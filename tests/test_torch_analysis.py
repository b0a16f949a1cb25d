"""The port's analytic cost terms (``repro_torch.launch.analysis``) against
``repro.launch.analysis``.

* ``analytic_costs`` and ``model_flops`` equal to the JAX functions (rtol
  1e-12: the same arithmetic in the same order) for every config of the
  registry at every ``INPUT_SHAPES`` kind, with ``n_model`` in {1, 16} and
  ``n_workers`` in {1, 16}.
* The four checks of ``tests/test_analysis.py::TestAnalyticCosts`` on the
  port's copy, with the H100 SXM's rates in place of the TPU's.
* ``chip_smoke.py`` takes the card's rates from the module.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import analysis as JA  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_configs  # noqa: E402,E501
from repro_torch.launch import analysis as AN  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if isinstance(w, dict):
            _close(got[k], w, f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=0,
                                       err_msg=f"{what}/{k}")


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_costs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    s, js = INPUT_SHAPES[shape], JAX_SHAPES[shape]
    for n_model in (1, 16):
        for n_workers in (1, 16):
            _close(AN.analytic_costs(cfg, s, n_model=n_model,
                                     n_workers=n_workers),
                   JA.analytic_costs(jcfg, js, n_model=n_model,
                                     n_workers=n_workers),
                   f"{arch} {shape} model={n_model} workers={n_workers}")
    np.testing.assert_allclose(AN.model_flops(cfg, s),
                               JA.model_flops(jcfg, js), rtol=1e-12)


# the mirror of tests/test_analysis.py::TestAnalyticCosts


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b",
                                  "mamba2-780m", "whisper-large-v3",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_positive_and_finite(arch, shape):
    ac = AN.analytic_costs(get_config(arch), INPUT_SHAPES[shape], n_model=16,
                           n_workers=16)
    assert ac["flops_per_device"] > 0
    assert ac["bytes_per_device"] > 0
    assert np.isfinite(ac["flops_per_device"])


def test_train_flops_close_to_6nd():
    """Dense train analytic flops ≈ (4/3)·6·N·D/devices (the remat
    forward, which the port's ``remat_block`` runs as the reference's
    does), within the attention and vocabulary corrections."""
    cfg = get_config("granite-8b")
    shape = INPUT_SHAPES["train_4k"]
    ac = AN.analytic_costs(cfg, shape, n_model=16, n_workers=16)
    ratio = ac["flops_per_device"] / (AN.model_flops(cfg, shape) / 256)
    assert 1.1 < ratio < 2.2, ratio


def test_decode_memory_bound():
    """Decode is memory-bound at the H100 SXM's data-sheet rates (989
    TFLOP/s over 3.35 TB/s: 295 flops a byte)."""
    ac = AN.analytic_costs(get_config("yi-34b"), INPUT_SHAPES["decode_32k"],
                           n_model=16, n_workers=16)
    t_comp = ac["flops_per_device"] / AN.PEAK_FLOPS
    t_mem = ac["bytes_per_device"] / AN.HBM_BW
    assert t_mem > 10 * t_comp


def test_moe_sharding_divides_expert_flops():
    cfg = get_config("qwen3-moe-30b-a3b")  # 128 experts % 16 == 0
    shape = INPUT_SHAPES["train_4k"]
    a16 = AN.analytic_costs(cfg, shape, n_model=16, n_workers=16)
    a1 = AN.analytic_costs(cfg, shape, n_model=1, n_workers=16)
    assert a1["flops_per_device"] > 4 * a16["flops_per_device"]


def test_card_rates_have_one_source():
    """The roofline names are the H100 SXM data-sheet rates, and
    ``chip_smoke.py`` uses the module's values, not copies."""
    assert AN.PEAK_FLOPS == AN.BF16_FLOPS_PER_S == 989e12
    assert AN.HBM_BW == AN.HBM_BYTES_PER_S == 3.35e12
    assert AN.ICI_BW == AN.NVLINK_BYTES_PER_S == 450e9
    assert AN.F32_FLOPS_PER_S == 67e12
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("HBM_BYTES_PER_S", "BF16_FLOPS_PER_S", "F32_FLOPS_PER_S"):
        assert getattr(smoke, name) is getattr(AN, name), name
