"""The port's prod training step at M ∈ {2, 4} against the JAX package's.

One subprocess (M host devices need the XLA flag before jax starts) runs
the JAX prod backend at (R, D) = (2, 1) on the MLP fixture and on the
``_bench_cfg`` decoder, 3 steps each, and writes an ``.npz`` (params,
batches, metrics, final read planes) that the port, run on the CPU from the
same params and batches, is held to. The rest of the (R, D) × M grid is
behind ``slow``. Tolerances: see ``_torch_parity.py``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _subproc import run_sub  # noqa: E402
from _torch_parity import (METRICS, compare_metrics,  # noqa: E402
                           compare_planes, torch_mlp_loss)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import to_torch, unflatten_npz  # noqa: E402
from repro_torch.core.backend import drive, make_backend  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, make_worker_batches  # noqa: E402,E501
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import constant, momentum  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# (b) M ∈ {2, 4}: the JAX reference in a subprocess
# ---------------------------------------------------------------------------

_REF_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{repo!r}, os.path.join({repo!r}, "tests")]
import jax, jax.numpy as jnp, numpy as np
from _fixtures import mlp_problem
from benchmarks.table3_lm import _bench_cfg
from repro.core.backend import make_backend
from repro.data.synthetic import SyntheticLM, make_worker_batches
from repro.models import build_model
from repro.optim import momentum, constant

# Under jax 0.9 the reference's M>1 prod step fails to run with its state
# donated (XLA: "Expected aliased input ... to have the same size"; see
# ROADMAP queue 3). Donation does not change numerics, so the reference
# runs here with donation dropped.
_jit = jax.jit
def _jit_without_donation(f, *a, **k):
    k.pop("donate_argnums", None)
    return _jit(f, *a, **k)
jax.jit = _jit_without_donation

def flat(prefix, tree):
    out = {{}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(e.key) for e in path)] = np.asarray(leaf)
    return out

out = {{}}
for problem, M, R, D, pallas in {cases!r}:
    tag = f"{{problem}}/M{{M}}R{{R}}D{{D}}{{'p' if pallas else 'u'}}/"
    if problem == "mlp":
        loss_fn, params = mlp_problem()
        rng = np.random.default_rng(M)
        batches = [{{"x": rng.standard_normal((M, 8, 16)).astype(np.float32),
                    "labels": rng.integers(0, 10, (M, 8)).astype(np.int32)}}
                   for _ in range(3)]
    else:
        model = build_model(_bench_cfg())
        params = model.init(jax.random.PRNGKey(0))
        loss_fn = lambda p, b: model.loss_fn(p, b, block_k=16)
        ds = SyntheticLM(vocab=128, seq_len=16, temperature=1.2, seed=0)
        batches = [make_worker_batches(ds, M, 4, t) for t in range(3)]
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, use_pallas=pallas)
    st = be.init(jax.random.PRNGKey(0), params)
    out.update(flat(tag + "params/", params))
    for t, b in enumerate(batches):
        st, m = be.step(st, {{k: jnp.asarray(v) for k, v in b.items()}},
                        jax.random.PRNGKey(t))
        for k, v in b.items():
            out[tag + f"batch{{t}}/{{k}}"] = v
        for k in {metrics!r}:
            out[tag + f"metric{{t}}/{{k}}"] = np.asarray(m[k])
    for k, v in st["read"].items():
        out[tag + "read/" + k] = np.asarray(v)
np.savez({path!r}, **out)
print("ok")
"""


def _run_reference(path, cases):
    run_sub(_REF_CODE.format(repo=REPO, cases=cases, metrics=METRICS,
                             path=str(path)), timeout=900)
    return dict(np.load(path))


def _bench_torch_cfg():
    from benchmarks.table3_lm import _bench_cfg
    jcfg = _bench_cfg()
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = torch.float32
    return ModelConfig(**kw)


def _check_case(ref, problem, M, R, D, pallas):
    tag = f"{problem}/M{M}R{R}D{D}{'p' if pallas else 'u'}/"
    params = unflatten_npz(ref, tag + "params")
    batches = [unflatten_npz(ref, tag + f"batch{t}") for t in range(3)]
    if problem == "mlp":
        loss_fn, rtol = torch_mlp_loss, 1e-5
    else:
        model = build_model(_bench_torch_cfg())
        loss_fn, rtol = model.loss_fn, 1e-4
        # the port's numpy data is draw-for-draw the JAX package's
        ds = SyntheticLM(vocab=128, seq_len=16, temperature=1.2, seed=0)
        for t, b in enumerate(batches):
            mine = make_worker_batches(ds, M, 4, t)
            for k in b:
                np.testing.assert_array_equal(mine[k], b[k])
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, use_pallas=pallas,
                      device="cpu")
    out = drive(be, batches, None, to_torch(params, "cpu"),
                history_keys=METRICS)
    for t in range(3):
        jm = {k: ref[tag + f"metric{t}/{k}"] for k in METRICS}
        tm = {k: out["history"][k][t] for k in METRICS}
        compare_metrics(tm, jm, t)
    compare_planes(out["state"]["read"], unflatten_npz(ref, tag + "read"),
                    rtol=rtol)


FAST_CASES = [("mlp", 2, 2, 1, True), ("mlp", 4, 2, 1, True),
              ("mlp", 4, 2, 1, False), ("lm", 2, 2, 1, True),
              ("lm", 4, 2, 1, True)]
SLOW_CASES = [("mlp", M, R, D, True) for M in (2, 4)
              for R, D in ((1, 0), (1, 1))]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("ref") / "ref.npz",
                          FAST_CASES)


@pytest.mark.parametrize("case", FAST_CASES,
                         ids=["-".join(map(str, c)) for c in FAST_CASES])
def test_multiworker_prod_step_matches_jax(reference_runs, case):
    _check_case(reference_runs, *case)


@pytest.mark.slow
def test_multiworker_grid_matches_jax(tmp_path):
    ref = _run_reference(tmp_path / "ref.npz", SLOW_CASES)
    for case in SLOW_CASES:
        _check_case(ref, *case)
