"""The port's prod training step at M ∈ {2, 4} against the JAX package's.

One subprocess (M host devices need the XLA flag before jax starts) runs
the JAX prod backend at (R, D) = (2, 1) on the MLP fixture and on the
``_bench_cfg`` decoder, 3 steps each, and writes an ``.npz`` (params,
batches, metrics, final read planes) that the port, run on the CPU from the
same params and batches, is held to. One case runs the MoE family
(``reduced(qwen3-moe-30b-a3b)``) at M=2, one the VLM backbone
(``reduced(qwen2-vl-2b)``: embeddings and (3, B, S) M-RoPE positions, each
sequence's ids offset, so that only a split on the positions' batch dim
gives the reference's numbers). Two cases run the int8 wire (one with
delay compensation λ=0.5). One case runs a fault plan at M=4 (peer 1
crashes at step 2, is declared dead at step 3 and re-synced from peer 0 at
step 6; 8 steps): the port's ``peers_live`` and ``nonfinite_skips``
histories must equal the reference's, its other metrics and planes within
the same tolerances. The rest of the (R, D) × M grid and the faulted int8,
compensated and decoder variants are behind ``slow``. Tolerances: see ``_torch_parity.py``; on the int8 wire the
planes may also differ, in at most 0.1% of the elements, by one int8
level: the interpret-mode Pallas quantizer and the port's plain one round
``v − q·s`` differently in the last bit, and a later round can then put an
element whose ``v / s`` sits at a half on the other side of it.
"""
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _subproc import run_sub  # noqa: E402
from _torch_parity import (METRICS, compare_metrics,  # noqa: E402
                           compare_planes, torch_mlp_loss)
from repro_torch.configs import get_config, reduced  # noqa: E402
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
import re
from benchmarks.table3_lm import _bench_cfg
from repro.configs import get_config, reduced
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

# Under jax 0.9 the reference's MoE dispatch cannot trace inside the prod
# step's shard_map (ROADMAP queue 3, Ref-4): its jnp.repeat goes through
# broadcast_to.
from _torch_parity import repeat_without_sharding
jnp.repeat = repeat_without_sharding

def flat(prefix, tree):
    out = {{}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(e.key) for e in path)] = np.asarray(leaf)
    return out

out = {{}}
for case in {cases!r}:
    problem, M, R, D, pallas, wire, comp, faults = (tuple(case) + (
        "param", 0.0, None)[len(case) - 5:])
    tag = re.sub(r"[^A-Za-z0-9.-]", "_", "-".join(map(str, case))) + "/"
    steps = 3 if faults is None else 8
    metrics = {metrics!r} + (() if faults is None else {fault_metrics!r})
    if problem == "mlp":
        loss_fn, params = mlp_problem()
        rng = np.random.default_rng(M)
        batches = [{{"x": rng.standard_normal((M, 8, 16)).astype(np.float32),
                    "labels": rng.integers(0, 10, (M, 8)).astype(np.int32)}}
                   for _ in range(steps)]
    elif problem == "vlm":
        cfg = reduced(get_config("qwen2-vl-2b"))
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        loss_fn = lambda p, b: model.loss_fn(p, b, block_k=16)
        rng = np.random.default_rng(M)
        pos = (np.arange(16, dtype=np.int32)[None, None, None]
               + np.arange(M * 4, dtype=np.int32).reshape(M, 1, 4, 1)
               + np.arange(3, dtype=np.int32).reshape(1, 3, 1, 1))
        batches = [{{"embeds": (rng.standard_normal((M, 4, 16, cfg.d_model))
                               * 0.02).astype(np.float32),
                    "positions": pos,
                    "labels": rng.integers(0, cfg.vocab_size,
                                           (M, 4, 16)).astype(np.int32)}}
                   for _ in range(steps)]
    else:
        cfg = (_bench_cfg() if problem == "lm"
               else reduced(get_config("qwen3-moe-30b-a3b")))
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        loss_fn = lambda p, b: model.loss_fn(p, b, block_k=16)
        ds = SyntheticLM(vocab=cfg.vocab_size, seq_len=16, temperature=1.2,
                         seed=0)
        batches = [make_worker_batches(ds, M, 4, t) for t in range(steps)]
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, use_pallas=pallas,
                      wire=wire, compensate=comp, faults=faults)
    st = be.init(jax.random.PRNGKey(0), params)
    out.update(flat(tag + "params/", params))
    for t, b in enumerate(batches):
        st, m = be.step(st, {{k: jnp.asarray(v) for k, v in b.items()}},
                        jax.random.PRNGKey(t))
        for k, v in b.items():
            out[tag + f"batch{{t}}/{{k}}"] = v
        for k in metrics:
            out[tag + f"metric{{t}}/{{k}}"] = np.asarray(m[k])
    for k, v in st["read"].items():
        out[tag + "read/" + k] = np.asarray(v)
np.savez({path!r}, **out)
print("ok")
"""


# the membership metrics of a faulted run, held equal to the reference's
FAULT_METRICS = ("peers_live", "nonfinite_skips")


def _run_reference(path, cases):
    run_sub(_REF_CODE.format(repo=REPO, cases=cases, metrics=METRICS,
                             fault_metrics=FAULT_METRICS, path=str(path)),
            timeout=900)
    return dict(np.load(path))


def _parse_case(case):
    """``(problem, M, R, D, use_pallas, wire, compensate, faults, tag)`` of a
    case tuple (wire, compensate and faults may be left off)."""
    full = tuple(case) + ("param", 0.0, None)[len(case) - 5:]
    tag = re.sub(r"[^A-Za-z0-9.-]", "_", "-".join(map(str, case))) + "/"
    return full + (tag,)


def _bench_torch_cfg():
    from benchmarks.table3_lm import _bench_cfg
    jcfg = _bench_cfg()
    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = torch.float32
    return ModelConfig(**kw)


def _int8_close(got, want, rtol):
    """Planes of the int8 wire: within ``rtol`` (atol 1e-6) as the param
    wire, except that at most 0.1% of the elements may differ beyond it,
    each by at most one int8 level of its 128-element row (max |row| / 127,
    with β ≤ 1)."""
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        bad = np.abs(g - w) > 1e-6 + rtol * np.abs(w)
        assert bad.mean() <= 1e-3, f"{k}: {bad.sum()} of {w.size} differ"
        pad = -w.shape[-1] % 128
        rows = np.pad(np.abs(w), [(0, 0)] * (w.ndim - 1) + [(0, pad)])
        level = rows.reshape(w.shape[:-1] + (-1, 128)).max(-1) / 127.0
        level = np.repeat(level, 128, axis=-1)[..., :w.shape[-1]]
        over = np.abs(g - w)[bad] - level[bad]
        assert not bad.any() or over.max() <= 1e-6, \
            f"{k}: a difference exceeds one int8 level by {over.max()}"


def _check_case(ref, case):
    problem, M, R, D, pallas, wire, comp, faults, tag = _parse_case(case)
    steps = 3 if faults is None else 8
    params = unflatten_npz(ref, tag + "params")
    batches = [unflatten_npz(ref, tag + f"batch{t}") for t in range(steps)]
    if problem == "mlp":
        loss_fn, rtol = torch_mlp_loss, 1e-5
    elif problem == "vlm":
        loss_fn, rtol = build_model(reduced(get_config(
            "qwen2-vl-2b"))).loss_fn, 1e-4
        assert all(b["positions"].shape == (M, 3, 4, 16) for b in batches)
    else:
        cfg = (_bench_torch_cfg() if problem == "lm"
               else reduced(get_config("qwen3-moe-30b-a3b")))
        model = build_model(cfg)
        loss_fn, rtol = model.loss_fn, 1e-4
        # the port's numpy data is draw-for-draw the JAX package's
        ds = SyntheticLM(vocab=cfg.vocab_size, seq_len=16, temperature=1.2,
                         seed=0)
        for t, b in enumerate(batches):
            mine = make_worker_batches(ds, M, 4, t)
            for k in b:
                np.testing.assert_array_equal(mine[k], b[k])
    be = make_backend("prod", "layup", M=M, loss_fn=loss_fn,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, use_pallas=pallas,
                      wire=wire, compensate=comp, device="cpu",
                      faults=faults)
    exact = () if faults is None else FAULT_METRICS
    out = drive(be, batches, None, to_torch(params, "cpu"),
                history_keys=METRICS + exact)
    for t in range(steps):
        jm = {k: ref[tag + f"metric{t}/{k}"] for k in METRICS}
        tm = {k: out["history"][k][t] for k in METRICS}
        compare_metrics(tm, jm, t)
        for k in exact:
            assert float(out["history"][k][t]) == float(
                ref[tag + f"metric{t}/{k}"]), (k, t)
    if faults is not None:
        assert out["resyncs"] == 1 and out["peers_dead"] == 0
    want = unflatten_npz(ref, tag + "read")
    if wire == "int8":
        _int8_close(out["state"]["read"], want, rtol)
    else:
        compare_planes(out["state"]["read"], want, rtol=rtol)


CRASH = "crash:peer=1,step=2,recover=6"
# (problem, M, R, D, use_pallas[, wire, compensate[, faults]])
FAST_CASES = [("mlp", 2, 2, 1, True), ("mlp", 4, 2, 1, True),
              ("mlp", 4, 2, 1, False), ("lm", 2, 2, 1, True),
              ("lm", 4, 2, 1, True), ("mlp", 4, 2, 1, True, "int8", 0.5),
              ("lm", 2, 2, 1, True, "int8", 0.0),
              ("mlp", 4, 2, 1, True, "param", 0.0, CRASH),
              ("moe", 2, 2, 1, True), ("vlm", 2, 2, 1, True)]
SLOW_CASES = [("mlp", M, R, D, True) for M in (2, 4)
              for R, D in ((1, 0), (1, 1))] + [
    ("mlp", 4, 2, 1, True, "int8", 0.0, CRASH),
    ("mlp", 4, 2, 1, True, "param", 0.5, CRASH),
    ("mlp", 4, 2, 1, True, "int8", 0.5,
     CRASH + ";nan:step=4,peer=0,group=0"),
    ("lm", 4, 2, 1, True, "param", 0.0, CRASH)]


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("ref") / "ref.npz",
                          FAST_CASES)


@pytest.mark.parametrize("case", FAST_CASES,
                         ids=["-".join(map(str, c)) for c in FAST_CASES])
def test_multiworker_prod_step_matches_jax(reference_runs, case):
    _check_case(reference_runs, case)


@pytest.mark.slow
def test_multiworker_grid_matches_jax(tmp_path):
    ref = _run_reference(tmp_path / "ref.npz", SLOW_CASES)
    for case in SLOW_CASES:
        _check_case(ref, case)
