"""Shared pieces of the port's training parity tests: the MLP fixture's
loss in PyTorch and the comparisons with their tolerances.

Tolerances (float32 on the CPU; XLA and PyTorch order the sums of matrix
products differently, so the two drift apart by rounding only): loss and
metrics rtol 1e-5; planes rtol 1e-5 (MLP) / 1e-4 (decoder) with atol 1e-6.

``run_port`` and ``assert_runs_equal`` hold one run of the port's prod
backend to another bit for bit (the engines against the monolithic step).
"""
import jax
import numpy as np
import torch

from _fixtures import mlp_batch, mlp_problem

METRICS = ("loss", "update_staleness", "layer_staleness", "weight_sum",
           "disagreement", "staleness_mean")


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_cfg(jcfg):
    """The port's ModelConfig of a JAX package's config, field for field."""
    from repro_torch.configs.base import ModelConfig

    kw = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    kw["dtype"] = _TORCH_DTYPES[np.dtype(jcfg.dtype).name]
    return ModelConfig(**kw)


def torch_mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1"])
    logits = h @ p["l2"]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(logp[torch.arange(logits.shape[0]), b["labels"].long()])
    return ce, {}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def compare_metrics(tm, jm, t, rtol=1e-5):
    for k in METRICS:
        np.testing.assert_allclose(host(tm[k]), np.asarray(jm[k]),
                                   rtol=rtol, atol=1e-7,
                                   err_msg=f"{k} at step {t}")


def compare_planes(tplane, jplane, rtol):
    assert list(tplane) == list(jplane)
    for k in jplane:
        np.testing.assert_allclose(host(tplane[k]), np.asarray(jplane[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)


STEP_METRICS = ("loss", "update_staleness", "layer_staleness",
                "weight_sum", "disagreement", "staleness_mean")


def mlp_params():
    return np_tree(mlp_problem()[1])


def materialize(be, tree):
    """A state tree of the backend's engine as tensors."""
    eng = be.engine
    return eng.materialize(tree) if hasattr(eng, "materialize") else tree


def run_port(M, R, D, steps=5, **kw):
    """``(histories, planes, summary, backend)`` of the port's prod backend
    on the MLP fixture (CPU): host copies of each step's metrics and of the
    final read plane (and residual, θ where present). The stream engine's
    threads are closed before it returns."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    be = make_backend("prod", "layup", M=M, loss_fn=torch_mlp_loss,
                      optimizer=momentum(0.9), schedule=constant(0.05),
                      fb_ratio=R, update_delay=D, device="cpu",
                      wait_timeout_s=20.0, **kw)
    try:
        st = be.init(None, mlp_params())
        hist = []
        for t in range(steps):
            st, m = be.step(st, np_tree(mlp_batch(t, M=M, b=4 * R)))
            hist.append(m)
        hist = [{k: np.asarray(m[k]) for k in STEP_METRICS} for m in hist]
        planes = {name: {k: v.clone() for k, v in
                         materialize(be, st[name]).items()}
                  for name in ("read", "resid", "theta") if name in st}
        summary = be.summary()
    finally:
        if hasattr(be.engine, "close"):
            be.engine.close()
    return hist, planes, summary, be


def assert_runs_equal(got, want):
    """Two ``run_port`` results bit for bit: every metric of every step,
    and every final plane."""
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        for k in STEP_METRICS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} @ {t}")
    assert list(got[1]) == list(want[1])
    for name in want[1]:
        for k in want[1][name]:
            assert torch.equal(got[1][name][k], want[1][name][k]), (name, k)
