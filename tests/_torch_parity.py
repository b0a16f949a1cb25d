"""Shared pieces of the port's training parity tests: the MLP fixture's
loss in PyTorch and the comparisons with their tolerances.

Tolerances (float32 on the CPU; XLA and PyTorch order the sums of matrix
products differently, so the two drift apart by rounding only): loss and
metrics rtol 1e-5; planes rtol 1e-5 (MLP) / 1e-4 (decoder) with atol 1e-6.
"""
import jax
import numpy as np
import torch

METRICS = ("loss", "update_staleness", "layer_staleness", "weight_sum",
           "disagreement", "staleness_mean")


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
