"""Weights and token batches, made on the device from the run's seed.

Both sides of the correctness check get these same tensors; the program's
derived state and the reference's are each worked out from them.

Weights: every leaf of the model's parameter tree (``{path: (shape,
dtype)}``, paths ``a/b/c``) is drawn by the first rule of the
configuration's ``init`` list whose pattern it matches, from one
``randn`` and one ``rand`` of the total length over all leaves, on a
``torch.Generator`` of the device seeded with the seed. Rules:
``["pattern", "normal", std]``, ``["pattern", "ones"]``,
``["pattern", "zeros"]``, ``["pattern", "uniform", lo, hi]``,
``["pattern", "log_uniform", lo, hi]`` (log of a draw uniform on [lo, hi]),
``["pattern", "inv_softplus_log_uniform", lo, hi]`` (the softplus inverse
of a draw log-uniform on [lo, hi]: Mamba2's step-size bias).

Batches: ``distinct_batches`` batches of uniformly drawn token ids, each
``(workers, sequences_per_worker, sequence_length)`` with the labels the
next token, from a second generator seeded with ``seed + 1``.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List

import torch

SEED_MOD = 2 ** 62


def _rule(path: str, rules):
    for r in rules:
        if re.search(r[0], path):
            return r
    raise ValueError(f"no init rule matches parameter {path!r}")


def make_weights(shapes: Dict[str, tuple], dtype: torch.dtype, rules,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: tensor in ``dtype``} drawn by ``rules`` (see the module
    docstring), in sorted-path order."""
    paths = sorted(shapes, key=lambda p: tuple(p.split("/")))
    numel = {p: math.prod(shapes[p]) for p in paths}
    kinds = {p: _rule(p, rules) for p in paths}
    n_normal = sum(numel[p] for p in paths if kinds[p][1] == "normal")
    n_unif = sum(numel[p] for p in paths
                 if kinds[p][1] not in ("normal", "ones", "zeros"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    out, i_n, i_u = {}, 0, 0
    for p in paths:
        n, kind = numel[p], kinds[p]
        if kind[1] == "normal":
            v = normal[i_n:i_n + n] * kind[2]
            i_n += n
        elif kind[1] in ("ones", "zeros"):
            v = torch.full((n,), 1.0 if kind[1] == "ones" else 0.0,
                           device=device)
        else:
            u = unif[i_u:i_u + n]
            i_u += n
            lo, hi = float(kind[2]), float(kind[3])
            if kind[1] == "uniform":
                v = lo + (hi - lo) * u
            elif kind[1] == "log_uniform":
                v = torch.log(lo + (hi - lo) * u)
            elif kind[1] == "inv_softplus_log_uniform":
                dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                               * u)
                v = dt + torch.log(-torch.expm1(-dt))
            else:
                raise ValueError(f"unknown init kind {kind[1]!r}")
        out[p] = v.reshape(shapes[p]).to(dtype)
    return out


def make_batches(traffic: dict, vocab: int, seed: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """``distinct_batches`` batches {"tokens", "labels"} of
    (workers, sequences_per_worker, sequence_length) int64 ids."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % SEED_MOD)
    shape = (traffic["distinct_batches"], traffic["workers"],
             traffic["sequences_per_worker"], traffic["sequence_length"] + 1)
    ids = torch.randint(0, vocab, shape, generator=gen, device=device)
    return [{"tokens": b[..., :-1].contiguous(),
             "labels": b[..., 1:].contiguous()} for b in ids]


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a/b/c": t} → {"a": {"b": {"c": t}}}: the program's parameter
    tree."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """The inverse of :func:`nest` over nested dicts."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out
