"""Carry parameters and batches of the JAX package across to the port.

The JAX package's trees are handed over as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``, or an ``.npz`` of flattened paths);
these functions turn them into the port's nested dicts of tensors on a
given device, dtype for dtype. Nothing here imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.pytree import tree_map
from repro_torch.device import resolve_device

_SEP = "/"


def to_torch(tree, device=None):
    """Nested dict/list of numpy arrays (or array-likes, or tensors) → the
    same tree of tensors on ``device`` (default CUDA). Arrays are copied;
    bfloat16 arrays (ml_dtypes) go through float32 exactly."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(arr, copy=True)).to(dev)

    return tree_map(conv, tree)


def flatten_to_npz(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays → ``{"a/b/c": array}`` (for ``np.savez``)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_to_npz(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_npz(flat: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Inverse of :func:`flatten_to_npz` for the keys under ``prefix``."""
    out: Dict[str, Any] = {}
    head = prefix + _SEP if prefix else ""
    for key, v in flat.items():
        if not key.startswith(head):
            continue
        node = out
        parts = key[len(head):].split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return out
