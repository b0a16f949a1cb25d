"""Tree checkpointing to ``.npz`` (port of ``repro/checkpoint/checkpoint.py``).

The archive layout is the JAX package's: one file ``ckpt_%08d.npz`` per
step, written to a temporary name and renamed over the final one (a
partial write never shows), one entry per leaf. The entry's key is the
string ``jax.tree_util.keystr`` gives the leaf's path — ``['params']``
for a dict key, ``[0]`` for a sequence index, joined without a separator
(``['params']['layers'][0]``) — so an archive written by either package
restores in the other. (This is neither the port's group label, which pads
indices as ``%03d``, nor ``convert.py``'s ``/``-joined paths.)

Leaves are tensors (copied to the host), numpy arrays or Python scalars.
bfloat16 has no numpy dtype: it is stored in float32, a lossless
container, and cast back on restore. ``restore_checkpoint`` gives every
leaf ``like``'s dtype and, for a tensor, ``like``'s device.

A decoupled step's state on a multi-process mesh (a rank's ``(L, ...)``
plane rows beside the ``(M,)`` push-sum weights) is neither saved nor
restored yet: both raise ``NotImplementedError`` (ROADMAP item 15c).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pytree import (DictKey, SequenceKey,
                                     tree_flatten_with_path, tree_unflatten)
from repro_torch.device import not_ported


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of the port's pytree keys."""
    out = []
    for e in path:
        if isinstance(e, DictKey):
            out.append(f"[{e.key!r}]")
        elif isinstance(e, SequenceKey):
            out.append(f"[{e.idx}]")
        else:
            raise TypeError(f"unknown path entry {e!r}")
    return "".join(out)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = np.asarray(leaf, dtype=np.float32)
    return arr


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {keystr(path): _to_numpy(leaf)
            for path, leaf in tree_flatten_with_path(tree)[0]}


def _check_not_mesh_state(tree, what: str) -> None:
    """Raise for a decoupled step's state of one rank of a multi-process
    mesh: a dict (at any depth) whose ``"read"`` plane has fewer rows than
    its ``"w"`` has workers."""
    if not isinstance(tree, dict):
        if isinstance(tree, (list, tuple)):
            for v in tree:
                _check_not_mesh_state(v, what)
        return
    read, w = tree.get("read"), tree.get("w")
    if isinstance(read, dict) and isinstance(w, torch.Tensor) and read:
        rows = next(iter(read.values())).shape[0]
        if w.dim() == 1 and rows != w.shape[0]:
            raise not_ported(f"{what} of a state spread over a WorkerMesh's "
                             "ranks", "15c")
    for v in tree.values():
        _check_not_mesh_state(v, what)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write ``tree`` as ``<directory>/ckpt_<step:08d>.npz``; returns the
    path."""
    _check_not_mesh_state(tree, "checkpoint save")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    # np.savez appends ".npz" unless the name already ends with it
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr, dtype=leaf.dtype)
    return arr


def restore_checkpoint(directory: str, step: Optional[int], like: Any,
                       fill_missing: bool = False) -> Any:
    """Restore into the structure of ``like`` (each leaf's dtype and device
    kept). ``step=None`` takes the latest step in ``directory``.

    ``fill_missing=True`` keeps the ``like`` value for leaves absent from
    the archive instead of raising ``KeyError``."""
    _check_not_mesh_state(like, "checkpoint restore")
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat, treedef = tree_flatten_with_path(like)
    new_leaves = []
    with np.load(path) as data:
        for path_, leaf in flat:
            key = keystr(path_)
            if key not in data.files:
                if fill_missing:
                    new_leaves.append(leaf)
                    continue
                raise KeyError(f"checkpoint missing leaf {key}")
            new_leaves.append(_like(data[key], leaf))
    return tree_unflatten(treedef, new_leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
