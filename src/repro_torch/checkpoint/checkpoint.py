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

A decoupled step's state on a multi-process mesh (``mesh=``, a
:class:`~repro_torch.launch.mesh.WorkerMesh` with a process group: a
rank's ``(L, ...)`` rows of the row entries ``launch.mesh.ROW_ENTRIES``
beside the ``(M,)`` push-sum weights and clocks) goes to the same one
archive, in the one-process layout: ``save_checkpoint`` gathers the rows
on rank 0, which writes the file while the others wait, and
``restore_checkpoint`` lets every rank read the archive and take its own
rows. Every rank calls both alike; a failure on one raises on all.
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


def _ring(mesh):
    return mesh if mesh is not None and mesh.group is not None else None


def _row_leaf(path, leaf) -> bool:
    """A leaf of the row entries (``launch.mesh.ROW_ENTRIES``) with rows:
    spread over the ranks of a mesh (a 0-d leaf there, such as adamw's
    count, is every rank's)."""
    from repro_torch.launch.mesh import ROW_ENTRIES

    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1:
        return False
    keys = tuple(e.key for e in path if isinstance(e, DictKey))
    return any(keys[:len(e)] == e for e in ROW_ENTRIES)


def _all_ok(ring, err: Optional[BaseException], what: str) -> None:
    """Raise on every rank when ``err`` was raised on any of them (the
    ranks' failures summed through the mesh: also the barrier)."""
    flag = torch.tensor([0.0 if err is None else 1.0],
                        device=ring.resolved_device())
    ring.all_reduce_sum_(flag)
    if err is not None:
        raise err
    if float(flag.item()) > 0.0:
        raise RuntimeError(f"{what} failed on another rank of the mesh")


def _write(directory: str, step: int, arrays: Dict[str, np.ndarray]) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    # np.savez appends ".npz" unless the name already ends with it
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def save_checkpoint(directory: str, step: int, tree: Any,
                    mesh=None) -> str:
    """Write ``tree`` as ``<directory>/ckpt_<step:08d>.npz``; returns the
    path. ``mesh`` (a ``WorkerMesh`` with a process group): ``tree`` is a
    rank's; its row leaves are gathered on rank 0, which writes the whole
    state, and every rank returns once the file is in place."""
    ring = _ring(mesh)
    if ring is None:
        return _write(directory, step, _flatten(tree))
    ring.agree(int(step), "checkpoint steps")
    arrays: Dict[str, np.ndarray] = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        if _row_leaf(path, leaf):
            leaf = ring.gather_rows_to(leaf, 0)
        if ring.rank == 0:
            arrays[keystr(path)] = _to_numpy(leaf)
    err = None
    out = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if ring.rank == 0:
        try:
            out = _write(directory, step, arrays)
        except Exception as e:  # noqa: BLE001 - raised on every rank below
            err = e
    del arrays
    _all_ok(ring, err, "checkpoint save")
    return out


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr, dtype=leaf.dtype)
    return arr


def restore_checkpoint(directory: str, step: Optional[int], like: Any,
                       fill_missing: bool = False, mesh=None) -> Any:
    """Restore into the structure of ``like`` (each leaf's dtype and device
    kept). ``step=None`` takes the latest step in ``directory``.

    ``fill_missing=True`` keeps the ``like`` value for leaves absent from
    the archive instead of raising ``KeyError``.

    ``mesh`` (a ``WorkerMesh`` with a process group): ``like`` is a rank's
    state; every rank reads the one archive (the step checked to agree
    over the ranks) and takes its own rows of the row leaves."""
    ring = _ring(mesh)
    if step is None:
        step = latest_step(directory)
    if ring is not None:
        ring.agree(step, "checkpoint steps")
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    if ring is None:
        return _restore(path, like, fill_missing, None)
    err, out = None, None
    try:
        out = _restore(path, like, fill_missing, ring)
    except Exception as e:  # noqa: BLE001 - raised on every rank below
        err = e
    _all_ok(ring, err, "checkpoint restore")
    return out


def _restore(path: str, like: Any, fill_missing: bool, ring) -> Any:
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
            arr = data[key]
            if ring is not None and _row_leaf(path_, leaf):
                if arr.shape[0] != ring.workers:
                    raise ValueError(f"checkpoint leaf {key} has "
                                     f"{arr.shape[0]} rows, the mesh "
                                     f"{ring.workers} workers")
                arr = ring.local(arr)
            new_leaves.append(_like(arr, leaf))
    return tree_unflatten(treedef, new_leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
