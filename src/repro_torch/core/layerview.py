"""Layer-granular parameter views and the persistent flat plane.

Port of ``repro/core/layerview.py``:

* ``LayerPartition`` splits a parameter tree into layer groups: the
  top-level key, or ``"<key>.<idx>"`` for per-layer containers (lists of
  blocks). Group names are sorted. ``split`` gives the ``{group: {path:
  leaf}}`` mapping of a :class:`LayerView`, ``join`` the tree back;
  ``by_key``/``from_keys`` the flat ``{path: leaf}`` dict, which the update
  lane and the optimizers take for a tree (the lockstep and DDP steps).
* ``FlatPartition`` fixes one contiguous buffer per layer group and dtype
  (leaves flattened in C order and concatenated in tree order; a group that
  mixes dtypes gets one ``"<group>:<dtype>"`` buffer per dtype). ``pack`` and
  ``unpack`` take any number of leading axes: ``(M, ...)`` worker stacks,
  ``(M, D, ...)`` FIFO stacks. ``unpack`` returns views (slice + reshape).
* ``LayerView``: what the ``DistAlgorithm`` hooks receive, ``groups`` (a
  tree whose leaves keep the stacked ``(M, ...)`` layout) and ``versions``,
  the ``(M, G)`` float32 version clocks. The sim trainer
  (``repro_torch.core.api``) hands the hooks the flat plane itself as
  ``groups``: ``{buffer: (M, n)}``, one clock per group of ``names``.
* The version-clock arithmetic (``send_fractions``, ``stamp_groups``,
  ``layer_staleness``, ``version_metrics``) on ``(M, G)`` float32 tensors.

Trees are flattened in jax order (sorted dict keys, see
``repro_torch.core.pytree``), so group names, sizes and every offset match
the JAX package's plane exactly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import (DictKey, SequenceKey,
                                     tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)
from repro_torch.kernels.quantize import quant_wire_nbytes


# The port's pytree makes only dict and sequence keys; the JAX package's
# versions also name attribute and flattened-index keys, which no tree of
# the port produces.
def _key_str(entry) -> str:
    if isinstance(entry, DictKey):
        return str(entry.key)
    if isinstance(entry, SequenceKey):
        return f"{entry.idx:03d}"
    return str(entry)


def _group_label(path) -> str:
    """Group = top-level key, or "<key>.<idx>" for per-layer containers."""
    if not path:
        return "root"
    if len(path) >= 2 and isinstance(path[1], SequenceKey):
        return f"{_key_str(path[0])}.{_key_str(path[1])}"
    return _key_str(path[0])


def dtype_name(dt: torch.dtype) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``: the name numpy/jax give it."""
    return str(dt).replace("torch.", "")


class LayerPartition:
    """Static partitioner: the layer group of every leaf of a tree. Only the
    tree structure matters (stacked or single-worker)."""

    def __init__(self, example_tree):
        flat, treedef = tree_flatten_with_path(example_tree)
        self._treedef = treedef
        self._index = []  # (group_label, leaf_key) per leaf, in flatten order
        seen: Dict[str, None] = {}
        for path, _ in flat:
            label = _group_label(path)
            leaf_key = ".".join(_key_str(e) for e in path) or "leaf"
            self._index.append((label, leaf_key))
            seen.setdefault(label, None)
        self.names: Tuple[str, ...] = tuple(sorted(seen))
        self._gidx = {n: i for i, n in enumerate(self.names)}

    @property
    def num_groups(self) -> int:
        return len(self.names)

    def group_index(self, name: str) -> int:
        return self._gidx[name]

    def split(self, tree) -> Dict[str, Dict[str, Any]]:
        """Tree → ``{group: {leaf_key: leaf}}`` (leaves not copied)."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self._index):
            raise ValueError(
                f"tree has {len(leaves)} leaves; partition expects "
                f"{len(self._index)}")
        groups: Dict[str, Dict[str, Any]] = {n: {} for n in self.names}
        for (label, leaf_key), leaf in zip(self._index, leaves):
            groups[label][leaf_key] = leaf
        return groups

    def join(self, groups: Dict[str, Dict[str, Any]]):
        leaves = [groups[label][leaf_key] for label, leaf_key in self._index]
        return tree_unflatten(self._treedef, leaves)

    def by_key(self, tree) -> Dict[str, Any]:
        """Tree → ``{leaf_key: leaf}`` in flatten order (leaves not copied):
        the dict of buffers the update lane and the optimizers take for a
        parameter tree."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self._index):
            raise ValueError(
                f"tree has {len(leaves)} leaves; partition expects "
                f"{len(self._index)}")
        return {k: leaf for (_, k), leaf in zip(self._index, leaves)}

    def from_keys(self, leaves: Dict[str, Any]):
        """``{leaf_key: leaf}`` → tree: the inverse of :meth:`by_key`."""
        return tree_unflatten(self._treedef,
                              [leaves[k] for _, k in self._index])

    def init_versions(self, M: int, device=None) -> torch.Tensor:
        return torch.zeros((M, self.num_groups), dtype=torch.float32,
                           device=device)

    def view(self, tree, versions=None, M: Optional[int] = None
             ) -> "LayerView":
        if versions is None:
            leaf = tree_leaves(tree)[0]
            if M is None:
                M = leaf.shape[0]
            versions = self.init_versions(M, device=leaf.device)
        return LayerView(groups=self.split(tree), versions=versions,
                         names=self.names)


class _LeafSlot(NamedTuple):
    """Where one leaf lives inside its group's flat buffer."""
    group: str
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: torch.dtype


class FlatPartition(LayerPartition):
    """A :class:`LayerPartition` with a fixed flat layout per group.

    ``group_sizes``/``group_dtypes`` are keyed by plane-buffer name (the
    group name for a uniform-dtype group); ``names`` stays the per-group key
    of the version clocks. Every leaf is stored at its own dtype."""

    def __init__(self, example_tree):
        super().__init__(example_tree)
        flat, _ = tree_flatten_with_path(example_tree)
        dtypes_by_group: Dict[str, list] = {n: [] for n in self.names}
        for (label, _), (_, leaf) in zip(self._index, flat):
            if leaf.dtype not in dtypes_by_group[label]:
                dtypes_by_group[label].append(leaf.dtype)

        def bucket(label, dt):
            if len(dtypes_by_group[label]) == 1:
                return label
            return f"{label}:{dtype_name(dt)}"

        self.group_dtypes: Dict[str, torch.dtype] = {}
        sizes: Dict[str, int] = {}
        self._slots: list = []  # per leaf, in tree-flatten order
        for (label, _), (_, leaf) in zip(self._index, flat):
            key = bucket(label, leaf.dtype)
            self.group_dtypes[key] = leaf.dtype
            shape = tuple(int(d) for d in leaf.shape)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            self._slots.append(_LeafSlot(key, sizes.get(key, 0), size,
                                         shape, leaf.dtype))
            sizes[key] = sizes.get(key, 0) + size
        self.group_sizes: Dict[str, int] = sizes

    def plane_nbytes(self, wire: str = "param") -> int:
        """Bytes of ONE flat plane (single worker): the per-step gossip wire
        cost per peer. ``wire="param"`` prices each group at its param
        dtype; ``wire="int8"`` at one int8 byte per element plus one f32
        scale per 128-element row of the group's quantized layout."""
        if wire == "param":
            return sum(size * self.group_dtypes[n].itemsize
                       for n, size in self.group_sizes.items())
        if wire == "int8":
            return sum(quant_wire_nbytes(size)
                       for size in self.group_sizes.values())
        raise ValueError(f"unknown wire dtype {wire!r}")

    def abstract_plane(self, lead: Tuple[int, ...] = ()
                       ) -> Dict[str, torch.Tensor]:
        """The plane ``{group: (*lead, size)}`` on the ``meta`` device
        (nothing allocated)."""
        return {g: torch.empty(tuple(lead) + (n,),
                               dtype=self.group_dtypes[g], device="meta")
                for g, n in self.group_sizes.items()}

    def pack(self, tree, out: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """Tree → ``{group: (*lead, group_size) buffer}``. Leading axes are
        inferred from the first leaf; leaves are cast to the group dtype.

        ``out`` (buffers of the right shape, e.g. one worker's row of a
        stacked plane) receives the leaves in place instead of a fresh
        concatenation; it is returned."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self._slots):
            raise ValueError(f"tree has {len(leaves)} leaves; partition "
                             f"expects {len(self._slots)}")
        lead = leaves[0].dim() - len(self._slots[0].shape)
        if lead < 0:
            raise ValueError(
                f"leaf rank {leaves[0].dim()} below partition rank "
                f"{len(self._slots[0].shape)}")
        chunks: Dict[str, list] = {n: [] for n in self.group_sizes}
        for slot, leaf in zip(self._slots, leaves):
            if tuple(leaf.shape[lead:]) != slot.shape:
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} does not end with "
                    f"partition shape {slot.shape} (lead={lead})")
            flat = leaf.reshape(tuple(leaf.shape[:lead]) + (slot.size,))
            if out is not None:
                out[slot.group][..., slot.offset:slot.offset + slot.size] \
                    .copy_(flat)
            else:
                chunks[slot.group].append(
                    flat.to(self.group_dtypes[slot.group]))
        if out is not None:
            return out
        return {n: (torch.cat(c, dim=-1) if len(c) > 1 else c[0])
                for n, c in chunks.items()}

    def unpack(self, plane: Dict[str, torch.Tensor]):
        """``{group: (*lead, group_size)}`` → tree (original shapes and
        dtypes, leading axes preserved). Slices and reshapes: views of the
        plane, not copies."""
        leaves = []
        for slot in self._slots:
            buf = plane[slot.group]
            lead = tuple(buf.shape[:-1])
            piece = buf[..., slot.offset:slot.offset + slot.size]
            leaves.append(piece.reshape(lead + slot.shape).to(slot.dtype))
        return tree_unflatten(self._treedef, leaves)


@dataclass
class LayerView:
    """Layer-grouped stacked parameters + per-group version clocks."""

    groups: Any              # a tree of (M, ...) leaves
    versions: torch.Tensor   # (M, G) float32 generation-time stamps
    names: Tuple[str, ...] = ()

    @property
    def num_groups(self) -> int:
        return len(self.names)

    def with_groups(self, groups) -> "LayerView":
        return replace(self, groups=groups)

    def with_versions(self, versions) -> "LayerView":
        return replace(self, versions=versions)


# ---------------------------------------------------------------------------
# version-clock arithmetic
# ---------------------------------------------------------------------------


def send_fractions(G: int, bwd_ratio: float = 2.0) -> np.ndarray:
    """Fractional iteration time at which group ``g``'s update is generated
    during the backward pass:
    ``phi_g = (1 + bwd_ratio * (G - g)/G) / (1 + bwd_ratio)`` ∈ (0, 1]."""
    g = np.arange(G, dtype=np.float32)
    return ((1.0 + bwd_ratio * (G - g) / G)
            / (1.0 + bwd_ratio)).astype(np.float32)


def stamp_groups(versions: torch.Tensor, value,
                 worker_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-merge new generation-time stamps into the ``(M, G)`` clock.
    ``value`` (a number or a tensor on the clock's device) broadcasts
    against ``(M, G)``; ``worker_mask`` ((M,) bool) restricts the stamp to
    the receiving workers. Versions never move back."""
    if isinstance(value, torch.Tensor):
        stamped = torch.maximum(versions, value.to(torch.float32))
    else:
        stamped = torch.clamp(versions, min=float(np.float32(value)))
    if worker_mask is None:
        return stamped
    return torch.where(worker_mask.reshape(-1, 1), stamped, versions)


def layer_staleness(versions: torch.Tensor, step) -> torch.Tensor:
    """Per-group staleness ``(G,)`` at the end of iteration ``step``: mean
    over workers of ``(step + 1) - versions``, clipped at 0."""
    now = float(np.float32(step) + np.float32(1.0))
    return torch.clamp(now - versions, min=0.0).mean(dim=0)


def version_metrics(versions: torch.Tensor, step) -> Dict[str, torch.Tensor]:
    """The staleness metrics the prod decoupled lane reports."""
    ls = layer_staleness(versions, step)
    return {"layer_staleness": ls, "staleness_mean": ls.mean()}
