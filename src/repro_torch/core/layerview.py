"""Layer-granular parameter views and the persistent flat plane.

Port of ``repro/core/layerview.py`` (the parts the prod training step uses):

* ``LayerPartition`` splits a parameter tree into layer groups: the
  top-level key, or ``"<key>.<idx>"`` for per-layer containers (lists of
  blocks). Group names are sorted.
* ``FlatPartition`` fixes one contiguous buffer per layer group and dtype
  (leaves flattened in C order and concatenated in tree order; a group that
  mixes dtypes gets one ``"<group>:<dtype>"`` buffer per dtype). ``pack`` and
  ``unpack`` take any number of leading axes: ``(M, ...)`` worker stacks,
  ``(M, D, ...)`` FIFO stacks. ``unpack`` returns views (slice + reshape).
* The version-clock arithmetic (``send_fractions``, ``stamp_groups``,
  ``layer_staleness``, ``version_metrics``) on ``(M, G)`` float32 tensors.

Trees are flattened in jax order (sorted dict keys, see
``repro_torch.core.pytree``), so group names, sizes and every offset match
the JAX package's plane exactly.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import (DictKey, SequenceKey,
                                     tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)


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

    @property
    def num_groups(self) -> int:
        return len(self.names)

    def init_versions(self, M: int, device=None) -> torch.Tensor:
        return torch.zeros((M, self.num_groups), dtype=torch.float32,
                           device=device)


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
        cost per peer, each group priced at its param dtype."""
        if wire == "int8":
            raise NotImplementedError(
                "wire='int8' is not ported yet (ROADMAP queue 1, item 8)")
        if wire != "param":
            raise ValueError(f"unknown wire dtype {wire!r}")
        return sum(size * self.group_dtypes[n].itemsize
                   for n, size in self.group_sizes.items())

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


def stamp_groups(versions: torch.Tensor, value) -> torch.Tensor:
    """Max-merge new generation-time stamps into the ``(M, G)`` clock.
    ``value`` broadcasts against ``(M, G)``. Versions never move back."""
    value = torch.as_tensor(value, dtype=torch.float32,
                            device=versions.device).expand_as(versions)
    return torch.maximum(versions, value)


def layer_staleness(versions: torch.Tensor, step) -> torch.Tensor:
    """Per-group staleness ``(G,)`` at the end of iteration ``step``: mean
    over workers of ``(step + 1) - versions``, clipped at 0."""
    now = float(np.float32(step) + np.float32(1.0))
    return torch.clamp(now - versions, min=0.0).mean(dim=0)


def version_metrics(versions: torch.Tensor, step) -> Dict[str, torch.Tensor]:
    """The staleness metrics the prod decoupled lane reports."""
    ls = layer_staleness(versions, step)
    return {"layer_staleness": ls, "staleness_mean": ls.mean()}
