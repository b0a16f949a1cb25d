"""LayUp — the paper's algorithm (Alg. 1); port of ``repro/core/layup.py``.

Asynchronous decentralized SGD with push-sum randomized gossip and
layer-wise updates (DESIGN.md §4):

1. **Zero-delay mixing** — each layer's parameters are sent *during* the
   backward pass, so a peer's next forward sees them immediately
   (``layerwise=True``). With ``layerwise=False`` ("block updates", ≡
   GoSGD) the whole-model message lands only after the full backward, one
   iteration later (a two-slot queue in ``extras``).
2. **Mixed-version updates** — the local update computed at the forward
   pass's parameters is applied on top of freshly *mixed* parameters (the
   gradient bias of Lemma 6.1).
3. **Per-layer version stamps** — receivers stamp each layer group with the
   fractional generation time of the message (``send_fractions``).

Collisions (two senders picking the same peer) skip the losing send with
weights untouched, conserving Σw exactly (paper §3.1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import (DistAlgorithm, choose_peers, columns_,
                                  pushsum_weight_update, register_algorithm)
from repro_torch.core.layerview import LayerView, send_fractions, stamp_groups
from repro_torch.core.pytree import tree_map


class LayUp(DistAlgorithm):
    asynchronous = True

    def __init__(self, layerwise: bool = True, name: str = "layup",
                 peer_mode: str = "random"):
        """peer_mode: 'random' (the paper's randomized gossip) or
        'hypercube' (deterministic XOR partners i ↔ i⊕2^(t mod log₂M): a
        perfect matching every step, collision-free by construction)."""
        self.layerwise = layerwise
        self.name = name
        self.peer_mode = peer_mode
        self._phi = {}  # send_fractions on each device, copied once

    def _peers(self, rng, M: int, active: torch.Tensor, step: int):
        if self.peer_mode == "hypercube":
            bits = max(int(np.ceil(np.log2(M))), 1)
            stride = 1 << (int(step) % bits)
            me = torch.arange(M, device=active.device)
            peers = torch.bitwise_xor(me, stride)
            valid = peers < M  # non-power-of-two M: unpaired workers idle
            clipped = torch.clamp(peers, 0, M - 1)
            send_ok = active & valid
            has_recv = send_ok[clipped] & valid
            sender_idx = torch.where(has_recv, clipped,
                                     torch.zeros_like(clipped))
            return send_ok, has_recv, sender_idx
        return choose_peers(rng, M, active)

    def _send_fractions(self, G: int, device) -> torch.Tensor:
        key = (G, device)
        if key not in self._phi:
            self._phi[key] = torch.from_numpy(send_fractions(G)).to(device)
        return self._phi[key]

    # -- pending-buffer helpers (block mode only) ------------------------------
    #
    # Block (≡ GoSGD) messages carry the WHOLE model and are sent only after
    # the full backward pass, one extra iteration of staleness versus
    # layer-wise sends (paper §3.2): a 2-slot message queue, each slot with
    # the generation-time stamp its receivers merge into their clocks.
    def _empty_slot(self, groups, M: int, device):
        return {"vals": tree_map(torch.zeros_like, groups),
                "w": torch.zeros((M,), dtype=torch.float32, device=device),
                "valid": torch.zeros((M,), dtype=torch.bool, device=device),
                "stamp": 0.0}

    def init_extras(self, view: LayerView, M: int):
        if self.layerwise:
            return ()
        device = view.versions.device
        return {"q0": self._empty_slot(view.groups, M, device),
                "q1": self._empty_slot(view.groups, M, device)}

    def pre(self, view: LayerView, weights, extras, step: int):
        if self.layerwise:
            return view, weights, extras
        # apply the oldest buffered block mix (sent two iterations ago)
        slot = extras["q0"]
        w_s, valid = slot["w"], slot["valid"]
        denom = torch.clamp(weights + w_s, min=1e-12)
        alpha = torch.where(valid, weights / denom, torch.ones_like(denom))
        beta = torch.where(valid, w_s / denom, torch.zeros_like(denom))

        def mix(x, v):
            a = self._bcast(alpha, x)
            b = self._bcast(beta, x)
            return (a * x.to(torch.float32)
                    + b * v.to(torch.float32)).to(x.dtype)

        groups = tree_map(lambda x, v: columns_(mix, x, v), view.groups,
                          slot["vals"])
        weights = weights + torch.where(valid, w_s, torch.zeros_like(w_s))
        versions = stamp_groups(view.versions, slot["stamp"],
                                worker_mask=valid)
        extras = {"q0": extras["q1"],
                  "q1": {**slot, "valid": torch.zeros_like(valid),
                         "w": torch.zeros_like(w_s)}}
        return (view.with_groups(groups).with_versions(versions), weights,
                extras)

    def post(self, view: LayerView, weights, extras, updates, active, rng,
             step: int):
        M = weights.shape[0]
        send_ok, has_recv, sender_idx = self._peers(rng, M, active, step)
        af = active.to(torch.float32)
        metrics = {"gossip_sends": torch.sum(send_ok.to(torch.float32))}

        if self.layerwise:
            # the sender transmits its *updated* layer; the receiver mixes,
            # then its own update lands on the mixed value (Lemma 6.1's
            # bias). A worker that is also a winning sender mixes with its
            # post-halving weight, which conserves Σ wᵢxᵢ exactly.
            w_self = torch.where(send_ok, weights * 0.5, weights)
            w_s = (weights * 0.5)[sender_idx]  # the winners' halved mass
            denom = torch.clamp(w_self + w_s, min=1e-12)
            alpha = torch.where(has_recv, w_self / denom,
                                torch.ones_like(denom))
            beta = torch.where(has_recv, w_s / denom, torch.zeros_like(denom))
            recv = has_recv.to(torch.float32)

            def apply_leaf(x, u):
                xf = x.to(torch.float32)
                uf = self._bcast(af, x) * u.to(torch.float32)
                upd_x = xf + uf  # the sender-side value
                sent = upd_x.index_select(0, sender_idx)
                a = self._bcast(alpha, x)
                b = self._bcast(beta, x)
                mixed = a * xf + b * sent + uf
                del sent
                out = torch.where(self._bcast(recv, x) > 0, mixed, upd_x)
                return out.to(x.dtype)

            new_groups = tree_map(lambda x, u: columns_(apply_leaf, x, u),
                                  view.groups, updates)
            new_weights = pushsum_weight_update(weights, send_ok, has_recv,
                                                sender_idx)
            # layer ℓ's message is generated mid-backward at
            # send_fractions[ℓ]
            phi = self._send_fractions(view.num_groups, weights.device)
            versions = stamp_groups(view.versions,
                                    phi + float(np.float32(step)),
                                    worker_mask=has_recv)
            return (view.with_groups(new_groups).with_versions(versions),
                    new_weights, extras, metrics)

        # ---- block mode (≡ GoSGD): update now, enqueue the mix --------------
        # the message is written into the emptied slot's buffers (``pre``
        # moved the applied slot there; nothing reads them before this)
        new_groups = self.masked_apply(view.groups, updates, active)
        sent = tree_map(lambda x, d: torch.index_select(x, 0, sender_idx,
                                                        out=d),
                        new_groups, extras["q1"]["vals"])
        w_half = weights * 0.5
        new_weights = torch.where(send_ok, w_half, weights)
        extras = {
            "q0": extras["q0"],
            "q1": {
                "vals": sent,
                "w": torch.where(has_recv, w_half[sender_idx],
                                 torch.zeros_like(w_half)),
                "valid": has_recv,
                # whole-model message generated at the end of this iteration
                "stamp": float(np.float32(step) + np.float32(1.0)),
            },
        }
        return (view.with_groups(new_groups), new_weights, extras, metrics)


@register_algorithm("layup")
def _layup(**kw):
    return LayUp(layerwise=True, name="layup", **kw)


@register_algorithm("layup-block")
def _layup_block():
    """Ablation: LayUp without layer-wise updates (end-of-iteration mix)."""
    return LayUp(layerwise=False, name="layup-block")


@register_algorithm("layup-hypercube")
def _layup_hypercube():
    """Deterministic hypercube gossip schedule."""
    return LayUp(layerwise=True, name="layup-hypercube",
                 peer_mode="hypercube")
