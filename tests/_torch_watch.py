"""A loss wrapper that catches a plane written while a forward reads it
(shared by the CPU and the card's stream-engine tests; imports no jax)."""
import time

import torch


class PlaneWatch:
    """Wraps ``loss_fn(params, batch)``: a float64 checksum of the
    parameters it is given, taken on the current stream just before and
    just after the loss, for every call. If another stream (or thread)
    wrote the plane in between, a pair differs.

    ``hold`` widens the window after the loss, so that a write that could
    happen there does: ``hold`` seconds of sleep in the calling thread on
    the CPU, a spin kernel of ``hold`` × 1e9 cycles on the current CUDA
    stream on the card."""

    def __init__(self, loss_fn, hold: float = 0.0):
        self.loss_fn = loss_fn
        self.hold = float(hold)
        self.pairs = []

    @staticmethod
    def checksum(params):
        from repro_torch.core.pytree import tree_leaves
        return torch.stack([p.detach().double().sum()
                            for p in tree_leaves(params)])

    def __call__(self, params, batch):
        before = self.checksum(params)
        out = self.loss_fn(params, batch)
        if self.hold > 0.0:
            if before.is_cuda:
                torch.cuda._sleep(int(self.hold * 1e9))
            else:
                time.sleep(self.hold)
        self.pairs.append((before, self.checksum(params)))
        return out

    def changed(self):
        """The number of calls whose plane changed under them."""
        return sum(not torch.equal(a, b) for a, b in self.pairs)
