"""Batched serving loop: slot-based continuous batching over the decode
step (port of ``repro/launch/serve.py``).

A fixed decode batch of ``num_slots`` sequences; requests are admitted into
free slots, each slot decodes with its own position counter (the decode step
takes per-sequence positions), and finished sequences (EOS / max-tokens)
free their slot immediately for the next queued request — the standard
continuous-batching pattern.

Prompts are consumed through the decode path one token at a time
("prefill-by-decode"), which works uniformly for every architecture family
(attention caches, SSM states).

The loop is live-swappable: ``set_params`` atomically rebinds the whole
parameter tree between decode steps (``step_once`` is the step
granularity), which is how ``repro_torch.serving.LiveServer`` hot-swaps
weights published from the training read plane (DESIGN.md §12).
``stats()`` summarizes throughput and occupancy.

The cache lives on the loop's device (``device=None`` is CUDA, which must
exist) and the decode step writes it in place. A step makes one copy to
the host: the greedy tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.pytree import tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models.transformer import alloc_cache


@dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    output: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                # next cache position to write
    cursor: int = 0             # prompt tokens consumed
    last_tok: int = 0           # last generated token (decode phase)


def _check_params(params, device: torch.device) -> None:
    for leaf in tree_leaves(params):
        if leaf.device != device:
            raise ValueError(
                f"params on {leaf.device}, the serve loop on {device}: "
                "move them first (the loop never moves weights itself)")


class ServeLoop:
    def __init__(self, model, params, *, num_slots: int = 4,
                 max_len: int = 256, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        _check_params(params, self.device)
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.slots = [_Slot() for _ in range(num_slots)]
        self.queue: List[Request] = []
        self.steps_run = 0
        self.tokens_emitted = 0
        self.requests_completed = 0
        self.params_version = None   # provenance tag set by set_params
        self._busy_slot_steps = 0    # Σ over steps of occupied slots
        self.cache = alloc_cache(model.cache_specs(num_slots, max_len),
                                 device=self.device)

    def submit(self, req: Request):
        self.queue.append(req)

    def set_params(self, params, version=None):
        """Atomically rebind the serving parameters. Called between decode
        steps only (``step_once`` reads ``self.params`` exactly once per
        step), so a decode step sees either the whole old tree or the
        whole new one — never a mix. ``version`` is an opaque provenance
        tag (the live path passes ``(snapshot.seq, training_step)``)."""
        _check_params(params, self.device)
        self.params = params
        self.params_version = version

    # -- internals -------------------------------------------------------------
    def _reset_slot(self, i: int):
        """Zero a slot's cache entries (SSM states carry across sequences;
        attention slots are position-masked but cleared for hygiene)."""
        for c in tree_leaves(self.cache):
            c[:, i].zero_()

    def _admit(self):
        for i, s in enumerate(self.slots):
            if s.req is None and self.queue:
                s.req = self.queue.pop(0)
                s.pos = s.cursor = 0
                s.last_tok = 0
                self._reset_slot(i)

    def _feed_tokens(self) -> np.ndarray:
        toks = np.zeros(self.num_slots, np.int32)
        for i, s in enumerate(self.slots):
            if s.req is None:
                continue
            if s.cursor < len(s.req.prompt):
                toks[i] = int(s.req.prompt[s.cursor])
            else:
                toks[i] = s.last_tok
        return toks

    def _advance(self, logits):
        # the step's one copy to the host
        greedy = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, s in enumerate(self.slots):
            r = s.req
            if r is None:
                continue
            in_prompt = s.cursor < len(r.prompt)
            if in_prompt:
                s.cursor += 1
            # once the LAST prompt token has been fed, every step emits a
            # generated token
            if not in_prompt or s.cursor == len(r.prompt):
                s.last_tok = int(greedy[i])
                r.output.append(s.last_tok)
                self.tokens_emitted += 1
            s.pos += 1
            if (len(r.output) >= r.max_new_tokens
                    or (r.eos_id is not None and r.output
                        and r.output[-1] == r.eos_id)
                    or s.pos >= self.max_len):
                r.done = True
                self.requests_completed += 1
                s.req = None  # free the slot (cache slots position-masked)

    # -- public API --------------------------------------------------------------
    def step_once(self) -> bool:
        """Admit from the queue, run ONE decode step over the slots, and
        retire finished sequences. Returns False (and runs no device work)
        when every slot is empty after admission — the loop is idle.

        This is the swap granularity: callers that rebind ``params``
        (``set_params``) between ``step_once`` calls get atomic weight
        swaps for free, since the decode step reads ``self.params`` once."""
        self._admit()
        if all(s.req is None for s in self.slots):
            return False
        self._busy_slot_steps += sum(s.req is not None for s in self.slots)
        toks = torch.from_numpy(self._feed_tokens())[:, None].to(self.device)
        positions = torch.tensor([s.pos for s in self.slots],
                                 dtype=torch.int64, device=self.device)
        logits, self.cache = self.model.decode_fn(self.params, self.cache,
                                                  toks, positions)
        self._advance(logits)
        self.steps_run += 1
        return True

    def run(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step_once():
                break

    def stats(self) -> Dict[str, Any]:
        """Run summary: steps, throughput and occupancy."""
        steps = self.steps_run
        return {
            "steps_run": steps,
            "tokens_emitted": self.tokens_emitted,
            "requests_completed": self.requests_completed,
            "queue_depth": len(self.queue),
            "slots_busy": sum(s.req is not None for s in self.slots),
            "num_slots": self.num_slots,
            "slot_occupancy": (self._busy_slot_steps
                               / (steps * self.num_slots) if steps else 0.0),
            "params_version": self.params_version,
        }

    def serve(self, requests: List[Request],
              max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Submit all requests, run to completion, return uid → tokens."""
        for r in requests:
            self.submit(r)
        self.run(max_steps)
        return {r.uid: r.output for r in requests}
