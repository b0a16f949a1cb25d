"""Sharded, prefetching data iterator (port of ``repro/data/pipeline.py``).

A background thread makes the per-worker numpy batches, deterministic per
(seed, step, worker) (``make_worker_batches``, draw for draw the JAX
package's); the consuming thread moves each one to the device. On a CUDA
device a batch is copied into page-locked host memory and uploaded with
``non_blocking=True``, so the copy runs on the current stream without
holding up the host; on the CPU the numpy arrays are wrapped as they are.
The stacked ``(M, ...)`` leading axis is the gossip-worker axis.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import make_worker_batches
from repro_torch.device import resolve_device


class ShardedIterator:
    """Endless iterator over ``{key: (num_workers, batch_per_worker, ...)}``
    tensors on ``device`` (default CUDA, which must exist); ``prefetch``
    batches are made ahead. ``close()`` stops the producer thread."""

    def __init__(self, dataset, num_workers: int, batch_per_worker: int,
                 *, prefetch: int = 2, seed: int = 0, device=None):
        self.dataset = dataset
        self.num_workers = num_workers
        self.batch_per_worker = batch_per_worker
        self.seed = seed
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = 0
        while not self._stop.is_set():
            batch = make_worker_batches(self.dataset, self.num_workers,
                                        self.batch_per_worker, step,
                                        epoch_seed=self.seed)
            try:
                self._q.put(batch, timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = None
        while batch is None and not self._stop.is_set():
            try:
                batch = self._q.get(timeout=5.0)
            except queue.Empty:
                raise StopIteration
        if batch is None:
            raise StopIteration
        return {k: self._upload(v) for k, v in batch.items()}

    def close(self):
        self._stop.set()
