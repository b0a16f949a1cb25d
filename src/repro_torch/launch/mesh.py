"""The worker mesh (port of ``repro/launch/mesh.py``).

The JAX package spreads its M gossip workers over the ``("pod", "data")``
axes of a device mesh, one worker a device, and shards each worker's
parameters over ``"model"``. The port's :class:`WorkerMesh` has two
layouts:

* without a process group, the M workers are stacked on the leading
  dimension of every plane buffer on one device;
* with a ``torch.distributed`` group of ``world`` ranks, rank ``r`` holds
  the ``L = M // world`` consecutive workers ``[r·L, (r+1)·L)``, stacked
  the same way on its own device. The push-sum ring hop
  (:meth:`WorkerMesh.ring_hop`) then crosses ranks, as the reference's
  ``ppermute`` does, and the loss, skip and drift reductions go through
  :meth:`WorkerMesh.all_gather_rows` and :meth:`WorkerMesh.all_reduce_sum_`
  (its ``pmean`` and ``psum``).

The transport follows the group's backend: ``nccl`` moves device tensors
directly; ``gloo`` moves CPU tensors directly and stages CUDA tensors
through pinned host buffers (gloo's point-to-point ops take host memory),
timing that staging apart in ``stats["staging_s"]``. An ``nccl`` group on a
CPU device is refused. Nothing falls back from one transport to another.

A user launches the ring on N cards with ``torchrun --nproc_per_node=N``,
``dist.init_process_group("nccl")`` and ``WorkerMesh(M,
f"cuda:{local_rank}", dist.group.WORLD)``.

Beside the hop and the reductions, the mesh moves one global row from
the rank that owns it to the rank that owns another (:meth:`WorkerMesh.
copy_row_`, a donor re-sync), gathers a buffer's rows on one rank
(:meth:`WorkerMesh.gather_rows_to`, a checkpoint), checks that every rank
holds the same small host value (:meth:`WorkerMesh.agree`: a schedule, a
resume step) and gives each thread of the stream engine a process group
of its own (:meth:`WorkerMesh.role_meshes`). Without a group each is the
one-process operation (a local copy, the buffer itself, the value).

``make_production_mesh`` (the TPU pod's (16, 16) and expert-parallel
layouts) has no analogue.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

# The decoupled step's per-worker state entries (``launch.train.
# make_decoupled_state``), as paths of dict keys: a donor re-sync copies
# their rows (``chaos.recovery.resync_peer``). Over a mesh with a process
# group a rank holds its L rows of ``ROW_ENTRIES``; the version clocks
# depend on the host-drawn shifts and the step only, so every rank keeps
# all M of them, as it keeps ``w``.
WORKER_ENTRIES = (("read",), ("write",), ("opt",), ("versions",),
                  ("resid",), ("theta",), ("fifo", "g"))
ROW_ENTRIES = tuple(e for e in WORKER_ENTRIES if e != ("versions",))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view: the wire is
    indifferent to the dtype (int8, bf16, f32 alike)."""
    return t.reshape(-1).view(torch.uint8)


@dataclass(frozen=True)
class WorkerMesh:
    """``workers`` gossip workers. Without ``group``, all of them are
    stacked on ``device`` (``None``: CUDA, which must exist). With a
    ``torch.distributed`` process group, this rank holds the ``L = workers
    // world`` consecutive workers :attr:`rows` on ``device`` (the caller's
    ``cuda:<local_rank>``, or ``cpu``).

    ``stats`` counts what crossed ranks: ``bytes_sent`` (this rank's bytes
    sent to other ranks) and ``staging_s`` (host seconds of the
    pinned-buffer copies of a gloo group on CUDA tensors). The role meshes
    (:meth:`role_meshes`) count into their parent's ``stats``."""

    workers: int
    device: Any = None
    group: Any = field(default=None, compare=False)
    stats: Dict[str, float] = field(default_factory=dict, init=False,
                                    compare=False, repr=False)
    _host: Dict[Tuple[str, int], torch.Tensor] = field(
        default_factory=dict, init=False, compare=False, repr=False)
    _lock: Any = field(default_factory=threading.Lock, init=False,
                       compare=False, repr=False)
    _roles: Dict[str, "WorkerMesh"] = field(
        default_factory=dict, init=False, compare=False, repr=False)

    def __post_init__(self):
        if int(self.workers) < 1:
            raise ValueError(f"a mesh needs >= 1 worker, got {self.workers}")
        if self.group is not None:
            world = self.world
            if self.workers % world:
                raise ValueError(
                    f"{self.workers} workers do not split over {world} "
                    "ranks: WorkerMesh needs workers % world == 0")
            backend = self.backend
            if backend not in ("gloo", "nccl"):
                raise ValueError(f"unsupported process group backend "
                                 f"{backend!r} (expected 'gloo' or 'nccl')")
            dev = torch.device("cuda" if self.device is None
                               else self.device)
            if backend == "nccl" and dev.type != "cuda":
                raise ValueError(f"an nccl group moves CUDA tensors; the "
                                 f"mesh's device is {dev}")
        self.reset_stats()

    # -- layout -------------------------------------------------------------

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        """The group's backend (``"gloo"``, ``"nccl"``), ``None`` without
        one."""
        if self.group is None:
            return None
        import torch.distributed as dist
        return str(dist.get_backend(self.group))

    @property
    def local_workers(self) -> int:
        """``L``: the workers this rank holds."""
        return self.workers // self.world

    @property
    def rows(self) -> range:
        """The global indices of this rank's workers."""
        L = self.local_workers
        return range(self.rank * L, (self.rank + 1) * L)

    def resolved_device(self) -> torch.device:
        """The device, resolved (``None``: CUDA, which must exist)."""
        from repro_torch.device import resolve_device
        return resolve_device(self.device)

    def local(self, t):
        """This rank's rows of a tensor (or numpy array) over all
        ``workers`` on its leading dim (a view); the tensor itself without
        a group."""
        if self.group is None:
            return t
        return t[self.rows.start:self.rows.stop]

    def owner(self, row: int) -> int:
        """The rank that holds global worker ``row`` (0 without a group)."""
        row = int(row)
        if not 0 <= row < self.workers:
            raise ValueError(f"worker {row} out of range for "
                             f"{self.workers} workers")
        return row // self.local_workers

    def local_index(self, row: int) -> int:
        """Global worker ``row``'s index among this rank's rows; raises
        ``ValueError`` when another rank holds it."""
        if self.owner(row) != self.rank:
            raise ValueError(f"worker {row} is held by rank "
                             f"{self.owner(row)}, not by rank {self.rank} "
                             f"(rows {self.rows.start}..{self.rows.stop - 1})")
        return int(row) - self.rows.start

    def role_meshes(self, roles: Sequence[str]) -> Dict[str, "WorkerMesh"]:
        """A mesh for each of ``roles`` (the stream engine's threads), each
        on a process group of its own over this mesh's ranks: two threads'
        operations on one group would meet in no order that matches across
        ranks (NCCL can deadlock on them). The groups are made on the first
        call for a role, in the order given, so every rank must make the
        same calls (as ``torch.distributed.new_group`` requires of every
        rank of the default group). They share this mesh's workers, device
        and ``stats``. Without a group: this mesh for every role."""
        if self.group is None:
            return {r: self for r in roles}
        import torch.distributed as dist

        for r in roles:
            if r not in self._roles:
                group = dist.new_group(
                    ranks=dist.get_process_group_ranks(self.group),
                    backend=self.backend)
                mesh = WorkerMesh(self.workers, self.device, group)
                object.__setattr__(mesh, "stats", self.stats)
                object.__setattr__(mesh, "_lock", self._lock)
                self._roles[r] = mesh
        return {r: self._roles[r] for r in roles}

    # -- transport ----------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self.stats.update(bytes_sent=0.0, staging_s=0.0)

    def _count(self, key: str, v: float) -> None:
        with self._lock:  # role meshes count from threads of their own
            self.stats[key] += float(v)

    @property
    def staged(self) -> bool:
        """True when tensors cross through pinned host buffers: a gloo
        group on a CUDA device."""
        return (self.backend == "gloo"
                and torch.device("cuda" if self.device is None
                                 else self.device).type == "cuda")

    @property
    def transport(self) -> str:
        """``"local"`` (no group), ``"nccl"``, ``"gloo"`` or
        ``"gloo+pinned-host-staging"``."""
        if self.group is None:
            return "local"
        return self.backend + ("+pinned-host-staging" if self.staged
                               else "")

    def _host_buffer(self, role: str, peer: int, nbytes: int):
        """A pinned host buffer of at least ``nbytes`` for (``role``,
        ``peer``), kept and grown across hops."""
        buf = self._host.get((role, peer))
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._host[(role, peer)] = buf
        return buf[:nbytes]

    def _timed_copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """A staging copy between a CUDA tensor and a pinned host buffer,
        timed into ``staging_s``. It is enqueued on the calling thread's
        current CUDA stream, the stage's own on a stream engine's thread,
        behind the work queued there (the producer of ``src``), and the
        host then waits for that stream only."""
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(dst.device if dst.is_cuda
                                           else src.device)
        dst.copy_(src, non_blocking=True)
        stream.synchronize()
        self._count("staging_s", time.perf_counter() - t0)

    def _exchange(self, sends: List[Tuple[int, torch.Tensor]],
                  recvs: List[Tuple[int, torch.Tensor]]) -> None:
        """One batch of point-to-point ops: each ``(peer, tensor)`` of
        ``sends`` goes to the group rank ``peer``, each of ``recvs`` is
        filled from it. Every op is waited on before return."""
        import torch.distributed as dist

        staged = self.staged
        ops, landing = [], []
        for peer, t in sends:
            t = _bytes(t)
            if staged:
                h = self._host_buffer("send", peer, t.numel())
                self._timed_copy(h, t)
                t = h
            self._count("bytes_sent", t.numel())
            ops.append(dist.P2POp(dist.isend, t,
                                  dist.get_global_rank(self.group, peer),
                                  self.group))
        for peer, t in recvs:
            t = _bytes(t)
            if staged:
                h = self._host_buffer("recv", peer, t.numel())
                landing.append((t, h))
                t = h
            ops.append(dist.P2POp(dist.irecv, t,
                                  dist.get_global_rank(self.group, peer),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, h in landing:
            self._timed_copy(dst, h)

    def ring_hop(self, buf: torch.Tensor, s: int) -> torch.Tensor:
        """One push-sum ring hop of this rank's ``(L, ...)`` rows by the
        shift ``s``: a fresh ``(L, ...)`` buffer in which global row ``j``
        holds global row ``(j − s) mod M``, exactly ``torch.roll(full, s,
        0)[rows]`` (worker ``i`` sends to ``i + s mod M``, the reference's
        ``ppermute``). Without a group it is ``torch.roll(buf, s, 0)``.

        The rank's sources are one run of rows modulo M, held by at most
        two ranks: rows it holds itself are copied locally, the rest come
        in one batch of point-to-point ops with the one or two peers, and
        the matching sends go out in the same batch."""
        if self.group is None:
            return torch.roll(buf, s, 0)
        M, L, me = self.workers, self.local_workers, self.rank
        lo = me * L
        s = int(s) % M
        buf = buf.contiguous()
        out = torch.empty_like(buf)
        recvs, sends = [], []
        k = 0
        while k < L:  # runs of this rank's rows fed by one source rank
            src = (lo + k - s) % M
            n = min(L - k, L - src % L)
            if src // L == me:
                out[k:k + n].copy_(buf[src - lo:src - lo + n])
            else:
                recvs.append((src // L, out[k:k + n]))
            k += n
        k = 0
        while k < L:  # runs of this rank's rows bound for one rank
            dst = (lo + k + s) % M
            n = min(L - k, L - dst % L)
            if dst // L != me:
                sends.append((dst // L, buf[k:k + n]))
            k += n
        self._exchange(sends, recvs)
        return out

    def _on_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the collective reads it: a host copy when staged."""
        if not self.staged:
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._timed_copy(h, t)
        return h

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's ``(L, ...)`` rows gathered into the ``(M, ...)``
        tensor of every rank's, in global row order (the identity without a
        group)."""
        if self.group is None:
            return t
        import torch.distributed as dist

        src = self._on_wire(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        full = torch.cat(parts)
        if self.staged:
            dev = torch.empty(full.shape, dtype=full.dtype, device=t.device)
            self._timed_copy(dev, full)
            return dev
        return full

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place (the identity without a
        group). Returns ``t``."""
        if self.group is None:
            return t
        import torch.distributed as dist

        src = self._on_wire(t)
        dist.all_reduce(src, op=dist.ReduceOp.SUM, group=self.group)
        if src is not t:
            self._timed_copy(t, src)
        return t

    # -- rows of one worker, gathers, agreement -----------------------------

    def copy_row_(self, t: torch.Tensor, src: int, dst: int) -> None:
        """Global row ``dst`` of a row-spread buffer ← global row ``src``,
        in place (``t`` holds this rank's rows; without a group all of
        them): a local copy where one rank owns both, else a point-to-point
        copy from ``src``'s owner to ``dst``'s; a no-op on the other
        ranks."""
        if self.group is None:
            t[dst].copy_(t[src])
            return
        me, s_own, d_own = self.rank, self.owner(src), self.owner(dst)
        if s_own == d_own:
            if me == s_own:
                t[self.local_index(dst)].copy_(t[self.local_index(src)])
            return
        if me == s_own:
            self._exchange([(d_own, t[self.local_index(src)].contiguous())],
                           [])
        elif me == d_own:
            row = t[self.local_index(dst)]
            land = row if row.is_contiguous() else torch.empty_like(row)
            self._exchange([], [(s_own, land)])
            if land is not row:
                row.copy_(land)

    def gather_rows_to(self, t: torch.Tensor, dst: int = 0):
        """The ``(M, ...)`` buffer of every rank's rows of ``t`` in global
        row order, on rank ``dst`` (on ``t``'s device); ``None`` on the
        other ranks, which send theirs. ``t`` itself without a group."""
        if self.group is None:
            return t
        L = self.local_workers
        if self.rank != dst:
            self._exchange([(dst, t.contiguous())], [])
            return None
        full = torch.empty((self.workers,) + tuple(t.shape[1:]),
                           dtype=t.dtype, device=t.device)
        full[dst * L:(dst + 1) * L].copy_(t)
        self._exchange([], [(r, full[r * L:(r + 1) * L])
                            for r in range(self.world) if r != dst])
        return full

    def agree(self, value, what: str):
        """Check that every rank holds the same small host ``value`` (a
        JSON-able schedule, key or step): each rank gathers the others'
        SHA-256 of its canonical JSON, and where any differs EVERY rank
        raises ``RuntimeError``, so that none goes on into a hang. Returns
        ``value``; the identity without a group."""
        if self.group is None:
            return value
        text = json.dumps(value, sort_keys=True, default=repr)
        digest = np.frombuffer(hashlib.sha256(text.encode()).digest(),
                               dtype=np.int64).copy()
        mine = torch.from_numpy(digest).to(self.resolved_device())
        every = self.all_gather_rows(mine).reshape(self.world, -1).cpu()
        differ = [r for r in range(self.world)
                  if not torch.equal(every[r], every[0])]
        if differ:
            raise RuntimeError(
                f"the ranks of the mesh hold different {what}: rank(s) "
                f"{differ} differ from rank 0 (rank {self.rank} has "
                f"{text})")
        return value
