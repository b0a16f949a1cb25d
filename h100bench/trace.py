"""The profiled part of a ``--trace 1`` run: device kernels and the
host's CUDA calls from ``torch.profiler`` (CUDA activity), reduced to what
the per-layer readers and the result's ``breakdown`` need.

Device busy time is the union of the device events' intervals, merged over
streams; an idle gap is a stretch of the profiled window in which no
device event ran.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# kernel families of the breakdown, by name; the first pattern that
# matches wins, and whatever matches none is elementwise work
FAMILIES = (
    ("flash", re.compile(r"flash_")),
    ("gossip/quantize", re.compile(r"^_mix_kernel|quantize_plane|dequant_mix")),
    # cuBLAS and CUTLASS products; Hopper's cuBLASLt kernels are named
    # nvjet_*, and split-K products end in a splitKreduce pass
    ("gemm", re.compile(r"gemm|gemv|xmma|cutlass|nvjet|splitKreduce", re.I)),
    ("copies", re.compile(r"^Memcpy|^Memset|copy|CatArrayBatched|fill", re.I)),
)
COPY = re.compile(r"^Memcpy|^Memset")


def family(name: str) -> str:
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "elementwise"


def short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = re.sub(r"^void\s+|\(anonymous namespace\)::", "", name)
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:96] or name[:96]


@dataclass
class Trace:
    steps: int
    window_s: float
    kernels: List[Tuple[str, int, int]]   # (name, start ns, duration ns)
    host_ops: List[Tuple[str, int, int]]
    busy_s: float = 0.0
    gaps: List[Tuple[int, int]] = field(default_factory=list)

    def __post_init__(self):
        spans = sorted((s, s + d) for _, s, d in self.kernels)
        merged: List[List[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        self.gaps = [(merged[i][1], merged[i + 1][0])
                     for i in range(len(merged) - 1)]

    def by_name(self, pattern) -> List[Tuple[str, int, int]]:
        pat = re.compile(pattern)
        return [k for k in self.kernels if pat.search(k[0])]

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time over the window."""
        total: Dict[str, int] = {}
        for name, _, d in self.kernels:
            key = f"{family(name)}: {short(name)}"
            total[key] = total.get(key, 0) + d
        rows = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest idle gaps, each named by the host's CUDA call across
        its middle (a launch, a copy, a wait; none: the host was running
        Python) and by the kernel that ended the gap."""
        longest = sorted(range(len(self.gaps)),
                         key=lambda i: self.gaps[i][0] - self.gaps[i][1])
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        firsts = sorted(self.kernels, key=lambda k: k[1])
        kstarts = [k[1] for k in firsts]
        out = []
        for i in longest[:top]:
            a, b = self.gaps[i]
            mid, call = (a + b) // 2, "python"
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and ops[j][1] + ops[j][2] >= mid:
                call = ops[j][0]
            nxt = firsts[min(bisect.bisect_left(kstarts, b),
                             len(firsts) - 1)][0]
            out.append([f"host in {call}, then {short(nxt)}",
                        (b - a) / 1e9])
        return out


def profile(step_fn, steps: int, settle) -> Trace:
    """``step_fn()`` ``steps`` times under torch.profiler, with
    ``settle()`` (wait until the program's work is done) before and after;
    the window is timed on the host clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    # CUDA activity alone: kernels, copies and the host's CUDA calls. The
    # host's own ops are not recorded: that costs more host time than the
    # step itself and would be read as device idle.
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with torch_profile(activities=acts, acc_events=True) as prof:
        # the window is the steps' own: the profiler's start and its
        # gathering of the events at the stop lie outside it
        settle()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        settle()
        window = time.perf_counter() - t0
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            kernels.append(row)
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
    return Trace(steps, window, kernels, host)
