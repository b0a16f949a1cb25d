#!/usr/bin/env python3
"""The lane split of a benchmark cell's profiled steps, from the port's
lane spans (``repro_torch.launch.timeline``) and the profiler's CUDA trace.

    python3 tools/lane_split.py --workload gpt2m-layup-param --seed 1 \
        [--steps 2] [--out build/lane_split.json]

Set-up is the benchmark's (``h100bench``: the cell's model, weights,
batches and backend on the card from the seed, the first steps to warm
every shape); then ``--steps`` steps run under ``torch.profiler`` (CUDA
activity, as ``h100bench.trace.profile``). Printed, one JSON object:

- ``lanes``: per lane span name, its count and device ms a step, and the
  device ms a step of the kernels its launch calls made, by kernel family
  and for its four longest kernels (a kernel is placed by its launch
  call's host time, through the profiler's correlation ids, in the span
  that holds it, followed down the spans' parent links from the ``step``
  span to the innermost; ``outside lanes``: in the ``step`` span only;
  ``no span``: outside it); and the lane's work a step (the spans'
  ``work``), set against its device time: ``us_per_token`` for ``fwd``
  and ``bwd``, and for the plane lanes ``passes_at_peak``, the passes over
  the plane (at the model's dtype) that HBM's 3.35 TB/s would move in the
  lane's time (``h100bench.lanes.passes_at_peak``);
- ``coverage``: the six lanes' device ms over the device's busy time and
  over the profiled window, and the share of kernel launch calls inside a
  ``step`` span (all on the profiler's clock);
- the metrics of ``h100bench.lanes`` (host dispatch, dispatch idle);
- ``idle_gaps``: the longest device idle gaps, each with the host's CUDA
  call across its middle and the lane span that held the host there (its
  worker, slice, and how far into the span the gap opened).

The card's name and power limit come first. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LANES = ("fwd", "bwd", "pack", "update", "gossip", "drift")


def children(spans):
    """The spans by their parent's id; a span whose parent is not among
    ``spans`` (outside the window) is filed under ``None``, with the
    outermost ones, ``step`` spans first: another thread's outermost span
    (the stream engine's) holds a time only where no step does."""
    ids = {s["id"] for s in spans}
    tree = {}
    for s in spans:
        tree.setdefault(s["parent"] if s["parent"] in ids else None,
                        []).append(s)
    tree.get(None, []).sort(key=lambda s: s["name"] != "step")
    return tree


def innermost(tree, t):
    """The innermost span holding host time ``t``, followed down the
    parent links from the outermost spans (``None``: none holds it)."""
    held, kids = None, tree.get(None, [])
    while True:
        s = next((s for s in kids if s["start_ns"] <= t <= s["end_ns"]),
                 None)
        if s is None:
            return held
        held, kids = s, tree.get(s["id"], [])


def profile_steps(step_fn, steps, settle):
    """(Trace, {kernel index: its launch call's host start}) of ``steps``
    calls of ``step_fn`` under the CUDA-activity profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from h100bench.trace import Trace

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as p:
        settle()
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
        settle()
        window = time.perf_counter() - t0
    kernels, host, launch_of, kcorr = [], [], {}, []
    for e in p.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            kernels.append(row)
            kcorr.append(e.correlation_id())
        elif e.device_type() == DeviceType.CPU:
            host.append(row)
            launch_of[e.correlation_id()] = e.start_ns()
    launched = {i: launch_of.get(c) for i, c in enumerate(kcorr)}
    return Trace(steps, window, kernels, host), launched


def split(tr, launched, spans, element_bytes):
    from h100bench import lanes
    from h100bench.trace import family, short

    per = tr.steps
    tree = children(spans)
    out = {}
    for name in LANES + ("step",):
        mine = [s for s in spans if s["name"] == name]
        dev = [s["device_ms"] for s in mine if s["device_ms"] is not None]
        out[name] = {"spans_per_step": len(mine) / per,
                     "device_ms_per_step": sum(dev) / per,
                     "kernel_ms_per_step": {}}
        work = lanes.work_per_step(tr, name)
        if work:
            out[name]["work_per_step"] = work
            if name in ("fwd", "bwd"):
                out[name]["us_per_token"] = (
                    out[name]["device_ms_per_step"] * 1e3 / work)
            else:
                out[name]["passes_at_peak"] = lanes.passes_at_peak(
                    tr, name, element_bytes)
    out["outside lanes"] = {"kernel_ms_per_step": {}}
    out["no span"] = {"kernel_ms_per_step": {}}
    by_kernel = {}
    for i, (name, _, d) in enumerate(tr.kernels):
        t = launched.get(i)
        s = None if t is None else innermost(tree, t)
        key = ("no span" if s is None else
               "outside lanes" if s["name"] == "step" else s["name"])
        fam = out[key]["kernel_ms_per_step"]
        fam[family(name)] = fam.get(family(name), 0.0) + d / 1e6 / per
        mine = by_kernel.setdefault(key, {})
        mine[short(name)] = mine.get(short(name), 0.0) + d / 1e6 / per
    for key, mine in by_kernel.items():
        out[key]["top_kernels_ms_per_step"] = sorted(
            mine.items(), key=lambda kv: -kv[1])[:4]
    lanes_ms = sum(out[n]["device_ms_per_step"] for n in LANES)
    calls = [(n, s) for n, s, _ in tr.host_ops if "LaunchKernel" in n]
    steps = [s for s in spans if s["name"] == "step"]
    held = sum(any(s["start_ns"] <= t <= s["end_ns"] for s in steps)
               for _, t in calls)
    coverage = {
        "lanes_ms_per_step": lanes_ms,
        "busy_ms_per_step": tr.busy_s * 1e3 / per,
        "window_ms_per_step": tr.window_s * 1e3 / per,
        "of_busy": lanes_ms / (tr.busy_s * 1e3 / per),
        "of_window": lanes_ms / (tr.window_s * 1e3 / per),
        "launch_calls": len(calls),
        "launch_calls_in_step": held,
    }
    ops = sorted(tr.host_ops, key=lambda o: o[1])
    ostarts = [o[1] for o in ops]
    gaps = []
    for a, b in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) // 2
        s = innermost(tree, mid)
        j = bisect.bisect_right(ostarts, mid) - 1
        call = (ops[j][0] if j >= 0 and ops[j][1] + ops[j][2] >= mid
                else "python")
        gaps.append({"ms": (b - a) / 1e6, "host_call": call,
                     **({} if s is None else {
                         "lane": s["name"], "worker": s["worker"],
                         "slice": s["slice"],
                         "into_lane_ms": (a - s["start_ns"]) / 1e6})})
    return {"lanes": out, "coverage": coverage,
            "host_dispatch_ms_per_step": lanes.host_dispatch_ms_per_step(tr),
            "dispatch_idle_ms_per_step": lanes.dispatch_idle_ms_per_step(tr),
            "idle_gaps": gaps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench.run import environment

    environment()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    from h100bench import inputs, program
    from h100bench.lanes import spans as window_spans
    from h100bench.spec import load_cell

    spec = load_cell(args.workload)
    cfg, job = spec["config"], spec["traffic"]
    dtype = getattr(torch, cfg["model"]["dtype"])
    model, backend = program.build(cfg, job, "cuda")
    weights = inputs.make_weights(program.param_shapes(model), dtype,
                                  cfg["init"], args.seed, "cuda")
    batches = inputs.make_batches(job, cfg["model"]["vocab_size"],
                                  args.seed, "cuda")
    box = {"state": backend.init(args.seed, inputs.nest(weights)), "t": 0,
           "losses": []}
    del weights
    for _ in range(3):  # every shape warm, as the benchmark's set-up
        program.step(backend, box, batches)
    program.settle(backend)
    steps = args.steps or job["profiled_steps"]
    tr, launched = profile_steps(
        lambda: program.step(backend, box, batches), steps,
        lambda: program.settle(backend))
    out = {"workload": args.workload, "seed": args.seed, "steps": steps,
           **split(tr, launched, window_spans(tr),
                   torch.empty((), dtype=dtype).element_size())}
    program.close(backend)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
