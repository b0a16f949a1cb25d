"""Run one cell of the benchmark once and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``): the weights and token batches made on the
device from the seed, the port's prod backend built and initialised with
them, and its first three steps, which warm every shape the window uses
and are read for the correctness check. Then the window: steps back to
back on the cycled batches for ``--seconds``; with ``--trace 1`` a few
steps under torch.profiler first, then the window timed without it. After the window
the program's state is freed and the plain reference follows the same
three steps from the same weights and batches; the result's ``correct``
compares the two. The last line of standard output is one JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CHECK_STEPS = 3  # the steps the reference follows
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # whole top-level names


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def environment() -> None:
    """Before CUDA starts: deterministic cuBLAS workspaces (bits across
    streams), the program's compile caches inside the checkout, and no
    JAX pulled in by a library."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[h100bench {time.perf_counter() - T_START:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run of a cell (``spec`` from :func:`h100bench.spec.load_cell`)
    on ``device``; returns the result dict (without ``device``'s name)."""
    import torch

    from h100bench import check, inputs, metrics, program
    from h100bench.reference import pdasgd
    from h100bench.trace import profile

    cfg, job = spec["config"], spec["traffic"]
    dtype = getattr(torch, cfg["model"]["dtype"])
    on_gpu = device == "cuda"

    # ---- set-up -----------------------------------------------------------
    model, backend = program.build(cfg, job, device)
    shapes = program.param_shapes(model)
    weights = inputs.make_weights(shapes, dtype, cfg["init"], seed, device)
    batches = inputs.make_batches(job, cfg["model"]["vocab_size"], seed,
                                  device)
    # the state lives in the box alone: a step consumes its state in place,
    # and a second reference would keep a consumed plane alive
    box = {"state": backend.init(seed, inputs.nest(weights)),
           "t": CHECK_STEPS, "losses": []}
    log("weights, batches and state made")
    got = program.first_steps(backend, box, batches, weights, CHECK_STEPS,
                              job["update_delay"])
    log(f"first {CHECK_STEPS} steps run and read")
    del weights
    gc.collect()
    tokens = (job["workers"] * job["sequences_per_worker"]
              * job["sequence_length"])
    if on_gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start

    # ---- the window -------------------------------------------------------
    out = {}
    if not trace:
        n, elapsed = program.drive(backend, box, batches, seconds, t0)
        out["metrics"] = {
            "tokens_per_s": {"value": n * tokens / elapsed,
                             "unit": "tokens/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        peak = {"value": (torch.cuda.max_memory_allocated() / 2 ** 30
                          if on_gpu else 0.0), "unit": "GiB"}
        for m in spec["end_to_end"]:
            if m["name"].startswith("peak_mem_gib"):
                out["metrics"][m["name"]] = peak
    else:
        k = job["profiled_steps"]
        tr = profile(lambda: program.step(backend, box, batches), k,
                     lambda: program.settle(backend))
        log(f"{k} steps profiled in {tr.window_s:.2f} s, "
            f"{len(tr.kernels)} device events")
        n_u, elapsed_u = program.drive(backend, box, batches, seconds)
        n = k + n_u
        ctx = {"trace": tr, "unprofiled_steps": n_u,
               "unprofiled_s": elapsed_u, "model": cfg["model"],
               "traffic": job, "groups": pdasgd.group_layout(shapes)[1]}
        out["metrics"] = {}
        for m in spec["per_layer"]:
            v = metrics.read(m["name"], ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
        out["busy_s"], out["window_s"] = tr.busy_s, tr.window_s
    out["attempted"] = n
    log(f"window closed: {n} steps")
    out["failed"] = sum(1 for v in box["losses"]
                        if not math.isfinite(float(v)))
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if on_gpu else 0)

    # ---- the reference, after the program's state is freed ----------------
    program.close(backend)
    box.clear()
    del backend, model
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = inputs.make_weights(shapes, dtype, cfg["init"], seed, device)
    want = pdasgd.run(weights, batches, cfg["model"], job, CHECK_STEPS)
    log("reference run")
    numbers = check.compare(got, want)
    out["correct"] = (check.judge(numbers, spec["limits"])
                      and out["failed"] == 0)
    out["checks"] = {k: {"value": v, "limit": spec["limits"][k]}
                     for k, v in numbers.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    from h100bench.spec import load_cell

    spec = load_cell(args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for k, c in out["checks"].items():
        limit = "not compared" if c["limit"] is None else repr(c["limit"])
        print(f"check {k} = {c['value']!r} limit {limit}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
