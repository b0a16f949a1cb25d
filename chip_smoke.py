#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # what CI runs
    python3 chip_smoke.py --profile  # also profiles two training steps

Phases, one JSON line each; any failed check raises and the exit code is
not 0:

1. device: ``nvidia-smi`` name and power limit, torch and Triton versions.
2. kernels: the Triton ``gossip_mix`` (both variants) against its plain
   PyTorch version on the same CUDA tensors, at the training step's real
   layer-group shapes (GPT-2 Medium, M=4, float32), at odd sizes and in
   bfloat16; max error against the stated tolerance; kernel and plain
   times (CUDA events, median of 20) beside the bound from bytes.
3. train: the port's main path through its user entry points,
   ``make_backend("prod", "layup", M=4, fb_ratio=2, update_delay=1,
   use_pallas=True)`` + ``drive``, GPT-2 Medium at full width and depth
   (random weights from a seed), 6 steps. Kernel launch counts are zeroed
   just before and read just after: ``gossip_mix`` must run once per layer
   group per step.
4. route: the same step at 2 layers, full width, M=4, 3 steps, through the
   kernel and through the plain ``gossip_mix_ref`` called directly on the
   same CUDA tensors; losses and planes must agree to 1e-5 relative.
5. the kernels line, the card's ``nvidia-smi`` line, and last the result.

TF32 is off for matrix products and cuDNN (both set below), so float32 is
float32 throughout.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TOL = {"float32": 1e-6, "bfloat16": 2e-2}  # relative to max |ref|
M = 4
TRAIN_STEPS = 6
SEQ, BATCH_PER_WORKER = 256, 4
LR = 3e-3
ROUTE_LAYERS, ROUTE_STEPS, ROUTE_RTOL = 2, 3, 1e-5


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mix_bound_ms(numels, itemsize: int, with_upd: bool, rows: int):
    """Least time for gossip_mix over stacked buffers of ``numels`` elements
    each (all rows): each operand read once, the output written once, plus
    ``rows`` α/β pairs per buffer, over HBM; or 4 (3) flops per element over
    the float32 rate. Returns (ms, bound_by)."""
    n = sum(numels)
    nbytes = n * itemsize * (4 if with_upd else 3) + len(numels) * rows * 8
    flops = n * (4 if with_upd else 3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gpt2_medium_groups():
    """Layer-group sizes of GPT-2 Medium's flat plane (no allocation)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_map
    from repro_torch.models.transformer import decoder_specs

    specs = decoder_specs(get_config("gpt2-medium"))
    part = FlatPartition(tree_map(
        lambda s: torch.empty(s.shape, device="meta"), specs))
    return dict(part.group_sizes)


def phase_kernels(torch):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gossip_mix_ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1234)
    w = torch.rand(M, generator=gen, device=dev) + 0.5
    rw = torch.roll(w, 1)
    alpha, beta = w / (w + rw), rw / (w + rw)

    def operands(n, dtype):
        return [torch.randn((M, n), generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def max_err(x, r, u, dtype_name):
        got = ops.gossip_mix(x, r, u, alpha, beta)
        want = gossip_mix_ref(x, r, u, alpha, beta)
        err = (got.float() - want.float()).abs().max().item()
        scale = max(want.float().abs().max().item(), 1.0)
        check(err <= TOL[dtype_name] * scale,
              f"gossip_mix error {err} > {TOL[dtype_name]} x {scale} "
              f"(n={x.shape[1]}, {dtype_name}, upd={u is not None})")
        return err

    results = {"cases": []}
    # odd sizes (masked tails) and bf16, both variants
    for n, dtype in ((1, torch.float32), (127, torch.float32),
                     (129, torch.float32), (1029, torch.float32),
                     (1029, torch.bfloat16)):
        x, r, u = operands(n, dtype)
        dn = str(dtype).replace("torch.", "")
        results["cases"].append({"n": n, "dtype": dn,
                                 "err_fused": max_err(x, r, u, dn),
                                 "err_pure": max_err(x, r, None, dn)})

    # the training step's real groups, float32 at M=4 (fused: main path)
    groups = gpt2_medium_groups()
    stacked = [M * n for n in groups.values()]
    bufs = {g: operands(n, torch.float32) for g, n in groups.items()}
    main_err = 0.0
    for g, (x, r, u) in bufs.items():
        e_f, e_p = max_err(x, r, u, "float32"), max_err(x, r, None, "float32")
        main_err = max(main_err, e_f)
        results["cases"].append({"group": g, "n": groups[g],
                                 "dtype": "float32", "err_fused": e_f,
                                 "err_pure": e_p})
        torch.cuda.empty_cache()

    def step_mix(fn, pure=False):
        def run():
            for x, r, u in bufs.values():
                fn(x, r, None if pure else u, alpha, beta)
        return run

    timing = {}
    for pure in (False, True):
        key = "pure" if pure else "fused"
        timing[key] = {
            "ms": time_ms(torch, step_mix(ops.gossip_mix, pure)),
            "plain_ms": time_ms(torch, step_mix(gossip_mix_ref, pure)),
            "bound_ms": mix_bound_ms(stacked, 4, not pure, M)[0]}
    per_group = {g: time_ms(torch, lambda b=b: ops.gossip_mix(
        b[0], b[1], b[2], alpha, beta)) for g, b in bufs.items()}

    # one bf16 group at a main-path width (embed), both variants
    x, r, u = operands(groups["embed"], torch.bfloat16)
    results["cases"].append({"group": "embed", "n": groups["embed"],
                             "dtype": "bfloat16",
                             "err_fused": max_err(x, r, u, "bfloat16"),
                             "err_pure": max_err(x, r, None, "bfloat16")})
    del x, r, u, bufs
    torch.cuda.empty_cache()
    bound, bound_by = mix_bound_ms(stacked, 4, True, M)
    results.update(groups=groups, M=M, timing=timing,
                   per_group_fused_ms=per_group,
                   main_max_abs_err=main_err, bound_by=bound_by,
                   bound_ms=bound)
    emit("kernels", **results)
    return results


def lm_batches(torch, vocab, steps, seed):
    """Seeded random tokens, labels = next token; on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (M, BATCH_PER_WORKER, SEQ + 1))
        out.append({"tokens": torch.from_numpy(toks[..., :-1]).cuda(),
                    "labels": torch.from_numpy(toks[..., 1:]).cuda()})
    return out


def phase_train(torch, profile: bool):
    from repro_torch.configs import get_config
    from repro_torch.core.backend import drive, make_backend
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=2, update_delay=1, use_pallas=True,
                           device="cuda")
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    stamps = []

    def timed(batches):
        for b in batches:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield b

    keys = ("loss", "weight_sum", "update_staleness", "staleness_mean",
            "disagreement", "nonfinite_skips")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gm_kernel.reset_launches()                      # main path starts
    out = drive(backend, timed(batches), None, params, history_keys=keys)
    torch.cuda.synchronize()
    launches = gm_kernel.launches                   # main path ends
    stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    hist = {k: [float(v) for v in out["history"][k]] for k in keys}
    n_groups = len(backend.part.group_sizes)
    check(launches == TRAIN_STEPS * n_groups,
          f"gossip_mix launches {launches} != {TRAIN_STEPS} x {n_groups}")
    check(all(math.isfinite(v) for v in hist["loss"]), f"loss {hist}")
    check(all(abs(v - 1.0) <= 1e-5 for v in hist["weight_sum"]),
          f"weight_sum {hist['weight_sum']}")
    check(abs(hist["loss"][0] - math.log(cfg.vocab_size)) < 0.5,
          f"first loss {hist['loss'][0]} far from ln(V) at random init")
    check(hist["nonfinite_skips"] == [0.0] * TRAIN_STEPS, "nonfinite skips")
    read = out["state"]["read"]
    check(all(bool(torch.isfinite(v).all()) for v in read.values()),
          "nonfinite plane")
    med = statistics.median(step_s[1:])
    tokens = M * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(backend.part.group_sizes.values()), "M": M,
           "fb_ratio": 2, "update_delay": 1, "seq": SEQ,
           "batch_per_worker": BATCH_PER_WORKER, "steps": TRAIN_STEPS,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "peak_bytes": peak, "gossip_mix_launches": launches,
           "groups": dict(backend.part.group_sizes)}
    emit("train", **res)
    if profile:
        phase_profile(torch, backend, out["state"], batches)
    del out, read, params
    torch.cuda.empty_cache()
    return res


def phase_profile(torch, backend, state, batches):
    """Two more steps under torch.profiler: device time by kernel and the
    device's idle share over the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[:2]:
            state, _ = backend.step(state, b)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []  # device-side events only (kernels, copies, fills)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    emit("profile", steps=2, wall_s=wall, device_busy_s=busy,
         idle_share=max(0.0, 1.0 - busy / wall),
         top=[{"kernel": k[:120], "device_ms": us / 1e3, "count": c}
              for us, k, c in rows[:25]])


def phase_route(torch):
    """Kernel route vs plain route on the same tensors, 2 layers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.launch.train import (_decoupled_worker_fn,
                                          backward_update_lane, forward_lane,
                                          gossip_fused_lane,
                                          make_decoupled_state)
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=ROUTE_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=1, device="cuda")
    opt, sched = momentum(0.9), constant(LR)
    batches = lm_batches(torch, cfg.vocab_size, ROUTE_STEPS, seed=1)

    kernel = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                          optimizer=opt, schedule=sched, fb_ratio=2,
                          update_delay=1, use_pallas=True, device="cuda",
                          measure_drift=False)
    part = FlatPartition(params)
    shifts = tuple(s % M for s in (1, 2, 4, 8) if s % M) or (1,)
    plain_step = _decoupled_worker_fn(
        part, forward_lane(model.loss_fn, fb_ratio=2),
        backward_update_lane(opt, sched, update_delay=1, apply=False),
        None, M, 1,
        fused_mix=gossip_fused_lane(part, M, shifts, use_pallas=False))
    shift_rng = np.random.default_rng(0xC0FFEE)  # the backend's draws

    ks = kernel.init(None, params)
    ps = make_decoupled_state(
        tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)), params),
        opt, update_delay=1, part=part)
    before = gm_kernel.launches
    losses = []
    for t, b in enumerate(batches):
        ks, km = kernel.step(ks, b)
        with torch.no_grad():
            ps, pm = plain_step(ps, b, t, int(shift_rng.integers(
                0, len(shifts))))
        kl, pl = float(km["loss"]), float(pm["loss"])
        losses.append((kl, pl))
        check(abs(kl - pl) <= ROUTE_RTOL * abs(pl),
              f"route loss step {t}: kernel {kl} vs plain {pl}")
    plane_rel = {}
    for g in ps["read"]:
        a, b = ks["read"][g].float(), ps["read"][g].float()
        plane_rel[g] = ((a - b).abs().max() / b.abs().max()).item()
        check(plane_rel[g] <= ROUTE_RTOL, f"route plane {g}: {plane_rel[g]}")
    route_launches = gm_kernel.launches - before
    check(route_launches == ROUTE_STEPS * len(part.group_sizes),
          f"route launches {route_launches}")
    emit("route", layers=ROUTE_LAYERS, M=M, steps=ROUTE_STEPS,
         losses=losses, plane_max_rel_diff=plane_rel,
         kernel_route_launches=route_launches, rtol=ROUTE_RTOL)
    del ks, ps, params
    torch.cuda.empty_cache()


def main(argv) -> int:
    # the step's transients are plane-sized (GBs): growable segments keep
    # the caching allocator from stranding them as fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              "it from the root of a checkout", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    import triton

    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, triton=triton.__version__,
         name=torch.cuda.get_device_name(0),
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    kern = phase_kernels(torch)
    train = phase_train(torch, profile="--profile" in argv)
    phase_route(torch)
    fused = kern["timing"]["fused"]
    print(json.dumps({"kernels": [{
        "name": "gossip_mix", "route": "triton",
        "source": "src/repro_torch/kernels/gossip_mix.py",
        "replaces": "src/repro/kernels/gossip_mix.py:49",
        "launches": train["gossip_mix_launches"],
        "max_abs_err": kern["main_max_abs_err"],
        "ms": fused["ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None}]}), flush=True)
    emit("done", wall_s=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
