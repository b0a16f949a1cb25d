#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # what CI runs
    python3 chip_smoke.py --profile  # also profiles the step on each route

Phases, one JSON line each; any failed check raises and the exit code is
not 0:

1. device: ``nvidia-smi`` name and power limit, torch and Triton versions;
   then build: ``nvcc`` builds every CUDA C++ source of the port at once,
   one process each (a line per source with its build time).
1b. ptxas: the registers, static shared memory and spills of each kernel
   of ``flash_attention.cu``, ``ssd_scan.cu`` and ``rmsnorm.cu`` (what
   ``-Xptxas -v`` printed when the build compiled them).
2. kernels: the Triton ``gossip_mix`` (both variants) against its plain
   PyTorch version on the same CUDA tensors, at the training step's real
   layer-group shapes (GPT-2 Medium, M=4, float32), at odd sizes and in
   bfloat16; max error against the stated tolerance; kernel and plain
   device times (CUDA events, median of 20, queued behind a spin kernel
   so that the host's dispatch is not timed) beside the bound from bytes.
3. flash: the CUDA C++ flash attention kernels (3xTF32 ``mma.sync``
   products, ``cp.async`` ring; the dq kernel also computes delta), the
   forward (o, lse), the backward (dq, dk, dv; two launches) and the
   autograd Function, are held against their plain PyTorch versions on the
   same CUDA tensors, at the training step's attention shape (B=2, H=16,
   S=256, D=64, float32, causal; (B,S,H,D) tensors passed as (B,H,S,D)
   views), over a sweep (GQA, MQA, windows, bidirectional, bfloat16,
   D=128, S not a multiple of the tile), at S=2048, 65 and 1, and on
   misaligned views (storage offset 1, odd sequence stride: the kernels'
   element-by-element copies); two calls on the same inputs must give
   bit-identical o, lse, dq, dk and dv (float32 and bfloat16). Each
   kernel's block and dynamic shared memory (``flash_config``); kernel,
   plain and ``scaled_dot_product_attention`` times (the last as a
   yardstick only: the port never calls it) beside each bound, at the
   card's f32-accurate tensor-core rate for f32 (3xTF32, 165 TFLOP/s).
3b. quantize: the CUDA C++ ``quantize_plane`` and both ``dequant_mix``
   variants against their plain PyTorch versions on the same CUDA tensors,
   required BIT-IDENTICAL (q, scales, residual, output): at the int8 step's
   stacked group shapes (GPT-2 Medium, M=4, float32), at odd sizes (n in
   {1, 127, 129, 1029}, M in {1, 3}), in bfloat16, with all-zero rows and
   with the residual written over itself; kernel, plain and bound times.
3c. norm_ssd: the CUDA C++ ``rmsnorm`` and ``ssd_scan`` against their
   plain PyTorch versions on the same CUDA tensors. ``rmsnorm``: the
   Mamba2 step's norms (512 rows of 1536 and of 3072, bfloat16), the
   decoder's 1024 x 1024 float32, the JAX tests' three shapes in float32
   and bfloat16, and 16384 x 4096 bfloat16 for bandwidth. ``ssd_scan``:
   the step's shape (B=2, H=48, S=256, P=64, N=128, chunk 128) in
   bfloat16 and float32 from strided (B,S,H,P) views, S=2048 (16 chunks
   carry the state), and the JAX tests' three shapes, also against the
   sequential ``ssd_ref``. Two calls on the same inputs must give
   bit-identical outputs (each kernel, every shape), and each shape's
   launch configuration is reported (``rmsnorm``: blocks, threads, shared
   memory, vectors a lane, warps a row, rows a block; ``ssd_scan``: the
   CUDA kernels a call and each one's blocks, threads and shared memory).
   Kernel, plain, library (``F.rms_norm``; none computes the SSD scan) and
   bound times; the SSD bound at the rates of the card's units for each
   product (``ssd_bound_ms``), and the device time of each of the SSD's
   CUDA kernels (torch.profiler, ``device_ms_by_kernel``).
4. train: the port's main path through its user entry points,
   ``make_backend("prod", "layup", M=4, fb_ratio=2, update_delay=1,
   use_pallas=True)`` + ``drive``, GPT-2 Medium at full width and depth
   (random weights from a seed), 6 steps. Kernel launch counts are zeroed
   just before and read just after: ``gossip_mix`` must run once per layer
   group per step, the flash forward once per layer, forward slice and
   worker, and each backward kernel once per layer and worker.
4a. train_pipeline, train_streams: the train phase's run (same model,
   weights, batches and options) through the stage-graph pipeline engine
   (``overlap=True``) and through the stream engine (``overlap=True,
   streams=3``: forward | update | gossip on CUDA streams of their own).
   Steps 1-5 are one window between two synchronisations, with no copy
   to the host inside it; the metrics are read after it. The loss,
   update_staleness, staleness_mean, weight_sum and disagreement
   histories, the SHA-256 of each group of the final read plane (copied to
   the host) and every kernel's launch count must be identical to the
   train phase's; the engines' overlap fields (``summary()``), stage times,
   peak device bytes and the window's time per step are printed.
   train_streams_int8: the same with ``wire="int8"``, ``compensate=0.5``,
   held against train_int8 once that has run. ``--profile`` then
   alternates the three (monolithic, pipeline, streams, streams, pipeline,
   monolithic) on one state: each run's window time per step, device time
   per step (kernels merged over the streams) and idle share.
4b. train_int8: the int8 wire's main path, ``make_backend("prod",
   "layup", M=4, fb_ratio=2, update_delay=1, use_pallas=True,
   wire="int8", compensate=0.5)`` + ``drive``, GPT-2 Medium at full width
   and depth, 6 steps on the train phase's batches. ``quantize_plane`` and
   ``dequant_mix`` must run once per layer group per step, ``gossip_mix``
   never, flash as in train; Σw, losses, skips and the wire bytes checked;
   then one more step, outside the counted window, whose new residual must
   keep |r'| <= s/2 of its row (s computed plainly from the plane and
   residual it quantizes).
4c. train_ssm: the SSM family's main path, the same entry points and
   traffic with Mamba2-780M (48 layers, d 1536, bfloat16) at full width
   and depth, random weights from a seed, after the GPT-2 states are
   freed: ``gossip_mix`` must run once per layer group per step, flash
   never, and neither ``rmsnorm`` nor ``ssd_scan`` (the model runs the
   plain forms, as the reference's does). Then, outside that window, the
   two kernels run on the step's own activations (worker 0's read plane,
   the first batch's first forward slice): ``ssd_scan`` on layers 0 and
   47's mixer inputs against the model's ``ssd_chunked``, ``rmsnorm`` on
   their pre-norm and gate-norm inputs and the final norm's against the
   model's norm; their launches there are counted from 0.
4d. train_membership_empty (monolithic) and
   train_membership_empty_streams (``streams=3``): train's and
   train_streams's runs with ``faults=""`` (membership on, nothing
   injected), each held bit-identical to its fault-free phase: loss,
   staleness, Σw and disagreement histories, the read plane's per-group
   SHA-256 and every launch count; ``peers_live`` = 4 at every step.
   train_chaos: the monolithic param-wire step, 12 steps on the train
   phase's seeded batches, with ``faults=CHAOS_PLAN`` (peer 1 crashes at
   step 2, dead at step 3, re-synced from peer 0 at step 8; a NaN in peer
   0's queued gradient of group 0 at step 5; a corrupted group 1 payload at
   step 6): finite loss, |Σw − 1| ≤ 1e-5 every step, ``peers_live`` as the
   ladder predicts, one resync, at least one nonfinite skip, one checksum
   reject and one resend, peer 1's read-plane rows equal to the donor's
   right after the resync, ``gossip_mix`` once per group per step.
   train_chaos_streams_int8: the reference's headline run,
   ``streams=3``, ``wire="int8"``, ``faults=CHAOS_STREAMS_PLAN``, 14
   steps, held bit-identical (histories, plane digests, launches) to the
   same plan on the monolithic int8 step (``train_chaos_int8``); finite
   loss, Σw, one resync, no peer dead and 4 live at the end. Each prints
   its step times, peak device bytes, the host seconds of each fault
   event (``kill_s``, ``resync_s``, ``guard_round_s``, ``nan_s``) and the
   controller's counters.
4e. serve: GPT-2 Medium (f32, seed-0 weights) through ``ServeLoop``
   (8 slots, max_len 512): 16 requests, prompts of 16–128 tokens from
   ``default_rng(5)``, 64 new tokens, no EOS; all complete, in fewer steps
   than one after another, with no flash launch. ``prefill_fn`` (flash #2:
   one forward launch a layer, no backward) against prefill-by-decode on 4
   prompts (last logits to 1e-4, every layer's K/V to 1e-5 of the largest
   |value|) and against the plain attention route (``ROUTE_RTOL``).
   Readings: decode-step median and p99, tokens/s, the idle share of 10
   full-batch steps (host clock, then torch.profiler), ``prefill_fn``'s
   host ms and device busy ms at B=1 S=128, B=1 S=512 and B=8 S=512,
   cache bytes, peak, ``stats()``. serve_ssm: Mamba2-780M (bf16), 8 slots, max_len 256,
   prompts of 16–64, 32 new tokens; no kernel launch; on 4 prompts each
   layer's chunked form (prefill) against its recurrence (decode) on the
   same inputs to 2e-2 (state, conv tail), and prefill-by-decode against
   ``prefill_fn`` end to end in float32 (the weights upcast) to 1e-4; the
   bf16 end-to-end gaps as readings; the same readings as serve.
4f. serve_live, serve_live_pipeline: train's run (monolithic, then
   ``overlap=True``) with ``publisher=PlanePublisher()``; after each of its
   6 steps ``LiveServer.run_until_idle()`` serves 2 requests on the same
   thread. Held: histories, plane digests and launches identical to
   train's; after each swap the served params equal worker 0's row of the
   snapshot bit for bit; step 2's snapshot has the same SHA-256 two steps
   later; every publish copied; at least 2 swaps. Readings: publish host
   seconds, device ms between events around each publish (the clones) and
   each unpack, the step's median against train's, peak.
5. route: the same step at 2 layers, full width, M=4, 3 steps, through the
   kernels and through the plain route (``USE_PALLAS=False`` attention and
   ``gossip_mix_ref``) on the same CUDA tensors; losses and planes must
   agree to 1e-5 relative (the attention kernels sum in another order).
5b. route_int8: the int8 step (λ=0.5) at 2 layers, M=4, 3 steps, through
   the quantize kernels and through their plain versions
   (``gossip_fused_lane(use_pallas=False, wire="int8")``), attention on the
   flash kernels on both: losses, planes, residuals and θ bit-identical.
6. the kernels line, the card's ``nvidia-smi`` line, and last the result.

TF32 is off for matrix products and cuDNN (both set below), so float32 is
float32 throughout. ``CUBLAS_WORKSPACE_CONFIG`` is fixed before CUDA
starts, so cuBLAS gives the same bits on every CUDA stream (the engine
phases compare streams against the default stream bit for bit).
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
# f32-accurate matrix products on the tensor cores: TF32 (495 TFLOP/s
# dense) over the three products of 3xTF32, as the flash kernels and
# PyTorch's f32 attention take them
TF32X3_FLOPS_PER_S = 495e12 / 3
# a product of an f32 operand with one exact in TF32 (a bf16 value): the
# two products of 2xTF32
TF32X2_FLOPS_PER_S = 495e12 / 2
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TOL = {"float32": 1e-6, "bfloat16": 2e-2}  # relative to max |ref|
M = 4
TRAIN_STEPS = 6
SEQ, BATCH_PER_WORKER = 256, 4
LR = 3e-3
ROUTE_LAYERS, ROUTE_STEPS, ROUTE_RTOL = 2, 3, 1e-5
PROFILE_AB_ROUNDS = 3  # --profile: 4 steps a round, 2 on each route
R = 2  # forward slices per step (fb_ratio)
# the training step's attention call: per worker and forward slice, B =
# BATCH_PER_WORKER / R sequences, GPT-2 Medium's 16 heads of 64, causal
FLASH_MAIN = (BATCH_PER_WORKER // R, 16, 16, SEQ, 64, True, 0, "float32")
FLASH_SWEEP = [  # (B, Hq, Hkv, S, D, causal, window, dtype)
    (2, 8, 2, 256, 64, True, 0, "float32"),      # GQA
    (2, 8, 1, 256, 64, True, 0, "float32"),      # MQA
    (2, 16, 16, 256, 64, True, 64, "float32"),   # sliding window
    (2, 16, 16, 256, 64, False, 0, "float32"),   # bidirectional
    (2, 16, 16, 256, 64, True, 0, "bfloat16"),
    (2, 8, 8, 256, 128, True, 0, "float32"),     # D=128
    (2, 8, 4, 200, 64, True, 0, "float32"),      # S not a multiple of 64
    (1, 4, 2, 77, 128, False, 20, "bfloat16"),
]
# more flash cases (B, Hq, Hkv, S, D, causal, window, dtype): 32 trips round
# the K/V ring, one row, and a full tile plus a ragged one. At S=1 the
# softmax has one key, so dq and dk are 0 in exact arithmetic and both sides
# are rounding noise of dP − delta: they are held to tol × max |dP| instead
# of max |plain| (~1e-6).
FLASH_EXTRA = [
    (1, 4, 2, 2048, 64, True, 0, "float32"),
    (2, 4, 2, 1, 64, True, 0, "float32"),
    (1, 4, 2, 65, 64, True, 0, "float32"),
]
# a misaligned operand: storage offset 1 element, sequence stride H·D + 3
FLASH_MISALIGNED = (2, 8, 2, 200, 64, True, 0, "float32")
# |kernel − plain| ≤ tol × max |plain| in float32, which sums in another
# order than cuBLAS (tol 1e-5 forward; 1e-4 backward, which sums over S).
# bfloat16, element by element: + 2^-7 × |plain|, one bf16 ulp, since each
# side is one rounding of a float32 result within that tolerance
FLASH_TOL = (1e-5, 1e-4)  # forward, backward
ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7}
LAMBDA = 0.5  # delay compensation of the int8 phases
# the int8 wire of GPT-2 Medium: its groups' int8 bytes plus 4 B a scale row
INT8_WIRE_BYTES = 468_360_320
# |r'| <= s/2 of its row, up to the two roundings (v/s and q·s, each at
# most 127·2^-24·s) that float32 adds
RESID_SLACK = 2.0 ** -15
# the SSM phases: rmsnorm shapes (rows, d, dtype); the step's scan is per
# worker and forward slice B = BATCH_PER_WORKER / R sequences, Mamba2's 48
# heads of 64, state 128, chunk 128
RMS_SHAPES = [(512, 1536, "bfloat16"), (512, 3072, "bfloat16"),
              (1024, 1024, "float32")] + [
    (r, d, dt) for dt in ("float32", "bfloat16")
    for r, d in ((4, 64), (14, 128), (300, 32))] + [
    (16384, 4096, "bfloat16")]
RMS_MAIN = (512, 3072, "bfloat16")   # the gate norm, the kernels line's row
SSD_MAIN = (BATCH_PER_WORKER // R, 48, SEQ, 64, 128, 128)  # B,H,S,P,N,Q
SSD_SHAPES = [SSD_MAIN + (dt, True) for dt in ("bfloat16", "float32")] + [
    (BATCH_PER_WORKER // R, 48, 2048, 64, 128, 128, "bfloat16", True)] + [
    c + (dt, False) for dt in ("float32", "bfloat16")
    for c in ((1, 2, 32, 8, 4, 8), (2, 3, 64, 16, 8, 16),
              (1, 1, 64, 32, 16, 64))]
SSM_PROBE_LAYERS = (0, 47)
ENGINE_TIMEOUT_S = 600.0  # every wait of the stream engine's threads
PROFILE_WINDOW = 5  # --profile: unprofiled steps timed per engine run
# the histories the engine phases must reproduce bit for bit
ENGINE_KEYS = ("loss", "update_staleness", "staleness_mean", "weight_sum",
               "disagreement")
# the chaos phases (DESIGN.md §15): crash → dead → re-sync, a NaN in a
# queued gradient and a corrupted wire payload; then the reference's
# headline plan on the stream engine with the int8 wire
CHAOS_PLAN = ("crash:peer=1,step=2,recover=8;nan:step=5,peer=0,group=0;"
              "corrupt:step=6,group=1")
CHAOS_STEPS = 12
CHAOS_STREAMS_PLAN = "crash:peer=1,step=3,recover=9"
CHAOS_STREAMS_STEPS = 14
# serving (DESIGN.md §12): GPT-2 Medium, 16 requests over 8 slots, prompt
# lengths in [16, 128] from default_rng(5), 64 new tokens; prefill_fn
# (flash #2) against prefill-by-decode on SERVE_HOLD of the prompts,
# logits to 1e-4 and K/V to 1e-5 of their largest |value|
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS = 8, 512, 16
SERVE_PROMPT, SERVE_NEW, SERVE_HOLD = (16, 128), 64, 4
SERVE_LOGIT_TOL, SERVE_KV_TOL = 1e-4, 1e-5
# Mamba2-780M in bf16: the chunked and recurrent forms round to bf16 at
# different points, so each layer's two forms on the same inputs agree to
# 2e-2 of the largest |value| (state, tail). End to end these gaps compound
# over the 48 layers (0.16-0.20 on the card; the reference's own forms
# drift alike, tests/test_torch_decode.py), so the whole path is held in
# float32 (the same weights upcast), to 1e-4 as GPT-2 Medium's logits
SSM_SERVE_MAX_LEN, SSM_SERVE_PROMPT, SSM_SERVE_NEW = 256, (16, 64), 32
SSM_SERVE_TOL, SSM_F32_TOL = 2e-2, 1e-4
IDLE_STEPS = 10  # decode steps timed, then profiled, for the idle share
# the live phases: 2 requests (8-token prompts, 4 new tokens) after each
# training step; the snapshot of step LIVE_HOLD_STEP is digested again
# two steps later
LIVE_MAX_LEN, LIVE_PROMPT, LIVE_NEW, LIVE_HOLD_STEP = 64, 8, 4, 2


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events, one
    pair per run). The runs are queued behind a ~50 ms spin kernel, so work
    shorter than its host dispatch is timed on the device alone, without
    the host's launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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


def quant_bound_ms(numels, rows, itemsize: int, kind: str):
    """Least time for the int8 wire's kernels over stacked buffers of
    ``numels`` elements with ``rows`` scale rows each (all workers), the
    larger of bytes and operations. Bytes, each operand read once and each
    output written once: ``quantize`` reads x and r and writes q (1 B) and
    r' plus a 4 B scale a row; ``dequant`` reads x, q and u and writes o,
    and reads the scales and M α/β pairs a buffer (``M`` = its workers);
    ``pure`` the same without u. Operations per element, over the float32
    rate: quantize 9 (add, abs, max, divide, round, two clips, multiply,
    subtract), dequant 5, pure 4. Returns (ms, bound_by)."""
    n, r = sum(numels), sum(rows)
    nbytes = {
        "quantize": n * (3 * itemsize + 1) + 4 * r,
        "dequant": n * (3 * itemsize + 1) + 4 * r + 8 * M * len(numels),
        "pure": n * (2 * itemsize + 1) + 4 * r + 8 * M * len(numels),
    }[kind]
    flops = n * {"quantize": 9, "dequant": 5, "pure": 4}[kind]
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


def phase_build():
    """Build every CUDA C++ source of the port at once, one ``nvcc`` each."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (lib, seconds) in built.items():
        emit("build", kernel=name,
             source=f"src/repro_torch/csrc/{name}.cu",
             library=os.path.relpath(lib, HERE), seconds=seconds)
    emit("build_all", sources=list(_build.SOURCES),
         seconds=time.perf_counter() - t0)
    for name in ("flash_attention", "ssd_scan", "rmsnorm"):
        emit("ptxas", source=f"src/repro_torch/csrc/{name}.cu",
             kernels=[{**r, "function": kernel_name(r["function"])}
                      for r in _build.ptxas_report(name)])


def kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<float, 64, 2>`` or ``ssd_out_kernel<bf16, float>``
    (the template's types and integers) from a mangled name: the
    identifier ending in ``_kernel`` that its length prefix delimits, then
    its template arguments (a substitution ``S…_`` can only stand for
    ``__nv_bfloat16`` here, the one named type); other names as they
    are."""
    starts = (m.end() for m in re.finditer(r"\d+", mangled))
    for end in starts:  # a length may follow other digits (``_N_116name``)
        names = [mangled[end:end + int(mangled[k:end])]
                 for k in range(end - 1, -1, -1) if mangled[k].isdigit()
                 and mangled[k:end].isdigit()]
        name = next((n for n in names
                     if re.fullmatch(r"[A-Za-z]\w*_kernel", n)), None)
        if name:
            break
    else:
        return mangled
    rest = mangled[end + len(name):]
    if not rest.startswith("I"):
        return name
    args = []
    for a in re.finditer(r"f|13__nv_bfloat16|S\d*_|Li(-?\d+)E|(E)", rest[1:]):
        if a.group(2):
            break
        args.append("float" if a.group(0) == "f" else a.group(1)
                    if a.group(1) else "bf16")
    return f"{name}<{', '.join(args)}>"


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


def phase_quantize(torch):
    """``quantize_plane`` and both ``dequant_mix`` variants against their
    plain versions, bit for bit, over a sweep and at the int8 step's group
    shapes; kernel, plain and bound times at those shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import quant_layout
    from repro_torch.kernels.ref import dequant_mix_ref, quantize_plane_ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2468)

    def randn(shape, dtype, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    def same(name, got, want, case):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} ({case}): {got.dtype} {tuple(got.shape)} vs plain "
              f"{want.dtype} {tuple(want.shape)}")
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs()
            raise AssertionError(
                f"{name} ({case}) is not bit-identical to its plain version:"
                f" {int((diff != 0).sum())} elements differ, max "
                f"{diff.max().item()} (NaN: {bool(diff.isnan().any())})")

    def check_case(x, r, u, alpha, beta, case, out_of_place=True):
        """Both kernels against their plain versions on one buffer; the
        residual is also written over itself, as the step does."""
        want = quantize_plane_ref(x, r)
        if out_of_place:
            for n, g, w in zip(("q", "scales", "resid"),
                               ops.quantize_plane(x, r), want):
                same(f"quantize_plane {n}", g, w, case)
        r_k = r.clone()
        got = ops.quantize_plane(x, r_k, out_resid=r_k)
        check(got[2] is r_k, "out_resid was not written in place")
        for n, g, w in zip(("q", "scales", "resid"), got, want):
            same(f"quantize_plane {n} (in place)", g, w, case)
        del want, r_k
        q, sc = got[0], got[1]
        if x.dim() == 2:
            q, sc = torch.roll(q, 1, 0), torch.roll(sc, 1, 0)
        del got
        for upd in (u, None):
            same("dequant_mix" + ("" if upd is not None else " pure"),
                 ops.dequant_mix(x, q, sc, upd, alpha, beta),
                 dequant_mix_ref(x, q, sc, upd, alpha, beta), case)
        o = x.clone()
        same("dequant_mix (out=x)",
             ops.dequant_mix(o, q, sc, u, alpha, beta, out=o),
             dequant_mix_ref(x, q, sc, u, alpha, beta), case)

    def coefficients(m):
        if m is None:
            return (torch.tensor(0.6, device=dev),
                    torch.tensor(0.4, device=dev))
        w = torch.rand(m, generator=gen, device=dev) + 0.5
        rw = torch.roll(w, 1)
        return w / (w + rw), rw / (w + rw)

    cases = []
    for n in (1, 127, 129, 1029):
        for m in (None, 3):          # a 1-D buffer (M=1) or stacked M=3
            for dtype in (torch.float32, torch.bfloat16):
                shape = (n,) if m is None else (m, n)
                x, r, u = (randn(shape, dtype, sc) for sc in (3.0, 0.01,
                                                              0.01))
                if n > 256:          # an all-zero row
                    x[..., 128:256] = 0
                    r[..., 128:256] = 0
                case = f"n={n} M={m or 1} {str(dtype)[6:]}"
                check_case(x, r, u, *coefficients(m), case)
                cases.append(case)
    zero = torch.zeros((3, 1029), device=dev)
    check_case(zero, zero, zero, *coefficients(3), "all zeros")
    cases.append("all zeros")

    # the int8 step's stacked groups, float32 at M=4, one group at a time
    groups = gpt2_medium_groups()
    alpha, beta = coefficients(M)
    for g, n in groups.items():
        x, r, u = (randn((M, n), torch.float32, sc)
                   for sc in (1.0, 0.004, 0.001))
        check_case(x, r, u, alpha, beta, f"{g} M={M} float32",
                   out_of_place=False)
        cases.append(f"{g} M={M} float32")
        del x, r, u
        torch.cuda.empty_cache()
    n = groups["embed"]
    x, r, u = (randn((M, n), torch.bfloat16, sc) for sc in (1.0, 0.004,
                                                             0.001))
    check_case(x, r, u, alpha, beta, f"embed M={M} bfloat16",
               out_of_place=False)
    cases.append(f"embed M={M} bfloat16")
    del x, r, u
    torch.cuda.empty_cache()

    # times of one step's work: every group once
    bufs = {}
    for g, n in groups.items():
        rows = quant_layout(n)[0]
        bufs[g] = {"x": randn((M, n), torch.float32, 1.0),
                   "r": randn((M, n), torch.float32, 0.004),
                   "u": randn((M, n), torch.float32, 0.001),
                   "q": torch.empty((M, n), dtype=torch.int8, device=dev),
                   "s": torch.empty((M, rows), device=dev),
                   "o": torch.empty((M, n), device=dev)}
    for b in bufs.values():
        ops.quantize_plane(b["x"], b["r"], out_q=b["q"], out_s=b["s"],
                           out_resid=b["r"])

    def quant(fn):
        def run():
            for b in bufs.values():
                fn(b["x"], b["r"], out_q=b["q"], out_s=b["s"],
                   out_resid=b["r"])
        return run

    def mix(fn, pure=False):
        def run():
            for b in bufs.values():
                fn(b["x"], b["q"], b["s"], None if pure else b["u"], alpha,
                   beta, out=b["o"])
        return run

    numels = [M * n for n in groups.values()]
    rows = [M * quant_layout(n)[0] for n in groups.values()]
    timing = {}
    for key, kernel, plain in (
            ("quantize", quant(ops.quantize_plane),
             quant(quantize_plane_ref)),
            ("dequant", mix(ops.dequant_mix), mix(dequant_mix_ref)),
            ("pure", mix(ops.dequant_mix, True),
             mix(dequant_mix_ref, True))):
        bound, bound_by = quant_bound_ms(numels, rows, 4, key)
        timing[key] = {"ms": time_ms(torch, kernel),
                       "plain_ms": time_ms(torch, plain),
                       "bound_ms": bound, "bound_by": bound_by}
    per_group = {g: {
        "quantize_ms": time_ms(torch, lambda b=b: ops.quantize_plane(
            b["x"], b["r"], out_q=b["q"], out_s=b["s"], out_resid=b["r"])),
        "dequant_ms": time_ms(torch, lambda b=b: ops.dequant_mix(
            b["x"], b["q"], b["s"], b["u"], alpha, beta, out=b["o"]))}
        for g, b in bufs.items()}
    del bufs
    torch.cuda.empty_cache()
    res = {"cases": cases, "groups": groups, "M": M, "timing": timing,
           "per_group": per_group, "max_abs_err": 0.0,
           "scale_rows": rows}
    emit("quantize", **res)
    return res


def norm_bound_ms(rows, d, itemsize, gamma_itemsize):
    """Least time for rmsnorm over (rows, d): x read once and the output
    written once, plus γ once, over HBM; or 4 flops an element (square,
    add, scale, γ) over the float32 rate. Returns (ms, bound_by)."""
    nbytes = 2 * rows * d * itemsize + d * gamma_itemsize
    flops = 4 * rows * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_flops(B, H, S, P, N, Q, per_head_cb: bool = False) -> int:
    """Operations of the SSD chunked scan, products over i >= j only
    (T = Q(Q+1)/2 pairs of a chunk), 2 a multiply-add. Per (b, chunk):
    C·Bᵀ, 2·T·N (Bm and Cm are shared across heads). Per (b, h, chunk):
    W·x, 2·T·P; W's decay weights, 3 a pair; C·state and the state's ingest
    (B⊙w)ᵀ·x, 2·Q·N·P each; the state's decay, 2·N·P. The CUDA kernels do
    this work (C·Bᵀ in blocks of its own). ``per_head_cb`` counts C·Bᵀ
    for every head instead, as the TPU kernel recomputes it."""
    T, nc = Q * (Q + 1) // 2, S // Q
    cb = 2 * T * N * B * nc * (H if per_head_cb else 1)
    return cb + B * H * nc * (2 * T * P + 3 * T + 4 * Q * N * P + 2 * N * P)


def ssd_bound_ms(B, H, S, P, N, Q, itemsize, dt_itemsize):
    """Least time for the SSD chunked scan on these inputs, the larger of
    bytes and operations, each kind of operation at the rate of the card's
    unit for it. Operations: ``ssd_flops`` less the work that y does not
    need, since the function returns y alone: C·state only for chunks
    1 .. nc−1 (chunk 0 starts from a zero state), the ingest (B⊙w)ᵀ·x only
    for chunks 0 .. nc−2 (the last chunk's state is never read), the
    state's decay only for chunks 1 .. nc−2. Rates: C·Bᵀ of bf16 operands
    (exact in any product) at the bf16 tensor-core rate; W·x, C·state and
    the ingest, whose W, state and B⊙w are f32 (the TPU kernel's
    preferred_element_type), at 2xTF32 (247.5 TFLOP/s) where the other
    operand (x, C) is bf16 and so exact in TF32, at 3xTF32 (165 TFLOP/s)
    in f32, as C·Bᵀ in f32; the decay weights and the state's decay at
    the float32 rate. Bytes: x, dt, A, Bm and Cm read once, y written
    once. Returns (ms, bound_by)."""
    T, nc = Q * (Q + 1) // 2, S // Q
    cb = 2 * T * N * B * nc
    products = B * H * (nc * 2 * T * P + 2 * (nc - 1) * 2 * Q * N * P)
    elementwise = B * H * (nc * 3 * T + max(nc - 2, 0) * 2 * N * P)
    exact = itemsize == 2   # bf16 x, Bm and Cm
    t_ops = (cb / (BF16_FLOPS_PER_S if exact else TF32X3_FLOPS_PER_S)
             + products / (TF32X2_FLOPS_PER_S if exact
                           else TF32X3_FLOPS_PER_S)
             + elementwise / F32_FLOPS_PER_S)
    nbytes = (2 * B * H * S * P * itemsize + B * H * S * dt_itemsize + 4 * H
              + 2 * B * S * N * itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rms_check(torch, got, want, what: str) -> float:
    """rmsnorm kernel against its plain version: float32 rtol 1e-5 and
    atol 1e-6 (the row's sum runs in another order); bfloat16 within one
    bf16 ulp of each element (2^-7 × |plain|), each side one rounding of
    float32 values that close. Returns max |got − want|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"rmsnorm {what}: {got.dtype} {tuple(got.shape)} vs "
          f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.bfloat16:
        allowed = ULP["bfloat16"] * w.abs()
    else:
        allowed = 1e-6 + 1e-5 * w.abs()
    excess = (diff - allowed).max().item()
    check(excess <= 0, f"rmsnorm {what}: error exceeds its tolerance by "
          f"{excess}")
    return diff.max().item()


def ssd_check(torch, got, want, what: str) -> float:
    """ssd_scan kernel against a plain version, the JAX test's ``_tol``:
    |got − want| ≤ atol + rtol·|want|, bfloat16 2e-2 / 2e-2, float32 rtol
    2e-4 and atol 2e-5 × max(1, max |want|) (the chunk's products are
    summed in other orders; in float32 the two differ by rounding of the
    summands, which grow with the output). Returns max |got − want|."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"ssd_scan {what}: {got.dtype} {tuple(got.shape)} vs "
          f"{want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    scale = max(1.0, w.abs().max().item())
    if got.dtype == torch.bfloat16:
        rtol, atol = 2e-2, 2e-2
    else:
        rtol, atol = 2e-4, 2e-5 * scale
    diff = (g - w).abs()
    excess = (diff - atol - rtol * w.abs()).max().item()
    check(excess <= 0, f"ssd_scan {what}: error exceeds {atol} + "
          f"{rtol}|want| by {excess}")
    return diff.max().item()


def phase_norm_ssd(torch):
    """The CUDA C++ ``rmsnorm`` and ``ssd_scan`` against their plain
    versions on the same CUDA tensors, and their times, at the shapes of
    ``RMS_SHAPES`` and ``SSD_SHAPES``."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import rmsnorm_ref, ssd_ref, ssd_scan_ref

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1357)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rms_cases, rows = [], {}
    for n_rows, d, dn in RMS_SHAPES:
        dt = getattr(torch, dn)
        x = (randn(n_rows, d) * 3).to(dt)
        g = (1 + 0.1 * randn(d)).to(dt)
        got = rk.rmsnorm(x, g)
        err = rms_check(torch, got, rmsnorm_ref(x, g), f"{n_rows}x{d} {dn}")
        check(torch.equal(got, rk.rmsnorm(x, g)),
              f"rmsnorm {n_rows}x{d} {dn}: two calls differ")
        bound, bound_by = norm_bound_ms(n_rows, d, x.element_size(),
                                        g.element_size())
        case = {"shape": [n_rows, d], "dtype": dn, "max_abs_err": err,
                "bit_identical_calls": True,
                "launch": rk.launch_config(x, g),
                "ms": time_ms(torch, lambda: rk.rmsnorm(x, g)),
                "plain_ms": time_ms(torch, lambda: rmsnorm_ref(x, g)),
                "library_ms": time_ms(torch, lambda: F.rms_norm(
                    x, (d,), g, 1e-5)),
                "bound_ms": bound, "bound_by": bound_by}
        rms_cases.append(case)
        if (n_rows, d, dn) == RMS_MAIN:
            rows["rmsnorm"] = {k: case[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
        del x, g

    ssd_cases = []
    for B, H, S, P, N, Q, dn, model_layout in SSD_SHAPES:
        dt_ = getattr(torch, dn)
        A = -torch.exp(randn(H) * 0.3)
        if model_layout:   # the model's strided (B,S,H,P), f32 dt, slices
            x = (randn(B, S, H, P) * 0.5).to(dt_).transpose(1, 2)
            dt = F.softplus(randn(B, S, H)).transpose(1, 2)
            bc = (randn(B, S, 2 * N + 1) * 0.5).to(dt_)
            Bm, Cm = bc[..., 1:N + 1], bc[..., N + 1:]
        else:              # the JAX test's operands, dt in x's dtype
            x = (randn(B, H, S, P) * 0.5).to(dt_)
            dt = F.softplus(randn(B, H, S)).to(dt_)
            Bm, Cm = ((randn(B, S, N) * 0.5).to(dt_) for _ in range(2))
        args = (x, dt, A, Bm, Cm)
        y = sk.ssd_scan(*args, chunk=Q)
        what = f"{[B, H, S, P, N, Q]} {dn}"
        case = {"shape": [B, H, S, P, N, Q], "dtype": dn,
                "model_views": model_layout,
                "aligned": [sk.aligned(t) for t in (x, Bm, Cm)],
                "launch": sk.launch_config(x, Bm, Cm, chunk=Q),
                "max_abs_err": ssd_check(torch, y, ssd_scan_ref(
                    *args, chunk=Q), what)}
        check(torch.equal(y, sk.ssd_scan(*args, chunk=Q)),
              f"ssd_scan {what}: two calls differ")
        case["bit_identical_calls"] = True
        if not model_layout:
            case["max_abs_err_sequential"] = ssd_check(
                torch, y, ssd_ref(*args), what + " vs sequential")
        if model_layout:
            bound, bound_by = ssd_bound_ms(B, H, S, P, N, Q,
                                           x.element_size(),
                                           dt.element_size())
            case.update(ms=time_ms(torch, lambda: sk.ssd_scan(*args,
                                                              chunk=Q)),
                        plain_ms=time_ms(torch, lambda: ssd_scan_ref(
                            *args, chunk=Q)),
                        bound_ms=bound, bound_by=bound_by,
                        device_ms_by_kernel=device_ms_by_kernel(
                            torch, lambda: sk.ssd_scan(*args, chunk=Q)),
                        flops=ssd_flops(B, H, S, P, N, Q),
                        tpu_kernel_flops=ssd_flops(B, H, S, P, N, Q,
                                                   per_head_cb=True))
        if (B, H, S, P, N, Q) == SSD_MAIN and dn == "bfloat16":
            rows["ssd_scan"] = {k: case[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
            rows["ssd_scan"]["library_ms"] = None
        ssd_cases.append(case)
        del x, dt, Bm, Cm, args, y
    torch.cuda.empty_cache()
    emit("norm_ssd", rmsnorm=rms_cases, ssd_scan=ssd_cases, rows=rows)
    return rows


def probe_ssm_kernels(torch, cfg, part, read, batch):
    """``ssd_scan`` and ``rmsnorm`` on the training step's own activations:
    worker 0's read plane, the first forward slice of its first batch.
    Layers ``SSM_PROBE_LAYERS`` are run through the model's plain forms up
    to the mixer (``ssm_mixer_inputs``, ``ssd_chunked``), keeping the mixer's
    operands and y, the pre-norm and gate-norm inputs, and the final norm's
    input. Then, with the two counts zeroed, the kernels run on them (the
    probe's path), and only after that are their outputs held against the
    model's: ``ssd_scan`` against the plain ``ssd_scan_ref`` on the same
    operands at the bfloat16 tolerance; ``rmsnorm`` within one bf16 ulp of
    the model's norm. The gap between the kernel's y and the model's own
    (the model rounds W and the states to bf16, the kernel keeps f32) is
    reported as a reading, not checked. Returns the probe's launches,
    errors and gaps."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    params = part.unpack({k: v[0] for k, v in read.items()})
    tokens = batch["tokens"][0][:BATCH_PER_WORKER // R]
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    mixers, norms = {}, {}
    with torch.no_grad():
        h = L.embed_apply(params["embed"], tokens)
        for layer, sub in T.decoder_layers(params):
            if layer in SSM_PROBE_LAYERS:
                p = sub["ssm"]
                xn = L.rmsnorm(h, p["norm"], cfg.norm_eps)
                x_ssm, dt, A, Bm, Cm, z, _ = S.ssm_mixer_inputs(p, xn, cfg)
                y, _ = S.ssd_chunked(x_ssm, dt, A, Bm, Cm)
                mixers[layer] = ((x_ssm.transpose(1, 2), dt.transpose(1, 2),
                                  A, Bm, Cm), y.transpose(1, 2))
                norms[f"layer{layer}_pre"] = (h, p["norm"])
                norms[f"layer{layer}_gate"] = (
                    S.ssm_gate_input(p, y, x_ssm, z), p["gate_norm"])
            h, _ = T.decoder_layer(sub, h, cfg, positions=positions)
        norms["final"] = (h, params["final_norm"])
        torch.cuda.synchronize()
        rk.reset_launches()                         # the probe's path starts
        sk.reset_launches()
        y_k = {l: ops.ssd_scan(*m[0]) for l, m in mixers.items()}
        n_k = {n: ops.rmsnorm(x, g, eps=cfg.norm_eps)
               for n, (x, g) in norms.items()}
        torch.cuda.synchronize()
        launches = {"rmsnorm": rk.launches,         # the probe's path ends
                    "ssd_scan": sk.launches}
        want = {"rmsnorm": len(norms), "ssd_scan": len(mixers)}
        check(launches == want, f"probe launches {launches} != {want}")
        err, gap = {}, {}
        for l, (args, y_model) in mixers.items():
            err[f"ssd_scan layer{l} vs plain"] = ssd_check(
                torch, y_k[l], ssd_scan_ref(*args), f"layer {l} activations")
            gap[f"ssd_scan layer{l} vs model"] = (
                y_k[l].float() - y_model.float()).abs().max().item()
            gap[f"max |y| layer{l}"] = y_model.float().abs().max().item()
        for n, (x, g) in norms.items():
            err[f"rmsnorm {n}"] = rms_check(
                torch, n_k[n], L.rmsnorm(x, g, cfg.norm_eps), n)
        shapes = {f"ssd_scan layer{l}": [list(t.shape) for t in m[0]]
                  for l, m in mixers.items()}
        shapes.update({f"rmsnorm {n}": list(x.shape)
                       for n, (x, _) in norms.items()})
    return {"launches": launches, "max_abs_err": err,
            "model_gap": gap, "shapes": shapes,
            "dtype": str(h.dtype).replace("torch.", "")}


def phase_train_ssm(torch, profile: bool):
    """The SSM family's main path: ``train``'s entry points and traffic
    with Mamba2-780M at full width and depth in bfloat16."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda")
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches,
        (gm_kernel.reset_launches, fa.reset_launches, rk.reset_launches,
         sk.reset_launches))
    launches = {"gossip_mix": gm_kernel.launches,
                "flash": fa.fwd_launches + fa.dq_launches + fa.dkv_launches,
                "rmsnorm": rk.launches, "ssd_scan": sk.launches}
    n_groups = len(backend.part.group_sizes)
    want = {"gossip_mix": TRAIN_STEPS * n_groups, "flash": 0, "rmsnorm": 0,
            "ssd_scan": 0}
    check(launches == want, f"train_ssm launches {launches} != {want}")
    check_history(hist, cfg.vocab_size, "train_ssm")
    state = out["state"]
    check(all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
              for v in state["read"].values()), "train_ssm plane")
    if profile:
        def run(b):
            nonlocal state
            state, _ = backend.step(state, b)
        profile_steps(torch, run, batches[:2], model=cfg.name)
    probe = probe_ssm_kernels(torch, cfg, backend.part, state["read"],
                              batches[0])
    med = statistics.median(step_s[1:])
    tokens = M * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": "bfloat16",
           "params": sum(backend.part.group_sizes.values()), "M": M,
           "fb_ratio": R, "update_delay": 1, "seq": SEQ,
           "batch_per_worker": BATCH_PER_WORKER, "steps": TRAIN_STEPS,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "peak_bytes": peak, "step_launches": launches,
           "wire_bytes_per_round": out["wire_bytes_per_round"],
           "groups": dict(backend.part.group_sizes), "probe": probe}
    emit("train_ssm", **res)
    del out, state, params
    torch.cuda.empty_cache()
    return res


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible in one head."""
    import numpy as np
    q, k = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= (q - k) < window
    return int(mask.sum())


def attention_bound_ms(B, Hq, Hkv, S, D, causal, window, itemsize, kind):
    """Least time for flash attention's work on these inputs, the larger of
    operations and bytes. Operations: the matrix products over the visible
    pairs only, 2 flops a multiply-add: forward QKᵀ and PV (4·D a pair);
    backward S, dP, dV, dK and dQ (10·D a pair) plus delta = rowsum(do·o);
    ``trainable`` both. Rate: for f32 operands the card's f32-accurate rate
    on the tensor cores, TF32 over the three products of 3xTF32 (165
    TFLOP/s; whatever the kernel does, the bound is the card's); bf16
    tensor cores for bf16.
    Bytes: each input read once, each output written once: forward q, k, v
    in, o and the f32 lse out; backward q, k, v, o, do and lse in, dq, dk,
    dv out; trainable q, k, v and do in, o, dq, dk and dv out. Returns
    (ms, bound_by)."""
    pairs = B * Hq * attention_pairs(S, S, causal, window)
    nq, nkv = B * Hq * S * D * itemsize, B * Hkv * S * D * itemsize
    nlse, delta = B * Hq * S * 4, 2 * B * Hq * S * D
    flops, nbytes = {
        "fwd": (4 * D * pairs, 2 * nq + 2 * nkv + nlse),
        "bwd": (10 * D * pairs + delta, 4 * nq + 4 * nkv + nlse),
        "trainable": (14 * D * pairs + delta, 4 * nq + 4 * nkv),
    }[kind]
    rate = TF32X3_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_flash(torch):
    """Build the CUDA C++ flash kernels, hold each against its plain
    version, and time kernel, plain and library at the main path's shape."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4321)

    def operands(B, Hq, Hkv, S, D, dtype):
        """q, k, v, do as (B, H, S, D) views of (B, S, H, D) tensors, as the
        decoder passes them."""
        dt = getattr(torch, dtype)
        return [torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
                .transpose(1, 2) for H in (Hq, Hkv, Hkv, Hq)]

    def misaligned(B, Hq, Hkv, S, D, dtype):
        """q, k, v, do with a storage offset of 1 element and a sequence
        stride of H·D + 3: no operand takes the 16-byte copies."""
        def view(H):
            row = H * D + 3
            buf = torch.randn(B * S * row + 1, generator=gen,
                              device=dev).to(getattr(torch, dtype))
            return buf.as_strided((B, S, H, D), (S * row, row, D, 1),
                                  1).transpose(1, 2)
        ops_ = [view(H) for H in (Hq, Hkv, Hkv, Hq)]
        check(not any(fa.aligned(t) for t in ops_),
              "the misaligned case has an aligned operand")
        return ops_

    def max_err(name, got, want, tol, dtype="float32", scale=None):
        diff, ref = (got.float() - want.float()).abs(), want.float().abs()
        scale = ref.max() if scale is None else scale
        excess = (diff - ULP[dtype] * ref - tol * scale).max().item()
        check(excess <= 0, f"flash {name} ({dtype}): error exceeds "
              f"{ULP[dtype]} x |plain| + {tol} x {float(scale)} by {excess}")
        return diff.max().item()

    def check_case(B, Hq, Hkv, S, D, causal, window, dtype, make=operands):
        q, k, v, do = make(B, Hq, Hkv, S, D, dtype)
        kw = dict(causal=causal, window=window)
        tol_f, tol_b = FLASH_TOL
        o, lse = fa.flash_attention(q, k, v, **kw)
        o_r, lse_r = flash_attention_ref(q, k, v, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o_r, lse_r, do, **kw)
        want = flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)
        torch.cuda.synchronize()
        dp_scale = None
        if S == 1:  # dq, dk: 0 exactly; noise of dP − delta, |dP| = |do·v|
            G = Hq // Hkv
            dp_scale = (do.reshape(B, Hkv, G, S, D).float()
                        * v[:, :, None].float()).sum(-1).abs().max()
        errs = {"o": max_err("o", o, o_r, tol_f, dtype),
                "lse": max_err("lse", lse, lse_r, 1e-5)}
        for n, g, w in zip(("dq", "dk", "dv"), grads, want):
            errs[n] = max_err(n, g, w, tol_b, dtype,
                              dp_scale if n != "dv" else None)
        return {"shape": [B, Hq, Hkv, S, D], "causal": causal,
                "window": window, "dtype": dtype, "tol": [tol_f, tol_b],
                "ulp": ULP[dtype], "aligned": fa._aligned_bits(q, k, v, do),
                "max_abs_err": errs, "max_abs_plain": {
                    n: w.float().abs().max().item() for n, w in zip(
                        ("o", "lse", "dq", "dk", "dv"),
                        (o_r, lse_r) + tuple(want))}}

    def deterministic(B, Hq, Hkv, S, D, causal, window, dtype):
        """Two calls on the same inputs: o, lse, dq, dk, dv bit-identical."""
        q, k, v, do = operands(B, Hq, Hkv, S, D, dtype)
        kw = dict(causal=causal, window=window)
        runs = []
        for _ in range(2):
            o, lse = fa.flash_attention(q, k, v, **kw)
            runs.append((o, lse) + fa.flash_attention_bwd(q, k, v, o, lse,
                                                          do, **kw))
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(a, b)) for n, a, b in zip(
            ("o", "lse", "dq", "dk", "dv"), *runs)}
        check(all(same.values()), f"flash not deterministic: {same}")
        return same

    emit("flash_config", kernels={str(dt).split(".")[-1]: fa.launch_config(
        dt, 64) for dt in (torch.float32, torch.bfloat16)})
    cases = [check_case(*c) for c in [FLASH_MAIN] + FLASH_SWEEP
             + FLASH_EXTRA]
    cases.append(check_case(*FLASH_MISALIGNED, make=misaligned))
    same = {dt: deterministic(*FLASH_MAIN[:7], dt)
            for dt in ("float32", "bfloat16")}
    main = cases[0]["max_abs_err"]

    B, Hq, Hkv, S, D, causal, window, dtype = FLASH_MAIN
    q, k, v, do = operands(B, Hq, Hkv, S, D, dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, **kw)
    args = [t.detach().requires_grad_(True) for t in (q, k, v)]

    def trainable():
        out = ops.flash_attention_trainable(*args, **kw)
        return out, torch.autograd.grad(out, args, do)

    def trainable_plain():
        o_r, lse_r = flash_attention_ref(q, k, v, **kw)
        return o_r, flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def sdpa_trainable():
        out = F.scaled_dot_product_attention(*args, is_causal=causal)
        return torch.autograd.grad(out, args, do)

    # the library's backward alone: its graph, from one forward, kept
    sdpa_out = F.scaled_dot_product_attention(*args, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, args, do, retain_graph=True)

    (t_o, t_g), (p_o, p_g) = trainable(), trainable_plain()
    tol_f, tol_b = FLASH_TOL
    train_err = max([max_err("trainable o", t_o, p_o, tol_f, dtype)]
                    + [max_err(f"trainable d{n}", g, w, tol_b, dtype)
                       for n, g, w in zip("qkv", t_g, p_g)])
    rows = {
        "flash_attention": {
            "max_abs_err": max(main["o"], main["lse"]),
            "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                q, k, v, **kw)),
            "library_ms": time_ms(torch, sdpa)},
        "flash_attention_bwd": {
            "max_abs_err": max(main["dq"], main["dk"], main["dv"]),
            "ms": time_ms(torch, lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, **kw)),
            "plain_ms": time_ms(torch, lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, **kw)),
            "library_ms": time_ms(torch, sdpa_bwd)},
        "flash_attention_trainable": {
            "max_abs_err": train_err,
            "ms": time_ms(torch, trainable),
            "plain_ms": time_ms(torch, trainable_plain),
            "library_ms": time_ms(torch, sdpa_trainable)},
    }
    itemsize = 4 if dtype == "float32" else 2
    for kind, row in zip(("fwd", "bwd", "trainable"), rows.values()):
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            B, Hq, Hkv, S, D, causal, window, itemsize, kind)
    emit("flash", main_shape=list(FLASH_MAIN), cases=cases,
         bit_identical_reruns=same, rows=rows)
    del q, k, v, do, o, lse, args, sdpa_out
    torch.cuda.empty_cache()
    return rows


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


HISTORY_KEYS = ("loss", "weight_sum", "update_staleness", "staleness_mean",
                "disagreement", "nonfinite_skips")
MEMBERSHIP_KEYS = HISTORY_KEYS + ("peers_live",)


def counted_drive(torch, backend, params, batches, resets,
                  keys=HISTORY_KEYS, on_batch=None):
    """``drive`` over ``batches`` with the launch counts zeroed (each of
    ``resets`` called) just before; the caller reads them right after.
    ``on_batch(t)``, when given, runs at each synchronised handover, before
    step ``t`` (init has run by the first). Returns (out, history of
    ``keys``, step seconds, peak device bytes); a step's time is host clock
    between synchronised batch handovers. ``out["bytes_before_init"]`` is
    what was allocated when the window opened (earlier phases' leftovers,
    e.g. cuBLAS workspaces of their streams), the floor under the peak."""
    from repro_torch.core.backend import drive

    stamps = []

    def timed(batches):
        for t, b in enumerate(batches):
            torch.cuda.synchronize()
            if on_batch is not None:
                on_batch(t)
            stamps.append(time.perf_counter())
            yield b

    gc.collect()  # earlier phases' cyclic garbage out of the peak
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    allocs = alloc_counts(torch)
    for reset in resets:                            # main path starts
        reset()
    out = drive(backend, timed(batches), None, params, history_keys=keys)
    out["bytes_before_init"] = base
    out["allocator"] = alloc_delta(allocs, alloc_counts(torch))
    settle(torch, backend)                          # main path ends
    stamps.append(time.perf_counter())
    hist = {k: [float(v) for v in out["history"][k]] for k in keys}
    return (out, hist, [b - a for a, b in zip(stamps, stamps[1:])],
            torch.cuda.max_memory_allocated())


def launch_resets():
    """The launch counters of the kernels a training step can launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import quantize as qk

    return (gm_kernel.reset_launches, fa.reset_launches, qk.reset_launches)


def step_launches() -> dict:
    """Every training-step kernel's launches since the counters' reset."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import quantize as qk

    return {"gossip_mix": gm_kernel.launches,
            "flash_fwd": fa.fwd_launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches,
            "quantize_plane": qk.quantize_launches,
            "dequant_mix": qk.dequant_mix_launches}


def plane_digests(torch, plane, chunk: int = 1 << 26) -> dict:
    """A SHA-256 digest of each group buffer of a plane: its bytes copied
    to the host a chunk at a time (so no second plane is kept on the card),
    each chunk hashed on a thread of its own, and the group's digest the
    SHA-256 of its chunks' digests in order (hashlib releases the
    interpreter lock while it hashes, so the chunks hash in parallel)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    def sha(b):
        return hashlib.sha256(b).digest()

    out = {}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for g, buf in plane.items():
            flat = buf.reshape(-1)
            parts, pending = [], []
            for lo in range(0, flat.numel(), chunk):
                host = (flat[lo:lo + chunk].contiguous().view(torch.uint8)
                        .cpu().numpy())
                pending.append(pool.submit(sha, host))
                if len(pending) >= 8:  # at most 8 chunks on the host
                    parts.append(pending.pop(0).result())
            parts.extend(f.result() for f in pending)
            out[g] = hashlib.sha256(b"".join(parts)).hexdigest()
    return out


def settle(torch, backend) -> None:
    """Wait until the backend's work is done: the stream engine's tasks all
    launched (and their spans recorded), then the card idle."""
    if getattr(backend, "streams", 1) > 1:
        backend.engine.finalize()
    torch.cuda.synchronize()


def window_drive(torch, backend, params, batches, resets,
                 keys=HISTORY_KEYS):
    """The engine phases' drive: init and step 0, then steps 1.. as ONE
    window between two synchronisations with no copy to the host inside
    it (``drive``'s per-step metric copies and ``counted_drive``'s
    per-batch synchronisations would hide any run-ahead); the metrics are
    read after the window. The launch counters are zeroed (``resets``)
    just before init. Returns (state, history, window seconds, peak device
    bytes, bytes allocated before init)."""
    gc.collect()  # earlier phases' cyclic garbage out of the peak
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for reset in resets:                            # main path starts
        reset()
    state = backend.init(None, params)
    state, m = backend.step(state, batches[0])
    metrics = [m]
    settle(torch, backend)
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, m = backend.step(state, b)
        metrics.append(m)
    settle(torch, backend)                          # main path ends
    window = time.perf_counter() - t0
    hist = {k: [float(m[k]) for m in metrics] for k in keys}
    return state, hist, window, torch.cuda.max_memory_allocated(), base


def hold_engine(name: str, got: dict, ref: dict, ref_name: str,
                keys=ENGINE_KEYS) -> None:
    """An engine run against its monolithic run: the histories of ``keys``,
    launch counts and the final read plane's digests identical."""
    for k in keys:
        check(got["history"][k] == ref["history"][k],
              f"{name} {k} {got['history'][k]} != {ref_name} "
              f"{ref['history'][k]}")
    check(got["all_launches"] == ref["all_launches"],
          f"{name} launches {got['all_launches']} != {ref_name} "
          f"{ref['all_launches']}")
    check(got["read_plane_sha256"] == ref["read_plane_sha256"],
          f"{name} read plane differs from {ref_name}'s")


def phase_train_engine(torch, name, ref, *, int8: bool = False, **engine):
    """The train phase's run (train_int8's with ``int8``) through an engine
    (``engine``: ``overlap=True[, streams=n]``), timed as one window
    (``window_drive``) and held against ``ref``, the monolithic run, when
    given. Returns (result, backend); the backend's state is dropped and
    its engine reset, so it holds no plane."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    wire = dict(wire="int8", compensate=LAMBDA) if int8 else {}
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", wait_timeout_s=ENGINE_TIMEOUT_S,
                           **wire, **engine)
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    membership = "faults" in engine
    state, hist, window, peak, base = window_drive(
        torch, backend, params, batches, launch_resets(),
        keys=MEMBERSHIP_KEYS if membership else HISTORY_KEYS)
    every = step_launches()
    check_history(hist, cfg.vocab_size, name)
    if membership:
        check(hist["peers_live"] == [float(M)] * TRAIN_STEPS,
              f"{name} peers_live {hist['peers_live']}")
    summary = backend.summary()
    timeline = backend.timeline.summary()
    read = state["read"]
    if backend.streams > 1:
        read = backend.engine.materialize(read)
    digests = plane_digests(torch, read)
    steps = len(batches) - 1
    tokens = M * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "M": M, "fb_ratio": R, "update_delay": 1,
           **wire, **engine, "steps": TRAIN_STEPS, "history": hist,
           "all_launches": every, "read_plane_sha256": digests,
           "window_steps": steps, "window_s": window,
           "window_step_s": window / steps,
           "tokens_per_s": tokens * steps / window, "peak_bytes": peak,
           "bytes_before_init": base,
           "describe": backend.engine.describe,
           **{k: summary[k] for k in (
               "pipeline_wall_s", "overlap_events", "overlap_s",
               "fwd_gossip_overlap_s", "streams", "exec_overlap_s",
               "signal_wait_s")},
           "stage_s": timeline["stage_s"],
           "stream_busy_s": timeline["stream_busy_s"]}
    if membership:
        res["chaos"] = chaos_counters(summary)
    if ref is not None:
        hold_engine(name, res, ref, ref["phase"])
        res["held_against"] = ref["phase"]
    emit(name, **res)
    del state, read, params
    backend.engine.reset()
    torch.cuda.empty_cache()
    return res, backend


def profiled_busy(torch, fn):
    """``fn()`` under torch.profiler (CUDA activity): the device's busy time
    with the kernels of all streams merged into one timeline (time when at
    least one ran), the plain sum of kernel times, and the kernel count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    union, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return union / 1e6, sum(b - a for a, b in spans) / 1e6, len(spans)


def phase_profile_engines(torch, backends, batches):
    """--profile: the monolithic step, the pipeline and the streams
    alternated on one state (m, p, s, s, p, m). Each run times
    ``PROFILE_WINDOW`` steps as one window between two synchronisations,
    then profiles two more: device time per step (kernels merged over the
    streams) and idle share = 1 − device time per step / the window's time
    per step; the engines' overlap fields over the window."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    params = build_model(get_config("gpt2-medium")).init(seed=0,
                                                         device="cuda")
    state = backends["monolithic"].init(None, params)
    del params
    rows = {k: [] for k in backends}
    for name in ("monolithic", "pipeline", "streams", "streams", "pipeline",
                 "monolithic"):
        be = backends[name]
        if be.engine is not None:
            be.engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches[:PROFILE_WINDOW]:
            state, _ = be.step(state, b)
        settle(torch, be)
        window = time.perf_counter() - t0
        summary = be.summary()

        def run():
            nonlocal state
            for b in batches[PROFILE_WINDOW:PROFILE_WINDOW + 2]:
                state, _ = be.step(state, b)
            settle(torch, be)

        busy, kernel_sum, kernels = profiled_busy(torch, run)
        if be.streams > 1:
            state = be.engine.materialize(state)
        row = {"run": name, "window_step_s": window / PROFILE_WINDOW,
               "device_s_per_step": busy / 2,
               "kernel_s_per_step": kernel_sum / 2,
               # time two or more kernels ran at once (streams only)
               "concurrent_kernel_s_per_step": (kernel_sum - busy) / 2,
               "kernels_per_step": kernels / 2,
               "idle_share": 1.0 - busy / 2 / (window / PROFILE_WINDOW),
               **{k: summary.get(k) for k in (
                   "streams", "exec_overlap_s", "overlap_s",
                   "fwd_gossip_overlap_s", "signal_wait_s")}}
        rows[name].append(row)
        emit("engine_profile", **row)
    emit("engine_profile_summary", order="m, p, s, s, p, m",
         **{name: {k: statistics.median(r[k] for r in rs)
                   for k in ("window_step_s", "device_s_per_step",
                             "idle_share")}
            for name, rs in rows.items()})
    del state
    torch.cuda.empty_cache()


def check_history(hist, vocab: int, what: str) -> None:
    """Finite losses near ln(V) at random init, Σw = 1 ± 1e-5, no skips."""
    check(all(math.isfinite(v) for v in hist["loss"]), f"{what} loss {hist}")
    check(all(abs(v - 1.0) <= 1e-5 for v in hist["weight_sum"]),
          f"{what} weight_sum {hist['weight_sum']}")
    check(abs(hist["loss"][0] - math.log(vocab)) < 0.5,
          f"{what} first loss {hist['loss'][0]} far from ln(V) at random "
          "init")
    check(hist["nonfinite_skips"] == [0.0] * TRAIN_STEPS,
          f"{what} nonfinite skips")


def chaos_counters(summary: dict) -> dict:
    """The controller's counters of a backend's ``summary()``."""
    keys = ("faults_injected", "rounds_degraded", "peers_dead",
            "peers_suspect", "resyncs", "hangs", "nan_injections",
            "rounds_sealed", "checksum_rejects", "drops_detected", "resends",
            "time_to_detect_steps", "time_to_resync_steps",
            "nonfinite_skips", "peers_live")
    return {k: summary[k] for k in keys if k in summary}


def live_schedule(plan: str, steps: int) -> list:
    """``peers_live`` at each step as the membership ladder predicts for a
    plan of single crashes with ``recover=``: 1 missed beat makes a peer
    SUSPECT (still mixing), 2 make it DEAD, the recover step re-admits it."""
    live = [float(M)] * steps
    for ev in plan.split(";"):
        kind, _, body = ev.partition(":")
        if kind != "crash":
            continue
        f = dict(kv.split("=") for kv in body.split(","))
        dead_from = int(f["step"]) + 1
        until = int(f.get("recover", steps))
        for t in range(dead_from, min(until, steps)):
            live[t] -= 1.0
    return live


def resync_probe(torch, backend, step: int, peer: int, donor: int):
    """A ``counted_drive`` hook that holds the peer's read-plane rows against
    the donor's right after the controller's ``before_step`` of ``step``:
    at the first handover it wraps the hook of the controller that init
    made. Returns (on_batch, rows); ``rows["equal"]`` is the verdict."""
    rows = {}

    def on_batch(t):
        if t:
            return
        before = backend.chaos.before_step

        def before_step(state, batch, s):
            state, batch = before(state, batch, s)
            if s == step:
                rows["equal"] = all(bool(torch.equal(v[peer], v[donor]))
                                    for v in state["read"].values())
            return state, batch

        backend.chaos.before_step = before_step

    return on_batch, rows


def chaos_drive(torch, backend, params, batches, resync):
    """A faulted run through ``counted_drive`` (histories of
    ``MEMBERSHIP_KEYS``), with ``resync=(step, peer, donor)`` probed
    (``resync_probe``). Returns (state, history, step seconds, peak bytes,
    rows_equal, bytes allocated before init)."""
    on_batch, rows = resync_probe(torch, backend, *resync)
    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches, launch_resets(),
        keys=MEMBERSHIP_KEYS, on_batch=on_batch)
    return (out["state"], hist, step_s, peak, rows.get("equal"),
            out["bytes_before_init"])


def chaos_backend(torch, plan: str, **kw):
    """GPT-2 Medium at full width and depth with ``faults=plan``: (backend,
    params, config)."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", wait_timeout_s=ENGINE_TIMEOUT_S,
                           faults=plan, **kw)
    return backend, params, cfg


def chaos_result(torch, name, backend, cfg, plan, state, hist, step_s, peak,
                 steps, **extra):
    """The checks every faulted run shares, and its JSON line's fields:
    finite loss, |Σw − 1| ≤ 1e-5 at every step, ``peers_live`` as the
    ladder predicts, a finite read plane; the step times, peak bytes, the
    host seconds of each fault event and the controller's counters."""
    check(all(math.isfinite(v) for v in hist["loss"]),
          f"{name} loss {hist['loss']}")
    check(all(abs(v - 1.0) <= 1e-5 for v in hist["weight_sum"]),
          f"{name} weight_sum {hist['weight_sum']}")
    want_live = live_schedule(plan, steps)
    check(hist["peers_live"] == want_live,
          f"{name} peers_live {hist['peers_live']} != {want_live}")
    read = state["read"]
    if backend.streams > 1:
        read = backend.engine.materialize(read)
    check(all(bool(torch.isfinite(v).all()) for v in read.values()),
          f"{name} nonfinite read plane")
    summary = backend.summary()
    events = backend.chaos.event_s
    res = {"model": cfg.name, "M": M, "fb_ratio": R, "update_delay": 1,
           "faults": plan, "steps": steps, "history": hist,
           "step_s": step_s, "median_step_s": statistics.median(step_s),
           "peak_bytes": peak, "all_launches": step_launches(),
           "read_plane_sha256": plane_digests(torch, read),
           "chaos": chaos_counters(summary),
           **{f"{k}_s": v for k, v in events.items()}, **extra}
    return res, summary


def phase_train_chaos(torch):
    """train_chaos: the monolithic param-wire step under CHAOS_PLAN."""
    backend, params, cfg = chaos_backend(torch, CHAOS_PLAN)
    batches = lm_batches(torch, cfg.vocab_size, CHAOS_STEPS, seed=0)
    state, hist, step_s, peak, rows_equal, base = chaos_drive(
        torch, backend, params, batches, resync=(8, 1, 0))
    del params
    res, summary = chaos_result(torch, "train_chaos", backend, cfg,
                                CHAOS_PLAN, state, hist, step_s, peak,
                                CHAOS_STEPS, resync_rows_equal=rows_equal,
                                bytes_before_init=base)
    check(rows_equal is True, "train_chaos: peer 1's rows differ from the "
          "donor's right after the resync")
    c = res["chaos"]
    check(c["resyncs"] == 1 and c["checksum_rejects"] == 1
          and c["resends"] == 1 and c["nonfinite_skips"] >= 1.0
          and c["peers_dead"] == 0, f"train_chaos counters {c}")
    n_groups = len(backend.part.group_sizes)
    launches = res["all_launches"]
    check(launches["gossip_mix"] == CHAOS_STEPS * n_groups,
          f"train_chaos gossip_mix launches {launches['gossip_mix']} != "
          f"{CHAOS_STEPS} x {n_groups}")
    per_pass = CHAOS_STEPS * M * cfg.num_layers
    flash = {k: launches[f"flash_{k}"] for k in ("fwd", "dq", "dkv")}
    check(flash == {"fwd": per_pass * R, "dq": per_pass, "dkv": per_pass},
          f"train_chaos flash launches {flash}")
    emit("train_chaos", **res)
    del state
    torch.cuda.empty_cache()
    return res


def phase_train_chaos_streams_int8(torch):
    """train_chaos_int8 (monolithic) and train_chaos_streams_int8
    (``streams=3``): CHAOS_STREAMS_PLAN on the int8 wire, the stream run
    held bit-identical to the monolithic one."""
    runs = {}
    for name, engine in (("train_chaos_int8", {}),
                         ("train_chaos_streams_int8",
                          dict(overlap=True, streams=3))):
        backend, params, cfg = chaos_backend(
            torch, CHAOS_STREAMS_PLAN, wire="int8", **engine)
        batches = lm_batches(torch, cfg.vocab_size, CHAOS_STREAMS_STEPS,
                             seed=0)
        state, hist, step_s, peak, rows_equal, base = chaos_drive(
            torch, backend, params, batches, resync=(9, 1, 0))
        del params
        res, summary = chaos_result(
            torch, name, backend, cfg, CHAOS_STREAMS_PLAN, state, hist,
            step_s, peak, CHAOS_STREAMS_STEPS, wire="int8",
            resync_rows_equal=rows_equal, bytes_before_init=base, **engine)
        c = res["chaos"]
        check(c["resyncs"] == 1 and c["peers_dead"] == 0
              and summary["peers_live"] == float(M) and rows_equal is True,
              f"{name} counters {c}, rows equal {rows_equal}")
        n_groups = len(backend.part.group_sizes)
        launches = res["all_launches"]
        want = {"quantize_plane": CHAOS_STREAMS_STEPS * n_groups,
                "dequant_mix": CHAOS_STREAMS_STEPS * n_groups,
                "gossip_mix": 0}
        got = {k: launches[k] for k in want}
        check(got == want, f"{name} int8 launches {got} != {want}")
        if engine:
            res["overlap"] = {k: summary[k] for k in (
                "streams", "exec_overlap_s", "signal_wait_s")}
            hold_engine(name, res, runs["train_chaos_int8"],
                        "train_chaos_int8", keys=MEMBERSHIP_KEYS)
            res["held_against"] = "train_chaos_int8"
        emit(name, **res)
        runs[name] = res
        del state
        if engine:
            backend.engine.close()
        del backend
        torch.cuda.empty_cache()
    return runs


def phase_train(torch, profile: bool, name: str = "train", **faults):
    """The train phase; with ``faults=""`` the same run with membership on
    (``name`` train_membership_empty), which the caller holds against
    train."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", **faults)
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches, launch_resets(),
        keys=MEMBERSHIP_KEYS if faults else HISTORY_KEYS)
    every = step_launches()
    launches = gm_kernel.launches
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    n_groups = len(backend.part.group_sizes)
    check(launches == TRAIN_STEPS * n_groups,
          f"gossip_mix launches {launches} != {TRAIN_STEPS} x {n_groups}")
    per_pass = TRAIN_STEPS * M * cfg.num_layers
    want = {"fwd": per_pass * R, "dq": per_pass, "dkv": per_pass}
    check(flash == want, f"flash launches {flash} != {want}")
    check_history(hist, cfg.vocab_size, name)
    if faults:
        check(hist["peers_live"] == [float(M)] * TRAIN_STEPS,
              f"{name} peers_live {hist['peers_live']}")
    read = out["state"]["read"]
    check(all(bool(torch.isfinite(v).all()) for v in read.values()),
          "nonfinite plane")
    digests = plane_digests(torch, read)
    med = statistics.median(step_s[1:])
    tokens = M * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(backend.part.group_sizes.values()), "M": M,
           "fb_ratio": R, "update_delay": 1, "seq": SEQ,
           "batch_per_worker": BATCH_PER_WORKER, "steps": TRAIN_STEPS,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "peak_bytes": peak, "bytes_before_init": out["bytes_before_init"],
           "allocator": out["allocator"],
           "gossip_mix_launches": launches,
           "flash_launches": flash, "all_launches": every,
           "read_plane_sha256": digests,
           "groups": dict(backend.part.group_sizes), **faults}
    if faults:
        res["chaos"] = chaos_counters(out)
    emit(name, **res)
    if profile:
        phase_profile(torch, backend, out["state"], batches)
    del out, read, params
    torch.cuda.empty_cache()
    return res, backend


def device_events(torch, fn, cpu: bool = False):
    """``fn()`` once under torch.profiler (CUDA activity, and the host's
    with ``cpu``), synchronised before and after, every event of the
    window kept (``acc_events``). Returns the wall seconds of the window
    and ``[(device_us, kernel, count)]`` of its device-side events
    (kernels, copies, fills), the largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts, acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.count]
    return wall, sorted(rows, reverse=True)


def profile_steps(torch, run, batches, **label):
    """``run(batch)`` for each batch under torch.profiler: device time by
    kernel, device events and the device's idle share over the window."""
    wall, rows = device_events(
        torch, lambda: [run(b) for b in batches], cpu=True)
    busy = sum(r[0] for r in rows) / 1e6
    flash = [r for r in rows if "flash_" in r[1]]  # the CUDA C++ attention
    emit("profile", **label, steps=len(batches), wall_s=wall,
         device_busy_s=busy, idle_share=max(0.0, 1.0 - busy / wall),
         device_events=sum(r[2] for r in rows),
         flash_device_ms=sum(r[0] for r in flash) / 1e3,
         flash_events=sum(r[2] for r in flash),
         top=[{"kernel": k[:120], "device_ms": us / 1e3, "count": c}
              for us, k, c in rows[:25]])


def device_ms_by_kernel(torch, fn, reps: int = 20) -> dict:
    """Device time of each CUDA kernel that ``fn`` launches, over ``reps``
    calls in one profiled window (``device_events``, after one warm-up
    call): ``{kernel: {"ms": mean device time of one launch, "events":
    launches recorded}}`` by the kernel's short name; ``events`` is a
    multiple of ``reps`` when the window kept every launch."""
    fn()
    _, rows = device_events(torch, lambda: [fn() for _ in range(reps)])
    out = {}
    for us, key, count in rows:
        m = re.search(r"(\w+_kernel)", key)
        row = out.setdefault(m.group(1) if m else key[:60],
                             {"us": 0.0, "events": 0})
        row["us"] += us
        row["events"] += count
    return {k: {"ms": r["us"] / 1e3 / r["events"], "events": r["events"]}
            for k, r in out.items()}


def row_scales(torch, x, r, chunk_rows: int = 1 << 16):
    """The scales ``quantize_plane`` must give the rows of ``x + r``
    (stacked ``(M, n)``): absmax/127, 1.0 for a zero row, computed with the
    plain version a chunk of whole rows at a time; ``(M, ceil(n/128))``."""
    from repro_torch.kernels.ref import quantize_plane_ref

    n, step, out = x.shape[1], chunk_rows * 128, []
    for lo in range(0, n, step):
        _, s, _ = quantize_plane_ref(x[:, lo:lo + step], r[:, lo:lo + step])
        out.append(s[:, :-(-min(step, n - lo) // 128)])
    return torch.cat(out, 1)


def phase_train_int8(torch, train_res, profile: bool):
    """The int8 wire's main path: the train phase's run with
    ``wire="int8"`` and ``compensate=λ``."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import quantize as qk
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           wire="int8", compensate=LAMBDA, device="cuda")
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches, launch_resets())
    every = step_launches()
    launches = {"quantize_plane": qk.quantize_launches,
                "dequant_mix": qk.dequant_mix_launches,
                "gossip_mix": gm_kernel.launches}
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    n_groups = len(backend.part.group_sizes)
    want = {"quantize_plane": TRAIN_STEPS * n_groups,
            "dequant_mix": TRAIN_STEPS * n_groups, "gossip_mix": 0}
    check(launches == want, f"int8 launches {launches} != {want}")
    per_pass = TRAIN_STEPS * M * cfg.num_layers
    want = {"fwd": per_pass * R, "dq": per_pass, "dkv": per_pass}
    check(flash == want, f"int8 flash launches {flash} != {want}")
    check_history(hist, cfg.vocab_size, "train_int8")
    wire = out["wire_bytes_per_round"]
    f32_plane = backend.part.plane_nbytes()
    check(out["wire_dtype"] == "int8" and wire == INT8_WIRE_BYTES
          == backend.part.plane_nbytes("int8"),
          f"wire {out['wire_dtype']} {wire} B != {INT8_WIRE_BYTES}")
    state = out["state"]
    del out
    digests = plane_digests(torch, state["read"])
    for name in ("write", "resid", "theta"):
        check(all(bool(torch.isfinite(v).all())
                  for v in state[name].values()), f"nonfinite {name}")

    # |r'| <= s/2: one more step (outside the counted window), with the
    # scales its quantization must use computed plainly beforehand from
    # the plane and residual it quantizes
    scales = {g: row_scales(torch, state["write"][g], state["resid"][g])
              for g in state["write"]}
    state, _ = backend.step(state, batches[0])
    worst = 0.0
    for g, r in state["resid"].items():
        n, step = r.shape[1], (1 << 16) * 128
        for lo in range(0, n, step):
            rc = r[:, lo:lo + step].abs()
            sc = scales[g][:, lo // 128:lo // 128 + -(-rc.shape[1] // 128)]
            ratio = (rc / sc.repeat_interleave(128, 1)[:, :rc.shape[1]])
            worst = max(worst, ratio.max().item())
    check(math.isfinite(worst) and worst <= 0.5 + RESID_SLACK,
          f"residual exceeds s/2: max |r'|/s = {worst}")
    if profile:
        def run(b):
            nonlocal state
            state, _ = backend.step(state, b)
        profile_steps(torch, run, batches[:2], wire="int8")
    med = statistics.median(step_s[1:])
    tokens = M * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "M": M, "fb_ratio": R, "update_delay": 1,
           "compensate": LAMBDA, "wire": "int8", "steps": TRAIN_STEPS,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_s": tokens / med,
           "median_step_vs_train": med / train_res["median_step_s"],
           "peak_bytes": peak, "launches": launches, "flash_launches": flash,
           "wire_bytes_per_round": wire, "f32_plane_bytes": f32_plane,
           "wire_vs_f32_plane": wire / f32_plane,
           "resid_max_over_scale": worst, "history": hist,
           "all_launches": every, "read_plane_sha256": digests}
    emit("train_int8", **res)
    del state, params
    torch.cuda.empty_cache()
    return res


def phase_profile(torch, backend, state, batches):
    """Two more steps under torch.profiler for each attention route (the
    kernels, then plain attention with ``USE_PALLAS=False``): device time by
    kernel, device events and the device's idle share over the window. Then
    the two routes' step times, alternated on the same state (plain,
    kernels, kernels, plain, ...; host clock around synchronised steps)."""
    from repro_torch.models import layers

    def run(use, batch):
        nonlocal state
        layers.USE_PALLAS = use
        try:
            state, _ = backend.step(state, batch)
        finally:
            layers.USE_PALLAS = True

    for use in (True, False):
        profile_steps(torch, lambda b, use=use: run(use, b), batches[:2],
                      attention="kernels" if use else "plain")
    step_s = {True: [], False: []}
    for i in range(PROFILE_AB_ROUNDS):
        for use in (False, True, True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(use, batches[i % len(batches)])
            torch.cuda.synchronize()
            step_s[use].append(time.perf_counter() - t0)
    emit("route_step_time", order="plain, kernels, kernels, plain",
         kernels_step_s=step_s[True], plain_step_s=step_s[False],
         kernels_median_s=statistics.median(step_s[True]),
         plain_median_s=statistics.median(step_s[False]),
         kernels_faster_pairs=sum(a < b for a, b in zip(step_s[True],
                                                         step_s[False])))


def phase_route(torch):
    """Kernel route vs plain route on the same tensors, 2 layers: the
    plain route runs attention with ``USE_PALLAS=False`` and the mix with
    ``gossip_mix_ref``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.launch.train import (_decoupled_worker_fn,
                                          backward_update_lane, forward_lane,
                                          gossip_fused_lane,
                                          make_decoupled_state)
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=ROUTE_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=1, device="cuda")
    opt, sched = momentum(0.9), constant(LR)
    batches = lm_batches(torch, cfg.vocab_size, ROUTE_STEPS, seed=1)

    kernel = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                          optimizer=opt, schedule=sched, fb_ratio=R,
                          update_delay=1, use_pallas=True, device="cuda",
                          measure_drift=False)
    part = FlatPartition(params)
    shifts = tuple(s % M for s in (1, 2, 4, 8) if s % M) or (1,)
    plain_step = _decoupled_worker_fn(
        part, forward_lane(model.loss_fn, fb_ratio=R),
        backward_update_lane(opt, sched, update_delay=1, apply=False),
        None, M, 1,
        fused_mix=gossip_fused_lane(part, M, shifts, use_pallas=False))
    shift_rng = np.random.default_rng(0xC0FFEE)  # the backend's draws

    ks = kernel.init(None, params)
    ps = make_decoupled_state(
        tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)), params),
        opt, update_delay=1, part=part)
    before = gm_kernel.launches
    fa.reset_launches()
    losses = []
    for t, b in enumerate(batches):
        ks, km = kernel.step(ks, b)
        layers.USE_PALLAS = False
        try:
            with torch.no_grad():
                ps, pm = plain_step(ps, b, t, int(shift_rng.integers(
                    0, len(shifts))))
        finally:
            layers.USE_PALLAS = True
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
    per_pass = ROUTE_STEPS * M * ROUTE_LAYERS
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = {"fwd": per_pass * R, "dq": per_pass, "dkv": per_pass}
    check(flash == want, f"route flash launches {flash} != {want}")
    emit("route", layers=ROUTE_LAYERS, M=M, steps=ROUTE_STEPS,
         losses=losses, plane_max_rel_diff=plane_rel,
         kernel_route_launches=route_launches,
         kernel_route_flash_launches=flash, rtol=ROUTE_RTOL)
    del ks, ps, params
    torch.cuda.empty_cache()


def phase_route_int8(torch):
    """The int8 step (λ=0.5) through the quantize kernels against the same
    step through their plain versions (``gossip_fused_lane(use_pallas=
    False, wire="int8")``), 2 layers; attention on the flash kernels on
    both routes, so only the quantize kernels differ: bit for bit."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qk
    from repro_torch.launch.train import (_decoupled_worker_fn,
                                          backward_update_lane, forward_lane,
                                          gossip_fused_lane,
                                          make_decoupled_state)
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium").with_(num_layers=ROUTE_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=2, device="cuda")
    opt, sched = momentum(0.9), constant(LR)
    batches = lm_batches(torch, cfg.vocab_size, ROUTE_STEPS, seed=2)
    kernel = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                          optimizer=opt, schedule=sched, fb_ratio=R,
                          update_delay=1, use_pallas=True, device="cuda",
                          measure_drift=False, wire="int8",
                          compensate=LAMBDA)
    part = FlatPartition(params)
    shifts = tuple(s % M for s in (1, 2, 4, 8) if s % M) or (1,)
    plain_step = _decoupled_worker_fn(
        part, forward_lane(model.loss_fn, fb_ratio=R),
        backward_update_lane(opt, sched, update_delay=1, apply=False,
                             compensate=LAMBDA),
        None, M, 1,
        fused_mix=gossip_fused_lane(part, M, shifts, use_pallas=False,
                                    wire="int8"))
    shift_rng = np.random.default_rng(0xC0FFEE)  # the backend's draws
    ks = kernel.init(None, params)
    ps = make_decoupled_state(
        tree_map(lambda p: p[None].expand((M,) + tuple(p.shape)), params),
        opt, update_delay=1, part=part, wire="int8", compensate=LAMBDA)
    qk.reset_launches()
    fa.reset_launches()
    losses = []
    for t, b in enumerate(batches):
        ks, km = kernel.step(ks, b)
        with torch.no_grad():
            ps, pm = plain_step(ps, b, t, int(shift_rng.integers(
                0, len(shifts))))
        kl, pl = float(km["loss"]), float(pm["loss"])
        losses.append((kl, pl))
        check(kl == pl, f"route_int8 loss step {t}: kernel {kl} vs plain "
              f"{pl}")
    for name in ("read", "write", "resid", "theta"):
        for g in ps[name]:
            check(torch.equal(ks[name][g], ps[name][g]),
                  f"route_int8 {name} {g} not bit-identical")
    check(torch.equal(ks["w"], ps["w"]), "route_int8 push-sum weights")
    n_groups = len(part.group_sizes)
    launches = {"quantize_plane": qk.quantize_launches,
                "dequant_mix": qk.dequant_mix_launches}
    check(launches == {"quantize_plane": ROUTE_STEPS * n_groups,
                       "dequant_mix": ROUTE_STEPS * n_groups},
          f"route_int8 launches {launches}")
    per_pass = 2 * ROUTE_STEPS * M * ROUTE_LAYERS  # flash on both routes
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = {"fwd": per_pass * R, "dq": per_pass, "dkv": per_pass}
    check(flash == want, f"route_int8 flash launches {flash} != {want}")
    emit("route_int8", layers=ROUTE_LAYERS, M=M, steps=ROUTE_STEPS,
         compensate=LAMBDA, losses=losses, bit_identical=True,
         kernel_route_launches=launches, flash_launches=flash)
    del ks, ps, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# serving (DESIGN.md §12): the decode path, ServeLoop and live swaps
# ---------------------------------------------------------------------------


def serve_prompts(vocab: int, n: int, lo: int, hi: int, seed: int):
    """``n`` prompts of lengths drawn in [lo, hi], tokens from the same
    generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lens]


def prefill_by_decode(torch, model, params, prompts, max_len: int):
    """The prompts fed one token a step through ``decode_fn`` in one batch
    (as the serve loop feeds them). For each prompt, at its last token: the
    float32 logits and a copy of its row of every cache leaf."""
    from repro_torch.models.transformer import alloc_cache

    B = len(prompts)
    cache = alloc_cache(model.cache_specs(B, max_len), device="cuda")
    out = [None] * B
    for t in range(max(len(p) for p in prompts)):
        toks = torch.tensor([[int(p[min(t, len(p) - 1)])] for p in prompts],
                            device="cuda")
        pos = torch.full((B,), t, dtype=torch.int64, device="cuda")
        logits, cache = model.decode_fn(params, cache, toks, pos)
        for b, p in enumerate(prompts):
            if t == len(p) - 1:
                out[b] = (logits[b, 0].clone(),
                          {f"{s}/{k}": v[:, b].clone()
                           for s, leaves in cache.items()
                           for k, v in leaves.items()})
    return out


def rel_gap(torch, got, want) -> float:
    """max |got − want| / max |want| (float32)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def run_serve_loop(torch, loop, requests):
    """Serve ``requests`` to completion, one host-timed step at a time (the
    step's argmax copy synchronises it). Returns the step seconds and the
    wall seconds."""
    for r in requests:
        loop.submit(r)
    step_s = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if not loop.step_once():
            break
        step_s.append(time.perf_counter() - t0)
    return step_s, time.perf_counter() - t_start


def cache_nbytes(cache) -> int:
    return sum(v.numel() * v.element_size()
               for leaves in cache.values() for v in leaves.values())


def serve_readings(torch, model, params, loop, step_s, wall_s):
    """Decode-step median and p99, tokens/s, the idle share of IDLE_STEPS
    full-batch decode steps, prefill_fn's host ms and device busy ms at
    B=1 S=128, B=1 S=512 and the loop's slots at S=512, the cache bytes and
    stats()."""
    import numpy as np
    from repro_torch.launch.serve import Request

    st = sorted(step_s)
    p99 = st[min(len(st) - 1, int(math.ceil(0.99 * len(st))) - 1)]
    out = {"decode_steps": len(step_s),
           "decode_step_median_ms": 1e3 * statistics.median(step_s),
           "decode_step_p99_ms": 1e3 * p99,
           "decode_step_mean_ms": 1e3 * sum(step_s) / len(step_s),
           "serve_wall_s": wall_s,
           "tokens_per_s": loop.tokens_emitted / wall_s,
           "cache_bytes": cache_nbytes(loop.cache), "stats": loop.stats()}
    # the idle share: IDLE_STEPS steps of a full batch timed on the host,
    # then the device's busy time (kernels merged) of as many more under
    # torch.profiler (whose own host cost would inflate a profiled wall)
    reqs = [Request(uid=1000 + i, prompt=np.asarray([1], np.int32),
                    max_new_tokens=2 * IDLE_STEPS + 2)
            for i in range(loop.num_slots)]
    for r in reqs:
        loop.submit(r)
    loop.step_once()  # admit and warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(IDLE_STEPS):
        loop.step_once()
    wall = time.perf_counter() - t0
    busy, _, kernels = profiled_busy(
        torch, lambda: [loop.step_once() for _ in range(IDLE_STEPS)])
    out.update(idle_steps=IDLE_STEPS, idle_wall_s=wall,
               idle_device_busy_s=busy,
               device_idle_share=1.0 - busy / wall,
               kernels_per_step=kernels / IDLE_STEPS)
    loop.run()
    # prefill: host ms of a synchronised call (median of 5), and the
    # device's busy ms in one call (torch.profiler); the call is
    # host-bound, so events around it would time the host's dispatch
    prefill = {}
    for B, S in ((1, 128), (1, 512), (loop.num_slots, 512)):
        toks = torch.randint(0, model.cfg.vocab_size, (B, S), device="cuda")

        def call():
            model.prefill_fn(params, {"tokens": toks})
            torch.cuda.synchronize()

        call()
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            host.append(time.perf_counter() - t0)
        busy, _, kernels = profiled_busy(torch, call)
        prefill[f"B{B}_S{S}"] = {"host_ms": 1e3 * statistics.median(host),
                                 "device_busy_ms": 1e3 * busy,
                                 "kernels": kernels}
    out["prefill"] = prefill
    return out


def alloc_counts(torch) -> dict:
    """The caching allocator's device allocations, frees and retries so
    far (``torch.cuda.memory_stats``)."""
    st = torch.cuda.memory_stats()
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                      "num_alloc_retries")}


def alloc_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def phase_serve(torch):
    """GPT-2 Medium (f32) through ServeLoop, and prefill_fn (flash #2)
    against prefill-by-decode and against the plain attention route."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import build_model
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    prompts = serve_prompts(cfg.vocab_size, SERVE_REQUESTS, *SERVE_PROMPT,
                            seed=5)
    loop = ServeLoop(model, params, num_slots=SERVE_SLOTS,
                     max_len=SERVE_MAX_LEN)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    fa.reset_launches()
    step_s, wall = run_serve_loop(torch, loop, reqs)
    decode_flash = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    check(decode_flash == (0, 0, 0), f"serve decode flash {decode_flash}")
    check(all(r.done and len(r.output) == SERVE_NEW for r in reqs),
          "serve: a request did not complete with its tokens")
    sequential = sum(len(p) + SERVE_NEW for p in prompts)
    check(loop.steps_run < sequential,
          f"serve steps {loop.steps_run} !< sequential {sequential}")
    res = {"model": cfg.name, "dtype": "float32", "num_slots": SERVE_SLOTS,
           "max_len": SERVE_MAX_LEN, "requests": SERVE_REQUESTS,
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": SERVE_NEW, "sequential_steps": sequential}
    # prefill_fn (the flash forward) against prefill-by-decode
    hold = prompts[:SERVE_HOLD]
    by_decode = prefill_by_decode(torch, model, params, hold, SERVE_MAX_LEN)
    fa.reset_launches()
    gaps = []
    for p, (dec_logits, dec_cache) in zip(hold, by_decode):
        cache, logits = model.prefill_fn(
            params, {"tokens": torch.from_numpy(p[None]).cuda()})
        g = {"len": len(p),
             "logits": rel_gap(torch, dec_logits, logits[0, 0])}
        for key in ("k", "v"):
            g[key] = rel_gap(torch, dec_cache[f"sub0/{key}"][:, :len(p)],
                             cache["sub0"][key][:, 0])
        check(g["logits"] <= SERVE_LOGIT_TOL and g["k"] <= SERVE_KV_TOL
              and g["v"] <= SERVE_KV_TOL, f"serve prefill vs decode {g}")
        gaps.append(g)
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = {"fwd": cfg.num_layers * SERVE_HOLD, "dq": 0, "dkv": 0}
    check(flash == want, f"prefill flash launches {flash} != {want}")
    # the kernel route against the plain route (USE_PALLAS=False)
    route = []
    for p in hold:
        toks = {"tokens": torch.from_numpy(p[None]).cuda()}
        kc, kl = model.prefill_fn(params, toks)
        layers.USE_PALLAS = False
        try:
            pc, pl = model.prefill_fn(params, toks)
        finally:
            layers.USE_PALLAS = True
        r = {"logits": rel_gap(torch, kl, pl),
             **{k: rel_gap(torch, kc["sub0"][k], pc["sub0"][k])
                for k in ("k", "v")}}
        check(max(r.values()) <= ROUTE_RTOL, f"prefill route {r}")
        route.append(r)
    del by_decode
    res.update(prefill_vs_decode=gaps,
               prefill_tol={"logits": SERVE_LOGIT_TOL, "kv": SERVE_KV_TOL},
               prefill_route_vs_plain=route, route_rtol=ROUTE_RTOL,
               serve_launches=flash,
               **serve_readings(torch, model, params, loop, step_s, wall),
               peak_bytes=torch.cuda.max_memory_allocated())
    emit("serve", phase_s=time.perf_counter() - t_phase, **res)
    del loop, params
    torch.cuda.empty_cache()
    return res


def ssm_layer_local_gaps(torch, model, params, prompts):
    """Each layer's chunked form against its recurrence on the same
    inputs: the hidden states entering a layer in each prompt's prefill
    are fed one token a step through ``ssm_sublayer_decode``, the prompts
    as one batch (a prompt's last input repeated once it has ended). Per
    prompt and layer, the gaps of the final state and conv tail (read at
    the prompt's last token) to what its prefill collected."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = model.cfg
    lens = [len(p) for p in prompts]
    steps = torch.arange(max(lens), device="cuda")
    gaps = [[] for _ in prompts]
    with torch.inference_mode():
        hs = [L.embed_apply(params["embed"],
                            torch.from_numpy(p[None]).cuda())
              for p in prompts]
        for _, sub in T.decoder_layers(params):
            padded = torch.stack([h[0, torch.clamp(steps, max=n - 1)]
                                  for h, n in zip(hs, lens)])
            outs, finals = [], []
            for h in hs:
                h, st = T.ssm_sublayer(sub["ssm"], h, cfg, return_state=True)
                outs.append(h)
                finals.append(st)
            c = {"state": torch.zeros((len(prompts),) + finals[0][0].shape[1:],
                                      dtype=finals[0][0].dtype, device="cuda"),
                 "conv_tail": torch.zeros(
                     (len(prompts),) + finals[0][1].shape[1:],
                     dtype=finals[0][1].dtype, device="cuda")}
            for t in range(max(lens)):
                T.ssm_sublayer_decode(sub["ssm"], padded[:, t:t + 1], cfg, c)
                for b, n in enumerate(lens):
                    if t == n - 1:
                        gaps[b].append({
                            "state": rel_gap(torch, c["state"][b],
                                             finals[b][0][0]),
                            "conv_tail": rel_gap(torch, c["conv_tail"][b],
                                                 finals[b][1][0])})
            if "mlp" in sub:
                outs = [T.mlp_residual(sub["mlp"], h, cfg) for h in outs]
            hs = outs
    return gaps


def ssm_prefill_gaps(torch, model, params, prompts, max_len):
    """Prefill-by-decode against ``prefill_fn``, end to end: the last
    logits, and the final state and conv tail at every layer (the largest
    gap over the layers, and each layer's state gap)."""
    out = []
    for p, (dec_logits, dec_cache) in zip(
            prompts, prefill_by_decode(torch, model, params, prompts,
                                       max_len)):
        cache, logits = model.prefill_fn(
            params, {"tokens": torch.from_numpy(p[None]).cuda()})
        ref = {k: cache["sub0"][k][:, 0] for k in ("state", "conv_tail")}
        out.append({
            "len": len(p),
            "logits": rel_gap(torch, dec_logits, logits[0, 0]),
            **{k: rel_gap(torch, dec_cache[f"sub0/{k}"], v)
               for k, v in ref.items()},
            "state_by_layer": [rel_gap(torch, a, b) for a, b in zip(
                dec_cache["sub0/state"], ref["state"])]})
    return out


def phase_serve_ssm(torch):
    """Mamba2-780M (bf16) through ServeLoop, and prefill_fn (chunked SSD,
    final state and conv tail) against prefill-by-decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.core.pytree import tree_map
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    cfg = get_config("mamba2-780m")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    prompts = serve_prompts(cfg.vocab_size, SERVE_REQUESTS,
                            *SSM_SERVE_PROMPT, seed=5)
    loop = ServeLoop(model, params, num_slots=SERVE_SLOTS,
                     max_len=SSM_SERVE_MAX_LEN)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=SSM_SERVE_NEW)
            for i, p in enumerate(prompts)]
    for reset in (fa.reset_launches, rk.reset_launches, sk.reset_launches):
        reset()
    step_s, wall = run_serve_loop(torch, loop, reqs)
    launches = {"flash": fa.fwd_launches + fa.dq_launches + fa.dkv_launches,
                "rmsnorm": rk.launches, "ssd_scan": sk.launches}
    check(launches == {"flash": 0, "rmsnorm": 0, "ssd_scan": 0},
          f"serve_ssm launches {launches}")
    check(all(r.done and len(r.output) == SSM_SERVE_NEW for r in reqs),
          "serve_ssm: a request did not complete")
    hold = prompts[:SERVE_HOLD]
    # bf16: each layer's chunked form against its recurrence on the same
    # inputs, held to SSM_SERVE_TOL; end to end the two forms' bf16
    # roundings compound over the 48 layers (the reference's too), so the
    # end-to-end gaps are readings, and float32 holds the whole path
    local = ssm_layer_local_gaps(torch, model, params, hold)
    worst = max(max(g.values()) for per in local for g in per)
    check(worst <= SSM_SERVE_TOL, f"serve_ssm layer-local gap {worst}")
    e2e = ssm_prefill_gaps(torch, model, params, hold, SSM_SERVE_MAX_LEN)
    check(all(math.isfinite(g["logits"]) for g in e2e), "serve_ssm e2e")
    model32 = build_model(cfg.with_(dtype=torch.float32))
    params32 = tree_map(lambda x: x.float(), params)
    e2e32 = ssm_prefill_gaps(torch, model32, params32, hold,
                             SSM_SERVE_MAX_LEN)
    for g in e2e32:
        check(max(g["logits"], g["state"], g["conv_tail"])
              <= SSM_F32_TOL, f"serve_ssm f32 prefill vs decode {g}")
    del model32, params32
    res = {"model": cfg.name, "dtype": "bfloat16", "num_slots": SERVE_SLOTS,
           "max_len": SSM_SERVE_MAX_LEN, "requests": SERVE_REQUESTS,
           "prompt_lens": [len(p) for p in prompts],
           "max_new_tokens": SSM_SERVE_NEW, "launches": launches,
           "layer_local_max_gap": worst,
           "layer_local_by_layer": [
               max(max(per[l].values()) for per in local)
               for l in range(cfg.num_layers)],
           "prefill_vs_decode_bf16": e2e, "prefill_vs_decode_f32": e2e32,
           "prefill_tol": {"bf16_layer_local": SSM_SERVE_TOL,
                           "f32": SSM_F32_TOL},
           **serve_readings(torch, model, params, loop, step_s, wall),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    emit("serve_ssm", phase_s=time.perf_counter() - t_phase, **res)
    del loop, params
    torch.cuda.empty_cache()
    return res


def served_equals_row(torch, part, params, snap, worker: int = 0) -> bool:
    """The served tree against worker ``worker``'s row of the snapshot,
    unpacked (views, no copy), leaf by leaf, bit for bit."""
    from repro_torch.core.pytree import tree_leaves

    want = part.unpack({g: b[worker] for g, b in snap.plane.items()})
    return all(torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(want)))


def phase_serve_live(torch, name, train, **engine):
    """train's run (same model, weights, batches, options) with
    ``publisher=PlanePublisher()``, each step followed by
    ``LiveServer.run_until_idle()`` over 2 requests on one thread; held
    bit-identical to train."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum
    from repro_torch.serving import LiveServer, PlanePublisher

    t_phase = time.perf_counter()
    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    pub = PlanePublisher()
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", publisher=pub, **engine)
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0)
    publish_s, clone_ev, unpack_ev = [], [], []

    def timed(fn, events, host=None):
        def run(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if host is not None:
                host.append(time.perf_counter() - t0)
            e1.record()
            events.append((e0, e1))
            return out
        return run

    pub.publish = timed(pub.publish, clone_ev, publish_s)
    loop = ServeLoop(model, params, num_slots=2, max_len=LIVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab_size, 2 * TRAIN_STEPS,
                            LIVE_PROMPT, LIVE_PROMPT, seed=6)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    allocs = alloc_counts(torch)
    for reset in launch_resets():                   # main path starts
        reset()
    state = backend.init(None, params)
    srv = LiveServer(loop, backend.part, pub)
    srv._unpack = timed(srv._unpack, unpack_ev)
    hist = {k: [] for k in HISTORY_KEYS}
    step_s, held = [], None
    for t, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = backend.step(state, b)
        settle(torch, backend)
        step_s.append(time.perf_counter() - t0)
        for k in HISTORY_KEYS:
            hist[k].append(float(m[k]))
        snap = pub.latest()
        check(snap is not None and snap.step == t, f"{name}: no snapshot")
        if t == LIVE_HOLD_STEP:
            held = (snap, plane_digests(torch, snap.plane))
        for i in (2 * t, 2 * t + 1):
            loop.submit(Request(uid=i, prompt=prompts[i],
                                max_new_tokens=LIVE_NEW))
        srv.run_until_idle()
        check(loop.params_version == (snap.seq, snap.step),
              f"{name}: serving {loop.params_version}, published "
              f"{(snap.seq, snap.step)}")
        check(served_equals_row(torch, backend.part, loop.params, snap),
              f"{name}: served params != worker 0's row of snapshot "
              f"{snap.seq}")
        if t == LIVE_HOLD_STEP + 2:
            check(plane_digests(torch, held[0].plane) == held[1],
                  f"{name}: snapshot {held[0].seq} changed after two "
                  "more steps")
            held = None
    settle(torch, backend)                          # main path ends
    every = step_launches()
    peak = torch.cuda.max_memory_allocated()
    allocs = alloc_delta(allocs, alloc_counts(torch))
    digests = plane_digests(torch, state["read"])
    check_history(hist, cfg.vocab_size, name)
    res = {"model": cfg.name, "M": M, "fb_ratio": R, "update_delay": 1,
           **engine, "steps": TRAIN_STEPS, "history": hist,
           "all_launches": every, "read_plane_sha256": digests,
           "step_s": step_s, "median_step_s": statistics.median(step_s[1:]),
           "median_step_vs_train": statistics.median(step_s[1:])
           / train["median_step_s"],
           "peak_bytes": peak, "bytes_before_init": base,
           "allocator": allocs, "train_allocator": train["allocator"],
           "publisher": vars(pub.stats).copy(), "live": srv.stats(),
           "snapshot_held_step": LIVE_HOLD_STEP,
           "publish_host_s": publish_s,
           "publish_device_ms": [a.elapsed_time(b) for a, b in clone_ev],
           "unpack_device_ms": [a.elapsed_time(b) for a, b in unpack_ev],
           "plane_bytes": backend.part.plane_nbytes() * M}
    hold_engine(name, res, train, "train", keys=HISTORY_KEYS)
    check(pub.stats.copied_planes == pub.stats.published == TRAIN_STEPS,
          f"{name} publisher {pub.stats}")
    check(srv.swap_count >= 2, f"{name} swaps {srv.swap_count}")
    res["held_against"] = "train"
    emit(name, phase_s=time.perf_counter() - t_phase, **res)
    del state, params, loop, srv, pub, snap
    if backend.engine is not None:
        backend.engine.reset()
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main(argv) -> int:
    # the step's transients are plane-sized (GBs): growable segments keep
    # the caching allocator from stranding them as fragments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # a fixed cuBLAS workspace: the same bits on every CUDA stream
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         cublas_workspace_config=os.environ["CUBLAS_WORKSPACE_CONFIG"])
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernels(torch)
    flash = phase_flash(torch)
    quant = phase_quantize(torch)
    norm_ssd = phase_norm_ssd(torch)
    profile = "--profile" in argv
    train, mono = phase_train(torch, profile=profile)
    train["phase"] = "train"
    _, pipe = phase_train_engine(torch, "train_pipeline", train,
                                 overlap=True)
    train_streams, streams = phase_train_engine(
        torch, "train_streams", train, overlap=True, streams=3)
    train_streams["phase"] = "train_streams"
    if profile:
        phase_profile_engines(
            torch, {"monolithic": mono, "pipeline": pipe, "streams": streams},
            lm_batches(torch, train["vocab"], PROFILE_WINDOW + 2, seed=3))
    streams.engine.close()
    del mono, pipe, streams
    streams_int8, be = phase_train_engine(torch, "train_streams_int8", None,
                                          int8=True, overlap=True, streams=3)
    be.engine.close()
    del be
    int8 = phase_train_int8(torch, train, profile=profile)
    int8["phase"] = "train_int8"
    hold_engine("train_streams_int8", streams_int8, int8, "train_int8")
    emit("train_streams_int8_held", held_against="train_int8",
         keys=list(ENGINE_KEYS), launches=streams_int8["all_launches"],
         read_plane_sha256=streams_int8["read_plane_sha256"])
    # membership on, nothing injected: the same bits as train and
    # train_streams; then the faulted runs
    empty, be = phase_train(torch, profile=False,
                            name="train_membership_empty", faults="")
    hold_engine("train_membership_empty", empty, train, "train")
    emit("train_membership_empty_held", held_against="train",
         median_step_vs_train=empty["median_step_s"]
         / train["median_step_s"],
         peak_above_start_vs_train=(
             (empty["peak_bytes"] - empty["bytes_before_init"])
             / (train["peak_bytes"] - train["bytes_before_init"])))
    del be
    _, be = phase_train_engine(torch, "train_membership_empty_streams",
                               train_streams, overlap=True, streams=3,
                               faults="")
    be.engine.close()
    del be
    phase_train_chaos(torch)
    phase_train_chaos_streams_int8(torch)
    ssm = phase_train_ssm(torch, profile="--profile" in argv)
    serve = phase_serve(torch)
    phase_serve_ssm(torch)
    live = {n: phase_serve_live(torch, n, train, **kw)["all_launches"]
            for n, kw in (("serve_live", {}),
                          ("serve_live_pipeline", {"overlap": True}))}
    phase_route(torch)
    phase_route_int8(torch)
    fused = kern["timing"]["fused"]
    launches = train["flash_launches"]
    rows = [{
        "name": "gossip_mix", "route": "triton",
        "source": "src/repro_torch/kernels/gossip_mix.py",
        "replaces": "src/repro/kernels/gossip_mix.py:49",
        "launches": train["gossip_mix_launches"],
        "max_abs_err": kern["main_max_abs_err"],
        "ms": fused["ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None,
        "live_launches": {n: c["gossip_mix"] for n, c in live.items()}}]
    # the trainable Function launches the forward and both backward kernels
    for name, replaces, keys in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:85",
             ("fwd",)),
            ("flash_attention_bwd", "src/repro/kernels/flash_attention.py:232",
             ("dq", "dkv")),
            ("flash_attention_trainable",
             "src/repro/kernels/flash_attention.py:322",
             ("fwd", "dq", "dkv"))):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": replaces,
                     "launches": sum(launches[k] for k in keys),
                     **flash[name],
                     "live_launches": {
                         n: sum(c[f"flash_{k}"] for k in keys)
                         for n, c in live.items()}})
    # prefill_fn's forward launches on the serve phase (SERVE_HOLD calls)
    rows[1]["serve_launches"] = serve["serve_launches"]["fwd"]
    # the int8 wire's kernels, launched on train_int8 (dequant_mix with the
    # update is the main path's variant)
    for name, replaces, key in (
            ("quantize_plane", "src/repro/kernels/quantize.py:76",
             "quantize"),
            ("dequant_mix", "src/repro/kernels/quantize.py:128", "dequant")):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/csrc/quantize.cu",
                     "replaces": replaces, "launches": int8["launches"][name],
                     "max_abs_err": quant["max_abs_err"],
                     **quant["timing"][key], "library_ms": None})
    # the SSM family's kernels: 0 launches on train_ssm's step (the model
    # runs their plain forms, as the reference's does); the probe's own
    # launches on the step's activations under their own key
    for name, replaces in (
            ("rmsnorm", "src/repro/kernels/rmsnorm.py:27"),
            ("ssd_scan", "src/repro/kernels/ssd_scan.py:68")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{name}.cu",
                     "replaces": replaces,
                     "launches": ssm["step_launches"][name],
                     "probe_launches": ssm["probe"]["launches"][name],
                     **norm_ssd[name]})
    print(json.dumps({"kernels": rows}), flush=True)
    emit("done", wall_s=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
