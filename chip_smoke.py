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
3. flash: the CUDA C++ flash attention kernels (float32: 3xTF32
   ``mma.sync`` products; bfloat16: bf16 ``mma.sync`` m16n8k16 fed by
   ``ldmatrix``, P and dS in two bf16 terms, and a dk/dv grid split over
   parts at few KV heads, added by ``flash_dkv_sum_kernel``; both a
   ``cp.async`` ring, the dq kernel also computing delta), the forward (o,
   lse), the backward (dq, dk, dv; two launches, three with the split)
   and the autograd Function, are held against their plain PyTorch
   versions on the same CUDA tensors, at the training step's attention
   shape (B=2, H=16, S=256, D=64, float32, causal; (B,S,H,D) tensors
   passed as (B,H,S,D) views), over a sweep (GQA, MQA, windows,
   bidirectional, bfloat16, D=128, S not a multiple of the tile), at
   S=2048, 65 and 1, at the hybrid's, VLM's, encoder-decoder's and MoE's
   shapes and at query and key lengths that differ (``FLASH_FAMILIES``:
   Whisper's cross-attention Sq=256 / Sk=1500 and encoder S=1500, not
   causal, bf16; Sq > Sk and Sq < Sk in float32; each also timed: kernel,
   plain and SDPA beside its bound), and on misaligned views (storage
   offset 1, odd sequence stride: the kernels' element-by-element copies);
   two calls on the same inputs must give bit-identical o, lse, dq, dk and
   dv (float32, bfloat16, and every family shape, the split ones
   included). The summing kernel alone at Qwen2-VL's shape, bit for bit
   against ``flash_dkv_sum_ref``, timed beside its bound. Each kernel's
   block and dynamic shared memory and the dk/dv split at each family
   shape (``flash_config``); kernel, plain and
   ``scaled_dot_product_attention`` times (the last as a yardstick only:
   the port never calls it) beside each bound, at the card's f32-accurate
   tensor-core rate for f32 (3xTF32, 165 TFLOP/s). The build phase prints
   each flash kernel's SASS opcode counts (``sass``).
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
   worker and once more per layer and worker for the backward slice's
   recompute (every block runs through ``transformer.remat_block``), and
   each backward kernel once per layer and worker (``flash_want``).
   train_remat: the same entry points priced with and without that
   recompute, ``remat_block`` patched to the identity for the unwrapped
   runs, alternated (remat, unwrapped, unwrapped, remat; the first run is
   train's own, the others 3 steps on its first batches): each run's peak
   over start, the backward slice's peak, median step, one more step's
   device time under torch.profiler with the idle share, and flash
   forward launches; every run's losses and Σw bit-identical to train's,
   and the later runs' read-plane rows to each other.
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
5c. sim: the sim trainer on GPT-2 Medium cut to 12 layers (f32, M=4, the
   train phase's batches, momentum 0.9, lr 3e-3), each of the nine registered
   algorithms for 4 steps (layup, layup-hypercube, gosgd at R=2, D=1; the
   rest at R=1, D=0; localsgd, slowmo and co2 sync every 2 steps): finite
   loss near ln V, Σw with the block queue's mass in flight = 1 ± 1e-5,
   DDP's replicas identical, and the prod step's flash launches a step.
   Median step (steps 1-2), tokens/s, peak, and the idle share from a
   profiled 4th step. event: the event backend in lock-step with each
   run, on a ``HardwareModel`` of the card's measured forward time and
   backward ratio: modeled iteration time, utilization and MFU.
5d. sim_prod: the sim ``layup-hypercube`` against the prod ``layup`` at
   M=1, (R, D) in {(1, 0), (2, 1)}, 4 steps: staleness equal, losses
   within 1e-5.
5e. tune: the autotuner over the pipeline engine (``overlap=True``,
   ``use_pallas=True``, M=4): the default candidate, then R in {1, 2} x D
   in {0, 1}; 3 steps each for the timeline, then every stage cutout timed
   alone (CUDA events; warmup 1, reps 3; fresh inputs each call) with the
   card's floors; the record saved under ``build/tune``, loaded by key,
   and a fresh ``make_backend(..., tuning=path)`` must take its R, D and
   max_inflight_steps, train a step and launch gossip_mix.
5f. checkpoint: the prod state of GPT-2 Medium cut to 12 layers at M=1,
   R=2, D=1 saved and
   restored into a fresh state (read plane SHA-256s, every leaf equal);
   two more steps from each, the restored one after ``resume``,
   identical; save and restore seconds, bytes on disk.
5g. train_moe: the MoE family's main path, train's entry points and
   traffic with Qwen3-30B-A3B at full width (d 2048, 32 heads of 128 on 4
   KV heads, qk_norm, 128 experts top-8 of d_ff 768 at capacity factor
   1.25, vocab 151936 tied, bf16), its depth cut from 48 layers to 1:
   ``gossip_mix`` once per group per step, flash once per layer, forward
   slice and worker (48 forward, 24 dq, 24 dk/dv), the norm and SSD
   kernels never; finite loss near ln V, Σw, a finite bf16 plane. After
   the window, on worker 0's read plane: ``ce`` and ``aux`` of one
   ``loss_fn`` call; its first slice's routing at the MoE, under the
   seed-0 weights and under the read plane (the share of assignments
   dropped, each expert's load, how far the tokens share one direction),
   held to a plain numpy routing on the same logits; and ``gossip_mix`` on
   the read plane's bf16 ``blocks`` group (M·n = 2.49e9 elements, past
   2^31), fused and pure against its plain version (a chunk of columns at
   a time) and in place bit-identical to out of place. train_moe_pipeline:
   the same run through ``overlap=True``, held bit-identical (histories,
   plane digests, launches): the MoE's dispatch and combine use no
   floating-point atomics. serve_moe: the same model (seed-0 weights)
   through ``ServeLoop`` (8 slots, max_len 256, 8 requests of 16–64 prompt
   tokens from ``default_rng(5)``, 16 new tokens): all complete, no flash
   launch in decode; ``prefill_fn`` (one flash forward a layer) against
   prefill-by-decode on 4 prompts at capacity factor E/k = 16, where
   nothing can drop, in float32 (weights upcast) to serve's tolerances,
   the bf16 gaps as readings; serve's readings.
5h. the hybrid, VLM and encoder-decoder families (ROADMAP item 14b-d),
   each at full width through train's entry points and traffic, its bf16
   plane near 7-8 GB: train_hybrid (Jamba v0.1 at full width, depth 32 ->
   2 with attention every 2nd layer: sub0 SSM + dense MLP, sub1 attention
   + MoE of 16 experts top-2; M=1) with ``gossip_mix`` held on its bf16
   ``blocks`` buffer (3.14e9 elements), train_hybrid_pipeline (the same run
   through ``overlap=True``, held bit-identical), train_vlm (Qwen2-VL 2B
   whole, M=2, batches from ``lm_batch_for``: embeddings and (3, B, S)
   M-RoPE positions with an 8 x 8 image span a sequence, split into
   forward slices on their dim 1) and train_encdec (Whisper large-v3
   whole, M=2, 1500 audio frames and 256 tokens a sequence). Each: flash
   launches equal to ``attention_calls`` (96 a forward slice and worker on
   Whisper: encoder, decoder and cross-attention) through ``flash_want``
   (the backward slice's recompute included), ``gossip_mix`` once per
   group per step, the first loss within 0.5 of ``init_loss``, ce and aux
   of one ``loss_fn`` call on worker 0's read plane; after train_encdec,
   train_encdec_remat prices the recompute as train_remat does, with one
   unwrapped run against train_encdec's own. serve_hybrid and
   serve_vlm: ServeLoop (8 slots x 256), ``prefill_fn`` against
   prefill-by-decode in float32 (the VLM's prefill on the tokens'
   embeddings with ``arange`` on the three axes; the hybrid at capacity
   factor E/k). serve_encdec: ``prefill_fn`` (encoder, cross K/V, first
   token) and ``decode_fn`` for 8 sequences of 64 tokens, held in float32
   to ``decode_train``'s teacher-forced logits at every position.
5i. train_model_path (after train_streams): the Model-level factories,
   ``make_step`` on ``WorkerMesh(4, "cuda")`` with GPT-2 Medium (f32,
   seed-0 weights, train's batches as one global batch of 16 x 256), 3
   steps a route, launch counts zeroed before and read after each route:
   the decoupled step (R=2, D=1, ``use_pallas``) and its pipeline engine
   (``overlap=True``), each bit-identical (losses, read plane) to
   ``ProdTrainerBackend`` on the same rows and shift draws, #1 fused 9
   times; lockstep LayUp (``use_pallas``: the pure #1, 9 launches; flash
   96 forward, 96 dq, 96 dk/dv a step) within TOL of the plain mix, and
   ``accum_steps=2`` within 2e-3 (loss) and 5e-2 (parameters) of it; the
   plain decoupled step (update applied, then the float32 plane mix)
   bit-identical to ``ProdTrainerBackend``'s plain route; DDP on the
   global batch, its step-0
   loss within 1e-5 (relative) of the lockstep workers' mean and its
   first loss within 0.5 of ``init_loss``; ``kind="prefill"`` and
   ``"decode"`` at 8 x 512 bit-identical to ``prefill_fn`` and
   ``decode_fn``. Each route's line: step times and median, peak over its
   start, launches, ``model_flops`` and ``analytic_costs`` of the step's
   shape and the FLOPs shares against the card's float32 rate, with the
   ``nvidia-smi`` name and power limit.
5j. train_ring: the multi-process worker ring (``WorkerMesh`` with a
   ``torch.distributed`` group, ROADMAP item 15b). GPT-2 Medium (f32,
   seed-0 weights, the first 3 of train's batches, R=2, D=1, M=4, no
   drift) runs 3 steps as one stacked process, fused on the param wire and
   then on the int8 wire with λ=0.5, each with a per-row bit digest of its
   read plane (an int64 sum of each worker's row viewed as int32) and its
   losses; its state is freed. Then this script starts itself twice on the
   same card (``--ring-rank r``), two ranks of a gloo group (file store
   under ``build/ring``) with L=2 workers each; each runs the same 3 + 3
   steps, monolithic and ``overlap=True``. Every rank's digests (at its
   global rows) and losses must equal the stacked run's bit for bit, and
   #1 (param) and #6, #7 (int8) launch 9 times a rank and route (3 steps x
   3 groups). Printed: step times, the seconds of the pinned-host staging
   (gloo on CUDA tensors), the wire bytes a round, each rank's peak, and
   ``nccl``: run the same way over NCCL on two cards where
   ``torch.cuda.device_count() >= 2``, else "not run (1 device)". A failed
   rank fails the phase. (The param wire's ``overlap=True`` rank run is
   cut: ``overlap=True`` over the ranks runs on the int8 wire.)
   Then the options over the ranks (ROADMAP item 15c), int8 wire with
   λ=0.5, after each a line a rank with its step times, staging seconds,
   wire bytes and peak beside the card's ``nvidia-smi`` name and limit:
   GPT-2 Medium cut to 12 layers: ``streams=3`` (3 steps, one step in
   flight) held to a stacked monolithic int8 run of the cut model
   (digests, histories), #6 and #7 9 times, flash 144 forward and 72 + 72
   backward a rank (half the stacked step's); a faulted run
   (``RING_FAULTS``: peer 3 of rank 1 crashes at step 1 and is re-admitted
   at step 3 from donor 0 of rank 0, a cross-rank re-sync of one row of
   every row entry, its seconds and bytes printed) with a publisher and a
   ``LiveServer`` on each rank serving its first worker, held to a
   stacked run of the same (row digests, histories, the controller's
   counters, each server's decisions and served params). At full depth:
   ``make_prefill_step`` on 8 prompts of 504 tokens and 8
   greedy ``make_decode_step`` steps in a 512-slot cache, the rows split
   over the ranks (4 a rank's cache), held to the one-process steps within
   1e-5 (max |Δ| / max |ref|) and the same tokens; ``tuning=`` a record
   built here, keyed for the world: the schedule each rank resolves is the
   record's; a checkpoint round trip 4 layers deep (2 steps, ``save``
   gathered to rank 0, one step; a fresh state restored on both ranks,
   ``resume(2)``, one step): restored and resumed states equal bit for bit,
   save and restore seconds printed.
6. the kernels line (with ``sim_launches``, ``tune_launches``,
   ``moe_launches``, the families' ``hybrid_launches``,
   ``vlm_launches``, ``encdec_launches``, ``model_path_launches`` by
   route, ``ring_launches`` by rank and route, #1's ``hybrid_blocks`` and
   #2-#4's ``family_shapes`` times), the
   card's ``nvidia-smi`` line, and last the result.

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
sys.path.insert(0, str(HERE / "src"))
try:  # the card's data-sheet rates, one source with the port's cost model
    from repro_torch.launch.analysis import (BF16_FLOPS_PER_S,
                                             F32_FLOPS_PER_S,
                                             HBM_BYTES_PER_S)
except ImportError:  # not beside the port: main() says so and exits 3
    BF16_FLOPS_PER_S = F32_FLOPS_PER_S = HBM_BYTES_PER_S = None

# f32-accurate matrix products on the tensor cores: TF32 (495 TFLOP/s
# dense) over the three products of 3xTF32, as the flash kernels and
# PyTorch's f32 attention take them
TF32X3_FLOPS_PER_S = 495e12 / 3
# a product of an f32 operand with one exact in TF32 (a bf16 value): the
# two products of 2xTF32
TF32X2_FLOPS_PER_S = 495e12 / 2
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
# The hybrid, VLM, encoder-decoder and MoE steps' shapes (per worker and
# forward slice B = BATCH_PER_WORKER / R), and query and key lengths that
# differ: S is then (Sq, Sk). Each is also timed (kernel, plain, SDPA)
# beside its bound.
FLASH_FAMILIES = [
    (2, 20, 20, (256, 1500), 64, False, 0, "bfloat16"),  # whisper cross
    (2, 20, 20, 1500, 64, False, 0, "bfloat16"),  # whisper encoder
    (2, 20, 20, 256, 64, True, 0, "bfloat16"),    # whisper decoder
    (2, 32, 8, 256, 128, True, 0, "bfloat16"),    # jamba
    (2, 12, 2, 256, 128, True, 0, "bfloat16"),    # qwen2-vl
    (2, 32, 4, 256, 128, True, 0, "bfloat16"),    # the MoE step's (qwen3)
    (1, 4, 2, (333, 129), 64, True, 0, "float32"),   # Sq > Sk
    (1, 4, 2, (97, 301), 64, False, 0, "float32"),   # Sq < Sk
]
FLASH_EXTRA = [
    (1, 4, 2, 2048, 64, True, 0, "float32"),
    (2, 4, 2, 1, 64, True, 0, "float32"),
    (1, 4, 2, 65, 64, True, 0, "float32"),
] + FLASH_FAMILIES
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
    # what the flash kernels compiled to: HMMA forms, shared loads
    # (LDS scalar, LDSM ldmatrix), conversions, per kernel (static counts)
    emit("sass", source="src/repro_torch/csrc/flash_attention.cu",
         kernels={kernel_name(k): v for k, v in _build.sass_counts(
             built["flash_attention"][0], "flash").items()})


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
            h, _ = T.decoder_layer(sub, h, cfg, positions=positions,
                                   use_moe=cfg.is_moe_layer(layer))
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
    check_history(hist, cfg, "train_ssm")
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


def seq_lens(S) -> tuple:
    """(Sq, Sk) of a flash case's S: one length, or the pair."""
    return tuple(S) if isinstance(S, (tuple, list)) else (S, S)


def attention_bound_ms(B, Hq, Hkv, S, D, causal, window, itemsize, kind):
    """Least time for flash attention's work on these inputs (S one length
    or (Sq, Sk)), the larger of
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
    Sq, Sk = seq_lens(S)
    pairs = B * Hq * attention_pairs(Sq, Sk, causal, window)
    nq, nkv = B * Hq * Sq * D * itemsize, B * Hkv * Sk * D * itemsize
    nlse, delta = B * Hq * Sq * 4, 2 * B * Hq * Sq * D
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
        decoder passes them (q and do of Sq rows, k and v of Sk)."""
        dt = getattr(torch, dtype)
        Sq, Sk = seq_lens(S)
        return [torch.randn((B, L, H, D), generator=gen, device=dev).to(dt)
                .transpose(1, 2) for H, L in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk),
                                              (Hq, Sq))]

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
        return {"shape": [B, Hq, Hkv, list(seq_lens(S)), D],
                "causal": causal,
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

    emit("flash_config", kernels={
        f"{str(dt).split('.')[-1]}, D={D}": fa.launch_config(dt, D)
        for dt in (torch.float32, torch.bfloat16) for D in (64, 128)},
        dkv_split=[{"shape": c[:5], "dtype": c[7], "nsplit": fa.dkv_split(
            *c[:3], *seq_lens(c[3]), getattr(torch, c[7]),
            fa.sm_count(dev))} for c in FLASH_FAMILIES],
        sm_count=fa.sm_count(dev))
    cases = [check_case(*c) for c in [FLASH_MAIN] + FLASH_SWEEP
             + FLASH_EXTRA]
    cases.append(check_case(*FLASH_MISALIGNED, make=misaligned))
    same = {dt: deterministic(*FLASH_MAIN[:7], dt)
            for dt in ("float32", "bfloat16")}
    same["families"] = [deterministic(*c) for c in FLASH_FAMILIES]
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
    del q, k, v, do, o, lse, args, sdpa_out
    families = [flash_times(torch, c, operands) for c in FLASH_FAMILIES]
    rows["flash_dkv_sum"] = dkv_sum_row(torch, gen)
    emit("flash", main_shape=list(FLASH_MAIN), cases=cases,
         bit_identical_reruns=same, rows=rows, families=families)
    torch.cuda.empty_cache()
    return rows, families


DKV_SUM_SHAPE = (2, 12, 2, 256, 128)  # B, Hq, Hkv, S, D: Qwen2-VL's step


def dkv_sum_row(torch, gen) -> dict:
    """The bf16 backward's summing kernel (``flash_dkv_sum_kernel``) alone
    at Qwen2-VL's step shape, on seeded partial sums in its ``dkv_split``
    parts: held bit for bit to ``flash_dkv_sum_ref`` (the same f32 adds in
    the same order, then one rounding), kernel and plain times, and its
    bound: the parts read once and dk, dv written once over HBM, or an add
    a part and element and the scale over the f32 rate."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_dkv_sum_ref

    B, Hq, Hkv, S, D = DKV_SUM_SHAPE
    n = fa.dkv_split(B, Hq, Hkv, S, S, torch.bfloat16, fa.sm_count("cuda"))
    check(n > 1, f"no dk/dv split at Qwen2-VL's shape ({n})")
    part = torch.randn((2, n, B, Hkv, S, D), generator=gen, device="cuda")
    dk, dv = (torch.empty((B, Hkv, S, D), dtype=torch.bfloat16,
                          device="cuda") for _ in range(2))
    fa.dkv_sum(part, dk, dv)
    want = flash_dkv_sum_ref(part, D ** -0.5)
    torch.cuda.synchronize()
    check(torch.equal(dk, want[0]) and torch.equal(dv, want[1]),
          "flash_dkv_sum differs from flash_dkv_sum_ref")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip((dk, dv), want))
    nbytes = part.numel() * 4 + 2 * dk.numel() * 2
    flops = part.numel() + dk.numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return {"shape": [B, Hq, Hkv, S, D], "nsplit": n, "max_abs_err": err,
            "ms": time_ms(torch, lambda: fa.dkv_sum(part, dk, dv)),
            "plain_ms": time_ms(torch, lambda: flash_dkv_sum_ref(
                part, D ** -0.5)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def flash_times(torch, case, operands) -> dict:
    """A FLASH_FAMILIES case timed: the forward, the backward (two
    launches) and the trainable Function (forward + backward), each
    against its plain version, scaled_dot_product_attention (top-left
    causal mask, the kernels' for Sq != Sk; under GQA on k and v repeated
    to the q heads beforehand, outside the timing) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)

    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v, do = operands(B, Hq, Hkv, S, D, dtype)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention(q, k, v, **kw)
    args = [t.detach().requires_grad_(True) for t in (q, k, v)]
    G = Hq // Hkv
    lib_args = [args[0]] + [t.detach().repeat_interleave(G, 1)
                            .requires_grad_(True) for t in args[1:]]

    def trainable():
        out = ops.flash_attention_trainable(*args, **kw)
        return torch.autograd.grad(out, args, do)

    def trainable_plain():
        o_r, lse_r = flash_attention_ref(q, k, v, **kw)
        return flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, **kw)

    lib_in = [t.detach() for t in lib_args]

    def sdpa(operands=lib_in):
        return F.scaled_dot_product_attention(*operands, is_causal=causal)

    def sdpa_trainable():
        return torch.autograd.grad(sdpa(lib_args), lib_args, do)

    sdpa_out = sdpa(lib_args)
    itemsize = 4 if dtype == "float32" else 2
    res = {"shape": [B, Hq, Hkv, list(seq_lens(S)), D], "causal": causal,
           "dtype": dtype}
    for kind, fn, plain, lib in (
            ("fwd", lambda: fa.flash_attention(q, k, v, **kw),
             lambda: flash_attention_ref(q, k, v, **kw), sdpa),
            ("bwd", lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   **kw),
             lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
             lambda: torch.autograd.grad(sdpa_out, lib_args, do,
                                         retain_graph=True)),
            ("trainable", trainable, trainable_plain, sdpa_trainable)):
        bound, by = attention_bound_ms(B, Hq, Hkv, S, D, causal, window,
                                       itemsize, kind)
        res[kind] = {"ms": time_ms(torch, fn),
                     "plain_ms": time_ms(torch, plain),
                     "library_ms": time_ms(torch, lib),
                     "bound_ms": bound, "bound_by": by}
    del q, k, v, do, o, lse, args, lib_args, lib_in, sdpa_out
    return res


def lm_batches(torch, vocab, steps, seed, *, workers=M):
    """Seeded random tokens, labels = next token, ``workers`` rows on the
    leading axis; on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (workers, BATCH_PER_WORKER, SEQ + 1))
        out.append({"tokens": torch.from_numpy(toks[..., :-1]).cuda(),
                    "labels": torch.from_numpy(toks[..., 1:]).cuda()})
    return out


def family_batches(torch, cfg, steps, seed, *, workers):
    """Per-step batches of ``cfg``'s family from the port's
    ``lm_batch_for`` (each worker's drawn in turn from one generator on
    the card), stacked on a leading worker axis. A VLM sequence gets one
    VLM_IMAGE_GRID² image span at a seeded start (its t ids hold still, h
    and w walk the grid: ``synth_mrope_positions``), so positions are
    (workers, 3, B, S)."""
    from repro_torch.data.synthetic import lm_batch_for
    from repro_torch.models.frontends import synth_mrope_positions

    gen = torch.Generator(device="cuda").manual_seed(seed)
    span = VLM_IMAGE_GRID ** 2
    out = []
    for _ in range(steps):
        rows = []
        for _ in range(workers):
            b = lm_batch_for(cfg, BATCH_PER_WORKER, SEQ, generator=gen,
                             device="cuda")
            if "positions" in b:
                starts = torch.randint(0, SEQ - span + 1, (BATCH_PER_WORKER,),
                                       generator=gen, device="cuda").tolist()
                b["positions"] = torch.cat([synth_mrope_positions(
                    1, SEQ, image_span=(s, s + span, VLM_IMAGE_GRID),
                    device="cuda") for s in starts], dim=1)
            rows.append(b)
        out.append({k: torch.stack([r[k] for r in rows]) for k in rows[0]})
    return out


def attention_calls(cfg) -> int:
    """``layers.attention`` calls in one forward of ``cfg``'s model (each a
    flash forward on the card; in the backward slice the recompute of its
    block, ``remat_block``, runs the forward again before a dq and a dk/dv
    launch: ``flash_want``): one an attention layer (none in an SSM
    decoder, one a super-block's attention sub-layer in the hybrid); the
    encoder-decoder's encoder layers, decoder layers and their
    cross-attention."""
    if cfg.enc_dec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(cfg.is_attn_layer(l) for l in range(cfg.num_layers))


def flash_want(calls: int, passes: int = R, backward: int = 1,
               remat: bool = True) -> dict:
    """The flash launches of ``passes`` forward passes of ``calls``
    attention calls each (summed over steps and workers), ``backward`` of
    them with a backward: such a pass rematerializes its blocks
    (``transformer.remat_block``), so it runs each forward (#2) once more
    before its dq and dk/dv (#3); ``remat=False``: the blocks patched to
    the identity, no recompute."""
    return {"fwd": calls * (passes + (backward if remat else 0)),
            "dq": calls * backward, "dkv": calls * backward}


def init_loss(cfg) -> float:
    """The expected loss of a seed-0 init: logits of variance σ² =
    0.02²·d_model (an N(0, 0.02²) unembedding, tied or not, against
    hidden states of unit RMS after the final norm) make
    E[logsumexp] − E[gold] ≈ ln V + σ²/2."""
    return math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2


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
    """The launch counters of every kernel of the port."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    return (gm_kernel.reset_launches, fa.reset_launches, qk.reset_launches,
            rk.reset_launches, sk.reset_launches)


def step_launches() -> dict:
    """Every kernel's launches since the counters' reset (the norm and SSD
    kernels' are 0 on a training step: the models run their plain
    forms)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    return {"gossip_mix": gm_kernel.launches,
            "flash_fwd": fa.fwd_launches, "flash_dq": fa.dq_launches,
            "flash_dkv": fa.dkv_launches,
            "flash_dkv_sum": fa.dkv_sum_launches,
            "quantize_plane": qk.quantize_launches,
            "dequant_mix": qk.dequant_mix_launches,
            "rmsnorm": rk.launches, "ssd_scan": sk.launches}


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


def phase_train_engine(torch, name, ref, *, int8: bool = False, cfg=None,
                       workers=M, batches=None, **engine):
    """The train phase's run (train_int8's with ``int8``; of ``cfg`` in
    place of GPT-2 Medium, on ``workers`` workers and ``batches`` in place
    of ``lm_batches``', where given) through an engine (``engine``:
    ``overlap=True[, streams=n]``), timed as one window (``window_drive``)
    and held against ``ref``, the monolithic run, when given. Returns
    (result, backend); the backend's state is dropped and its engine
    reset, so it holds no plane."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = cfg or get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    wire = dict(wire="int8", compensate=LAMBDA) if int8 else {}
    backend = make_backend("prod", "layup", M=workers, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", wait_timeout_s=ENGINE_TIMEOUT_S,
                           **wire, **engine)
    batches = batches or lm_batches(torch, cfg.vocab_size, TRAIN_STEPS,
                                    seed=0)
    membership = "faults" in engine
    state, hist, window, peak, base = window_drive(
        torch, backend, params, batches, launch_resets(),
        keys=MEMBERSHIP_KEYS if membership else HISTORY_KEYS)
    every = step_launches()
    check_history(hist, cfg, name)
    if membership:
        check(hist["peers_live"] == [float(workers)] * TRAIN_STEPS,
              f"{name} peers_live {hist['peers_live']}")
    summary = backend.summary()
    timeline = backend.timeline.summary()
    read = state["read"]
    if backend.streams > 1:
        read = backend.engine.materialize(read)
    digests = plane_digests(torch, read)
    steps = len(batches) - 1
    tokens = workers * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "M": workers, "fb_ratio": R, "update_delay": 1,
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
    # the raw events (ns), not ``prof.events()``: building its Python event
    # objects costs seconds a training step (~20k kernels)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    union, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return union / 1e9, sum(b - a for a, b in spans) / 1e9, len(spans)


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


def check_history(hist, cfg, what: str) -> None:
    """Finite losses, the first within 0.5 of ``init_loss`` (ln V and the
    init's logit variance), Σw = 1 ± 1e-5, no skips."""
    check(all(math.isfinite(v) for v in hist["loss"]), f"{what} loss {hist}")
    check(all(abs(v - 1.0) <= 1e-5 for v in hist["weight_sum"]),
          f"{what} weight_sum {hist['weight_sum']}")
    check(abs(hist["loss"][0] - init_loss(cfg)) < 0.5,
          f"{what} first loss {hist['loss'][0]} far from {init_loss(cfg)} "
          "at random init")
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
    check(flash == flash_want(per_pass), f"train_chaos flash launches {flash}")
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


def phase_train(torch, profile, name: str = "train", cfg=None,
                readings=None, workers=M, batches=None, **faults):
    """The train phase; with ``faults=""`` the same run with membership on
    (``name`` train_membership_empty), which the caller holds against
    train. ``cfg`` runs another model than GPT-2 Medium through the same
    entry points and traffic (on ``workers`` workers, and ``batches`` in
    place of ``lm_batches``' tokens, where given), and ``readings(model,
    backend, state, batches)``, when given, adds its dict of readings
    (taken after the counted window) to the result. The flash launches
    are held to ``attention_calls(cfg)`` a forward. ``profile``: True, or
    "kernels" for the kernels' route alone (``phase_profile``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gossip_mix as gm_kernel
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    cfg = cfg or get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    backend = make_backend("prod", "layup", M=workers, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           device="cuda", **faults)
    batches = batches or lm_batches(torch, cfg.vocab_size, TRAIN_STEPS,
                                    seed=0)
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
    want = flash_want(TRAIN_STEPS * workers * attention_calls(cfg))
    check(flash == want, f"flash launches {flash} != {want}")
    check(every["rmsnorm"] == every["ssd_scan"] == 0,
          f"{name}: norm or SSD kernel launched on the step {every}")
    check_history(hist, cfg, name)
    if faults:
        check(hist["peers_live"] == [float(workers)] * TRAIN_STEPS,
              f"{name} peers_live {hist['peers_live']}")
    read = out["state"]["read"]
    check(all(v.dtype == cfg.dtype and bool(torch.isfinite(v).all())
              for v in read.values()), f"{name}: nonfinite plane")
    digests = plane_digests(torch, read)
    med = statistics.median(step_s[1:])
    tokens = workers * BATCH_PER_WORKER * SEQ
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "params": sum(backend.part.group_sizes.values()), "M": workers,
           "fb_ratio": R, "update_delay": 1, "seq": SEQ,
           "batch_per_worker": BATCH_PER_WORKER, "steps": TRAIN_STEPS,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_step": tokens, "tokens_per_s": tokens / med,
           "peak_bytes": peak, "bytes_before_init": out["bytes_before_init"],
           "allocator": out["allocator"],
           "gossip_mix_launches": launches, "flash_launches": flash,
           "flash_launches_predicted": want, "all_launches": every,
           "read_plane_sha256": digests,
           "groups": dict(backend.part.group_sizes), **faults}
    if faults:
        res["chaos"] = chaos_counters(out)
    if readings is not None:
        res.update(readings(model, backend, out["state"], batches))
    emit(name, **res)
    if profile:
        phase_profile(torch, backend, out["state"], batches,
                      plain=profile != "kernels")
    del out, read, params
    torch.cuda.empty_cache()
    return res, backend


REMAT_STEPS = 3  # steps a run of the remat alternation
# the runs after the phase's own (remat) run: A, B, B, A with the first A
# the train phase's
REMAT_ORDER = ("unwrapped", "unwrapped", "remat")
REMAT_KEYS = ("loss", "weight_sum")


def backward_slice_peak(torch, model, backend, state, batch) -> int:
    """The device bytes one backward slice takes above what is allocated
    before it: worker 0's forward slice 0 with its backward
    (``forward_slice_lane``) on its read plane and first batch, the
    gradients kept until the peak is read."""
    from repro_torch.launch.train import forward_slice_lane

    params = backend.part.unpack({k: v[0] for k, v in state["read"].items()})
    lane = forward_slice_lane(model.loss_fn, fb_ratio=R)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = lane(params, {k: v[0] for k, v in batch.items()})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, params
    return peak


def remat_readings(model, backend, state, batches) -> dict:
    """After a counted window: the backward slice's own peak
    (``backward_slice_peak``), then one more step on the first batch under
    torch.profiler (``profiled_busy``): its device time, the kernels of
    all streams merged, and its kernel count."""
    import torch

    slice_peak = backward_slice_peak(torch, model, backend, state,
                                     batches[0])

    def step():
        backend.step(state, batches[0])
        settle(torch, backend)

    busy, _, kernels = profiled_busy(torch, step)
    return {"slice_peak_above_start": slice_peak, "device_s_per_step": busy,
            "kernels_per_step": kernels}


def remat_row(label, res, median_step_s) -> dict:
    """One run of the remat alternation as ``phase_remat``'s line keeps
    it; idle share = 1 − device time of the profiled step / the counted
    window's median step."""
    return {"label": label, "median_step_s": median_step_s,
            "peak_above_start": res["peak_bytes"] - res["bytes_before_init"],
            "slice_peak_above_start": res["slice_peak_above_start"],
            "device_s_per_step": res["device_s_per_step"],
            "idle_share": 1.0 - res["device_s_per_step"] / median_step_s,
            "kernels_per_step": res["kernels_per_step"],
            "flash_fwd_launches": res["flash_launches"]["fwd"]}


def phase_remat(torch, name, cfg, workers, batches, first,
                order=REMAT_ORDER):
    """Per-block activation checkpointing priced both ways on train's
    entry points. ``first`` is the phase's own run of ``cfg`` on
    ``workers`` workers (remat, read by ``remat_readings``); then runs of
    ``REMAT_STEPS`` steps of ``batches`` (``first``'s first batches) in
    ``order``, "unwrapped" with ``transformer.remat_block`` patched to the
    identity for the run. Each run: the peak over ``bytes_before_init``,
    the backward slice's own peak, the median step (steps 1..), the
    profiled step's device time and the idle share, and the flash
    launches, held to ``flash_want`` with and without the recompute;
    every run's losses and Σw must be ``first``'s bit for bit, and its
    read-plane row digests the first later run's. One line, ``name``."""
    import contextlib
    from unittest import mock

    from repro_torch.core.backend import make_backend
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.optim import constant, momentum

    batches = batches[:REMAT_STEPS]
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    calls = REMAT_STEPS * workers * attention_calls(cfg)
    want_hist = {k: first["history"][k][:REMAT_STEPS] for k in REMAT_KEYS}
    runs = [remat_row("remat", first, first["median_step_s"])]
    digests = None
    for label in order:
        with (mock.patch.object(T, "remat_block", lambda f: f)
              if label == "unwrapped" else contextlib.nullcontext()):
            backend = make_backend(
                "prod", "layup", M=workers, loss_fn=model.loss_fn,
                optimizer=momentum(0.9), schedule=constant(LR), fb_ratio=R,
                update_delay=1, use_pallas=True, device="cuda",
                measure_drift=False)
            out, hist, step_s, peak = counted_drive(
                torch, backend, params, batches, launch_resets(),
                keys=REMAT_KEYS)
            flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                     "dkv": fa.dkv_launches}
            res = {"peak_bytes": peak,
                   "bytes_before_init": out["bytes_before_init"],
                   "flash_launches": flash,
                   **remat_readings(model, backend, out["state"], batches)}
        want = flash_want(calls, remat=label == "remat")
        check(flash == want, f"{name} {label}: flash launches {flash} != "
              f"{want}")
        rows = row_digests(torch, out["state"]["read"])
        check(hist == want_hist and rows == (digests or rows),
              f"{name}: {label} run differs from the phase's own run")
        digests = rows
        runs.append(remat_row(label, res, statistics.median(step_s[1:])))
        del out, backend
        gc.collect()
        torch.cuda.empty_cache()
    del params
    summary = {lab: {k: [r[k] for r in runs if r["label"] == lab] for k in (
        "peak_above_start", "slice_peak_above_start", "median_step_s",
        "device_s_per_step", "idle_share", "flash_fwd_launches")}
        for lab in ("remat", "unwrapped")}
    emit(name, model=cfg.name, M=workers, fb_ratio=R, steps=REMAT_STEPS,
         first_steps=len(first["step_s"]), order=["remat"] + list(order),
         bit_identical=True, summary=summary, runs=runs)
    return summary


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
    want = flash_want(TRAIN_STEPS * M * cfg.num_layers)
    check(flash == want, f"int8 flash launches {flash} != {want}")
    check_history(hist, cfg, "train_int8")
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


def phase_profile(torch, backend, state, batches, plain: bool = True):
    """Two more steps under torch.profiler for each attention route (the
    kernels, then plain attention with ``USE_PALLAS=False``): device time by
    kernel, device events and the device's idle share over the window. Then
    the two routes' step times, alternated on the same state (plain,
    kernels, kernels, plain, ...; host clock around synchronised steps).
    ``plain=False`` profiles the kernels' route alone (the plain route
    keeps every layer's (Sq, Sk) float32 scores for its backward: ~1 GB a
    layer on Whisper's 1500-frame encoder, past the card beside the
    step)."""
    from repro_torch.models import layers

    def run(use, batch):
        nonlocal state
        layers.USE_PALLAS = use
        try:
            state, _ = backend.step(state, batch)
        finally:
            layers.USE_PALLAS = True

    for use in (True, False) if plain else (True,):
        profile_steps(torch, lambda b, use=use: run(use, b), batches[:2],
                      attention="kernels" if use else "plain")
    if not plain:
        return
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
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = flash_want(ROUTE_STEPS * M * ROUTE_LAYERS)
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
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = flash_want(2 * ROUTE_STEPS * M * ROUTE_LAYERS)  # on both routes
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


def prefill_inputs(torch, model, params, toks):
    """``prefill_fn``'s batch for tokens ``toks`` (B, S): the tokens, or
    for a vision frontend their embeddings with ``arange`` on the three
    M-RoPE axes (the ids ``decode_fn`` gives a text token)."""
    if model.cfg.frontend != "vision":
        return {"tokens": toks}
    from repro_torch.models import layers as L

    B, S = toks.shape
    return {"embeds": L.embed_apply(params["embed"], toks),
            "positions": torch.arange(S, dtype=torch.int32,
                                      device=toks.device).expand(3, B, S)}


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
        batch = prefill_inputs(torch, model, params, torch.randint(
            0, model.cfg.vocab_size, (B, S), device="cuda"))

        def call():
            model.prefill_fn(params, batch)
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


def serve_run(torch, cfg, name, slots, max_len, n_requests, prompt, new):
    """``cfg``'s model (seed-0 weights) through ServeLoop: ``n_requests``
    prompts of ``prompt`` = (lo, hi) tokens from default_rng(5), ``new``
    tokens each, over ``slots`` slots of ``max_len``. Checks that decode
    launches no flash kernel, that every request completes with its tokens
    and that the batched loop takes fewer steps than the requests one by
    one. Returns (model, params, loop, prompts, step seconds, wall seconds,
    result)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Request, ServeLoop
    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    prompts = serve_prompts(cfg.vocab_size, n_requests, *prompt, seed=5)
    loop = ServeLoop(model, params, num_slots=slots, max_len=max_len)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    fa.reset_launches()
    step_s, wall = run_serve_loop(torch, loop, reqs)
    decode_flash = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    check(decode_flash == (0, 0, 0), f"{name} decode flash {decode_flash}")
    check(all(r.done and len(r.output) == new for r in reqs),
          f"{name}: a request did not complete with its tokens")
    sequential = sum(len(p) + new for p in prompts)
    check(loop.steps_run < sequential,
          f"{name} steps {loop.steps_run} !< sequential {sequential}")
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "dtype": str(cfg.dtype).replace("torch.", ""),
           "num_slots": slots, "max_len": max_len, "requests": n_requests,
           "prompt_lens": [len(p) for p in prompts], "max_new_tokens": new,
           "sequential_steps": sequential}
    return model, params, loop, prompts, step_s, wall, res


def prefill_hold(torch, model, params, prompts, max_len, name,
                 hold: bool = True):
    """prefill_fn (flash #2) against prefill-by-decode on ``prompts``: the
    gaps of the last position's logits and of the first attention
    sub-layer's K and V, held to SERVE_LOGIT_TOL and SERVE_KV_TOL when
    ``hold``; and prefill_fn's launches, one flash forward an attention
    layer a call. Returns (gaps, launches)."""
    from repro_torch.kernels import flash_attention as fa

    by_decode = prefill_by_decode(torch, model, params, prompts, max_len)
    fa.reset_launches()
    gaps = []
    for p, (dec_logits, dec_cache) in zip(prompts, by_decode):
        cache, logits = model.prefill_fn(params, prefill_inputs(
            torch, model, params, torch.from_numpy(p[None]).cuda()))
        attn = next(sub for sub in cache if "k" in cache[sub])
        g = {"len": len(p),
             "logits": rel_gap(torch, dec_logits, logits[0, 0])}
        for key in ("k", "v"):
            g[key] = rel_gap(torch, dec_cache[f"{attn}/{key}"][:, :len(p)],
                             cache[attn][key][:, 0])
        check(not hold or (g["logits"] <= SERVE_LOGIT_TOL
                           and g["k"] <= SERVE_KV_TOL
                           and g["v"] <= SERVE_KV_TOL),
              f"{name} prefill vs decode {g}")
        gaps.append(g)
    flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
             "dkv": fa.dkv_launches}
    want = flash_want(attention_calls(model.cfg) * len(prompts), 1, 0)
    check(flash == want, f"{name} prefill flash launches {flash} != {want}")
    return gaps, flash


def phase_serve(torch):
    """GPT-2 Medium (f32) through ServeLoop, and prefill_fn (flash #2)
    against prefill-by-decode and against the plain attention route."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    model, params, loop, prompts, step_s, wall, res = serve_run(
        torch, get_config("gpt2-medium"), "serve", SERVE_SLOTS,
        SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW)
    hold = prompts[:SERVE_HOLD]
    gaps, flash = prefill_hold(torch, model, params, hold, SERVE_MAX_LEN,
                               "serve")
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
                outs = [T.mlp_sublayer(sub["mlp"], h, cfg,
                                       use_moe=False)[0] for h in outs]
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
    check_history(hist, cfg, name)
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


# ---------------------------------------------------------------------------
# the sim trainer, the event simulator, the tuner and checkpoints
# ---------------------------------------------------------------------------

# (algorithm, R, D, algorithm kwargs): the nine registered algorithms of
# the sim phase; the periodic ones sync every 2 steps, so twice in 4 steps
SIM_RUNS = (("layup", 2, 1, {}), ("layup-hypercube", 2, 1, {}),
            ("gosgd", 2, 1, {}), ("layup-block", 1, 0, {}),
            ("adpsgd", 1, 0, {}), ("ddp", 1, 0, {}),
            ("localsgd", 1, 0, {"sync_every": 2}),
            ("slowmo", 1, 0, {"sync_every": 2}),
            ("co2", 1, 0, {"sync_every": 2}))
SIM_STEPS = 4  # steps 1-2 timed, step 3 profiled for the idle share
# the sim and checkpoint phases' depth, cut from 24 layers at full width
# to keep the script within its time with train_ring's option runs
SIM_LAYERS = CKPT_LAYERS = 12
SIM_PROD_POINTS, SIM_PROD_STEPS = ((1, 0), (2, 1)), 4
TUNE_STEPS, TUNE_WARMUP, TUNE_REPS = 3, 1, 3
CKPT_STEPS = 2  # steps before the save, and again after it


def reset_kernel_launches() -> None:
    for reset in launch_resets():
        reset()


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def row_launches(counts: dict, name: str) -> int:
    """A kernels-line row's launches out of ``step_launches()``."""
    keys = {"gossip_mix": ("gossip_mix",), "flash_attention": ("flash_fwd",),
            "flash_attention_bwd": ("flash_dq", "flash_dkv"),
            "flash_attention_trainable": ("flash_fwd", "flash_dq",
                                          "flash_dkv")}.get(name, (name,))
    return sum(counts.get(k, 0) for k in keys)


def gpt2_medium(torch, layers=None):
    """GPT-2 Medium (its depth cut to ``layers`` where given), its seed-0
    parameters on the card and its loss."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gpt2-medium")
    if layers is not None:
        cfg = cfg.with_(num_layers=layers)
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cuda")


def fwd_bwd_times(torch, model, params, batch):
    """Device seconds of one worker's forward on its batch (no grad) and the
    backward's ratio to it (forward + backward through autograd, minus the
    forward, over the forward): CUDA events, median of 3 after a warm-up."""
    from repro_torch.launch.train import forward_slice_lane

    b = {k: v[0] for k, v in batch.items()}
    lane = forward_slice_lane(model.loss_fn)

    def fwd():
        with torch.no_grad():
            model.loss_fn(params, b)

    t_f = time_ms(torch, fwd, reps=3, warmup=1) / 1e3
    t_fb = time_ms(torch, lambda: lane(params, b), reps=3, warmup=1) / 1e3
    return t_f, (t_fb - t_f) / t_f


def in_flight(extras) -> float:
    """The push-sum mass a block-mode queue holds (0 for the others)."""
    if isinstance(extras, dict) and "q0" in extras:
        return float(extras["q0"]["w"].sum() + extras["q1"]["w"].sum())
    return 0.0


def sim_run(torch, cfg, model, params, batches, hw, algo, R_, D_, kw):
    """One algorithm on the sim backend, 4 steps, and the event backend in
    lock-step. Held: finite loss near ln V, Σw (with the block queue's mass
    in flight) = 1 ± 1e-5, DDP's replicas identical, and the flash launches
    of the prod step (``flash_want``: (R + 1)·M·L forward, the recompute
    included, M·L each backward, a step)."""
    from repro_torch.core.api import get_algorithm
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    be = make_backend("sim", get_algorithm(algo, **kw), M=M,
                      loss_fn=model.loss_fn, optimizer=momentum(0.9),
                      schedule=constant(LR), fb_ratio=R_, update_delay=D_,
                      device="cuda")
    ev = make_backend("event", algo, M=M, hw=hw, fb_ratio=R_,
                      update_delay=D_, sync_every=kw.get("sync_every", 8))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches()                         # main path starts
    state = be.init(0, params)
    es = ev.init()
    hist = {k: [] for k in ("loss", "weight_sum", "mass", "update_staleness",
                            "staleness_mean", "disagreement")}
    modeled, step_s, busy = [], [], None
    for t, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == len(batches) - 1:  # the last step under the profiler

            def run(b=b):
                nonlocal state, m
                state, m = be.step(state, b)

            m = None
            busy, _, _ = profiled_busy(torch, run)
        else:
            state, m = be.step(state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        es, em = ev.step(es)
        modeled.append(em["iter_time"])
        for k in hist:
            if k != "mass":
                hist[k].append(float(m[k]))
        hist["mass"].append(hist["weight_sum"][-1] + in_flight(state.extras))
    torch.cuda.synchronize()                        # main path ends
    counts = step_launches()
    peak = torch.cuda.max_memory_allocated()
    what = f"sim {algo}"
    check(all(math.isfinite(v) for v in hist["loss"]), f"{what} {hist}")
    check(abs(hist["loss"][0] - math.log(cfg.vocab_size)) < 0.5,
          f"{what} first loss {hist['loss'][0]} far from ln(V)")
    check(all(abs(v - 1.0) <= 1e-5 for v in hist["mass"]),
          f"{what} push-sum mass {hist['mass']}")
    steps, L = len(batches), cfg.num_layers
    flash = {"fwd": counts["flash_fwd"], "dq": counts["flash_dq"],
             "dkv": counts["flash_dkv"]}
    want = flash_want(steps * M * L, R_)
    check(flash == want, f"{what} flash launches {flash} != {want}")
    check(counts["gossip_mix"] == 0, f"{what} launched gossip_mix")
    if algo == "ddp":
        for g, p in state.params.items():
            check(all(torch.equal(p[0], p[i]) for i in range(1, M)),
                  f"sim ddp replicas differ in {g}")
    med = statistics.median(step_s[1:])
    tokens = M * BATCH_PER_WORKER * SEQ
    summary = ev.summary()
    row = {"algo": algo, "fb_ratio": R_, "update_delay": D_, **kw,
           "history": hist, "step_s": step_s, "median_step_s": med,
           "tokens_per_s": tokens / med, "peak_bytes": peak,
           "bytes_before_init": base, "device_s_profiled_step": busy,
           "idle_share": 1.0 - busy / med,
           "flash_launches_per_step": {k: v / steps
                                       for k, v in flash.items()},
           "modeled": {"label": "modeled by the event simulator from the "
                                "card's measured forward time and "
                                "backward ratio",
                       "iter_time_s": modeled,
                       "total_time_s": summary["total_time"],
                       "utilization": summary["utilization"],
                       "mfu": summary["mfu"],
                       "fwd_passes_per_s": summary["fwd_passes_per_s"]}}
    emit("sim_algo", **row)
    del state, be
    torch.cuda.empty_cache()
    return row, counts


def phase_sim(torch):
    """The sim trainer on GPT-2 Medium cut to ``SIM_LAYERS`` (f32, M=4,
    the train phase's batches) for each of the nine algorithms, with the event backend in
    lock-step on a HardwareModel of the card's measured forward time and
    backward ratio. Returns the phase's launches and the model's rows."""
    from repro_torch.core.simulator import HardwareModel
    from repro_torch.core.pytree import tree_leaves

    cfg, model, params = gpt2_medium(torch, SIM_LAYERS)
    batches = lm_batches(torch, cfg.vocab_size, SIM_STEPS, seed=0)
    t_fwd, bwd_ratio = fwd_bwd_times(torch, model, params, batches[0])
    plane_bytes = sum(p.numel() * p.element_size()
                      for p in tree_leaves(params))
    hw = HardwareModel(fwd_time=t_fwd, bwd_ratio=bwd_ratio,
                       num_layers=cfg.num_layers, model_bytes=plane_bytes)
    emit("sim_hardware_model", fwd_time_s=t_fwd, bwd_ratio=bwd_ratio,
         num_layers=cfg.num_layers, model_bytes=plane_bytes,
         bandwidth=hw.bandwidth, allreduce_bandwidth=hw.allreduce_bandwidth,
         kernel_mfu=hw.kernel_mfu,
         note="fwd_time and bwd_ratio measured on the card (one worker's "
              "4 x 256 batch); the link rates and kernel_mfu are the "
              "simulator's defaults, not measured")
    total, rows = {}, []
    for algo, R_, D_, kw in SIM_RUNS:
        row, counts = sim_run(torch, cfg, model, params, batches, hw, algo,
                              R_, D_, kw)
        rows.append(row)
        total = add_counts(total, counts)
    emit("event", label="modeled by the event simulator from the card's "
         "measured forward time and backward ratio (sim_hardware_model), "
         "stepped in lock-step with each algorithm's sim run",
         **{r["algo"]: {k: r["modeled"][k] for k in (
             "iter_time_s", "total_time_s", "utilization", "mfu")}
            for r in rows})
    emit("sim", algorithms=[r["algo"] for r in rows],
         median_step_s={r["algo"]: r["median_step_s"] for r in rows},
         peak_bytes={r["algo"]: r["peak_bytes"] for r in rows},
         idle_share={r["algo"]: r["idle_share"] for r in rows},
         modeled_total_time_s={r["algo"]: r["modeled"]["total_time_s"]
                               for r in rows},
         launches=total)
    del params
    torch.cuda.empty_cache()
    return {"launches": total, "rows": rows}


def phase_sim_prod(torch):
    """The sim ``layup-hypercube`` against the prod ``layup`` at M=1 (one
    worker sends nothing), GPT-2 Medium, (R, D) in SIM_PROD_POINTS, 4
    steps each: layer_staleness and update_staleness equal, the losses
    within 1e-5 (``tests/test_torch_sim.py::test_sim_prod_parity`` on the
    card)."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    cfg, model, params = gpt2_medium(torch)
    batches = [{k: v[:1] for k, v in b.items()} for b in
               lm_batches(torch, cfg.vocab_size, SIM_PROD_STEPS, seed=0)]
    out = []
    for R_, D_ in SIM_PROD_POINTS:
        kw = dict(M=1, loss_fn=model.loss_fn, optimizer=momentum(0.9),
                  schedule=constant(LR), fb_ratio=R_, update_delay=D_,
                  device="cuda")
        prod = make_backend("prod", "layup", use_pallas=True, **kw)
        sim = make_backend("sim", "layup-hypercube", **kw)
        ps, ss = prod.init(None, params), sim.init(0, params)
        gaps = []
        for t, b in enumerate(batches):
            ps, pm = prod.step(ps, b)
            ss, sm = sim.step(ss, b)
            gaps.append(abs(float(pm["loss"]) - float(sm["loss"])))
            check(gaps[-1] <= 1e-5, f"sim_prod R={R_} D={D_} step {t} "
                  f"loss gap {gaps[-1]}")
            check(torch.equal(pm["layer_staleness"], sm["layer_staleness"]),
                  f"sim_prod R={R_} D={D_} layer_staleness differs")
            check(float(pm["update_staleness"])
                  == float(sm["update_staleness"]),
                  f"sim_prod R={R_} D={D_} update_staleness differs")
        out.append({"fb_ratio": R_, "update_delay": D_, "loss_gaps": gaps,
                    "update_staleness": float(sm["update_staleness"])})
        del ps, ss, prod, sim
        torch.cuda.empty_cache()
    emit("sim_prod", M=1, steps=SIM_PROD_STEPS, points=out)
    del params
    torch.cuda.empty_cache()


def tune_floors(cfg, groups: dict):
    """Per-stage floors of a candidate on the card, from its own rates:
    ``fwd`` the mean over the R forward slices of the products each does
    (slice 0 forward, its blocks' recompute (``remat_block``) and
    backward, 4x; the others forward) at the float32
    rate (TF32 is off); ``update`` the bytes of the update stage (momentum
    and gradient read, momentum and update written, the FIFO slot read
    when D > 0; each plane M x the f32 model) at the HBM rate; ``gossip``
    ``mix_bound_ms`` of the fused mix over the plane."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models.transformer import decoder_specs

    n = sum(groups.values())
    tokens = M * BATCH_PER_WORKER * SEQ
    d, L = cfg.d_model, cfg.num_layers
    # matmul parameters: the blocks' matrices (stacked over the layers, so
    # 3-D) and the tied head; and causal attention's two products a layer
    # (half of S x S)
    mm = sum(math.prod(s.shape) for s in tree_leaves(
        decoder_specs(cfg)["blocks"]) if len(s.shape) >= 3)
    mm += d * cfg.vocab_size
    fwd_flops = 2 * mm * tokens + L * 2 * 2 * (SEQ * SEQ // 2) * d * (
        tokens // SEQ)
    gossip_s = mix_bound_ms([M * v for v in groups.values()], 4, True,
                            M)[0] / 1e3

    def floors(cand):
        slice_flops = fwd_flops / cand.R
        mean_flops = (4 * slice_flops + (cand.R - 1) * slice_flops) / cand.R
        planes = 4 + (1 if cand.D > 0 else 0)
        return {"fwd": mean_flops / F32_FLOPS_PER_S,
                "update": planes * M * n * 4 / HBM_BYTES_PER_S,
                "gossip": gossip_s}

    return floors


def phase_tune(torch):
    """The stage autotuner on GPT-2 Medium, M=4, the pipeline engine
    (``overlap=True``, ``use_pallas=True``): the default candidate, then R
    in {1, 2} x D in {0, 1} at ``max_inflight_steps=3``. Each candidate: 3
    steps for the timeline, its state dropped, then every cutout timed
    (warmup 1, reps 3, CUDA-event clock; fresh inputs each call). Then
    ``build_record`` with the card's floors, save under ``build/``,
    ``load_tuning(key=...)``, and a fresh ``make_backend("prod", ...,
    tuning=path)`` must take the record's R, D and max_inflight_steps,
    train a step and launch gossip_mix."""
    from repro_torch.core.backend import make_backend
    from repro_torch.launch import tuner
    from repro_torch.optim import constant, momentum

    cfg, model, params = gpt2_medium(torch)
    batches = lm_batches(torch, cfg.vocab_size, TUNE_STEPS + 1, seed=0)
    groups = gpt2_medium_groups()
    floors = tune_floors(cfg, groups)
    harness = tuner.CutoutHarness(warmup=TUNE_WARMUP, reps=TUNE_REPS)
    grid = [tuner.DEFAULT_CANDIDATE] + [
        tuner.Candidate(R=r, D=d, max_inflight_steps=3)
        for r in (1, 2) for d in (0, 1)]
    kw = dict(M=M, loss_fn=model.loss_fn, optimizer=momentum(0.9),
              schedule=constant(LR), use_pallas=True, device="cuda")
    measured, entries, rows, launches = {}, [], [], {}
    for cand in grid:
        if cand in measured:  # the default again: the same measurement
            entries.append((cand,) + measured[cand])
            continue
        be = make_backend("prod", "layup", overlap=True, fb_ratio=cand.R,
                          update_delay=cand.D,
                          max_inflight_steps=cand.max_inflight_steps, **kw)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = be.init(None, params)
        for b in batches[:TUNE_STEPS]:
            state, m = be.step(state, b)
        settle(torch, be)
        loss = float(m["loss"])
        check(math.isfinite(loss), f"tune {cand.label()} loss {loss}")
        be.summary()  # finalizes the timeline
        tl = be.timeline.summary()
        step_peak = torch.cuda.max_memory_allocated()
        part = be.part
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()                     # cutouts start
        timings = harness.time_engine(be.engine)
        torch.cuda.synchronize()                    # cutouts end
        launches = add_counts(launches, step_launches())
        cut_peak = torch.cuda.max_memory_allocated()
        times = tuner.stage_times_from_cutouts(timings)
        measured[cand] = (times, tl)
        entries.append((cand, times, tl))
        rows.append({"label": cand.label(), "cutout_s": timings,
                     "stage_times_s": times,
                     "engine_stage_s": tl.get("stage_s"),
                     "timeline_wall_s": tl["wall_s"],
                     "floors_s": floors(cand), "loss": loss,
                     "step_peak_bytes": step_peak,
                     "cutout_peak_bytes": cut_peak})
        emit("tune_candidate", **rows[-1])
        del be
        gc.collect()
        torch.cuda.empty_cache()
    key = tuner.make_key(tuner.problem_descriptor(part),
                         tuner.mesh_descriptor("cuda", M), "param")
    rec = tuner.build_record(entries, key=key, floors=floors,
                             meta={"steps": TUNE_STEPS, "warmup": TUNE_WARMUP,
                                   "reps": TUNE_REPS})
    path = rec.save(str(HERE / "build" / "tune" / "tuning.json"))
    loaded = tuner.load_tuning(path, key=key)
    check(loaded is not None and loaded.to_dict() == rec.to_dict(),
          "tune record did not load back")
    best = loaded.best_candidate()
    reset_kernel_launches()                         # tuned backend starts
    be = make_backend("prod", "layup", tuning=path, **kw)
    check(be.overlap and be.tuning is not None, "tuned backend not tuned")
    state = be.init(None, params)
    eng = be.engine
    check((eng.R, eng.D, eng.max_inflight_steps)
          == (best.R, best.D, best.max_inflight_steps),
          f"tuned engine {(eng.R, eng.D, eng.max_inflight_steps)} != "
          f"record {best.label()}")
    state, m = be.step(state, batches[-1])
    settle(torch, be)                               # tuned backend ends
    tuned = step_launches()
    loss = float(m["loss"])
    check(math.isfinite(loss), f"tuned backend loss {loss}")
    check(tuned["gossip_mix"] == len(groups),
          f"tuned step gossip_mix launches {tuned['gossip_mix']}")
    launches = add_counts(launches, tuned)
    emit("tune", key=key, best=rec.best, score=rec.score, table=rec.table,
         record_path=os.path.relpath(path, HERE),
         tuned_engine={"R": eng.R, "D": eng.D,
                       "max_inflight_steps": eng.max_inflight_steps},
         tuned_loss=loss, tuned_step_launches=tuned, launches=launches)
    del state, be, m, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_checkpoint(torch):
    """The prod state of GPT-2 Medium cut to ``CKPT_LAYERS`` at M=1, R=2,
    D=1 (read, write, momentum, FIFO) after 2 steps, saved under ``build/`` and restored into
    a fresh ``init`` state: the read plane's SHA-256s and every other leaf
    equal; then 2 more steps from each (the restored run after
    ``resume(2)``) give identical histories, digests and leaves. The
    directory is deleted afterwards."""
    import shutil

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.backend import make_backend
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.optim import constant, momentum

    cfg, model, params = gpt2_medium(torch, CKPT_LAYERS)
    batches = [{k: v[:1] for k, v in b.items()} for b in
               lm_batches(torch, cfg.vocab_size, 2 * CKPT_STEPS, seed=0)]

    def backend():
        return make_backend("prod", "layup", M=1, loss_fn=model.loss_fn,
                            optimizer=momentum(0.9), schedule=constant(LR),
                            fb_ratio=2, update_delay=1, use_pallas=True,
                            device="cuda")

    def same(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(
            (x.dtype == y.dtype and torch.equal(x, y))
            if isinstance(x, torch.Tensor) else bool((x == y).all())
            for x, y in zip(la, lb))

    def run(be, st):
        hist = []
        for b in batches[CKPT_STEPS:]:
            st, m = be.step(st, b)
            hist.append([float(m[k]) for k in ("loss", "weight_sum",
                                                 "update_staleness")])
        return hist, st

    directory = HERE / "build" / "ckpt_smoke"
    shutil.rmtree(directory, ignore_errors=True)
    be = backend()
    st = be.init(None, params)
    for b in batches[:CKPT_STEPS]:
        st, _ = be.step(st, b)
    torch.cuda.synchronize()
    digest = plane_digests(torch, st["read"])
    state_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(st)
                      if isinstance(x, torch.Tensor))
    try:
        os.makedirs(directory, exist_ok=True)
        free = shutil.disk_usage(directory).free
        check(free > 2 * state_bytes,
              f"checkpoint: {free} B free under build/, need "
              f"{2 * state_bytes}")
        t0 = time.perf_counter()
        path = save_checkpoint(str(directory), CKPT_STEPS, st)
        save_s = time.perf_counter() - t0
        on_disk = os.path.getsize(path)
        be2 = backend()
        fresh = be2.init(None, params)
        t0 = time.perf_counter()
        back = restore_checkpoint(str(directory), None, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del fresh
        check(plane_digests(torch, back["read"]) == digest,
              "restored read plane's SHA-256 differs")
        check(same(back, st), "restored state differs")
        be2.resume(CKPT_STEPS)
        h1, st = run(be, st)
        h2, back = run(be2, back)
        check(h1 == h2, f"resumed history {h2} != uninterrupted {h1}")
        d1, d2 = plane_digests(torch, st["read"]), plane_digests(
            torch, back["read"])
        check(d1 == d2 and same(st, back),
              "resumed planes differ from the uninterrupted run's")
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    emit("checkpoint", M=1, fb_ratio=2, update_delay=1, steps=CKPT_STEPS,
         state_bytes=state_bytes, bytes_on_disk=on_disk, save_s=save_s,
         restore_s=restore_s, history=h1, read_plane_sha256=d1,
         disk_free_bytes=free)
    del st, back, be, be2, params
    gc.collect()
    torch.cuda.empty_cache()


# the MoE phases: Qwen3-30B-A3B at full width (d 2048, 32 heads of 128 on
# 4 KV heads, qk_norm, 128 experts top-8 of d_ff 768, vocab 151936, bf16),
# its depth cut from 48 layers to MOE_LAYERS so that M=4 planes fit one
# card (934,287,616 parameters: a 7.47 GB bf16 plane at M=4); serving: 8
# requests over 8 slots, prompts of 16-64 tokens, 16 new tokens
MOE_NAME, MOE_LAYERS = "qwen3-moe-30b-a3b", 1
# serving a family (serve_moe, serve_hybrid, serve_vlm): slots, max_len,
# requests, prompt lengths and new tokens
FAMILY_SERVE = (8, 256, 8, (16, 64), 16)


def moe_config():
    from repro_torch.configs import get_config

    return get_config(MOE_NAME).with_(num_layers=MOE_LAYERS)


def routing_witness(logits, k: int, C: int):
    """The reference's routing written out plainly with numpy on one
    group's router logits (T, E) float32: each token's k experts by
    descending logit, ties to the lower index (softmax keeps the order of
    the distinct bf16 logits, so this is the order of the probabilities);
    then each assignment's rank within its expert, counted over the
    assignments token-major, kept below the capacity ``C``. Returns
    (gate_idx (T, k), keep (T·k,))."""
    import numpy as np

    gate_idx = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    seen = np.zeros(logits.shape[1], np.int64)
    keep = np.zeros(gate_idx.size, bool)
    for a, e in enumerate(gate_idx.reshape(-1)):
        keep[a] = seen[e] < C
        seen[e] += 1
    return gate_idx, keep


def moe_routing(torch, cfg, params, tokens) -> dict:
    """Layer 0's routing of ``tokens`` (one forward slice) under
    ``params``, as the step dispatches it (``moe._dispatch_group`` on the
    MLP input ``xt``), held to ``routing_witness`` on the card's logits:
    the same experts and the same kept assignments. A second product of
    the same xt and router, on the host in float64 rounded to the model's
    dtype, must agree with the card's logits to TOL of their largest
    |value| (the card may sum in another order and precision); the
    witness's dropped share on it is a reading. Readings: the share of
    assignments dropped, the load each expert was given, and how far the
    tokens share one direction (the cosine of each row of xt with their
    mean; the share of the logits' energy in their mean over tokens)."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MoE
    from repro_torch.models import transformer as T

    E, k = cfg.num_experts, cfg.experts_per_token
    with torch.no_grad():
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        _, sub = next(T.decoder_layers(params))
        h, _ = T.attn_sublayer(sub["attn"],
                               L.embed_apply(params["embed"], tokens), cfg,
                               positions=positions,
                               window=cfg.sliding_window)
        xt = L.rmsnorm(h, sub["mlp"]["norm"], cfg.norm_eps).reshape(
            -1, cfg.d_model)
        C = MoE.capacity(xt.shape[0], E, k, cfg.capacity_factor)
        _, meta, _ = MoE._dispatch_group(xt, sub["mlp"], cfg, C)
        router = sub["mlp"]["router"]
        logits = (xt @ router).float()
        load = torch.bincount(meta.gate_idx.reshape(-1), minlength=E).float()
        xf = xt.float()
        cos = torch.nn.functional.cosine_similarity(
            xf, xf.mean(0, keepdim=True), dim=1)
        common = (logits.mean(0).square().sum()
                  / logits.square().sum(1).mean())
    host = logits.cpu().numpy()
    gate_idx, keep = routing_witness(host, k, C)
    check(np.array_equal(meta.gate_idx.cpu().numpy(), gate_idx),
          "moe routing: experts differ from the witness's")
    check(np.array_equal(meta.keep.cpu().numpy(), keep),
          "moe routing: kept assignments differ from the witness's")
    f64 = (xt.cpu().double() @ router.cpu().double()).to(
        xt.dtype).float().numpy()
    off = np.abs(host - f64)
    tol = TOL[str(xt.dtype).replace("torch.", "")]
    check(off.max() <= tol * np.abs(f64).max(),
          f"moe routing: card logits off the host's by {off.max()}")
    _, host_keep = routing_witness(f64, k, C)
    mean = xt.shape[0] * k / E
    return {"tokens": xt.shape[0], "experts": E, "top_k": k,
            "capacity": C, "capacity_factor": cfg.capacity_factor,
            "dropped_share": 1.0 - meta.keep.float().mean().item(),
            "witness_dropped_share": 1.0 - float(keep.mean()),
            "host_dropped_share": 1.0 - float(host_keep.mean()),
            "logits_off_host": int((off > 0).sum()),
            "logits_off_host_max": float(off.max()),
            "logits_host_max": float(np.abs(f64).max()),
            "load_mean": mean, "load_max": load.max().item(),
            "load_min": load.min().item(),
            "load_max_over_mean": load.max().item() / mean,
            "load_cv": (load.std() / mean).item(),
            "experts_over_capacity": int((load > C).sum()),
            "xt_cos_to_mean_median": cos.median().item(),
            "xt_cos_to_mean_min": cos.min().item(),
            "logits_common_share": common.item()}


def hold_plane_mix(torch, read, group: str = "blocks",
                   chunk: int = 1 << 24) -> dict:
    """gossip_mix (#1) on a family step's largest buffer (train_moe's,
    train_hybrid's), the read plane's bf16 ``group`` stacked over its
    workers (past 2^31 elements), with
    its ring hop (the roll the step makes) and a third operand (the roll
    by two): the fused and pure variants against gossip_mix_ref, which
    runs a chunk of columns at a time so that no float32 copy of the
    buffer is made; then the fused variant in place (the step's form)
    bit-identical to out of place. Launches here are not the main path's
    (its counts were read before)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gossip_mix_ref

    x = read[group]
    rows = x.shape[0]
    x = x.reshape(rows, -1)
    n = x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(1234)
    w = torch.rand(rows, generator=gen, device=x.device) + 0.5
    rw = torch.roll(w, 1)
    alpha, beta = w / (w + rw), rw / (w + rw)
    recv, upd = torch.roll(x, 1, 0), torch.roll(x, 2, 0)
    out = torch.empty_like(x)
    dn = str(x.dtype).replace("torch.", "")
    res = {"group": group, "rows": rows, "n": n, "elements": x.numel(),
           "dtype": dn, "tol": TOL[dn]}
    for variant, u in (("fused", upd), ("pure", None)):
        ops.gossip_mix(x, recv, u, alpha, beta, out=out)
        err = scale = 0.0
        for lo in range(0, n, chunk):
            cols = slice(lo, lo + chunk)
            want = gossip_mix_ref(x[:, cols], recv[:, cols],
                                  None if u is None else u[:, cols],
                                  alpha, beta).float()
            err = max(err, (out[:, cols].float() - want).abs().max().item())
            scale = max(scale, want.abs().max().item())
        check(err <= TOL[dn] * max(scale, 1.0),
              f"gossip_mix {variant} on {group} ({x.numel()} elements): "
              f"error {err} > {TOL[dn]} x {scale}")
        res[f"max_abs_err_{variant}"] = err
    res["ms"] = time_ms(torch, lambda: ops.gossip_mix(
        x, recv, upd, alpha, beta, out=out), reps=5, warmup=1)
    res["bound_ms"] = mix_bound_ms([x.numel()], x.element_size(), True,
                                   rows)[0]
    ops.gossip_mix(recv, x, upd, alpha, beta, out=out)
    ops.gossip_mix(recv, x, upd, alpha, beta, out=recv)  # in place
    res["in_place_bit_identical"] = bool(torch.equal(recv, out))
    check(res["in_place_bit_identical"],
          f"gossip_mix in place on {group} differs from out of place")
    del recv, upd, out
    torch.cuda.empty_cache()
    return res


def moe_readings(model, backend, state, batches) -> dict:
    """After the counted window: ``ce`` and ``aux`` of one ``loss_fn``
    call on worker 0's read plane and first batch; layer 0's routing of
    that batch's first forward slice (``moe_routing``) under the seed-0
    weights the run started from and under that read plane; and
    ``hold_plane_mix`` on the read plane."""
    import torch

    cfg = model.cfg
    params = backend.part.unpack({n: v[0] for n, v in state["read"].items()})
    batch = {n: v[0] for n, v in batches[0].items()}
    tokens = batch["tokens"][:BATCH_PER_WORKER // R]
    with torch.no_grad():
        _, metrics = model.loss_fn(params, batch)
    init = model.init(seed=0, device="cuda")
    out = {"ce": metrics["ce"].item(), "aux": metrics["aux"].item(),
           "routing_init": moe_routing(torch, cfg, init, tokens),
           "routing": moe_routing(torch, cfg, params, tokens)}
    del init, params
    out["blocks_mix"] = hold_plane_mix(torch, state["read"])
    return out


def phase_train_moe(torch, profile: bool):
    """train_moe: the MoE family through train's entry points and traffic
    (``moe_config()``; ``profile`` as train's); train_moe_pipeline: the
    same run through the stage-graph engine (``overlap=True``), held to it
    bit for bit (histories, read plane digests, launches). Returns
    train_moe's result."""
    cfg = moe_config()
    res, backend = phase_train(torch, profile=profile, name="train_moe",
                               cfg=cfg, readings=moe_readings)
    del backend
    res["phase"] = "train_moe"
    _, backend = phase_train_engine(torch, "train_moe_pipeline", res,
                                    cfg=cfg, overlap=True)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_family(torch, name, cfg):
    """``cfg``'s model (its dtype, seed-0 weights) through ServeLoop
    (FAMILY_SERVE); then ``prefill_fn`` against prefill-by-decode in
    float32 (the same weights upcast) to phase serve's tolerances, the
    model's own dtype's gaps as readings. An MoE holds at
    ``capacity_factor`` = E/k, where no assignment can drop (a prompt of T
    tokens gets T slots an expert)."""
    from repro_torch.core.pytree import tree_map
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    model, params, loop, prompts, step_s, wall, res = serve_run(
        torch, cfg, name, *FAMILY_SERVE)
    hold_kw = {}
    if cfg.num_experts:
        hold_kw["capacity_factor"] = cfg.num_experts / cfg.experts_per_token
        res["hold_capacity_factor"] = hold_kw["capacity_factor"]
    gaps = {}
    for dtype in (torch.float32, cfg.dtype):
        dn = str(dtype).replace("torch.", "")
        hold_params = tree_map(lambda t: t.to(dtype), params)
        gaps[dn], flash = prefill_hold(
            torch, build_model(cfg.with_(dtype=dtype, **hold_kw)),
            hold_params, prompts[:SERVE_HOLD], FAMILY_SERVE[1],
            f"{name} ({dn})", hold=dtype == torch.float32)
        del hold_params
    res.update(prefill_vs_decode=gaps,
               prefill_tol_float32={"logits": SERVE_LOGIT_TOL,
                                    "kv": SERVE_KV_TOL},
               prefill_launches=flash,
               **serve_readings(torch, model, params, loop, step_s, wall),
               peak_bytes=torch.cuda.max_memory_allocated())
    emit(name, phase_s=time.perf_counter() - t_phase, **res)
    del loop, params
    torch.cuda.empty_cache()
    return res


def phase_serve_moe(torch):
    """The MoE model (``moe_config()``, bf16) through
    ``phase_serve_family``."""
    return phase_serve_family(torch, "serve_moe", moe_config())


# ---------------------------------------------------------------------------
# the hybrid, VLM and encoder-decoder families (ROADMAP item 14b-d)
# ---------------------------------------------------------------------------

# Each at full width with train's traffic (R=2, D=1, 4 x 256 tokens a
# worker, 6 steps, seed-0 weights), its bf16 plane near 7-8 GB (a step
# holds ~7 planes). Jamba v0.1: depth 32 -> 2 and attn_layer_period 8 -> 2
# (configs.reduced's interleave: sub0 SSM + dense MLP, sub1 attention +
# MoE), 3,675,001,376 parameters, M=1 (7.35 GB; at M=2 14.7 GB). Qwen2-VL
# 2B whole, 1,543,656,960 parameters, M=2 (6.17 GB). Whisper large-v3
# whole, 1,954,032,640 parameters, M=2 (7.82 GB).
HYBRID_NAME, HYBRID_LAYERS, HYBRID_PERIOD, HYBRID_M = (
    "jamba-v0.1-52b", 2, 2, 1)
VLM_NAME, VLM_M = "qwen2-vl-2b", 2
VLM_IMAGE_GRID = 8  # one 8 x 8 image span a training sequence
ENCDEC_NAME, ENCDEC_M = "whisper-large-v3", 2
# serve_encdec: prefill_fn and decode_fn over 8 sequences of 64 tokens,
# held in float32 to decode_train's teacher-forced logits at every position
ENCDEC_SERVE_SEQS, ENCDEC_SERVE_LEN, ENCDEC_TOL = 8, 64, SERVE_LOGIT_TOL


def hybrid_config():
    from repro_torch.configs import get_config

    return get_config(HYBRID_NAME).with_(num_layers=HYBRID_LAYERS,
                                         attn_layer_period=HYBRID_PERIOD)


def family_readings(model, backend, state, batches) -> dict:
    """After the counted window: ``ce`` and ``aux`` of one ``loss_fn`` call
    on worker 0's read plane and first batch; the shapes of that batch's
    forward slices (``_split_fwd_slices``: a (3, B, S) positions leaf on
    its dim 1)."""
    import torch
    from repro_torch.launch.train import _split_fwd_slices

    params = backend.part.unpack({n: v[0] for n, v in state["read"].items()})
    batch = {n: v[0] for n, v in batches[0].items()}
    with torch.no_grad():
        _, metrics = model.loss_fn(params, batch)
    slices = _split_fwd_slices(batch, R)
    shapes = {k: list(v.shape) for k, v in slices[0].items()}
    check(all(len(sl) == len(batch) for sl in slices)
          and all(v.shape[1 if k == "positions" else 0]
                  == BATCH_PER_WORKER // R for k, v in slices[0].items()),
          f"forward slices {shapes}")
    del params
    return {"ce": metrics["ce"].item(), "aux": metrics["aux"].item(),
            "init_loss": init_loss(model.cfg), "slice_shapes": shapes}


def hybrid_readings(model, backend, state, batches) -> dict:
    """``family_readings`` and ``hold_plane_mix`` on the read plane's bf16
    ``blocks`` buffer (3.14e9 elements at M=1)."""
    import torch

    out = family_readings(model, backend, state, batches)
    out["blocks_mix"] = hold_plane_mix(torch, state["read"])
    return out


def phase_train_family(torch, name, cfg, workers, batches, readings,
                       profile=False) -> dict:
    """``cfg`` through phase_train's entry points and traffic on
    ``workers`` workers and ``batches``."""
    res, backend = phase_train(torch, profile=profile, name=name, cfg=cfg,
                               readings=readings, workers=workers,
                               batches=batches)
    del backend
    res["phase"] = name
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_train_hybrid(torch, profile=False):
    """train_hybrid: ``hybrid_config()`` at M=1 (``hybrid_readings``;
    ``profile`` as train's); train_hybrid_pipeline: the same run through
    the stage-graph engine (``overlap=True``), held to it bit for bit.
    Returns train_hybrid's result."""
    cfg = hybrid_config()
    batches = lm_batches(torch, cfg.vocab_size, TRAIN_STEPS, seed=0,
                         workers=HYBRID_M)
    res = phase_train_family(torch, "train_hybrid", cfg, HYBRID_M, batches,
                             hybrid_readings, profile)
    _, backend = phase_train_engine(torch, "train_hybrid_pipeline", res,
                                    cfg=cfg, workers=HYBRID_M,
                                    batches=batches, overlap=True)
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_train_vlm(torch, profile=False):
    """train_vlm: Qwen2-VL 2B whole at M=2 on ``family_batches``
    (embeddings, (3, B, S) positions with an image span a sequence;
    ``profile`` as train's)."""
    from repro_torch.configs import get_config

    cfg = get_config(VLM_NAME)
    batches = family_batches(torch, cfg, TRAIN_STEPS, seed=0,
                             workers=VLM_M)
    check(batches[0]["positions"].shape == (VLM_M, 3, BATCH_PER_WORKER, SEQ),
          f"VLM positions {tuple(batches[0]['positions'].shape)}")
    return phase_train_family(torch, "train_vlm", cfg, VLM_M, batches,
                              family_readings, profile)


def phase_train_encdec(torch, profile=False):
    """train_encdec: Whisper large-v3 whole at M=2 on ``family_batches``
    (1500 audio frames, 256 tokens a sequence; ``profile`` as train's)."""
    from repro_torch.configs import get_config

    cfg = get_config(ENCDEC_NAME)
    batches = family_batches(torch, cfg, TRAIN_STEPS, seed=0,
                             workers=ENCDEC_M)
    return phase_train_family(
        torch, "train_encdec", cfg, ENCDEC_M, batches,
        lambda *a: {**family_readings(*a), **remat_readings(*a)},
        "kernels" if profile else False)


def phase_serve_encdec(torch):
    """serve_encdec: Whisper large-v3 (bf16, seed-0 weights): ``prefill_fn``
    (the encoder, every layer's cross K/V, the first token) and then
    ``decode_fn`` over the later tokens of ENCDEC_SERVE_SEQS sequences,
    each step host-timed to a synchronisation. prefill_fn launches one
    flash forward an encoder layer, decode none. Held in float32 (the same
    weights and frames upcast) to ``decode_train``'s teacher-forced logits
    at every position, within ENCDEC_TOL of their largest |value|; the
    bf16 gap as a reading. No ServeLoop: the JAX package serves whisper
    only through these two functions (its ServeLoop never fills the cross
    cache)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data.synthetic import lm_batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.models import encdec as ED

    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_NAME)
    B, S = ENCDEC_SERVE_SEQS, ENCDEC_SERVE_LEN
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = lm_batch_for(cfg, B, S, generator=gen, device="cuda")
    toks = batch["tokens"]
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()

    def incremental(model, params, batch, timed=None):
        """(B, S, V) float32 logits: prefill_fn, then decode_fn a token a
        step; ``timed`` collects each call's host seconds."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = model.prefill_fn(params, batch)
        torch.cuda.synchronize()
        out = [logits[:, 0]]
        if timed is not None:
            timed["prefill_s"] = time.perf_counter() - t0
            fa.reset_launches()
        steps = []
        for t in range(1, S):
            t0 = time.perf_counter()
            logits, cache = model.decode_fn(
                params, cache, toks[:, t:t + 1],
                torch.full((B,), t, dtype=torch.int64, device="cuda"))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            out.append(logits[:, 0])
        if timed is not None:
            timed["decode_s"] = steps
            timed["cache_bytes"] = sum(v.numel() * v.element_size()
                                       for leaves in cache.values()
                                       for v in leaves.values())
        return torch.stack(out, dim=1)

    incremental(model, params, batch)  # warm
    timed = {}
    got = incremental(model, params, batch, timed)  # counts from decode
    decode_flash = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                    "dkv": fa.dkv_launches}
    check(decode_flash == {"fwd": 0, "dq": 0, "dkv": 0},
          f"serve_encdec decode flash launches {decode_flash}")
    fa.reset_launches()
    model.prefill_fn(params, batch)
    torch.cuda.synchronize()
    launches = {"fwd": fa.fwd_launches, "dq": fa.dq_launches,
                "dkv": fa.dkv_launches}
    want = {"fwd": cfg.enc_layers, "dq": 0, "dkv": 0}
    check(launches == want,
          f"serve_encdec prefill flash launches {launches} != {want}")
    gaps = {}
    for dtype in (torch.float32, cfg.dtype):
        dn = str(dtype).replace("torch.", "")
        m = build_model(cfg.with_(dtype=dtype))
        p = tree_map(lambda t: t.to(dtype), params)
        b = dict(batch, audio_embeds=batch["audio_embeds"].to(dtype))
        with torch.no_grad():
            full = ED.decode_train(p, ED.encode(p, b["audio_embeds"],
                                                m.cfg), toks, m.cfg)
        inc = got if dtype == cfg.dtype else incremental(m, p, b)
        gaps[dn] = rel_gap(torch, inc, full)
        check(dtype != torch.float32 or gaps[dn] <= ENCDEC_TOL,
              f"serve_encdec float32 decode vs decode_train {gaps[dn]}")
        del m, p, b, full, inc
    steps = sorted(timed["decode_s"])
    p99 = steps[min(len(steps) - 1, int(math.ceil(0.99 * len(steps))) - 1)]
    res = {"model": cfg.name, "enc_layers": cfg.enc_layers,
           "layers": cfg.num_layers, "enc_seq": cfg.enc_seq,
           "dtype": str(cfg.dtype).replace("torch.", ""), "sequences": B,
           "tokens": S, "prefill_ms": 1e3 * timed["prefill_s"],
           "decode_steps": len(steps),
           "decode_step_median_ms": 1e3 * statistics.median(steps),
           "decode_step_p99_ms": 1e3 * p99,
           "tokens_per_s": B * len(steps) / sum(steps),
           "cache_bytes": timed["cache_bytes"],
           "decode_vs_decode_train": gaps, "tol_float32": ENCDEC_TOL,
           "prefill_launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    emit("serve_encdec", phase_s=time.perf_counter() - t_phase, **res)
    del params, batch, got
    torch.cuda.empty_cache()
    return res


# the Model path (phase train_model_path): GPT-2 Medium through make_step,
# 3 steps a route
MODEL_PATH_STEPS = 3
# lockstep accum_steps=2 against the whole batch: the reference's
# tests/test_dryrun_small.py::test_accum_steps_matches_full_batch
ACCUM_LOSS_TOL, ACCUM_PARAM_TOL = 2e-3, 5e-2
# DDP's step-0 loss against the mean of the lockstep workers' (relative;
# one forward of 16 sequences against four of 4: the sums' order differs)
DDP_LOSS_RTOL = 1e-5
MODEL_PATH_DECODE_STEPS = 4


def model_path_readings(torch, cfg, shape, step_s, base, launches, smi):
    """A route's readings: median step (steps 1.., or the one step), peak
    device bytes over the window's start, its launches, and the cost
    model's terms for the step's shape on one device with FLOPs shares
    against the card's float32 rate (the steps run in float32, TF32 off)."""
    from repro_torch.launch import analysis as AN

    med = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    mf = AN.model_flops(cfg, shape)
    ac = AN.analytic_costs(cfg, shape, n_model=1, n_workers=1)
    return {"shape": {"kind": shape.kind, "seq": shape.seq_len,
                      "global_batch": shape.global_batch},
            "step_s": step_s, "median_step_s": med,
            "peak_above_start": torch.cuda.max_memory_allocated() - base,
            "launches": launches, "model_flops": mf,
            "analytic_flops": ac["flops_per_device"],
            "analytic_bytes": ac["bytes_per_device"],
            "model_flops_share": mf / med / F32_FLOPS_PER_S,
            "analytic_flops_share": ac["flops_per_device"] / med
            / F32_FLOPS_PER_S,
            "flops_peak": "F32_FLOPS_PER_S (H100 SXM float32 SIMT)",
            "flops_peak_per_s": F32_FLOPS_PER_S, "nvidia_smi": smi}


def phase_train_model_path(torch, train, smi):
    """The Model-level factories: GPT-2 Medium (f32, seed-0 weights, the
    train phase's batches as one global batch of 16 x 256) on
    ``WorkerMesh(4, "cuda")``, each route 3 steps through ``make_step``,
    with the launch counts zeroed before and read after each: the
    decoupled step (R=2, D=1, ``use_pallas``) and its pipeline engine held
    bit-identical to ``ProdTrainerBackend`` on the same rows and shift
    draws; lockstep LayUp through the pure ``gossip_mix`` kernel (9
    launches, flash 192/96/96 a step) within TOL of the plain mix, and with
    ``accum_steps=2``; the plain decoupled step against the backend's plain
    route bit for bit; DDP's first loss against the lockstep workers' mean and
    ``init_loss``; prefill and decode at 8 x 512 bit-identical to
    ``prefill_fn`` and ``decode_fn``. One line per route; returns each
    route's launches."""
    import numpy as np
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.core.layerview import FlatPartition
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.launch.train import make_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import alloc_cache
    from repro_torch.optim import constant, momentum

    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    mesh = WorkerMesh(M, "cuda")
    steps, B, L = MODEL_PATH_STEPS, M * BATCH_PER_WORKER, cfg.num_layers
    shape = ShapeConfig("train_model_path", SEQ, B, "train")
    sim_batches = lm_batches(torch, cfg.vocab_size, steps, seed=0)
    batches = [{k: v.reshape((B,) + tuple(v.shape[2:]))
                for k, v in b.items()} for b in sim_batches]
    rng = np.random.default_rng(0xC0FFEE)  # ProdTrainerBackend's draws
    shift_idx = [int(rng.integers(0, 2)) for _ in range(steps)]  # (1, 2)
    stacked = tree_map(lambda x: x[None].expand((M,) + tuple(x.shape)),
                       params)
    part = FlatPartition(model.abstract_params())
    n_groups = len(part.group_sizes)
    opt = dict(optimizer=momentum(0.9), schedule=constant(LR))
    all_launches = {}

    def window():
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        return base

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def report(route, step_s, base, want, shape_=shape, **extra):
        got = step_launches()
        check(all(got[k] == v for k, v in want.items()),
              f"train_model_path {route}: launches {got} != {want}")
        all_launches[route] = got
        emit("train_model_path", route=route,
             **model_path_readings(torch, cfg, shape_, step_s, base, got,
                                   smi), **extra)

    def decoupled(**kw):
        step = make_step(model, mesh, shape, fb_ratio=R, update_delay=1,
                         **opt, **kw)
        state = step.init_state(stacked)
        losses, stale, step_s = [], [], []
        for t, b in enumerate(batches):
            (state, m), s = timed(lambda: step.fn(state, b, t, shift_idx[t]))
            step_s.append(s)
            losses.append(float(m["loss"]))
            stale.append(m["layer_staleness"].tolist())
        return state["read"], losses, stale, step_s

    def lockstep(**kw):
        step = make_step(model, mesh, shape, **opt, **kw)
        p, o, w = step.init_state(stacked)
        losses, step_s = [], []
        for t, b in enumerate(batches):
            (p, o, w, loss), s = timed(
                lambda: step.fn(p, o, w, b, t, shift_idx[t]))
            step_s.append(s)
            losses.append(float(loss))
        return p, losses, step_s

    fwd_lock = {f"flash_{k}": v
                for k, v in flash_want(steps * M * L, 1).items()}
    fwd_dec = {f"flash_{k}": v for k, v in flash_want(steps * M * L).items()}

    # 1. the decoupled step, fused: the backend path is the reference
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      fb_ratio=R, update_delay=1, use_pallas=True,
                      device="cuda", measure_drift=False, **opt)
    bst = be.init(None, params)
    ref_losses = []
    for b in sim_batches:
        bst, m = be.step(bst, b)
        ref_losses.append(float(m["loss"]))
    check(ref_losses == train["history"]["loss"][:steps],
          f"backend losses {ref_losses} != train's")
    ref_read = {k: v.clone() for k, v in bst["read"].items()}
    del bst, be, m
    for route, kw in (("decoupled", {}), ("decoupled_pipeline",
                                          {"overlap": True})):
        base = window()
        read, losses, stale, step_s = decoupled(use_pallas=True, **kw)
        check(losses == ref_losses,
              f"{route} losses {losses} != backend {ref_losses}")
        check(all(torch.equal(read[k], v) for k, v in ref_read.items()),
              f"{route}: read plane differs from the backend path's")
        report(route, step_s, base,
               {"gossip_mix": steps * n_groups, **fwd_dec},
               losses=losses, held_against="ProdTrainerBackend",
               bit_identical=True)
        del read
    del ref_read

    # 2. lockstep LayUp through the pure gossip_mix kernel, against the
    # plain mix; 3. accum_steps=2 against it
    base = window()
    p_kernel, lock_losses, step_s = lockstep(use_pallas=True)
    report("lockstep", step_s, base,
           {"gossip_mix": steps * n_groups, **fwd_lock}, losses=lock_losses)
    base = window()
    p_plain, plain_losses, step_s = lockstep()
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(tree_leaves(p_kernel), tree_leaves(p_plain)))
    check(worst <= TOL["float32"],
          f"lockstep pure kernel vs plain: {worst} > {TOL['float32']}")
    del p_plain
    report("lockstep_plain", step_s, base, {"gossip_mix": 0, **fwd_lock},
           losses=plain_losses, max_rel_gap_vs_kernel=worst)
    base = window()
    p_accum, accum_losses, step_s = lockstep(use_pallas=True, accum_steps=2)
    loss_gap = max(abs(a - b) for a, b in zip(accum_losses, lock_losses))
    param_gap = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(p_accum), tree_leaves(p_kernel)))
    check(loss_gap < ACCUM_LOSS_TOL and param_gap < ACCUM_PARAM_TOL,
          f"accum_steps=2 vs 1: loss gap {loss_gap}, param gap {param_gap}")
    del p_accum, p_kernel
    report("lockstep_accum2", step_s, base,
           {"gossip_mix": steps * n_groups,
            **{k: 2 * v for k, v in fwd_lock.items()}},
           losses=accum_losses, loss_gap=loss_gap, param_gap=param_gap)

    # 4. the decoupled step, plain, against the backend path's plain
    # route; the read planes compared by digest, so that no plane is kept
    # on the card across the two runs (the plain mix's float32 temporaries
    # make them the phase's largest)
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      fb_ratio=R, update_delay=1, device="cuda",
                      measure_drift=False, **opt)
    bst = be.init(None, params)
    ref_losses = []
    for b in sim_batches:
        bst, m = be.step(bst, b)
        ref_losses.append(float(m["loss"]))
    ref_digests = plane_digests(torch, bst["read"])
    del bst, be, m
    base = window()
    read, losses, _, step_s = decoupled()
    check(losses == ref_losses,
          f"decoupled_plain losses {losses} != backend {ref_losses}")
    report("decoupled_plain", step_s, base, {"gossip_mix": 0, **fwd_dec},
           losses=losses, held_against="ProdTrainerBackend",
           bit_identical=True)
    check(plane_digests(torch, read) == ref_digests,
          "decoupled_plain: read plane differs from the backend path's")
    del read

    # 5. DDP on the global batch
    base = window()
    step = make_step(model, mesh, shape, algo="ddp", **opt)
    p, o = step.init_state(params)
    ddp_losses, step_s = [], []
    for t, b in enumerate(batches):
        (p, o, loss), s = timed(lambda: step.fn(p, o, b, t))
        step_s.append(s)
        ddp_losses.append(float(loss))
    del p, o
    gap = abs(ddp_losses[0] - lock_losses[0])
    check(gap <= DDP_LOSS_RTOL * abs(lock_losses[0]),
          f"ddp step-0 loss {ddp_losses[0]} vs lockstep {lock_losses[0]}")
    check(abs(ddp_losses[0] - init_loss(cfg)) <= 0.5,
          f"ddp first loss {ddp_losses[0]} vs init_loss {init_loss(cfg)}")
    report("ddp", step_s, base,
           {"gossip_mix": 0, **{k: v // M for k, v in fwd_lock.items()}},
           losses=ddp_losses, step0_gap_vs_lockstep=gap,
           init_loss=init_loss(cfg))

    # 6. prefill and decode at the serve phase's 8 x 512
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (SERVE_SLOTS, SERVE_MAX_LEN))).cuda()
    pshape = ShapeConfig("serve_prefill", SERVE_MAX_LEN, SERVE_SLOTS,
                         "prefill")
    step = make_step(model, mesh, pshape)
    base = window()
    (cache_a, logits_a), s = timed(lambda: step.fn(params, {"tokens": toks}))
    report("prefill", [s], base, {"flash_fwd": L, "flash_dq": 0},
           shape_=pshape)
    cache_b, logits_b = model.prefill_fn(params, {"tokens": toks})
    check(torch.equal(logits_a, logits_b) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(cache_a),
                                          tree_leaves(cache_b))),
        "prefill step differs from prefill_fn")
    del cache_a, cache_b, logits_a, logits_b
    dshape = ShapeConfig("serve_decode", SERVE_MAX_LEN, SERVE_SLOTS, "decode")
    step = make_step(model, mesh, dshape)
    cache_b = alloc_cache(model.cache_specs(SERVE_SLOTS, SERVE_MAX_LEN),
                          device="cuda")
    base = window()
    cache_a = alloc_cache(step.abstract_args[1], device="cuda")
    step_s, same = [], True
    for pos in range(MODEL_PATH_DECODE_STEPS):
        tok = toks[:, pos:pos + 1].to(torch.int32)
        position = torch.full((SERVE_SLOTS,), pos, dtype=torch.int32,
                              device="cuda")
        (la, cache_a), s = timed(lambda: step.fn(params, cache_a, tok,
                                                 position))
        step_s.append(s)
        lb, cache_b = model.decode_fn(params, cache_b, tok, position)
        same = same and torch.equal(la, lb)
    same = same and all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(cache_a), tree_leaves(cache_b)))
    check(same, "decode step differs from decode_fn")
    report("decode", step_s, base, {"flash_fwd": 0, "gossip_mix": 0},
           shape_=dshape)
    del cache_a, cache_b, params
    torch.cuda.empty_cache()
    return all_launches


# the worker ring (train_ring): GPT-2 Medium at M=4 over RING_WORLD ranks
# that share the card (L = 2 workers each), RING_STEPS steps a run; the
# runs each rank makes, held to the stacked run of the same wire
RING_WORLD, RING_STEPS = 2, 3
RING_WIRES = {"param": 0.0, "int8": LAMBDA}
# the param wire's overlap run is cut (its rank step took 3.3-8.6 s on
# gloo loopback on an H100, 700 W): overlap over the ranks runs on the
# int8 wire
RING_RUNS = [("param", False), ("int8", False), ("int8", True)]
RING_TIMEOUT_S = 600  # each rank's process, build included
RING_KERNELS = {"param": ("gossip_mix",),
                "int8": ("quantize_plane", "dequant_mix")}
# the options over the ranks, after RING_RUNS (int8 wire, λ = LAMBDA):
# prefill and decode at serve's 8 x 512, full depth; a faulted run with a
# publisher and a live server on each rank, and streams=3, RING_CUT_LAYERS
# deep (two ranks' full-depth int8 states with two snapshots and a
# server's params, or with the stream engine's second plane and its
# per-stream allocator pools, do not fit one card), each held to a stacked
# run of the cut model; a checkpoint round trip RING_CKPT_LAYERS deep (a
# full-depth rank state is ~17 GB of disk)
RING_STREAMS = 3
RING_FAULTS = "crash:peer=3,step=1,recover=3"  # rank 1's peer, donor 0
RING_FAULT_STEPS = 4
RING_CUT_LAYERS, RING_CKPT_LAYERS = 12, 4
RING_DECODE_STEPS = 8
RING_SERVE_RTOL = 1e-5
RING_TUNED = {"R": 2, "D": 1, "max_inflight_steps": 2}


def row_digests(torch, plane) -> dict:
    """Each group's per worker row digest: the int64 sum of the row's bits
    viewed as int32 (computed on the card)."""
    return {g: buf.reshape(buf.shape[0], -1).view(torch.int32)
            .sum(dim=1, dtype=torch.int64).tolist()
            for g, buf in plane.items()}


def tree_digest(torch, tree) -> list:
    """Each tensor leaf's int64 sum of its bits viewed as int32 (bf16 and
    int8 leaves as their bytes), in leaf order."""
    from repro_torch.core.pytree import tree_leaves

    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            b = x.detach().reshape(-1).contiguous().view(torch.uint8)
            pad = (-b.numel()) % 4
            if pad:
                b = torch.cat([b, b.new_zeros(pad)])
            out.append(int(b.view(torch.int32).sum(dtype=torch.int64)))
    return out


RING_ROWS = ("gossip_mix", "flash_attention", "flash_attention_bwd",
             "flash_attention_trainable", "quantize_plane", "dequant_mix")


def ring_launches(counts: dict) -> dict:
    """A run's launches by kernel row of the kernels line."""
    return {"gossip_mix": counts["gossip_mix"],
            "flash_attention": counts["flash_fwd"],
            "flash_attention_bwd": counts["flash_dq"] + counts["flash_dkv"],
            "flash_attention_trainable": (counts["flash_fwd"]
                                          + counts["flash_dq"]
                                          + counts["flash_dkv"]),
            "quantize_plane": counts["quantize_plane"],
            "dequant_mix": counts["dequant_mix"]}


def card_memory(torch) -> dict:
    """This process's allocated and reserved bytes and the card's free
    bytes (all processes)."""
    free, total = torch.cuda.mem_get_info()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(), "card_free": free,
            "card_total": total}


def ring_run(torch, model, params, batches, wire, overlap, mesh=None,
             streams=1):
    """One run of ``RING_STEPS`` steps of the prod backend (stacked, or
    over ``mesh``), launch counts zeroed before: losses, read-plane row
    digests, step seconds, peak, the ring kernels' launches (and every
    kernel's by row), wire bytes a round and staging seconds. A stream
    engine runs one step in flight (``max_inflight_steps=1``: two ranks'
    engines share the card)."""
    from repro_torch.core.backend import make_backend
    from repro_torch.optim import constant, momentum

    kw = {"mesh": mesh} if mesh is not None else {"device": "cuda"}
    if streams > 1:
        kw["max_inflight_steps"] = 1
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           wire=wire, compensate=RING_WIRES[wire],
                           overlap=overlap, streams=streams,
                           wait_timeout_s=ENGINE_TIMEOUT_S,
                           measure_drift=False, **kw)
    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches, launch_resets(),
        keys=("loss", "weight_sum", "nonfinite_skips"))
    every = step_launches()
    read = out["state"]["read"]
    if streams > 1:
        read = backend.engine.materialize(read)
    res = {"losses": hist["loss"], "weight_sum": hist["weight_sum"],
           "skips": hist["nonfinite_skips"],
           "digests": row_digests(torch, read),
           "step_s": step_s, "peak_bytes": peak,
           "launches": {k: every[k] for k in RING_KERNELS[wire]},
           "kernel_launches": ring_launches(every),
           "wire_bytes_per_round": out["wire_bytes_per_round"],
           "staging_s": out.get("staging_s", 0.0),
           "memory_before": out["bytes_before_init"]}
    if streams > 1:
        backend.engine.close()
    del out, backend, read
    gc.collect()
    torch.cuda.empty_cache()
    return res


def cut_gpt2_medium(torch, layers: int):
    """GPT-2 Medium at full width cut to ``layers`` layers: (config, model,
    seed-0 params on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("gpt2-medium").with_(num_layers=layers)
    model = build_model(cfg)
    return cfg, model, model.init(seed=0, device="cuda")


def ring_faults_run(torch, model, params, batches, mesh=None):
    """The faulted run (``RING_FAULTS`` over ``RING_FAULT_STEPS`` steps,
    ``model``: GPT-2 Medium cut to ``RING_CUT_LAYERS``; int8 wire) with a publisher
    and a ``LiveServer`` polled after every step: stacked, one server for
    each rank's first worker; over ``mesh``, one for this rank's. Row
    digests, histories, the controller's counters, each server's decisions
    and served params' digests, the step and resync seconds, the resync's
    bytes, staging, wire bytes and peak."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.mesh import ROW_ENTRIES
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.optim import constant, momentum
    from repro_torch.serving import LiveServer, PlanePublisher, SwapPolicy

    cfg = model.cfg
    kw = {"mesh": mesh} if mesh is not None else {"device": "cuda"}
    pub = PlanePublisher()
    backend = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                           optimizer=momentum(0.9), schedule=constant(LR),
                           fb_ratio=R, update_delay=1, use_pallas=True,
                           wire="int8", compensate=LAMBDA, faults=RING_FAULTS,
                           publisher=pub, measure_drift=False, **kw)
    L = M // RING_WORLD
    workers = ([mesh.rows.start] if mesh is not None
               else [r * L for r in range(RING_WORLD)])
    servers = {j: LiveServer(ServeLoop(model, params, num_slots=2,
                                       max_len=LIVE_MAX_LEN),
                             None, pub,
                             policy=SwapPolicy(min_interval_steps=2),
                             worker=j, mesh=mesh) for j in workers}

    def on_batch(t):  # before step t: the snapshot of step t - 1
        for srv in servers.values():
            srv.part = backend.part
            if t:
                srv.poll()

    out, hist, step_s, peak = counted_drive(
        torch, backend, params, batches[:RING_FAULT_STEPS], launch_resets(),
        keys=MEMBERSHIP_KEYS, on_batch=on_batch)
    every = step_launches()
    for srv in servers.values():  # the last step's snapshot
        srv.poll()
    state = out["state"]
    held, seen = 0, set()
    for path in ROW_ENTRIES:  # one row of each row entry crossed
        tree = state
        for k in path:
            tree = tree.get(k, {}) if isinstance(tree, dict) else {}
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor) and x.dim() and id(x) not in seen:
                seen.add(id(x))
                held += x[0].numel() * x.element_size()
    res = {"losses": hist["loss"], "weight_sum": hist["weight_sum"],
           "skips": hist["nonfinite_skips"],
           "peers_live": hist["peers_live"],
           "digests": row_digests(torch, state["read"]),
           "chaos": chaos_counters(out), "step_s": step_s,
           "peak_bytes": peak, "layers": cfg.num_layers,
           "resync_s": backend.chaos.event_s.get("resync", []),
           "kill_s": backend.chaos.event_s.get("kill", []),
           "resync_bytes": held,
           "kernel_launches": ring_launches(every),
           "wire_bytes_per_round": out["wire_bytes_per_round"],
           "staging_s": out.get("staging_s", 0.0),
           "snapshot_rows": (None if pub.latest().rows is None
                             else list(pub.latest().rows)),
           "servers": {str(j): {
               "decisions": [[d.accepted, d.reason] for d in srv.decisions],
               "swaps": [r.step for r in srv.swaps],
               "served": tree_digest(torch, srv.loop.params)}
               for j, srv in servers.items()}}
    del out, state, backend, servers, pub
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ring_serve(torch, model, params, mesh):
    """``make_prefill_step`` on serve's 8 rows of prompts of
    ``SERVE_MAX_LEN − RING_DECODE_STEPS`` tokens, then
    ``RING_DECODE_STEPS`` greedy ``make_decode_step`` steps in a cache of
    ``SERVE_MAX_LEN`` (``mesh``: one process or the ranks). The logits and
    tokens (returned on the host), the prefill and decode seconds, the
    flash launches of the prefill and the cache's rows."""
    import numpy as np
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch.train import make_step
    from repro_torch.models.transformer import alloc_cache

    P = SERVE_MAX_LEN - RING_DECODE_STEPS
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (SERVE_SLOTS, P)).astype(np.int32)).cuda()
    prefill = make_step(model, mesh, ShapeConfig("ring_prefill", P,
                                                 SERVE_SLOTS, "prefill"))
    decode = make_step(model, mesh, ShapeConfig("ring_decode", SERVE_MAX_LEN,
                                                SERVE_SLOTS, "decode"))
    reset_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = prefill.fn(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    flash = step_launches()["flash_fwd"]
    big = alloc_cache(decode.abstract_args[1], device="cuda")
    for lb, la in zip(tree_leaves(big), tree_leaves(cache)):
        d = next((i for i, (a, b) in enumerate(zip(lb.shape, la.shape))
                  if a != b), 0)
        lb.narrow(d, 0, la.shape[d]).copy_(la)
    rows = tree_leaves(big)[0].shape[1]
    del cache
    out = {"prefill": logits.cpu(), "decode": [], "tokens": []}
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    step_s = []
    for i in range(RING_DECODE_STEPS):
        pos = torch.full((SERVE_SLOTS,), P + i, dtype=torch.int32,
                         device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, big = decode.fn(params, big, tok, pos)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out["decode"].append(lg.cpu())
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out["tokens"].append(tok.cpu())
    del big
    torch.cuda.empty_cache()
    return out, {"prefill_s": prefill_s, "decode_step_s": step_s,
                 "flash_fwd_launches": flash, "cache_rows": rows,
                 "prefill_describe": prefill.describe}


def ring_checkpoint(torch, batches, mesh, directory):
    """GPT-2 Medium cut to ``RING_CKPT_LAYERS`` over the ranks (int8 wire,
    λ): 2 steps, ``save_checkpoint(mesh=)`` into ``directory``, one more
    step; a fresh backend's state restored from the archive
    (``restore_checkpoint(mesh=)``), ``resume(2)``, one step. The saved,
    restored, uninterrupted and resumed states' digests, save and restore
    seconds and the archive's bytes."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.backend import make_backend
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.optim import constant, momentum

    cfg, model, params = cut_gpt2_medium(torch, RING_CKPT_LAYERS)

    def backend():
        return make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                            optimizer=momentum(0.9), schedule=constant(LR),
                            fb_ratio=R, update_delay=1, use_pallas=True,
                            wire="int8", compensate=LAMBDA,
                            measure_drift=False, mesh=mesh)

    be = backend()
    st = be.init(None, params)
    for b in batches[:2]:
        st, _ = be.step(st, b)
    torch.cuda.synchronize()
    saved = tree_digest(torch, st)
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(st) if isinstance(x, torch.Tensor))
    t0 = time.perf_counter()
    path = save_checkpoint(str(directory), 2, st, mesh=mesh)
    save_s = time.perf_counter() - t0
    st, m = be.step(st, batches[2])
    after = (tree_digest(torch, st), float(m["loss"]))
    del st, be
    be2 = backend()
    fresh = be2.init(None, params)
    t0 = time.perf_counter()
    back = restore_checkpoint(str(directory), None, fresh, mesh=mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    restored = tree_digest(torch, back)
    be2.resume(2)
    back, m = be2.step(back, batches[2])
    resumed = (tree_digest(torch, back), float(m["loss"]))
    res = {"layers": cfg.num_layers, "save_s": save_s,
           "restore_s": restore_s, "state_bytes": state_bytes,
           "bytes_on_disk": os.path.getsize(path),
           "restored_equal": restored == saved,
           "resumed_equal": resumed == after,
           "resumed_loss": resumed[1]}
    del back, be2, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ring_tuning(mesh, path):
    """A backend over ``mesh`` with ``tuning=path`` (GPT-2 Medium's loss,
    nothing allocated or stepped): the schedule it resolved."""
    from repro_torch.configs import get_config
    from repro_torch.core.backend import make_backend
    from repro_torch.models import build_model
    from repro_torch.optim import constant, momentum

    model = build_model(get_config("gpt2-medium"))
    be = make_backend("prod", "layup", M=M, loss_fn=model.loss_fn,
                      optimizer=momentum(0.9), schedule=constant(LR),
                      use_pallas=True, wire="int8", compensate=LAMBDA,
                      mesh=mesh, tuning=path)
    return dict(be.schedule)


def ring_rank_main(argv) -> int:
    """One rank of train_ring (``--ring-rank r --ring-world n
    --ring-backend gloo|nccl --ring-dir d``): joins the group through the
    file store in ``d``, runs ``RING_RUNS`` and then the options over a
    ``WorkerMesh(M, dev, group)``, writes its results to ``d/rank<r>.json``
    and its serving logits to ``d/serve<r>.pt``."""
    import datetime

    opt = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(opt["--ring-rank"]), int(opt["--ring-world"])
    backend, ring_dir = opt["--ring-backend"], Path(opt["--ring-dir"])
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # gloo's TCP pairs on the loopback device: the machine has no other
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: a ring rank needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    dist.init_process_group(backend,
                            init_method=f"file://{ring_dir / 'store'}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = WorkerMesh(M, dev, dist.group.WORLD)
        cfg = get_config("gpt2-medium")
        model = build_model(cfg)
        params = model.init(seed=0, device=dev)
        batches = lm_batches(torch, cfg.vocab_size, RING_FAULT_STEPS, seed=0)
        batches = [{k: v.to(dev) for k, v in b.items()} for b in batches]
        runs, seconds = {}, {}
        for wire, overlap in RING_RUNS:
            res = ring_run(torch, model, params, batches[:RING_STEPS], wire,
                           overlap, mesh=mesh)
            res["transport"] = mesh.transport
            runs[f"{wire}/{'overlap' if overlap else 'monolithic'}"] = res
        seconds["runs"] = time.perf_counter() - t0
        options, memory = {}, {"runs_done": card_memory(torch)}
        t1 = time.perf_counter()
        serve, options["serve"] = ring_serve(torch, model, params, mesh)
        torch.save(serve, ring_dir / f"serve{rank}.pt")
        seconds["serve"] = time.perf_counter() - t1
        del params, serve
        gc.collect()
        torch.cuda.empty_cache()
        _, cut, cut_params = cut_gpt2_medium(torch, RING_CUT_LAYERS)
        memory["cut_model"] = card_memory(torch)
        t1 = time.perf_counter()
        options["faults"] = ring_faults_run(torch, cut, cut_params, batches,
                                            mesh)
        seconds["faults"] = time.perf_counter() - t1
        memory["faults_done"] = card_memory(torch)
        t1 = time.perf_counter()
        options["streams"] = ring_run(torch, cut, cut_params,
                                      batches[:RING_STEPS], "int8", True,
                                      mesh=mesh, streams=RING_STREAMS)
        seconds["streams"] = time.perf_counter() - t1
        del cut_params
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        options["tuning"] = ring_tuning(mesh, str(ring_dir.parent
                                                  / "record.json"))
        options["checkpoint"] = ring_checkpoint(
            torch, batches, mesh, ring_dir.parent / "ckpt" / backend)
        seconds["checkpoint"] = time.perf_counter() - t1
        for name in ("streams", "serve", "faults", "checkpoint"):
            options[name]["transport"] = mesh.transport
        out = {"rank": rank, "rows": list(mesh.rows), "device": dev,
               "runs": runs, "options": options, "seconds": seconds,
               "memory": memory, "total_s": time.perf_counter() - t0}
        (ring_dir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def ring_ranks(backend: str) -> list:
    """Start ``RING_WORLD`` ranks of this script over ``backend``, wait
    for them (``RING_TIMEOUT_S``; every one is killed on a failure) and
    return their results (each with its serving logits under
    ``"serve"``). A rank that fails fails the phase."""
    import shutil

    ring_dir = HERE / "build" / "ring" / backend
    shutil.rmtree(ring_dir, ignore_errors=True)
    ring_dir.mkdir(parents=True)
    procs, logs = [], []
    for rank in range(RING_WORLD):
        log = open(ring_dir / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--ring-rank",
             str(rank), "--ring-world", str(RING_WORLD), "--ring-backend",
             backend, "--ring-dir", str(ring_dir)],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(HERE)))
    deadline = time.monotonic() + RING_TIMEOUT_S
    try:
        while True:  # until all exit 0, one fails, or the deadline
            codes = [p.poll() for p in procs]
            if (all(c == 0 for c in codes) or any(c not in (None, 0)
                                                  for c in codes)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)
        failed = [(r, "timeout" if c is None else c)
                  for r, c in enumerate(codes) if c != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(HERE / "build" / "ring" / "ckpt" / backend,
                      ignore_errors=True)
    if failed:
        import torch

        print("train_ring: this process's memory", card_memory(torch),
              file=sys.stderr)
        for rank in range(RING_WORLD):
            tail = (ring_dir / f"rank{rank}.log").read_text()[-3000:]
            print(f"--- ring rank {rank} ({backend}) log tail ---\n{tail}",
                  file=sys.stderr)
        raise AssertionError(f"train_ring: {backend} rank failed {failed}")
    import torch

    out = []
    for r in range(RING_WORLD):
        res = json.loads((ring_dir / f"rank{r}.json").read_text())
        res["serve"] = torch.load(ring_dir / f"serve{r}.pt")
        out.append(res)
    return out


def hold_ring(ranks: list, stacked: dict, backend: str) -> None:
    """Every rank's run against the stacked run of its wire: the digests
    of its global rows and the losses bit for bit, Σw, skips, and each
    ring kernel's launches (once a group a step)."""
    for res in ranks:
        for key, run in res["runs"].items():
            want = stacked[key.split("/")[0]]
            hold_rows(run, want, res, f"{backend} {key}")
            check(run["launches"] == want["launches"],
                  f"train_ring {backend} rank {res['rank']} {key}: "
                  f"launches {run['launches']} != {want['launches']}")


def hold_rows(run: dict, want: dict, res: dict, what: str,
              keys=("losses", "weight_sum", "skips")) -> None:
    """A rank's row digests (at its global rows) and histories against a
    stacked run's, bit for bit."""
    for g, rows in run["digests"].items():
        got = dict(zip(res["rows"], rows))
        check(all(got[r] == want["digests"][g][r] for r in got),
              f"train_ring {what} rank {res['rank']}: group {g} digests "
              f"{rows} != {[want['digests'][g][r] for r in got]}")
    for k in keys:
        check(run[k] == want[k], f"train_ring {what} rank {res['rank']}: "
              f"{k} {run[k]} != {want[k]}")


def hold_ring_options(torch, ranks: list, stacked: dict,
                      backend: str) -> None:
    """The options' holds: streams against the stacked int8 run of the cut
    model (and its launches: #6, #7 once a group a step, flash a rank's
    half); the
    faulted run against the stacked faulted one (histories, counters,
    servers); prefill and decode within ``RING_SERVE_RTOL`` of the
    one-process step and the same greedy tokens; the tuned schedule equal
    on every rank and the record's; the checkpoint's restored and resumed
    states equal the saved and uninterrupted ones."""
    steps, L, layers = RING_STEPS, M // RING_WORLD, RING_CUT_LAYERS
    groups = len(stacked["int8_cut"]["digests"])
    for res in ranks:
        rank, opts = res["rank"], res["options"]
        what = f"{backend} rank {rank}"
        st = opts["streams"]
        hold_rows(st, stacked["int8_cut"], res, f"{backend} streams")
        flash = flash_want(steps * L * layers)
        want = {"quantize_plane": steps * groups,
                "dequant_mix": steps * groups, "gossip_mix": 0,
                "flash_attention": flash["fwd"],
                "flash_attention_bwd": flash["dq"] + flash["dkv"]}
        got = {k: st["kernel_launches"][k] for k in want}
        check(got == want, f"train_ring {what} streams: launches {got} != "
              f"{want}")
        f, wf = opts["faults"], stacked["faults"]
        hold_rows(f, wf, res, f"{backend} faults",
                  keys=("losses", "weight_sum", "skips", "peers_live",
                        "chaos"))
        check(f["resync_s"] and f["chaos"]["resyncs"] == 1,
              f"train_ring {what} faults: no resync {f['chaos']}")
        j = str(res["rows"][0])
        check(f["servers"][j] == wf["servers"][j],
              f"train_ring {what} faults: server of worker {j} "
              f"{f['servers'][j]} != {wf['servers'][j]}")
        check(f["snapshot_rows"] == res["rows"],
              f"train_ring {what}: snapshot rows {f['snapshot_rows']}")
        check(opts["tuning"] == stacked["tuning"],
              f"train_ring {what}: tuned schedule {opts['tuning']} != "
              f"{stacked['tuning']}")
        ck = opts["checkpoint"]
        check(ck["restored_equal"] and ck["resumed_equal"],
              f"train_ring {what} checkpoint: restored "
              f"{ck['restored_equal']}, resumed {ck['resumed_equal']}")
        sv, ws = res["serve"], stacked["serve"]
        check(opts["serve"]["flash_fwd_launches"]
              == stacked["serve_readings"]["flash_fwd_launches"],
              f"train_ring {what}: prefill flash launches "
              f"{opts['serve']['flash_fwd_launches']}")
        gaps = [rel_gap(torch, sv["prefill"], ws["prefill"])] + [
            rel_gap(torch, a, b) for a, b in zip(sv["decode"], ws["decode"])]
        opts["serve"]["max_rel_gap"] = max(gaps)
        check(max(gaps) <= RING_SERVE_RTOL,
              f"train_ring {what}: logits gaps {gaps} > {RING_SERVE_RTOL}")
        check(all(torch.equal(a, b) for a, b in zip(sv["tokens"],
                                                    ws["tokens"])),
              f"train_ring {what}: greedy tokens differ")
        check(opts["serve"]["cache_rows"] == SERVE_SLOTS // RING_WORLD,
              f"train_ring {what}: a rank's cache holds "
              f"{opts['serve']['cache_rows']} rows")


def ring_record(torch, path):
    """A tuning record of ``RING_TUNED`` keyed for M workers over
    ``RING_WORLD`` ranks on this card, saved at ``path``."""
    from repro_torch.launch import tuner

    key = tuner.make_key("gpt2-medium", tuner.mesh_descriptor(
        "cuda", M, world=RING_WORLD), "int8")
    rec = tuner.build_record([(tuner.Candidate(**RING_TUNED),
                               {"fwd": 1.0, "update": 1.0, "gossip": 1.0},
                               None)], key=key)
    rec.save(str(path))
    return key


def phase_train_ring(torch, smi):
    """The multi-process ring (docstring item 5j). Returns the phase's
    result (the kernels' launches by backend, rank and run)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg = get_config("gpt2-medium")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    batches = lm_batches(torch, cfg.vocab_size, RING_FAULT_STEPS, seed=0)
    stacked = {wire: ring_run(torch, model, params, batches[:RING_STEPS],
                              wire, False)
               for wire in RING_WIRES}
    groups = len(stacked["param"]["digests"])
    for wire in RING_WIRES:
        res = stacked[wire]
        want = {k: RING_STEPS * groups for k in RING_KERNELS[wire]}
        check(res["launches"] == want,
              f"train_ring stacked {wire}: launches {res['launches']} != "
              f"{want}")
        check(all(math.isfinite(v) for v in res["losses"])
              and abs(res["losses"][0] - init_loss(cfg)) < 0.5
              and all(abs(v - 1.0) <= 1e-5 for v in res["weight_sum"])
              and res["skips"] == [0.0] * RING_STEPS,
              f"train_ring stacked {wire}: losses {res['losses']}, "
              f"weight_sum {res['weight_sum']}, skips {res['skips']}")
    stacked_s = {"runs": time.perf_counter() - t0}
    t1 = time.perf_counter()
    serve, stacked["serve_readings"] = ring_serve(
        torch, model, params, WorkerMesh(M, "cuda"))
    stacked["serve"] = serve
    stacked_s["serve"] = time.perf_counter() - t1
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _, cut, cut_params = cut_gpt2_medium(torch, RING_CUT_LAYERS)
    stacked["int8_cut"] = ring_run(torch, cut, cut_params,
                                   batches[:RING_STEPS], "int8", False)
    stacked["faults"] = ring_faults_run(torch, cut, cut_params, batches)
    del cut_params, cut
    f = stacked["faults"]
    check(f["chaos"]["resyncs"] == 1 and f["peers_live"] == live_schedule(
        RING_FAULTS, RING_FAULT_STEPS)
        and all(abs(v - 1.0) <= 1e-5 for v in f["weight_sum"]),
        f"train_ring stacked faults: {f['chaos']}, peers_live "
        f"{f['peers_live']}, weight_sum {f['weight_sum']}")
    stacked_s["faults"] = time.perf_counter() - t1
    del batches
    record = HERE / "build" / "ring" / "record.json"
    record.parent.mkdir(parents=True, exist_ok=True)
    key = ring_record(torch, record)
    stacked["tuning"] = {"fb_ratio": RING_TUNED["R"],
                         "update_delay": RING_TUNED["D"],
                         "max_inflight_steps":
                             RING_TUNED["max_inflight_steps"],
                         "overlap": True}
    gc.collect()
    torch.cuda.empty_cache()
    result = {"stacked": {k: v for k, v in stacked.items() if k != "serve"},
              "stacked_s": stacked_s, "ranks": {}, "record_key": key,
              "memory_before_ranks": card_memory(torch)}
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2
                           else [])
    for backend in backends:
        t1 = time.perf_counter()
        ranks = ring_ranks(backend)
        hold_ring(ranks, stacked, backend)
        hold_ring_options(torch, ranks, stacked, backend)
        for res in ranks:
            del res["serve"]
            ring_option_lines(res, backend, smi)
        result["ranks"][backend] = ranks
        result[f"{backend}_s"] = time.perf_counter() - t1
    if "nccl" not in backends:
        result["nccl"] = (f"not run ({torch.cuda.device_count()} "
                          "device)")
    emit("train_ring", model=cfg.name, M=M, world=RING_WORLD,
         local_workers=M // RING_WORLD, steps=RING_STEPS, fb_ratio=R,
         update_delay=1, wires=RING_WIRES, held="digests, losses, Σw, "
         "skips and launches bit for bit against the stacked run; the "
         "options against theirs (docstring item 5j)",
         seconds=time.perf_counter() - t0, nvidia_smi=smi, **result)
    return result


def ring_option_lines(res: dict, backend: str, smi: str) -> None:
    """One line a rank and option run: its step times, staging, wire
    bytes, peak; the faulted run's resync seconds and bytes; the
    checkpoint's save and restore seconds; the card's name and limit."""
    keep = ("step_s", "staging_s", "wire_bytes_per_round", "peak_bytes",
            "resync_s", "kill_s", "resync_bytes", "layers", "save_s",
            "restore_s", "state_bytes", "bytes_on_disk", "prefill_s",
            "decode_step_s", "max_rel_gap", "transport", "fb_ratio",
            "update_delay", "max_inflight_steps", "overlap")
    for name, run in res["options"].items():
        emit("train_ring_option", backend=backend, rank=res["rank"],
             run=name, nvidia_smi=smi,
             **{k: v for k, v in run.items() if k in keep},
             seconds=res["seconds"].get(name))


def main(argv) -> int:
    if "--ring-rank" in argv:
        return ring_rank_main(argv)
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
    try:
        from repro_torch.configs import get_config
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
    flash, flash_families = phase_flash(torch)
    quant = phase_quantize(torch)
    norm_ssd = phase_norm_ssd(torch)
    profile = "--profile" in argv
    train, mono = phase_train(torch, profile=profile,
                              readings=remat_readings)
    train["phase"] = "train"
    phase_remat(torch, "train_remat", get_config("gpt2-medium"), M,
                lm_batches(torch, train["vocab"], TRAIN_STEPS, seed=0), train)
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
    t1 = time.perf_counter()
    model_path = phase_train_model_path(torch, train, smi)
    emit("model_path_phase", seconds=time.perf_counter() - t1)
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
    new_s = {}
    t1 = time.perf_counter()
    sim = phase_sim(torch)
    new_s["sim"] = time.perf_counter() - t1
    for name, fn in (("sim_prod", phase_sim_prod), ("tune", phase_tune),
                     ("checkpoint", phase_checkpoint)):
        t1 = time.perf_counter()
        res = fn(torch)
        new_s[name] = time.perf_counter() - t1
        if name == "tune":
            tune = res
    # the event phase runs in lock-step inside sim (sim_algo's "modeled")
    emit("slice_phases", seconds=new_s, total_s=sum(new_s.values()))
    moe_s = {}
    t1 = time.perf_counter()
    moe = phase_train_moe(torch, profile=profile)
    moe_s["train_moe"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    serve_moe = phase_serve_moe(torch)
    moe_s["serve_moe"] = time.perf_counter() - t1
    emit("moe_phases", seconds=moe_s, total_s=sum(moe_s.values()))
    fam, fam_s = {}, {}
    for name, fn in (
            ("train_hybrid", lambda t: phase_train_hybrid(t, profile)),
            ("serve_hybrid", lambda t: phase_serve_family(
                t, "serve_hybrid", hybrid_config())),
            ("train_vlm", lambda t: phase_train_vlm(t, profile)),
            ("serve_vlm", lambda t: phase_serve_family(
                t, "serve_vlm", get_config(VLM_NAME))),
            ("train_encdec", lambda t: phase_train_encdec(t, profile)),
            ("train_encdec_remat", lambda t: phase_remat(
                t, "train_encdec_remat", get_config(ENCDEC_NAME), ENCDEC_M,
                family_batches(t, get_config(ENCDEC_NAME), TRAIN_STEPS,
                               seed=0, workers=ENCDEC_M),
                fam["train_encdec"], order=("unwrapped",))),
            ("serve_encdec", phase_serve_encdec)):
        t1 = time.perf_counter()
        fam[name] = fn(torch)
        fam_s[name] = time.perf_counter() - t1
    emit("family_phases", seconds=fam_s, total_s=sum(fam_s.values()))
    ring = phase_train_ring(torch, smi)
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
    # the bf16 backward's summing kernel, #3's third launch where the dk/dv
    # grid is split (dkv_split > 1): its main path is the bf16 families'
    # steps, once a backward on the few-KV-head ones (MoE 4, Jamba 8,
    # Qwen2-VL 2 KV heads), never on Whisper's 20
    fam_runs = {"moe": moe, **{n: fam[f"train_{n}"]
                               for n in ("hybrid", "vlm", "encdec")}}
    sum_launches = {n: r["all_launches"]["flash_dkv_sum"]
                    for n, r in fam_runs.items()}
    for n, r in fam_runs.items():
        want = 0 if n == "encdec" else r["all_launches"]["flash_dkv"]
        check(sum_launches[n] == want, f"train_{n}: flash_dkv_sum launches "
              f"{sum_launches[n]} != {want}")
    rows.append({"name": "flash_dkv_sum", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention.cu",
                 "replaces": "src/repro/kernels/flash_attention.py:232",
                 "launches": sum(sum_launches.values()),
                 "family_launches": sum_launches,
                 **flash["flash_dkv_sum"]})
    # the sim phase's launches (#2-#4: the loss) and the tune phase's (the
    # cutouts and the tuned backend's step: #1-#4), on every row
    for row in rows:
        row["sim_launches"] = row_launches(sim["launches"], row["name"])
        row["tune_launches"] = row_launches(tune["launches"], row["name"])
    # the MoE step's launches (train_moe: #1-#4) and prefill_fn's on
    # serve_moe's hold (#2; one hold a dtype, the same count each)
    for row in rows[:4]:
        row["moe_launches"] = row_launches(moe["all_launches"], row["name"])
    rows[1]["moe_serve_launches"] = serve_moe["prefill_launches"]["fwd"]
    # #1 on the MoE step's own bf16 blocks buffer (past 2^31 elements)
    rows[0]["moe_blocks"] = moe["blocks_mix"]
    # the hybrid, VLM and encoder-decoder steps' launches (#1-#4), the
    # prefill launches of their serve phases (#2), #1 on the hybrid's
    # bf16 blocks buffer, and #2-#4 timed at the families' shapes
    for row in rows[:4]:
        for fam_name in ("hybrid", "vlm", "encdec"):
            row[f"{fam_name}_launches"] = row_launches(
                fam[f"train_{fam_name}"]["all_launches"], row["name"])
    for fam_name in ("hybrid", "vlm", "encdec"):
        rows[1][f"{fam_name}_serve_launches"] = fam[f"serve_{fam_name}"][
            "prefill_launches"]["fwd"]
    rows[0]["hybrid_blocks"] = fam["train_hybrid"]["blocks_mix"]
    # train_model_path's launches by route (#1-#4; lockstep's #1 is the
    # pure variant, the decoupled routes' the fused one)
    for row in rows[:4]:
        row["model_path_launches"] = {
            route: row_launches(c, row["name"])
            for route, c in model_path.items()}
    # train_ring's launches of #1 (param wire) and #6, #7 (int8 wire) by
    # backend, rank and run, and of #1-#4, #6, #7 on the options' runs
    # (streams, faults, prefill: #2)
    for row in rows:
        if any(row["name"] in ks for ks in RING_KERNELS.values()):
            row["ring_launches"] = {
                b: {res["rank"]: {k: run["launches"].get(row["name"])
                                  for k, run in res["runs"].items()
                                  if row["name"] in run["launches"]}
                    for res in ranks}
                for b, ranks in ring["ranks"].items()}
        if row["name"] in RING_ROWS:
            row["ring_option_launches"] = {
                b: {res["rank"]: {
                    **{k: res["options"][k]["kernel_launches"][row["name"]]
                       for k in ("streams", "faults")},
                    "prefill": (res["options"]["serve"]["flash_fwd_launches"]
                                if row["name"] == "flash_attention" else 0)}
                    for res in ranks}
                for b, ranks in ring["ranks"].items()}
    for row, kind in zip(rows[1:4], ("fwd", "bwd", "trainable")):
        row["family_shapes"] = [
            {"shape": c["shape"], "causal": c["causal"], "dtype": c["dtype"],
             **c[kind]} for c in flash_families]
    print(json.dumps({"kernels": rows}), flush=True)
    emit("done", wall_s=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
