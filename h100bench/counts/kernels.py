"""Least time of a kernel's work, the larger of its operations over the
card's rate for them and its bytes over HBM bandwidth (each input read
once, each output written once). Copied from the port's measurement script
and frozen; times in seconds."""
from __future__ import annotations

from typing import Sequence

from h100bench.counts.peaks import (BF16_FLOPS_PER_S,
                                    F32_ACCURATE_FLOPS_PER_S,
                                    F32_SIMT_FLOPS_PER_S, HBM_BYTES_PER_S)


def _bound(flops: float, nbytes: float, rate: float) -> float:
    return max(flops / rate, nbytes / HBM_BYTES_PER_S)


def attention_bound_s(B: int, H: int, Hkv: int, S: int, D: int,
                      itemsize: int, kind: str) -> float:
    """Causal flash attention over (B, H, S, D). Operations over the
    visible pairs: forward QKᵀ and PV, 4·D a pair; backward S, dP, dV, dK
    and dQ, 10·D a pair, plus delta = rowsum(do·o), 2·D a row. Bytes:
    forward q, k, v in, o and the f32 lse out; backward q, k, v, o, do and
    lse in, dq, dk, dv out. Rate: 3xTF32 (165 TFLOP/s) for f32 operands,
    the bf16 tensor-core rate for bf16."""
    pairs = B * H * S * (S + 1) // 2
    nq, nkv = B * H * S * D * itemsize, B * Hkv * S * D * itemsize
    nlse, delta = B * H * S * 4, 2 * B * H * S * D
    flops, nbytes = {
        "fwd": (4 * D * pairs, 2 * nq + 2 * nkv + nlse),
        "bwd": (10 * D * pairs + delta, 4 * nq + 4 * nkv + nlse),
    }[kind]
    rate = F32_ACCURATE_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
    return _bound(flops, nbytes, rate)


def mix_bound_s(numels: Sequence[int], itemsize: int, rows: int) -> float:
    """gossip_mix with the update, α·x + β·recv + u, over buffers of
    ``numels`` elements each (all ``rows`` worker rows): x, recv and u read
    and the output written, plus α and β a row; 4 FLOPs an element at the
    float32 rate."""
    n = sum(numels)
    return _bound(4 * n, 4 * n * itemsize + 8 * len(numels) * rows,
                  F32_SIMT_FLOPS_PER_S)
