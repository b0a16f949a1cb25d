"""Model FLOPs of one decoupled PD-ASGD training step.

Every token that enters a forward slice costs ``2·N`` (N the weights of
the matrix products a token passes through: the blocks' projections and
the tied unembedding; the embedding lookup is no product), and every token
of slice 0, the one slice that is backpropagated, ``4·N`` more. Attention
adds its score and value products over the visible (causal) pairs, the
SSD its chunked-scan products; each backward costs twice its forward.
The recompute of activation checkpointing is not model work and is not
counted. A multiply-add is 2 FLOPs.
"""
from __future__ import annotations


def matmul_params(m: dict) -> int:
    """N: weights a token multiplies in one forward pass.
    Dense: L·(d·H·hd + 2·d·Hkv·hd + H·hd·d + 3·d·d_ff) + d·V.
    SSM: L·(d·(2·d_inner + 2·N_state + heads) + d_inner·d) + d·V."""
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    if m["family"] == "dense":
        H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        per = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * m["d_ff"]
    elif m["family"] == "ssm":
        di = m["ssm_expand"] * d
        per = (d * (2 * di + 2 * m["ssm_state"] + di // m["ssm_head_dim"])
               + di * d)
    else:
        raise ValueError(f"no FLOP count for family {m['family']!r}")
    return L * per + d * V


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal mask leaves visible: S·(S+1)/2."""
    return S * (S + 1) // 2


def attention_flops(m: dict, S: int) -> int:
    """One sequence's forward attention products: QKᵀ and PV over the
    visible pairs, 4·hd FLOPs a pair a head, every layer:
    L·H·4·hd·S(S+1)/2."""
    return (m["num_layers"] * m["num_heads"] * 4 * m["head_dim"]
            * causal_pairs(S))


def ssd_flops(m: dict, S: int, Q: int = 128) -> int:
    """One sequence's forward SSD (chunked scan, chunks of Q, products over
    i >= j only, T = Q(Q+1)/2 pairs a chunk), every layer. Per chunk: C·Bᵀ
    2·T·N (shared over heads); per chunk and head: W·x 2·T·P, the decay
    weights 3·T, C·state and the state's ingest 2·Q·N·P each, the state's
    decay 2·N·P."""
    H = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    P, N = m["ssm_head_dim"], m["ssm_state"]
    T, nc = Q * (Q + 1) // 2, S // Q
    per = 2 * T * N * nc + H * nc * (2 * T * P + 3 * T + 4 * Q * N * P
                                      + 2 * N * P)
    return m["num_layers"] * per


def step_flops(m: dict, job: dict) -> int:
    """Model FLOPs of one step: M workers, B sequences of S a worker, R
    forward slices of which slice 0 is backpropagated."""
    M, B, S = job["workers"], job["sequences_per_worker"], \
        job["sequence_length"]
    R = job["fb_ratio"]
    seqs_fwd, seqs_bwd = M * B, M * B // R
    n = matmul_params(m)
    mixer = (attention_flops(m, S) if m["family"] == "dense"
             else ssd_flops(m, S))
    return (2 * n * seqs_fwd * S + 4 * n * seqs_bwd * S
            + mixer * seqs_fwd + 2 * mixer * seqs_bwd)
