"""The analytic cost terms, the roofline report's record and the stage
floors (port of ``analytic_costs``, ``model_flops``, ``RooflineReport`` and
``stage_floors`` of ``repro/launch/analysis.py``: plain arithmetic, the
reference's conventions unchanged), with the H100 SXM's data-sheet rates in
place of the TPU's.

``parse_collectives``, ``cpu_residual_artifact_bytes``, ``memory_report``
and ``analyze`` read HLO text or XLA's compiled reports and have no analogue
in the port; a caller on the card fills a report's ``t_compute``,
``t_memory`` and ``t_collective`` from the rates below.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

# H100 SXM data sheet: dense bf16 on the tensor cores, float32 outside them
# (SIMT), HBM3, and NVLink 4 per direction (900 GB/s both ways)
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9

# the reference's names for the three roofline rates
PEAK_FLOPS = BF16_FLOPS_PER_S
HBM_BW = HBM_BYTES_PER_S
ICI_BW = NVLINK_BYTES_PER_S


@dataclass
class RooflineReport:
    arch: str = ""
    shape: str = ""
    algo: str = ""
    mesh: str = ""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_wire_bytes: float = 0.0
    collectives: Dict[str, Dict] = field(default_factory=dict)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    model_flops_total: float = 0.0
    model_flops_per_device: float = 0.0
    useful_ratio: float = 0.0
    memory: Dict[str, float] = field(default_factory=dict)
    xla_raw: Dict[str, float] = field(default_factory=dict)
    detail: Dict[str, Dict] = field(default_factory=dict)
    notes: str = ""

    def to_dict(self):
        return asdict(self)


def stage_floors(report, *, R: int = 1) -> Dict[str, float]:
    """Per-stage roofline lower bounds for the decoupled stage schedule,
    consumed by the autotuner's scorer (``launch/tuner.py``).

    A train step is priced at fwd + 2×bwd + the remat fwd (every block of
    the backward slice is recomputed, ``transformer.remat_block``, as in
    the reference), so one forward pass is ~1/4 and the backward+update
    tail ~3/4 of the device term, the
    binding roof of compute vs memory. With R slices the forward work is
    split R ways, so the per-slice floor divides by R. The gossip floor is
    the collective term unchanged.

    Accepts a :class:`RooflineReport` or its ``to_dict()`` form."""
    if hasattr(report, "t_compute"):
        t_comp = float(report.t_compute)
        t_mem = float(report.t_memory)
        t_coll = float(report.t_collective)
    else:
        t_comp = float(report.get("t_compute", 0.0))
        t_mem = float(report.get("t_memory", 0.0))
        t_coll = float(report.get("t_collective", 0.0))
    dev = max(t_comp, t_mem)
    R = max(int(R), 1)
    return {"fwd": 0.25 * dev / R, "update": 0.75 * dev, "gossip": t_coll}


# ---------------------------------------------------------------------------
# analytic per-device cost model
# ---------------------------------------------------------------------------


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pad(x: int, n: int) -> int:
    """Per-shard size of a dim of ``x`` padded over ``n`` shards."""
    return _ceil_div(x, n)


def analytic_costs(cfg, shape, *, n_model: int, n_workers: int,
                   algo: str = "layup") -> Dict:
    """Per-device FLOPs and minimum HBM bytes for one step.

    Conventions: dense/attention matmul flops = 2·m·n·k; causal attention
    counts the block-skipped (≈half) cost; MoE includes the capacity padding
    factor; train = fwd + 2×bwd + 1×remat-fwd for the layers (the port's
    ``remat_block`` recomputes every block in the backward, as the
    reference's does; 3× for embed/unembed, outside remat); bf16 = 2
    bytes. ``n_model`` shards the
    heads, vocabulary and FFN dims; ``n_workers`` the batch (one device
    running all M stacked workers is ``n_workers=1``)."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    dt = 2  # bf16

    B_loc = _pad(B, n_workers)
    d = cfg.d_model
    hd = cfg.head_dim
    hq_loc = _pad(cfg.num_heads, n_model) if cfg.num_heads else 0
    hkv_loc = _pad(cfg.num_kv_heads, n_model) if cfg.num_kv_heads else 0
    v_loc = _pad(cfg.vocab_size, n_model)
    ffn_loc = _pad(cfg.d_ff, n_model) if cfg.d_ff else 0

    if kind == "train":
        Sq = S
        ctx = (min(cfg.sliding_window, S) if cfg.sliding_window
               else S / 2)  # causal block-skip
        layer_mult = 4.0  # fwd + 2 bwd + remat fwd
        head_mult = 3.0   # embed/unembed outside remat
    elif kind == "prefill":
        Sq = S
        ctx = min(cfg.sliding_window, S) if cfg.sliding_window else S / 2
        layer_mult = head_mult = 1.0
    else:  # decode
        Sq = 1
        ctx = min(cfg.sliding_window, S) if cfg.sliding_window else S
        layer_mult = head_mult = 1.0

    T_loc = B_loc * Sq  # tokens per worker (the model axis shards dims)

    flops = {}
    byts = {}

    def attn_layer():
        proj = 2 * T_loc * d * (hq_loc + 2 * hkv_loc) * hd \
            + 2 * T_loc * hq_loc * hd * d
        score = 2 * T_loc * ctx * hq_loc * hd * 2  # qk + pv
        f = proj + score
        # bytes: read h, write q/k/v, stream the scores on chip, write out
        b = dt * (2 * T_loc * d + T_loc * (hq_loc + 2 * hkv_loc) * hd
                  + T_loc * hq_loc * hd)
        if kind == "decode":
            # the KV-cache read dominates: ctx slots × kv heads
            b += dt * 2 * B_loc * ctx * hkv_loc * hd
        elif kind == "prefill":
            b += dt * 2 * T_loc * hkv_loc * hd  # cache write
        return f, b

    def mlp_layer():
        f = 2 * T_loc * d * 3 * ffn_loc
        b = dt * (2 * T_loc * d + 3 * T_loc * ffn_loc)
        return f, b

    def moe_layer():
        E = cfg.num_experts
        k = cfg.experts_per_token
        dff = cfg.expert_d_ff()
        cap = cfg.capacity_factor
        # the expert axis (E % n_model == 0) or the per-expert dff on the
        # model axis: both divide the expert compute
        if E % n_model == 0:
            shard = n_model
        elif dff % n_model == 0:
            shard = n_model
        else:
            shard = 1  # fully replicated fallback
        f = 2 * T_loc * d * E  # router
        f += 2 * (T_loc * k * cap) * d * 3 * dff / shard
        # bytes: tokens in/out of buffers + local expert weights + router
        b = dt * (4 * T_loc * d + 3 * E * d * dff / shard)
        return f, b

    def ssm_layer():
        di_loc = _pad(cfg.d_inner, n_model)
        n = cfg.ssm_state
        h_loc = _pad(cfg.ssm_heads, n_model)
        p = cfg.ssm_head_dim
        chunk = min(128, Sq)
        f = 2 * T_loc * d * (2 * di_loc + h_loc)  # z, x, dt proj
        f += 2 * T_loc * d * 2 * n
        f += 2 * T_loc * (di_loc + 2 * n) * cfg.ssm_conv
        if kind == "decode":
            f += 2 * B_loc * h_loc * n * p * 2  # recurrent update + output
        else:
            f += 2 * T_loc * chunk * n          # C·B
            f += 2 * T_loc * chunk * h_loc * p  # intra
            f += 2 * 2 * T_loc * n * h_loc * p  # states + inter
        f += 2 * T_loc * di_loc * d  # out proj
        b = dt * (2 * T_loc * d + 4 * T_loc * di_loc)
        if kind == "decode":
            b += dt * 2 * B_loc * h_loc * n * p  # state read+write
        return f, b

    f_layers = b_layers = 0.0
    for l in range(cfg.num_layers):
        if cfg.family in ("ssm", "hybrid") and not cfg.is_attn_layer(l):
            f, b = ssm_layer()
        else:
            f, b = attn_layer()
            if cfg.enc_dec:  # cross attention (ctx = enc_seq)
                f2 = (2 * T_loc * d * (hq_loc + 2 * hkv_loc) * hd
                      + 2 * T_loc * hq_loc * hd * d
                      + 2 * T_loc * cfg.enc_seq * hq_loc * hd * 2)
                f += f2
                b += dt * (2 * T_loc * d + T_loc * hq_loc * hd)
        f_layers += f
        b_layers += b
        if cfg.d_ff or cfg.num_experts:
            if cfg.is_moe_layer(l):
                f, b = moe_layer()
            else:
                f, b = mlp_layer()
            f_layers += f
            b_layers += b

    if cfg.enc_dec:  # encoder (train/prefill; decode reads the cross cache)
        if kind != "decode":
            Te = B_loc * cfg.enc_seq
            fe = (2 * Te * d * (hq_loc + 2 * hkv_loc) * hd
                  + 2 * Te * hq_loc * hd * d
                  + 2 * Te * cfg.enc_seq * hq_loc * hd * 2
                  + 2 * Te * d * 3 * ffn_loc)
            f_layers += fe * cfg.enc_layers
            b_layers += dt * 5 * Te * d * cfg.enc_layers

    flops["layers"] = f_layers * layer_mult
    byts["activations"] = b_layers * (3.0 if kind == "train" else 1.0)

    f_head = 2 * T_loc * d * v_loc
    flops["unembed"] = f_head * head_mult
    byts["logits"] = 4 * T_loc * v_loc * (2 if kind == "train" else 1)

    p_dev = cfg.param_counts()["total"] / (n_model * 1.0)
    if kind == "train":
        # read fwd + bwd + remat, write grads, opt read+write (p, m),
        # gossip/all-reduce read+write
        byts["params"] = p_dev * dt * 9
        flops["optimizer"] = p_dev * 8  # momentum + update + gossip mix
    else:
        byts["params"] = p_dev * dt
        flops["optimizer"] = 0.0

    total_f = sum(flops.values())
    total_b = sum(byts.values())
    return {
        "flops_per_device": total_f,
        "bytes_per_device": total_b,
        "flops_detail": flops,
        "bytes_detail": byts,
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N(_active)·tokens for train, 2·N·tokens for
    inference."""
    n = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
