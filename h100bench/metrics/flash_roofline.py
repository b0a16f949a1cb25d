"""flash_roofline: the least time of every flash attention launch of the
profiled steps (forward: ``flash_fwd*``; backward: a ``flash_bwd_dq*``
launch with its dk/dv kernels, ``flash_bwd_dkv*`` and ``flash_dkv_sum``)
at the cell's shapes (``counts.kernels.attention_bound_s``: a forward
slice's sequences, every head, causal), over their summed device time, in
percent."""
from h100bench.counts.kernels import attention_bound_s


def read(ctx):
    tr, m, job = ctx["trace"], ctx["model"], ctx["traffic"]
    fwd = tr.by_name(r"flash_fwd")
    dq = tr.by_name(r"flash_bwd_dq")
    bwd_rest = tr.by_name(r"flash_bwd_dkv|flash_dkv_sum")
    if not fwd and not dq:
        return None
    item = 4 if m["dtype"] == "float32" else 2
    shape = (job["sequences_per_worker"] // job["fb_ratio"], m["num_heads"],
             m["num_kv_heads"], job["sequence_length"], m["head_dim"], item)
    least = (len(fwd) * attention_bound_s(*shape, "fwd")
             + len(dq) * attention_bound_s(*shape, "bwd"))
    spent = sum(d for _, _, d in fwd + dq + bwd_rest) / 1e9
    return 100.0 * least / spent
