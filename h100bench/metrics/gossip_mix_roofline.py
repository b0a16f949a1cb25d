"""gossip_mix_roofline: the least time of the profiled steps' gossip_mix
launches (one a layer group a step, with the update; all workers' rows;
``counts.kernels.mix_bound_s``), over their summed device time, in
percent."""
from h100bench.counts.kernels import mix_bound_s


def read(ctx):
    tr, m, job = ctx["trace"], ctx["model"], ctx["traffic"]
    launches = tr.by_name(r"^_mix_kernel")
    if not launches:
        return None
    M, sizes = job["workers"], list(ctx["groups"].values())
    item = 4 if m["dtype"] == "float32" else 2
    rounds = len(launches) / len(sizes)
    least = rounds * mix_bound_s([M * n for n in sizes], item, M)
    return 100.0 * least / (sum(d for _, _, d in launches) / 1e9)
