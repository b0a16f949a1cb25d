"""mfu: model FLOPs a step (``counts.flops.step_flops``: slice 0's
backward only, no recompute) times the unprofiled steps of the traced
window, over their host-clock time, over the matrix-product peak of the
configuration's dtype (bf16 989 TFLOP/s; float32 165, the 3xTF32 rate), in
percent."""
from h100bench.counts.flops import step_flops
from h100bench.counts.peaks import step_peak


def read(ctx):
    if not ctx["unprofiled_steps"]:
        return None
    flops = step_flops(ctx["model"], ctx["traffic"]) * ctx["unprofiled_steps"]
    return 100.0 * flops / ctx["unprofiled_s"] / step_peak(
        ctx["model"]["dtype"])
