"""bwd_ms_per_step: device milliseconds of the port's ``bwd`` lane spans
(``torch.autograd.grad`` of every worker's slice 0, the recompute of the
checkpointed blocks included), per profiled step (``h100bench.lanes``)."""
from h100bench.lanes import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx["trace"], "bwd")
