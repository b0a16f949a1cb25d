"""fwd_ms_per_step: device milliseconds of the port's ``fwd`` lane spans
(``loss_fn`` of every forward slice of every worker), per profiled step
(``h100bench.lanes``)."""
from h100bench.lanes import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx["trace"], "fwd")
