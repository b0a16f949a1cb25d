"""dispatch_idle_ms_per_step: milliseconds of the trace's device idle
gaps inside the port's ``step`` spans, per profiled step: the card idle
while the host was inside the step (``h100bench.lanes``)."""
from h100bench.lanes import dispatch_idle_ms_per_step


def read(ctx):
    return dispatch_idle_ms_per_step(ctx["trace"])
