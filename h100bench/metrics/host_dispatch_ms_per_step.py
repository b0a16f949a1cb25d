"""host_dispatch_ms_per_step: host milliseconds inside the port's ``step``
spans less the time in the trace's CUDA runtime calls within them, per
profiled step: the Python and ATen time a step needs, which sets the pace
once it exceeds the device's (``h100bench.lanes``)."""
from h100bench.lanes import host_dispatch_ms_per_step


def read(ctx):
    return host_dispatch_ms_per_step(ctx["trace"])
