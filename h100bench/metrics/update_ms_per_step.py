"""update_ms_per_step: device milliseconds of the port's ``update`` lane
span (the FIFO, the nonfinite verdicts and selects, the optimizer), per
profiled step (``h100bench.lanes``)."""
from h100bench.lanes import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx["trace"], "update")
