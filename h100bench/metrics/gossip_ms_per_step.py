"""gossip_ms_per_step: device milliseconds of the port's ``gossip`` lane
span (the mix, the push-sum weights and the clock stamp), per profiled
step (``h100bench.lanes``)."""
from h100bench.lanes import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx["trace"], "gossip")
