"""device_idle_share: 1 − (union of the device events' intervals, merged
over streams) / the profiled steps' wall time, in percent."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
