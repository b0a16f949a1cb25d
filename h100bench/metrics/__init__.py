"""Per-layer metric readers, one module a metric, named as the metric.

Each module's ``read(ctx)`` returns the metric's value, or ``None`` where
its run has nothing for it to read (the harness then leaves the metric out
of the result line). ``ctx`` holds: ``trace`` (:class:`h100bench.trace.
Trace` of the profiled steps), ``unprofiled_steps`` and ``unprofiled_s``
(the rest of the traced window, timed on the host clock), ``model`` and
``traffic`` (the cell's files) and ``groups`` ({layer group: elements a
worker})."""
import importlib


def read(name: str, ctx: dict):
    return importlib.import_module(f"h100bench.metrics.{name}").read(ctx)
