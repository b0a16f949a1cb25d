"""kernels_per_step: CUDA kernels of a profiled step (device events that
are not copies or fills): the work host dispatch does."""
from h100bench.trace import COPY


def read(ctx):
    tr = ctx["trace"]
    n = sum(1 for name, _, _ in tr.kernels if not COPY.search(name))
    return n / tr.steps if n else None
