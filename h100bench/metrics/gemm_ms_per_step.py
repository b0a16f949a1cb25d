"""gemm_ms_per_step: device milliseconds a profiled step in matrix-product
kernels (cuBLAS and CUTLASS: the ``gemm`` family of
``h100bench.trace.FAMILIES``, names with gemm, gemv, xmma, cutlass, nvjet
or splitKreduce)."""
from h100bench.trace import family


def read(ctx):
    tr = ctx["trace"]
    ns = sum(d for name, _, d in tr.kernels if family(name) == "gemm")
    return ns / 1e6 / tr.steps if ns else None
