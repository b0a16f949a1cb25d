"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
# float32-accurate products on the tensor cores: TF32 over the three
# products of 3xTF32. The peak that a float32 step is held to, so that no
# float32 implementation can read above 100%.
F32_ACCURATE_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
F32_SIMT_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def step_peak(dtype: str) -> float:
    """The matrix-product peak a step in ``dtype`` is held to."""
    return {"float32": F32_ACCURATE_FLOPS_PER_S,
            "bfloat16": BF16_FLOPS_PER_S}[dtype]
