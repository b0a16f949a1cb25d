"""PyTorch/CUDA port of the PD-ASGD reproduction (``repro``).

The package mirrors ``repro``'s subpackage layout and function names, so the
counterpart of ``repro/<sub>/<mod>.py::fn`` is ``repro_torch/<sub>/<mod>.py::fn``.
It imports ``torch`` and ``numpy`` only. Entry points take an explicit
``device``: ``None`` means ``"cuda"``, and a missing CUDA device is an error,
never a silent fall back to the CPU. The CPU runs only when the caller passes
``device="cpu"`` (the parity tests do).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
