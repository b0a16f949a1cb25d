"""Hand-written GPU kernels of the port (``gossip_mix`` in Triton; flash
attention, the int8 wire, ``rmsnorm`` and ``ssd_scan`` in CUDA C++ under
``csrc/``), their plain PyTorch versions (``ref``) and the dispatch by
device (``ops``)."""
