"""Hand-written GPU kernels of the port (``gossip_mix``), their plain
PyTorch versions (``ref``) and the dispatch by device (``ops``)."""
