"""The port's core: layer partition and flat plane (``layerview``), the
DistAlgorithm family and the sim trainer (``api`` and one module per
algorithm), the drift diagnostics, the event simulator and the
TrainerBackend protocol over the sim, event and prod backends
(``backend``)."""
