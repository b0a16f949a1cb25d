"""The decoupled PD-ASGD training step (``train``)."""
