"""Layer partition, flat plane and the prod TrainerBackend of the port."""
