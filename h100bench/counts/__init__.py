"""Operations and bytes from shapes: the model FLOPs of a training step and
the least work of each kernel that a roofline share is taken of. Frozen
with the benchmark; a later change to the program cannot move them."""
