from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          get_optimizer, momentum, sgd)
from repro_torch.optim.schedules import constant, cosine, linear_warmup_cosine

__all__ = ["Optimizer", "adamw", "apply_updates", "get_optimizer",
           "momentum", "sgd", "constant", "cosine", "linear_warmup_cosine"]
