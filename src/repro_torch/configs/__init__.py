from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      reduced, register)

__all__ = ["ModelConfig", "get_config", "list_configs", "reduced",
           "register"]
