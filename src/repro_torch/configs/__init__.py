from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig, ShapeConfig,
                                      get_config, input_specs, list_configs,
                                      reduced, register)

__all__ = ["INPUT_SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "input_specs", "list_configs", "reduced", "register"]
