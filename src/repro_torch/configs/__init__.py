from repro_torch.configs.base import (ARCH_ALIASES, ARCH_IDS, INPUT_SHAPES,
                                     InputShape, ModelConfig, get_config)

__all__ = ["ARCH_ALIASES", "ARCH_IDS", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "get_config"]
