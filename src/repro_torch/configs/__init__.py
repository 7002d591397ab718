from repro_torch.configs.base import ARCH_ALIASES, ModelConfig, get_config

__all__ = ["ARCH_ALIASES", "ModelConfig", "get_config"]
