from repro_torch.models.api import LM, resolve_device

__all__ = ["LM", "resolve_device"]
