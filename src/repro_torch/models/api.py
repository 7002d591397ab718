"""Model API of the port, after ``repro.models.api.LM`` (dense family).

Usage:
    lm = LM(cfg)
    params = lm.init(torch.Generator(device).manual_seed(0), device=device)
    logits, aux = lm.forward_train(params, batch)
    cache = lm.init_cache(batch_size, max_len, device=device)
    logits, cache = lm.prefill(params, batch, cache)
    logits, cache = lm.decode_step(params, token, cache)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        return torch.device("cuda")
    return torch.device(device)


class LM:
    def __init__(self, cfg: ModelConfig):
        transformer.check_supported(cfg)
        self.cfg = cfg

    # -- params / cache ------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        return transformer.init_params(self.cfg, generator, dtype,
                                       resolve_device(device))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   window: Optional[int] = None, device=None):
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      window=window,
                                      device=resolve_device(device))

    # -- forward passes ------------------------------------------------------
    def forward_train(self, params, batch, *, window=None):
        return transformer.forward_train(params, self.cfg, batch,
                                         window=window)

    def prefill(self, params, batch, cache, *, window=None):
        return transformer.prefill(params, self.cfg, batch, cache,
                                   window=window)

    def decode_step(self, params, token, cache, *, window=None):
        return transformer.decode_step(params, self.cfg, token, cache,
                                       window=window)
