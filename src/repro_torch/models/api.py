"""Model API of the port, after ``repro.models.api.LM``: one entry point
per family (dense and vlm: ``transformer``, hybrid: ``rglru``, ssm:
``xlstm``) and the shared causal LM loss.

Usage:
    lm = LM(cfg)
    params = lm.init(torch.Generator(device).manual_seed(0), device=device)
    logits, aux = lm.forward_train(params, batch)
    loss = lm.loss(params, batch)
    cache = lm.init_cache(batch_size, max_len, device=device)
    logits, cache = lm.prefill(params, batch, cache)
    logits, cache = lm.decode_step(params, token, cache)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer, xlstm
from repro_torch.models.params import init_from_specs

_FAMILY_MODULES = {"dense": transformer, "vlm": transformer,
                   "hybrid": rglru, "ssm": xlstm}
# family -> ROADMAP item that ports it
_PENDING = {"moe": "A5", "audio": "A9"}

MOE_AUX_WEIGHT = 0.01


def family_module(cfg: ModelConfig):
    """The module that implements ``cfg``'s family; raises, naming the
    ROADMAP item, for what the port does not carry yet."""
    mod = _FAMILY_MODULES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP item {_PENDING[cfg.family]})")
    if mod is transformer:
        transformer.check_supported(cfg)
    return mod


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
        self.mod = family_module(cfg)
        self.cfg = cfg

    # -- params / cache ------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """Random weights with the JAX package's distributions, drawn from
        ``generator`` (which lives on ``device``)."""
        return init_from_specs(self.mod.param_specs(self.cfg), generator,
                               dtype, resolve_device(device))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   window: Optional[int] = None, device=None):
        return self.mod.init_cache(self.cfg, batch, max_len, dtype,
                                   window=window,
                                   device=resolve_device(device))

    # -- forward passes ------------------------------------------------------
    def forward_train(self, params, batch, *, window=None):
        return self.mod.forward_train(params, self.cfg, batch,
                                      window=window)

    def prefill(self, params, batch, cache, *, window=None):
        return self.mod.prefill(params, self.cfg, batch, cache,
                                window=window)

    def decode_step(self, params, token, cache, *, window=None):
        return self.mod.decode_step(params, self.cfg, token, cache,
                                    window=window)

    # -- losses ---------------------------------------------------------------
    def loss(self, params, batch, *, window=None):
        """Causal LM loss: tokens predict labels; labels < 0 are masked."""
        logits, aux = self.forward_train(params, batch, window=window)
        labels = batch["labels"]
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long()
                            )[..., 0].float()
        mask = (labels >= 0).float()
        loss = ((lse - gold) * mask).sum() / mask.sum().clamp(min=1.0)
        return loss + MOE_AUX_WEIGHT * aux
