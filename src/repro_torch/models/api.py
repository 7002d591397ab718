"""Model API of the port, after ``repro.models.api.LM``: one entry point
per family (dense, moe and vlm: ``transformer``, hybrid: ``rglru``, ssm:
``xlstm``, audio: ``whisper``) and the shared causal LM loss.

Usage:
    lm = LM(cfg)
    params = lm.init(torch.Generator(device).manual_seed(0), device=device)
    logits, aux = lm.forward_train(params, batch)      # remat=True
    loss = lm.loss(params, batch)
    cache = lm.init_cache(batch_size, max_len, device=device)
    logits, cache = lm.prefill(params, batch, cache)
    logits, cache = lm.decode_step(params, token, cache)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, transformer, whisper, xlstm
from repro_torch.models import sharding as SH
from repro_torch.models.params import init_from_specs

_FAMILY_MODULES = {"dense": transformer, "moe": transformer,
                   "vlm": transformer, "audio": whisper, "hybrid": rglru,
                   "ssm": xlstm}

MOE_AUX_WEIGHT = 0.01


def family_module(cfg: ModelConfig):
    """The module that implements ``cfg``'s family."""
    return _FAMILY_MODULES[cfg.family]


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

    def _check_rules(self):
        """Raise under sharding rules for a family the multi-device layers
        do not cover yet, rather than run it unsharded."""
        if SH.active() and self.cfg.family not in SH.SHARDED_FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: the {self.cfg.family} family under "
                "sharding rules comes with ROADMAP A12")

    # -- params / cache ------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """Random weights with the JAX package's distributions, drawn from
        ``generator`` (which lives on ``device``)."""
        return init_from_specs(self.mod.param_specs(self.cfg), generator,
                               dtype, resolve_device(device))

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   window: Optional[int] = None, device=None):
        self._check_rules()
        return self.mod.init_cache(self.cfg, batch, max_len, dtype,
                                   window=window,
                                   device=resolve_device(device))

    # -- forward passes ------------------------------------------------------
    def forward_train(self, params, batch, *, window=None, remat=True):
        """Full-sequence forward; ``remat`` recomputes each layer group's
        activations in the backward rather than keeping them."""
        self._check_rules()
        return self.mod.forward_train(params, self.cfg, batch,
                                      window=window, remat=remat)

    def prefill(self, params, batch, cache, *, window=None):
        self._check_rules()
        return self.mod.prefill(params, self.cfg, batch, cache,
                                window=window)

    def decode_step(self, params, token, cache, *, window=None):
        self._check_rules()
        return self.mod.decode_step(params, self.cfg, token, cache,
                                    window=window)

    # -- losses ---------------------------------------------------------------
    def loss(self, params, batch, *, window=None, remat=True):
        """Causal LM loss: tokens predict labels; labels < 0 are masked."""
        nll, count, aux = self.loss_terms(params, batch, window=window,
                                          remat=remat)
        return nll / count.clamp(min=1.0) + MOE_AUX_WEIGHT * aux

    def loss_terms(self, params, batch, *, window=None, remat=True):
        """(the summed NLL of the unmasked labels, their count, the MoE FFNs'
        aux loss): ``loss`` is sum / max(count, 1) + MOE_AUX_WEIGHT aux. A
        sharded step sums the first two over the batch's ranks."""
        logits, aux = self.forward_train(params, batch, window=window,
                                         remat=remat)
        labels = batch["labels"]
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long()
                            )[..., 0].float()
        mask = (labels >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum(), aux
