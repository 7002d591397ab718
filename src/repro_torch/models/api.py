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
from repro_torch.models.vocab import vocab_block
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
        sharded step sums the first two over the batch's ranks. Where
        ``forward_train`` gives the rank's block of the vocabulary, the
        log-sum-exp and the gold logit are reduced over its blocks
        (``_block_terms``)."""
        logits, aux = self.forward_train(params, batch, window=window,
                                         remat=remat)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        if logits.shape[-1] == self.cfg.vocab_size:
            lse = torch.logsumexp(logits.float(), dim=-1)
            gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None]
                                .long())[..., 0].float()
        else:
            lse, gold = _block_terms(logits, labels, self.cfg)
        return ((lse - gold) * mask).sum(), mask.sum(), aux


def _block_terms(logits, labels, cfg):
    """(the log-sum-exp over the whole vocabulary, the gold logit) from
    this rank's block of the logits over the ``vocab`` axis, in fp32: m =
    the rows' max over the blocks (a MAX all-reduce, detached: the
    log-sum-exp does not depend on m), lse = m + log(the SUM over the
    blocks of sum exp(logits - m)); the gold logit from the block that
    holds the label, 0 from the others, summed. A masked label (< 0)
    takes its gold from no block."""
    axis = SH.rule("vocab")
    width = logits.shape[-1]
    lo = vocab_block(cfg, width)
    z = logits.float()
    with torch.no_grad():
        m = SH.all_reduce(z.amax(-1), axis, "max")
    lse = m + torch.log(SH.all_reduce(torch.exp(z - m[..., None]).sum(-1),
                                      axis))
    local = labels.long() - lo
    mine = (local >= 0) & (local < width)
    gold = torch.gather(z, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    return lse, SH.all_reduce(gold * mine, axis)
