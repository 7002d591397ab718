"""AdamW with dtype-configurable state, after ``repro.training.optimizer``
(the same arithmetic, written out by hand rather than with ``torch.optim``):
a global-norm clip, warmup then cosine decay to 10% of the peak rate, bias
correction, and weight decay on leaves of two or more dims only. The
schedule, the powers and every update are computed in fp32; m and v are
kept in ``state_dtype`` (bf16 for the full-width models, as the JAX
package's production path), each leaf in its own dtype (the RG-LRU's
``lam`` stays fp32).

Parameters are the port's stacked trees, so a stacked (G, D) norm weight
has two dims and is decayed, exactly as the reference decays its stacked
leaves. Unlike the reference, ``apply_updates`` writes the new parameters
and moments into the given tensors in place, to hold one copy of each on
the card, and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.models.params import flatten, map_leaves

# Large leaves are updated, and their squares summed for the global norm,
# in slices of at most this many elements along dim 0. The update makes
# about seven fp32 temporaries of what it updates: done on a whole stacked
# MLP weight of Llama-3.1-8B, (32, 4096, 14336), they would take ~52 GB
# beside the 64 GB of bf16 parameters, gradients and moments. A slice's
# temporaries take ~0.27 GB each. The arithmetic is elementwise, so the
# numbers are those of a whole-leaf update.
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Any = torch.float32     # torch.bfloat16 for big models
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def lr_schedule(cfg: AdamWConfig) -> Callable:
    """step (an int or a tensor) -> the learning rate, an fp32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cosine = 0.5 * (1 + torch.cos(math.pi * frac))
        return cfg.lr * warm * (0.1 + 0.9 * cosine)
    return lr


def init_state(cfg: AdamWConfig, params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    device = next(iter(flatten(params).values())).device
    return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def slices(t: torch.Tensor):
    """Views of ``t`` along dim 0 of at most ``SLICE_ELEMENTS`` elements
    each (one row at least); ``t`` itself when it is that small."""
    if t.ndim == 0 or t.numel() <= SLICE_ELEMENTS:
        return (t,)
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return t.split(rows, dim=0)


def sum_squares(leaves) -> torch.Tensor:
    """The fp32 sum of the leaves' squares (None where there is none)."""
    total = None
    for x in leaves:
        for s in slices(x):
            part = torch.sum(torch.square(s.float()))
            total = part if total is None else total + part
    return total


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum_squares(leaves))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, *,
                  gnorm: Optional[torch.Tensor] = None):
    """One AdamW step, written into ``params`` and ``state``'s m and v in
    place. Returns (params, new state, metrics). ``gnorm`` is the global
    gradient norm where the caller computes it (a sharded step, over every
    rank's blocks); else the norm of ``grads``."""
    count = state["count"] + 1
    flat_g = flatten(grads)
    if gnorm is None:
        gnorm = global_norm(flat_g.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg)(count)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    flat_m, flat_v = flatten(state["m"]), flatten(state["v"])
    for key, p in flatten(params).items():
        decay = p.ndim >= 2                      # no decay on norms/bias
        for ps, gs, ms, vs in zip(slices(p), slices(flat_g[key]),
                                  slices(flat_m[key]), slices(flat_v[key])):
            g = gs.float() * scale
            m_new = cfg.b1 * ms.float() + (1 - cfg.b1) * g
            v_new = cfg.b2 * vs.float() + (1 - cfg.b2) * torch.square(g)
            step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
            if decay:
                step = step + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * step)
            ms.copy_(m_new)
            vs.copy_(v_new)
    new_state = {"m": state["m"], "v": state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
