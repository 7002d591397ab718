"""Training loop, after ``repro.training.train_loop``: a train step and a
small single-device training entry point.

The step runs eagerly: ``LM.loss`` forward, ``torch.autograd.grad`` over
the parameter leaves (so no second set of ``.grad`` buffers lives on past
the update), then AdamW in place. On the card the loss's attention and
RG-LRU scans run the hand-written kernels forward and backward; on the CPU
autograd differentiates their plain versions.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import LM, resolve_device
from repro_torch.models.params import flatten, map_leaves, rebuild
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import TokenStream
from repro_torch.training.optimizer import AdamWConfig, apply_updates, init_state


def make_train_step(lm: LM, opt_cfg: AdamWConfig, *, window=None,
                    remat=True):
    def train_step(params, opt_state, batch):
        leaves = [p.requires_grad_() for p in flatten(params).values()]
        loss = lm.loss(params, batch, window=window, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        params, opt_state, metrics = apply_updates(
            opt_cfg, params, rebuild(params, grads), opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics
    return train_step


def train(cfg: ModelConfig, *, steps: int = 50, batch_size: int = 8,
          seq_len: int = 128, seed: int = 0, param_dtype=torch.float32,
          opt_cfg: Optional[AdamWConfig] = None,
          ckpt_path: Optional[str] = None, log_every: int = 10, remat=True,
          device=None, on_step: Optional[Callable] = None):
    """End-to-end single-device training (used by the launcher, the tests
    and the chip smoke), on CUDA unless ``device`` names another.
    ``on_step(step, metrics)``, where given, is called after each step,
    with the step's host seconds (from its batch to its loss on the host,
    which waits for the step's work on the device) in ``metrics["step_s"]``.
    Returns (params, the loss of every step); the parameters come back
    detached."""
    device = resolve_device(device)
    lm = LM(cfg)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(steps // 10, 1))
    params = lm.init(torch.Generator(device).manual_seed(seed),
                     dtype=param_dtype, device=device)
    opt_state = init_state(opt_cfg, params)
    data = TokenStream(cfg, seed=seed)
    step_fn = make_train_step(lm, opt_cfg, remat=remat)
    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 data.batch(batch_size, seq_len).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if on_step is not None:
            on_step(step, {**metrics, "step_s": time.perf_counter() - t_step})
        if log_every and (step % log_every == 0 or step == steps - 1):
            dt = time.perf_counter() - t0
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"gnorm {float(metrics['grad_norm']):6.3f} "
                  f"({dt:6.1f}s)", flush=True)
    params = map_leaves(lambda p: p.detach().requires_grad_(False), params)
    if ckpt_path:
        ckpt.save(ckpt_path, {"params": params}, step=steps)
    return params, history
