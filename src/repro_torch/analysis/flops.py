"""Analytic model FLOPs of a step, a copy of ``train_model_flops`` and
``step_model_flops`` in ``repro.analysis.hlo`` (pure Python; the HLO
parsing beside them there has no counterpart in the port).

The count is the JAX package's: 6 N D for a training step and 2 N a token
otherwise, N the config's ``active_param_count()``. That count undercounts
the xLSTM, whose full q/k/v projections it books as one head's (about
1.8x fewer parameters than the model holds; ROADMAP §C, mirrored from the
reference), and it leaves out attention's own products.
"""
from __future__ import annotations


def train_model_flops(cfg, tokens: int) -> float:
    """6*N*D with N = active params (fwd+bwd)."""
    return 6.0 * cfg.active_param_count() * tokens


def step_model_flops(cfg, shape) -> float:
    if shape.kind == "train":
        return train_model_flops(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    return 2.0 * cfg.active_param_count() * shape.global_batch   # one token
