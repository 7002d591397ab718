"""Plain PyTorch RG-LRU scan: the sequential recurrence in fp32, as
``repro.kernels.rglru_scan.ref``.

The CPU path of ``ops.rglru_scan`` and the version the CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(log_a, x, h0):
    """h_t = exp(log_a_t) * h_{t-1} + x_t, h_{-1} = h0.

    log_a, x: (B, S, W); h0: (B, W). Returns h: (B, S, W) in fp32.
    """
    a = torch.exp(log_a.float())
    xf = x.float()
    h = h0.float()
    out = torch.empty_like(xf)
    for t in range(xf.shape[1]):
        h = a[:, t] * h + xf[:, t]
        out[:, t] = h
    return out
