"""Plain PyTorch RG-LRU scan: the sequential recurrence in fp32, as
``repro.kernels.rglru_scan.ref``.

The CPU path of ``ops.rglru_scan`` (autograd differentiates it there) and
the version the CUDA kernel is held against on the card; beside it the
plain backward that the CUDA backward is held against.
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


def reverse_scan_inputs(log_a, dy):
    """The backward's scan as the forward scan on reversed time: its
    (log_a', x', h0') are the decays shifted one step on and flipped in
    time, dy flipped, and a zero state; its output flipped back is the
    states' gradient g."""
    shifted = torch.cat([log_a[:, 1:], torch.zeros_like(log_a[:, :1])], 1)
    return (torch.flip(shifted, (1,)), torch.flip(dy, (1,)),
            torch.zeros_like(log_a[:, 0]))


def bwd_products(log_a, h0, y, g):
    """(d log_a, dx, dh0) from the states' gradient g: d log_a_t =
    g_t a_t h_{t-1} (h_{-1} = h0, h the forward's output y), dx = g,
    dh0 = a_0 g_0."""
    a = torch.exp(log_a)
    h_prev = torch.cat([h0[:, None], y[:, :-1]], 1)
    return g * a * h_prev, g, a[:, 0] * g[:, 0]


def rglru_scan_bwd_ref(log_a, h0, y, dy):
    """The scan's gradient by the plain scan run on reversed time:
    g_t = dy_t + a_{t+1} g_{t+1}, g_S = dy_S; then ``bwd_products``.
    Returns (d log_a, dx, dh0), fp32."""
    log_a, h0, y, dy = (t.float() for t in (log_a, h0, y, dy))
    g = torch.flip(rglru_scan_ref(*reverse_scan_inputs(log_a, dy)), (1,))
    return bwd_products(log_a, h0, y, g)
