"""Plain PyTorch flash attention: the whole ``layers.gqa_attention`` contract.

The CPU path of ``ops.flash_attention`` and the version the CUDA kernel is
held against on the card. Math in fp32, output in q.dtype, masked scores
set to the reference's finite -1e30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool,
                        window: Optional[int] = None, q_pos_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd), K | Hq. Returns
    (B, Sq, Hq, hd). Query row i sits at absolute position q_pos_offset + i."""
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = Hq // K
    qf = q.reshape(B, Sq, K, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    qpos = q_pos_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
