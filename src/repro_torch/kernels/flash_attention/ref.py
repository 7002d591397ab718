"""Plain PyTorch flash attention: the whole ``layers.gqa_attention`` contract.

The CPU path of ``ops.flash_attention`` (autograd differentiates it there)
and the version the CUDA kernel is held against on the card; beside it the
plain backward that the CUDA backward is held against. Math in fp32, output
in q.dtype, masked scores set to the reference's finite -1e30.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask(Sq: int, Skv: int, causal: bool, window: Optional[int],
          q_pos_offset: int, device):
    """(Sq, Skv): whether query row i (at q_pos_offset + i) admits key j."""
    qpos = q_pos_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool,
                        window: Optional[int] = None, q_pos_offset: int = 0,
                        return_lse: bool = False):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd), K | Hq. Returns
    (B, Sq, Hq, hd). Query row i sits at absolute position q_pos_offset + i.
    With ``return_lse`` also each row's logsumexp L of its masked, scaled
    scores, fp32 (B, Hq, Sq): what the kernels write for the backward."""
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = Hq // K
    qf = q.reshape(B, Sq, K, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    scores = scores.masked_fill(~_mask(Sq, Skv, causal, window,
                                       q_pos_offset, q.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    out = out.reshape(B, Sq, Hq, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool,
                            window: Optional[int] = None,
                            q_pos_offset: int = 0, lse=None):
    """The FlashAttention-2 backward, written out in fp32: given the
    forward's output ``o`` and its gradient ``do`` (B, Sq, Hq, hd), returns
    (dq, dk, dv) in the dtypes of q, k and v. P comes from the row
    logsumexp L (``lse``, (B, Hq, Sq), as the forward writes it, where
    given, as the kernel reads it; else formed here), D_i = sum dO_i O_i
    and dS = P (dP - D). The plain version the CUDA backward is held
    against."""
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = Hq // K
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, Sq, K, G, hd).float()
    gf = do.reshape(B, Sq, K, G, hd).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgh,btkh->bkgst", qf, kf) * scale
    s = s.masked_fill(~_mask(Sq, Skv, causal, window, q_pos_offset,
                             q.device), NEG_INF)
    L = torch.logsumexp(s, dim=-1, keepdim=True) if lse is None else \
        lse.float().reshape(B, K, G, Sq, 1)
    p = torch.exp(s - L)
    delta = (gf * o.reshape(B, Sq, K, G, hd).float()).sum(-1)   # (b,s,k,g)
    dv = torch.einsum("bkgst,bskgh->btkh", p, gf)
    dp = torch.einsum("bskgh,btkh->bkgst", gf, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf) * scale
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
