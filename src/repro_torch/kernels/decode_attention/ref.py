"""Plain PyTorch decode attention: the whole ``layers.decode_attention``
contract (scalar or per-slot position, rotating window cache).

The CPU path of ``ops.decode_attention`` and the version the CUDA kernel is
held against on the card. Math in fp32, output in q.dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, pos, *,
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """q: (B, 1, Hq, hd); caches: (B, Sc, K, hd), Sc = max_len (no window)
    or the rotating window. ``pos``: the current absolute position, a scalar
    or a (B,) tensor of per-slot positions. A rotating cache's slot j holds
    absolute position pos - ((pos - j) mod Sc); negative ones are empty.
    With ``return_lse`` also returns the log-sum-exp of each head's scores
    (scaled by 1/sqrt(hd)) over the admitted rows, fp32 (B, Hq); -inf for a
    slot that admits none (pos < 0), whose output is the mean of V."""
    B, _, Hq, hd = q.shape
    Sc, K = k_cache.shape[1], k_cache.shape[2]
    G = Hq // K
    qf = q.reshape(B, K, G, hd).float()
    scores = torch.einsum("bkgh,btkh->bkgt", qf, k_cache.float())
    scores = scores / math.sqrt(hd)
    slots = torch.arange(Sc, device=q.device)
    posb = torch.as_tensor(pos, device=q.device).reshape(-1)   # (B,) or (1,)
    if window is None:
        valid = slots[None, :] <= posb[:, None]
    else:
        # torch.remainder is floor modulo, as jnp.mod
        kpos = posb[:, None] - torch.remainder(posb[:, None] - slots[None, :],
                                               Sc)
        valid = kpos >= 0
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v_cache.float())
    out = out.reshape(B, 1, Hq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (m[..., 0] + torch.log(e.sum(dim=-1))).reshape(B, Hq)
    none = ~valid.any(dim=-1)                                # (B,) or (1,)
    return out, lse.masked_fill(none[:, None], float("-inf"))
