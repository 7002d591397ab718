"""Decode attention, dispatched by the device of its inputs: CPU tensors go
to the plain version, CUDA tensors to the hand-written split-KV kernel
(which raises rather than fall back)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, return_lse: bool = False):
    """Single-token GQA attention. q: (B, 1, Hq, hd); caches (B, Sc, K, hd);
    pos: scalar or (B,) per-slot positions. With ``return_lse`` returns
    (out, lse): lse fp32 (B, Hq), the natural log-sum-exp of the scores
    scaled by 1/sqrt(hd) over the admitted rows, -inf where a slot admits
    none (pos < 0); out is what the call without it returns."""
    if q.device.type == "cuda":     # both cache layouts admit the same rows
        if not return_lse:
            return decode_attention_cuda(q, k_cache, v_cache, pos)
        lse = torch.empty(q.shape[0], q.shape[2], dtype=torch.float32,
                          device=q.device)
        return decode_attention_cuda(q, k_cache, v_cache, pos, lse=lse), lse
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    return_lse=return_lse)
    raise ValueError(f"no decode attention for device {q.device}")
