"""Decode attention, dispatched by the device of its inputs: CPU tensors go
to the plain version, CUDA tensors to the hand-written split-KV kernel
(which raises rather than fall back)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None):
    """Single-token GQA attention. q: (B, 1, Hq, hd); caches (B, Sc, K, hd);
    pos: scalar or (B,) per-slot positions."""
    if q.device.type == "cuda":     # both cache layouts admit the same rows
        return decode_attention_cuda(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    raise ValueError(f"no decode attention for device {q.device}")
