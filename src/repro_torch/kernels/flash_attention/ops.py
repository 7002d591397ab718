"""Flash attention, dispatched by the device of its inputs: CPU tensors go
to the plain version, CUDA tensors to the hand-written kernel (which raises
rather than fall back)."""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    q_pos_offset: int = 0):
    """GQA attention. q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd), K | Hq.
    Causal masking uses absolute query position q_pos_offset + row index."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_pos_offset=q_pos_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_pos_offset=q_pos_offset)
    raise ValueError(f"no flash attention for device {q.device}")
