"""ctypes wrapper of the CUDA flash prefill kernel (``csrc/flash_attention.cu``).

``flash_attention_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry():
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [_P, _P, _P, _P] + [_I] * 10 + [_P]
    fn.restype = _I
    return lib, fn


def rows_have_keys(Sq: int, Skv: int, causal: bool, window: Optional[int],
                   q_pos_offset: int) -> bool:
    """Whether every query row admits at least one key. The kernel skips
    tiles with no admissible key, so a row with none (which the layers never
    produce) would not get the reference's uniform average; the admissible
    range of a row only widens towards its first and last row."""
    def admits(qpos: int) -> bool:
        lo = max(0, qpos - window + 1) if window is not None else 0
        hi = min(Skv - 1, qpos) if causal else Skv - 1
        return lo <= hi
    return admits(q_pos_offset) and admits(q_pos_offset + Sq - 1)


def flash_attention_cuda(q, k, v, *, causal: bool,
                         window: Optional[int] = None, q_pos_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd) CUDA tensors, fp32 or bf16.
    Returns (B, Sq, Hq, hd) in q.dtype. Raises on input the kernel does not
    take and on any CUDA error of the launch."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or Hq % K:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (0 < hd <= 256 and hd % 4 == 0):
        raise ValueError(f"head_dim {hd}: the kernel takes a multiple of 4 "
                         "up to 256")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty sequence")
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if not rows_have_keys(Sq, Skv, causal, window, q_pos_offset):
        raise ValueError("some query row admits no key")
    build.check_operands(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, K, hd, int(causal), window or 0,
                 q_pos_offset, build.dtype_code(q.dtype), stream)
    build.raise_on_error(lib, "flash_attention_fwd", err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0  # type: ignore[attr-defined]
