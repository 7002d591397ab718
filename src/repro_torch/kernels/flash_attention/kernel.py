"""ctypes wrappers of the CUDA flash prefill kernels, chosen by dtype (both
routes are kernels; neither falls back to the other):

- bf16: ``csrc/flash_attention_sm90.cu``, both products on the tensor cores
  (``wgmma``, tiles fed by TMA); head_dim a multiple of 8 up to 256;
- fp32: ``csrc/flash_attention.cu``, fp32 products on the CUDA cores (held
  to 2e-5, which TF32 products could not meet); head_dim a multiple of 4 up
  to 256.

``flash_attention_cuda.launches`` counts the launches of both,
``flash_attention_cuda.launches_sm90`` those of the bf16 kernel.

The backward, ``csrc/flash_attention_bwd.cu``, also chooses by dtype:
bf16 on the tensor cores (``mma.sync``, two kernels), fp32 on the CUDA
cores (three kernels), fp32 sums in both; ``flash_attention_bwd_cuda.
launches`` counts its calls. ``FlashAttention`` is the autograd function
that joins the two: its forward runs the forward kernel with grad mode off
(so the raw wrappers never record a graph) and keeps q, k, v and the
output, its backward runs the backward kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry(name: str, fn_name: str, n_ints: int):
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P, _P, _P, _P] + [_I] * n_ints + [_P]
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


def _check_shapes(q, k, v, causal: bool, window: Optional[int],
                  q_pos_offset: int, step: int) -> None:
    """Raise on shapes the kernels do not take (head_dim a multiple of
    ``step`` up to 256)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or Hq % K:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (0 < hd <= 256 and hd % step == 0):
        raise ValueError(f"head_dim {hd}: the {q.dtype} kernel takes a "
                         f"multiple of {step} up to 256")
    if Sq == 0 or Skv == 0:
        raise ValueError("empty sequence")
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if not rows_have_keys(Sq, Skv, causal, window, q_pos_offset):
        raise ValueError("some query row admits no key")


def flash_attention_cuda(q, k, v, *, causal: bool,
                         window: Optional[int] = None, q_pos_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd) CUDA tensors, fp32 or bf16.
    Returns (B, Sq, Hq, hd) in q.dtype. Raises on input the kernel does not
    take and on any CUDA error of the launch."""
    sm90 = q.dtype == torch.bfloat16
    # TMA needs 16-byte row strides in bf16
    _check_shapes(q, k, v, causal, window, q_pos_offset, 8 if sm90 else 4)
    build.check_operands(q=q, k=k, v=v)
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if sm90:
        name, fn_name, extra = ("flash_attention_sm90",
                                "flash_attention_fwd_sm90", ())
    else:
        name, fn_name, extra = ("flash_attention", "flash_attention_fwd",
                                (build.dtype_code(q.dtype),))
    lib, fn = _entry(name, fn_name, 9 + len(extra))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, K, hd, int(causal), window or 0,
                 q_pos_offset, *extra, stream)
    build.raise_on_error(lib, fn_name, err)
    flash_attention_cuda.launches += 1
    if sm90:
        flash_attention_cuda.launches_sm90 += 1
    return out


flash_attention_cuda.launches = 0       # type: ignore[attr-defined]
flash_attention_cuda.launches_sm90 = 0  # type: ignore[attr-defined]


def flash_attention_bwd_cuda(q, k, v, o, do, *, causal: bool,
                             window: Optional[int] = None,
                             q_pos_offset: int = 0):
    """The gradient of ``flash_attention_cuda``: q, o, do (B, Sq, Hq, hd);
    k, v (B, Skv, K, hd), CUDA tensors of one dtype, fp32 or bf16, o the
    forward's output and do its gradient. Returns (dq, dk, dv) in that
    dtype. Raises on input the kernel does not take and on any CUDA error of
    its launches."""
    _check_shapes(q, k, v, causal, window, q_pos_offset,
                  8 if q.dtype == torch.bfloat16 else 4)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    build.check_operands(q=q, k=k, v=v, o=o, do=do)
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = torch.empty((2, B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = [_P] * 10 + [_I] * 10 + [_P]
    fn.restype = _I
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 rows[0].data_ptr(), rows[1].data_ptr(), B, Sq, Skv, Hq, K,
                 hd, int(causal), window or 0, q_pos_offset,
                 build.dtype_code(q.dtype), stream)
    build.raise_on_error(lib, "flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0  # type: ignore[attr-defined]


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos_offset):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_pos_offset=q_pos_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, q_pos_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        causal, window, q_pos_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, do.contiguous(), causal=causal, window=window,
            q_pos_offset=q_pos_offset)
        return dq, dk, dv, None, None, None
