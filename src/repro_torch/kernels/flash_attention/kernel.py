"""ctypes wrappers of the CUDA flash prefill kernels, chosen by dtype (both
routes are kernels; neither falls back to the other):

- bf16: ``csrc/flash_attention_sm90.cu``, both products on the tensor cores
  (``wgmma``, tiles fed by TMA; the helpers it shares with the backward in
  ``csrc/sm90.cuh``); head_dim a multiple of 8 up to 256;
- fp32: ``csrc/flash_attention.cu``, fp32 products on the CUDA cores (held
  to 2e-5, which TF32 products could not meet); head_dim a multiple of 4 up
  to 256.

``flash_attention_cuda.launches`` counts the launches of both,
``flash_attention_cuda.launches_sm90`` those of the bf16 kernel.

Both forward kernels write each row's logsumexp L on request (``lse=``),
and the backward, ``csrc/flash_attention_bwd.cu``, reads it. The backward
also chooses by dtype: bf16 on ``wgmma`` fed by TMA (two kernels, a third
that sums the shares where ``plan_bwd`` splits the query heads over
blocks), fp32 on the CUDA cores (three kernels), fp32 sums in both;
``flash_attention_bwd_cuda.launches`` counts its calls.
``FlashAttention`` is the autograd function that joins the two: its
forward runs the forward kernel with grad mode off (so the raw wrappers
never record a graph) and, when a gradient is wanted, keeps q, k, v, the
output and L; its backward runs the backward kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int

# the H100's streaming multiprocessors: the bf16 backward splits a KV head's
# query heads over blocks while its keys make fewer than two 64-key tiles an
# SM
H100_SMS = 132
BWD_KEY_TILE = 64   # keys of a warpgroup's tile (csrc/flash_attention_bwd.cu)


def _entry(name: str, fn_name: str, n_ptrs: int, n_ints: int):
    lib = build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P] * n_ptrs + [_I] * n_ints + [_P]
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


def _check_lse(lse, q) -> None:
    """Raise unless ``lse`` is an fp32 (B, Hq, Sq) contiguous tensor on q's
    device."""
    B, Sq, Hq, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq) or
            lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, Hq, Sq) = "
                         f"{(B, Hq, Sq)} tensor on {q.device}, not "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def flash_attention_cuda(q, k, v, *, causal: bool,
                         window: Optional[int] = None, q_pos_offset: int = 0,
                         lse=None):
    """q: (B, Sq, Hq, hd); k, v: (B, Skv, K, hd) CUDA tensors, fp32 or bf16.
    Returns (B, Sq, Hq, hd) in q.dtype. ``lse``, if given, is an fp32
    (B, Hq, Sq) buffer that receives each row's logsumexp of its masked,
    scaled scores (what the backward reads); without it the kernels' work
    is as it was. Raises on input the kernel does not take and on any CUDA
    error of the launch."""
    sm90 = q.dtype == torch.bfloat16
    # TMA needs 16-byte row strides in bf16
    _check_shapes(q, k, v, causal, window, q_pos_offset, 8 if sm90 else 4)
    build.check_operands(q=q, k=k, v=v)
    if lse is not None:
        _check_lse(lse, q)
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if sm90:
        name, fn_name, extra = ("flash_attention_sm90",
                                "flash_attention_fwd_sm90", ())
    else:
        name, fn_name, extra = ("flash_attention", "flash_attention_fwd",
                                (build.dtype_code(q.dtype),))
    lib, fn = _entry(name, fn_name, 5, 9 + len(extra))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, K,
                 hd, int(causal), window or 0, q_pos_offset, *extra, stream)
    build.raise_on_error(lib, fn_name, err)
    flash_attention_cuda.launches += 1
    if sm90:
        flash_attention_cuda.launches_sm90 += 1
    return out


flash_attention_cuda.launches = 0       # type: ignore[attr-defined]
flash_attention_cuda.launches_sm90 = 0  # type: ignore[attr-defined]


def plan_bwd(B: int, Sq: int, Skv: int, Hq: int, K: int, hd: int,
             dtype=torch.bfloat16) -> dict:
    """The launches of one backward call, as ``flash_attention_bwd`` makes
    them (the tiling of csrc/flash_attention_bwd.cu): each launch's grid,
    the device kernels a call launches, and the workspace past dq, dk, dv
    and D. bf16: the dQ launch (one block per BQ query rows, query head and
    batch: BQ = 128 at head_dim <= 128, 64 at 256), the dK/dV launch (one
    block per 128 keys at head_dim <= 128, 64 at 256, KV head, share of the
    G = Hq / K query heads and batch) and, where the G heads are split over
    ``shares`` blocks, a pass that sums the shares' fp32 partial dK and dV
    (``shares`` x B x Skv x K x hd x 8 bytes of workspace). The heads are
    split while the keys make fewer than two 64-key tiles (a warpgroup's
    work) an SM of the H100, (key tiles) x K x B < 2 x 132, into as many
    shares as bring it there, at most G; share i takes heads [i G /
    shares, (i + 1) G / shares) of its KV head. fp32: three CUDA-core
    launches (D, dK/dV, dQ), no split."""
    G = Hq // K
    if dtype == torch.float32:
        tile = 32 if hd > 128 else 64
        grids = {"delta": (-(-B * Sq * Hq // 8),),    # a warp a row
                 "dkdv": (-(-Skv // tile), K, B),
                 "dq": (-(-Sq // tile), Hq, B)}
        return {"shares": 1, "heads_per_share": [G], "grids": grids,
                "launches": len(grids), "workspace_bytes": 0}
    tiles = -(-Skv // BWD_KEY_TILE) * K * B
    fill = 2 * H100_SMS
    shares = 1 if tiles >= fill else min(G, -(-fill // tiles))
    rows = 64 if hd > 128 else 128   # query rows of dQ, keys of dK/dV
    n = B * Skv * K * hd             # elements of dK (and of dV)
    grids = {"dq": (Hq, -(-Sq // rows), B),
             "dkdv": (-(-Skv // rows) * K * shares * B,)}
    if shares > 1:
        grids["reduce"] = (-(-n // 1024),)   # 4 elements a thread, 256 a block
    return {"shares": shares,
            "heads_per_share": [(i + 1) * G // shares - i * G // shares
                                for i in range(shares)],
            "grids": grids, "launches": len(grids),
            "workspace_bytes": 8 * shares * n if shares > 1 else 0}


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool,
                             window: Optional[int] = None,
                             q_pos_offset: int = 0):
    """The gradient of ``flash_attention_cuda``: q, o, do (B, Sq, Hq, hd);
    k, v (B, Skv, K, hd), CUDA tensors of one dtype, fp32 or bf16, o the
    forward's output, ``lse`` the (B, Hq, Sq) fp32 logsumexp the forward
    wrote (``flash_attention_cuda(..., lse=)``) and do the output's
    gradient. Returns (dq, dk, dv) in that dtype. Raises ``ValueError``
    without L, and on input the kernel does not take; ``RuntimeError`` on
    any CUDA error of its launches."""
    if lse is None:
        raise ValueError("the backward reads L, the forward's row "
                         "logsumexp: pass flash_attention_cuda(..., lse=) "
                         "its buffer")
    _check_shapes(q, k, v, causal, window, q_pos_offset,
                  8 if q.dtype == torch.bfloat16 else 4)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    build.check_operands(q=q, k=k, v=v, o=o, do=do)
    _check_lse(lse, q)
    B, Sq, Hq, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    plan = plan_bwd(B, Sq, Skv, Hq, K, hd, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    part = torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32,
                       device=q.device) if plan["workspace_bytes"] else None
    lib, fn = _entry("flash_attention_bwd", "flash_attention_bwd", 11, 11)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(),
                 None if part is None else part.data_ptr(), B, Sq, Skv, Hq,
                 K, hd, int(causal), window or 0, q_pos_offset,
                 plan["shares"], build.dtype_code(q.dtype), stream)
    build.raise_on_error(lib, "flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0  # type: ignore[attr-defined]


class FlashAttention(torch.autograd.Function):
    """Flash attention on the card with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_pos_offset):
        lse = None
        if any(ctx.needs_input_grad[:3]):   # serving never asks for L
            B, Sq, Hq, _ = q.shape
            lse = torch.empty((B, Hq, Sq), dtype=torch.float32,
                              device=q.device)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_pos_offset=q_pos_offset, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_pos_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_pos_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, do.contiguous(), lse, causal=causal, window=window,
            q_pos_offset=q_pos_offset)
        return dq, dk, dv, None, None, None
