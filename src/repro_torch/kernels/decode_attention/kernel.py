"""ctypes wrappers of the CUDA split-KV decode kernels, chosen by dtype (both
routes are kernels; neither falls back to the other):

- bf16: ``csrc/decode_attention_sm90.cu``, one launch on the tensor cores
  (``mma.sync``, K and V through ``cp.async`` rings), the splits combined in
  the same launch; any G = Hq / K from 1 to 16, head_dim a multiple of 8 up
  to 256;
- fp32: ``csrc/decode_attention.cu``, fp32 products on the CUDA cores (held
  to 2e-5, which TF32 products could not meet), a partial and a combine
  pass; G in ``GROUP_SIZES``, head_dim a multiple of 4 up to 256.

Neither takes a window: a flat cache and a rotating window cache admit the
same rows, ``[0, min(pos + 1, Sc))`` of each slot (see the kernels'
headers), so one launch serves both. ``pos`` is never read on the host.

Both write each head's log-sum-exp on request (``lse=``, an fp32 (B, Hq)
tensor): the natural log of the sum of exp(score / sqrt(hd)) over the
admitted rows, from the combine's max and sum, -inf where a slot admits no
row (pos < 0). The output is the same with and without it: the lse adds B
x Hq stores to the one launch.

``decode_attention_cuda.launches`` counts the calls of both routes,
``decode_attention_cuda.launches_sm90`` those of the bf16 kernel,
``decode_attention_cuda.launches_lse`` those that wrote the lse.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
GROUP_SIZES = (1, 2, 4, 5, 8, 10, 12, 16)  # G the fp32 kernel takes
SM90_MAX_GROUP = 16                          # the bf16 kernel takes 1..16
SM90_MAX_SPLITS = 64                         # csrc kMaxSplit
SM90_MIN_SPLIT_ROWS = 128  # two 16-row tiles for each of the four warps


def plan_splits(B: int, K: int, Sc: int, n_sm: int, per_sm: int) -> int:
    """Splits per (slot, KV head) of the bf16 kernel: the least power of two
    for which the grid, splits x K x B, covers every SM, but none that cuts
    a full cache into splits of fewer than ``SM90_MIN_SPLIT_ROWS`` rows, and
    none that makes the grid more than the card holds at once (``per_sm``
    blocks an SM): the splits meet at a grid barrier. A power of two cuts a
    power-of-two cache into whole tiles. Depends on the shapes and the card
    alone, never on the positions.

    On an H100 this gives 4 splits at Llama-3.1-8B's decode (B=8, K=8: 256
    blocks) and 16 at RecurrentGemma-2B's (B=8, K=1: 128 blocks, the cap);
    PERF.md holds the sweep of split counts behind that choice."""
    most = max(1, min(SM90_MAX_SPLITS, Sc // SM90_MIN_SPLIT_ROWS,
                      per_sm * n_sm // (B * K)))
    n = 1
    while n * B * K < n_sm and 2 * n <= most:
        n *= 2
    return n


@lru_cache(maxsize=None)
def _card(index: int, hd: int) -> Tuple[int, int]:
    """(SMs, blocks of the bf16 kernel for head_dim hd an SM holds)."""
    lib = build.load("decode_attention_sm90")
    fn = lib.decode_attention_blocks_per_sm_sm90
    fn.argtypes = [_I, ctypes.POINTER(_I)]
    fn.restype = _I
    per_sm = _I(0)
    with torch.cuda.device(index):
        build.raise_on_error(lib, "decode_attention_blocks_per_sm_sm90",
                             fn(hd, ctypes.byref(per_sm)))
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    return n_sm, per_sm.value


def _cuda_core_entry():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    fn.restype = _I
    lib.decode_attention_split_rows.argtypes = []
    lib.decode_attention_split_rows.restype = _I
    return lib, fn


def _sm90_entry():
    lib = build.load("decode_attention_sm90")
    fn = lib.decode_attention_fwd_sm90
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    fn.restype = _I
    return lib, fn


def _check(q, k_cache, v_cache, pos):
    """Shapes, G and head_dim for the route of q's dtype; pos as a (B,)
    int32 tensor on q's device."""
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 or \
            k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)}")
    B, _, Hq, hd = q.shape
    Sc, K = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or K == 0 or Hq % K:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    G = Hq // K
    if q.dtype == torch.bfloat16:
        if not 1 <= G <= SM90_MAX_GROUP:
            raise ValueError(f"{G} query heads per KV head; the bf16 kernel "
                             f"takes 1 to {SM90_MAX_GROUP}")
        step = 8                  # 16-byte cp.async copies of bf16 rows
    else:
        if G not in GROUP_SIZES:
            raise ValueError(f"{G} query heads per KV head; the kernel takes "
                             f"{GROUP_SIZES}")
        step = 4
    if not (0 < hd <= 256 and hd % step == 0):
        raise ValueError(f"head_dim {hd}: the {q.dtype} kernel takes a "
                         f"multiple of {step} up to 256")
    posb = torch.as_tensor(pos, device=q.device).to(torch.int32)
    if posb.ndim == 0:
        posb = posb.expand(B)
    if tuple(posb.shape) != (B,):
        raise ValueError(f"pos of shape {tuple(posb.shape)} for batch {B}")
    build.check_operands(q=q, k_cache=k_cache, v_cache=v_cache)
    return B, Hq, K, Sc, hd, G, posb.contiguous()


def _check_lse(lse, q) -> None:
    """Raise unless ``lse`` is a contiguous fp32 (B, Hq) tensor on q's
    device."""
    B, Hq = q.shape[0], q.shape[2]
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq) or
            lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, Hq) = "
                         f"({B}, {Hq}) tensor on {q.device}, not "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch_cuda_core(q, k_cache, v_cache, posb, lse, B, Hq, K, Sc, hd, G):
    """The fp32 kernel on the CUDA cores: a partial and a combine pass."""
    lib, fn = _cuda_core_entry()
    n_split = -(-Sc // lib.decode_attention_split_rows())
    part_acc = torch.empty(B * K * n_split * G * hd, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * K * n_split * G * 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 posb.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                 part_ml.data_ptr(), _ptr(lse), B, Hq, K, Sc, hd, stream)
    build.raise_on_error(lib, "decode_attention_fwd", err)
    return out


def _launch_sm90(q, k_cache, v_cache, posb, lse, B, Hq, K, Sc, hd, G):
    """The bf16 kernel on the tensor cores, at ``plan_splits``'s split
    count."""
    lib, fn = _sm90_entry()
    n_split = plan_splits(B, K, Sc, *_card(q.device.index, hd))
    part_acc = torch.empty(B * K * n_split * G * hd, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * K * n_split * G * 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 posb.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
                 part_ml.data_ptr(), _ptr(lse), B, Hq, K, Sc, hd, n_split,
                 stream)
    build.raise_on_error(lib, "decode_attention_fwd_sm90", err)
    return out


def decode_attention_cuda(q, k_cache, v_cache, pos, lse=None):
    """q: (B, 1, Hq, hd); caches (B, Sc, K, hd) CUDA tensors, fp32 or bf16;
    pos: an int, a 0-d tensor or a (B,) tensor. Returns (B, 1, Hq, hd) in
    q.dtype. ``lse``, if given, is an fp32 (B, Hq) tensor the launch fills
    with each head's log-sum-exp. Raises on input the kernel does not take
    and on any CUDA error of the launch."""
    B, Hq, K, Sc, hd, G, posb = _check(q, k_cache, v_cache, pos)
    if lse is not None:
        _check_lse(lse, q)
    if q.dtype == torch.bfloat16:
        out = _launch_sm90(q, k_cache, v_cache, posb, lse, B, Hq, K, Sc, hd,
                           G)
        decode_attention_cuda.launches_sm90 += 1
    else:
        out = _launch_cuda_core(q, k_cache, v_cache, posb, lse, B, Hq, K, Sc,
                                hd, G)
    decode_attention_cuda.launches += 1
    if lse is not None:
        decode_attention_cuda.launches_lse += 1
    return out


decode_attention_cuda.launches = 0       # type: ignore[attr-defined]
decode_attention_cuda.launches_sm90 = 0  # type: ignore[attr-defined]
decode_attention_cuda.launches_lse = 0   # type: ignore[attr-defined]
