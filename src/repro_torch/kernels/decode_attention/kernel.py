"""ctypes wrapper of the CUDA split-KV decode kernel
(``csrc/decode_attention.cu``).

It takes no window: a flat cache and a rotating window cache admit the same
rows, ``[0, min(pos + 1, Sc))`` of each slot (see the kernel's header), so
one launch serves both.

``decode_attention_cuda.launches`` counts the kernel's launches (one per
call: the partial pass and the combine pass that follows it).
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
GROUP_SIZES = (1, 2, 4, 8, 10, 16)   # query heads per KV head the kernel takes


def _entry():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = _I
    lib.decode_attention_split_rows.argtypes = []
    lib.decode_attention_split_rows.restype = _I
    return lib, fn


def decode_attention_cuda(q, k_cache, v_cache, pos):
    """q: (B, 1, Hq, hd); caches (B, Sc, K, hd) CUDA tensors, fp32 or bf16;
    pos: an int, a 0-d tensor or a (B,) tensor. Returns (B, 1, Hq, hd) in
    q.dtype. Raises on input the kernel does not take and on any CUDA error
    of the launch."""
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
    if G not in GROUP_SIZES:
        raise ValueError(f"{G} query heads per KV head; the kernel takes "
                         f"{GROUP_SIZES}")
    if not (0 < hd <= 256 and hd % 4 == 0):
        raise ValueError(f"head_dim {hd}: the kernel takes a multiple of 4 "
                         "up to 256")
    posb = torch.as_tensor(pos, device=q.device).to(torch.int32)
    if posb.ndim == 0:
        posb = posb.expand(B)
    if tuple(posb.shape) != (B,):
        raise ValueError(f"pos of shape {tuple(posb.shape)} for batch {B}")
    posb = posb.contiguous()
    build.check_operands(q=q, k_cache=k_cache, v_cache=v_cache)
    lib, fn = _entry()
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
                 part_ml.data_ptr(), B, Hq, K, Sc, hd,
                 build.dtype_code(q.dtype), stream)
    build.raise_on_error(lib, "decode_attention_fwd", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0  # type: ignore[attr-defined]
