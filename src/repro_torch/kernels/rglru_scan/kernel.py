"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

``rglru_scan_cuda.launches`` counts the kernel's launches (one per call:
the chunk summaries, the carry across chunks and the rescan that follow
one another on the stream).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _entry():
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = _I
    lib.rglru_scan_chunk.argtypes = []
    lib.rglru_scan_chunk.restype = _I
    return lib, fn


def rglru_scan_cuda(log_a, x, h0):
    """log_a, x: (B, S, W); h0: (B, W); contiguous fp32 CUDA tensors, any
    S >= 1 and W >= 1. Returns (B, S, W) fp32. Raises on input the kernel
    does not take and on any CUDA error of the launch."""
    if log_a.ndim != 3 or log_a.shape != x.shape or \
            tuple(h0.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"shapes log_a {tuple(log_a.shape)}, x "
                         f"{tuple(x.shape)}, h0 {tuple(h0.shape)}")
    B, S, W = x.shape
    if min(B, S, W) == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the scan takes float32, not {x.dtype}")
    build.check_operands(log_a=log_a, x=x, h0=h0, align=4)
    lib, fn = _entry()
    n_chunks = -(-S // lib.rglru_scan_chunk())
    scratch = torch.empty(3 * B * n_chunks * W, dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(log_a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, S, W, stream)
    build.raise_on_error(lib, "rglru_scan_fwd", err)
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0  # type: ignore[attr-defined]
