"""ctypes wrapper of the CUDA chunkwise mLSTM (``csrc/mlstm_chunk.cu``).

``mlstm_chunk_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL_CHUNK = 64    # steps of S per chunk, kL in csrc/mlstm_chunk.cu


def _entry():
    lib = build.load("mlstm_chunk")
    fn = lib.mlstm_chunk_fwd
    fn.argtypes = [_P] * 12 + [_I] * 4 + [_P]
    fn.restype = _I
    return lib, fn


def mlstm_chunk_cuda(q, k, v, log_i, log_f, C, n, m):
    """q, k, v: (B, S, nh, hd); log_i, log_f: (B, S, nh); the state entering
    the first step C (B, nh, hd, hd), n (B, nh, hd), m (B, nh); contiguous
    fp32 CUDA tensors, any S >= 1, hd a multiple of 32 up to 512. Returns
    (h (B, S, nh, hd), (C, n, m)) as new tensors, the state after the last
    step. Raises on input the kernel does not take and on any CUDA error of
    the launch."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, S, nh, hd = q.shape
    want = {"log_i": (log_i, (B, S, nh)), "log_f": (log_f, (B, S, nh)),
            "C": (C, (B, nh, hd, hd)), "n": (n, (B, nh, hd)),
            "m": (m, (B, nh))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    if min(B, S, nh) == 0 or hd % 32 or not 0 < hd <= 512:
        raise ValueError(f"q {tuple(q.shape)}: the kernel takes S >= 1 and "
                         "hd a multiple of 32 up to 512")
    if q.dtype != torch.float32:
        raise TypeError(f"the mLSTM kernel takes float32, not {q.dtype}")
    build.check_operands(q=q, k=k, v=v, log_i=log_i, log_f=log_f, C=C, n=n,
                         m=m, align=4)
    h = torch.empty_like(q)
    C_out, n_out, m_out = (torch.empty_like(t) for t in (C, n, m))
    lib, fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
                 log_f.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
                 h.data_ptr(), C_out.data_ptr(), n_out.data_ptr(),
                 m_out.data_ptr(), B, S, nh, hd, stream)
    build.raise_on_error(lib, "mlstm_chunk_fwd", err)
    mlstm_chunk_cuda.launches += 1
    return h, (C_out, n_out, m_out)


mlstm_chunk_cuda.launches = 0  # type: ignore[attr-defined]
