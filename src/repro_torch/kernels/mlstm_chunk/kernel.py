"""ctypes wrapper of the CUDA chunkwise mLSTM (``csrc/mlstm_chunk.cu``).

``mlstm_chunk_cuda.launches`` counts the wrapper's calls that launched the
kernel (each call launches its three passes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the tiling of csrc/mlstm_chunk.cu, for plan()
KERNEL_CHUNK = 64    # kL: steps of S per chunk
STATE_TILE = 64      # kT: rows and columns of a C tile, state pass
WEIGHT_ROWS = 16     # kRows: rows of W per weight-pass block
OUTPUT_SLICE = 128   # kSlice: value columns per output-pass block


def plan(B: int, S: int, nh: int, hd: int) -> dict:
    """The launches of one call, as ``mlstm_chunk_fwd`` makes them: the
    blocks of each pass, and the workspace (floats of each part and bytes
    in all). The wrapper sizes the workspace by the library's own count,
    ``mlstm_chunk_workspace_floats``; this plan is for reading and tests."""
    nc = -(-S // KERNEL_CHUNK)
    nt = -(-hd // STATE_TILE)
    bh = B * nh
    blocks = {"state": nt * nt * bh,
              "weight": KERNEL_CHUNK // WEIGHT_ROWS * nc * bh,
              "output": nc * -(-hd // OUTPUT_SLICE) * bh}
    parts = {"C": bh * (nc - 1) * hd * hd, "n": bh * (nc - 1) * hd,
             "m": bh * (nc - 1), "W": bh * nc * KERNEL_CHUNK ** 2,
             "e": bh * nc * KERNEL_CHUNK, "den": bh * nc * KERNEL_CHUNK}
    return {"chunks": nc, "launches": len(blocks), "blocks": blocks,
            "workspace": parts, "workspace_bytes": 4 * sum(parts.values())}


def _entry():
    lib = build.load("mlstm_chunk")
    lib.mlstm_chunk_workspace_floats.argtypes = [_I] * 4
    lib.mlstm_chunk_workspace_floats.restype = _LL
    fn = lib.mlstm_chunk_fwd
    fn.argtypes = [_P] * 13 + [_LL] + [_I] * 4 + [_P]
    fn.restype = _I
    return lib, fn


def mlstm_chunk_cuda(q, k, v, log_i, log_f, C, n, m):
    """q, k, v: (B, S, nh, hd); log_i, log_f: (B, S, nh); the state entering
    the first step C (B, nh, hd, hd), n (B, nh, hd), m (B, nh); contiguous
    fp32 CUDA tensors, any S >= 1, hd a multiple of 32 up to 512. Returns
    (h (B, S, nh, hd), (C, n, m)) as new tensors, the state after the last
    step. Raises on input the kernel does not take and on any CUDA error of
    the launches. The kernel copies q, k, v and C in 16-byte pieces; one
    that does not start on 16 bytes is copied to new memory first."""
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
    q, k, v, C = (t if t.data_ptr() % 16 == 0 else t.clone()
                  for t in (q, k, v, C))
    h = torch.empty_like(q)
    C_out, n_out, m_out = (torch.empty_like(t) for t in (C, n, m))
    lib, fn = _entry()
    ws = torch.empty(lib.mlstm_chunk_workspace_floats(B, S, nh, hd),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, log_i, log_f, C, n, m, h,
                                          C_out, n_out, m_out, ws)),
                 ws.numel(), B, S, nh, hd, stream)
    build.raise_on_error(lib, "mlstm_chunk_fwd", err)
    mlstm_chunk_cuda.launches += 1
    return h, (C_out, n_out, m_out)


mlstm_chunk_cuda.launches = 0  # type: ignore[attr-defined]
