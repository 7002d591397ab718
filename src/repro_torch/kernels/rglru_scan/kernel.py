"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``).

``rglru_scan_cuda.launches`` counts the kernel's launches (one per call).

The kernel passes each chunk's state to the next through records in a
workspace that the library counts (``rglru_scan_workspace_floats``). The
wrapper keeps one zeroed workspace per (device, stream), grows it when a
call needs more, and gives each call a new epoch, so that no call reads a
record an earlier one left and the records need no reset between calls.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, \
    ctypes.c_longlong
# the tiling of csrc/rglru_scan.cu: one ticket per (batch row, chunk of
# KERNEL_CHUNK steps, tile of 128 channels)
KERNEL_CHUNK = 32
_EPOCHS = 2 ** 31 - 1      # the kernel takes epochs 1 .. 2^31 - 1

# (device index, stream) -> [workspace, epoch of its last call]
_workspaces: dict = {}


def _entry():
    lib = build.load("rglru_scan")
    lib.rglru_scan_chunk.argtypes = []
    lib.rglru_scan_chunk.restype = _I
    lib.rglru_scan_workspace_floats.argtypes = [_I] * 3
    lib.rglru_scan_workspace_floats.restype = _LL
    fn = lib.rglru_scan_fwd
    fn.argtypes = [_P] * 5 + [_LL, _U] + [_I] * 3 + [_P]
    fn.restype = _I
    return lib, fn


def _workspace(need: int, device, stream: int):
    """A zeroed workspace of at least ``need`` floats for this stream, and
    the next epoch for it; a new one (zeroed) when it is too small or its
    epochs are spent."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < need or ws[1] == _EPOCHS:
        ws = _workspaces[key] = [torch.zeros(need, dtype=torch.float32,
                                             device=device), 0]
    ws[1] += 1
    return ws[0], ws[1]


def release_workspaces() -> None:
    """Drop the cached workspaces (their memory returns to the caching
    allocator); the next call allocates a new one."""
    _workspaces.clear()


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
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ws, epoch = _workspace(lib.rglru_scan_workspace_floats(B, S, W),
                               x.device, stream)
        err = fn(log_a.data_ptr(), x.data_ptr(), h0.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), ws.numel(), epoch, B, S, W,
                 stream)
    build.raise_on_error(lib, "rglru_scan_fwd", err)
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0  # type: ignore[attr-defined]
