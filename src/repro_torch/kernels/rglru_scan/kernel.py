"""ctypes wrappers of the CUDA RG-LRU scan and its backward
(``csrc/rglru_scan.cu``).

``rglru_scan_cuda.launches`` counts the forward kernel's launches (one per
call), ``rglru_scan_bwd_cuda.launches`` the backward kernel's (one per
call). The backward kernel scans the gradient from the sequence's end and
writes d log_a, dx and dh0 itself, in one launch with no torch op before or
after it. ``RGLRUScan`` is the autograd function that joins the two.

Both kernels pass each chunk's state to the next through records in a
workspace that the library counts (``rglru_scan_workspace_floats``). The
wrapper keeps one zeroed workspace per (device, stream), grows it when a
call needs more, and gives each call, forward or backward, a new epoch, so
that no call reads a record an earlier one left and the records need no
reset between calls.
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


def _lib():
    lib = build.load("rglru_scan")
    lib.rglru_scan_chunk.argtypes = []
    lib.rglru_scan_chunk.restype = _I
    lib.rglru_scan_workspace_floats.argtypes = [_I] * 3
    lib.rglru_scan_workspace_floats.restype = _LL
    return lib


def _entry():
    """(library, the forward's entry)."""
    lib = _lib()
    fn = lib.rglru_scan_fwd
    fn.argtypes = [_P] * 5 + [_LL, _U] + [_I] * 3 + [_P]
    fn.restype = _I
    return lib, fn


def _bwd_entry():
    """(library, the backward's entry)."""
    lib = _lib()
    fn = lib.rglru_scan_bwd
    fn.argtypes = [_P] * 8 + [_LL, _U] + [_I] * 3 + [_P]
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


def _check(h0, **seqs):
    """Raise unless the (B, S, W) tensors ``seqs`` share one nonempty
    shape, h0 is (B, W), and all are contiguous 4-byte-aligned fp32 on one
    CUDA device; returns (B, S, W)."""
    shapes = {name: tuple(t.shape) for name, t in seqs.items()}
    first = next(iter(shapes.values()))
    if len(first) != 3 or len(set(shapes.values())) != 1 or \
            tuple(h0.shape) != (first[0], first[2]):
        raise ValueError(f"shapes {shapes}, h0 {tuple(h0.shape)}")
    if min(first) == 0:
        raise ValueError(f"empty input {first}")
    for name, t in (*seqs.items(), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"the scan takes float32, not {t.dtype} "
                            f"({name})")
    build.check_operands(**seqs, h0=h0, align=4)
    return first


def _launch(entry, B: int, S: int, W: int, device, *ptrs) -> None:
    """One launch through ``entry`` (``_entry`` or ``_bwd_entry``) with the
    stream's workspace and a new epoch (uncounted: the wrappers count)."""
    lib, fn = entry()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ws, epoch = _workspace(lib.rglru_scan_workspace_floats(B, S, W),
                               device, stream)
        err = fn(*ptrs, ws.data_ptr(), ws.numel(), epoch, B, S, W, stream)
    build.raise_on_error(lib, fn.__name__, err)


def rglru_scan_cuda(log_a, x, h0):
    """log_a, x: (B, S, W); h0: (B, W); contiguous fp32 CUDA tensors, any
    S >= 1 and W >= 1. Returns (B, S, W) fp32. Raises on input the kernel
    does not take and on any CUDA error of the launch."""
    B, S, W = _check(h0, log_a=log_a, x=x)
    out = torch.empty_like(x)
    _launch(_entry, B, S, W, x.device, log_a.data_ptr(), x.data_ptr(),
            h0.data_ptr(), out.data_ptr())
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0  # type: ignore[attr-defined]


def rglru_scan_bwd_cuda(log_a, h0, y, dy):
    """The gradient of ``rglru_scan_cuda``: log_a, y (its output), dy
    (B, S, W) and h0 (B, W), contiguous fp32 CUDA tensors. Returns
    (d log_a, dx, dh0), from one launch of the backward kernel; raises as
    ``rglru_scan_cuda``."""
    B, S, W = _check(h0, log_a=log_a, y=y, dy=dy)
    dlog_a, dx, dh0 = (torch.empty_like(y), torch.empty_like(y),
                       torch.empty_like(h0))
    _launch(_bwd_entry, B, S, W, y.device, log_a.data_ptr(), h0.data_ptr(),
            y.data_ptr(), dy.data_ptr(), dlog_a.data_ptr(), dx.data_ptr(),
            dh0.data_ptr())
    rglru_scan_bwd_cuda.launches += 1
    return dlog_a, dx, dh0


rglru_scan_bwd_cuda.launches = 0  # type: ignore[attr-defined]


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan on the card with its backward kernel."""

    @staticmethod
    def forward(ctx, log_a, x, h0):
        y = rglru_scan_cuda(log_a, x, h0)
        ctx.save_for_backward(log_a, h0, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        log_a, h0, y = ctx.saved_tensors
        return rglru_scan_bwd_cuda(log_a, h0, y, dy.contiguous())
