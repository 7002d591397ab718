"""ctypes wrapper of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``), and its
backward.

``rglru_scan_cuda.launches`` counts the kernel's launches (one per call).

The backward is the same kernel run on reversed time: the gradient g of
the states obeys g_t = dy_t + a_{t+1} g_{t+1} (g_S = dy_S, a_t =
exp(log_a_t)), the forward recurrence on flipped time with the decays
shifted by one step. ``rglru_scan_bwd_cuda`` runs that scan, then the
elementwise products dx = g, d log_a_t = g_t a_t h_{t-1} (h_{-1} = h0) and
dh0 = a_0 g_0 as torch ops; ``rglru_scan_bwd_cuda.launches`` counts its
reverse scans apart from the forward's. ``RGLRUScan`` is the autograd
function that joins the two.

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


def _scan(log_a, x, h0):
    """One launch of the scan kernel (uncounted: the wrappers count)."""
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
    return out


def rglru_scan_cuda(log_a, x, h0):
    """log_a, x: (B, S, W); h0: (B, W); contiguous fp32 CUDA tensors, any
    S >= 1 and W >= 1. Returns (B, S, W) fp32. Raises on input the kernel
    does not take and on any CUDA error of the launch."""
    out = _scan(log_a, x, h0)
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0  # type: ignore[attr-defined]


def reverse_scan_inputs(log_a, dy):
    """The reverse scan's (log_a', x', h0'): the decays shifted one step
    on and flipped in time, dy flipped, a zero state."""
    shifted = torch.cat([log_a[:, 1:], torch.zeros_like(log_a[:, :1])], 1)
    return (torch.flip(shifted, (1,)), torch.flip(dy, (1,)),
            torch.zeros_like(log_a[:, 0]))


def bwd_products(log_a, h0, y, g):
    """(d log_a, dx, dh0) from the states' gradient g."""
    a = torch.exp(log_a)
    h_prev = torch.cat([h0[:, None], y[:, :-1]], 1)
    return g * a * h_prev, g, a[:, 0] * g[:, 0]


def rglru_scan_bwd_cuda(log_a, h0, y, dy):
    """The gradient of ``rglru_scan_cuda``: log_a, y (its output), dy
    (B, S, W) and h0 (B, W) fp32 CUDA tensors. Returns (d log_a, dx, dh0).
    The scan runs on the kernel, once; raises as ``rglru_scan_cuda``."""
    g = torch.flip(_scan(*reverse_scan_inputs(log_a, dy)), (1,))
    rglru_scan_bwd_cuda.launches += 1
    return bwd_products(log_a, h0, y, g)


rglru_scan_bwd_cuda.launches = 0  # type: ignore[attr-defined]


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan on the card with its backward on the same kernel."""

    @staticmethod
    def forward(ctx, log_a, x, h0):
        y = rglru_scan_cuda(log_a, x, h0)
        ctx.save_for_backward(log_a, h0, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        log_a, h0, y = ctx.saved_tensors
        return rglru_scan_bwd_cuda(log_a, h0, y, dy.contiguous())
