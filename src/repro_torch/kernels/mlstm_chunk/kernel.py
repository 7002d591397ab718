"""ctypes wrappers of the CUDA chunkwise mLSTM (``csrc/mlstm_chunk.cu``)
and its backward (``csrc/mlstm_chunk_bwd.cu``), and ``MLSTMChunk``, the
autograd function that joins them.

``mlstm_chunk_cuda.launches`` counts the forward wrapper's calls that
launched the kernel (each call launches its three passes),
``mlstm_chunk_bwd_cuda.launches`` the backward's (four passes each, the
three with products on the tensor cores in split TF32).
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
BWD_SLICE = 128      # csrc/mlstm_chunk_bwd.cu's kSlice: gradient-pass columns


def plan(B: int, S: int, nh: int, hd: int) -> dict:
    """The launches of one call, as ``mlstm_chunk_fwd`` makes them: the
    blocks of each pass, and the workspace (floats of each part, in the
    order ``cut_workspace`` lays them out, and bytes in all). The wrapper
    sizes the workspace by the library's own count,
    ``mlstm_chunk_workspace_floats``; this plan is for reading, tests and
    cutting the chunks' states out of a workspace (``forward_states``)."""
    nc = -(-S // KERNEL_CHUNK)
    nt = -(-hd // STATE_TILE)
    bh = B * nh
    blocks = {"state": nt * nt * bh,
              "weight": KERNEL_CHUNK // WEIGHT_ROWS * nc * bh,
              "output": nc * -(-hd // OUTPUT_SLICE) * bh}
    parts = {"C": bh * (nc - 1) * hd * hd, "W": bh * nc * KERNEL_CHUNK ** 2,
             "n": bh * (nc - 1) * hd, "e": bh * nc * KERNEL_CHUNK,
             "den": bh * nc * KERNEL_CHUNK, "m": bh * (nc - 1)}
    return {"chunks": nc, "launches": len(blocks), "blocks": blocks,
            "workspace": parts, "workspace_bytes": 4 * sum(parts.values())}


def plan_bwd(B: int, S: int, nh: int, hd: int) -> dict:
    """The launches of one backward call, as ``mlstm_chunk_bwd`` makes them
    (the tiling of csrc/mlstm_chunk_bwd.cu): the blocks and threads of each
    pass, and the workspace (floats of each part, in its order, and bytes in
    all); the wrapper sizes it by ``mlstm_chunk_bwd_workspace_floats``.

    At xLSTM-350M's training shape (B=1, S=4096, nh=4, hd=512) every pass
    with products runs at least 256 blocks, two a streaming multiprocessor
    on an H100's 132 for the state pass (its 64 x 64 tiles of dC' walk the
    chunks in order, so it cannot be cut finer along S). The gate pass (no
    products, one thread a step) runs one block a chunk and head."""
    L = KERNEL_CHUNK
    nc = -(-S // L)
    nt = -(-hd // STATE_TILE)
    nsl = -(-hd // BWD_SLICE)
    bh = B * nh
    blocks = {"weight": L // WEIGHT_ROWS * nc * bh, "state": nt * nt * bh,
              "grad": nc * 3 * nsl * bh, "gate": nc * bh}
    threads = {"weight": 128, "state": 256, "grad": 256, "gate": L}
    chunk = bh * nc * L
    parts = {"dC": bh * (nc - 1) * hd * hd, "dS": chunk * L,
             "W/den": chunk * L, "dD": chunk * L, "dn": bh * (nc - 1) * hd,
             "e": chunk, "1/den": chunk, "da": chunk, "qn": chunk,
             "w": chunk, "qX": chunk * nsl, "kG": chunk * nsl,
             "dscale": bh * nc * nt * nt, "scale": bh * nc}
    return {"chunks": nc, "launches": len(blocks), "blocks": blocks,
            "threads": threads, "workspace": parts,
            "workspace_bytes": 4 * sum(parts.values())}


def forward_states(ws, B: int, S: int, nh: int, hd: int) -> tuple:
    """The states entering chunks 1 .. nc-1 that a forward call left in its
    workspace ``ws``, as views: C (B nh, nc-1, hd, hd), n (B nh, nc-1, hd),
    m (B nh, nc-1)."""
    parts = plan(B, S, nh, hd)["workspace"]
    at, views = 0, {}
    for name, size in parts.items():
        views[name] = ws[at:at + size]
        at += size
    bh, n = B * nh, -(-S // KERNEL_CHUNK) - 1
    return (views["C"].view(bh, n, hd, hd), views["n"].view(bh, n, hd),
            views["m"].view(bh, n))


def _entry():
    lib = build.load("mlstm_chunk")
    lib.mlstm_chunk_workspace_floats.argtypes = [_I] * 4
    lib.mlstm_chunk_workspace_floats.restype = _LL
    fn = lib.mlstm_chunk_fwd
    fn.argtypes = [_P] * 13 + [_LL] + [_I] * 4 + [_P]
    fn.restype = _I
    return lib, fn


def _check_shapes(q, k, v, log_i, log_f, C, n, m, **more) -> tuple:
    """(B, S, nh, hd) of operands the kernels take; raises on others."""
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, S, nh, hd = q.shape
    want = {"log_i": (log_i, (B, S, nh)), "log_f": (log_f, (B, S, nh)),
            "C": (C, (B, nh, hd, hd)), "n": (n, (B, nh, hd)),
            "m": (m, (B, nh)),
            **{name: (t, tuple(q.shape)) for name, t in more.items()}}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    if min(B, S, nh) == 0 or hd % 32 or not 0 < hd <= 512:
        raise ValueError(f"q {tuple(q.shape)}: the kernel takes S >= 1 and "
                         "hd a multiple of 32 up to 512")
    if q.dtype != torch.float32:
        raise TypeError(f"the mLSTM kernel takes float32, not {q.dtype}")
    return B, S, nh, hd


def mlstm_chunk_cuda(q, k, v, log_i, log_f, C, n, m, *,
                     keep_workspace: bool = False):
    """q, k, v: (B, S, nh, hd); log_i, log_f: (B, S, nh); the state entering
    the first step C (B, nh, hd, hd), n (B, nh, hd), m (B, nh); contiguous
    fp32 CUDA tensors, any S >= 1, hd a multiple of 32 up to 512. Returns
    (h (B, S, nh, hd), (C, n, m)) as new tensors, the state after the last
    step, and with ``keep_workspace`` the call's workspace as a third item
    (``forward_states`` cuts the chunks' states out of it for the
    backward). Raises on input the kernel does not take and on any CUDA
    error of the launches. The kernel copies q, k, v and C in 16-byte
    pieces; one that does not start on 16 bytes is copied to new memory
    first."""
    B, S, nh, hd = _check_shapes(q, k, v, log_i, log_f, C, n, m)
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
    if keep_workspace:
        return h, (C_out, n_out, m_out), ws
    return h, (C_out, n_out, m_out)


mlstm_chunk_cuda.launches = 0  # type: ignore[attr-defined]


def _bwd_entry():
    lib = build.load("mlstm_chunk_bwd")
    lib.mlstm_chunk_bwd_workspace_floats.argtypes = [_I] * 4
    lib.mlstm_chunk_bwd_workspace_floats.restype = _LL
    fn = lib.mlstm_chunk_bwd
    fn.argtypes = [_P] * 19 + [_LL] + [_I] * 4 + [_P]
    fn.restype = _I
    return lib, fn


def mlstm_chunk_bwd_cuda(q, k, v, log_i, log_f, state, h, dh, states):
    """The gradient of ``mlstm_chunk_cuda``'s h: its operands q, k, v,
    log_i, log_f and ``state`` = (C, n, m) entering the scan, its output h,
    the cotangent dh (B, S, nh, hd), and ``states``, the states entering
    chunks 1 .. nc-1 that the forward left in its workspace
    (``forward_states``); contiguous fp32 CUDA tensors. Returns (dq, dk,
    dv, dlog_i, dlog_f). The state leaving the scan takes no gradient and
    the state entering it gets none. Raises as ``mlstm_chunk_cuda``. The
    kernel copies q, k, v, h, dh, C and the chunks' states in 16-byte
    pieces; one that does not start on 16 bytes is copied to new memory
    first."""
    C, n, m = state
    B, S, nh, hd = _check_shapes(q, k, v, log_i, log_f, C, n, m, h=h, dh=dh)
    Cs, ns, ms = states
    nc = -(-S // KERNEL_CHUNK)
    want = {"Cs": (Cs, (B * nh, nc - 1, hd, hd)),
            "ns": (ns, (B * nh, nc - 1, hd)), "ms": (ms, (B * nh, nc - 1))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected {shape}")
    build.check_operands(q=q, k=k, v=v, log_i=log_i, log_f=log_f, h=h, dh=dh,
                         C=C, n=n, m=m, Cs=Cs, ns=ns, ms=ms, align=4)
    q, k, v, h, dh, C, Cs = (t if t.data_ptr() % 16 == 0 else t.clone()
                             for t in (q, k, v, h, dh, C, Cs))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dli, dlf = torch.empty_like(log_i), torch.empty_like(log_f)
    lib, fn = _bwd_entry()
    ws = torch.empty(lib.mlstm_chunk_bwd_workspace_floats(B, S, nh, hd),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, log_i, log_f, h, dh, C, n,
                                          m, Cs, ns, ms, dq, dk, dv, dli, dlf,
                                          ws)),
                 ws.numel(), B, S, nh, hd, stream)
    build.raise_on_error(lib, "mlstm_chunk_bwd", err)
    mlstm_chunk_bwd_cuda.launches += 1
    return dq, dk, dv, dli, dlf


mlstm_chunk_bwd_cuda.launches = 0  # type: ignore[attr-defined]


class MLSTMChunk(torch.autograd.Function):
    """The chunkwise mLSTM on the card with its backward kernel. Gradients
    reach q, k, v, log_i and log_f through h. The state is not
    differentiated (no training path of either package does): a state
    entering the scan that requires grad, or a gradient arriving on the
    state it returns, raises rather than be silently dropped. The forward
    saves its workspace's chunk states for the backward (by
    ``save_for_backward``, so a rematerialised region recomputes them)."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C, n, m):
        if any(t.requires_grad for t in (C, n, m)):
            raise RuntimeError("the mLSTM kernel's state entering the scan "
                               "takes no gradient: detach it")
        ctx.set_materialize_grads(False)
        h, (C_out, n_out, m_out), ws = mlstm_chunk_cuda(
            q, k, v, log_i, log_f, C, n, m, keep_workspace=True)
        ctx.save_for_backward(q, k, v, log_i, log_f, C, n, m, h,
                              *forward_states(ws, *q.shape))
        return h, C_out, n_out, m_out

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        if dC is not None or dn is not None or dm is not None:
            raise RuntimeError("the mLSTM kernel's backward takes no gradient "
                               "on the state it returns")
        if dh is None:
            return (None,) * 8
        q, k, v, li, lf, C, n, m, h, Cs, ns, ms = ctx.saved_tensors
        grads = mlstm_chunk_bwd_cuda(q, k, v, li, lf, (C, n, m), h,
                                     dh.contiguous(), (Cs, ns, ms))
        return (*grads, None, None, None)
