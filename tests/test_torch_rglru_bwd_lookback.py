"""The arithmetic of the CUDA RG-LRU scan's backward (``rglru_scan_bwd`` in
``csrc/rglru_scan.cu``) on the CPU, against the JAX package.

The kernel cannot run here, so a small torch emulation below repeats its
order of operations in fp32. It scans u_t = a_t g_t (a_t = exp(log_a_t),
g the states' gradient), the gradient that step t passes to step t - 1:
g_t = dy_t + u_{t+1}, u_t = a_t g_t, u_S = 0. The chunks are taken from
the sequence's end; each is scanned from u = 0, last step first, into its
aggregate (A = sum of its log_a, e = its first step's u; steps past S
have log_a = 0 and dy = 0); the gradient entering a chunk is found by
composing the aggregates of the chunks after it, nearest first, until a
chunk whose inclusive prefix (its first step's u) is published; and the
chunk is rescanned from it, writing dx_t = g_t and d log_a_t = u_t h_{t-1}
(h_{-1} = h0, h the forward's output), chunk 0 also dh0 = u_0. Where a
look-back stops depends on timing on the card, so the emulation takes
each chunk's stop from a schedule: always the nearest chunk, always the
last chunk (the chain reaches the prefix that starts from u = 0), or
drawn at random. Held against ``jax.vjp`` of JAX's ``rglru_scan_ref``
(jitted) and against the port's plain backward ``rglru_scan_bwd_ref``,
each gradient within 1e-4 of its max |ref| (fp32, the recurrence composed
in another order), at ragged S up to the served 3450 over narrow
channels, with the decays the model draws and with decays near 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import (KERNEL_CHUNK,  # noqa: E402
                                                   rglru_scan_bwd_cuda)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref  # noqa: E402

TOL = 1e-4     # of max |ref|, each gradient
SCHEDULES = ["nearest", "last", "random"]


@jax.jit
def jax_fwd_bwd(log_a, x, h0, dy):
    """(y, d log_a, dx, dh0) of JAX's plain scan, by ``jax.vjp``."""
    y, vjp = jax.vjp(jax_scan_ref, log_a, x, h0)
    return (y, *vjp(dy))


def lookback_bwd(log_a, h0, y, dy, schedule, seed=0, chunk=KERNEL_CHUNK):
    """The backward kernel's order of operations in fp32. log_a, y, dy:
    (B, S, W); h0: (B, W). Returns (d log_a, dx, dh0)."""
    B, S, W = y.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):
        return torch.nn.functional.pad(t, (0, 0, 0, pad)).view(B, nc, chunk,
                                                               W)
    la, dys = chunks(log_a), chunks(dy)
    h_prev = chunks(torch.cat([h0[:, None], y[:, :-1]], 1))
    a = torch.exp(la)
    # each chunk from u = 0, last step first: its aggregate (A, e)
    A = torch.zeros(B, nc, W)
    e = torch.zeros(B, nc, W)
    for i in reversed(range(chunk)):
        A = A + la[:, :, i]
        e = a[:, :, i] * (e + dys[:, :, i])
    rng = np.random.default_rng(seed)
    dla = torch.empty(B, nc, chunk, W)
    dx = torch.empty(B, nc, chunk, W)
    inclusive = [None] * nc
    for c in reversed(range(nc)):
        if c == nc - 1:
            u = torch.zeros(B, W)
        else:
            stop = {"nearest": c + 1, "last": nc - 1,
                    "random": int(rng.integers(c + 1, nc))}[schedule]
            As = torch.zeros(B, W)     # chunks c+1 .. stop-1 composed
            es = torch.zeros(B, W)
            for j in range(c + 1, stop):
                es = torch.exp(As) * e[:, j] + es
                As = As + A[:, j]
            u = torch.exp(As) * inclusive[stop] + es
        for i in reversed(range(chunk)):
            g = dys[:, c, i] + u
            u = a[:, c, i] * g
            dx[:, c, i] = g
            dla[:, c, i] = u * h_prev[:, c, i]
        inclusive[c] = u
    return (dla.view(B, nc * chunk, W)[:, :S], dx.view(B, nc * chunk, W)[:, :S],
            inclusive[0])


def _inputs(rng, B, S, W, decay):
    if decay == "model":
        # models/rglru.py _lru_gates: log_a = -8 softplus(lam) r with
        # a = sigmoid(lam) ~ U[0.9, 0.999]; x scaled by sqrt(1 - a^2)
        u = rng.uniform(0.9, 0.999, (B, S, W))
        r = rng.uniform(0.0, 1.0, (B, S, W))
        la = 8.0 * r * np.log(u)
        x = np.sqrt(np.maximum(1.0 - np.exp(2.0 * la), 1e-12)) * \
            rng.standard_normal((B, S, W))
    else:   # near 1
        la = rng.uniform(-0.01, 0.0, (B, S, W))
        x = rng.standard_normal((B, S, W))
    h0 = rng.standard_normal((B, W))
    dy = rng.standard_normal((B, S, W))
    return tuple(np.asarray(t, np.float32) for t in (la, x, h0, dy))


def _rel(ours, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(ours.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("decay", ["model", "near1"])
@pytest.mark.parametrize("B,S,W", [
    (1, 1, 3), (3, 31, 129), (1, 32, 4), (2, 33, 129), (1, 206, 8),
    (3, 3450, 129),
])
def test_bwd_lookback_matches_jax_vjp(schedule, decay, B, S, W):
    la, x, h0, dy = _inputs(np.random.default_rng(S * 7 + W), B, S, W, decay)
    y, *want = jax_fwd_bwd(*(jnp.asarray(t) for t in (la, x, h0, dy)))
    ins = [torch.from_numpy(t) for t in (la, h0, np.array(y), dy)]
    got = lookback_bwd(*ins, schedule, seed=S)
    plain = rglru_scan_bwd_ref(*ins)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel(g, w) < TOL
        assert _rel(g, p) < TOL


def test_bwd_lookback_chunks_from_the_end():
    """With every look-back stopping at the nearest chunk, chunk c's
    rescan starts from chunk c + 1's u at its first step: at a chunk edge
    the emulation's dx equals dy plus the next step's a g, as the plain
    recurrence in g gives it."""
    la, x, h0, dy = _inputs(np.random.default_rng(5), 1, 3 * KERNEL_CHUNK,
                            2, "model")
    y, *_ = jax_fwd_bwd(*(jnp.asarray(t) for t in (la, x, h0, dy)))
    t_la, t_dy = torch.from_numpy(la), torch.from_numpy(dy)
    _, dx, _ = lookback_bwd(t_la, torch.from_numpy(h0),
                            torch.from_numpy(np.array(y)), t_dy, "nearest")
    for t in (KERNEL_CHUNK - 1, 2 * KERNEL_CHUNK - 1):
        want = t_dy[:, t] + torch.exp(t_la[:, t + 1]) * dx[:, t + 1]
        assert float((dx[:, t] - want).abs().max()) < 1e-5


@pytest.mark.parametrize("case", ["cpu", "fp16", "shape", "h0"])
def test_bwd_wrapper_refuses_before_any_build(case):
    """The backward's wrapper checks its operands before it builds or
    launches anything: CPU tensors, fp16, mismatched shapes and an h0 of
    another width are refused here, on the CPU."""
    la, dy = torch.zeros(2, 5, 8), torch.zeros(2, 5, 8)
    y, h0 = torch.zeros(2, 5, 8), torch.zeros(2, 8)
    err = ValueError
    if case == "fp16":
        la, y, dy, h0, err = la.half(), y.half(), dy.half(), h0.half(), \
            TypeError
    elif case == "shape":
        dy = torch.zeros(2, 6, 8)
    elif case == "h0":
        h0 = torch.zeros(2, 4)
    with pytest.raises(err):
        rglru_scan_bwd_cuda(la, h0, y, dy)
