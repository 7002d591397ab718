"""The gradient of the port's chunkwise mLSTM against the JAX package on the
CPU.

``mlstm_chunk_bwd_ref`` (the plain backward the CUDA backward,
``csrc/mlstm_chunk_bwd.cu``, is held against on the card, written out in
the kernel's passes) and autograd through ``mlstm_chunk_ref`` (what the
port's CPU path differentiates) against ``jax.vjp`` of
``repro.models.xlstm._mlstm_chunk_scan``, which the JAX model
differentiates with ``jax.grad``, with the cotangent on h only; and
against ``jax.vjp`` of the exact recurrence
``repro.kernels.mlstm_chunk.ref.mlstm_ref``, heads folded into B. One
chunk, a ragged S past two 256-step chunks, a fresh and a given state, and
the plain backward at the kernel's 64-step chunk. Inputs are drawn from
numpy seeds as ``make_inputs`` draws them (k scaled by 1/sqrt(hd), forget
gates log_sigmoid(N + 3)).

The plain backward treats the stabilisers (m_row, m_next, the state's m) as
constants, since h does not depend on them; ``jax.vjp`` sends gradient
through ``jnp.max`` to the argmax entries instead, terms that cancel
mathematically, so the two agree only to rounding. Tolerance: each
gradient within 3e-5 · max |g_jax| (fp32; the measured worst is 1.0e-5 of
the largest entry, at S=600 from the fresh state). In fp64 the plain
backward equals autograd through the plain forward to 1e-12 of the largest
entry (the decomposition is exact; measured ≤ 9.3e-16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_chunk.ref import mlstm_ref  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import (  # noqa: E402
    KERNEL_CHUNK, forward_states, plan, plan_bwd)
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import (  # noqa: E402
    CHUNK, mlstm_chunk_bwd_ref, mlstm_chunk_ref)

GRAD_TOL = 3e-5
EXACT_TOL = 1e-12
NAMES = ("dq", "dk", "dv", "dlog_i", "dlog_f")


def _inputs(seed, B, S, nh, hd, given):
    """((q, k, v, log_i, log_f), (C, n, m), dh) as numpy fp32, drawn as
    ``make_inputs`` draws them; the fresh state is the prefill's."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    q, v = randn(B, S, nh, hd), randn(B, S, nh, hd)
    k = randn(B, S, nh, hd) / np.float32(np.sqrt(hd))
    li = randn(B, S, nh) * np.float32(0.5)
    lf = (-np.logaddexp(0, -(randn(B, S, nh) + 3.0))).astype(np.float32)
    if given:
        state = (randn(B, nh, hd, hd) * np.float32(0.1),
                 randn(B, nh, hd) * np.float32(0.1), randn(B, nh))
    else:
        state = (np.zeros((B, nh, hd, hd), np.float32),
                 np.zeros((B, nh, hd), np.float32),
                 np.full((B, nh), -1e30, np.float32))
    return (q, k, v, li, lf), state, randn(B, S, nh, hd)


def _rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@jax.jit
def _jax_chunk_vjp(ins, state, dh):
    _, vjp = jax.vjp(lambda *a: jx._mlstm_chunk_scan(*a, state)[0], *ins)
    return vjp(dh)


@jax.jit
def _jax_exact_vjp(ins, state, dh):
    """``mlstm_ref`` (one head) on heads folded into B."""
    B, S, nh, hd = ins[0].shape

    def fold(a):
        return jnp.moveaxis(a, 2, 1).reshape(B * nh, S, *a.shape[3:])

    def h_of(q, k, v, li, lf):
        C, n, m = state
        h, _ = mlstm_ref(fold(q), fold(k), fold(v), fold(li), fold(lf),
                         C.reshape(B * nh, hd, hd), n.reshape(B * nh, hd),
                         m.reshape(B * nh))
        return jnp.moveaxis(h.reshape(B, nh, S, hd), 1, 2)
    _, vjp = jax.vjp(h_of, *ins)
    return vjp(dh)


# (B, S, nh, hd, given state, chunk of the plain backward)
CASES = [
    (2, 37, 2, 16, False, CHUNK),        # one chunk, fresh state
    (2, 37, 2, 16, True, CHUNK),         # one chunk, given state
    (1, 600, 2, 32, False, CHUNK),       # ragged, past two 256-step chunks
    (1, 600, 2, 32, True, CHUNK),
    (2, 300, 2, 32, True, KERNEL_CHUNK), # the kernel's chunk, ragged
    (1, 130, 1, 32, False, KERNEL_CHUNK),
    (1, 64, 2, 16, True, KERNEL_CHUNK),  # one full kernel chunk
]


@pytest.mark.parametrize("B,S,nh,hd,given,chunk", CASES)
def test_backward_matches_jax_chunk_scan(B, S, nh, hd, given, chunk):
    """The plain backward and autograd through the plain forward (at the
    plain backward's chunk) against ``jax.vjp`` of ``_mlstm_chunk_scan``
    (whose chunk is 256)."""
    ins, state, dh = _inputs(S + 7 * given, B, S, nh, hd, given)
    want = _jax_chunk_vjp(*(tuple(map(jnp.asarray, x))
                            for x in (ins, state)), jnp.asarray(dh))
    plain = mlstm_chunk_bwd_ref(*_torch(ins), _torch(state),
                                torch.from_numpy(dh), chunk=chunk)
    tins = [t.requires_grad_() for t in _torch(ins)]
    h, _ = mlstm_chunk_ref(*tins, _torch(state), chunk=chunk)
    autograd = torch.autograd.grad(h, tins, torch.from_numpy(dh))
    for name, got in (("plain backward", plain), ("autograd", autograd)):
        for g, w, what in zip(got, want, NAMES):
            assert tuple(g.shape) == w.shape, (name, what)
            assert _rel_err(g, w) <= GRAD_TOL, (name, what)


@pytest.mark.parametrize("B,S,nh,hd,given,chunk", [
    (2, 37, 2, 16, True, CHUNK), (1, 300, 2, 32, False, CHUNK),
    (1, 300, 2, 32, True, KERNEL_CHUNK)])
def test_backward_matches_jax_exact_recurrence(B, S, nh, hd, given, chunk):
    """The plain backward against ``jax.vjp`` of the step-by-step
    recurrence the chunkwise form stands for."""
    ins, state, dh = _inputs(S + 11 * given, B, S, nh, hd, given)
    want = _jax_exact_vjp(*(tuple(map(jnp.asarray, x))
                            for x in (ins, state)), jnp.asarray(dh))
    plain = mlstm_chunk_bwd_ref(*_torch(ins), _torch(state),
                                torch.from_numpy(dh), chunk=chunk)
    for g, w, what in zip(plain, want, NAMES):
        assert _rel_err(g, w) <= GRAD_TOL, what


@pytest.mark.parametrize("S,given,chunk", [(37, True, CHUNK),
                                           (300, False, KERNEL_CHUNK),
                                           (300, True, KERNEL_CHUNK),
                                           (520, True, CHUNK)])
def test_backward_is_autograd_of_the_plain_forward_in_fp64(S, given, chunk):
    """In fp64 the written-out passes equal autograd through the plain
    forward (which differentiates the stabilisers too) to rounding."""
    ins, state, dh = _inputs(S, 2, S, 2, 32, given)
    f64 = torch.float64
    plain = mlstm_chunk_bwd_ref(*_torch(ins, f64), _torch(state, f64),
                                torch.from_numpy(dh).double(), chunk=chunk)
    tins = [t.requires_grad_() for t in _torch(ins, f64)]
    h, _ = mlstm_chunk_ref(*tins, _torch(state, f64), chunk=chunk)
    autograd = torch.autograd.grad(h, tins, torch.from_numpy(dh).double())
    for g, w, what in zip(plain, autograd, NAMES):
        assert g.dtype == f64, what
        assert _rel_err(g, w) <= EXACT_TOL, what


def _clamp_share(q, k, li, lf) -> float:
    """The share of steps whose denominator is the clamp, |n_t . q_t| <
    exp(-m_t), by the exact recurrence (B = nh = 1)."""
    m, n, clamped = -1e30, np.zeros(q.shape[-1]), []
    for t in range(q.shape[1]):
        m_new = max(lf[0, t, 0] + m, li[0, t, 0])
        n = np.exp(lf[0, t, 0] + m - m_new) * n + \
            np.exp(li[0, t, 0] - m_new) * k[0, t, 0]
        m = m_new
        clamped.append(abs(n @ q[0, t, 0]) < np.exp(-m))
    return float(np.mean(clamped))


def test_backward_in_the_clamp_branch():
    """Where |a_t| < exp(-m_row_t) the denominator is the clamp and h does
    not depend on a_t: keys scaled by 0.3 from a fresh state put about
    three steps in four there, and the plain backward still matches
    ``jax.vjp``."""
    ins, state, dh = _inputs(3, 1, 150, 1, 16, False)
    q, k, v, li, lf = ins
    ins = (q, k * np.float32(0.3), v, li, lf)
    assert 0.5 < _clamp_share(q, ins[1], li, lf) < 1.0
    want = _jax_chunk_vjp(*(tuple(map(jnp.asarray, x))
                            for x in (ins, state)), jnp.asarray(dh))
    plain = mlstm_chunk_bwd_ref(*_torch(ins), _torch(state),
                                torch.from_numpy(dh), chunk=KERNEL_CHUNK)
    for g, w, what in zip(plain, want, NAMES):
        assert _rel_err(g, w) <= GRAD_TOL, what


def test_cpu_dispatch_differentiates_the_plain_version():
    """``ops.mlstm_chunk`` on CPU tensors is the plain version, whose
    autograd gradients are the plain backward's."""
    ins, state, dh = _inputs(5, 1, 90, 2, 32, True)
    tins = [t.requires_grad_() for t in _torch(ins)]
    h, _ = mlstm_chunk(*tins, _torch(state))
    got = torch.autograd.grad(h, tins, torch.from_numpy(dh))
    want = mlstm_chunk_bwd_ref(*_torch(ins), _torch(state),
                               torch.from_numpy(dh))
    for g, w, what in zip(got, want, NAMES):
        assert _rel_err(g.detach(), w) <= GRAD_TOL, what


def test_plan_bwd_at_the_training_shape():
    """xLSTM-350M's training step: B=1, S=4096, nh=4, hd=512."""
    p = plan_bwd(1, 4096, 4, 512)
    assert p["launches"] == 4 and p["chunks"] == 64
    assert p["blocks"] == {"weight": 1024, "state": 256, "grad": 3072,
                           "gate": 256}
    # as the head note of csrc/mlstm_chunk_bwd.cu states it; dC' takes as
    # much as the forward's chunk states
    assert p["workspace_bytes"] == 278_258_688
    assert p["workspace"]["dC"] == plan(1, 4096, 4, 512)["workspace"]["C"]


@pytest.mark.parametrize("B,S,nh,hd", [(1, 1, 1, 32), (2, 300, 2, 256),
                                       (1, 65, 3, 96)])
def test_forward_states_cut_the_workspace_as_the_kernel_lays_it_out(
        B, S, nh, hd):
    """C_c, n_c and m_c sit at the offsets of ``cut_workspace`` in
    ``csrc/mlstm_chunk.cu``: C first, then W, n, e, den, m."""
    p = plan(B, S, nh, hd)
    ws = torch.arange(p["workspace_bytes"] // 4, dtype=torch.float64)
    Cs, ns, ms = forward_states(ws, B, S, nh, hd)
    nc, bh, L = p["chunks"], B * nh, KERNEL_CHUNK
    assert Cs.shape == (bh, nc - 1, hd, hd) and ms.shape == (bh, nc - 1)
    n_at = bh * (nc - 1) * hd * hd + bh * nc * L * L
    m_at = n_at + bh * (nc - 1) * hd + 2 * bh * nc * L
    if nc > 1:
        assert float(Cs.flatten()[0]) == 0
        assert float(ns.flatten()[0]) == n_at
        assert float(ms.flatten()[0]) == m_at
    assert m_at + ms.numel() == ws.numel()
