"""The arithmetic of the CUDA RG-LRU scan (``csrc/rglru_scan.cu``) on the
CPU, against the JAX package.

The kernel cannot run here, so a small torch emulation below repeats its
order of operations in fp32: each 32-step chunk scanned from a zero state
into its aggregate (A = sum of log_a, e = end state; steps past S decay by
exp(0) and add 0), the state entering each chunk found by composing the
aggregates of the chunks before it, nearest first, until a chunk whose
inclusive prefix (its last state) is published, and a rescan of the chunk
from that state, whose last state is the chunk's own inclusive prefix.
Where a look-back stops depends on timing on the card, so the emulation
takes each chunk's stop from a schedule: always the nearest chunk, always
chunk 0 (the chain reaches the prefix that composes h0), or drawn at
random. Held against JAX's ``rglru_scan_ref`` (jitted) and
``rglru_scan_pallas`` (interpret mode) at 1e-4, as test_kernels.py (fp32,
the recurrence composed in another order), at ragged S up to the served
3450 over narrow channels, with the decays the model draws and with
decays near 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru_scan.kernel import rglru_scan_pallas  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_scan_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import KERNEL_CHUNK  # noqa: E402

SCAN_TOL = 1e-4
SCHEDULES = ["nearest", "chunk0", "random"]

jax_scan_ref_jit = jax.jit(jax_scan_ref)


def lookback_scan(log_a, x, h0, schedule, seed=0, chunk=KERNEL_CHUNK):
    """The kernel's order of operations in fp32. log_a, x: (B, S, W);
    h0: (B, W). Returns (B, S, W)."""
    B, S, W = x.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    la = torch.nn.functional.pad(log_a, (0, 0, 0, pad)).view(B, nc, chunk, W)
    xs = torch.nn.functional.pad(x, (0, 0, 0, pad)).view(B, nc, chunk, W)
    a = torch.exp(la)
    # each chunk from a zero state: its aggregate (A, e)
    A = torch.zeros(B, nc, W)
    e = torch.zeros(B, nc, W)
    for i in range(chunk):
        A = A + la[:, :, i]
        e = a[:, :, i] * e + xs[:, :, i]
    rng = np.random.default_rng(seed)
    out = torch.empty(B, nc, chunk, W)
    inclusive = []
    for c in range(nc):
        if c == 0:
            h = h0.clone()
        else:
            stop = {"nearest": c - 1, "chunk0": 0,
                    "random": int(rng.integers(0, c))}[schedule]
            As = torch.zeros(B, W)     # chunks j+1 .. c-1 composed
            es = torch.zeros(B, W)
            for j in range(c - 1, stop, -1):
                es = torch.exp(As) * e[:, j] + es
                As = As + A[:, j]
            h = torch.exp(As) * inclusive[stop] + es
        for i in range(chunk):
            h = a[:, c, i] * h + xs[:, c, i]
            out[:, c, i] = h
        inclusive.append(h)
    return out.view(B, nc * chunk, W)[:, :S]


def _inputs(rng, B, S, W, decay):
    if decay == "model":
        # models/rglru.py _lru_gates: log_a = -8 softplus(lam) r with
        # a = sigmoid(lam) ~ U[0.9, 0.999]; x scaled by sqrt(1 - a^2)
        u = rng.uniform(0.9, 0.999, (B, S, W))
        r = rng.uniform(0.0, 1.0, (B, S, W))
        la = 8.0 * r * np.log(u)
        x = np.sqrt(np.maximum(1.0 - np.exp(2.0 * la), 1e-12)) * \
            rng.standard_normal((B, S, W))
    elif decay == "near1":
        la = rng.uniform(-0.01, 0.0, (B, S, W))
        x = rng.standard_normal((B, S, W))
    else:
        la = -np.abs(rng.standard_normal((B, S, W))) * 0.2
        x = rng.standard_normal((B, S, W))
    h0 = rng.standard_normal((B, W))
    return tuple(np.asarray(t, np.float32) for t in (la, x, h0))


def _err(ours, ref):
    return float(np.max(np.abs(ours.numpy() - np.asarray(ref))))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("B,S,W,decay", [
    (2, 37, 5, "plain"), (1, 1, 3, "plain"), (1, 31, 4, "near1"),
    (1, 32, 4, "model"), (1, 33, 4, "near1"), (1, 65, 4, "model"),
    (1, 206, 8, "model"), (2, 1000, 6, "near1"), (1, 3450, 8, "model"),
    (1, 3450, 8, "near1"),
])
def test_lookback_matches_jax_ref(schedule, B, S, W, decay):
    la, x, h0 = _inputs(np.random.default_rng(S * 7 + W), B, S, W, decay)
    ref = jax_scan_ref_jit(jnp.asarray(la), jnp.asarray(x), jnp.asarray(h0))
    out = lookback_scan(torch.from_numpy(la), torch.from_numpy(x),
                        torch.from_numpy(h0), schedule, seed=S)
    assert out.dtype == torch.float32 and out.shape == (B, S, W)
    assert _err(out, ref) < SCAN_TOL


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("decay", ["model", "near1"])
def test_lookback_matches_pallas(schedule, decay):
    B, S, W = 2, 1024, 128
    la, x, h0 = _inputs(np.random.default_rng(11), B, S, W, decay)
    ref = rglru_scan_pallas(jnp.asarray(la), jnp.asarray(x), jnp.asarray(h0),
                            chunk=256, bw=128, interpret=True)
    out = lookback_scan(torch.from_numpy(la), torch.from_numpy(x),
                        torch.from_numpy(h0), schedule, seed=3)
    assert _err(out, ref) < SCAN_TOL
