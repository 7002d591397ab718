"""The port's attention kernels against the JAX package.

On the CPU the port's dispatchers run the plain versions; they are held
against the JAX Pallas kernels (interpret mode) at the shapes of
test_kernels.py, and against ``repro.models.layers`` for the inputs the
model layers feed (ragged lengths, query offsets, per-slot positions,
rotating windows, an idle slot whose position ran past the cache). The
CUDA kernels are held against these plain versions on the card in
test_torch_cuda.py. Inputs are drawn with numpy from a seed and given to
both packages.

Tolerances: 2e-5 in fp32, as test_kernels.py (the same math, summed in
another order); 3e-2 in bf16, as test_kernels.py (one bf16 rounding of the
output, |out| <~ 4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_pallas  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import rows_have_keys  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

FP32_TOL = 2e-5
BF16_TOL = 3e-2

# jitted, the layer references compile once per shape instead of op by op
jax_gqa_attention = jax.jit(JL.gqa_attention,
                            static_argnames=("causal", "window",
                                             "q_pos_offset"))
jax_decode_attention = jax.jit(JL.decode_attention,
                               static_argnames=("window",))


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


@pytest.mark.parametrize("B,S,Hq,K,hd,window", [
    (2, 256, 4, 2, 64, None),
    (1, 128, 2, 2, 128, None),
    (2, 256, 4, 4, 64, 64),
    (1, 512, 8, 2, 64, None),
])
def test_flash_plain_matches_pallas(B, S, Hq, K, hd, window):
    rng = np.random.default_rng(S + Hq + hd)
    q, k, v = (_normal(rng, B, S, Hq, hd), _normal(rng, B, S, K, hd),
               _normal(rng, B, S, K, hd))
    ref = jax_flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           window=window, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window)
    assert _err(out, ref) < FP32_TOL


@pytest.mark.parametrize("B,S,Hq,K,hd,bs,pos", [
    (2, 1024, 8, 2, 64, 256, 700),
    (1, 512, 4, 4, 128, 128, 511),
    (3, 512, 16, 2, 64, 512, 100),
    (2, 256, 8, 8, 64, 64, 0),
])
def test_decode_plain_matches_pallas(B, S, Hq, K, hd, bs, pos):
    rng = np.random.default_rng(S + Hq + pos)
    q, kc, vc = (_normal(rng, B, Hq, hd), _normal(rng, B, S, K, hd),
                 _normal(rng, B, S, K, hd))
    ref = jax_decode_pallas(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            pos, bs=bs, interpret=True)
    out = decode_attention(torch.from_numpy(q)[:, None], torch.from_numpy(kc),
                           torch.from_numpy(vc), pos)
    assert _err(out[:, 0], ref) < FP32_TOL


# (B, Sq, Skv, Hq, K, hd, causal, window, q_pos_offset)
GQA_CASES = [
    (2, 37, 37, 4, 2, 16, True, None, 0),      # ragged, GQA
    (1, 45, 45, 4, 4, 32, True, 8, 0),         # sliding window
    (2, 5, 29, 8, 2, 16, True, None, 24),      # query tail at an offset
    (1, 7, 19, 4, 1, 16, False, None, 0),      # not causal
    (1, 70, 70, 6, 3, 8, True, 33, 0),         # window across tiles
    # the edges of the bf16 tensor-core kernel's tiles, which the plain
    # version is held to on the card
    (1, 63, 63, 4, 2, 64, True, None, 0),
    (1, 65, 65, 4, 2, 64, True, None, 0),
    (1, 127, 127, 4, 2, 64, True, None, 0),
    (1, 129, 129, 4, 2, 64, True, None, 0),
    (1, 70, 70, 10, 1, 256, True, 33, 0),      # G = 10, hd 256, window
    (1, 20, 150, 4, 2, 64, True, None, 130),   # offset tail, Sq < Skv
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,K,hd,causal,window,off", GQA_CASES)
def test_flash_plain_matches_layers(B, Sq, Skv, Hq, K, hd, causal, window,
                                    off):
    rng = np.random.default_rng(Sq * Skv + hd)
    q, k, v = (_normal(rng, B, Sq, Hq, hd), _normal(rng, B, Skv, K, hd),
               _normal(rng, B, Skv, K, hd))
    ref = jax_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, q_pos_offset=off)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window,
                          q_pos_offset=off)
    assert out.shape == (B, Sq, Hq, hd)
    assert _err(out, ref) < FP32_TOL


def _check_bf16(seed, B, S, Hq, K, hd):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, B, S, Hq, hd), _normal(rng, B, S, K, hd),
               _normal(rng, B, S, K, hd))
    ref = jax_gqa_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    out = flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, Hq, hd)
    assert _err(out.float(), ref.astype(jnp.float32)) < BF16_TOL


def test_flash_plain_bf16_matches_layers():
    _check_bf16(3, 1, 33, 4, 2, 32)


def test_flash_plain_bf16_hd128_matches_layers():
    _check_bf16(4, 2, 129, 8, 2, 128)   # two tiles of the bf16 kernel


# (B, Sc, Hq, K, hd, pos, window): pos an int or a per-slot list
DECODE_CASES = [
    (2, 32, 4, 2, 16, 13, None),               # scalar pos
    (4, 32, 8, 2, 16, [0, 5, 31, 40], None),   # per-slot, one idle past Sc
    (4, 8, 4, 4, 16, [3, 7, 8, 20], 8),        # rotating window
    (2, 8, 4, 1, 16, 19, 8),                   # rotating, scalar pos
    (3, 300, 16, 2, 8, [299, 128, 1000], None),  # several 128-row splits
]


@pytest.mark.parametrize("B,Sc,Hq,K,hd,pos,window", DECODE_CASES)
def test_decode_plain_matches_layers(B, Sc, Hq, K, hd, pos, window):
    rng = np.random.default_rng(Sc * Hq + hd)
    q, kc, vc = (_normal(rng, B, 1, Hq, hd), _normal(rng, B, Sc, K, hd),
                 _normal(rng, B, Sc, K, hd))
    posn = np.asarray(pos, np.int32)
    ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(posn),
                               window=window)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(posn),
                           window=window)
    assert out.shape == (B, 1, Hq, hd)
    assert _err(out, ref) < FP32_TOL


def test_rows_have_keys():
    assert rows_have_keys(8, 8, True, None, 0)
    assert rows_have_keys(8, 8, True, 1, 0)
    assert not rows_have_keys(8, 8, True, None, -1)   # row 0 sees no key
    assert not rows_have_keys(4, 8, False, 2, 8)      # window past the keys
    assert rows_have_keys(4, 12, True, 3, 8)


def test_dispatch_rejects_other_devices():
    q = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError):
        decode_attention(q[:, :1], q, q, 0)
