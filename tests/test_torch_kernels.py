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
    (2, 256, 10, 2, 64, 128, 200),    # G = 5 (llama4-maverick)
    (1, 512, 24, 2, 32, 256, 300),    # G = 12 (starcoder2-15b)
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
    # G = 5 and G = 12, which the bf16 kernel pads to its 16-row tile
    (3, 40, 10, 2, 16, [0, 17, 39], None),
    (3, 16, 10, 2, 16, [1, 15, 30], 16),
    (2, 48, 24, 2, 16, [1, 47], None),
    (3, 16, 12, 1, 16, [0, 16, 33], 16),
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


def test_plan_splits_covers_rows_and_fills_the_card():
    """The bf16 decode kernel's splits: chosen from B, K, Sc and the card
    (132 SMs; 2 blocks an SM at hd 128, 1 at hd 256) alone, the grid covers
    the SMs at both serve shapes unless the splits are already down to their
    least length (at RecurrentGemma's, 16 splits of 128 rows make 128
    blocks: 32 splits timed slower on the card), never holds more blocks
    than the card at once (the splits meet at a grid barrier), and the even
    cut of each slot's admitted rows over the splits (as each block derives
    it on the device) covers every row once."""
    from repro_torch.kernels.decode_attention.kernel import (
        SM90_MAX_SPLITS, SM90_MIN_SPLIT_ROWS, plan_splits)
    n_sm = 132
    for B, K, per_sm, want in ((8, 8, 2, 4), (8, 1, 1, 16)):
        n = plan_splits(B, K, 2048, n_sm, per_sm)    # llama, recurrentgemma
        assert n == want
        assert n * B * K >= n_sm or n == 2048 // SM90_MIN_SPLIT_ROWS
        assert n * B * K >= 0.95 * n_sm
    assert plan_splits(1, 1, 8192, n_sm, 1) == SM90_MAX_SPLITS
    for B, K, per_sm in ((100, 1, 1), (40, 2, 2), (64, 8, 2)):
        n = plan_splits(B, K, 2048, n_sm, per_sm)
        assert n == 1 or n * B * K <= per_sm * n_sm
    for B, K, Sc in ((8, 8, 2048), (8, 1, 2048), (1, 1, 16), (3, 2, 300),
                     (64, 8, 4096)):
        n = plan_splits(B, K, Sc, n_sm, 1)
        assert 1 <= n <= SM90_MAX_SPLITS
        for pos in (-1, 0, 1, 15, Sc - 2, Sc - 1, Sc, 3 * Sc):
            # as decode_attention_sm90.cu cuts them: evenly, rounded up to
            # whole 64-row tiles of the block's four warps
            n_valid = 0 if pos < 0 else min(pos + 1, Sc)
            chunk = -(-(-(-n_valid // n)) // 64) * 64
            rows = []
            for split in range(n):
                r0 = min(split * chunk, n_valid)
                rows += range(r0, min(r0 + chunk, n_valid))
            assert rows == list(range(n_valid))


def test_check_operands_refuses_autograd():
    """Under grad mode an operand that requires grad raises before any
    other check (a raw wrapper records no graph; the kernels differentiate
    through their autograd functions); under no_grad, or with no such
    operand, the next check (here: the device) decides."""
    from repro_torch.kernels import build
    x = torch.zeros(4, requires_grad=True)
    y = torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward"):
        build.check_operands(q=y, k=x)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            build.check_operands(q=y, k=x)
    with pytest.raises(ValueError, match="CUDA"):
        build.check_operands(q=y, k=x.detach())


@pytest.mark.parametrize("dtype,Hq,hd,match", [
    (torch.bfloat16, 17, 128, "1 to 16"),        # the bf16 kernel: G <= 16
    (torch.bfloat16, 12, 12, "multiple of 8"),   # 16-byte copies of rows
    (torch.float32, 3, 128, "query heads per KV head"),  # GROUP_SIZES
    (torch.float32, 12, 12, "CUDA"),             # fp32 takes hd 12 and G 12
])
def test_decode_cuda_wrapper_checks_each_route(dtype, Hq, hd, match):
    """The CUDA decode wrapper holds each dtype to its kernel's contract
    before it looks at the device: bf16 (the tensor-core kernel) takes any G
    up to 16 and head_dim a multiple of 8, fp32 (the CUDA-core kernel) the
    G of ``GROUP_SIZES`` and head_dim a multiple of 4. Input that passes
    fails next on the device check, since these tensors lie on the CPU."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    q = torch.zeros((2, 1, Hq, hd), dtype=dtype)
    cache = torch.zeros((2, 32, 1, hd), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        decode_attention_cuda(q, cache, cache, torch.tensor([0, 5]))
