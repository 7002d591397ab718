"""The port's model layers against ``repro.models.layers`` on the CPU:
norms (RMS and layer norm), RoPE, the KV-cache writes (including a dropped
out-of-range write and the rotating fill), the attention block with QKV
bias and QK-norm, and the SwiGLU and GeLU MLPs. Inputs are drawn with numpy
from a seed and given to both packages.

Tolerances: 1e-5 for the fp32 math (the same formulas, with other sum
orders and transcendental implementations); cache writes are copies and
must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 1e-5


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 2, 5, 64), _normal(rng, 64)
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    """fp32 math, biased variance, cast back: in bf16 both round the same
    fp32 value once, so they may differ by one bf16 step (2^-7 of it)."""
    rng = np.random.default_rng(5)
    x = _normal(rng, 2, 5, 64) * 3 + 1
    w, b = _normal(rng, 64), _normal(rng, 64)
    ref = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                        jnp.asarray(b, dtype), 1e-5)
    out = TL.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w).to(getattr(torch, dtype)),
                        torch.from_numpy(b).to(getattr(torch, dtype)), 1e-5)
    assert str(out.dtype) == f"torch.{ref.dtype}"
    ref32 = np.asarray(ref, np.float32)
    lim = TOL if dtype == "float32" else 2 ** -7 * np.abs(ref32) + TOL
    assert np.all(np.abs(out.float().numpy() - ref32) <= lim)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_and_init_norm(kind):
    rng = np.random.default_rng(6)
    x = _normal(rng, 3, 4, 32)
    jp = JL.init_norm(None, 32, kind, jnp.float32)
    spec = TL.init_norm(32, kind)
    assert {k: (tuple(v.shape), float(v[0])) for k, v in jp.items()} == \
        {k: (shape, {"ones": 1.0, "zeros": 0.0}[init])
         for k, (shape, init) in spec.items()}
    p = {k: _normal(rng, 32) for k in spec}
    ref = JL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()}, kind, 1e-6)
    out = TL.apply_norm(torch.from_numpy(x), {k: torch.from_numpy(v)
                                              for k, v in p.items()},
                        kind, 1e-6)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("theta", [500_000.0, 1_000_000.0, 0.0])
@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rope(theta, per_slot):
    rng = np.random.default_rng(1)
    B, S, H, hd = 3, 1 if per_slot else 40, 4, 64
    x = _normal(rng, B, S, H, hd)
    if per_slot:                          # decode: one position per slot
        pos = np.array([[3], [40], [77]], np.int32)
    else:                                 # prefill: arange(S)
        pos = np.arange(S, dtype=np.int32)[None, :]
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("pos,window", [
    (5, None),                  # scalar
    (40, None),                 # scalar past the cache: clamped, as JAX
    ([0, 7, 15, 16, 99], None),  # per slot; 16 and 99 are dropped
    ([3, 8, 21, 0, 15], 8),     # rotating: slot pos mod Sc
])
def test_cache_update_decode(pos, window):
    rng = np.random.default_rng(2)
    B, Sc = 5, 16 if window is None else 8
    cache = _normal(rng, B, Sc, 2, 8)
    new = _normal(rng, B, 1, 2, 8)
    posn = np.asarray(pos, np.int32)
    ref = JL.cache_update_decode(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(posn), window=window)
    tc = torch.from_numpy(cache.copy())
    out = TL.cache_update_decode(tc, torch.from_numpy(new),
                                 torch.from_numpy(posn), window=window)
    assert out is tc                     # written in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cache_update_decode_drops_out_of_range_write():
    """An idle decode slot's position runs past the cache; its write must
    vanish and leave every other slot's write in place."""
    cache = torch.zeros((2, 4, 1, 2))
    new = torch.ones((2, 1, 1, 2))
    TL.cache_update_decode(cache, new, torch.tensor([1, 4], dtype=torch.int32))
    assert cache[0, 1].eq(1).all() and cache.sum() == 2


@pytest.mark.parametrize("S,Sc,window", [
    (6, 16, None),     # prompt shorter than the cache
    (20, 16, None),    # longer: the last Sc tokens at slot 0
    (20, 8, 8),        # rotating fill
    (5, 8, 8),         # rotating cache, prompt fits
])
def test_cache_fill_prefill(S, Sc, window):
    rng = np.random.default_rng(3)
    cache = np.zeros((2, Sc, 2, 8), np.float32)
    k = _normal(rng, 2, S, 2, 8)
    ref = JL.cache_fill_prefill(jnp.asarray(cache), jnp.asarray(k),
                                window=window)
    out = TL.cache_fill_prefill(torch.from_numpy(cache.copy()),
                                torch.from_numpy(k), window=window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen1_5_4b",
                                  "starcoder2_15b"])
def test_mlp_forward(arch):
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(4)
    p = {name: _normal(rng, *shape) * std
         for name, (shape, std) in TL.init_mlp(cfg).items()}
    x = _normal(rng, 2, 3, cfg.d_model)
    ref = JL.mlp_forward({n: jnp.asarray(a) for n, a in p.items()},
                         jnp.asarray(x), jax_config(arch).reduced())
    out = TL.mlp_forward({n: torch.from_numpy(a) for n, a in p.items()},
                         torch.from_numpy(x), cfg)
    assert _err(out, ref) < TOL


@pytest.mark.parametrize("arch,window", [
    ("chameleon_34b", None),     # QK-norm
    ("chameleon_34b", 8),
    ("starcoder2_15b", None),    # QKV bias, G = 2
])
def test_attention_block(arch, window):
    """The attention block's forward, prefill (output and caches) and one
    decode step at per-slot positions, on parameters drawn at random (the
    biases and QK-norm weights too, which init sets to 0 and 1)."""
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    rng = np.random.default_rng(7)
    p = {name: _normal(rng, *shape) * (0.3 if isinstance(init, str) else init)
         + (1.0 if init == "ones" else 0.0)
         for name, (shape, init) in TL.init_attention(cfg).items()}
    assert ("q_norm" in p) == cfg.qk_norm and ("bq" in p) == cfg.qkv_bias
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    B, S, Sc = 2, 11, 16
    x = _normal(rng, B, S, cfg.d_model)
    ref = JL.attn_forward(jp, jnp.asarray(x), jcfg, window=window)
    out = TL.attn_forward(tp, torch.from_numpy(x), cfg, window=window)
    assert _err(out, ref) < TOL
    kv = (B, min(Sc, window or Sc), cfg.n_kv_heads, cfg.head_dim)
    jo, jk, jv = JL.attn_prefill(jp, jnp.asarray(x), jcfg, jnp.zeros(kv),
                                 jnp.zeros(kv), window=window)
    o, k, v = TL.attn_prefill(tp, torch.from_numpy(x), cfg, torch.zeros(kv),
                              torch.zeros(kv), window=window)
    assert _err(o, jo) < TOL and _err(k, jk) < TOL and _err(v, jv) < TOL
    x1 = _normal(rng, B, 1, cfg.d_model)
    pos = np.array([S, S - 4], np.int32)
    jo, jk, jv = JL.attn_decode(jp, jnp.asarray(x1), jcfg, jk, jv,
                                jnp.asarray(pos), window=window)
    o, k, v = TL.attn_decode(tp, torch.from_numpy(x1), cfg, k, v,
                             torch.from_numpy(pos), window=window)
    assert _err(o, jo) < TOL and _err(k, jk) < TOL and _err(v, jv) < TOL
