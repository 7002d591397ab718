"""The port's model layers against ``repro.models.layers`` on the CPU:
norms, RoPE, the KV-cache writes (including a dropped out-of-range write and
the rotating fill) and the SwiGLU MLP. Inputs are drawn with numpy from a
seed and given to both packages.

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


@pytest.mark.parametrize("arch", ["llama31_8b", "qwen1_5_4b"])
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
