"""The engine's slot insertion: the port's ``_cache_insert`` against
``repro.serving.engine._cache_insert`` on the CPU, bitwise, for the three
cache layouts the families have: the encoder-decoder's top-level ``k``,
``v``, ``ck`` and ``cv`` (no ``slots`` level), the hybrid's stacked
``slots`` beside its unstacked ``rest`` (batch on dim 0), and a dense
model's ``slots``. Every leaf is filled from a seed, so a leaf left out or
written on the wrong dim shows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving.engine import _cache_insert as jax_cache_insert  # noqa: E402
from repro_torch.serving.engine import _cache_insert  # noqa: E402

B, L, S, K, HD = 3, 2, 6, 2, 4


def _layout(name, batch):
    """Leaf shapes of each layout (tuples stand for the ``slots`` and
    ``rest`` levels), with ``batch`` slots."""
    kv = {"k": (L, batch, S, K, HD), "v": (L, batch, S, K, HD)}
    if name == "audio":
        return {**kv, "ck": (L, batch, 5, K, HD), "cv": (L, batch, 5, K, HD)}
    if name == "hybrid":
        return {"slots": ({"conv": (L, batch, 3, 8), "h": (L, batch, 8)}, kv),
                "rest": ({"conv": (batch, 3, 8), "h": (batch, 8)},)}
    return {"slots": (kv,)}


def _fill(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _fill(v, rng) for k, v in shapes.items()}
    if isinstance(shapes, tuple) and isinstance(shapes[0], (dict, tuple)):
        return tuple(_fill(v, rng) for v in shapes)
    return rng.standard_normal(shapes).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("layout", ["audio", "hybrid", "dense"])
@pytest.mark.parametrize("slot", [0, 2])
def test_cache_insert_matches_jax(layout, slot):
    rng = np.random.default_rng(slot)
    dst = _fill(_layout(layout, B), rng)
    src = _fill(_layout(layout, 1), rng)
    want = jax_cache_insert(layout, {**_map(jnp.asarray, dst),
                                     "pos": jnp.zeros((), jnp.int32)},
                            {**_map(jnp.asarray, src),
                             "pos": jnp.asarray(S, jnp.int32)}, slot)
    got = _map(torch.from_numpy, dst)
    _cache_insert(got, {**_map(torch.from_numpy, src),
                        "pos": torch.tensor(S)}, slot)
    want, got = jax.device_get(want), _map(lambda t: t.numpy(), got)
    assert sorted(want) == sorted(got)
    for w, g in zip(_leaves(want), _leaves(got)):
        assert w.shape == g.shape and np.array_equal(w, g)
    # the slot took the source, and every other slot kept its values
    for d, s, g in zip(_leaves(dst), _leaves(src), _leaves(got)):
        bdim = next(i for i, (a, b) in enumerate(zip(d.shape, s.shape))
                    if a != b)
        assert np.array_equal(np.take(g, slot, bdim), np.take(s, 0, bdim))
        others = [i for i in range(B) if i != slot]
        assert np.array_equal(np.take(g, others, bdim),
                              np.take(d, others, bdim))
