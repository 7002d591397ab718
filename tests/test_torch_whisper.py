"""The port's encoder-decoder pieces (``repro_torch.models.whisper`` and the
cross-attention and sinusoidal embeddings of ``models/layers.py``) against
the JAX package on the CPU, on the reduced whisper-large-v3 with the JAX
weights (the norms' weights and biases moved off their init, so a dropped
one shows). Tolerances: 1e-5 on one cross-attention block and 1e-4 on the
encoder's output (two layers and a norm in fp32, other sum orders). The
sinusoidal embeddings: 1e-6 plus pos * 2^-23 at the largest position pos.
XLA's fp32 exp is not correctly rounded and torch's is, so the two
packages' frequencies (at most 1) differ by one ulp, 2^-24 or less, in
about one in fifteen of them; the angle pos * freq carries that over
multiplied by pos, and sin and cos change by no more than the angle. At the
encoder's 1500 positions the difference reaches 1.2e-4; below position 8
the bound is within 2e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.layers as JL  # noqa: E402
import repro.models.whisper as jax_whisper  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.params import layer_of  # noqa: E402

ARCH = "whisper_large_v3"


def _sin_tol(positions) -> float:
    return 1e-6 + 2.0 ** -23 * float(np.max(positions))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX params, port config, port params), reduced."""
    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    rng = np.random.default_rng(0)
    jparams = jax_whisper.init_params(jcfg, jax.random.key(2), jnp.float32)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.3 * rng.standard_normal(x.shape).astype(
            np.float32) if str(path[-1].key) in ("w", "b", "bq", "bk", "bv")
        else x, jparams)
    return jcfg, jparams, cfg, params_from_numpy(_flatten(jparams), cfg,
                                                 "cpu")


@pytest.mark.parametrize("d_model", [256, 1280])
@pytest.mark.parametrize("positions", [
    np.arange(1500), np.array([[3, 4, 5]]), np.array([[0], [1], [7]]),
    np.array([[0], [7], [447]])])
def test_sinusoidal_pos_matches_jax(d_model, positions):
    want = JL.sinusoidal_pos(jnp.asarray(positions), d_model, jnp.float32)
    got = L.sinusoidal_pos(torch.from_numpy(positions), d_model,
                           torch.float32)
    assert got.shape == (*positions.shape, d_model)
    assert _err(got, want) < _sin_tol(positions)


@pytest.mark.parametrize("pos0", [0, 9, np.array([0, 5, 30], np.int32)])
def test_decoder_embedding_matches_jax(pair, pos0):
    """Token plus sinusoidal embeddings from a scalar first position or
    per-slot positions (B,)."""
    jcfg, jparams, cfg, params = pair
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 1 if np.ndim(pos0) else 4)).astype(np.int32)
    want = jax_whisper._dec_embed(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos0))
    got = whisper._dec_embed(params, cfg, torch.from_numpy(toks),
                             torch.as_tensor(pos0))
    assert _err(got, want) < _sin_tol(np.asarray(pos0) + toks.shape[1])


def test_encode_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    feats = 0.5 * np.random.default_rng(2).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(jax_whisper.encode, static_argnums=1)(
        jparams, jcfg, jnp.asarray(feats))
    got = whisper.encode(params, cfg, torch.from_numpy(feats))
    assert got.shape == feats.shape
    assert _err(got, want) < 1e-4


@pytest.mark.parametrize("Sq", [1, 5])
def test_cross_attention_matches_jax(pair, Sq):
    """``cross_attn_cache`` (no bias, though the config has QKV bias) and
    ``cross_attn_apply`` (non-causal over all frames) of the first decoder
    layer, at decode's one query row and at a prompt's."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["dec"]["cross"])
    p = layer_of(params["dec"], 0)["cross"]
    assert "bq" not in p and "bq" in layer_of(params["dec"], 0)["attn"]
    jk, jv = JL.cross_attn_cache(jp, jnp.asarray(enc), jcfg)
    k, v = L.cross_attn_cache(p, torch.from_numpy(enc), cfg)
    assert k.shape == (2, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    assert _err(k, jk) < 1e-5 and _err(v, jv) < 1e-5
    want = JL.cross_attn_apply(jp, jnp.asarray(x), jcfg, jk, jv)
    got = L.cross_attn_apply(p, torch.from_numpy(x), cfg, k, v)
    assert _err(got, want) < 1e-5


def test_prefill_stores_cross_kv(pair):
    """Prefill writes every decoder layer's self and cross K and V into the
    cache, as the JAX prefill's cache holds them."""
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = jax_whisper.init_cache(jcfg, 2, 16, jnp.float32)
    _, jcache = jax.jit(jax_whisper.prefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(toks),
                        "enc_feats": jnp.asarray(feats)}, jcache)
    cache = whisper.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    _, cache = whisper.prefill(params, cfg, {
        "tokens": torch.from_numpy(toks),
        "enc_feats": torch.from_numpy(feats)}, cache)
    assert sorted(cache) == sorted(jcache)
    for name in ("k", "v", "ck", "cv"):
        assert cache[name].shape == jcache[name].shape
        assert _err(cache[name], jcache[name]) < 1e-4, name
    assert int(cache["pos"]) == 6
