"""The port's RG-LRU scan and hybrid family (RecurrentGemma) against the JAX
package on the CPU.

The plain scan is held against the JAX Pallas kernel (interpret mode) at the
shapes of test_kernels.py and against the JAX reference at ragged shapes,
at 1e-4 as test_kernels.py (fp32, the recurrence summed in another order).
The hybrid model runs on weights from the JAX ``LM.init`` carried over with
``repro_torch.bridge``, for the reduced config (pattern (rec, attn), G=1, no
``rest``), a 5-layer variant with pattern (rec, rec, attn), which leaves
two unstacked ``rest`` rec layers, and a variant with layer norm, the GeLU
MLP and QK-norm (its norm weights and biases moved off their init). Tolerances: 1e-4 on logits (fp32, two to
five layers, other sum orders, the JAX prefill scans with
``associative_scan``); 1e-5 on the cache leaves (conv tail, h, k, v); 2e-3
for prefill+decode against teacher forcing and 1e-5 for per-slot against
scalar positions, as test_model_consistency.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_pallas  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.serving.engine import DisaggEngine  # noqa: E402

SCAN_TOL = 1e-4
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
ARCH = "recurrentgemma_2b"
VARIANTS = ["reduced", "rest", "layernorm"]

jax_rglru_ref_jit = jax.jit(jax_rglru_ref)


def _configs(variant):
    """(JAX config, port config) of a variant of the reduced hybrid."""
    pair = (jax_config(ARCH).reduced(), get_config(ARCH).reduced())
    if variant == "rest":
        pair = tuple(dataclasses.replace(c, n_layers=5,
                                         attn_pattern=("rec", "rec", "attn"))
                     for c in pair)
    if variant == "layernorm":
        pair = tuple(dataclasses.replace(c, norm="layernorm", mlp="gelu",
                                         qk_norm=True) for c in pair)
    return pair


def _moved_off_init(jparams, seed):
    """The norms' weights and biases (init: ones and zeros) plus a seeded
    normal draw of 0.3, so that a dropped bias or weight shows."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        if str(getattr(path[-1], "key", "")) not in ("w", "b"):
            return x
        return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, jparams)


@functools.lru_cache(maxsize=None)
def _pair(variant, seed=1):
    """(JAX LM, JAX params, port LM, port params) on the same weights (no
    test writes into the parameters)."""
    jcfg, cfg = _configs(variant)
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(seed))
    if variant == "layernorm":
        jparams = _moved_off_init(jparams, seed)
    return jlm, jparams, LM(cfg), params_from_numpy(_flatten(jparams), cfg,
                                                    "cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


def _scan_inputs(rng, B, S, W):
    la = -np.abs(rng.standard_normal((B, S, W))).astype(np.float32) * 0.2
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return la, x, h0


@pytest.mark.parametrize("B,S,W,chunk,bw", [
    (2, 512, 256, 128, 128),
    (1, 256, 128, 256, 64),
    (3, 1024, 384, 64, 128),
    (2, 128, 256, 32, 256),
])
def test_scan_plain_matches_pallas(B, S, W, chunk, bw):
    la, x, h0 = _scan_inputs(np.random.default_rng(S + W), B, S, W)
    ref = jax_rglru_pallas(jnp.asarray(la), jnp.asarray(x), jnp.asarray(h0),
                           chunk=chunk, bw=bw, interpret=True)
    out = rglru_scan(torch.from_numpy(la), torch.from_numpy(x),
                     torch.from_numpy(h0))
    assert out.dtype == torch.float32 and out.shape == (B, S, W)
    assert _err(out, ref) < SCAN_TOL


@pytest.mark.parametrize("B,S,W", [(2, 37, 200), (1, 5, 8), (1, 1, 3),
                                   (3, 70, 33)])
def test_scan_plain_matches_ref_ragged(B, S, W):
    la, x, h0 = _scan_inputs(np.random.default_rng(S * W), B, S, W)
    ref = jax_rglru_ref_jit(jnp.asarray(la), jnp.asarray(x), jnp.asarray(h0))
    out = rglru_scan(torch.from_numpy(la), torch.from_numpy(x),
                     torch.from_numpy(h0))
    assert _err(out, ref) < SCAN_TOL


def test_scan_dispatch_rejects_other_devices():
    t = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        rglru_scan(t, t, t[:, 0])


@pytest.mark.parametrize("variant", VARIANTS)
def test_param_layout_matches_jax(variant):
    """The port's random init has the JAX tree's keys, shapes and fp32
    ``lam`` (whatever the model dtype), and ``lam`` spans the JAX range."""
    jlm, jparams, lm, _ = _pair(variant)
    flat = _flatten(jparams)
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                     device="cpu")
    ours = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            ours["/".join(path)] = node
    walk(params, [])
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in flat.items()}
    for key, t in ours.items():
        want = torch.float32 if key.endswith("/lam") else torch.bfloat16
        assert t.dtype == want, key
    lam = [k for k in ours if k.endswith("/lam")]
    assert lam
    for key in lam:   # softplus(lam) = -log(u) for u in (0.9, 0.999)
        sp = torch.nn.functional.softplus(ours[key])
        assert float(sp.min()) > -np.log(0.999) - 1e-6
        assert float(sp.max()) < -np.log(0.9) + 1e-6
        jsp = jax.nn.softplus(flat[key])
        assert float(jsp.min()) > -np.log(0.999) - 1e-6


def _cache_leaves(cache):
    """Flat name -> array of a hybrid cache without ``pos``."""
    out = {}
    for level in ("slots", "rest"):
        for i, entry in enumerate(cache[level]):
            if isinstance(entry, dict):
                for k in ("k", "v"):
                    out[f"{level}/{i}/{k}"] = entry[k]
            else:
                out[f"{level}/{i}/tail"], out[f"{level}/{i}/h"] = entry
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_and_cache_match_jax(variant):
    """forward_train, then prefill 20 tokens and decode past the reduced
    window of 32 (the rotating cache wraps), on bridged weights."""
    jlm, jparams, lm, params = _pair(variant)
    assert lm.cfg.window == 32
    B, S, P = 2, 40, 20
    toks = _tokens(lm.cfg, B, S)
    jfull, _ = jax.jit(lambda p, t: jlm.forward_train(
        p, {"tokens": t}, remat=False))(jparams, jnp.asarray(toks))
    full, _ = lm.forward_train(params, {"tokens": torch.from_numpy(toks)})
    assert _err(full, jfull) < LOGIT_TOL

    jprefill = jax.jit(lambda p, t, c: jlm.prefill(p, {"tokens": t}, c))
    jdecode = jax.jit(jlm.decode_step)
    jcache = jlm.init_cache(B, 64, dtype=jnp.float32)
    jlg, jcache = jprefill(jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = lm.init_cache(B, 64, dtype=torch.float32, device="cpu")
    lg, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])},
                           cache)
    assert _err(lg, jlg) < LOGIT_TOL
    for t in range(P, S):
        jlg, jcache = jdecode(jparams, jnp.asarray(toks[:, t]), jcache)
        lg, cache = lm.decode_step(params, torch.from_numpy(toks[:, t]),
                                   cache)
        assert _err(lg, jlg) < LOGIT_TOL, t
    assert int(cache["pos"]) == int(jcache["pos"]) == S
    ours, theirs = _cache_leaves(cache), _cache_leaves(jcache)
    assert ours.keys() == theirs.keys()
    assert len(ours) == {"reduced": 4, "rest": 10,
                         "layernorm": 4}[variant]
    for name in ours:
        assert ours[name].shape == theirs[name].shape, name
        assert _err(ours[name], theirs[name]) < CACHE_TOL, name


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_decode_matches_teacher_forcing(variant):
    cfg = _configs(variant)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(1), device="cpu")
    B, S, P = 2, 40, 20
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=1))
    full, _ = lm.forward_train(params, {"tokens": toks})
    cache = lm.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
    lg, cache = lm.prefill(params, {"tokens": toks[:, :P]}, cache)
    errs = [_err(lg, full[:, P - 1])]
    for t in range(P, S):
        lg, cache = lm.decode_step(params, toks[:, t], cache)
        errs.append(_err(lg, full[:, t]))
    assert max(errs) < 2e-3, errs


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("variant", VARIANTS)
def test_vector_pos_decode_matches_scalar(variant):
    cfg = _configs(variant)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(3), device="cpu")
    B, P = 2, 36   # past the window: the rotating cache has wrapped
    toks = torch.from_numpy(_tokens(cfg, B, P, seed=3))
    cache = lm.init_cache(B, 48, dtype=torch.float32, device="cpu")
    lg_s, cache_s = lm.prefill(params, {"tokens": toks}, cache)
    tok = torch.argmax(lg_s, -1)
    # decode writes the cache in place: give the vector-pos step its own copy
    cache_v = _clone(cache_s)
    cache_v["pos"] = torch.full((B,), P, dtype=torch.int32)
    lg1, _ = lm.decode_step(params, tok, cache_s)
    lg2, _ = lm.decode_step(params, tok, cache_v)
    assert _err(lg1, lg2) < 1e-5


def test_engine_tokens_match_single_request_decode_across_window():
    """Prompts longer than the window (rotating fill at prefill) and decodes
    that wrap it, with the 5-layer variant's ``rest`` leaves inserted on
    batch dim 0: the engine's tokens are those of an isolated decode."""
    cfg = _configs("rest")[1]
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=64,
                       decode_slots=3, seed=7, device="cpu")
    rng = np.random.default_rng(0)
    for n in (12, 40, 29, 33):
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 8,
                   0.0)
    s = eng.run()
    assert s.n_finished == 4
    for req in eng.finished:
        cache = eng.lm.init_cache(1, 64, dtype=torch.float32, device="cpu")
        lg, cache = eng.lm.prefill(
            eng.params, {"tokens": torch.from_numpy(req.tokens)[None]}, cache)
        toks = [int(torch.argmax(lg[0]))]
        for _ in range(len(req.generated) - 1):
            lg, cache = eng.lm.decode_step(eng.params,
                                           torch.tensor([toks[-1]]), cache)
            toks.append(int(torch.argmax(lg[0])))
        assert toks == req.generated
