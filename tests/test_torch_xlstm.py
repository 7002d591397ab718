"""The port's chunkwise mLSTM and xLSTM family against the JAX package on
the CPU.

The plain chunk scan is held against ``repro.models.xlstm._mlstm_chunk_scan``
(one to three chunks of 256, padded, from a zero and a non-zero state) and
against the JAX Pallas kernel (interpret mode) at the shapes of
test_kernels.py, at 2e-4 as test_kernels.py (fp32; outputs reach ~25,
summed in another order); the final state at 1e-5 (its entries stay below
~2). The sLSTM step and the mLSTM decode step against the JAX functions at
1e-5 (fp32, the same few elementwise ops). The model runs on weights from
the JAX ``LM.init`` carried over with ``repro_torch.bridge``, for the
reduced config (mLSTM + sLSTM, G = 1), a 4-layer variant (G = 2) and a
variant with layer norm (its weights and biases moved off their init):
1e-4 on logits (fp32, other sum orders), 1e-4 on the state leaves (the
sLSTM's normaliser n grows to ~6 over 270 steps); 2e-3 for prefill+decode
against teacher forcing and 1e-5 for per-slot against scalar positions, as
test_model_consistency.py. Prefills run past the 256-step chunk.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels.mlstm_chunk.ops import mlstm_chunk as jax_mlstm_pallas  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk  # noqa: E402
from repro_torch.models import LM, xlstm  # noqa: E402
from repro_torch.serving.engine import DisaggEngine  # noqa: E402

SCAN_TOL = 2e-4
STATE_TOL = 1e-5
STEP_TOL = 1e-5
LOGIT_TOL = 1e-4
MODEL_STATE_TOL = 1e-4
ARCH = "xlstm_350m"
VARIANTS = ["reduced", "stacked", "layernorm"]

jax_chunk_scan = jax.jit(jx._mlstm_chunk_scan)


def _configs(variant):
    """(JAX config, port config) of a variant of the reduced xLSTM."""
    pair = (jax_config(ARCH).reduced(), get_config(ARCH).reduced())
    if variant == "stacked":
        pair = tuple(dataclasses.replace(c, n_layers=4) for c in pair)
    if variant == "layernorm":
        pair = tuple(dataclasses.replace(c, norm="layernorm") for c in pair)
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


def _scan_inputs(rng, B, S, nh, hd):
    """Inputs as test_kernels.py draws them: k scaled by 1/sqrt(hd), forget
    gates log_sigmoid(N + 3)."""
    q = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    k = (rng.standard_normal((B, S, nh, hd)) / np.sqrt(hd)).astype(np.float32)
    v = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    li = (rng.standard_normal((B, S, nh)) * 0.5).astype(np.float32)
    lf = -np.logaddexp(0, -(rng.standard_normal((B, S, nh)) + 3.0))
    return q, k, v, li, lf.astype(np.float32)


def _scan_state(rng, B, nh, hd, nonzero):
    if not nonzero:
        return (np.zeros((B, nh, hd, hd), np.float32),
                np.zeros((B, nh, hd), np.float32),
                np.full((B, nh), -1e30, np.float32))
    return ((rng.standard_normal((B, nh, hd, hd)) * 0.1).astype(np.float32),
            (rng.standard_normal((B, nh, hd)) * 0.1).astype(np.float32),
            rng.standard_normal((B, nh)).astype(np.float32))


@pytest.mark.parametrize("S", [16, 300, 520])
@pytest.mark.parametrize("nonzero", [False, True])
def test_chunk_plain_matches_jax_scan(S, nonzero):
    """One, two and three chunks of 256 (the last padded), from the zero
    state and from a given one; h and the final (C, n, m)."""
    rng = np.random.default_rng(S + nonzero)
    B, nh, hd = 2, 2, 64
    ins = _scan_inputs(rng, B, S, nh, hd)
    state = _scan_state(rng, B, nh, hd, nonzero)
    jh, jstate = jax_chunk_scan(*map(jnp.asarray, ins),
                                tuple(map(jnp.asarray, state)))
    h, new = mlstm_chunk(*map(torch.from_numpy, ins),
                         tuple(map(torch.from_numpy, state)))
    assert h.dtype == torch.float32 and h.shape == (B, S, nh, hd)
    assert _err(h, jh) < SCAN_TOL
    for ours, theirs in zip(new, jstate):
        assert ours.shape == theirs.shape
        assert _err(ours, theirs) < STATE_TOL


@pytest.mark.parametrize("B,S,hd,chunk", [
    (2, 256, 64, 128), (1, 128, 32, 32), (3, 256, 128, 256),
])
def test_chunk_plain_matches_pallas(B, S, hd, chunk):
    """The shapes of test_kernels.py, heads folded into B (one head)."""
    q, k, v, li, lf = _scan_inputs(np.random.default_rng(S + hd), B, S, 1, hd)
    ref = jax_mlstm_pallas(jnp.asarray(q[:, :, 0]), jnp.asarray(k[:, :, 0]),
                           jnp.asarray(v[:, :, 0]), jnp.asarray(li[:, :, 0]),
                           jnp.asarray(lf[:, :, 0]), chunk=chunk,
                           interpret=True)
    state = tuple(map(torch.from_numpy, _scan_state(None, B, 1, hd, False)))
    h, _ = mlstm_chunk(*map(torch.from_numpy, (q, k, v, li, lf)), state)
    assert _err(h[:, :, 0], ref) < SCAN_TOL


def test_chunk_dispatch_rejects_other_devices():
    t = torch.zeros((1, 4, 1, 32), device="meta")
    g = torch.zeros((1, 4, 1), device="meta")
    with pytest.raises(ValueError):
        mlstm_chunk(t, t, t, g, g, (t, t, t))


def test_mlstm_decode_step_matches_jax():
    rng = np.random.default_rng(0)
    B, nh, hd = 3, 2, 32
    q, k, v, li, lf = (a[:, 0] for a in _scan_inputs(rng, B, 1, nh, hd))
    state = _scan_state(rng, B, nh, hd, True)
    jh, jstate = jx._mlstm_decode(*map(jnp.asarray, (q, k, v, li, lf)),
                                  tuple(map(jnp.asarray, state)))
    ours = tuple(torch.from_numpy(s.copy()) for s in state)
    h = xlstm._mlstm_decode(*map(torch.from_numpy, (q, k, v, li, lf)), ours)
    assert _err(h, jh) < STEP_TOL
    for o, t in zip(ours, jstate):   # written in place
        assert _err(o, t) < STEP_TOL


def test_slstm_step_matches_jax():
    rng = np.random.default_rng(1)
    jcfg, cfg = _configs("reduced")
    B, D, nh = 3, cfg.d_model, cfg.n_heads
    hd = D // nh
    r = (rng.standard_normal((nh, hd, 4 * hd)) / np.sqrt(hd)).astype(
        np.float32)
    pre = rng.standard_normal((B, 4 * D)).astype(np.float32)
    state = (rng.standard_normal((B, D)).astype(np.float32),
             np.abs(rng.standard_normal((B, D))).astype(np.float32) + 0.5,
             rng.standard_normal((B, D)).astype(np.float32),
             rng.standard_normal((B, D)).astype(np.float32))
    jnew = jx._slstm_step({"r": jnp.asarray(r)}, jcfg, jnp.asarray(pre),
                          tuple(map(jnp.asarray, state)))
    new = xlstm._slstm_step(torch.from_numpy(r), cfg, torch.from_numpy(pre),
                            tuple(map(torch.from_numpy, state)))
    for o, t in zip(new, jnew):
        assert _err(o, t) < STEP_TOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_param_layout_matches_jax(variant):
    """The port's random init has the JAX tree's keys and shapes, the model
    dtype, and the JAX gate bias: nh zeros, then nh entries of 3."""
    jlm, jparams, lm, _ = _pair(variant)
    flat = _flatten(jparams)
    specs = xlstm.param_specs(lm.cfg)
    assert {k: tuple(s) for k, (s, _) in specs.items()} == \
        {k: v.shape for k, v in flat.items()}
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                     device="cpu")
    nh = lm.cfg.n_heads
    b_if = params["slots"][0]["b_if"]
    assert b_if.dtype == torch.bfloat16
    want = np.concatenate([np.zeros(nh), np.full(nh, 3.0)])
    for g in range(b_if.shape[0]):
        assert np.array_equal(b_if[g].float().numpy(), want)
        assert np.array_equal(np.asarray(flat["slots/0/b_if"][g]), want)
    # the sLSTM's recurrent weights draw with fan-in hd, as the vmapped init
    r = params["slots"][1]["r"].float()
    hd = lm.cfg.d_model // nh
    assert abs(float(r.std()) * math.sqrt(hd) - 1) < 0.05
    assert abs(float(np.std(flat["slots/1/r"])) * math.sqrt(hd) - 1) < 0.05


def test_full_size_parameter_count_matches_jax():
    """xLSTM-350M as the reference builds it: 518,640,808 parameters (its
    wq/wk/wv are full inner x inner matrices) and an mLSTM head dim of 512."""
    cfg = get_config("xlstm-350m")
    specs = xlstm.param_specs(cfg)
    n = sum(math.prod(shape) for shape, _ in specs.values())
    shapes = jax.eval_shape(lambda k: jx.init_params(jax_config(ARCH), k),
                            jax.random.key(0))
    assert n == sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))
    assert n == 518_640_808
    assert specs["slots/7/r"][0] == (3, 4, 256, 1024)
    cache = xlstm.init_cache(cfg, 1, 0, device="meta")
    assert cache["slots"][0][0].shape == (3, 1, 4, 512, 512)
    assert sum(t.numel() * 4 for s in cache["slots"] for t in s) == 88_301_904


def _state_leaves(cache):
    """Flat name -> array of an xLSTM cache without ``pos``."""
    return {f"slots/{i}/{j}": t for i, st in enumerate(cache["slots"])
            for j, t in enumerate(st)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_and_state_match_jax(variant):
    """forward_train over 300 tokens, then prefill 270 (two chunks of the
    JAX scan, the second padded) and decode to 280, on bridged weights."""
    jlm, jparams, lm, params = _pair(variant)
    B, S, P = 2, 280, 270
    toks = _tokens(lm.cfg, B, 300)
    jfull, _ = jax.jit(lambda p, t: jlm.forward_train(
        p, {"tokens": t}, remat=False))(jparams, jnp.asarray(toks))
    full, _ = lm.forward_train(params, {"tokens": torch.from_numpy(toks)})
    assert _err(full, jfull) < LOGIT_TOL

    jprefill = jax.jit(lambda p, t, c: jlm.prefill(p, {"tokens": t}, c))
    jdecode = jax.jit(jlm.decode_step)
    jcache = jlm.init_cache(B, 0, dtype=jnp.float32)
    jlg, jcache = jprefill(jparams, jnp.asarray(toks[:, :P]), jcache)
    cache = lm.init_cache(B, 0, dtype=torch.float32, device="cpu")
    lg, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])},
                           cache)
    assert _err(lg, jlg) < LOGIT_TOL
    for t in range(P, S):
        jlg, jcache = jdecode(jparams, jnp.asarray(toks[:, t]), jcache)
        lg, cache = lm.decode_step(params, torch.from_numpy(toks[:, t]),
                                   cache)
        assert _err(lg, jlg) < LOGIT_TOL, t
    assert int(cache["pos"]) == int(jcache["pos"]) == S
    ours, theirs = _state_leaves(cache), _state_leaves(jcache)
    assert ours.keys() == theirs.keys() and len(ours) == 7
    for name in ours:
        assert ours[name].dtype == torch.float32
        assert ours[name].shape == theirs[name].shape, name
        assert _err(ours[name], theirs[name]) < MODEL_STATE_TOL, name


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_decode_matches_teacher_forcing(variant):
    cfg = _configs(variant)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(1), device="cpu")
    B, S, P = 2, 280, 260
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=1))
    full, _ = lm.forward_train(params, {"tokens": toks})
    cache = lm.init_cache(B, S, dtype=torch.float32, device="cpu")
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
    B, P = 2, 20
    toks = torch.from_numpy(_tokens(cfg, B, P, seed=3))
    cache = lm.init_cache(B, 32, dtype=torch.float32, device="cpu")
    lg_s, cache_s = lm.prefill(params, {"tokens": toks}, cache)
    tok = torch.argmax(lg_s, -1)
    # decode writes the state in place: give the vector-pos step its own copy
    cache_v = _clone(cache_s)
    cache_v["pos"] = torch.full((B,), P, dtype=torch.int32)
    lg1, c1 = lm.decode_step(params, tok, cache_s)
    lg2, c2 = lm.decode_step(params, tok, cache_v)
    assert _err(lg1, lg2) < 1e-5
    assert int(c1["pos"]) == P + 1 and c2["pos"].tolist() == [P + 1] * B


def test_engine_tokens_match_single_request_decode_past_a_chunk():
    """Prompts longer than the 256-step chunk and ragged ones: the engine's
    tokens (states inserted into the decode batch in place) are those of an
    isolated decode."""
    cfg = _configs("stacked")[1]
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=320,
                       decode_slots=3, seed=7, device="cpu")
    rng = np.random.default_rng(0)
    for n in (12, 300, 29, 257):
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 8,
                   0.0)
    s = eng.run()
    assert s.n_finished == 4
    for req in eng.finished:
        cache = eng.lm.init_cache(1, 0, dtype=torch.float32, device="cpu")
        lg, cache = eng.lm.prefill(
            eng.params, {"tokens": torch.from_numpy(req.tokens)[None]}, cache)
        toks = [int(torch.argmax(lg[0]))]
        for _ in range(len(req.generated) - 1):
            lg, cache = eng.lm.decode_step(eng.params,
                                           torch.tensor([toks[-1]]), cache)
            toks.append(int(torch.argmax(lg[0])))
        assert toks == req.generated
