"""The port's dense and vlm transformer, and ``LM.loss`` of every ported
family, against the JAX package on the CPU.

Weights come from the JAX ``LM.init``, the norms' weights and biases and
the QKV biases moved off their init (ones and zeros) by a seeded draw,
flattened as checkpoints flatten them and carried over with
``repro_torch.bridge``; tokens are drawn with numpy. The reduced configs
have 4 query heads over 2 KV heads; ``starcoder2_15b+g12`` gives the
reduced StarCoder2 12 query heads over one KV head, StarCoder2-15B's group
of 12. Tolerances: 1e-4 on logits and on the loss against JAX (fp32, two
layers, other sum orders); 2e-3 for prefill+decode against teacher forcing
and 1e-5 for per-slot against scalar positions, as
test_model_consistency.py.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402

G12 = "starcoder2_15b+g12"
# the dense and vlm configs, and StarCoder2's group of 12
ARCHS = ["llama31_8b", "qwen1_5_4b", "granite_3_8b", "llama3_405b",
         "starcoder2_15b", "chameleon_34b", G12]
# every ported config; the hybrid's and the ssm family's model tests are in
# test_torch_rglru.py and test_torch_xlstm.py
PORTED = ARCHS[:-1] + ["recurrentgemma_2b", "xlstm_350m"]
LOGIT_TOL = 1e-4
# leaves that init draws as ones (norm weights) or zeros (norm and QKV
# biases)
_CONSTANT_INIT = ("w", "b", "bq", "bk", "bv", "q_norm", "k_norm")


def _configs(arch):
    """(JAX config, port config), reduced."""
    name = arch.split("+")[0]
    pair = (jax_config(name).reduced(), get_config(name).reduced())
    if arch == G12:
        pair = tuple(dataclasses.replace(c, n_heads=12, n_kv_heads=1)
                     for c in pair)
    return pair


def _moved_off_init(jparams, seed):
    """The leaves of ``_CONSTANT_INIT`` plus a seeded normal draw of 0.3,
    so that a dropped bias or weight shows."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        if str(getattr(path[-1], "key", "")) not in _CONSTANT_INIT:
            return x
        return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, jparams)


def _pair(arch, seed=1):
    """(JAX LM, JAX params, port LM, port params) on the same weights."""
    jcfg, cfg = _configs(arch)
    jlm = JaxLM(jcfg)
    jparams = _moved_off_init(jlm.init(jax.random.key(seed)), seed)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    return jlm, jparams, LM(cfg), params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               np.asarray(b, np.float32))))


@pytest.mark.parametrize("arch", PORTED)
def test_config_copy_matches_jax(arch):
    for j, t in ((jax_config(arch), get_config(arch)),
                 (jax_config(arch).reduced(), get_config(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_unported_arch_names_roadmap_item():
    # the ssm (A8) and vlm (A3) families are ported: their configs load and
    # build their models
    assert LM(get_config("xlstm-350m")).cfg.family == "ssm"
    assert LM(get_config("chameleon-34b")).cfg.family == "vlm"
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="ROADMAP item A5"):
            get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP item A9"):
        get_config("whisper-large-v3")
    for family, item in (("moe", "A5"), ("audio", "A9")):
        cfg = dataclasses.replace(get_config("qwen1_5_4b"), family=family)
        with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
            LM(cfg)
    # MoE layers in a dense config
    cfg = dataclasses.replace(get_config("qwen1_5_4b"), n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError, match="ROADMAP item A5"):
        LM(cfg)


@pytest.mark.parametrize("arch", PORTED)
def test_bridge_rejects_mismatched_tree(arch):
    _, jparams, lm, _ = _pair(arch)
    flat = _flatten(jparams)
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in flat.items() if k != "embed"},
                          lm.cfg, "cpu")
    if lm.cfg.family == "ssm":      # a tree of another sLSTM period
        with pytest.raises(KeyError):
            params_from_numpy(flat, dataclasses.replace(
                lm.cfg, n_layers=4, slstm_every=4), "cpu")
    if lm.cfg.family == "hybrid":   # a tree of another layer pattern
        with pytest.raises(KeyError):
            params_from_numpy(flat, dataclasses.replace(
                lm.cfg, n_layers=5, attn_pattern=("rec", "rec", "attn")),
                "cpu")
        lam = next(k for k in flat if k.endswith("/lam"))
        flat[lam] = flat[lam][..., :-1]
        with pytest.raises(ValueError):
            params_from_numpy(flat, lm.cfg, "cpu")
    flat["embed"] = flat["embed"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(flat, lm.cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 8])
def test_logits_match_jax(arch, window):
    jlm, jparams, lm, params = _pair(arch)
    B, S, P = 2, 20, 13
    toks = _tokens(lm.cfg, B, S)
    jfull, _ = jlm.forward_train(jparams, {"tokens": jnp.asarray(toks)},
                                 remat=False, window=window)
    full, _ = lm.forward_train(params, {"tokens": torch.from_numpy(toks)},
                               window=window)
    assert _err(full, jfull) < LOGIT_TOL

    jdecode = jax.jit(functools.partial(jlm.decode_step, window=window))
    jcache = jlm.init_cache(B, S, dtype=jnp.float32, window=window)
    jlg, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])},
                              jcache, window=window)
    cache = lm.init_cache(B, S, dtype=torch.float32, window=window,
                          device="cpu")
    lg, cache = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :P])},
                           cache, window=window)
    assert _err(lg, jlg) < LOGIT_TOL
    for t in range(P, S):
        jlg, jcache = jdecode(jparams, jnp.asarray(toks[:, t]), jcache)
        lg, cache = lm.decode_step(params, torch.from_numpy(toks[:, t]),
                                   cache, window=window)
        assert _err(lg, jlg) < LOGIT_TOL, t
    for name in ("k", "v"):
        assert _err(cache["slots"][0][name], jcache["slots"][0][name]) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 8])
def test_prefill_decode_matches_teacher_forcing(arch, window):
    cfg = _configs(arch)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(1), device="cpu")
    B, S, P = 2, 24, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=1))
    full, _ = lm.forward_train(params, {"tokens": toks}, window=window)
    cache = lm.init_cache(B, S + 4, dtype=torch.float32, window=window,
                          device="cpu")
    lg, cache = lm.prefill(params, {"tokens": toks[:, :P]}, cache,
                           window=window)
    errs = [_err(lg, full[:, P - 1])]
    for t in range(P, S):
        lg, cache = lm.decode_step(params, toks[:, t], cache, window=window)
        errs.append(_err(lg, full[:, t]))
    assert max(errs) < 2e-3, (arch, errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_vector_pos_decode_matches_scalar(arch):
    cfg = _configs(arch)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(3), device="cpu")
    B, P = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, P, seed=3))
    cache = lm.init_cache(B, 24, dtype=torch.float32, device="cpu")
    lg_s, cache_s = lm.prefill(params, {"tokens": toks}, cache)
    tok = torch.argmax(lg_s, -1)
    # decode writes the cache in place: give the vector-pos step its own copy
    cache_v = {"slots": tuple({n: t.clone() for n, t in s.items()}
                              for s in cache_s["slots"]),
               "pos": torch.full((B,), P, dtype=torch.int32)}
    lg1, _ = lm.decode_step(params, tok, cache_s)
    lg2, _ = lm.decode_step(params, tok, cache_v)
    assert _err(lg1, lg2) < 1e-5


@pytest.mark.parametrize("arch,window", [
    ("qwen1_5_4b", None), ("starcoder2_15b", None), ("chameleon_34b", 8),
    ("recurrentgemma_2b", None), ("xlstm_350m", None)])
def test_loss_matches_jax(arch, window):
    """``LM.loss`` of the dense, vlm, hybrid and ssm families against the
    JAX loss, with labels masked (< 0) at the end of each row and in a
    stretch of the first; a batch with every label masked gives 0."""
    jlm, jparams, lm, params = _pair(arch)
    B, S = 2, 20
    toks = _tokens(lm.cfg, B, S, seed=4)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3:9] = -1
    for lab in (labels, np.full_like(labels, -1)):
        jloss = jlm.loss(jparams, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(lab)},
                         window=window, remat=False)
        loss = lm.loss(params, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(lab)},
                       window=window)
        assert loss.shape == () and loss.dtype == torch.float32
        assert abs(float(loss) - float(jloss)) < LOGIT_TOL
    assert float(loss) == 0.0
