"""The port's dense, moe, vlm and audio models, and ``LM.loss`` of every
ported family, against the JAX package on the CPU.

Weights come from the JAX ``LM.init``, the norms' weights and biases and
the QKV biases moved off their init (ones and zeros) by a seeded draw,
flattened as checkpoints flatten them and carried over with
``repro_torch.bridge``; tokens (and the encoder-decoder's frame
embeddings) are drawn with numpy. The reduced configs have 4 query heads
over 2 KV heads; ``starcoder2_15b+g12`` gives the reduced StarCoder2 12
query heads over one KV head, StarCoder2-15B's group of 12. Tolerances:
1e-4 on logits and on the loss against JAX (fp32, two layers, other sum
orders); 2e-3 for prefill+decode against teacher forcing and 1e-5 for
per-slot against scalar positions, as test_model_consistency.py (whose MoE
cases make the prefill dropless with capacity_factor E / k). The MoE
routes by argmax over fp32 gates: a failure message gives the smallest
gap between neighbouring top-k gates the port's routing saw, since a gap
under 1e-6 can flip a choice between the packages.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import ARCH_ALIASES, get_config  # noqa: E402
from repro_torch.models import LM, moe_layer  # noqa: E402

G12 = "starcoder2_15b+g12"
# the dense, vlm, moe and audio configs, and StarCoder2's group of 12
ARCHS = ["llama31_8b", "qwen1_5_4b", "granite_3_8b", "llama3_405b",
         "starcoder2_15b", "chameleon_34b", "phi3_5_moe", "llama4_maverick",
         "whisper_large_v3", G12]
# every ported config; the hybrid's and the ssm family's model tests are in
# test_torch_rglru.py and test_torch_xlstm.py
PORTED = ARCHS[:-1] + ["recurrentgemma_2b", "xlstm_350m"]
LOGIT_TOL = 1e-4
# leaves that init draws as ones (norm weights) or zeros (norm and QKV
# biases)
_CONSTANT_INIT = ("w", "b", "bq", "bk", "bv", "q_norm", "k_norm")


def _configs(arch, dropless=False):
    """(JAX config, port config), reduced; ``dropless`` sets an MoE's
    capacity_factor to E / k, so its prefill drops no token either."""
    name = arch.split("+")[0]
    pair = (jax_config(name).reduced(), get_config(name).reduced())
    if arch == G12:
        pair = tuple(dataclasses.replace(c, n_heads=12, n_kv_heads=1)
                     for c in pair)
    if dropless and pair[1].n_experts:
        pair = tuple(dataclasses.replace(
            c, capacity_factor=c.n_experts / c.top_k) for c in pair)
    return pair


def _batch(cfg, toks, seed=0):
    """numpy inputs of a forward pass: the tokens, and for the
    encoder-decoder frame embeddings (B, encoder_seq, d_model)."""
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["enc_feats"] = 0.5 * np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


class _GateGaps:
    """Records, through the port's MoE routing, the smallest gap between
    neighbouring top-k gates of a token (the k-th against the next one
    too): a gap under 1e-6 can flip an argmax between the packages."""

    def __init__(self, monkeypatch):
        self.smallest = float("inf")
        route = moe_layer.route

        def recording(gates, k, C):
            top = torch.topk(gates, min(k + 1, gates.shape[-1]), -1).values
            gap = float((top[..., :-1] - top[..., 1:]).min())
            self.smallest = min(self.smallest, gap)
            return route(gates, k, C)
        monkeypatch.setattr(moe_layer, "route", recording)

    def note(self) -> str:
        if self.smallest == float("inf"):
            return "no MoE routing"
        tie = " (a near tie)" if self.smallest < 1e-6 else ""
        return f"smallest top-k gate gap {self.smallest:.3g}{tie}"


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


def test_input_shapes_and_arch_ids_match_jax():
    """``InputShape``, ``INPUT_SHAPES`` and ``ARCH_IDS``, copied into the
    port's ``configs/base.py``."""
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
    from repro_torch.configs import ARCH_IDS as TORCH_ARCH_IDS
    from repro_torch.configs import INPUT_SHAPES
    assert TORCH_ARCH_IDS == ARCH_IDS
    assert list(INPUT_SHAPES) == list(JAX_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JAX_SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_jax_arch_loads_and_builds(arch):
    """Every architecture of the JAX package loads in the port, under its
    name and its alias, and builds its model."""
    cfg = get_config(arch)
    assert LM(cfg).cfg is cfg
    alias = next(a for a, n in ARCH_ALIASES.items() if n == arch)
    assert get_config(alias) == cfg == get_config(arch.replace("_", "-"))


@pytest.mark.parametrize("arch", PORTED)
def test_full_size_layout_matches_jax(arch):
    """The port's parameter layout at the published shape has the JAX
    tree's keys and shapes (by ``init_abstract``, nothing allocated)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        JaxLM(jax_config(arch)).init_abstract())[0]
    # keys joined as checkpoint._flatten joins them
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf.shape for path, leaf in leaves}
    cfg = get_config(arch)
    got = {k: tuple(shape) for k, (shape, _) in
           LM(cfg).mod.param_specs(cfg).items()}
    assert got == want


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
def test_logits_match_jax(monkeypatch, arch, window):
    jlm, jparams, lm, params = _pair(arch)
    gaps = _GateGaps(monkeypatch)
    B, S, P = 2, 20, 13
    toks = _tokens(lm.cfg, B, S)
    batch = _batch(lm.cfg, toks)
    jfull, jaux = jlm.forward_train(jparams, _jax(batch), remat=False,
                                    window=window)
    full, aux = lm.forward_train(params, _torch(batch), window=window)
    assert _err(full, jfull) < LOGIT_TOL, gaps.note()
    assert abs(float(aux) - float(jaux)) < 1e-6, gaps.note()

    jdecode = jax.jit(functools.partial(jlm.decode_step, window=window))
    jcache = jlm.init_cache(B, S, dtype=jnp.float32, window=window)
    prompt = {**batch, "tokens": toks[:, :P]}
    jlg, jcache = jlm.prefill(jparams, _jax(prompt), jcache, window=window)
    cache = lm.init_cache(B, S, dtype=torch.float32, window=window,
                          device="cpu")
    lg, cache = lm.prefill(params, _torch(prompt), cache, window=window)
    assert _err(lg, jlg) < LOGIT_TOL, gaps.note()
    for t in range(P, S):
        jlg, jcache = jdecode(jparams, jnp.asarray(toks[:, t]), jcache)
        lg, cache = lm.decode_step(params, torch.from_numpy(toks[:, t]),
                                   cache, window=window)
        assert _err(lg, jlg) < LOGIT_TOL, (t, gaps.note())
    kv = [(cache["slots"][i], jcache["slots"][i])
          for i in range(len(cache["slots"]))] if "slots" in cache else \
        [(cache, jcache)]
    for ours, theirs in kv:
        for name in ours:
            if name != "pos":
                assert _err(ours[name], theirs[name]) < 1e-5, name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 8])
def test_prefill_decode_matches_teacher_forcing(arch, window):
    cfg = _configs(arch, dropless=True)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(1), device="cpu")
    B, S, P = 2, 24, 16
    toks = _tokens(cfg, B, S, seed=1)
    batch = _torch(_batch(cfg, toks, seed=1))
    full, _ = lm.forward_train(params, batch, window=window)
    cache = lm.init_cache(B, S + 4, dtype=torch.float32, window=window,
                          device="cpu")
    lg, cache = lm.prefill(params, {**batch, "tokens": batch["tokens"][:, :P]},
                           cache, window=window)
    errs = [_err(lg, full[:, P - 1])]
    for t in range(P, S):
        lg, cache = lm.decode_step(params, batch["tokens"][:, t], cache,
                                   window=window)
        errs.append(_err(lg, full[:, t]))
    assert max(errs) < 2e-3, (arch, errs)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


@pytest.mark.parametrize("arch", ARCHS)
def test_vector_pos_decode_matches_scalar(arch):
    cfg = _configs(arch)[1]
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(3), device="cpu")
    B, P = 2, 12
    batch = _torch(_batch(cfg, _tokens(cfg, B, P, seed=3), seed=3))
    cache = lm.init_cache(B, 24, dtype=torch.float32, device="cpu")
    lg_s, cache_s = lm.prefill(params, batch, cache)
    tok = torch.argmax(lg_s, -1)
    # decode writes the cache in place: give the vector-pos step its own copy
    cache_v = {**_clone(cache_s),
               "pos": torch.full((B,), P, dtype=torch.int32)}
    lg1, _ = lm.decode_step(params, tok, cache_s)
    lg2, _ = lm.decode_step(params, tok, cache_v)
    assert _err(lg1, lg2) < 1e-5


@pytest.mark.parametrize("arch,window", [
    ("qwen1_5_4b", None), ("starcoder2_15b", None), ("chameleon_34b", 8),
    ("phi3_5_moe", None), ("llama4_maverick", None),
    ("whisper_large_v3", None), ("recurrentgemma_2b", None),
    ("xlstm_350m", None)])
def test_loss_matches_jax(monkeypatch, arch, window):
    """``LM.loss`` of every family against the JAX loss (with the MoE's
    0.01 aux), with labels masked (< 0) at the end of each row and in a
    stretch of the first; a batch with every label masked gives 0 plus the
    MoE's aux term."""
    jlm, jparams, lm, params = _pair(arch)
    gaps = _GateGaps(monkeypatch)
    B, S = 2, 20
    toks = _tokens(lm.cfg, B, S, seed=4)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3:9] = -1
    batch = _batch(lm.cfg, toks, seed=4)
    for lab in (labels, np.full_like(labels, -1)):
        jloss = jlm.loss(jparams, _jax({**batch, "labels": lab}),
                         window=window, remat=False)
        loss = lm.loss(params, _torch({**batch, "labels": lab}),
                       window=window)
        assert loss.shape == () and loss.dtype == torch.float32
        assert abs(float(loss) - float(jloss)) < LOGIT_TOL, gaps.note()
    _, aux = lm.forward_train(params, _torch(batch), window=window)
    assert float(loss) == pytest.approx(0.01 * float(aux), abs=1e-7)
    assert (float(aux) > 0) == bool(lm.cfg.n_experts)
