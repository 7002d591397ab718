"""The port's training package against the JAX package's on the CPU: the
learning-rate schedule, AdamW (fp32 and bf16, clipping, weight decay on the
stacked layout), the sliced update, the token stream, checkpoints in both
directions, the ports of test_training.py and of test_system.py's
train-then-serve test, and the launcher.

Inputs come from numpy seeds. Tolerances: the schedule to 1e-7 of the
rate; fp32 parameters and moments within 1e-6 after each of three steps
(the same fp32 arithmetic, other sum orders in the global norm); bf16
parameters and moments within one bf16 step of the value (both sides round
fp32 arithmetic once); the sliced update bit for bit (elementwise
arithmetic, clipping off so the norm's sum order does not enter); the token
stream and fp32 checkpoints bit for bit.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.data import TokenStream as JaxTokenStream  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.serving.engine import DisaggEngine  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.data import TokenStream  # noqa: E402
from repro_torch.training.train_loop import train  # noqa: E402

FP32_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these models are small, and the suite's workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    """(port config, JAX config) of AdamW with the same settings."""
    state = kw.pop("state_dtype", "float32")
    return (opt.AdamWConfig(state_dtype=getattr(torch, state), **kw),
            jax_opt.AdamWConfig(state_dtype=getattr(jnp, state), **kw))


@pytest.mark.parametrize("step", [0, 3, 10, 40, 55, 99, 100, 150])
def test_lr_schedule_matches_jax(step):
    """Step 0, mid-warmup, the peak, mid-cosine, the end and past it."""
    cfg, jcfg = _cfgs(warmup_steps=10, total_steps=100)
    got = float(opt.lr_schedule(cfg)(step))
    want = float(jax_opt.lr_schedule(jcfg)(jnp.asarray(step)))
    assert abs(got - want) <= 1e-7 * cfg.lr
    if step >= 100:
        assert abs(got - 0.1 * cfg.lr) <= 1e-7 * cfg.lr


# leaves of the port's stacked layout: a stacked (G, D) norm weight, which
# has two dims and is decayed, a 1-D leaf, which is not, a matrix and a
# stacked matrix
SHAPES = {"embed": (16, 8), "final_norm/w": (8,),
          "slots/0/ln1/w": (2, 8), "slots/0/attn/wq": (2, 8, 4)}


def _tree(flat):
    """The port's nesting of SHAPES' keys (``slots`` a tuple), for either
    package."""
    return {"embed": flat["embed"], "final_norm": {"w": flat["final_norm/w"]},
            "slots": ({"ln1": {"w": flat["slots/0/ln1/w"]},
                       "attn": {"wq": flat["slots/0/attn/wq"]}},)}


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _steps(dtype: str, n_steps=3, **kw):
    """Run ``n_steps`` AdamW steps in both packages from the same params
    and per-step grads (large enough that the clip acts). Yields, after each
    step, the port's and JAX's (params, m, v) flattened to fp32 numpy, and
    both metrics."""
    cfg, jcfg = _cfgs(state_dtype=dtype, warmup_steps=2, total_steps=10,
                      **kw)
    p0 = _draws(0)
    # copies: the port updates in place, and jnp.asarray may share numpy's
    # memory
    params = _tree({k: torch.tensor(v).to(getattr(torch, dtype))
                    for k, v in p0.items()})
    jparams = _tree({k: jnp.asarray(v, getattr(jnp, dtype))
                     for k, v in p0.items()})
    state, jstate = opt.init_state(cfg, params), jax_opt.init_state(jcfg,
                                                                    jparams)
    for step in range(n_steps):
        g = _draws(step + 1, scale=3.0)
        grads = _tree({k: torch.from_numpy(v).to(getattr(torch, dtype))
                       for k, v in g.items()})
        jgrads = _tree({k: jnp.asarray(v, getattr(jnp, dtype))
                        for k, v in g.items()})
        params, state, metrics = opt.apply_updates(cfg, params, grads, state)
        jparams, jstate, jmetrics = jax_opt.apply_updates(jcfg, jparams,
                                                          jgrads, jstate)

        def port(tree):
            return {k: t.float().numpy() for k, t in flatten(tree).items()}

        def ref(tree):
            return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in path): np.asarray(x, np.float32)
                    for path, x in jax.tree_util.tree_flatten_with_path(
                        tree)[0]}
        yield ((port(params), port(state["m"]), port(state["v"])),
               (ref(jparams), ref(jstate["m"]), ref(jstate["v"])),
               metrics, jmetrics, int(state["count"]))


def test_apply_updates_matches_jax_fp32():
    for got, want, metrics, jmetrics, count in _steps("float32"):
        assert float(metrics["grad_norm"]) > 1.0         # the clip acts
        assert abs(float(metrics["grad_norm"]) -
                   float(jmetrics["grad_norm"])) < 1e-5
        assert float(metrics["lr"]) == pytest.approx(float(jmetrics["lr"]),
                                                     rel=1e-7)
        for tree, jtree in zip(got, want):
            assert sorted(tree) == sorted(jtree)
            for key in tree:
                assert np.max(np.abs(tree[key] - jtree[key])) < FP32_TOL, \
                    (count, key)


def test_apply_updates_matches_jax_bf16():
    """bf16 parameters and moments, within one bf16 step of JAX's."""
    for got, want, *_ in _steps("bfloat16"):
        for tree, jtree in zip(got, want):
            for key in tree:
                ref = jtree[key]
                step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref),
                                                           1e-30))) - 7)
                assert np.all(np.abs(tree[key] - ref) <= step), key


def test_weight_decay_by_leaf_rank():
    """With no gradient and no moments, a step is decay alone: a stacked
    (G, D) norm weight shrinks by lr * weight_decay, a 1-D leaf keeps its
    value, as the reference's ``p.ndim >= 2``."""
    cfg = opt.AdamWConfig(warmup_steps=1, total_steps=10, weight_decay=0.1)
    p0 = _draws(0)
    params = _tree({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    grads = _tree({k: torch.zeros(s) for k, s in SHAPES.items()})
    params, state, metrics = opt.apply_updates(
        cfg, params, grads, opt.init_state(cfg, params))
    lr = float(metrics["lr"])
    flat = flatten(params)
    assert torch.equal(flat["final_norm/w"],
                       torch.from_numpy(p0["final_norm/w"]))
    for key in ("slots/0/ln1/w", "slots/0/attn/wq", "embed"):
        np.testing.assert_allclose(flat[key].numpy(),
                                   p0[key] * (1 - lr * 0.1), rtol=1e-6)


def test_sliced_update_equals_whole(monkeypatch):
    """Slices of a row (and of one element) give the update of the whole
    leaf bit for bit; the clip is off, so the norm's sum order does not
    reach the update."""
    def run(slice_elements):
        monkeypatch.setattr(opt, "SLICE_ELEMENTS", slice_elements)
        cfg = opt.AdamWConfig(warmup_steps=1, total_steps=10,
                              grad_clip=1e9)
        params = _tree({k: torch.from_numpy(v) for k, v in _draws(0).items()})
        state = opt.init_state(cfg, params)
        for step in range(2):
            grads = _tree({k: torch.from_numpy(v)
                           for k, v in _draws(step + 1, 3.0).items()})
            params, state, metrics = opt.apply_updates(cfg, params, grads,
                                                       state)
        return [flatten(t) for t in (params, state["m"], state["v"])], \
            float(metrics["grad_norm"])
    whole, norm = run(1 << 30)
    for n in (1, 7, 33):
        sliced, sliced_norm = run(n)
        assert len(opt.slices(torch.zeros(2, 8, 4))) > 1
        assert sliced_norm == pytest.approx(norm, rel=1e-6)
        for a, b in zip(sliced, whole):
            for key in a:
                assert torch.equal(a[key], b[key]), (n, key)


def test_slices_are_views_along_dim0(monkeypatch):
    monkeypatch.setattr(opt, "SLICE_ELEMENTS", 64)
    t = torch.zeros(5, 4, 8)
    parts = opt.slices(t)
    assert [tuple(p.shape) for p in parts] == [(2, 4, 8)] * 2 + [(1, 4, 8)]
    assert all(p.data_ptr() == t[2 * i].data_ptr()
               for i, p in enumerate(parts))
    assert opt.slices(torch.zeros(8, 8))[0].shape == (8, 8)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [("qwen1_5_4b", 0),
                                       ("whisper_large_v3", 3)])
def test_token_stream_matches_jax(arch, seed):
    ours, ref = (TokenStream(get_config(arch).reduced(), seed=seed),
                 JaxTokenStream(jax_config(arch).reduced(), seed=seed))
    for B, S in ((4, 32), (2, 700), (1, 5)):     # past one refill
        a, b = ours.batch(B, S), ref.batch(B, S)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def _pair(arch="xlstm_350m"):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = JaxLM(jcfg).init(jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in jax_ckpt._flatten(jparams).items()}
    return jparams, flat, cfg


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_2b",
                                  "llama31_8b"])
def test_checkpoint_crosses_packages_fp32(tmp_path, arch):
    """A JAX checkpoint restores in the port and a port checkpoint in the
    JAX package, bit for bit, with the same key set."""
    jparams, flat, cfg = _pair(arch)
    params = params_from_numpy(flat, cfg, "cpu")
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ckpt.save(jpath, {"params": jparams}, step=5)
    ckpt.save(path, {"params": params}, step=6)
    with np.load(jpath) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
    template = {"params": LM(cfg).init(torch.Generator().manual_seed(9),
                                       device="cpu")}
    restored, step = ckpt.restore(jpath, template)
    assert step == 5
    for key, t in flatten(restored["params"]).items():
        np.testing.assert_array_equal(t.numpy(), flat[key])
    jrestored, jstep = jax_ckpt.restore(path[:-4], {"params": jparams})
    assert jstep == 6
    for key, v in jax_ckpt._flatten(jrestored["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), flat[key])


def test_bf16_checkpoint_roundtrips_bitwise(tmp_path):
    """bf16 parameters and AdamW state (stored widened to fp32) restore bit
    for bit into a bf16 template; the RG-LRU's fp32 lam stays fp32."""
    cfg = get_config("recurrentgemma_2b").reduced()
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                     device="cpu")
    ocfg = opt.AdamWConfig(state_dtype=torch.bfloat16)
    state = opt.init_state(ocfg, params)
    for t in flatten(state["m"]).values():
        t.normal_()
    tree = {"params": params, "opt": state}
    path = str(tmp_path / "bf16.npz")
    ckpt.save(path, tree, step=3)
    template = {"params": lm.init(torch.Generator().manual_seed(1),
                                  dtype=torch.bfloat16, device="cpu"),
                "opt": opt.init_state(ocfg, params)}
    restored, step = ckpt.restore(path, template)
    assert step == 3
    got, want = flatten(restored), flatten(tree)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key
    assert got["params/slots/0/rec/lam"].dtype == torch.float32


def test_checkpoint_rejects_a_shape_mismatch(tmp_path):
    path = str(tmp_path / "c.npz")
    ckpt.save(path, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {"w": torch.zeros(4, 3)})


# ---------------------------------------------------------------------------
# ports of tests/test_training.py and test_system.py's training test
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = get_config("qwen1_5_4b").reduced()
    ocfg = opt.AdamWConfig(lr=3e-3, grad_clip=10.0, total_steps=40,
                           warmup_steps=4, weight_decay=0.0)
    _, hist = train(cfg, steps=40, batch_size=4, seq_len=64, log_every=0,
                    remat=False, opt_cfg=ocfg, device="cpu")
    assert min(hist[-10:]) < hist[0] - 0.15


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("xlstm_350m").reduced()
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    path = os.path.join(tmp_path, "ck.npz")
    ckpt.save(path, {"params": params}, step=7)
    restored, step = ckpt.restore(path, {"params": params})
    assert step == 7
    want = flatten(params)
    for key, t in flatten(restored["params"]).items():
        assert torch.equal(t, want[key])


def test_data_pipeline_shapes_and_determinism():
    cfg = get_config("qwen1_5_4b").reduced()
    a = TokenStream(cfg, seed=3).batch(4, 32)
    b = TokenStream(cfg, seed=3).batch(4, 32)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 32)
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].max() < cfg.vocab_size


def test_enc_dec_batch_has_frontend_stub():
    cfg = get_config("whisper_large_v3").reduced()
    b = TokenStream(cfg, seed=0).batch(2, 16)
    assert b["enc_feats"].shape == (2, cfg.encoder_seq, cfg.d_model)


def test_train_then_serve_end_to_end(rng):
    cfg = get_config("qwen1_5_4b").reduced()
    params, hist = train(cfg, steps=8, batch_size=2, seq_len=32, log_every=0,
                         remat=False, device="cpu")
    assert all(np.isfinite(hist))
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=48,
                       decode_slots=2, device="cpu")
    eng.params = params                     # serve the trained weights
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                   6, 0.0)
    s = eng.run()
    assert s.n_finished == 3


def test_train_returns_detached_params_and_checkpoint(tmp_path):
    """``train`` with remat writes its final parameters to the checkpoint
    and returns them detached; a second run from the seed repeats the
    losses."""
    cfg = dataclasses.replace(get_config("recurrentgemma_2b").reduced(),
                              window=8)
    path = str(tmp_path / "t.npz")
    params, hist = train(cfg, steps=3, batch_size=2, seq_len=20,
                         log_every=0, ckpt_path=path, device="cpu")
    _, again = train(cfg, steps=3, batch_size=2, seq_len=20, log_every=0,
                     device="cpu")
    assert hist == again
    restored, step = ckpt.restore(path, {"params": params})
    assert step == 3
    for key, t in flatten(params).items():
        assert not t.requires_grad
        assert torch.equal(flatten(restored)[f"params/{key}"], t)


def test_train_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(get_config("qwen1_5_4b").reduced(), steps=1, batch_size=1,
              seq_len=8)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def test_launch_train_smoke_on_cpu(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train as launcher
    path = str(tmp_path / "smoke.npz")
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen1.5-4b", "--smoke", "--steps", "3",
        "--batch", "2", "--seq", "16", "--ckpt", path, "--device", "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "[train] qwen1.5-4b-smoke: loss" in out
    assert os.path.exists(path)


def test_launch_train_production_path_on_cpu(monkeypatch, capsys):
    """The production path (``build_train_step`` on a 1x1 mesh, bf16,
    train_4k's sequence, its batch cut to 1) with the config reduced: each
    step's loss printed, and the losses, grad norms and lr those of
    ``make_train_step`` on the same weights and ``TokenStream`` batches.
    Without a card and without --device cpu it raises."""
    from repro_torch.launch import train as launcher
    from repro_torch.training.train_loop import make_train_step
    cfg = get_config("llama3.1-8b").reduced()
    monkeypatch.setattr(launcher, "get_config", lambda arch: cfg)
    got = launcher.train_production(launcher.parse_args(
        ["--arch", "llama3.1-8b", "--mesh", "1x1", "--batch", "1",
         "--steps", "2", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "step 1 loss" in out
    assert "global batch 1, cut from 256" in out
    lm = LM(cfg)
    params = lm.init(torch.Generator("cpu").manual_seed(0),
                     dtype=torch.bfloat16, device="cpu")
    opt_cfg = opt.AdamWConfig(state_dtype=torch.bfloat16)
    state = opt.init_state(opt_cfg, params)
    step = make_train_step(lm, opt_cfg)
    data = TokenStream(cfg, seed=0)
    for m in got:
        batch = {k: torch.from_numpy(v) for k, v in
                 data.batch(1, 4096).items()}
        params, state, want = step(params, state, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert m[k] == float(want[k]), k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "llama3.1-8b", "--mesh", "1x1"])
