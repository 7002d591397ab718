"""The port's steps (``repro_torch.launch.steps``), sharded training
through the collectives' backwards, ``shardspecs``' batch and cache specs
and the meshes of ``launch.mesh``, against the JAX package's, on the CPU.

One module-scoped run launches, at once, four ``gloo`` ranks of
``python -m repro_torch.launch.step_cases`` (one torch thread each, a file
rendezvous in the test's temporary directory) and ``JAX_PROCS`` JAX
processes (the train cases split among them, the last also running the
rest) with four host devices on ``Auto`` axes (jax 0.9's ``make_mesh`` makes
Explicit axes, which the JAX steps' ``constrain`` refuses), on the same
seeded weights and batches; the ranks are killed, and the run fails with
their output, past ``WALL_S``. Then, in fp32:

- ``build_train_step`` on meshes (1, 4), (2, 2) and (4, 1) for the reduced
  Llama-3.1-8B (the KV plans "gather", "own" and none; the vocabulary cut
  over "model"), on (2, 2, 1) and (2, 1, 2) over ("pod", "data", "model")
  (the batch over the flattened ("pod", "data")), on (1, 4) for a
  reduced StarCoder2 with one KV head of 34 (the "whole" plan, QKV bias),
  for the reduced Chameleon (QK-norm) and for the reduced Llama with a
  vocabulary of 510 (which 4 does not divide: held whole): loss, grad
  norm and lr at both of 2 steps, and every parameter block and AdamW's m
  and v after them, within 1e-5 max(1, max |ref|) of the JAX
  ``build_train_step``;
- ``build_prefill_step`` and ``build_serve_step`` under ``kv_seq`` on
  (1, 4) and under the heads' rule on (1, 4), (2, 2) and (2, 2, 1):
  tokens equal wherever the reference's top-2 gap exceeds the tolerance,
  caches within 1e-5;
- every leaf of ``BuiltStep.args`` at the full size of Llama-3.1-8B, for
  the four input shapes on (1, 4), (2, 2) and (2, 1, 2), against the JAX
  ``NamedSharding.shard_shape`` of the same leaf, but for a cache's
  KV-head dim: the rank's own heads (the JAX cache keeps every KV head on
  every rank of "model");
- ``LM.loss_terms`` with the vocabulary cut, on labels that hold -1 and
  the first and last id of every rank's block, against the JAX
  ``LM.loss`` and the port's outside rules;
- ``split_disagg_mesh`` on (4, 1) for n_prefill 1-3 and on (2, 2) against
  the JAX pools' devices, and an all-reduce in each pool;
- the gradients of ``all_gather``, ``all_reduce`` and ``entry``, over
  "model" and over the flattened ("pod", "data");
- ``make_production_mesh``'s refusal on a world of 4.

In the test process alone: ``batch_specs`` and ``cache_specs`` for all
five families against the JAX functions, ``effective_window`` for every
``ARCH_IDS`` x ``INPUT_SHAPES`` pair, the analytic FLOPs, and the
refusals that name A12.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import shardspecs as JSS  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import make_batch_specs  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import shardspecs as SS  # noqa: E402
from repro_torch.launch import step_cases as C  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
WALL_S = 150
SEED = 1
TOL = 1e-5
FEED_STEPS = 6
JAX_PROCS = 3     # the JAX side's processes (its compiles take the time)

JAX_SIDE = r"""
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.launch import shardspecs as SS
from repro.launch.mesh import batch_axes_for, split_disagg_mesh
from repro.launch.steps import build_step
from repro.models import LM
from repro.training.checkpoint import _flatten
from repro.training.optimizer import AdamWConfig, init_state

inp = dict(np.load(sys.argv[1]))
seed = int(sys.argv[3])
out = {}
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1), "2x2x1": (2, 2, 1),
          "2x1x2": (2, 1, 2)}


def mesh_of(tag):
    shape = MESHES[tag]
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    # constrain() takes only Auto axes
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))


def whole_kv(cfg):
    return dataclasses.replace(cfg, n_kv_heads=1, head_dim=34)


CONFIGS = {"llama": get_config("llama3.1-8b").reduced(),
           "starcoder2_whole": whole_kv(get_config("starcoder2-15b")
                                        .reduced()),
           "chameleon": get_config("chameleon-34b").reduced(),
           "llama_v510": dataclasses.replace(get_config("llama3.1-8b")
                                             .reduced(), vocab_size=510)}
PARAMS = {k: LM(c).init(jax.random.key(seed)) for k, c in CONFIGS.items()}


def paths(tree, is_leaf=None):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in leaves}


opt_cfg = AdamWConfig(state_dtype=jnp.float32)
for case in filter(None, sys.argv[4].split(",")):
    name, tag = case.split("/")
    pre = "train/v510/" if name == "llama_v510" else "train/"
    train_batch = {k: jnp.asarray(inp[pre + k]) for k in ("tokens", "labels")}
    mesh = mesh_of(tag)
    built = build_step(CONFIGS[name], mesh, InputShape("train_small", 16, 4,
                                                       "train"),
                       dtype=jnp.float32, opt_cfg=opt_cfg)
    params = jax.tree.map(jnp.array, PARAMS[name])
    opt = init_state(opt_cfg, params)
    with mesh:
        for i in range(2):
            params, opt, metrics = built.fn(params, opt, train_batch)
            for k, v in metrics.items():
                out[f"train/{case}/step{i}/{k}"] = np.asarray(v)
    for part, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for k, v in _flatten(tree).items():
            out[f"train/{case}/{part}/{k}"] = v

if sys.argv[5] != "rest":        # the train cases alone
    np.savez(sys.argv[2], **out)
    sys.exit(0)
cfg = CONFIGS["llama"]
lm = LM(cfg)
prompt = jnp.asarray(inp["serve/prompt"])
feed = jnp.asarray(inp["serve/feed"])
kv_seq = {"heads": None, "d_ff": None}
for case, tag, overrides, axis in (("kv_seq/1x4", "1x4", kv_seq, "model"),
                                   ("heads/1x4", "1x4", None, None),
                                   ("heads/2x2", "2x2", None, None),
                                   ("heads/2x2x1", "2x2x1", None, None)):
    mesh = mesh_of(tag)
    kw = dict(dtype=jnp.float32, rule_overrides=overrides, kv_seq_axis=axis)
    pre = build_step(cfg, mesh, InputShape("prefill_small", 32, 4, "prefill"),
                     **kw)
    dec = build_step(cfg, mesh, InputShape("decode_small", 32, 4, "decode"),
                     **kw)
    params = PARAMS["llama"]
    with mesh:
        tok, cache = pre.fn(params, {"tokens": prompt},
                            lm.init_cache(4, 32, dtype=jnp.float32))
        out[f"serve/{case}/prefill"] = np.asarray(tok)
        cache = dict(cache, pos=jnp.asarray(22, jnp.int32))
        for i in range(feed.shape[1]):
            tok, cache = dec.fn(params, feed[:, i], cache)
            out[f"serve/{case}/step{i}"] = np.asarray(tok)
    for i, slot in enumerate(cache["slots"]):
        for name in ("k", "v"):
            out[f"serve/{case}/cache/{i}/{name}"] = np.asarray(slot[name])
# the unsharded logits of the same feed: the tokens' top-2 gaps
params = PARAMS["llama"]
logits, cache = jax.jit(lm.prefill)(params, {"tokens": prompt},
                                    lm.init_cache(4, 32, dtype=jnp.float32))
out["serve/logits/prefill"] = np.asarray(logits)
cache = dict(cache, pos=jnp.asarray(22, jnp.int32))
decode = jax.jit(lm.decode_step)
for i in range(feed.shape[1]):
    logits, cache = decode(params, feed[:, i], cache)
    out[f"serve/logits/step{i}"] = np.asarray(logits)
out["loss/ref"] = np.asarray(jax.jit(lm.loss)(params, {
    k: jnp.asarray(inp["loss/" + k]) for k in ("tokens", "labels")}))

full = get_config("llama3.1-8b")
flm = LM(full)
for tag in ("1x4", "2x2", "2x1x2"):
    mesh = mesh_of(tag)
    for name, shape in INPUT_SHAPES.items():
        built = build_step(full, mesh, shape)
        baxes = batch_axes_for(shape.global_batch, mesh)
        p_specs = SS.param_specs(full, built.args[0], mesh)
        parts = {"params": (built.args[0], p_specs)}
        if shape.kind == "train":
            parts["opt"] = (built.args[1], {"m": p_specs, "v": p_specs,
                                            "count": P()})
            parts["batch"] = (built.args[2], SS.batch_specs(
                full, built.args[2], baxes))
        else:
            if shape.kind == "prefill":
                parts["batch"] = (built.args[1], SS.batch_specs(
                    full, built.args[1], baxes))
            else:
                parts["batch"] = ({"token": built.args[1]},
                                  {"token": P(baxes or None)})
            parts["cache"] = (built.args[2], SS.cache_specs(
                full, built.args[2], baxes))
        for part, (tree, specs) in parts.items():
            spec_of = paths(specs, lambda x: isinstance(x, P))
            for k, leaf in paths(tree).items():
                spec = spec_of[k]
                out[f"args/{tag}/{name}/{part}/{k}"] = np.asarray(
                    NamedSharding(mesh, spec).shard_shape(leaf.shape))

for tag, n in (("4x1", 1), ("4x1", 2), ("4x1", 3), ("2x2", 1)):
    mesh = mesh_of(tag)
    order = {d.id: r for r, d in enumerate(np.asarray(mesh.devices).flat)}
    pre, dec = split_disagg_mesh(mesh, n)
    for pool, m in (("pre", pre), ("dec", dec)):
        out[f"split/{tag}/{n}/{pool}"] = np.vectorize(
            lambda d: order[d.id])(np.asarray(m.devices))
np.savez(sys.argv[2], **out)
"""


# the JAX side's configs of ``step_cases.CONFIGS``
JAX_CFGS = {
    "llama": jax_config("llama3.1-8b").reduced(),
    "starcoder2_whole": dataclasses.replace(
        jax_config("starcoder2-15b").reduced(), n_kv_heads=1, head_dim=34),
    "chameleon": jax_config("chameleon-34b").reduced(),
    "llama_v510": dataclasses.replace(jax_config("llama3.1-8b").reduced(),
                                      vocab_size=C.VOCAB_UNEVEN),
}


def test_case_configs_match_jax():
    assert set(JAX_CFGS) == set(C.CONFIGS)
    for name, make in C.CONFIGS.items():
        assert dataclasses.asdict(make()) == dataclasses.asdict(JAX_CFGS[name])


def _inputs(path: Path) -> None:
    """The seeded inputs: the configs' weights as the JAX side draws them
    (``LM.init(key(SEED))``), a training batch with masked labels, a prompt
    and the serve steps' feed."""
    rng = np.random.default_rng(0)
    inp = {}
    for name, jcfg in JAX_CFGS.items():
        params = JaxLM(jcfg).init(jax.random.key(SEED))
        inp.update({f"w/{name}/{k}": np.asarray(v)
                    for k, v in _flatten(params).items()})
    B, S = C.TRAIN_SHAPE.global_batch, C.TRAIN_SHAPE.seq_len
    tokens = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[1, -5:] = -1
    labels[3, :3] = -1
    inp["train/tokens"] = tokens[:, :-1].copy()
    inp["train/labels"] = labels
    # the same batch within the 510 ids of llama_v510 (509 its last id)
    inp["train/v510/tokens"] = inp["train/tokens"] % C.VOCAB_UNEVEN
    inp["train/v510/labels"] = np.where(labels >= 0,
                                        labels % C.VOCAB_UNEVEN, labels)
    assert C.train_batch("llama_v510") == "train/v510"
    inp["serve/prompt"] = rng.integers(
        0, 512, (C.SERVE_PREFILL.global_batch,
                 C.SERVE_PREFILL.seq_len)).astype(np.int32)
    inp["serve/feed"] = rng.integers(
        0, 512, (C.SERVE_PREFILL.global_batch, FEED_STEPS)).astype(np.int32)
    # -1, then the first and last id of each of 4 blocks of 128 ids
    edges = [-1] + [i for r in range(4) for i in (128 * r, 128 * r + 127)]
    labels = rng.integers(0, 512, (2, 12)).astype(np.int32)
    labels[0, :len(edges)] = edges
    labels[1, -len(edges):] = edges[::-1]
    inp["loss/labels"] = labels
    inp["loss/tokens"] = rng.integers(0, 512, (2, 12)).astype(np.int32)
    np.savez(path, **inp)


def _tail(path: Path) -> str:
    return path.read_text()[-3000:] if path.exists() else ""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX side's outputs, each rank's outputs, the inputs)."""
    tmp = tmp_path_factory.mktemp("steps")
    t0 = time.perf_counter()
    _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cases = [case for case, _, _ in C.TRAIN_CASES]
    procs = []
    for name, cmd in [(f"jax{j}", [sys.executable, "-c", JAX_SIDE,
                                   str(tmp / "inputs.npz"),
                                   str(tmp / f"jax{j}.npz"), str(SEED),
                                   ",".join(cases[j::JAX_PROCS]),
                                   "rest" if j == JAX_PROCS - 1 else "-"])
                      for j in range(JAX_PROCS)] + [
            (f"rank{r}", [sys.executable, "-m",
                          "repro_torch.launch.step_cases",
                          "--rdv", str(tmp / "rdv"), "--rank", str(r),
                          "--world", str(WORLD),
                          "--inputs", str(tmp / "inputs.npz"),
                          "--out", str(tmp / f"rank{r}.npz")])
            for r in range(WORLD)]:
        log = tmp / f"{name}.log"
        with open(log, "w") as f:
            procs.append((name, log, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)))
    failed = None
    while failed is None and any(p.poll() is None for _, _, p in procs):
        if time.perf_counter() - t0 > WALL_S:
            failed = f"past {WALL_S} s"
        elif any(p.poll() not in (None, 0) for _, _, p in procs):
            failed = "a process failed"
        else:
            time.sleep(0.2)
    if failed is None and any(p.returncode for _, _, p in procs):
        failed = "a process failed"
    if failed is not None:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        pytest.fail(f"{failed}:\n" + "\n".join(
            f"--- {name} (exit {p.returncode}):\n{_tail(log)}"
            for name, log, p in procs))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    jx = {}
    for j in range(JAX_PROCS):
        jx.update(np.load(tmp / f"jax{j}.npz"))
    return jx, ranks, dict(np.load(tmp / "inputs.npz"))


def _shape(tag: str) -> tuple:
    return tuple(int(n) for n in tag.split("x"))


def _coords(rank: int, tag: str):
    """(batch, model) coordinates of a rank on mesh ``tag``: its data
    coordinate, or its ("pod", "data") one flattened (pod the most
    significant), and its model coordinate."""
    n_model = _shape(tag)[-1]
    return rank // n_model, rank % n_model


def _rel(a, b) -> float:
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _block(full: np.ndarray, local: np.ndarray, cfg, path: str, tag: str,
           rank: int) -> np.ndarray:
    """The rank's block of ``full`` as ``param_spec`` + ``sanitize_spec``
    place it (whole where the port keeps the leaf whole)."""
    if local.shape == full.shape:
        return full
    n_model = _shape(tag)[-1]
    spec = JSS.sanitize_spec(JSS.param_spec(cfg, path, full.ndim),
                             full.shape, _Mesh(n_model))
    sl = []
    _, m = _coords(rank, tag)
    for d, entry in enumerate(spec):
        if entry is None:
            sl.append(slice(None))
        else:
            n = full.shape[d] // local.shape[d]
            assert entry == "model" and n == n_model
            sl.append(slice(m * local.shape[d], (m + 1) * local.shape[d]))
    return full[tuple(sl)]


@pytest.mark.parametrize("case", [c for c, _, _ in C.TRAIN_CASES])
def test_train_step_matches_jax(runs, case):
    """Loss, grad norm and lr at each of 2 steps, then every parameter
    block and AdamW's m and v, within 1e-5 max(1, max |ref|)."""
    jx, ranks, _ = runs
    name, tag = case.split("/")
    cfg = JAX_CFGS[name]
    # the vocabulary is cut wherever the model axis divides it
    vocab_cut = _shape(tag)[-1] > 1 and cfg.vocab_size % _shape(tag)[-1] == 0
    for r, res in enumerate(ranks):
        got = res[f"train/{case}/params/embed"].shape[0]
        assert got == (cfg.vocab_size // _shape(tag)[-1] if vocab_cut else
                       cfg.vocab_size), (r, got)
        for i in range(C.TRAIN_STEPS):
            for k in ("loss", "grad_norm", "lr"):
                key = f"train/{case}/step{i}/{k}"
                assert _rel(res[key], jx[key]) < TOL, (r, key)
        n_blocks = 0
        for part in ("params", "m", "v"):
            pre = f"train/{case}/{part}/"
            paths = [k[len(pre):] for k in jx if k.startswith(pre)]
            assert {k[len(pre):] for k in res if k.startswith(pre)} == \
                set(paths)
            for path in paths:
                local = res[pre + path]
                want = _block(jx[pre + path], local, cfg, path, tag, r)
                n_blocks += want.shape != jx[pre + path].shape
                assert local.shape == want.shape, (r, part, path)
                assert _rel(local, want) < TOL, (r, part, path,
                                                 _rel(local, want))
        # on a model axis of 2 or 4 the explicit layers' leaves are blocks
        assert (n_blocks > 0) == (not tag.endswith("x1")), n_blocks


def test_train_cases_reach_each_kv_plan():
    """The reduced Llama on 1x4 gathers its KV heads, on 2x2 owns them;
    the starcoder2 variant keeps wk and wv whole, used in part."""
    from repro_torch.models import layers as L
    want = {("llama", 4): "gather", ("llama", 2): "own",
            ("starcoder2_whole", 4): "whole", ("chameleon", 4): "gather"}
    for (name, n), kv in want.items():
        with SH.use_rules(SH.standard_rules(False), _Mesh(n)):
            plan = L.head_plan(C.CONFIGS[name]())
            assert plan.kv == kv and plan.axis == "model", (name, n)
            parts = L.partial_leaves(C.CONFIGS[name]())
        assert ("wk" in parts) == (kv == "whole")
        assert "q_norm" in parts


def _clear(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tol = TOL * max(1.0, float(np.abs(logits).max()))
    return (top2[..., 1] - top2[..., 0]) > tol


@pytest.mark.parametrize("case", [c for c, _, _, _ in C.SERVE_CASES])
def test_prefill_and_serve_steps_match_jax(runs, case):
    """Each rank's rows of the tokens equal the JAX step's wherever the
    unsharded logits' top-2 gap exceeds the tolerance; its block of the
    cache (its rows under kv_seq, its KV heads under heads) within 1e-5."""
    jx, ranks, _ = runs
    tag = case.split("/")[1]
    n_model = _shape(tag)[-1]
    B = C.SERVE_PREFILL.global_batch * n_model // WORLD
    for r, res in enumerate(ranks):
        d, m = _coords(r, tag)
        rows = slice(d * B, (d + 1) * B)
        for name in ["prefill"] + [f"step{i}" for i in range(FEED_STEPS)]:
            got = res[f"serve/{case}/{name}"]
            want = jx[f"serve/{case}/{name}"][rows]
            assert got.dtype == np.int32 and want.dtype == np.int32
            clear = _clear(jx[f"serve/logits/{name}"][rows])
            assert clear.any()
            np.testing.assert_array_equal(got[clear], want[clear],
                                          err_msg=name)
        heads = res[f"serve/{case}/kv_heads"]
        for key in [k for k in res if k.startswith(f"serve/{case}/cache/")]:
            full = jx[key][:, rows]
            if case.startswith("kv_seq"):
                n = full.shape[2] // n_model
                full = full[:, :, m * n:(m + 1) * n]
            else:
                full = full[:, :, :, heads]
            assert res[key].shape == full.shape, key
            assert _rel(res[key], full) < TOL, key


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_built_args_have_jax_shard_shapes(runs, tag, shape):
    """Every leaf of ``BuiltStep.args`` (full-size Llama-3.1-8B, on the
    meta device) has the JAX leaf's ``shard_shape``, ``embed`` and
    ``unembed`` (and their m and v) cut over the vocabulary among them,
    but the cache's KV-head dim, which the JAX cache keeps whole on every
    rank of "model" and the port cuts to the KV heads of the rank's query
    heads (``head_plan``)."""
    jx, ranks, _ = runs
    pre = f"args/{tag}/{shape}/"
    want = {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}
    assert want
    full = get_config("llama3.1-8b")
    n_model = _shape(tag)[-1]
    for res in ranks:
        got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
        assert set(got) == set(want)
        for key, g in got.items():
            w = want[key].copy()
            if key.startswith("cache/slots/"):
                w[3] = full.n_kv_heads // n_model
            np.testing.assert_array_equal(g, w, err_msg=key)
            if key.split("/")[-1] in ("embed", "unembed"):
                assert full.vocab_size // n_model in g, key


@pytest.mark.parametrize("split", ["4x1/1", "4x1/2", "4x1/3", "2x2/1"])
def test_split_disagg_mesh_matches_jax(runs, split):
    """Both pools' ranks, data x model, as the JAX pools' devices in the
    mesh's order; each rank's own pool all-reduces over its data axis."""
    jx, ranks, _ = runs
    tag, n = split.split("/")
    for r, res in enumerate(ranks):
        pools = {}
        for pool in ("pre", "dec"):
            key = f"split/{split}/{pool}"
            np.testing.assert_array_equal(res[key], jx[key], err_msg=key)
            pools[pool] = res[key]
        own = pools["pre"] if r in pools["pre"] else pools["dec"]
        d, m = np.argwhere(own == r)[0]
        assert float(res[f"split/{split}/sum"][0]) == float(own[:, m].sum())


@pytest.mark.parametrize("tag", ["grad", "grad/flat"])
def test_collectives_differentiate(runs, tag):
    """x_r = r + arange (2, 3), w_r = (r + 1)(1 + column): all_gather's
    gradient is the rank's slice of sum_r w_r, all_reduce's w_r (the
    identity), entry's sum_r w_r; over "model" of (1, 4) and over the
    flattened ("pod", "data") of (2, 2, 1), whose rank r has the
    flattened coordinate r, so the gather is in rank order."""
    _, ranks, _ = runs
    wsum = sum(r + 1.0 for r in range(WORLD))
    for r, res in enumerate(ranks):
        cols = np.arange(12.0)[3 * r:3 * r + 3]
        np.testing.assert_array_equal(res[f"{tag}/gather"],
                                      np.broadcast_to(wsum * (1 + cols),
                                                      (2, 3)))
        np.testing.assert_array_equal(
            res[f"{tag}/gather/y"], np.concatenate(
                [np.arange(6.0).reshape(2, 3) + q for q in range(WORLD)], 1))
        np.testing.assert_array_equal(
            res[f"{tag}/reduce"], np.broadcast_to(
                (r + 1.0) * (1 + np.arange(3.0)), (2, 3)))
        np.testing.assert_array_equal(
            res[f"{tag}/reduce/y"], sum(np.arange(6.0).reshape(2, 3) + q
                                        for q in range(WORLD)))
        np.testing.assert_array_equal(
            res[f"{tag}/entry"], np.broadcast_to(
                wsum * (1 + np.arange(3.0)), (2, 3)))


def test_loss_terms_over_vocab_blocks_match_jax(runs):
    """The reduced Llama's 512 ids in 4 blocks of 128, the labels -1 and
    each block's first and last id: every rank's summed NLL over the count
    is the JAX ``LM.loss`` within 1e-5, and its terms those of the port
    outside rules on the whole weights."""
    jx, ranks, inp = runs
    labels = inp["loss/labels"]
    assert (labels < 0).any() and {0, 127, 128, 255, 256, 383, 384,
                                   511} <= set(labels.flat)
    count = float((labels >= 0).sum())
    for r, res in enumerate(ranks):
        assert float(res["loss/count"]) == count
        loss = float(res["loss/nll"]) / count
        assert _rel(loss, jx["loss/ref"]) < TOL, (r, loss)
        assert _rel(res["loss/nll"], res["loss/whole/nll"]) < TOL, r


def test_production_mesh_refuses_a_world_of_four(runs):
    _, ranks, _ = runs
    for res in ranks:
        msg = str(res["production"])
        assert "256" in msg and "has 4" in msg, msg


def test_production_mesh_refuses_one_process():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="world of 256"):
        make_production_mesh(backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="world of 512"):
        make_production_mesh(multi_pod=True, backend="gloo", device="cpu")


# ---------------------------------------------------------------------------
# in the test process
# ---------------------------------------------------------------------------

def _norm(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _spec_pairs(jspecs, tspecs):
    """(JAX spec, port spec) at each of the JAX tree's PartitionSpec
    leaves, the port's tree walked along the same path."""
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, P))[0]:
        node = tspecs
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        yield path, spec, node


FAMILY_ARCHS = ["llama3.1-8b", "phi3.5-moe-42b-a6.6b", "chameleon-34b",
                "whisper-large-v3", "xlstm-350m", "recurrentgemma-2b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_and_cache_specs_match_jax(arch):
    """``batch_specs`` and ``cache_specs`` (with and without kv_seq, the
    batch over "data" or replicated) of each family's reduced config, on
    its own abstract batch and cache, against the JAX functions."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jcache = jax.eval_shape(lambda: JaxLM(jcfg).init_cache(4, 32))
    tcache = LM(tcfg).init_cache(4, 32, device="meta")
    jbatch = make_batch_specs(jcfg, 4, 32)
    tbatch = {k: torch.empty(v.shape, device="meta")
              for k, v in jbatch.items()}
    n = 0
    for baxes in (("data",), ()):
        for (_, js, ts) in _spec_pairs(JSS.batch_specs(jcfg, jbatch, baxes),
                                       SS.batch_specs(tcfg, tbatch, baxes)):
            assert tuple(map(_norm, js)) == tuple(map(_norm, ts))
            n += 1
        for kv in (None, "model"):
            for path, js, ts in _spec_pairs(
                    JSS.cache_specs(jcfg, jcache, baxes, kv),
                    SS.cache_specs(tcfg, tcache, baxes, kv)):
                assert tuple(map(_norm, js)) == tuple(map(_norm, ts)), path
                n += 1
    assert n > 8


@pytest.mark.parametrize("arch", ["llama3.1-8b", "starcoder2-15b",
                                  "chameleon-34b"])
def test_param_specs_match_jax(arch):
    """``param_specs`` of the full-size config's parameters, sanitised on a
    (1, 4) mesh, against the JAX function's on the abstract parameters."""
    jspecs = JSS.param_specs(jax_config(arch), JaxLM(jax_config(arch))
                             .init_abstract(), _Mesh())
    tparams = LM(get_config(arch)).init(torch.Generator(), device="meta")
    pairs = list(_spec_pairs(jspecs, SS.param_specs(get_config(arch),
                                                    tparams, _Mesh())))
    assert len(pairs) == len(jax.tree_util.tree_leaves(
        jspecs, is_leaf=lambda x: isinstance(x, P)))
    for path, js, ts in pairs:
        assert tuple(map(_norm, js)) == tuple(map(_norm, ts)), path


@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["llama31_8b"])
def test_effective_window_matches_jax(arch):
    from repro.launch.steps import effective_window as jax_window
    from repro_torch.launch.steps import effective_window
    assert tuple(JAX_ARCH_IDS) == tuple(ARCH_IDS)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(JAX_SHAPES[name])
        assert effective_window(get_config(arch), shape) == \
            jax_window(jax_config(arch), JAX_SHAPES[name])


@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["llama31_8b"])
def test_step_flops_match_jax(arch):
    from repro.analysis.hlo import step_model_flops as jax_flops
    from repro_torch.analysis.flops import step_model_flops
    for name, shape in INPUT_SHAPES.items():
        assert step_model_flops(get_config(arch), shape) == \
            jax_flops(jax_config(arch), JAX_SHAPES[name])


class _Mesh:
    """A stand-in for a (data, n) DeviceMesh, for what comes before any
    collective."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n: int = WORLD, data: int = 1):
        self.sizes = (data, n)
        self.shape = {"data": data, "model": n}    # as the JAX mesh's

    def size(self, dim):
        return self.sizes[dim]

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


def test_refusals_name_a12():
    """FSDP, the families the multi-device layers do not cover, a cut of
    heads without d_ff or of the vocabulary over another axis, and a MAX
    all-reduce that would need a backward; a rule over mesh axes that no
    process group flattens (not adjacent in the mesh's order)."""
    from repro_torch.launch.steps import build_step
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=4,
                                seq_len=16)
    llama = get_config("llama3.1-8b").reduced()
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(llama, _Mesh(), shape, param_mode="fsdp")
    for arch in ("recurrentgemma-2b", "xlstm-350m", "whisper-large-v3",
                 "phi3.5-moe-42b-a6.6b"):
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            with pytest.raises(NotImplementedError, match="A12"):
                build_step(get_config(arch).reduced(), _Mesh(),
                           INPUT_SHAPES[kind])
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(llama, _Mesh(), shape, rule_overrides={"d_ff": None})
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(llama, _Mesh(), shape, rule_overrides={"vocab": "data"})

    class PodMesh(_Mesh):
        mesh_dim_names = ("pod", "data", "model")

        def size(self, dim):
            return (2, 2, 1)[dim]
    for axes in (("data", "pod"), ("pod", "model")):
        with pytest.raises(ValueError, match="flattens"):
            with SH.use_rules({"batch": axes}, PodMesh()):
                pass
    with SH.use_rules(SH.standard_rules(False), _Mesh()):
        x = torch.zeros(3, requires_grad=True) * 1.0
        with pytest.raises(RuntimeError, match="no backward"):
            SH.all_reduce(x, "model", "max")
        with pytest.raises(NotImplementedError, match="A12"):
            with SH.use_rules({"fsdp_gather": True}):
                pass


def test_launch_serve_production_path_on_cpu(monkeypatch, capsys):
    """The serve launcher's production path (``build_step`` on a 1x1 mesh,
    bf16) at decode_32k with the config reduced and the batch cut to 2:
    3 steps from position 32765 over the seeded cache, their tokens those
    of ``LM.decode_step`` on the same weights and cache; then its default
    mesh, the production one, refused on a world of one, and no card
    without --device cpu refused."""
    import torch.distributed as dist

    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import init_world, make_smoke_mesh
    from repro_torch.launch.steps import build_step, init_params
    cfg = get_config("llama3.1-8b").reduced()
    monkeypatch.setattr(launcher, "get_config", lambda arch: cfg)
    res = launcher.serve_production(launcher.parse_args(
        ["--arch", "llama3.1-8b", "--mesh", "1x1", "--batch", "2",
         "--steps", "3", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "decode_32k (global batch 2, cut from 128)" in out
    assert "tokens/s" in out and "flops=" in out
    assert len(res["walls_s"]) == 3 and res["tokens_per_s"] > 0
    shape = launcher.cut_shape(INPUT_SHAPES["decode_32k"], 2)
    init_world()
    try:
        built = build_step(cfg, make_smoke_mesh(), shape)
        params = init_params(cfg, built, torch.Generator().manual_seed(0),
                             "cpu")
        cache = launcher.primed_cache(built, torch.Generator().manual_seed(1),
                                      "cpu", 32768 - 3)
        token = launcher.first_tokens(cfg, built, shape, 0, "cpu")
    finally:
        dist.destroy_process_group()
    for i in range(3):
        logits, cache = LM(cfg).decode_step(params, token, cache)
        token = logits.argmax(-1).to(torch.int32)
        assert torch.equal(res["tokens"][i], token), i
    with pytest.raises(ValueError, match="world of 256"):
        launcher.main(["--arch", "llama3.1-8b", "--device", "cpu"])
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "llama3.1-8b", "--mesh", "1x1"])
