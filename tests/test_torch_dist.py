"""The port's multi-device layers (``repro_torch.models.sharding``,
``launch.mesh``, ``launch.shardspecs`` and the sharded branches of
``models.layers``) against the JAX package's, on the CPU.

One module-scoped run launches, at once, four ``gloo`` ranks of
``python -m repro_torch.launch.dist_cases`` (one torch thread each, a file
rendezvous in the test's temporary directory, never a fixed port) and one
JAX process with four host devices, on the same seeded inputs; the ranks
are killed, and the run fails with their output, past ``WALL_S``. Then:

- ``dist_decode_attention`` on meshes (1, 4) and (2, 2) (batch over
  "data", cache rows over "model") against the JAX function and against
  ``decode_attention_ref``, within the JAX test's 2e-5, the cache rows
  written on their owner and unchanged elsewhere;
- ``mlp_forward`` (SwiGLU, GeLU) and ``attn_forward`` under ``tp_bf16_ar``
  on (1, 4), reaching ``tp_mlp_forward`` and ``tp_attn_out``, against the
  JAX functions under the same rules: fp32 within 1e-5 max(1, max |ref|),
  bf16 within two bf16 steps of max |ref| (gloo and XLA sum the ranks'
  bf16 partials in their own orders, so no case asks for equal bits);
- the reduced Llama-3.1-8B through ``LM.prefill`` and 6 ``decode_step``s
  (positions 13-18 cross the rank boundary at 16) under ``kv_seq`` and,
  with ``forward_train``, under ``tp_bf16_ar``, against the JAX model run
  unsharded on the same weights;
- ``local_params`` against ``param_spec`` + ``sanitize_spec`` placed by a
  ``NamedSharding``, leaf by leaf;
- ``batch_axes_for`` on both meshes and ``make_smoke_mesh`` (on a one-rank
  group of its own) against the JAX functions;
- the plain B2's log-sum-exp against ``jax.nn.logsumexp`` of the JAX
  reference's scaled scores, and the refusals the rules must give.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.training.checkpoint import _flatten  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref,
)
from repro_torch.launch.dist_cases import BATCHES  # noqa: E402
from repro_torch.launch.shardspecs import EXPLICIT_LEAVES  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
WALL_S = 120
DD_B, DD_SC, DD_HQ, DD_K, DD_HD = 2, 64, 8, 2, 16
# positions 0, 5, Sc/n - 1, Sc/n of both meshes (n = 4, 2), 41, Sc - 1
DD_POS = (0, 5, 15, 16, 31, 32, 41, 63)
LM_B, LM_PROMPT, LM_STEPS, LM_SEED = 2, 13, 6, 1
FP32_TOL, DD_TOL, LM_BF16_TOL = 1e-5, 2e-5, 3e-2

JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.launch.mesh import batch_axes_for
from repro.launch.shardspecs import param_spec, sanitize_spec
from repro.models import LM, layers as L
from repro.models.sharding import standard_rules, use_rules
from repro.training.checkpoint import _flatten

inp = dict(np.load(sys.argv[1]))
out = {}
AUTO = (AxisType.Auto,) * 2      # constrain() takes only Auto axes
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=AUTO)


rules = standard_rules(False)
rules["kv_seq"] = "model"
dd = [jnp.asarray(inp["dd/" + k]) for k in ("q", "kc", "vc", "kn", "vn")]
for tag, shape in MESHES.items():
    mesh = mesh_of(shape)
    for bs in inp["batches"].tolist():
        out[f"batch_axes/{tag}/{bs}"] = np.asarray(
            ",".join(batch_axes_for(bs, mesh)))
    for pos in inp["dd/pos"].tolist():
        def run(q, kc, vc, kn, vn):
            with use_rules(rules, mesh):
                return L.dist_decode_attention(q, kc, vc, kn, vn, pos)
        cs = NamedSharding(mesh, P("data", "model", None, None))
        bs = NamedSharding(mesh, P("data"))
        with mesh:
            o, k2, v2 = jax.jit(run, in_shardings=(bs, cs, cs, bs, bs))(*dd)
        q, kc, vc, kn, vn = dd
        kref = kc.at[:, pos].set(kn[:, 0])
        vref = vc.at[:, pos].set(vn[:, 0])
        out[f"dd/{tag}/{pos}/out"] = np.asarray(o)
        out[f"dd/{tag}/{pos}/ref"] = np.asarray(
            decode_attention_ref(q[:, 0], kref, vref, pos))[:, None]
        out[f"dd/{tag}/{pos}/kc"] = np.asarray(kref)
        out[f"dd/{tag}/{pos}/vc"] = np.asarray(vref)

trules = standard_rules(False)
trules["tp_bf16_ar"] = True
mesh = mesh_of((1, 4))
for arch, arch_id in (("llama", "llama3.1-8b"),
                      ("starcoder2", "starcoder2-15b")):
    cfg = get_config(arch_id).reduced()
    for dname, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        blocks = {b: {k.split("/")[-1]: jnp.asarray(v, dt)
                      for k, v in inp.items()
                      if k.startswith(f"layer/{arch}/{b}/")}
                  for b in ("attn", "ffn")}
        x = jnp.asarray(inp["x"], dt)

        def mlp(p, x):
            with use_rules(trules, mesh):
                return L.mlp_forward(p, x, cfg)

        def attn(p, x):
            with use_rules(trules, mesh):
                return L.attn_forward(p, x, cfg)
        with mesh:
            out[f"tp/{arch}/{dname}/mlp"] = np.asarray(
                jax.jit(mlp)(blocks["ffn"], x), np.float32)
            out[f"tp/{arch}/{dname}/attn"] = np.asarray(
                jax.jit(attn)(blocks["attn"], x), np.float32)

cfg = get_config("llama3.1-8b").reduced()
lm = LM(cfg)
params32 = lm.init(jax.random.key(int(sys.argv[3])))
flat = _flatten(params32)
for tag, shape in MESHES.items():
    mesh = mesh_of(shape)
    devices = list(np.asarray(mesh.devices).flat)     # rank order
    for path, arr in flat.items():
        spec = sanitize_spec(param_spec(cfg, path, arr.ndim), arr.shape,
                             mesh)
        idx = NamedSharding(mesh, spec).devices_indices_map(arr.shape)
        blocks = np.zeros((len(devices), arr.ndim, 2), np.int64)
        for r, d in enumerate(devices):
            for dim, sl in enumerate(idx[d]):
                blocks[r, dim] = sl.indices(arr.shape[dim])[:2]
        out[f"spec/{tag}/{path}"] = blocks

tokens = jnp.asarray(inp["lm/tokens"])
steps = jnp.asarray(inp["lm/steps"])
prefill = jax.jit(lm.prefill)
decode = jax.jit(lm.decode_step)
train = jax.jit(lambda p, t: lm.forward_train(p, {"tokens": t},
                                              remat=False)[0])
for dname, dt in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
    params = jax.tree.map(lambda a: a.astype(dt), params32)
    cache = lm.init_cache(tokens.shape[0], int(sys.argv[4]), dtype=dt)
    logits, cache = prefill(params, {"tokens": tokens}, cache)
    out[f"lm/{dname}/prefill"] = np.asarray(logits, np.float32)
    for i in range(steps.shape[1]):
        logits, cache = decode(params, steps[:, i], cache)
        out[f"lm/{dname}/step{i}"] = np.asarray(logits, np.float32)
    for i, slot in enumerate(cache["slots"]):
        for name in ("k", "v"):
            out[f"lm/{dname}/cache/{i}/{name}"] = np.asarray(slot[name],
                                                             np.float32)
    out[f"lm/{dname}/train"] = np.asarray(train(params, tokens), np.float32)
np.savez(sys.argv[2], **out)
"""


def _inputs(path: Path) -> None:
    """The seeded inputs of every case, and the reduced Llama's weights as
    the JAX side draws them (``LM.init(key(LM_SEED))``)."""
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    inp = {"dd/q": normal(DD_B, 1, DD_HQ, DD_HD),
           "dd/kc": normal(DD_B, DD_SC, DD_K, DD_HD),
           "dd/vc": normal(DD_B, DD_SC, DD_K, DD_HD),
           "dd/kn": normal(DD_B, 1, DD_K, DD_HD),
           "dd/vn": normal(DD_B, 1, DD_K, DD_HD),
           "dd/pos": np.asarray(DD_POS, np.int32)}
    for arch, arch_id in (("llama", "llama3.1-8b"),
                          ("starcoder2", "starcoder2-15b")):
        cfg = jax_config(arch_id).reduced()
        D, qd, kvd, F = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        attn = {"wq": normal(D, qd, scale=D ** -0.5),
                "wk": normal(D, kvd, scale=D ** -0.5),
                "wv": normal(D, kvd, scale=D ** -0.5),
                "wo": normal(qd, D, scale=qd ** -0.5)}
        if cfg.qkv_bias:
            attn.update(bq=normal(qd, scale=0.3), bk=normal(kvd, scale=0.3),
                        bv=normal(kvd, scale=0.3))
        ffn = {"wi": normal(D, F, scale=D ** -0.5),
               "wo": normal(F, D, scale=F ** -0.5)}
        if cfg.mlp == "swiglu":
            ffn["wg"] = normal(D, F, scale=D ** -0.5)
        for block, ws in (("attn", attn), ("ffn", ffn)):
            inp.update({f"layer/{arch}/{block}/{k}": v
                        for k, v in ws.items()})
        if arch == "llama":
            inp["x"] = normal(2, 8, D)
    cfg = jax_config("llama3.1-8b").reduced()
    params = JaxLM(cfg).init(jax.random.key(LM_SEED))
    inp.update({f"lm/{k}": np.asarray(v) for k, v in
                _flatten(params).items()})
    inp["lm/tokens"] = rng.integers(0, cfg.vocab_size,
                                    (LM_B, LM_PROMPT)).astype(np.int32)
    inp["lm/steps"] = rng.integers(0, cfg.vocab_size,
                                   (LM_B, LM_STEPS)).astype(np.int32)
    inp["batches"] = np.asarray(BATCHES)
    np.savez(path, **inp)


def _tail(path: Path) -> str:
    return path.read_text()[-3000:] if path.exists() else ""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX side's outputs, each rank's outputs, seconds taken, the
    inputs)."""
    from repro_torch.launch.dist_cases import KV_SEQ_MAX_LEN
    tmp = tmp_path_factory.mktemp("dist")
    t0 = time.perf_counter()
    _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    procs = []
    for name, cmd in [("jax", [sys.executable, "-c", JAX_SIDE,
                               str(tmp / "inputs.npz"), str(tmp / "jax.npz"),
                               str(LM_SEED), str(KV_SEQ_MAX_LEN)])] + [
            (f"rank{r}", [sys.executable, "-m",
                          "repro_torch.launch.dist_cases",
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
    return (dict(np.load(tmp / "jax.npz")), ranks,
            time.perf_counter() - t0, dict(np.load(tmp / "inputs.npz")))


def _coords(rank: int, tag: str):
    """(data, model) coordinates of a rank on mesh ``tag``."""
    n_model = int(tag.split("x")[1])
    return rank // n_model, rank % n_model


def _rel(a, b) -> float:
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


def _bf16_step(x) -> float:
    """One bf16 step (2^-7 of the binade) at |x|'s largest value."""
    top = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize("tag", ["1x4", "2x2"])
@pytest.mark.parametrize("pos", DD_POS)
def test_dist_decode_attention_matches_jax(runs, tag, pos):
    jx, ranks, _, _ = runs
    n_data, n_model = (int(s) for s in tag.split("x"))
    rows = DD_SC // n_model
    b = DD_B // n_data
    for r, res in enumerate(ranks):
        d, m = _coords(r, tag)
        sl = slice(d * b, (d + 1) * b)
        out = res[f"dd/{tag}/{pos}/out"]
        assert np.abs(out - jx[f"dd/{tag}/{pos}/out"][sl]).max() < DD_TOL
        assert np.abs(out - jx[f"dd/{tag}/{pos}/ref"][sl]).max() < DD_TOL
        for name in ("kc", "vc"):     # written by the owner, else unchanged
            want = jx[f"dd/{tag}/{pos}/{name}"][sl, m * rows:(m + 1) * rows]
            np.testing.assert_array_equal(res[f"dd/{tag}/{pos}/{name}"],
                                          want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["llama", "starcoder2"])
@pytest.mark.parametrize("layer", ["mlp", "attn"])
def test_tp_layer_matches_jax(runs, layer, arch, dtype):
    """Under ``tp_bf16_ar`` on (1, 4): starcoder2's GeLU FFN and QKV bias;
    the reduced configs' 2 KV heads over 4 ranks cut a KV head, so the
    ranks gather K and V."""
    jx, ranks, _, _ = runs
    ref = jx[f"tp/{arch}/{dtype}/{layer}"]
    for res in ranks:
        out = res[f"tp/{arch}/{dtype}/{layer}"]
        if dtype == "fp32":
            assert _rel(out, ref) < FP32_TOL
        else:
            assert np.abs(out - ref).max() <= 2 * _bf16_step(ref)


def _check_logits(out, ref, dtype: str, what: str) -> None:
    """fp32 within 1e-5 max(1, max |ref|); bf16 within 3e-2 of max |ref|,
    the argmax equal wherever the reference's top-2 gap exceeds that."""
    if dtype == "fp32":
        assert _rel(out, ref) < FP32_TOL, what
        return
    bound = LM_BF16_TOL * float(np.abs(ref).max())
    assert float(np.abs(out - ref).max()) < bound, what
    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > bound
    assert (out.argmax(-1) == ref.argmax(-1))[clear].all(), what


def _lm_logits(jx, res, dtype, tag, b_rows):
    names = ["prefill"] + [f"step{i}" for i in range(LM_STEPS)]
    for name in names:
        _check_logits(res[f"{tag}/{name}"], jx[f"lm/{dtype}/{name}"][b_rows],
                      dtype, f"{tag}/{name}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lm_kv_seq_matches_unsharded_jax(runs, dtype):
    """Each rank holds 8 of the 32 cache rows; the prompt fills ranks 0-1,
    the steps write rows 13-18. The ranks' blocks of the cache make the JAX
    model's cache."""
    jx, ranks, _, _ = runs
    tag = f"lm/kv_seq/{dtype}"
    for r, res in enumerate(ranks):
        _lm_logits(jx, res, dtype, tag, slice(None))
    for key in [k for k in ranks[0] if k.startswith(f"{tag}/cache/")]:
        whole = np.concatenate([res[key] for res in ranks], axis=2)
        ref = jx[f"lm/{dtype}/cache/" + key.split("/cache/")[1]]
        if dtype == "fp32":
            assert _rel(whole, ref) < FP32_TOL, key
        else:
            assert np.abs(whole - ref).max() <= 2 * _bf16_step(ref), key


@pytest.mark.parametrize("case", ["1x4/fp32", "1x4/bf16", "2x2/fp32"])
def test_lm_tensor_parallel_matches_unsharded_jax(runs, case):
    """``tp_bf16_ar``: on (1, 4) one query head a rank and half a KV head's
    columns (gathered); on (2, 2) two query heads and one KV head a rank,
    one sequence a rank over "data". Prefill, decode steps and
    ``forward_train``."""
    jx, ranks, _, _ = runs
    tag, dtype = f"lm/tp/{case}", case.split("/")[1]
    mesh = case.split("/")[0]
    n_data = int(mesh.split("x")[0])
    b = LM_B // n_data
    for r, res in enumerate(ranks):
        d, _ = _coords(r, mesh)
        rows = slice(d * b, (d + 1) * b)
        _lm_logits(jx, res, dtype, tag, rows)
        _check_logits(res[f"{tag}/train"], jx[f"lm/{dtype}/train"][rows],
                      dtype, f"{tag}/train")


def _explicit(path: str) -> bool:
    parts = path.split("/")
    return len(parts) >= 2 and parts[-1] in EXPLICIT_LEAVES.get(parts[-2],
                                                                ())


@pytest.mark.parametrize("tag", ["1x4", "2x2"])
def test_local_params_match_named_sharding(runs, tag):
    """Every leaf the explicit layers take, and ``embed`` and ``unembed``
    (the vocabulary's rows and columns), is the rank's block of the
    NamedSharding of ``sanitize_spec(param_spec(...))`` (wk and wv cut
    mid-head on 1x4); every other leaf whole."""
    jx, ranks, _, inp = runs
    paths = [k[len(f"spec/{tag}/"):] for k in jx
             if k.startswith(f"spec/{tag}/")]
    assert any(_explicit(p) for p in paths)
    for r, res in enumerate(ranks):
        local = {k[len(f"local/{tag}/"):]: v for k, v in res.items()
                 if k.startswith(f"local/{tag}/")}
        assert set(local) == set(paths)
        for path, t in local.items():
            full = inp[f"lm/{path}"]
            if _explicit(path) or path in ("embed", "unembed"):
                full = full[tuple(slice(int(lo), int(hi)) for lo, hi in
                                  jx[f"spec/{tag}/{path}"][r])]
            np.testing.assert_array_equal(t, full, err_msg=path)


class _Mesh:
    """A stand-in for a (1, 4) DeviceMesh, for refusals that come before
    any collective."""
    mesh_dim_names = ("data", "model")

    def size(self, dim):
        return (1, WORLD)[dim]

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


@pytest.mark.parametrize("tag", ["1x4", "2x2"])
def test_batch_axes_for_matches_jax(runs, tag):
    """``batch_axes_for`` on each rank's mesh against the JAX function on
    a JAX mesh of the same shape, for every batch in ``BATCHES``."""
    jx, ranks, _, _ = runs
    for bs in BATCHES:
        want = str(jx[f"batch_axes/{tag}/{bs}"])
        # a data axis of size 1 divides every batch, of size 2 the even
        assert want == ("data" if tag == "1x4" or bs % 2 == 0 else "")
        for res in ranks:
            assert str(res[f"batch_axes/{tag}/{bs}"]) == want, bs


def test_smoke_mesh_is_jax_smoke_mesh(tmp_path):
    """``make_smoke_mesh`` on a one-rank gloo group: the JAX smoke mesh's
    axis names and shape, every rule over it of size 1 (``all_reduce`` the
    identity), and ``batch_axes_for`` the JAX function's on it."""
    import torch.distributed as dist

    from repro.launch.mesh import batch_axes_for as jax_batch_axes
    from repro.launch.mesh import make_smoke_mesh as jax_smoke_mesh
    from repro_torch.launch.mesh import batch_axes_for, make_smoke_mesh
    want = jax_smoke_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh()
        assert mesh.mesh_dim_names == tuple(want.axis_names)
        assert tuple(mesh.mesh.shape) == tuple(want.devices.shape)
        for bs in BATCHES:
            assert batch_axes_for(bs, mesh) == jax_batch_axes(bs, want)
        with SH.use_rules(SH.standard_rules(False), mesh):
            assert SH.shard_of("heads") == SH.Shard(None, 0, 1)
            x = torch.arange(6.0)
            assert SH.all_reduce(x, "model") is x
            assert torch.equal(x, torch.arange(6.0))
    finally:
        dist.destroy_process_group()


def test_refusals():
    """Rules on a family the multi-device layers do not cover raise, naming
    A12; parameters not cut to the rules raise, naming local_params: the
    attention's, and an ``embed`` or ``unembed`` of a third width (neither
    the whole vocabulary nor the rank's block of it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models import layers as L
    rules = {**SH.standard_rules(False), "tp_bf16_ar": True}
    with SH.use_rules(rules, _Mesh()):
        for arch in ("recurrentgemma-2b", "xlstm-350m", "whisper-large-v3",
                     "phi3.5-moe-42b-a6.6b"):
            with pytest.raises(NotImplementedError, match="A12"):
                LM(get_config(arch).reduced()).init_cache(2, 32,
                                                          device="cpu")
        cfg = get_config("llama3.1-8b").reduced()
        whole = {k: torch.zeros(s) for k, (s, _) in
                 L.init_attention(cfg).items()}
        with pytest.raises(ValueError, match="local_params"):
            L.attn_forward(whole, torch.zeros(1, 2, cfg.d_model), cfg)
        # a vocabulary leaf neither whole nor the rank's block of 4
        from repro_torch.models import transformer as T
        V, D = cfg.vocab_size, cfg.d_model
        for rows in (V // 2, V // 4 + 1):
            with pytest.raises(ValueError, match="local_params"):
                T._embed({"embed": torch.zeros(rows, D)},
                         torch.zeros(1, 2, dtype=torch.long), cfg)
            with pytest.raises(ValueError, match="local_params"):
                T._logits({"unembed": torch.zeros(D, rows),
                           "final_norm": {"w": torch.ones(D)}},
                          torch.zeros(1, 2, D), cfg)
        assert T.vocab_block(cfg, V) is None


def test_rules_without_process_group_raise():
    with pytest.raises(ValueError, match="process group"):
        with SH.use_rules(SH.standard_rules(False)):
            pass
    with pytest.raises(ValueError, match="process group"):
        with SH.use_rules({"heads": "model", "tp_bf16_ar": True}):
            pass
    with SH.use_rules({"heads": None, "tp_bf16_ar": True}):
        assert SH.active() and SH.shard_of("heads").size == 1
    assert not SH.active()
    with pytest.raises(NotImplementedError, match="A12"):
        with SH.use_rules({"fsdp_gather": True}):
            pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_lse_matches_jax_logsumexp(dtype, window):
    """The plain B2's lse against ``jax.nn.logsumexp`` of the JAX
    reference's scores (q k / sqrt(hd)) over the admitted rows, per slot,
    -inf where pos < 0; its output the same with and without the lse."""
    rng = np.random.default_rng(3)
    B, Sc, Hq, K, hd = 5, 16 if window else 40, 6, 2, 32
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    pos = np.array([-1, 0, 7, Sc - 1, Sc + 9], np.int32)
    args = [torch.tensor(a).to(dtype) for a in (q, kc, vc)]
    out, lse = decode_attention_ref(*args, torch.tensor(pos), window=window,
                                    return_lse=True)
    plain = decode_attention_ref(*args, torch.tensor(pos), window=window)
    assert torch.equal(out, plain)
    qf, kf = (np.asarray(a.float()) for a in args[:2])
    G = Hq // K
    s = jnp.einsum("bkgh,btkh->bkgt", qf.reshape(B, K, G, hd), kf) / \
        np.sqrt(hd)
    slots = np.arange(Sc)
    if window is None:
        valid = slots[None, :] <= pos[:, None]
    else:
        valid = pos[:, None] - np.mod(pos[:, None] - slots[None, :], Sc) >= 0
    want = jax.nn.logsumexp(jnp.where(valid[:, None, None, :], s, -jnp.inf),
                            axis=-1).reshape(B, Hq)
    want = np.asarray(want)
    got = lse.numpy()
    assert lse.dtype == torch.float32 and got.shape == (B, Hq)
    assert np.isneginf(got[0]).all() and np.isneginf(want[0]).all()
    assert np.abs(got[1:] - want[1:]).max() < 1e-5
