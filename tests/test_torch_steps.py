"""The port's steps (``repro_torch.launch.steps``), sharded training
through the collectives' backwards, ``shardspecs``' batch and cache specs
and the meshes of ``launch.mesh``, against the JAX package's, on the CPU.

One module-scoped run launches, at once, four ``gloo`` ranks of
``python -m repro_torch.launch.step_cases`` (one torch thread each, a file
rendezvous in the test's temporary directory) and ``JAX_PROCS`` JAX
processes (its jobs spread over them by their rough CPU cost, longest
first) with four host devices on ``Auto`` axes (jax 0.9's ``make_mesh`` makes
Explicit axes, which the JAX steps' ``constrain`` refuses; each step
compiled once, ahead of its calls, and LLVM's optimisation of their CPU
code off, to keep the compiles short), on the same seeded weights and
batches; the processes are killed, and the run fails with their output,
past ``WALL_S``. Then, in fp32:

- ``build_train_step`` on meshes (1, 4), (2, 2) and (4, 1) for the reduced
  Llama-3.1-8B (the KV plans "gather", "own" and none; the vocabulary cut
  over "model"), on (2, 2, 1) and (2, 1, 2) over ("pod", "data", "model")
  (the batch over the flattened ("pod", "data")), on (1, 4) for a
  reduced StarCoder2 with one KV head of 34 (the "whole" plan, QKV bias),
  for the reduced Chameleon (QK-norm) and for the reduced Llama with a
  vocabulary of 510 (which 4 does not divide: held whole): loss, grad
  norm and lr at both of 2 steps, and every parameter block and AdamW's m
  and v after them, within 1e-5 max(1, max |ref|) of the JAX
  ``build_train_step``; likewise ``param_mode="fsdp"`` (ZeRO-3) for the
  reduced Llama on (2, 2) and (2, 1, 2), the 510-id Llama on (1, 4)
  (``embed``/``unembed`` cut over d_model), the StarCoder2 variant on
  (1, 4) (bk, bv kept whole) and at 4 layers on (2, 2) (bk, bv cut on the
  layer dim) and Chameleon on (2, 2); the moe family on a batch of 4 rows
  of 64 tokens (whole groups of 64 on every rank; the aux loss in the
  loss): the reduced Phi-3.5-MoE, its experts and router columns over
  "model", on (1, 4), (2, 2), (2, 1, 2) and under FSDP on (2, 2) and
  (1, 4), the reduced Llama-4-Maverick (top-1, a shared expert, a dense
  slot of d_ff 16384) on (1, 4) and under FSDP on (2, 2), and a 6-expert
  Phi on (1, 4), its experts and router kept whole; the hybrid family, a
  reduced RecurrentGemma of 5 layers (``step_cases.hybrid``: a stacked
  group and two ``rest`` rec layers, its RG-LRU width over "model"), on
  (1, 4), on (2, 1, 2) and under FSDP on (2, 2), its whole-held gate
  leaves' gradients summed over the lru axis (the JAX side runs the
  hybrid's train and serve steps once, on (1, 4), ``JAX_RUN_OF``); the
  ssm family, a reduced xLSTM at 4 heads and 4 layers (``step_cases.ssm``:
  two groups of (mLSTM, sLSTM), its mLSTM heads and sLSTM gate columns
  over "model", its sLSTM's r and b_in gradients summed over the lru
  axis), on (1, 4), (2, 2), (2, 1, 2) and under FSDP on (2, 2) (its JAX
  steps run once too, on (1, 4));
- ``build_prefill_step`` and ``build_serve_step`` under ``kv_seq`` on
  (1, 4) and under the heads' rule on (1, 4), (2, 2) and (2, 2, 1), and
  the MoE configs under the heads' and experts' rules (Phi on (2, 2),
  whose dropless decode splits a group over the batch's ranks, Maverick
  on (1, 4)): tokens equal wherever the reference's top-2 gap exceeds the
  tolerance, caches within 1e-5; the reduced RecurrentGemma on (1, 4) and
  (2, 2), its prompt wrapping the 16-row window and its serve steps going
  on from the prefill's position, every cache leaf (k, v, conv tails, h)
  against the rank's block of the JAX cache; the reduced xLSTM likewise
  on (1, 4) and (2, 2), an mLSTM state at the rank's heads;
- every leaf of ``BuiltStep.args`` at the full size of Llama-3.1-8B, of
  Phi-3.5-MoE and of xLSTM-350M, for the four input shapes on (1, 4),
  (2, 2) and (2, 1, 2), and of RecurrentGemma-2B on (2, 2) and (2, 1, 2),
  against the JAX ``NamedSharding.shard_shape`` of the same leaf, but for
  a cache's KV-head dim and an mLSTM state's heads dim: the rank's own
  heads (the JAX cache keeps every head on every rank of "model"); and of
  train_4k's FSDP step;
- ``LM.loss_terms`` with the vocabulary cut, on labels that hold -1 and
  the first and last id of every rank's block, against the JAX
  ``LM.loss`` and the port's outside rules;
- ``split_disagg_mesh`` on (4, 1) for n_prefill 1-3 and on (2, 2) against
  the JAX pools' devices, and an all-reduce in each pool;
- the gradients of ``all_gather``, ``all_reduce`` and ``entry``, over
  "model" and over the flattened ("pod", "data");
- ``make_production_mesh``'s refusal on a world of 4.

In the test process alone: ``batch_specs`` and ``cache_specs`` for all
five families against the JAX functions, ``param_specs_fsdp`` for every
dense, vlm, moe, hybrid and ssm config, FSDP's ``init_params`` against one
draw cut to each rank's blocks, ``effective_window`` for every ``ARCH_IDS`` x
``INPUT_SHAPES`` pair, the analytic FLOPs, that each MoE case's batch
drops choices by capacity, and the refusals that name A12.
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
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 InputShape, get_config)
from repro_torch.launch import shardspecs as SS  # noqa: E402
from repro_torch.launch import step_cases as C  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models.params import IF_BIAS, LRU_LAMBDA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# the fixture's watchdog (inputs and processes): alone they take ~60 s, but
# its ten processes share the CPU with the other test workers; under six of
# them on 8 cores the module's first test, the fixture's set-up in it, took
# 154 s without the hybrid's cases, and with them the processes were still
# running at 150 s
WALL_S = 300
SEED = 1
TOL = 1e-5
FEED_STEPS = 6
JAX_PROCS = 6     # the JAX side's processes (its compiles take the time)
# the JAX step a case is held against where it is not the case's own: the
# hybrid's steps compile three times as long as Llama's, and the JAX
# sharding of a step places one function on every mesh (the same loss,
# parameters, moments, tokens and caches, gathered whole, to fp32's
# rounding), so its train and serve steps run once, on (1, 4)
JAX_RUN_OF = {"rg/2x1x2": "rg/1x4", "rg/2x2/fsdp": "rg/1x4",
              "rg/2x2": "rg/1x4", "xl/2x2": "xl/1x4", "xl/2x1x2": "xl/1x4",
              "xl/2x2/fsdp": "xl/1x4"}

JAX_SIDE = r"""
import dataclasses
import functools
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
                                             .reduced(), vocab_size=510),
           "phi": get_config("phi3.5-moe-42b-a6.6b").reduced(),
           "maverick": get_config("llama4-maverick-400b-a17b").reduced()}
CONFIGS["starcoder2_whole4"] = dataclasses.replace(
    CONFIGS["starcoder2_whole"], n_layers=4)
CONFIGS["phi6"] = dataclasses.replace(CONFIGS["phi"], n_experts=6)
CONFIGS["rg"] = dataclasses.replace(
    get_config("recurrentgemma-2b").reduced(), n_layers=5,
    attn_pattern=("rec", "rec", "attn"), window=16)
CONFIGS["xl"] = dataclasses.replace(get_config("xlstm-350m").reduced(),
                                    n_heads=4, n_layers=4)
MOE = ("phi", "maverick", "phi6")
# the recurrent families' serve steps go on from the prefill's position
RECURRENT = ("rg", "xl")


def paths(tree, is_leaf=None):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in leaves}


# config name's weights from the inputs (the test process's
# LM.init(key(SEED))) in LM.init's pytree: drawing them again here would
# compile the init anew in every process
@functools.cache
def weights(name):
    like = LM(CONFIGS[name]).init_abstract(jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(like), [
        jnp.asarray(inp[f"w/{name}/{k}"]) for k in paths(like)])


opt_cfg = AdamWConfig(state_dtype=jnp.float32)


def train(case):
    name, tag, *mode = case.split("/")
    pre = "train/moe/" if name in MOE else \
        "train/v510/" if name == "llama_v510" else "train/"
    train_batch = {k: jnp.asarray(inp[pre + k]) for k in ("tokens", "labels")}
    mesh = mesh_of(tag)
    shape = InputShape("train_moe", 64, 4, "train") if name in MOE else \
        InputShape("train_small", 16, 4, "train")
    built = build_step(CONFIGS[name], mesh, shape,
                       dtype=jnp.float32, opt_cfg=opt_cfg,
                       param_mode=mode[0] if mode else "2d")
    params = jax.tree.map(jnp.array, weights(name))
    opt = init_state(opt_cfg, params)
    with mesh:
        # compiled once: the step's outputs come back sharded, which a
        # second call of the jitted function would compile anew for
        step = built.fn.lower(params, opt, train_batch).compile()
        params, opt, train_batch = jax.device_put(
            (params, opt, train_batch), step.input_shardings[0])
        for i in range(2):
            params, opt, metrics = step(params, opt, train_batch)
            for k, v in metrics.items():
                out[f"train/{case}/step{i}/{k}"] = np.asarray(v)
    for part, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for k, v in _flatten(tree).items():
            out[f"train/{case}/{part}/{k}"] = v

prompt = jnp.asarray(inp["serve/prompt"])
feed = jnp.asarray(inp["serve/feed"])
kv_seq = {"heads": None, "d_ff": None}
# the hybrid and ssm families' cases go on from the prefill's own
# position (32)
SERVE = {"kv_seq/1x4": ("llama", "1x4", kv_seq, "model"),
         "heads/1x4": ("llama", "1x4", None, None),
         "heads/2x2": ("llama", "2x2", None, None),
         "heads/2x2x1": ("llama", "2x2x1", None, None),
         "phi/2x2": ("phi", "2x2", None, None),
         "maverick/1x4": ("maverick", "1x4", None, None),
         "rg/1x4": ("rg", "1x4", None, None),
         "rg/2x2": ("rg", "2x2", None, None),
         "xl/1x4": ("xl", "1x4", None, None),
         "xl/2x2": ("xl", "2x2", None, None)}


def serve(case):
    name, tag, overrides, axis = SERVE[case]
    cfg = CONFIGS[name]
    lm = LM(cfg)
    mesh = mesh_of(tag)
    kw = dict(dtype=jnp.float32, rule_overrides=overrides, kv_seq_axis=axis)
    pre = build_step(cfg, mesh, InputShape("prefill_small", 32, 4, "prefill"),
                     **kw)
    dec = build_step(cfg, mesh, InputShape("decode_small", 32, 4, "decode"),
                     **kw)
    params = weights(name)
    with mesh:
        tok, cache = pre.fn(params, {"tokens": prompt},
                            lm.init_cache(4, 32, dtype=jnp.float32))
        out[f"serve/{case}/prefill"] = np.asarray(tok)
        if name not in RECURRENT:
            cache = dict(cache, pos=jnp.asarray(22, jnp.int32))
        step = dec.fn.lower(params, feed[:, 0], cache).compile()
        params, _, cache = jax.device_put((params, feed[:, 0], cache),
                                          step.input_shardings[0])
        for i in range(feed.shape[1]):
            tok, cache = step(params, jax.device_put(
                feed[:, i], step.input_shardings[0][1]), cache)
            out[f"serve/{case}/step{i}"] = np.asarray(tok)
    for path, leaf in paths(cache).items():
        if path != "pos":
            out[f"serve/{case}/cache/{path}"] = np.asarray(leaf)


# the unsharded logits of the same feed: the tokens' top-2 gaps
def logits(name):
    lm = LM(CONFIGS[name])
    params = weights(name)
    logits, cache = jax.jit(lm.prefill)(params, {"tokens": prompt},
                                        lm.init_cache(4, 32,
                                                      dtype=jnp.float32))
    out[f"serve/logits/{name}/prefill"] = np.asarray(logits)
    if name not in RECURRENT:
        cache = dict(cache, pos=jnp.asarray(22, jnp.int32))
    decode = jax.jit(lm.decode_step)
    for i in range(feed.shape[1]):
        logits, cache = decode(params, feed[:, i], cache)
        out[f"serve/logits/{name}/step{i}"] = np.asarray(logits)


def loss(_):
    lm, params = LM(CONFIGS["llama"]), weights("llama")
    out["loss/ref"] = np.asarray(jax.jit(lm.loss)(params, {
        k: jnp.asarray(inp["loss/" + k]) for k in ("tokens", "labels")}))


ARGS = {"": ("llama3.1-8b", ("1x4", "2x2", "2x1x2")),
        "phi/": ("phi3.5-moe-42b-a6.6b", ("1x4", "2x2", "2x1x2")),
        "rg/": ("recurrentgemma-2b", ("2x2", "2x1x2")),
        "xl/": ("xlstm-350m", ("1x4", "2x2", "2x1x2"))}


def args(pre):
    arch, tags = ARGS[pre]
    full = get_config(arch)
    for tag in tags:
        mesh = mesh_of(tag)
        for name, shape in [*INPUT_SHAPES.items(),
                            ("fsdp", INPUT_SHAPES["train_4k"])]:
            if name == "fsdp":
                built = build_step(full, mesh, shape, param_mode="fsdp")
                baxes = built.rules["batch"]
                p_specs = SS.param_specs_fsdp(built.args[0], mesh)
            else:
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
                    out[f"args/{pre}{tag}/{name}/{part}/{k}"] = np.asarray(
                        NamedSharding(mesh, spec).shard_shape(leaf.shape))


def split(_):
    for tag, n in (("4x1", 1), ("4x1", 2), ("4x1", 3), ("2x2", 1)):
        mesh = mesh_of(tag)
        order = {d.id: r
                 for r, d in enumerate(np.asarray(mesh.devices).flat)}
        pre, dec = split_disagg_mesh(mesh, n)
        for pool, m in (("pre", pre), ("dec", dec)):
            out[f"split/{tag}/{n}/{pool}"] = np.vectorize(
                lambda d: order[d.id])(np.asarray(m.devices))


# the jobs "kind:argument" of this process, comma-separated
JOBS = {"train": train, "serve": serve, "logits": logits, "loss": loss,
        "args": args, "split": split}
for job in filter(None, sys.argv[3].split(",")):
    kind, _, arg = job.partition(":")
    JOBS[kind](arg)
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
    "starcoder2_whole4": dataclasses.replace(
        jax_config("starcoder2-15b").reduced(), n_kv_heads=1, head_dim=34,
        n_layers=4),
    "phi": jax_config("phi3.5-moe-42b-a6.6b").reduced(),
    "maverick": jax_config("llama4-maverick-400b-a17b").reduced(),
    "phi6": dataclasses.replace(jax_config("phi3.5-moe-42b-a6.6b").reduced(),
                                n_experts=6),
    "rg": dataclasses.replace(jax_config("recurrentgemma-2b").reduced(),
                              n_layers=5, attn_pattern=("rec", "rec", "attn"),
                              window=16),
    "xl": dataclasses.replace(jax_config("xlstm-350m").reduced(), n_heads=4,
                              n_layers=4),
}


def test_case_configs_match_jax():
    assert set(JAX_CFGS) == set(C.CONFIGS)
    for name, make in C.CONFIGS.items():
        assert dataclasses.asdict(make()) == dataclasses.asdict(JAX_CFGS[name])


# the configs whose weights are drawn with numpy (the JAX init of the MoE
# configs would take as long as all the others' together, the hybrid's
# 6 s)
NUMPY_WEIGHTS = (*C.MOE_CONFIGS, "rg", "xl")


def _numpy_leaf(rng, shape, init) -> np.ndarray:
    """A leaf drawn as the JAX init draws it, from numpy: a normal at its
    std, ones, zeros, the RG-LRU's lambda (``params.LRU_LAMBDA``) or the
    mLSTM's gate bias (``params.IF_BIAS``: nh zeros, then nh 3.0s)."""
    if init == "ones":
        return np.ones(shape, np.float32)
    if init == "zeros":
        return np.zeros(shape, np.float32)
    if init == IF_BIAS:
        nh = shape[-1] // 2
        return np.concatenate([np.zeros((*shape[:-1], nh), np.float32),
                               np.full((*shape[:-1], nh), 3.0, np.float32)],
                              axis=-1)
    if init == LRU_LAMBDA:
        u = rng.uniform(0.9, 0.999, shape)
        return np.log(np.expm1(-np.log(u ** 8.0) / 8.0)).astype(np.float32)
    return init * rng.standard_normal(shape, np.float32)


def _inputs(path: Path) -> None:
    """The seeded inputs: the configs' weights as the JAX side draws them
    (``LM.init(key(SEED))``; those of ``NUMPY_WEIGHTS`` at the same
    distributions from numpy), the training batches with masked labels, a
    prompt and the serve steps' feed."""
    rng = np.random.default_rng(0)
    inp = {}
    for name, jcfg in JAX_CFGS.items():
        if name in NUMPY_WEIGHTS:
            continue
        params = JaxLM(jcfg).init(jax.random.key(SEED))
        inp.update({f"w/{name}/{k}": np.asarray(v)
                    for k, v in _flatten(params).items()})
    # at the distributions of the JAX init (the port's ``param_specs``)
    wrng = np.random.default_rng(SEED)
    for name in NUMPY_WEIGHTS:
        cfg = C.CONFIGS[name]()
        for k, (shape, init) in LM(cfg).mod.param_specs(cfg).items():
            inp[f"w/{name}/{k}"] = _numpy_leaf(wrng, shape, init)
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
    # the MoE configs' batch (drawn last, so the others keep their draws)
    B, S = C.MOE_TRAIN_SHAPE.global_batch, C.MOE_TRAIN_SHAPE.seq_len
    tokens = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[2, -7:] = -1
    inp["train/moe/tokens"] = tokens[:, :-1].copy()
    inp["train/moe/labels"] = labels
    np.savez(path, **inp)


def _tail(path: Path) -> str:
    return path.read_text()[-3000:] if path.exists() else ""


# a job's rough CPU seconds on the JAX side (its compiles), by its kind and
# its config: maverick's and rg's steps compile three times as long as
# llama's, phi's 1.6 times
_KIND_S = {"train": 6, "serve": 2.5, "logits": 1.5, "args": 1.5}
_CONFIG_X = {"rg": 3, "xl": 3, "maverick": 3, "phi": 1.6, "phi6": 1.6}


def _cost(job: str) -> float:
    kind, _, arg = job.partition(":")
    return _KIND_S.get(kind, 1) * _CONFIG_X.get(arg.split("/")[0], 1)


def _jax_jobs() -> list:
    """The JAX side's jobs ("kind:argument") spread over ``JAX_PROCS``
    processes, longest first, each to the least loaded: one comma-separated
    list a process."""
    jobs = ([f"train:{c}" for c, _, _ in C.TRAIN_CASES
             if c not in JAX_RUN_OF]
            + [f"serve:{c[0]}" for c in C.SERVE_CASES + C.HYBRID_SERVE_CASES
               + C.SSM_SERVE_CASES if c[0] not in JAX_RUN_OF]
            + [f"logits:{n}" for n in ("llama", "phi", "maverick", "rg",
                                       "xl")]
            + [f"args:{pre}" for pre, _, _ in C.ARGS_ARCHS]
            + ["loss:", "split:"])
    load = [0.0] * JAX_PROCS
    lists = [[] for _ in range(JAX_PROCS)]
    for job in sorted(jobs, key=_cost, reverse=True):
        j = load.index(min(load))
        load[j] += _cost(job)
        lists[j].append(job)
    return [",".join(jobs) for jobs in lists]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX side's outputs, each rank's outputs, the inputs)."""
    tmp = tmp_path_factory.mktemp("steps")
    t0 = time.perf_counter()
    _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           # LLVM's optimisation of the JAX side's CPU code off: its
           # compiles take most of the run's CPU time, which parallel test
           # workers share, and its steps are small
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4 "
                        "--xla_backend_optimization_level=0"}
    procs = []
    for name, cmd in [(f"jax{j}", [sys.executable, "-c", JAX_SIDE,
                                   str(tmp / "inputs.npz"),
                                   str(tmp / f"jax{j}.npz"), jobs])
                      for j, jobs in enumerate(_jax_jobs())] + [
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


def _fsdp_block(full: np.ndarray, tag: str, rank: int) -> np.ndarray:
    """The rank's block of ``full`` as the JAX ``param_specs_fsdp`` places
    it on mesh ``tag``: over every mesh axis flattened, where rank r's
    coordinate is r (the meshes order the ranks row-major)."""
    spec = JSS.param_specs_fsdp({"x": full}, _Mesh.of(_shape(tag)))["x"]
    sl = [slice(None)] * full.ndim
    for d, entry in enumerate(spec):
        if entry is not None:
            assert tuple(entry) == C.mesh_axes(_shape(tag)), entry
            n = full.shape[d] // WORLD
            sl[d] = slice(rank * n, (rank + 1) * n)
    return full[tuple(sl)]


# the FSDP cases' leaves that show the cut's three kinds, on every rank:
# embed and unembed over d_model where 4 does not divide the vocabulary;
# bk and bv (G, 34) whole at G = 2, cut on the layer dim at G = 4
FSDP_SHAPES = {
    "llama_v510/1x4/fsdp": {"embed": (C.VOCAB_UNEVEN, 64),
                            "unembed": (64, C.VOCAB_UNEVEN)},
    "starcoder2_whole/1x4/fsdp": {"slots/0/attn/bk": (2, 34),
                                  "slots/0/attn/bv": (2, 34)},
    "starcoder2_whole4/2x2/fsdp": {"slots/0/attn/bk": (1, 34),
                                   "slots/0/attn/bv": (1, 34)},
}


def _block(full: np.ndarray, local: np.ndarray, cfg, path: str, tag: str,
           rank: int, fsdp: bool = False) -> np.ndarray:
    """The rank's block of ``full`` as ``param_spec`` + ``sanitize_spec``
    place it (whole where the port keeps the leaf whole), or where
    ``fsdp`` as ``param_specs_fsdp`` does."""
    if fsdp:
        return _fsdp_block(full, tag, rank)
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
    block and AdamW's m and v, within 1e-5 max(1, max |ref|); the FSDP
    cases against the JAX ``param_mode="fsdp"`` step, each block as its
    ``param_specs_fsdp`` places it (the hybrid's and the ssm's against
    their JAX steps on (1, 4), ``JAX_RUN_OF``)."""
    jx, ranks, _ = runs
    jcase = JAX_RUN_OF.get(case, case)
    name, tag = case.split("/")[:2]
    cfg = JAX_CFGS[name]
    fsdp = C.param_mode(case) == "fsdp"
    # the vocabulary is cut wherever the model axis divides it
    vocab_cut = _shape(tag)[-1] > 1 and cfg.vocab_size % _shape(tag)[-1] == 0
    for r, res in enumerate(ranks):
        got = res[f"train/{case}/params/embed"].shape[0]
        if not fsdp:
            assert got == (cfg.vocab_size // _shape(tag)[-1] if vocab_cut
                           else cfg.vocab_size), (r, got)
        for path, want in FSDP_SHAPES.get(case, {}).items():
            assert res[f"train/{case}/params/{path}"].shape == want, path
        for i in range(C.TRAIN_STEPS):
            for k in ("loss", "grad_norm", "lr"):
                key = f"train/{case}/step{i}/{k}"
                jkey = f"train/{jcase}/step{i}/{k}"
                assert _rel(res[key], jx[jkey]) < TOL, (r, key)
        n_blocks = 0
        for part in ("params", "m", "v"):
            pre = f"train/{case}/{part}/"
            jpre = f"train/{jcase}/{part}/"
            paths = [k[len(jpre):] for k in jx if k.startswith(jpre)]
            assert {k[len(pre):] for k in res if k.startswith(pre)} == \
                set(paths)
            for path in paths:
                local = res[pre + path]
                full = jx[jpre + path]
                want = _block(full, local, cfg, path, tag, r, fsdp)
                n_blocks += want.shape != full.shape
                assert local.shape == want.shape, (r, part, path)
                assert _rel(local, want) < TOL, (r, part, path,
                                                 _rel(local, want))
        # on a model axis of 2 or 4 the explicit layers' leaves are blocks;
        # under FSDP every leaf that the flattened axes divide
        assert (n_blocks > 0) == (fsdp or not tag.endswith("x1")), n_blocks


@pytest.mark.parametrize("name", C.MOE_CONFIGS)
def test_moe_cases_drop_choices(runs, name, monkeypatch):
    """Each MoE config's training batch, and for phi and maverick the serve
    cases' prompt, drops choices by capacity (the ``fits`` of each
    ``moe_layer.route`` call the forward makes) on the seeded weights, so
    that the train and prefill cases hold the dropping path; the rows of
    ``MOE_TRAIN_SHAPE`` hold whole groups on every rank of each mesh."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import moe_layer
    route, dropped = moe_layer.route, []

    def counted(*args, **kw):
        r = route(*args, **kw)
        dropped.append(int((~r.fits).sum()))
        return r
    monkeypatch.setattr(moe_layer, "route", counted)
    _, _, inp = runs
    cfg = C.CONFIGS[name]()
    params = params_from_numpy({k[len(f"w/{name}/"):]: v for k, v in
                                inp.items() if k.startswith(f"w/{name}/")},
                               cfg, "cpu")
    batches = [inp["train/moe/tokens"]]
    if any(c[1] == name for c in C.SERVE_CASES):
        batches.append(inp["serve/prompt"])
    for tokens in batches:
        dropped.clear()
        with torch.no_grad():
            LM(cfg).forward_train(params, {"tokens": torch.from_numpy(
                tokens)}, remat=False)
        assert dropped and sum(dropped) > 0, tokens.shape
    shape = C.MOE_TRAIN_SHAPE
    for n_batch in (1, 2, WORLD):     # the batch's ranks of the cases
        rows = shape.global_batch // n_batch
        assert rows * shape.seq_len % cfg.moe_group_size == 0


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


@pytest.mark.parametrize("case", [c[0] for c in C.SERVE_CASES])
def test_prefill_and_serve_steps_match_jax(runs, case):
    """Each rank's rows of the tokens equal the JAX step's wherever the
    unsharded logits' top-2 gap exceeds the tolerance; its block of the
    cache (its rows under kv_seq, its KV heads under heads) within 1e-5.
    The MoE cases run their experts over "model" too: phi's prefill on
    2x2 routes a rank's whole groups with capacity drops, its dropless
    decode steps a group split over the two rows' ranks."""
    jx, ranks, _ = runs
    cfg = {c[0]: c[1] for c in C.SERVE_CASES}[case]
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
            clear = _clear(jx[f"serve/logits/{cfg}/{name}"][rows])
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


@pytest.mark.parametrize("case", [c[0] for c in C.HYBRID_SERVE_CASES])
def test_hybrid_serve_steps_match_jax(runs, case):
    """The reduced RecurrentGemma (``step_cases.hybrid``) under the heads'
    and the lru rules: its 32-token prompt prefilled into the 16-row
    window, then the serve steps from the prefill's own position 32,
    which wrap the window on both sides. Each rank's rows of the tokens
    equal the JAX step's wherever the unsharded logits' top-2 gap exceeds
    the tolerance; every cache leaf after the steps (the attention slot's
    k and v at the rank's KV heads, each rec slot's conv tail and h at the
    rank's W/m channels of the lru width, stacked and ``rest``) within
    1e-5 of the rank's block of the JAX cache (of the JAX step on (1, 4),
    ``JAX_RUN_OF``)."""
    jx, ranks, _ = runs
    jcase = JAX_RUN_OF.get(case, case)
    tag = case.split("/")[1]
    n_model = _shape(tag)[-1]
    B = C.SERVE_PREFILL.global_batch * n_model // WORLD
    pre, jpre = f"serve/{case}/cache/", f"serve/{jcase}/cache/"
    paths = [k[len(jpre):] for k in jx if k.startswith(jpre)]
    assert set(paths) == {
        "slots/0/0", "slots/0/1", "slots/1/0", "slots/1/1", "slots/2/k",
        "slots/2/v", "rest/0/0", "rest/0/1", "rest/1/0", "rest/1/1"}
    for r, res in enumerate(ranks):
        d, m = _coords(r, tag)
        rows = slice(d * B, (d + 1) * B)
        for name in ["prefill"] + [f"step{i}" for i in range(FEED_STEPS)]:
            got = res[f"serve/{case}/{name}"]
            want = jx[f"serve/{jcase}/{name}"][rows]
            clear = _clear(jx[f"serve/logits/rg/{name}"][rows])
            assert clear.any()
            np.testing.assert_array_equal(got[clear], want[clear],
                                          err_msg=name)
        heads = res[f"serve/{case}/kv_heads"]
        assert {k[len(pre):] for k in res if k.startswith(pre)} == set(paths)
        for path in paths:
            key = pre + path
            full = jx[jpre + path]
            # the batch dim: behind the layer dim of a stacked slot
            full = full[:, rows] if path.startswith("slots/") else full[rows]
            if path.endswith(("/k", "/v")):
                full = full[..., heads, :]
            else:
                W = full.shape[-1] // n_model
                full = full[..., m * W:(m + 1) * W]
            assert res[key].shape == full.shape, (r, key)
            assert _rel(res[key], full) < TOL, (r, key, _rel(res[key], full))


def _mlstm_slots(cfg) -> set:
    """The slot indices of an xLSTM config's mLSTM layers."""
    period = cfg.slstm_every or cfg.n_layers
    return {i for i, kind in enumerate(cfg.layer_kinds()[:period])
            if kind == "mlstm"}


@pytest.mark.parametrize("case", [c[0] for c in C.SSM_SERVE_CASES])
def test_ssm_serve_steps_match_jax(runs, case):
    """The reduced xLSTM at 4 heads (``step_cases.ssm``) under the lru
    rule: its mLSTM heads (one a rank on 1x4, two on 2x2) and its sLSTM's
    gate columns over "model", the 32-token prompt prefilled, then the
    serve steps from the prefill's own position 32. Each rank's rows of
    the tokens equal the JAX step's wherever the unsharded logits' top-2
    gap exceeds the tolerance; every state leaf after the steps within
    1e-5 of the rank's block of the JAX cache (of the JAX step on (1, 4),
    ``JAX_RUN_OF``): an mLSTM slot's C, n and m at the rank's heads (the
    JAX cache keeps every head on every rank of "model"), an sLSTM slot's
    c, n, m and h whole."""
    jx, ranks, _ = runs
    jcase = JAX_RUN_OF.get(case, case)
    tag = case.split("/")[1]
    n_model = _shape(tag)[-1]
    B = C.SERVE_PREFILL.global_batch * n_model // WORLD
    cfg = JAX_CFGS["xl"]
    mlstm = _mlstm_slots(cfg)
    pre, jpre = f"serve/{case}/cache/", f"serve/{jcase}/cache/"
    paths = [k[len(jpre):] for k in jx if k.startswith(jpre)]
    assert set(paths) == {f"slots/{i}/{j}" for i in range(2)
                          for j in range(3 if i in mlstm else 4)}
    for r, res in enumerate(ranks):
        d, m = _coords(r, tag)
        rows = slice(d * B, (d + 1) * B)
        for name in ["prefill"] + [f"step{i}" for i in range(FEED_STEPS)]:
            got = res[f"serve/{case}/{name}"]
            want = jx[f"serve/{jcase}/{name}"][rows]
            clear = _clear(jx[f"serve/logits/xl/{name}"][rows])
            assert clear.any()
            np.testing.assert_array_equal(got[clear], want[clear],
                                          err_msg=name)
        assert {k[len(pre):] for k in res if k.startswith(pre)} == set(paths)
        for path in paths:
            key = pre + path
            full = jx[jpre + path][:, rows]
            if int(path.split("/")[1]) in mlstm:     # (G, B, nh, ...)
                nh = full.shape[2] // n_model
                full = full[:, :, m * nh:(m + 1) * nh]
            assert res[key].shape == full.shape, (r, key)
            assert _rel(res[key], full) < TOL, (r, key, _rel(res[key], full))


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_built_args_have_jax_shard_shapes(runs, tag, shape):
    """Every leaf of ``BuiltStep.args`` (full-size Llama-3.1-8B, on the
    meta device) has the JAX leaf's ``shard_shape``, ``embed`` and
    ``unembed`` (and their m and v) cut over the vocabulary among them,
    but the cache's KV-head dim, which the JAX cache keeps whole on every
    rank of "model" and the port cuts to the KV heads of the rank's query
    heads (``head_plan``)."""
    _check_args(runs, "", "llama3.1-8b", tag, shape)


def _check_args(runs, pre: str, arch: str, tag: str, shape: str) -> dict:
    """Every rank's leaves of ``BuiltStep.args`` of ``arch`` at ``shape``
    on ``tag`` (keys ``args/<pre><tag>/<shape>/``) against the JAX
    ``shard_shape``s, the cache's KV heads the rank's own, an mLSTM
    state's heads the rank's own. Returns rank 0's."""
    jx, ranks, _ = runs
    pre = f"args/{pre}{tag}/{shape}/"
    want = {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}
    assert want
    full = get_config(arch)
    n_model = _shape(tag)[-1]
    for res in ranks:
        got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
        assert set(got) == set(want)
        for key, g in got.items():
            w = want[key].copy()
            if key.startswith("cache/slots/") and key.endswith(("/k",
                                                                "/v")):
                # a rank's query heads read one KV head at least
                w[-2] = max(1, full.n_kv_heads // n_model)
            if full.family == "ssm" and key.startswith("cache/slots/") and \
                    int(key.split("/")[2]) in _mlstm_slots(full):
                w[2] = full.n_heads // n_model    # (G, B, nh, ...)
            np.testing.assert_array_equal(g, w, err_msg=key)
            if key.split("/")[-1] in ("embed", "unembed"):
                assert full.vocab_size // n_model in g, key
    return {k[len(pre):]: v for k, v in ranks[0].items() if k.startswith(pre)}


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_moe_built_args_have_jax_shard_shapes(runs, tag, shape):
    """The same for the full-size Phi-3.5-MoE: the router a rank's (G, D,
    E / n) and the stacked experts (G, E / n, D, F) of the n = "model"
    ranks, as the JAX ``shard_shape``s."""
    got = _check_args(runs, "phi/", "phi3.5-moe-42b-a6.6b", tag, shape)
    full = get_config("phi3.5-moe-42b-a6.6b")
    G, D, E, Fd = full.n_layers, full.d_model, full.n_experts, full.d_ff
    n = _shape(tag)[-1]
    np.testing.assert_array_equal(got["params/slots/0/ffn/router"],
                                  (G, D, E // n))
    np.testing.assert_array_equal(got["params/slots/0/ffn/wi"],
                                  (G, E // n, D, Fd))
    np.testing.assert_array_equal(got["params/slots/0/ffn/wo"],
                                  (G, E // n, Fd, D))


@pytest.mark.parametrize("tag", ["2x2", "2x1x2"])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_hybrid_built_args_have_jax_shard_shapes(runs, tag, shape):
    """The same for the full-size RecurrentGemma-2B, whose 10 query heads
    split over 2 ranks (on 1x4 the build refuses, naming A12): the rec
    blocks' w_gate, w_in and conv_w a rank's W/2 columns, w_out its W/2
    rows, a rec state's conv tail and h its W/2 channels, the attention
    cache the one KV head, as the JAX ``shard_shape``s."""
    got = _check_args(runs, "rg/", "recurrentgemma-2b", tag, shape)
    full = get_config("recurrentgemma-2b")
    D, W, G = full.d_model, full.lru_width, full.n_layers // 3
    np.testing.assert_array_equal(got["params/slots/0/rec/w_in"],
                                  (G, D, W // 2))
    np.testing.assert_array_equal(got["params/rest/1/rec/w_out"],
                                  (W // 2, D))
    np.testing.assert_array_equal(got["params/slots/1/rec/w_r"],
                                  (G, 8, W // 8, W // 8))
    if INPUT_SHAPES[shape].kind != "train":
        assert got["cache/slots/0/1"][-1] == W // 2
        assert got["cache/rest/0/0"][-1] == W // 2
        assert got["cache/slots/2/k"][-2] == 1


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_ssm_built_args_have_jax_shard_shapes(runs, tag, shape):
    """The same for the full-size xLSTM-350M, its 4 mLSTM heads over the
    "model" ranks: an mLSTM slot's w_up, w_gate, wq, wk and wv a rank's
    2D/n columns, w_if and w_down its 2D/n rows, an sLSTM slot's w_in its
    4D/n columns and w_out its D/n rows, r and b_in whole, as the JAX
    ``shard_shape``s; an mLSTM state (C, n, m) at the rank's 4/n heads
    (the JAX cache keeps all 4 on every rank of "model"), an sLSTM state
    whole."""
    got = _check_args(runs, "xl/", "xlstm-350m", tag, shape)
    full = get_config("xlstm-350m")
    D, nh, G = full.d_model, full.n_heads, full.n_layers // full.slstm_every
    n = _shape(tag)[-1]
    hd = 2 * D // nh
    np.testing.assert_array_equal(got["params/slots/0/wq"],
                                  (G, 2 * D, 2 * D // n))
    np.testing.assert_array_equal(got["params/slots/0/w_if"],
                                  (G, 2 * D // n, 2 * nh))
    np.testing.assert_array_equal(got["params/slots/7/w_in"],
                                  (G, D, 4 * D // n))
    np.testing.assert_array_equal(got["params/slots/7/w_out"],
                                  (G, D // n, D))
    np.testing.assert_array_equal(got["params/slots/7/r"],
                                  (G, nh, D // nh, 4 * D // nh))
    if INPUT_SHAPES[shape].kind != "train":
        assert tuple(got["cache/slots/0/0"][2:]) == (nh // n, hd, hd)
        assert got["cache/slots/7/3"][-1] == D


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
def test_fsdp_args_have_jax_shard_shapes(runs, tag):
    """``BuiltStep.args`` of train_4k's FSDP step (full-size Llama-3.1-8B):
    every parameter leaf, AdamW's m and v and the batch's rows have the
    JAX FSDP step's ``shard_shape``; at this size every weight is cut,
    none kept whole."""
    _check_fsdp_args(runs, "", "llama3.1-8b", tag)


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
def test_moe_fsdp_args_have_jax_shard_shapes(runs, tag):
    """The same for train_4k's FSDP step of the full-size Phi-3.5-MoE: its
    router and experts among the leaves every one of which is cut."""
    _check_fsdp_args(runs, "phi/", "phi3.5-moe-42b-a6.6b", tag)


@pytest.mark.parametrize("tag", ["2x2", "2x1x2"])
def test_hybrid_fsdp_args_have_jax_shard_shapes(runs, tag):
    """The same for train_4k's FSDP step of the full-size RecurrentGemma-2B:
    its stacked and ``rest`` rec leaves among the leaves every one of
    which is cut."""
    _check_fsdp_args(runs, "rg/", "recurrentgemma-2b", tag)


@pytest.mark.parametrize("tag", list(C.ARGS_MESHES))
def test_ssm_fsdp_args_have_jax_shard_shapes(runs, tag):
    """The same for train_4k's FSDP step of the full-size xLSTM-350M: its
    mLSTM and sLSTM leaves (r and b_in among them) every one of which is
    cut."""
    _check_fsdp_args(runs, "xl/", "xlstm-350m", tag)


def _check_fsdp_args(runs, pre: str, arch: str, tag: str) -> None:
    jx, ranks, _ = runs
    pre = f"args/{pre}{tag}/fsdp/"
    want = {k[len(pre):]: v for k, v in jx.items() if k.startswith(pre)}
    assert {k.split("/")[0] for k in want} == {"params", "opt", "batch"}
    full = get_config(arch)
    whole = {k: shape for k, (shape, _) in
             LM(full).mod.param_specs(full).items()}
    for res in ranks:
        got = {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}
        assert set(got) == set(want)
        for key, g in got.items():
            np.testing.assert_array_equal(g, want[key], err_msg=key)
        for key, shape in whole.items():
            assert np.prod(got[f"params/{key}"]) * WORLD == np.prod(shape), \
                key
        assert got["batch/tokens"][0] * WORLD == \
            INPUT_SHAPES["train_4k"].global_batch


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
                                  "chameleon-34b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b",
                                  "recurrentgemma-2b", "xlstm-350m"])
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
    collective; by ``axis_names`` and ``shape`` also for a JAX mesh.
    ``_Mesh.of(shape)`` is one of any shape over ``step_cases.mesh_axes``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n: int = WORLD, data: int = 1):
        self.sizes = (data, n)
        self.shape = {"data": data, "model": n}    # as the JAX mesh's
        # the runs of adjacent axes, as ``sharding.flatten_axes`` lists them
        names = self.mesh_dim_names
        self._flat_groups = {names[lo:hi]: None for lo in range(len(names))
                             for hi in range(lo + 2, len(names) + 1)}

    @classmethod
    def of(cls, shape, rank: int = 0):
        """A mesh of ``shape`` as rank ``rank`` (row-major) sees it."""
        class Shaped(cls):
            mesh_dim_names = C.mesh_axes(shape)

            def get_local_rank(self, axis):
                return int(np.unravel_index(rank, shape)[
                    self.mesh_dim_names.index(axis)])
        m = Shaped()
        m.sizes = tuple(shape)
        m.shape = dict(zip(m.mesh_dim_names, shape))
        return m

    @property
    def axis_names(self):
        return self.mesh_dim_names

    def size(self, dim):
        return self.sizes[dim]

    def get_group(self, axis):
        return None

    def get_local_rank(self, axis):
        return 0


FSDP_ARCHS = [a for a in list(ARCH_IDS) + ["llama31_8b"]
              if get_config(a).family in SH.SHARDED_FAMILIES]
FSDP_MESHES = ((2, 2), (1, 4), (1, 8), (2, 1, 2))


@pytest.mark.parametrize("arch", FSDP_ARCHS + ["step cases"])
def test_param_specs_fsdp_match_jax(arch):
    """The port's ``param_specs_fsdp`` against the JAX function leaf by
    leaf, on (2, 2), (1, 4), (1, 8) and (2, 1, 2) ("pod" in front): each
    dense, vlm, moe, hybrid and ssm config full and reduced, or
    ``step_cases``' configs."""
    if arch == "step cases":
        pairs = [(JAX_CFGS[n], make()) for n, make in C.CONFIGS.items()]
    else:
        pairs = [(jax_config(arch), get_config(arch)),
                 (jax_config(arch).reduced(), get_config(arch).reduced())]
    n = 0
    for jcfg, tcfg in pairs:
        jparams = JaxLM(jcfg).init_abstract()
        tparams = LM(tcfg).init(torch.Generator(), device="meta")
        for shape in FSDP_MESHES:
            mesh = _Mesh.of(shape)
            jspecs = JSS.param_specs_fsdp(jparams, mesh)
            for path, js, ts in _spec_pairs(
                    jspecs, SS.param_specs_fsdp(tparams, mesh)):
                assert tuple(map(_norm, js)) == tuple(map(_norm, ts)), \
                    (tcfg.name, shape, path)
                n += 1
    assert n > 40


@pytest.mark.parametrize("case", ["starcoder2_whole4/2x2", "llama_v510/1x4",
                                  "llama/2x1x2", "phi/2x2", "rg/2x2",
                                  "xl/2x2"])
def test_fsdp_init_params_keep_blocks_of_one_draw(case):
    """Under FSDP each rank's ``init_params`` are its blocks of the weights
    that one device draws from the same seed (``LM.init`` cut by
    ``local_params``): a leaf cut on its layer dim (starcoder2_whole4's bk
    and bv) keeps the rank's layers, embed and unembed over d_model, on
    (2, 1, 2) the flattened ("pod", "data", "model"), the reduced
    Phi-3.5-MoE's router and stacked experts their blocks, and the hybrid
    family's stacked and ``rest`` rec leaves theirs (``lam`` drawn in
    fp32), and the ssm family's mLSTM and sLSTM leaves theirs (``b_if``
    drawn as its fixed halves)."""
    from repro_torch.launch.steps import build_step, init_params
    from repro_torch.models.params import flatten
    name, tag = case.split("/")
    cfg = C.CONFIGS[name]()
    shape = dataclasses.replace(C.train_shape(name), global_batch=4)
    whole = LM(cfg).init(torch.Generator().manual_seed(3), device="cpu")
    n_cut = 0
    for r in range(WORLD):
        mesh = _Mesh.of(_shape(tag), r)
        built = build_step(cfg, mesh, shape, dtype=torch.float32,
                           param_mode="fsdp")
        got = flatten(init_params(cfg, built, torch.Generator().manual_seed(
            3), "cpu"))
        want = flatten(SS.local_params(whole, cfg, mesh, built.rules))
        assert set(got) == set(want)
        for key, t in want.items():
            assert torch.equal(got[key], t), (r, key)
            n_cut += t.shape != flatten(whole)[key].shape
    assert n_cut > 0


def test_refusals_name_a12():
    """The families the multi-device layers do not cover (FSDP's train step
    among them), a cut of heads without d_ff or of the vocabulary over
    another axis, and a MAX all-reduce that would need a backward; a rule
    over mesh axes that no process group flattens (not adjacent in the
    mesh's order). FSDP itself builds: ``param_mode="fsdp"`` for the dense
    family, and ``use_rules`` installs ``fsdp_gather``. The moe family: a
    capacity-routed step whose rank's rows split a group (train and
    prefill, 16 tokens a row over the two rows of 2x2, groups of 64), and
    an experts rule that disagrees with heads and d_ff; the dropless
    decode on the same split builds (and runs in the phi/2x2 serve case),
    as do the moe family's train, FSDP, prefill and serve steps. The
    hybrid family: the full-size RecurrentGemma-2B's 10 heads over 4
    ranks, an lru axis that cuts the 8 gate blocks (16 ranks, or 3), and
    an lru rule that differs from heads and d_ff; its reduced config's
    train, FSDP, prefill and serve steps build. The ssm family: the
    full-size xLSTM-350M's 4 mLSTM heads over an lru axis of 16 ranks (the
    production mesh's model axis) or 8, which would cut a head; its
    FSDP step there, and its train, FSDP, prefill and serve steps on 4
    ranks, build. The audio family raises under rules."""
    from repro_torch.launch.steps import build_step
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=4,
                                seq_len=16)
    llama = get_config("llama3.1-8b").reduced()
    built = build_step(llama, _Mesh(), shape, param_mode="fsdp")
    assert built.rules["fsdp_gather"] and \
        built.rules["batch"] == ("data", "model")
    assert built.args[2]["tokens"].shape == (1, 16)
    whisper = get_config("whisper-large-v3").reduced()
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="A12"):
            build_step(whisper, _Mesh(), INPUT_SHAPES[kind])
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(whisper, _Mesh(), shape, param_mode="fsdp")
    # the ssm family: an lru axis that does not divide the 4 mLSTM heads
    xl_full = get_config("xlstm-350m")
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="heads over 16.*A12"):
            build_step(xl_full, _Mesh(16), INPUT_SHAPES[kind])
    with pytest.raises(NotImplementedError, match="heads over 8.*A12"):
        build_step(xl_full, _Mesh(8), shape)
    assert build_step(xl_full, _Mesh(16), INPUT_SHAPES["train_4k"],
                      param_mode="fsdp")
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        assert build_step(xl_full, _Mesh(), INPUT_SHAPES[kind])
    assert build_step(C.CONFIGS["xl"](), _Mesh(), shape, param_mode="fsdp")
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(llama, _Mesh(), shape, rule_overrides={"d_ff": None})
    with pytest.raises(NotImplementedError, match="A12"):
        build_step(llama, _Mesh(), shape, rule_overrides={"vocab": "data"})
    # the moe family
    from repro_torch.models.moe_layer import check_groups
    phi = C.CONFIGS["phi"]()
    split = _Mesh.of((2, 2))
    for kind, seq in (("train", 16), ("prefill", 16)):
        with pytest.raises(NotImplementedError, match="A12"):
            build_step(phi, split, InputShape(kind, seq, 4, kind))
    with pytest.raises(NotImplementedError, match="A12"):
        check_groups(phi, 2, 2, dropless=False)
    check_groups(phi, 2, 2, dropless=True)
    assert build_step(phi, split, InputShape("decode", 32, 4, "decode"))
    for over in ({"experts": None}, {"heads": None, "d_ff": None},
                 {"experts": "data"}):
        with pytest.raises(NotImplementedError, match="A12"):
            build_step(phi, _Mesh(), C.MOE_TRAIN_SHAPE, rule_overrides=over)
    with pytest.raises(ValueError, match="experts"):
        build_step(phi, _Mesh(), C.MOE_TRAIN_SHAPE, param_mode="fsdp",
                   rule_overrides={"experts": "model"})
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"):
        cfg = get_config(arch).reduced()
        for kind in ("train_4k", "prefill_32k", "decode_32k"):
            assert build_step(cfg, _Mesh(), INPUT_SHAPES[kind])
        assert build_step(cfg, _Mesh(), C.MOE_TRAIN_SHAPE, param_mode="fsdp")

    # the hybrid family
    rg_full, rg = get_config("recurrentgemma-2b"), C.CONFIGS["rg"]()
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="A12"):
            build_step(rg_full, _Mesh(), INPUT_SHAPES[kind])
        assert build_step(rg_full, _Mesh(2), INPUT_SHAPES[kind])
        assert build_step(rg, _Mesh(), INPUT_SHAPES[kind])
    assert build_step(rg, _Mesh(), shape, param_mode="fsdp")
    rg16 = dataclasses.replace(rg, n_heads=16)     # the heads split
    for mesh in (_Mesh(16), _Mesh(3)):
        with pytest.raises(NotImplementedError, match="gate blocks.*A12"):
            build_step(rg16, mesh, shape)
    for over in ({"lru": None}, {"lru": "data"}, {"heads": None,
                                                  "d_ff": None}):
        with pytest.raises(NotImplementedError, match="A12"):
            build_step(rg, _Mesh(), shape, rule_overrides=over)

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
        with SH.use_rules({"fsdp_gather": True}, _Mesh()):
            assert SH.rule("fsdp_gather") and SH.mesh() is not None


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
