"""One rank of the cases of ``launch.steps`` on the CPU, over ``gloo``:

    python -m repro_torch.launch.step_cases --rdv FILE --rank R --world 4 \\
        --inputs IN.npz --out OUT.npz

Four such processes (ranks 0-3, one file rendezvous; the launcher sets
their torch threads with ``OMP_NUM_THREADS``) build the steps of
``launch.steps`` on meshes of the four ranks, run them on the inputs in
``IN.npz`` and each writes what it holds to its ``OUT.npz``;
``tests/test_torch_steps.py`` launches them and holds the ranks' results
against the JAX package's steps on the same meshes. The inputs (all made
from a seed by the caller):

- ``w/<cfg>/<path>``: the weights of each config in ``CONFIGS``,
  flattened as ``repro.training.checkpoint._flatten`` names them;
- ``train/tokens``, ``train/labels``: the global training batch, some
  labels masked; ``train/v510/{tokens,labels}`` the same within the
  vocabulary of ``llama_v510``;
- ``loss/tokens``, ``loss/labels``: a batch whose labels hold -1 and the
  first and last id of every rank's vocabulary block on (1, 4);
- ``serve/prompt`` (B, S) and ``serve/feed`` (B, n): the prefill's prompt
  and the tokens fed to the serve steps.

What each rank writes (fp32 unless said), by case:

- ``train/<case>/step<i>/{loss,grad_norm,lr}`` and, after the last step,
  ``train/<case>/{params,m,v}/<path>``: its blocks;
- ``serve/<case>/prefill`` (the argmax tokens), ``serve/<case>/step<i>``,
  ``serve/<case>/cache/<slot>/{k,v}`` after the steps, and
  ``serve/<case>/kv_heads`` (the rank's KV heads);
- ``args/<mesh>/<shape>/<part>/<path>``: the shape of each leaf of
  ``BuiltStep.args`` for the full-size Llama-3.1-8B;
- ``split/<mesh>/<n>/{pre,dec}``: ``split_disagg_mesh``'s pools' ranks
  (data x model), and ``split/<mesh>/<n>/sum`` the SUM of the ranks over
  the rank's own pool's data axis;
- ``loss/{nll,count}``: ``LM.loss_terms`` of the reduced Llama on (1, 4)
  with ``embed``/``unembed`` cut over the vocabulary, and
  ``loss/whole/{nll,count}`` the same outside rules on the whole weights;
- ``production``: the message ``make_production_mesh`` raises with;
- ``grad/{gather,reduce,entry}``: the gradients of ``all_gather``,
  ``all_reduce`` and ``entry`` on the (1, 4) mesh, and ``grad/flat/*``
  over the flattened ("pod", "data") of the (2, 2, 1) mesh.

A mesh's tag is its shape: "DxM" over ("data", "model"), "PxDxM" over
("pod", "data", "model"), whose batch is cut over ("pod", "data").
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import (batch_axes_for, make_mesh,
                                     make_production_mesh, split_disagg_mesh)
from repro_torch.launch.steps import build_step, materialize
from repro_torch.models import LM
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.params import flatten
from repro_torch.training.optimizer import AdamWConfig

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1), "2x2x1": (2, 2, 1),
          "2x1x2": (2, 1, 2)}


def mesh_axes(shape) -> tuple:
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def whole_kv(cfg):
    """A reduced config whose kv_dim the 4-rank model axis does not divide
    (one KV head of 34): ``head_plan``'s "whole" KV plan."""
    return dataclasses.replace(cfg, n_kv_heads=1, head_dim=34)


# name -> the reduced config; the test builds the same on the JAX side
CONFIGS = {
    "llama": lambda: get_config("llama3.1-8b").reduced(),
    "starcoder2_whole": lambda: whole_kv(get_config("starcoder2-15b")
                                         .reduced()),
    "chameleon": lambda: get_config("chameleon-34b").reduced(),
    "llama_v510": lambda: dataclasses.replace(
        get_config("llama3.1-8b").reduced(), vocab_size=VOCAB_UNEVEN),
}
# a vocabulary that 4 does not divide: embed and unembed stay whole on (1, 4)
VOCAB_UNEVEN = 510
# (case, config, mesh): the reduced Llama's 2 KV heads over 4 ranks take the
# "gather" plan, over 2 "own", over 1 none, its vocabulary cut over
# "model"; on (2, 2, 1) and (2, 1, 2) its batch over ("pod", "data");
# starcoder2_whole "whole" with QKV bias; chameleon the QK-norm's weights,
# used in part on each rank; llama_v510 a vocabulary held whole
TRAIN_CASES = (("llama/1x4", "llama", "1x4"), ("llama/2x2", "llama", "2x2"),
               ("llama/4x1", "llama", "4x1"),
               ("llama/2x2x1", "llama", "2x2x1"),
               ("llama/2x1x2", "llama", "2x1x2"),
               ("llama_v510/1x4", "llama_v510", "1x4"),
               ("starcoder2_whole/1x4", "starcoder2_whole", "1x4"),
               ("chameleon/1x4", "chameleon", "1x4"))
TRAIN_SHAPE = InputShape("train_small", 16, 4, "train")


def train_batch(name: str) -> str:
    """The inputs' prefix of config ``name``'s training batch."""
    return "train/v510" if name == "llama_v510" else "train"

TRAIN_STEPS = 2
# the serve cases: the prefill fills 32 rows, then the serve steps write
# rows 22-27 (crossing 24, a rank boundary under kv_seq on 1x4)
SERVE_PREFILL = InputShape("prefill_small", 32, 4, "prefill")
SERVE_DECODE = InputShape("decode_small", 32, 4, "decode")
SERVE_POS = 22
KV_SEQ = {"heads": None, "d_ff": None}     # weights whole, rows over "model"
SERVE_CASES = (("kv_seq/1x4", "1x4", KV_SEQ, "model"),
               ("heads/1x4", "1x4", None, None),
               ("heads/2x2", "2x2", None, None),
               ("heads/2x2x1", "2x2x1", None, None))
ARGS_MESHES = ("1x4", "2x2", "2x1x2")


def train_opt() -> AdamWConfig:
    """The fp32 AdamW of the CPU cases (the JAX side's too)."""
    return AdamWConfig(state_dtype=torch.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _weights(inp, name: str, cfg) -> dict:
    pre = f"w/{name}/"
    return params_from_numpy({k[len(pre):]: v for k, v in inp.items()
                              if k.startswith(pre)}, cfg, "cpu")


def train_case(inp, case: str, name: str, mesh, out: Dict[str, np.ndarray]):
    cfg = CONFIGS[name]()
    built = build_step(cfg, mesh, TRAIN_SHAPE, dtype=torch.float32,
                       opt_cfg=train_opt())
    params = SS.local_params(_weights(inp, name, cfg), cfg, mesh, built.rules)
    for key, t in flatten(built.args[0]).items():
        assert flatten(params)[key].shape == t.shape, key
    opt = materialize(built.args[1], "cpu")
    baxes = batch_axes_for(TRAIN_SHAPE.global_batch, mesh)
    batch = SS.local_batch({k: torch.from_numpy(inp[f"{train_batch(name)}/"
                                                    f"{k}"])
                            for k in ("tokens", "labels")}, baxes, mesh)
    for i in range(TRAIN_STEPS):
        params, opt, metrics = built.fn(params, opt, batch)
        for k, v in metrics.items():
            out[f"train/{case}/step{i}/{k}"] = _np(v)
    for part, tree in (("params", params), ("m", opt["m"]), ("v", opt["v"])):
        for key, t in flatten(tree).items():
            out[f"train/{case}/{part}/{key}"] = _np(t)


def serve_case(inp, case: str, mesh, overrides, kv_seq,
               out: Dict[str, np.ndarray]) -> None:
    cfg = CONFIGS["llama"]()
    kw = dict(dtype=torch.float32, rule_overrides=overrides,
              kv_seq_axis=kv_seq)
    pre = build_step(cfg, mesh, SERVE_PREFILL, **kw)
    dec = build_step(cfg, mesh, SERVE_DECODE, **kw)
    params = SS.local_params(_weights(inp, "llama", cfg), cfg, mesh,
                             pre.rules)
    baxes = batch_axes_for(SERVE_PREFILL.global_batch, mesh)
    rows = SS.local_batch({"prompt": torch.from_numpy(inp["serve/prompt"]),
                           "feed": torch.from_numpy(inp["serve/feed"])},
                          baxes, mesh)
    cache = materialize(pre.args[2], "cpu")
    tokens, cache = pre.fn(params, {"tokens": rows["prompt"]}, cache)
    out[f"serve/{case}/prefill"] = tokens.numpy()
    cache["pos"] = torch.tensor(SERVE_POS, dtype=torch.int32)
    for i in range(rows["feed"].shape[1]):
        tokens, cache = dec.fn(params, rows["feed"][:, i].contiguous(), cache)
        out[f"serve/{case}/step{i}"] = tokens.numpy()
    for i, slot in enumerate(cache["slots"]):
        for name in ("k", "v"):
            out[f"serve/{case}/cache/{i}/{name}"] = _np(slot[name])
    with SH.use_rules(dec.rules, mesh):
        out[f"serve/{case}/kv_heads"] = np.asarray(L.head_plan(cfg).kv_heads)


def args_shapes(mesh, tag: str, out: Dict[str, np.ndarray]) -> None:
    cfg = get_config("llama3.1-8b")
    for name, shape in INPUT_SHAPES.items():
        built = build_step(cfg, mesh, shape)
        for part, tree in zip(("params", "opt", "batch", "cache")
                              if shape.kind == "train" else
                              ("params", "batch", "cache"), built.args):
            if part == "batch" and shape.kind == "decode":
                tree = {"token": tree}
            for key, t in flatten(tree).items():
                out[f"args/{tag}/{name}/{part}/{key}"] = np.asarray(t.shape)


def splits(meshes, out: Dict[str, np.ndarray]) -> None:
    rank = dist.get_rank()
    for tag, n_pre in (("4x1", 1), ("4x1", 2), ("4x1", 3), ("2x2", 1)):
        pre, dec = split_disagg_mesh(meshes[tag], n_pre)
        out[f"split/{tag}/{n_pre}/pre"] = pre.mesh.numpy()
        out[f"split/{tag}/{n_pre}/dec"] = dec.mesh.numpy()
        own = pre if pre.get_coordinate() is not None else dec
        x = torch.tensor([float(rank)])
        if own.size(0) > 1:
            dist.all_reduce(x, group=own.get_group("data"))
        out[f"split/{tag}/{n_pre}/sum"] = x.numpy()


def collective_grads(mesh, axis, tag: str,
                     out: Dict[str, np.ndarray]) -> None:
    """Each rank's x (2, 3) = rank + arange; the gradients of sum(w_r y)
    for y = all_gather(x, axis, 1), all_reduce(x) and entry(x), with
    w_r = (rank + 1) (1 + the column of y)."""
    r = dist.get_rank()
    rules = SH.standard_rules("pod" in mesh.mesh_dim_names)
    with SH.use_rules(rules, mesh):
        for name in ("gather", "reduce", "entry"):
            x = (torch.arange(6.0).reshape(2, 3) + r).requires_grad_()
            if name == "gather":
                y = SH.all_gather(x, axis, 1)
            elif name == "reduce":
                y = SH.all_reduce(x * 1.0, axis)
            else:
                y = SH.entry(x, axis)
            w = (r + 1.0) * (1.0 + torch.arange(float(y.shape[-1])))
            (y * w).sum().backward()
            out[f"{tag}/{name}"] = _np(x.grad)
            out[f"{tag}/{name}/y"] = _np(y)


def loss_case(inp, mesh, out: Dict[str, np.ndarray]) -> None:
    """``LM.loss_terms`` with the vocabulary cut over "model" (the
    reduced Llama's 512 ids in blocks of 128) and outside rules."""
    cfg = CONFIGS["llama"]()
    whole = _weights(inp, "llama", cfg)
    batch = {k: torch.from_numpy(inp[f"loss/{k}"]) for k in ("tokens",
                                                            "labels")}
    rules = SH.standard_rules(False)
    with torch.no_grad():
        with SH.use_rules(rules, mesh):
            nll, count, _ = LM(cfg).loss_terms(
                SS.local_params(whole, cfg, mesh), batch, remat=False)
        out["loss/nll"], out["loss/count"] = _np(nll), _np(count)
        nll, count, _ = LM(cfg).loss_terms(whole, batch, remat=False)
        out["loss/whole/nll"], out["loss/whole/count"] = _np(nll), _np(count)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rdv", required=True, help="rendezvous file")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    dist.init_process_group("gloo", init_method=f"file://{args.rdv}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=60))
    inp = dict(np.load(args.inputs))
    out: Dict[str, np.ndarray] = {}
    meshes = {tag: make_mesh(shape, mesh_axes(shape), backend="gloo",
                             device="cpu") for tag, shape in MESHES.items()}
    for case, name, tag in TRAIN_CASES:
        train_case(inp, case, name, meshes[tag], out)
    for case, tag, overrides, kv_seq in SERVE_CASES:
        serve_case(inp, case, meshes[tag], overrides, kv_seq, out)
    for tag in ARGS_MESHES:
        args_shapes(meshes[tag], tag, out)
    splits(meshes, out)
    collective_grads(meshes["1x4"], "model", "grad", out)
    collective_grads(meshes["2x2x1"], ("pod", "data"), "grad/flat", out)
    loss_case(inp, meshes["1x4"], out)
    try:
        make_production_mesh(backend="gloo", device="cpu")
        out["production"] = np.asarray("built")
    except ValueError as e:
        out["production"] = np.asarray(str(e))
    np.savez(args.out, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
