"""One rank of the multi-device layers' cases on the CPU, over ``gloo``:

    python -m repro_torch.launch.dist_cases --rdv FILE --rank R --world 4 \\
        --inputs IN.npz --out OUT.npz

Four such processes (ranks 0-3, one file rendezvous; the launcher sets
their torch threads with ``OMP_NUM_THREADS``) run the layers under
sharding rules on the inputs in ``IN.npz`` and each writes what it holds
to its ``OUT.npz``; ``tests/test_torch_dist.py`` launches them and holds
the ranks' results against the JAX package's functions under the same
rules. The inputs (all made from a seed by the caller):

- ``dd/q``, ``dd/kc``, ``dd/vc``, ``dd/kn``, ``dd/vn``, ``dd/pos``: one
  decode step's q, caches, new k and v and the positions to run;
- ``x``: activations (B, S, d_model) of the reduced configs;
- ``layer/<arch>/<name>``: one attention block's and one FFN's weights;
- ``lm/<path>``: the reduced Llama-3.1-8B's parameters, flattened as
  ``repro.training.checkpoint._flatten`` names them; ``lm/tokens`` (B, S)
  the prompt and ``lm/steps`` (B, n) the tokens fed to the decode steps.

What each rank writes (its own block, in fp32), by case:

- ``dd/<mesh>/<pos>/{out,kc,vc}``: ``dist_decode_attention`` with the
  batch over "data" and the cache rows over "model";
- ``tp/<arch>/<dtype>/{mlp,attn}``: ``mlp_forward`` and ``attn_forward``
  under ``tp_bf16_ar`` on the (1, 4) mesh, the parameters cut by
  ``shardspecs.local_leaf``;
- ``lm/<case>/{prefill,step<i>,train}``: the reduced model's logits through
  ``LM.prefill`` and ``decode_step`` (and ``forward_train`` under tensor
  parallelism, its vocabulary block gathered), ``lm/<case>/cache/<slot>/
  {k,v}`` its cache at the end;
- ``local/<mesh>/<path>``: ``shardspecs.local_params`` of the model under
  ``standard_rules`` (the layers' leaves and the vocabulary cut);
- ``batch_axes/<mesh>/<batch>``: ``mesh.batch_axes_for`` of each batch in
  ``BATCHES``, its axes joined by commas.
"""
from __future__ import annotations

import argparse
import datetime
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch.mesh import batch_axes_for, make_mesh
from repro_torch.launch.shardspecs import local_leaf, local_params
from repro_torch.models import LM
from repro_torch.models import layers as L
from repro_torch.models import sharding as SH
from repro_torch.models.params import flatten
from repro_torch.models.transformer import whole_logits

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
ARCHS = {"llama": "llama3.1-8b", "starcoder2": "starcoder2-15b"}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
KV_SEQ_MAX_LEN = 32
BATCHES = (1, 2, 3, 4, 6, 8)


def rules_kv_seq() -> dict:
    """The KV sequence over "model", every weight whole."""
    return {**SH.standard_rules(False), "heads": None, "d_ff": None,
            "kv_seq": "model"}


def rules_tp() -> dict:
    """Heads and d_ff over "model", partial products all-reduced in the
    activations' dtype."""
    return {**SH.standard_rules(False), "tp_bf16_ar": True}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _lm_params(inp, cfg, dtype=torch.float32) -> dict:
    flat = {k[3:]: v for k, v in inp.items()
            if k.startswith("lm/") and k not in ("lm/tokens", "lm/steps")}
    return params_from_numpy(flat, cfg, "cpu", dtype)


def _rows(t, mesh, axis: str, dim: int):
    """This rank's block of ``t`` along ``dim`` over mesh axis ``axis``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    blk = t.shape[dim] // n
    return t.narrow(dim, mesh.get_local_rank(axis) * blk, blk).contiguous()


def dist_decode(inp, mesh, tag: str, out: Dict[str, np.ndarray]) -> None:
    rules = {**SH.standard_rules(False), "kv_seq": "model"}
    with SH.use_rules(rules, mesh):
        for pos in inp["dd/pos"].tolist():
            q, kc, vc, kn, vn = (
                _rows(torch.tensor(inp[f"dd/{k}"]), mesh, "data", 0)
                for k in ("q", "kc", "vc", "kn", "vn"))
            kc, vc = _rows(kc, mesh, "model", 1), _rows(vc, mesh, "model", 1)
            o, kc, vc = L.dist_decode_attention(q, kc, vc, kn, vn,
                                                torch.tensor(pos))
            for name, t in (("out", o), ("kc", kc), ("vc", vc)):
                out[f"dd/{tag}/{pos}/{name}"] = _np(t)


def tp_layers(inp, mesh, out: Dict[str, np.ndarray]) -> None:
    with SH.use_rules(rules_tp(), mesh):
        for arch, arch_id in ARCHS.items():
            cfg = get_config(arch_id).reduced()
            for dname, dtype in DTYPES.items():
                x = torch.tensor(inp["x"]).to(dtype)
                blocks = {}
                for block in ("attn", "ffn"):
                    pre = f"layer/{arch}/{block}/"
                    blocks[block] = {
                        k[len(pre):]: local_leaf(
                            cfg, f"{block}/{k[len(pre):]}",
                            torch.tensor(v), mesh).to(dtype)
                        for k, v in inp.items() if k.startswith(pre)}
                tag = f"tp/{arch}/{dname}"
                out[f"{tag}/mlp"] = _np(L.mlp_forward(blocks["ffn"], x, cfg))
                out[f"{tag}/attn"] = _np(L.attn_forward(blocks["attn"], x,
                                                        cfg))


def lm_case(inp, mesh, rules, tp: bool, dtype, tag: str,
            out: Dict[str, np.ndarray]) -> None:
    """Prefill + decode steps of the reduced Llama-3.1-8B under ``rules``
    (the batch over "data"), with its forward under tensor parallelism."""
    cfg = get_config("llama3.1-8b").reduced()
    params = _lm_params(inp, cfg, dtype)
    tokens = _rows(torch.tensor(inp["lm/tokens"]).long(), mesh, "data", 0)
    steps = _rows(torch.tensor(inp["lm/steps"]).long(), mesh, "data", 0)
    lm = LM(cfg)
    with SH.use_rules(rules, mesh):
        if tp:
            params = local_params(params, cfg, mesh)
            out[f"{tag}/train"] = _np(whole_logits(lm.forward_train(
                params, {"tokens": tokens}, remat=False)[0], cfg))
        cache = lm.init_cache(tokens.shape[0], KV_SEQ_MAX_LEN, dtype=dtype,
                              device="cpu")
        logits, cache = lm.prefill(params, {"tokens": tokens}, cache)
        out[f"{tag}/prefill"] = _np(logits)
        for i in range(steps.shape[1]):
            logits, cache = lm.decode_step(params, steps[:, i], cache)
            out[f"{tag}/step{i}"] = _np(logits)
    for i, slot in enumerate(cache["slots"]):
        for name in ("k", "v"):
            out[f"{tag}/cache/{i}/{name}"] = _np(slot[name])


def local(inp, mesh, tag: str, out: Dict[str, np.ndarray]) -> None:
    cfg = get_config("llama3.1-8b").reduced()
    loc = local_params(_lm_params(inp, cfg), cfg, mesh)
    for path, t in flatten(loc).items():
        out[f"local/{tag}/{path}"] = _np(t)


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
    meshes = {tag: make_mesh(shape, ("data", "model"), backend="gloo",
                             device="cpu") for tag, shape in MESHES.items()}
    with torch.no_grad():
        for tag, mesh in meshes.items():
            dist_decode(inp, mesh, tag, out)
            local(inp, mesh, tag, out)
            for bs in BATCHES:
                out[f"batch_axes/{tag}/{bs}"] = np.asarray(
                    ",".join(batch_axes_for(bs, mesh)))
        tp_layers(inp, meshes["1x4"], out)
        for dname, dtype in DTYPES.items():
            lm_case(inp, meshes["1x4"], rules_kv_seq(), False, dtype,
                    f"lm/kv_seq/{dname}", out)
            lm_case(inp, meshes["1x4"], rules_tp(), True, dtype,
                    f"lm/tp/1x4/{dname}", out)
        lm_case(inp, meshes["2x2"], rules_tp(), True, torch.float32,
                "lm/tp/2x2/fp32", out)
    np.savez(args.out, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
