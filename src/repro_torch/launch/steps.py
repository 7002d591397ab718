"""The step functions for a (cfg, mesh, input-shape) triple, after
``repro.launch.steps``: a train step, a prefill step and a serve (decode)
step on a ``DeviceMesh``, used by the launchers and ``chip_smoke.py``.

The JAX package jits each step with its arrays' shardings and lets GSPMD
place them. The port shards explicitly (``models.sharding``): each rank
holds its own block of every argument and runs the step on it eagerly,
with the rules installed, and the layers call the collectives themselves.
So ``BuiltStep.args`` are this rank's blocks, as tensors on the meta
device (shapes and dtypes, nothing allocated): the parameters cut as
``shardspecs.local_params`` cuts them under the step's rules (the layers'
leaves by heads and d_ff, ``embed`` and ``unembed`` by vocab), AdamW's m,
v and count, the batch's rows as ``shardspecs.local_batch`` takes them
(over the flattened ("pod", "data") on a multi-pod mesh) and the cache as
``transformer.local_cache`` sizes it. ``init_params`` draws the weights
into those blocks, and a prefill or serve step's ``new_cache(device)``
makes the rank's fresh cache as the family initialises it. ``fn`` runs on
real tensors of those shapes and updates the parameters, the optimizer
state and the cache in place, where the JAX steps donate them.

The train step computes what the JAX one computes over the global batch:
the loss is the masked mean over every rank's rows (its log-sum-exp taken
over the vocabulary's blocks, ``LM.loss_terms``) plus the MoE FFNs' aux
loss averaged over the batch's ranks (each rank's the mean over its own
groups, so the average is the mean over the global batch's groups), each
leaf's gradient is the global one restricted to the rank's block (a
leaf held whole but read in part, the QK-norm's weights under the heads'
rule, an RG-LRU block's gates or an sLSTM's recurrence and bias under the
lru rule, summed over that axis), the gradient norm is the global norm,
and the clip and AdamW run on those.
Each step's rules name in ``batch`` the mesh axes its rows are cut over
(none where ``batch_axes_for`` leaves the batch whole), which the MoE FFN
reads to tell whether the rank's rows hold whole groups of the global
token stream (``moe_layer.check_groups``, which the train and prefill
builders also call). The prefill and serve
steps take the argmax of whole logits, gathered over the vocabulary's
blocks by ``transformer.prefill`` and ``decode_step``.

``build_train_step(..., param_mode="fsdp")`` is the JAX FSDP step (ZeRO-3):
no tensor parallelism, the batch's rows over every mesh axis flattened
(``sharding.fsdp_axes``), and each rank holds its block of every leaf and
of AdamW's m and v as ``shardspecs.param_specs_fsdp`` places them (a leaf
no dim of which the ranks divide whole). The model gathers a layer
group's weights inside its remat (``sharding.maybe_gather_params``), and
the gather's backward sums each gathered leaf's gradient over the same
ranks and keeps the rank's block, so the data-parallel sum runs only on the
leaves kept whole; the norm sums each block's squares over the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import batch_axes_for
from repro_torch.models import LM
from repro_torch.models import layers as L
from repro_torch.models import rglru, xlstm
from repro_torch.models import sharding as SH
from repro_torch.models.api import MOE_AUX_WEIGHT, family_module
from repro_torch.models.moe_layer import check_groups
from repro_torch.models.params import (flatten, init_from_specs, leaf_dtype,
                                       map_leaves, rebuild, unflatten)
from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                            sum_squares)

LONG_CONTEXT_WINDOW = 8192   # sliding-window used by full-attention archs
                             # for the long_500k shape (sub-quadratic decode)


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    args: tuple                # this rank's blocks, on the meta device
    mesh: object
    rules: dict
    kind: str
    # a prefill or serve step's: this rank's fresh cache on a device, as
    # the family initialises it (an xLSTM state's m at -1e30, not zeros)
    new_cache: Optional[Callable] = None


def effective_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm", "audio"):
        return LONG_CONTEXT_WINDOW
    return cfg.window


def _rules_for(cfg: ModelConfig, mesh, overrides=None):
    rules = SH.standard_rules("pod" in mesh.mesh_dim_names)
    if overrides:
        rules.update(overrides)
    return rules


def _local_rows(global_batch: int, baxes, mesh) -> int:
    return SS.block((baxes or None,), (global_batch,), mesh)[0][1]


def _rows_over(rules: dict, baxes, cfg: ModelConfig, mesh, shape: InputShape,
               dropless: bool) -> int:
    """The rank's rows of ``shape``'s batch, cut over ``baxes``, which
    ``rules`` then name as the batch's axes; raises where a capacity-routed
    MoE step's rows would split a group of the global token stream."""
    rules["batch"] = baxes or None
    rows = _local_rows(shape.global_batch, baxes, mesh)
    if cfg.n_experts:
        check_groups(cfg, rows * shape.seq_len, SH.axis_size(mesh, baxes),
                     dropless)
    return rows


def _meta_params(cfg: ModelConfig, blocks: dict, dtype) -> dict:
    flat = {}
    for key, (shape, init) in family_module(cfg).param_specs(cfg).items():
        kept = tuple(n for _, n in blocks[key][0]) if key in blocks else shape
        flat[key] = torch.empty(kept, dtype=leaf_dtype(init, dtype),
                                device="meta")
    return unflatten(flat)


def init_params(cfg: ModelConfig, built: BuiltStep,
                generator: torch.Generator, device) -> dict:
    """This rank's parameters for ``built``: every leaf drawn from
    ``generator`` as ``LM.init`` draws it (so ranks given the same seed
    draw the weights that one device would), the rank's block of it kept,
    in the dtype of ``built.args[0]``."""
    dtype = flatten(built.args[0])["embed"].dtype
    blocks = SS.param_blocks(cfg, built.mesh, built.rules)
    return init_from_specs(family_module(cfg).param_specs(cfg), generator,
                           dtype, torch.device(device),
                           {k: b for k, (b, _) in blocks.items()})


def materialize(tree, device):
    """Zeroed tensors on ``device`` shaped as a tree of meta tensors."""
    return map_leaves(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                            device=device), tree)


def _meta_batch(cfg: ModelConfig, rows: int, seq: int, dtype,
                with_labels: bool = True) -> dict:
    """The rank's rows of ``make_batch_specs``' batch, on the meta device."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    specs = {"tokens": meta((rows, seq), torch.int32)}
    if with_labels:
        specs["labels"] = meta((rows, seq), torch.int32)
    if cfg.is_encoder_decoder:
        specs["enc_feats"] = meta((rows, cfg.encoder_seq, cfg.d_model), dtype)
    return specs


def _cache_maker(lm: LM, rules, mesh, rows: int, max_len: int, dtype,
                 window) -> Callable:
    """device -> this rank's fresh cache on it (``LM.init_cache`` under
    ``rules``)."""
    def make(device):
        with SH.use_rules(rules, mesh):
            return lm.init_cache(rows, max_len, dtype, window=window,
                                 device=device)
    return make


def train_batch_axes(shape: InputShape, mesh, rules) -> tuple:
    """The mesh axes a train step's batch rows are cut over, flattened:
    under FSDP the rules' batch axes (every axis of the mesh), else
    ``batch_axes_for``."""
    if rules.get("fsdp_gather"):
        return SH.axis_names(rules["batch"])
    return batch_axes_for(shape.global_batch, mesh)


def build_train_step(cfg: ModelConfig, mesh, shape: InputShape,
                     dtype=torch.bfloat16,
                     opt_cfg: Optional[AdamWConfig] = None,
                     rule_overrides=None, remat=True,
                     param_mode: str = "2d") -> BuiltStep:
    lm = LM(cfg)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=torch.bfloat16)
    if param_mode == "fsdp":
        # ZeRO-3: no tensor parallelism; the batch over every mesh axis;
        # each layer's weights gathered inside its remat (fsdp_gather)
        fs = {"heads": None, "kv_heads": None, "d_ff": None, "experts": None,
              "vocab": None, "lru": None, "fsdp_gather": True,
              "batch": SH.fsdp_axes(mesh)}
        rule_overrides = {**fs, **(rule_overrides or {})}
    rules = _rules_for(cfg, mesh, rule_overrides)
    blocks = SS.param_blocks(cfg, mesh, rules)
    baxes = train_batch_axes(shape, mesh, rules)
    if shape.global_batch % SH.axis_size(mesh, baxes):
        raise ValueError(f"a global batch of {shape.global_batch} does not "
                         f"split over the batch axes {baxes}")
    rows = _rows_over(rules, baxes, cfg, mesh, shape, dropless=False)
    bax = baxes or None          # a tuple of two axes is flattened
    n_batch = SH.axis_size(mesh, baxes)
    window = effective_window(cfg, shape)
    # the leaves whose gradient the gather's backward already summed over
    # the batch's ranks (FSDP's; the same group as the batch's)
    summed = set(blocks) if rules.get("fsdp_gather") else set()

    abstract_params = _meta_params(cfg, blocks, dtype)

    def moment(p):
        return torch.empty(p.shape, dtype=opt_cfg.state_dtype, device="meta")
    abstract_opt = {"m": map_leaves(moment, abstract_params),
                    "v": map_leaves(moment, abstract_params),
                    "count": torch.empty((), dtype=torch.int32,
                                         device="meta")}
    abstract_batch = _meta_batch(cfg, rows, shape.seq_len, dtype)
    with SH.use_rules(rules, mesh):
        partial = _partial_leaves(cfg, abstract_params, rules)

    def train_step(params, opt_state, batch):
        with SH.use_rules(rules, mesh):
            flat = flatten(params)
            leaves = [p.requires_grad_() for p in flat.values()]
            nll, count, aux = lm.loss_terms(params, batch, window=window,
                                            remat=remat)
            # the masked mean over every rank's rows
            nll = SH.all_reduce(nll, bax)
            with torch.no_grad():
                count = SH.all_reduce(count, bax)
            # the aux loss's mean over the batch's ranks (a SUM whose
            # backward is the identity, so each rank's aux gradient is
            # 1 / n_batch of it, which the data-parallel sum adds up)
            if cfg.n_experts and n_batch > 1:
                aux = SH.all_reduce(aux * 1.0, bax) / n_batch
            loss = nll / count.clamp(min=1.0) + MOE_AUX_WEIGHT * aux
            grads = dict(zip(flat, torch.autograd.grad(loss, leaves)))
            for p in leaves:
                p.requires_grad_(False)
            with torch.no_grad():
                for key, g in grads.items():         # data parallel
                    if key not in summed:
                        SH.all_reduce(g, bax)
                for key, axis in partial.items():    # a rank's share
                    SH.all_reduce(grads[key], axis)
                gnorm = _global_norm(grads, blocks)
            params, opt_state, metrics = apply_updates(
                opt_cfg, params, rebuild(params, grads.values()), opt_state,
                gnorm=gnorm)
            metrics["loss"] = loss.detach()
            return params, opt_state, metrics

    return BuiltStep(train_step, (abstract_params, abstract_opt,
                                  abstract_batch), mesh, rules, "train")


def _partial_leaves(cfg: ModelConfig, abstract_params, rules) -> dict:
    """The leaves a rank holds whole and reads in part under the active
    ``rules``: path -> the axis its gradient's shares are summed over. The
    attention's by their parent's name (the heads' axis), an RG-LRU
    block's likewise (the lru width's); an xLSTM's by their full paths
    (``xlstm.partial_leaves``, the lru width's), since a slot's parent is
    its index."""
    if cfg.family == "ssm":
        return {key: rules["lru"] for key in xlstm.partial_leaves(cfg)}
    in_part = {"attn": (L.head_plan(cfg).axis, L.partial_leaves(cfg))}
    if cfg.family == "hybrid":
        in_part["rec"] = (rules["lru"], rglru.partial_leaves())
    partial = {}
    for key in flatten(abstract_params):
        *_, block, leaf = ["", *key.split("/")]
        axis, names = in_part.get(block, (None, ()))
        if leaf in names:
            partial[key] = axis
    return partial


def _global_norm(grads: dict, blocks: dict) -> torch.Tensor:
    """The norm of the whole gradient: a cut leaf's squares summed over the
    axes it is cut over, a whole leaf's counted once."""
    by_axes: Dict[tuple, list] = {}
    for key, g in grads.items():
        by_axes.setdefault(blocks[key][1] if key in blocks else (),
                           []).append(g)
    total = None
    for axes in sorted(by_axes):
        part = sum_squares(by_axes[axes])
        for a in axes:
            part = SH.all_reduce(part, a)
        total = part if total is None else total + part
    return torch.sqrt(total)


def build_prefill_step(cfg: ModelConfig, mesh, shape: InputShape,
                       dtype=torch.bfloat16, rule_overrides=None,
                       kv_seq_axis=None) -> BuiltStep:
    """The prompt's last-token argmax and the filled cache. ``kv_seq_axis``
    shards the cache's rows, as the JAX step's cache sharding does; here it
    is also the ``kv_seq`` rule, by which the layers fill only the rank's
    rows."""
    lm = LM(cfg)
    if kv_seq_axis:
        rule_overrides = dict(rule_overrides or {}, kv_seq=kv_seq_axis)
    rules = _rules_for(cfg, mesh, rule_overrides)
    blocks = SS.param_blocks(cfg, mesh, rules)
    baxes = batch_axes_for(shape.global_batch, mesh)
    rows = _rows_over(rules, baxes, cfg, mesh, shape, dropless=False)
    window = effective_window(cfg, shape)

    abstract_params = _meta_params(cfg, blocks, dtype)
    abstract_batch = _meta_batch(cfg, rows, shape.seq_len, dtype,
                                 with_labels=False)
    new_cache = _cache_maker(lm, rules, mesh, rows, shape.seq_len, dtype,
                             window)
    abstract_cache = new_cache("meta")

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        with SH.use_rules(rules, mesh):
            logits, cache = lm.prefill(params, batch, cache, window=window)
            return logits.argmax(-1).to(torch.int32), cache

    return BuiltStep(prefill_step, (abstract_params, abstract_batch,
                                    abstract_cache), mesh, rules, "prefill",
                     new_cache)


def build_serve_step(cfg: ModelConfig, mesh, shape: InputShape,
                     dtype=torch.bfloat16, rule_overrides=None,
                     kv_seq_axis=None) -> BuiltStep:
    """One decode step: new token given a KV cache of shape.seq_len."""
    lm = LM(cfg)
    if kv_seq_axis:
        rule_overrides = dict(rule_overrides or {}, kv_seq=kv_seq_axis)
    rules = _rules_for(cfg, mesh, rule_overrides)
    blocks = SS.param_blocks(cfg, mesh, rules)
    baxes = batch_axes_for(shape.global_batch, mesh)
    rows = _rows_over(rules, baxes, cfg, mesh, shape, dropless=True)
    window = effective_window(cfg, shape)

    abstract_params = _meta_params(cfg, blocks, dtype)
    new_cache = _cache_maker(lm, rules, mesh, rows, shape.seq_len, dtype,
                             window)
    abstract_cache = new_cache("meta")
    abstract_token = torch.empty((rows,), dtype=torch.int32, device="meta")

    @torch.no_grad()
    def serve_step(params, token, cache):
        with SH.use_rules(rules, mesh):
            logits, cache = lm.decode_step(params, token, cache, window=window)
            return logits.argmax(-1).to(torch.int32), cache

    return BuiltStep(serve_step, (abstract_params, abstract_token,
                                  abstract_cache), mesh, rules, "decode",
                     new_cache)


def build_step(cfg: ModelConfig, mesh, shape: InputShape, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_serve_step(cfg, mesh, shape, **kw)
