"""Logical-axis rules of the multi-device layers, after
``repro.models.sharding``, on ``torch.distributed``.

The launcher installs a rules table (logical axis -> mesh axis, or a flag
such as ``tp_bf16_ar``) and a ``DeviceMesh`` with ``use_rules``; the
layers read them with ``rule``, ``active`` and ``mesh``. Outside a rules
context every layer computes on one device, as before.

The port shards explicitly, never implicitly. The JAX package annotates
activations (``constrain``, ``logical_to_spec``) and lets GSPMD place the
arrays and insert the collectives. PyTorch has no such compiler pass, so
here each rank holds only its own block of a sharded tensor (its
parameters cut by ``repro_torch.launch.shardspecs.local_params``, its
cache rows sized by ``models.transformer.local_cache``) and a layer that
contracts over a sharded dimension calls ``all_reduce`` itself, where the JAX package's
``shard_map`` bodies call ``psum``/``pmax`` or GSPMD inserts them. So the
port has no ``constrain`` and no ``logical_to_spec``: there is nothing for
an annotation to act on.

A rule that names a mesh axis needs a process group behind it:
``use_rules`` raises when it is given no mesh or a mesh without that axis.
A rule may also name a tuple of adjacent mesh axes, such as the multi-pod
batch ("pod", "data"): the axes flattened into one, its first axis the most
significant, as ``NamedSharding(mesh, P(("pod", "data")))`` orders the
ranks. ``flatten_axes`` gives a mesh the process groups of those runs of
axes (``launch.mesh`` calls it for every mesh it makes).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import flatten, rebuild

MeshAxes = Union[None, bool, str, Tuple[str, ...]]

# logical axis -> mesh axes, and flags. Installed by the launcher.
_RULES: Optional[Dict[str, MeshAxes]] = None
_MESH = None
# rules whose value is a flag, not a mesh axis: ``tp_bf16_ar`` (the
# tensor-parallel all-reduces in bf16) and ``fsdp_gather`` (ZeRO-3: every
# weight held cut over ``fsdp_axes``, gathered a layer at a time by
# ``maybe_gather_params``)
FLAGS = ("tp_bf16_ar", "fsdp_gather")
# the families whose layers run under rules (``models.layers``, the MoE
# FFN's experts in ``models.moe_layer``, the RG-LRU's width in
# ``models.rglru``, the mLSTM's inner width and the sLSTM's gates in
# ``models.xlstm``); the audio family raises there until ROADMAP A12
SHARDED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm")
# the mesh axes FSDP cuts the weights over, flattened (``fsdp_axes``)
FSDP_AXES = ("data", "model")


def standard_rules(multi_pod: bool) -> Dict[str, MeshAxes]:
    """2D (data, model) sharding; batch additionally over the pod axis."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,           # sequence replicated by default (see kv_seq)
        "d_model": None,       # activations replicated over model on entry
        "heads": "model",
        "kv_heads": None,      # GQA: kv heads usually < model axis -> replicate
        "d_ff": "model",
        "experts": "model",
        "vocab": "model",
        "kv_batch": batch,     # kv-cache batch dim
        "kv_seq": None,        # set to "model" for seq-sharded long-KV decode
        "lru": "model",        # RG-LRU / mLSTM inner width
    }


def axis_names(value) -> Tuple[str, ...]:
    """The mesh axes a rule's value names: () for None, a name as a
    one-tuple, a tuple as it is."""
    if value is None:
        return ()
    return value if isinstance(value, tuple) else (value,)


def axis_size(m, axes) -> int:
    """The size of mesh axis ``axes`` of mesh ``m``, or of the axes of a
    tuple flattened into one (the product of their sizes)."""
    n = 1
    for a in axis_names(axes):
        n *= m.size(m.mesh_dim_names.index(a))
    return n


def axis_rank(m, axes) -> int:
    """This rank's coordinate along ``axes`` of mesh ``m``: along a tuple,
    its coordinates flattened with the first axis the most significant."""
    r = 0
    for a in axis_names(axes):
        r = r * m.size(m.mesh_dim_names.index(a)) + m.get_local_rank(a)
    return r


# the attribute of a mesh that holds its flattened axes' groups
_FLAT = "_flat_groups"


def flatten_axes(m, backend: str) -> None:
    """Give mesh ``m`` a process group (on ``backend``) along every run of
    two or more adjacent axes, in the rank order of ``axis_rank``; a run
    of size 1 needs none. Making a group is a collective over the whole
    world: every rank of the world calls this for every mesh, in the same
    order (a rank outside ``m`` is a member of none of its groups)."""
    ranks = m.mesh.cpu().numpy()
    names = tuple(m.mesh_dim_names)
    me = dist.get_rank()
    groups = {}
    for lo in range(len(names)):
        for hi in range(lo + 2, len(names) + 1):
            run = names[lo:hi]
            n = axis_size(m, run)
            groups[run] = None
            if n == 1:
                continue
            # a row for each coordinate of the other axes: the run's ranks
            rows = np.moveaxis(ranks, range(lo, hi), range(
                ranks.ndim - (hi - lo), ranks.ndim)).reshape(-1, n)
            for row in rows.tolist():
                if row != sorted(row):
                    raise ValueError(f"mesh axes {run}: ranks {row} are not "
                                     "in increasing order, the order of a "
                                     "process group")
                group = dist.new_group(row, backend=backend)
                if me in row:
                    groups[run] = group
    setattr(m, _FLAT, groups)


def fsdp_axes(m, axes: Tuple[str, ...] = FSDP_AXES) -> Tuple[str, ...]:
    """The mesh axes FSDP cuts every weight over, flattened into one:
    ``axes``, with "pod" in front where mesh ``m`` has it (as
    ``repro.launch.shardspecs.param_specs_fsdp`` takes them)."""
    return (("pod",) if "pod" in m.mesh_dim_names else ()) + tuple(axes)


def fsdp_dim(shape, n: int) -> Optional[int]:
    """The dim FSDP cuts a leaf of ``shape`` on over ``n`` ranks: the first,
    in a stable sort by descending size, that ``n`` divides; None where
    none does (the leaf is kept whole)."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0:
            return d
    return None


@contextlib.contextmanager
def use_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install ``rules`` and the ``DeviceMesh`` whose axes they name. Raises
    ``ValueError`` if a rule names an axis that ``mesh`` lacks (or there is
    no mesh): no layer may shard over an axis with no process group. The
    ``fsdp_gather`` flag names the mesh's ``fsdp_axes``."""
    global _RULES, _MESH
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    named = {k: v for k, v in rules.items() if k not in FLAGS}
    if rules.get("fsdp_gather"):
        named["fsdp_gather"] = fsdp_axes(mesh) if mesh is not None \
            else FSDP_AXES
    for key, value in named.items():
        missing = [a for a in axis_names(value) if a not in names]
        if missing:
            raise ValueError(f"rule {key!r} names mesh axes {missing}, but "
                             f"the mesh has {list(names) or 'none'}: a "
                             "sharded axis needs a process group")
        axes = axis_names(value)
        if len(axes) > 1 and axes not in getattr(mesh, _FLAT, {}):
            raise ValueError(f"rule {key!r} names mesh axes {axes}, which "
                             "are not a run of the mesh's adjacent axes "
                             "in order: no process group flattens them")
    prev, prev_mesh = _RULES, _MESH
    _RULES, _MESH = rules, mesh
    try:
        yield
    finally:
        _RULES, _MESH = prev, prev_mesh


def active() -> bool:
    return _RULES is not None


def installed() -> Optional[Dict[str, MeshAxes]]:
    """The installed rules table (None outside a rules context)."""
    return _RULES


def rule(name: str):
    """Mesh axes mapped to a logical axis (None outside a rules context)."""
    return _RULES.get(name) if _RULES is not None else None


def mesh():
    return _MESH


class Shard(NamedTuple):
    """A rank's place along a mesh axis (or a tuple of them, flattened):
    the axis' process group (None for an axis of size 1 or no axis), the
    rank's coordinate on it and the axis' size."""
    group: Optional[object]
    rank: int
    size: int


def _shard(axes) -> Shard:
    """The ``Shard`` of mesh axis ``axes`` (a name, a tuple of them or
    None) of the installed mesh."""
    m = _MESH
    names = axis_names(axes)
    size = axis_size(m, names) if names else 1
    if size == 1:
        return Shard(None, 0, 1)
    group = m.get_group(names[0]) if len(names) == 1 else \
        getattr(m, _FLAT)[names]
    return Shard(group, axis_rank(m, names), size)


def shard_of(name: str) -> Shard:
    """The (process group, rank, size) of the mesh axis that logical axis
    ``name`` maps to, or of its tuple of mesh axes flattened into one;
    (None, 0, 1) where it maps to none."""
    return _shard(rule(name))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _label(axis) -> str:
    return "+".join(axis_names(axis))


def _reduce(x: torch.Tensor, axis, op: str) -> torch.Tensor:
    """``x`` all-reduced in place over mesh axis ``axis``, counted."""
    group = _shard(axis).group
    t0 = time.perf_counter()
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        x.copy_(host)
        all_reduce.host_staged += 1
    else:
        dist.all_reduce(x, op=_OPS[op], group=group)
    _count(all_reduce, axis, x.numel() * x.element_size(),
           time.perf_counter() - t0)
    return x


class _SumReduce(torch.autograd.Function):
    """The SUM all-reduce of a partial product: the identity backward (each
    rank's partial product gets the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.mark_dirty(x)
        return _reduce(x, axis, "sum")

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Entry(torch.autograd.Function):
    """The identity forward; the gradient's SUM all-reduce backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _reduce(dy.clone(), ctx.axis, "sum"), None


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce(x: torch.Tensor, axis, op: str = "sum"):
    """All-reduce ``x`` in place over the process group of mesh axis
    ``axis``, or of a tuple of them flattened (``op`` "sum" or "max"), and
    return it; the identity on an axis of size 1 or none. On a ``gloo`` group a CUDA tensor is copied to the
    host, reduced there and copied back: gloo's own CUDA path stages through
    the host the same way, and one explicit copy takes every dtype and op
    whatever the card's gloo build accepts.

    A SUM differentiates as the all-reduce of a partial product does: its
    backward is the identity. A MAX has no backward (only the decode step's
    log-sum-exp takes one): a tensor that requires grad raises."""
    if _shard(axis).size == 1:
        return x
    if _differentiated(x):
        if op != "sum":
            raise RuntimeError(f"the {op!r} all-reduce has no backward "
                               "(run under torch.no_grad())")
        return _SumReduce.apply(x, axis)
    return _reduce(x, axis, op)


def row_block_product(z: torch.Tensor, w: torch.Tensor, axis, dtype):
    """``z @ w`` where, over mesh axis ``axis``, z is the rank's block of
    columns and w its block of rows (an RG-LRU block's or an xLSTM block's
    output projection): the partial products summed over the axis in fp32
    and cast once to ``dtype``, as GSPMD does for the JAX functions, or
    formed and summed in z's dtype under ``tp_bf16_ar``; the plain product
    on an axis of size 1 or none."""
    if _shard(axis).size == 1:
        return z @ w
    if rule("tp_bf16_ar"):
        return all_reduce(z @ w, axis)
    return all_reduce(z.float() @ w.float(), axis).to(dtype)


def entry(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` where a replicated activation enters a block whose work is cut
    over mesh axis ``axis`` (the attention's heads, the FFN's d_ff): the
    identity forward, and in the backward the SUM over the axis of the
    ranks' partial gradients, so that each rank goes on with the whole
    gradient of ``x``. Outside autograd, or on an axis of size 1, ``x``
    itself."""
    if _shard(axis).size == 1 or not _differentiated(x):
        return x
    return _Entry.apply(x, axis)


def _count(fn, axis, n: int, seconds: float) -> None:
    fn.seconds += seconds
    fn.calls += 1
    fn.bytes += n
    calls, total = fn.by_axis.get(_label(axis), (0, 0))
    fn.by_axis[_label(axis)] = (calls + 1, total + n)


def _gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``x`` of every rank of mesh axis ``axis``, concatenated along
    ``dim``, counted (the gathered output's bytes)."""
    sh = _shard(axis)
    t0 = time.perf_counter()
    staged = x.device.type == "cuda" and dist.get_backend(sh.group) == "gloo"
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(sh.size)]
    dist.all_gather(parts, src, group=sh.group)
    out = torch.cat(parts, dim=dim).to(x.device)
    all_gather.host_staged += staged
    _count(all_gather, axis, out.numel() * out.element_size(),
           time.perf_counter() - t0)
    return out


class _Gather(torch.autograd.Function):
    """Backward: each rank's own slice of the SUM of the ranks' gradients
    (a reduce-scatter, as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        whole = _reduce(dy.contiguous().clone(), ctx.axis, "sum")
        r = _shard(ctx.axis).rank
        # a copy, so that the whole gradient is freed at once
        return whole.narrow(ctx.dim, r * ctx.width, ctx.width).clone(), \
            None, None


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of mesh axis ``axis`` (or a tuple of them,
    flattened), concatenated along ``dim`` in rank order (the whole of a
    tensor a NamedSharding cut along ``dim``); staged through the host as
    ``all_reduce`` does on ``gloo``. Its backward gives each rank its slice
    of the ranks' summed gradients."""
    if _shard(axis).size == 1:
        return x
    if _differentiated(x):
        return _Gather.apply(x, axis, dim)
    return _gather(x, axis, dim)


# the all-reduces' and the all-gathers' count, bytes (an all-gather's: its
# gathered output) and host seconds (a staged call's copies included): the
# forward's, and in training also the backward's (``entry``, and
# ``all_gather``'s reduce-scatter, counted as the all-reduce it is) and
# those that remat's recompute repeats; ``host_staged``: the calls staged
# through the host; ``by_axis``: mesh axes ("pod+data" for a flattened
# pair) -> (count, bytes)
for _fn in (all_reduce, all_gather):
    _fn.seconds = 0.0    # type: ignore[attr-defined]
    _fn.calls = 0        # type: ignore[attr-defined]
    _fn.bytes = 0        # type: ignore[attr-defined]
    _fn.host_staged = 0  # type: ignore[attr-defined]
    _fn.by_axis = {}     # type: ignore[attr-defined]
del _fn


def maybe_gather_params(tree, whole: Dict[str, tuple]):
    """ZeRO-3 / FSDP, after ``repro.models.sharding.maybe_gather_params``:
    under the ``fsdp_gather`` rule, every leaf of ``tree`` that the rank
    holds a block of (its shape not ``whole[path]``, the path as
    ``params.flatten`` names it) gathered whole over ``fsdp_axes`` along
    the one dim where the two differ; ``all_gather``'s backward gives the
    rank its block of the ranks' summed gradient (a reduce-scatter). A
    caller that gathers one layer's leaves inside the layer's remat keeps
    only that layer's weights whole. Outside ``fsdp_gather``, ``tree`` as
    it is. Raises where a leaf is no block of its whole shape."""
    if not rule("fsdp_gather"):
        return tree
    axes = fsdp_axes(_MESH)
    n = axis_size(_MESH, axes)
    out = []
    for key, t in flatten(tree).items():
        want = tuple(whole[key])
        diff = [d for d, (a, b) in enumerate(zip(t.shape, want)) if a != b]
        if not diff:
            out.append(t)
            continue
        if len(diff) > 1 or t.ndim != len(want) or \
                t.shape[diff[0]] * n != want[diff[0]]:
            raise ValueError(f"{key} is {tuple(t.shape)}, no block over the "
                             f"{n} ranks of {axes} of its whole shape "
                             f"{want}: cut the parameters with "
                             "launch.shardspecs.local_params under the same "
                             "rules")
        out.append(all_gather(t, axes, diff[0]))
    return rebuild(tree, out)


def whole_shapes(specs: dict, prefix: str,
                 stacked: bool = False) -> Dict[str, tuple]:
    """``maybe_gather_params``' whole shapes for the subtree ``prefix``
    (``slots/``, ``rest/<j>/``) of a family's ``param_specs`` (path ->
    (shape, init)), keyed as ``params.flatten`` names that subtree's
    leaves (``0/attn/wq``); one layer's shapes where ``stacked``."""
    return {k[len(prefix):]: shape[1:] if stacked else shape
            for k, (shape, _) in specs.items() if k.startswith(prefix)}


def gather_layer_dim(slots, n_layers: int):
    """Under ``fsdp_gather``, the stacked ``slots`` with each leaf that is
    cut on its layer dim (whole layers a rank) gathered whole, since
    ``params.layer_of`` indexes the global layer; as they are otherwise."""
    if not rule("fsdp_gather"):
        return slots
    return maybe_gather_params(slots, {
        k: (n_layers, *t.shape[1:]) for k, t in flatten(slots).items()})


def gather_top(params, specs: dict, stacks: Tuple[str, ...] = ("slots",)):
    """Under ``fsdp_gather``, ``params`` with its leaves outside the
    layer stacks ``stacks`` (``embed``, ``unembed``, ``final_norm``)
    gathered whole, their whole shapes from ``specs`` (a family's
    ``param_specs``); as they are otherwise."""
    if not rule("fsdp_gather"):
        return params
    top = {k: v for k, v in params.items() if k not in stacks}
    return {**params, **maybe_gather_params(top, {
        k: shape for k, (shape, _) in specs.items()
        if k.split("/")[0] not in stacks})}
