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
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

MeshAxes = Union[None, bool, str, Tuple[str, ...]]

# logical axis -> mesh axes, and flags. Installed by the launcher.
_RULES: Optional[Dict[str, MeshAxes]] = None
_MESH = None
# rules whose value is a flag, not a mesh axis
FLAGS = ("tp_bf16_ar", "fsdp_gather")
# the families whose layers run under rules (``models.layers``); the others
# raise there until ROADMAP A12
SHARDED_FAMILIES = ("dense", "vlm")


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


def _axis_names(value) -> Tuple[str, ...]:
    if value is None:
        return ()
    return value if isinstance(value, tuple) else (value,)


@contextlib.contextmanager
def use_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install ``rules`` and the ``DeviceMesh`` whose axes they name. Raises
    ``ValueError`` if a rule names an axis that ``mesh`` lacks (or there is
    no mesh): no layer may shard over an axis with no process group."""
    global _RULES, _MESH
    if rules.get("fsdp_gather"):
        raise NotImplementedError("fsdp_gather (ZeRO-3's per-layer gather) "
                                  "comes with ROADMAP A12")
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    for key, value in rules.items():
        if key in FLAGS:
            continue
        missing = [a for a in _axis_names(value) if a not in names]
        if missing:
            raise ValueError(f"rule {key!r} names mesh axes {missing}, but "
                             f"the mesh has {list(names) or 'none'}: a "
                             "sharded axis needs a process group")
    prev, prev_mesh = _RULES, _MESH
    _RULES, _MESH = rules, mesh
    try:
        yield
    finally:
        _RULES, _MESH = prev, prev_mesh


def active() -> bool:
    return _RULES is not None


def rule(name: str):
    """Mesh axes mapped to a logical axis (None outside a rules context)."""
    return _RULES.get(name) if _RULES is not None else None


def mesh():
    return _MESH


class Shard(NamedTuple):
    """A rank's place along one mesh axis: the axis' process group (None
    for an axis of size 1 or no axis), the rank's coordinate on it and the
    axis' size."""
    group: Optional[object]
    rank: int
    size: int


def shard_of(name: str) -> Shard:
    """The (process group, rank, size) of the mesh axis that logical axis
    ``name`` maps to; (None, 0, 1) where it maps to none. A rule over more
    than one mesh axis (the multi-pod batch) has no single group: A12."""
    axes = _axis_names(rule(name))
    if not axes:
        return Shard(None, 0, 1)
    if len(axes) > 1:
        raise NotImplementedError(f"rule {name!r} spans mesh axes {axes}: "
                                  "flattened axes come with ROADMAP A12")
    m, axis = _MESH, axes[0]
    size = m.size(m.mesh_dim_names.index(axis))
    if size == 1:
        return Shard(None, 0, 1)
    return Shard(m.get_group(axis), m.get_local_rank(axis), size)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _axis_size(axis: str) -> int:
    m = _MESH
    return m.size(m.mesh_dim_names.index(axis))


def _reduce(x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
    """``x`` all-reduced in place over mesh axis ``axis``, counted."""
    group = _MESH.get_group(axis)
    t0 = time.perf_counter()
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = x.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        x.copy_(host)
        all_reduce.host_staged += 1
    else:
        dist.all_reduce(x, op=_OPS[op], group=group)
    all_reduce.seconds += time.perf_counter() - t0
    all_reduce.calls += 1
    all_reduce.bytes += x.numel() * x.element_size()
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


def all_reduce(x: torch.Tensor, axis: Optional[str], op: str = "sum"):
    """All-reduce ``x`` in place over the process group of mesh axis
    ``axis`` (``op`` "sum" or "max") and return it; the identity on an axis
    of size 1 or none. On a ``gloo`` group a CUDA tensor is copied to the
    host, reduced there and copied back: gloo's own CUDA path stages through
    the host the same way, and one explicit copy takes every dtype and op
    whatever the card's gloo build accepts.

    A SUM differentiates as the all-reduce of a partial product does: its
    backward is the identity. A MAX has no backward (only the decode step's
    log-sum-exp takes one): a tensor that requires grad raises."""
    if axis is None or _axis_size(axis) == 1:
        return x
    if _differentiated(x):
        if op != "sum":
            raise RuntimeError(f"the {op!r} all-reduce has no backward "
                               "(run under torch.no_grad())")
        return _SumReduce.apply(x, axis)
    return _reduce(x, axis, op)


def entry(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """``x`` where a replicated activation enters a block whose work is cut
    over mesh axis ``axis`` (the attention's heads, the FFN's d_ff): the
    identity forward, and in the backward the SUM over the axis of the
    ranks' partial gradients, so that each rank goes on with the whole
    gradient of ``x``. Outside autograd, or on an axis of size 1, ``x``
    itself."""
    if axis is None or _axis_size(axis) == 1 or not _differentiated(x):
        return x
    return _Entry.apply(x, axis)


# the all-reduces' count, bytes and host seconds (a staged call's copies
# included): the forward's, and in training also the backward's (``entry``,
# ``all_gather``'s reduce-scatter) and those that remat's recompute repeats
all_reduce.seconds = 0.0    # type: ignore[attr-defined]
all_reduce.calls = 0        # type: ignore[attr-defined]
all_reduce.bytes = 0        # type: ignore[attr-defined]
all_reduce.host_staged = 0  # type: ignore[attr-defined]


def _gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    n = _axis_size(axis)
    group = _MESH.get_group(axis)
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


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
        r = _MESH.get_local_rank(ctx.axis)
        return whole.narrow(ctx.dim, r * ctx.width, ctx.width), None, None


def all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of mesh axis ``axis``, concatenated along ``dim`` in
    rank order (the whole of a tensor a NamedSharding cut along ``dim``);
    staged through the host as ``all_reduce`` does on ``gloo``. Its
    backward gives each rank its slice of the ranks' summed gradients."""
    if _axis_size(axis) == 1:
        return x
    if _differentiated(x):
        return _Gather.apply(x, axis, dim)
    return _gather(x, axis, dim)
