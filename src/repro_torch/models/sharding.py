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


def axis_size(m, axes) -> int:
    """The size of mesh axis ``axes`` of mesh ``m``, or of the axes of a
    tuple flattened into one (the product of their sizes)."""
    n = 1
    for a in _axis_names(axes):
        n *= m.size(m.mesh_dim_names.index(a))
    return n


def axis_rank(m, axes) -> int:
    """This rank's coordinate along ``axes`` of mesh ``m``: along a tuple,
    its coordinates flattened with the first axis the most significant."""
    r = 0
    for a in _axis_names(axes):
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
        axes = _axis_names(value)
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
    names = _axis_names(axes)
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
    return "+".join(_axis_names(axis))


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
    all_reduce.seconds += time.perf_counter() - t0
    n = x.numel() * x.element_size()
    all_reduce.calls += 1
    all_reduce.bytes += n
    calls, total = all_reduce.by_axis.get(_label(axis), (0, 0))
    all_reduce.by_axis[_label(axis)] = (calls + 1, total + n)
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


# the all-reduces' count, bytes and host seconds (a staged call's copies
# included): the forward's, and in training also the backward's (``entry``,
# ``all_gather``'s reduce-scatter) and those that remat's recompute repeats;
# ``by_axis``: mesh axes ("pod+data" for a flattened pair) -> (count, bytes)
all_reduce.seconds = 0.0    # type: ignore[attr-defined]
all_reduce.calls = 0        # type: ignore[attr-defined]
all_reduce.bytes = 0        # type: ignore[attr-defined]
all_reduce.host_staged = 0  # type: ignore[attr-defined]
all_reduce.by_axis = {}     # type: ignore[attr-defined]


def _gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    sh = _shard(axis)
    staged = x.device.type == "cuda" and dist.get_backend(sh.group) == "gloo"
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(sh.size)]
    dist.all_gather(parts, src, group=sh.group)
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
        r = _shard(ctx.axis).rank
        return whole.narrow(ctx.dim, r * ctx.width, ctx.width), None, None


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
