"""Parameter and cache placements of the multi-device layers, after
``repro.launch.shardspecs``.

``param_spec`` and ``sanitize_spec`` are copies of the JAX functions, with
a partition spec written as a tuple (one entry a dim: None, a mesh axis or
a tuple of them) in place of ``PartitionSpec``. ``local_params`` cuts the
leaves that the explicit layers take to this rank's block, as a
``NamedSharding`` of those specs places it; ``local_cache`` gives the shape
of this rank's KV cache (defined in ``models.transformer``, which sizes
the cache with it). ``embed`` and ``unembed`` stay whole here: their
vocabulary sharding (``("model", None)``, ``(None, "model")``) has no
explicit layer in the JAX package and comes with ROADMAP A11, as do
``batch_specs``, the rest of ``cache_specs`` and the FSDP specs.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.models.params import flatten, unflatten
from repro_torch.models.sharding import SHARDED_FAMILIES
# the shape of a rank's KV cache, kept beside the layers that size it
from repro_torch.models.transformer import local_cache  # noqa: F401

Spec = Tuple

_REPLICATED_LEAVES = {
    "ln", "ln1", "ln2", "ln_c", "w", "b", "q_norm", "k_norm", "b_in",
    "b_if", "lam", "final_norm", "enc_norm", "r", "w_r", "w_i",
    "conv_b", "b_r", "b_i", "pos", "count",
}
# the leaves the explicit layers take cut (attention's by heads, the FFN's
# by d_ff): the blocks that ``local_params`` keeps
EXPLICIT_LEAVES = {"attn": ("wq", "wk", "wv", "bq", "bk", "bv", "wo"),
                   "ffn": ("wi", "wg", "wo")}


def param_spec(cfg, path: str, ndim: int) -> Spec:
    parts = path.split("/")
    leaf = parts[-1]
    pre = (None,) * max(ndim - 2, 0)     # leading stack dims (group/layer)

    if leaf == "embed":
        return ("model", None)
    if leaf == "unembed":
        return (None, "model")
    if leaf in _REPLICATED_LEAVES:
        return (None,) * ndim
    if leaf in ("wi", "wg", "wo") and ndim >= 4 and cfg.n_experts > 0:
        # stacked MoE expert weights (G, E, D, F) / (G, E, F, D): expert-parallel
        return (*(None,) * (ndim - 3), "model", None, None)
    if leaf == "router":
        return (*pre, None, "model")
    if leaf in ("wq", "wk", "wv", "w_up", "w_gate", "w_in", "wi", "wg"):
        return (*pre, None, "model")
    if leaf in ("wo", "w_down", "w_out", "w_if"):
        return (*pre, "model", None)
    if leaf in ("bq", "bk", "bv"):
        return (*(None,) * (ndim - 1), "model")
    if leaf == "conv_w":
        return (*pre, None, "model")
    return (None,) * ndim


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh-axis assignments that do not divide the dimension size
    (e.g. a 51866-token vocab over a 16-way model axis)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for a in axes:
            prod *= _axis_size(mesh, a)
        out.append(entry if shape[d] % prod == 0 else None)
    return tuple(out)


def local_leaf(cfg, path: str, t, mesh):
    """This rank's block of leaf ``path`` (a contiguous copy): the leaf cut
    along each dim its sanitised spec shards, in rank order along the
    axis, as ``NamedSharding(mesh, spec)`` places it."""
    spec = sanitize_spec(param_spec(cfg, path, t.ndim), t.shape, mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        if isinstance(entry, tuple):
            raise NotImplementedError(f"{path}: a dim over mesh axes {entry} "
                                      "comes with ROADMAP A11")
        n = _axis_size(mesh, entry)
        blk = t.shape[d] // n
        t = t.narrow(d, mesh.get_local_rank(entry) * blk, blk)
    return t.contiguous()


def _explicit(path: str) -> bool:
    parts = path.split("/")
    return len(parts) >= 2 and parts[-1] in EXPLICIT_LEAVES.get(parts[-2], ())


def local_params(params, cfg, mesh) -> dict:
    """This rank's parameters: each leaf the explicit layers take cut to
    its block (``local_leaf``), every other leaf whole (norms, and
    ``embed``/``unembed``, whose vocabulary sharding waits for A11). Pair
    it with rules that shard ``heads`` and ``d_ff`` over "model", as
    ``standard_rules`` does: the layers cut their work by the rules and
    check the leaves' widths against them."""
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                  "under sharding rules comes with ROADMAP "
                                  "A11")
    flat = flatten(params)
    return unflatten({k: local_leaf(cfg, k, t, mesh) if _explicit(k) else t
                      for k, t in flat.items()})
