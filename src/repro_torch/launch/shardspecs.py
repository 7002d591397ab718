"""Parameter, batch and cache placements of the multi-device layers, after
``repro.launch.shardspecs``.

``param_spec``, ``sanitize_spec``, ``param_specs``, ``batch_specs`` and
``cache_specs`` are copies of the JAX functions, with a partition spec
written as a tuple (one entry a dim: None, a mesh axis or a tuple of them)
in place of ``PartitionSpec``. ``param_blocks`` names this rank's block of
each leaf that the explicit layers take cut, as a ``NamedSharding`` of those
specs places it, and ``local_params`` cuts the leaves to those blocks;
``local_batch`` takes this rank's rows of a batch as ``batch_specs``
places them; ``local_cache`` gives the shape of this
rank's KV cache (defined in ``models.transformer``, which sizes the cache
with it). Under rules whose ``vocab`` names "model", ``embed`` and
``unembed`` are cut as their specs place them (``("model", None)``,
``(None, "model")``): a rank holds its block of the vocabulary's rows or
columns, which ``models.vocab`` looks up and multiplies. A spec
entry may name a tuple of mesh axes, flattened (the multi-pod batch over
("pod", "data")). ``param_specs_fsdp`` is a copy of the JAX function: under
rules with ``fsdp_gather`` (the FSDP train step) every leaf is cut over the
flattened ``sharding.fsdp_axes`` on the dim ``sharding.fsdp_dim`` picks,
and ``param_blocks`` lists every leaf so cut.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.models import xlstm
from repro_torch.models.api import family_module
from repro_torch.models.rglru import check_lru_axis
from repro_torch.models.params import flatten, map_leaves, narrow, unflatten
from repro_torch.models import sharding as SH
# the shape of a rank's KV cache, kept beside the layers that size it
from repro_torch.models.transformer import local_cache  # noqa: F401

Spec = Tuple

_REPLICATED_LEAVES = {
    "ln", "ln1", "ln2", "ln_c", "w", "b", "q_norm", "k_norm", "b_in",
    "b_if", "lam", "final_norm", "enc_norm", "r", "w_r", "w_i",
    "conv_b", "b_r", "b_i", "pos", "count",
}
# the leaves the explicit layers take cut (attention's by heads, the FFN's
# by d_ff, an MoE FFN's experts and router columns by experts, its shared
# expert by d_ff, an RG-LRU block's by lru), keyed by the parent's name: the
# blocks that ``local_params`` keeps. An xLSTM slot's parent is its index,
# so its leaves are chosen by the slot's kind (``xlstm.cut_leaves``)
EXPLICIT_LEAVES = {"attn": ("wq", "wk", "wv", "bq", "bk", "bv", "wo"),
                   "ffn": ("wi", "wg", "wo", "router"),
                   "shared": ("wi", "wg", "wo"),
                   "rec": ("w_gate", "w_in", "conv_w", "w_out")}
# the leaves cut over the vocabulary, kept cut where the rules' vocab is
VOCAB_LEAVES = ("embed", "unembed")


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


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh-axis assignments that do not divide the dimension size
    (e.g. a 51866-token vocab over a 16-way model axis)."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        out.append(entry if shape[d] % SH.axis_size(mesh, entry) == 0
                   else None)
    return tuple(out)


def param_specs(cfg, params, mesh=None):
    """The spec tree matching a parameter tree (its leaves' shapes are all
    it reads), sanitised against ``mesh`` where one is given."""
    def one(path, leaf):
        spec = param_spec(cfg, path, leaf.ndim)
        return sanitize_spec(spec, leaf.shape, mesh) if mesh is not None \
            else spec
    return unflatten({k: one(k, t) for k, t in flatten(params).items()})


def fsdp_spec(shape, mesh, axes=SH.FSDP_AXES) -> Spec:
    """ZeRO-3 storage sharding of a leaf of ``shape``: cut over the
    flattened ``axes`` ("pod" in front where the mesh has it) on its
    largest dim that their size divides, else kept whole
    (``sharding.fsdp_dim``)."""
    axes = SH.fsdp_axes(mesh, axes)
    d = SH.fsdp_dim(shape, SH.axis_size(mesh, axes))
    return tuple(axes if i == d else None for i in range(len(shape)))


def param_specs_fsdp(params, mesh, axes=SH.FSDP_AXES):
    """The ``fsdp_spec`` tree matching a parameter tree (its leaves' shapes
    are all it reads)."""
    return unflatten({k: fsdp_spec(t.shape, mesh, axes)
                      for k, t in flatten(params).items()})


def block(spec: Spec, shape, mesh) -> Tuple[Tuple[int, int], ...]:
    """(start, length) along each dim of this rank's block of a tensor of
    ``shape`` placed by ``spec``, in rank order along each axis (along a
    tuple of axes, flattened, the first the most significant), as
    ``NamedSharding(mesh, spec)`` places it."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            out.append((0, shape[d]))
            continue
        blk = shape[d] // SH.axis_size(mesh, entry)
        out.append((SH.axis_rank(mesh, entry) * blk, blk))
    return tuple(out)


def cut(t, blk):
    """``t`` narrowed to ``blk`` ((start, length) a dim), contiguous."""
    return narrow(t, blk).contiguous()


def leaf_block(cfg, path: str, shape, mesh, fsdp: bool = False):
    """(this rank's block of leaf ``path``, (start, length) a dim; the mesh
    axes it is cut over): the leaf cut along each dim its sanitised spec
    shards (its ``fsdp_spec`` where ``fsdp``), in rank order
    along the axis, as ``NamedSharding(mesh, spec)`` places it."""
    spec = fsdp_spec(shape, mesh) if fsdp else \
        sanitize_spec(param_spec(cfg, path, len(shape)), shape, mesh)
    blk = block(spec, shape, mesh)
    axes = tuple(e for e, (_, n), full in zip(spec, blk, shape)
                 if n != full)
    return blk, axes


def local_leaf(cfg, path: str, t, mesh):
    """This rank's block of leaf ``path`` (a contiguous copy)."""
    return cut(t, leaf_block(cfg, path, t.shape, mesh)[0])


def explicit(path: str) -> bool:
    """Whether the explicit layers take leaf ``path`` cut (``EXPLICIT_LEAVES``)."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[-1] in EXPLICIT_LEAVES.get(parts[-2], ())


def cuts(rules: dict, experts: bool = False, lru: bool = False) -> tuple:
    """(whether the rank holds its blocks of the explicit layers' leaves,
    of ``embed`` and ``unembed``, of every leaf by its FSDP spec) under
    ``rules``: the layers' blocks where heads and d_ff map to "model" (and
    where ``experts``, a model with MoE FFNs, the experts too; where
    ``lru``, a model with RG-LRU blocks, the lru width too), none where
    they all map to nothing; the vocabulary's where vocab maps to "model";
    every leaf's under ``fsdp_gather``, which takes heads, d_ff, vocab
    (and the experts, the lru width) over nothing. Raises for another cut,
    which the parameter specs do not place. ``lru``: a model with RG-LRU
    blocks or xLSTM blocks (the mLSTM's inner width, the sLSTM's gates)."""
    heads, d_ff, vocab = (rules.get(k) for k in ("heads", "d_ff", "vocab"))
    names = ("heads", "d_ff") + (("experts",) if experts else ()) + \
        (("lru",) if lru else ())
    layer = tuple(rules.get(k) for k in names)
    if rules.get("fsdp_gather"):
        if set(layer) | {vocab} != {None}:
            raise ValueError(f"fsdp_gather with {', '.join(names)} over "
                             f"{layer} and vocab over {vocab!r}: the FSDP "
                             "step cuts every weight over the flattened "
                             "mesh and no layer by its width")
        return False, False, True
    if set(layer) not in ({None}, {"model"}):
        raise NotImplementedError(f"{', '.join(names)} over {layer}: other "
                                  "cuts of the parameters come with ROADMAP "
                                  "A12")
    if vocab not in (None, "model"):
        raise NotImplementedError(f"vocab over {vocab!r}: other cuts of the "
                                  "parameters come with ROADMAP A12")
    return heads is not None, vocab is not None, False


def param_blocks(cfg, mesh, rules: Optional[dict] = None) -> dict:
    """leaf path -> ``leaf_block`` of it, for every leaf of ``cfg`` that the
    rank holds cut under ``rules`` (``cuts``) and the mesh cuts; the leaves
    not listed stay whole (norms; a vocabulary the axis does not divide,
    as ``sanitize_spec`` says; under FSDP a leaf no dim of which the
    flattened axes divide). ``rules``: by default the ones installed by
    ``models.sharding.use_rules``, else ``standard_rules`` of the mesh.
    The layers cut their work by the same rules and check the leaves'
    widths against them. Raises where an ``lru`` axis would cut the
    RG-LRU's gate blocks (``rglru.check_lru_axis``) or an mLSTM head
    (``xlstm.check_lru_axis``)."""
    if cfg.family not in SH.SHARDED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family "
                                  "under sharding rules comes with ROADMAP "
                                  "A12")
    if rules is None:
        rules = SH.installed() if SH.active() else \
            SH.standard_rules("pod" in mesh.mesh_dim_names)
    hybrid, ssm = cfg.family == "hybrid", cfg.family == "ssm"
    layers, vocab, fsdp = cuts(rules, cfg.n_experts > 0, hybrid or ssm)
    if layers and hybrid:
        check_lru_axis(SH.axis_size(mesh, rules["lru"]))
    if layers and ssm:
        xlstm.check_lru_axis(cfg, SH.axis_size(mesh, rules["lru"]))
    cut_by_kind = xlstm.cut_leaves(cfg) if ssm else frozenset()
    out = {}
    for key, (shape, _) in family_module(cfg).param_specs(cfg).items():
        in_layer = key in cut_by_kind if ssm else explicit(key)
        if fsdp or (layers and in_layer) or \
                (vocab and key in VOCAB_LEAVES):
            blk, axes = leaf_block(cfg, key, shape, mesh, fsdp)
            if axes:
                out[key] = (blk, axes)
    return out


def local_params(params, cfg, mesh, rules: Optional[dict] = None) -> dict:
    """This rank's parameters under ``rules`` (as ``param_blocks`` reads
    them): each leaf of ``param_blocks`` cut to its block, every other
    leaf whole."""
    blocks = param_blocks(cfg, mesh, rules)
    return unflatten({k: cut(t, blocks[k][0]) if k in blocks else t
                      for k, t in flatten(params).items()})


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg, abstract_batch, batch_axes: Tuple[str, ...]):
    b = batch_axes if batch_axes else None
    specs = {}
    for k, v in abstract_batch.items():
        specs[k] = (b, *(None,) * (v.ndim - 1))
    return specs


def local_batch(batch: dict, batch_axes: Tuple[str, ...], mesh) -> dict:
    """This rank's rows of a global batch, as ``batch_specs`` places them
    (the whole batch where ``batch_axes`` is empty)."""
    return {k: cut(t, block((batch_axes or None,) + (None,) * (t.ndim - 1),
                            t.shape, mesh))
            for k, t in batch.items()}


# ---------------------------------------------------------------------------
# cache specs (mirror each family's init_cache structure)
# ---------------------------------------------------------------------------

def cache_specs(cfg, abstract_cache, batch_axes: Tuple[str, ...],
                kv_seq_axis: Optional[str] = None):
    """kv_seq_axis: mesh axis to shard the KV sequence dim over (long-KV
    decode optimization); None = unsharded."""
    b = batch_axes if batch_axes else None

    def kv5(_):   # (G/L, B, S, K, H)
        return (None, b, kv_seq_axis, None, None)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return {
            "slots": tuple({"k": kv5(None), "v": kv5(None)}
                           for _ in abstract_cache["slots"]),
            "pos": (),
        }
    if fam == "audio":
        return {"k": kv5(None), "v": kv5(None),
                "ck": (None, b, None, None, None),
                "cv": (None, b, None, None, None), "pos": ()}
    if fam == "ssm":
        # slots: mLSTM (C,n,m) or sLSTM (c,n,m,h); every leaf is (G,B,...)
        def leaf_spec(a):
            return (None, b, *(None,) * (a.ndim - 2))
        return {
            "slots": map_leaves(leaf_spec, abstract_cache["slots"]),
            "pos": (),
        }
    if fam == "hybrid":
        def slot_spec(slot, stacked: bool):
            n = 1 if stacked else 0
            if isinstance(slot, dict):      # attention: k/v (G?,B,S,K,H)
                return {"k": (*(None,) * n, b, None, None, None),
                        "v": (*(None,) * n, b, None, None, None)}
            # rec: (conv (G?,B,cw-1,W), h (G?,B,W))
            return ((*(None,) * n, b, None, "model"),
                    (*(None,) * n, b, "model"))
        return {
            "slots": tuple(slot_spec(s, True) for s in abstract_cache["slots"]),
            "rest": tuple(slot_spec(s, False) for s in abstract_cache["rest"]),
            "pos": (),
        }
    raise ValueError(fam)
