"""Flat parameter layouts shared by the model families.

A family module's ``param_specs(cfg)`` states its parameters as a flat dict
keyed by the JAX pytree's paths as ``repro.training.checkpoint._flatten``
joins them (``slots/0/attn/wq``, ``rest/1/rec/lam``): name -> (shape, init),
init a normal std, "ones", "zeros", ``LRU_LAMBDA`` or ``IF_BIAS``. Leaves under
``slots/`` carry a leading layer dim G, those under the encoder-decoder's
``enc/`` and ``dec/`` one of its encoder or decoder layers.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

# init of the RG-LRU decay parameter: log(expm1(-log(u^c) / c)) with
# u ~ U(0.9, 0.999), c = 8, kept in fp32 whatever the model dtype, as
# ``repro.models.rglru._init_rec`` draws it
LRU_LAMBDA = "lru_lambda"
_LRU_C = 8.0
# init of the mLSTM's input/forget gate bias: the first half of the last dim
# (nh input gates) zeros, the second (nh forget gates) 3.0, as
# ``repro.models.xlstm._init_mlstm`` sets it
IF_BIAS = "if_bias"
# the top-level keys whose leaves carry a leading layer dim
STACKED = ("slots", "enc", "dec")


def prefixed(prefix: str, spec: Dict[str, tuple]) -> Dict[str, tuple]:
    """``spec`` with its keys under ``prefix/``."""
    return {f"{prefix}/{k}": v for k, v in spec.items()}


def leaf_dtype(init, dtype) -> torch.dtype:
    return torch.float32 if init == LRU_LAMBDA else dtype


def unflatten(flat: Dict[str, torch.Tensor]) -> dict:
    """Nest ``a/b/c`` keys into dicts; the ``slots`` and ``rest`` levels
    become tuples (``rest`` is empty when the pytree had none)."""
    tree: dict = {}
    for key, t in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    for level in ("slots", "rest"):
        if level in tree:
            tree[level] = tuple(tree[level][str(i)]
                                for i in range(len(tree[level])))
    return tree


def _draw(init, shape, generator, device):
    if init == LRU_LAMBDA:
        u = torch.rand(shape, generator=generator, device=device) * \
            (0.999 - 0.9) + 0.9
        return torch.log(torch.expm1(-torch.log(u ** _LRU_C) / _LRU_C))
    if init == IF_BIAS:
        nh = shape[-1] // 2
        return torch.cat([torch.zeros((*shape[:-1], nh), device=device),
                          torch.full((*shape[:-1], nh), 3.0, device=device)],
                         dim=-1)
    return torch.randn(shape, generator=generator, device=device) * init


def narrow(t, blk):
    """A view of ``t`` narrowed to ``blk``, (start, length) a dim."""
    for d, (start, length) in enumerate(blk):
        if length != t.shape[d]:
            t = t.narrow(d, start, length)
    return t


def init_from_specs(specs: Dict[str, tuple], generator: torch.Generator,
                    dtype, device, blocks: Optional[Dict[str, tuple]] = None
                    ) -> dict:
    """Random weights with the JAX package's distributions, drawn from
    ``generator`` (which lives on ``device``). Stacked leaves are drawn one
    layer at a time, so the fp32 draw never holds more than one layer.

    ``blocks`` maps a leaf to the block of it to keep, (start, length)
    along each dim (FSDP may cut a stacked leaf's layer dim): every leaf
    is drawn whole, so the generator runs as it does without ``blocks`` and
    the blocks of the ranks make the weights that one device would
    draw."""
    flat = {}
    for key, (shape, init) in specs.items():
        dt = leaf_dtype(init, dtype)
        blk = (blocks or {}).get(key)
        kept = tuple(n for _, n in blk) if blk else tuple(shape)
        if init == "ones":
            flat[key] = torch.ones(kept, dtype=dt, device=device)
        elif init == "zeros":
            flat[key] = torch.zeros(kept, dtype=dt, device=device)
        else:
            t = torch.empty(kept, dtype=dt, device=device)
            if key.split("/")[0] not in STACKED:
                whole = _draw(init, shape, generator, device)
                t.copy_(narrow(whole, blk) if blk else whole)
                flat[key] = t
                continue
            # every layer drawn, the block's layers kept
            lo = blk[0][0] if blk else 0
            for g in range(shape[0]):
                whole = _draw(init, shape[1:], generator, device)
                if lo <= g < lo + t.shape[0]:
                    t[g - lo].copy_(narrow(whole, blk[1:]) if blk else whole)
            flat[key] = t
    return unflatten(flat)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a tree of dicts and tuples keyed by their paths joined
    with "/", as ``repro.training.checkpoint._flatten`` joins them (a
    tuple's entries under their index); ``unflatten`` inverts it for a
    parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def map_leaves(fn, tree):
    """``tree`` with every tensor leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_leaves(fn, v) for v in tree)
    return fn(tree)


def rebuild(like, leaves) -> dict:
    """A tree of ``like``'s structure whose leaves are ``leaves``, in the
    order ``flatten(like)`` lists them."""
    it = iter(leaves)
    return map_leaves(lambda _: next(it), like)


def unbind_layers(tree):
    """A stacked subtree with each leaf split into the list of its layers
    (``unbind`` views), which ``layer_of`` indexes. The models take their
    layers from these: in training, the backward of one ``unbind`` stacks
    the layers' gradients once, where a ``select`` for each layer would add
    a zero-filled gradient of the whole stacked leaf for every layer."""
    return map_leaves(lambda t: list(t.unbind(0)), tree)


def layer_of(tree, g: int):
    """Layer ``g`` of a stacked subtree (dicts and tuples of tensors with a
    leading layer dim, or of the lists ``unbind_layers`` makes), as
    views."""
    if isinstance(tree, dict):
        return {k: layer_of(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_of(v, g) for v in tree)
    return tree[g]
