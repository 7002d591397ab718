"""Flat parameter layouts shared by the model families.

A family module's ``param_specs(cfg)`` states its parameters as a flat dict
keyed by the JAX pytree's paths as ``repro.training.checkpoint._flatten``
joins them (``slots/0/attn/wq``, ``rest/1/rec/lam``): name -> (shape, init),
init a normal std, "ones", "zeros", ``LRU_LAMBDA`` or ``IF_BIAS``. Leaves under
``slots/`` carry a leading layer dim G.
"""
from __future__ import annotations

from typing import Dict

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


def init_from_specs(specs: Dict[str, tuple], generator: torch.Generator,
                    dtype, device) -> dict:
    """Random weights with the JAX package's distributions, drawn from
    ``generator`` (which lives on ``device``). Stacked leaves are drawn one
    layer at a time, so the fp32 draw never holds more than one layer."""
    flat = {}
    for key, (shape, init) in specs.items():
        dt = leaf_dtype(init, dtype)
        if init == "ones":
            flat[key] = torch.ones(shape, dtype=dt, device=device)
        elif init == "zeros":
            flat[key] = torch.zeros(shape, dtype=dt, device=device)
        else:
            t = torch.empty(shape, dtype=dt, device=device)
            for part in (t if key.startswith("slots/") else [t]):
                part.copy_(_draw(init, part.shape, generator, device))
            flat[key] = t
    return unflatten(flat)


def layer_of(tree, g: int):
    """Layer ``g`` of a stacked subtree (dicts and tuples of tensors with a
    leading layer dim), as views."""
    if isinstance(tree, dict):
        return {k: layer_of(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(layer_of(v, g) for v in tree)
    return tree[g]
