"""Carry weights from the JAX package to the port.

``params_from_numpy`` takes the JAX parameter pytree flattened to numpy
arrays with the key paths of ``repro.training.checkpoint._flatten``
(``embed``, ``slots/0/attn/wq``, ``rest/1/rec/lam``, ...) and returns the
port's parameters, so the two packages compute the same function. It takes numpy only and imports
nothing from JAX: the caller flattens on the JAX side.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.api import family_module
from repro_torch.models.params import leaf_dtype, unflatten


def params_from_numpy(flat: Dict[str, np.ndarray], cfg, device,
                      dtype=torch.float32) -> dict:
    """Leaves in ``dtype``, except those the family keeps in fp32 (the
    RG-LRU's ``lam``)."""
    specs = family_module(cfg).param_specs(cfg)
    missing = sorted(set(specs) - set(flat))
    extra = sorted(set(flat) - set(specs))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing {missing}, unexpected {extra}")
    out = {}
    for key, (shape, init) in specs.items():
        arr = np.asarray(flat[key], dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"{key}: shape {arr.shape}, expected {shape}")
        out[key] = torch.tensor(arr, dtype=leaf_dtype(init, dtype),
                                device=device)
    return unflatten(out)
