"""Flat-npz checkpointing of parameter and optimizer trees, after
``repro.training.checkpoint``: one array a leaf, keyed by its path as
``repro.training.checkpoint._flatten`` joins it (``params/slots/0/attn/wq``,
``m/rest/1/rec/lam``), and the step under ``__step__``. An fp32
checkpoint written by either package restores in the other.

bf16 leaves are stored widened to fp32 (numpy has no bf16 without
``ml_dtypes``, which the port does not need). Every bf16 value is exact in
fp32, so a bf16 leaf restores bit for bit into a bf16 template, and the
JAX package's ``restore`` reads the same file.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import flatten, rebuild


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save(path: str, tree: Any, step: int = 0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(t) for k, t in flatten(tree).items()}
    flat["__step__"] = np.asarray(step)
    np.savez(path, **flat)


def restore(path: str, like: Any):
    """Restore into the structure, dtypes and devices of ``like`` (a
    template tree). Returns (tree, step)."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as data:
        step = int(data["__step__"])
        leaves = []
        for key, leaf in flatten(like).items():
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} in the "
                                 f"checkpoint, {tuple(leaf.shape)} expected")
            leaves.append(torch.from_numpy(arr).to(device=leaf.device,
                                                   dtype=leaf.dtype))
    return rebuild(like, leaves), step
