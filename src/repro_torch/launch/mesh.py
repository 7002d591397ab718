"""Device meshes of the port, after ``repro.launch.mesh``, on
``torch.distributed``.

``make_mesh`` lays the ranks of the default process group out as a named
``DeviceMesh``, with a process group of the caller's backend on each axis:
``gloo`` on the CPU and for ranks that share one card, ``nccl`` for one rank
per card. The caller initialises ``torch.distributed`` (its rendezvous, rank
and world size) first; nothing here reads a cluster's environment.
``make_production_mesh`` and ``split_disagg_mesh`` come with ROADMAP A11.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

BACKENDS = ("gloo", "nccl")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, backend: str,
              device):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group's ranks in order (the last axis varies fastest, as
    ``jax.make_mesh`` lays out devices), each axis' group on ``backend``.
    ``device`` is the device this rank computes on: a CUDA device becomes
    the current one (``nccl`` wants one card a rank; ``gloo`` ranks may
    share one, their CUDA tensors staged through the host by
    ``repro_torch.models.sharding.all_reduce``). Raises unless the default
    process group exists, runs ``backend`` and has as many ranks as the
    mesh."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group (rendezvous, rank, world "
                           "size) before make_mesh")
    if dist.get_backend() != backend:
        raise ValueError(f"the default process group runs "
                         f"{dist.get_backend()!r}, not {backend!r}")
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} holds {n} ranks; the world "
                         f"has {dist.get_world_size()}")
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs one CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(
        device.type, tuple(shape), mesh_dim_names=tuple(axes),
        backend_override={a: backend for a in axes})


def make_smoke_mesh(*, backend: str = "gloo", device="cpu"):
    """1-device mesh with the production axis names (CPU tests)."""
    return make_mesh((1, 1), ("data", "model"), backend=backend,
                     device=device)


def batch_axes_for(global_batch: int, mesh) -> Tuple[str, ...]:
    """Largest prefix of the batch-capable mesh axes that divides the batch.

    bs=1 (long_500k) -> () i.e. replicated batch; bs=128 on (pod,data) -> both.
    """
    names = mesh.mesh_dim_names
    cand = [a for a in ("pod", "data") if a in names]
    axes = []
    prod = 1
    for a in cand:
        n = mesh.size(names.index(a))
        if global_batch % (prod * n) == 0:
            axes.append(a)
            prod *= n
    return tuple(axes)
