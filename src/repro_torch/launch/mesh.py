"""Device meshes of the port, after ``repro.launch.mesh``, on
``torch.distributed``.

``make_mesh`` lays the ranks of the default process group out as a named
``DeviceMesh``, with a process group of the caller's backend on each axis:
``gloo`` on the CPU and for ranks that share one card, ``nccl`` for one rank
per card. The caller initialises ``torch.distributed`` (its rendezvous, rank
and world size) first; nothing here reads a cluster's environment.
``make_production_mesh`` is the JAX package's (16, 16) or (2, 16, 16) mesh
over a world of that many ranks; ``split_disagg_mesh`` cuts a mesh's data
axis into the prefill and decode pools.
"""
from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = ("gloo", "nccl")
# how long a collective of the launchers' world waits for its ranks
TIMEOUT_S = 600.0


def init_world(*, rank: int = 0, world: int = 1,
               rdv: Optional[str] = None) -> None:
    """Initialise ``torch.distributed``'s default process group on
    ``gloo``: ``world`` ranks meeting at ``rdv`` (an ``init_method`` URL: ``file://PATH`` or
    ``tcp://localhost:PORT``), this process rank ``rank``. A world of one
    needs no rendezvous: it meets at a file in a new temporary directory."""
    if rdv is None:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a rendezvous "
                             "(--rdv file://PATH or tcp://HOST:PORT)")
        tmp = tempfile.mkdtemp()
        atexit.register(shutil.rmtree, tmp, True)
        rdv = "file://" + os.path.join(tmp, "rdv")
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def parse_mesh(text: str) -> Tuple[int, ...]:
    """"DxM" (or "PxDxM") -> the mesh's shape."""
    try:
        shape = tuple(int(n) for n in text.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"mesh {text!r}: write DxM (data x model) or PxDxM")
    return shape


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
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl needs one CUDA device a rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(
        device.type, tuple(shape), mesh_dim_names=tuple(axes),
        backend_override={a: backend for a in axes})


def make_production_mesh(*, multi_pod: bool = False, backend: str,
                         device):
    """The production mesh: (16, 16) over ("data", "model"), or (2, 16, 16)
    over ("pod", "data", "model"), one rank a device. Raises unless the
    world has that many ranks; it never builds a smaller mesh instead."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} needs a world of {n} "
                         f"ranks, one a device; this one has {world}: pass "
                         "another --mesh for a smaller world")
    return make_mesh(shape, axes, backend=backend, device=device)


def split_disagg_mesh(mesh, n_prefill: int):
    """Split the data axis of a mesh into prefill/decode sub-meshes: the
    prefill pool the data coordinates [0, n_prefill), the decode pool
    [n_prefill, data), each a ``DeviceMesh`` with the mesh's axis names
    and its ranks in the order ``np.take`` of the JAX function gives them
    (the paper's prefill/decode GPU pools as a partition of the data
    axis). Every rank of the mesh must call it, with the same arguments:
    making a sub-mesh's process groups is a collective over the whole
    world, so each rank builds both pools, in the same order. A rank's own
    pool is the one whose ``get_coordinate()`` is not None."""
    ranks = mesh.mesh.cpu().numpy()         # (data, model) or (pod, data, model)
    names = tuple(mesh.mesh_dim_names)
    axis = names.index("data")
    assert 0 < n_prefill < ranks.shape[axis]
    backend = dist.get_backend(mesh.get_group(names[0]))
    override = tuple((backend, None) for _ in names)

    def take(sl):
        return DeviceMesh(mesh.device_type,
                          torch.tensor(np.take(ranks, sl, axis=axis)),
                          mesh_dim_names=names, backend_override=override)
    pre = take(range(n_prefill))
    dec = take(range(n_prefill, ranks.shape[axis]))
    return pre, dec


def add_mesh_args(ap) -> None:
    """A launcher's mesh options: the mesh, and this process's place in the
    world (one rank a process)."""
    ap.add_argument("--mesh", default="production",
                    help="'production' (16x16, a world of 256 ranks) or DxM "
                         "(data x model), e.g. 1x1 for one process")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rdv", default=None,
                    help="rendezvous URL (file://PATH or tcp://HOST:PORT); "
                         "a world of one needs none")


def launcher_mesh(args, device):
    """The mesh of a launcher's options (``add_mesh_args``) over a ``gloo``
    world it initialises; ``device`` is this rank's device."""
    init_world(rank=args.rank, world=args.world, rdv=args.rdv)
    try:
        if args.mesh == "production":
            return make_production_mesh(backend="gloo", device=device)
        shape = parse_mesh(args.mesh)
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        return make_mesh(shape, axes, backend="gloo", device=device)
    except BaseException:
        dist.destroy_process_group()
        raise


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
