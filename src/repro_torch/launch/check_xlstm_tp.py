"""xLSTM-350M's tensor-parallel train step against the unsharded one at its
published widths, on the CPU:
``python -m repro_torch.launch.check_xlstm_tp [--layers 8] [--seq 64] [--fp64]``.

Two ``gloo`` processes on a (1, 2) mesh run one ``build_train_step`` step
under ``standard_rules`` (the mLSTM's heads and the sLSTM's gate columns
over "model"), then one process the same step unsharded, on the same
seeded weights and batch (B=2). It prints each run's loss and grad norm
and, for every parameter leaf, max |d| / max |ref| of AdamW's m after the
step (the step's gradient times 1 - beta1) on each rank's block against
the unsharded leaf, the worst first. ``--fp64`` makes the models' fp32
casts fp64, as ``tests/test_torch_xlstm_fullwidth.py`` does: what is left
is the sharding's own error, not the rounding that this seeded model
amplifies from layer to layer. Exits non-zero where a leaf passes
``--tol`` (by default 1e-9 with ``--fp64``, 1e-2 without).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class _Dtypes:
    """A module's stand-in that forwards every attribute but ``float32``."""

    def __init__(self, module, float32):
        self._module, self.float32 = module, float32

    def __getattr__(self, name):
        return getattr(self._module, name)


def _run(rank: int, world: int, args, rdv: str, out: str) -> None:
    """One rank's step; writes its loss, grad norm, m and blocks to
    ``out``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import shardspecs as SS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_step, init_params, materialize
    from repro_torch.models import xlstm
    from repro_torch.models.params import flatten
    from repro_torch.training.optimizer import AdamWConfig
    dtype = torch.float64 if args.fp64 else torch.float32
    if args.fp64:
        xlstm.torch = _Dtypes(torch, torch.float64)
        torch.Tensor.float = torch.Tensor.double
    torch.set_num_threads(args.threads)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=1800))
    mesh = make_mesh((1, world), ("data", "model"), backend="gloo",
                     device="cpu")
    cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=args.layers)
    built = build_step(cfg, mesh, InputShape("check", args.seq, 2, "train"),
                       dtype=dtype, opt_cfg=AdamWConfig(
                           state_dtype=dtype, warmup_steps=1))
    params = init_params(cfg, built, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, args.seq + 1)).astype(np.int32))
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    _, opt, metrics = built.fn(params, materialize(built.args[1], "cpu"),
                               batch)
    blocks = SS.param_blocks(cfg, mesh, built.rules)
    np.savez(out, loss=float(metrics["loss"]),
             grad_norm=float(metrics["grad_norm"]),
             **{"m/" + k: t.numpy() for k, t in flatten(opt["m"]).items()},
             **{"block/" + k: np.asarray(b[0]) for k, b in blocks.items()})
    dist.destroy_process_group()


def _spawn(world: int, args, tmp: Path) -> list:
    rdv = tmp / f"rdv{world}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(r, world, args, str(rdv),
                                            str(tmp / f"{world}_{r}.npz")))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    if any(p.exitcode for p in procs):
        raise SystemExit(f"a rank of the world of {world} failed")
    return [dict(np.load(tmp / f"{world}_{r}.npz")) for r in range(world)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fp64", action="store_true")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    tol = args.tol or (1e-9 if args.fp64 else 1e-2)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = _spawn(2, args, Path(tmp))
        ref = _spawn(1, args, Path(tmp))[0]
    print(f"[check_xlstm_tp] xLSTM-350M at {args.layers} layers, B=2 "
          f"S={args.seq}, {'fp64' if args.fp64 else 'fp32'}: loss "
          f"{ref['loss']:.9g} unsharded, {ranks[0]['loss']:.9g} sharded; "
          f"grad norm {ref['grad_norm']:.9g}, {ranks[0]['grad_norm']:.9g}")
    errs = []
    for r, res in enumerate(ranks):
        for key in [k for k in res if k.startswith("m/")]:
            want = ref[key]
            blk = res.get("block/" + key[2:])
            if blk is not None:
                want = want[tuple(slice(int(lo), int(lo) + int(n))
                                  for lo, n in blk)]
            errs.append((float(np.abs(res[key] - want).max()) /
                         max(float(np.abs(want).max()), 1e-300), r, key[2:]))
    errs.sort(reverse=True)
    for err, r, key in errs[:8]:
        print(f"[check_xlstm_tp] rank {r} {key}: AdamW m {err:.3g} of max")
    print(f"[check_xlstm_tp] worst {errs[0][0]:.3g}, median "
          f"{float(np.median([e for e, _, _ in errs])):.3g} of max over "
          f"{len(errs)} blocks (tol {tol:g})")
    return 0 if errs[0][0] <= tol else 1


if __name__ == "__main__":
    sys.exit(main())
