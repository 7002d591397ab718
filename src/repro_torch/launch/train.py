"""Training launcher of the port:

    python -m repro_torch.launch.train --arch <id> --smoke [--device cpu]
    python -m repro_torch.launch.train --arch <id> [--mesh production | DxM]
        [--batch N] [--steps 100] [--device cpu] [--rank R --world W --rdv URL]

--smoke trains the reduced config end to end from the synthetic pipeline.

Without --smoke it builds the production train step of ``train_4k`` on a
mesh (``launch.steps.build_train_step``: bf16 parameters and AdamW
moments, remat), draws this rank's block of the weights from a seeded
generator and runs ``--steps`` steps on ``TokenStream`` batches, each
rank on its rows, printing each step's loss as the JAX launcher does.
``--mesh`` as in ``launch.serve``: ``production`` needs a world of 256
processes, ``1x1`` is one. ``--batch`` cuts train_4k's global batch of
256 sequences.

Both run on the GPU unless ``--device`` names another, and raise without
one; they never fall back to the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.analysis.flops import step_model_flops
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import add_mesh_args, launcher_mesh
from repro_torch.launch.serve import SEED, cut_shape, rank_device
from repro_torch.launch.steps import (build_train_step, init_params,
                                      materialize, train_batch_axes)
from repro_torch.training.data import TokenStream


def local_batches(cfg, built, shape, seed: int, device):
    """This rank's rows of ``TokenStream``'s global batches, one a step."""
    data = TokenStream(cfg, seed=seed)
    baxes = train_batch_axes(shape, built.mesh, built.rules)
    while True:
        batch = {k: torch.from_numpy(v) for k, v in
                 data.batch(shape.global_batch, shape.seq_len).items()}
        yield {k: t.to(device) for k, t in
               SS.local_batch(batch, baxes, built.mesh).items()}


def train_production(args) -> list:
    """The production path (without --smoke); returns each step's metrics
    (loss, grad norm, lr, seconds) as floats."""
    device = rank_device(args.device, args.rank)
    mesh = launcher_mesh(args, device)
    try:
        return _train(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, device, mesh) -> list:
    cfg = get_config(args.arch)
    full = INPUT_SHAPES["train_4k"]
    shape = cut_shape(full, args.batch)
    built = build_train_step(cfg, mesh, shape)
    params = init_params(cfg, built, torch.Generator(device).manual_seed(
        SEED), device)
    opt = materialize(built.args[1], device)      # AdamW's zeroed state
    if args.rank == 0:
        print(f"[train] {cfg.name} {shape.name} (global batch "
              f"{shape.global_batch}, cut from {full.global_batch}) on mesh "
              f"{tuple(mesh.mesh.shape)}, {device}; "
              f"flops={step_model_flops(cfg, shape):.3g} a step", flush=True)
    history = []
    batches = local_batches(cfg, built, shape, SEED, device)
    for step in range(args.steps):
        t0 = time.perf_counter()
        params, opt, metrics = built.fn(params, opt, next(batches))
        m = {k: float(v) for k, v in metrics.items()}   # waits for the step
        m["step_s"] = time.perf_counter() - t0
        history.append(m)
        if args.rank == 0:
            print(f"step {step} loss {m['loss']:.4f}", flush=True)
    return history


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="--smoke: the batch (8); else cut train_4k's "
                         "global batch to this")
    ap.add_argument("--seq", type=int, default=128, help="--smoke only")
    ap.add_argument("--ckpt", default=None, help="--smoke only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.smoke:
        train_production(args)
        return

    from repro_torch.training.train_loop import train
    cfg = get_config(args.arch).reduced()
    params, hist = train(cfg, steps=args.steps, batch_size=args.batch or 8,
                         seq_len=args.seq, ckpt_path=args.ckpt,
                         device=args.device)
    print(f"[train] {cfg.name}: loss {hist[0]:.3f} -> {hist[-1]:.3f}")


if __name__ == "__main__":
    main()
