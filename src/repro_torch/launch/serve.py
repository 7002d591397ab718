"""Serving launcher of the port:

    python -m repro_torch.launch.serve --arch <id> --smoke [--device cpu]
    python -m repro_torch.launch.serve --arch <id> [--mesh production | DxM]
        [--shape decode_32k] [--batch N] [--steps 16] [--device cpu]
        [--rank R --world W --rdv URL]

--smoke serves a reduced model through the real-compute disaggregated
engine (prefill worker -> ring buffer -> decode worker) with the RAPID
controller enabled.

Without --smoke it builds the production step of ``--shape`` on a mesh
(``launch.steps.build_step``), draws this rank's block of the weights from
a seeded generator and runs the step ``--steps`` times, printing the
step's wall, tokens/s and its analytic FLOPs (``step_model_flops``); the
JAX launcher compiles the step and prints its FLOPs, and running it is the
port's counterpart. ``--mesh production`` is the (16, 16) mesh, which
needs a world of 256 processes (``--world 256``, one ``--rank`` each, and
``--rdv``); ``--mesh DxM`` any other, ``1x1`` for one process. ``--batch``
cuts the shape's global batch (decode_32k's 128 sequences of 32768 rows
need 550 GB of KV cache at Llama-3.1-8B's width). A decode shape decodes
from position seq_len - steps over a cache of seeded random keys and
values, so its last step reads every row; a prefill shape prefills a
seeded prompt of seq_len tokens each time.

Both run on the GPU unless ``--device`` names another, and raise without
one; they never fall back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.flops import step_model_flops
from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import shardspecs as SS
from repro_torch.launch.mesh import add_mesh_args, batch_axes_for, launcher_mesh
from repro_torch.launch.steps import (BuiltStep, build_step, init_params,
                                      materialize)
from repro_torch.models import resolve_device

SEED = 0      # of the weights, the prompts and the primed cache


def cut_shape(shape, batch):
    """``shape`` with its global batch cut to ``batch`` (unchanged when
    None)."""
    return shape if batch is None else dataclasses.replace(
        shape, global_batch=batch)


def rank_device(device, rank: int) -> torch.device:
    """The device a rank computes on: ``device`` (CUDA unless named), one
    card a rank modulo the cards there are."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def prompt_batch(cfg, built: BuiltStep, shape, seed: int, device) -> dict:
    """This rank's rows of a seeded global batch of prompts (B, seq_len)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (shape.global_batch,
                                              shape.seq_len)).astype(np.int32)
    baxes = batch_axes_for(shape.global_batch, built.mesh)
    return {k: t.to(device) for k, t in SS.local_batch(
        {"tokens": torch.from_numpy(tokens)}, baxes, built.mesh).items()}


def first_tokens(cfg, built: BuiltStep, shape, seed: int, device):
    """This rank's rows of a seeded global batch of tokens (B,)."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (shape.global_batch,)).astype(np.int32))
    baxes = batch_axes_for(shape.global_batch, built.mesh)
    return SS.local_batch({"t": tokens}, baxes, built.mesh)["t"].to(device)


def primed_cache(built: BuiltStep, generator: torch.Generator, device,
                 pos: int) -> dict:
    """This rank's cache for ``built`` (a decode step), its rows drawn
    from ``generator`` (standard normal keys and values, one layer at a
    time), at position ``pos``."""
    cache = materialize(built.args[2], device)
    for slot in cache["slots"]:
        for t in slot.values():
            for layer in t:
                layer.normal_(generator=generator)
    cache["pos"] = torch.tensor(pos, dtype=torch.int32, device=device)
    return cache


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(built: BuiltStep, params, first, cache, steps: int, device):
    """``steps`` calls of ``built.fn``: a decode step fed its own argmax
    from ``first`` (B,), or a prefill of the batch ``first``. Returns (the
    tokens of each call (steps, B_local), each call's host seconds after
    the device's work)."""
    outs, walls = [], []
    token = first
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        if built.kind == "decode":
            token, cache = built.fn(params, token, cache)
        else:                   # the prefill writes every row of the cache
            token, cache = built.fn(params, first, cache)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        outs.append(token)
    return torch.stack(outs), walls


def serve_production(args) -> dict:
    """The production path (without --smoke); returns what it printed."""
    device = rank_device(args.device, args.rank)
    mesh = launcher_mesh(args, device)
    try:
        return _serve(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _serve(args, device, mesh) -> dict:
    cfg = get_config(args.arch)
    full = INPUT_SHAPES[args.shape]
    if full.kind == "train":
        raise SystemExit(f"{args.shape} is a training shape: "
                         "python -m repro_torch.launch.train")
    shape = cut_shape(full, args.batch)
    built = build_step(cfg, mesh, shape)
    params = init_params(cfg, built, torch.Generator(device).manual_seed(
        SEED), device)
    if built.kind == "decode":
        if args.steps > shape.seq_len:
            raise SystemExit(f"--steps {args.steps} past the cache's "
                             f"{shape.seq_len} rows")
        gen = torch.Generator(device).manual_seed(SEED + 1)
        first = first_tokens(cfg, built, shape, SEED, device)
        cache = primed_cache(built, gen, device, shape.seq_len - args.steps)
    else:
        first = prompt_batch(cfg, built, shape, SEED, device)
        cache = built.new_cache(device)
    tokens, walls = run_steps(built, params, first, cache, args.steps,
                              device)
    per_step = (shape.global_batch if built.kind == "decode"
                else shape.global_batch * shape.seq_len)
    res = {"shape": shape.name, "global_batch": shape.global_batch,
           "cut_from": full.global_batch, "mesh": tuple(mesh.mesh.shape),
           "walls_s": walls, "median_s": float(np.median(walls)),
           "tokens_per_s": per_step * len(walls) / sum(walls),
           "model_flops": step_model_flops(cfg, shape),
           "tokens": tokens.cpu()}
    if args.rank == 0:
        print(f"[serve] {cfg.name} {shape.name} (global batch "
              f"{shape.global_batch}, cut from {full.global_batch}) on mesh "
              f"{res['mesh']}, {device}: {len(walls)} steps, median "
              f"{res['median_s'] * 1e3:.1f} ms a step, "
              f"{res['tokens_per_s']:.1f} tokens/s; "
              f"flops={res['model_flops']:.3g} a step", flush=True)
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefill-workers", type=int, default=1)
    ap.add_argument("--decode-workers", type=int, default=1)
    ap.add_argument("--shape", default="decode_32k", choices=INPUT_SHAPES)
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch to this")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.smoke:
        serve_production(args)
        return

    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.engine import DisaggEngine
    rcfg = get_config(args.arch).reduced()
    eng = DisaggEngine(rcfg, n_prefill=args.prefill_workers,
                       n_decode=args.decode_workers, max_len=96,
                       decode_slots=4, ctrl_cfg=ControllerConfig(),
                       device=args.device)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, rcfg.vocab_size, 24).astype(np.int32),
                   12, 0.0)
    s = eng.run()
    print(f"[serve] {rcfg.name} on {eng.device}: {s.n_finished}/{s.n_total} "
          f"finished  {s.row()}")


if __name__ == "__main__":
    main()
