"""Where a serving step's time goes:
``python -m repro_torch.launch.profile_serve [--arch <id>] [--device cpu]``.

Fills the decode batch of a ``DisaggEngine`` serving Llama-3.1-8B (the
default; max_len 2048, prompts of 1000 tokens), another dense, vlm or moe
model on the same plan (StarCoder2-15B, Chameleon-34B, Granite-3-8B,
Phi-3.5-MoE), RecurrentGemma-2B (max_len 4096, prompts of 3000 tokens,
past its 2048-token window), xLSTM-350M (prompts of 2000 tokens, the
xLSTM paper's context) or Whisper-large-v3 (max_len 448, its decoder's
context, prompts of 223 tokens, the most its decoding keeps, over the
stub's 1500 zero frames) at the published shape (bf16 on a GPU, fp32 on
the CPU; 8 slots; ``--layers`` cuts the depth, as one H100 needs for
Phi-3.5-MoE: 28 of its 32 layers), then times one prefill step and five
decode steps without the
profiler (host wall per step, after ``torch.cuda.synchronize``) and once
more under ``torch.profiler``. From
the profiled run it prints the device-busy time per step (the sum of the
device events' own time; one stream, so no overlap), the device ops
launched per step and those that take the most device time, and the host
time of the spans the model marks with ``record_function`` (the xLSTM's
sLSTM step loop) as a share of the profiled wall. Where the profiler
records no device activity, device numbers read "not measured". The
profiler slows the host, so only the unprofiled wall is a step time.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

STEPS = 5        # decode steps timed
TOP = 15         # device ops listed, by device time


def _report(name: str, prof, wall_s: float, prof_wall_s: float,
            steps: int) -> None:
    events = prof.key_averages()
    stats = [e for e in events
             if e.device_type == DeviceType.CUDA and
             e.self_device_time_total > 0 and not e.is_user_annotation]
    print(f"[profile] {name}: host wall {1e3 * wall_s / steps:.3f} ms/step "
          "(unprofiled)")
    for e in events:
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            print(f"[profile] {name}: span {e.key} "
                  f"{e.cpu_time_total / 1e3 / steps:.3f} ms/step host, "
                  f"{100 * e.cpu_time_total / 1e6 / prof_wall_s:.1f}% of "
                  f"the profiled wall {1e3 * prof_wall_s / steps:.3f} "
                  "ms/step")
    if not stats:
        print(f"[profile] {name}: device time not measured (the profiler "
              "recorded no device activity)")
        return
    busy_us = sum(e.self_device_time_total for e in stats)
    launches = sum(e.count for e in stats)
    print(f"[profile] {name}: device busy {busy_us / 1e3 / steps:.3f} "
          f"ms/step ({100 * busy_us / 1e6 / wall_s:.1f}% of the wall), "
          f"{launches / steps:.0f} device ops/step")
    for e in sorted(stats, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f} "
              f"ms/step  x{e.count // steps:<5d} {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b",
                    choices=("llama3.1-8b", "starcoder2-15b",
                             "chameleon-34b", "granite-3-8b",
                             "recurrentgemma-2b", "xlstm-350m",
                             "phi3.5-moe-42b-a6.6b",
                             "llama4-maverick-400b-a17b",
                             "whisper-large-v3"))
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers to keep (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.models import resolve_device
    from repro_torch.serving.engine import DisaggEngine
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    slots = 8
    max_len, prompt = {"hybrid": (4096, 3000), "ssm": (4096, 2000),
                       "audio": (448, 223)}.get(cfg.family, (2048, 1000))
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=max_len,
                       decode_slots=slots, device=device, dtype=dtype)
    rng = np.random.default_rng(0)
    for _ in range(slots + 2):
        eng.submit(rng.integers(0, cfg.vocab_size, prompt).astype(np.int32),
                   10_000, 0.0)
    pre, dec = eng.workers
    for _ in range(slots):
        eng._do_prefill(pre)
    for _ in range(3):                                  # warm-up
        eng._do_decode_iter(dec)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    print(f"[profile] {cfg.name}: {cfg.n_layers} layers")
    for name, step, n in ((f"{cfg.name} prefill S={prompt}",
                           lambda: eng._do_prefill(pre), 1),
                          (f"{cfg.name} decode B={slots}",
                           lambda: eng._do_decode_iter(dec), STEPS)):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        wall = time.perf_counter() - t0     # each step ends synchronized
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            prof_wall = time.perf_counter() - t0
        _report(name, prof, wall, prof_wall, n)


if __name__ == "__main__":
    main()
