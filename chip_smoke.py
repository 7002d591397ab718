#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It
imports nothing from JAX or the JAX package ``repro``. Phases, each printing
its own lines; any failure exits non-zero without the result line:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, and the build of the eight CUDA libraries from ``csrc/``
   (one ``nvcc`` each, all at once, timed; their ``ptxas`` lines), and the
   count of tensor-core instructions in the SASS of the tensor-core
   kernels (``cuobjdump --dump-sass``): ``HGMMA`` in the bf16 flash
   kernel's and in the backward flash library's bf16 passes, ``HMMA`` in
   the bf16 decode kernel's and in the mLSTM's and its backward's split
   TF32 passes (a library with none fails the run);
2. each kernel against its plain PyTorch version on the card, with its time
   (CUDA events, median, the host queued ahead of the card), the plain
   version's time, the least time the card could take (bytes over 3.35 TB/s
   or flops over 989 TFLOP/s bf16 / 67 TFLOP/s fp32; the mLSTM's fp32
   products, which the kernels run in split TF32, at the faster of 67
   TFLOP/s and three TF32 products at 495 TFLOP/s) and, for attention, as
   a yardstick the port never calls,
   ``torch.nn.functional.scaled_dot_product_attention`` (for a window also
   SDPA's time on the causal problem without it: the dense mask keeps SDPA
   off its flash backend). Each decode case also times SDPA on each slot's
   cache cut to its admitted rows, with no mask, under the flash backend
   alone (the B calls as one case; where that backend refuses the shape it
   says why, and the next backend that takes it is timed), and prints the
   bf16 kernel's time over the faster SDPA time. Each attention case
   prints the route its launch took, by the wrapper's counters: bf16 on
   the tensor-core kernels (``flash_attention_sm90.cu``,
   ``decode_attention_sm90.cu``), fp32 on the CUDA-core ones. The attention
   kernels run at the head shapes of the served models (llama3.1-8b: 32
   query heads over 8 KV heads, head_dim 128; recurrentgemma-2b: 10 over
   1, head_dim 256, window 2048) in fp32 (tolerance 2e-5) and bf16 (each
   element within min(3e-2, 1e-3 + 1e-2 |plain|): both sides round fp32
   math once to bf16, so they may differ by one bf16 step), and in bf16
   at the groups of starcoder2-15b (48 over 4, G = 12; decode also at its
   serve's shape) and llama3-405b (128 over 8, G = 16, the largest the
   bf16 decode kernel takes) and at chameleon-34b's (64 over 8), and at
   whisper-large-v3's (20 over 20, G = 1, head_dim 64): B1 non-causal
   over the encoder's 1500 frames and as cross-attention at decode (B=8,
   one query row over the 1500 frames; B2 timed on the same rows beside
   it), B2 over the decoder's 448-token cache; the
   RG-LRU scan (fp32 only, tolerance 1e-4) at the hybrid serve's prefill
   shape, a ragged one, the serve's shortest and longest prompts (S=206,
   3450) and with the gates drawn as the model draws them, with the
   kernels one call launches (by ``torch.profiler``; the phase fails
   unless that is one launch of the scan kernel and nothing else), its
   workspace bytes, and
   its time at each of the hybrid serve's 12 prompt lengths, summed over
   the serve's 216 calls (beside it what ``cuda_ms`` reads for one
   one-element PyTorch kernel, the floor under a short call's time);
   the chunkwise mLSTM (fp32 only, 2e-4 on h, 1e-5 on the final
   (C, n, m)) at the xLSTM serve's prefill shape and a ragged multi-chunk
   one from a given state, with the kernels one call launches (by
   ``torch.profiler``, beside the wrapper's plan; the phase fails unless
   each pass shows as one launch) and its workspace bytes (the library's
   count, and what one call allocates past its outputs); the backwards
   (each gradient within 1e-4 max |plain| in fp32, 2e-2 max |plain| in
   bf16, the plain version computing in fp32 from the same bf16 inputs):
   B1's (``flash_attention_bwd.cu``: bf16 on ``wgmma`` fed by TMA, fp32 on
   the CUDA cores; both read L, which the forward kernel writes, and the
   plain backward forms its own) at llama3.1-8b's and
   recurrentgemma-2b's training shapes (S=4096, the latter with its 2048
   window), whisper-large-v3's cross-attention (448 over 1500) and an fp32
   ragged case, timed beside SDPA's backward alone (flash backend where it
   takes the shape) and its bound (10 hd Hq flops per admitted pair), with
   the device kernels one call launches (by ``torch.profiler``; the phase
   fails unless they are ``plan_bwd``'s, each launched once), the
   workspace, the split of the query heads, each kernel's registers and
   spills (``ptxas``) and two calls compared bit for bit; every B1 forward
   case also writes L, which must be within 1e-5 max(1, |L|) of the plain
   L, with its output bitwise equal to the output without L, and is timed
   both ways; B3's
   (the scan kernel on reversed time, then the elementwise products) at
   B=1 S=4096 W=2560, with the reverse scan's share and the elementwise
   share; B4's (``mlstm_chunk_bwd.cu``, four launches, three of them on
   ``mma.sync`` in split TF32) against the plain backward evaluated in
   fp64 at xLSTM-350M's training shape (B=1 S=4096 nh=4 hd=512, fresh
   state; the forward there too) and a ragged multi-chunk case from a
   given state, with its passes' launches and times by ``torch.profiler``
   beside ``plan_bwd``, its workspace bytes, each pass's registers and
   spills (``ptxas``) and two calls compared bit for bit;
3. reduced llama3.1-8b, qwen1.5-4b, starcoder2-15b, chameleon-34b,
   granite-3-8b, phi3.5-moe, llama4-maverick, whisper-large-v3,
   recurrentgemma-2b and xlstm-350m in fp32 on the card: prefill and
   decode logits and ``LM.loss`` against the same model on the CPU (plain
   versions, 1e-4; the hybrid decodes past its window of 32, the xLSTM
   prefills 300 tokens, past the plain version's 256-step chunk; the
   encoder-decoder's frames drawn from the seed), and the engine's tokens
   for three ragged prompts against an isolated prefill + decode of each;
   then one training step of each (remat on) in fp32: the loss within
   1e-4 of the CPU's, every gradient leaf within 1e-4 max(1, max |g_cpu|),
   AdamW on the card from the CPU's gradients within 1e-6 of the CPU's
   update (the xLSTM on a batch of 300 tokens, past the plain version's
   256-step chunk); ``train()`` of the reduced qwen1.5-4b
   for 40 steps (test_training.py's settings and assertion), its trained
   parameters served through ``DisaggEngine`` (3 requests), and a
   checkpoint written on the card that restores on the CPU bit for bit;
4. Llama-3.1-8B at its published shape, all 32 layers, bf16 weights drawn
   from a seeded generator, serving 12 requests (prompts of 128-1536
   tokens, 64 new tokens each) through ``DisaggEngine`` with the kernels'
   launch counts set to 0 before the run and read after it (prefill and
   decode attention must run on the tensor-core kernels, the CUDA-core
   ones never);
4b. RecurrentGemma-2B at its published shape, all 26 layers (18 RG-LRU, 8
   local attention), bf16, max_len 4096 (a rotating window cache of 2048),
   serving 12 requests (six prompts of 128-2047 tokens, six of 2049-3583,
   so the cache fills at prefill and wraps in decode; 64 new tokens each),
   with the launch counts read around that run alone;
4c. xLSTM-350M at its published shape, all 24 layers (21 mLSTM, 3 sLSTM),
   bf16, max_len 4096, serving 12 requests (prompts of 128-2047 tokens,
   the xLSTM paper's 2048 context, never a multiple of 64; 64 new tokens
   each), with the mLSTM kernel's launch count read around that run alone;
4d. StarCoder2-15B at its published shape (40 layers, layer norm with
   bias, QKV bias, the GeLU MLP, 48 query heads over 4 KV heads), bf16, on
   Llama's plan;
4e. Chameleon-34B at its published shape (48 layers, QK-norm, 64 over 8
   heads; its bf16 weights take 68.6 GB of the card), on Llama's plan;
4f. Phi-3.5-MoE at its published widths (16 experts of d_ff 6400, top-2
   routing, 32 over 8 heads), its depth cut to 28 of 32 layers (73.3 GB
   of bf16 weights), on Llama's plan: prefill routes groups of 512 tokens
   with capacity drops, decode is dropless;
4g. Whisper-large-v3 at its published shape (32 encoder and 32 decoder
   layers, d_model 1280, 20 heads of 64), over the engine's stub of 1500
   zero frames, max_len 448 (its decoder's context), prompts of 4-223
   tokens.

5. training at the published widths through ``train()``: Llama-3.1-8B (all
   32 layers), RecurrentGemma-2B (all 26) and xLSTM-350M (all 24: 21
   mLSTM, 3 sLSTM), bf16 parameters and AdamW moments, B=1 S=4096
   (train_4k's sequence), remat on, 4 steps each (the xLSTM 3: its sLSTM
   loop makes a step ~45 s), printing each step's wall, loss, grad norm
   and lr, the peak memory and step 2's device-busy share by
   ``torch.profiler`` (for the xLSTM also the sLSTM loop's host share);
   each step's launches must match the plan the model's structure
   gives (B1 forward twice and backward once a rematerialised attention
   layer, B3 likewise a rec layer, B4 an mLSTM layer, the hybrid's
   unrolled layers once), and bf16 B1 never runs on the CUDA-core kernel;
   for the xLSTM, B4's backward device time in step 2, by pass.

Each serve and each training run starts with the previous one's engine
freed and the allocator's cache emptied, and prints its peak device
memory. The seconds of each phase are printed before the table.

The last two lines are the kernel table as JSON and
``{"ok": true, "device": {...}}``. A longer report goes to
``build/chip_smoke_report.json``.

    python3 chip_smoke.py --ab-mlstm DIR

runs none of the phases: it holds B4's forward and backward built from
DIR, another commit's ``src/repro_torch/csrc`` (``git archive <commit>
src/repro_torch/csrc | tar -x -C build/parent`` gives DIR =
``build/parent/src/repro_torch/csrc``), against this checkout's
(``ab_mlstm``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12   # the tensor cores' dense TF32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_TOL = 2e-5
SCAN_TOL = 1e-4
MLSTM_TOL, MLSTM_STATE_TOL = 2e-4, 1e-5
TOL_TEXT = {torch.float32: "2e-5", torch.bfloat16: "min(3e-2, 1e-3+1e-2|plain|)"}
# the backwards: max |kernel - plain| of each gradient within this share of
# max |plain|; in bf16 the plain version computes in fp32 from the same
# bf16 inputs and dO, and the kernel rounds its fp32 sums once to bf16
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
BWD_TOL_TEXT = {torch.float32: "1e-4 max|plain|",
                torch.bfloat16: "2e-2 max|plain|"}
TRAIN_TOL, UPDATE_TOL = 1e-4, 1e-6
LSE_TOL = 1e-5     # B1's L against the plain L, of max(1, |L|)
# the reduced archs whose training step is held against the CPU
TRAIN_ARCHS = ("llama3.1-8b", "qwen1.5-4b", "starcoder2-15b",
               "chameleon-34b", "granite-3-8b", "phi3.5-moe-42b-a6.6b",
               "llama4-maverick-400b-a17b", "whisper-large-v3",
               "recurrentgemma-2b", "xlstm-350m")
TRAIN_SEQ, TRAIN_STEPS = 4096, 4   # train_4k's sequence length, B=1
# the xLSTM's step is ~45 s (its sLSTM loop's ~1.2 million device kernels):
# 3 steps keep the script within half its time limit; step 2 is profiled
XLSTM_TRAIN_STEPS = 3
# device kernels of a training step by kind, by name (the first that
# matches); the rest is "other"
B1_BWD_KERNELS = r"bwd_(?:dq|dkdv|reduce)_sm90|bwd_(?:delta|dkdv|dq)_kernel"
B4_BWD_KERNELS = r"mlstm_bwd_(?:weight|state|grad|gate)_kernel"
DEVICE_KINDS = (("B4 backward", r"mlstm_bwd_"),
                ("B4", r"mlstm_(state|weight|output)_kernel"),
                ("B1 backward", B1_BWD_KERNELS),
                ("B1 forward", r"flash_fwd"),
                ("B3", r"rglru"),
                ("GEMM", r"nvjet|gemm|cutlass|xmma|sm90_"),
                ("reductions", r"reduce|softmax|logsumexp|norm"),
                ("elementwise and copies", r"elementwise|copy|fill|cat"),
                ("indexing", r"index|scatter|gather"))
LLAMA_HEADS = (32, 8, 128)         # (query heads, KV heads, head_dim)
RG_HEADS = (10, 1, 256)            # recurrentgemma-2b
STARCODER2_HEADS = (48, 4, 128)    # starcoder2-15b, G = 12
CHAMELEON_HEADS = (64, 8, 128)     # chameleon-34b
LLAMA405B_HEADS = (128, 8, 128)    # llama3-405b, G = 16
WHISPER_HEADS = (20, 20, 64)       # whisper-large-v3, G = 1
PHI, PHI_LAYERS = "phi3.5-moe-42b-a6.6b", 28   # served at 28 of 32 layers
WHISPER = "whisper-large-v3"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up. The
    card first sleeps for 20 ms, so the host queues the timed calls ahead of
    it and a call shorter than its own launch overhead is timed on the card,
    not on the host (a call whose host work outlasts the sleep, as the plain
    scan's thousands of launches do, is still timed with it)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(0.02 * 1.98e9))   # cycles at the H100's boost clock
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def close(out, ref) -> bool:
    """fp32: max |out - ref| < 2e-5. bf16: each element within
    min(3e-2, 1e-3 + 1e-2 |ref|), one bf16 step (2^-7 of the value) and
    some room."""
    d = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return float(d.max()) < FP32_TOL
    lim = (1e-3 + 1e-2 * ref.float().abs()).clamp(max=3e-2)
    return bool((d <= lim).all())


def bound_ms(n_bytes: float, flops: float, dtype,
             split_tf32: bool = False) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the flops over the peak rate. ``split_tf32``: fp32
    products that may run as three TF32 products on the tensor cores, so
    at the faster of fp32's rate and a third of TF32's."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if split_tf32:
        t_ops = min(t_ops, 3 * flops / TF32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def count_sass(lib: Path, opcode: str) -> int:
    """Instructions of an opcode (``HGMMA``: wgmma, ``HMMA``: mma.sync) in a
    built library's SASS."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return sum(f" {opcode}." in line or f" {opcode} " in line
               for line in sass.splitlines())


def ptxas_registers(name: str, kernels: str = B1_BWD_KERNELS,
                    csrc: Path = None) -> dict:
    """{kernel<template arguments>: (registers, spill store bytes)} of the
    kernels whose names match ``kernels`` (by default the B1 backward's) in
    a library built (from ``csrc``, by default the checkout's), from its
    ``ptxas -v`` log."""
    from repro_torch.kernels import build
    out, kernel, spill = {}, None, 0
    log_path = build.library_path(name, csrc or build.CSRC).with_suffix(
        ".log")
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            base = re.search(f"(?:{kernels})(?=[IE])", m.group(1))
            kernel = None
            if base:
                args = re.match(r"I((?:Li\d+E)+)E", m.group(1)[base.end():])
                kernel = base.group() + (
                    "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1)))
                    + ">" if args else "")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out[kernel] = (int(m.group(1)), spill)
    return out


def phase_environment(report: dict) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    log(f"[env] built {[p.name for p in libs]} in {secs:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "bytes stack" in line:
                log(f"[ptxas] {lib.stem.rsplit('_', 1)[0]}: {line.strip()}")
    tensor_core = {}
    for name, opcode in (("flash_attention_sm90", "HGMMA"),
                         ("decode_attention_sm90", "HMMA"),
                         ("mlstm_chunk", "HMMA"),
                         ("mlstm_chunk_bwd", "HMMA"),
                         ("flash_attention_bwd", "HGMMA")):
        n = count_sass(build.library_path(name), opcode)
        log(f"[env] {name}: {n} {opcode} instructions in its SASS")
        if n == 0:
            raise SystemExit(f"the tensor-core kernel of {name} has no "
                             "tensor-core instruction")
        tensor_core[name] = n
    report["env"] = {"nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda, "build_s": secs,
                     "tensor_core_instructions": tensor_core,
                     "b1_backward_registers":
                     ptxas_registers("flash_attention_bwd"),
                     "b4_backward_registers":
                     ptxas_registers("mlstm_chunk_bwd", B4_BWD_KERNELS)}
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _flash_case(S: int, window, dtype, gen, heads, causal: bool = True,
                B: int = 1, Sq=None) -> dict:
    """B1 at B x (Sq query rows over S keys; Sq = S unless given), causal
    (queries at the first positions) or not."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    HQ, KV, HD = heads
    Sq = S if Sq is None else Sq
    q = torch.randn((B, Sq, HQ, HD), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, HD), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, HD), generator=gen, device="cuda").to(dtype)
    lse = torch.empty((B, HQ, Sq), device="cuda")

    def kern():
        return flash_attention_cuda(q, k, v, causal=causal, window=window)

    def kern_lse():
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    lse=lse)

    def plain():
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    sm90 = flash_attention_cuda.launches_sm90
    out, ref = kern(), plain()
    route = "sm90 wgmma" if flash_attention_cuda.launches_sm90 > sm90 else \
        "cuda-core fp32"
    err, ok = float((out.float() - ref.float()).abs().max()), close(out, ref)
    # L, which the backward reads: against the plain L, and the output
    # with it bit for bit the output without it
    same = bool(torch.equal(kern_lse(), out))
    plain_lse = flash_attention_ref(q, k, v, causal=causal, window=window,
                                    return_lse=True)[1]
    lse_err = float(((lse - plain_lse).abs() /
                     plain_lse.abs().clamp(min=1.0)).max())
    ok = ok and same and lse_err <= LSE_TOL
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def causal_library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def library():
        if mask is None:
            return causal_library()
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    qpos = np.arange(Sq)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq)
    hi = qpos if causal else np.full(Sq, S - 1)
    pairs = B * float(np.sum(hi - lo + 1))
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(n_bytes, 4.0 * pairs * HD * HQ, dtype)
    shape = (f"B={B} S={S} Hq={HQ} K={KV} hd={HD} causal window={window}"
             if causal and Sq == S and B == 1 else
             f"B={B} Sq={Sq} Skv={S} Hq={HQ} K={KV} hd={HD} "
             f"{'causal' if causal else 'non-causal'} window={window}")
    ms, ms_lse = cuda_ms(kern, 20), cuda_ms(kern_lse, 20)
    log(f"[kernel] flash_attention [{route}] {dtype} {shape}: L within "
        f"{lse_err:.3g} of max(1, |plain L|) (tol {LSE_TOL}), output with L "
        f"{'bitwise equal to' if same else 'DIFFERENT from'} the output "
        f"without; {ms:.4f} ms without L, {ms_lse:.4f} ms with")
    return {"shape": shape, "dtype": str(dtype), "err": err,
            "ok": ok, "route": route, "ms": ms, "ms_lse": ms_lse,
            "lse_err": lse_err, "lse_bitwise_same_output": same,
            "plain_ms": cuda_ms(plain, 5),
            "library_ms": cuda_ms(library, 20),
            "library_causal_ms": None if window is None else
            cuda_ms(causal_library, 20), "bound_ms": b_ms, "bound_by": b_by}


def _sdpa_per_slot(qt, kt, vt, rows) -> tuple:
    """SDPA on each slot's cache cut to its admitted rows, no mask: the B
    calls as one function, under the flash backend alone if it takes the
    shape, else under the first backend that does. Returns (function,
    backend name, why flash was refused or None)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def run(backend):
        with sdpa_kernel(backend):
            return [F.scaled_dot_product_attention(
                qt[b:b + 1], kt[b:b + 1, :, :n], vt[b:b + 1, :, :n],
                enable_gqa=True) for b, n in enumerate(rows)]
    refused = None
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            run(backend)
        except RuntimeError as e:   # the backend refuses the shape
            refused = refused or str(e).strip().splitlines()[0][:160]
            continue
        return (lambda: run(backend)), backend.name, refused
    raise SystemExit(f"no SDPA backend takes the per-slot calls: {refused}")


def _decode_case(pos, window, dtype, gen, heads, Sc=2048, B=8) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    HQ, KV, HD = heads
    q = torch.randn((B, 1, HQ, HD), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((B, Sc, KV, HD), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((B, Sc, KV, HD), generator=gen, device="cuda").to(dtype)
    posd = torch.tensor(pos, dtype=torch.int32, device="cuda")

    def kern():           # one launch for both cache layouts
        return decode_attention_cuda(q, kc, vc, posd)

    def plain():
        return decode_attention_ref(q, kc, vc, posd, window=window)
    sm90 = decode_attention_cuda.launches_sm90
    out, ref = kern(), plain()
    route = "sm90 mma.sync" if decode_attention_cuda.launches_sm90 > sm90 \
        else "cuda-core fp32"
    err, ok = float((out.float() - ref.float()).abs().max()), close(out, ref)
    rows = np.minimum(np.asarray(pos) + 1, Sc)     # rows the mask admits
    valid = torch.arange(Sc, device="cuda")[None, :] < \
        torch.as_tensor(rows, device="cuda")[:, None]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=valid[:, None, None, :], enable_gqa=True)
    per_slot, backend, refused = _sdpa_per_slot(qt, kt, vt, rows.tolist())
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + 2 * float(rows.sum()) * KV * HD) + 4 * B
    b_ms, b_by = bound_ms(n_bytes, 4.0 * float(rows.sum()) * HQ * HD, dtype)
    return {"shape": f"B={B} Sc={Sc} Hq={HQ} K={KV} hd={HD} pos={list(pos)} "
                     f"window={window}", "dtype": str(dtype), "err": err,
            "ok": ok, "route": route, "ms": cuda_ms(kern, 50),
            "plain_ms": cuda_ms(plain, 10),
            "library_ms": cuda_ms(library, 50),
            "library_per_slot_ms": cuda_ms(per_slot, 50),
            "per_slot_backend": backend, "flash_refused": refused,
            "bound_ms": b_ms, "bound_by": b_by}


def _model_gates(gen, B: int, S: int, W: int) -> tuple:
    """log_a and x as the model feeds the scan (models/rglru.py
    ``_lru_gates``): log_a = 8 r log(u), u ~ U[0.9, 0.999] (the lam init's
    range), r ~ U(0, 1); x = sqrt(1 - exp(2 log_a)) times a normal draw."""
    u = 0.9 + 0.099 * torch.rand((B, S, W), generator=gen, device="cuda")
    r = torch.rand((B, S, W), generator=gen, device="cuda")
    la = 8.0 * r * torch.log(u)
    z = torch.randn((B, S, W), generator=gen, device="cuda")
    return la, torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la),
                                      min=1e-12)) * z


def _scan_case(B: int, S: int, W: int, gen, model_gates: bool = False,
               main: bool = False) -> dict:
    """The scan against its plain version; for the main case also the
    device kernels one call launches (by torch.profiler: it fails unless
    that is one launch of the scan kernel and nothing else) and the
    workspace (the library's count, and what one call allocates past its
    output when the wrapper holds none yet)."""
    from repro_torch.kernels.rglru_scan.kernel import (_entry,
                                                       release_workspaces,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    if model_gates:
        la, x = _model_gates(gen, B, S, W)
    else:
        la = -torch.rand((B, S, W), generator=gen, device="cuda") * 0.5
        x = torch.randn((B, S, W), generator=gen, device="cuda")
    h0 = torch.randn((B, W), generator=gen, device="cuda")

    def kern():
        return rglru_scan_cuda(la, x, h0)

    def plain():
        return rglru_scan_ref(la, x, h0)
    err = float((kern() - plain()).abs().max())
    # log_a and x read once, the states written once; an exp-mul-add each
    b_ms, b_by = bound_ms(4.0 * (3 * B * S * W + B * W), 2.0 * B * S * W,
                          torch.float32)
    shape = f"B={B} S={S} W={W}{' model gates' if model_gates else ''}"
    case = {"shape": shape, "dtype": str(torch.float32), "err": err,
            "ok": err < SCAN_TOL, "ms": cuda_ms(kern, 50),
            "plain_ms": cuda_ms(plain, 3), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}
    if main:
        kernels = _device_kernels(kern)
        scan = [n for k, (n, _) in kernels.items() if "rglru_scan" in k]
        if scan != [1] or sum(n for n, _ in kernels.values()) != 1:
            raise RuntimeError(
                f"rglru_scan {shape}: the profiler saw (launches, device "
                f"ms) {kernels} in one call, not one launch of the scan "
                "kernel and nothing else")
        lib, _ = _entry()
        ws_bytes = 4 * lib.rglru_scan_workspace_floats(B, S, W)
        release_workspaces()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = kern()
        torch.cuda.synchronize()
        ws_alloc = torch.cuda.max_memory_allocated() - base - \
            out.numel() * 4
        del out
        log(f"[kernel] rglru_scan {shape}: one call launches, by the "
            f"profiler (launches, device ms): {kernels}; workspace "
            f"{ws_bytes} bytes (the library's count), {ws_alloc} "
            "allocated past the output (measured)")
        case.update(launches_per_call=kernels, workspace_bytes=ws_bytes,
                    workspace_alloc_bytes=ws_alloc)
    return case


def _rg_prompt_lengths() -> np.ndarray:
    """The RecurrentGemma serve's prompt lengths (phase 4b): six of
    128-2047 and six of 2049-3583 tokens, never a multiple of 128."""
    rng = np.random.default_rng(0)
    lengths = rng.permutation(np.concatenate([rng.integers(128, 2048, 6),
                                              rng.integers(2049, 3584, 6)]))
    return lengths + (lengths % 128 == 0)


def _scan_serve(gen) -> dict:
    """The scan's time at each of the RecurrentGemma serve's prompt lengths
    (B=1, W = lru_width, the gates as the model draws them), and their sum
    over the serve's calls (one a rec layer for each prompt's prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    cfg = get_config("recurrentgemma-2b")
    W = cfg.lru_width or cfg.d_model
    n_rec = cfg.layer_kinds().count("rec")
    per_call = {}
    for S in sorted(int(n) for n in _rg_prompt_lengths()):
        la, x = _model_gates(gen, 1, S, W)
        h0 = torch.randn((1, W), generator=gen, device="cuda")
        per_call[S] = cuda_ms(lambda: rglru_scan_cuda(la, x, h0), 20)
    total = n_rec * sum(per_call.values())
    bound = n_rec * sum(1e3 * 12.0 * S * W / HBM_BYTES_PER_S
                        for S in per_call)
    log(f"[kernel] rglru_scan at the RecurrentGemma serve's prompt lengths "
        f"(B=1 W={W}, model gates), ms a call: "
        f"{ {S: round(ms, 4) for S, ms in per_call.items()} }; x {n_rec} "
        f"rec layers: {total:.3f} ms of scan a serve (bound {bound:.3f} ms)")
    return {"per_call_ms": per_call, "rec_layers": n_rec,
            "serve_ms": total, "serve_bound_ms": bound}


def _device_kernels(fn) -> dict:
    """(launches, device ms) of each device kernel in one call of fn, by
    torch.profiler (empty where it records no device activity). A first
    call under the profiler warms it up and is not recorded: the profiler
    can lose the first kernel it sees."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    got = {}

    def ready(prof):
        got.update({e.key: (e.count, e.self_device_time_total / 1e3)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and
                    not e.is_user_annotation})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return got


def _passes(fn, pattern: str, n: int, what: str) -> dict:
    """The device kernels of one call of fn whose names match ``pattern``,
    by torch.profiler: {name: (launches, device ms)}; raises unless there
    are n of them, each launched once. The profiler on the card has at
    times recorded none of a call's kernels, so a call is profiled up to
    three times before the check fails."""
    for _ in range(3):
        kernels = _device_kernels(fn)
        passes = {re.search(pattern, k).group(): v
                  for k, v in kernels.items() if re.search(pattern, k)}
        if len(passes) == n and all(c == 1 for c, _ in passes.values()):
            return passes
    raise RuntimeError(
        f"{what}: the profiler saw (launches, device ms) {passes} of "
        f"{pattern} kernels in one call, not {n} passes launched once each; "
        f"all it saw: {kernels}")


def _mlstm_case(B: int, S: int, nh: int, hd: int, given: bool, gen) -> dict:
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_CHUNK,
                                                        _entry,
                                                        mlstm_chunk_cuda,
                                                        plan)
    from repro_torch.kernels.mlstm_chunk.ref import (make_inputs,
                                                     mlstm_chunk_ref)
    # given=False: a prefill from the fresh state, as the serve runs it
    (q, k, v, li, lf), state = make_inputs(gen, B, S, nh, hd, given)

    def kern():
        return mlstm_chunk_cuda(q, k, v, li, lf, *state)

    def plain():
        return mlstm_chunk_ref(q, k, v, li, lf, state)
    # held against the plain version evaluated in fp64: its fp32 rounding on
    # the card can reach the tolerance by itself (printed beside)
    h, new = kern()
    h_ref, new_ref = mlstm_chunk_ref(
        *(t.double() for t in (q, k, v, li, lf)),
        tuple(t.double() for t in state))
    err = float((h.double() - h_ref).abs().max())
    state_err = max(float((a.double() - b).abs().max())
                    for a, b in zip(new, new_ref))
    plain_err = float((plain()[0].double() - h_ref).abs().max())
    # q, k, v, the gates and the state read once; h and the state written
    # once. Flops of the chunkwise form at the kernel's chunk kL: q C and
    # the C update (2 hd^2 each a step), the causal half of q k^T and w v
    # (kL hd each a step on average)
    n_state = B * nh * (hd * hd + hd + 1)
    n_bytes = 4.0 * (4 * B * S * nh * hd + 2 * B * S * nh + 2 * n_state)
    flops = 2.0 * B * nh * S * (2 * hd * hd + KERNEL_CHUNK * hd)
    b_ms, b_by = bound_ms(n_bytes, flops, torch.float32, split_tf32=True)
    shape = (f"B={B} S={S} nh={nh} hd={hd} "
             f"{'given' if given else 'fresh'} state")
    # the passes of one call: planned by the wrapper, and as profiled; each
    # pass must show as one launch of its own kernel
    p = plan(B, S, nh, hd)
    passes = _passes(kern, r"mlstm_\w+", p["launches"], f"mlstm_chunk {shape}")
    # the workspace: the library's count, the plan's, and the memory one
    # call allocates past its outputs (the caching allocator rounds up)
    lib, _ = _entry()
    ws_bytes = 4 * lib.mlstm_chunk_workspace_floats(B, S, nh, hd)
    if ws_bytes != p["workspace_bytes"]:
        raise RuntimeError(f"mlstm_chunk {shape}: the library needs "
                           f"{ws_bytes} bytes of workspace, the plan "
                           f"{p['workspace_bytes']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = kern()
    torch.cuda.synchronize()
    out_bytes = sum(t.numel() * 4 for t in (out[0], *out[1]))
    ws_alloc = torch.cuda.max_memory_allocated() - base - out_bytes
    del out
    log(f"[kernel] mlstm_chunk {shape}: one call launches "
        f"{p['launches']} passes on {p['blocks']} blocks (plan); profiled "
        f"(launches, device ms): {passes}; "
        f"workspace {ws_bytes} bytes (the library's count), "
        f"{ws_alloc} allocated past the outputs (measured)")
    return {"shape": shape,
            "dtype": str(torch.float32), "err": err, "state_err": state_err,
            "plain_fp32_err": plain_err,
            "ok": err < MLSTM_TOL and state_err < MLSTM_STATE_TOL,
            "passes": passes, "blocks": p["blocks"],
            "workspace_bytes": ws_bytes, "workspace_alloc_bytes": ws_alloc,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def _mlstm_bwd_case(B: int, S: int, nh: int, hd: int, given: bool,
                    gen) -> dict:
    """B4's backward against its plain version evaluated in fp64 at the
    kernel's chunk (each gradient within 1e-4 max |plain|) and against
    itself (two calls bit for bit); its time, the plain version's (fp32),
    its passes' launches and device times by torch.profiler beside
    ``plan_bwd``, their registers and spills (``ptxas``), its workspace
    bytes, and the bound: 8 B nh S hd^2 + 5 B nh S 64 hd flops (the dC'
    chain, C dnum, dC' v and dC'^T k; the causal half of q k^T, dh v^T and
    the three intra-chunk products) as three TF32 products at 495 TFLOP/s
    (the split-TF32 floor; fp32's 67 TFLOP/s, logged beside, is slower),
    or q, k, v, h, dh, the gates and the chunks' states read and the
    gradients written once."""
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_CHUNK,
                                                        _bwd_entry,
                                                        forward_states,
                                                        mlstm_chunk_bwd_cuda,
                                                        mlstm_chunk_cuda,
                                                        plan_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import (make_inputs,
                                                     mlstm_chunk_bwd_ref)
    (q, k, v, li, lf), state = make_inputs(gen, B, S, nh, hd, given)
    dh = torch.randn(q.shape, generator=gen, device="cuda")
    with torch.no_grad():
        h, _, ws = mlstm_chunk_cuda(q, k, v, li, lf, *state,
                                    keep_workspace=True)
    states = forward_states(ws, B, S, nh, hd)

    def kern():
        return mlstm_chunk_bwd_cuda(q, k, v, li, lf, state, h, dh, states)

    def plain():
        return mlstm_chunk_bwd_ref(q, k, v, li, lf, state, dh)
    got = kern()
    same = all(torch.equal(a, b) for a, b in zip(got, kern()))
    want = mlstm_chunk_bwd_ref(*(t.double() for t in (q, k, v, li, lf)),
                               tuple(t.double() for t in state), dh.double(),
                               chunk=KERNEL_CHUNK)
    errs = [float((g.double() - w).abs().max()) for g, w in zip(got, want)]
    rel = [e / float(w.abs().max()) for e, w in zip(errs, want)]
    del got, want
    flops = 8.0 * B * nh * S * hd * hd + 5.0 * B * nh * S * KERNEL_CHUNK * hd
    n_state = sum(t.numel() for t in (*state, *states))
    n_bytes = 4.0 * (8 * B * S * nh * hd + 4 * B * S * nh + n_state)
    b_ms, b_by = bound_ms(n_bytes, flops, torch.float32, split_tf32=True)
    fp32_ms, _ = bound_ms(n_bytes, flops, torch.float32)
    shape = (f"B={B} S={S} nh={nh} hd={hd} "
             f"{'given' if given else 'fresh'} state")
    p = plan_bwd(B, S, nh, hd)
    passes = _passes(kern, r"mlstm_bwd_\w+", p["launches"],
                     f"mlstm_chunk_bwd {shape}")
    lib, _ = _bwd_entry()
    ws_bytes = 4 * lib.mlstm_chunk_bwd_workspace_floats(B, S, nh, hd)
    if ws_bytes != p["workspace_bytes"]:
        raise RuntimeError(f"mlstm_chunk_bwd {shape}: the library needs "
                           f"{ws_bytes} bytes of workspace, the plan "
                           f"{p['workspace_bytes']}")
    regs = ptxas_registers("mlstm_chunk_bwd", B4_BWD_KERNELS)
    log(f"[kernel] mlstm_chunk_bwd {shape}: one call launches "
        f"{p['launches']} passes on {p['blocks']} blocks of {p['threads']} "
        f"threads (plan); profiled (launches, device ms): {passes}; "
        f"(registers, spill store bytes) by ptxas: {regs}; workspace "
        f"{ws_bytes} bytes (the library's count); {flops / 1e9:.2f} GFLOP, "
        f"bound {b_ms:.4f} ms ({b_by}, split TF32), at fp32's 67 TFLOP/s "
        f"{fp32_ms:.4f} ms; two calls "
        f"{'bitwise equal' if same else 'DIFFER'}")
    return {"shape": shape, "dtype": str(torch.float32), "err": max(errs),
            "rel_err": rel, "bitwise": same,
            "ok": max(rel) <= BWD_TOL[torch.float32] and same,
            "passes": passes, "blocks": p["blocks"], "registers": regs,
            "workspace_bytes": ws_bytes, "ms": cuda_ms(kern, 10),
            "plain_ms": cuda_ms(plain, 3), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def _sdpa_backward(q, k, v, do, causal: bool, window) -> tuple:
    """The backward alone of ``scaled_dot_product_attention`` on the same
    problem, as a yardstick the port never calls: under the flash backend
    where it takes the shape (no mask, bf16), else under the first backend
    that does (a window needs a dense mask, and then K and V expanded to
    the query heads). Returns (function, backend name, why flash was
    refused or None)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    Sq, Skv, G = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    mask = None
    if window is not None:
        i = torch.arange(Sq, device="cuda")[:, None]
        j = torch.arange(Skv, device="cuda")[None, :]
        mask = (j > i - window) & ((j <= i) if causal else True)
    refused = None
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        gqa = mask is None
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (t.transpose(1, 2) if gqa else
                  t.repeat_interleave(G, dim=2).transpose(1, 2)
                  for t in (k, v))
        kt, vt = kt.detach().requires_grad_(), vt.detach().requires_grad_()
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=gqa)
                torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                    retain_graph=True)
        except RuntimeError as e:   # the backend refuses the problem
            refused = refused or str(e).strip().splitlines()[0][:160]
            continue
        dot = do.transpose(1, 2)
        return (lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                            retain_graph=True)), \
            backend.name, refused
    raise SystemExit(f"no SDPA backend takes the backward: {refused}")


def _flash_bwd_case(Sq: int, Skv: int, heads, dtype, gen, causal=True,
                    window=None) -> dict:
    """B1's backward, through the L the forward kernel wrote, against its
    plain version (fp32 math from the same inputs and dO, its own L), with
    its time, the plain version's, SDPA's backward and the bound: 10 hd Hq
    flops per admitted (query, key) pair at the dtype's peak, or q, k, v,
    o, dO read and dq, dk, dv written once. Also the device kernels of one
    call against ``plan_bwd`` (by torch.profiler), its workspace and split,
    the kernels' registers, and two calls compared bit for bit."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_bwd)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref)
    HQ, KV, HD = heads
    q = torch.randn((1, Sq, HQ, HD), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Skv, KV, HD), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, Skv, KV, HD), generator=gen, device="cuda").to(dtype)
    do = torch.randn((1, Sq, HQ, HD), generator=gen, device="cuda").to(dtype)
    lse = torch.empty((1, HQ, Sq), device="cuda")
    with torch.no_grad():
        o = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                 lse=lse)

    def kern():
        return flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                        window=window)

    def plain():
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    got, want = kern(), plain()
    errs = [float((g.float() - w.float()).abs().max()) for g, w in
            zip(got, want)]
    rel = [e / float(w.float().abs().max()) for e, w in zip(errs, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, kern()))
    del got, want
    plan = plan_bwd(1, Sq, Skv, HQ, KV, HD, dtype)
    shape = (f"Sq={Sq} Skv={Skv} Hq={HQ} K={KV} hd={HD} "
             f"{'causal' if causal else 'non-causal'} window={window}")
    kernels = _passes(kern, B1_BWD_KERNELS, plan["launches"],
                      f"flash_attention_bwd {shape}")
    # the registers of the kernels that ran, at this head dim's padding
    hdp = next(p for p in (32, 64, 128, 256) if HD <= p and (
        p > 32 or dtype == torch.float32))
    regs = {k: v for k, v in ptxas_registers("flash_attention_bwd").items()
            if k.split("<")[0] in kernels and
            ("<" not in k or int(re.search(r"<(\d+)", k).group(1)) == hdp)}
    log(f"[kernel] flash_attention_bwd {dtype} {shape}: one call launches "
        f"{ {k: (n, round(t, 4)) for k, (n, t) in kernels.items()} } "
        f"(device kernels: launches, ms; plan {plan['launches']}: "
        f"{plan['grids']}); query heads split into {plan['shares']} "
        f"share(s) of {plan['heads_per_share']}; workspace "
        f"{plan['workspace_bytes']} bytes; registers, spill bytes "
        f"{regs}; two calls {'bitwise equal' if same else 'DIFFER'}")
    qpos = np.arange(Sq)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq)
    hi = np.minimum(qpos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    pairs = float(np.sum(hi - lo + 1))
    n_bytes = q.element_size() * 4.0 * (q.numel() + k.numel())
    b_ms, b_by = bound_ms(n_bytes, 10.0 * HD * HQ * pairs, dtype)
    library, backend, refused = _sdpa_backward(q, k, v, do, causal, window)
    case = {"shape": shape,
            "route": "wgmma" if dtype == torch.bfloat16 else
            "cuda-core fp32",
            "dtype": str(dtype), "err": max(errs), "rel_err": rel,
            "ok": max(rel) <= BWD_TOL[dtype] and same, "pairs": pairs,
            "device_kernels": kernels, "plan": plan, "registers": regs,
            "bitwise_repeatable": same,
            "ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 3),
            "library_ms": cuda_ms(library, 10), "library_backend": backend,
            "flash_refused": refused, "bound_ms": b_ms, "bound_by": b_by}
    if window is not None:   # SDPA's flash backward without the window
        causal_library, _, _ = _sdpa_backward(q, k, v, do, causal, None)
        case["library_causal_ms"] = cuda_ms(causal_library, 10)
    return case


def _scan_bwd_case(B: int, S: int, W: int, gen) -> dict:
    """B3's backward (the scan kernel on reversed time, then the
    elementwise products) against its plain version, the gates as the
    model draws them; its time, the reverse scan's alone and the
    elementwise share, and the bound: the reverse scan's bytes (log_a' and
    dy' read, g written) over the memory rate."""
    from repro_torch.kernels.rglru_scan.kernel import (_scan,
                                                       reverse_scan_inputs,
                                                       rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    la, x = _model_gates(gen, B, S, W)
    h0 = torch.randn((B, W), generator=gen, device="cuda")
    dy = torch.randn((B, S, W), generator=gen, device="cuda")
    y = rglru_scan_cuda(la, x, h0)

    def kern():
        return rglru_scan_bwd_cuda(la, h0, y, dy)

    def plain():
        return rglru_scan_bwd_ref(la, h0, y, dy)
    got, want = kern(), plain()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    rel = [e / float(w.abs().max()) for e, w in zip(errs, want)]
    rev = reverse_scan_inputs(la, dy)
    ms = cuda_ms(kern, 20)
    scan_ms = cuda_ms(lambda: _scan(*rev), 20)
    b_ms, b_by = bound_ms(4.0 * 3 * B * S * W, 2.0 * B * S * W,
                          torch.float32)
    return {"shape": f"B={B} S={S} W={W} model gates",
            "dtype": str(torch.float32), "err": max(errs), "rel_err": rel,
            "ok": max(rel) <= BWD_TOL[torch.float32], "ms": ms,
            "reverse_scan_ms": scan_ms, "elementwise_ms": ms - scan_ms,
            "plain_ms": cuda_ms(plain, 3), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels(report: dict) -> dict:
    """Returns the main-path case of each kernel, for the table: bf16
    attention at the llama serve's shapes, the scan at the hybrid serve's
    prefill shape, the mLSTM at the xLSTM serve's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    spread = [0, 300, 700, 1023, 1024, 1500, 2047, 2300]   # 2300: idle, > Sc
    # recurrentgemma-2b's rotating cache, before and after it wraps
    rg_spread = [0, 1, 300, 1023, 1024, 2047, 2048, 3500]
    cases = {"flash_attention": [], "decode_attention": [], "rglru_scan": [],
             "mlstm_chunk": []}
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S, window in ((1000, None), (2048, None), (2048, 256)):
            c = _flash_case(S, window, dtype, gen, LLAMA_HEADS)
            cases["flash_attention"].append(c)
            if dtype == torch.bfloat16 and S == 1000:   # a ragged prompt
                main["flash_attention"] = c
        cases["flash_attention"].append(
            _flash_case(3000, 2048, dtype, gen, RG_HEADS))
        for window in (None, 2048):   # flat cache, then rotating window
            c = _decode_case(spread, window, dtype, gen, LLAMA_HEADS)
            cases["decode_attention"].append(c)
            if dtype == torch.bfloat16 and window is None:
                main["decode_attention"] = c
        c = _decode_case(rg_spread, 2048, dtype, gen, RG_HEADS)
        cases["decode_attention"].append(c)
        if dtype == torch.bfloat16:
            main["decode_attention_rg"] = c
        # G = 5 (llama4-maverick) and 12 (starcoder2-15b), which the bf16
        # kernel pads to its 16-row tile, and slots with one or two keys
        cases["decode_attention"].append(_decode_case(
            [0, 1, 500, 2047], None, dtype, gen, (40, 8, 128), B=4))
        cases["decode_attention"].append(_decode_case(
            [1, 0, 1500, 3000], 2048, dtype, gen, STARCODER2_HEADS, B=4))
    # bf16 at the head shapes of the dense serves 4d and 4e and of
    # llama3-405b (G = 16), which no served model reaches
    bf16 = torch.bfloat16
    for S, heads in ((1500, STARCODER2_HEADS), (1000, CHAMELEON_HEADS),
                     (1000, LLAMA405B_HEADS)):
        cases["flash_attention"].append(
            _flash_case(S, None, bf16, gen, heads))
    for name, heads in (("starcoder2", STARCODER2_HEADS),
                        ("chameleon", CHAMELEON_HEADS)):
        c = _decode_case(spread, None, bf16, gen, heads)
        cases["decode_attention"].append(c)
        main[f"decode_attention_{name}"] = c
    cases["decode_attention"].append(
        _decode_case(rg_spread, 2048, bf16, gen, LLAMA405B_HEADS))
    # whisper-large-v3 (20 over 20 heads, G = 1, hd 64): B1 non-causal over
    # the encoder's 1500 frames, and as cross-attention at decode (one
    # query row of a 128-row tile for each of 8 slots); B2 on the same rows
    # (every slot at position 1499) for comparison; B2 over the decoder's
    # 448-token self-attention cache
    c = _flash_case(1500, None, bf16, gen, WHISPER_HEADS, causal=False)
    cases["flash_attention"].append(c)
    main["flash_attention_whisper_encoder"] = c
    c = _flash_case(1500, None, bf16, gen, WHISPER_HEADS, causal=False, B=8,
                    Sq=1)
    cases["flash_attention"].append(c)
    main["flash_attention_whisper_cross"] = c
    cases["decode_attention"].append(_decode_case(
        [1499] * 8, None, bf16, gen, WHISPER_HEADS, Sc=1500))
    c = _decode_case([0, 1, 223, 447, 5, 100, 300, 446], None, bf16, gen,
                     WHISPER_HEADS, Sc=448)
    cases["decode_attention"].append(c)
    main["decode_attention_whisper"] = c
    # what cuda_ms reads for a call that does next to nothing: the floor
    # under the short scans' times
    one = torch.zeros(1, device="cuda")
    report["cuda_ms_floor"] = cuda_ms(lambda: one.add_(1), 50)
    log(f"[kernel] cuda_ms of one one-element PyTorch kernel: "
        f"{report['cuda_ms_floor']:.4f} ms")
    # the hybrid serve's prefill, a ragged shape, the serve's shortest and
    # longest prompts, and the gates as the model draws them
    cases["rglru_scan"].append(_scan_case(1, 3000, 2560, gen, main=True))
    for B, S, W in ((2, 37, 200), (1, 206, 2560), (1, 3450, 2560)):
        cases["rglru_scan"].append(_scan_case(B, S, W, gen))
    cases["rglru_scan"].append(_scan_case(1, 3000, 2560, gen,
                                          model_gates=True))
    main["rglru_scan"] = cases["rglru_scan"][0]
    report["rglru_scan_serve"] = _scan_serve(gen)
    # xlstm-350m's prefill (4 heads of 512), then ragged chunks from a
    # state, then its training shape
    for B, S, nh, hd, given in ((1, 2048, 4, 512, False),
                                (2, 300, 2, 256, True),
                                (1, TRAIN_SEQ, 4, 512, False)):
        cases["mlstm_chunk"].append(_mlstm_case(B, S, nh, hd, given, gen))
    main["mlstm_chunk"] = cases["mlstm_chunk"][0]
    # the backwards at the training shapes: llama3.1-8b and
    # recurrentgemma-2b at S=4096, whisper-large-v3's cross-attention, an
    # fp32 ragged case; B3 at the hybrid's training shape
    cases["flash_attention_bwd"] = [
        _flash_bwd_case(4096, 4096, LLAMA_HEADS, bf16, gen),
        _flash_bwd_case(4096, 4096, RG_HEADS, bf16, gen, window=2048),
        _flash_bwd_case(448, 1500, WHISPER_HEADS, bf16, gen, causal=False),
        _flash_bwd_case(1000, 1000, (16, 4, 128), torch.float32, gen,
                        window=256)]
    main["flash_attention_bwd"] = cases["flash_attention_bwd"][0]
    main["flash_attention_bwd_rg"] = cases["flash_attention_bwd"][1]
    cases["rglru_scan_bwd"] = [_scan_bwd_case(1, 4096, 2560, gen)]
    main["rglru_scan_bwd"] = cases["rglru_scan_bwd"][0]
    # B4's at xlstm-350m's training shape, then ragged chunks from a state
    cases["mlstm_chunk_bwd"] = [
        _mlstm_bwd_case(1, TRAIN_SEQ, 4, 512, False, gen),
        _mlstm_bwd_case(2, 300, 2, 256, True, gen)]
    main["mlstm_chunk_bwd"] = cases["mlstm_chunk_bwd"][0]
    log(f"[kernel] rglru_scan_bwd B=1 S=4096 W=2560: "
        f"{main['rglru_scan_bwd']['ms']:.4f} ms, of which the reverse scan "
        f"{main['rglru_scan_bwd']['reverse_scan_ms']:.4f} ms and the "
        f"flips and elementwise products "
        f"{main['rglru_scan_bwd']['elementwise_ms']:.4f} ms")
    tols = {"rglru_scan": SCAN_TOL,
            "mlstm_chunk": f"{MLSTM_TOL}, state {MLSTM_STATE_TOL}",
            "rglru_scan_bwd": "1e-4 max|plain|",
            "mlstm_chunk_bwd": "1e-4 max|plain|, plain in fp64"}
    failed = []
    for name, rows in cases.items():
        for c in rows:
            dtype = getattr(torch, c["dtype"].split(".")[1])
            tol = tols.get(name, BWD_TOL_TEXT[dtype] if name.endswith(
                "_bwd") else TOL_TEXT[dtype])
            lib = "none" if c["library_ms"] is None else \
                f"{c['library_ms']:.4f} ms"
            ok = c["ok"]
            state = f" state {c['state_err']:.3g}" if "state_err" in c \
                else ""
            if "plain_fp32_err" in c:
                state += (f" against the plain version in fp64 (the plain "
                          f"version in fp32: {c['plain_fp32_err']:.3g})")
            route = f" [{c['route']}]" if "route" in c else ""
            if "rel_err" in c:
                state += (" (relative to max |plain|: "
                          f"{', '.join(f'{r:.3g}' for r in c['rel_err'])})")
            if "library_backend" in c:
                lib += f" backward, {c['library_backend']}"
            if c.get("library_causal_ms") is not None:
                lib += f" (causal, no window {c['library_causal_ms']:.4f} ms)"
            if "library_per_slot_ms" in c:
                lib += (f" dense mask; {c['library_per_slot_ms']:.4f} ms "
                        f"per slot, cut, {c['per_slot_backend']}")
                if c["flash_refused"]:
                    lib += f" (flash refused: {c['flash_refused']})"
            log(f"[kernel] {name}{route} {c['dtype']} {c['shape']}: "
                f"max_abs_err {c['err']:.3g}{state} (tol {tol}) "
                f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                f"sdpa {lib}  bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']})  {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append((name, c["shape"], c["dtype"]))
            if "library_per_slot_ms" in c and c["dtype"] == "torch.bfloat16":
                fast = min(c["library_ms"], c["library_per_slot_ms"])
                log(f"[kernel]   bf16 decode kernel over the faster SDPA "
                    f"time ({fast:.4f} ms): {c['ms'] / fast:.2f}x")
    report["kernels"] = cases
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version: {failed}")
    return main


# ---------------------------------------------------------------------------
# B4 against another commit's (--ab-mlstm)
# ---------------------------------------------------------------------------

AB_FWD_CASES = ((1, 2048, 4, 512, False), (2, 300, 2, 256, True),
                (1, 4096, 4, 512, False))
AB_BWD_CASES = ((1, 4096, 4, 512, False), (2, 300, 2, 256, True))


def ab_mlstm(parent: Path) -> int:
    """B4's forward and backward built from ``parent`` (a ``csrc``
    directory) and from this checkout's, called through the same wrappers
    on the same seeded inputs: each library's ``HMMA`` count and its
    kernels' registers; the forwards' outputs compared bit for bit at
    xLSTM-350M's prefill and training shapes and a ragged case from a
    given state; each backward at the training shape and the ragged case
    against the plain backward in fp64 (within 1e-4 of max |plain|) and
    against itself (bit for bit), with its passes by torch.profiler; and
    every time in turns (parent, change, change, parent), so that both see
    the same card. Returns 1 if the forwards differ or a backward fails."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk.kernel import (KERNEL_CHUNK,
                                                        forward_states,
                                                        mlstm_chunk_bwd_cuda,
                                                        mlstm_chunk_cuda)
    from repro_torch.kernels.mlstm_chunk.ref import (make_inputs,
                                                     mlstm_chunk_bwd_ref)
    names = ("mlstm_chunk", "mlstm_chunk_bwd")
    sides = {"parent": parent.resolve(), "change": build.CSRC}
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    for tag, csrc in sides.items():
        for name, lib in zip(names, build.build_all(names, csrc)):
            regs = ptxas_registers(
                name, rf"mlstm_(?:state|weight|output)_kernel|{B4_BWD_KERNELS}",
                csrc)
            log(f"[ab] {tag} {name}: {count_sass(lib, 'HMMA')} HMMA; "
                f"(registers, spill store bytes) {regs}")

    def in_turns(fn, reps: int) -> dict:
        times = {tag: [] for tag in sides}
        for tag in ("parent", "change", "change", "parent"):
            with build.using(sides[tag], names):
                times[tag].append(cuda_ms(fn, reps))
        return times
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for B, S, nh, hd, given in AB_FWD_CASES:
        shape = f"B={B} S={S} nh={nh} hd={hd} {'given' if given else 'fresh'}"
        ins, state = make_inputs(gen, B, S, nh, hd, given)

        def fwd():
            return mlstm_chunk_cuda(*ins, *state)
        outs = []
        for csrc in sides.values():
            with build.using(csrc, names):
                h, new = fwd()
                outs.append((h, *new))
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        log(f"[ab] forward {shape}: outputs "
            f"{'bitwise equal' if same else 'DIFFER'}; ms "
            f"{in_turns(fwd, 20)}")
        if not same:
            failed.append(f"forward {shape}")
    for B, S, nh, hd, given in AB_BWD_CASES:
        shape = f"B={B} S={S} nh={nh} hd={hd} {'given' if given else 'fresh'}"
        ins, state = make_inputs(gen, B, S, nh, hd, given)
        dh = torch.randn(ins[0].shape, generator=gen, device="cuda")
        h, _, ws = mlstm_chunk_cuda(*ins, *state, keep_workspace=True)
        states = forward_states(ws, B, S, nh, hd)
        want = mlstm_chunk_bwd_ref(*(t.double() for t in ins),
                                   tuple(t.double() for t in state),
                                   dh.double(), chunk=KERNEL_CHUNK)

        def bwd():
            return mlstm_chunk_bwd_cuda(*ins, state, h, dh, states)
        for tag, csrc in sides.items():
            with build.using(csrc, names):
                got = bwd()
                rel = [float((g.double() - w).abs().max() / w.abs().max())
                       for g, w in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, bwd()))
                passes = _passes(bwd, r"mlstm_bwd_\w+", 4,
                                 f"{tag} mlstm_chunk_bwd {shape}")
            log(f"[ab] backward {tag} {shape}: of max |plain| (fp64) "
                f"{', '.join(f'{r:.3g}' for r in rel)}; two calls "
                f"{'bitwise equal' if same else 'DIFFER'}; passes "
                f"(launches, device ms) {passes}")
            if max(rel) > BWD_TOL[torch.float32] or not same:
                failed.append(f"backward {tag} {shape}")
        del got, want
        log(f"[ab] backward {shape}: ms {in_turns(bwd, 10)}")
    log(f"[ab] {'failed: ' + str(failed) if failed else 'ok'}")
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_reduced(report: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving.engine import DisaggEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # arch -> (prefill, total tokens, cache max_len, engine prompt lengths,
    # engine max_len); the hybrid's window is 32: it decodes past it, and two
    # of its engine prompts are longer than it; the xLSTM prefills past the
    # plain version's 256-step chunk, and so do two of its engine prompts
    dense = (17, 21, 32, (12, 20, 17), 64)
    plans = {"qwen1.5-4b": dense, "llama3.1-8b": dense,
             "starcoder2-15b": dense, "chameleon-34b": dense,
             "granite-3-8b": dense, "phi3.5-moe-42b-a6.6b": dense,
             "llama4-maverick-400b-a17b": dense, "whisper-large-v3": dense,
             "recurrentgemma-2b": (20, 40, 64, (12, 40, 33), 64),
             "xlstm-350m": (300, 310, 0, (12, 300, 257), 320)}
    for arch, (n_pre, n_tot, max_len, lengths, eng_len) in plans.items():
        cfg = get_config(arch).reduced()
        lm = LM(cfg)
        rng = np.random.default_rng(0)
        # logits on the card (kernels) against the CPU (plain versions)
        params = lm.init(torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
        params_cpu = _to_cpu(params)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, n_tot)))
        # the encoder-decoder's frame embeddings, drawn from the seed
        frames = {} if not cfg.is_encoder_decoder else {
            "enc_feats": torch.from_numpy(0.5 * rng.standard_normal(
                (3, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
        errs = []
        caches = {d: lm.init_cache(3, max_len, dtype=torch.float32, device=d)
                  for d in ("cuda", "cpu")}
        lg = {}
        for d, p in (("cuda", params), ("cpu", params_cpu)):
            lg[d], caches[d] = lm.prefill(
                p, {**{k: v.to(d) for k, v in frames.items()},
                    "tokens": toks[:, :n_pre].to(d)}, caches[d])
        errs.append(float((lg["cuda"].cpu() - lg["cpu"]).abs().max()))
        for t in range(n_pre, n_tot):
            for d, p in (("cuda", params), ("cpu", params_cpu)):
                lg[d], caches[d] = lm.decode_step(p, toks[:, t].to(d),
                                                  caches[d])
            errs.append(float((lg["cuda"].cpu() - lg["cpu"]).abs().max()))
        if not max(errs) < 1e-4 or not torch.isfinite(lg["cuda"]).all():
            raise SystemExit(f"{arch}: card logits differ from the CPU: {errs}")
        # LM.loss (forward_train's logits), some labels masked
        labels = toks.roll(-1, dims=1)
        labels[:, -1] = -1
        labels[0, 3:9] = -1
        batch = {"tokens": toks, "labels": labels, **frames}
        loss = {d: float(lm.loss(p, {k: v.to(d) for k, v in batch.items()}))
                for d, p in (("cuda", params), ("cpu", params_cpu))}
        loss_err = abs(loss["cuda"] - loss["cpu"])
        if not loss_err < 1e-4:
            raise SystemExit(f"{arch}: card loss differs from the CPU: "
                             f"{loss}")
        # the engine's tokens against an isolated decode, on the card
        eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=eng_len,
                           decode_slots=3, seed=7, device="cuda")
        for n in lengths:
            eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       8, 0.0)
        s = eng.run()
        mismatched = 0
        for req in eng.finished:
            cache = lm.init_cache(1, eng_len, dtype=torch.float32,
                                  device="cuda")
            lg1, cache = lm.prefill(eng.params, _prompt_batch(eng, req.tokens),
                                    cache)
            toks1 = [int(torch.argmax(lg1[0]))]
            for _ in range(len(req.generated) - 1):
                lg1, cache = lm.decode_step(
                    eng.params, torch.tensor([toks1[-1]], device="cuda"),
                    cache)
                toks1.append(int(torch.argmax(lg1[0])))
            mismatched += toks1 != req.generated
        log(f"[reduced] {cfg.name}: logits card vs cpu max err "
            f"{max(errs):.3g} (tol 1e-4); loss {loss['cuda']:.6f}, card vs "
            f"cpu err {loss_err:.3g} (tol 1e-4); engine "
            f"{s.n_finished}/{s.n_total} "
            f"finished, {len(eng.finished) - mismatched}/{len(eng.finished)} "
            f"match an isolated decode")
        if s.n_finished != 3 or mismatched:
            raise SystemExit(f"{arch}: engine tokens differ from an isolated "
                             "decode")
        out[cfg.name] = {"logit_err": max(errs), "loss_err": loss_err,
                         "finished": s.n_finished}
    report["reduced"] = out


def _loss_and_grads(lm, params, batch: dict, device: str) -> tuple:
    """``LM.loss`` with remat and its gradient leaves on ``device``, from
    copies of ``params``."""
    from repro_torch.models.params import flatten, map_leaves
    p = map_leaves(lambda t: t.detach().to(device).requires_grad_(), params)
    leaves = flatten(p)
    loss = lm.loss(p, {k: torch.from_numpy(v).to(device)
                       for k, v in batch.items()}, remat=True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def phase_train_reduced(report: dict) -> None:
    """One training step of each reduced arch in fp32 on the card against
    the CPU: the loss, every gradient leaf, and AdamW on the card from the
    CPU's gradients; then train(), a serve of what it trained, and a
    checkpoint from the card restored on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.params import flatten, map_leaves, rebuild
    from repro_torch.serving.engine import DisaggEngine
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import TokenStream
    from repro_torch.training.optimizer import (AdamWConfig, apply_updates,
                                                init_state)
    from repro_torch.training.train_loop import train
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        lm = LM(cfg)
        params = lm.init(torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
        # S=40: past the reduced hybrid's window of 32; the xLSTM's 300 past
        # the plain version's 256-step chunk (and the kernel's 64)
        batch = TokenStream(cfg, seed=0).batch(
            2, 300 if cfg.family == "ssm" else 40)
        loss, grads = _loss_and_grads(lm, params, batch, "cuda")
        cpu_loss, cpu_grads = _loss_and_grads(lm, params, batch, "cpu")
        grad_err = max(float((grads[k].cpu() - g).abs().max()) /
                       max(1.0, float(g.abs().max()))
                       for k, g in cpu_grads.items())
        # AdamW from the CPU's gradients, on the card and on the CPU
        ocfg = AdamWConfig(warmup_steps=1, total_steps=10)
        new = {}
        for d in ("cuda", "cpu"):
            p = map_leaves(lambda t: t.detach().to(d).clone(), params)
            g = rebuild(p, [cpu_grads[k].to(d) for k in flatten(p)])
            p, st, _ = apply_updates(ocfg, p, g, init_state(ocfg, p))
            new[d] = [flatten(t) for t in (p, st["m"], st["v"])]
        upd_err = max(float((a[k].cpu() - b[k]).abs().max())
                      for a, b in zip(new["cuda"], new["cpu"]) for k in b)
        log(f"[train-reduced] {cfg.name}: loss card {loss:.6f} cpu "
            f"{cpu_loss:.6f} (tol {TRAIN_TOL}); worst gradient leaf "
            f"{grad_err:.3g} of max(1, max |g_cpu|) (tol {TRAIN_TOL}); "
            f"AdamW on the card vs the CPU {upd_err:.3g} (tol {UPDATE_TOL})")
        if not (abs(loss - cpu_loss) < TRAIN_TOL and grad_err <= TRAIN_TOL
                and upd_err <= UPDATE_TOL):
            raise SystemExit(f"{arch}: a training step on the card differs "
                             "from the CPU's")
        out[cfg.name] = {"loss_err": abs(loss - cpu_loss),
                         "grad_err": grad_err, "update_err": upd_err}
    # train() as test_training.py's test_loss_decreases, then serve it
    cfg = get_config("qwen1.5-4b").reduced()
    ocfg = AdamWConfig(lr=3e-3, grad_clip=10.0, total_steps=40,
                       warmup_steps=4, weight_decay=0.0)
    t0 = time.perf_counter()
    params, hist = train(cfg, steps=40, batch_size=4, seq_len=64,
                         log_every=0, remat=False, opt_cfg=ocfg,
                         device="cuda")
    secs = time.perf_counter() - t0
    log(f"[train-reduced] {cfg.name}: train() 40 steps in {secs:.1f} s, "
        f"loss {hist[0]:.4f} -> min of the last 10 {min(hist[-10:]):.4f}")
    if not min(hist[-10:]) < hist[0] - 0.15:
        raise SystemExit(f"{cfg.name}: the loss did not decrease: {hist}")
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=48,
                       decode_slots=2, device="cuda")
    eng.params = params                     # serve the trained weights
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                   6, 0.0)
    s = eng.run()
    if s.n_finished != 3:
        raise SystemExit(f"{cfg.name}: {s.n_finished}/3 requests of the "
                         "trained model finished")
    path = str(ROOT / "build" / "chip_smoke_ckpt.npz")
    ckpt.save(path, {"params": params}, step=40)
    template = {"params": LM(cfg).init(torch.Generator().manual_seed(9),
                                       device="cpu")}
    restored, step = ckpt.restore(path, template)
    same = step == 40 and all(
        torch.equal(t, params_t.cpu()) for t, params_t in
        zip(flatten(restored).values(), flatten({"params": params}).values()))
    log(f"[train-reduced] {cfg.name}: the trained model served 3/3; its "
        f"checkpoint from the card restores on the CPU bit for bit: {same}")
    if not same:
        raise SystemExit("the card's checkpoint does not restore on the CPU")
    report["train_reduced"] = {"steps": out, "loss_history": hist,
                               "train_s": secs}


def train_plan(cfg) -> dict:
    """Launches a training step with remat must make, from the model's
    structure: each attention layer inside a rematerialised group runs B1
    forward twice and backward once, each rec layer there B3 twice and its
    reverse scan once, each mLSTM layer B4 twice and its backward once; the
    hybrid's unrolled rest layers once each."""
    from repro_torch.models import rglru
    if cfg.family == "ssm":   # every group rematerialised
        mlstm = cfg.layer_kinds().count("mlstm")
        return {"mlstm_chunk": 2 * mlstm, "mlstm_chunk_bwd": mlstm}
    if cfg.family == "hybrid":
        G, pat, rest = rglru._plan(cfg)
        attn, rec = G * pat.count("attn"), G * pat.count("rec")
        attn_rest, rec_rest = rest.count("attn"), rest.count("rec")
    else:
        attn, rec, attn_rest, rec_rest = cfg.n_layers, 0, 0, 0
    plan = {"flash_attention": 2 * attn + attn_rest,
            "flash_attention_bwd": attn + attn_rest}
    if rec or rec_rest:
        plan.update(rglru_scan=2 * rec + rec_rest,
                    rglru_scan_bwd=rec + rec_rest)
    return plan


def _kernel_times(prof) -> tuple:
    """({device kernel: (launches, ms)}, {host span: ms}) of a finished
    torch.profiler run, summed from its raw events: the profiler's own
    function events take minutes to build for the million kernels of an
    xLSTM step, and these sums need none of them."""
    from torch.autograd import DeviceType
    by_kernel, spans = {}, {}
    for e in prof.profiler.kineto_results.events():
        ms = (e.end_ns() - e.start_ns()) / 1e6
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            n, total = by_kernel.get(e.name(), (0, 0.0))
            by_kernel[e.name()] = (n + 1, total + ms)
        elif e.device_type() == DeviceType.CPU and e.is_user_annotation():
            spans[e.name()] = spans.get(e.name(), 0.0) + ms
    return by_kernel, spans


def phase_train(report: dict, tag: str, arch: str,
                n_steps: int = TRAIN_STEPS) -> dict:
    """Train ``arch`` at its published shape on one card through
    ``train()``: bf16 parameters (the RG-LRU's lam fp32), AdamW with bf16
    moments, B=1, S=4096 from ``TokenStream(seed=0)``, remat on, ``n_steps``
    steps.
    Prints each step's wall, loss, grad norm and lr, the peak memory, and
    the device-busy share of step 2 by torch.profiler (and the host share
    of the xLSTM's sLSTM loop, span ``xlstm.slstm_steps``); fails on a
    non-finite loss or norm, on launch counts a step that differ from
    ``train_plan``, and on a bf16 B1 forward off the tensor-core kernel.
    Returns the launches of the whole run, for the table."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_bwd_cuda,
                                                        mlstm_chunk_cuda)
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import train
    cfg = get_config(arch)
    plan = train_plan(cfg)
    counters = {"flash_attention": (flash_attention_cuda, "launches_sm90"),
                "flash_attention_bwd": (flash_attention_bwd_cuda,
                                        "launches"),
                "rglru_scan": (rglru_scan_cuda, "launches"),
                "rglru_scan_bwd": (rglru_scan_bwd_cuda, "launches"),
                "mlstm_chunk": (mlstm_chunk_cuda, "launches"),
                "mlstm_chunk_bwd": (mlstm_chunk_bwd_cuda, "launches")}
    counters = {k: v for k, v in counters.items() if k in plan}
    gc.collect()                   # the last serve's engine
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in counters.values():
        fn.launches = 0
    flash_attention_cuda.launches_sm90 = 0
    total = {k: 0 for k in counters}
    steps = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def on_step(step, metrics):
        torch.cuda.synchronize()
        got = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        cuda_core = flash_attention_cuda.launches - \
            flash_attention_cuda.launches_sm90
        for fn, _ in counters.values():
            fn.launches = 0
        flash_attention_cuda.launches_sm90 = 0
        for k, n in got.items():
            total[k] += n
        row = {"step": step, "wall_s": metrics["step_s"],
               "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "launches": got,
               "cuda_core_flash": cuda_core}
        steps.append(row)
        log(f"[{tag}] step {step}: wall {row['wall_s']:.3f} s  loss "
            f"{row['loss']:.4f}  grad norm {row['grad_norm']:.4f}  lr "
            f"{row['lr']:.3e}  launches {got} (plan {plan}); CUDA-core B1 "
            f"forward {cuda_core}")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise SystemExit(f"{arch}: step {step} is not finite: {row}")
        if got != plan or cuda_core:
            raise SystemExit(f"{arch}: step {step} launched {got} and "
                             f"{cuda_core} CUDA-core B1 forwards, the plan "
                             f"is {plan} and none")
        if step == 1:              # profile step 2
            prof.start()
        elif step == 2:
            prof.stop()

    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers at the published "
        f"widths, bf16, AdamW moments in bf16, B=1 S={TRAIN_SEQ}, remat on, "
        f"{n_steps} steps; launches a step by the plan: {plan}")
    t0 = time.perf_counter()
    params, hist = train(
        cfg, steps=n_steps, batch_size=1, seq_len=TRAIN_SEQ, seed=0,
        param_dtype=torch.bfloat16,
        opt_cfg=AdamWConfig(state_dtype=torch.bfloat16,
                            total_steps=n_steps, warmup_steps=1),
        log_every=0, remat=True, device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    by_kernel, spans = _kernel_times(prof)
    device_ms = sum(ms for _, ms in by_kernel.values())
    wall_ms = 1e3 * steps[2]["wall_s"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    shares = {}
    for name, (_, ms) in by_kernel.items():
        kind = next((k for k, pat in DEVICE_KINDS
                     if re.search(pat, name, re.IGNORECASE)),
                    "other")
        shares[kind] = shares.get(kind, 0.0) + ms
    log(f"[{tag}] {n_params} parameters; {run_s:.1f} s in all (weights and "
        f"moments drawn included); peak memory {peak_gb:.2f} GB")
    log(f"[{tag}] step 2 under torch.profiler: device busy {device_ms:.1f} "
        f"ms of {wall_ms:.1f} ms wall = {device_ms / wall_ms:.3f}; top "
        "device kernels (launches, ms): " +
        "; ".join(f"{k[:60]}: {n}, {ms:.1f}" for k, (n, ms) in top))
    log(f"[{tag}] step 2's device ms by kind: " + ", ".join(
        f"{k} {ms:.1f}" for k, ms in sorted(shares.items(),
                                             key=lambda kv: -kv[1])))
    b4_bwd = {}   # B4's backward by pass: (launches, ms)
    for name, (n, ms) in by_kernel.items():
        m = re.search(B4_BWD_KERNELS, name)
        if m:
            b4_bwd[m.group()] = (n, ms)
    if b4_bwd:
        b4_ms = sum(ms for _, ms in b4_bwd.values())
        log(f"[{tag}] step 2: B4 backward {b4_ms:.2f} ms of device time; "
            f"by pass (launches, ms): {b4_bwd}")
    log(f"[{tag}] step 2: {sum(n for n, _ in by_kernel.values())} device "
        "kernels" + "".join(f"; span {k} {ms:.1f} ms host = "
                            f"{ms / wall_ms:.3f} of the wall"
                            for k, ms in spans.items()))
    report[tag] = {"arch": arch, "n_layers": cfg.n_layers,
                   "parameters": n_params, "seq_len": TRAIN_SEQ,
                   "steps": steps, "plan": plan, "run_s": run_s,
                   "peak_gb": peak_gb, "busy_ms": device_ms,
                   "profiled_wall_ms": wall_ms,
                   "busy_share": device_ms / wall_ms,
                   "device_ms_by_kind": shares, "spans_host_ms": spans,
                   "b4_backward_by_pass": b4_bwd,
                   "top_kernels": {k: v for k, v in top}}
    return total


def _prompt_batch(eng, prompt) -> dict:
    """A prefill batch of one prompt on the card, over the engine's stub
    frames for the encoder-decoder."""
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.long,
                                       device="cuda")[None]}
    if eng.cfg.is_encoder_decoder:
        batch["enc_feats"] = eng.stub_frames()
    return batch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_cpu(v) for v in tree)
    return tree.cpu()


# ---------------------------------------------------------------------------
# phases 4 to 4e
# ---------------------------------------------------------------------------

def phase_serve(report: dict, tag: str, arch: str, lengths, max_len: int,
                kernels: dict, n_layers=None) -> dict:
    """Serve 12 requests (64 new tokens each) through ``DisaggEngine`` at
    the published shape in bf16 (cut to ``n_layers`` decoder layers where
    given, and said so); ``kernels`` name -> (wrapper, name of its launch
    counter), whose counters are set to 0 just before the run and read
    just after it. The bf16 serve must not launch the CUDA-core attention
    kernels (each wrapper's total less its tensor-core launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.engine import DisaggEngine
    cfg = get_config(arch)
    if n_layers is not None:
        log(f"[{tag}] {cfg.name}: depth cut to {n_layers} of its "
            f"{cfg.n_layers} layers, every width as published")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gc.collect()                   # the previous serve's engine, if any
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=max_len,
                       decode_slots=8, ctrl_cfg=ControllerConfig(), seed=0,
                       device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(eng.params))
    rng = np.random.default_rng(0)
    for n in lengths:
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                   64, 0.0)
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "launches_sm90"):
            fn.launches_sm90 = 0
    t0 = time.perf_counter()
    s = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in kernels.items()}
    cuda_core = {name: fn.launches - fn.launches_sm90
                 for name, (fn, _) in kernels.items()
                 if hasattr(fn, "launches_sm90")}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = sum(len(r.generated) for r in eng.finished)
    pre = np.asarray(eng.prefill_walls) * 1e3
    dec = np.asarray(eng.decode_walls) * 1e3
    log(f"[{tag}] {cfg.name} bf16 {cfg.n_layers} layers, max_len {max_len}, "
        f"prompts {sorted(int(n) for n in lengths)}: {s.row()}")
    log(f"[{tag}] {s.n_finished}/{s.n_total} finished, {n_tok} tokens in "
        f"{wall:.2f} s wall = {n_tok / wall:.1f} tok/s; {n_params} "
        f"parameters, weight init {init_s:.1f} s; peak memory "
        f"{peak_gb:.2f} GB")
    log(f"[{tag}] prefill step ms: median {np.median(pre):.2f} max "
        f"{pre.max():.2f} (n={len(pre)}); decode step ms: median "
        f"{np.median(dec):.2f} p90 {np.percentile(dec, 90):.2f} "
        f"(n={len(dec)})")
    log(f"[{tag}] launches on the main path: {launches}; CUDA-core "
        f"attention kernels: {cuda_core}")
    if s.n_finished != 12 or any(len(r.generated) != 64
                                 for r in eng.finished):
        raise SystemExit(f"{arch}: not every request finished with 64 tokens")
    if min(launches.values()) <= 0:
        raise SystemExit(f"{arch}: a kernel of the main path never ran: "
                         f"{launches}")
    if any(cuda_core.values()):
        raise SystemExit(f"{arch}: bf16 attention left the tensor-core "
                         f"kernels: {cuda_core}")
    if not all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.generated):
        raise SystemExit(f"{arch}: a generated token is outside the "
                         "vocabulary")
    # the full model's logits are finite and of the expected shape, after
    # the longest prompt (past the window, where the model has one)
    prompt = max((r.tokens for r in eng.finished), key=len)
    cache = eng.lm.init_cache(1, max_len, dtype=torch.bfloat16, device="cuda")
    lg, cache = eng.lm.prefill(eng.params, _prompt_batch(eng, prompt), cache)
    lg2, _ = eng.lm.decode_step(eng.params, torch.argmax(lg, -1), cache)
    if lg2.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all() or \
            not torch.isfinite(lg2).all():
        raise SystemExit(f"{arch}: full-width logits are not finite")
    report[tag] = {
        "arch": arch, "n_layers": cfg.n_layers, "parameters": n_params,
        "decode_steps": len(dec), "prompt_lengths": [int(n) for n in lengths],
        "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
        "init_s": init_s, "peak_gb": peak_gb, "prefill_ms": pre.tolist(),
        "decode_ms": dec.tolist(), "launches": launches, "summary": s.row()}
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["--ab-mlstm"] and len(sys.argv) == 3:
        return ab_mlstm(Path(sys.argv[2]))
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--ab-mlstm DIR]", file=sys.stderr)
        return 2
    report: dict = {}
    smi = phase_environment(report)
    secs = {}
    t0 = time.perf_counter()
    main_cases = phase_kernels(report)
    secs["2 kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_reduced(report)
    phase_train_reduced(report)
    secs["3 reduced"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_cuda
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    attention = {"flash_attention": (flash_attention_cuda, "launches_sm90"),
                 "decode_attention": (decode_attention_cuda, "launches_sm90")}
    llama_lengths = np.random.default_rng(0).integers(128, 1536, 12)
    llama_lengths += llama_lengths % 128 == 0      # never a tile multiple
    by_path = {"llama3.1-8b": phase_serve(report, "serve", "llama3.1-8b",
                                          llama_lengths, 2048, attention)}
    by_path["recurrentgemma-2b"] = phase_serve(
        report, "serve-rg", "recurrentgemma-2b", _rg_prompt_lengths(), 4096,
        {**attention, "rglru_scan": (rglru_scan_cuda, "launches")})
    lengths = np.random.default_rng(0).integers(128, 2048, 12)
    lengths += lengths % 64 == 0                   # never a multiple of 64
    by_path["xlstm-350m"] = phase_serve(
        report, "serve-xlstm", "xlstm-350m", lengths, 4096,
        {"mlstm_chunk": (mlstm_chunk_cuda, "launches")})
    for tag, arch in (("serve-starcoder2", "starcoder2-15b"),
                      ("serve-chameleon", "chameleon-34b")):
        by_path[arch] = phase_serve(report, tag, arch, llama_lengths, 2048,
                                    attention)
    # Phi-3.5-MoE's 32 layers take 83.7 GB in bf16: 28 of them fit the card
    # beside the caches
    by_path[PHI] = phase_serve(report, "serve-phi", PHI, llama_lengths, 2048,
                               attention, n_layers=PHI_LAYERS)
    # Whisper: prompts of at most n_text_ctx // 2 - 1 = 223 tokens (what its
    # decoding keeps of a prompt), its 448-token context
    whisper_lengths = np.random.default_rng(0).integers(4, 224, 12)
    by_path[WHISPER] = phase_serve(report, "serve-whisper", WHISPER,
                                   whisper_lengths, 448, attention)
    secs["4 serves"] = time.perf_counter() - t0
    # phase 5: training at the published widths
    t0 = time.perf_counter()
    for arch in ("llama3.1-8b", "recurrentgemma-2b"):
        by_path[f"train-{arch}"] = phase_train(report, f"train-{arch}", arch)
    by_path["train-xlstm-350m"] = phase_train(
        report, "train-xlstm-350m", "xlstm-350m", n_steps=XLSTM_TRAIN_STEPS)
    secs["5 train"] = time.perf_counter() - t0
    log(f"[time] seconds by phase: "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    report["phase_s"] = secs
    table = {"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "path": "llama3.1-8b"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_rg", "path": "recurrentgemma-2b"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_starcoder2", "path": "starcoder2-15b"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_chameleon", "path": "chameleon-34b"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "path": PHI},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_whisper_encoder", "path": WHISPER},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_whisper_cross", "path": WHISPER},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_whisper", "path": WHISPER},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:54"},
        {"name": "mlstm_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:76"},
        # the backwards: the gradients of the JAX functions that jax.grad
        # differentiates where the port runs B1 and B3
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "grad_of": "src/repro/models/layers.py:105 gqa_attention"},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:54",
         "grad_of": "src/repro/models/rglru.py:114 associative_scan"},
        {"name": "mlstm_chunk_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_chunk_bwd.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:76",
         "grad_of": "src/repro/models/xlstm.py:83 _mlstm_chunk_scan"},
    ]}
    for row in table["kernels"]:
        # a row's case: the kernel's main case, or the one it names; B2 has
        # a row for each served model's head shape, with that serve's
        # launches
        c = main_cases[row.pop("case", row["name"])]
        path = row.pop("path", None)
        log(f"[table] {row['name']}: {c['dtype']} {c['shape']}")
        # launches: the sum over the serves whose path runs the kernel
        paths = {p: n[row["name"]] for p, n in by_path.items()
                 if row["name"] in n and path in (None, p)}
        row.update(launches=sum(paths.values()), launches_by_path=paths,
                   max_abs_err=c["err"], ms=c["ms"], plain_ms=c["plain_ms"],
                   bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                   library_ms=c["library_ms"], shape=c["shape"])
        if "library_per_slot_ms" in c:   # B calls, so not the library call
            row["library_per_slot_ms"] = c["library_per_slot_ms"]
        if c.get("passes"):   # B4's launches, by torch.profiler
            row["passes_ms"] = {k: ms for k, (_, ms) in c["passes"].items()}
        if "elementwise_ms" in c:   # B3's backward: the scan and the rest
            row.update(reverse_scan_ms=c["reverse_scan_ms"],
                       elementwise_ms=c["elementwise_ms"])
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(
        json.dumps(report, indent=1))
    log(smi)
    log(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
