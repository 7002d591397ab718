#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100. It
imports nothing from JAX or the JAX package ``repro``. Phases, each printing
its own lines; any failure exits non-zero without the result line:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, and the build of the six CUDA libraries from ``csrc/``
   (one ``nvcc`` each, all at once, timed; their ``ptxas`` lines), and the
   count of tensor-core instructions in the SASS of the tensor-core
   kernels (``cuobjdump --dump-sass``): ``HGMMA`` in the bf16 flash
   kernel's, ``HMMA`` in the bf16 decode kernel's and in the mLSTM's split
   TF32 passes (none fails the run);
2. each kernel against its plain PyTorch version on the card, with its time
   (CUDA events, median, the host queued ahead of the card), the plain
   version's time, the least time the card could take (bytes over 3.35 TB/s
   or flops over 989 TFLOP/s bf16 / 67 TFLOP/s fp32) and, for attention, as
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
   bf16 decode kernel takes) and at chameleon-34b's (64 over 8); the
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
   count, and what one call allocates past its outputs);
3. reduced llama3.1-8b, qwen1.5-4b, starcoder2-15b, chameleon-34b,
   granite-3-8b, recurrentgemma-2b and xlstm-350m in fp32 on the card:
   prefill and decode logits and ``LM.loss`` against the same model on the
   CPU (plain versions, 1e-4; the hybrid decodes past its window of 32, the
   xLSTM prefills 300 tokens, past the plain version's 256-step chunk), and
   the engine's tokens for three ragged prompts against an isolated
   prefill + decode of each;
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
   heads; its bf16 weights take 68.6 GB of the card), on Llama's plan.

Each serve starts with the previous one's engine freed and the allocator's
cache emptied, and prints its peak device memory.

The last two lines are the kernel table as JSON and
``{"ok": true, "device": {...}}``. A longer report goes to
``build/chip_smoke_report.json``.
"""
from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12
FP32_TOL = 2e-5
SCAN_TOL = 1e-4
MLSTM_TOL, MLSTM_STATE_TOL = 2e-4, 1e-5
TOL_TEXT = {torch.float32: "2e-5", torch.bfloat16: "min(3e-2, 1e-3+1e-2|plain|)"}
LLAMA_HEADS = (32, 8, 128)         # (query heads, KV heads, head_dim)
RG_HEADS = (10, 1, 256)            # recurrentgemma-2b
STARCODER2_HEADS = (48, 4, 128)    # starcoder2-15b, G = 12
CHAMELEON_HEADS = (64, 8, 128)     # chameleon-34b
LLAMA405B_HEADS = (128, 8, 128)    # llama3-405b, G = 16


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


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
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
                         ("mlstm_chunk", "HMMA")):
        n = count_sass(build.library_path(name), opcode)
        log(f"[env] {name}: {n} {opcode} instructions in its SASS")
        if n == 0:
            raise SystemExit(f"the tensor-core kernel of {name} has no "
                             "tensor-core instruction")
        tensor_core[name] = n
    report["env"] = {"nvidia_smi": smi, "torch": torch.__version__,
                     "cuda": torch.version.cuda, "build_s": secs,
                     "tensor_core_instructions": tensor_core}
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _flash_case(S: int, window, dtype, gen, heads) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    HQ, KV, HD = heads
    q = torch.randn((1, S, HQ, HD), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, S, KV, HD), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, S, KV, HD), generator=gen, device="cuda").to(dtype)

    def kern():
        return flash_attention_cuda(q, k, v, causal=True, window=window)

    def plain():
        return flash_attention_ref(q, k, v, causal=True, window=window)
    sm90 = flash_attention_cuda.launches_sm90
    out, ref = kern(), plain()
    route = "sm90 wgmma" if flash_attention_cuda.launches_sm90 > sm90 else \
        "cuda-core fp32"
    err, ok = float((out.float() - ref.float()).abs().max()), close(out, ref)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def causal_library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def library():
        if mask is None:
            return causal_library()
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    qpos = np.arange(S)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S)
    pairs = float(np.sum(qpos - lo + 1))
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(n_bytes, 4.0 * pairs * HD * HQ, dtype)
    return {"shape": f"B=1 S={S} Hq={HQ} K={KV} hd={HD} causal "
                     f"window={window}", "dtype": str(dtype), "err": err,
            "ok": ok, "route": route, "ms": cuda_ms(kern, 20),
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
    b_ms, b_by = bound_ms(n_bytes, flops, torch.float32)
    shape = (f"B={B} S={S} nh={nh} hd={hd} "
             f"{'given' if given else 'fresh'} state")
    # the passes of one call: planned by the wrapper, and as profiled; each
    # pass must show as one launch of its own kernel
    p = plan(B, S, nh, hd)
    kernels = _device_kernels(kern)
    passes = {re.search(r"mlstm_\w+", k).group(): v
              for k, v in kernels.items() if "mlstm_" in k}
    if len(passes) != p["launches"] or \
            any(n != 1 for n, _ in passes.values()):
        raise RuntimeError(
            f"mlstm_chunk {shape}: the profiler saw (launches, device ms) "
            f"{passes} of mlstm_ kernels in one call, not {p['launches']} "
            "passes launched once each")
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
        f"(launches, device ms): {passes}, "
        f"{sum(n for n, _ in kernels.values())} device kernels in all; "
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
    # xlstm-350m's prefill (4 heads of 512), then ragged chunks from a state
    for B, S, nh, hd, given in ((1, 2048, 4, 512, False),
                                (2, 300, 2, 256, True)):
        cases["mlstm_chunk"].append(_mlstm_case(B, S, nh, hd, given, gen))
    main["mlstm_chunk"] = cases["mlstm_chunk"][0]
    tols = {"rglru_scan": SCAN_TOL,
            "mlstm_chunk": f"{MLSTM_TOL}, state {MLSTM_STATE_TOL}"}
    failed = []
    for name, rows in cases.items():
        for c in rows:
            dtype = getattr(torch, c["dtype"].split(".")[1])
            tol = tols.get(name, TOL_TEXT[dtype])
            lib = "none" if c["library_ms"] is None else \
                f"{c['library_ms']:.4f} ms"
            ok = c["ok"]
            state = f" state {c['state_err']:.3g}" if "state_err" in c \
                else ""
            if "plain_fp32_err" in c:
                state += (f" against the plain version in fp64 (the plain "
                          f"version in fp32: {c['plain_fp32_err']:.3g})")
            route = f" [{c['route']}]" if "route" in c else ""
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
             "granite-3-8b": dense,
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
        errs = []
        caches = {d: lm.init_cache(3, max_len, dtype=torch.float32, device=d)
                  for d in ("cuda", "cpu")}
        lg = {}
        for d, p in (("cuda", params), ("cpu", params_cpu)):
            lg[d], caches[d] = lm.prefill(
                p, {"tokens": toks[:, :n_pre].to(d)}, caches[d])
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
        loss = {d: float(lm.loss(p, {"tokens": toks.to(d),
                                     "labels": labels.to(d)}))
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
            lg1, cache = lm.prefill(
                eng.params, {"tokens": torch.as_tensor(
                    req.tokens, dtype=torch.long, device="cuda")[None]}, cache)
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
                kernels: dict) -> dict:
    """Serve 12 requests (64 new tokens each) through ``DisaggEngine`` at
    the published shape in bf16; ``kernels`` name -> (wrapper, name of its
    launch counter), whose counters are set to 0 just before the run and
    read just after it. The bf16 serve must not launch the CUDA-core
    attention kernels (each wrapper's total less its tensor-core
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.serving.engine import DisaggEngine
    cfg = get_config(arch)
    gc.collect()                   # the previous serve's engine, if any
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = DisaggEngine(cfg, n_prefill=1, n_decode=1, max_len=max_len,
                       decode_slots=8, ctrl_cfg=ControllerConfig(), seed=0,
                       device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
        f"{wall:.2f} s wall = {n_tok / wall:.1f} tok/s; weight init "
        f"{init_s:.1f} s; peak memory {peak_gb:.2f} GB")
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
    lg, cache = eng.lm.prefill(eng.params, {"tokens": torch.as_tensor(
        prompt, device="cuda")[None]}, cache)
    lg2, _ = eng.lm.decode_step(eng.params, torch.argmax(lg, -1), cache)
    if lg2.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all() or \
            not torch.isfinite(lg2).all():
        raise SystemExit(f"{arch}: full-width logits are not finite")
    report[tag] = {
        "arch": arch, "prompt_lengths": [int(n) for n in lengths],
        "tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
        "init_s": init_s, "peak_gb": peak_gb, "prefill_ms": pre.tolist(),
        "decode_ms": dec.tolist(), "launches": launches, "summary": s.row()}
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    report: dict = {}
    smi = phase_environment(report)
    main_cases = phase_kernels(report)
    phase_reduced(report)
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
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:54"},
        {"name": "mlstm_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:76"},
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
        if c.get("passes"):   # B4's three launches, by torch.profiler
            row["passes_ms"] = {k: ms for k, (_, ms) in c["passes"].items()}
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
