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
   (one launch of its own kernel in ``rglru_scan.cu``, scanning from the
   sequence's end) at B=1 S=4096 W=2560, beside the route it replaced
   (the forward kernel on flipped inputs, then torch's products) timed in
   turns on the same inputs, with the kernels one call launches (by
   ``torch.profiler``; the phase fails unless that is one launch of the
   backward kernel and nothing else), its registers and spills
   (``ptxas``), its workspace bytes and its bound at 20 bytes an element;
   B4's (``mlstm_chunk_bwd.cu``, four launches, three of them on
   ``mma.sync`` in split TF32) against the plain backward evaluated in
   fp64 at xLSTM-350M's training shape (B=1 S=4096 nh=4 hd=512, fresh
   state; the forward there too) and a ragged multi-chunk case from a
   given state, with its passes' launches and times by ``torch.profiler``
   beside ``plan_bwd``, its workspace bytes, each pass's registers and
   spills (``ptxas``) and two calls compared bit for bit; B2 writing its
   log-sum-exp (``lse=``) at phase 6's shape (B=4 over 4096 rows) and at
   Llama's and RecurrentGemma's decode shapes, in bf16 and fp32, some
   positions negative: the lse within 1e-5 max(1, |lse|) of the plain
   version's (-inf where pos < 0), the output bitwise equal to the call
   without it, both calls timed, and beside them, as the library time,
   ``aten._scaled_dot_product_efficient_attention`` with
   ``compute_log_sumexp`` (the same dense mask as a bias, K and V repeated
   to the query heads), its lse held against the kernel's; B1 and B2 at
   phase 6b's shapes (a rank's
   16 query heads over 4 KV heads: S=2048; B=4 over 1024 rows);
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

6. the multi-device layers (``models/sharding.py``, ``launch/mesh.py``,
   ``launch/shardspecs.py``, the sharded branches of ``models/layers.py``)
   as two ranks on the one card: NCCL takes one rank a card, so two
   processes spawned with ``torch.multiprocessing`` share cuda:0 in a
   ``gloo`` group (rendezvous a file under ``build/``; the all-reduces
   stage their CUDA tensors through the host), each holding
   Llama-3.1-8B at full width and depth in bf16 from the same seeded
   generator, on a (1, 2) mesh. 6a: the KV sequence over "model", weights
   whole: B=4, max_len 8192 (4096 cache rows a rank), prompts of 4088
   tokens, 16 decode steps (positions 4088-4103: the first 8 write rank
   0's rows, the last 8 rank 1's), B2 writing its lse on each rank's rows
   and the ranks combining (``dist_decode_attention``); before it, one
   layer's ``dist_decode_attention`` at that shape against B2 unsharded
   over the whole cache, within 4 bf16 steps of max |unsharded|, at
   positions where rank 1 admits none, 8, 2048 and all of its rows, with
   a control (rank 1's weight set to 0) that must miss by more wherever
   rank 1 admits 8 rows or more, and each rank's cache rows against the
   unsharded write. 6b: heads and
   d_ff over "model" with ``tp_bf16_ar``, each rank its ``local_params``
   (16 query heads over 4 KV heads, d_ff 7168, 64128 of the vocabulary's
   rows of embed and columns of unembed): ``forward_train`` at B=1 S=2048
   without a gradient (its vocabulary blocks gathered), then a prefill of
   B=4 prompts of 1000 tokens and 16 decode steps. Rank 0 first runs the
   same tokens unsharded, greedily; both ranks are fed its tokens and
   hold each step's logits against its (max |dlogit| / max |logit| within
   3e-2, the argmax equal wherever the reference's top-2 gap exceeds
   that). Each rank prints its launches (B2 with the lse: 32 x 16 a rank
   in 6a, all on the sm90 kernel), its all-reduces (count, bytes, host
   seconds), its peak memory and its seconds. A rank that fails, or a
   phase past 600 s, fails the run.

7. the steps of ``launch/steps.py`` at Llama-3.1-8B's full width,
   with seeded weights, bf16. 7a, one rank (a ``gloo`` world of one, mesh
   (1, 1)), all 32 layers, through what the production serve launcher
   calls (``build_step``, ``init_params``, ``launch.serve``'s batch set-up
   and ``run_steps``): prefill_32k at B=1 (cut from 32; B1 at S=32768
   into a 32768-row cache of 4.29 GB), then decode_32k at B=8 (cut from
   128; the prefill's rows copied into each slot, position 32752, 16
   serve steps: B2 over 32753-32768 rows a slot, 34.4 GB of cache), the
   first step's tokens equal to ``LM.decode_step``'s on the same cache,
   B1's 32 and B2's 512 launches all on the sm90 kernels. 7b, two
   ``gloo`` ranks sharing the card: ``build_train_step`` under
   ``standard_rules`` on mesh (1, 2), all 32 layers, the heads, d_ff and
   the vocabulary cut (``embed``/``unembed`` a rank's 64128 ids; the
   loss's log-sum-exp over the two blocks), B=1, S=4096, remat, 2 steps,
   after rank 0 ran the same steps unsharded on its one-rank pool (and
   freed the card), both at the schedule's peak rate from the first step;
   each step's loss and grad norm, and after step 2 every parameter
   block's change from its initial value and AdamW's m and v leaf by
   leaf, within ``TRAIN_TP_*`` of the unsharded step's; B1 launches
   forward 2 (all sm90) and backward 1 a layer a step; each rank's peak
   memory, parameters, step walls and all-reduces (count, bytes, host
   seconds); the host's ``MemAvailable`` before it. 7c, the same two
   processes: mesh (2, 1) cut by
   ``split_disagg_mesh(mesh, 1)`` (pools [[0]] and [[1]], as the JAX
   split), rank 0 prefilling B=1 S=4096 in the prefill pool, rank 1
   serving B=8 over 4096 rows for 16 steps in the decode pool, each
   against the unsharded model's first tokens, its launches counted
   around its steps alone (B1 32 and B2 512, all sm90). 7d, the same two
   processes: the multi-pod batch, ``build_train_step`` on the (2, 1, 1)
   mesh over ("pod", "data", "model"), train_4k's batch cut to 2, one row
   a rank over the flattened ("pod", "data"), 8 of the 32 layers (two
   whole replicas share the card), 2 steps held as 7b's against rank 0's
   unsharded step on both rows; the all-reduces over the flattened
   group. Phase 2 holds B1 at S=32768 (the plain version in blocks of 1024
   query rows) and B2 over 32768 rows at these shapes. A rank that fails,
   or phase 7 past 600 s, fails the run.

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

    python3 chip_smoke.py --ab-scan DIR

likewise holds B3's forward built from DIR against this checkout's: its
registers, its outputs against the plain version and its times in turns
(``ab_scan``).

    python3 chip_smoke.py --ab-decode DIR

likewise holds B2's bf16 kernel built from DIR against this checkout's:
the ``HMMA`` count of each library's SASS, outputs bit for
bit at phase 2's bf16 decode shapes and times in turns (``ab_decode``).

    python3 chip_smoke.py --profile-check N

runs none of the phases either: it profiles B1's fp32 backward and B3's
backward N times each as phase 2 profiles them, with and without the
host's margin around the call, and counts the sessions that recorded no
device kernel or the wrong ones (``profile_check``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
PROFILE_MARGIN_S = 0.02   # host idle around a profiled call (_device_kernels)
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
B3_KERNELS = r"rglru_scan(?:_bwd)?_kernel"
DEVICE_KINDS = (("B4 backward", r"mlstm_bwd_"),
                ("B4", r"mlstm_(state|weight|output)_kernel"),
                ("B1 backward", B1_BWD_KERNELS),
                ("B1 forward", r"flash_fwd"),
                ("B3 backward", r"rglru_scan_bwd"),
                ("B3", r"rglru"),
                ("GEMM", r"nvjet|gemm|cutlass|xmma|sm90_"),
                ("reductions", r"reduce|softmax|logsumexp|norm"),
                ("elementwise and copies", r"elementwise|copy|fill|cat"),
                ("indexing", r"index|scatter|gather"))
LLAMA_HEADS = (32, 8, 128)         # (query heads, KV heads, head_dim)
LLAMA_TP_HEADS = (16, 4, 128)      # a rank's of llama3.1-8b over 2 (6b)
RG_HEADS = (10, 1, 256)            # recurrentgemma-2b
STARCODER2_HEADS = (48, 4, 128)    # starcoder2-15b, G = 12
CHAMELEON_HEADS = (64, 8, 128)     # chameleon-34b
LLAMA405B_HEADS = (128, 8, 128)    # llama3-405b, G = 16
WHISPER_HEADS = (20, 20, 64)       # whisper-large-v3, G = 1
PHI, PHI_LAYERS = "phi3.5-moe-42b-a6.6b", 28   # served at 28 of 32 layers
WHISPER = "whisper-large-v3"
# phase 6: two gloo ranks on the one card; each sharded run's logits
# against rank 0's unsharded model within DIST_TOL of max |reference|,
# the argmax equal wherever the reference's top-2 gap exceeds that
DIST_WORLD, DIST_TIMEOUT_S, DIST_TOL = 2, 600, 3e-2
# 6a's layer check: dist_decode_attention against unsharded B2, in bf16
# steps of max |unsharded| (each side rounds to bf16; the combine adds the
# ranks' rounded outputs)
DIST_LAYER_STEPS = 4
DIST_KV = {"batch": 4, "max_len": 8192, "prompt": 4088, "steps": 16}
DIST_TP = {"train_seq": 2048, "batch": 4, "max_len": 1024, "prompt": 1000,
           "steps": 16}
# phase 7: the steps of launch/steps.py at Llama-3.1-8B's full width. 7a:
# prefill_32k's 32 sequences cut to 1, decode_32k's 128 to 8 (their 34.4 GB
# of KV cache beside 16.06 GB of weights); 7b: all 32 layers, the
# vocabulary cut with the layers (a rank's blocks, AdamW moments,
# gradients and logits ~36 GB); 7c: the pools; 7d: 8 of the 32 layers, as
# two whole replicas of ~28 GB each (data parallel over the flattened
# ("pod", "data")) must share the one card
STEPS_PREFILL_BATCH = 1
LONG_SEQ = 32768                # prefill_32k's and decode_32k's rows
STEPS_DECODE_BATCH = 8
STEPS_DECODE_POS = 32752        # the 16 steps write the cache's last rows
STEPS_DECODE_STEPS = 16
STEPS_TRAIN_LAYERS = 32
STEPS_TRAIN_STEPS = 2
STEPS_POD_LAYERS = 8
STEPS_POD_BATCH = 2
STEPS_POOL_SEQ = 4096
STEPS_WORLD = 2
STEPS_TIMEOUT_S = 600
# 7b against the unsharded step (bf16; the sharded layers all-reduce fp32
# partial products and cast once): the loss and the grad norm relative to
# the reference's; after the steps, each parameter leaf's change from its
# initial value (in fp32) within a share of the reference's change (the
# norm of the difference over the norm of the reference's), and AdamW's m
# and v within a share of the leaf's max |ref|. The steps run at the
# schedule's peak rate from the first (a warm-up of one step): AdamW's
# first update moves each value with a gradient by about lr, several bf16
# steps of a weight at the init's scale, so a missing or wrong update shows
TRAIN_TP_WARMUP = 1
TRAIN_TP_LOSS_TOL = 5e-3
TRAIN_TP_GNORM_TOL = 5e-2
TRAIN_TP_DELTA_TOL = 0.5
TRAIN_TP_MOMENT_TOL = 0.1


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
                     ptxas_registers("mlstm_chunk_bwd", B4_BWD_KERNELS),
                     "b3_registers": ptxas_registers("rglru_scan",
                                                     B3_KERNELS)}
    log(f"[env] rglru_scan (registers, spill store bytes) by ptxas: "
        f"{report['env']['b3_registers']}")
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _flash_plain(q, k, v, causal: bool, window, blocks, return_lse=False):
    """B1's plain version, in ``blocks`` query rows at a time where given
    (causal, no window: each block over the keys up to its last row): at
    S=32768 the whole would need 137 GB of fp32 scores."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    if blocks is None:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    assert causal and window is None
    parts = [flash_attention_ref(q[:, i:i + blocks], k[:, :i + blocks],
                                 v[:, :i + blocks], causal=True,
                                 q_pos_offset=i, return_lse=True)
             for i in range(0, q.shape[1], blocks)]
    out = torch.cat([o for o, _ in parts], 1)
    if not return_lse:
        return out
    return out, torch.cat([lse for _, lse in parts], 2)


def _flash_case(S: int, window, dtype, gen, heads, causal: bool = True,
                B: int = 1, Sq=None, plain_blocks=None) -> dict:
    """B1 at B x (Sq query rows over S keys; Sq = S unless given), causal
    (queries at the first positions) or not; the plain version in
    ``plain_blocks`` query rows at a time where given."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
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
        return _flash_plain(q, k, v, causal, window, plain_blocks)
    sm90 = flash_attention_cuda.launches_sm90
    out, ref = kern(), plain()
    route = "sm90 wgmma" if flash_attention_cuda.launches_sm90 > sm90 else \
        "cuda-core fp32"
    err, ok = float((out.float() - ref.float()).abs().max()), close(out, ref)
    # L, which the backward reads: against the plain L, and the output
    # with it bit for bit the output without it
    same = bool(torch.equal(kern_lse(), out))
    plain_lse = _flash_plain(q, k, v, causal, window, plain_blocks,
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


def _decode_lse_case(pos, window, dtype, gen, heads, Sc=2048, B=8) -> dict:
    """B2 writing its log-sum-exp (``lse=``), as flash-decoding across
    ranks calls it: the lse against the plain version's (within 1e-5
    max(1, |lse|), -inf where pos < 0), the output bitwise equal to the
    call without it, and both calls timed. The library time is that of
    ``aten._scaled_dot_product_efficient_attention`` with
    ``compute_log_sumexp``, which returns the output and its natural-log
    lse, given the same dense mask of admitted rows as a float bias and K
    and V repeated to the Hq heads (the repeat made once, outside the
    timing); its lse is held against the kernel's and the difference
    logged."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    HQ, KV, HD = heads
    q = torch.randn((B, 1, HQ, HD), generator=gen, device="cuda").to(dtype)
    kc = torch.randn((B, Sc, KV, HD), generator=gen, device="cuda").to(dtype)
    vc = torch.randn((B, Sc, KV, HD), generator=gen, device="cuda").to(dtype)
    posd = torch.tensor(pos, dtype=torch.int32, device="cuda")
    lse = torch.full((B, HQ), float("nan"), device="cuda")

    def kern():
        return decode_attention_cuda(q, kc, vc, posd)

    def kern_lse():
        return decode_attention_cuda(q, kc, vc, posd, lse=lse)

    def plain():
        return decode_attention_ref(q, kc, vc, posd, window=window,
                                    return_lse=True)
    sm90 = decode_attention_cuda.launches_sm90
    out = kern_lse()
    route = "sm90 mma.sync" if decode_attention_cuda.launches_sm90 > sm90 \
        else "cuda-core fp32"
    same = bool(torch.equal(out, kern()))
    ref, ref_lse = plain()
    empty = (posd < 0)[:, None].expand(B, HQ)
    lse_err = float(((lse - ref_lse)[~empty].abs() /
                     ref_lse[~empty].abs().clamp(min=1.0)).max())
    neg_inf = bool(torch.isneginf(lse[empty]).all())
    live = ~(posd < 0)
    err = float((out[live].float() - ref[live].float()).abs().max())
    ok = same and neg_inf and lse_err <= LSE_TOL and close(out[live],
                                                           ref[live])
    rows = np.clip(np.asarray(pos) + 1, 0, Sc)
    elt = q.element_size()
    n_bytes = elt * (2 * q.numel() + 2 * float(rows.sum()) * KV * HD) + \
        4 * B + 4 * B * HQ
    b_ms, b_by = bound_ms(n_bytes, 4.0 * float(rows.sum()) * HQ * HD, dtype)
    ms, ms_lse = cuda_ms(kern, 50), cuda_ms(kern_lse, 50)
    # the library: one call that returns the output and its lse
    bias = torch.zeros((B, HQ, 1, Sc), dtype=dtype, device="cuda")
    bias.masked_fill_(torch.arange(Sc, device="cuda") >= torch.as_tensor(
        rows, device="cuda")[:, None, None, None], float("-inf"))
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (c.transpose(1, 2).repeat_interleave(HQ // KV, dim=1)
              for c in (kc, vc))

    def library():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True)
    lib_lse = library()[1][:, :, 0]
    lib_lse_err = float(((lib_lse - lse)[~empty].abs() /
                         lse[~empty].abs().clamp(min=1.0)).max())
    lib_ms = cuda_ms(library, 50)
    shape = (f"B={B} Sc={Sc} Hq={HQ} K={KV} hd={HD} pos={list(pos)} "
             f"window={window} lse")
    log(f"[kernel] decode_attention_lse [{route}] {dtype} {shape}: lse "
        f"within {lse_err:.3g} of max(1, |plain lse|) (tol {LSE_TOL}), -inf "
        f"where pos < 0: {neg_inf}; output with the lse "
        f"{'bitwise equal to' if same else 'DIFFERENT from'} the output "
        f"without; {ms:.4f} ms without the lse, {ms_lse:.4f} ms with; "
        f"the efficient-attention call {lib_ms:.4f} ms, its lse within "
        f"{lib_lse_err:.3g} of the kernel's")
    return {"shape": shape, "dtype": str(dtype), "err": err, "ok": ok,
            "route": route, "ms": ms_lse, "ms_without_lse": ms,
            "lse_err": lse_err, "lse_bitwise_same_output": same,
            "plain_ms": cuda_ms(plain, 10), "library_ms": lib_ms,
            "library_lse_err": lib_lse_err, "bound_ms": b_ms,
            "bound_by": b_by}


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
        ws_bytes = 4 * _entry()[0].rglru_scan_workspace_floats(B, S, W)
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


def _device_kernels(fn, margin_s: float = PROFILE_MARGIN_S) -> dict:
    """(launches, device ms) of each device kernel in one call of fn, by
    torch.profiler (empty where it records no device activity). A first
    call under the profiler warms it up and is not recorded: the profiler
    can lose the first kernel it sees. The host idles ``margin_s`` before
    each call and after the card has finished it, so that the call's
    kernels lie inside the recorded window and not at its edges: on an
    H100, without the margin 17 of 800 sessions recorded none of a call's
    kernels and 2 only some of them, about one every 60 sessions; with it,
    none of 800 (``--profile-check 400``)."""
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
            time.sleep(margin_s)
            fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
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
    """B3's backward, one launch of ``rglru_scan_bwd`` (csrc/rglru_scan.cu),
    against its plain version, the gates as the model draws them; in the
    same call and on the same inputs the route it replaced (the forward
    kernel on the flipped inputs, then the products as torch ops, from
    ref.py's pieces), both within 1e-4 of max |plain| and timed in turns
    (replaced, kernel, kernel, replaced); the device kernels one call
    launches (by torch.profiler: it fails unless that is one launch of the
    backward kernel and nothing else), the kernel's registers and spills
    (ptxas), the workspace bytes, and the bound: log_a, dy and y read once,
    d log_a and dx written once, 20 bytes an element (h0 read and dh0
    written beside them), over the memory rate."""
    from repro_torch.kernels.rglru_scan.kernel import (_entry,
                                                       rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    from repro_torch.kernels.rglru_scan.ref import (bwd_products,
                                                    reverse_scan_inputs,
                                                    rglru_scan_bwd_ref)
    la, x = _model_gates(gen, B, S, W)
    h0 = torch.randn((B, W), generator=gen, device="cuda")
    dy = torch.randn((B, S, W), generator=gen, device="cuda")
    y = rglru_scan_cuda(la, x, h0)

    def kern():
        return rglru_scan_bwd_cuda(la, h0, y, dy)

    def replaced():
        g = torch.flip(rglru_scan_cuda(*reverse_scan_inputs(la, dy)), (1,))
        return bwd_products(la, h0, y, g)

    def plain():
        return rglru_scan_bwd_ref(la, h0, y, dy)
    want = plain()
    routes = {"kernel": kern, "replaced": replaced}
    errs, rel = {}, {}
    for tag, fn in routes.items():
        got = fn()
        errs[tag] = [float((g - w).abs().max()) for g, w in zip(got, want)]
        rel[tag] = [e / float(w.abs().max())
                    for e, w in zip(errs[tag], want)]
    del got, want
    shape = f"B={B} S={S} W={W} model gates"
    kernels = _device_kernels(kern)
    bwd = [n for k, (n, _) in kernels.items() if "rglru_scan_bwd" in k]
    if bwd != [1] or sum(n for n, _ in kernels.values()) != 1:
        raise RuntimeError(
            f"rglru_scan_bwd {shape}: the profiler saw (launches, device "
            f"ms) {kernels} in one call, not one launch of the backward "
            "kernel and nothing else")
    regs = {k: v for k, v in ptxas_registers("rglru_scan", B3_KERNELS).items()
            if "bwd" in k}
    ws_bytes = 4 * _entry()[0].rglru_scan_workspace_floats(B, S, W)
    times = {tag: [] for tag in routes}
    for tag in ("replaced", "kernel", "kernel", "replaced"):
        times[tag].append(cuda_ms(routes[tag], 20))
    elements = B * S * W
    b_ms, b_by = bound_ms(4.0 * (5 * elements + 2 * B * W), 4.0 * elements,
                          torch.float32)
    ms = float(np.mean(times["kernel"]))
    log(f"[kernel] rglru_scan_bwd {shape}: one call launches, by the "
        f"profiler (launches, device ms): {kernels}; (registers, spill "
        f"store bytes) by ptxas: {regs}; workspace {ws_bytes} bytes; "
        f"of max |plain|: kernel {rel['kernel']}, replaced route "
        f"{rel['replaced']}; ms in turns: kernel {times['kernel']}, "
        f"replaced route (forward kernel on flipped inputs + torch "
        f"products) {times['replaced']}; bound {b_ms:.4f} ms (20 bytes an "
        f"element, {b_by}), the kernel at {ms / b_ms:.2f}x")
    return {"shape": shape, "dtype": str(torch.float32),
            "err": max(errs["kernel"]), "rel_err": rel["kernel"],
            "replaced_rel_err": rel["replaced"],
            "ok": max(rel["kernel"] + rel["replaced"]) <=
            BWD_TOL[torch.float32],
            "ms": ms, "ms_turns": times["kernel"],
            "replaced_ms": float(np.mean(times["replaced"])),
            "replaced_ms_turns": times["replaced"],
            "launches_per_call": kernels, "registers": regs,
            "workspace_bytes": ws_bytes, "plain_ms": cuda_ms(plain, 3),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def _long_cases(gen, cases: dict, main: dict) -> None:
    """Phase 7a's shapes: B1 at prefill_32k's S=32768 (Llama's 32 over 8
    heads, causal; the plain version in blocks of 1024 query rows) and B2
    over decode_32k's 32768 rows, B=8, at the serve's first position
    32752 and at others up to the cache's last row."""
    bf16 = torch.bfloat16
    c = _flash_case(LONG_SEQ, None, bf16, gen, LLAMA_HEADS,
                    plain_blocks=1024)
    cases["flash_attention"].append(c)
    main["flash_attention_32k"] = c
    c = _decode_case([STEPS_DECODE_POS, LONG_SEQ - 1, 32760, 16383, 0, 32000,
                      24575, LONG_SEQ - 2], None, bf16, gen, LLAMA_HEADS,
                     Sc=LONG_SEQ, B=STEPS_DECODE_BATCH)
    cases["decode_attention"].append(c)
    main["decode_attention_32k"] = c


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
    # B2 with its log-sum-exp: at phase 6's shape (B=4 over a rank's 4096
    # rows, rank 1's first steps admitting none), and at Llama's and
    # RecurrentGemma's decode shapes, some positions negative
    cases["decode_attention_lse"] = []
    for dtype in (torch.bfloat16, torch.float32):
        cases["decode_attention_lse"] += [
            _decode_lse_case([4088, -8, 4095, 7], None, dtype, gen,
                             LLAMA_HEADS, Sc=4096, B=4),
            _decode_lse_case([-1, 300, 700, 1023, 1024, -3, 2047, 2300],
                             None, dtype, gen, LLAMA_HEADS),
            _decode_lse_case([0, -1, 300, 1023, 1024, 2047, -2, 3500], 2048,
                             dtype, gen, RG_HEADS)]
    main["decode_attention_lse"] = cases["decode_attention_lse"][0]
    # phase 6b's shapes: a rank's 16 query heads over 4 KV heads, B1 at the
    # forward's S=2048, B2 over the 1024-row cache at its positions
    c = _flash_case(2048, None, bf16, gen, LLAMA_TP_HEADS)
    cases["flash_attention"].append(c)
    main["flash_attention_tp"] = c
    c = _decode_case([1000, 1007, 1015, 1003], None, bf16, gen,
                     LLAMA_TP_HEADS, Sc=1024, B=4)
    cases["decode_attention"].append(c)
    main["decode_attention_tp"] = c
    _long_cases(gen, cases, main)
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
        f"{main['rglru_scan_bwd']['ms']:.4f} ms in one launch; the route it "
        f"replaced (reverse scan, flips and products) "
        f"{main['rglru_scan_bwd']['replaced_ms']:.4f} ms in the same call")
    tols = {"rglru_scan": SCAN_TOL,
            "decode_attention_lse": f"output as without the lse, bitwise; "
                                    f"lse {LSE_TOL} max(1, |lse|)",
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
            if "ms_without_lse" in c:
                state += (f" (lse within {c['lse_err']:.3g}; "
                          f"{c['ms_without_lse']:.4f} ms without the lse)")
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
# B3 against another commit's (--ab-scan)
# ---------------------------------------------------------------------------

AB_SCAN_CASES = ((1, 3000, 2560), (1, 206, 2560), (1, 3450, 2560),
                 (1, TRAIN_SEQ, 2560))


def ab_scan(parent: Path) -> int:
    """B3's forward built from ``parent`` (a ``csrc`` directory) and from
    this checkout's, called through the same wrapper on the same seeded
    inputs (the gates as the model draws them): each library's kernels'
    registers and spills; each output against the plain version (within
    1e-4; the look-back makes the last bits differ from call to call) at
    the hybrid's prefill shape, the serve's shortest and longest prompts
    and the training shape; and the times in turns (parent, change, change,
    parent), so that both see the same card. Returns 1 if an output is
    off."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_cuda
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    names = ("rglru_scan",)
    sides = {"parent": parent.resolve(), "change": build.CSRC}
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    for tag, csrc in sides.items():
        build.build_all(names, csrc)
        log(f"[ab] {tag} rglru_scan: (registers, spill store bytes) "
            f"{ptxas_registers('rglru_scan', B3_KERNELS, csrc)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for B, S, W in AB_SCAN_CASES:
        shape = f"B={B} S={S} W={W} model gates"
        la, x = _model_gates(gen, B, S, W)
        h0 = torch.randn((B, W), generator=gen, device="cuda")
        want = rglru_scan_ref(la, x, h0)

        def fwd():
            return rglru_scan_cuda(la, x, h0)
        errs = {}
        for tag, csrc in sides.items():
            with build.using(csrc, names):
                errs[tag] = float((fwd() - want).abs().max())
        times = {tag: [] for tag in sides}
        for tag in ("parent", "change", "change", "parent"):
            with build.using(sides[tag], names):
                times[tag].append(cuda_ms(fwd, 50))
        log(f"[ab] forward {shape}: max |kernel - plain| {errs}; ms {times}")
        if max(errs.values()) >= SCAN_TOL:
            failed.append(shape)
    log(f"[ab] {'failed: ' + str(failed) if failed else 'ok'}")
    return 1 if failed else 0


# B2's bf16 kernel built from another commit's csrc, and this checkout's:
# (B, Sc, heads, positions, window) of phase 2's bf16 decode cases
AB_DECODE_CASES = (
    (8, 2048, LLAMA_HEADS, [0, 300, 700, 1023, 1024, 1500, 2047, 2300]),
    (8, 2048, RG_HEADS, [0, 1, 300, 1023, 1024, 2047, 2048, 3500]),
    (4, 2048, (40, 8, 128), [0, 1, 500, 2047]),
    (4, 2048, STARCODER2_HEADS, [1, 0, 1500, 3000]),
    (8, 448, WHISPER_HEADS, [0, 1, 223, 447, 5, 100, 300, 446]),
    (4, 4096, LLAMA_HEADS, [4088, 4090, 4095, 4093]))


def ab_decode(parent: Path) -> int:
    """B2's bf16 kernel (``decode_attention_sm90.cu``) built from ``parent``
    (a ``csrc`` directory) and from this checkout's, each called through
    its own C interface (a ``csrc`` whose kernel takes no lse pointer is
    called without it) at its own split count on the
    same seeded inputs: the ``HMMA`` count of each library's SASS, its
    registers (``ptxas``), the outputs compared bit for bit (and each
    side's two calls), and the times in turns (parent, change, change,
    parent). Returns 1 if the outputs differ."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention.kernel import plan_splits
    name = "decode_attention_sm90"
    sides = {"parent": parent.resolve(), "change": build.CSRC}
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs, with_lse = {}, {}
    for tag, csrc in sides.items():
        build.build_all((name,), csrc)
        path = build.library_path(name, csrc)
        libs[tag] = ctypes.CDLL(str(path))
        with_lse[tag] = "void* lse" in (csrc / f"{name}.cu").read_text()
        regs = [line.strip() for line in
                path.with_suffix(".log").read_text().splitlines()
                if "registers" in line]
        log(f"[ab] {tag} {name}: {count_sass(path, 'HMMA')} HMMA in its "
            f"SASS; the lse pointer in its interface: {with_lse[tag]}; "
            f"ptxas {regs}")
    P, I = ctypes.c_void_p, ctypes.c_int
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def caller(tag, q, kc, vc, posb):
        lib = libs[tag]
        B, _, Hq, hd = q.shape
        Sc, K = kc.shape[1], kc.shape[2]
        per_sm = I(0)
        lib.decode_attention_blocks_per_sm_sm90(I(hd), ctypes.byref(per_sm))
        n_split = plan_splits(B, K, Sc, n_sm, per_sm.value)
        fn = lib.decode_attention_fwd_sm90
        fn.argtypes = [P] * (8 if with_lse[tag] else 7) + [I] * 6 + [P]
        fn.restype = I
        part_acc = torch.empty(B * Hq * n_split * hd, device="cuda")
        part_ml = torch.empty(B * Hq * n_split * 2, device="cuda")
        out = torch.empty_like(q)
        ptrs = [q.data_ptr(), kc.data_ptr(), vc.data_ptr(), posb.data_ptr(),
                out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr()]
        if with_lse[tag]:
            ptrs.append(None)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = fn(*ptrs, B, Hq, K, Sc, hd, n_split, stream)
            if err:
                raise RuntimeError(f"{tag} {name}: CUDA error {err}")
            return out
        # raw pointers do not keep the tensors alive: the closure must
        call.scratch = (part_acc, part_ml)
        return call
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for B, Sc, (HQ, KV, HD), pos in AB_DECODE_CASES:
        shape = f"B={B} Sc={Sc} Hq={HQ} K={KV} hd={HD} pos={pos}"
        q, kc, vc = (torch.randn(shp, generator=gen, device="cuda").to(
            torch.bfloat16) for shp in ((B, 1, HQ, HD), (B, Sc, KV, HD),
                                        (B, Sc, KV, HD)))
        posb = torch.tensor(pos, dtype=torch.int32, device="cuda")
        calls = {tag: caller(tag, q, kc, vc, posb) for tag in sides}
        outs = {tag: fn().clone() for tag, fn in calls.items()}
        same = bool(torch.equal(outs["parent"], outs["change"]))
        again = {tag: bool(torch.equal(fn(), outs[tag]))
                 for tag, fn in calls.items()}
        if not same:
            d = (outs["parent"].float() - outs["change"].float()).abs()
            log(f"[ab]   {int((d > 0).sum())} of {d.numel()} elements "
                f"differ, by at most {float(d.max()):.3g}; each side's two "
                f"calls equal: {again}")
        times = {tag: [] for tag in sides}
        for tag in ("parent", "change", "change", "parent"):
            times[tag].append(cuda_ms(calls[tag], 50))
        log(f"[ab] decode {shape}: outputs bitwise equal {same}; ms {times}")
        if not same:
            failed.append(shape)
    log(f"[ab] {'failed: ' + str(failed) if failed else 'ok'}")
    return 1 if failed else 0


def profile_check(n: int) -> int:
    """The launch checks' profiler (``_device_kernels``) on two calls, B1's
    fp32 backward at phase 2's ragged shape (three kernels a call) and B3's
    backward at its training shape (one): n sessions each with no host
    margin and with the smoke's, in turns, each session followed by a
    ``cuda_ms`` of the call as in phase 2. Prints, for each margin, the
    sessions that recorded no device kernel and those that recorded other
    kernels. Returns 1 if any session with the smoke's margin was empty or
    wrong."""
    import os
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda, plan_bwd)
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    log(f"[profile] torch {torch.__version__}; TEARDOWN_CUPTI="
        f"{os.environ.get('TEARDOWN_CUPTI')}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    HQ, KV, HD = 16, 4, 128
    q, do = (torch.randn((1, 1000, HQ, HD), generator=gen, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((1, 1000, KV, HD), generator=gen, device="cuda")
            for _ in range(2))
    lse = torch.empty((1, HQ, 1000), device="cuda")
    o = flash_attention_cuda(q, k, v, causal=True, window=256, lse=lse)
    la, x = _model_gates(gen, 1, 4096, 2560)
    h0 = torch.randn((1, 2560), generator=gen, device="cuda")
    dy = torch.randn_like(x)
    y = rglru_scan_cuda(la, x, h0)
    calls = {
        "flash_attention_bwd fp32": (
            lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                             causal=True, window=256),
            B1_BWD_KERNELS,
            plan_bwd(1, 1000, 1000, HQ, KV, HD, torch.float32)["launches"]),
        "rglru_scan_bwd": (lambda: rglru_scan_bwd_cuda(la, h0, y, dy),
                           "rglru_scan_bwd", 1)}
    bad = 0
    t0 = time.perf_counter()
    margins = (0.0, PROFILE_MARGIN_S)
    for what, (fn, pattern, want) in calls.items():
        empty = {m: [] for m in margins}
        wrong = {m: [] for m in margins}
        for i in range(n):
            for margin in margins:   # in turns: the losses come in runs
                kernels = _device_kernels(fn, margin)
                hits = [c for name, (c, _) in kernels.items()
                        if re.search(pattern, name)]
                if not kernels:
                    empty[margin].append(i)
                elif len(hits) != want or set(hits) != {1} or \
                        sum(c for c, _ in kernels.values()) != want:
                    wrong[margin].append((i, kernels))
                cuda_ms(fn, 5)
        for margin in margins:
            log(f"[profile] {what}, margin {margin} s: {n} sessions, "
                f"{len(empty[margin])} saw no device kernel "
                f"{empty[margin][:20]}, {len(wrong[margin])} saw others "
                f"{wrong[margin][:3]}")
        bad += len(empty[PROFILE_MARGIN_S]) + len(wrong[PROFILE_MARGIN_S])
    log(f"[profile] {time.perf_counter() - t0:.1f} s; the smoke's margin "
        f"({PROFILE_MARGIN_S} s): {'ok' if not bad else 'FAILED'}")
    return 1 if bad else 0


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


# ---------------------------------------------------------------------------
# phase 6: the multi-device layers, two ranks on one card
# ---------------------------------------------------------------------------

def _logits_check(out, ref) -> dict:
    """max |out - ref| / max |ref|, the share of rows whose argmax agrees,
    and whether it agrees wherever the reference's top-2 gap exceeds
    DIST_TOL max |ref|."""
    o, r = out.float(), ref.float()
    top = float(r.abs().max())
    rel = float((o - r).abs().max()) / top
    t2 = r.topk(2, dim=-1).values
    clear = (t2[..., 0] - t2[..., 1]) > DIST_TOL * top
    agree = o.argmax(-1) == r.argmax(-1)
    ok = rel <= DIST_TOL and bool(agree[clear].all())
    return {"rel": rel, "argmax_agree": float(agree.float().mean()),
            "clear_rows": int(clear.sum()), "ok": ok}


def _greedy(lm, params, tokens, max_len: int, steps: int):
    """Prefill and ``steps`` greedy decode steps: (the logits of each, as
    fp32 (steps + 1, B, V) on the host; the fed tokens (B, steps))."""
    cache = lm.init_cache(tokens.shape[0], max_len, dtype=torch.bfloat16,
                          device="cuda")
    logits, cache = lm.prefill(params, {"tokens": tokens}, cache)
    outs, fed = [logits.float().cpu()], []
    for _ in range(steps):
        fed.append(logits.argmax(-1))
        logits, cache = lm.decode_step(params, fed[-1], cache)
        outs.append(logits.float().cpu())
    return torch.stack(outs), torch.stack(fed, 1)


def _feed(lm, params, tokens, fed, max_len: int):
    """Prefill, then decode steps fed ``fed`` (B, steps): (the logits as
    fp32 (steps + 1, B, V) on the host, seconds of the prefill, of each
    step, the cache's shape)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = lm.init_cache(tokens.shape[0], max_len, dtype=torch.bfloat16,
                          device="cuda")
    logits, cache = lm.prefill(params, {"tokens": tokens}, cache)
    torch.cuda.synchronize()
    walls, outs = [time.perf_counter() - t0], [logits.float().cpu()]
    for i in range(fed.shape[1]):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(params, fed[:, i], cache)
        outs.append(logits.float().cpu())     # synchronises
        walls.append(time.perf_counter() - t0)
    return torch.stack(outs), walls, tuple(cache["slots"][0]["k"].shape)


def _from_rank0(t, rank: int):
    """Rank 0's host tensor ``t`` on every rank (``t`` shaped alike)."""
    import torch.distributed as dist
    t = t.contiguous()
    dist.broadcast(t, src=0)
    return t


def _counters(reset: bool = False) -> dict:
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda,
    )
    from repro_torch.models import sharding as SH
    fns = {"flash_attention": flash_attention_cuda,
           "decode_attention": decode_attention_cuda,
           "all_reduce": SH.all_reduce}
    attrs = {"flash_attention": ("launches", "launches_sm90"),
             "decode_attention": ("launches", "launches_sm90",
                                  "launches_lse"),
             "all_reduce": ("calls", "bytes", "seconds", "host_staged")}
    if reset:
        for name, fn in fns.items():
            for a in attrs[name]:
                setattr(fn, a, 0 if a != "seconds" else 0.0)
        SH.all_reduce.by_axis = {}
    out = {f"{name}.{a}": getattr(fn, a) for name, fn in fns.items()
           for a in attrs[name]}
    # mesh axes ("pod+data" flattened) -> [count, bytes]
    out["all_reduce.by_axis"] = {k: list(v) for k, v in
                                 SH.all_reduce.by_axis.items()}
    return out


def _sharded_run(tag: str, rank: int, run, ref) -> dict:
    """``run()`` -> (logits (n, B, V), walls, cache shape) under the active
    rules, with the launch and all-reduce counters set to 0 just before
    and read just after; each of its logits held against ``ref``."""
    _counters(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, walls, cache_shape = run()
    wall = time.perf_counter() - t0
    counts = _counters()
    checks = [_logits_check(o, r) for o, r in zip(outs, ref)]
    for i, c in enumerate(checks):
        what = "logits" if len(checks) == 1 else \
            "prefill" if i == 0 else f"step {i}"
        log(f"[dist r{rank}] {tag} {what}: max |dlogit| / max |logit| "
            f"{c['rel']:.4g} (tol {DIST_TOL}), argmax agrees on "
            f"{c['argmax_agree']:.3f} of the rows, on every row whose "
            f"top-2 gap exceeds the tol ({c['clear_rows']}): {c['ok']}")
    steps = (f", decode steps median {np.median(walls[1:]) * 1e3:.1f} ms"
             if len(walls) > 1 else "")
    log(f"[dist r{rank}] {tag}: {wall:.2f} s; first call {walls[0]:.3f} s"
        f"{steps}; cache of a slot {cache_shape}; counters {counts}")
    return {"checks": checks, "ok": all(c["ok"] for c in checks),
            "wall_s": wall, "walls_s": walls, "cache_shape": cache_shape,
            "counters": counts}


def _bf16_step(x) -> float:
    """One bf16 step (2^-7 of the binade) at x's largest |value|."""
    top = float(x.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _dist_layer_check(rank: int) -> dict:
    """One layer's ``dist_decode_attention`` under the active ``kv_seq``
    rules at 6a's shape (B=4, 32 over 8 heads of 128, bf16, a rank's 4096
    of 8192 rows) against B2 unsharded over the whole cache, within
    DIST_LAYER_STEPS bf16 steps of max |unsharded|, at positions where
    rank 1 admits none, 8, 2048 and all of its rows. The control is the
    combine with rank 1's weight set to 0, which is rank 0's B2 over its
    own rows: it must miss by more than the tolerance wherever rank 1
    admits 8 rows or more, or the check could not tell a dropped shard
    from rounding. Every rank draws the same cache from one seed."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as SH
    HQ, KV, HD = LLAMA_HEADS
    B, Sc = DIST_KV["batch"], DIST_KV["max_len"]
    seq = SH.shard_of("kv_seq")
    rows = Sc // seq.size
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, kn, vn = (torch.randn(shp, generator=gen, device="cuda").to(
        torch.bfloat16) for shp in ((B, 1, HQ, HD), (B, 1, KV, HD),
                                    (B, 1, KV, HD)))
    kc, vc = (torch.randn((B, Sc, KV, HD), generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in "kv")
    res, ok = [], True
    for pos in (rows - 1, rows + 7, rows + 2047, Sc - 1):
        kl, vl = (c[:, seq.rank * rows:(seq.rank + 1) * rows].clone()
                  for c in (kc, vc))
        posd = torch.tensor(pos, dtype=torch.int32, device="cuda")
        out = L.dist_decode_attention(q, kl, vl, kn, vn, posd)[0]
        kw, vw = kc.clone(), vc.clone()
        kw[:, pos], vw[:, pos] = kn[:, 0], vn[:, 0]
        ref = L.decode_attention(q, kw, vw, posd)
        ctrl = L.decode_attention(q, kw[:, :rows].contiguous(),
                                  vw[:, :rows].contiguous(), posd)
        tol = DIST_LAYER_STEPS * _bf16_step(ref)
        err = float((out.float() - ref.float()).abs().max())
        ctrl_err = float((ctrl.float() - ref.float()).abs().max())
        rank1_rows = min(max(pos + 1 - rows, 0), rows)
        own = slice(seq.rank * rows, (seq.rank + 1) * rows)
        cache_ok = bool(torch.equal(kl, kw[:, own]) and
                        torch.equal(vl, vw[:, own]))
        caught = ctrl_err > tol if rank1_rows >= 8 else True
        ok = ok and err <= tol and caught and cache_ok
        log(f"[dist r{rank}] 6a layer pos {pos}: dist_decode_attention "
            f"within {err:.3g} of unsharded B2 (tol {tol:.3g}, "
            f"{DIST_LAYER_STEPS} bf16 steps of max |ref| "
            f"{float(ref.float().abs().max()):.3g}); the control without "
            f"rank 1's {rank1_rows} rows off by {ctrl_err:.3g} "
            f"({'caught' if ctrl_err > tol else 'not caught'}); cache rows "
            f"as the unsharded write: {cache_ok}")
        res.append({"pos": pos, "err": err, "tol": tol,
                    "control_err": ctrl_err, "rank1_rows": rank1_rows,
                    "cache_ok": cache_ok})
    return {"cases": res, "ok": ok}


def _dist_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One rank of phase 6 on cuda:0, in a gloo process group of ``world``
    ranks that meet at the file ``rdv``. Writes its results to
    ``out_dir/dist_rank<rank>.json``; a check that fails is recorded
    there (the ranks keep their collectives in step), an error ends the
    process."""
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.dist_cases import rules_kv_seq, rules_tp
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardspecs import local_params
    from repro_torch.models import LM
    from repro_torch.models import sharding as SH
    from repro_torch.models.transformer import whole_logits
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    mesh = make_mesh((1, world), ("data", "model"), backend="gloo",
                     device="cuda:0")
    cfg = get_config("llama3.1-8b")
    lm = LM(cfg)
    res = {"rank": rank}
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
        # 6a: the KV sequence over the two ranks, every weight whole
        kv = DIST_KV
        tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (kv["batch"], kv["prompt"])), device="cuda")
        shape = (kv["steps"] + 1, kv["batch"], cfg.vocab_size)
        ref, fed = torch.zeros(shape), torch.zeros(
            (kv["batch"], kv["steps"]), dtype=torch.long)
        if rank == 0:
            ref, fed = _greedy(lm, params, tokens, kv["max_len"],
                               kv["steps"])
        ref, fed = _from_rank0(ref, rank), _from_rank0(fed.cpu(), rank)
        gc.collect()
        torch.cuda.empty_cache()
        with SH.use_rules(rules_kv_seq(), mesh):
            res["kv_seq_layer"] = _dist_layer_check(rank)
            res["kv_seq"] = _sharded_run(
                "6a kv_seq", rank, lambda: _feed(lm, params, tokens,
                                                 fed.cuda(), kv["max_len"]),
                ref)
        res["kv_seq"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        # 6b: heads and d_ff over the two ranks, bf16 all-reduces
        tp = DIST_TP
        train_tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (1, tp["train_seq"])), device="cuda")
        tokens = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (tp["batch"], tp["prompt"])), device="cuda")
        shape = (tp["steps"] + 1, tp["batch"], cfg.vocab_size)
        ref, fed = torch.zeros(shape), torch.zeros(
            (tp["batch"], tp["steps"]), dtype=torch.long)
        ref_train = torch.zeros((1, tp["train_seq"], cfg.vocab_size),
                                dtype=torch.bfloat16)
        if rank == 0:
            ref_train = lm.forward_train(params, {"tokens": train_tokens},
                                         remat=False)[0].cpu()
            ref, fed = _greedy(lm, params, tokens, tp["max_len"],
                               tp["steps"])
        ref, fed = _from_rank0(ref, rank), _from_rank0(fed.cpu(), rank)
        ref_train = _from_rank0(ref_train, rank)
        with SH.use_rules(rules_tp(), mesh):
            local = local_params(params, cfg, mesh)
            if rank != 0:        # rank 0 keeps the whole model: the reference
                del params
            gc.collect()
            torch.cuda.empty_cache()
            n_local = sum(t.numel() for t in _leaves(local))
            log(f"[dist r{rank}] 6b: {n_local} parameters on this rank "
                f"({2 * n_local / 1e9:.2f} GB in bf16)")

            def train_run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = whole_logits(lm.forward_train(
                    local, {"tokens": train_tokens}, remat=False)[0],
                    cfg).float().cpu()
                return out[None], [time.perf_counter() - t0], ()
            res["tp_train"] = _sharded_run("6b tp forward_train", rank,
                                           train_run, ref_train[None])
            res["tp"] = _sharded_run(
                "6b tp", rank, lambda: _feed(lm, local, tokens, fed.cuda(),
                                             tp["max_len"]), ref)
        res["local_parameters"] = n_local
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.perf_counter() - t_start
    log(f"[dist r{rank}] peak memory {res['peak_gb']:.2f} GB (6a "
        f"{res['kv_seq']['peak_gb']:.2f}); {res['seconds']:.1f} s")
    Path(out_dir, f"dist_rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_dist(report: dict) -> dict:
    """Phase 6: Llama-3.1-8B at full width and depth on two gloo ranks that
    share the card (NCCL takes one rank a card), spawned with
    ``torch.multiprocessing``; fails if a rank fails, outlasts
    ``DIST_TIMEOUT_S`` or finds its logits off. Returns the launches of
    each sharded run, summed over the ranks, by path."""
    import os

    import torch.multiprocessing as mp
    gc.collect()                  # the serve and training engines
    torch.cuda.empty_cache()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    rdv = out_dir / f"dist_rdv_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    for r in range(DIST_WORLD):
        (out_dir / f"dist_rank{r}.json").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dist_rank,
                         args=(r, DIST_WORLD, str(rdv), str(out_dir)))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    while any(p.is_alive() for p in procs):
        if time.perf_counter() - t0 > DIST_TIMEOUT_S or any(
                p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:               # every rank ends here, done or not
        if p.is_alive():
            p.terminate()
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    rdv.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise SystemExit(f"phase 6: ranks failed or outlasted "
                         f"{DIST_TIMEOUT_S} s (exit codes {bad})")
    ranks = [json.loads((out_dir / f"dist_rank{r}.json").read_text())
             for r in range(DIST_WORLD)]
    failed = [(r["rank"], run) for r in ranks
              for run in ("kv_seq_layer", "kv_seq", "tp_train", "tp")
              if not r[run]["ok"]]
    layers = 32
    want_lse = layers * DIST_KV["steps"]
    lse = [r["kv_seq"]["counters"]["decode_attention.launches_lse"]
           for r in ranks]
    cuda_core = [r[run]["counters"]["decode_attention.launches"] -
                 r[run]["counters"]["decode_attention.launches_sm90"]
                 for r in ranks for run in ("kv_seq", "tp")]
    log(f"[dist] phase 6 in {secs:.1f} s; peak GB by rank "
        f"{[round(r['peak_gb'], 2) for r in ranks]}; B2 launches with the "
        f"lse by rank {lse} (expected {want_lse} each); B2 on the CUDA "
        f"cores {cuda_core}")
    report["dist"] = {"seconds": secs, "ranks": ranks}
    if failed:
        raise SystemExit(f"phase 6: sharded layer or logits off the "
                         f"unsharded ones: {failed}")
    if lse != [want_lse] * DIST_WORLD or any(cuda_core):
        raise SystemExit(f"phase 6: B2 with the lse launched {lse} times, "
                         f"{cuda_core} on the CUDA cores")

    def launches(run: str, name: str) -> int:
        return sum(r[run]["counters"][f"{name}.launches"] for r in ranks)
    return {"dist-kv_seq": {"decode_attention": launches("kv_seq",
                                                         "decode_attention"),
                            "flash_attention": launches("kv_seq",
                                                        "flash_attention")},
            "dist-tp": {"decode_attention": launches("tp",
                                                     "decode_attention"),
                        "flash_attention": launches("tp", "flash_attention")
                        + launches("tp_train", "flash_attention")}}


# ---------------------------------------------------------------------------
# phase 7: the steps of launch/steps.py
# ---------------------------------------------------------------------------

def _step_counters(reset: bool = False) -> dict:
    """B1 forward (all, sm90), B1 backward, B2 (all, sm90) and the
    all-reduces (count, bytes, host seconds), set to 0 where ``reset``."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
    )
    out = _counters(reset)
    if reset:
        flash_attention_bwd_cuda.launches = 0
    out["flash_attention_bwd.launches"] = flash_attention_bwd_cuda.launches
    return out


def _peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def phase_steps_serve(report: dict) -> dict:
    """7a: Llama-3.1-8B at full width and depth on a one-rank mesh (1, 1),
    through what the production serve launcher calls: ``build_step`` of
    prefill_32k at B=1 (B1 at S=32768, a 32768-row cache), then
    decode_32k at B=8, the prefill's rows copied into every slot at
    position 32752, 16 serve steps (B2 over 32753-32768 rows a slot). The
    first serve step's tokens must equal ``LM.decode_step``'s on the same
    cache (the same layers, the rules' axes all of size 1). Returns the
    launches by path."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.mesh import init_world, make_smoke_mesh
    from repro_torch.launch.serve import (cut_shape, first_tokens,
                                          prompt_batch, run_steps)
    from repro_torch.launch.steps import build_step, init_params, materialize
    from repro_torch.models import LM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    import os
    rdv = ROOT / "build" / f"steps_rdv_1_{os.getpid()}"
    rdv.parent.mkdir(exist_ok=True)
    rdv.unlink(missing_ok=True)
    init_world(rdv=f"file://{rdv}")
    res: dict = {}
    try:
        mesh = make_smoke_mesh(device="cuda:0")
        cfg = get_config("llama3.1-8b")
        pshape = cut_shape(INPUT_SHAPES["prefill_32k"], STEPS_PREFILL_BATCH)
        pre = build_step(cfg, mesh, pshape)
        params = init_params(cfg, pre, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
        batch = prompt_batch(cfg, pre, pshape, 0, "cuda")
        cache = materialize(pre.args[2], "cuda")
        _step_counters(reset=True)
        tokens, walls = run_steps(pre, params, batch, cache, 1, "cuda")
        pc = _step_counters()
        res["prefill"] = {"wall_s": walls[0], "counters": pc,
                          "cache_gb": sum(t.numel() * t.element_size() for t
                                          in _leaves(cache)) / 1e9,
                          "tokens": tokens[0].tolist()}
        log(f"[steps] 7a prefill_32k B={pshape.global_batch} (cut from "
            f"{INPUT_SHAPES['prefill_32k'].global_batch}): "
            f"{walls[0]:.3f} s; B1 launches {pc['flash_attention.launches']}"
            f" ({pc['flash_attention.launches_sm90']} sm90); cache "
            f"{res['prefill']['cache_gb']:.2f} GB; tokens "
            f"{res['prefill']['tokens']}")
        dshape = cut_shape(INPUT_SHAPES["decode_32k"], STEPS_DECODE_BATCH)
        dec = build_step(cfg, mesh, dshape)
        dcache = materialize(dec.args[2], "cuda")
        for src, dst in zip(cache["slots"], dcache["slots"]):
            for name in ("k", "v"):
                dst[name].copy_(src[name].expand_as(dst[name]))
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        pos = torch.tensor(STEPS_DECODE_POS, dtype=torch.int32, device="cuda")
        dcache["pos"] = pos
        first = first_tokens(cfg, dec, dshape, 0, "cuda")
        # the reference: the unsharded model's step on the same cache (it
        # writes row pos, which the serve step then writes with the same
        # values)
        logits, _ = LM(cfg).decode_step(params, first, dcache)
        ref = logits.argmax(-1).to(torch.int32)
        dcache["pos"] = pos.clone()
        _step_counters(reset=True)
        tokens, walls = run_steps(dec, params, first, dcache,
                                  STEPS_DECODE_STEPS, "cuda")
        dc = _step_counters()
        same = bool(torch.equal(tokens[0], ref))
        res["serve"] = {"walls_s": walls, "counters": dc,
                        "first_tokens_equal_reference": same,
                        "cache_gb": sum(t.numel() * t.element_size() for t
                                        in _leaves(dcache)) / 1e9,
                        "tokens_per_s": dshape.global_batch * len(walls)
                        / sum(walls)}
        want = cfg.n_layers * STEPS_DECODE_STEPS
        log(f"[steps] 7a decode_32k B={dshape.global_batch} (cut from "
            f"{INPUT_SHAPES['decode_32k'].global_batch}) over "
            f"{dshape.seq_len} rows from position {STEPS_DECODE_POS}: "
            f"{STEPS_DECODE_STEPS} steps, median "
            f"{np.median(walls) * 1e3:.1f} ms (first {walls[0] * 1e3:.1f}), "
            f"{res['serve']['tokens_per_s']:.1f} tokens/s; B2 launches "
            f"{dc['decode_attention.launches']} "
            f"({dc['decode_attention.launches_sm90']} sm90, {want} "
            f"expected); cache {res['serve']['cache_gb']:.2f} GB; first "
            f"step's tokens equal LM.decode_step's: {same}")
        res["peak_gb"] = _peak_gb()
        res["seconds"] = time.perf_counter() - t_start
        log(f"[steps] 7a: peak {res['peak_gb']:.2f} GB; "
            f"{res['seconds']:.1f} s")
        del params, dcache
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    report["steps_serve"] = res
    bad = []
    if pc["flash_attention.launches_sm90"] != cfg.n_layers or \
            pc["flash_attention.launches"] != cfg.n_layers:
        bad.append(f"prefill B1 launches {pc['flash_attention.launches']}")
    if dc["decode_attention.launches_sm90"] != want or \
            dc["decode_attention.launches"] != want:
        bad.append(f"serve B2 launches {dc['decode_attention.launches']}")
    if not same:
        bad.append("the first serve step's tokens differ from "
                   "LM.decode_step's")
    if bad:
        raise SystemExit(f"phase 7a: {bad}")
    return {"steps-prefill": {"flash_attention": pc[
                "flash_attention.launches"]},
            "steps-serve": {"decode_attention": dc[
                "decode_attention.launches"]}}


def _leaf_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.float() - ref.float()).abs().max())


# elements of a leaf compared on the card at a time (the leaf check's
# fp32 temporaries stay ~2 GB beside the two ranks' parameters and moments)
CHECK_PIECE = 1 << 27


def _pieces(*ts):
    """The same rows of ``ts`` (one shape) along their first dim, about
    CHECK_PIECE elements a piece, on the card."""
    n = ts[0].shape[0]
    step = max(1, CHECK_PIECE * n // max(ts[0].numel(), 1))
    for lo in range(0, n, step):
        yield [t[lo:lo + step].to("cuda") for t in ts]


def _train_check(rank: int, blocks: dict, params, opt, init: dict,
                 ref) -> dict:
    """The leaf-by-leaf check of the ranks' blocks after a held training
    run (7b, 7d) against rank 0's unsharded reference: each parameter's
    change from its initial value, AdamW's m and v. ``init``: this rank's
    parameters before the steps, on the host. ``ref`` (rank 0 only): part
    -> path -> the unsharded leaf after the steps on the host, for the
    parts "params", "m" and "v". The other ranks send their blocks (and
    initial values) to rank 0 (through the host), which cuts each
    reference leaf to the sender's block (model coordinate = rank on the
    (1, n) mesh; whole where ``blocks`` lists no cut) and compares on the
    card, a piece of rows at a time (``_pieces``). Both changes are taken
    from the sender's initial values: the sharded and the unsharded runs
    draw the same weights (``init_params`` keeps a rank's block of each
    whole draw), and where they did not, the reference's change would
    carry the difference and fail. Returns rank 0's worst errors over the
    tolerances and the share of compared parameter values that moved."""
    import torch.distributed as dist

    from repro_torch.launch import shardspecs as SS
    from repro_torch.models.params import flatten
    flat = {"params": flatten(params), "init": init, "m": flatten(opt["m"]),
            "v": flatten(opt["v"])}

    def want(part, key, src):
        t = ref[part][key]
        if key in blocks:
            t = SS.cut(t, tuple(
                (start + src * n if n != full else 0, n)
                for (start, n), full in zip(blocks[key][0], t.shape)))
        return t

    worst = {"delta": 0.0, "m": 0.0, "v": 0.0}
    failed = []
    moved = compared = 0
    for part in ("delta", "m", "v"):
        names = ("params", "init") if part == "delta" else (part,)
        for key in sorted(flat["params"]):
            mine = [flat[n][key] for n in names]
            if rank:
                for t in mine:
                    dist.send(t.cpu(), dst=0)
                continue
            for src in range(dist.get_world_size()):
                got = mine
                if src:
                    got = [torch.empty(t.shape, dtype=t.dtype) for t in mine]
                    for t in got:
                        dist.recv(t, src=src)
                if part == "delta":
                    # the norms of the reference's change and of the error
                    sq_ref = sq_err = 0.0
                    for p_, i_, r_ in _pieces(
                            got[0], got[1], want("params", key, src)):
                        start = i_.float()
                        d_ref = r_.float() - start
                        d_err = p_.float() - start - d_ref
                        sq_ref += float(d_ref.square().sum())
                        sq_err += float(d_err.square().sum())
                        moved += int(torch.count_nonzero(d_ref))
                        compared += d_ref.numel()
                    err = math.sqrt(sq_err)
                    tol = TRAIN_TP_DELTA_TOL * math.sqrt(sq_ref)
                else:
                    err = top = 0.0
                    for g_, r_ in _pieces(got[0], want(part, key, src)):
                        err = max(err, _leaf_err(g_, r_))
                        top = max(top, float(r_.float().abs().max()))
                    tol = TRAIN_TP_MOMENT_TOL * top
                worst[part] = max(worst[part], err / tol if tol else
                                  (0.0 if err == 0 else math.inf))
                if err > tol:
                    failed.append((part, key, src, err, tol))
    return {"worst_over_tol": worst, "failed": failed[:20],
            "n_failed": len(failed),
            "moved_share": moved / compared if compared else None}


def _mem_available_gb() -> float:
    """The host's ``MemAvailable`` (/proc/meminfo), in GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _held_training(rank: int, tag: str, cfg, shape, ref_mesh, mesh,
                   opt_cfg) -> dict:
    """Train ``cfg`` on ``shape`` for STEPS_TRAIN_STEPS steps through
    ``build_train_step`` on ``mesh`` and hold it against rank 0's run of
    the same steps on ``ref_mesh`` (its one-rank pool, unsharded, every
    row of the batch), run first while the other ranks wait with nothing
    allocated, its parameters and moments kept on the host and the card
    freed: each step's loss and grad norm within TRAIN_TP_LOSS_TOL and
    TRAIN_TP_GNORM_TOL of the reference's, then ``_train_check``. Both
    draw the weights from seed 0 and the batches from ``TokenStream``'s
    seed 0. Returns the reference's and the run's steps, launches,
    all-reduces, peaks and checks."""
    import torch.distributed as dist

    from repro_torch.launch.shardspecs import param_blocks
    from repro_torch.launch.steps import (build_train_step, init_params,
                                          materialize)
    from repro_torch.launch.train import local_batches
    from repro_torch.models.params import flatten

    def train(built, what, keep_init):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, built, gen, "cuda")
        init = {k: t.to("cpu", copy=True)
                for k, t in flatten(params).items()} if keep_init else None
        opt = materialize(built.args[1], "cuda")
        batches = local_batches(cfg, built, shape, 0, "cuda")
        steps = []
        _step_counters(reset=True)
        for i in range(STEPS_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = built.fn(params, opt, next(batches))
            m = {k: float(v) for k, v in m.items()}
            m["wall_s"] = time.perf_counter() - t0
            steps.append(m)
            log(f"[steps r{rank}] {tag} {what} step {i}: {m['wall_s']:.2f} "
                f"s, loss {m['loss']:.6f}, grad norm {m['grad_norm']:.6f}, "
                f"lr {m['lr']:.3g}")
        return params, opt, init, steps, _step_counters()

    res = {}
    if rank == 0:
        log(f"[steps r0] {tag}: host MemAvailable "
            f"{_mem_available_gb():.1f} GB before the reference")
    torch.cuda.reset_peak_memory_stats()
    ref = None
    if rank == 0:
        built = build_train_step(cfg, ref_mesh, shape, opt_cfg=opt_cfg)
        params, opt, _, steps, counts = train(built, "unsharded", False)
        ref = {"params": {k: t.cpu() for k, t in flatten(params).items()},
               "m": {k: t.cpu() for k, t in flatten(opt["m"]).items()},
               "v": {k: t.cpu() for k, t in flatten(opt["v"]).items()}}
        res["ref"] = {"steps": steps, "counters": counts,
                      "peak_gb": _peak_gb()}
        del params, opt, built
        gc.collect()
        torch.cuda.empty_cache()
        res["mem_available_gb"] = _mem_available_gb()
        log(f"[steps r0] {tag}: reference peak {_peak_gb():.2f} GB; host "
            f"MemAvailable {res['mem_available_gb']:.1f} GB with its "
            "parameters and moments")
    ref_steps = [torch.tensor([s["loss"], s["grad_norm"]], dtype=torch.float64)
                 for s in (res["ref"]["steps"] if rank == 0 else
                           [{"loss": 0.0, "grad_norm": 0.0}] *
                           STEPS_TRAIN_STEPS)]
    for t in ref_steps:
        dist.broadcast(t, src=0)
    torch.cuda.reset_peak_memory_stats()
    built = build_train_step(cfg, mesh, shape, opt_cfg=opt_cfg)
    params, opt, init, steps, counts = train(built, "sharded", True)
    checks = []
    for s, want in zip(steps, ref_steps):
        loss_err = abs(s["loss"] - float(want[0])) / abs(float(want[0]))
        gn_err = abs(s["grad_norm"] - float(want[1])) / abs(float(want[1]))
        checks.append({"loss_rel": loss_err, "grad_norm_rel": gn_err,
                       "ok": loss_err <= TRAIN_TP_LOSS_TOL and
                       gn_err <= TRAIN_TP_GNORM_TOL})
    n_local = sum(t.numel() for t in flatten(params).values())
    res.update(steps=steps, counters=counts, checks=checks,
               local_parameters=n_local, peak_gb=_peak_gb())
    for i, c in enumerate(checks):
        log(f"[steps r{rank}] {tag} step {i} against unsharded: loss "
            f"{c['loss_rel']:.3g} (tol {TRAIN_TP_LOSS_TOL}), grad norm "
            f"{c['grad_norm_rel']:.3g} (tol {TRAIN_TP_GNORM_TOL}) of the "
            f"reference's: {c['ok']}")
    log(f"[steps r{rank}] {tag}: {n_local} parameters on this rank; B1 "
        f"forward {counts['flash_attention.launches']} "
        f"({counts['flash_attention.launches_sm90']} sm90), backward "
        f"{counts['flash_attention_bwd.launches']}; all-reduces "
        f"{counts['all_reduce.calls']} ({counts['all_reduce.bytes']} bytes, "
        f"{counts['all_reduce.seconds']:.2f} host s; [count, bytes] by mesh "
        f"axes {counts['all_reduce.by_axis']}); peak {res['peak_gb']:.2f} "
        f"GB")
    # the training's cached blocks back to the card, on every rank
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    leaves = _train_check(rank, param_blocks(cfg, mesh, built.rules), params,
                          opt, init, ref)
    res["leaves"] = leaves
    res["leaf_check_s"] = time.perf_counter() - t0
    if rank == 0:
        log(f"[steps r0] {tag} after step {STEPS_TRAIN_STEPS}: every rank's "
            f"parameter blocks' change from their initial values, AdamW m "
            f"and v against the unsharded step's, leaf by leaf: worst error "
            f"over its tolerance {leaves['worst_over_tol']} (the change "
            f"within {TRAIN_TP_DELTA_TOL} of the norm of the reference's, "
            f"m and v within {TRAIN_TP_MOMENT_TOL} max |ref|); "
            f"{leaves['n_failed']} leaves past it; the steps moved "
            f"{leaves['moved_share']:.4f} of the compared parameter values; "
            f"{res['leaf_check_s']:.1f} s")
    del params, opt, init, built, ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res



def _steps_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One rank of 7b, 7c and 7d on cuda:0 in a gloo world of two. 7b:
    Llama-3.1-8B at full width and STEPS_TRAIN_LAYERS layers on the (1, 2)
    mesh under ``standard_rules`` (heads, d_ff and the vocabulary cut),
    held against rank 0's unsharded run on its one-rank pool
    (``_held_training``). 7c: the (2, 1) mesh cut by
    ``split_disagg_mesh(mesh, 1)``, rank 0 prefilling in the prefill pool,
    rank 1 decoding in the decode pool. 7d: STEPS_POD_LAYERS layers on the
    (2, 1, 1) mesh over ("pod", "data", "model"), one row of the batch a
    rank over the flattened ("pod", "data"), held likewise. Writes its
    results to ``out_dir/steps_rank<rank>.json``."""
    import dataclasses as dc
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    from repro_torch.launch.mesh import make_mesh, split_disagg_mesh
    from repro_torch.launch.serve import (first_tokens, primed_cache,
                                          prompt_batch, run_steps)
    from repro_torch.launch.steps import build_step, init_params, materialize
    from repro_torch.models import LM
    from repro_torch.training.optimizer import AdamWConfig
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{rdv}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=STEPS_TIMEOUT_S))
    mesh12 = make_mesh((1, world), ("data", "model"), backend="gloo",
                       device="cuda:0")
    mesh21 = make_mesh((world, 1), ("data", "model"), backend="gloo",
                       device="cuda:0")
    mesh_pod = make_mesh((world, 1, 1), ("pod", "data", "model"),
                         backend="gloo", device="cuda:0")
    pools = split_disagg_mesh(mesh21, 1)
    own = pools[0] if pools[0].get_coordinate() is not None else pools[1]
    res = {"rank": rank, "pools": [p.mesh.tolist() for p in pools]}
    full = get_config("llama3.1-8b")
    train_4k = INPUT_SHAPES["train_4k"]
    opt_cfg = AdamWConfig(state_dtype=torch.bfloat16,
                          warmup_steps=TRAIN_TP_WARMUP)
    # 7b: tensor parallel, the vocabulary cut, at full depth
    res["train_tp"] = _held_training(
        rank, "7b", dc.replace(full, n_layers=STEPS_TRAIN_LAYERS),
        dc.replace(train_4k, global_batch=1), pools[0], mesh12, opt_cfg)
    # 7c: the disaggregated pools
    torch.cuda.reset_peak_memory_stats()
    res["pool"] = own.mesh.tolist()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    lm = LM(full)
    if own is pools[0]:
        pshape = InputShape("prefill_4k", STEPS_POOL_SEQ, 1, "prefill")
        built = build_step(full, own, pshape)
        params = init_params(full, built, gen, "cuda")
        batch = prompt_batch(full, built, pshape, 0, "cuda")
        _step_counters(reset=True)
        tokens, walls = run_steps(built, params, batch,
                                  materialize(built.args[2], "cuda"), 1,
                                  "cuda")
        counts = _step_counters()
        logits, _ = lm.prefill(params, batch, materialize(built.args[2],
                                                          "cuda"))
        same = bool(torch.equal(tokens[0], logits.argmax(-1).to(torch.int32)))
        what = f"prefill B=1 S={STEPS_POOL_SEQ}"
    else:
        dshape = InputShape("decode_4k", STEPS_POOL_SEQ, STEPS_DECODE_BATCH,
                            "decode")
        built = build_step(full, own, dshape)
        params = init_params(full, built, gen, "cuda")
        pos = STEPS_POOL_SEQ - STEPS_DECODE_STEPS
        cache = primed_cache(built, torch.Generator(device="cuda")
                             .manual_seed(1), "cuda", pos)
        first = first_tokens(full, built, dshape, 0, "cuda")
        logits, _ = lm.decode_step(params, first, cache)
        cache["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
        _step_counters(reset=True)
        tokens, walls = run_steps(built, params, first, cache,
                                  STEPS_DECODE_STEPS, "cuda")
        counts = _step_counters()
        same = bool(torch.equal(tokens[0], logits.argmax(-1).to(torch.int32)))
        what = (f"serve B={STEPS_DECODE_BATCH} over {STEPS_POOL_SEQ} rows, "
                f"{STEPS_DECODE_STEPS} steps from position {pos}")
    res["pool_run"] = {"what": what, "walls_s": walls, "counters": counts,
                       "first_tokens_equal_reference": same,
                       "peak_gb": _peak_gb(),
                       "seconds": time.perf_counter() - t0}
    log(f"[steps r{rank}] 7c pools {res['pools']} (prefill, decode); this "
        f"rank's pool {res['pool']}: {what}: median "
        f"{np.median(walls) * 1e3:.1f} ms a call; B1 "
        f"{counts['flash_attention.launches']}, B2 "
        f"{counts['decode_attention.launches']} launches; first tokens "
        f"equal the unsharded model's: {same}; peak "
        f"{res['pool_run']['peak_gb']:.2f} GB")
    del params, built
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    # 7d: the multi-pod batch over the flattened ("pod", "data"), a whole
    # replica a rank: 8 of the 32 layers, so that two fit the card
    res["train_pod"] = _held_training(
        rank, "7d", dc.replace(full, n_layers=STEPS_POD_LAYERS),
        dc.replace(train_4k, global_batch=STEPS_POD_BATCH), pools[0],
        mesh_pod, opt_cfg)
    res["seconds"] = time.perf_counter() - t_start
    Path(out_dir, f"steps_rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def phase_steps_ranks(report: dict) -> dict:
    """7b, 7c and 7d: two gloo ranks sharing the card (``_steps_rank``), spawned
    with ``torch.multiprocessing``; fails if a rank fails, outlasts what
    is left of STEPS_TIMEOUT_S or finds a result off. Returns the launches
    by path."""
    import os

    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    rdv = out_dir / f"steps_rdv_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    for r in range(STEPS_WORLD):
        (out_dir / f"steps_rank{r}.json").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_steps_rank,
                         args=(r, STEPS_WORLD, str(rdv), str(out_dir)))
             for r in range(STEPS_WORLD)]
    for p in procs:
        p.start()
    limit = STEPS_TIMEOUT_S - report["steps_serve"]["seconds"]
    while any(p.is_alive() for p in procs):
        if time.perf_counter() - t0 > limit or any(
                p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.terminate()
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    rdv.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise SystemExit(f"phase 7b/7c/7d: ranks failed or outlasted "
                         f"{limit:.0f} s (exit codes {bad})")
    ranks = [json.loads((out_dir / f"steps_rank{r}.json").read_text())
             for r in range(STEPS_WORLD)]
    report["steps_ranks"] = {"seconds": secs, "ranks": ranks}
    problems = []
    held = {"train_tp": ("7b", STEPS_TRAIN_LAYERS),
            "train_pod": ("7d", STEPS_POD_LAYERS)}
    for r in ranks:
        for run, (tag, _) in held.items():
            if not all(c["ok"] for c in r[run]["checks"]):
                problems.append(f"rank {r['rank']}: {tag} loss or grad norm "
                                "off")
        if not r["pool_run"]["first_tokens_equal_reference"]:
            problems.append(f"rank {r['rank']}: 7c tokens off")
        if r["pools"] != [[[0]], [[1]]]:
            problems.append(f"pools {r['pools']}")
        # 7d's all-reduces run over the flattened ("pod", "data") alone
        axes = set(r["train_pod"]["counters"]["all_reduce.by_axis"])
        if axes != {"pod+data"}:
            problems.append(f"rank {r['rank']}: 7d all-reduces over {axes}")
    for run, (tag, _) in held.items():
        leaves = ranks[0][run]["leaves"]
        if leaves["n_failed"]:
            problems.append(f"{tag}: {leaves['n_failed']} leaves off: "
                            f"{leaves['failed'][:5]}")
    # each pool's launches, all of them and the sm90 kernel's: one prefill
    # of 32 layers, 16 serve steps of 32
    pool = [ranks[0]["pool_run"]["counters"], ranks[1]["pool_run"]["counters"]]
    got = {"B1 in the prefill pool": (
               pool[0]["flash_attention.launches"],
               pool[0]["flash_attention.launches_sm90"], 32),
           "B2 in the decode pool": (
               pool[1]["decode_attention.launches"],
               pool[1]["decode_attention.launches_sm90"],
               32 * STEPS_DECODE_STEPS),
           "B2 in the prefill pool": (pool[0]["decode_attention.launches"],
                                      0, 0),
           "B1 in the decode pool": (pool[1]["flash_attention.launches"],
                                     0, 0)}
    for what, (n, n_sm90, expected) in got.items():
        if not n == n_sm90 == expected:
            problems.append(f"7c launches: {what} {n} ({n_sm90} sm90), "
                            f"{expected} expected")
    # B1 a layer a step: forward 2 (remat's recompute), backward 1
    for run, (tag, layers) in held.items():
        per_layer = layers * STEPS_TRAIN_STEPS
        fwd = [(r[run]["counters"]["flash_attention.launches"],
                r[run]["counters"]["flash_attention.launches_sm90"])
               for r in ranks]
        bwd = [r[run]["counters"]["flash_attention_bwd.launches"]
               for r in ranks]
        if fwd != [(2 * per_layer,) * 2] * STEPS_WORLD or \
                bwd != [per_layer] * STEPS_WORLD:
            problems.append(f"{tag} B1 launches forward {fwd}, backward "
                            f"{bwd}")
    log(f"[steps] 7b/7c/7d in {secs:.1f} s; peak GB by rank: 7b reference "
        f"{ranks[0]['train_tp']['ref']['peak_gb']:.2f}, tensor-parallel "
        f"{[round(r['train_tp']['peak_gb'], 2) for r in ranks]}; pools "
        f"{[round(r['pool_run']['peak_gb'], 2) for r in ranks]}; 7d "
        f"reference {ranks[0]['train_pod']['ref']['peak_gb']:.2f}, "
        f"data-parallel {[round(r['train_pod']['peak_gb'], 2) for r in ranks]}")
    if problems:
        raise SystemExit(f"phase 7b/7c/7d: {problems}")

    def total(run, name):
        return sum(r[run]["counters"][f"{name}.launches"] for r in ranks)
    return {"steps-train-tp": {
                "flash_attention": total("train_tp", "flash_attention"),
                "flash_attention_bwd": total("train_tp",
                                             "flash_attention_bwd")},
            "steps-train-pod": {
                "flash_attention": total("train_pod", "flash_attention"),
                "flash_attention_bwd": total("train_pod",
                                             "flash_attention_bwd")},
            "steps-pools": {
                "flash_attention": total("pool_run", "flash_attention"),
                "decode_attention": total("pool_run", "decode_attention")}}


def phase_steps(report: dict) -> dict:
    """Phase 7: 7a, then 7b, 7c and 7d; fails past STEPS_TIMEOUT_S."""
    t0 = time.perf_counter()
    by_path = phase_steps_serve(report)
    by_path.update(phase_steps_ranks(report))
    secs = time.perf_counter() - t0
    log(f"[steps] phase 7 in {secs:.1f} s (7a {report['steps_serve']['seconds']:.1f}, "
        f"7b, 7c and 7d {report['steps_ranks']['seconds']:.1f})")
    if secs > STEPS_TIMEOUT_S:
        raise SystemExit(f"phase 7 took {secs:.0f} s, past "
                         f"{STEPS_TIMEOUT_S}")
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["--ab-mlstm"] and len(sys.argv) == 3:
        return ab_mlstm(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-scan"] and len(sys.argv) == 3:
        return ab_scan(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--ab-decode"] and len(sys.argv) == 3:
        return ab_decode(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--profile-check"] and len(sys.argv) == 3:
        return profile_check(int(sys.argv[2]))
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--ab-mlstm DIR | --ab-scan DIR | "
              "--ab-decode DIR | --profile-check N]",
              file=sys.stderr)
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
    t0 = time.perf_counter()
    by_path.update(phase_dist(report))
    secs["6 dist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_path.update(phase_steps(report))
    secs["7 steps"] = time.perf_counter() - t0
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
        # phase 6: B2 on each rank's rows with its lse (6a), B2 and B1 on
        # a rank's heads (6b)
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_lse", "path": "dist-kv_seq"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_tp", "path": "dist-tp"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_tp", "path": "dist-tp"},
        # phase 7a: B1 at prefill_32k's S, B2 over decode_32k's rows
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_32k", "path": "steps-prefill"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_32k", "path": "steps-serve"},
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
        if "replaced_ms" in c:   # B3's backward: the route it replaced
            row["replaced_ms"] = c["replaced_ms"]
        if "ms_without_lse" in c:   # B2 with its lse: the call without it
            row["ms_without_lse"] = c["ms_without_lse"]
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
