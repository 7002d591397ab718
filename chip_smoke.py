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
   16 query heads over 4 KV heads: S=2048; B=4 over 1024 rows); and at
   7g's (a rank's 5 of RecurrentGemma-2B's 10 query heads over its one KV
   head, hd 256: B1 at S=3000 in the 2048 window, B2 over the rotating
   2048 rows, B1's backward at B=2 S=4096; B3 forward at S=3000 and
   backward at B=2 S=4096 on a rank's 1280 of the RG-LRU width); and at
   7h's (a rank's 2 of xLSTM-350M's 4 mLSTM heads of 512: B4 forward and
   backward at B=2 S=1024, the forward at B=1 S=1000);
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
   32 layers), RecurrentGemma-2B (all 26) and xLSTM-350M (8 of its 24
   layers: 7 mLSTM, 1 sLSTM), bf16 parameters and AdamW moments, B=1
   S=4096 (train_4k's sequence), remat on, 4 steps each (the xLSTM 2: its
   sLSTM loop makes a step 44-102 s at 24 layers), printing each step's
   wall, loss, grad norm
   and lr, the peak memory and step 2's device-busy share by
   ``torch.profiler`` (the xLSTM's step 1; for the xLSTM also the sLSTM
   loop's host share);
   each step's launches must match the plan the model's structure
   gives (B1 forward twice and backward once a rematerialised attention
   layer, B3 likewise a rec layer, B4 an mLSTM layer, the hybrid's
   unrolled layers once), and bf16 B1 never runs on the CUDA-core kernel;
   for the xLSTM, B4's backward device time in the profiled step, by
   pass.

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
   ``standard_rules`` on mesh (1, 2), 8 of the 32 layers, the heads, d_ff and
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
   group. 7e, the same two processes: FSDP, ``build_train_step(...,
   param_mode="fsdp")`` on the (1, 2) mesh, every weight and AdamW's m and
   v cut over the flattened ("data", "model") (half of each leaf a rank),
   one layer's weights gathered at a time inside its remat, the same 8
   layers and two rows, held as 7d against the same unsharded reference
   (7d's, kept on the host where ``MemAvailable`` holds it); each rank's
   peak must be below its 7d peak, its all-gathers and all-reduces over
   "data+model" alone. 7f, the same two processes: Phi-3.5-MoE at its
   published widths (16 experts of d_ff 6400, top-2, capacity factor
   1.25, groups of 512; 32 query heads over 8 KV heads), bf16, seeded,
   under ``standard_rules`` on the (1, 2) mesh, each rank its
   ``local_params`` (8 experts, 8 of the router's 16 columns, 16/4 heads,
   16032 of the vocabulary's ids): 7f-train, ``build_train_step`` at 4 of
   its 32 layers, train_4k's sequence at B=1 (8 groups of 512 at capacity
   80), 2 steps held as 7b against rank 0's unsharded run, with the
   reference's MoE routing imposed; 7f-serve, ``build_prefill_step`` and
   ``build_serve_step`` at 8 of its 32 layers, 6b's B=4 prompts of 1000
   tokens into a 1024-row cache and 16 dropless serve steps fed the
   tokens of rank 0's unsharded ``LM.prefill`` and ``LM.decode_step``
   (run first, its logits and routing kept on the host), run once as it
   is (timed) and once with the reference's routing imposed. Every
   choice a run's own gates make otherwise than the reference's must
   have been within ROUTE_GAP_TOL of a tie in the reference's gates (as
   the serve runs, at each pass's first MoE layer); the tokens must
   equal the reference's argmax wherever its top-2 gap exceeds DIST_TOL
   of max |logit| (as it runs, save rows whose own token routed
   otherwise); both must drop choices by capacity in training and in the
   prefill (each ``moe_layer.route`` call's ``fits``), run B1 (8
   in the prefill; forward 2 and backward 1 a layer a training step) and
   B2 (8 a serve step) on the sm90 kernels alone and keep their
   collectives over "model". 7g, the same two processes:
   RecurrentGemma-2B at its published widths, bf16, seeded, under
   ``standard_rules`` on the (1, 2) mesh, each rank its ``local_params``
   (5 of the 10 query heads and the 1 KV head, d_ff 3840, 1280 of the
   RG-LRU width: 4 of the 8 gate blocks, and 128,000 of the 256,000 ids;
   the whole-held gate leaves' gradients summed over "model"): 7g-train,
   ``build_train_step`` at 5 of its 26 layers ((rec, rec, attn) and the
   2 ``rest`` rec layers), train_4k's sequence at B=2, 2 steps held
   as 7b against rank 0's unsharded run, its leaves after the first
   (RG_CHECK_AFTER: after AdamW's first, sign-like update the runs part
   where bf16 flips a near-zero gradient's sign); 7g-fsdp, the same layers and
   rows under ``param_mode="fsdp"``, held against the same reference
   (kept on the host where ``MemAvailable`` holds it); 7g-serve,
   ``build_prefill_step`` and ``build_serve_step`` at all 26 layers, a
   B=1 prompt of 3000 tokens into the rotating 2048-row window (max_len
   4096), 16 serve steps fed the tokens of rank 0's unsharded run in fp32
   (the bf16 draw upcast), rank 0 running the unsharded bf16 model on the
   same feed too: the passes' whole logits and each rank's channels of
   the final h and conv tails must differ from the unsharded bf16
   model's by no more than those differ from the fp32 model's (max |d|
   / max |ref|, the worst pass and the worst leaf: the sharding's change
   within bf16's own rounding, which puts the bf16 model 4-6% of max
   |logit| from the fp32 one, past DIST_TOL), and the tokens equal the
   fp32 model's argmax wherever its top-2 gap exceeds DIST_TOL of max
   |logit|; then the same sharded steps in fp32 (the rank's blocks
   upcast, the caches in fp32) on the same feed, every pass's logits and
   the rank's channels of the rec leaves within SERVE_FP32_TOL = 1e-3 of
   the unsharded fp32 model's. B1 and B3 launch as ``train_plan``
   says in training, B1 8 and B3 18 (on the rank's block of the width)
   in the prefill, B2 8 a serve step, all on the sm90 kernels; the
   collectives over "model" ("data+model" under FSDP). 7h, the same two
   processes: xLSTM-350M at its published widths, bf16, seeded, under
   ``standard_rules`` on the (1, 2) mesh, each rank its ``local_params`` (2
   of the 4 mLSTM heads: 1024 of the 2048 inner columns of w_up, w_gate,
   wq, wk and wv and rows of w_if and w_down; 2048 of the sLSTM's 4096 w_in
   columns and 512 of w_out's 1024 rows; 25,152 of the 50,304 ids; the
   sLSTM's r and b_in whole, their gradients summed over "model"), each
   rank running the sLSTM's recurrence whole. The seeded model amplifies a
   rounding difference from layer to layer (XL_FP32_SEQ), so its long runs
   are held where that does not swamp the sharding's own error: 7h-train32,
   ``build_train_step`` at 8 of its 24 layers (7 mLSTM, 1 sLSTM) in fp32,
   B=2, S=200, 2 steps, the first's loss and grad norm and the leaves after
   it held as 7b against rank 0's unsharded run (XL_CHECK_AFTER: after
   AdamW's first, sign-like update the runs part, and this model amplifies
   it); 7h-train, the same in bf16 at S=1024, its first step's loss and
   grad norm held; 7h-fsdp, the bf16 run's layers and rows under
   ``param_mode="fsdp"`` (the unsharded arithmetic a head), held as 7b
   against 7h-train's reference; 7h-serve, ``build_prefill_step`` and
   ``build_serve_step`` at all 24 layers, a B=1 prompt of 1000 tokens, 16
   serve steps fed the unsharded fp32 model's tokens, the bf16 run reported
   beside bf16's own floor (0.94-1.37 of max |logit| there, so not held),
   and the fp32 run teacher-forced block by block (each block on the
   unsharded fp32 model's input to it, ``_block_io``): every block call's
   change, every pass's logits and every state leaf (the rank's heads of
   each mLSTM state (C, n, m), each sLSTM state whole) within
   SERVE_FP32_TOL, its tokens on clear rows. B4 launches forward and
   backward as ``train_plan`` says in training and 21 times in the prefill,
   on the CUDA kernels alone and on the rank's 2 heads (4 under FSDP; the
   heads of each call of ``models.xlstm``'s ``mlstm_chunk``, recorded); the
   collectives over "model" ("data+model" under FSDP). Phase 2 holds B1 at
   S=32768 (the plain version in blocks of 1024 query rows) and B2 over
   32768 rows at these shapes, at 7f's 16/4 heads in its 6b cases, at 7g's,
   and B4 forward and backward at 7h's (2 heads of 512: B=2 S=1024, and the
   forward at the prefill's B=1 S=1000). A rank that fails, or phase 7 past
   600 s, fails the run.

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

import contextlib
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
# 2 steps, the last profiled, at 8 of its 24 layers (one of its three
# sLSTM layers): at 24 layers a step took 44-102 s on the H100's host (the
# sLSTM loop's host launches), phase 5 324-330 s in two runs against 91 s
# at 8 layers, and with phase 7 at its depths the whole script took 1193 s
# of its 1200 in one run at 24 layers
XLSTM_TRAIN_STEPS = 2
XLSTM_TRAIN_LAYERS = 8
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
# of KV cache beside 16.06 GB of weights); 7b: 8 of the 32 layers, the
# vocabulary cut with the layers (all 32, ~36 GB a rank of blocks, AdamW
# moments, gradients and logits, took ~170 s of the script's 1200 with
# its leaf check: cut to 16 to make room for 7f, to 8 for 7h); 7c: the
# pools; 7d: 8 of the 32 layers, as
# two whole replicas of ~28 GB each (data parallel over the flattened
# ("pod", "data")) must share the one card; 7e: the same 8 layers under
# FSDP. 7e's collectives are staged through the host on gloo: at 7d's rate
# (11.18 GB in ~25 s) a step's ~5.6 GB of forward gathers, ~3.5 GB of
# recompute gathers and ~5.6 GB of backward all-reduces come to ~33 s, so
# 8 layers keep phase 7 near 290 s of its 600; all 32 (~38 GB a rank,
# ~200 s of collectives) wait for NCCL
STEPS_PREFILL_BATCH = 1
LONG_SEQ = 32768                # prefill_32k's and decode_32k's rows
STEPS_DECODE_BATCH = 8
STEPS_DECODE_POS = 32752        # the 16 steps write the cache's last rows
STEPS_DECODE_STEPS = 16
STEPS_TRAIN_LAYERS = 8
STEPS_TRAIN_STEPS = 2
STEPS_POD_LAYERS = 8
STEPS_POD_BATCH = 2
STEPS_POOL_SEQ = 4096
STEPS_WORLD = 2
STEPS_TIMEOUT_S = 600
# 7f: Phi-3.5-MoE at its published widths on the same (1, 2) mesh, its 16
# experts over "model" (8 a rank) with the heads, d_ff and the vocabulary.
# Training at 4 of its 32 layers: 5.46e9 parameters, ~43.7 GB of bf16
# parameters, gradients and moments unsharded (the reference), ~21.9 GB a
# rank (8 layers would need ~84 GB for the two ranks); train_4k's sequence
# at B=1 makes 8 groups of 512 at capacity 80, so choices are dropped.
# Serving at 8 of 32 layers (16 until 7h came): 10,665,136,128
# parameters, 21.3 GB whole (the reference), ~10.7 GB a rank; 6b's
# prompts, cache and steps (DIST_TP).
# The host-staged all-reduces come to ~1.3 GB a training step and ~2 GB a
# prefill: at 7b's ~0.4 GB/s, 7f should take 60-120 s of phase 7's 600
STEPS_MOE_TRAIN_LAYERS = 4
STEPS_MOE_SERVE_LAYERS = 8
# 7g: RecurrentGemma-2B at its published widths on the same (1, 2) mesh,
# its RG-LRU width over "model" with the heads, d_ff and the vocabulary: a
# rank holds 5 of the 10 query heads and the 1 KV head, d_ff 3840, 1280 of
# the width (4 of the 8 gate blocks) and 128,000 of the 256,000 ids.
# Training at 5 of its 26 layers ((rec, rec, attn) and the 2 rest rec
# layers; 1,705,356,800 parameters; 8 until 7h came), train_4k's sequence
# at B=2 (FSDP's
# batch must split over its two ranks, and 7g-train and 7g-fsdp share one
# unsharded reference, as 7d and 7e do); serving at all 26
# (3,343,495,680): a B=1 prompt (B=2 took the whole script past 1000 s) of
# 3000 tokens into the rotating 2048-row window (max_len 4096), 16 steps
# fed the tokens of the unsharded model in
# fp32. Its logits and final rec states are held to bf16's own rounding:
# the unsharded bf16 model is 4-6% of max |logit| from the fp32 one there
# (on the H100), past DIST_TOL, so the sharded run's distance to
# the bf16 model may not exceed the bf16 model's to the fp32 one
STEPS_RG_TRAIN_LAYERS = 5
STEPS_RG_BATCH = 2
RG_SERVE = {"batch": 1, "prompt": 3000, "max_len": 4096, "steps": 16}
# the same sharded prefill and steps with the bf16 draw upcast to fp32,
# its caches in fp32, against the unsharded fp32 model on the same feed:
# max |d| / max |ref| of every pass's logits and of each rank's channels of
# every rec leaf after the steps (the sharding's own error, which bf16's
# 4-6% would hide)
SERVE_FP32_TOL = 1e-3
# 7g's leaves are held after its first step: AdamW's first update is about
# lr sign(g) for every value, so wherever bf16 rounding flips the sign of a
# near-zero gradient the two runs part by 2 lr there, and the second
# step's gradients inherit it (the last rec layer's w_in's v landed at
# 0.076-0.102 of max |v| after step 2 in five runs, past 0.1 in two; after
# step 1 every leaf's m within 0.044 and v within 0.085, on the H100);
# both steps' loss and grad norm are held as 7b's
RG_CHECK_AFTER = 1
RG_TP_HEADS = (5, 1, 256)          # a rank's of recurrentgemma-2b over 2
RG_TP_WIDTH = 1280                 # a rank's RG-LRU width over 2
# 7h: xLSTM-350M at its published widths on the same (1, 2) mesh, the
# mLSTM's inner width and heads and the sLSTM's gate columns over "model"
# with the vocabulary: a rank holds 2 of the 4 mLSTM heads (1024 of the
# 2048 inner columns), 2048 of the sLSTM's 4096 w_in columns and 512 of
# w_out's 1024 rows, and 25,152 of the 50,304 ids; each rank runs the
# sLSTM's recurrence whole. Training at 8 of its 24 layers (one group:
# 7 mLSTM, 1 sLSTM; 241,562,680 parameters) at B=2 (FSDP's batch splits
# over the two ranks; 7h-train and 7h-fsdp share one unsharded reference,
# as 7g's do) and S=1024, not train_4k's 4096: the sLSTM loop's launches
# hold a step (phase 5: ~15-30 s a step at 8 layers and S=4096), and both
# ranks and the reference walk it; serving at all 24 (518,640,808): a B=1
# prompt of 1000 tokens (past B4's 64-step chunks, not a multiple of them),
# 16 steps fed the unsharded fp32 model's tokens, held as 7g-serve
STEPS_XL_TRAIN_LAYERS = 8
STEPS_XL_BATCH = 2
STEPS_XL_SEQ = 1024
XL_SERVE = {"batch": 1, "prompt": 1000, "max_len": 4096, "steps": 16}
# 7h's leaves are held after its first step, for 7g's reason
# (RG_CHECK_AFTER): AdamW's first update is about lr sign(g) for every
# value, so wherever rounding flips the sign of a near-zero gradient the
# runs part by 2 lr and the second step's gradients carry it, which this
# model amplifies (XL_FP32_SEQ): the tensor-parallel runs hold their first
# step's loss and grad norm alone, FSDP (the unsharded arithmetic a head)
# both steps'
XL_CHECK_AFTER = 1
# The seeded xLSTM-350M amplifies a rounding difference from layer to layer
# (as C3's gradients show; ``launch.check_xlstm_tp`` holds the sharding
# itself in fp64 on the CPU): after 24 layers and 1000 tokens the unsharded
# bf16 model's logits are 95-137% of max |logit| from the fp32 one's, and
# the sharded fp32 run's 8.5-33% from the unsharded fp32 run's. So
# 7h-serve's fp32 run is held block by block, each block run on the
# unsharded model's input to it (``_block_io``). A training step parts the
# runs too: after AdamW's first, sign-like update (XL_CHECK_AFTER) the
# second step's grad norm lay 32% (bf16, S=1024) and 27% (fp32, S=200) from
# the unsharded run's. So 7h-train's bf16 run holds the loss and grad norm
# of its first step, and the same training in fp32 at a short sequence
# (7h-train32, XL_FP32_SEQ) holds them and every leaf after that step as 7b
# (the leaves 0.16-0.30 of their tolerance, on the H100)
XL_FP32_SEQ = 200
XL_TP_HEADS = 2                    # a rank's mLSTM heads of xlstm-350m
XL_TP_HD = 512                     # its mLSTM head dim (2 d_model / 4)
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
# 7f: where a sharded run's own gates choose another expert than the
# reference did, the reference's gate gap there (the margin its argmax won
# by, in logits) must be at most this. The seeded router's logits have a
# spread of about 0.02 sqrt(4096) = 1.28 over the 16 experts, and the gap
# between a token's two largest of them is 0.54 on average: a routing
# taken from wrong gates differs at gaps of that size, while the runs'
# rounding can only cross a near tie
ROUTE_GAP_TOL = 0.25


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
                    window=None, B: int = 1) -> dict:
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
    q = torch.randn((B, Sq, HQ, HD), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Skv, KV, HD), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Skv, KV, HD), generator=gen, device="cuda").to(dtype)
    do = torch.randn((B, Sq, HQ, HD), generator=gen, device="cuda").to(dtype)
    lse = torch.empty((B, HQ, Sq), device="cuda")
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
    plan = plan_bwd(B, Sq, Skv, HQ, KV, HD, dtype)
    shape = ((f"B={B} " if B > 1 else "") +
             f"Sq={Sq} Skv={Skv} Hq={HQ} K={KV} hd={HD} "
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
    pairs = B * float(np.sum(hi - lo + 1))
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


def _hybrid_cases(gen) -> dict:
    """The kernels at 7g's shapes, a rank's of RecurrentGemma-2B over two:
    B1 (5 query heads over its one KV head, hd 256) at the serve's
    3000-token prompt in the 2048 window, B2 over the rotating 2048 rows
    at the last serve step's position, B1's backward at the training's
    B=2 S=4096; B3 on 1280 of the RG-LRU width, forward at the prefill's
    S=3000, backward at the training's B=2 S=4096. Returns
    the table's case name -> (the kernel's list in ``phase_kernels``, the
    case)."""
    bf16 = torch.bfloat16
    B = RG_SERVE["batch"]
    return {
        "flash_attention_rg_tp": ("flash_attention", _flash_case(
            RG_SERVE["prompt"], 2048, bf16, gen, RG_TP_HEADS)),
        "decode_attention_rg_tp": ("decode_attention", _decode_case(
            [RG_SERVE["prompt"] + RG_SERVE["steps"] - 1] * B, 2048, bf16,
            gen, RG_TP_HEADS, B=B)),
        "rglru_scan_tp": ("rglru_scan", _scan_case(
            B, RG_SERVE["prompt"], RG_TP_WIDTH, gen, model_gates=True)),
        "flash_attention_bwd_rg_tp": ("flash_attention_bwd", _flash_bwd_case(
            TRAIN_SEQ, TRAIN_SEQ, RG_TP_HEADS, bf16, gen, window=2048,
            B=STEPS_RG_BATCH)),
        "rglru_scan_bwd_tp": ("rglru_scan_bwd", _scan_bwd_case(
            STEPS_RG_BATCH, TRAIN_SEQ, RG_TP_WIDTH, gen))}


def _xlstm_cases(gen) -> dict:
    """B4 at 7h's shapes, a rank's 2 of xLSTM-350M's 4 mLSTM heads of 512:
    forward and backward at the training's B=2 S=1024 from a fresh state,
    and forward at the serve's prefill, B=1 S=1000. Returns the table's
    case name -> (the kernel's list in ``phase_kernels``, the case)."""
    B, S = STEPS_XL_BATCH, STEPS_XL_SEQ
    nh, hd = XL_TP_HEADS, XL_TP_HD
    return {
        "mlstm_chunk_tp": ("mlstm_chunk", _mlstm_case(
            B, S, nh, hd, False, gen)),
        "mlstm_chunk_tp_prefill": ("mlstm_chunk", _mlstm_case(
            XL_SERVE["batch"], XL_SERVE["prompt"], nh, hd, False, gen)),
        "mlstm_chunk_bwd_tp": ("mlstm_chunk_bwd", _mlstm_bwd_case(
            B, S, nh, hd, False, gen))}


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
    cases["rglru_scan_bwd"] = [_scan_bwd_case(1, TRAIN_SEQ, 2560, gen)]
    main["rglru_scan_bwd"] = cases["rglru_scan_bwd"][0]
    for key, (name, c) in _hybrid_cases(gen).items():
        cases[name].append(c)
        main[key] = c
    # B4's at xlstm-350m's training shape, then ragged chunks from a state
    cases["mlstm_chunk_bwd"] = [
        _mlstm_bwd_case(1, TRAIN_SEQ, 4, 512, False, gen),
        _mlstm_bwd_case(2, 300, 2, 256, True, gen)]
    main["mlstm_chunk_bwd"] = cases["mlstm_chunk_bwd"][0]
    for key, (name, c) in _xlstm_cases(gen).items():
        cases[name].append(c)
        main[key] = c
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
                n_steps: int = TRAIN_STEPS, n_layers=None) -> dict:
    """Train ``arch`` at its published shape on one card through
    ``train()``: bf16 parameters (the RG-LRU's lam fp32), AdamW with bf16
    moments, B=1, S=4096 from ``TokenStream(seed=0)``, remat on, ``n_steps``
    steps, at ``n_layers`` of its layers where given.
    Prints each step's wall, loss, grad norm and lr, the peak memory, and
    the device-busy share of step 2 (the last where there are fewer steps)
    by torch.profiler (and the host share
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
    if n_layers is not None:           # the depth cut, the widths kept
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
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
    profiled = min(2, n_steps - 1)

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
        if step == profiled - 1:
            prof.start()
        elif step == profiled:
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
    wall_ms = 1e3 * steps[profiled]["wall_s"]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    shares = {}
    for name, (_, ms) in by_kernel.items():
        kind = next((k for k, pat in DEVICE_KINDS
                     if re.search(pat, name, re.IGNORECASE)),
                    "other")
        shares[kind] = shares.get(kind, 0.0) + ms
    log(f"[{tag}] {n_params} parameters; {run_s:.1f} s in all (weights and "
        f"moments drawn included); peak memory {peak_gb:.2f} GB")
    log(f"[{tag}] step {profiled} under torch.profiler: device busy "
        f"{device_ms:.1f} "
        f"ms of {wall_ms:.1f} ms wall = {device_ms / wall_ms:.3f}; top "
        "device kernels (launches, ms): " +
        "; ".join(f"{k[:60]}: {n}, {ms:.1f}" for k, (n, ms) in top))
    log(f"[{tag}] step {profiled}'s device ms by kind: " + ", ".join(
        f"{k} {ms:.1f}" for k, ms in sorted(shares.items(),
                                             key=lambda kv: -kv[1])))
    b4_bwd = {}   # B4's backward by pass: (launches, ms)
    for name, (n, ms) in by_kernel.items():
        m = re.search(B4_BWD_KERNELS, name)
        if m:
            b4_bwd[m.group()] = (n, ms)
    if b4_bwd:
        b4_ms = sum(ms for _, ms in b4_bwd.values())
        log(f"[{tag}] step {profiled}: B4 backward {b4_ms:.2f} ms of device "
            "time; "
            f"by pass (launches, ms): {b4_bwd}")
    log(f"[{tag}] step {profiled}: {sum(n for n, _ in by_kernel.values())} "
        "device "
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


def _greedy(lm, params, tokens, max_len: int, steps: int,
            keep_cache: bool = False, dtype=torch.bfloat16):
    """Prefill and ``steps`` greedy decode steps, the cache in ``dtype``:
    (the logits of each, as fp32 (steps + 1, B, V) on the host; the fed
    tokens (B, steps); where ``keep_cache``, also the cache after the last
    step)."""
    cache = lm.init_cache(tokens.shape[0], max_len, dtype=dtype,
                          device="cuda")
    logits, cache = lm.prefill(params, {"tokens": tokens}, cache)
    outs, fed = [logits.float().cpu()], []
    for _ in range(steps):
        fed.append(logits.argmax(-1))
        logits, cache = lm.decode_step(params, fed[-1], cache)
        outs.append(logits.float().cpu())
    if keep_cache:
        return torch.stack(outs), torch.stack(fed, 1), cache
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
           "all_reduce": SH.all_reduce, "all_gather": SH.all_gather}
    collective = ("calls", "bytes", "seconds", "host_staged")
    attrs = {"flash_attention": ("launches", "launches_sm90"),
             "decode_attention": ("launches", "launches_sm90",
                                  "launches_lse"),
             "all_reduce": collective, "all_gather": collective}
    if reset:
        for name, fn in fns.items():
            for a in attrs[name]:
                setattr(fn, a, 0 if a != "seconds" else 0.0)
        SH.all_reduce.by_axis = {}
        SH.all_gather.by_axis = {}
    out = {f"{name}.{a}": getattr(fn, a) for name, fn in fns.items()
           for a in attrs[name]}
    # mesh axes ("pod+data" flattened) -> [count, bytes]
    for name in ("all_reduce", "all_gather"):
        out[f"{name}.by_axis"] = {k: list(v) for k, v in
                                  fns[name].by_axis.items()}
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
    from repro_torch.models.vocab import whole_logits
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
    """B1 forward (all, sm90), B1 backward, B2 (all, sm90), B3 forward and
    backward, B4 forward and backward (and the heads B4 ran on) and the
    all-reduces and all-gathers (count, bytes, host seconds), set to 0
    where ``reset``."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda,
    )
    from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_bwd_cuda,
                                                        mlstm_chunk_cuda)
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd_cuda,
                                                       rglru_scan_cuda)
    out = _counters(reset)
    fns = {"flash_attention_bwd": flash_attention_bwd_cuda,
           "rglru_scan": rglru_scan_cuda,
           "rglru_scan_bwd": rglru_scan_bwd_cuda,
           "mlstm_chunk": mlstm_chunk_cuda,
           "mlstm_chunk_bwd": mlstm_chunk_bwd_cuda}
    for name, fn in fns.items():
        if reset:
            fn.launches = 0
        out[f"{name}.launches"] = fn.launches
    if reset:
        _MLSTM_HEADS.clear()
    out["mlstm_chunk.heads"] = sorted(set(_MLSTM_HEADS))
    return out


# the heads (q's dim 2) of each call the xLSTM's blocks made of the
# chunkwise mLSTM since the counters were last set to 0, in a process of
# phase 7's ranks (``_record_mlstm_heads``)
_MLSTM_HEADS: list = []


def _record_mlstm_heads() -> None:
    """Wrap ``models.xlstm``'s call of B4's entry point so that each call's
    heads (the rank's: q is (B, S, nh, hd)) are kept in _MLSTM_HEADS."""
    from repro_torch.models import xlstm
    chunk = xlstm.mlstm_chunk

    def recorded(q, *args):
        _MLSTM_HEADS.append(int(q.shape[2]))
        return chunk(q, *args)
    xlstm.mlstm_chunk = recorded


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
    run (7b, 7d, 7e) against rank 0's unsharded reference: each parameter's
    change from its initial value, AdamW's m and v. ``init``: this rank's
    parameters before the steps, on the host. ``ref`` (rank 0 only): part
    -> path -> the unsharded leaf after the steps on the host, for the
    parts "params", "m" and "v". The other ranks send their blocks (and
    initial values) to rank 0 (through the host), which cuts each
    reference leaf to the sender's block along the dim ``blocks`` cuts
    (rank 0's block moved by the sender's coordinate along the cut axes,
    which is its rank: over "model" of the (1, n) mesh in 7b, over the
    flattened ("data", "model") of the same mesh under FSDP in 7e; whole
    where ``blocks`` lists no cut) and compares on the
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


@contextlib.contextmanager
def _routes(calls: list, impose: list | None = None):
    """While the context lasts, each ``moe_layer.route`` call appends to
    ``calls``, on the device: the experts its own gates choose
    (``expert``, (N, g, k)), their gate gaps (``gap``, ``_gate_gaps``),
    whether each choice it routes fits its expert's capacity (``fits``)
    and the choices it dropped (``dropped``). ``impose``, another
    run's ``expert`` call by call: each call routes those in place of its
    own (``route``'s ``chosen``), so that the two runs take the same
    choices; ``expert`` stays what its own gates chose."""
    from repro_torch.models import moe_layer
    route = moe_layer.route
    queue = list(impose or [])

    def wrapped(gates, k, C, *args, **kw):
        own = route(gates, k, C, *args, **kw)
        r = own if impose is None else route(
            gates, k, C, *args, chosen=queue.pop(0).to(gates.device), **kw)
        # detached: a gap kept with the gates' graph would keep each
        # layer's activations, remat's recompute's too, alive
        calls.append({"expert": own.expert,
                      "gap": _gate_gaps(gates.detach(), k),
                      "fits": r.fits, "dropped": (~r.fits).sum()})
        return r
    moe_layer.route = wrapped
    try:
        yield
    finally:
        moe_layer.route = route


def _gate_gaps(gates, k: int):
    """(N, g, k): for each token's round-j choice, the least margin by
    which its argmax won rounds 0..j, in logits (log-gates): a choice
    differs from another run's only where a perturbation crossed one of
    these margins, since an earlier round that went the other way changes
    every later one."""
    top = gates.topk(k + 1, dim=-1).values.clamp_min(1e-30).log()
    return torch.cummin(top[..., :-1] - top[..., 1:], dim=-1).values


def _host_routes(calls: list) -> dict:
    """``_routes``' record on the host: each call's ``expert``, ``gap``
    and ``fits``, and the choices dropped in all."""
    return {"expert": [c["expert"].cpu() for c in calls],
            "gap": [c["gap"].float().cpu() for c in calls],
            "fits": [c["fits"].cpu() for c in calls],
            "dropped": int(sum(int(c["dropped"]) for c in calls))}


def _routes_from_rank0(routes: dict, rank: int) -> dict:
    """Rank 0's ``_host_routes`` record (its lists) on every rank."""
    return {name: [t.to(torch.bool) if name == "fits" else t for t in
                   _list_from_rank0(routes.get(name, []), rank, dtype)]
            for name, dtype in (("expert", torch.long),
                                ("gap", torch.float32),
                                ("fits", torch.long))}


def _list_from_rank0(ts: list, rank: int, dtype) -> list:
    """Rank 0's list of tensors (of ``dtype``, on the host) on every
    rank."""
    import torch.distributed as dist
    n = torch.tensor([len(ts)])
    dist.broadcast(n, src=0)
    shapes = torch.tensor([list(t.shape) for t in ts] if rank == 0 else
                          [[0, 0, 0]] * int(n), dtype=torch.long)
    dist.broadcast(shapes, src=0)
    sizes = shapes.prod(1).tolist()
    flat = torch.cat([t.reshape(-1).to(dtype) for t in ts]) if rank == 0 \
        else torch.empty(sum(sizes), dtype=dtype)
    dist.broadcast(flat, src=0)
    return [t.view(*shp) for t, shp in zip(flat.split(sizes),
                                           shapes.tolist())]


def _route_check(ref: dict, run: dict, passes: int,
                 first_call_only: bool) -> dict:
    """A run's MoE choices (``run``, as ``_host_routes`` keeps them, call
    by call, ``passes`` passes of equally many calls over one token grid
    each: a training step with remat's recompute, a prefill, a serve step)
    against the reference's (``ref``). Where a choice's expert differs,
    the reference's gate gap (``_gate_gaps``) says how near a tie it was;
    the largest gap among the held choices must be at most ROUTE_GAP_TOL.
    ``first_call_only`` (a run that routes for itself): only each pass's
    first call is held, the first MoE layer, where none of the run's
    choices has yet gone another way, so that nothing but the runs'
    rounding parts their gates; at a later layer a token's inputs differ
    once it, a token it attends to or one sharing its group's capacity
    went another way. Else (the reference's routing imposed) every
    differing choice is held. Returns the counts, the largest gap held,
    by call of the pass the largest gap of a token's first differing
    choice and the choices of the same expert whose fit differs (a
    capacity slot taken or freed by a choice that went another way), and
    the unchanged choices' median gap and how many of them lie within the
    largest held one."""
    expert, ref_expert, ref_gap = run["expert"], ref["expert"], ref["gap"]
    per = len(expert) // passes
    if per * passes != len(expert) or len(expert) != len(ref_expert):
        raise ValueError(f"{len(expert)} calls for {len(ref_expert)} of "
                         f"the reference's in {passes} passes")
    n = n_diff = 0
    held, same = [], []
    by_call, fit_by_call = [0.0] * per, [0] * per
    for p in range(passes):
        seen = None
        for c in range(per):
            i = p * per + c
            diff = expert[i] != ref_expert[i]                    # (N, g, k)
            tok = diff.any(-1)
            first = tok if seen is None else tok & ~seen
            seen = tok if seen is None else seen | tok
            j = diff.int().argmax(-1, keepdim=True)       # first round off
            gap_first = ref_gap[i].gather(-1, j)[..., 0][first]
            if gap_first.numel():
                by_call[c] = max(by_call[c], float(gap_first.max()))
            fit_by_call[c] += int(((run["fits"][i] != ref["fits"][i])
                                   & ~diff).sum())
            if c == 0 or not first_call_only:
                held.append(ref_gap[i][diff])
            same.append(ref_gap[i][~diff])
            n += diff.numel()
            n_diff += int(diff.sum())
    held_t, same_t = torch.cat(held), torch.cat(same)
    top = float(held_t.max()) if held_t.numel() else 0.0
    return {"choices": n, "differ": n_diff, "held_differ": held_t.numel(),
            "held": "first call a pass" if first_call_only else "all",
            "max_gap": top, "tol": ROUTE_GAP_TOL,
            "max_first_gap_by_call": by_call,
            "fit_differ_by_call": fit_by_call,
            "same_median_gap": float(same_t.median()),
            "same_within_max_gap": int((same_t <= top).sum()),
            "ok": top <= ROUTE_GAP_TOL}


def _route_log(check: dict) -> str:
    return (f"{check['differ']} of {check['choices']} MoE choices differ "
            f"from the reference's; the largest reference gate gap of the "
            f"{check['held_differ']} held ({check['held']}) "
            f"{check['max_gap']:.4g} logits (tol {check['tol']}), of the "
            f"others the median {check['same_median_gap']:.4g}, "
            f"{check['same_within_max_gap']} within that largest: "
            f"{check['ok']}; by call of the pass, a token's first differing "
            f"choice's largest gap "
            f"{[round(g, 4) for g in check['max_first_gap_by_call']]} and "
            f"the choices of the same expert whose fit differs "
            f"{check['fit_differ_by_call']}")


def _held_training(rank: int, tag: str, cfg, shape, ref_mesh, mesh,
                   opt_cfg, param_mode: str = "2d", reference=None,
                   keep: bool = False,
                   check_after: int = STEPS_TRAIN_STEPS,
                   dtype=torch.bfloat16) -> tuple:
    """Train ``cfg`` on ``shape`` for STEPS_TRAIN_STEPS steps through
    ``build_train_step(..., param_mode=param_mode)`` on ``mesh`` and hold
    it against rank 0's run of the same steps on ``ref_mesh`` (its
    one-rank pool, unsharded, every row of the batch), run first while the
    other ranks wait with nothing allocated, its parameters and moments
    kept on the host and the card freed: each step's loss and grad norm
    within TRAIN_TP_LOSS_TOL and TRAIN_TP_GNORM_TOL of the reference's,
    then ``_train_check``. Both draw the weights from seed 0 and the
    batches from ``TokenStream``'s seed 0. A model with MoE FFNs runs
    the reference's routing, broadcast from rank 0 (``_routes``: in bf16
    a choice near a gate tie can go the other way in one run and not the
    other, after which the runs part, as the prompts' tokens are fed in
    the serves), and every choice its own gates would have routed
    otherwise must have been within ROUTE_GAP_TOL of a tie in the
    reference (``_route_check``); the choices dropped by capacity are
    counted (forward and remat's recompute). ``reference`` (rank 0): an
    earlier call's kept reference of the same ``cfg``, ``shape`` and
    ``opt_cfg``, used in place of running it again. ``check_after``: the
    step after which the leaves are held (the reference's are kept then,
    the run's checked then and the steps go on). ``dtype``: the
    parameters' (and the activations'). Returns (the reference's
    and the run's steps, launches, collectives, peaks and checks; on rank 0
    where ``keep``, the reference for a later call, else None)."""
    import torch.distributed as dist

    from repro_torch.launch.shardspecs import param_blocks
    from repro_torch.launch.steps import (build_train_step, init_params,
                                          materialize)
    from repro_torch.launch.train import local_batches
    from repro_torch.models.params import flatten

    def train(built, what, at_check, keep_init):
        """The steps, ``at_check(params, opt, init)`` called after step
        ``check_after`` (``init``: the parameters drawn before the steps,
        on the host, where ``keep_init``)."""
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, built, gen, "cuda")
        init = {k: t.to("cpu", copy=True)
                for k, t in flatten(params).items()} if keep_init else None
        opt = materialize(built.args[1], "cuda")
        batches = local_batches(cfg, built, shape, 0, "cuda")
        steps = []
        _step_counters(reset=True)
        for i in range(STEPS_TRAIN_STEPS + 1):
            if i == check_after:
                at_check(params, opt, init)
            if i == STEPS_TRAIN_STEPS:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = built.fn(params, opt, next(batches))
            m = {k: float(v) for k, v in m.items()}
            m["wall_s"] = time.perf_counter() - t0
            steps.append(m)
            log(f"[steps r{rank}] {tag} {what} step {i}: {m['wall_s']:.2f} "
                f"s, loss {m['loss']:.6f}, grad norm {m['grad_norm']:.6f}, "
                f"lr {m['lr']:.3g}")
        return params, opt, steps, _step_counters()

    res = {}
    routes: list = []           # the reference's MoE routing, call by call
    moe = bool(cfg.n_experts)
    if moe and reference is not None:
        raise ValueError(f"{tag}: a kept reference holds no MoE routing")
    if rank == 0:
        log(f"[steps r0] {tag}: host MemAvailable "
            f"{_mem_available_gb():.1f} GB before the reference")
    torch.cuda.reset_peak_memory_stats()
    ref = None
    if rank == 0 and reference is not None:
        res["ref"], ref = reference
        res["ref"] = dict(res["ref"], reused=True)
        log(f"[steps r0] {tag}: the reference reused (kept on the host)")
    elif rank == 0:
        built = build_train_step(cfg, ref_mesh, shape, dtype,
                                 opt_cfg=opt_cfg)
        ref = {}

        def keep_ref(params, opt, _):
            ref.update(
                params={k: t.cpu() for k, t in flatten(params).items()},
                m={k: t.cpu() for k, t in flatten(opt["m"]).items()},
                v={k: t.cpu() for k, t in flatten(opt["v"]).items()})
        with _routes(routes):
            params, opt, steps, counts = train(built, "unsharded", keep_ref,
                                               False)
        routes = _host_routes(routes)
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
    built = build_train_step(cfg, mesh, shape, dtype, opt_cfg=opt_cfg,
                             param_mode=param_mode)
    # a model with MoE FFNs runs the reference's routing (a choice near a
    # gate tie may go the other way in bf16, and the runs then part, as
    # fed tokens keep a serve's runs together); the choices its own
    # argmax would have taken otherwise are held to the reference's gaps
    calls: list = []
    if moe:
        routes = _routes_from_rank0(routes if rank == 0 else {}, rank)

    def check_leaves(params, opt, init):
        # the training's cached blocks back to the card, on every rank
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["leaves"] = _train_check(rank, param_blocks(cfg, mesh,
                                                        built.rules),
                                     params, opt, init, ref)
        res["leaf_check_s"] = time.perf_counter() - t0
    with _routes(calls, routes["expert"]) if moe else \
            contextlib.nullcontext():
        params, opt, steps, counts = train(built, "sharded", check_leaves,
                                           True)
    checks = []
    if moe:
        run = _host_routes(calls)
        counts["moe.dropped"] = run["dropped"]
        res["routes"] = _route_check(routes, run, STEPS_TRAIN_STEPS,
                                     first_call_only=False)
        checks.append({"routes": True, "ok": res["routes"]["ok"]})
        log(f"[steps r{rank}] {tag}, the reference's routing imposed, its "
            f"own gates (forward and remat's recompute, {STEPS_TRAIN_STEPS} "
            f"steps): {_route_log(res['routes'])}")
    for s, want in zip(steps, ref_steps):
        loss_err = abs(s["loss"] - float(want[0])) / abs(float(want[0]))
        gn_err = abs(s["grad_norm"] - float(want[1])) / abs(float(want[1]))
        checks.append({"loss_rel": loss_err, "grad_norm_rel": gn_err,
                       "ok": loss_err <= TRAIN_TP_LOSS_TOL and
                       gn_err <= TRAIN_TP_GNORM_TOL})
    n_local = sum(t.numel() for t in flatten(params).values())
    res.update(steps=steps, counters=counts, checks=checks,
               local_parameters=n_local, peak_gb=_peak_gb())
    for i, c in enumerate(c for c in checks if "routes" not in c):
        log(f"[steps r{rank}] {tag} step {i} against unsharded: loss "
            f"{c['loss_rel']:.3g} (tol {TRAIN_TP_LOSS_TOL}), grad norm "
            f"{c['grad_norm_rel']:.3g} (tol {TRAIN_TP_GNORM_TOL}) of the "
            f"reference's: {c['ok']}")
    log(f"[steps r{rank}] {tag}: {n_local} parameters on this rank; step "
        f"walls {[round(s['wall_s'], 2) for s in steps]} s; B1 "
        f"forward {counts['flash_attention.launches']} "
        f"({counts['flash_attention.launches_sm90']} sm90), backward "
        f"{counts['flash_attention_bwd.launches']}; "
        + (f"B3 forward {counts['rglru_scan.launches']}, backward "
           f"{counts['rglru_scan_bwd.launches']}; "
           if cfg.family == "hybrid" else "")
        + (f"B4 forward {counts['mlstm_chunk.launches']}, backward "
           f"{counts['mlstm_chunk_bwd.launches']} on heads "
           f"{counts['mlstm_chunk.heads']}; " if cfg.family == "ssm" else "") +
        f"all-reduces "
        f"{counts['all_reduce.calls']} ({counts['all_reduce.bytes']} bytes, "
        f"{counts['all_reduce.seconds']:.2f} host s; [count, bytes] by mesh "
        f"axes {counts['all_reduce.by_axis']}); all-gathers "
        f"{counts['all_gather.calls']} ({counts['all_gather.bytes']} bytes, "
        f"{counts['all_gather.seconds']:.2f} host s; by mesh axes "
        f"{counts['all_gather.by_axis']}); "
        + (f"MoE choices dropped by capacity {counts['moe.dropped']}; "
           if moe else "") + f"peak {res['peak_gb']:.2f} GB")
    leaves = res["leaves"]
    if rank == 0:
        log(f"[steps r0] {tag} after step {check_after}: every rank's "
            f"parameter blocks' change from their initial values, AdamW m "
            f"and v against the unsharded step's, leaf by leaf: worst error "
            f"over its tolerance {leaves['worst_over_tol']} (the change "
            f"within {TRAIN_TP_DELTA_TOL} of the norm of the reference's, "
            f"m and v within {TRAIN_TP_MOMENT_TOL} max |ref|); "
            f"{leaves['n_failed']} leaves past it; the steps moved "
            f"{leaves['moved_share']:.4f} of the compared parameter values; "
            f"{res['leaf_check_s']:.1f} s")
    kept = (res["ref"], ref) if keep and rank == 0 else None
    del params, opt, built, ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res, kept



def _tokens_check(tokens, ref, rerouted=None) -> dict:
    """Tokens (n, B) against the argmax of the reference's logits (n, B,
    V), wherever a row's top-2 gap exceeds DIST_TOL of its step's max
    |logit| (6b's test, ``_logits_check``, on tokens alone). ``rerouted``
    (n, B): rows whose own token took another MoE choice than the
    reference's at some layer (held by ``_route_check``), whose logits are
    another function's and so are not held; the largest top-2 gap (of max
    |logit|) among the rows that differ is reported."""
    r = ref.float()
    top = r.abs().flatten(1).amax(1)[:, None]
    t2 = r.topk(2, dim=-1).values
    gap = (t2[..., 0] - t2[..., 1]) / top
    clear = gap > DIST_TOL
    if rerouted is None:
        rerouted = torch.zeros_like(clear)
    held = clear & ~rerouted
    agree = tokens.long() == r.argmax(-1)
    return {"agree": float(agree.float().mean()),
            "clear_rows": int(clear.sum()),
            "rerouted_rows": int(rerouted.sum()),
            "held_rows": int(held.sum()),
            "differ_on_clear": int((~agree & clear).sum()),
            "differ_on_held": int((~agree & held).sum()),
            "max_gap_differ": float(gap[~agree].max()) if (~agree).any()
            else 0.0,
            "ok": bool(agree[held].all())}


def _rows_rerouted(ref_expert: list, expert: list,
                   rows: list) -> torch.Tensor:
    """(passes, B): whether the token each output row reads (``rows[p]``,
    its index in pass p's token grid flattened) took another MoE choice
    than the reference's in any call of its pass (``_route_check``'s
    passes of equally many calls)."""
    per = len(expert) // len(rows)
    out = torch.zeros((len(rows), len(rows[0])), dtype=torch.bool)
    for p, idx in enumerate(rows):
        for i in range(p * per, (p + 1) * per):
            d = (expert[i] != ref_expert[i]).any(-1).reshape(-1)
            out[p] |= d[torch.as_tensor(idx)]
    return out


def _moe_serve(rank: int, cfg, mesh) -> dict:
    """7f-serve: ``build_prefill_step`` and ``build_serve_step`` of ``cfg``
    under ``standard_rules`` on ``mesh``, each rank its blocks drawn by
    ``init_params`` (its experts, router columns, heads and vocabulary
    ids), 6b's B=4 prompts of 1000 tokens into a 1024-row cache, then
    DIST_TP's dropless serve steps fed the reference's tokens. Rank 0 first
    runs the same tokens unsharded through ``LM.prefill`` and
    ``LM.decode_step`` (``_greedy``, the weights of the same seed), keeps
    its logits and its MoE routing on the host and frees the card. The
    sharded steps run twice. As they are (timed and counted): each
    choice of a pass's (the prefill's, a serve step's) first MoE layer
    that differs from the reference's must have been within ROUTE_GAP_TOL
    of a tie there (``_route_check``), and each token must equal the
    reference's argmax wherever its top-2 gap is clear, save the rows
    whose own token routed otherwise (``_tokens_check``). Then with the
    reference's routing imposed (``_routes``): every choice its own gates
    would have made otherwise held likewise, and every clear row's token
    equal. The prefill must drop choices by capacity."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_step, init_params, materialize
    from repro_torch.models import LM
    from repro_torch.models.params import flatten
    tp = DIST_TP
    lm = LM(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (tp["batch"], tp["prompt"])), device="cuda")
    ref = torch.zeros((tp["steps"] + 1, tp["batch"], cfg.vocab_size))
    fed = torch.zeros((tp["batch"], tp["steps"]), dtype=torch.long)
    ref_routes: dict = {}
    res = {}
    torch.cuda.reset_peak_memory_stats()
    if rank == 0:
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
        calls: list = []
        with _routes(calls):
            ref, fed = _greedy(lm, params, tokens, tp["max_len"],
                               tp["steps"])
        ref_routes = _host_routes(calls)
        res["ref"] = {"seconds": time.perf_counter() - t0,
                      "peak_gb": _peak_gb()}
        del params, calls
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[steps r0] 7f-serve: unsharded reference at {cfg.n_layers} "
            f"layers in {res['ref']['seconds']:.1f} s, peak "
            f"{res['ref']['peak_gb']:.2f} GB; host MemAvailable "
            f"{_mem_available_gb():.1f} GB with its logits")
    ref, fed = _from_rank0(ref, rank), _from_rank0(fed.cpu(), rank)
    ref_routes = _routes_from_rank0(ref_routes, rank)
    passes = 1 + tp["steps"]                # the prefill, each serve step
    # the token each output row reads: the prompt's last, the step's
    rows = [[b * tp["prompt"] + tp["prompt"] - 1
             for b in range(tp["batch"])]] + \
        [list(range(tp["batch"]))] * tp["steps"]
    torch.cuda.reset_peak_memory_stats()
    pre = build_step(cfg, mesh, InputShape("prefill_moe", tp["prompt"],
                                           tp["batch"], "prefill"))
    dec = build_step(cfg, mesh, InputShape("decode_moe", tp["max_len"],
                                           tp["batch"], "decode"))
    params = init_params(cfg, pre, torch.Generator(device="cuda")
                         .manual_seed(0), "cuda")
    n_local = sum(t.numel() for t in flatten(params).values())

    def serve():
        cache = materialize(dec.args[2], "cuda")
        _step_counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = pre.fn(params, {"tokens": tokens}, cache)
        out = [tok.cpu()]
        walls = [time.perf_counter() - t0]
        pc = _step_counters()
        _step_counters(reset=True)
        for i in range(tp["steps"]):
            t0 = time.perf_counter()
            tok, cache = dec.fn(params, fed[:, i].to("cuda", torch.int32),
                                cache)
            out.append(tok.cpu())                 # synchronises
            walls.append(time.perf_counter() - t0)
        return torch.stack(out), walls, pc, _step_counters(), \
            tuple(cache["slots"][0]["k"].shape)

    calls = []
    with _routes(calls):
        out, walls, pc, dc, cache_shape = serve()
    per = len(calls) // passes
    pc["moe.dropped"] = _host_routes(calls[:per])["dropped"]
    dc["moe.dropped"] = _host_routes(calls[per:])["dropped"]
    run = _host_routes(calls)
    routes_free = _route_check(ref_routes, run, passes, first_call_only=True)
    free = _tokens_check(out, ref, _rows_rerouted(
        ref_routes["expert"], run["expert"], rows))
    calls = []
    with _routes(calls, ref_routes["expert"]):
        out = serve()[0]
    routes_imposed = _route_check(ref_routes, _host_routes(calls), passes,
                                  first_call_only=False)
    check = _tokens_check(out, ref)
    del calls
    res.update(walls_s=walls, prefill_counters=pc, serve_counters=dc,
               free=free, routes_free=routes_free, check=check,
               routes_imposed=routes_imposed, local_parameters=n_local,
               peak_gb=_peak_gb(), cache_shape=cache_shape)
    log(f"[steps r{rank}] 7f-serve at {cfg.n_layers} layers: {n_local} "
        f"parameters on this rank; prefill B={tp['batch']} x {tp['prompt']} "
        f"{walls[0]:.2f} s (B1 {pc['flash_attention.launches']}, "
        f"{pc['flash_attention.launches_sm90']} sm90; MoE choices dropped "
        f"by capacity {pc['moe.dropped']}; all-reduces "
        f"{pc['all_reduce.calls']}, {pc['all_reduce.bytes']} bytes, "
        f"{pc['all_reduce.seconds']:.2f} host s, by mesh axes "
        f"{pc['all_reduce.by_axis']}; all-gathers {pc['all_gather.calls']}, "
        f"{pc['all_gather.bytes']} bytes, {pc['all_gather.seconds']:.2f} "
        f"host s, by mesh axes {pc['all_gather.by_axis']}); "
        f"{tp['steps']} serve steps median "
        f"{np.median(walls[1:]) * 1e3:.1f} ms (B2 "
        f"{dc['decode_attention.launches']}, "
        f"{dc['decode_attention.launches_sm90']} sm90; dropped "
        f"{dc['moe.dropped']}; all-reduces {dc['all_reduce.calls']}, "
        f"{dc['all_reduce.bytes']} bytes, {dc['all_reduce.seconds']:.2f} "
        f"host s; all-gathers {dc['all_gather.calls']}, "
        f"{dc['all_gather.bytes']} bytes, {dc['all_gather.seconds']:.2f} "
        f"host s); cache of a slot {cache_shape}; peak "
        f"{res['peak_gb']:.2f} GB")
    log(f"[steps r{rank}] 7f-serve as it runs (timed): "
        f"{_route_log(routes_free)}; tokens equal the reference's argmax on "
        f"{free['agree']:.3f} of the rows; of the {free['clear_rows']} whose "
        f"top-2 gap exceeds {DIST_TOL} max |logit|, {free['rerouted_rows']} "
        f"of all rows routed their own token otherwise, "
        f"{free['differ_on_held']} differ of the {free['held_rows']} held "
        f"({free['differ_on_clear']} of all clear; the largest top-2 gap "
        f"of a row that differs {free['max_gap_differ']:.4g} max |logit|): "
        f"{free['ok']}")
    log(f"[steps r{rank}] 7f-serve with the reference's routing imposed, "
        f"its own gates: {_route_log(routes_imposed)}; tokens equal on "
        f"{check['agree']:.3f} of the rows, {check['differ_on_clear']} "
        f"differ of the {check['clear_rows']} clear: {check['ok']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _kept_logits(kept: list):
    """While the context lasts, each ``LM.prefill`` and ``LM.decode_step``
    call (a built step's, which takes the argmax of its whole logits)
    appends a fp32 copy of its logits to ``kept``, on the device (no
    synchronisation inside a timed step)."""
    from repro_torch.models.api import LM
    prefill, decode = LM.prefill, LM.decode_step

    def keep(fn):
        def wrapped(self, *args, **kw):
            logits, cache = fn(self, *args, **kw)
            kept.append(logits.detach().float().clone())
            return logits, cache
        return wrapped
    LM.prefill, LM.decode_step = keep(prefill), keep(decode)
    try:
        yield
    finally:
        LM.prefill, LM.decode_step = prefill, decode


def _rec_leaves(cache) -> dict:
    """The rec slots' leaves of a hybrid cache (path -> tensor): each
    stacked or ``rest`` rec slot's conv tail (``.../0``) and h
    (``.../1``)."""
    from repro_torch.models.params import flatten
    return {k: t for k, t in flatten(cache).items()
            if k.split("/")[-1] in ("0", "1")}


def _rel_max(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()) / \
        max(float(b.float().abs().max()), 1e-30)


def _worst(rows, what: str) -> float:
    return max(c[what] for c in rows)


@dataclasses.dataclass
class RecurrentServe:
    """What ``_recurrent_serve`` runs and holds for one model: its tag, the
    serve's shape (batch, prompt, max_len, steps), the recurrent leaves of
    a cache (path -> tensor), the dim along which a rank holds its block
    of such a leaf (None: whole), for the log the kernels' (label,
    counter) and the cache leaves whose shapes it prints (label, path),
    and ``blocks``: the block functions ((module, name), each layer one
    call ``fn(p, x, cfg, state, mode) -> x + out``) that the fp32 run is
    teacher-forced through (``_block_io``), or none: the fp32 run end to
    end."""
    tag: str
    shape: dict
    leaves: object
    block_dim: object
    kernels: tuple
    shapes: tuple
    blocks: tuple = ()


@contextlib.contextmanager
def _block_io(blocks: tuple, io: list, ref: list | None = None,
              errs: list | None = None):
    """While the context lasts, each call of the block functions
    ``blocks`` ((module, name) pairs; ``fn(p, x, cfg, state, mode) -> x +
    out``): without ``ref``, appends (x, its output) as fp32 host tensors
    to ``io``; with ``ref`` (what such a run appended), runs the call on
    the reference's x in its place, in order, and appends max |d| / max
    |ref| of the call's change (output - x) against the reference's to
    ``errs``. A forced model's error does not carry from layer to layer:
    each block is held on its own."""
    import importlib
    calls = iter(ref) if ref is not None else None
    saved = []
    for module, name in blocks:
        mod = importlib.import_module(module)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapped(p, x, *args, fn=fn):
            if calls is None:
                y = fn(p, x, *args)
                io.append((x.detach().float().cpu(), y.detach().float().cpu()))
                return y
            x_ref, y_ref = next(calls)
            x = x_ref.to(x.device, x.dtype)
            y = fn(p, x, *args)
            errs.append(_rel_max((y.float() - x.float()).cpu(), y_ref - x_ref))
            return y
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _recurrent_serve(rank: int, cfg, mesh, how: RecurrentServe) -> dict:
    """7g-serve and 7h-serve: ``build_prefill_step`` and
    ``build_serve_step`` of ``cfg`` under ``standard_rules`` on ``mesh``,
    each rank its blocks drawn by ``init_params``, ``how.shape``'s prompt,
    then its serve steps fed the reference's tokens. Rank 0 first runs the
    same prompts unsharded twice, keeps each run's logits and final
    recurrent states on the host and frees the card: in fp32 (the bf16
    draw's weights upcast, its caches in fp32; greedy, its tokens the
    feed) and in bf16 on the same feed. The sharded steps are timed and
    counted; the whole logits each step takes its argmax of are kept
    (``_kept_logits``). The logits of the serve's passes, and each rank's
    block of the recurrent leaves after the steps (``how.leaves``, cut
    along ``how.block_dim``), must differ from the unsharded bf16 model's
    by no more than that model's differ from the fp32 model's (max |d| /
    max |ref|, the worst pass against the worst pass, the worst leaf
    against the worst leaf: each varies by ~15% between runs): the
    sharding's change within what bf16's rounding alone makes of the
    function. Each token must equal the fp32 model's argmax wherever its
    top-2 gap exceeds DIST_TOL of max |logit| (``_tokens_check``). Then the
    same sharded steps run in fp32, the rank's blocks upcast and the
    caches in fp32, on the same feed: every pass's logits and the rank's
    block of every recurrent leaf within SERVE_FP32_TOL of the unsharded
    fp32 model's (max |d| / max |ref|), its tokens held as the bf16
    run's. Where ``how.blocks`` names the model's blocks, that fp32 run is
    teacher-forced: each block runs on the unsharded fp32 model's input to
    it (recorded in its run, ``_block_io``), and every call's change is
    held within SERVE_FP32_TOL of the unsharded block's too."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import build_step, init_params
    from repro_torch.models import LM
    from repro_torch.models.params import flatten, map_leaves
    sv, tag = how.shape, how.tag
    lm = LM(cfg)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (sv["batch"], sv["prompt"])), device="cuda")
    # the fp32 and the bf16 reference's logits and recurrent states after
    # the steps (whole, on the host), and the feed
    refs = {d: torch.zeros((sv["steps"] + 1, sv["batch"], cfg.vocab_size))
            for d in ("fp32", "bf16")}
    fed = torch.zeros((sv["batch"], sv["steps"]), dtype=torch.long)
    like = how.leaves(lm.init_cache(sv["batch"], sv["max_len"],
                                    device="meta"))
    states = {d: {k: torch.zeros(t.shape) for k, t in like.items()}
              for d in ("fp32", "bf16")}
    # the fp32 reference's blocks' inputs and outputs, call by call (each
    # layer once a pass): rank 0 records them, the others take them
    io: list = []
    B, D = sv["batch"], cfg.d_model
    io_shapes = [(B, sv["prompt"], D)] * cfg.n_layers + \
        [(B, 1, D)] * (cfg.n_layers * sv["steps"]) if how.blocks else []
    res = {}
    torch.cuda.reset_peak_memory_stats()
    if rank == 0:
        t0 = time.perf_counter()
        params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
        with _block_io(how.blocks, io):
            refs["fp32"], fed, cache = _greedy(
                lm, map_leaves(torch.Tensor.float, params), tokens,
                sv["max_len"], sv["steps"], keep_cache=True,
                dtype=torch.float32)
        assert [tuple(x.shape) for x, _ in io] == io_shapes
        states["fp32"] = {k: t.float().cpu()
                          for k, t in how.leaves(cache).items()}
        del cache
        cache = lm.init_cache(sv["batch"], sv["max_len"], device="cuda")
        logits, cache = lm.prefill(params, {"tokens": tokens}, cache)
        outs = [logits.float().cpu()]
        for i in range(sv["steps"]):
            logits, cache = lm.decode_step(params, fed[:, i], cache)
            outs.append(logits.float().cpu())
        refs["bf16"] = torch.stack(outs)
        states["bf16"] = {k: t.float().cpu()
                          for k, t in how.leaves(cache).items()}
        res["ref"] = {"seconds": time.perf_counter() - t0,
                      "peak_gb": _peak_gb()}
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[steps r0] {tag}: the unsharded model in fp32, then in bf16 "
            f"on its feed, at {cfg.n_layers} layers in "
            f"{res['ref']['seconds']:.1f} s, peak {res['ref']['peak_gb']:.2f}"
            " GB")
    refs = {d: _from_rank0(t, rank) for d, t in refs.items()}
    if rank != 0:
        io = [(torch.zeros(shape), torch.zeros(shape)) for shape in io_shapes]
    io = [(_from_rank0(x, rank), _from_rank0(y, rank)) for x, y in io]
    fed = _from_rank0(fed.cpu(), rank)
    states = {d: {k: _from_rank0(t, rank) for k, t in leaves.items()}
              for d, leaves in states.items()}
    torch.cuda.reset_peak_memory_stats()
    shapes = (InputShape("prefill_" + tag, sv["prompt"], sv["batch"],
                         "prefill"),
              InputShape("decode_" + tag, sv["max_len"], sv["batch"],
                         "decode"))
    pre, dec = (build_step(cfg, mesh, b) for b in shapes)
    params = init_params(cfg, pre, torch.Generator(device="cuda")
                         .manual_seed(0), "cuda")
    n_local = sum(t.numel() for t in flatten(params).values())
    kept: list = []
    with _kept_logits(kept):
        cache = dec.new_cache("cuda")
        _step_counters(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = pre.fn(params, {"tokens": tokens}, cache)
        out = [tok.cpu()]
        walls = [time.perf_counter() - t0]
        pc = _step_counters()
        _step_counters(reset=True)
        for i in range(sv["steps"]):
            t0 = time.perf_counter()
            tok, cache = dec.fn(params, fed[:, i].to("cuda", torch.int32),
                                cache)
            out.append(tok.cpu())                 # synchronises
            walls.append(time.perf_counter() - t0)
        dc = _step_counters()
    logits = torch.stack([t.cpu() for t in kept])
    # by pass: the sharded run against the bf16 and the fp32 model, and
    # the bf16 model against the fp32 one (the floor)
    passes = [{"vs_bf16": _rel_max(o, r16), "vs_fp32": _rel_max(o, r32),
               "floor": _rel_max(r16, r32)}
              for o, r16, r32 in zip(logits, refs["bf16"], refs["fp32"])]
    tokens_ok = _tokens_check(torch.stack(out), refs["fp32"])

    def mine(key, t, d):
        """This rank's block of the reference's leaf ``key``."""
        ref = states[d][key]
        dim = how.block_dim(key)
        if dim is None:
            assert t.shape == ref.shape, (key, tuple(t.shape))
            return ref
        n = t.shape[dim]
        assert n * mesh.size(1) == ref.shape[dim], (key, tuple(t.shape))
        return ref.narrow(dim, rank * n, n)
    leaves = {}
    for key, t in how.leaves(cache).items():
        s16, s32 = mine(key, t, "bf16"), mine(key, t, "fp32")
        leaves[key] = {"vs_bf16": _rel_max(t.cpu(), s16),
                       "vs_fp32": _rel_max(t.cpu(), s32),
                       "floor": _rel_max(s16, s32)}
    cache_shapes = {label: tuple(flatten(cache)[path].shape)
                    for label, path in how.shapes}
    res.update(walls_s=walls, prefill_counters=pc, serve_counters=dc,
               logits=passes, tokens=tokens_ok, states=leaves,
               logits_ok=_worst(passes, "vs_bf16") <= _worst(passes, "floor"),
               states_ok=_worst(leaves.values(), "vs_bf16") <=
               _worst(leaves.values(), "floor"),
               local_parameters=n_local, peak_gb=_peak_gb(),
               cache_shapes=cache_shapes)
    # the same steps in fp32 on the same blocks upcast, against the
    # unsharded fp32 model (not timed; its launches are not the path's)
    del cache, kept
    params = map_leaves(torch.Tensor.float, params)
    pre, dec = (build_step(cfg, mesh, b, dtype=torch.float32)
                for b in shapes)
    kept, errs = [], []
    with _kept_logits(kept), _block_io(how.blocks, [], io, errs):
        cache = dec.new_cache("cuda")
        tok, cache = pre.fn(params, {"tokens": tokens}, cache)
        out32 = [tok.cpu()]
        for i in range(sv["steps"]):
            tok, cache = dec.fn(params, fed[:, i].to("cuda", torch.int32),
                                cache)
            out32.append(tok.cpu())
    fp32 = {"logits": [_rel_max(o.cpu(), r32)
                       for o, r32 in zip(kept, refs["fp32"])],
            "states": {key: _rel_max(t.cpu(), mine(key, t, "fp32"))
                       for key, t in how.leaves(cache).items()},
            "tokens": _tokens_check(torch.stack(out32), refs["fp32"]),
            "forced_blocks": len(errs),
            "blocks": max(errs) if errs else None}
    fp32["ok"] = bool(max(fp32["logits"]) <= SERVE_FP32_TOL and
                      max(fp32["states"].values()) <= SERVE_FP32_TOL and
                      fp32["tokens"]["ok"] and
                      len(errs) == len(io) and
                      (not errs or max(errs) <= SERVE_FP32_TOL))
    res["fp32"] = fp32
    del params, cache, kept
    gc.collect()
    torch.cuda.empty_cache()

    def launches(c):
        return ", ".join(f"{label} {c[name + '.launches']}" + (
            f" ({c[name + '.launches_sm90']} sm90)"
            if name + ".launches_sm90" in c else "") + (
            f" on heads {c['mlstm_chunk.heads']}"
            if name == "mlstm_chunk" else "")
            for label, name in how.kernels)

    def collectives(c):
        return "; ".join(
            f"{name}s {c[f'all_{name}.calls']}, {c[f'all_{name}.bytes']} "
            f"bytes, {c[f'all_{name}.seconds']:.2f} host s, by mesh axes "
            f"{c[f'all_{name}.by_axis']}" for name in ("reduce", "gather"))
    log(f"[steps r{rank}] {tag} at {cfg.n_layers} layers: {n_local} "
        f"parameters on this rank; prefill B={sv['batch']} x {sv['prompt']} "
        f"{walls[0]:.2f} s ({launches(pc)}; all-{collectives(pc)}); "
        f"{sv['steps']} serve steps median "
        f"{np.median(walls[1:]) * 1e3:.1f} ms ({launches(dc)}; "
        f"all-{collectives(dc)}); cache leaves {cache_shapes}; peak "
        f"{res['peak_gb']:.2f} GB")

    def by(rows, what):
        return [round(c[what], 5) for c in rows]
    log(f"[steps r{rank}] {tag} logits, max |d| / max |ref| by pass: "
        f"against the unsharded bf16 model {by(passes, 'vs_bf16')}, the "
        f"worst within that model's own against the fp32 one "
        f"{by(passes, 'floor')}: {res['logits_ok']} (against the fp32 model "
        f"{by(passes, 'vs_fp32')}); tokens equal the fp32 model's argmax on "
        f"{tokens_ok['agree']:.3f} of the rows, "
        f"{tokens_ok['differ_on_clear']} differ of the "
        f"{tokens_ok['clear_rows']} whose top-2 gap exceeds {DIST_TOL} max "
        f"|logit|: {tokens_ok['ok']}; final recurrent states, the rank's "
        f"block: against the bf16 model "
        f"{ {k: round(c['vs_bf16'], 5) for k, c in leaves.items()} }, the "
        f"worst within its own against the fp32 one "
        f"{ {k: round(c['floor'], 5) for k, c in leaves.items()} }: "
        f"{res['states_ok']} (against the fp32 model "
        f"{ {k: round(c['vs_fp32'], 5) for k, c in leaves.items()} })")
    forced = (f" each of its {len(errs)} block calls teacher-forced (run on "
              f"the unsharded model's input; the worst call's change "
              f"{max(errs):.3g} of max)," if errs else "")
    log(f"[steps r{rank}] {tag} in fp32 (the blocks upcast),{forced} against "
        f"the unsharded fp32 model, max |d| / max |ref|: logits by pass "
        f"{[float(f'{e:.3g}') for e in fp32['logits']]}, the rank's block "
        f"of the final recurrent states "
        f"{ {k: float(f'{e:.3g}') for k, e in fp32['states'].items()} } "
        f"(tol {SERVE_FP32_TOL}); tokens differ on "
        f"{fp32['tokens']['differ_on_clear']} of "
        f"{fp32['tokens']['clear_rows']} clear rows: {fp32['ok']}")
    return res


def _hybrid_serve(rank: int, cfg, mesh) -> dict:
    """7g-serve (``_recurrent_serve``): RecurrentGemma-2B's RG_SERVE prompt
    of 3000 tokens into the rotating 2048-row window, each rank its query
    heads, the KV head, its d_ff columns, its RG-LRU width and gate blocks
    and its vocabulary ids; held on the rec leaves (the conv tails and h,
    the rank's channels of the width)."""
    width = cfg.lru_width or cfg.d_model

    def channels(key):
        return -1
    assert width % mesh.size(1) == 0
    return _recurrent_serve(rank, cfg, mesh, RecurrentServe(
        "7g-serve", RG_SERVE, _rec_leaves, channels,
        (("B1", "flash_attention"), ("B3", "rglru_scan"),
         ("B2", "decode_attention")),
        (("attention", "slots/2/k"), ("h", "slots/0/1"))))


def _xlstm_leaves(cache) -> dict:
    """Every state leaf of an xLSTM cache (path -> tensor): an mLSTM slot's
    C, n and m (``slots/<i>/{0,1,2}``), an sLSTM slot's c, n, m and h."""
    from repro_torch.models.params import flatten
    return {k: t for k, t in flatten(cache).items() if k != "pos"}


def _xlstm_serve(rank: int, cfg, mesh) -> dict:
    """7h-serve (``_recurrent_serve``): xLSTM-350M's XL_SERVE prompt of 1000
    tokens (past B4's 64-step chunks, not a multiple of them), each rank
    its 2 of the 4 mLSTM heads, its sLSTM gate columns and w_out rows and
    its vocabulary ids; held on every state leaf: an mLSTM state at the
    rank's heads (dim 2 of (G, B, nh, ...)), an sLSTM state whole. Its
    fp32 run is teacher-forced block by block (XL_FP32_SEQ says why)."""
    from repro_torch.models import xlstm
    mlstm = {i for i, kind in enumerate(xlstm._slot_kinds(cfg))
             if kind == "mlstm"}

    def heads(key):
        return 2 if int(key.split("/")[1]) in mlstm else None
    slstm = min(set(range(len(xlstm._slot_kinds(cfg)))) - mlstm)
    return _recurrent_serve(rank, cfg, mesh, RecurrentServe(
        "7h-serve", XL_SERVE, _xlstm_leaves, heads,
        (("B4", "mlstm_chunk"),),
        (("mLSTM C", "slots/0/0"), ("sLSTM h", f"slots/{slstm}/3")),
        tuple(("repro_torch.models.xlstm", name)
              for name in ("_mlstm_block", "_slstm_block"))))


def _hybrid_steps(rank: int, res: dict, mesh, ref_mesh, opt_cfg) -> None:
    """7g on this rank, its results into ``res``: RecurrentGemma-2B at its
    published widths on ``mesh`` (1, 2), its RG-LRU width over "model":
    STEPS_RG_TRAIN_LAYERS layers trained tensor parallel and then under
    FSDP, both held against one unsharded run on ``ref_mesh`` (rank 0's
    one-rank pool; the reference kept on the host where MemAvailable
    holds it; the leaves after step RG_CHECK_AFTER), then all 26 layers
    prefilled and served (``_hybrid_serve``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    rg = get_config("recurrentgemma-2b")
    rg_cfg = dataclasses.replace(rg, n_layers=STEPS_RG_TRAIN_LAYERS)
    rg_shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                   global_batch=STEPS_RG_BATCH)
    t0 = time.perf_counter()
    res["train_rg"], reference = _held_training(
        rank, "7g-train", rg_cfg, rg_shape, ref_mesh, mesh, opt_cfg,
        keep=True, check_after=RG_CHECK_AFTER)
    if rank == 0:
        ref_gb = sum(t.numel() * t.element_size() for part in
                     reference[1].values() for t in part.values()) / 1e9
        res["rg_fsdp_reference"] = {"leaves_gb": ref_gb,
                                    "mem_available_gb": _mem_available_gb()}
        if res["rg_fsdp_reference"]["mem_available_gb"] < ref_gb:
            reference = None
    res["train_rg_fsdp"], _ = _held_training(
        rank, "7g-fsdp", rg_cfg, rg_shape, ref_mesh, mesh, opt_cfg,
        param_mode="fsdp", reference=reference, check_after=RG_CHECK_AFTER)
    del reference
    gc.collect()
    res["serve_rg"] = _hybrid_serve(rank, rg, mesh)
    res["rg_seconds"] = time.perf_counter() - t0
    dist.barrier()


def _xlstm_steps(rank: int, res: dict, mesh, ref_mesh, opt_cfg) -> None:
    """7h on this rank, its results into ``res``: xLSTM-350M at its
    published widths on ``mesh`` (1, 2), its mLSTM heads and sLSTM gate
    columns over "model": STEPS_XL_TRAIN_LAYERS layers trained tensor
    parallel in fp32 at S=XL_FP32_SEQ (7h-train32), then in bf16 tensor
    parallel and under FSDP at B=STEPS_XL_BATCH, S=STEPS_XL_SEQ, each held
    against an unsharded run on ``ref_mesh`` (rank 0's one-rank pool; the
    bf16 one kept on the host where MemAvailable holds it; the leaves
    after step XL_CHECK_AFTER), then all 24 layers prefilled and served
    (``_xlstm_serve``)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    xl = get_config("xlstm-350m")
    xl_cfg = dataclasses.replace(xl, n_layers=STEPS_XL_TRAIN_LAYERS)
    xl_shape = dataclasses.replace(INPUT_SHAPES["train_4k"],
                                   global_batch=STEPS_XL_BATCH,
                                   seq_len=STEPS_XL_SEQ)
    t0 = time.perf_counter()
    res["train_xl32"], _ = _held_training(
        rank, "7h-train32", xl_cfg, dataclasses.replace(
            xl_shape, seq_len=XL_FP32_SEQ), ref_mesh, mesh,
        dataclasses.replace(opt_cfg, state_dtype=torch.float32),
        check_after=XL_CHECK_AFTER, dtype=torch.float32)
    res["train_xl"], reference = _held_training(
        rank, "7h-train", xl_cfg, xl_shape, ref_mesh, mesh, opt_cfg,
        keep=True, check_after=XL_CHECK_AFTER)
    if rank == 0:
        ref_gb = sum(t.numel() * t.element_size() for part in
                     reference[1].values() for t in part.values()) / 1e9
        res["xl_fsdp_reference"] = {"leaves_gb": ref_gb,
                                    "mem_available_gb": _mem_available_gb()}
        if res["xl_fsdp_reference"]["mem_available_gb"] < ref_gb:
            reference = None
    res["train_xl_fsdp"], _ = _held_training(
        rank, "7h-fsdp", xl_cfg, xl_shape, ref_mesh, mesh, opt_cfg,
        param_mode="fsdp", reference=reference, check_after=XL_CHECK_AFTER)
    del reference
    gc.collect()
    res["serve_xl"] = _xlstm_serve(rank, xl, mesh)
    res["xl_seconds"] = time.perf_counter() - t0
    dist.barrier()


def _steps_rank(rank: int, world: int, rdv: str, out_dir: str) -> None:
    """One rank of 7b to 7h on cuda:0 in a gloo world of two. 7b:
    Llama-3.1-8B at full width and STEPS_TRAIN_LAYERS layers on the (1, 2)
    mesh under ``standard_rules`` (heads, d_ff and the vocabulary cut),
    held against rank 0's unsharded run on its one-rank pool
    (``_held_training``). 7c: the (2, 1) mesh cut by
    ``split_disagg_mesh(mesh, 1)``, rank 0 prefilling in the prefill pool,
    rank 1 decoding in the decode pool. 7d: STEPS_POD_LAYERS layers on the
    (2, 1, 1) mesh over ("pod", "data", "model"), one row of the batch a
    rank over the flattened ("pod", "data"), held likewise. 7e: the same
    model and batch under FSDP on the (1, 2) mesh, held against 7d's
    reference. 7f: Phi-3.5-MoE at its published widths on the (1, 2)
    mesh, its experts over "model": STEPS_MOE_TRAIN_LAYERS layers trained
    and held against rank 0's unsharded run, then STEPS_MOE_SERVE_LAYERS
    layers prefilled and served (``_moe_serve``). 7g: RecurrentGemma-2B at
    its published widths on the (1, 2) mesh, its RG-LRU width over
    "model": STEPS_RG_TRAIN_LAYERS layers trained tensor parallel and
    under FSDP, both held against one unsharded run of rank 0's, then all
    26 layers prefilled and served (``_hybrid_serve``). 7h: xLSTM-350M at
    its published widths on the (1, 2) mesh, its mLSTM heads and sLSTM
    gate columns over "model" (``_xlstm_steps``). Writes its results
    to ``out_dir/steps_rank<rank>.json``."""
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
    _record_mlstm_heads()
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
    # 7b: tensor parallel, the vocabulary cut, at half depth
    res["train_tp"], _ = _held_training(
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
    # replica a rank: STEPS_POD_LAYERS of the 32 layers, so that two fit
    pod_cfg = dc.replace(full, n_layers=STEPS_POD_LAYERS)
    pod_shape = dc.replace(train_4k, global_batch=STEPS_POD_BATCH)
    res["train_pod"], reference = _held_training(
        rank, "7d", pod_cfg, pod_shape, pools[0], mesh_pod, opt_cfg,
        keep=True)
    # 7e: FSDP on (1, 2), the same model, batch and unsharded reference:
    # 7d's, kept where the host's MemAvailable holds its leaves again
    if rank == 0:
        ref_gb = sum(t.numel() * t.element_size() for part in
                     reference[1].values() for t in part.values()) / 1e9
        res["fsdp_reference"] = {"leaves_gb": ref_gb,
                                 "mem_available_gb": _mem_available_gb()}
        if res["fsdp_reference"]["mem_available_gb"] < ref_gb:
            reference = None
    res["train_fsdp"], _ = _held_training(
        rank, "7e", pod_cfg, pod_shape, pools[0], mesh12, opt_cfg,
        param_mode="fsdp", reference=reference)
    del reference
    gc.collect()
    # 7f: Phi-3.5-MoE at its published widths, its experts over "model":
    # training at STEPS_MOE_TRAIN_LAYERS layers, serving at
    # STEPS_MOE_SERVE_LAYERS
    phi = get_config(PHI)
    t0 = time.perf_counter()
    res["train_moe"], _ = _held_training(
        rank, "7f-train", dc.replace(phi, n_layers=STEPS_MOE_TRAIN_LAYERS),
        dc.replace(train_4k, global_batch=1), pools[0], mesh12, opt_cfg)
    res["serve_moe"] = _moe_serve(
        rank, dc.replace(phi, n_layers=STEPS_MOE_SERVE_LAYERS), mesh12)
    res["moe_seconds"] = time.perf_counter() - t0
    dist.barrier()
    _hybrid_steps(rank, res, mesh12, pools[0], opt_cfg)
    _xlstm_steps(rank, res, mesh12, pools[0], opt_cfg)
    res["seconds"] = time.perf_counter() - t_start
    Path(out_dir, f"steps_rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _hybrid_problems(r: dict) -> list:
    """7g's checks on rank ``r``'s results: each training run's B1 and B3
    launches (all sm90) as ``train_plan`` of its 8 layers gives them for
    its 2 steps; the tensor-parallel run's collectives over "model"
    alone, the FSDP run's over "data+model" alone, half the parameters
    a rank; the serve's logits, tokens and final rec states held, B1 a
    layer of attention in the prefill and B3 a rec layer (on the rank's
    block of the width), B2 a layer of attention a serve step and neither
    B1 nor B3 there, its collectives over "model" alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru
    rg = get_config("recurrentgemma-2b")
    cfg = dataclasses.replace(rg, n_layers=STEPS_RG_TRAIN_LAYERS)
    plan = train_plan(cfg)
    out = []
    for run, tag, axes in (("train_rg", "7g-train", {"model"}),
                           ("train_rg_fsdp", "7g-fsdp", {"data+model"})):
        c = r[run]["counters"]
        for name, want in plan.items():
            if c[f"{name}.launches"] != want * STEPS_TRAIN_STEPS:
                out.append(f"rank {r['rank']}: {tag} {name} launches "
                           f"{c[f'{name}.launches']}, "
                           f"{want * STEPS_TRAIN_STEPS} expected")
        if c["flash_attention.launches_sm90"] != \
                c["flash_attention.launches"]:
            out.append(f"rank {r['rank']}: {tag} B1 off the sm90 kernel")
        for name in ("all_reduce", "all_gather"):
            got = set(c[f"{name}.by_axis"])
            if got - axes:
                out.append(f"rank {r['rank']}: {tag} {name} over {got}")
    total = sum(math.prod(shape) for shape, _ in
                rglru.param_specs(cfg).values())
    if r["train_rg_fsdp"]["local_parameters"] * STEPS_WORLD != total:
        out.append(f"rank {r['rank']}: 7g-fsdp holds "
                   f"{r['train_rg_fsdp']['local_parameters']} of {total}")
    serve = r["serve_rg"]
    for what, detail in (("logits_ok", "logits"), ("states_ok", "states")):
        if not serve[what]:
            out.append(f"rank {r['rank']}: 7g-serve {detail} past bf16's "
                       f"own: {serve[detail]}")
    if not serve["tokens"]["ok"]:
        out.append(f"rank {r['rank']}: 7g-serve tokens {serve['tokens']}")
    if not serve["fp32"]["ok"]:
        out.append(f"rank {r['rank']}: 7g-serve in fp32 past {SERVE_FP32_TOL} "
                   f"of the unsharded fp32 model's: {serve['fp32']}")
    n_attn = rg.layer_kinds().count("attn")
    n_rec = rg.layer_kinds().count("rec")
    pc, dc = serve["prefill_counters"], serve["serve_counters"]
    for what, n, n_sm90, expected in (
            ("prefill B1", pc["flash_attention.launches"],
             pc["flash_attention.launches_sm90"], n_attn),
            ("prefill B3", pc["rglru_scan.launches"],
             pc["rglru_scan.launches"], n_rec),
            ("serve B2", dc["decode_attention.launches"],
             dc["decode_attention.launches_sm90"],
             n_attn * RG_SERVE["steps"]),
            ("serve B1", dc["flash_attention.launches"], 0, 0),
            ("serve B3", dc["rglru_scan.launches"], 0, 0)):
        if not n == n_sm90 == expected:
            out.append(f"rank {r['rank']}: 7g {what} launches {n} "
                       f"({n_sm90} sm90), {expected} expected")
    for c in (pc, dc):
        for name in ("all_reduce", "all_gather"):
            if set(c[f"{name}.by_axis"]) - {"model"}:
                out.append(f"rank {r['rank']}: 7g-serve {name} over "
                           f"{set(c[f'{name}.by_axis'])}")
    return out


def _xlstm_problems(r: dict) -> list:
    """7h's checks on rank ``r``'s results: each training run's B4 forward
    and backward launches as ``train_plan`` of its 8 layers gives them for
    its 2 steps, on the rank's 2 of the 4 heads tensor parallel and on
    all 4 under FSDP; the tensor-parallel runs' collectives over "model"
    alone, the FSDP run's over "data+model" alone, half the parameters a
    rank; the serve's teacher-forced fp32 run's blocks, logits, states
    and tokens held, B4 an mLSTM layer in the prefill (21) on the rank's
    heads and none in a serve step, its collectives over "model" alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    xl = get_config("xlstm-350m")
    cfg = dataclasses.replace(xl, n_layers=STEPS_XL_TRAIN_LAYERS)
    plan = train_plan(cfg)
    out = []
    for run, tag, axes, heads in (
            ("train_xl32", "7h-train32", {"model"}, [XL_TP_HEADS]),
            ("train_xl", "7h-train", {"model"}, [XL_TP_HEADS]),
            ("train_xl_fsdp", "7h-fsdp", {"data+model"}, [cfg.n_heads])):
        c = r[run]["counters"]
        for name, want in plan.items():
            if c[f"{name}.launches"] != want * STEPS_TRAIN_STEPS:
                out.append(f"rank {r['rank']}: {tag} {name} launches "
                           f"{c[f'{name}.launches']}, "
                           f"{want * STEPS_TRAIN_STEPS} expected")
        if c["mlstm_chunk.heads"] != heads:
            out.append(f"rank {r['rank']}: {tag} B4 on heads "
                       f"{c['mlstm_chunk.heads']}, {heads} expected")
        for name in ("all_reduce", "all_gather"):
            got = set(c[f"{name}.by_axis"])
            if got - axes:
                out.append(f"rank {r['rank']}: {tag} {name} over {got}")
    total = sum(math.prod(shape) for shape, _ in
                xlstm.param_specs(cfg).values())
    if r["train_xl_fsdp"]["local_parameters"] * STEPS_WORLD != total:
        out.append(f"rank {r['rank']}: 7h-fsdp holds "
                   f"{r['train_xl_fsdp']['local_parameters']} of {total}")
    # the bf16 run's logits, states and tokens are reported, not held: the
    # unsharded bf16 model's own lie 0.94-1.37 of max from the fp32 one's
    # past 24 layers (XL_FP32_SEQ), a floor no difference can exceed; the
    # forced fp32 run's are held
    serve = r["serve_xl"]
    if not serve["fp32"]["ok"]:
        out.append(f"rank {r['rank']}: 7h-serve in fp32 past "
                   f"{SERVE_FP32_TOL} of the unsharded fp32 model's: "
                   f"{serve['fp32']}")
    n_mlstm = xl.layer_kinds().count("mlstm")
    pc, dc = serve["prefill_counters"], serve["serve_counters"]
    for what, n, expected in (
            ("prefill B4", pc["mlstm_chunk.launches"], n_mlstm),
            ("serve B4", dc["mlstm_chunk.launches"], 0)):
        if n != expected:
            out.append(f"rank {r['rank']}: 7h {what} launches {n}, "
                       f"{expected} expected")
    if pc["mlstm_chunk.heads"] != [XL_TP_HEADS]:
        out.append(f"rank {r['rank']}: 7h prefill B4 on heads "
                   f"{pc['mlstm_chunk.heads']}")
    for c in (pc, dc):
        for name in ("all_reduce", "all_gather"):
            if set(c[f"{name}.by_axis"]) - {"model"}:
                out.append(f"rank {r['rank']}: 7h-serve {name} over "
                           f"{set(c[f'{name}.by_axis'])}")
    return out


def _spawn_ranks(target, tag: str, limit: float) -> tuple:
    """STEPS_WORLD gloo ranks sharing the card, spawned with
    ``torch.multiprocessing``, each ``target(rank, world, rendezvous file,
    out dir)`` writing ``build/<tag>_rank<r>.json``. Returns (the ranks'
    results, seconds); fails if a rank fails or outlasts ``limit``
    seconds, stopping them all."""
    import os

    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    rdv = out_dir / f"{tag}_rdv_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    for r in range(STEPS_WORLD):
        (out_dir / f"{tag}_rank{r}.json").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target,
                         args=(r, STEPS_WORLD, str(rdv), str(out_dir)))
             for r in range(STEPS_WORLD)]
    for p in procs:
        p.start()
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
        raise SystemExit(f"{tag}: ranks failed or outlasted {limit:.0f} s "
                         f"(exit codes {bad})")
    return [json.loads((out_dir / f"{tag}_rank{r}.json").read_text())
            for r in range(STEPS_WORLD)], secs


def phase_steps_ranks(report: dict) -> dict:
    """7b to 7h: two gloo ranks sharing the card (``_steps_rank``); fails
    if a rank fails, outlasts what is left of STEPS_TIMEOUT_S or finds a
    result off. Returns the launches by path."""
    ranks, secs = _spawn_ranks(
        _steps_rank, "steps",
        STEPS_TIMEOUT_S - report["steps_serve"]["seconds"])
    report["steps_ranks"] = {"seconds": secs, "ranks": ranks}
    problems = []
    held = {"train_tp": ("7b", STEPS_TRAIN_LAYERS),
            "train_pod": ("7d", STEPS_POD_LAYERS),
            "train_fsdp": ("7e", STEPS_POD_LAYERS),
            "train_moe": ("7f-train", STEPS_MOE_TRAIN_LAYERS)}
    # the hybrid's and the ssm's runs are held as these, their launches by
    # train_plan: run -> (tag, the steps whose loss and grad norm are held,
    # whether its leaves are); 7h's tensor-parallel runs hold their first
    # step alone (XL_FP32_SEQ says why)
    held_rg = {"train_rg": ("7g-train", STEPS_TRAIN_STEPS, True),
               "train_rg_fsdp": ("7g-fsdp", STEPS_TRAIN_STEPS, True),
               "train_xl32": ("7h-train32", 1, True),
               "train_xl": ("7h-train", 1, False),
               "train_xl_fsdp": ("7h-fsdp", STEPS_TRAIN_STEPS, True)}
    for r in ranks:
        for run, (tag, steps, _) in held_rg.items():
            if not all(c["ok"] for c in r[run]["checks"][:steps]):
                problems.append(f"rank {r['rank']}: {tag} loss or grad norm "
                                f"off: {r[run]['checks']}")
        for run, (tag, _) in held.items():
            if not all(c["ok"] for c in r[run]["checks"]):
                problems.append(f"rank {r['rank']}: {tag} loss, grad norm or "
                                f"routes off: {r[run]['checks']}")
        if not r["pool_run"]["first_tokens_equal_reference"]:
            problems.append(f"rank {r['rank']}: 7c tokens off")
        if r["pools"] != [[[0]], [[1]]]:
            problems.append(f"pools {r['pools']}")
        # 7d's all-reduces run over the flattened ("pod", "data") alone
        axes = set(r["train_pod"]["counters"]["all_reduce.by_axis"])
        if axes != {"pod+data"}:
            problems.append(f"rank {r['rank']}: 7d all-reduces over {axes}")
        # 7e: its gathers and all-reduces over the flattened ("data",
        # "model") alone; every leaf halved; below 7d's peak
        fsdp = r["train_fsdp"]
        for name in ("all_reduce", "all_gather"):
            axes = set(fsdp["counters"][f"{name}.by_axis"])
            if axes != {"data+model"}:
                problems.append(f"rank {r['rank']}: 7e {name} over {axes}")
        if fsdp["local_parameters"] * STEPS_WORLD != \
                r["train_pod"]["local_parameters"]:
            problems.append(f"rank {r['rank']}: 7e holds "
                            f"{fsdp['local_parameters']} parameters")
        if not fsdp["peak_gb"] < r["train_pod"]["peak_gb"]:
            problems.append(f"rank {r['rank']}: 7e peak {fsdp['peak_gb']:.2f}"
                            f" GB, not below 7d's "
                            f"{r['train_pod']['peak_gb']:.2f}")
        # 7f: its collectives over "model" alone; choices dropped by
        # capacity in training and in the prefill; tokens held; B1 16 in
        # the prefill and B2 16 a serve step, all on the sm90 kernels
        serve = r["serve_moe"]
        for run, c in (("train", r["train_moe"]["counters"]),
                       ("prefill", serve["prefill_counters"]),
                       ("serve", serve["serve_counters"])):
            for name in ("all_reduce", "all_gather"):
                axes = set(c[f"{name}.by_axis"])
                if axes != {"model"}:
                    problems.append(f"rank {r['rank']}: 7f {run} {name} "
                                    f"over {axes}")
            if run != "serve" and not c["moe.dropped"] > 0:
                problems.append(f"rank {r['rank']}: 7f {run} dropped no "
                                "choice")
        for what in ("free", "routes_free", "check", "routes_imposed"):
            if not serve[what]["ok"]:
                problems.append(f"rank {r['rank']}: 7f-serve {what} off: "
                                f"{serve[what]}")
        problems += _hybrid_problems(r) + _xlstm_problems(r)
        pc, dc = serve["prefill_counters"], serve["serve_counters"]
        n_serve = STEPS_MOE_SERVE_LAYERS * DIST_TP["steps"]
        for what, n, n_sm90, expected in (
                ("prefill B1", pc["flash_attention.launches"],
                 pc["flash_attention.launches_sm90"], STEPS_MOE_SERVE_LAYERS),
                ("serve B2", dc["decode_attention.launches"],
                 dc["decode_attention.launches_sm90"], n_serve),
                ("serve B1", dc["flash_attention.launches"], 0, 0)):
            if not n == n_sm90 == expected:
                problems.append(f"rank {r['rank']}: 7f {what} launches {n} "
                                f"({n_sm90} sm90), {expected} expected")
    for run, tag in [(k, t) for k, (t, _) in held.items()] + \
            [(k, t) for k, (t, _, leaves) in held_rg.items() if leaves]:
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
    rg_ref = ranks[0]["train_rg"]["ref"]
    log(f"[steps] 7g in {[round(r['rg_seconds'], 1) for r in ranks]} s; "
        f"peak GB by rank: 7g-train reference {rg_ref['peak_gb']:.2f}, "
        f"tensor-parallel "
        f"{[round(r['train_rg']['peak_gb'], 2) for r in ranks]}; 7g-fsdp "
        f"{[round(r['train_rg_fsdp']['peak_gb'], 2) for r in ranks]} "
        f"(reference reused: "
        f"{ranks[0]['train_rg_fsdp']['ref'].get('reused', False)}, "
        f"{ranks[0]['rg_fsdp_reference']}); 7g-serve reference "
        f"{ranks[0]['serve_rg']['ref']['peak_gb']:.2f}, sharded "
        f"{[round(r['serve_rg']['peak_gb'], 2) for r in ranks]}")
    xl_ref = ranks[0]["train_xl"]["ref"]
    log(f"[steps] 7h in {[round(r['xl_seconds'], 1) for r in ranks]} s; "
        f"peak GB by rank: 7h-train reference {xl_ref['peak_gb']:.2f}, "
        f"tensor-parallel "
        f"{[round(r['train_xl']['peak_gb'], 2) for r in ranks]}; 7h-fsdp "
        f"{[round(r['train_xl_fsdp']['peak_gb'], 2) for r in ranks]} "
        f"(reference reused: "
        f"{ranks[0]['train_xl_fsdp']['ref'].get('reused', False)}, "
        f"{ranks[0]['xl_fsdp_reference']}); 7h-serve reference "
        f"{ranks[0]['serve_xl']['ref']['peak_gb']:.2f}, sharded "
        f"{[round(r['serve_xl']['peak_gb'], 2) for r in ranks]}")
    log(f"[steps] 7b-7h in {secs:.1f} s; peak GB by rank: 7b reference "
        f"{ranks[0]['train_tp']['ref']['peak_gb']:.2f}, tensor-parallel "
        f"{[round(r['train_tp']['peak_gb'], 2) for r in ranks]}; pools "
        f"{[round(r['pool_run']['peak_gb'], 2) for r in ranks]}; 7d "
        f"reference {ranks[0]['train_pod']['ref']['peak_gb']:.2f}, "
        f"data-parallel {[round(r['train_pod']['peak_gb'], 2) for r in ranks]}"
        f"; 7e FSDP {[round(r['train_fsdp']['peak_gb'], 2) for r in ranks]}"
        f" (reference reused: "
        f"{ranks[0]['train_fsdp']['ref'].get('reused', False)}, "
        f"{ranks[0]['fsdp_reference']}); 7f-train reference "
        f"{ranks[0]['train_moe']['ref']['peak_gb']:.2f}, sharded "
        f"{[round(r['train_moe']['peak_gb'], 2) for r in ranks]}; 7f-serve "
        f"reference {ranks[0]['serve_moe']['ref']['peak_gb']:.2f}, sharded "
        f"{[round(r['serve_moe']['peak_gb'], 2) for r in ranks]}; 7f in "
        f"{[round(r['moe_seconds'], 1) for r in ranks]} s")
    if problems:
        raise SystemExit(f"phase 7b-7h: {problems}")

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
            "steps-train-fsdp": {
                "flash_attention": total("train_fsdp", "flash_attention"),
                "flash_attention_bwd": total("train_fsdp",
                                             "flash_attention_bwd")},
            "steps-pools": {
                "flash_attention": total("pool_run", "flash_attention"),
                "decode_attention": total("pool_run", "decode_attention")},
            "steps-moe": {
                "flash_attention": total("train_moe", "flash_attention") +
                sum(r["serve_moe"]["prefill_counters"][
                    "flash_attention.launches"] for r in ranks),
                "flash_attention_bwd": total("train_moe",
                                             "flash_attention_bwd"),
                "decode_attention": sum(r["serve_moe"]["serve_counters"][
                    "decode_attention.launches"] for r in ranks)},
            "steps-hybrid": {
                name: sum(total(run, name) for run in
                          ("train_rg", "train_rg_fsdp")) +
                sum(r["serve_rg"][c][f"{name}.launches"] for r in ranks
                    for c in ("prefill_counters", "serve_counters"))
                for name in ("flash_attention", "flash_attention_bwd",
                             "decode_attention", "rglru_scan",
                             "rglru_scan_bwd")},
            "steps-ssm": {
                name: sum(total(run, name) for run in
                          ("train_xl32", "train_xl", "train_xl_fsdp")) +
                sum(r["serve_xl"][c][f"{name}.launches"] for r in ranks
                    for c in ("prefill_counters", "serve_counters"))
                for name in ("mlstm_chunk", "mlstm_chunk_bwd")}}


def phase_steps(report: dict) -> dict:
    """Phase 7: 7a, then 7b to 7h; fails past STEPS_TIMEOUT_S."""
    t0 = time.perf_counter()
    by_path = phase_steps_serve(report)
    by_path.update(phase_steps_ranks(report))
    secs = time.perf_counter() - t0
    ranks = report["steps_ranks"]["ranks"]
    log(f"[steps] phase 7 in {secs:.1f} s (7a "
        f"{report['steps_serve']['seconds']:.1f}, 7b-7h "
        f"{report['steps_ranks']['seconds']:.1f}, of which 7f "
        f"{max(r['moe_seconds'] for r in ranks):.1f}, 7g "
        f"{max(r['rg_seconds'] for r in ranks):.1f}, 7h "
        f"{max(r['xl_seconds'] for r in ranks):.1f})")
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
        report, "train-xlstm-350m", "xlstm-350m", n_steps=XLSTM_TRAIN_STEPS,
        n_layers=XLSTM_TRAIN_LAYERS)
    secs["5 train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_path.update(phase_dist(report))
    secs["6 dist"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_path.update(phase_steps(report))
    secs["7 steps"] = time.perf_counter() - t0
    secs["7f moe, in 7"] = max(r["moe_seconds"] for r in
                               report["steps_ranks"]["ranks"])
    secs["7g hybrid, in 7"] = max(r["rg_seconds"] for r in
                                  report["steps_ranks"]["ranks"])
    secs["7h ssm, in 7"] = max(r["xl_seconds"] for r in
                               report["steps_ranks"]["ranks"])
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
        # phase 7f: Phi-3.5-MoE's rank of 16 query heads over 4 KV heads,
        # 6b's head shape (its phase 2 cases)
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_tp", "path": "steps-moe"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_tp", "path": "steps-moe"},
        # phase 7g: RecurrentGemma-2B's rank of 5/1 heads and 1280 of the
        # RG-LRU width (its phase 2 cases)
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "case": "flash_attention_rg_tp", "path": "steps-hybrid"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_sm90.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
         "case": "decode_attention_rg_tp", "path": "steps-hybrid"},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:54",
         "case": "rglru_scan_tp", "path": "steps-hybrid"},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
         "grad_of": "src/repro/models/layers.py:105 gqa_attention",
         "case": "flash_attention_bwd_rg_tp", "path": "steps-hybrid"},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:54",
         "grad_of": "src/repro/models/rglru.py:114 associative_scan",
         "case": "rglru_scan_bwd_tp", "path": "steps-hybrid"},
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
        # phase 7h: xLSTM-350M's rank of 2 mLSTM heads of 512 (its phase 2
        # cases at the training's shape)
        {"name": "mlstm_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_chunk.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:76",
         "case": "mlstm_chunk_tp", "path": "steps-ssm"},
        {"name": "mlstm_chunk_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/mlstm_chunk_bwd.cu",
         "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:76",
         "grad_of": "src/repro/models/xlstm.py:83 _mlstm_chunk_scan",
         "case": "mlstm_chunk_bwd_tp", "path": "steps-ssm"},
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
