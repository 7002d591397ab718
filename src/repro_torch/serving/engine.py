"""Real-compute disaggregated serving engine on PyTorch, ported from
``repro.serving.engine``.

Prefill workers run the model over each prompt and fill a KV cache; the
ring buffer hands the cache to a decode worker, which runs continuous
batching with per-slot positions; the same RapidController/PowerManager
move watts and roles. Power caps scale a logical clock, exactly as in the
JAX engine: the port actuates no real power limit.

On the GPU, prefill attention runs the hand-written flash kernel, decode
attention the split-KV kernel, the hybrid family's recurrence the RG-LRU
scan and the ssm family's mLSTM prefill the chunkwise mLSTM kernel
(``repro_torch.kernels``); the encoder-decoder's encoder and its
cross-attention run the flash kernel non-causal. The decode worker's
batched cache is written in place (slot insertion and each step's new
token and state), not copied.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import (ControllerConfig, Observation,
                                         RapidController)
from repro_torch.core.goodput import RequestRecord, summarize
from repro_torch.core.power_manager import PowerManager
from repro_torch.core.power_model import PowerModel, mi300x
from repro_torch.models import LM, resolve_device
from repro_torch.serving.ring import KVRing


@dataclasses.dataclass
class ServeRequest:
    rec: RequestRecord
    tokens: np.ndarray               # prompt
    generated: list = dataclasses.field(default_factory=list)
    slot: int = -1                   # decode slot index


def _cache_insert(dst: dict, src: dict, slot: int) -> None:
    """Copy a batch-1 prefilled cache into slot ``slot`` of a batched decode
    cache, in place, walking every top-level key but ``pos`` through its
    nested dicts and tuples: KV caches ``{"k", "v"}``, the hybrid's (conv
    tail, h), the xLSTM's (C, n, m) and (c, n, m, h), the encoder-decoder's
    top-level ``k``, ``v``, ``ck`` and ``cv``. Leaves are stacked (L, B,
    ...), so batch is dim 1, except under the hybrid's unstacked ``rest``,
    where it is dim 0, as ``repro.serving.engine._cache_insert`` has it."""
    def ins(d, s, bdim):
        if isinstance(d, dict):
            for k in d:
                ins(d[k], s[k], bdim)
        elif isinstance(d, tuple):
            for dd, ss in zip(d, s):
                ins(dd, ss, bdim)
        else:
            d.select(bdim, slot).copy_(s.select(bdim, 0))
    for key in dst:
        if key != "pos":
            ins(dst[key], src[key], 0 if key == "rest" else 1)


class Worker:
    def __init__(self, wid: int, role: str):
        self.wid = wid
        self.role = role
        self.draining = False
        self.free_at = 0.0           # logical clock
        # decode state
        self.active: dict = {}       # slot -> ServeRequest
        self.cache = None            # the decode cache without "pos"
        self.pos = None              # (B,) int32 per-slot positions, on device


class DisaggEngine:
    def __init__(self, cfg: ModelConfig, *, n_prefill: int = 1,
                 n_decode: int = 1, max_len: int = 192,
                 decode_slots: int = 8, node_budget_w: float = 4800.0,
                 ctrl_cfg: Optional[ControllerConfig] = None,
                 power: Optional[PowerModel] = None, seed: int = 0,
                 caps: Optional[List[float]] = None,
                 time_scale: float = 1.0, device=None,
                 dtype: torch.dtype = torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.lm = LM(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.lm.init(gen, dtype=dtype, device=self.device)
        self.max_len = max_len
        self.decode_slots = decode_slots
        n = n_prefill + n_decode
        self.workers = ([Worker(i, "prefill") for i in range(n_prefill)] +
                        [Worker(n_prefill + i, "decode")
                         for i in range(n_decode)])
        self.pm = PowerManager(n, node_budget_w,
                               initial_caps=caps or [node_budget_w / n] * n)
        self.power = power or mi300x()
        self.ctrl = RapidController(ctrl_cfg, self.pm) if ctrl_cfg else None
        self.ctrl_cfg = ctrl_cfg
        self.ring = KVRing(32)
        self.queue: deque = deque()
        self.records: List[RequestRecord] = []
        self.finished: List[ServeRequest] = []
        self.clock = 0.0             # logical seconds
        self.time_scale = time_scale
        self.recent_ttft: deque = deque(maxlen=64)
        self.recent_tpot: deque = deque(maxlen=64)
        # wall seconds of each prefill / decode step (device work included)
        self.prefill_walls: List[float] = []
        self.decode_walls: List[float] = []

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, out_tokens: int, now: float,
               ttft_slo=1.0, tpot_slo=0.04):
        rid = len(self.records)
        rec = RequestRecord(rid, now, len(prompt), out_tokens,
                            ttft_slo=ttft_slo, tpot_slo=tpot_slo)
        self.records.append(rec)
        self.queue.append(ServeRequest(rec, prompt))

    def _logical_dt(self, wall: float, role: str, wid: int) -> float:
        rel = self.power.rel(role, self.pm.effective[wid])
        return wall * self.time_scale / rel

    def stub_frames(self) -> torch.Tensor:
        """The encoder-decoder's stub audio front end: zero frame embeddings
        (1, encoder_seq, d_model), as the JAX engine feeds its prefill, but
        in the engine's dtype (the JAX engine's fp32 zeros would promote
        its encoder to fp32; here they would meet bf16 weights and fail)."""
        return torch.zeros((1, self.cfg.encoder_seq, self.cfg.d_model),
                           dtype=self.dtype, device=self.device)

    def _sync(self):
        """Wait for the device, the counterpart of ``block_until_ready``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _do_prefill(self, w: Worker) -> bool:
        if not self.queue or self.ring.n_free == 0:
            return False
        req = self.queue.popleft()
        toks = torch.as_tensor(req.tokens, dtype=torch.long,
                               device=self.device)[None, :]
        cache = self.lm.init_cache(1, self.max_len, dtype=self.dtype,
                                   device=self.device)
        batch = {"tokens": toks}
        if self.cfg.is_encoder_decoder:
            batch["enc_feats"] = self.stub_frames()
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.lm.prefill(self.params, batch, cache)
        first = int(torch.argmax(logits[0]))      # waits for the device
        wall = time.perf_counter() - t0
        self.prefill_walls.append(wall)
        dt = self._logical_dt(wall, "prefill", w.wid)
        self.clock = max(self.clock, w.free_at) + dt
        w.free_at = self.clock
        req.rec.prefill_done = self.clock
        self.recent_ttft.append(req.rec.ttft)
        req.generated.append(first)
        assert self.ring.try_put((req, cache, first)) is not None
        return True

    def _ensure_decode_state(self, w: Worker):
        if w.cache is None:
            cache = self.lm.init_cache(self.decode_slots, self.max_len,
                                       dtype=self.dtype, device=self.device)
            w.cache = {k: v for k, v in cache.items() if k != "pos"}
            w.pos = torch.zeros((self.decode_slots,), dtype=torch.int32,
                                device=self.device)

    def _admit(self, w: Worker):
        self._ensure_decode_state(w)
        while len(w.active) < self.decode_slots and self.ring.n_ready:
            req, cache, _first = self.ring.try_pull()
            slot = next(i for i in range(self.decode_slots)
                        if i not in {r.slot for r in w.active.values()})
            req.slot = slot
            _cache_insert(w.cache, cache, slot)
            w.pos[slot] = len(req.tokens)
            w.active[slot] = req

    def _do_decode_iter(self, w: Worker) -> bool:
        self._admit(w)
        if not w.active:
            return False
        # feed each slot its last token (inactive slots feed 0)
        tok = np.zeros((self.decode_slots,), np.int64)
        for slot, req in w.active.items():
            tok[slot] = req.generated[-1]
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.lm.decode_step(
            self.params, torch.as_tensor(tok, device=self.device),
            {**w.cache, "pos": w.pos})
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self._sync()
        wall = time.perf_counter() - t0
        self.decode_walls.append(wall)
        dt = self._logical_dt(wall, "decode", w.wid)
        self.clock = max(self.clock, w.free_at) + dt
        w.free_at = self.clock
        self.recent_tpot.append(dt)
        w.pos = cache["pos"]
        # one device-to-host copy per step for all slots' tokens and positions
        nxt_h, pos_h = torch.stack([nxt, w.pos]).cpu().numpy()
        done = []
        for slot, req in list(w.active.items()):
            req.generated.append(int(nxt_h[slot]))
            if len(req.generated) >= req.rec.output_tokens or \
                    int(pos_h[slot]) >= self.max_len - 1:
                req.rec.finish = self.clock
                self.finished.append(req)
                done.append(slot)
        for slot in done:
            del w.active[slot]
        return True

    # ------------------------------------------------------------------
    def _ctrl_tick(self):
        if self.ctrl is None:
            return
        self.pm.tick(self.clock)
        pre = [w.wid for w in self.workers if w.role == "prefill"
               and not w.draining]
        dec = [w.wid for w in self.workers if w.role == "decode"
               and not w.draining]
        obs = Observation(
            now=self.clock,
            ttft_p90=float(np.percentile(self.recent_ttft, 90))
            if self.recent_ttft else 0.0,
            tpot_p90=float(np.percentile(self.recent_tpot, 90))
            if self.recent_tpot else 0.0,
            q_prefill=len(self.queue), q_decode=self.ring.n_ready)
        d = self.ctrl.tick(obs, pre, dec)
        if d.kind == "power":
            src, dst = (dec, pre) if d.direction == "d2p" else (pre, dec)
            t_ready, freed = self.pm.shift(self.clock, src, dst,
                                           self.ctrl_cfg.power_step_w)
            self.pm.tick(t_ready)
            self.pm.apply_raise(t_ready, dst, freed,
                                self.ctrl_cfg.decode_cap_max_w
                                if d.direction == "p2d" else None)
        elif d.kind == "gpu":
            cands = dec if d.direction == "d2p" else pre
            if len(cands) > 1:
                w = self.workers[cands[-1]]
                if not w.active:     # drain-free flip for idle workers
                    w.role = ("prefill" if d.direction == "d2p" else "decode")
                    w.cache, w.pos, w.active = None, None, {}
                    self.clock += self.ctrl_cfg.gpu_move_drain_s
                    t_r, gpus, per = self.pm.distribute_uniform(self.clock)
                    self.pm.tick(t_r)
                    self.pm.apply_uniform(t_r, gpus, per)

    # ------------------------------------------------------------------
    def run(self, max_iters: int = 10_000):
        """Drive until all submitted requests finish."""
        it = 0
        while it < max_iters:
            it += 1
            progressed = False
            for w in self.workers:
                if w.role == "prefill":
                    progressed |= self._do_prefill(w)
                else:
                    progressed |= self._do_decode_iter(w)
            self._ctrl_tick()
            if not progressed:
                if all(r.finish is not None for r in self.records):
                    break
                self.clock += 0.01
        dur = max((r.finish or self.clock) for r in self.records) \
            if self.records else self.clock
        return summarize(self.records, dur, sum(self.pm.effective))
