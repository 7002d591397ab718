"""RAPID resource controllers: Algorithm 1 (reactive dynamic scheduling) and
the static / partially-dynamic policies evaluated in the paper (Section 5).

The controller is *observation-driven*: it sees recent TTFT/TPOT, queue
depths, and the power manager — no latency prediction or offline profiling
(paper Section 3.3, contrast with WindServe). Decisions:

  MovePower(decode -> prefill)   when TTFT stressed and TPOT healthy
  MoveGPU(decode -> prefill)     when power limits reached
  (and the symmetric direction)

with a cooldown between actions (implicit hysteresis), queue depth as the
early-warning trigger, and a decode power ceiling of 600 W (the paper's
observation that decode does not scale beyond it, Fig 9a).
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.core.power_manager import PowerManager


@dataclasses.dataclass
class ControllerConfig:
    ttft_slo: float = 1.0
    tpot_slo: float = 0.040
    queue_threshold: int = 4        # THRESHOLD on |Q_P|
    cooldown_s: float = 3.0         # COOLDOWN for GPU moves (paper: 2-6 s)
    power_cooldown_s: float = 0.5   # power loop runs at sub-second pace
    min_time_s: float = 0.25        # MIN_TIME control period
    power_step_w: float = 50.0
    min_prefill_gpus: int = 1       # MIN_P
    min_decode_gpus: int = 1
    decode_cap_max_w: float = 600.0  # decode doesn't scale beyond (Fig 9)
    gpu_move_drain_s: float = 3.0   # role flip drain cost (paper: 2-5 s)
    allow_power: bool = True        # DynPower
    allow_gpu: bool = False         # DynGPU


@dataclasses.dataclass
class Observation:
    now: float
    ttft_p90: float                 # recent window
    tpot_p90: float
    q_prefill: int
    q_decode: int


@dataclasses.dataclass
class Decision:
    kind: str                       # "none" | "power" | "gpu"
    direction: str = ""             # "d2p" | "p2d"
    note: str = ""


class RapidController:
    """Algorithm 1. Interacts with a cluster through a narrow interface:
    the PowerManager plus role lists (indices of prefill/decode GPUs)."""

    def __init__(self, cfg: ControllerConfig, pm: PowerManager):
        self.cfg = cfg
        self.pm = pm
        self.last_move_time = -1e9      # any move (gates the power loop)
        self.last_gpu_time = -1e9       # GPU moves (long cooldown)
        self.trace: List[tuple] = []    # (t, kind, direction)

    # role lists are owned by the cluster; controller reads them each tick
    def tick(self, obs: Observation, prefill_gpus: List[int],
             decode_gpus: List[int]) -> Decision:
        c = self.cfg
        now = obs.now
        if now - self.last_move_time < c.power_cooldown_s:
            return Decision("none", note="cooldown")

        ttft_bad = obs.ttft_p90 > c.ttft_slo
        tpot_bad = obs.tpot_p90 > c.tpot_slo
        queue_hot = obs.q_prefill > c.queue_threshold

        # --- prefill-side stress: TTFT over SLO, queue building, decode OK --
        if ttft_bad and queue_hot and not tpot_bad:
            return self._relieve(now, "d2p", src=decode_gpus, dst=prefill_gpus,
                                 src_min=c.min_decode_gpus,
                                 dst_max_w=self.pm.max_cap)
        # --- decode-side stress: TPOT over SLO, prefill healthy --------------
        if tpot_bad and not ttft_bad:
            return self._relieve(now, "p2d", src=prefill_gpus, dst=decode_gpus,
                                 src_min=c.min_prefill_gpus,
                                 dst_max_w=c.decode_cap_max_w)
        return Decision("none")

    def _relieve(self, now: float, direction: str, src: List[int],
                 dst: List[int], src_min: int, dst_max_w: float) -> Decision:
        c = self.cfg
        if c.allow_power and not self.pm.at_limits(src, dst, dst_max_w):
            self.last_move_time = now
            self.trace.append((now, "power", direction))
            return Decision("power", direction)
        if c.allow_gpu and len(src) > src_min and \
                now - self.last_gpu_time >= c.cooldown_s:
            self.last_move_time = now
            self.last_gpu_time = now
            self.trace.append((now, "gpu", direction))
            return Decision("gpu", direction,
                            note="power limits reached" if c.allow_power else "")
        if c.allow_power and not c.allow_gpu:
            # power-only policy saturated: nothing to do
            return Decision("none", note="power saturated")
        return Decision("none", note="at limits")
