"""Power-performance model, calibrated to RAPID Figure 4 (MI300X) with a
TPU-v5e parameter set for the target hardware.

Paper observations (Fig 4a/b, Section 3.3):
  * prefill (compute-bound): up to 1.8x speedup for 1.87x power
    (400 W -> 750 W), still improving until ~700 W, then flattens;
  * decode (memory-bound): 1.3-1.5x, flattening beyond ~600 W.

We model speedup-vs-power with a saturating exponential
    s(p) = 1 + a * (1 - exp(-(p - p_min) / tau))
and fit (a, tau) so s(750) and the flattening points match the figure.

The same asymmetry holds on TPU: MXU throughput scales ~linearly with
frequency (DVFS), HBM bandwidth barely moves — so prefill tracks the power
knob and decode saturates early. The TPU parameter set expresses that; the
MI300X set is used for the paper-reproduction experiments.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PowerCurve:
    a: float          # asymptotic speedup - 1
    tau: float        # watts scale
    p_min: float      # minimum cap (reference point, speedup = 1)
    p_max: float      # TBP

    def speedup(self, p: float) -> float:
        p = min(max(p, self.p_min), self.p_max)
        return 1.0 + self.a * (1.0 - math.exp(-(p - self.p_min) / self.tau))

    def rel(self, p: float) -> float:
        """Throughput multiplier relative to max power (<= 1)."""
        return self.speedup(p) / self.speedup(self.p_max)


@dataclasses.dataclass(frozen=True)
class PowerModel:
    name: str
    prefill: PowerCurve
    decode: PowerCurve
    idle_w: float                 # idle draw
    enforce_latency_s: float      # cap-change enforcement (Fig 4c: O(100ms))

    def speedup(self, role: str, p: float) -> float:
        return (self.prefill if role == "prefill" else self.decode).speedup(p)

    def rel(self, role: str, p: float) -> float:
        return (self.prefill if role == "prefill" else self.decode).rel(p)

    def demand(self, role: str, busy: bool) -> float:
        """Unconstrained power demand of a GPU in the given state."""
        if not busy:
            return self.idle_w
        curve = self.prefill if role == "prefill" else self.decode
        return curve.p_max if role == "prefill" else 0.85 * curve.p_max

    def draw(self, role: str, cap: float, busy: bool) -> float:
        return min(cap, self.demand(role, busy))

    def joules(self, role: str, cap: float, dt_s: float,
               busy: bool = True) -> float:
        """Energy drawn over ``dt_s`` seconds at the given cap and state —
        the per-request energy accounting integrates this along each
        request's prefill/decode path (``core.simulator``)."""
        return self.draw(role, cap, busy) * dt_s


def mi300x() -> PowerModel:
    """Calibration: prefill s(750)=1.80 with tau=200 (still rising at 700);
    decode s(750)=1.40 with tau=90 (>=90% of gain by 600 W)."""
    return PowerModel(
        name="mi300x",
        prefill=PowerCurve(a=0.968, tau=200.0, p_min=400.0, p_max=750.0),
        decode=PowerCurve(a=0.408, tau=90.0, p_min=400.0, p_max=750.0),
        idle_w=90.0,
        enforce_latency_s=0.3,
    )


def h100() -> PowerModel:
    """H100 SXM (300-700 W cap range). Same compute/memory asymmetry as
    MI300X: SM clocks track the power knob almost to TBP (prefill ~1.8x for
    300->700 W), HBM3 bandwidth saturates early (decode ~1.4x, >=90% of the
    gain by ~550 W). Used for the heterogeneous multi-vendor cluster
    experiments (fig10)."""
    return PowerModel(
        name="h100",
        prefill=PowerCurve(a=0.95, tau=190.0, p_min=300.0, p_max=700.0),
        decode=PowerCurve(a=0.38, tau=85.0, p_min=300.0, p_max=700.0),
        idle_w=70.0,
        enforce_latency_s=0.3,
    )


def tpu_v5e_group() -> PowerModel:
    """TPU adaptation: an 8-chip v5e group treated as the 'node'. Per-chip
    envelope ~200 W scaled; prefill ~ linear in clock (compute term), decode
    saturates once HBM-bound. Used for target-hardware projections."""
    return PowerModel(
        name="tpu_v5e_group",
        prefill=PowerCurve(a=0.90, tau=55.0, p_min=110.0, p_max=200.0),
        decode=PowerCurve(a=0.30, tau=25.0, p_min=110.0, p_max=200.0),
        idle_w=35.0,
        enforce_latency_s=0.3,
    )


def get_power_model(name: str) -> PowerModel:
    return {"mi300x": mi300x, "h100": h100, "tpu_v5e": tpu_v5e_group}[name]()
