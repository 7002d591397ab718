"""Goodput / SLO-attainment metrics (DistServe-style, per RAPID Section 3.1).

A request meets SLO iff TTFT <= ttft_slo AND mean TPOT <= tpot_slo.
Goodput = rate of SLO-meeting requests. QPS/W uses average *provisioned*
GPU power (the paper's accounting, Section 4).

Per-request energy (``energy_j``): joules of *busy draw* integrated along
the request's prefill/decode path by the simulator — prefill batches split
proportionally by prompt tokens, decode iterations split evenly across the
batch. It counts work actually burned for the request (including work later
wasted by a node failure) but NOT idle/provisioned power — that overhead
lives in ``avg_provisioned_w``/``qps_per_kw``. ``energy_per_good_token_j``
divides fleet-wide spent energy by the output tokens of SLO-meeting
requests, so wasted work (failed/migrated/SLO-missing requests) makes the
goodput-relative energy price visibly worse.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol

import numpy as np

J_PER_KWH = 3.6e6


class EnergySignal(Protocol):
    """A time series the summary can price spent joules against — the
    structural type of ``core.autoscale.SignalTrace`` (price in $/kWh,
    carbon intensity in gCO2/kWh). Kept as a Protocol so this module stays
    below ``autoscale`` in the layering."""

    def values_at(self, ts: np.ndarray) -> np.ndarray:
        """Signal values in force at each timestamp (edge-clamped)."""
        ...


@dataclasses.dataclass
class RequestRecord:
    rid: int
    arrival: float
    input_tokens: int
    output_tokens: int
    prefill_done: Optional[float] = None    # first token time
    finish: Optional[float] = None
    ttft_slo: float = 1.0
    tpot_slo: float = 0.040
    energy_j: float = 0.0          # busy-draw joules spent on this request
    # SLO-aware admission control rejected this request (overload /
    # emergency shedding). A shed request can never finish or meet SLO —
    # it counts against attainment, and any joules it burned before being
    # shed (e.g. pre-failure work before a requeue was rejected) are
    # reported separately so degradation is visible, not laundered.
    shed_t: Optional[float] = None
    # owning tenant (core.tenancy): drives preemption priority, admission
    # weight, and the per-tenant attribution block in the summary. The
    # "default" tag keeps single-stream workloads on their pre-tenancy
    # accounting path.
    tenant: str = "default"

    @property
    def ttft(self) -> Optional[float]:
        if self.prefill_done is None:
            return None
        return self.prefill_done - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finish is None or self.prefill_done is None:
            return None
        n = max(self.output_tokens - 1, 1)
        return (self.finish - self.prefill_done) / n

    @property
    def meets_slo(self) -> bool:
        return (self.ttft is not None and self.tpot is not None
                and self.ttft <= self.ttft_slo + 1e-9
                and self.tpot <= self.tpot_slo + 1e-9)


@dataclasses.dataclass
class GoodputSummary:
    n_total: int
    n_finished: int
    n_good: int
    slo_attainment: float          # fraction of all requests meeting SLO
    goodput_rps: float             # SLO-meeting requests per second
    p50_ttft: float
    p90_ttft: float
    p50_tpot: float
    p90_tpot: float
    duration_s: float
    avg_provisioned_w: float
    qps_per_kw: float
    total_energy_j: float = 0.0
    # spent joules per SLO-meeting output token; 0.0 when nothing met SLO
    energy_per_good_token_j: float = 0.0
    # tariff attribution (0.0 unless price/carbon traces were provided):
    # spent joules priced at the electricity price / carbon intensity in
    # force when each request finished — the $/good-token and
    # gCO2/good-token objectives the autoscaler optimizes
    total_cost_usd: float = 0.0
    cost_per_good_token_usd: float = 0.0
    total_carbon_g: float = 0.0
    carbon_per_good_token_g: float = 0.0
    # load shedding (SLO-aware admission control): shed requests and the
    # joules they burned before rejection, accounted separately — they are
    # already counted against slo_attainment via n_total
    n_shed: int = 0
    shed_energy_j: float = 0.0
    # per-tenant attribution (core.tenancy): tenant name -> the same
    # goodput/energy/$/carbon metrics restricted to that tenant's records.
    # Empty for single-stream workloads, so existing JSON artifacts keep
    # their schema (append-only — old artifacts still parse).
    per_tenant: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)

    def row(self) -> str:
        s = (f"good {self.slo_attainment*100:5.1f}%  goodput "
             f"{self.goodput_rps:6.2f} req/s  TTFT p90 {self.p90_ttft:6.3f}s "
             f"TPOT p90 {self.p90_tpot*1e3:6.1f}ms  "
             f"QPS/kW {self.qps_per_kw:5.2f}  "
             f"J/tok {self.energy_per_good_token_j:5.2f}")
        if self.total_cost_usd > 0.0:
            s += f"  $/Mtok {self.cost_per_good_token_usd*1e6:6.2f}"
        if self.total_carbon_g > 0.0:
            s += f"  gCO2/Mtok {self.carbon_per_good_token_g*1e6:6.1f}"
        if self.n_shed > 0:
            s += f"  shed {self.n_shed}"
        for name, t in self.per_tenant.items():
            s += (f"\n    {name:12s} good {t['slo_attainment']*100:5.1f}%  "
                  f"TTFT p90 {t['p90_ttft']:6.3f}s  "
                  f"J/tok {t['energy_per_good_token_j']:5.2f}")
            if t["total_cost_usd"] > 0.0:
                s += f"  $/Mtok {t['cost_per_good_token_usd']*1e6:6.2f}"
            if t["n_shed"] > 0:
                s += f"  shed {t['n_shed']:.0f}"
        return s


def summarize(records: List[RequestRecord], duration_s: float,
              avg_provisioned_w: float,
              price_trace: Optional[EnergySignal] = None,
              carbon_trace: Optional[EnergySignal] = None) -> GoodputSummary:
    # Vectorized over preallocated arrays: one attribute pass per record,
    # then numpy for TTFT/TPOT/SLO math — fleet-scale summaries (tens of
    # thousands of records) were a visible chunk of benchmark wall time.
    # The arithmetic mirrors RequestRecord.ttft/.tpot/.meets_slo exactly.
    n = len(records)
    arrival = np.empty(n)
    pd_ = np.empty(n)
    fin_t = np.empty(n)
    out_tok = np.empty(n)
    ttft_slo = np.empty(n)
    tpot_slo = np.empty(n)
    energy = np.empty(n)
    shed = np.empty(n, dtype=bool)
    tenants: List[str] = [""] * n
    for i, r in enumerate(records):
        arrival[i] = r.arrival
        pd_[i] = np.nan if r.prefill_done is None else r.prefill_done
        fin_t[i] = np.nan if r.finish is None else r.finish
        out_tok[i] = r.output_tokens
        ttft_slo[i] = r.ttft_slo
        tpot_slo[i] = r.tpot_slo
        energy[i] = r.energy_j
        shed[i] = r.shed_t is not None
        tenants[i] = r.tenant
    fin_mask = ~np.isnan(fin_t)
    n_fin = int(fin_mask.sum())
    ttft = pd_[fin_mask] - arrival[fin_mask]
    tpot = (fin_t[fin_mask] - pd_[fin_mask]) / \
        np.maximum(out_tok[fin_mask] - 1, 1)
    good_mask = ((ttft <= ttft_slo[fin_mask] + 1e-9) &
                 (tpot <= tpot_slo[fin_mask] + 1e-9) & ~np.isnan(ttft))
    n_good = int(good_mask.sum())
    if n_fin:
        p50_ttft, p90_ttft = np.percentile(ttft, (50, 90))
        p50_tpot, p90_tpot = np.percentile(tpot, (50, 90))
    else:
        # percentile() of [inf] raises a spurious inf-inf RuntimeWarning
        p50_ttft = p90_ttft = p50_tpot = p90_tpot = np.inf
    goodput = n_good / duration_s if duration_s > 0 else 0.0
    total_energy = float(energy.sum())
    good_tokens = float(out_tok[fin_mask][good_mask].sum())
    # tariff attribution: a record's joules are priced at the trace value
    # in force at its finish instant (arrival for never-finished requests —
    # their partial work was spent around then). Piecewise-constant traces
    # make this deterministic and cheap; sub-request price changes are
    # below the tariff resolution this models (5-minute to hourly markets).
    t_spend = np.where(np.isnan(fin_t), arrival, fin_t)
    total_cost = cost_per_good = 0.0
    cost = None
    if price_trace is not None:
        cost = energy / J_PER_KWH * price_trace.values_at(t_spend)
        total_cost = float(cost.sum())
        cost_per_good = total_cost / good_tokens if good_tokens > 0 else 0.0
    total_carbon = carbon_per_good = 0.0
    carbon = None
    if carbon_trace is not None:
        carbon = energy / J_PER_KWH * carbon_trace.values_at(t_spend)
        total_carbon = float(carbon.sum())
        carbon_per_good = (total_carbon / good_tokens
                           if good_tokens > 0 else 0.0)
    # per-tenant attribution: the same masks restricted per tenant tag.
    # Only materialized when the workload is actually multi-tenant, so
    # single-stream summaries (and their JSON artifacts) are unchanged.
    per_tenant: Dict[str, Dict[str, float]] = {}
    if any(t != "default" for t in tenants):
        good_full = np.zeros(n, dtype=bool)
        good_full[np.nonzero(fin_mask)[0]] = good_mask
        ttft_full = np.full(n, np.nan)
        ttft_full[fin_mask] = ttft
        tarr = np.array(tenants)
        for name in sorted(set(tenants)):
            m = tarr == name
            mf = m & fin_mask
            good_m = good_full & m
            n_good_m = int(good_m.sum())
            gtok = float(out_tok[good_m].sum())
            e_m = float(energy[m].sum())
            c_m = float(cost[m].sum()) if cost is not None else 0.0
            g_m = float(carbon[m].sum()) if carbon is not None else 0.0
            per_tenant[name] = {
                "n_total": int(m.sum()),
                "n_finished": int(mf.sum()),
                "n_good": n_good_m,
                "slo_attainment": n_good_m / max(int(m.sum()), 1),
                "goodput_rps": (n_good_m / duration_s
                                if duration_s > 0 else 0.0),
                "p90_ttft": (float(np.percentile(ttft_full[mf], 90))
                             if int(mf.sum()) else float(np.inf)),
                "total_energy_j": e_m,
                "energy_per_good_token_j": e_m / gtok if gtok > 0 else 0.0,
                "total_cost_usd": c_m,
                "cost_per_good_token_usd": c_m / gtok if gtok > 0 else 0.0,
                "total_carbon_g": g_m,
                "carbon_per_good_token_g": g_m / gtok if gtok > 0 else 0.0,
                "n_shed": int(shed[m].sum()),
            }
    return GoodputSummary(
        n_total=n, n_finished=n_fin, n_good=n_good,
        slo_attainment=n_good / max(n, 1),
        goodput_rps=goodput,
        p50_ttft=float(p50_ttft),
        p90_ttft=float(p90_ttft),
        p50_tpot=float(p50_tpot),
        p90_tpot=float(p90_tpot),
        duration_s=duration_s,
        avg_provisioned_w=avg_provisioned_w,
        qps_per_kw=1000.0 * goodput / max(avg_provisioned_w, 1.0),
        total_energy_j=total_energy,
        energy_per_good_token_j=(total_energy / good_tokens
                                 if good_tokens > 0 else 0.0),
        total_cost_usd=total_cost,
        cost_per_good_token_usd=cost_per_good,
        total_carbon_g=total_carbon,
        carbon_per_good_token_g=carbon_per_good,
        n_shed=int(shed.sum()),
        shed_energy_j=float(energy[shed].sum()),
        per_tenant=per_tenant,
    )
