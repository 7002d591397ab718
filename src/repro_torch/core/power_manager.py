"""Node power management: per-GPU caps under a fixed node budget, with the
paper's source-before-sink ordering for dynamic power shifting (Section 2.2).

``PowerBackend`` abstracts the enforcement mechanism (amd-smi on MI300X; a
platform power API or ILP duty-cycling on TPU). ``SimulatedSMI`` reproduces
the Fig 4c behaviour: a cap-lowering command takes ``enforce_latency_s`` to
take effect; raises are immediate (raising a cap cannot violate the budget
as long as the budget accounting uses commanded caps for raises and
*previous* caps for in-flight lowers — which is exactly what the paper's
"lower sources first, then raise sinks" rule guarantees).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple


class InvariantViolation(AssertionError):
    """A power-budget invariant broke at runtime (sanitizer mode)."""


def sanitize_enabled(override: Optional[bool] = None) -> bool:
    """Resolve the sanitizer switch: an explicit ``sanitize=`` argument
    wins; otherwise the ``RAPID_SANITIZE`` environment variable."""
    if override is not None:
        return override
    return os.environ.get("RAPID_SANITIZE", "").lower() in (
        "1", "true", "yes", "on", "full")

MIN_CAP_W = 400.0
MAX_CAP_W = 750.0


@dataclasses.dataclass
class CapChange:
    gpu: int
    watts: float
    effective_at: float


class PowerBackend:
    """Interface: schedule a cap change, report when it is in force."""

    def set_cap(self, now: float, gpu: int, watts: float) -> CapChange:
        raise NotImplementedError


class SimulatedSMI(PowerBackend):
    def __init__(self, enforce_latency_s: float = 0.3):
        self.enforce_latency_s = enforce_latency_s

    def set_cap(self, now: float, gpu: int, watts: float) -> CapChange:
        return CapChange(gpu, watts, now + self.enforce_latency_s)


class PowerManager:
    """Tracks commanded + effective caps for every GPU; enforces the node
    budget invariant sum(max(commanded, effective)) <= budget at all times.

    The budget itself is *mutable at runtime* (hierarchical power: a cluster
    coordinator moves watts between node budgets, ``core.cluster``) with the
    same source-before-sink discipline one level up: ``shrink_budget`` lowers
    GPU caps first and only ``commit_budget`` — once those caps are in force —
    actually releases the watts; ``grow_budget`` raises are immediate."""

    def __init__(self, n_gpus: int, node_budget_w: float,
                 backend: Optional[PowerBackend] = None,
                 min_cap: float = MIN_CAP_W, max_cap: float = MAX_CAP_W,
                 initial_caps: Optional[List[float]] = None,
                 sanitize: Optional[bool] = None):
        self.n = n_gpus
        # sanitizer mode: self-check the budget invariant after every
        # mutator, not only at the dispatch boundary (RAPID_SANITIZE=1)
        self.sanitize = sanitize_enabled(sanitize)
        self.budget = node_budget_w
        self._budget_target = node_budget_w   # < budget while a shrink is in flight
        self.backend = backend or SimulatedSMI()
        self.min_cap, self.max_cap = min_cap, max_cap
        caps = initial_caps or [node_budget_w / n_gpus] * n_gpus
        caps = [min(max(c, min_cap), max_cap) for c in caps]
        assert sum(caps) <= node_budget_w + 1e-6
        self.commanded: List[float] = list(caps)
        self.effective: List[float] = list(caps)
        self.pending: List[CapChange] = []
        self.history: List[tuple] = []     # (t, gpu, watts)
        self.budget_history: List[tuple] = []   # (t, budget)
        # per-GPU change counters, bumped on every command AND every
        # effective-cap application. The macro-stepped simulator snapshots a
        # GPU's counter when it plans a run of decode iterations at a fixed
        # cap; a counter mismatch afterwards means the plan must be cut short
        # at the next iteration boundary and re-derived from fresh caps.
        # ``version_total`` aggregates them so the per-event staleness check
        # is a single comparison.
        self.cap_version: List[int] = [0] * n_gpus
        self.version_total = 0

    # -- bookkeeping -----------------------------------------------------------
    def _sanity(self, where: str) -> None:
        """Sanitizer-mode self-check: every mutator leaves the worst-case
        draw within budget and every cap inside the spec envelope."""
        if self._worst_case() > self.budget + 1e-6:
            raise InvariantViolation(
                f"PowerManager.{where}: worst-case draw "
                f"{self._worst_case():.3f} W exceeds budget "
                f"{self.budget:.3f} W")
        if self._budget_target > self.budget + 1e-6:
            raise InvariantViolation(
                f"PowerManager.{where}: budget target "
                f"{self._budget_target:.3f} W above budget {self.budget:.3f} W")
        for g in range(self.n):
            for val in (self.commanded[g], self.effective[g]):
                if val < -1e-6 or val > self.max_cap + 1e-6:
                    raise InvariantViolation(
                        f"PowerManager.{where}: GPU {g} cap {val:.3f} W "
                        f"outside [0, {self.max_cap:.0f}] W")

    def _worst_case(self) -> float:
        """Budget-relevant power: for lowering commands still in flight the
        GPU may still draw its old (higher) cap."""
        return sum(max(c, e) for c, e in zip(self.commanded, self.effective))

    def _usable_budget(self) -> float:
        """Budget that cap *raises* may consume: during an in-flight budget
        shrink the (lower) target is authoritative, so the node cannot grab
        back watts it has already promised to the cluster."""
        return min(self.budget, self._budget_target)

    @property
    def budget_floor_w(self) -> float:
        return self.n * self.min_cap

    @property
    def budget_ceil_w(self) -> float:
        return self.n * self.max_cap

    @property
    def budget_op_inflight(self) -> bool:
        """A budget shrink has been issued but not yet committed."""
        return abs(self._budget_target - self.budget) > 1e-9

    def tick(self, now: float) -> None:
        """Apply pending cap changes that have become effective."""
        if not self.pending:           # hot path: called on every sim event
            return
        still = []
        for ch in self.pending:
            if ch.effective_at <= now:
                self.effective[ch.gpu] = ch.watts
                self.cap_version[ch.gpu] += 1
                self.version_total += 1
            else:
                still.append(ch)
        self.pending = still
        if self.sanitize:
            self._sanity("tick")

    def caps(self) -> List[float]:
        return list(self.effective)

    # -- commands --------------------------------------------------------------
    def set_cap(self, now: float, gpu: int, watts: float) -> float:
        """Command one cap. Returns when it takes effect. Raising a cap is
        refused (ValueError) if it would break the worst-case budget."""
        watts = min(max(watts, self.min_cap), self.max_cap)
        old = self.commanded[gpu]
        if watts > old:
            # clamp the raise to the worst-case budget headroom: concurrent
            # in-flight lowers still count at their old caps, so a raise can
            # never overshoot the node budget (source-before-sink invariant)
            mine = max(old, self.effective[gpu])
            headroom = self._usable_budget() - (self._worst_case() - mine)
            watts = max(min(watts, headroom), self.min_cap)
            if watts <= old + 1e-9:
                return now
            # raises take effect immediately (no draw above demand anyway)
            self.commanded[gpu] = watts
            self.effective[gpu] = watts
            self.cap_version[gpu] += 1
            self.version_total += 1
            self.history.append((now, gpu, watts))
            if self.sanitize:
                self._sanity("set_cap")
            return now
        ch = self.backend.set_cap(now, gpu, watts)
        self.commanded[gpu] = watts
        self.pending.append(ch)
        self.cap_version[gpu] += 1
        self.version_total += 1
        self.history.append((now, gpu, watts))
        if self.sanitize:
            self._sanity("set_cap")
        return ch.effective_at

    def shift(self, now: float, src: List[int], dst: List[int],
              watts_per_gpu: float) -> Tuple[float, float]:
        """Move watts from each src GPU to dst GPUs (source-before-sink).
        Lowers the sources now; returns (t_ready, freed_watts). The caller
        schedules ``apply_raise(t_ready, dst, freed_watts, dst_max)`` —
        the payload travels with the event so concurrent shifts and uniform
        redistributions cannot clobber each other."""
        total = 0.0
        t_ready = now
        for g in src:
            target = max(self.commanded[g] - watts_per_gpu, self.min_cap)
            moved = self.commanded[g] - target
            if moved <= 0:
                continue
            t_ready = max(t_ready, self.set_cap(now, g, target))
            total += moved
        return t_ready, total

    def apply_raise(self, now: float, dst: List[int], total: float,
                    dst_max: Optional[float] = None) -> None:
        """Second phase of ``shift``: distribute the freed watts to sinks."""
        if not dst or total <= 0:
            return
        self.tick(now)
        per = total / len(dst)
        cap = min(self.max_cap, dst_max) if dst_max else self.max_cap
        for g in dst:
            target = min(self.commanded[g] + per, cap)
            if target > self.commanded[g]:
                self.set_cap(now, g, target)

    def distribute_uniform(self, now: float,
                           gpus: Optional[List[int]] = None
                           ) -> Tuple[float, List[int], float]:
        """Paper Algorithm 1 line 14: DISTRIBUTEUNIFORMPOWER(AllGPUs).
        Lower-first then raise; returns (t_ready, gpus, per)."""
        gpus = list(range(self.n)) if gpus is None else gpus
        per = min(self._usable_budget() / self.n, self.max_cap)
        t_ready = now
        for g in gpus:
            if self.commanded[g] > per:
                t_ready = max(t_ready, self.set_cap(now, g, per))
        return t_ready, gpus, per

    def apply_uniform(self, now: float, gpus: List[int],
                      per: float) -> None:
        self.tick(now)
        for g in gpus:
            if self.commanded[g] < per:
                self.set_cap(now, g, per)

    # -- hierarchical budgets (cluster -> node) --------------------------------
    def shrink_budget(self, now: float,
                      delta_w: float) -> Tuple[float, float]:
        """First phase of a cluster-level budget move out of this node:
        lower GPU caps (highest first) until the commanded total fits the
        shrunk budget, but keep ``self.budget`` — the facility-accounting
        value — at its old level until ``commit_budget``. Returns
        ``(t_ready, freed_watts)``; the caller schedules the commit (and the
        sink node's ``grow_budget``) at ``t_ready``. Mirrors ``shift``'s
        source-before-sink discipline one level up."""
        assert not self.budget_op_inflight, \
            "budget operation already in flight"
        target = max(self.budget - delta_w, self.budget_floor_w)
        freed = self.budget - target
        if freed <= 1e-9:
            return now, 0.0
        self._budget_target = target
        t_ready = self._lower_caps_to(now, target)
        if self.sanitize:
            self._sanity("shrink_budget")
        return t_ready, freed

    def _lower_caps_to(self, now: float, target: float) -> float:
        """Cut GPU caps until the commanded total fits ``target``; returns
        when every lowered cap (including pre-existing in-flight lowers,
        which still count at their old caps in ``_worst_case()``) is in
        force — the release may not happen before they land, even if no
        *new* cap cuts are needed."""
        t_ready = max([now] + [ch.effective_at for ch in self.pending])
        excess = sum(self.commanded) - target
        if excess > 1e-9:
            # level-down water-fill: bring the highest caps to a common level
            # so the cut spreads evenly instead of gutting one GPU
            order = sorted(range(self.n), key=lambda i: -self.commanded[i])
            prefix, level, chosen_k = 0.0, self.min_cap, self.n
            for k in range(1, self.n + 1):
                prefix += self.commanded[order[k - 1]]
                nxt = self.commanded[order[k]] if k < self.n else -1e18
                level = (prefix - excess) / k
                if level >= nxt - 1e-12:
                    chosen_k = k
                    break
            level = max(level, self.min_cap)
            for g in order[:chosen_k]:
                if self.commanded[g] > level + 1e-9:
                    t_ready = max(t_ready, self.set_cap(now, g, level))
        return t_ready

    def emergency_shrink(self, now: float,
                         target_w: float) -> Tuple[float, float]:
        """Facility power emergency: force-throttle this node toward
        ``target_w`` watts, source-before-sink like ``shrink_budget`` —
        caps are cut first and the watts release only at the caller's
        ``commit_budget`` once the lowered caps are in force. Unlike
        ``shrink_budget`` this path is *preemptive*: it may land while a
        coordinator budget op is already in flight on this node, in which
        case the tighter of the two targets wins (the in-flight op's
        commit then lands at the emergency target — the sink still
        receives only the watts the op originally freed, so the facility
        sum can only fall). Targets clamp at the node's cap floor: a
        powered node cannot be throttled below spec minimums.

        Returns ``(t_ready, freed)`` where ``freed`` is relative to the
        currently-promised (usable) budget."""
        target = max(min(target_w, self.budget), self.budget_floor_w)
        freed = self._usable_budget() - target
        if freed <= 1e-9:
            return now, 0.0
        self._budget_target = target
        t_ready = self._lower_caps_to(now, target)
        if self.sanitize:
            self._sanity("emergency_shrink")
        return t_ready, freed

    def commit_budget(self, now: float) -> None:
        """Second phase: the lowered caps are in force; release the watts."""
        self.tick(now)
        self.budget = self._budget_target
        self.budget_history.append((now, self.budget))
        assert self._worst_case() <= self.budget + 1e-6, \
            (self._worst_case(), self.budget)
        if self.sanitize:
            self._sanity("commit_budget")

    def grow_budget(self, now: float, delta_w: float) -> float:
        """Raise this node's budget immediately (safe: more budget cannot
        violate anything) and water-fill the new headroom across GPU caps so
        the node can use it right away. Returns the watts actually absorbed
        (clamped by ``n * max_cap``); the caller returns any remainder to the
        source node so facility watts are conserved."""
        assert not self.budget_op_inflight, \
            "budget operation already in flight"
        new = min(self.budget + delta_w, self.budget_ceil_w)
        absorbed = new - self.budget
        if absorbed <= 1e-9:
            return 0.0
        self.budget = new
        self._budget_target = new
        self.budget_history.append((now, self.budget))
        left = absorbed
        # least-headroom first: a GPU that clamps at max_cap rolls its
        # surplus share to the ones that still have room
        order = sorted(range(self.n),
                       key=lambda i: self.max_cap - self.commanded[i])
        for idx, g in enumerate(order):
            share = left / (self.n - idx)
            give = min(share, self.max_cap - self.commanded[g])
            if give > 1e-9:
                self.set_cap(now, g, self.commanded[g] + give)
                left -= give
        if self.sanitize:
            self._sanity("grow_budget")
        return absorbed

    # -- fleet membership (node power on/off) ----------------------------------
    @property
    def powered(self) -> bool:
        return self.budget > 0.0

    def power_off(self, now: float) -> float:
        """Take the whole node off the facility budget (leave/failure). A
        powered-off node draws nothing and holds no watts, so its budget and
        all caps drop to zero immediately — there is no enforcement latency
        to wait out because the node is not *lowering under load*, it is
        gone. Returns the watts released to the facility."""
        released = self.budget
        self.budget = 0.0
        self._budget_target = 0.0
        self.pending.clear()
        for g in range(self.n):
            self.commanded[g] = 0.0
            self.effective[g] = 0.0
            self.cap_version[g] += 1
        self.version_total += self.n
        self.budget_history.append((now, 0.0))
        if self.sanitize:
            self._sanity("power_off")
        return released

    def power_on(self, now: float, budget_w: float) -> float:
        """Bring the node onto the facility budget with ``budget_w`` watts
        (clamped to [floor, ceiling]) and uniform per-GPU caps. Caps take
        effect immediately: a node powering on cannot be drawing above its
        fresh caps. Returns the watts actually absorbed — the caller keeps
        any remainder for other nodes (facility conservation)."""
        assert not self.powered, "power_on on a live node"
        budget = min(max(budget_w, self.budget_floor_w), self.budget_ceil_w)
        if budget > budget_w + 1e-9:
            raise ValueError(
                f"power_on granted {budget_w} W < floor {self.budget_floor_w} W")
        self.budget = budget
        self._budget_target = budget
        per = min(budget / self.n, self.max_cap)
        for g in range(self.n):
            self.commanded[g] = per
            self.effective[g] = per
            self.cap_version[g] += 1
        self.version_total += self.n
        self.budget_history.append((now, budget))
        self.history.append((now, -1, per))     # -1: whole-node uniform set
        if self.sanitize:
            self._sanity("power_on")
        return budget

    def at_limits(self, src: List[int], dst: List[int],
                  dst_max: Optional[float] = None) -> bool:
        """POWERLIMITSREACHED: no more watts can move src -> dst."""
        dst_cap = min(self.max_cap, dst_max) if dst_max else self.max_cap
        src_done = all(self.commanded[g] <= self.min_cap + 1e-6 for g in src)
        dst_done = all(self.commanded[g] >= dst_cap - 1e-6 for g in dst)
        return src_done or dst_done or not src or not dst
