"""Goodput-aware cluster reconfiguration (paper §3.3.1); mirrors
repro/core/planner.py, iteration orders and tie-breaks included, so that
both packages make the same plan from the same profile.

Every control window the planner:
  1. enumerates candidate configurations (tier × TP_prefill × TP_decode),
  2. estimates each one's goodput efficiency
         GE = min(P·THP, rps) / (P·TPi + D·TPj)            (paper Eq. 1)
     with the prefill/decode ratio balanced so P·THP = D·THD,
  3. assigns chips with a *weighted* greedy on
         WGE = GE · rps / served_rps                        (unmet demand)
     until the pool is exhausted, then discretizes fractional group counts.

The candidate space is a small fixed set of TP levels (×tiers), so planning
cost is O(tiers · |TP|²) per window, independent of cluster size — matching
the paper's §4.2.3 scalability argument.
"""
from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.goodput import SLOTier
from repro_torch.profiles.perf_model import (
    PerfModel,
    TPOT_DESIGN_MARGIN,
    mid_decode_ctx,
)
from repro_torch.traces.workload import Topology

# Per-host failure-rate multiple of the per-chip rate for the planner's
# expected-recovery-cost term (docs/faults.md §Fault-aware planning): one
# host event takes all of its chips down at once, so host hazard dominates
# chip hazard by roughly the host's chip count in the incident matrix's
# cascade families.
HOST_HAZARD_RATIO = 4.0


@dataclass(frozen=True)
class CandidateConfig:
    tier: str
    tp_prefill: int
    tp_decode: int


@dataclass
class TierDemand:
    rps: float
    prompt_len: int
    output_len: int


@dataclass
class PlannerInputs:
    demands: Dict[str, TierDemand]  # tier name -> observed arrival stats
    total_chips: int


@dataclass
class StageAlloc:
    tp: int
    chips: float  # fractional during planning; discretized at the end

    @property
    def groups(self) -> float:
        return self.chips / self.tp


@dataclass
class TierPlan:
    prefill: StageAlloc
    decode: StageAlloc
    served_rps: float = 0.0
    mixed: Optional[StageAlloc] = None  # colocated prefill+decode groups


@dataclass
class Plan:
    tiers: Dict[str, TierPlan] = field(default_factory=dict)
    planning_ms: float = 0.0
    leftover_chips: int = 0

    def chips_used(self) -> float:
        return sum(t.prefill.chips + t.decode.chips for t in self.tiers.values())


class Planner:
    def __init__(
        self,
        perf: PerfModel,
        tiers: Sequence[SLOTier],
        candidate_tps: Sequence[int] = (1, 2, 4, 8),
        chip_step: float = 1.0,
        mixed_discount: float = 0.8,  # prefill/decode interference penalty
        resilience_weight: float = 0.0,
        topology: Optional[Topology] = None,
    ):
        self.perf = perf
        self.tiers = {t.name: t for t in tiers}
        self.candidate_tps = tuple(candidate_tps)
        self.chip_step = chip_step
        self.mixed_discount = mixed_discount
        # fault-aware planning (docs/faults.md §Fault-aware planning):
        # weight > 0 discounts each candidate's goodput efficiency by its
        # expected recovery cost, trading steady-state goodput for blast
        # radius — the goodput-vs-resilience frontier's knob. 0 = pure
        # goodput (the recorded goldens).
        self.resilience_weight = resilience_weight
        self.topology = topology or Topology()
        # candidate selection is independent of the demand *rate* (only its
        # length statistics), so memoize the chosen (tp_p, tp_d, thp, thd,
        # kind) per (tier, quantized lengths, pool size) — the per-window
        # itertools.product sweep then only runs when demand shape moves
        self._cand_cache: Dict[tuple, Optional[tuple]] = {}

    # ---- goodput-efficiency estimation --------------------------------
    def stage_throughputs(
        self, tier: SLOTier, demand: TierDemand, tp_p: int, tp_d: int
    ) -> Tuple[float, float]:
        """(THP, THD): SLO-compliant req/s per prefill / decode *group*.

        The decode rate is designed at the demand's mid-decode context
        with the TPOT slack margin — the exact operating point the
        simulator's runtime caps (Policy.decode_cap) are derived at, so
        the plan's group sizing and the groups' realized batch sizes
        agree. Designing at the bare prompt length overstated decode
        capacity on long-output regimes and understated it on long-prompt
        ones."""
        thp = self.perf.max_prefill_rps(demand.prompt_len, tp_p, tier.ttft_ms)
        thd = self.perf.max_decode_rps(
            mid_decode_ctx(demand.prompt_len, demand.output_len),
            demand.output_len, tp_d, tier.tpot_ms * TPOT_DESIGN_MARGIN,
        )
        return thp, thd

    def goodput_efficiency(
        self, tier: SLOTier, demand: TierDemand, tp_p: int, tp_d: int,
        rps: Optional[float] = None,
    ) -> Tuple[float, float, float]:
        """Returns (GE, thp, thd) for one balanced prefill+decode unit.

        A unit is P prefill groups and D decode groups with P·THP = D·THD
        (fluid); GE is SLO-compliant req/s per chip — paper Eq. (1).
        """
        thp, thd = self.stage_throughputs(tier, demand, tp_p, tp_d)
        if thp <= 0.0 or thd <= 0.0:
            return 0.0, thp, thd
        # fluid balance: x prefill groups, y decode groups, x·thp = y·thd,
        # normalize to 1 chip total: x·tp_p + y·tp_d = 1
        y = 1.0 / (tp_d + tp_p * thd / thp)
        x = y * thd / thp
        unit_rps = x * thp  # == y*thd
        rate = unit_rps  # per chip
        if rps is not None:
            rate = min(rate, rps)
        return rate, thp, thd

    def clear_caches(self) -> None:
        """Drop the per-instance candidate memo (cold-start benchmarking)."""
        self._cand_cache.clear()

    # ---- expected recovery cost (docs/faults.md §Fault-aware planning) --
    def chip_exposure(self, tp: int) -> float:
        """Correlated-excess hazard of a TP-``tp`` group, in arbitrary
        units: the extra chips a single failure-domain loss strands
        BEYOND the domain itself. A host-contained group scores zero —
        a host loss takes its chips but strands nothing outside the
        blast, and its uncorrelated per-chip hazard is already priced by
        realized goodput (every restart is a served-request loss the
        estimator sees). A host-spanning group is the genuinely worse
        shape: any one of its hosts dying stalls the WHOLE group, so
        each spanned host beyond the first exposes all ``tp`` chips to a
        correlated kill, weighted by the host event rate
        (HOST_HAZARD_RATIO). Pricing raw ``tp`` here instead was
        measured to distort steady-state layout choice among
        host-contained candidates with zero resilience payoff
        (docs/faults.md §Fault-aware planning)."""
        return (
            HOST_HAZARD_RATIO
            * tp
            * (self.topology.hosts_spanned(tp) - 1)
        )

    def _resilience_adjust(
        self, ge: float, tp_p: int, tp_d: int, thp: float, thd: float,
        kind: str,
    ) -> float:
        """Discount a candidate's goodput efficiency by its expected
        recovery cost: GE / (1 + w · x̄), with x̄ the chip-weighted mean
        exposure over the balanced unit's prefill and decode chips."""
        w = self.resilience_weight
        if not w or ge <= 0:
            return ge
        if kind == "mixed" or tp_p == tp_d:
            xbar = self.chip_exposure(tp_p)
        else:
            y = 1.0 / (tp_d + tp_p * thd / thp)
            x = y * thd / thp
            cp, cd = x * tp_p, y * tp_d
            xbar = (
                cp * self.chip_exposure(tp_p) + cd * self.chip_exposure(tp_d)
            ) / (cp + cd)
        return ge / (1.0 + w * xbar)

    def _choose_candidate(
        self, name: str, tier: SLOTier, d: TierDemand, total_chips: int
    ) -> Optional[tuple]:
        """Pick the tier's (tp_p, tp_d, thp, thd, kind) unit: near-best
        goodput efficiency, smallest footprint as tiebreak (memoized on the
        demand's quantized length statistics)."""
        from repro_torch.profiles.perf_model import quantize_len

        ck = (
            name, quantize_len(d.prompt_len), quantize_len(d.output_len),
            total_chips,
        )
        if ck in self._cand_cache:
            return self._cand_cache[ck]
        # KV feasibility: a candidate's decode stage must hold at least one
        # sequence at the demand's END-of-decode context (prompt + output) —
        # max_decode_rps only checks memory at the prompt length, which
        # overstates capacity exactly in the long-context regime where KV
        # backpressure matters.
        end_ctx = d.prompt_len + d.output_len

        def _kv_feasible(tp_d: int) -> bool:
            return self.perf.max_decode_batch(end_ctx, tp_d, 1e9) >= 1

        entries = []
        for tp_p, tp_d in itertools.product(self.candidate_tps, repeat=2):
            if tp_p + tp_d > total_chips:
                continue
            if not _kv_feasible(tp_d):
                continue
            ge, thp, thd = self.goodput_efficiency(tier, d, tp_p, tp_d)
            ge = self._resilience_adjust(ge, tp_p, tp_d, thp, thd, "disagg")
            if ge > 0:
                entries.append((ge, tp_p, tp_d, thp, thd, "disagg"))
        for tp in self.candidate_tps:
            if tp > total_chips:
                continue
            if not _kv_feasible(tp):
                continue
            thp, thd = self.stage_throughputs(tier, d, tp, tp)
            if thp <= 0 or thd <= 0:
                continue
            unit = self.mixed_discount * min(thp, thd)
            ge = self._resilience_adjust(unit / tp, tp, tp, unit, unit, "mixed")
            entries.append((ge, tp, tp, unit, unit, "mixed"))
        if not entries:
            chosen = None
        else:
            ge_max = max(e[0] for e in entries)
            near = [e for e in entries if e[0] >= 0.85 * ge_max]
            _, tp_p, tp_d, thp, thd, kind = min(
                near, key=lambda e: (e[1] + e[2] if e[5] == "disagg" else e[1], -e[0])
            )
            chosen = (tp_p, tp_d, thp, thd, kind)
        self._cand_cache[ck] = chosen
        return chosen

    # ---- weighted greedy assignment (discrete whole groups) -------------
    def plan(self, inputs: PlannerInputs) -> Plan:
        """Greedy over whole TP groups. Each step adds the whole group with
        the highest weighted marginal goodput gain per chip,
        WGE = (Δserved/chips) · rps/served — the paper's unmet-demand
        weighting — until the pool or the demand is exhausted."""
        t0 = time.perf_counter()
        plan = Plan()
        slo_tiers = {
            n: t for n, t in self.tiers.items()
            if not t.background and n in inputs.demands
        }

        # Candidate space per tier: disaggregated (tp_p, tp_d) pairs AND
        # colocated ("mixed") single-tp groups. Colocation pays an
        # interference discount (prefill preempts decode) but halves the
        # bootstrap footprint and shares capacity between stages — on small
        # pools it often dominates, and including it makes the planner's
        # config space a superset of the Split baseline's.
        state: Dict[str, dict] = {}
        for name, tier in slo_tiers.items():
            d = inputs.demands[name]
            chosen = self._choose_candidate(name, tier, d, inputs.total_chips)
            if chosen is None:
                continue
            tp_p, tp_d, thp, thd, kind = chosen
            state[name] = dict(
                tp_p=tp_p, tp_d=tp_d, thp=thp, thd=thd, P=0, D=0, kind=kind
            )

        remaining = int(inputs.total_chips)
        while remaining > 0 and state:
            choice = None  # (wge, name, stage, cost, new_served)
            for name, st in state.items():
                d = inputs.demands[name]
                if st["kind"] == "mixed":
                    cap = st["P"] * st["thp"]
                    served = min(cap, d.rps)
                    if served >= d.rps - 1e-9:
                        continue
                    cost = st["tp_p"]
                    if cost > remaining:
                        continue
                    new_served = min(cap + st["thp"], d.rps)
                    stage = "M"
                else:
                    cap_p = st["P"] * st["thp"]
                    cap_d = st["D"] * st["thd"]
                    served = min(cap_p, cap_d, d.rps)
                    if served >= d.rps - 1e-9:
                        continue
                    if st["P"] == 0:  # bootstrap: one group of each stage
                        cost = st["tp_p"] + st["tp_d"]
                        if cost > remaining:
                            continue
                        new_served = min(st["thp"], st["thd"], d.rps)
                        stage = "both"
                    elif cap_p <= cap_d:
                        cost = st["tp_p"]
                        if cost > remaining:
                            continue
                        new_served = min(cap_p + st["thp"], cap_d, d.rps)
                        stage = "P"
                    else:
                        cost = st["tp_d"]
                        if cost > remaining:
                            continue
                        new_served = min(cap_p, cap_d + st["thd"], d.rps)
                        stage = "D"
                gain = new_served - served
                if gain <= 1e-9:
                    continue
                wge = (gain / cost) * (d.rps / max(served, 1e-6))
                if choice is None or wge > choice[0]:
                    choice = (wge, name, stage, cost, new_served)
            if choice is None:
                break
            _, name, stage, cost, new_served = choice
            st = state[name]
            if stage in ("both", "P", "M"):
                st["P"] += 1
            if stage in ("both", "D"):
                st["D"] += 1
            remaining -= cost

        for name, st in state.items():
            if st["P"] == 0:
                continue
            d = inputs.demands[name]
            if st["kind"] == "mixed":
                served = min(st["P"] * st["thp"], d.rps)
                plan.tiers[name] = TierPlan(
                    StageAlloc(st["tp_p"], 0),
                    StageAlloc(st["tp_d"], 0),
                    served_rps=served,
                    mixed=StageAlloc(st["tp_p"], st["P"] * st["tp_p"]),
                )
            else:
                served = min(st["P"] * st["thp"], st["D"] * st["thd"], d.rps)
                plan.tiers[name] = TierPlan(
                    StageAlloc(st["tp_p"], st["P"] * st["tp_p"]),
                    StageAlloc(st["tp_d"], st["D"] * st["tp_d"]),
                    served_rps=served,
                )
        plan.leftover_chips = remaining
        plan.planning_ms = (time.perf_counter() - t0) * 1e3
        return plan


def enumerate_configs(tiers, candidate_tps) -> List[CandidateConfig]:
    return [
        CandidateConfig(t, p, d)
        for t in tiers
        for p, d in itertools.product(candidate_tps, repeat=2)
    ]
