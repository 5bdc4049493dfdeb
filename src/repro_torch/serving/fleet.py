"""Fleet-of-cells layer (docs/control_plane.md; mirrors repro/serving/fleet.py):
several independent serving cells behind one admission tier, advancing
under one fleet clock.

A *cell* is a full :class:`~repro_torch.serving.simulator.Simulator` — its own
policy, planner, groups, and KV accounting over a 16–512-chip pool (the
dry-run cell builders in ``launch/cells.py`` model the same unit at the
array level). The fleet:

* owns the merged arrival stream and assigns each arrival to a cell at
  admission (seeded, deterministic, least-admitted-share first);
* advances every cell under one clock: each engine exposes
  ``_next_time()`` / ``_process(t)`` and the fleet always steps the
  globally-earliest event, so cells interleave exactly as one merged
  event loop would schedule them;
* makes **cross-cell spill** the first-choice overflow path: when a
  cell is at its KV watermark and no group inside it has headroom, the
  request is handed to the sibling cell with the most projected KV
  headroom (the dispatch commitment moves with it) *before* the old
  intra-cell demotion to best-effort. A single-cell fleet therefore
  degrades to exactly the single-simulator re-route/demote behavior.

:class:`FleetScheduler` is the handle-level front door for control-plane
throughput work: a seeded stateless hash fans arrival batches out to
per-cell (optionally sharded) schedulers — ``benchmarks/fleet_throughput``
drives it at >=100k req/s on the million-user diurnal trace.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.goodput import GoodputMeter, SLOTier
from repro_torch.profiles.perf_model import PerfModel
from repro_torch.serving.global_scheduler import (
    GlobalScheduler,
    GroupHandle,
    tenant_key,
)
from repro_torch.serving.simulator import (
    Simulator,
    SimReq,
    SimResult,
    TraceRequest,
    Workload,
    make_policy,
)

_KNUTH = 2654435761


@dataclass
class FleetResult:
    """Fleet-level rollup of the per-cell :class:`SimResult` s."""

    policy: str
    n_cells: int
    goodput: float
    per_tier_goodput: Dict[str, float]
    spills: Dict[str, int]  # per-tier intra-cell spill counts, fleet-wide
    # per-tier count of spills resolved by handing the request to another
    # cell (the `cross_cell` bucket the intra-cell counters don't see)
    cross_cell_spills: Dict[str, int] = field(default_factory=dict)
    # per-tier count of *bandwidth*-infeasible dispatches rescued by a
    # sibling cell with SLO headroom (KV pressure is counted above)
    cross_cell_bw_spills: Dict[str, int] = field(default_factory=dict)
    # fleet-wide per-tenant rollups (docs/tenancy.md)
    tenant_goodput: Dict[str, float] = field(default_factory=dict)
    tenant_throttled: Dict[str, int] = field(default_factory=dict)
    tenant_retries: Dict[str, int] = field(default_factory=dict)
    tenant_demoted: Dict[str, int] = field(default_factory=dict)
    finished: int = 0
    reconfig_count: int = 0
    switch_considered: int = 0
    timeline: List[Tuple[float, float]] = field(default_factory=list)
    cells: List[SimResult] = field(default_factory=list)

    @property
    def spill_total(self) -> int:
        return sum(self.spills.values())

    @property
    def cross_cell_total(self) -> int:
        return sum(self.cross_cell_spills.values())

    @property
    def ckpt_restores(self) -> int:
        """Fleet-wide checkpointed-KV partial restarts (docs/faults.md
        §Checkpointed restart)."""
        return sum(r.ckpt_restores for r in self.cells)

    @property
    def fault_restart_total(self) -> int:
        return sum(r.fault_restart_total for r in self.cells)


class FleetSimulator:
    """Compose cells under one admission tier and one clock."""

    def __init__(self, cells: Sequence[Simulator], seed: int = 0):
        if not cells:
            raise ValueError("a fleet needs at least one cell")
        dts = {(c.dt, c.grid_parity) for c in cells}
        if len(dts) > 1:
            raise ValueError(
                f"cells disagree on the clock grid ({sorted(dts)}); the "
                "fleet clock admits arrivals on one shared dt grid"
            )
        self.cells = list(cells)
        self.seed = seed
        self.now = 0.0
        self.cross_cell_spills: Dict[str, int] = {}
        self.cross_cell_bw_spills: Dict[str, int] = {}
        self._spilling = False  # re-entrancy guard for cross-cell spills
        # admitted-share balancing state (see _pick_cell)
        self._load = [0.0] * len(self.cells)
        self._rot = int(np.random.RandomState(seed).randint(len(self.cells)))
        for c in self.cells:
            c._fleet = self

    # ---- admission tier --------------------------------------------------
    def _pick_cell(self, tr: TraceRequest) -> int:
        """Deterministic least-admitted-share assignment: each arrival goes
        to the cell with the lowest admitted-count-per-chip, scanning from
        a seeded rotating offset so exact ties spread instead of piling on
        cell 0. Cells are homogeneous in capability; heavy-request skew is
        corrected downstream by cross-cell spill."""
        cells, load = self.cells, self._load
        n = len(cells)
        best_k, best_s = 0, math.inf
        for off in range(n):
            k = (off + self._rot) % n
            s = load[k] / max(cells[k].n_chips, 1)
            if s < best_s - 1e-12:
                best_k, best_s = k, s
        load[best_k] += 1.0
        self._rot = (self._rot + 1) % n
        return best_k

    def _admit_fleet(self, batch: Sequence[TraceRequest], t: float) -> None:
        cells = self.cells
        if len(cells) == 1:
            cells[0].now = t
            cells[0]._admit_batch(batch)
            return
        per_cell: List[List[TraceRequest]] = [[] for _ in cells]
        for tr in batch:
            per_cell[self._pick_cell(tr)].append(tr)
        for c, sub in zip(cells, per_cell):
            if sub:
                c.now = t
                c._admit_batch(sub)

    # ---- cross-cell spill ------------------------------------------------
    def _cell_headroom(self, cell: Simulator, req: SimReq) -> float:
        """Most projected KV headroom (bytes, below the watermark) on any
        compatible prefill-capable group in ``cell``."""
        tier = req.tr.tier
        cell.now = self.now
        best = 0.0
        for g in cell.groups:
            if g.spec.stage not in ("prefill", "mixed"):
                continue
            if g.spec.tier not in (None, tier):
                continue
            g.advance_to(cell.now)
            free = (
                cell.kv_watermark * g.kv_capacity_bytes - g.kv_projected_bytes()
            )
            if free > best:
                best = free
        return best

    def _take_spill(self, victim: Simulator, req: SimReq) -> bool:
        """Called by a cell whose every group is at the KV watermark:
        move the request to the sibling cell with the most projected
        headroom (commitment transferred), or refuse (False) and let the
        victim demote it. Guarded against recursion — a transferred
        request never bounces to a third cell in the same admission."""
        if self._spilling or len(self.cells) == 1:
            return False
        need = victim.perf.seq_kv_bytes(req.tr.prompt_len)
        best, best_free = None, 0.0
        for cell in self.cells:
            if cell is victim:
                continue
            free = self._cell_headroom(cell, req)
            if free >= need and free > best_free:
                best, best_free = cell, free
        if best is None:
            return False
        # transfer the dispatch commitment out of the victim's scheduler;
        # the target cell's own route() takes a fresh commitment there
        gs = getattr(victim.policy, "gs", None)
        if gs is not None and req.dispatch_gid is not None:
            gs.complete(req.dispatch_gid, req.rate_cost)
        req.dispatch_gid = None
        req.rate_cost = 0.0
        tier = req.tr.tier
        self.cross_cell_spills[tier] = self.cross_cell_spills.get(tier, 0) + 1
        self._spilling = True
        try:
            best.now = self.now
            best._admit_transfer(req)
        finally:
            self._spilling = False
        return True

    def _take_bw_spill(self, victim: Simulator, req: SimReq) -> bool:
        """Bandwidth analogue of :meth:`_take_spill` (ROADMAP item 2's
        follow-on): a cell whose dispatch came back SLO-infeasible offers
        the request to the sibling cell with the most spare SLO-compliant
        bandwidth on a compatible prefill group, *before* serving it as
        best-effort. The victim's infeasible dispatch committed no
        bandwidth, so nothing transfers — the target cell's own route()
        takes a fresh commitment."""
        if self._spilling or len(self.cells) == 1:
            return False
        rate_cost = 1.0  # matches the policies' uniform dispatch cost
        tier = req.tr.tier
        best, best_avail = None, 0.0
        for cell in self.cells:
            if cell is victim:
                continue
            pol = cell.policy
            cell.now = self.now
            sync = getattr(pol, "_sync_scheduler", None)
            if sync is not None:
                sync(cell)  # headroom read from a fresh handle snapshot
            # gs only exists after the first sync — read it *after*, so a
            # sibling that has not dispatched anything yet still counts
            gs = getattr(pol, "gs", None)
            if gs is None:
                continue
            avail = 0.0
            for h in gs.groups.values():
                if not h.alive or h.stage not in ("prefill", "mixed"):
                    continue
                if h.tier not in (None, tier):
                    continue
                if h.available_rps > avail:
                    avail = h.available_rps
            if avail >= rate_cost and avail > best_avail:
                best, best_avail = cell, avail
        if best is None:
            return False
        # drop the victim's stale pick (its gid is meaningless in the
        # target cell's scheduler); route() there re-labels feasibility
        req.dispatch_gid = None
        req.rate_cost = 0.0
        req.feasible = True
        self.cross_cell_bw_spills[tier] = (
            self.cross_cell_bw_spills.get(tier, 0) + 1
        )
        self._spilling = True
        try:
            best.now = self.now
            best._admit_transfer(req)
        finally:
            self._spilling = False
        return True

    # ---- fleet clock -----------------------------------------------------
    def run(self, workload: Workload, drain_s: float = 60.0) -> GoodputMeter:
        cells = self.cells
        n = len(cells)
        horizon = workload.horizon_s + drain_s
        # faults land on cells round-robin by event index: deterministic,
        # and a fleet-wide incident schedule degrades each cell in turn
        for ci, cell in enumerate(cells):
            wl_cell = Workload(
                f"{workload.name}/cell{ci}",
                workload.requests,
                workload.horizon_s,
                tuple(f for j, f in enumerate(workload.faults) if j % n == ci),
            )
            cell._begin(
                wl_cell, drain_s, external_arrivals=True, demand_scale=1.0 / n
            )
        arr = sorted(workload.requests, key=lambda r: r.arrival_s)
        ref = cells[0]
        if ref.grid_parity:
            dt = ref.dt
            adm = [math.ceil(r.arrival_s / dt - 1e-9) * dt for r in arr]
        else:
            adm = [r.arrival_s for r in arr]
        i, N = 0, len(arr)
        while True:
            t = min(c._next_time() for c in cells)
            t_arr = adm[i] if i < N else math.inf
            t = min(t, t_arr)
            if t >= horizon:
                break
            self.now = t
            if t_arr <= t:
                j = i
                while j < N and adm[j] <= t:
                    j += 1
                self._admit_fleet(arr[i:j], t)
                i = j
            for c in cells:
                while c._next_time() <= t:
                    c._process(t)
        self.now = horizon
        for c in cells:
            c.now = horizon
        return self.meter

    @property
    def meter(self) -> GoodputMeter:
        return GoodputMeter.merged([c.meter for c in self.cells])

    def result(self, horizon_s: float) -> FleetResult:
        cr = [c.result(horizon_s) for c in self.cells]
        per_tier: Dict[str, float] = {}
        spills: Dict[str, int] = {}
        merged: Dict[float, float] = {}
        tenant_goodput: Dict[str, float] = {}
        tenant_throttled: Dict[str, int] = {}
        tenant_retries: Dict[str, int] = {}
        tenant_demoted: Dict[str, int] = {}
        for r in cr:
            for tier, v in r.per_tier_goodput.items():
                per_tier[tier] = per_tier.get(tier, 0.0) + v
            for tier, v in r.spills.items():
                spills[tier] = spills.get(tier, 0) + v
            for t, v in r.timeline:
                merged[t] = merged.get(t, 0.0) + v
            for ten, v in r.tenant_goodput.items():
                tenant_goodput[ten] = tenant_goodput.get(ten, 0.0) + v
            for acc, src in (
                (tenant_throttled, r.tenant_throttled),
                (tenant_retries, r.tenant_retries),
                (tenant_demoted, r.tenant_demoted),
            ):
                for ten, v in src.items():
                    acc[ten] = acc.get(ten, 0) + v
        return FleetResult(
            policy=cr[0].policy,
            n_cells=len(cr),
            goodput=sum(r.goodput for r in cr),
            per_tier_goodput=per_tier,
            spills=spills,
            cross_cell_spills=dict(self.cross_cell_spills),
            cross_cell_bw_spills=dict(self.cross_cell_bw_spills),
            tenant_goodput=tenant_goodput,
            tenant_throttled=tenant_throttled,
            tenant_retries=tenant_retries,
            tenant_demoted=tenant_demoted,
            finished=sum(r.finished for r in cr),
            reconfig_count=sum(r.reconfig_count for r in cr),
            switch_considered=sum(r.switch_considered for r in cr),
            timeline=sorted(merged.items()),
            cells=cr,
        )


def run_fleet(
    system: str,
    perf: PerfModel,
    tiers: Sequence[SLOTier],
    n_cells: int,
    chips_per_cell: int,
    workload: Workload,
    candidate_tps=(1, 2, 4, 8),
    seed: int = 0,
    drain_s: float = 60.0,
    kv_watermark: float = 0.9,
    kv_audit: bool = False,
    admission=None,
    kv_checkpoint: bool = False,
    **policy_kw,
) -> Tuple[FleetSimulator, GoodputMeter]:
    """Build an ``n_cells`` x ``chips_per_cell`` fleet (fresh policy per
    cell) and replay ``workload`` through it. Mirrors ``run_system``.
    ``admission`` is ONE shared controller across every cell: token
    budgets are fleet-global, so a tenant cannot dodge its quota by
    landing on a different cell."""
    cells = [
        Simulator(
            perf, tiers, chips_per_cell,
            make_policy(
                system, perf, tiers, chips_per_cell,
                candidate_tps=candidate_tps, **policy_kw,
            ),
            kv_watermark=kv_watermark, kv_audit=kv_audit,
            admission=admission, kv_checkpoint=kv_checkpoint,
        )
        for _ in range(n_cells)
    ]
    fleet = FleetSimulator(cells, seed=seed)
    meter = fleet.run(workload, drain_s=drain_s)
    return fleet, meter


class FleetScheduler:
    """Handle-level admission tier over per-cell schedulers — the
    control-plane fast path, with no simulator behind it.

    Assignment is a seeded multiplicative hash of the request's
    tenant key (``tenant_key``: the real tenant id for named tenants —
    sticky, so one tenant's flood stays one cell's problem — and the
    request id for the default tenant, preserving per-request spread):
    stateless, deterministic, and O(1) per request regardless of fleet
    size. Each cell's scheduler (plain or sharded) then batch-dispatches
    its slice with KV-aware, tier-aware scoring. When a cell's pick comes
    back infeasible the request is retried once on the hash-neighbor
    cell — the batch analogue of cross-cell spill — before being
    accepted as best-effort.
    """

    def __init__(
        self, cell_schedulers: Sequence[GlobalScheduler], seed: int = 0
    ):
        if not cell_schedulers:
            raise ValueError("FleetScheduler needs at least one cell")
        self.cells = list(cell_schedulers)
        self.seed = seed
        self.cross_cell = 0  # infeasible picks retried on a sibling cell

    def cell_of(
        self, req_ids: np.ndarray, tenants: Optional[Sequence[str]] = None
    ) -> np.ndarray:
        keys = req_ids.astype(np.int64)
        if tenants is not None:
            keys = np.asarray(
                [tenant_key(t, int(r)) for t, r in zip(tenants, req_ids)],
                dtype=np.int64,
            )
        h = (keys + self.seed) * _KNUTH
        return (h & 0xFFFFFFFF) % len(self.cells)

    def dispatch_batch(
        self,
        tiers: Sequence[str],
        rate_costs: Sequence[float],
        backgrounds: Sequence[bool],
        req_ids: np.ndarray,
        now: Optional[float] = None,
        tenants: Optional[Sequence[str]] = None,
    ) -> List[Tuple[GroupHandle, bool]]:
        n_cells = len(self.cells)
        req_ids = np.asarray(req_ids)
        cell_idx = self.cell_of(req_ids, tenants)
        if tenants is not None:
            keys = [tenant_key(t, int(r)) for t, r in zip(tenants, req_ids)]
        else:
            keys = [int(r) for r in req_ids]
        out: List[Optional[Tuple[GroupHandle, bool]]] = [None] * len(tiers)
        retry: List[Tuple[int, int]] = []  # (item index, next cell)
        for ci in range(n_cells):
            sub = np.nonzero(cell_idx == ci)[0]
            if not len(sub):
                continue
            items = [(tiers[i], rate_costs[i], backgrounds[i]) for i in sub]
            picks = self.cells[ci].dispatch_batch(
                items, now=now, keys=[keys[i] for i in sub]
            )
            for i, pick in zip(sub, picks):
                if not pick[1] and n_cells > 1 and not backgrounds[i]:
                    retry.append((int(i), (ci + 1) % n_cells))
                else:
                    out[int(i)] = pick
        # cross-cell retry for infeasible picks: one hop to the neighbor
        for i, ci in retry:
            self.cross_cell += 1
            pick = self.cells[ci].dispatch(
                tiers[i], rate_costs[i], backgrounds[i],
                now=now, key=keys[i],
            )
            out[i] = pick
        return out  # type: ignore[return-value]
