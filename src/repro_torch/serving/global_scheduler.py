"""Global scheduler (paper §3.3.2; mirrors repro/serving/global_scheduler.py,
tie-breaks and heap keys included): FCFS dispatch with SLO feasibility
accounting, least-loaded placement, round-robin spill, background routing.

The scheduler maintains a per-group *SLO-compliant available serving
bandwidth*: the group's profiled max throughput (THP for prefill groups)
minus the rate already committed to assigned-but-unfinished requests. A
request is *feasible* if its tier has a group with spare bandwidth;
infeasible requests are spilled round-robin across all prefill groups as
best-effort work.

Control-plane scale (docs/control_plane.md): ``dispatch`` is the scalar
reference path; ``dispatch_batch`` scores a whole arrival batch with
array ops over a snapshot of the handle table and reproduces the scalar
decision sequence exactly (same lexicographic tie-breaks, same RR
counters). ``ShardedScheduler`` splits the handle table into independent
shards (by tier or tenant-hash) that commit locally and reconcile against
the authoritative table on a fixed interval — staleness of any shard's
view is bounded by one reconciliation interval, and KV snapshots older
than ``kv_stale_s`` are treated as *full* so stale headroom is never
trusted.
"""
from __future__ import annotations

import heapq
import itertools
import math
import zlib
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..traces.workload import DEFAULT_TENANT


def tenant_key(tenant_id: str, req_id: int) -> int:
    """Shard/fan-out key for a request (docs/tenancy.md).

    Non-default tenants hash by identity, so one tenant's requests land
    on one shard (stickiness makes a flood a local problem and keeps the
    shard's committed-bandwidth view of that tenant exact). The default
    tenant keys by ``req_id`` — tenant-free workloads keep today's
    per-request spreading and their recorded goldens byte-identical.
    """
    if tenant_id == DEFAULT_TENANT:
        return int(req_id)
    return zlib.crc32(tenant_id.encode())


@dataclass
class GroupHandle:
    """Scheduler-visible view of one TP group."""

    gid: int
    tier: Optional[str]  # None = shared / any
    stage: str  # prefill | decode | mixed
    tp: int
    max_rps: float  # profiled THP/THD for the group's tier & tp
    committed_rps: float = 0.0
    accepts_background: bool = True
    queue_len: int = 0
    # fraction of the group's KV budget (HBM after weights, below the
    # simulator's occupancy watermark) still free; 0 = under KV pressure
    kv_free_frac: float = 1.0
    # staleness stamp for kv_free_frac: publish time and the publishing
    # _groups_ver. dispatch() treats snapshots older than the scheduler's
    # kv_stale_s as full (routes conservatively) instead of trusting
    # stale headroom — a group can fill completely between two syncs.
    kv_stamp_s: float = 0.0
    kv_ver: int = 0
    # False once the group is torn down (fault, migration, reconfiguration):
    # the handle stays in the table so in-flight completions still resolve,
    # but dispatch never routes new work to it
    alive: bool = True

    @property
    def available_rps(self) -> float:
        return max(self.max_rps - self.committed_rps, 0.0)


class GlobalScheduler:
    def __init__(
        self, groups: Sequence[GroupHandle], kv_stale_s: float = math.inf
    ):
        self.groups = {g.gid: g for g in groups}
        # KV snapshots older than this are treated as full (see
        # GroupHandle.kv_stamp_s). inf = trust snapshots forever, which
        # is correct for the fully-synchronous per-arrival sync.
        self.kv_stale_s = kv_stale_s
        self._rr = itertools.count()
        self._rr_bg = itertools.count()

    def replace_groups(self, groups: Sequence[GroupHandle]) -> None:
        old = self.groups
        self.groups = {g.gid: g for g in groups}
        for gid, g in self.groups.items():
            if gid in old:
                g.committed_rps = old[gid].committed_rps

    def mark_dead(self, gid: int) -> None:
        """Flag a torn-down group so dispatch stops routing to its handle.
        The handle is kept (not popped): completions for requests that were
        dispatched before the teardown still release their bandwidth."""
        g = self.groups.get(gid)
        if g is not None:
            g.alive = False

    def _prefill_groups(self, tier: Optional[str] = None) -> List[GroupHandle]:
        out = [
            g for g in self.groups.values()
            if g.alive and g.stage in ("prefill", "mixed")
            and (tier is None or g.tier in (tier, None))
        ]
        return out

    def _kv_free(self, g: GroupHandle, now: Optional[float]) -> float:
        """kv_free_frac under the staleness bound: a snapshot older than
        kv_stale_s reads as full, so dispatch never routes into headroom
        that may have evaporated since the last sync."""
        if (
            now is not None
            and self.kv_stale_s != math.inf
            and now - g.kv_stamp_s > self.kv_stale_s
        ):
            return 0.0
        return g.kv_free_frac

    def dispatch(
        self,
        tier: str,
        rate_cost: float,
        background: bool = False,
        now: Optional[float] = None,
        key: int = 0,
    ) -> Tuple[GroupHandle, bool]:
        """Returns (group, feasible). rate_cost ~ 1/expected_service_rate —
        the request's contribution to committed bandwidth. ``now`` enables
        the KV-staleness bound; ``key`` is the shard key (unused here,
        accepted so callers can treat sharded/unsharded uniformly)."""
        if background:
            cands = [g for g in self._prefill_groups() if g.accepts_background]
            if not cands:
                cands = self._prefill_groups()
            g = cands[next(self._rr_bg) % len(cands)]
            return g, True

        tier_groups = self._prefill_groups(tier)
        feas = [g for g in tier_groups if g.available_rps >= rate_cost]
        # KV backpressure: among bandwidth-feasible groups, avoid those whose
        # projected KV occupancy is at the watermark (they would stall the
        # prefill's decode phase); fall back to all if every group is full
        kv_ok = [g for g in feas if self._kv_free(g, now) > 0.0]
        if kv_ok:
            feas = kv_ok
        if feas:
            g = min(feas, key=lambda g: (g.committed_rps / max(g.max_rps, 1e-9), g.queue_len))
            g.committed_rps += rate_cost
            return g, True
        # infeasible: spill round-robin over ALL prefill groups (§3.3.2)
        cands = self._prefill_groups()
        if not cands:
            cands = [g for g in self.groups.values() if g.alive]
        if not cands:
            cands = list(self.groups.values())
        g = cands[next(self._rr) % len(cands)]
        return g, False

    def dispatch_batch(
        self,
        items: Sequence[Tuple[str, float, bool]],
        now: Optional[float] = None,
        keys: Optional[Sequence[int]] = None,
    ) -> List[Tuple[GroupHandle, bool]]:
        """Batch-vectorized dispatch: one snapshot of the handle table,
        per-tier candidate heaps keyed ``(load, queue_len, position)``, and
        O(log G) per pick. Decisions are identical to calling ``dispatch``
        per item — the heap key reproduces the scalar path's lexicographic
        ``min`` with first-wins ties (position = handle-table order), the
        same RR counters drive spill order, and the KV-then-bandwidth
        fallback layering is preserved (heap A = KV-free candidates, heap
        B = KV-full; a bandwidth-infeasible pop is discarded, which is
        sound because committed bandwidth only grows within a batch).
        Committed bandwidth is written through to the handles per pick so
        intra-batch feasibility is exact; queue_len is read from the
        snapshot (the scalar path never mutates it either — only the
        policy's sync republishes queue depths)."""
        gl = list(self.groups.values())
        G = len(gl)
        if G == 0:
            raise RuntimeError("dispatch_batch with no groups")
        committed = [g.committed_rps for g in gl]
        max_rps = [g.max_rps for g in gl]
        denom = [max(m, 1e-9) for m in max_rps]
        queue = [float(g.queue_len) for g in gl]
        ver = [0] * G  # bumped per pick; stale heap entries refresh lazily
        check = now is not None and self.kv_stale_s != math.inf
        kv_ok = [
            (
                0.0 if check and now - g.kv_stamp_s > self.kv_stale_s
                else g.kv_free_frac
            ) > 0.0
            for g in gl
        ]
        pre = [
            j for j, g in enumerate(gl)
            if g.alive and g.stage in ("prefill", "mixed")
        ]
        spill_cands = (
            pre
            or [j for j, g in enumerate(gl) if g.alive]
            or list(range(G))
        )
        bg_cands = [j for j in pre if gl[j].accepts_background] or pre

        heaps: Dict[Tuple[Optional[str], float], tuple] = {}

        def tier_heaps(tier: str, rc: float) -> tuple:
            hs = heaps.get((tier, rc))
            if hs is None:
                tix = [j for j in pre if gl[j].tier in (tier, None)]
                # entries carry the ver they were keyed at (ver is never
                # compared: (load, queue, j) is unique by j)
                ha = [
                    (committed[j] / denom[j], queue[j], j, ver[j])
                    for j in tix if kv_ok[j]
                ]
                hb = [
                    (committed[j] / denom[j], queue[j], j, ver[j])
                    for j in tix if not kv_ok[j]
                ]
                heapq.heapify(ha)
                heapq.heapify(hb)
                hs = (ha, hb)
                heaps[(tier, rc)] = hs
            return hs

        def pop_pick(h: list, rc: float) -> Optional[int]:
            while h:
                _, _, j, v = h[0]
                if v != ver[j]:
                    heapq.heapreplace(
                        h, (committed[j] / denom[j], queue[j], j, ver[j])
                    )
                    continue
                if max(max_rps[j] - committed[j], 0.0) < rc:
                    # monotone within the batch: committed only grows, so
                    # this entry can never become feasible again at this rc
                    heapq.heappop(h)
                    continue
                committed[j] += rc
                ver[j] += 1
                heapq.heapreplace(
                    h, (committed[j] / denom[j], queue[j], j, ver[j])
                )
                gl[j].committed_rps = committed[j]
                return j
            return None

        out: List[Tuple[GroupHandle, bool]] = []
        for tier, rate_cost, background in items:
            if background:
                j = bg_cands[next(self._rr_bg) % len(bg_cands)]
                out.append((gl[j], True))
                continue
            ha, hb = tier_heaps(tier, rate_cost)
            j = pop_pick(ha, rate_cost)
            if j is None:
                j = pop_pick(hb, rate_cost)
            if j is not None:
                out.append((gl[j], True))
            else:
                j = spill_cands[next(self._rr) % len(spill_cands)]
                out.append((gl[j], False))
        return out

    def complete(self, gid: int, rate_cost: float) -> None:
        g = self.groups.get(gid)
        if g is not None:
            g.committed_rps = max(g.committed_rps - rate_cost, 0.0)

    def decode_target(self, tier: str) -> Optional[GroupHandle]:
        cands = [
            g for g in self.groups.values()
            if g.alive and g.stage == "decode" and g.tier in (tier, None)
        ]
        if not cands:
            cands = [
                g for g in self.groups.values()
                if g.alive and g.stage == "mixed"
            ]
        if not cands:
            return None
        return min(cands, key=lambda g: g.queue_len)


class ShardedScheduler(GlobalScheduler):
    """Global scheduler split into independent shards with periodic state
    reconciliation (docs/control_plane.md).

    The base-class handle table stays *authoritative*: commitments are
    written through to it on every dispatch and completions land on it
    directly. Each shard runs a private :class:`GlobalScheduler` over
    *copies* of the handles and makes routing decisions against that
    possibly-stale view; ``reconcile`` re-clones the authoritative state
    into every shard, so a shard's view is never staler than one
    reconciliation interval (plus the publisher's own cadence). Liveness
    is the exception — ``mark_dead`` propagates to all shards immediately,
    because routing to a dead group is a correctness bug while routing on
    slightly-stale load is only a quality loss.

    Determinism: shard assignment is a seeded multiplicative hash of the
    request key (or a stable tier hash), and each shard's RR spill
    counters start at a seeded offset — two runs with the same seed make
    identical decisions, and ``n_shards=1`` with ``reconcile_interval_s=0``
    degrades to exactly the unsharded scheduler.
    """

    def __init__(
        self,
        groups: Sequence[GroupHandle],
        n_shards: int = 1,
        shard_by: str = "hash",
        reconcile_interval_s: float = 0.0,
        kv_stale_s: float = math.inf,
        seed: int = 0,
    ):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if shard_by not in ("hash", "tier"):
            raise ValueError(f"shard_by must be 'hash' or 'tier', got {shard_by!r}")
        super().__init__(groups, kv_stale_s=kv_stale_s)
        self.n_shards = n_shards
        self.shard_by = shard_by
        self.reconcile_interval_s = reconcile_interval_s
        self.seed = seed
        rng = np.random.RandomState(seed)
        self._shards: List[GlobalScheduler] = []
        for _ in range(n_shards):
            s = GlobalScheduler([], kv_stale_s=kv_stale_s)
            if n_shards > 1:
                # seeded RR offsets: sharded and unsharded runs stay
                # individually deterministic and comparable across seeds
                s._rr = itertools.count(int(rng.randint(0, 997)))
                s._rr_bg = itertools.count(int(rng.randint(0, 997)))
            self._shards.append(s)
        self._last_reconcile = -math.inf
        self.reconcile(now=0.0)

    # -- shard bookkeeping ------------------------------------------------
    def shard_of(self, tier: Optional[str], key: int) -> int:
        if self.n_shards == 1:
            return 0
        if self.shard_by == "tier":
            h = zlib.crc32((tier or "").encode()) ^ (self.seed & 0xFFFFFFFF)
            return h % self.n_shards
        # Knuth multiplicative hash over the request/tenant key
        h = ((int(key) + self.seed) * 2654435761) & 0xFFFFFFFF
        return h % self.n_shards

    def reconcile(self, now: float = 0.0) -> None:
        """Re-clone the authoritative handle table into every shard; after
        this every shard's load/KV view is exact as of ``now``."""
        for s in self._shards:
            s.groups = {gid: replace(h) for gid, h in self.groups.items()}
            s.kv_stale_s = self.kv_stale_s
        self._last_reconcile = now

    def _maybe_reconcile(self, now: Optional[float]) -> None:
        if now is None:
            return
        if now - self._last_reconcile >= self.reconcile_interval_s:
            self.reconcile(now)

    # -- overridden verbs --------------------------------------------------
    def replace_groups(self, groups: Sequence[GroupHandle]) -> None:
        super().replace_groups(groups)
        # a new group set invalidates every shard view immediately
        self.reconcile(self._last_reconcile)

    def mark_dead(self, gid: int) -> None:
        super().mark_dead(gid)
        for s in self._shards:
            s.mark_dead(gid)

    def _authoritative(
        self, pick: Tuple[GroupHandle, bool], rate_cost: float, background: bool
    ) -> Tuple[GroupHandle, bool]:
        """Map a shard-local pick back to the authoritative handle and
        write the commitment through (the shard copy committed locally)."""
        h, feasible = pick
        ah = self.groups.get(h.gid)
        if ah is None:
            return h, feasible  # stale shard handle: caller re-validates
        if feasible and not background:
            ah.committed_rps += rate_cost
        return ah, feasible

    def dispatch(
        self,
        tier: str,
        rate_cost: float,
        background: bool = False,
        now: Optional[float] = None,
        key: int = 0,
    ) -> Tuple[GroupHandle, bool]:
        self._maybe_reconcile(now)
        shard = self._shards[self.shard_of(tier, key)]
        pick = shard.dispatch(tier, rate_cost, background, now=now)
        return self._authoritative(pick, rate_cost, background)

    def dispatch_batch(
        self,
        items: Sequence[Tuple[str, float, bool]],
        now: Optional[float] = None,
        keys: Optional[Sequence[int]] = None,
    ) -> List[Tuple[GroupHandle, bool]]:
        self._maybe_reconcile(now)
        if keys is None:
            keys = range(len(items))
        assign = [self.shard_of(it[0], k) for it, k in zip(items, keys)]
        out: List[Optional[Tuple[GroupHandle, bool]]] = [None] * len(items)
        for si, shard in enumerate(self._shards):
            sub = [i for i, a in enumerate(assign) if a == si]
            if not sub:
                continue
            picks = shard.dispatch_batch([items[i] for i in sub], now=now)
            for i, pick in zip(sub, picks):
                _, rate_cost, background = items[i]
                out[i] = self._authoritative(pick, rate_cost, background)
        return out  # type: ignore[return-value]
