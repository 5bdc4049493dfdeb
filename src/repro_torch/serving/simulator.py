"""Calibrated event-driven serving simulator (mirrors
repro/serving/simulator.py: every seeded draw, iteration order, tie-break
and heap key is the reference's, so both packages replay a trace alike).

Replays 10-minute traces at full cluster scale against a profile model
(profiles/perf_model.py: the analytic roofline at a ``HardwareSpec``, or a
``TabulatedPerfModel`` of tables measured on the card). This is what
produces the paper's evaluation figures: every baseline the paper compares
against is a `Policy` here, and Nitsum itself is the planner +
global/local schedulers + the switch mechanisms.

Execution model per group (one TP group of `tp` chips):
  * prefill runs serially (FCFS) and, in mixed groups, preempts decode —
    which reproduces the prefill/decode interference the paper's
    disaggregation baselines suffer from;
  * decode is a continuous batch of up to `batch_cap` requests, each gaining
    tokens at 1/decode_step_time(batch, ctx, tp);
  * reconfiguration blocks the group for the mechanism's switch cost, as
    the perf model and ``MigrationModel`` price it at the spec given:
    zero-copy weights + pipelined KV migration for Nitsum, weight reload
    and per-page migration for the straw-men.

Engine (docs/simulator.md): next-event time advance. Each group arms its
next boundary event (prefill completion, earliest decode finish, unblock,
context-drift refresh) and the engine jumps straight to it, integrating
decode token gain analytically over the interval. The original fixed-``dt``
fluid-tick reference loop was retired after two consecutive green
equivalence PRs (ROADMAP); the recorded golden trajectories in
repro_torch.testing.sim_equivalence now serve as the regression gate, and
``grid_parity`` (arrivals/finish stamps snapped to the old ``dt`` grid) is
kept ON so those goldens remain comparable across PRs.

Faults (docs/faults.md): a workload may carry seeded
:class:`~repro_torch.traces.workload.FaultEvent` s — chip/host loss, KV loss,
stragglers, recovery. The engine applies them at their fire times: victim
groups are torn down (their resident sequences restart through the
admission/spill path), the policy gets a forced ``on_fault`` replan over
the degraded pool, and recoveries re-grow the pool with weight-reload
storms charged to newly formed groups.
"""
from __future__ import annotations

import bisect
import heapq
import math
from collections import Counter, deque
from dataclasses import dataclass, field, replace
from itertools import count
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.goodput import GoodputMeter, RequestRecord, SLOTier
from repro_torch.core.incidents import analyze_incidents
from repro_torch.core.migration import MigrationModel
from repro_torch.core.planner import Planner, PlannerInputs, TierDemand
from repro_torch.profiles.perf_model import (
    PerfModel,
    TPOT_DESIGN_MARGIN,
    mid_decode_ctx,
)
from repro_torch.serving.global_scheduler import (
    GlobalScheduler,
    GroupHandle,
    ShardedScheduler,
    tenant_key,
)
from repro_torch.traces.workload import Topology, TraceRequest, Workload

_EPS = 1e-9
_NO_CROSSERS = np.zeros(0, dtype=np.intp)

# default resilience_weight for the "nitsum-resilient" policy. The
# measured frontier (benchmarks/cascade_matrix.py --frontier; docs/
# faults.md records the sweep) is a step, not a slope: any w > 0 flips
# layouts to host-contained groups at ~0.3% steady-state goodput on
# topologies where the exposure term binds (zero where groups already fit
# a host), and the choice is insensitive to w across [0.002, 0.1] — 0.02
# sits mid-range of that plateau
DEFAULT_RESILIENCE_WEIGHT = 0.02


@dataclass(frozen=True)
class GroupSpec:
    tier: Optional[str]  # None = shared
    stage: str  # prefill | decode | mixed
    tp: int


@dataclass(slots=True)
class SimReq:
    tr: TraceRequest
    feasible: bool = True
    background: bool = False
    tokens: float = 0.0
    prefill_left_s: float = 0.0
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    group: Optional["Group"] = None
    rate_cost: float = 0.0
    dispatch_gid: Optional[int] = None
    # admission throttling exhausted its retries: serve best-effort, and
    # never offer the request to the fleet as a bandwidth spill (budgets
    # are fleet-global — a different cell has the same bucket)
    demoted: bool = False
    _penalty: float = 0.0  # transient: reconfig stall charged on migration

    @property
    def ctx(self) -> float:
        return self.tr.prompt_len + self.tokens


def prefill_priority(r: SimReq) -> tuple:
    """Local-scheduler queue priority (§3.3.2): feasible SLO work first,
    then best-effort (spilled infeasible), then background; FCFS within a
    class. The key is static while a request is queued."""
    return (r.background, not r.feasible, r.tr.arrival_s)


class PrefillQueue:
    """Prefill admission queue with order-preserving selection.

    Two modes, chosen by the policy's ``slo_aware_prefill`` flag:
      * FCFS (deque): plain append/popleft, plus the tail-pop / resort ops
        request-migration policies (Llumnix) use.
      * priority (binary heap on `prefill_priority`): O(log n) push/pop
        replacing the O(n) rotate/pop/rotate selection of the fluid seed.
        The key is static per request, so no re-heapify is ever needed.

    In both modes removing the selected element preserves the relative
    order of everything left behind (regression: test_prefill_queue_*).

    ``prompt_tokens`` maintains the sum of queued prompt lengths in O(1):
    the KV backpressure check projects a group's occupancy as (live KV +
    queued prompts) without scanning the queue. ``kv_clamp`` caps each
    prompt's contribution (sliding-window models hold at most `window`
    KV tokens per sequence).
    """

    __slots__ = ("_priority", "_q", "_heap", "_ctr", "_kv_clamp", "prompt_tokens")

    def __init__(
        self, priority: bool = False, items: Sequence[SimReq] = (),
        kv_clamp: float = math.inf,
    ):
        self._priority = priority
        self._ctr = count()
        self._kv_clamp = kv_clamp
        self.prompt_tokens = sum(min(r.tr.prompt_len, kv_clamp) for r in items)
        if priority:
            self._q = None
            self._heap = [(prefill_priority(r), next(self._ctr), r) for r in items]
            heapq.heapify(self._heap)
        else:
            self._q = deque(items)
            self._heap = None

    def append(self, r: SimReq) -> None:
        self.prompt_tokens += min(r.tr.prompt_len, self._kv_clamp)
        if self._priority:
            heapq.heappush(self._heap, (prefill_priority(r), next(self._ctr), r))
        else:
            self._q.append(r)

    def popleft(self) -> SimReq:
        r = (
            heapq.heappop(self._heap)[2] if self._priority else self._q.popleft()
        )
        self.prompt_tokens -= min(r.tr.prompt_len, self._kv_clamp)
        return r

    def pop(self) -> SimReq:
        """Tail pop (queue-migration policies; FCFS mode only)."""
        r = self._q.pop()
        self.prompt_tokens -= min(r.tr.prompt_len, self._kv_clamp)
        return r

    def pop_best(self) -> SimReq:
        """Remove and return the highest-priority request, preserving the
        order of the remaining queue."""
        if self._priority:
            r = heapq.heappop(self._heap)[2]
        else:
            best_i = min(
                range(len(self._q)), key=lambda i: prefill_priority(self._q[i])
            )
            r = self._q[best_i]
            del self._q[best_i]
        self.prompt_tokens -= min(r.tr.prompt_len, self._kv_clamp)
        return r

    def resort(self, key) -> None:
        """Reorder in place (FCFS mode; e.g. Llumnix strict-tier priority)."""
        items = sorted(self._q, key=key)
        self._q.clear()
        self._q.extend(items)

    def clear(self) -> List[SimReq]:
        out = list(self)
        if self._priority:
            self._heap.clear()
        else:
            self._q.clear()
        self.prompt_tokens = 0
        return out

    def __len__(self) -> int:
        return len(self._heap) if self._priority else len(self._q)

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self):
        if self._priority:
            return (e[2] for e in sorted(self._heap, key=lambda e: (e[0], e[1])))
        return iter(self._q)

    def __getitem__(self, i):
        if self._priority:
            return list(self)[i]
        return self._q[i]


class DecodeBatch:
    """Structure-of-arrays decode state with a bounded running batch.

    The running batch — the first ``cap`` requests in scheduling-priority
    order (`prefill_priority`) — lives in parallel numpy arrays, so token
    integration is one vectorized add and every array operation is O(cap).
    Requests beyond the cap gain no tokens; they wait in a binary heap keyed
    by the same priority and are promoted as batch slots free up. The
    invariant at all times is that (batch set, waiting set) partitions the
    requests exactly as the fluid seed's full per-tick sort would: the batch
    holds the cap best-priority requests, in priority order.

    ``tokens`` in the arrays is authoritative for batch members between
    ``sync()`` points; ``sync()``/eviction write it back to the `SimReq`
    objects before any outside code (switch-cost estimation,
    reconfiguration) reads per-request context lengths. Waiting requests do
    not gain tokens, so their ``SimReq.tokens`` is always current.
    """

    __slots__ = (
        "cap", "reqs", "_keys", "_wait", "_ctr", "_n", "_data",
        "_pfx_b", "_pfx_ctx_sum", "_pfx_min_rem", "_pending",
    )

    _TOK, _NEED, _PROMPT = 0, 1, 2

    def __init__(self, cap: int):
        self.cap = max(int(cap), 1)
        self.reqs: List[SimReq] = []  # running batch, priority order
        self._keys: List[tuple] = []
        self._wait: List[tuple] = []  # heap of (key, seq, req) beyond cap
        self._ctr = count()
        self._n = 0
        size = min(self.cap, 1 << 12)
        # one (3, size) buffer: a membership change shifts one 2-D slice
        # instead of three 1-D ones
        self._data = np.zeros((3, size))
        # incremental aggregates over the running batch: a uniform token
        # gain g shifts the context sum by g*b and the min remaining by -g,
        # so steady-state refresh events are O(1) numpy-free updates
        self._pfx_b = -1
        self._pfx_ctx_sum = 0.0
        self._pfx_min_rem = 0.0
        # uniform gain accumulated against the current prefix but not yet
        # applied to the arrays — steady-state refresh events touch no numpy
        self._pending = 0.0

    def __len__(self) -> int:
        return self._n + len(self._wait)

    @property
    def batch_len(self) -> int:
        return self._n

    def __iter__(self):
        for r in self.reqs:
            yield r
        for e in self._wait:
            yield e[2]

    @property
    def tokens(self) -> np.ndarray:
        self._materialize()
        return self._data[self._TOK, : self._n]

    def _materialize(self) -> None:
        """Apply the buffered uniform gain to the arrays. Must run before
        any membership change or any read of individual token values."""
        if self._pending:
            self._data[self._TOK, : self._pfx_b] += self._pending
            self._pending = 0.0

    def _grow(self) -> None:
        size = min(max(2 * self._data.shape[1], 16), max(self.cap, 16))
        buf = np.zeros((3, size))
        buf[:, : self._n] = self._data[:, : self._n]
        self._data = buf

    def _insert(self, k: tuple, r: SimReq) -> None:
        self._materialize()
        i = bisect.bisect_right(self._keys, k)
        self.reqs.insert(i, r)
        self._keys.insert(i, k)
        n = self._n
        data = self._data
        if n == data.shape[1]:
            self._grow()
            data = self._data
        data[:, i + 1 : n + 1] = data[:, i:n]
        data[0, i] = r.tokens
        data[1, i] = r.tr.output_len
        data[2, i] = r.tr.prompt_len
        self._n = n + 1
        self._pfx_b = -1

    def _evict_last(self) -> None:
        self._materialize()
        j = self._n - 1
        r = self.reqs.pop()
        k = self._keys.pop()
        r.tokens = float(self._data[self._TOK, j])
        self._n = j
        self._pfx_b = -1
        heapq.heappush(self._wait, (k, next(self._ctr), r))

    def add(self, r: SimReq) -> bool:
        """Insert a request; returns True iff the running batch changed."""
        k = prefill_priority(r)
        if self._n >= self.cap:
            if k >= self._keys[-1]:
                heapq.heappush(self._wait, (k, next(self._ctr), r))
                return False
            # newcomer outranks the worst batch member: displace it
            self._evict_last()
        self._insert(k, r)
        return True

    def set_cap(self, cap: int) -> bool:
        """Resize the running batch bound (dynamic KV-occupancy caps).
        Shrinking evicts the worst-priority members to the waiting heap;
        growing promotes waiters. Returns True iff membership changed."""
        cap = max(int(cap), 1)
        if cap == self.cap:
            return False
        self.cap = cap
        changed = False
        while self._n > cap:
            self._evict_last()
            changed = True
        while self._wait and self._n < cap:
            k, _, r = heapq.heappop(self._wait)
            self._insert(k, r)
            changed = True
        return changed

    def remove_indices(self, idx) -> List[SimReq]:
        """Remove (sorted ascending) batch positions; returns the removed
        requests with their tokens synced back. Freed slots are refilled
        from the waiting heap in priority order."""
        self._materialize()
        out = []
        n = self._n
        data = self._data
        for j in reversed(list(idx)):
            r = self.reqs[j]
            r.tokens = float(data[0, j])
            out.append(r)
            del self.reqs[j]
            del self._keys[j]
            data[:, j : n - 1] = data[:, j + 1 : n]
            n -= 1
        self._n = n
        self._pfx_b = -1
        while self._wait and self._n < self.cap:
            k, _, r = heapq.heappop(self._wait)
            self._insert(k, r)
        out.reverse()
        return out

    def _refresh_prefix(self, b: int) -> None:
        self._materialize()
        data = self._data
        tok = data[0, :b]
        self._pfx_ctx_sum = float(data[2, :b].sum() + tok.sum())
        self._pfx_min_rem = float((data[1, :b] - tok).min())
        self._pfx_b = b

    def mean_ctx(self, b: int) -> float:
        if self._pfx_b != b:
            self._refresh_prefix(b)
        return self._pfx_ctx_sum / b

    def gain(self, g: float, b: int) -> None:
        if self._pfx_b == b:
            # numpy-free steady state: buffer the uniform gain and update
            # the O(1) aggregates; arrays catch up at the next materialize
            self._pending += g
            self._pfx_ctx_sum += g * b
            self._pfx_min_rem -= g
        else:
            self._materialize()
            self._data[self._TOK, :b] += g
            self._pfx_b = -1

    def window_charge(self, g: float, b: int, win: float) -> float:
        """KV tokens a uniform gain ``g`` over the running batch actually
        adds when per-sequence residency is clamped to a sliding window:
        sequences already at the window contribute nothing, sequences
        crossing it during the gain contribute only the part below it.
        Must be called BEFORE gain() applies ``g``."""
        self._materialize()
        data = self._data
        c0 = np.minimum(data[self._PROMPT, :b], win) + data[self._TOK, :b]
        return float(
            (np.minimum(c0 + g, win) - np.minimum(c0, win)).sum()
        )

    def crossers(self, b: int) -> np.ndarray:
        if self._pfx_b == b and self._pfx_min_rem > _EPS:
            return _NO_CROSSERS
        self._materialize()
        data = self._data
        return np.nonzero(data[0, :b] >= data[1, :b] - _EPS)[0]

    def min_remaining(self, b: int) -> float:
        if self._pfx_b != b:
            self._refresh_prefix(b)
        return self._pfx_min_rem

    def sync(self) -> None:
        self._materialize()
        toks = self._data[self._TOK]
        for j, r in enumerate(self.reqs):
            r.tokens = float(toks[j])

    def clear(self) -> List[SimReq]:
        self.sync()
        out = self.reqs + [e[2] for e in self._wait]
        self.reqs = []
        self._keys = []
        self._wait = []
        self._n = 0
        return out


class Group:
    __slots__ = (
        "gid", "spec", "sim", "prefill_q", "cur", "decode", "blocked_until",
        "batch_cap", "t_sync", "_epoch", "_ev_kind", "_step", "_batch_n",
        "_decode_active", "kv_tokens", "kv_seqs", "kv_capacity_bytes",
        "ctx_ewma", "_cap_ctx", "_kv_win", "slow_factor", "chips",
    )

    def __init__(self, gid: int, spec: GroupSpec, sim: "Simulator"):
        self.gid = gid
        self.spec = spec
        self.sim = sim
        # sliding-window models hold at most `window` KV tokens per seq;
        # occupancy charges are clamped consistently with seq_kv_bytes
        self._kv_win = sim.perf.cfg.attn.window or math.inf
        self.prefill_q = PrefillQueue(
            priority=sim.policy.slo_aware_prefill, kv_clamp=self._kv_win
        )
        self.cur: Optional[SimReq] = None
        self.blocked_until: float = 0.0
        self.batch_cap = sim.decode_cap(spec)
        # realized mean decode context, time-weighted EWMA over decode
        # activity (tau = sim.ctx_ewma_tau_s); 0.0 = no signal yet, caps
        # fall back to the demand-derived design context
        self.ctx_ewma: float = 0.0
        # the design context batch_cap was derived at — refresh_cap only
        # re-derives once the realized context drifts cap_drift_frac away
        self._cap_ctx: float = sim.policy.design_ctx(sim, spec)
        self.decode = DecodeBatch(self.batch_cap)
        # --- live KV occupancy (docs/simulator.md §KV occupancy) ---
        # kv_tokens: tokens resident on this group's HBM — every decode
        # request's ctx (batch AND waiting; waiters hold KV without gaining)
        # plus the in-flight prefill's prompt, charged up-front at prefill
        # start. kv_seqs counts the resident sequences (recurrent-state
        # charge). Invariant (kv_audit): kv_tokens == sum of those charges.
        self.kv_tokens: float = 0.0
        self.kv_seqs: int = 0
        self.kv_capacity_bytes: float = sim.perf.kv_capacity_bytes(spec.tp)
        # straggler fault: >1.0 scales every step/prefill time until the
        # fault window ends (docs/faults.md). A TP group runs at its
        # SLOWEST chip, so this is max over the member chips' slowdowns.
        self.slow_factor: float = 1.0
        # chip identity (docs/faults.md §Failure domains): which physical
        # chips this group holds — assigned by Simulator._alloc_chips,
        # read by domain-scoped faults and per-chip degradation
        self.chips: Tuple[int, ...] = ()
        # --- event-engine state ---
        self.t_sync: float = sim.now  # decode/prefill integrated up to here
        self._epoch: int = 0  # invalidates stale heap entries
        self._ev_kind: Optional[str] = None
        self._step: float = 0.0  # decode step time held over the interval
        self._batch_n: int = 0
        self._decode_active: bool = False

    # ---- KV occupancy ------------------------------------------------
    def _kv_charge(self, tokens: float, seqs: int) -> None:
        self.kv_tokens += tokens
        self.kv_seqs += seqs

    def _kv_ctx(self, r: SimReq) -> float:
        """The request's charged KV tokens: prompt plus generated tokens,
        with the TOTAL clamped to the sliding window — a window model
        evicts the oldest token as each new one lands, so residency never
        exceeds the window no matter how long the output runs (consistent
        with seq_kv_bytes and the clamped decode-gain charges; the old
        unclamped generation charge spuriously tripped the kv_watermark
        spill path on long-output swa traces)."""
        p = r.tr.prompt_len
        win = self._kv_win
        tot = (p if p < win else win) + r.tokens
        return tot if tot < win else win

    def kv_bytes(self) -> float:
        perf = self.sim.perf
        return (
            perf.kv_bytes_per_token() * self.kv_tokens
            + perf.state_bytes() * self.kv_seqs
        )

    def kv_projected_bytes(self) -> float:
        """Occupancy once every queued prefill has been admitted — the
        quantity the admission watermark is checked against."""
        perf = self.sim.perf
        q = self.prefill_q
        return self.kv_bytes() + (
            perf.kv_bytes_per_token() * q.prompt_tokens
            + perf.state_bytes() * len(q)
        )

    def refresh_cap(self) -> bool:
        """Re-derive the decode batch cap at the group's realized context
        (the EWMA `design_ctx` tracks); returns True iff batch membership
        changed. Called by the engine before each decode step-time
        evaluation. Fast path: while the realized context stays within
        cap_drift_frac of the context the current cap was designed at,
        the cap cannot have moved meaningfully (the TPOT margin absorbs
        sub-drift error), so the policy call is skipped — the hot
        steady-state replay pays one comparison per event."""
        sim = self.sim
        decode = self.decode
        b = decode.batch_len
        ctx = self.ctx_ewma
        if ctx <= 0.0 and b:
            ctx = decode.mean_ctx(b)
        ref = self._cap_ctx
        if ctx > 0.0 and ref > 0.0 and abs(ctx - ref) <= sim.cap_drift_frac * ref:
            return False
        cap = sim.decode_cap(self.spec, self)
        self._cap_ctx = sim.policy.design_ctx(sim, self.spec, self)
        if cap == self.batch_cap:
            return False
        self.batch_cap = cap
        return self.decode.set_cap(cap)

    def _start_prefill(self) -> SimReq:
        """Pop the next prefill, charge its KV up-front, set it running."""
        r = self._next_prefill()
        r.prefill_left_s = self.sim.perf.prefill_time_s(
            r.tr.prompt_len, self.spec.tp
        )
        self.cur = r
        self._kv_charge(min(r.tr.prompt_len, self._kv_win), 1)
        return r

    @property
    def decoding(self) -> List[SimReq]:
        """All decode-phase requests (running batch in priority order, then
        waiting). NOTE: per-request ``tokens`` on batch members is only
        current after ``decode.sync()`` (the engines sync before any policy
        code that reads them runs)."""
        return list(self.decode)

    @property
    def queue_len(self) -> int:
        return len(self.prefill_q) + (1 if self.cur else 0) + len(self.decode)

    def live_requests(self) -> List[SimReq]:
        self.decode.sync()
        out = list(self.prefill_q) + list(self.decode)  # batch + waiting
        if self.cur is not None:
            out.append(self.cur)
        return out

    def clear(self) -> List[SimReq]:
        out = list(self.prefill_q.clear()) + self.decode.clear()
        if self.cur is not None:
            out.append(self.cur)
        self.cur = None
        self.kv_tokens = 0.0
        self.kv_seqs = 0
        return out

    def add_decode(self, r: SimReq) -> bool:
        """Returns True iff the running batch's membership changed."""
        return self.decode.add(r)

    def _next_prefill(self) -> SimReq:
        """SLO-aware policies serve feasible requests first (local scheduler
        queue priority, §3.3.2); SLO-agnostic engines are FCFS."""
        if not self.sim.policy.slo_aware_prefill:
            return self.prefill_q.popleft()
        return self.prefill_q.pop_best()

    # ------------------------------------------------------------------
    # event engine: analytic advance + next-boundary computation
    # ------------------------------------------------------------------
    def advance_to(self, t: float) -> None:
        """Integrate state from ``t_sync`` to ``t``. The engine guarantees no
        boundary (prefill completion, decode finish, unblock) lies strictly
        inside the interval, so a single regime applies throughout — fault
        application advances every group to the fault time before changing
        ``slow_factor``, keeping intervals regime-homogeneous."""
        if t <= self.t_sync:
            return
        if self.t_sync < self.blocked_until:
            self.t_sync = min(t, self.blocked_until)
            if self.t_sync >= t:
                return
        dt = t - self.t_sync
        if self.spec.stage in ("prefill", "mixed") and self.cur is not None:
            self.cur.prefill_left_s = max(
                self.cur.prefill_left_s - dt / self.slow_factor, 0.0
            )
        elif self._decode_active and len(self.decode):
            gain = dt / self._step  # _step already carries slow_factor
            b = self._batch_n
            # realized-context EWMA (decode-time-weighted): the design
            # point refresh_cap re-derives the cap at once it drifts
            ctx = self.decode.mean_ctx(b) + 0.5 * gain
            ew = self.ctx_ewma
            if ew <= 0.0:
                self.ctx_ewma = ctx
            else:
                self.ctx_ewma = ew + (ctx - ew) * (
                    dt / (dt + self.sim.ctx_ewma_tau_s)
                )
            if self._kv_win is math.inf:
                charged = gain * b
            else:
                # sliding-window model: per-sequence residency saturates
                # at the window, so only the unsaturated part is charged
                charged = self.decode.window_charge(gain, b, self._kv_win)
            self.decode.gain(gain, b)
            self._kv_charge(charged, 0)
        self.t_sync = t

    def arm(self) -> float:
        """Compute (and cache the parameters of) this group's next boundary
        event; returns its absolute time (inf = idle). May start the next
        queued prefill, mirroring the fluid tick's immediate pickup."""
        base = self.t_sync
        self._decode_active = False
        self._ev_kind = None
        decode = self.decode
        stage = self.spec.stage
        if base < self.blocked_until:
            if self.cur is None and not self.prefill_q and not decode.batch_len:
                return math.inf
            self._ev_kind = "unblock"
            return self.blocked_until
        if stage != "decode":  # prefill | mixed
            cur = self.cur
            if cur is None and self.prefill_q:
                cur = self._start_prefill()
            if cur is not None:
                self._ev_kind = "prefill"
                return base + cur.prefill_left_s * self.slow_factor
        if stage != "prefill" and decode.batch_len:
            self.refresh_cap()
        b = decode.batch_len
        if b and stage != "prefill":  # decode | mixed
            ctx = decode.mean_ctx(b)
            step = self._step = (
                self.sim.perf.decode_step_time_s(b, ctx, self.spec.tp)
                * self.slow_factor
            )
            self._batch_n = b
            self._decode_active = True
            self._ev_kind = "decode"
            dt_fin = max(decode.min_remaining(b), 0.0) * step
            # context-drift refresh: holding `step` constant is only valid
            # while the batch's mean context is ~unchanged; re-arm after
            # ctx_refresh_frac relative growth (docs/simulator.md §Error)
            gain_cap = max(8.0, self.sim.ctx_refresh_frac * ctx)
            return base + min(dt_fin, gain_cap * step)
        return math.inf


# ===========================================================================
# Policies (the paper's systems)
# ===========================================================================
class Policy:
    name = "base"
    reconfigures = False
    slo_aware_batching = True  # cap decode batch by the tier's TPOT SLO
    slo_aware_prefill = False  # feasible-first prefill queueing

    def __init__(self, perf: PerfModel, tiers: Sequence[SLOTier], candidate_tps=(1, 2, 4, 8)):
        self.perf = perf
        self.tiers = {t.name: t for t in tiers}
        self.tps = tuple(candidate_tps)

    # Decode caps are designed at the context the group actually serves:
    # the realized batch-context EWMA when one exists, else the
    # demand-derived mid-decode context, else CTX_REF as a last resort.
    # The TPOT budget carries an explicit slack margin (TPOT_MARGIN) so a
    # cap-sized batch runs safely inside the SLO rather than exactly on
    # the boundary — the margin is what lets the perf-model length grid
    # run 5x coarser (docs/simulator.md §Decode-caps, §Cache-key).
    CTX_REF = 2048  # fallback design point only: no demand stats, no batch
    TPOT_MARGIN = TPOT_DESIGN_MARGIN
    # Layouts are scored (and planned) against the observed rate plus
    # burst headroom, not the bare observed rate: capping the estimate at
    # raw demand made every demand-meeting layout tie exactly, so the
    # switch criterion could never see a drifting mix eroding one tier's
    # headroom until the SLOs were already blown (tier_drift fired zero
    # switches over a full mix inversion).
    DEMAND_HEADROOM = 1.2

    def design_ctx(
        self, sim: "Simulator", spec: "GroupSpec",
        group: Optional["Group"] = None,
    ) -> float:
        """The context length a group's decode cap (and the planner's
        matching decode-rate estimate) is designed at."""
        if group is not None and group.ctx_ewma > 0.0:
            return group.ctx_ewma
        d = sim.tier_stats(spec.tier)
        if d.rps > 0.0:
            return mid_decode_ctx(d.prompt_len, d.output_len)
        return float(self.CTX_REF)

    def _cap_tpot_ms(self, spec: "GroupSpec") -> float:
        if not self.slo_aware_batching:
            return 1e9  # SLO-agnostic engines batch to the memory limit
        tpot = None
        for t in self.tiers.values():
            if spec.tier in (None, t.name) and not t.background:
                # a shared group may serve EVERY compatible tier, so the
                # batch must be sized for the strictest (min) TPOT — the
                # loosest (max) let relaxed-tier batches blow the strict
                # tier's TPOT SLO
                tpot = t.tpot_ms if tpot is None else min(tpot, t.tpot_ms)
        return 1e9 if tpot is None else tpot

    def decode_cap(
        self, sim: "Simulator", spec: "GroupSpec", group: Optional["Group"] = None
    ) -> int:
        tpot = self._cap_tpot_ms(spec)
        if tpot < 1e9:
            tpot *= self.TPOT_MARGIN
        ctx = self.design_ctx(sim, spec, group)
        cap = self.perf.max_decode_batch(ctx, spec.tp, tpot)
        if group is not None and (
            self.perf.kv_bytes_per_token() > 0 or self.perf.state_bytes() > 0
        ):
            # dynamic memory term: how many sequences at the batch's CURRENT
            # mean context fit the group's watermarked KV budget. The budget
            # is the FULL watermarked capacity — the batch being sized is
            # the occupancy, so subtracting resident bytes would
            # double-count. In particular the waiting heap must NOT be
            # subtracted: shrinking the running batch frees no waiter KV
            # (waiters keep their cache while evicted), so a
            # budget-minus-waiters rule feeds itself — a small cap grows
            # the heap, which shrinks the budget, which shrinks the cap,
            # until whole groups decode at batch=1 (the prefill_heavy/512
            # collapse). Total residency is the admission watermark's job
            # (_kv_backpressure), not the cap's.
            b = group.decode.batch_len
            cur = group.decode.mean_ctx(b) if b else ctx
            budget = sim.kv_watermark * group.kv_capacity_bytes
            cap = min(
                cap,
                self.perf.max_decode_batch(
                    cur, spec.tp, 1e9, hbm_free_bytes=budget
                ),
            )
        return max(cap, 1)

    def estimate_specs(self, sim: "Simulator", specs) -> float:
        """Estimated SLO-served rps of a group layout under current demand.

        Shared (tier=None) groups are split demand-proportionally across
        tiers — a hard 50/50 split would systematically undervalue shared
        pools and bias the planner toward needless partitioning."""
        demands = self._live_demands(sim)
        caps = self._tier_caps(sim, specs, demands)
        return sum(
            min(thp, thd, demands[name].rps * self.DEMAND_HEADROOM)
            for name, (thp, thd) in caps.items()
        )

    def _live_demands(self, sim: "Simulator") -> Dict[str, "TierDemand"]:
        demands = {}
        for t in self.tiers.values():
            if not t.background:
                d = sim.tier_stats(t.name)
                if d.rps > 0:
                    demands[t.name] = d
        return demands

    def _tier_caps(self, sim, specs, demands) -> Dict[str, tuple]:
        """Per-tier (prefill, decode) SLO-compliant capacity of a layout,
        shared groups split demand-proportionally."""
        tot_rps = sum(d.rps for d in demands.values()) or 1.0
        # a shared group's decode batch is sized by the STRICTEST tier it
        # may serve (_cap_tpot_ms takes the min) — the estimate must use
        # the same budget or shared pools are credited with relaxed-tier
        # capacity the runtime cap never grants
        strictest = min(
            (t.tpot_ms for t in self.tiers.values() if not t.background),
            default=1e9,
        )
        caps: Dict[str, tuple] = {}
        for name, d in demands.items():
            t = self.tiers[name]
            thp = thd = 0.0
            for s in specs:
                if s.tier not in (None, name):
                    continue
                # mixed groups time-share stages adaptively — 0.8, not 0.5
                # (calibrated against realized sim goodput; a hard split
                # undervalues colocation and biases toward partitioning)
                w = 0.8 if s.stage == "mixed" else 1.0
                share = 1.0 if s.tier == name else d.rps / tot_rps
                if s.stage in ("prefill", "mixed"):
                    thp += w * share * self.perf.max_prefill_rps(
                        d.prompt_len, s.tp, t.ttft_ms
                    )
                if s.stage in ("decode", "mixed"):
                    # same design point as the runtime caps (decode_cap):
                    # mid-decode context, TPOT budget with the slack margin
                    # — estimates and realized group behaviour must agree
                    # or plans systematically mis-size decode capacity
                    tpot = t.tpot_ms if s.tier == name else min(
                        t.tpot_ms, strictest
                    )
                    if self.slo_aware_batching:
                        tpot *= self.TPOT_MARGIN
                    thd += w * share * self.perf.max_decode_rps(
                        mid_decode_ctx(d.prompt_len, d.output_len),
                        d.output_len, s.tp, tpot,
                    )
            caps[name] = (thp, thd)
        return caps

    def mix_headroom_rps(self, sim: "Simulator", specs) -> float:
        """The total arrival rate the layout could serve if demand scaled
        up uniformly at the CURRENT tier mix — i.e. burst headroom at the
        realized mix, min over tiers of capacity/mix-share.

        This is the drift signal the served-rate estimate cannot carry:
        when mean demand is met by every candidate layout (estimate_specs
        ties at the demand cap), a drifting mix still erodes the growing
        tier's headroom, and bursty arrivals cash that headroom out as
        goodput. tier_drift fired ZERO switches over a full strict:relaxed
        inversion before this term existed."""
        demands = self._live_demands(sim)
        if not demands:
            return 0.0
        tot_rps = sum(d.rps for d in demands.values())
        caps = self._tier_caps(sim, specs, demands)
        return min(
            min(thp, thd) * tot_rps / demands[name].rps
            for name, (thp, thd) in caps.items()
        )

    def initial_specs(self, sim: "Simulator") -> List[GroupSpec]:
        raise NotImplementedError

    def window(self, sim: "Simulator") -> Optional[List[GroupSpec]]:
        return None

    def switch_cost_s(self, sim: "Simulator", group: Group) -> float:
        return 0.0

    def on_fault(self, sim: "Simulator", event) -> Optional[List[GroupSpec]]:
        """Reaction to an applied fault; returns a new group layout or None.

        The base (static-baseline) reaction is deliberately naive — the
        contrast the paper's robustness argument needs: losses are absorbed
        as lost capacity (no control plane re-plans around the hole, so a
        group's surviving chips are stranded), and on recovery the operator
        restarts instances of the deployment's own TP on whatever chips are
        free. NitsumPolicy overrides this with a forced planner re-solve
        over the changed pool."""
        if event.kind != "recovery":
            return None
        tp = getattr(self, "tp", None) or self.perf.min_tp(self.tps)
        specs = [g.spec for g in sim.groups]
        free = sim.n_chips - sum(s.tp for s in specs)
        if free < tp:
            return None
        return specs + [GroupSpec(None, "mixed", tp)] * (free // tp)

    def route(self, sim: "Simulator", req: SimReq) -> Group:
        """Default: least-loaded compatible prefill/mixed group."""
        cands = [
            g for g in sim.groups
            if g.spec.stage in ("prefill", "mixed")
            and (g.spec.tier in (None, req.tr.tier))
        ]
        if not cands:
            cands = sim.groups
        return min(cands, key=lambda g: g.queue_len)

    def decode_target(self, sim: "Simulator", req: SimReq, frm: Group) -> Group:
        if frm.spec.stage == "mixed":
            return frm
        cands = [
            g for g in sim.groups
            if g.spec.stage == "decode" and g.spec.tier in (None, req.tr.tier)
        ]
        if not cands:
            return frm
        # KV-aware tiebreak: a group already at its occupancy watermark only
        # receives the hand-off when every alternative is also full (on
        # short-context traces no group is ever full, so the order reduces
        # to the plain least-loaded choice)
        wm = sim.kv_watermark
        return min(
            cands,
            key=lambda g: (g.kv_bytes() >= wm * g.kv_capacity_bytes, len(g.decode)),
        )


class StaticPolicy(Policy):
    """SGLang-like static TP. disaggregated=True adds PD split (SGLang-PD)."""

    slo_aware_batching = False  # vanilla engines are SLO-agnostic

    def __init__(self, perf, tiers, tp=1, disaggregated=False, prefill_frac=0.35, **kw):
        super().__init__(perf, tiers, **kw)
        self.tp = tp
        self.disagg = disaggregated
        self.prefill_frac = prefill_frac
        self.name = f"sglang-tp{tp}" + ("-pd" if disaggregated else "")

    def initial_specs(self, sim):
        n_groups = sim.n_chips // self.tp
        if not self.disagg:
            return [GroupSpec(None, "mixed", self.tp)] * n_groups
        n_p = max(int(round(n_groups * self.prefill_frac)), 1)
        n_d = max(n_groups - n_p, 1)
        return [GroupSpec(None, "prefill", self.tp)] * n_p + [
            GroupSpec(None, "decode", self.tp)
        ] * n_d


class SLOStaticPolicy(StaticPolicy):
    """Static best-for-trace TP + SLO-aware batching/queueing (the paper's
    ablation step 3: 'simple batch rule that defers requests that cannot
    meet their SLO', no tier partitioning, no dynamic TP)."""

    slo_aware_batching = True
    slo_aware_prefill = True

    def __init__(self, perf, tiers, **kw):
        # the TP is sized at initial_specs time from the trace's realized
        # demand stats (like its sibling SplitPolicy) — a hardcoded
        # 1024/128 operating point flattered short traces and starved
        # length-heavy ones; min_tp is only the pre-trace placeholder
        super().__init__(
            perf, tiers,
            tp=perf.min_tp(kw.get("candidate_tps", (1, 2, 4, 8))), **kw,
        )
        self.name = "sglang-slo"

    def initial_specs(self, sim):
        # best static TP for the pool by the same profile (and the same
        # margin-designed decode operating point) the planner uses, at the
        # trace's observed per-tier demand
        best, best_tp = -1.0, self.tp
        for tp in self.tps:
            if tp > sim.n_chips or not self.perf.fits(tp):
                continue
            rate = 0.0
            for t in self.tiers.values():
                if t.background:
                    continue
                d = sim.tier_stats(t.name)
                if d.rps <= 0:
                    continue
                thp = self.perf.max_prefill_rps(d.prompt_len, tp, t.ttft_ms)
                thd = self.perf.max_decode_rps(
                    mid_decode_ctx(d.prompt_len, d.output_len),
                    d.output_len, tp, t.tpot_ms * self.TPOT_MARGIN,
                )
                rate += min(thp, thd)
            rate /= tp
            if rate > best:
                best, best_tp = rate, tp
        self.tp = best_tp
        self.name = f"sglang-slo-tp{best_tp}"
        return super().initial_specs(sim)


class SplitPolicy(Policy):
    """Per-tier static partitions; per-tier offline-best TP (paper 'Split').
    Each partition runs a vanilla (SLO-agnostic) engine."""

    name = "split"
    slo_aware_batching = False

    def initial_specs(self, sim):
        tiers = [t for t in self.tiers.values() if not t.background]
        share = sim.n_chips // max(len(tiers), 1)
        specs = []
        for t in tiers:
            d = sim.tier_stats(t.name)
            best, best_tp = -1.0, self.tps[0]
            for tp in self.tps:
                if tp > share:
                    continue
                thp = self.perf.max_prefill_rps(d.prompt_len, tp, t.ttft_ms)
                thd = self.perf.max_decode_rps(d.prompt_len, d.output_len, tp, t.tpot_ms)
                rate = min(thp, thd) / tp if min(thp, thd) > 0 else 0.0
                if rate > best:
                    best, best_tp = rate, tp
            specs += [GroupSpec(t.name, "mixed", best_tp)] * (share // best_tp)
        return specs


class LlumnixPolicy(StaticPolicy):
    """Request-level control only: static TP + per-window queue rebalancing
    and strict-tier priority. No execution reconfiguration."""

    def __init__(self, perf, tiers, tp=1, **kw):
        super().__init__(perf, tiers, tp=tp, disaggregated=False, **kw)
        self.name = f"llumnix-tp{tp}"

    reconfigures = True
    slo_aware_batching = False

    def window(self, sim):
        # migrate queued prefills from the most- to the least-loaded groups
        groups = sorted(sim.groups, key=lambda g: g.queue_len)
        lo, hi = groups[0], groups[-1]
        moved = 0
        while len(hi.prefill_q) - len(lo.prefill_q) > 2 and moved < 8:
            r = hi.prefill_q.pop()
            lo.prefill_q.append(r)
            r.group = lo
            moved += 1
        if moved:
            # live migration overhead hidden but not free: brief stall
            hi.blocked_until = max(hi.blocked_until, sim.now + 0.05)
        for g in sim.groups:  # strict-priority queues
            g.prefill_q.resort(
                key=lambda r: (r.tr.tier != "strict", r.tr.arrival_s)
            )
        return None


class ChironPolicy(StaticPolicy):
    """Hierarchical autoscaling: adjusts per-tier group counts by queue
    backpressure; static TP; batch caps adapted to SLO."""

    def __init__(self, perf, tiers, tp=1, **kw):
        super().__init__(perf, tiers, tp=tp, **kw)
        self.name = f"chiron-tp{tp}"

    reconfigures = True
    slo_aware_batching = True  # chiron adapts batch sizes to SLOs
    slo_aware_prefill = True

    def initial_specs(self, sim):
        n = sim.n_chips // self.tp
        tiers = [t.name for t in self.tiers.values() if not t.background]
        self._cooldown = 0
        return [GroupSpec(tiers[i % len(tiers)], "mixed", self.tp) for i in range(n)]

    def window(self, sim):
        # hierarchical autoscaling reacts on a slower timescale than the
        # per-second window (cooldown avoids instance-restart thrash)
        self._cooldown = getattr(self, "_cooldown", 0) + 1
        if self._cooldown < 10:
            return None
        self._cooldown = 0
        # backpressure: move one group from the least- to the most-loaded tier
        load: Dict[str, List[Group]] = {}
        for g in sim.groups:
            load.setdefault(g.spec.tier, []).append(g)
        if len(load) < 2:
            return None
        press = {
            t: sum(g.queue_len for g in gs) / len(gs) for t, gs in load.items()
        }
        hot = max(press, key=press.get)
        cold = min(press, key=press.get)
        if press[hot] - press[cold] > 4 and len(load[cold]) > 1:
            specs = []
            moved = False
            for g in sim.groups:
                s = g.spec
                if not moved and s.tier == cold:
                    s = replace(s, tier=hot)
                    moved = True
                specs.append(s)
            return specs
        return None

    def switch_cost_s(self, sim, group):
        return 2.0  # instance restart / scale-out provisioning


class NitsumPolicy(Policy):
    """The full system: goodput-aware planner + feasibility routing +
    ms-level TP switching. Ablation flags select the paper's Fig. 12 ladder."""

    reconfigures = True
    slo_aware_prefill = True

    def __init__(
        self, perf, tiers, dynamic_tp=True, fast_switch=True, slo_aware=True,
        window_s=1.0, n_shards=1, shard_by="hash", reconcile_s=0.0,
        shard_seed=0, resilience_weight=0.0, **kw,
    ):
        super().__init__(perf, tiers, **kw)
        self.dynamic_tp = dynamic_tp
        self.fast_switch = fast_switch
        self.slo_aware = slo_aware
        # fault-aware planning (docs/faults.md §Fault-aware planning):
        # > 0 trades steady-state goodput for blast radius — candidate
        # layouts are discounted by expected recovery cost, in the
        # planner's per-tier choice AND in the shared-pool/uniform-plan
        # comparisons below
        self.resilience_weight = resilience_weight
        self.planner = Planner(
            perf, tiers, candidate_tps=self.tps,
            resilience_weight=resilience_weight,
        )
        self.mig = MigrationModel()
        self.name = "nitsum" + ("" if fast_switch else "-slowswitch")
        if resilience_weight > 0:
            self.name = "nitsum-resilient"
        # control-plane sharding (docs/control_plane.md): with n_shards > 1
        # or a nonzero reconcile interval the dispatch view is a
        # ShardedScheduler whose staleness is bounded by reconcile_s; the
        # defaults keep the fully-synchronous per-arrival view (goldens)
        self.n_shards = n_shards
        self.shard_by = shard_by
        self.reconcile_s = reconcile_s
        self.shard_seed = shard_seed
        self.gs: Optional[GlobalScheduler] = None

    def _mk_scheduler(self, handles) -> GlobalScheduler:
        if self.n_shards > 1 or self.reconcile_s > 0.0:
            # a KV snapshot that survived a full reconcile interval without
            # being republished is treated as full (route conservatively)
            stale = self.reconcile_s if self.reconcile_s > 0.0 else math.inf
            return ShardedScheduler(
                handles, n_shards=self.n_shards, shard_by=self.shard_by,
                reconcile_interval_s=self.reconcile_s, kv_stale_s=stale,
                seed=self.shard_seed,
            )
        return GlobalScheduler(handles)

    def _plan_chips(self, sim) -> int:
        """The pool fault-aware planning plans over: degraded chips
        (stragglers, flaky-link on-windows) are QUARANTINED — a TP group
        runs at its slowest member, so seating one 3x-slow chip gates a
        whole group, while planning around it idles only that chip. The
        allocator seats slow chips last, so a plan sized to the healthy
        pool sidelines them entirely (shrink-TP-in-place beats
        migrate-away). Identity when resilience is off — the ablation and
        the recorded goldens keep planning over the raw pool."""
        n = sim.n_chips
        if not getattr(self, "resilience_weight", 0.0):
            return n
        slow = getattr(sim, "_chip_slow", None)
        if not slow:
            return n
        return max(n - len(slow), self.perf.min_tp(self.tps))

    def _mk_plan(self, sim, n_chips: Optional[int] = None) -> List[GroupSpec]:
        n_chips = sim.n_chips if n_chips is None else n_chips
        demands = {}
        for t in self.tiers.values():
            if t.background:
                continue
            d = sim.tier_stats(t.name)
            if d.rps > 0:
                # burst headroom: plan for the same headroom the layout
                # estimator scores against (Policy.DEMAND_HEADROOM)
                demands[t.name] = TierDemand(
                    d.rps * self.DEMAND_HEADROOM, d.prompt_len, d.output_len
                )
        tp0 = self.perf.min_tp(self.tps)
        if not demands:
            return [GroupSpec(None, "mixed", tp0)] * (n_chips // tp0)
        plan = self.planner.plan(PlannerInputs(demands, n_chips))
        sim.last_planning_ms = plan.planning_ms
        specs: List[GroupSpec] = []
        for tier, tp in plan.tiers.items():
            if tp.mixed is not None:
                specs += [GroupSpec(tier, "mixed", tp.mixed.tp)] * int(
                    tp.mixed.chips // tp.mixed.tp
                )
                continue
            specs += [GroupSpec(tier, "prefill", tp.prefill.tp)] * int(
                tp.prefill.chips // tp.prefill.tp
            )
            specs += [GroupSpec(tier, "decode", tp.decode.tp)] * int(
                tp.decode.chips // tp.decode.tp
            )
        # leftover chips: shared mixed groups at the TP the aggregate
        # demand's own design point favours (same estimator as the group
        # sizing) — this is where spilled best-effort and background work
        # lands, and on length-heavy regimes most of the pool ends up
        # here, so hardcoding min_tp let a 2x-worse per-chip operating
        # point dominate the cluster
        used = sum(s.tp for s in specs)
        left = n_chips - used
        tp_s = self._shared_tp(sim)
        specs += [GroupSpec(None, "mixed", tp_s)] * (left // tp_s)
        left -= (left // tp_s) * tp_s
        specs += [GroupSpec(None, "mixed", tp0)] * (left // tp0)
        return specs

    def _shared_tp(self, sim) -> int:
        """TP for the leftover shared pool: best per-chip
        min(prefill, margin-designed decode) rate at the aggregate demand
        under the strictest SLOs a shared group must honour (the shared
        cap rule in _cap_tpot_ms)."""
        tp0 = self.perf.min_tp(self.tps)
        d = sim.tier_stats(None)
        if d.rps <= 0:
            return tp0
        live = [t for t in self.tiers.values() if not t.background]
        if not live:
            return tp0
        ttft = min(t.ttft_ms for t in live)
        tpot = min(t.tpot_ms for t in live) * self.TPOT_MARGIN
        ctx = mid_decode_ctx(d.prompt_len, d.output_len)
        best, best_tp = -1.0, tp0
        for tp in self.tps:
            if tp > sim.n_chips or not self.perf.fits(tp):
                continue
            thp = self.perf.max_prefill_rps(d.prompt_len, tp, ttft)
            thd = self.perf.max_decode_rps(ctx, d.output_len, tp, tpot)
            rate = self.planner._resilience_adjust(
                min(thp, thd) / tp, tp, tp, thp, thd, "mixed"
            )
            if rate > best:
                best, best_tp = rate, tp
        return best_tp

    def _resilience_score(self, est: float, specs) -> float:
        """Layout-comparison key under fault-aware planning: the goodput
        estimate discounted by the layout's chip-weighted mean recovery
        exposure (identity when resilience_weight is 0)."""
        w = self.resilience_weight
        if not w or est <= 0 or not specs:
            return est
        tot = sum(s.tp for s in specs)
        xbar = sum(
            s.tp * self.planner.chip_exposure(s.tp) for s in specs
        ) / max(tot, 1)
        return est / (1.0 + w * xbar)

    def _mk_plan_with_shared(self, sim) -> List[GroupSpec]:
        """Planner output vs uniform shared mixed pools: take the best by
        the same estimate. The shared pool wins when tiers' SLO-optimal TPs
        coincide (loose SLOs / uniform load) — it is the paper's 'in stable
        settings a fixed configuration may suffice' case, and including it
        makes Nitsum's config space a superset of every static baseline."""
        n = self._plan_chips(sim)
        cands = [self._mk_plan(sim, n)]
        for tp in self.tps:
            if self.perf.fits(tp) and n // tp >= 1:
                cands.append([GroupSpec(None, "mixed", tp)] * (n // tp))
        return max(
            cands,
            key=lambda s: self._resilience_score(self.estimate_specs(sim, s), s),
        )

    def initial_specs(self, sim):
        self._cur_specs = self._mk_plan_with_shared(sim)
        return self._cur_specs

    # restart-priced switch criterion: a candidate layout must clear a
    # small raw gain threshold (noise floor; counted as switch_considered)
    # AND pay for the restart it causes — the estimated rps gain over one
    # amortization horizon must exceed the requests forfeited by the
    # switch itself (stalls + redone in-flight prefill work). The old
    # criterion was a bare >15% raw-gain test: blind to prompt length, it
    # both fired on cheap noise and never priced a genuinely expensive
    # restart.
    #
    # Two raw signals feed the threshold: the served-rate estimate (a
    # tier is capacity-bound) and mix headroom (mean demand is met but a
    # drifting mix is eroding one tier's burst margin — see
    # mix_headroom_rps). Headroom gains are discounted by burst_credit
    # (only the burst-riding fraction of arrivals cashes headroom out as
    # goodput) and clamped at headroom_ceil x demand (margin beyond the
    # burst envelope is worthless, so the criterion does not chase raw
    # capacity).
    gain_threshold = 1.05
    switch_amortize_s = 30.0
    burst_credit = 0.25
    headroom_ceil = 2.0

    def window(self, sim):
        if not self.dynamic_tp:
            return None
        new = self._mk_plan_with_shared(sim)
        cur = getattr(self, "_cur_specs", None)
        if cur is None:
            self._cur_specs = new
            return new
        est_new = self.estimate_specs(sim, new)
        est_cur = self.estimate_specs(sim, cur)
        tot_rps = sum(d.rps for d in self._live_demands(sim).values())
        ceil = self.headroom_ceil * tot_rps
        hr_new = min(self.mix_headroom_rps(sim, new), ceil)
        hr_cur = min(self.mix_headroom_rps(sim, cur), ceil)
        raw = (
            est_new > self.gain_threshold * est_cur
            or hr_new > self.gain_threshold * hr_cur
        )
        if raw:
            # calibration counter (ROADMAP item 1): windows where a switch
            # candidate cleared the raw gain threshold, whether or not the
            # net-gain test and the hysteresis streak let it through
            sim.switch_considered += 1
        gain_rps = max(
            est_new - est_cur, (hr_new - hr_cur) * self.burst_credit
        )
        gain = raw and (
            gain_rps * self.switch_amortize_s
            > self.restart_cost_reqs(sim, new, est_cur)
        )
        # sustained-signal hysteresis: net gain must hold in THREE
        # consecutive windows — transient demand noise never switches,
        # real mix shifts switch within ~3 s (well inside the paper's
        # 0.5-1 s x burst-length envelope)
        self._gain_streak = getattr(self, "_gain_streak", 0) + 1 if gain else 0
        if self._gain_streak < 3:
            return None
        self._gain_streak = 0
        self._cur_specs = new
        return new

    def restart_cost_reqs(self, sim, new: List[GroupSpec], est_cur: float) -> float:
        """Requests forfeited by applying ``new``, in the same units as
        (estimated rps gain) x switch_amortize_s. Groups whose spec
        survives the multiset diff (what _apply_specs keeps) cost
        nothing. A dissolved group costs (a) its chip-share of the
        current served rate for the switch stall, and (b) its in-flight
        prefill's completed work, redone from scratch after the restart —
        a term that scales with the queued prompt length, which is
        exactly what the raw-gain criterion ignored (4-6k-token prompts
        make restarts ~20x pricier than chat-length ones)."""
        avail = Counter((s.tier or "", s.stage, s.tp) for s in new)
        n_chips = max(sim.n_chips, 1)
        cost = 0.0
        for g in sim.groups:
            k = (g.spec.tier or "", g.spec.stage, g.spec.tp)
            if avail[k] > 0:
                avail[k] -= 1
                continue
            g.decode.sync()  # switch_cost_s reads per-request contexts
            stall = self.switch_cost_s(sim, g)
            cost += est_cur * (g.spec.tp / n_chips) * stall
            if g.cur is not None:
                total = self.perf.prefill_time_s(
                    g.cur.tr.prompt_len, g.spec.tp
                )
                done = max(total - g.cur.prefill_left_s, 0.0)
                # the redone seconds occupy the restarted group before it
                # is back where it was — priced like the stall (so a 6k
                # prompt half-prefilled costs ~10x a 512-token one) —
                # plus the request's own forfeited progress fraction
                cost += est_cur * (g.spec.tp / n_chips) * done
                cost += done / max(total, 1e-9)
        return cost

    def switch_cost_s(self, sim, group: Group) -> float:
        # KV bytes resident on the group that must migrate (window-clamped,
        # consistent with the occupancy accounting)
        kv_bytes = sum(self.perf.seq_kv_bytes(r.ctx) for r in group.decoding)
        if self.fast_switch:
            return self.mig.pipelined_s(max(kv_bytes, 1.0))
        # straw-man: full weight reload (~1 GB/s from host) + per-page copies
        reload_s = self.perf.n_params * self.perf.dtype_bytes / 1e9
        return reload_s + self.mig.naive_per_page_s(max(kv_bytes, 1.0))

    def _sync_demand_sig(self, sim) -> tuple:
        """Change signature for the scheduler's profiled-bandwidth inputs:
        each tier's window-mean prompt length, bucketed at 2% so per-arrival
        jitter of the mean does not force a bandwidth refresh (max_rps
        staleness is bounded by the bucket). Reads the rolling sums
        directly — this runs on every arrival."""
        sim._recent_expire()
        sums = sim._tier_sums
        log = math.log
        sig = []
        tot_n = tot_sp = 0
        for tier in self.tiers:
            st = sums.get(tier)
            if st and st[0]:
                tot_n += st[0]
                tot_sp += st[1]
                sig.append(round(log(max(st[1] / st[0], 1.0)) * 50))
            else:
                sig.append(-1)
        sig.append(round(log(max(tot_sp / tot_n, 1.0)) * 50) if tot_n else -1)
        return tuple(sig)

    def _handle_max_rps(self, sim, g: Group) -> float:
        tier = g.spec.tier
        t = self.tiers.get(tier) if tier else None
        d = sim.tier_stats(tier) if tier else sim.tier_stats(None)
        if t is not None:
            rps = self.perf.max_prefill_rps(d.prompt_len, g.spec.tp, t.ttft_ms)
        else:
            rps = self.perf.max_prefill_rps(d.prompt_len, g.spec.tp, 10_000.0)
        # a straggling group serves at 1/slow_factor of its profiled
        # bandwidth: publishing the degraded rate shifts dispatch away from
        # it for the fault window (static baselines keep routing blindly)
        return rps / g.slow_factor

    def _sync_scheduler(self, sim) -> None:
        """Incremental scheduler view (ROADMAP): GroupHandles are rebuilt
        ONLY when the group set itself changes (reconfiguration bumps
        `sim._groups_ver`); demand drift refreshes `max_rps` on the existing
        handles in place, and the per-arrival dynamic fields (queue_len, KV
        headroom) are plain in-place writes. With ``reconcile_s`` > 0 the
        dynamic publish is gated to that cadence — dispatch then runs on a
        stale-bounded snapshot (staleness <= reconcile_s), the handles
        carry publish stamps, and KV headroom older than the interval is
        treated as full by the scheduler (kv_stale_s)."""
        gs = self.gs
        rebuild = gs is None or getattr(self, "_sync_ver", None) != sim._groups_ver
        if (
            not rebuild
            and self.reconcile_s > 0.0
            and sim.now - getattr(self, "_last_pub", -math.inf) < self.reconcile_s
        ):
            return
        sig = self._sync_demand_sig(sim)
        if rebuild:
            handles = [
                GroupHandle(
                    g.gid, g.spec.tier, g.spec.stage, g.spec.tp,
                    self._handle_max_rps(sim, g), queue_len=g.queue_len,
                )
                for g in sim.groups
            ]
            if gs is None:
                self.gs = gs = self._mk_scheduler(handles)
            else:
                gs.replace_groups(handles)
            self._sync_ver = sim._groups_ver
            self._sync_sig = sig
        elif sig != getattr(self, "_sync_sig", None):
            gsg = gs.groups
            for g in sim.groups:
                gsg[g.gid].max_rps = self._handle_max_rps(sim, g)
            self._sync_sig = sig
        gsg = gs.groups
        now, ver = sim.now, sim._groups_ver
        for g in sim.groups:
            h = gsg[g.gid]
            h.queue_len = g.queue_len
            h.kv_free_frac = sim.kv_free_frac(g)
            h.kv_stamp_s = now
            h.kv_ver = ver
        self._last_pub = now

    def on_fault(self, sim, event):
        """Forced replan: re-solve the plan over the changed chip pool,
        bypassing the hysteresis streak (a fault is a step change, not
        demand noise). Also invalidates the scheduler's bandwidth signature
        so straggler slowdowns reach the dispatch view immediately.

        Two reactions are part of fault-AWARE planning proper and gated on
        ``resilience_weight`` (the no-resilience ablation keeps the naive
        reaction on both):

        - partial degradation (``chip_straggler`` / ``link_flap``) is a
          planner event only under fault-aware planning: the resilient
          policy re-solves and QUARANTINES the degraded chip
          (``_plan_chips``), while the ablation's planner only hears about
          hard pool changes — its dispatch view sees the slowdown, but the
          gated group keeps running at its slowest chip.
        - ``recovery`` rejoins gently: returned chips come back as shared
          mixed groups — a pure addition that touches no surviving group
          and restarts no in-flight work — and the priced switch criterion
          re-optimizes the layout once the pool is warm (``window``). The
          ablation re-solves the full plan at recovery time, paying a
          restart storm at the exact moment demand is most backlogged."""
        self._gain_streak = 0
        self._sync_sig = None
        if not self.dynamic_tp:
            return super().on_fault(sim, event)
        if event.kind in ("chip_straggler", "link_flap") and not getattr(
            self, "resilience_weight", 0.0
        ):
            return None
        if event.kind == "recovery" and getattr(self, "resilience_weight", 0.0):
            cur = [g.spec for g in sim.groups]
            free = sim.n_chips - sum(s.tp for s in cur)
            tp0 = self.perf.min_tp(self.tps)
            if free < tp0:
                return None
            tp_s = self._shared_tp(sim)
            specs = cur + [GroupSpec(None, "mixed", tp_s)] * (free // tp_s)
            free -= (free // tp_s) * tp_s
            specs += [GroupSpec(None, "mixed", tp0)] * (free // tp0)
            self._cur_specs = specs
            return specs
        specs = self._mk_plan_with_shared(sim)
        self._cur_specs = specs
        return specs

    def route(self, sim, req: SimReq) -> Group:
        if not self.slo_aware:
            return super().route(sim, req)
        self._sync_scheduler(sim)
        rate_cost = 1.0
        for _ in range(2):
            h, feasible = self.gs.dispatch(
                req.tr.tier, rate_cost, req.background,
                now=sim.now, key=tenant_key(req.tr.tenant_id, req.tr.req_id),
            )
            g = sim._by_gid.get(h.gid)
            if g is not None:
                req.feasible = feasible
                req.rate_cost = rate_cost
                req.dispatch_gid = h.gid
                return g
            # stale handle: the group was torn down (fault/teardown race)
            # after the handle snapshot — release the commitment the failed
            # dispatch just took, flag the handle dead, and re-dispatch to
            # a live group instead of dropping the request
            if feasible and not req.background:
                self.gs.complete(h.gid, rate_cost)
            self.gs.mark_dead(h.gid)
        req.feasible = True
        req.rate_cost = 0.0
        req.dispatch_gid = None
        return super().route(sim, req)

    def route_batch(self, sim, reqs: List[SimReq]) -> List[Group]:
        """Batch-vectorized routing (docs/control_plane.md): one scheduler
        sync for the whole arrival batch, then array-scored dispatch over
        the published handle snapshot. Decision semantics match per-request
        ``route``; queue growth inside the batch is tracked on the snapshot
        (the per-arrival sync would have shown each append)."""
        if not self.slo_aware:
            return [super(NitsumPolicy, self).route(sim, r) for r in reqs]
        self._sync_scheduler(sim)
        rate_cost = 1.0
        items = [(r.tr.tier, rate_cost, r.background) for r in reqs]
        keys = [tenant_key(r.tr.tenant_id, r.tr.req_id) for r in reqs]
        picks = self.gs.dispatch_batch(items, now=sim.now, keys=keys)
        out: List[Group] = []
        for r, (h, feasible) in zip(reqs, picks):
            g = sim._by_gid.get(h.gid)
            if g is None:
                # stale handle (teardown race): release the commitment the
                # failed dispatch took and fall back to the scalar path,
                # which retries against live handles
                if feasible and not r.background:
                    self.gs.complete(h.gid, rate_cost)
                self.gs.mark_dead(h.gid)
                out.append(self.route(sim, r))
                continue
            r.feasible = feasible
            r.rate_cost = rate_cost
            r.dispatch_gid = h.gid
            out.append(g)
        return out


class OraclePolicy(Policy):
    """Per-window best static configuration (uniform mixed / disaggregated /
    tier-partitioned), zero switch cost — the paper's Fig. 3 'Optimal'
    upper bound."""

    name = "oracle"
    reconfigures = True
    slo_aware_prefill = True

    def _best(self, sim) -> List[GroupSpec]:
        """Rank candidate static layouts (uniform mixed / tier-partitioned,
        per TP level) with the SAME estimator the hysteresis uses — two
        disagreeing estimators made the oracle flip configs at saturation,
        restarting in-flight prefills every window."""
        tier_names = [t.name for t in self.tiers.values() if not t.background]
        cands = []
        for tp in self.tps:
            n = sim.n_chips // tp
            if n < 1 or not self.perf.fits(tp):
                continue
            cands.append([GroupSpec(None, "mixed", tp)] * n)
            if n >= len(tier_names):
                cands.append([
                    GroupSpec(tier_names[i % len(tier_names)], "mixed", tp)
                    for i in range(n)
                ])
        if not cands:
            tp0 = self.perf.min_tp(self.tps)
            return [GroupSpec(None, "mixed", tp0)] * (sim.n_chips // tp0)
        return max(cands, key=lambda s: self.estimate_specs(sim, s))

    def initial_specs(self, sim):
        self._cur = self._best(sim)
        return self._cur

    def window(self, sim):
        new = self._best(sim)
        cur = getattr(self, "_cur", None)
        if cur is not None:
            # hysteresis: even a zero-cost switch restarts in-flight prefills
            if self.estimate_specs(sim, new) < 1.10 * self.estimate_specs(sim, cur):
                return None
        self._cur = new
        return new


# ===========================================================================
# Simulator
# ===========================================================================
@dataclass
class SimResult:
    """Summary of one simulated replay (what benchmarks/tests consume)."""

    policy: str
    goodput: float
    per_tier_goodput: Dict[str, float]
    spills: Dict[str, int]  # per-tier KV-backpressure admission spills
    finished: int
    reconfig_count: int
    timeline: List[Tuple[float, float]]
    spill_timeline: List[Tuple[float, int]]
    # (t, cumulative reconfigurations) per second — the scenario matrix
    # plots reconfiguration activity against the workload's phase structure
    reconfig_timeline: List[Tuple[float, int]] = field(default_factory=list)
    # windows where a switch candidate cleared the policy's gain threshold
    # (applied or not): reconfig_count/switch_considered is the hysteresis
    # acceptance rate the tier_drift calibration question needs
    switch_considered: int = 0
    # ---- fault/recovery accounting (docs/faults.md) ----
    # one entry per applied FaultEvent: kind, fire time, victims, chips
    # lost/restored, sequences restarted
    fault_timeline: List[dict] = field(default_factory=list)
    # per-tier count of resident sequences force-restarted by faults
    fault_restarts: Dict[str, int] = field(default_factory=dict)
    # checkpointed-KV partial restarts (docs/faults.md §Checkpointed
    # restart): kills that restored a host-offloaded snapshot instead of
    # re-prefilling, the tokens those snapshots carried, and the
    # re-prefill/regeneration seconds the restores saved net of the
    # priced restore transfer
    ckpt_restores: int = 0
    ckpt_restored_tokens: float = 0.0
    ckpt_saved_prefill_s: float = 0.0
    # per-incident recovery metrics (core/incidents.py): baseline goodput,
    # dip depth/width, time-to-recover, per-tier SLO damage
    incidents: List[dict] = field(default_factory=list)
    # per-tier (t, SLO-good finishes in the last second) series — what the
    # per-tier SLO-damage numbers in `incidents` are computed from
    tier_timelines: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict
    )
    # ---- per-tenant accounting (docs/tenancy.md) ----
    # SLO-good req/s per tenant (every tenant seen, even at 0)
    tenant_goodput: Dict[str, float] = field(default_factory=dict)
    # arrivals denied at the admission gate (one per denied first attempt)
    tenant_throttled: Dict[str, int] = field(default_factory=dict)
    # retry-heap pops (a request throttled twice retries twice)
    tenant_retries: Dict[str, int] = field(default_factory=dict)
    # requests demoted to best-effort after exhausting their retries
    tenant_demoted: Dict[str, int] = field(default_factory=dict)

    @property
    def spill_total(self) -> int:
        return sum(self.spills.values())

    @property
    def fault_restart_total(self) -> int:
        return sum(self.fault_restarts.values())


class Simulator:
    def __init__(
        self,
        perf: PerfModel,
        tiers: Sequence[SLOTier],
        n_chips: int,
        policy: Policy,
        dt: float = 0.02,
        window_s: float = 1.0,
        monitor_window_s: float = 10.0,
        engine: str = "event",
        ctx_refresh_frac: float = 0.02,
        grid_parity: bool = True,
        kv_watermark: float = 0.9,
        kv_audit: bool = False,
        ctx_ewma_tau_s: float = 5.0,
        cap_drift_frac: float = 0.05,
        admission=None,
        kv_checkpoint: bool = False,
        ckpt_interval_tokens: int = 64,
        ckpt_restore_bps: float = 1e9,
        topology: Optional[Topology] = None,
    ):
        if engine != "event":
            raise ValueError(
                f"unknown engine {engine!r}: the fluid reference engine was "
                "retired (docs/simulator.md); only 'event' remains, gated by "
                "the recorded golden trajectories in "
                "repro_torch.testing.sim_equivalence"
            )
        self.perf = perf
        self.tiers = {t.name: t for t in tiers}
        # n_chips tracks the LIVE pool: chip/host-loss faults shrink it,
        # recoveries restore it (never beyond chips_total, the provisioned
        # size). Policies plan against n_chips, so a forced replan after a
        # fault naturally solves over the degraded pool.
        self.n_chips = n_chips
        self.chips_total = n_chips
        self.policy = policy
        self.dt = dt
        self.window_s = window_s
        self.monitor_window_s = monitor_window_s
        self.engine = engine
        self.ctx_refresh_frac = ctx_refresh_frac
        # KV admission backpressure: a prefill is spilled (re-routed, or
        # demoted to best-effort when no group has headroom) when its
        # target's projected occupancy would cross kv_watermark × capacity
        self.kv_watermark = kv_watermark
        self.kv_audit = kv_audit
        # realized-context cap design (docs/simulator.md §Decode-caps):
        # per-group context EWMA time constant, and the relative context
        # drift beyond which refresh_cap re-derives the batch cap
        self.ctx_ewma_tau_s = ctx_ewma_tau_s
        self.cap_drift_frac = cap_drift_frac
        self.spill_counts: Dict[str, int] = {t.name: 0 for t in tiers}
        self.spill_timeline: List[Tuple[float, int]] = []
        self.reconfig_timeline: List[Tuple[float, int]] = []
        # grid parity (event engine only): admit arrivals and stamp decode
        # finishes on the fluid engine's dt grid, so the two engines differ
        # only by the analytic-integration error, not by discretization
        # artifacts the fluid reference itself introduces (docs/simulator.md)
        self.grid_parity = grid_parity
        self.now = 0.0
        self.groups: List[Group] = []
        self._gid = 0
        self._by_gid: Dict[int, Group] = {}
        self._groups_ver = 0  # bumped whenever the group set changes
        self._bg_tiers = {t.name for t in tiers if t.background}
        self.meter = GoodputMeter(self.tiers)
        self.finished: List[SimReq] = []
        self.recent: deque = deque()  # (arrival_s, tier, plen, olen)
        # incremental per-tier rolling sums over the monitor window:
        # tier -> [count, sum_prompt, sum_output]
        self._tier_sums: Dict[str, List[float]] = {}
        self._stats_ver = 0  # bumped on every push/expire
        self._stats_cache: Dict[Optional[str], tuple] = {}
        self.timeline: List[Tuple[float, float]] = []  # (t, goodput in window)
        self._win_good = 0
        self.last_planning_ms = 0.0
        self.reconfig_count = 0
        self.switch_considered = 0
        # fleet composition (serving/fleet.py): set by FleetSimulator when
        # this cell joins a fleet — enables cross-cell spill ahead of the
        # intra-cell demote, and external (fleet-clock) arrival admission
        self._fleet = None
        # arrival batches below this size route through the scalar path
        # (snapshot construction would cost more than it saves)
        self.batch_route_min = 4
        self._tier_defaults: Dict[Optional[str], TierDemand] = {}
        # fault machinery (docs/faults.md)
        # failure-domain tree + chip identity: chips are ints
        # 0..chips_total-1; _free_chips = live chips held by no group,
        # _down_chips = failed chips awaiting a recovery, _chip_slow =
        # per-chip slowdown factors (group slow_factor = max over members).
        # Invariant: n_chips == chips_total - len(_down_chips).
        self.topology = topology or Topology()
        self._free_chips: List[int] = list(range(n_chips))
        self._down_chips: set = set()
        self._chip_slow: Dict[int, float] = {}
        self._alloc_ctr = 0  # round-robin power-domain start for placement
        # checkpointed KV / partial restart (docs/faults.md §Checkpointed
        # restart): OFF by default — the recorded goldens embed full
        # re-prefill restart semantics. When on, a killed decode-phase
        # sequence restores its host-offloaded KV snapshot (latest
        # ckpt_interval_tokens multiple) at ckpt_restore_bps instead of
        # re-prefilling, whenever the priced restore beats regeneration.
        self.kv_checkpoint = kv_checkpoint
        self.ckpt_interval_tokens = max(int(ckpt_interval_tokens), 1)
        self.ckpt_restore_bps = ckpt_restore_bps
        self.ckpt_restores = 0
        self.ckpt_restored_tokens = 0.0
        self.ckpt_saved_prefill_s = 0.0
        # sequences stranded while the pool is below the model's minimum
        # TP (a deep cascade can leave no feasible group): parked until a
        # recovery rebuilds the pool, SLO clocks still running
        self._parked: List[SimReq] = []
        self.fault_log: List[dict] = []
        self.fault_restarts: Dict[str, int] = {t.name: 0 for t in tiers}
        self.tier_timelines: Dict[str, List[Tuple[float, float]]] = {
            t.name: [] for t in tiers
        }
        self._tier_win_good: Dict[str, int] = {t.name: 0 for t in tiers}
        self._fault_heap: List[tuple] = []  # (t, seq, FaultEvent | end-marker)
        # per-tenant token-budget admission (docs/tenancy.md): None means
        # no gate — every admission-path branch below is skipped and the
        # engine's event trace is bit-identical to the pre-tenant code
        self.admission = admission
        self.tenant_throttled: Dict[str, int] = {}
        self.tenant_retries: Dict[str, int] = {}
        self.tenant_demoted: Dict[str, int] = {}
        self._retry_heap: List[tuple] = []  # (t, seq, SimReq, tries)
        # event-engine machinery
        self._heap: List[tuple] = []
        self._seq = count()

    # ---- bookkeeping ---------------------------------------------------
    def decode_cap(self, spec: GroupSpec, group: Optional[Group] = None) -> int:
        """Decode batch cap for a group spec (delegates to the policy).
        With ``group``, the cap also reflects the group's live KV occupancy
        and the batch's current mean context."""
        return self.policy.decode_cap(self, spec, group)

    def result(self, horizon_s: float) -> SimResult:
        return SimResult(
            policy=self.policy.name,
            goodput=self.meter.goodput(horizon_s),
            per_tier_goodput=self.meter.per_tier_goodput(horizon_s),
            spills=dict(self.spill_counts),
            finished=len(self.finished),
            reconfig_count=self.reconfig_count,
            switch_considered=self.switch_considered,
            timeline=list(self.timeline),
            spill_timeline=list(self.spill_timeline),
            reconfig_timeline=list(self.reconfig_timeline),
            fault_timeline=list(self.fault_log),
            fault_restarts=dict(self.fault_restarts),
            ckpt_restores=self.ckpt_restores,
            ckpt_restored_tokens=self.ckpt_restored_tokens,
            ckpt_saved_prefill_s=self.ckpt_saved_prefill_s,
            incidents=analyze_incidents(
                self.timeline, self.tier_timelines, self.fault_log, horizon_s
            ),
            tier_timelines={t: list(tl) for t, tl in self.tier_timelines.items()},
            tenant_goodput=self.meter.per_tenant_goodput(horizon_s),
            tenant_throttled=dict(self.tenant_throttled),
            tenant_retries=dict(self.tenant_retries),
            tenant_demoted=dict(self.tenant_demoted),
        )

    def group_by_id(self, gid: int) -> Group:
        g = self._by_gid.get(gid)
        if g is not None:
            return g
        # stale gid (group torn down since the caller snapshotted it): fall
        # back to a live prefill-capable group, never an arbitrary one —
        # the old groups[0] fallback could hand a decode-only group a
        # prefill and strand it
        for g in self.groups:
            if g.spec.stage in ("prefill", "mixed"):
                return g
        return self.groups[0]

    def _recent_push(self, tr: TraceRequest) -> None:
        self.recent.append((tr.arrival_s, tr.tier, tr.prompt_len, tr.output_len))
        s = self._tier_sums.setdefault(tr.tier, [0, 0, 0])
        s[0] += 1
        s[1] += tr.prompt_len
        s[2] += tr.output_len
        self._stats_ver += 1

    def _recent_expire(self) -> None:
        cut = self.now - self.monitor_window_s
        recent = self.recent
        while recent and recent[0][0] < cut:
            _, tier, p, o = recent.popleft()
            s = self._tier_sums[tier]
            s[0] -= 1
            s[1] -= p
            s[2] -= o
            self._stats_ver += 1

    def tier_stats(self, tier: Optional[str]) -> TierDemand:
        self._recent_expire()
        hit = self._stats_cache.get(tier)
        if hit is not None and hit[0] == self._stats_ver:
            return hit[1]
        d = self._tier_stats_compute(tier)
        self._stats_cache[tier] = (self._stats_ver, d)
        return d

    def _tier_stats_compute(self, tier: Optional[str]) -> TierDemand:
        if tier is None:
            n = sum(s[0] for s in self._tier_sums.values())
            sp = sum(s[1] for s in self._tier_sums.values())
            so = sum(s[2] for s in self._tier_sums.values())
        else:
            s = self._tier_sums.get(tier)
            n, sp, so = (s if s else (0, 0, 0))
        if not n:
            return self._tier_defaults.get(
                tier, TierDemand(rps=0.0, prompt_len=1024, output_len=128)
            )
        span = max(self.monitor_window_s, 1e-6)
        return TierDemand(rps=n / span, prompt_len=int(sp / n), output_len=int(so / n))

    # ---- chip identity (docs/faults.md §Failure domains) -----------------
    def _group_slow_factor(self, chips) -> float:
        """A TP group is gated by its slowest member chip."""
        cs = self._chip_slow
        if not cs:
            return 1.0
        return max((cs.get(c, 1.0) for c in chips), default=1.0)

    def _alloc_chips(self, tp: int) -> Tuple[int, ...]:
        """Assign ``tp`` chips to a new group: healthy (non-degraded)
        chips first, scanned from a rotating power-domain offset so
        consecutive groups — hence a plan's tiers — spread across failure
        domains and a domain loss strands fewer whole tiers.
        Deterministic given the allocation history, so replays of one
        (trace, seed) stay bit-identical."""
        free = sorted(self._free_chips)
        nd = max(self.topology.n_domains(self.chips_total), 1)
        start = self._alloc_ctr % nd
        self._alloc_ctr += 1
        dom = self.topology.domain_of
        slow = self._chip_slow
        order = sorted(
            free, key=lambda c: (c in slow, (dom(c) - start) % nd, c)
        )
        take = set(order[:tp])
        self._free_chips = [c for c in free if c not in take]
        return tuple(sorted(take))

    def _release_chips(self, chips) -> None:
        down = self._down_chips
        have = set(self._free_chips)
        self._free_chips.extend(
            c for c in chips if c not in down and c not in have
        )

    def _apply_specs(
        self, specs: List[GroupSpec], charge_cost: bool, reload_s: float = 0.0
    ) -> None:
        """``reload_s`` > 0 models a recovery weight-reload storm: newly
        created groups (chips rejoining the pool, or groups re-formed
        around them) must load weights from host storage before serving —
        they block for at least that long on top of the policy's own
        switch cost. Groups whose spec survives the reconfiguration are
        kept as-is and pay nothing."""
        old = self.groups
        key = lambda s: (s.tier or "", s.stage, s.tp)
        if old and sorted(specs, key=key) == sorted((g.spec for g in old), key=key):
            return  # hysteresis: same multiset of groups, no reconfiguration
        self.reconfig_count += bool(old)
        for g in old:
            g.decode.sync()  # switch-cost estimation reads r.ctx below
        # keep groups whose spec survives; rebuild the rest
        pool = list(old)
        plan: List = []  # kept Group, or GroupSpec still to build
        for spec in specs:
            match = next((g for g in pool if g.spec == spec), None)
            if match is not None:
                pool.remove(match)
                plan.append(match)
            else:
                plan.append(spec)
        # dissolved groups hand their chips back first, so rebuilt groups
        # can re-seat on them (chip identity: a rebuilt group inheriting a
        # degraded chip inherits its slowdown)
        for g in pool:
            self._release_chips(g.chips)
        new_groups: List[Group] = []
        for item in plan:
            if isinstance(item, Group):
                new_groups.append(item)
                continue
            g = Group(self._gid, item, self)
            self._gid += 1
            g.chips = self._alloc_chips(item.tp)
            g.slow_factor = self._group_slow_factor(g.chips)
            if charge_cost and old:
                g.blocked_until = self.now + max(
                    self.policy.switch_cost_s(self, g), reload_s
                )
            new_groups.append(g)
        # redistribute requests from dissolved groups
        orphans: List[SimReq] = []
        for g in pool:
            cost = self.policy.switch_cost_s(self, g) if charge_cost else 0.0
            for r in g.clear():
                r._penalty = cost  # noqa: attached transient
                orphans.append(r)
        self.groups = new_groups
        self._by_gid = {g.gid: g for g in new_groups}
        self._groups_ver += 1
        # flag dissolved groups in the scheduler view immediately — dispatch
        # between this teardown and the next handle rebuild must not route
        # to a gid that no longer exists (the stale-handle bug)
        gs = getattr(self.policy, "gs", None)
        if gs is not None:
            for g in pool:
                gs.mark_dead(g.gid)
        for r in orphans:
            if r.tokens > 0 or r.first_token_s is not None:
                tgt = self.policy.decode_target(self, r, self.groups[0])
                tgt.add_decode(r)
                tgt._kv_charge(tgt._kv_ctx(r), 1)  # KV migrated with the request
                tgt.blocked_until = max(
                    tgt.blocked_until, self.now + r._penalty
                )
            else:
                # queued/in-flight prefills restart from scratch: no KV yet
                tgt = self.policy.route(self, r)
                tgt.prefill_q.append(r)
            r.group = tgt

    # ---- event hooks -----------------------------------------------------
    def on_prefill_done(self, req: SimReq, group: Group, t: float) -> None:
        req.first_token_s = t
        req.tokens = 1.0
        req.group = group
        # the first generated token's KV (window models at a saturated
        # prompt evict one prompt token for it: net zero residency)
        group._kv_charge(
            1.0 if req.tr.prompt_len < group._kv_win else 0.0, 0
        )
        if req.dispatch_gid is not None and isinstance(self.policy, NitsumPolicy):
            if self.policy.gs is not None:
                self.policy.gs.complete(req.dispatch_gid, req.rate_cost)
        if req.tr.output_len <= 1:
            req.finish_s = t
            self.on_finish(req)
            return
        tgt = self.policy.decode_target(self, req, group)
        if tgt is not group:
            # KV migrates with the request (pipelined; the switch-cost
            # model charges reconfiguration migrations, not hand-offs)
            ctx = group._kv_ctx(req)
            group._kv_charge(-ctx, -1)
            tgt._kv_charge(ctx, 1)
        if tgt is not group:
            tgt.advance_to(self.now)
            touched = tgt.add_decode(req)
            req.group = tgt
            if tgt._ev_kind == "decode" and not touched:
                # newcomer went to the waiting heap; the armed event on the
                # (unchanged) running batch is still valid
                return
            self._schedule_group(tgt)
            return
        tgt.add_decode(req)
        req.group = tgt

    def on_finish(self, req: SimReq) -> None:
        if req.group is not None:
            g = req.group
            g._kv_charge(-g._kv_ctx(req), -1)  # release the sequence's KV
        self.finished.append(req)
        rec = RequestRecord(
            req.tr.req_id, req.tr.tier, req.tr.arrival_s, req.tr.prompt_len,
            req.tr.output_len, req.first_token_s, req.finish_s,
            int(req.tr.output_len), tenant_id=req.tr.tenant_id,
        )
        self.meter.add(rec)
        if self.meter.meets_slo(rec):
            self._win_good += 1
            tw = self._tier_win_good
            tw[req.tr.tier] = tw.get(req.tr.tier, 0) + 1

    # ---- shared run setup ------------------------------------------------
    def _setup(
        self, workload: Workload, demand_scale: float = 1.0
    ) -> List[TraceRequest]:
        """``demand_scale`` < 1 sizes the initial plan for a fraction of the
        workload's rate — a fleet cell plans for its share of the admitted
        stream, not the whole front-door trace."""
        for t in self.tiers.values():
            sub = [r for r in workload.requests if r.tier == t.name]
            if sub:
                self._tier_defaults[t.name] = TierDemand(
                    rps=len(sub) / workload.horizon_s * demand_scale,
                    prompt_len=int(np.mean([r.prompt_len for r in sub])),
                    output_len=int(np.mean([r.output_len for r in sub])),
                )
        self._tier_defaults[None] = TierDemand(
            rps=workload.rps * demand_scale,
            prompt_len=int(np.mean([r.prompt_len for r in workload.requests])),
            output_len=int(np.mean([r.output_len for r in workload.requests])),
        )
        self._apply_specs(self.policy.initial_specs(self), charge_cost=False)
        return sorted(workload.requests, key=lambda r: r.arrival_s)

    # ---- KV admission backpressure ---------------------------------------
    def kv_free_frac(self, g: Group) -> float:
        """Fraction of the group's watermarked KV budget still free after
        projecting queued prefills."""
        budget = self.kv_watermark * g.kv_capacity_bytes
        if budget <= 0:
            return 0.0
        return max(budget - g.kv_projected_bytes(), 0.0) / budget

    def _kv_backpressure(
        self, req: SimReq, g: Group, fleet_ok: bool = True
    ) -> Optional[Group]:
        """Admission control at arrival: if the routed group's projected
        occupancy (live KV + queued prompts + this prompt) crosses the
        watermark, the prefill spills — re-routed to the compatible group
        with the most projected headroom; failing that, offered to the
        fleet as a cross-cell spill (returns None when another cell takes
        it); only when no cell anywhere has headroom is it demoted to
        best-effort so it sinks in the priority queue. Either way the
        per-tier spill counter increments."""
        perf = self.perf
        if perf.kv_bytes_per_token() <= 0 and perf.state_bytes() <= 0:
            return g  # O(1)-state model: no KV pressure to model
        # window-clamped, consistent with the capacity model and the
        # occupancy charges
        need = perf.seq_kv_bytes(req.tr.prompt_len)
        g.advance_to(self.now)  # occupancy integrated up to the arrival
        if g.kv_projected_bytes() + need <= self.kv_watermark * g.kv_capacity_bytes:
            return g
        self.spill_counts[req.tr.tier] = self.spill_counts.get(req.tr.tier, 0) + 1
        tier = req.tr.tier
        best, best_free = None, 0.0
        for cand in self.groups:
            if cand is g or cand.spec.stage not in ("prefill", "mixed"):
                continue
            if cand.spec.tier not in (None, tier):
                continue
            cand.advance_to(self.now)
            free = (
                self.kv_watermark * cand.kv_capacity_bytes
                - cand.kv_projected_bytes()
            )
            if free >= need and free > best_free:
                best, best_free = cand, free
        if best is not None:
            # keep the global scheduler's bandwidth view consistent with
            # the actual placement: move the dispatch commitment (and the
            # completion target) from the original group to the new one
            gs = getattr(self.policy, "gs", None)
            if gs is not None and req.dispatch_gid == g.gid:
                gs.complete(g.gid, req.rate_cost)
                h = gs.groups.get(best.gid)
                if h is not None:
                    h.committed_rps += req.rate_cost
                req.dispatch_gid = best.gid
            return best
        # cross-cell spill (docs/control_plane.md): before demoting, offer
        # the request to the fleet — first-choice overflow path when this
        # cell is at the watermark but a sibling cell has headroom
        if fleet_ok and self._fleet is not None:
            if self._fleet._take_spill(self, req):
                return None
        req.feasible = False  # no headroom anywhere: best-effort spill
        return g

    # ---- per-tenant token-budget admission (docs/tenancy.md) -------------
    def _admission_gate(self, tr: TraceRequest) -> bool:
        """Token-budget gate ahead of routing. Admitted → True (and only
        then does the request count toward the planner's demand stats).
        Throttled → False: the request is parked on the retry heap with a
        priced delay (token deficit / refill rate) for delay-and-retry."""
        if tr.tier in self._bg_tiers:
            return True  # background work is already residual-capacity-only
        adm = self.admission
        cost = tr.prompt_len + tr.output_len
        if adm.try_admit(tr.tenant_id, cost, self.now):
            return True
        t = tr.tenant_id
        self.tenant_throttled[t] = self.tenant_throttled.get(t, 0) + 1
        req = SimReq(tr, background=False)
        delay = adm.retry_delay_s(t, cost, self.now)
        heapq.heappush(
            self._retry_heap, (self.now + delay, next(self._seq), req, 1)
        )
        return False

    def _retry_admit(self, req: SimReq, tries: int) -> None:
        """One retry-heap pop: re-offer the request to its tenant's bucket.
        Admitted → route + place as if it had just arrived (SLO clock kept
        from the original arrival). Still throttled → re-park, up to the
        budget's retry bound; then demote to best-effort — the spill
        path's third option, after delay and before outright service as
        infeasible work."""
        adm = self.admission
        tr = req.tr
        tenant = tr.tenant_id
        cost = tr.prompt_len + tr.output_len
        self.tenant_retries[tenant] = self.tenant_retries.get(tenant, 0) + 1
        if adm.try_admit(tenant, cost, self.now):
            self._recent_push(tr)
            g = self._route_or_park(req)
            if g is not None:
                self._place(req, g)
            return
        if tries < adm.max_retries(tenant):
            delay = adm.retry_delay_s(tenant, cost, self.now)
            heapq.heappush(
                self._retry_heap,
                (self.now + delay, next(self._seq), req, tries + 1),
            )
            return
        # retries exhausted: serve best-effort (sinks in prefill_priority)
        self.tenant_demoted[tenant] = self.tenant_demoted.get(tenant, 0) + 1
        self._recent_push(tr)
        g = self._route_or_park(req)
        if g is None:
            return
        gs = getattr(self.policy, "gs", None)
        if gs is not None and req.feasible and req.dispatch_gid is not None:
            # release the bandwidth the route just committed: a demoted
            # request must not crowd the tier's SLO budget
            gs.complete(req.dispatch_gid, req.rate_cost)
        req.rate_cost = 0.0
        req.feasible = False
        req.demoted = True
        self._place(req, g)

    def _route_or_park(self, req: SimReq) -> Optional[Group]:
        """Route through the policy — unless a deep cascade left the pool
        with no feasible group at all, in which case the request parks
        with the fault orphans until a recovery rebuilds the pool (its
        SLO clock keeps running; most parked work misses SLO, which is
        exactly the outage's cost)."""
        if not self.groups:
            req.group = None
            self._parked.append(req)
            return None
        return self.policy.route(self, req)

    def _admit(self, tr: TraceRequest) -> None:
        if self.admission is not None and not self._admission_gate(tr):
            return
        self._recent_push(tr)
        req = SimReq(tr, background=tr.tier in self._bg_tiers)
        g = self._route_or_park(req)
        if g is None:
            return
        self._place(req, g)

    def _place(self, req: SimReq, g: Group) -> None:
        if (
            not req.feasible
            and not req.background
            and not req.demoted
            and self._fleet is not None
        ):
            # bandwidth-infeasible here, but a sibling cell may have SLO
            # headroom: cross-cell spill before demoting (ROADMAP item 2's
            # bandwidth follow-on; KV pressure spills below as before)
            if self._fleet._take_bw_spill(self, req):
                return
        g = self._kv_backpressure(req, g)
        if g is None:
            return  # cross-cell spill: another cell admitted the request
        if g._ev_kind not in ("prefill", "unblock"):
            # an armed prefill/unblock event is unaffected by a queue append;
            # otherwise (idle, or decoding that prefill now preempts) re-arm
            g.advance_to(self.now)
            g.prefill_q.append(req)
            req.group = g
            self._schedule_group(g)
            return
        g.prefill_q.append(req)
        req.group = g

    def _admit_batch(self, batch: Sequence[TraceRequest]) -> None:
        """Admit one same-tick arrival batch. Batches at or above
        ``batch_route_min`` go through the policy's vectorized
        ``route_batch`` (one scheduler sync + array-scored dispatch);
        smaller ones take the scalar path where the snapshot would cost
        more than it saves."""
        route_batch = getattr(self.policy, "route_batch", None)
        if not self.groups:
            route_batch = None  # scalar path parks each request
        if route_batch is None or len(batch) < self.batch_route_min:
            for tr in batch:
                self._admit(tr)
            return
        if self.admission is not None:
            batch = [tr for tr in batch if self._admission_gate(tr)]
            if not batch:
                return
        reqs = []
        for tr in batch:
            self._recent_push(tr)
            reqs.append(SimReq(tr, background=tr.tier in self._bg_tiers))
        for req, g in zip(reqs, route_batch(self, reqs)):
            self._place(req, g)

    def _admit_transfer(self, req: SimReq) -> None:
        """Admit a request handed off by the fleet (cross-cell spill):
        route inside this cell and place it. Re-spilling back out is
        suppressed by the fleet's in-progress guard."""
        self._recent_push(req.tr)
        g = self._route_or_park(req)
        if g is None:
            return
        self._place(req, g)

    # ---- fault injection (docs/faults.md) --------------------------------
    def _pick_victims(self, seed: int, chips: int) -> List[Group]:
        """Deterministic victim selection: a seeded permutation over the
        groups (sorted by gid — insertion order is an implementation
        detail), accumulating whole groups until ``chips`` are covered."""
        pool = sorted(self.groups, key=lambda g: g.gid)
        if not pool:
            return []
        order = np.random.RandomState(seed).permutation(len(pool))
        victims: List[Group] = []
        got = 0
        for idx in order:
            if got >= chips:
                break
            victims.append(pool[idx])
            got += pool[idx].spec.tp
        return victims

    def _fault_restart(self, r: SimReq) -> None:
        """Re-admit a sequence whose group died or dumped its KV: full
        restart semantics — the prompt must re-prefill from token zero
        (its KV is gone) while the SLO clock keeps running from the
        original arrival. Routing goes through the policy + the PR-2
        admission/spill path, so restart storms spread by KV headroom and
        demote to best-effort exactly like arrival bursts do.

        With ``kv_checkpoint`` on (docs/faults.md §Checkpointed restart),
        a decode-phase victim holds a host-offloaded snapshot of its KV
        (prompt KV at first token, then every ``ckpt_interval_tokens``
        decoded tokens). If restoring that snapshot at
        ``ckpt_restore_bps`` is cheaper than regenerating it, the kill
        becomes a partial replay: the sequence resumes decode at the
        snapshot token after a priced restore delay — no re-prefill.
        Demoted/best-effort sequences restore the same way (PR 9's
        host-offload follow-on): the snapshot exists regardless of class."""
        gs = getattr(self.policy, "gs", None)
        if gs is not None and r.dispatch_gid is not None and r.first_token_s is None:
            # the request never reached on_prefill_done, so its dispatch
            # commitment is still held — release it before re-dispatching
            gs.complete(r.dispatch_gid, r.rate_cost)
        r.dispatch_gid = None
        if not self.groups:
            # nowhere to run (pool below min TP): park until a recovery
            # re-forms groups — _apply_fault drains the parked list
            r.group = None
            self._parked.append(r)
            return
        if self.kv_checkpoint and r.first_token_s is not None and self.groups:
            iv = self.ckpt_interval_tokens
            ckpt = math.floor(r.tokens / iv) * iv
            prompt = r.tr.prompt_len
            restore_s = self.perf.seq_kv_bytes(prompt + ckpt) / self.ckpt_restore_bps
            tp_ref = (
                r.group.spec.tp if r.group is not None else self.groups[0].spec.tp
            )
            tier = self.tiers.get(r.tr.tier)
            tpot_s = tier.tpot_ms / 1e3 if tier is not None else 0.02
            regen_s = self.perf.prefill_time_s(prompt, tp_ref) + ckpt * tpot_s
            if restore_s < regen_s:
                self.ckpt_restores += 1
                self.ckpt_restored_tokens += prompt + ckpt
                self.ckpt_saved_prefill_s += regen_s - restore_s
                r.tokens = max(float(ckpt), 1.0)  # first token survived too
                r.prefill_left_s = 0.0
                r._penalty = 0.0
                r.group = None
                heapq.heappush(
                    self._fault_heap,
                    (self.now + restore_s, next(self._seq), ("ckpt_restore", r)),
                )
                return
        r.tokens = 0.0
        r.first_token_s = None
        r.prefill_left_s = 0.0
        r._penalty = 0.0
        r.group = None
        if not r.background:
            r.feasible = True
        self.fault_restarts[r.tr.tier] = self.fault_restarts.get(r.tr.tier, 0) + 1
        g = self.policy.route(self, r)
        # fleet_ok=False: restart storms stay intra-cell — the restarted
        # sequence's SLO clock is already running and a cross-cell hand-off
        # mid-incident would hide the victim cell's recovery cost
        g = self._kv_backpressure(r, g, fleet_ok=False)
        g.prefill_q.append(r)
        r.group = g

    def _kill_groups(self, victims: List[Group]) -> List[SimReq]:
        """Tear down groups (fault path): collect their resident sequences,
        drop them from the pool, and flag their scheduler handles dead.
        Restarting the orphans is the caller's job — it happens AFTER the
        policy's forced replan, so restarts route into the new layout."""
        dead = {g.gid for g in victims}
        orphans: List[SimReq] = []
        for g in victims:
            orphans.extend(g.clear())
            g._epoch += 1  # invalidate any armed heap events
        self.groups = [g for g in self.groups if g.gid not in dead]
        self._by_gid = {g.gid: g for g in self.groups}
        self._groups_ver += 1
        gs = getattr(self.policy, "gs", None)
        if gs is not None:
            for gid in dead:
                gs.mark_dead(gid)
        return orphans

    def _resolve_domain_host(self, ev) -> Optional[int]:
        """Resolve a domain-scoped event to one victim host. Events of one
        cascade share ``ev.seed``, so every wave lands in the SAME
        rack/power domain; ``ev.wave`` walks a seeded permutation of the
        member hosts — a rack/power cascade fans out host by host."""
        topo, total = self.topology, self.chips_total
        n_hosts = topo.n_hosts(total)
        if n_hosts <= 0:
            return None
        wave = max(ev.wave, 0)
        if ev.domain == "host":
            perm = np.random.RandomState(ev.seed).permutation(n_hosts)
            return int(perm[wave % n_hosts])
        hosts = self._domain_unit_hosts(ev)
        perm = np.random.RandomState(ev.seed + 1).permutation(len(hosts))
        return int(hosts[perm[wave % len(hosts)]])

    def _domain_unit_hosts(self, ev) -> Tuple[int, ...]:
        topo, total = self.topology, self.chips_total
        if ev.domain == "rack":
            rack = int(np.random.RandomState(ev.seed).randint(topo.n_racks(total)))
            return topo.rack_hosts(rack, total)
        if ev.domain == "power":
            dom = int(np.random.RandomState(ev.seed).randint(topo.n_domains(total)))
            return topo.domain_hosts(dom, total)
        raise ValueError(f"unknown fault domain {ev.domain!r}")

    def _domain_loss_chips(self, ev) -> List[int]:
        host = self._resolve_domain_host(ev)
        if host is None:
            return []
        down = self._down_chips
        return [
            c for c in self.topology.host_chips(host, self.chips_total)
            if c not in down
        ]

    def _domain_recovery_chips(self, ev) -> List[int]:
        """Chips a domain-scoped recovery restores: the down chips of the
        cascade's unit (its host for ``domain="host"``; the whole rack /
        power domain otherwise — one repair brings the unit back), capped
        at ``ev.chips`` when the spec asks for a partial restore."""
        topo, total = self.topology, self.chips_total
        if ev.domain == "host":
            host = self._resolve_domain_host(ev)
            unit = topo.host_chips(host, total) if host is not None else ()
        else:
            unit = [
                c for h in self._domain_unit_hosts(ev)
                for c in topo.host_chips(h, total)
            ]
        down = self._down_chips
        out = sorted(c for c in unit if c in down)
        if ev.chips > 0:
            out = out[: ev.chips]
        return out

    def _set_chip_slow(self, chip: int, slow: float) -> None:
        """Mark one chip degraded; the group holding it runs at the
        slowest member (flaky-link on-window, chip straggler start)."""
        self._chip_slow[chip] = max(slow, 1.0)
        for g in self.groups:
            if chip in g.chips:
                g.advance_to(self.now)
                g.slow_factor = self._group_slow_factor(g.chips)
                self._schedule_group(g)
        if hasattr(self.policy, "_sync_sig"):
            self.policy._sync_sig = None  # republish degraded bandwidth

    def _end_chip_slow(self, chips, log: bool) -> None:
        """Clear degradation on ``chips`` — matched by chip identity, not
        group handle, so a victim group dissolved and rebuilt by a
        mid-incident replan still recovers (the rebuilt group inherits
        the chips, and this clears them wherever they now live)."""
        for c in chips:
            self._chip_slow.pop(c, None)
        chip_set = set(chips)
        affected = [
            g for g in self.groups if chip_set.intersection(g.chips)
        ]
        for g in affected:
            g.advance_to(self.now)
            g.slow_factor = self._group_slow_factor(g.chips)
            self._schedule_group(g)
        if log and affected:
            self.fault_log.append({
                "t": self.now, "kind": "straggler_end",
                "victim_gids": sorted(g.gid for g in affected),
            })
        if affected and hasattr(self.policy, "_sync_sig"):
            self.policy._sync_sig = None  # republish full bandwidth

    def _straggle_chip_of(self, ev, g: Group) -> Optional[int]:
        if not g.chips:
            return None
        idx = int(np.random.RandomState(ev.seed + 5).randint(len(g.chips)))
        return g.chips[idx]

    def _apply_fault(self, ev) -> None:
        """Apply one FaultEvent at ``self.now`` (== ev.t_s)."""
        for g in self.groups:
            g.advance_to(self.now)
        entry = {"t": self.now, "kind": ev.kind}
        if ev.domain:
            entry["domain"] = ev.domain
        orphans: List[SimReq] = []
        reload_s = 0.0
        if ev.kind in ("chip_loss", "host_loss"):
            # lose chips (clamped to keep the pool alive); every group
            # holding a lost chip dies whole, and its surviving chips are
            # stranded until a replan re-forms groups around them
            if ev.domain:
                # domain-correlated: the victim is a topology unit — all
                # live chips of the resolved host go down together
                lost_chips = self._domain_loss_chips(ev)
                if len(lost_chips) >= self.n_chips:
                    lost_chips = lost_chips[: max(self.n_chips - 1, 0)]
                lost_set = set(lost_chips)
                victims = [
                    g for g in sorted(self.groups, key=lambda g: g.gid)
                    if lost_set.intersection(g.chips)
                ]
                lost = len(lost_chips)
            else:
                # legacy anonymous draw (recorded goldens embed it): the
                # seeded group permutation picks victims, and identity is
                # assigned after the fact — victims' chips die first, the
                # remainder comes from the free pool
                lost = min(max(ev.chips, 1), max(self.n_chips - 1, 0))
                victims = self._pick_victims(ev.seed, lost)
                cand = [c for g in victims for c in g.chips]
                seen = set(cand)
                cand.extend(
                    c for c in sorted(self._free_chips) if c not in seen
                )
                lost_set = set(cand[:lost])
                lost = len(lost_set)
            self.n_chips -= lost
            self._down_chips.update(lost_set)
            self._free_chips = [
                c for c in self._free_chips if c not in lost_set
            ]
            orphans = self._kill_groups(victims)
            for g in victims:
                # the victim group's surviving chips are stranded back
                # into the free pool until a replan re-forms around them
                self._release_chips(c for c in g.chips if c not in lost_set)
            entry.update(
                chips_lost=lost,
                victim_gids=sorted(g.gid for g in victims),
                restarts=len(orphans),
            )
        elif ev.kind == "kv_loss":
            victims = self._pick_victims(ev.seed, 1)
            for g in victims:
                orphans.extend(g.clear())  # zeroes the group's KV counters
            entry.update(
                victim_gids=sorted(g.gid for g in victims),
                restarts=len(orphans),
            )
        elif ev.kind == "straggler":
            victims = self._pick_victims(ev.seed, 1)
            for g in victims:
                slow = max(ev.slowdown, 1.0)
                for c in g.chips:
                    self._chip_slow[c] = slow
                g.slow_factor = self._group_slow_factor(g.chips) if g.chips else slow
                heapq.heappush(
                    self._fault_heap,
                    (self.now + ev.duration_s, next(self._seq),
                     ("straggler_end", g.chips)),
                )
            entry.update(
                victim_gids=sorted(g.gid for g in victims),
                slowdown=ev.slowdown, duration_s=ev.duration_s,
            )
        elif ev.kind == "chip_straggler":
            # partial degradation: ONE chip of the victim group straggles;
            # the whole group runs at its slowest chip, so shrinking TP in
            # place (excluding the chip) beats migrating the group away
            victims = self._pick_victims(ev.seed, 1)
            hit = []
            for g in victims:
                chip = self._straggle_chip_of(ev, g)
                if chip is None:
                    continue
                self._chip_slow[chip] = max(ev.slowdown, 1.0)
                g.slow_factor = self._group_slow_factor(g.chips)
                hit.append(chip)
                heapq.heappush(
                    self._fault_heap,
                    (self.now + ev.duration_s, next(self._seq),
                     ("straggler_end", (chip,))),
                )
            entry.update(
                victim_gids=sorted(g.gid for g in victims),
                chips_slow=sorted(hit),
                slowdown=ev.slowdown, duration_s=ev.duration_s,
            )
        elif ev.kind == "link_flap":
            # flaky ICI link: seeded intermittent slow windows on one chip
            # inside duration_s — each on-window degrades whoever holds
            # the chip at that moment (toggles are silent in fault_log)
            victims = self._pick_victims(ev.seed, 1)
            hit, flaps = [], 0
            for g in victims:
                chip = self._straggle_chip_of(ev, g)
                if chip is None:
                    continue
                hit.append(chip)
                rng = np.random.RandomState(ev.seed + 9)
                t = 0.0
                while t < ev.duration_s:
                    start = t + float(rng.exponential(4.0))
                    if start >= ev.duration_s:
                        break
                    end = min(start + float(rng.exponential(3.0)), ev.duration_s)
                    heapq.heappush(
                        self._fault_heap,
                        (self.now + start, next(self._seq),
                         ("flap_on", chip, max(ev.slowdown, 1.0))),
                    )
                    heapq.heappush(
                        self._fault_heap,
                        (self.now + end, next(self._seq), ("flap_off", chip)),
                    )
                    flaps += 1
                    t = end
            entry.update(
                victim_gids=sorted(g.gid for g in victims),
                chips_slow=sorted(hit), flaps=flaps,
                slowdown=ev.slowdown, duration_s=ev.duration_s,
            )
        elif ev.kind == "recovery":
            if ev.domain:
                chips = self._domain_recovery_chips(ev)
            else:
                restored_n = min(ev.chips, self.chips_total - self.n_chips)
                chips = sorted(self._down_chips)[:restored_n]
            restored = len(chips)
            for c in chips:
                self._down_chips.discard(c)
            self._release_chips(chips)
            self.n_chips += restored
            # rejoined chips hold no weights: any group formed in reaction
            # pays a full host-to-HBM reload (the recovery storm)
            reload_s = self.perf.n_params * self.perf.dtype_bytes / 1e9
            entry.update(chips_restored=restored, reload_s=reload_s)
        else:
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        self.fault_log.append(entry)
        # forced policy reaction over the changed pool (Nitsum replans;
        # static baselines degrade naively / naively rebuild on recovery)
        specs = self.policy.on_fault(self, ev)
        if specs is not None:
            self._apply_specs(specs, charge_cost=True, reload_s=reload_s)
        if not self.groups:
            # the whole serving pool died and the policy did not rebuild:
            # restart instances on whatever chips survive
            self._apply_specs(
                self.policy.initial_specs(self), charge_cost=False,
            )
        if self.groups and self._parked:
            orphans = self._parked + orphans
            self._parked = []
        for r in orphans:
            self._fault_restart(r)
        for g in self.groups:
            self._schedule_group(g)
        if self.kv_audit:
            self._kv_audit_check()

    def _finish_restore(self, r: SimReq) -> None:
        """A checkpointed-KV restore completed: the sequence re-enters
        decode at its snapshot token on a policy-chosen group (no
        re-prefill — the restored KV is resident again)."""
        if not self.groups:
            # the pool died while the restore was in flight: the snapshot
            # has nowhere to land, fall back to a full restart
            self._fault_restart(r)
            return
        tgt = self.policy.decode_target(self, r, self.groups[0])
        tgt.advance_to(self.now)
        tgt.add_decode(r)
        tgt._kv_charge(tgt._kv_ctx(r), 1)
        r.group = tgt
        self._schedule_group(tgt)
        if self.kv_audit:
            self._kv_audit_check()

    def _apply_fault_action(self, action) -> None:
        if isinstance(action, tuple):
            tag = action[0]
            if tag == "straggler_end":
                self._end_chip_slow(action[1], log=True)
            elif tag == "flap_on":
                self._set_chip_slow(action[1], action[2])
            elif tag == "flap_off":
                self._end_chip_slow((action[1],), log=False)
            elif tag == "ckpt_restore":
                self._finish_restore(action[1])
            else:
                raise ValueError(f"unknown fault action {tag!r}")
        else:
            self._apply_fault(action)

    # ---- main loop -------------------------------------------------------
    def run(self, workload: Workload, drain_s: float = 60.0) -> GoodputMeter:
        return self._run_event(workload, drain_s)

    # ---- event engine ----------------------------------------------------
    def _schedule_group(self, g: Group) -> None:
        g._epoch += 1
        t = g.arm()
        if t != math.inf:
            heapq.heappush(self._heap, (t, next(self._seq), g.gid, g._epoch))

    def _peek_group_event(self) -> float:
        h = self._heap
        while h:
            t, _, gid, epoch = h[0]
            g = self._by_gid.get(gid)
            if g is None or epoch != g._epoch:
                heapq.heappop(h)
                continue
            return t
        return math.inf

    def _handle_group_event(self) -> None:
        t, _, gid, epoch = heapq.heappop(self._heap)
        g = self._by_gid.get(gid)
        if g is None or epoch != g._epoch:
            return
        g.advance_to(t)
        kind = g._ev_kind
        if kind == "prefill" and g.cur is not None and g.cur.prefill_left_s <= _EPS:
            req = g.cur
            g.cur = None
            self.on_prefill_done(req, g, t)
        elif kind == "decode":
            idx = g.decode.crossers(g._batch_n)
            if len(idx):
                # parity: the fluid reference stamps decode finishes at the
                # end of the tick the crossing fell in
                stamp = (
                    math.ceil(t / self.dt - 1e-9) * self.dt
                    if self.grid_parity else t
                )
                for r in g.decode.remove_indices(idx):
                    r.finish_s = stamp
                    self.on_finish(r)
            # else: context-drift refresh — re-arm recomputes the step
        self._schedule_group(g)
        if self.kv_audit:
            self._kv_audit_check()

    def _kv_audit_check(self) -> None:
        """Conservation invariant (the reference's
        tests/test_kv_occupancy.py): per group, tokens admitted − released
        == live occupancy, i.e. the tracked
        counters equal a fresh scan of resident requests."""
        for g in self.groups:
            g.decode.sync()
            toks, seqs = 0.0, 0
            for r in g.decode:
                toks += g._kv_ctx(r)
                seqs += 1
            if g.cur is not None:
                toks += g._kv_ctx(g.cur)
                seqs += 1
            if seqs != g.kv_seqs or abs(toks - g.kv_tokens) > 0.5 + 1e-5 * toks:
                raise AssertionError(
                    f"KV occupancy drift on group {g.gid} at t={self.now:.3f}: "
                    f"tracked ({g.kv_tokens:.2f} tok, {g.kv_seqs} seqs) != "
                    f"live ({toks:.2f} tok, {seqs} seqs)"
                )

    def _window_boundary(self) -> None:
        if type(self.policy).window is Policy.window:
            return  # policy's window() is the no-op base — nothing to do
        # bring every group's integrated state up to the boundary so the
        # policy observes current queues (per-request tokens stay lazy:
        # _apply_specs syncs the groups whose contexts it actually reads)
        for g in self.groups:
            g.advance_to(self.now)
        specs = self.policy.window(self)
        if specs is not None:
            self._apply_specs(specs, charge_cost=True)
        # queue contents / blocked_until / group set may all have changed
        for g in self.groups:
            self._schedule_group(g)

    def _begin(
        self,
        workload: Workload,
        drain_s: float,
        external_arrivals: bool = False,
        demand_scale: float = 1.0,
    ) -> None:
        """Stand the engine up for stepped execution: plan the initial
        layout, stage the arrival stream (unless a fleet feeds arrivals in
        externally), and arm the heaps. After this, ``_next_time`` /
        ``_process`` advance the simulation one event-time at a time — the
        fleet layer drives many cells under one clock this way."""
        if workload.topology is not None:
            # the trace declares the failure-domain tree; bind it before
            # the initial plan so chip placement spreads across it
            self.topology = workload.topology
        arr = self._setup(workload, demand_scale)
        self._horizon = workload.horizon_s + drain_s
        if external_arrivals:
            arr = []
        if self.grid_parity:
            # golden-trajectory stability: admit arrivals at dt-grid starts
            # (the retired fluid reference's tick grid, which the recorded
            # goldens embed — see the module docstring)
            dt = self.dt
            adm = [math.ceil(r.arrival_s / dt - 1e-9) * dt for r in arr]
        else:
            adm = [r.arrival_s for r in arr]
        self._arr = arr
        self._adm = adm
        self._arr_i = 0
        self._next_window = self.window_s
        self._next_second = 1.0
        self._heap = []
        self._fault_heap = []
        self._retry_heap = []
        for ev in workload.faults:
            heapq.heappush(self._fault_heap, (ev.t_s, next(self._seq), ev))
        for g in self.groups:
            self._schedule_group(g)

    def _next_time(self) -> float:
        """Earliest pending event: next arrival, group boundary event,
        fault, window boundary, or per-second sampling point."""
        t = self._peek_group_event()
        if self._arr_i < len(self._adm):
            t = min(t, self._adm[self._arr_i])
        if self._retry_heap:
            t = min(t, self._retry_heap[0][0])
        if self._fault_heap:
            t = min(t, self._fault_heap[0][0])
        return min(t, self._next_window, self._next_second)

    def _process(self, t: float) -> None:
        """Process every pending event at/under ``t``, in the engine's
        canonical order: arrivals, faults, group boundary events, then the
        second/window boundaries when ``t`` reaches them."""
        self.now = t
        adm, i, n = self._adm, self._arr_i, len(self._adm)
        if i < n and adm[i] <= t:
            j = i
            while j < n and adm[j] <= t:
                j += 1
            self._arr_i = j
            self._admit_batch(self._arr[i:j])
        retries = self._retry_heap
        while retries and retries[0][0] <= t:
            _, _, req, tries = heapq.heappop(retries)
            self._retry_admit(req, tries)
        faults = self._fault_heap
        while faults and faults[0][0] <= t:
            _, _, action = heapq.heappop(faults)
            self._apply_fault_action(action)
        while self._peek_group_event() <= t:
            self._handle_group_event()
        if t >= self._next_second:
            self._recent_expire()  # static policies never query stats
            self.timeline.append((t, self._win_good / 1.0))
            self.spill_timeline.append((t, sum(self.spill_counts.values())))
            self.reconfig_timeline.append((t, self.reconfig_count))
            self._win_good = 0
            tw = self._tier_win_good
            for tier, tl in self.tier_timelines.items():
                tl.append((t, float(tw.get(tier, 0))))
                tw[tier] = 0
            self._next_second += 1.0
        if t >= self._next_window:
            self._window_boundary()
            self._next_window += self.window_s

    def _run_event(self, workload: Workload, drain_s: float) -> GoodputMeter:
        self._begin(workload, drain_s)
        horizon = self._horizon
        while True:
            t = self._next_time()
            if t >= horizon:
                break
            self._process(t)
        self.now = horizon
        return self.meter

    def goodput(self, workload: Workload) -> float:
        return self.meter.goodput(workload.horizon_s)


def make_policy(
    system: str,
    perf: PerfModel,
    tiers: Sequence[SLOTier],
    n_chips: int,
    candidate_tps=(1, 2, 4, 8),
    **policy_kw,
) -> Policy:
    """Build the named policy sized for an ``n_chips`` pool (the fleet
    layer calls this once per cell with the per-cell chip count)."""
    tps = [t for t in candidate_tps if t <= n_chips]
    # static baselines run at the minimal TP the model fits (paper's setup)
    tp0 = perf.min_tp(tps)
    mk = {
        "nitsum": lambda: NitsumPolicy(perf, tiers, candidate_tps=tps, **policy_kw),
        "nitsum-slowswitch": lambda: NitsumPolicy(
            perf, tiers, fast_switch=False, candidate_tps=tps, **policy_kw
        ),
        # fault-aware planning on (docs/faults.md §Fault-aware planning);
        # the bare "nitsum" is the no-resilience ablation the cascade
        # matrix compares against
        "nitsum-resilient": lambda: NitsumPolicy(
            perf, tiers, candidate_tps=tps,
            **{"resilience_weight": DEFAULT_RESILIENCE_WEIGHT, **policy_kw},
        ),
        "sglang": lambda: StaticPolicy(perf, tiers, tp=tp0, candidate_tps=tps),
        "sglang-pd": lambda: StaticPolicy(
            perf, tiers, tp=tp0, disaggregated=True, candidate_tps=tps
        ),
        "sglang-slo": lambda: SLOStaticPolicy(perf, tiers, candidate_tps=tps),
        "split": lambda: SplitPolicy(perf, tiers, candidate_tps=tps),
        "llumnix": lambda: LlumnixPolicy(perf, tiers, tp=tp0, candidate_tps=tps),
        "chiron": lambda: ChironPolicy(perf, tiers, tp=tp0, candidate_tps=tps),
        "oracle": lambda: OraclePolicy(perf, tiers, candidate_tps=tps),
    }
    if system.startswith("static-tp"):
        tp = int(system.split("static-tp")[1].split("-")[0])
        disagg = system.endswith("-pd")
        return StaticPolicy(
            perf, tiers, tp=tp, disaggregated=disagg, candidate_tps=tps
        )
    return mk[system]()


def run_system(
    system: str,
    perf: PerfModel,
    tiers: Sequence[SLOTier],
    n_chips: int,
    workload: Workload,
    candidate_tps=(1, 2, 4, 8),
    engine: str = "event",
    kv_watermark: float = 0.9,
    kv_audit: bool = False,
    admission=None,
    kv_checkpoint: bool = False,
    **policy_kw,
):
    policy = make_policy(
        system, perf, tiers, n_chips, candidate_tps=candidate_tps, **policy_kw
    )
    sim = Simulator(
        perf, tiers, n_chips, policy, engine=engine,
        kv_watermark=kv_watermark, kv_audit=kv_audit, admission=admission,
        kv_checkpoint=kv_checkpoint,
    )
    meter = sim.run(workload)
    return sim, meter
