"""Per-tenant token-budget admission control (docs/tenancy.md); mirrors
repro/serving/admission.py.

Sits *ahead* of the global scheduler: before a request is routed, its
tenant's token bucket must cover ``prompt_len + output_len`` tokens.
Buckets refill continuously at ``tokens_per_s`` and hold at most
``burst_tokens``, so a tenant can burst briefly above its sustained rate
but a sustained flood drains the bucket and gets throttled.

Throttled requests are not dropped or demoted immediately — the engine
re-queues them on a priced retry heap (delay = token deficit divided by
the refill rate, clamped to [min_retry_s, max_retry_s]) and demotes to
best-effort only after ``max_retries`` failed attempts.  This is the
spill path's missing third option alongside re-route and demote
(ROADMAP item 4).

Tenants with no configured budget (including the default tenant when no
``default_budget`` is given) are unlimited: ``try_admit`` returns True
without touching any state, so a tenant-free workload behaves exactly
as if no admission layer existed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..traces.workload import DEFAULT_TENANT


@dataclass(frozen=True)
class TenantBudget:
    """Sustained token rate + burst allowance for one tenant."""

    tokens_per_s: float
    burst_tokens: float
    max_retries: int = 3


class TokenBucket:
    """Continuous-refill token bucket. Deterministic: state is a pure
    function of the (cost, now) call sequence."""

    __slots__ = ("rate", "cap", "tokens", "t")

    def __init__(self, rate: float, cap: float):
        self.rate = float(rate)
        self.cap = float(cap)
        self.tokens = float(cap)  # start full: cold tenants get their burst
        self.t = 0.0

    def _refill(self, now: float) -> None:
        if now > self.t:
            self.tokens = min(self.cap, self.tokens + (now - self.t) * self.rate)
            self.t = now

    def try_take(self, cost: float, now: float) -> bool:
        self._refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def delay_for(self, cost: float, now: float) -> float:
        """Seconds until the bucket could cover ``cost`` (0 if it already
        can; inf if the cost exceeds the bucket's capacity)."""
        self._refill(now)
        if self.tokens >= cost:
            return 0.0
        if cost > self.cap:
            return float("inf")
        return (cost - self.tokens) / max(self.rate, 1e-9)


class AdmissionController:
    """Maps tenants to token buckets and answers admit/throttle.

    One controller is shared across every cell of a fleet — budgets are
    fleet-global, so a tenant cannot dodge its quota by landing on a
    different cell.
    """

    def __init__(
        self,
        budgets: Dict[str, TenantBudget],
        default_budget: Optional[TenantBudget] = None,
        min_retry_s: float = 0.05,
        max_retry_s: float = 5.0,
    ):
        self.budgets = dict(budgets)
        self.default_budget = default_budget
        self.min_retry_s = float(min_retry_s)
        self.max_retry_s = float(max_retry_s)
        self._buckets: Dict[str, TokenBucket] = {}

    def _bucket(self, tenant: str) -> Optional[TokenBucket]:
        b = self._buckets.get(tenant)
        if b is not None:
            return b
        budget = self.budgets.get(tenant, self.default_budget)
        if budget is None:
            return None  # unlimited tenant
        b = TokenBucket(budget.tokens_per_s, budget.burst_tokens)
        self._buckets[tenant] = b
        return b

    def try_admit(self, tenant: str, cost: float, now: float) -> bool:
        b = self._bucket(tenant)
        if b is None:
            return True
        return b.try_take(cost, now)

    def retry_delay_s(self, tenant: str, cost: float, now: float) -> float:
        """Priced retry delay: how long until this tenant's bucket refills
        enough, clamped so retries neither thrash nor stall forever."""
        b = self._bucket(tenant)
        if b is None:
            return self.min_retry_s
        d = b.delay_for(cost, now)
        if d == float("inf"):
            return self.max_retry_s
        return min(self.max_retry_s, max(self.min_retry_s, d))

    def max_retries(self, tenant: str) -> int:
        budget = self.budgets.get(tenant, self.default_budget)
        return budget.max_retries if budget is not None else 0


def budgets_from_spec(
    spec,
    headroom: float = 1.25,
    burst_s: float = 10.0,
    max_retries: int = 3,
) -> Dict[str, TenantBudget]:
    """Derive per-tenant token budgets from a ScenarioSpec.

    Each stream with ``budget_rps`` set contributes
    ``budget_rps * (prompt_mean + output_mean)`` tokens/s to its tenant's
    sustained rate; ``headroom`` scales the sum (budgets are contracts,
    not exact means) and ``burst_s`` sizes the burst allowance as seconds
    of sustained rate. Streams without ``budget_rps`` leave their tenant
    unlimited (no entry).
    """
    rates: Dict[str, float] = {}
    for s in spec.streams:
        if getattr(s, "budget_rps", None) is None:
            continue
        tok_per_req = float(s.prompt_mean) + float(s.output_mean)
        tenant = getattr(s, "tenant", DEFAULT_TENANT)
        rates[tenant] = rates.get(tenant, 0.0) + s.budget_rps * tok_per_req
    return {
        t: TenantBudget(
            tokens_per_s=r * headroom,
            burst_tokens=r * headroom * burst_s,
            max_retries=max_retries,
        )
        for t, r in rates.items()
    }
