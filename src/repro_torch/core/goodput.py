"""SLO tiers and goodput accounting (requests meeting both TTFT and TPOT);
mirrors repro/core/goodput.py."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


@dataclass(frozen=True)
class SLOTier:
    name: str
    ttft_ms: float
    tpot_ms: float
    background: bool = False  # no SLO; scheduled into residual capacity

    def scaled(self, factor: float) -> "SLOTier":
        return SLOTier(self.name, self.ttft_ms * factor, self.tpot_ms * factor,
                       self.background)


# The paper's Table-1 methodology: strict tier = bs-1 latency, relaxed tier =
# bs-128 latency, measured per (model, platform). These are the v5e-profile
# derived defaults used across benchmarks (see profiles/perf_model.py).
def default_tiers(strict_ttft_ms=300.0, strict_tpot_ms=12.0) -> List[SLOTier]:
    return [
        SLOTier("strict", strict_ttft_ms, strict_tpot_ms),
        SLOTier("relaxed", strict_ttft_ms, strict_tpot_ms * 2.0),
    ]


@dataclass
class RequestRecord:
    req_id: int
    tier: str
    arrival_s: float
    prompt_len: int
    output_len: int
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    tokens_out: int = 0
    tenant_id: str = "default"

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return (self.first_token_s - self.arrival_s) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.tokens_out <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) * 1e3 / (self.tokens_out - 1)


@dataclass
class GoodputMeter:
    """Aggregates per-request SLO attainment into goodput (req/s)."""

    tiers: Dict[str, SLOTier]
    records: List[RequestRecord] = field(default_factory=list)

    def add(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    @classmethod
    def merged(cls, meters: Sequence["GoodputMeter"]) -> "GoodputMeter":
        """Combine per-cell meters into one fleet-level meter (tier tables
        must agree on shared names). Records are re-sorted by arrival so
        percentile/goodput queries behave as if one meter had observed the
        whole fleet's traffic."""
        tiers: Dict[str, SLOTier] = {}
        records: List[RequestRecord] = []
        for m in meters:
            tiers.update(m.tiers)
            records.extend(m.records)
        out = cls(tiers)
        out.records = sorted(records, key=lambda r: (r.arrival_s, r.req_id))
        return out

    def meets_slo(self, rec: RequestRecord) -> bool:
        tier = self.tiers[rec.tier]
        if tier.background:
            return rec.finish_s is not None
        if rec.ttft_ms is None or rec.tpot_ms is None:
            return False
        return rec.ttft_ms <= tier.ttft_ms and rec.tpot_ms <= tier.tpot_ms

    def goodput(self, horizon_s: float) -> float:
        good = sum(1 for r in self.records if self.meets_slo(r))
        return good / max(horizon_s, 1e-9)

    def per_tier_goodput(self, horizon_s: float) -> Dict[str, float]:
        out = {t: 0 for t in self.tiers}
        for r in self.records:
            if self.meets_slo(r):
                out[r.tier] += 1
        return {t: n / max(horizon_s, 1e-9) for t, n in out.items()}

    def per_tenant_goodput(self, horizon_s: float) -> Dict[str, float]:
        out: Dict[str, int] = {}
        for r in self.records:
            out.setdefault(r.tenant_id, 0)
            if self.meets_slo(r):
                out[r.tenant_id] += 1
        return {t: n / max(horizon_s, 1e-9) for t, n in out.items()}

    def latency_percentiles(self, tier: str, q=(50, 90, 99)) -> dict:
        import numpy as np

        ttfts = [r.ttft_ms for r in self.records if r.tier == tier and r.ttft_ms is not None]
        tpots = [r.tpot_ms for r in self.records if r.tier == tier and r.tpot_ms is not None]
        out = {}
        for name, xs in (("ttft_ms", ttfts), ("tpot_ms", tpots)):
            if xs:
                for p in q:
                    out[f"{name}_p{p}"] = float(np.percentile(xs, p))
        return out
