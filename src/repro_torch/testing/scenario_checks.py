"""Statistical-property checks for scenario-generated traces (mirrors
repro/testing/scenario_checks.py).

In the reference, shared between its tests/test_scenarios.py and the
scenario-matrix runner (benchmarks/scenario_matrix.py validates every trace
it replays before spending simulation time on it): a realized trace must be
(a) bit-identical under the same (spec, seed) and (b) statistically
faithful to its :class:`~repro_torch.traces.scenarios.ScenarioSpec` —
realized arrival rate, per-tier request mix, and rate-weighted length
means within tolerance.

Tolerances default to ±10%: the generator draws a Cox process whose
*expected* mean is normalized to the spec (workload.bursty_arrivals), so
over hour-scale horizons the realized statistics concentrate well inside
that; short test horizons (minutes) need the slack for Poisson noise on a
few thousand requests.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.traces.scenarios import ScenarioSpec
from repro_torch.traces.workload import Workload


def trace_statistics(wl: Workload) -> Dict:
    """Realized statistics of a trace: ``Workload.stats()`` (the single
    source of truth for n/rps/length means) plus the per-tier request
    mix the scenario checks need."""
    n = len(wl.requests)
    if not n:
        return {"n": 0, "rps": 0.0, "tier_mix": {},
                "prompt_mean": 0.0, "output_mean": 0.0}
    mix: Dict[str, int] = {}
    for r in wl.requests:
        mix[r.tier] = mix.get(r.tier, 0) + 1
    out = dict(wl.stats())
    out["tier_mix"] = {t: c / n for t, c in mix.items()}
    return out


def scenario_violations(
    spec: ScenarioSpec,
    wl: Workload,
    rtol: float = 0.10,
    mix_atol: float = 0.05,
    rps_scale: float = 1.0,
) -> List[str]:
    """Compare a realized trace against its spec; returns human-readable
    violation strings (empty list = statistically faithful).

    * realized arrival rate within ``rtol`` of ``expected_rps * rps_scale``;
    * each tier's request fraction within ``mix_atol`` (absolute) of the
      spec's expected mix — fractions, not rates, so the check is
      scale-invariant;
    * rate-weighted prompt/output means within ``rtol`` of the spec's.
    """
    st = trace_statistics(wl)
    out: List[str] = []

    def rel(label: str, got: float, want: float) -> None:
        if want <= 0:
            return
        err = abs(got - want) / want
        if err > rtol:
            out.append(
                f"{spec.name}: {label} {got:.2f} vs expected {want:.2f} "
                f"(rel err {err:.1%} > {rtol:.0%})"
            )

    rel("arrival rps", st["rps"], spec.expected_rps * rps_scale)
    rel("prompt mean", st["prompt_mean"], spec.expected_prompt_mean)
    rel("output mean", st["output_mean"], spec.expected_output_mean)
    want_mix = spec.expected_tier_mix
    for tier, want in want_mix.items():
        got = st["tier_mix"].get(tier, 0.0)
        if abs(got - want) > mix_atol:
            out.append(
                f"{spec.name}: tier {tier!r} fraction {got:.3f} vs expected "
                f"{want:.3f} (|err| > {mix_atol})"
            )
    for tier in st["tier_mix"]:
        if tier not in want_mix:
            out.append(f"{spec.name}: unexpected tier {tier!r} in trace")
    return out


def check_determinism(
    spec: ScenarioSpec, seed: int = 0, horizon_s: float = 60.0,
    rps_scale: float = 1.0,
) -> None:
    """Same (spec, seed) must realize the identical trace; a different seed
    must not. Raises AssertionError on violation."""
    a = spec.build(seed=seed, horizon_s=horizon_s, rps_scale=rps_scale)
    b = spec.build(seed=seed, horizon_s=horizon_s, rps_scale=rps_scale)
    key = lambda wl: [
        (r.req_id, r.tier, r.arrival_s, r.prompt_len, r.output_len,
         r.tenant_id)
        for r in wl.requests
    ]
    assert key(a) == key(b), f"{spec.name}: same seed produced different traces"
    assert a.faults == b.faults, (
        f"{spec.name}: same seed realized different fault schedules"
    )
    c = spec.build(seed=seed + 1, horizon_s=horizon_s, rps_scale=rps_scale)
    assert key(a) != key(c), (
        f"{spec.name}: different seeds produced identical traces"
    )
