"""ServeGen-calibrated workloads (Alibaba Cloud Model Studio, arXiv/NSDI'26);
mirrors repro/traces/servegen.py.

Published statistics reproduced (paper §4 Workloads):
  conversation: avg prompt 871, avg output 86, avg 10.66 req/s
  code:         avg prompt 912, avg output 148, avg 11.94 req/s
10-minute normalized windows, strongly bursty.
"""
from __future__ import annotations

from repro_torch.traces.workload import Workload, make_workload, merge_workloads

STATS = {
    "conversation": dict(prompt_mean=871, output_mean=86, mean_rps=10.66),
    "code": dict(prompt_mean=912, output_mean=148, mean_rps=11.94),
}


def servegen_workload(
    kind: str = "conversation",
    tier: str = "strict",
    horizon_s: float = 600.0,
    seed: int = 0,
    rps: float = None,
) -> Workload:
    s = dict(STATS[kind])
    if rps is not None:
        s["mean_rps"] = rps
    return make_workload(
        f"servegen-{kind}", tier, s["mean_rps"], s["prompt_mean"],
        s["output_mean"], horizon_s, seed, burstiness=0.7,
    )


def servegen_two_tier(horizon_s: float = 600.0, seed: int = 0, rps_scale: float = 1.0) -> Workload:
    """The paper's two-tier setting: conversation = strict, code = relaxed."""
    conv = servegen_workload(
        "conversation", "strict", horizon_s, seed,
        rps=STATS["conversation"]["mean_rps"] * rps_scale,
    )
    code = servegen_workload(
        "code", "relaxed", horizon_s, seed + 1,
        rps=STATS["code"]["mean_rps"] * rps_scale,
    )
    return merge_workloads("servegen-2tier", conv, code)


def servegen_longctx(
    horizon_s: float = 240.0, seed: int = 0, rps_scale: float = 1.0,
) -> Workload:
    """ServeGen-style long-context mix: 8-32k-token prompts (agentic /
    document workloads from the ServeGen length study), two tiers. At these
    context lengths a TP group's HBM holds only a handful of sequences, so
    this is the trace that exercises dynamic KV occupancy accounting and
    admission backpressure (docs/simulator.md §KV occupancy) — the regime
    where the paper's KV migration and TP adaptation matter most (Fig. 7)."""
    conv = make_workload(
        "longctx-chat", "strict", 0.72 * rps_scale,
        prompt_mean=12288, output_mean=200, horizon_s=horizon_s, seed=seed,
        burstiness=0.7, prompt_sigma=0.45, prompt_lo=8192, prompt_hi=32768,
    )
    doc = make_workload(
        "longctx-doc", "relaxed", 1.08 * rps_scale,
        prompt_mean=16384, output_mean=400, horizon_s=horizon_s, seed=seed + 1,
        burstiness=0.7, prompt_sigma=0.5, prompt_lo=8192, prompt_hi=32768,
    )
    return merge_workloads("servegen-longctx", conv, doc)


def servegen_hourlong(
    scenario: str = "diurnal",
    horizon_s: float = 3600.0,
    seed: int = 0,
    rps_scale: float = 1.0,
):
    """Hour-long ServeGen-calibrated trace with non-stationary structure.

    Thin entry point over the scenario library (traces/scenarios.py): the
    named scenarios compose these ServeGen rate/length statistics with
    deterministic envelopes (diurnal cycles, flash crowds, tier-mix
    drift, long-context phases). Imported lazily — scenarios builds on
    this module's STATS, not the other way round."""
    from repro_torch.traces.scenarios import get_scenario

    return get_scenario(scenario).build(
        seed=seed, horizon_s=horizon_s, rps_scale=rps_scale
    )


def servegen_shifting(
    horizon_s: float = 600.0, seed: int = 0, rps_scale: float = 1.0,
    n_phases: int = 4,
) -> Workload:
    """Time-varying tier mix (the paper's §2.3 motivation): the workload
    alternates between strict-heavy and relaxed-heavy phases, so the
    goodput-optimal configuration shifts during the trace."""
    from repro_torch.traces.workload import TraceRequest

    phase_s = horizon_s / n_phases
    parts = []
    for ph in range(n_phases):
        heavy_strict = ph % 2 == 0
        conv = servegen_workload(
            "conversation", "strict", phase_s, seed + 2 * ph,
            rps=STATS["conversation"]["mean_rps"] * rps_scale * (1.7 if heavy_strict else 0.3),
        )
        code = servegen_workload(
            "code", "relaxed", phase_s, seed + 2 * ph + 1,
            rps=STATS["code"]["mean_rps"] * rps_scale * (0.3 if heavy_strict else 1.7),
        )
        for w in (conv, code):
            parts.append(
                Workload(w.name, [
                    TraceRequest(r.req_id, r.tier, r.arrival_s + ph * phase_s,
                                 r.prompt_len, r.output_len, r.tenant_id)
                    for r in w.requests
                ], horizon_s)
            )
    return merge_workloads("servegen-shifting", *parts)
