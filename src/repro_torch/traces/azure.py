"""Azure LLM-inference-trace-calibrated workloads (paper §4 Workloads);
mirrors repro/traces/azure.py.

Published statistics reproduced:
  conversation: avg prompt 1155, avg output 211, avg 0.5 req/s
  code:         avg prompt 2048, avg output 28,  avg 2.3 req/s
"""
from __future__ import annotations

from repro_torch.traces.workload import Workload, make_workload, merge_workloads

STATS = {
    "conversation": dict(prompt_mean=1155, output_mean=211, mean_rps=0.5),
    "code": dict(prompt_mean=2048, output_mean=28, mean_rps=2.3),
}


def azure_workload(
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
        f"azure-{kind}", tier, s["mean_rps"], s["prompt_mean"], s["output_mean"],
        horizon_s, seed, burstiness=0.5,
    )


def azure_two_tier(horizon_s: float = 600.0, seed: int = 0, rps_scale: float = 1.0) -> Workload:
    conv = azure_workload(
        "conversation", "strict", horizon_s, seed,
        rps=STATS["conversation"]["mean_rps"] * rps_scale,
    )
    code = azure_workload(
        "code", "relaxed", horizon_s, seed + 1,
        rps=STATS["code"]["mean_rps"] * rps_scale,
    )
    return merge_workloads("azure-2tier", conv, code)
