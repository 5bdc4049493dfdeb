"""SLO derivation (mirrors repro/profiles/slo.py), following the paper's
§4 methodology (via SplitWise):

  strict tier  = measured latency at batch size 1, minimal TP that fits;
  relaxed tier = measured latency at batch size 128.

We "measure" with the profile the planner uses: the analytic model, or a
``TabulatedPerfModel`` of tables measured on the card. A small engineering
margin is applied on TTFT (queueing is never zero) exactly as the paper's
Table-1 numbers sit well above pure execution time.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.goodput import SLOTier
from repro_torch.profiles.perf_model import PerfModel


def derive_tiers(
    perf: PerfModel,
    prompt_len: int,
    ctx_len: int = None,
    ttft_margin: float = 4.0,
    tpot_margin: float = 1.25,
    candidate_tps=(1, 2, 4, 8),
) -> List[SLOTier]:
    tp = perf.min_tp(candidate_tps)
    ctx = ctx_len or prompt_len
    strict_ttft = perf.ttft_ms(prompt_len, tp) * ttft_margin
    strict_tpot = perf.tpot_ms(1, ctx, tp) * tpot_margin
    relaxed_tpot = max(perf.tpot_ms(128, ctx, tp), 2 * strict_tpot / tpot_margin)
    return [
        SLOTier("strict", strict_ttft, strict_tpot),
        SLOTier("relaxed", strict_ttft, relaxed_tpot),
    ]
