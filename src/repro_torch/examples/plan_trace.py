"""Trace-replay comparison: Nitsum vs the paper's baselines on ServeGen
(mirrors examples/plan_trace.py).

    PYTHONPATH=src python -m repro_torch.examples.plan_trace [--horizon 120] [--scale 2.0]

Host code: the simulator prices every step with ``PerfModel(llama3-8b)`` at
its default V5E spec, as the reference does, so its goodputs are the
reference's (a parity check, not a measurement of any device).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.profiles.perf_model import PerfModel
from repro_torch.profiles.slo import derive_tiers
from repro_torch.serving.simulator import run_system
from repro_torch.traces.servegen import servegen_two_tier

SYSTEMS = ("nitsum", "sglang", "sglang-pd", "split", "llumnix", "chiron")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--horizon", type=float, default=120.0)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--chips", type=int, default=16)
    args = ap.parse_args(argv)

    perf = PerfModel(get_config("llama3-8b"))
    tiers = derive_tiers(perf, prompt_len=900, ctx_len=1000)
    print("derived SLOs (paper methodology: strict=bs1, relaxed=bs128):")
    for t in tiers:
        print(f"  {t.name}: TTFT {t.ttft_ms:.0f}ms TPOT {t.tpot_ms:.1f}ms")

    wl = servegen_two_tier(horizon_s=args.horizon, rps_scale=args.scale)
    print(f"workload: {wl.stats()}")
    print(f"{'system':14s} {'goodput':>8s}  {'strict':>7s} {'relaxed':>8s} {'reconfigs':>9s}")
    for system in SYSTEMS:
        sim, meter = run_system(system, perf, tiers, args.chips, wl)
        g = meter.goodput(wl.horizon_s)
        per = meter.per_tier_goodput(wl.horizon_s)
        print(f"{system:14s} {g:8.2f}  {per.get('strict', 0):7.2f} "
              f"{per.get('relaxed', 0):8.2f} {sim.reconfig_count:9d}")


if __name__ == "__main__":
    main()
