"""Scenario matrix: {cluster size} x {scenario} x {policy} goodput sweeps,
the part that the length-regime gate reads (the port's own copy of
benchmarks/scenario_matrix.py's matrix and cell runner, with
benchmarks/common.py's MODEL and CANDIDATE_TPS).

Hour-scale non-stationary traces (traces/scenarios.py: diurnal cycles,
flash crowds, tier-mix drift, long-context phases, prefill- vs
decode-heavy regimes) replayed on 64-512-chip pools under the event
engine, nitsum vs the static-TP baseline per cell. Load scales with the
pool: ``rps_scale = n_chips / 16`` keeps each cell at the 16-chip
reference pool's saturation point. SLO tiers are derived per scenario at
its expected operating point (``scenario_tiers``). Every realized trace is
validated against its spec's expected statistics
(testing/scenario_checks.py) before any simulation time is spent on it.

The benchmark harness's half (``run``, the environment overrides and the
result files) is not ported: nothing here writes a file.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs import get_config
from repro_torch.profiles.perf_model import PerfModel, clear_perf_caches
from repro_torch.profiles.slo import derive_tiers
from repro_torch.serving.simulator import run_system
from repro_torch.testing.scenario_checks import scenario_violations
from repro_torch.traces.scenarios import get_scenario

MODEL = "llama3-8b"
CANDIDATE_TPS = (1, 2, 4, 8)

SYSTEMS = ("nitsum", "sglang")  # adaptive TP vs static-TP baseline
REFERENCE_CHIPS = 16  # the pool the base scenario rates saturate

# cluster size -> (horizon_s, scenario names). The 256-chip row is the
# hour-long headline cell; 64/128 run the full scenario set at 15 minutes;
# 512 probes the largest pool at 10 minutes (wall-clock budget: the event
# engine is ~0.3-1 ms per request at these scales).
FULL_MATRIX: Dict[int, Tuple[float, Tuple[str, ...]]] = {
    64: (900.0, ("diurnal", "flash_crowd", "tier_drift", "longctx_phases",
                 "prefill_heavy", "decode_heavy")),
    128: (900.0, ("diurnal", "flash_crowd", "tier_drift", "longctx_phases",
                  "prefill_heavy", "decode_heavy")),
    256: (3600.0, ("diurnal", "flash_crowd", "tier_drift", "longctx_phases")),
    512: (600.0, ("diurnal", "tier_drift", "prefill_heavy", "decode_heavy")),
}
QUICK_MATRIX: Dict[int, Tuple[float, Tuple[str, ...]]] = {
    # the length-heavy regimes ride the quick matrix so the CI gate
    # (testing.length_regime_gate) can watch them on every run
    64: (90.0, ("diurnal", "flash_crowd", "tier_drift", "longctx_phases",
                "prefill_heavy", "decode_heavy")),
    128: (90.0, ("diurnal", "flash_crowd", "tier_drift", "longctx_phases")),
}

# scenarios where nitsum vs static is a capacity contest at one length
# regime (the two cells an early matrix showed losing); everything else in
# the matrix is a MIX scenario nitsum is expected to win outright
LENGTH_REGIMES = ("prefill_heavy", "decode_heavy")

TRAJECTORY_POINTS = 600  # downsample per-second series to at most this


def _downsample(series: Sequence[Tuple[float, float]], cumulative: bool):
    """Bucket a per-second series to <= TRAJECTORY_POINTS entries: windowed
    mean for rate-like series, bucket-final value for cumulative counters."""
    series = list(series)
    if len(series) <= TRAJECTORY_POINTS:
        return series
    stride = -(-len(series) // TRAJECTORY_POINTS)
    out = []
    for i in range(0, len(series), stride):
        chunk = series[i : i + stride]
        t = chunk[-1][0]
        v = chunk[-1][1] if cumulative else sum(c[1] for c in chunk) / len(chunk)
        out.append((t, v))
    return out


def scenario_tiers(perf: PerfModel, scenario_name: str):
    """SLO tiers derived at the scenario's expected operating point (the
    paper's SplitWise-style methodology, applied per workload exactly as
    benchmarks/kv_backpressure.py derives its tiers at the 14k-prompt
    point): strict/relaxed TTFT+TPOT measured at the spec's rate-weighted
    mean prompt and end-of-decode context. Deriving all scenarios at one
    short-context point makes heavy regimes trivially infeasible (a 5k
    prompt can never meet a TTFT measured at 900 tokens) and turns those
    cells into zero-goodput floor effects with no policy signal."""
    spec = get_scenario(scenario_name)
    p = int(spec.expected_prompt_mean)
    c = p + int(spec.expected_output_mean)
    return derive_tiers(perf, prompt_len=p, ctx_len=c,
                        candidate_tps=CANDIDATE_TPS)


def build_cell_trace(
    scenario_name: str,
    n_chips: int,
    horizon_s: float,
    seed: int = 0,
    validate_trace: bool = True,
):
    """Build (and statistically validate) one cell's trace. Deterministic
    in its arguments, so a (scenario, cluster) pair's trace is shared
    across the systems replaying it."""
    spec = get_scenario(scenario_name)
    rps_scale = n_chips / REFERENCE_CHIPS
    wl = spec.build(seed=seed, horizon_s=horizon_s, rps_scale=rps_scale)
    if validate_trace:
        bad = scenario_violations(spec, wl, rps_scale=rps_scale)
        if bad:
            raise AssertionError(
                f"scenario {scenario_name!r} trace failed its statistical "
                f"spec: {bad}"
            )
    return wl


def run_cell(
    system: str,
    scenario_name: str,
    n_chips: int,
    horizon_s: float,
    perf: PerfModel,
    tiers=None,
    seed: int = 0,
    engine: str = "event",
    validate_trace: bool = True,
    workload=None,
) -> Dict:
    """Replay one (policy, scenario, cluster) cell; returns the BENCH dict.
    ``tiers=None`` derives the scenario's own SLO operating point;
    ``workload=None`` builds (and validates) the cell's trace."""
    if tiers is None:
        tiers = scenario_tiers(perf, scenario_name)
    wl = workload
    if wl is None:
        wl = build_cell_trace(
            scenario_name, n_chips, horizon_s, seed, validate_trace
        )
    clear_perf_caches()
    t0 = time.perf_counter()
    sim, _ = run_system(
        system, perf, tiers, n_chips, wl,
        candidate_tps=CANDIDATE_TPS, engine=engine,
    )
    wall = time.perf_counter() - t0
    res = sim.result(wl.horizon_s)
    return {
        "system": system,
        "scenario": scenario_name,
        "n_chips": n_chips,
        "horizon_s": horizon_s,
        "engine": engine,
        "slo": {
            t.name: {"ttft_ms": t.ttft_ms, "tpot_ms": t.tpot_ms}
            for t in tiers
        },
        "requests": len(wl.requests),
        "injected_rps": len(wl.requests) / wl.horizon_s,
        "goodput": res.goodput,
        "per_tier_goodput": res.per_tier_goodput,
        "spills": res.spills,
        "spill_total": res.spill_total,
        "reconfig_count": res.reconfig_count,
        # hysteresis calibration pair: windows where a
        # candidate cleared the raw gain threshold vs switches executed —
        # considered >> executed means the net-gain pricing is filtering,
        # considered == 0 on a drifting mix means the criterion is blind
        "switch_considered": res.switch_considered,
        "finished": res.finished,
        "wall_s": wall,
        "trajectory": {
            "goodput_per_s": _downsample(res.timeline, cumulative=False),
            "cumulative_spills": _downsample(res.spill_timeline, cumulative=True),
            "cumulative_reconfigs": _downsample(
                res.reconfig_timeline, cumulative=True
            ),
        },
    }


def run_matrix(
    matrix: Dict[int, Tuple[float, Tuple[str, ...]]],
    seed: int = 0,
    systems: Sequence[str] = SYSTEMS,
    engine: str = "event",
    perf: Optional[PerfModel] = None,
    progress=None,
) -> Dict[int, Dict]:
    """Run the full matrix; returns {n_chips: payload} with one payload per
    cluster size (the per-cluster BENCH trajectory json). SLO tiers are
    derived per scenario (scenario_tiers)."""
    perf = perf or PerfModel(get_config(MODEL))
    tiers_by_scenario: Dict[str, list] = {}
    payloads: Dict[int, Dict] = {}
    for n_chips, (horizon_s, scenarios) in sorted(matrix.items()):
        cells = {}
        for scen in scenarios:
            if scen not in tiers_by_scenario:
                tiers_by_scenario[scen] = scenario_tiers(perf, scen)
            # one deterministic trace per (scenario, cluster), shared by
            # every system replaying the cell
            wl = build_cell_trace(scen, n_chips, horizon_s, seed)
            for system in systems:
                cell = run_cell(
                    system, scen, n_chips, horizon_s, perf,
                    tiers_by_scenario[scen], seed=seed, engine=engine,
                    workload=wl,
                )
                cells[f"{scen}/{system}"] = cell
                if progress is not None:
                    progress(cell)
                # calibration gate: on the drifting-mix scenario the
                # adaptive policy must both SEE switch candidates and
                # EXECUTE some (considered/executed finite and nonzero) —
                # zero considered over a full mix inversion means the
                # criterion is blind, zero executed means the hysteresis
                # is too sticky (the symmetric bug to thrashing). Quick
                # 90 s smokes are exempt: the rolling demand stats barely
                # see the mix move before the trace ends.
                if (scen == "tier_drift" and system == "nitsum"
                        and horizon_s >= 300.0):
                    if not (cell["switch_considered"] > 0
                            and cell["reconfig_count"] > 0):
                        raise AssertionError(
                            f"tier_drift hysteresis calibration failed at "
                            f"{n_chips} chips: switch_considered="
                            f"{cell['switch_considered']} reconfig_count="
                            f"{cell['reconfig_count']} (both must be > 0)"
                        )
        payloads[n_chips] = {
            "n_chips": n_chips,
            "horizon_s": horizon_s,
            "model": MODEL,
            "engine": engine,
            "seed": seed,
            "rps_scale": n_chips / REFERENCE_CHIPS,
            "scenarios": list(scenarios),
            "systems": list(systems),
            "cells": cells,
        }
    return payloads
