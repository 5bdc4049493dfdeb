"""Golden-trajectory regression harness for the event-driven simulator
(mirrors repro/testing/sim_equivalence.py: the same cases, summary and
gate, against the reference's committed goldens).

Successor of the event-vs-fluid equivalence harness: the fluid-tick
reference engine was retired after two consecutive green parity PRs
(ROADMAP carried item), so "matches the reference engine" is no longer a
checkable property. What replaces it is a set of **recorded golden
trajectories**: seeded replay cases whose summary statistics (goodput,
per-tier goodput, finished counts, spills) are committed to
``benchmarks/results/sim_golden.json``. Every case is bit-deterministic —
seeded traces, seeded fault schedules, no wall-clock dependence — so any
drift beyond tolerance is a real behavioural change: either a bug, or an
intentional change that must consciously re-record the goldens.

Two perf models, chosen by ``hw``:

  * ``"v5e"`` (default): the analytic ``PerfModel`` at the reference's
    ``V5E`` spec, checked against the reference's goldens in
    ``benchmarks/results/sim_golden.json``. Those are the reference's
    file: this module reads them and never writes them.
  * ``"h100"``: a ``TabulatedPerfModel`` of the committed llama3-8b table
    measured on an H100 (``profiles/tables/llama3-8b_h100.json``) at the
    ``H100`` spec, checked against this package's own goldens, which
    ``--record`` writes (the replay is host-only and deterministic, so any
    machine records the same file):

    PYTHONPATH=src python -m repro_torch.testing.sim_equivalence --hw h100 --record

The case set spans the regimes the old parity suite pinned (short-context
two-tier, long-context KV backpressure, non-stationary scenarios) plus the
fault families (docs/faults.md) — fault-path changes are regression-gated
here, with ``kv_audit=True`` so every golden replay also proves exact KV
conservation under forced frees.

Used by tests/test_torch_simulator.py (goodput within ``DEFAULT_RTOL``
of the golden per case, and equal to the reference's replay exactly).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.profiles.perf_model import H100, PerfModel, clear_perf_caches
from repro_torch.profiles.profiler import ProfileTable, TabulatedPerfModel
from repro_torch.profiles.slo import derive_tiers
from repro_torch.serving.admission import AdmissionController, budgets_from_spec
from repro_torch.serving.simulator import SimResult, run_system
from repro_torch.traces.scenarios import FAULT_SCENARIOS, get_scenario
from repro_torch.traces.servegen import servegen_longctx, servegen_two_tier

MODEL = "llama3-8b"
N_CHIPS = 16
DEFAULT_RTOL = 0.02
GOLDEN_PATH = (
    Path(__file__).resolve().parents[3] / "benchmarks" / "results"
    / "sim_golden.json"
)
H100_GOLDEN_PATH = Path(__file__).resolve().with_name("sim_golden_h100.json")
H100_TABLE = (
    Path(__file__).resolve().parents[1] / "profiles" / "tables"
    / f"{MODEL}_h100.json"
)
HW = ("v5e", "h100")

_SHORT_TIERS = dict(prompt_len=900, ctx_len=1000)
_LONG_TIERS = dict(prompt_len=14000, ctx_len=15000)


def _case_library() -> Dict[str, Callable[[], dict]]:
    """name -> factory for one replay case. Factories are lazy so importing
    the module never builds traces. ``fast`` marks the reference's default
    CI lane (its tests/test_sim_equivalence.py); the port's tests replay
    every case."""
    cases: Dict[str, Callable[[], dict]] = {}

    def add(name: str, fast: bool, **kw) -> None:
        factory = dict(kw)

        def build(factory=factory):
            spec = dict(factory)
            spec["workload"] = spec.pop("mk_workload")()
            return spec

        build.fast = fast
        cases[name] = build

    for system in ("nitsum", "sglang"):
        add(
            f"two_tier/{system}", fast=True, system=system,
            tiers_kw=_SHORT_TIERS,
            mk_workload=lambda: servegen_two_tier(horizon_s=60.0, seed=0),
        )
        add(
            f"longctx/{system}", fast=(system == "sglang"), system=system,
            tiers_kw=_LONG_TIERS,
            mk_workload=lambda: servegen_longctx(horizon_s=90.0, seed=0),
        )
    add(
        "flash_crowd/nitsum", fast=True, system="nitsum",
        tiers_kw=_SHORT_TIERS,
        mk_workload=lambda: get_scenario("flash_crowd").build(
            seed=0, horizon_s=60.0
        ),
    )
    for name in ("diurnal", "tier_drift", "longctx_phases", "prefill_heavy",
                 "decode_heavy"):
        add(
            f"{name}/nitsum", fast=False, system="nitsum",
            tiers_kw=_SHORT_TIERS,
            mk_workload=lambda name=name: get_scenario(name).build(
                seed=1, horizon_s=90.0
            ),
        )
    # fault families: every golden fault replay runs with kv_audit=True, so
    # checking the golden also proves exact KV conservation under forced
    # frees; host_loss is in the fast lane as the representative family
    for name in FAULT_SCENARIOS:
        fast = name == "fault_host_loss"
        for system in ("nitsum", "sglang"):
            add(
                f"{name}/{system}", fast=fast and system == "nitsum",
                system=system, tiers_kw=_SHORT_TIERS, kv_audit=True,
                mk_workload=lambda name=name: get_scenario(name).build(
                    seed=0, horizon_s=180.0
                ),
            )
    # correlated cascades (docs/faults.md §Failure domains): pure additions
    # — domain-resolved kills, partial degradation and checkpointed
    # restores are all new code paths, so existing goldens stay
    # byte-identical. "nitsum-resilient" + kv_checkpoint is exactly the
    # cascade-matrix "nitsum" system.
    for name in ("cascade_host", "cascade_rack"):
        add(
            f"{name}/nitsum", fast=(name == "cascade_host"),
            system="nitsum-resilient", tiers_kw=_SHORT_TIERS, kv_audit=True,
            kv_checkpoint=True,
            mk_workload=lambda name=name: get_scenario(name).build(
                seed=0, horizon_s=180.0
            ),
        )
    # multi-tenant cases (docs/tenancy.md): gated WITH token-budget
    # admission (throttle/retry path) and open (tenant identity threads
    # through routing/metrics but nothing throttles). Existing cases stay
    # byte-identical — tenant fields only enter the summary when present.
    add(
        "noisy_neighbor/nitsum", fast=True, system="nitsum",
        tiers_kw=_SHORT_TIERS,
        mk_workload=lambda: get_scenario("noisy_neighbor").build(
            seed=0, horizon_s=90.0
        ),
        mk_admission=lambda: AdmissionController(
            budgets_from_spec(get_scenario("noisy_neighbor"))
        ),
    )
    add(
        "noisy_neighbor_open/nitsum", fast=False, system="nitsum",
        tiers_kw=_SHORT_TIERS,
        mk_workload=lambda: get_scenario("noisy_neighbor").build(
            seed=0, horizon_s=90.0
        ),
    )
    return cases


CASES = _case_library()


def list_cases(fast_only: bool = False) -> List[str]:
    return [n for n, c in CASES.items() if c.fast or not fast_only]


def summarize(res: SimResult) -> dict:
    """The recorded per-case statistics. Everything here is deterministic
    under fixed seeds; floats are rounded so the committed json is stable
    across platforms at well below the check tolerance."""
    out = {
        "policy": res.policy,
        "goodput": round(res.goodput, 4),
        "per_tier_goodput": {
            t: round(v, 4) for t, v in sorted(res.per_tier_goodput.items())
        },
        "finished": res.finished,
        "spill_total": res.spill_total,
        "reconfig_count": res.reconfig_count,
        "fault_restart_total": res.fault_restart_total,
        "fault_count": len(res.fault_timeline),
    }
    # checkpointed-restore block only when restores actually fired
    # (kv_checkpoint cases): every pre-existing golden stays byte-identical
    if res.ckpt_restores:
        out["ckpt_restores"] = res.ckpt_restores
        out["ckpt_restored_tokens"] = round(res.ckpt_restored_tokens, 1)
        out["ckpt_saved_prefill_s"] = round(res.ckpt_saved_prefill_s, 3)
    # tenant block only for genuinely multi-tenant (or throttled) replays:
    # single-default-tenant cases keep their committed goldens byte-identical
    named = {t for t in res.tenant_goodput if t != "default"}
    if named or res.tenant_throttled:
        out["tenant_goodput"] = {
            t: round(v, 4) for t, v in sorted(res.tenant_goodput.items())
        }
        out["tenant_throttled"] = dict(sorted(res.tenant_throttled.items()))
        out["tenant_retries"] = dict(sorted(res.tenant_retries.items()))
        out["tenant_demoted"] = dict(sorted(res.tenant_demoted.items()))
    return out


def perf_model(hw: str = "v5e") -> PerfModel:
    """The case's perf model. Call ``clear_perf_caches()`` first: tabulated
    models of one config share the memo whatever their tables."""
    cfg = get_config(MODEL)
    if hw == "v5e":
        return PerfModel(cfg)
    if hw == "h100":
        return TabulatedPerfModel(cfg, ProfileTable.load(str(H100_TABLE)), hw=H100)
    raise ValueError(f"unknown hw {hw!r}; known: {HW}")


def golden_path(hw: str = "v5e") -> Path:
    return {"v5e": GOLDEN_PATH, "h100": H100_GOLDEN_PATH}[hw]


def replay_case(name: str, hw: str = "v5e"):
    """Replay one case; returns (simulator, workload), so that a caller can
    read the per-request records as well as the summary."""
    spec = CASES[name]()
    clear_perf_caches()
    perf = perf_model(hw)
    tiers = derive_tiers(perf, candidate_tps=(1, 2, 4, 8), **spec["tiers_kw"])
    wl = spec["workload"]
    mk_adm = spec.get("mk_admission")
    sim, _ = run_system(
        spec["system"], perf, tiers, spec.get("n_chips", N_CHIPS), wl,
        kv_audit=spec.get("kv_audit", False),
        kv_checkpoint=spec.get("kv_checkpoint", False),
        admission=mk_adm() if mk_adm is not None else None,
    )
    return sim, wl


def run_case(name: str, hw: str = "v5e") -> dict:
    sim, wl = replay_case(name, hw)
    return summarize(sim.result(wl.horizon_s))


def load_golden(path: Optional[Path] = None, hw: str = "v5e") -> dict:
    p = Path(path) if path else golden_path(hw)
    with open(p) as f:
        return json.load(f)


def check_case(
    name: str,
    golden: Optional[dict] = None,
    rtol: float = DEFAULT_RTOL,
    hw: str = "v5e",
    got: Optional[dict] = None,
) -> List[str]:
    """Replay one case (or take ``got``, its summary already replayed) and
    compare against its golden; returns violation strings (empty = green).
    Gate semantics:

      * goodput (total and per-tier) within ``rtol`` relative;
      * finished within max(2, rtol·golden) requests;
      * spills agree on zero-vs-nonzero and within 2x when nonzero;
      * fault counts exact (the schedule is part of the trace).
    """
    g = (golden or load_golden(hw=hw))["cases"][name]
    if got is None:
        got = run_case(name, hw)
    bad: List[str] = []

    def rel(label: str, a: float, b: float, tol: float = rtol) -> None:
        ref = max(abs(b), 1e-9)
        if abs(a - b) / ref > tol:
            bad.append(f"{name}: {label} {a} vs golden {b} (> {tol:.0%})")

    rel("goodput", got["goodput"], g["goodput"])
    for tier, v in g["per_tier_goodput"].items():
        if v > 0.5:  # tiny per-tier rates are all noise
            rel(f"per_tier_goodput[{tier}]",
                got["per_tier_goodput"].get(tier, 0.0), v, tol=2 * rtol)
    if abs(got["finished"] - g["finished"]) > max(2, rtol * g["finished"]):
        bad.append(
            f"{name}: finished {got['finished']} vs golden {g['finished']}"
        )
    gs, es = got["spill_total"], g["spill_total"]
    if (gs == 0) != (es == 0) or (es and not 0.5 <= gs / es <= 2.0):
        bad.append(f"{name}: spill_total {gs} vs golden {es}")
    if got["fault_count"] != g["fault_count"]:
        bad.append(
            f"{name}: fault_count {got['fault_count']} != {g['fault_count']}"
        )
    # checkpointed restores (cascade cases): zero-vs-nonzero and within 2x
    ec = g.get("ckpt_restores", 0)
    gc = got.get("ckpt_restores", 0)
    if (gc == 0) != (ec == 0) or (ec and not 0.5 <= gc / ec <= 2.0):
        bad.append(f"{name}: ckpt_restores {gc} vs golden {ec}")
    # tenant gates (only present on multi-tenant cases): per-tenant goodput
    # within 2·rtol, throttle counts agree on zero-vs-nonzero and within 2x
    for ten, v in g.get("tenant_goodput", {}).items():
        if v > 0.5:
            rel(f"tenant_goodput[{ten}]",
                got.get("tenant_goodput", {}).get(ten, 0.0), v, tol=2 * rtol)
    for ten, et in g.get("tenant_throttled", {}).items():
        gt = got.get("tenant_throttled", {}).get(ten, 0)
        if (gt == 0) != (et == 0) or (et and not 0.5 <= gt / et <= 2.0):
            bad.append(f"{name}: tenant_throttled[{ten}] {gt} vs golden {et}")
    return bad


def record(
    names: Optional[Sequence[str]] = None, path: Optional[Path] = None,
    hw: str = "h100",
) -> dict:
    """Re-run the named cases (default: all) at ``hw`` and write the golden
    file, preserving existing entries for cases not re-run. Never writes
    the reference's goldens (``GOLDEN_PATH``)."""
    p = Path(path) if path else golden_path(hw)
    if p.resolve() == GOLDEN_PATH.resolve():
        raise ValueError(
            f"{GOLDEN_PATH} holds the reference's goldens; record them with "
            "the reference's harness"
        )
    payload = {"model": MODEL, "n_chips": N_CHIPS, "rtol": DEFAULT_RTOL,
               "hw": hw, "cases": {}}
    if p.exists():
        payload["cases"] = load_golden(p).get("cases", {})
    for name in names or list(CASES):
        payload["cases"][name] = run_case(name, hw)
        print(f"recorded {name}: {payload['cases'][name]}")
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--record", action="store_true",
                    help="re-run cases and rewrite this package's golden "
                         "file of --hw (h100 only: the v5e goldens are the "
                         "reference's)")
    ap.add_argument("--hw", choices=HW, default="v5e",
                    help="v5e: the analytic model at V5E against the "
                         "reference's goldens; h100: the committed H100 "
                         "table against this package's goldens")
    ap.add_argument("--only", default=None,
                    help="comma-separated substring filters on case names")
    args = ap.parse_args()
    if args.only:
        pats = args.only.split(",")
        names = [n for n in CASES if any(p in n for p in pats)]
        if not names:
            # silent zero-match reads as "everything passed"
            raise SystemExit(
                f"--only {args.only!r} matched no case; "
                f"known: {sorted(CASES)}"
            )
    else:
        names = list(CASES)
    if args.record:
        record(names, hw=args.hw)
        return
    golden = load_golden(hw=args.hw)
    bad: List[str] = []
    for n in names:
        errs = check_case(n, golden, hw=args.hw)
        bad += errs
        print(f"{'FAIL' if errs else 'ok  '} {n}")
    if bad:
        raise SystemExit("\n".join(bad))


if __name__ == "__main__":
    main()
