"""Gate for the length-heavy scenario regimes (mirrors
repro/testing/length_regime_gate.py).

On the quick scenario matrix (``testing.scenario_matrix``):

  * nitsum must stay within ``LENGTH_REGIME_RATIO`` (1.3x) of the static
    baseline on every length-regime cell (prefill_heavy, decode_heavy);
  * nitsum must still WIN (>=) every MIX scenario cell outright.

Run as a module::

    PYTHONPATH=src python -m repro_torch.testing.length_regime_gate [--hw h100]

which replays the quick matrix (90 s horizons) and exits nonzero with a
per-cell report on any violation. ``--hw v5e`` (the default) prices it with
``PerfModel`` at the V5E spec, for parity with the reference's gate (its
goodputs are the reference's, digit for digit: a parity check, not a
measurement); ``--hw h100`` with the ``TabulatedPerfModel`` of the
committed llama3-8b table measured on an H100
(``testing.sim_equivalence.perf_model``). ``gate_violations`` is pure.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.profiles.perf_model import clear_perf_caches
from repro_torch.testing.scenario_matrix import LENGTH_REGIMES, QUICK_MATRIX, run_matrix
from repro_torch.testing.sim_equivalence import HW, perf_model

LENGTH_REGIME_RATIO = 1.3


def gate_violations(payload: Dict) -> List[str]:
    """Check one per-cluster scenario-matrix payload; returns violation
    strings (empty == gate passed). Scenarios missing either system's
    cell are skipped — the gate judges contests, not coverage."""
    n = payload.get("n_chips", "?")
    out: List[str] = []
    for scen in payload.get("scenarios", ()):
        git = payload["cells"].get(f"{scen}/nitsum")
        sta = payload["cells"].get(f"{scen}/sglang")
        if not git or not sta:
            continue
        g, s = git["goodput"], sta["goodput"]
        if scen in LENGTH_REGIMES:
            if g * LENGTH_REGIME_RATIO < s:
                out.append(
                    f"{n}chips/{scen}: nitsum {g:.1f} vs static {s:.1f} "
                    f"req/s — outside the {LENGTH_REGIME_RATIO}x "
                    f"length-regime bound"
                )
        elif g < s:
            out.append(
                f"{n}chips/{scen}: nitsum {g:.1f} lost a MIX scenario to "
                f"static {s:.1f} req/s"
            )
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hw", choices=HW, default="v5e",
                    help="v5e: PerfModel at the V5E spec (the reference's gate); "
                         "h100: the committed H100 table")
    args = ap.parse_args(argv)
    clear_perf_caches()
    payloads = run_matrix(QUICK_MATRIX, perf=perf_model(args.hw))
    violations: List[str] = []
    for n_chips, payload in sorted(payloads.items()):
        violations += gate_violations(payload)
        for key, cell in payload["cells"].items():
            print(
                f"# length_regime_gate {n_chips}chips {key}: "
                f"goodput={cell['goodput']:.1f}",
                flush=True,
            )
    if violations:
        print("LENGTH-REGIME GATE FAILED:", file=sys.stderr)
        for v in violations:
            print(f"  - {v}", file=sys.stderr)
        return 1
    print("# length_regime_gate: all cells within bounds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
