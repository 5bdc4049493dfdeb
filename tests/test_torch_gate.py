"""The port's length-regime gate and the scenario matrix it reads, against
the reference's (repro/testing/length_regime_gate.py,
benchmarks/scenario_matrix.py).

* ``gate_violations``: the reference's test_length_regime_gate_logic cases.
* Two cells of the quick matrix at 64 chips, decode_heavy and diurnal, both
  systems, replayed by both packages at the V5E spec on each package's own
  trace: every field equal, apart from the wall clock (exact: the replay is
  host code on the same seeds).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from benchmarks import scenario_matrix as ref_matrix  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.profiles.perf_model import PerfModel as JPerfModel, clear_perf_caches as j_clear  # noqa: E402
from repro.testing.length_regime_gate import gate_violations as ref_gate_violations  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.profiles.perf_model import PerfModel, clear_perf_caches  # noqa: E402
from repro_torch.testing import scenario_matrix  # noqa: E402
from repro_torch.testing.length_regime_gate import LENGTH_REGIME_RATIO, gate_violations  # noqa: E402


def _gate_payload(cells):
    scenarios = sorted({k.split("/")[0] for k in cells})
    return {"n_chips": 64, "scenarios": scenarios, "cells": {k: {"goodput": v} for k, v in cells.items()}}


GATE_CASES = {
    # all within bounds: decode_heavy inside 1.3x, MIX won
    "ok": ({"decode_heavy/nitsum": 40.0, "decode_heavy/sglang": 50.0,
            "diurnal/nitsum": 88.0, "diurnal/sglang": 64.0}, None),
    # length regime outside the 1.3x bound
    "length_regime": ({"prefill_heavy/nitsum": 33.0, "prefill_heavy/sglang": 162.0}, "1.3x"),
    # a lost MIX scenario fails even inside 1.3x
    "lost_mix": ({"flash_crowd/nitsum": 60.0, "flash_crowd/sglang": 66.0}, "MIX"),
    # one-sided cells are skipped
    "partial": ({"decode_heavy/nitsum": 1.0}, None),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_logic_matches_reference_cases(case):
    cells, needle = GATE_CASES[case]
    got = gate_violations(_gate_payload(cells))
    assert got == ref_gate_violations(_gate_payload(cells))
    if needle is None:
        assert got == []
    else:
        assert got and any(needle in v for v in got)
    assert LENGTH_REGIME_RATIO == 1.3


def test_matrix_tables_match_reference():
    for name in ("SYSTEMS", "REFERENCE_CHIPS", "FULL_MATRIX", "QUICK_MATRIX", "LENGTH_REGIMES",
                 "TRAJECTORY_POINTS"):
        assert getattr(scenario_matrix, name) == getattr(ref_matrix, name), name
    assert scenario_matrix.MODEL == ref_matrix.MODEL and scenario_matrix.CANDIDATE_TPS == ref_matrix.CANDIDATE_TPS


def _plain(x):
    """Tuples as lists and numpy scalars as Python numbers, so that the
    packages' cells compare as data."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("scenario", ["decode_heavy", "diurnal"])
def test_quick_matrix_cells_match_reference(scenario):
    horizon, names = scenario_matrix.QUICK_MATRIX[64]
    assert scenario in names
    j_clear()
    jperf = JPerfModel(j_get_config(ref_matrix.MODEL))
    jtiers = ref_matrix.scenario_tiers(jperf, scenario)
    jwl = ref_matrix.build_cell_trace(scenario, 64, horizon)
    clear_perf_caches()
    perf = PerfModel(get_config(scenario_matrix.MODEL))
    tiers = scenario_matrix.scenario_tiers(perf, scenario)
    wl = scenario_matrix.build_cell_trace(scenario, 64, horizon)
    for system in scenario_matrix.SYSTEMS:
        want = ref_matrix.run_cell(system, scenario, 64, horizon, jperf, jtiers, workload=jwl)
        got = scenario_matrix.run_cell(system, scenario, 64, horizon, perf, tiers, workload=wl)
        want.pop("wall_s")
        got.pop("wall_s")
        assert _plain(got) == _plain(want), system
        assert got["goodput"] > 0
