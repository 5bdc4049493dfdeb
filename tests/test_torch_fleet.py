"""The port's fleet layer (repro_torch.serving.fleet) against the
reference's: ``run_fleet`` on small fleets, and the handle-level
``FleetScheduler``.

Both packages run the same float arithmetic in the same order on the same
seeded traces, so the tolerance is exact: the whole ``FleetResult``
(every cell's ``SimResult`` included) and the merged meter's per-request
records must be equal.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as R_get_config  # noqa: E402
from repro.profiles import perf_model as R_pm  # noqa: E402
from repro.profiles.slo import derive_tiers as R_derive_tiers  # noqa: E402
from repro.serving import fleet as R_fleet  # noqa: E402
from repro.serving import global_scheduler as R_gs  # noqa: E402
from repro.serving.admission import AdmissionController as R_Admission  # noqa: E402
from repro.serving.admission import budgets_from_spec as R_budgets  # noqa: E402
from repro.traces import scenarios as R_scen  # noqa: E402
from repro_torch.configs import get_config as P_get_config  # noqa: E402
from repro_torch.profiles import perf_model as P_pm  # noqa: E402
from repro_torch.profiles.slo import derive_tiers as P_derive_tiers  # noqa: E402
from repro_torch.serving import fleet as P_fleet  # noqa: E402
from repro_torch.serving import global_scheduler as P_gs  # noqa: E402
from repro_torch.serving.admission import AdmissionController as P_Admission  # noqa: E402
from repro_torch.serving.admission import budgets_from_spec as P_budgets  # noqa: E402
from repro_torch.traces import scenarios as P_scen  # noqa: E402

PORT = dict(pm=P_pm, get_config=P_get_config, derive_tiers=P_derive_tiers, fleet=P_fleet, scen=P_scen,
            admission=P_Admission, budgets=P_budgets)
REF = dict(pm=R_pm, get_config=R_get_config, derive_tiers=R_derive_tiers, fleet=R_fleet, scen=R_scen,
           admission=R_Admission, budgets=R_budgets)

FLEETS = {
    # (system, scenario, seed, horizon, n_cells, chips per cell, options)
    "two_cells_flash_crowd": ("nitsum", "flash_crowd", 2, 40.0, 2, 8, {}),
    "three_cells_sglang": ("sglang", "tier_drift", 1, 40.0, 3, 8, {}),
    "two_cells_host_loss": ("nitsum", "fault_host_loss", 0, 90.0, 2, 16, {"kv_audit": True}),
    "two_cells_noisy_admission": ("nitsum", "noisy_neighbor", 0, 40.0, 2, 8, {"admission": True}),
}


def run(pkg, system, scenario, seed, horizon, n_cells, chips, opts):
    pkg["pm"].clear_perf_caches()
    perf = pkg["pm"].PerfModel(pkg["get_config"]("llama3-8b"))
    tiers = pkg["derive_tiers"](perf, prompt_len=900, ctx_len=1000, candidate_tps=(1, 2, 4, 8))
    wl = pkg["scen"].get_scenario(scenario).build(seed=seed, horizon_s=horizon)
    kw = dict(opts)
    if kw.pop("admission", False):
        kw["admission"] = pkg["admission"](pkg["budgets"](pkg["scen"].get_scenario(scenario)))
    fleet, meter = pkg["fleet"].run_fleet(system, perf, tiers, n_cells, chips, wl, seed=seed, **kw)
    return fleet.result(wl.horizon_s), [dataclasses.astuple(r) for r in meter.records]


def fields(res):
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    out["cells"] = [{f.name: getattr(c, f.name) for f in dataclasses.fields(c)} for c in res.cells]
    return out


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_run_fleet_matches_reference(fleet):
    (got, got_recs), (want, want_recs) = run(PORT, *FLEETS[fleet]), run(REF, *FLEETS[fleet])
    assert fields(got) == fields(want)
    assert got_recs == want_recs
    assert got.finished > 0 and len(got.cells) == FLEETS[fleet][4]


def test_fleet_scheduler_matches_reference():
    """The handle-level front door, with and without tenant keys, over
    plain and sharded cell schedulers: every pick, the cross-cell retry
    count and the handles' commitments after the batch."""
    def picks(gs, fleet_mod, sharded, tenants):
        rng = np.random.RandomState(5)

        def cell(c):
            hs = [gs.GroupHandle(g, (None, "strict", "relaxed")[(g + c) % 3], "mixed", 2,
                                 max_rps=float(rng.uniform(0.5, 4.0))) for g in range(6)]
            return gs.ShardedScheduler(hs, n_shards=2, seed=c) if sharded else gs.GlobalScheduler(hs)

        fs = fleet_mod.FleetScheduler([cell(c) for c in range(4)], seed=3)
        n = 300
        ids = np.arange(n)
        ten = [("default", "tenant_a", "tenant_b")[i % 3] for i in range(n)] if tenants else None
        tiers = [("strict", "relaxed")[i % 2] for i in range(n)]
        costs = rng.uniform(0.01, 0.4, size=n).tolist()
        bgs = (rng.rand(n) < 0.05).tolist()
        out = fs.dispatch_batch(tiers, costs, bgs, ids, now=0.0, tenants=ten)
        return ([(h.gid, ok) for h, ok in out], fs.cross_cell, fs.cell_of(ids, ten).tolist(),
                [sorted((g.gid, g.committed_rps) for g in c.groups.values()) for c in fs.cells])

    for sharded in (False, True):
        for tenants in (False, True):
            assert picks(P_gs, P_fleet, sharded, tenants) == picks(R_gs, R_fleet, sharded, tenants)


def test_fleet_validation():
    with pytest.raises(ValueError):
        P_fleet.FleetSimulator([])
    with pytest.raises(ValueError):
        P_fleet.FleetScheduler([])
