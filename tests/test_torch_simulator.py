"""The port's serving simulator (repro_torch.serving.simulator) and its
golden harness (repro_torch.testing.sim_equivalence) against the
reference's.

Tolerance: exact everywhere except where a test says it checks a golden.
Both packages run the same float arithmetic in the same order on the same
seeded traces, so a replay's whole ``SimResult`` (timelines, fault log,
incidents, per-tenant counts, unrounded) and its meter's per-request
records must be equal. The goldens are checked with the harness's own gate
(``check_case`` at ``DEFAULT_RTOL``): the reference's V5E goldens in
``benchmarks/results/sim_golden.json``, and the port's H100 goldens in
``src/repro_torch/testing/sim_golden_h100.json``.
"""
import dataclasses
import hashlib
import json

import pytest

pytest.importorskip("torch")

from repro.configs import get_config as R_get_config  # noqa: E402
from repro.profiles import perf_model as R_pm  # noqa: E402
from repro.profiles import profiler as R_prof  # noqa: E402
from repro.profiles.slo import derive_tiers as R_derive_tiers  # noqa: E402
from repro.serving import simulator as R_sim  # noqa: E402
from repro.testing import sim_equivalence as R_eq  # noqa: E402
from repro.traces.servegen import servegen_two_tier as R_two_tier  # noqa: E402
from repro_torch.configs import get_config as P_get_config  # noqa: E402
from repro_torch.profiles import perf_model as P_pm  # noqa: E402
from repro_torch.profiles.slo import derive_tiers as P_derive_tiers  # noqa: E402
from repro_torch.serving import simulator as P_sim  # noqa: E402
from repro_torch.testing import sim_equivalence as P_eq  # noqa: E402
from repro_torch.traces.servegen import servegen_two_tier as P_two_tier  # noqa: E402

CASES = list(R_eq.CASES)


def ref_replay(name, perf_factory=None):
    """The reference's ``run_case`` up to the summary: (sim, workload)."""
    spec = R_eq.CASES[name]()
    R_pm.clear_perf_caches()
    perf = R_pm.PerfModel(R_get_config(R_eq.MODEL)) if perf_factory is None else perf_factory()
    tiers = R_derive_tiers(perf, candidate_tps=(1, 2, 4, 8), **spec["tiers_kw"])
    wl = spec["workload"]
    mk_adm = spec.get("mk_admission")
    sim, _ = R_sim.run_system(
        spec["system"], perf, tiers, spec.get("n_chips", R_eq.N_CHIPS), wl,
        kv_audit=spec.get("kv_audit", False), kv_checkpoint=spec.get("kv_checkpoint", False),
        admission=mk_adm() if mk_adm is not None else None,
    )
    return sim, wl


def records(sim):
    return [dataclasses.astuple(r) for r in sim.meter.records]


def fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_same_replay(got, want):
    """Equal replays; returns the two results."""
    (gs, gw), (ws, ww) = got, want
    assert gw.horizon_s == ww.horizon_s
    gr, wr = gs.result(gw.horizon_s), ws.result(ww.horizon_s)
    assert fields(gr) == fields(wr)
    assert records(gs) == records(ws)
    return gr, wr


def test_case_library_matches_reference():
    assert list(P_eq.CASES) == CASES and len(CASES) == 24
    assert [c.fast for c in P_eq.CASES.values()] == [c.fast for c in R_eq.CASES.values()]
    assert (P_eq.MODEL, P_eq.N_CHIPS, P_eq.DEFAULT_RTOL) == (R_eq.MODEL, R_eq.N_CHIPS, R_eq.DEFAULT_RTOL)
    assert P_eq.GOLDEN_PATH == R_eq.GOLDEN_PATH and P_eq.GOLDEN_PATH.exists()


@pytest.mark.parametrize("name", CASES)
def test_case_matches_reference_and_golden(name):
    """One golden case at V5E: the port's replay equals the reference's
    (whole result and per-request records, exactly), its summary equals
    the reference's summary, and it passes the reference's golden gate."""
    gr, wr = assert_same_replay(P_eq.replay_case(name), ref_replay(name))
    summary = P_eq.summarize(gr)
    assert summary == R_eq.summarize(wr)
    assert P_eq.check_case(name, got=summary) == []


@pytest.mark.parametrize("name", ("two_tier/sglang", "longctx/sglang"))
def test_run_case_matches_reference(name):
    assert P_eq.run_case(name) == R_eq.run_case(name)
    assert P_eq.check_case(name) == []


def test_replay_is_bit_deterministic():
    """Two replays of a fault case with the KV audit and checkpointed
    restores armed give the same result and records, bit for bit."""
    a, _ = assert_same_replay(P_eq.replay_case("cascade_host/nitsum"), P_eq.replay_case("cascade_host/nitsum"))
    assert a.ckpt_restores > 0 and a.fault_timeline


def ref_h100():
    """The reference's perf model at the port's H100 fields and table."""
    hw = R_pm.HardwareSpec(**dataclasses.asdict(P_pm.H100))
    table = R_prof.ProfileTable.load(str(P_eq.H100_TABLE))
    return R_prof.TabulatedPerfModel(R_get_config(R_eq.MODEL), table, hw=hw)


@pytest.mark.parametrize("name", ("two_tier/nitsum", "two_tier/sglang", "fault_straggler/sglang"))
def test_h100_replay_matches_reference_at_same_fields_and_table(name):
    assert_same_replay(P_eq.replay_case(name, "h100"), ref_replay(name, ref_h100))


def h100_golden():
    return json.loads(P_eq.H100_GOLDEN_PATH.read_text())


def test_h100_golden_file_covers_every_case():
    g = h100_golden()
    assert set(g["cases"]) == set(P_eq.CASES)
    assert (g["model"], g["n_chips"], g["rtol"], g["hw"]) == (P_eq.MODEL, P_eq.N_CHIPS, P_eq.DEFAULT_RTOL, "h100")
    assert all(c["goodput"] > 0 and c["finished"] > 0 for c in g["cases"].values())


@pytest.mark.parametrize("name", CASES)
def test_h100_golden(name):
    """Each case at the committed H100 table stays within the harness's
    gate (``DEFAULT_RTOL``) of the port's recorded H100 golden."""
    assert P_eq.check_case(name, golden=h100_golden(), hw="h100") == []


def test_record_writes_only_the_ports_goldens(tmp_path):
    before = hashlib.sha256(P_eq.GOLDEN_PATH.read_bytes()).hexdigest()
    with pytest.raises(ValueError):
        P_eq.record(["longctx/sglang"], path=P_eq.GOLDEN_PATH, hw="v5e")
    out = tmp_path / "golden.json"
    payload = P_eq.record(["longctx/sglang"], path=out, hw="h100")
    assert json.loads(out.read_text()) == payload
    assert payload["cases"]["longctx/sglang"] == h100_golden()["cases"]["longctx/sglang"]
    assert hashlib.sha256(P_eq.GOLDEN_PATH.read_bytes()).hexdigest() == before


SYSTEMS = ("nitsum", "nitsum-slowswitch", "nitsum-resilient", "sglang", "sglang-pd", "sglang-slo", "split",
           "llumnix", "chiron", "oracle", "static-tp2", "static-tp4-pd")


@pytest.mark.parametrize("system", SYSTEMS)
def test_every_policy_matches_reference(system):
    """Every policy ``make_policy`` builds (the Fig. 9 baselines among
    them) on a 20 s two-tier trace at twice its rate, 16 chips."""
    def run(pm, get_config, derive_tiers, sim_mod, two_tier):
        pm.clear_perf_caches()
        perf = pm.PerfModel(get_config("llama3-8b"))
        tiers = derive_tiers(perf, prompt_len=900, ctx_len=1000, candidate_tps=(1, 2, 4, 8))
        wl = two_tier(horizon_s=20.0, seed=2, rps_scale=2.0)
        return sim_mod.run_system(system, perf, tiers, 16, wl)[0], wl

    got = run(P_pm, P_get_config, P_derive_tiers, P_sim, P_two_tier)
    want = run(R_pm, R_get_config, R_derive_tiers, R_sim, R_two_tier)
    assert got[0].policy.name == want[0].policy.name
    assert_same_replay(got, want)


def test_unknown_engine_is_refused():
    P_pm.clear_perf_caches()
    perf = P_pm.PerfModel(P_get_config("llama3-8b"))
    tiers = P_derive_tiers(perf, prompt_len=900, ctx_len=1000)
    with pytest.raises(ValueError):
        P_sim.run_system("sglang", perf, tiers, 8, P_two_tier(horizon_s=5.0), engine="fluid")
