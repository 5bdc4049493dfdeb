"""The port's traces (repro_torch.traces: workload, servegen, azure,
scenarios) and scenario checks against the reference's.

Both packages draw every trace from the same ``np.random.RandomState``
streams in the same order, so the tolerance is exact everywhere: each
request (id, tier, arrival, lengths, tenant), each fault, the horizon and
the topology must be equal, and the scenario checks must return equal
results on the two packages' traces.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.testing import scenario_checks as R_checks  # noqa: E402
from repro.traces import azure as R_azure  # noqa: E402
from repro.traces import scenarios as R_scen  # noqa: E402
from repro.traces import servegen as R_sg  # noqa: E402
from repro.traces import workload as R_wl  # noqa: E402
from repro_torch.testing import scenario_checks as P_checks  # noqa: E402
from repro_torch.traces import azure as P_azure  # noqa: E402
from repro_torch.traces import scenarios as P_scen  # noqa: E402
from repro_torch.traces import servegen as P_sg  # noqa: E402
from repro_torch.traces import workload as P_wl  # noqa: E402

SEEDS = (0, 1)
# every scenario is built over 5 minutes: envelopes and fault times are
# fractions of the horizon, so every shape term and every fault still runs,
# and the files stay fast (their own horizons are 600 s and an hour)
HORIZON_S = 300.0


def key(wl):
    """Everything a replay reads from a workload, as plain values."""
    return (
        wl.name,
        wl.horizon_s,
        [(r.req_id, r.tier, r.arrival_s, r.prompt_len, r.output_len, r.tenant_id) for r in wl.requests],
        [dataclasses.astuple(f) for f in wl.faults],
        None if wl.topology is None else dataclasses.astuple(wl.topology),
    )


def assert_same(got, want):
    g, w = key(got), key(want)
    assert g[0] == w[0] and g[1] == w[1]
    assert len(g[2]) == len(w[2])
    assert g[2] == w[2]
    assert g[3] == w[3] and g[4] == w[4]


def test_constants_and_registry_match_reference():
    assert P_wl.FAULT_KINDS == R_wl.FAULT_KINDS
    assert P_wl.FAULT_DOMAINS == R_wl.FAULT_DOMAINS
    assert P_wl.DEFAULT_TENANT == R_wl.DEFAULT_TENANT
    assert P_sg.STATS == R_sg.STATS and P_azure.STATS == R_azure.STATS
    assert P_scen.list_scenarios() == R_scen.list_scenarios()
    assert P_scen.FAULT_SCENARIOS == R_scen.FAULT_SCENARIOS
    assert P_scen.CASCADE_SCENARIOS == R_scen.CASCADE_SCENARIOS
    assert P_scen.RPS_PER_USER == R_scen.RPS_PER_USER
    for name in R_scen.list_scenarios():
        assert dataclasses.asdict(P_scen.get_scenario(name)) == dataclasses.asdict(R_scen.get_scenario(name))
    with pytest.raises(KeyError):
        P_scen.get_scenario("no-such-scenario")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", R_scen.list_scenarios())
def test_scenario_matches_reference(name, seed):
    """Each scenario, built by both packages, is equal request by request
    and fault by fault; the scenario checks agree on it (statistics,
    violations) and both packages' determinism checks pass."""
    got = P_scen.get_scenario(name).build(seed=seed, horizon_s=HORIZON_S)
    want = R_scen.get_scenario(name).build(seed=seed, horizon_s=HORIZON_S)
    assert_same(got, want)
    assert got.faults == () or len(got.faults) == len(R_scen.get_scenario(name).faults)
    assert P_checks.trace_statistics(got) == R_checks.trace_statistics(want)
    assert P_checks.scenario_violations(P_scen.get_scenario(name), got) == R_checks.scenario_violations(
        R_scen.get_scenario(name), want
    )
    P_checks.check_determinism(P_scen.get_scenario(name), seed=seed)
    R_checks.check_determinism(R_scen.get_scenario(name), seed=seed)


@pytest.mark.parametrize("rps_scale", (0.5, 2.0))
def test_scaled_scenarios_match_reference(rps_scale):
    for name in ("flash_crowd", "cascade_rack", "noisy_neighbor"):
        got = P_scen.get_scenario(name).build(seed=3, horizon_s=120.0, rps_scale=rps_scale)
        want = R_scen.get_scenario(name).build(seed=3, horizon_s=120.0, rps_scale=rps_scale)
        assert_same(got, want)
        assert P_checks.scenario_violations(P_scen.get_scenario(name), got, rps_scale=rps_scale) == (
            R_checks.scenario_violations(R_scen.get_scenario(name), want, rps_scale=rps_scale)
        )
        assert dataclasses.asdict(P_scen.get_scenario(name).scaled(rps_scale)) == dataclasses.asdict(
            R_scen.get_scenario(name).scaled(rps_scale)
        )


def test_spec_builders_match_reference():
    """noisy_neighbor_spec, cascade_faults and user_scaled_scenario: equal
    specs, and equal traces from them."""
    for flood in (2.0, 5.0):
        assert dataclasses.asdict(P_scen.noisy_neighbor_spec(flood)) == dataclasses.asdict(
            R_scen.noisy_neighbor_spec(flood)
        )
    for family in ("host", "rack", "power", "flaky"):
        got = P_scen.cascade_faults(family, waves=2, corr=1)
        want = R_scen.cascade_faults(family, waves=2, corr=1)
        assert [dataclasses.asdict(f) for f in got] == [dataclasses.asdict(f) for f in want]
    p = P_scen.user_scaled_scenario("diurnal", users=10_000)
    r = R_scen.user_scaled_scenario("diurnal", users=10_000)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert_same(p.build(seed=1, horizon_s=60.0), r.build(seed=1, horizon_s=60.0))


BUILDERS = {
    "servegen_conversation": lambda m, seed: m["sg"].servegen_workload("conversation", "strict", 120.0, seed),
    "servegen_code_rps": lambda m, seed: m["sg"].servegen_workload("code", "relaxed", 120.0, seed, rps=4.0),
    "servegen_two_tier": lambda m, seed: m["sg"].servegen_two_tier(horizon_s=120.0, seed=seed),
    "servegen_two_tier_x2": lambda m, seed: m["sg"].servegen_two_tier(horizon_s=60.0, seed=seed, rps_scale=2.0),
    "servegen_longctx": lambda m, seed: m["sg"].servegen_longctx(horizon_s=120.0, seed=seed),
    "servegen_hourlong": lambda m, seed: m["sg"].servegen_hourlong("tier_drift", horizon_s=120.0, seed=seed),
    "servegen_shifting": lambda m, seed: m["sg"].servegen_shifting(horizon_s=120.0, seed=seed),
    "azure_conversation": lambda m, seed: m["az"].azure_workload("conversation", "strict", 300.0, seed),
    "azure_two_tier": lambda m, seed: m["az"].azure_two_tier(horizon_s=120.0, seed=seed, rps_scale=10.0),
    "make_workload_envelope": lambda m, seed: m["wl"].make_workload(
        "env", "strict", 3.0, 500.0, 60.0, horizon_s=200.0, seed=seed, burstiness=0.8,
        envelope=np.linspace(0.2, 1.8, 200), tenant_id="tenant_a"),
    "merge": lambda m, seed: m["wl"].merge_workloads(
        "merged", m["sg"].servegen_workload("code", "relaxed", 100.0, seed),
        m["az"].azure_workload("code", "strict", 100.0, seed + 5)),
}
PKGS = {
    "port": {"sg": P_sg, "az": P_azure, "wl": P_wl},
    "reference": {"sg": R_sg, "az": R_azure, "wl": R_wl},
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builders_match_reference(builder, seed):
    """The published-statistics builders, and ``scaled_rps`` of what they
    build, are equal in both packages."""
    got = BUILDERS[builder](PKGS["port"], seed)
    want = BUILDERS[builder](PKGS["reference"], seed)
    assert_same(got, want)
    assert got.stats() == want.stats()
    for target in (5.0, 40.0):
        assert_same(got.scaled_rps(target, seed=seed), want.scaled_rps(target, seed=seed))


def test_scaled_rps_carries_faults_and_topology():
    got = P_scen.get_scenario("cascade_power").build(seed=0, horizon_s=300.0).scaled_rps(30.0)
    want = R_scen.get_scenario("cascade_power").build(seed=0, horizon_s=300.0).scaled_rps(30.0)
    assert got.faults and got.topology is not None
    assert_same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_and_length_draws_match_reference(seed):
    """The two primitives, draw for draw: bursty_arrivals (with and
    without an envelope, micro-bursts on) and lognormal_lengths."""
    env = np.abs(np.sin(np.linspace(0.0, 6.0, 300))) + 0.1
    for kw in ({}, {"envelope": env}, {"burstiness": 0.0, "micro_burst_rate": 0.2}):
        got = P_wl.bursty_arrivals(np.random.RandomState(seed), 7.5, 300.0, **kw)
        want = R_wl.bursty_arrivals(np.random.RandomState(seed), 7.5, 300.0, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = P_wl.lognormal_lengths(np.random.RandomState(seed), 900.0, 5000, sigma=0.9, lo=8, hi=32768)
    want = R_wl.lognormal_lengths(np.random.RandomState(seed), 900.0, 5000, sigma=0.9, lo=8, hi=32768)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_topology_and_fault_validation_match_reference():
    for kw in ({}, {"chips_per_host": 4, "hosts_per_rack": 2, "racks_per_domain": 3}):
        p, r = P_wl.Topology(**kw), R_wl.Topology(**kw)
        for n in (1, 8, 16, 100):
            assert [p.domain_hosts(d, n) for d in range(p.n_domains(n))] == [
                r.domain_hosts(d, n) for d in range(r.n_domains(n))
            ]
            assert [p.domain_of(c) for c in range(n)] == [r.domain_of(c) for c in range(n)]
    for bad in ({"kind": "meteor", "t_frac": 0.1}, {"kind": "chip_loss", "t_frac": 0.1, "domain": "planet"}):
        with pytest.raises(ValueError):
            P_scen.FaultSpec(**bad)
        with pytest.raises(ValueError):
            R_scen.FaultSpec(**bad)
