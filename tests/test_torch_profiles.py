"""The port's offline profile and the planner that consumes it against the
reference: perf_model (every query at V5E, cached and under
perf_caches_disabled, for every config and TP 1/2/4/8), ProfileTable's JSON
(each package loads the other's files), TabulatedPerfModel with its
fallback, derive_tiers, GoodputMeter, Topology, Planner.plan over a grid,
MigrationModel, and profile_engine on a reduced llama3-8b engine on the
CPU (and on reduced moonshot, for its drop counts). Every comparison is
exact: both packages run the same Python float arithmetic on the same
config numbers.

Three reference notes are shown here with both packages: tabulated models
of one config share the memoised queries whatever their tables,
profile_engine does not measure its batch and context axes, and
Plan.chips_used leaves out mixed groups.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, list_configs as j_list_configs, reduced as j_reduced  # noqa: E402
from repro.core import goodput as jg  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.core.migration import MigrationModel as JMigrationModel  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402
from repro.profiles import perf_model as jpm  # noqa: E402
from repro.profiles import profiler as jprof  # noqa: E402
from repro.profiles.slo import derive_tiers as j_derive_tiers  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.traces.workload import Topology as JTopology  # noqa: E402

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, list_configs, reduced  # noqa: E402
from repro_torch.core import goodput as pg  # noqa: E402
from repro_torch.core import planner as ppl  # noqa: E402
from repro_torch.core.migration import MigrationModel  # noqa: E402
from repro_torch.models import init_params, model_param_defs  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.profiles import perf_model as ppm  # noqa: E402
from repro_torch.profiles import profiler as pprof  # noqa: E402
from repro_torch.profiles.slo import derive_tiers  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.traces.workload import Topology  # noqa: E402

CONFIGS = list_configs()
TPS = (1, 2, 4, 8)
LENS = (1, 7.5, 16, 100, 1000.3, 4096, 32768)
BATCHES = (1, 8, 128)
TTFT_SLOS = (50.0, 300.0, 5000.0)
TPOT_SLOS = (5.0, 20.0, 100.0)


@pytest.fixture(autouse=True)
def cold_caches():
    """Both packages' memos cleared: a tabulated model shares them with any
    other of its config (the reference note below)."""
    jpm.clear_perf_caches()
    ppm.clear_perf_caches()
    yield
    jpm.clear_perf_caches()
    ppm.clear_perf_caches()


def _h100_pair():
    """The port's H100 spec, and the reference's HardwareSpec with the same
    fields."""
    return ppm.H100, jpm.HardwareSpec(**dataclasses.asdict(ppm.H100))


def test_list_configs_and_derived_counts_match_reference():
    assert CONFIGS == j_list_configs() and len(CONFIGS) == 11
    for name in CONFIGS:
        cfg, jcfg = get_config(name), j_get_config(name)
        got = (cfg.param_count(), cfg.active_param_count(), cfg.n_attn_layers, cfg.n_mamba_layers)
        assert got == (jcfg.param_count(), jcfg.active_param_count(), jcfg.n_attn_layers, jcfg.n_mamba_layers), name
        if cfg.mamba is not None:
            assert cfg.d_inner == jcfg.d_inner


def test_quantize_len_and_mid_decode_ctx_match_reference():
    xs = np.concatenate([np.linspace(0, 20, 81), np.geomspace(16.01, 1e10, 400), [0.4999, 0.5, 1.5, 2.5, 16.0]])
    for x in xs:
        assert ppm.quantize_len(float(x)) == jpm.quantize_len(float(x)), x
        assert ppm.mid_decode_ctx(x, 3 * x + 1) == jpm.mid_decode_ctx(x, 3 * x + 1)
    assert (ppm.LEN_QUANT_REL, ppm.TPOT_DESIGN_MARGIN) == (jpm.LEN_QUANT_REL, jpm.TPOT_DESIGN_MARGIN)
    assert dataclasses.asdict(ppm.V5E) == dataclasses.asdict(jpm.V5E)


def _queries(pm):
    """Every PerfModel query over the grid, in one order."""
    out = [pm.n_params, pm.n_active, pm.kv_bytes_per_token(), pm.state_bytes(), pm.min_tp(), pm.min_tp((2, 4, 8))]
    for tp in TPS:
        out += [pm.kv_capacity_bytes(tp), pm.fits(tp), pm.fits(tp, 0.5), pm.allreduce_time(1e6, tp)]
        for n in LENS:
            out += [pm.seq_kv_bytes(n), pm.max_decode_rps(n, 64, tp, 20.0), pm.max_decode_rps(n, 1, tp, 100.0)]
            out += [pm.prefill_time_s(n, tp, b) for b in BATCHES] + [pm.ttft_ms(n, tp)]
            out += [pm.decode_step_time_s(b, n, tp) for b in BATCHES] + [pm.tpot_ms(8, n, tp)]
            out += [pm.max_prefill_rps(n, tp, s) for s in TTFT_SLOS]
            out += [pm.max_decode_batch(n, tp, s) for s in TPOT_SLOS]
            out += [pm.max_decode_batch(n, tp, s, free) for s in TPOT_SLOS for free in (0.0, 3.3e9, 1e12)]
    return out


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "uncached"])
@pytest.mark.parametrize("name", CONFIGS)
def test_perf_model_queries_match_reference_at_v5e(name, cached):
    pm, jpm_ = ppm.PerfModel(get_config(name)), jpm.PerfModel(j_get_config(name))
    if cached:
        assert _queries(pm) == _queries(jpm_)
        assert _queries(pm) == _queries(jpm_)  # warm memos
    else:
        with ppm.perf_caches_disabled(), jpm.perf_caches_disabled():
            assert _queries(pm) == _queries(jpm_)
    assert ppm.perf_cache_info().keys() == jpm.perf_cache_info().keys()


@pytest.mark.parametrize("name", ["llama3-8b", "mamba2-2.7b", "gemma2-2b"])
def test_perf_model_queries_match_reference_at_the_h100_fields(name):
    hw, jhw = _h100_pair()
    assert _queries(ppm.PerfModel(get_config(name), hw)) == _queries(jpm.PerfModel(j_get_config(name), jhw))


def _table(seed, tps=(1, 2)):
    rng = np.random.RandomState(seed)
    t = pprof.ProfileTable()
    for tp in tps:
        for b in (1, 4, 8):
            for ctx in (64, 512):
                t.decode_s[(tp, b, ctx)] = float(rng.uniform(1e-3, 3e-2))
        for L in (32, 64, 128):
            t.prefill_s[(tp, L)] = float(rng.uniform(5e-3, 1e-1))
    return t


def test_profile_table_round_trips_between_packages(tmp_path):
    port = _table(0)
    port.save(str(tmp_path / "port.json"))
    ref = jprof.ProfileTable.load(str(tmp_path / "port.json"))
    assert ref.decode_s == port.decode_s and ref.prefill_s == port.prefill_s
    ref.save(str(tmp_path / "ref.json"))
    back = pprof.ProfileTable.load(str(tmp_path / "ref.json"))
    assert (tmp_path / "ref.json").read_text() == (tmp_path / "port.json").read_text()
    assert back.decode_s == port.decode_s and back.prefill_s == port.prefill_s
    for tp, b, ctx in itertools.product((1, 2), (1, 3, 8, 64), (1, 64, 300, 4096)):
        assert back.decode_time(b, ctx, tp) == ref.decode_time(b, ctx, tp)
    for tp, L in itertools.product((1, 2), (1, 20, 64, 100, 4096)):
        assert back.prefill_time(L, tp) == ref.prefill_time(L, tp)
    for t in (back, ref):
        with pytest.raises(KeyError):
            t.decode_time(8, 64, 4)
        with pytest.raises(KeyError):
            t.prefill_time(64, 8)


@pytest.mark.parametrize("hw_name", ["v5e", "h100"])
def test_tabulated_perf_model_matches_reference_with_its_fallback(tmp_path, hw_name):
    """Rows for TP 1 and 2; TP 4 and 8 fall back to the analytic model."""
    hw, jhw = (ppm.V5E, jpm.V5E) if hw_name == "v5e" else _h100_pair()
    port = _table(1)
    port.save(str(tmp_path / "t.json"))
    pm = pprof.TabulatedPerfModel(get_config("llama3-8b"), port, hw=hw)
    jpm_ = jprof.TabulatedPerfModel(j_get_config("llama3-8b"), jprof.ProfileTable.load(str(tmp_path / "t.json")), hw=jhw)
    assert _queries(pm) == _queries(jpm_)
    assert pm.decode_step_time_s(8, 64, 1) == port.decode_s[(1, 8, 64)]
    assert pm.decode_step_time_s(8, 64, 4) == ppm.PerfModel(get_config("llama3-8b"), hw).decode_step_time_s(8, 64, 4)
    assert pm.prefill_time_s(64, 2, 3) == 3 * port.prefill_s[(2, 64)]
    got = [(t.name, t.ttft_ms, t.tpot_ms, t.background) for t in derive_tiers(pm, 64)]
    assert got == [(t.name, t.ttft_ms, t.tpot_ms, t.background) for t in j_derive_tiers(jpm_, 64)]


def test_tabulated_models_of_one_config_share_the_memo_in_both_packages():
    """Reference note: ``TabulatedPerfModel`` keeps its table outside the
    dataclass fields, and PerfModel hashes and compares (cfg, hw,
    dtype_bytes) only, so two tabulated models of one config with different
    tables hit each other's memoised ``max_prefill_rps`` and
    ``max_decode_batch``. Llama3-8b at TP 2: table A prefills in 20 ms, B
    in 200 ms; B's cached answers are A's, its uncached ones differ. The
    port reproduces it, number for number."""
    def tables(mod):
        a, b = mod.ProfileTable(), mod.ProfileTable()
        a.prefill_s[(2, 128)], b.prefill_s[(2, 128)] = 0.02, 0.2
        a.decode_s[(2, 1, 64)], b.decode_s[(2, 1, 64)] = 0.002, 0.08
        return a, b

    out = {}
    for name, mod, pm_mod, cfg in (("port", pprof, ppm, get_config("llama3-8b")),
                                   ("ref", jprof, jpm, j_get_config("llama3-8b"))):
        a, b = (mod.TabulatedPerfModel(cfg, t) for t in tables(mod))
        assert a == b and hash(a) == hash(b)
        def query(m):
            return m.max_prefill_rps(128, 2, 300.0), m.max_decode_batch(64, 2, 50.0)

        pm_mod.clear_perf_caches()
        cached = [query(a), query(b)]
        pm_mod.clear_perf_caches()
        b_alone = query(b)
        with pm_mod.perf_caches_disabled():
            raw = [query(a), query(b)]
        assert cached[0] == cached[1] != b_alone  # B took A's answers
        assert raw[0] != raw[1] and raw[1][1] == b_alone[1] == 0
        out[name] = cached, b_alone, raw
    assert out["port"] == out["ref"]


def _records(mod, n=60, seed=0):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        arrival = float(rng.uniform(0, 10))
        first = None if rng.rand() < 0.1 else arrival + float(rng.exponential(0.3))
        finish = None if first is None or rng.rand() < 0.1 else first + float(rng.exponential(1.0))
        recs.append(mod.RequestRecord(i, ("strict", "relaxed", "batch")[i % 3], arrival, int(rng.randint(4, 2000)),
                                      int(rng.randint(1, 200)), first, finish, int(rng.randint(0, 200)),
                                      tenant_id=("default", "a", "b")[i % 2 + (i % 5 == 0)]))
    return recs


def test_goodput_meter_matches_reference():
    def meter(mod, recs):
        tiers = {t.name: t for t in mod.default_tiers(120.0, 10.0)}
        tiers["batch"] = mod.SLOTier("batch", 0.0, 0.0, background=True)
        m = mod.GoodputMeter(tiers)
        for r in recs:
            m.add(r)
        return m

    def readings(mod, m, m2):
        merged = mod.GoodputMeter.merged([m, m2])
        return ([m.meets_slo(r) for r in m.records], [(r.ttft_ms, r.tpot_ms) for r in m.records],
                m.goodput(7.5), m.per_tier_goodput(7.5), m.per_tenant_goodput(7.5),
                [m.latency_percentiles(t) for t in ("strict", "relaxed", "batch")],
                [r.req_id for r in merged.records], merged.goodput(15.0), m.tiers["strict"].scaled(1.5).ttft_ms)

    got = readings(pg, meter(pg, _records(pg)), meter(pg, _records(pg, seed=1)))
    want = readings(jg, meter(jg, _records(jg)), meter(jg, _records(jg, seed=1)))
    assert got == want


def test_topology_matches_reference():
    for kw in ({}, {"chips_per_host": 4, "hosts_per_rack": 2, "racks_per_domain": 3}):
        t, jt = Topology(**kw), JTopology(**kw)
        for n in (1, 7, 8, 64, 100):
            assert (t.n_hosts(n), t.n_racks(n), t.n_domains(n)) == (jt.n_hosts(n), jt.n_racks(n), jt.n_domains(n))
            for i in range(t.n_hosts(n)):
                assert t.host_chips(i, n) == jt.host_chips(i, n)
            for r in range(t.n_racks(n)):
                assert t.rack_hosts(r, n) == jt.rack_hosts(r, n)
            for d in range(t.n_domains(n)):
                assert t.domain_hosts(d, n) == jt.domain_hosts(d, n)
        for c in range(70):
            assert (t.host_of(c), t.rack_of(c), t.domain_of(c)) == (jt.host_of(c), jt.rack_of(c), jt.domain_of(c))
        for tp in (1, 2, 4, 8, 16, 32):
            assert t.hosts_spanned(tp) == jt.hosts_spanned(tp)


def _plan_view(plan):
    def stage(s):
        return None if s is None else (s.tp, s.chips)

    return ({n: (stage(t.prefill), stage(t.decode), t.served_rps, stage(t.mixed)) for n, t in plan.tiers.items()},
            plan.leftover_chips, plan.chips_used())


TIER_SETS = {
    "two": [("strict", 300.0, 10.0), ("relaxed", 300.0, 30.0)],
    "three": [("strict", 150.0, 8.0), ("relaxed", 600.0, 40.0), ("batch", 0.0, 0.0, True)],
}


@pytest.mark.parametrize("weight", [0.0, 0.5])
@pytest.mark.parametrize("tiers", sorted(TIER_SETS))
@pytest.mark.parametrize("name", ["llama3-8b", "yi-34b", "moonshot-v1-16b-a3b"])
def test_planner_plans_match_reference(name, tiers, weight):
    """One planner per package over a grid of demands (its candidate memo
    carried across plans, as in a control loop): per tier the same TP
    levels, chips, served rps and mixed groups."""
    planners = [mod.Planner(pm_mod.PerfModel(cfg), [g.SLOTier(*t) for t in TIER_SETS[tiers]],
                            resilience_weight=weight, topology=topo())
                for mod, pm_mod, g, cfg, topo in ((ppl, ppm, pg, get_config(name), Topology),
                                                  (jpl, jpm, jg, j_get_config(name), JTopology))]
    n = 0
    for chips, rps, (plen, olen) in itertools.product((8, 16, 64), ((0.5, 3.0), (4.0, 20.0), (40.0, 1.0)),
                                                       ((128, 64), (2048, 256), (8000, 32))):
        views = []
        for mod, pl in zip((ppl, jpl), planners):
            demands = {"strict": mod.TierDemand(rps[0], plen, olen), "relaxed": mod.TierDemand(rps[1], plen // 2, olen)}
            if tiers == "three":
                demands["batch"] = mod.TierDemand(5.0, plen, olen)
            plan = pl.plan(mod.PlannerInputs(demands, chips))
            views.append(_plan_view(plan))
        assert views[0] == views[1], (chips, rps, plen, olen)
        n += bool(views[0][0])
    assert n > 0  # some demand was served
    port, ref = planners
    for tp in TPS:
        assert port.chip_exposure(tp) == ref.chip_exposure(tp)
    assert ([dataclasses.astuple(c) for c in ppl.enumerate_configs(["a", "b"], TPS)]
            == [dataclasses.astuple(c) for c in jpl.enumerate_configs(["a", "b"], TPS)])


def test_chips_used_leaves_out_mixed_groups_in_both_packages():
    """Reference note: ``Plan.chips_used`` sums the prefill and decode
    groups' chips, and a tier served by colocated ("mixed") groups keeps
    its chips in ``mixed`` only, so they are not counted. llama3-8b at V5E,
    two tiers of 2 and 6 req/s at prompt 64, output 24, on 8 chips: mixed
    groups hold chips that ``chips_used`` leaves out, in both packages."""
    views = []
    for mod, pm_mod, g, cfg in ((ppl, ppm, pg, get_config("llama3-8b")), (jpl, jpm, jg, j_get_config("llama3-8b"))):
        plan = mod.Planner(pm_mod.PerfModel(cfg), g.default_tiers()).plan(mod.PlannerInputs(
            {"strict": mod.TierDemand(2.0, 64, 24), "relaxed": mod.TierDemand(6.0, 64, 24)}, 8))
        mixed = sum(t.mixed.chips for t in plan.tiers.values() if t.mixed is not None)
        assert mixed > 0 and plan.chips_used() + mixed + plan.leftover_chips == 8
        views.append(_plan_view(plan))
    assert views[0] == views[1]


@pytest.mark.parametrize("strategy", ["naive", "aggregated", "pipelined"])
def test_migration_model_matches_reference(strategy):
    hw, jhw = _h100_pair()
    for port, ref in ((MigrationModel(), JMigrationModel()), (MigrationModel(hw=hw), JMigrationModel(hw=jhw)),
                      (MigrationModel(page_bytes=16384, staging_bytes=2**20), JMigrationModel(page_bytes=16384,
                                                                                                staging_bytes=2**20))):
        for nbytes in (0.0, 1.0, 32768.0, 0.537e9, 4.295e9, 1e12):
            assert port.migration_s(nbytes, strategy) == ref.migration_s(nbytes, strategy)
        assert port.ici_bw() == ref.ici_bw()


# ---------------------------------------------------------------------------
# profile_engine on a reduced llama3-8b engine
# ---------------------------------------------------------------------------
ENGINE_KW = dict(n_slots=4, max_len=96, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def llama_pair():
    jcfg, cfg = j_reduced(j_get_config("llama3-8b")), reduced(get_config("llama3-8b"))
    jparams = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, cfg, to_torch(jparams, device="cpu")


@pytest.fixture(scope="module")
def reference_engine(llama_pair):
    """The reference engine at TP 1 on one CPU device."""
    jcfg, jparams, _, _ = llama_pair
    return JServingEngine(jcfg, jparams, devices=jax.devices()[:1],
                          econf=JEngineConfig(candidate_tps=(1,), **ENGINE_KW, dtype=jnp.float32))


def test_profile_engine_keys_match_reference(llama_pair, reference_engine):
    """The same EngineConfig (TP 1: the reference engine runs on one CPU
    device), batches (1, 4, 8) of which 8 exceeds the 4 slots: the same
    keys, every value positive; the engine stays at its TP level."""
    _, _, cfg, params = llama_pair
    want = jprof.profile_engine(reference_engine, batches=(1, 4, 8), ctxs=(64,))
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1,), **ENGINE_KW), device="cpu")
    got = pprof.profile_engine(eng, batches=(1, 4, 8), ctxs=(64,))
    assert set(got.decode_s) == set(want.decode_s) == {(1, 1, 64), (1, 4, 64)}
    assert set(got.prefill_s) == set(want.prefill_s) == {(1, 16), (1, 32)}
    assert all(v > 0 for v in [*got.decode_s.values(), *got.prefill_s.values()])
    assert eng.tp == 1


def test_profile_engine_over_tp_levels(llama_pair):
    """TP 1 and 2 (reduced llama3-8b has 2 KV heads): the reference's keys
    for each level, values positive, the engine's TP level and its served
    tokens unchanged by the profile (the replays write KV rows only where
    no request lives), and the refusal while a request holds a slot."""
    _, _, cfg, params = llama_pair
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2), **ENGINE_KW), device="cpu")
    before = [r.generated for r in eng.run([Request(0, "strict", np.arange(5, 25, dtype=np.int32), 6)])]
    eng.switch_tp(2)
    table = pprof.profile_engine(eng, batches=(1, 4), ctxs=(64, 80))
    assert set(table.decode_s) == {(tp, b, c) for tp in (1, 2) for b in (1, 4) for c in (64, 80)}
    assert set(table.prefill_s) == {(tp, L) for tp in (1, 2) for L in (16, 32)}
    assert all(v > 0 for v in [*table.decode_s.values(), *table.prefill_s.values()])
    assert eng.tp == 2
    eng.switch_tp(1)
    assert [r.generated for r in eng.run([Request(0, "strict", np.arange(5, 25, dtype=np.int32), 6)])] == before
    assert eng.admit(Request(1, "strict", np.arange(3, dtype=np.int32), 4))
    with pytest.raises(RuntimeError, match="holds a slot"):
        pprof.profile_engine(eng)
    with pytest.raises(ValueError, match="max_len"):
        pprof.profile_engine(ServingEngine(cfg, params, EngineConfig(candidate_tps=(1,), **ENGINE_KW), device="cpu"),
                             ctxs=(96,))


def test_profile_engine_does_not_measure_batch_or_context_in_both_packages(llama_pair, reference_engine,
                                                                           monkeypatch):
    """Reference note: profile_engine steps all n_slots slots at ctxs[0]
    whatever the batch b, and writes each time under every context of
    (tp, b, ctx). Shown with time_fn replaced by one that runs the step
    once, records how many sequences it stepped and returns the call's
    number: every decode call steps the 4 slots, and each b's one time
    stands under both contexts. The port reproduces it."""
    _, _, cfg, params = llama_pair
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1,), **ENGINE_KW), device="cpu")
    for mod, engine in ((jprof, reference_engine), (pprof, eng)):
        stepped = []

        def one_call(fn, *args, **kw):
            out = fn(*args)
            stepped.append(int(np.asarray(out[0] if isinstance(out, tuple) else out).shape[0]))
            return float(len(stepped))

        monkeypatch.setattr(mod, "time_fn", one_call)
        table = mod.profile_engine(engine, batches=(1, 2, 4), ctxs=(16, 64))
        assert stepped == [4, 4, 4, 1, 1]  # three decode calls of all 4 slots, then the two buckets
        assert table.decode_s == {(1, b, c): float(i + 1) for i, b in enumerate((1, 2, 4)) for c in (16, 64)}


def test_profile_engine_leaves_moe_drop_counts_as_they_were():
    """Reduced moonshot at capacity factor 0.25, so a prefill of the
    profile drops assignments: the engine's drop counts after the profile
    are those before it (zero after the warm-up), though a replay of the
    same executable counts its drops."""
    base = reduced(get_config("moonshot-v1-16b-a3b"))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=0.25))
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2), **ENGINE_KW), device="cpu")
    eng.warmup()
    assert not any(eng.moe_dropped().values())
    table = pprof.profile_engine(eng, batches=(1,), ctxs=(64,))
    assert len(table.prefill_s) == 4 and not any(eng.moe_dropped().values())
    eng.cache.get(1, 32)(torch.zeros((1, 32), dtype=torch.int64), torch.tensor([31]), torch.tensor([0]))
    assert eng.moe_dropped()[(1, "prefill")] > 0
