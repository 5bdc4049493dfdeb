"""The port's serving engine against the reference engine (check_engine's
config and requests, repro/testing/multidev_checks.py), and the port's TP
switch: rebind, rollback, migration abort and pool shrink."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AttnSpec as JAttnSpec, ModelConfig as JModelConfig  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402
from repro.models.attention import decode_attention as j_decode_attention  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs.base import AttnSpec, ModelConfig  # noqa: E402
from repro_torch.core.migration import MigrationAborted, migrate_cache  # noqa: E402
from repro_torch.core.tp_switch import SwitchAborted, TPSwitchController  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import forward, logits_for, model_param_defs  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import ShardView, make_exec_config  # noqa: E402
from repro_torch.models.attention import as_pages, decode_attention  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PAGE_SIZE, SlotCache  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

CPU = torch.device("cpu")
SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}
_SERVE = dict(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8,
              num_kv_heads=8, head_dim=16, d_ff=128, vocab_size=256)
CFG = ModelConfig(**_SERVE, attn=AttnSpec(kind="full"))
ECONF = EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32))


def _requests(cls):
    rng = np.random.RandomState(0)
    return [cls(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(10)]


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JModelConfig(**_SERVE, attn=JAttnSpec(kind="full"))
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def reference_engine(jax_params):
    """The reference engine on one CPU device (TP 1), recording logits."""
    jcfg = JModelConfig(**_SERVE, attn=JAttnSpec(kind="full"))
    econf = JEngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32), dtype=jnp.float32,
                          record_logits=True)
    eng = JServingEngine(jcfg, jax_params, devices=jax.devices()[:1], econf=econf)
    done = eng.run(_requests(JRequest))
    return {r.req_id: list(r.generated) for r in done}, eng.logit_trace


@pytest.fixture(scope="module")
def reference_trajectories(reference_engine):
    return reference_engine[0]


@pytest.fixture(scope="module")
def params(jax_params):
    return to_torch(jax_params, device="cpu")


def test_engine_matches_reference_trajectories(params, reference_trajectories):
    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    done = eng.run(_requests(Request))
    assert len(done) == 10
    assert {r.req_id: r.generated for r in done} == reference_trajectories


def test_engine_switch_schedule_keeps_trajectories(params, reference_trajectories):
    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    eng.warmup()
    ptrs = sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos)
    done = eng.run(_requests(Request), switch_schedule=SCHEDULE)
    assert eng.stats.switches == 4 and eng.tp == 2
    assert {r.req_id: r.generated for r in done} == reference_trajectories
    assert sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos) == ptrs


@pytest.mark.parametrize("schedule", [None, SCHEDULE], ids=["fixed_tp1", "switch_schedule"])
def test_engine_logits_match_reference(params, reference_engine, schedule):
    """Every step's logits (prefill, then each decode step) of every request
    within 2e-4 of the reference engine's, as its engine tests hold them."""
    econf = EngineConfig(**{**ECONF.__dict__, "record_logits": True})
    eng = ServingEngine(CFG, params, econf, device="cpu")
    done = eng.run(_requests(Request), switch_schedule=schedule)
    want = reference_engine[1]
    assert sorted(eng.logit_trace) == sorted(want) == sorted(r.req_id for r in done)
    for rid, steps in want.items():
        got = eng.logit_trace[rid]
        assert len(got) == len(steps) == 24
        for g, w in zip(got, steps):
            assert g.shape == (CFG.vocab_size,)
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4)


def test_rebind_is_zero_copy(params):
    """Every bound weight is a view of a storage tensor; with storage_tp 1 all
    ranks share one tensor per weight, so the pool holds canonical bytes."""
    store = WeightStore(CFG, model_param_defs(CFG, make_exec_config(CFG, 1)), [CPU] * 4)
    storage = store.build(params)
    canonical = {x.data_ptr() for _, x in tree_leaves_with_path(params)}
    stored = {t.data_ptr() for _, per_pos in tree_leaves_with_path(storage) for t in per_pos}
    assert stored == canonical  # build kept the caller's tensors: no copy, no N-fold replica
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for _, per_pos in tree_leaves_with_path(storage) for t in per_pos]
    for tp in (1, 2, 4):
        bound = store.rebind(storage, tp)
        views = [v for layer in bound["layers"] for sub in layer.values() if isinstance(sub, dict)
                 for v in sub.values() if isinstance(v, ShardView)] + [bound["embed"], bound["lm_head"]]
        assert all(v.tp == tp for v in views)
        for v in views:
            for m in v.mats:
                assert any(lo <= m.data_ptr() < hi for lo, hi in spans)
    assert store.bytes_per_device(4) == 4 * sum(x.numel() for _, x in tree_leaves_with_path(params))


def _serve_logits(store, storage, tp, tokens):
    bound = store.rebind(storage, tp)
    h, _ = forward(bound, CFG, make_exec_config(CFG, tp), tokens=tokens, mode="prefill", block_q=16, block_k=16)
    return logits_for(bound, CFG, h)[..., : CFG.vocab_size]


def test_switch_abort_rolls_back(params):
    """check_fault_abort part 1 on the port."""
    store = WeightStore(CFG, model_param_defs(CFG, make_exec_config(CFG, 1)), [CPU] * 4)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, size=(8, 16)))
    ctl = TPSwitchController(store, (1, 2, 4))
    ctl.install(params, 1)
    assert sorted(ctl.bind_s) == [1, 2, 4] and all(s > 0 for s in ctl.bind_s.values())
    ref = _serve_logits(store, ctl.storage, 1, tokens)
    storage_before, params_before = ctl.storage, ctl.params

    def dying_migrate(tp):
        raise RuntimeError("device lost mid-migration")

    with pytest.raises(SwitchAborted):
        ctl.switch(2, migrate_fn=dying_migrate)
    assert ctl.current_tp == 1 and ctl.params is params_before and ctl.storage is storage_before
    assert ctl.stats.n_aborts == 1 and ctl.stats.n_switches == 0
    torch.testing.assert_close(_serve_logits(store, ctl.storage, ctl.current_tp, tokens), ref, rtol=2e-4, atol=2e-4)
    ctl.switch(2)  # retry after the fault clears
    assert ctl.current_tp == 2 and ctl.stats.n_switches == 1


def test_engine_switch_abort_keeps_serving(params, reference_trajectories, monkeypatch):
    import repro_torch.serving.engine as engine_mod

    eng = ServingEngine(CFG, params, ECONF, device="cpu")

    def broken(cache, device):
        raise MigrationAborted("target lost")

    monkeypatch.setattr(engine_mod, "migrate_cache", broken)
    with pytest.raises(SwitchAborted):
        eng.switch_tp(4)
    assert eng.tp == 1 and eng.stats.switches == 0
    monkeypatch.undo()
    done = eng.run(_requests(Request))
    assert {r.req_id: r.generated for r in done} == reference_trajectories


def test_migration_abort_leaves_source_intact():
    cache = [{"k": torch.arange(64.0).view(2, 4, 2, 4), "v": torch.arange(64.0).view(2, 4, 2, 4) + 1}]
    want = [{k: t.clone() for k, t in c.items()} for c in cache]
    with pytest.raises(MigrationAborted):
        migrate_cache(cache, object())
    for c, w in zip(cache, want):
        for k in c:
            assert torch.equal(c[k], w[k])
    moved, seconds = migrate_cache(cache, CPU)
    assert seconds >= 0 and moved[0]["k"] is cache[0]["k"]  # same device: no byte moves


def test_shrink_and_reload_serves_identical_logits(params):
    """check_fault_abort part 3: lose half the pool, reload, serve at TP 2."""
    store = WeightStore(CFG, model_param_defs(CFG, make_exec_config(CFG, 1)), [CPU] * 8, storage_tp=2)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 256, size=(8, 16)))
    ref = _serve_logits(store, store.build(params), 2, tokens)
    small = store.shrink(range(4))
    assert small.N == 4 and small.s == 2 and small.bytes_per_device() > 0
    torch.testing.assert_close(_serve_logits(small, small.build(params), 2, tokens), ref, rtol=2e-4, atol=2e-4)
    assert store.shrink([0, 1, 2]).s == 1


def test_slot_cache_paged_view_equals_reference_decode_attention():
    """The engine's decode layout: each slot's rows viewed as pages, with the
    identity block tables and seq_lens = min(pos + 1, max_len) of
    ``page_tables``, attend as the reference's dense masked decode does."""
    ec = make_exec_config(CFG, 4)
    slots = SlotCache.create(CFG, ec, n_slots=3, max_len=48, dtype=torch.float32, device=CPU)
    rng = np.random.RandomState(5)
    for c in slots.layers[1].values():
        c.copy_(torch.from_numpy(rng.randn(*c.shape).astype(np.float32)))
    kc, vc = slots.layers[1]["k"], slots.layers[1]["v"]
    kp = as_pages(kc, PAGE_SIZE)
    assert kp.data_ptr() == kc.data_ptr()
    pos = np.array([0, 20, 47])
    tables, lens = (per_layer[1] for per_layer in slots.page_tables(torch.from_numpy(pos)))
    assert lens.tolist() == [1, 21, 48]
    for b in range(3):
        for j in range(tables.shape[1]):
            assert torch.equal(kp[tables[b, j]], kc[b, j * PAGE_SIZE:(j + 1) * PAGE_SIZE])
    q = rng.randn(3, ec.kv_exec, ec.q_per_kv, CFG.head_dim).astype(np.float32)
    got = decode_attention(torch.from_numpy(q), kc, vc, tables, lens, None)
    valid = np.arange(48)[None] <= pos[:, None]
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()), jnp.asarray(valid),
                              None, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_entry_points_refuse_the_cpu_unless_asked(params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(CFG, params, ECONF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_torch({"w": np.zeros(2, np.float32)})
