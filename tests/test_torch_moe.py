"""The port's MoE (models/moe.py) against the reference's on the same weights
and numpy inputs: configs and parameter trees, routing with its aux losses,
the sort-based dispatch, the local path (with a shared expert too), the model
forward, the weight store's expert shards and the weight carry; then, on a
mesh of 4 host devices, the sharded and decode paths of a TP group against
the reference's at every (TP level, shape) the engine reaches, and the
serving engine on reduced moonshot-v1-16b-a3b against the reference engine
under a TP switch schedule, at capacity factors 8.0 and 1.25 and with 16
slots (where decode can drop).

The mesh checks run in a subprocess, ``python tests/test_torch_moe.py
<check> [out]``, whose XLA_FLAGS ask for 4 host devices before JAX starts,
as tests/test_multidev.py does.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models import forward as j_forward, model_param_defs as j_param_defs  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.model import logits_for as j_logits_for  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import (  # noqa: E402
    DEFAULT_RULES, make_exec_config as j_make_exec_config, validate_divisibility,
)

from repro_torch.checkpoint.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import forward, logits_for, model_param_defs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import ShardView, make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MOONSHOT = "moonshot-v1-16b-a3b"
TOL = dict(rtol=1e-5, atol=1e-5)
MESH_TOL = dict(rtol=5e-4, atol=5e-4)  # check_moe_sharded's
ENGINE_TOL = dict(rtol=2e-4, atol=2e-4)
N_POOL = 4
SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}  # test_torch_engine.py's


def _pair(name=MOONSHOT, **moe_kw):
    """The reduced config in both packages, its MoESpec's fields replaced."""
    jcfg, cfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    return replace(jcfg, moe=replace(jcfg.moe, **moe_kw)), replace(cfg, moe=replace(cfg.moe, **moe_kw))


def _jax_params(jcfg, seed=0):
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)


def _jax_leaves(tree):
    return {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


def _bind_moe(cfg, p, tp, pool=N_POOL):
    """One MoE layer's port params (numpy or tensors) bound at TP ``tp`` over
    ``pool`` CPU ranks, as the weight store binds a model's."""
    store = WeightStore(cfg, {"ffn": moe.moe_param_defs(cfg)}, [CPU] * pool)
    return store.rebind(store.build({"ffn": to_torch(p, device="cpu")}), tp)["ffn"]


def _layer0(jparams):
    return jax.tree_util.tree_map(lambda a: a[0], jparams["periods"]["pos0"]["ffn"])


def _x(shape, d, seed):
    return np.random.RandomState(seed).randn(*shape, d).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MOONSHOT, "dbrx-132b"])
def test_moe_config_fields_match_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    for f in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "vocab_padded", "norm_eps", "tie_embeddings", "frontend", "source", "num_periods"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.moe) == vars(jcfg.moe) and vars(cfg.attn) == vars(jcfg.attn)
    assert [(t.mixer, t.ffn) for t in cfg.layer_pattern] == [(t.mixer, t.ffn) for t in jcfg.layer_pattern] \
        == [("attn", "moe")]
    assert (cfg.param_count(), cfg.active_param_count()) == (jcfg.param_count(), jcfg.active_param_count())
    r, jr = reduced(cfg), j_reduced(jcfg)
    assert vars(r.moe) == vars(jr.moe) and r.moe.capacity_factor == 8.0


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_param_defs_match_reference(shared, tp):
    jcfg, cfg = _pair(num_shared_experts=shared)
    want = {p: (d.shape, d.axes, d.init, d.scale)
            for p, d in _jax_leaves(j_param_defs(jcfg, j_make_exec_config(jcfg, tp))).items()}
    got = {p: (d.shape, d.axes, d.init, d.scale)
           for p, d in tree_leaves_with_path(model_param_defs(cfg, make_exec_config(cfg, tp)))}
    assert got == want
    assert (("periods", "pos0", "ffn", "shared", "w_in") in got) == bool(shared)


def test_unshardable_experts_are_refused():
    """Experts must divide by the TP level (the reference's
    validate_divisibility), and the engine needs at least as many experts
    as its largest TP level (the reference engine's assert)."""
    jcfg, cfg = _pair()
    with pytest.raises(ValueError, match="experts"):
        validate_divisibility(jcfg, 8)
    with pytest.raises(ValueError, match="experts"):
        make_exec_config(cfg, 8)
    wide = replace(cfg, num_kv_heads=8)
    params = to_torch(_jax_params(replace(jcfg, num_kv_heads=8)), device="cpu")
    with pytest.raises(ValueError, match="experts"):
        ServingEngine(wide, params, EngineConfig(candidate_tps=(1, 2, 4, 8), n_slots=2, max_len=32,
                                                 prefill_buckets=(16,)), device="cpu")


def test_weight_carry_round_trip():
    """checkpoint.convert carries the MoE tree unchanged, both ways."""
    jcfg, _ = _pair(num_shared_experts=1)
    jparams = _jax_params(jcfg)
    port = to_torch(jparams, device="cpu")
    assert port["periods"]["pos0"]["ffn"]["w_gate"].shape == (2, 4, 64, 64)
    back = dict(tree_leaves_with_path(to_numpy(port)))
    want = _jax_leaves(jparams)
    assert set(back) == set(want)
    for p, x in back.items():
        np.testing.assert_array_equal(x, np.asarray(want[p]))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_rebind_is_zero_copy_for_experts(tp):
    """Over a pool of 4 ranks: every bound weight is a view of a storage
    tensor, each rank's expert shard (E/t, D, F) is a view inside it holding
    that rank's experts, and the storage holds the caller's tensors."""
    jcfg, cfg = _pair(num_shared_experts=1)
    params = to_torch(_jax_params(jcfg), device="cpu")
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * N_POOL)
    storage = store.build(params)
    assert {t.data_ptr() for _, per_pos in tree_leaves_with_path(storage) for t in per_pos} == \
        {x.data_ptr() for _, x in tree_leaves_with_path(params)}
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for _, per_pos in tree_leaves_with_path(storage) for t in per_pos]
    bound = store.rebind(storage, tp)
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    for i, layer in enumerate(bound["layers"]):
        ffn = layer["ffn"]
        views = [v for v in (*ffn.values(), *ffn["shared"].values()) if isinstance(v, ShardView)]
        assert len(views) == 6 and all(v.tp == tp for v in views)
        for v in views:
            assert all(any(lo <= m.data_ptr() < hi for lo, hi in spans) for m in v.mats)
        for name, inner in (("w_gate", (D, Fe)), ("w_in", (D, Fe)), ("w_out", (Fe, D))):
            full = params["periods"]["pos0"]["ffn"][name][i]
            for r in range(tp):
                blk = ffn[name].block(r, *inner)
                assert blk.shape == (E // tp, *inner)
                assert any(lo <= blk.data_ptr() < hi for lo, hi in spans)
                assert blk.data_ptr() == full[r * E // tp].data_ptr()  # the rank's first expert, in place
                assert torch.equal(blk, full[r * E // tp:(r + 1) * E // tp])


# ---------------------------------------------------------------------------
# routing, dispatch and the local path, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 8, 16, 24, 128])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_capacity_matches_reference(T, cf):
    for name in (MOONSHOT, "dbrx-132b"):
        m = replace(get_config(name).moe, capacity_factor=cf)
        jm = replace(j_get_config(name).moe, capacity_factor=cf)
        assert moe._capacity(T, m) == j_moe._capacity(T, jm)


@pytest.mark.parametrize("T", [8, 32])
def test_route_matches_reference(T):
    """Same probabilities and picks; the aux losses (lb, z) within 1e-5; over
    groups, the aux is the mean of each group's (the reference's pmean)."""
    jcfg, cfg = _pair()
    jp = _layer0(_jax_params(jcfg))
    x = _x((T,), cfg.d_model, 1)
    jt_p, jt_i, jaux = j_moe._route(jnp.asarray(x), jp["router"], jcfg.moe)
    t_p, t_i, aux = moe._route(torch.from_numpy(x), torch.from_numpy(np.array(jp["router"])), cfg.moe)
    np.testing.assert_array_equal(t_i.numpy(), np.asarray(jt_i))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(jt_p), **TOL)
    for k in ("lb", "z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)
    _, _, g_aux = moe._route(torch.from_numpy(x).view(2, T // 2, -1), torch.from_numpy(np.array(jp["router"])),
                             cfg.moe)
    halves = [j_moe._route(jnp.asarray(h), jp["router"], jcfg.moe)[2] for h in np.split(x, 2)]
    for k in ("lb", "z"):
        np.testing.assert_allclose(float(g_aux[k]), np.mean([float(h[k]) for h in halves]), **TOL)


@pytest.mark.parametrize("C", [3, 8, 10, 40])
def test_dispatch_indices_match_reference(C):
    """Given the same picks, dest, tok, keep and order are equal; a batch of
    groups dispatches each group as the reference dispatches it alone."""
    rng = np.random.RandomState(C)
    E, K, T = 8, 3, 20
    top_i = np.stack([np.stack([rng.choice(E, K, replace=False) for _ in range(T)]) for _ in range(3)])
    got = moe._dispatch_indices(torch.from_numpy(top_i).long(), E, C)
    for g in range(3):
        want = j_moe._dispatch_indices(jnp.asarray(top_i[g], jnp.int32), E, C)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a[g].numpy(), np.asarray(b))
    assert (C >= T) == bool(got[2].all())


@pytest.mark.parametrize("shape", [(2, 16), (1, 24), (8, 1)], ids=["2x16", "prefill_24", "decode_8"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared_expert"])
def test_moe_apply_local_matches_reference(shared, cf, shape):
    """moe_apply_local at TP 1 within 1e-5 of the reference's (y relative to
    its scale, and aux), the dropped assignments counted as the reference's
    keep gives them. y's scale is set by the reference's init of the 3-D
    expert leaves (fan-in = their first dim, E = 4: std 0.5), which puts y
    in the hundreds, where one f32 ulp is 1.5e-5 to 6e-5; a sum that cancels
    to a small value keeps that absolute error."""
    jcfg, cfg = _pair(num_shared_experts=shared, capacity_factor=cf)
    jp = _layer0(_jax_params(jcfg))
    x = _x(shape, cfg.d_model, 2)
    jy, jaux = j_moe.moe_apply_local(jp, jnp.asarray(x), jcfg)
    drops = torch.zeros(1, dtype=torch.int64)
    y, aux = moe.moe_apply_local(_bind_moe(cfg, jp, 1), torch.from_numpy(x), cfg, drops=drops)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(jy)).max())
    for k in ("lb", "z"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL)
    x2d = jnp.asarray(x.reshape(-1, cfg.d_model))
    _, top_i, _ = j_moe._route(x2d, jp["router"], jcfg.moe)
    keep = j_moe._dispatch_indices(top_i, cfg.moe.num_experts, j_moe._capacity(x2d.shape[0], jcfg.moe))[2]
    assert int(drops) == int((~np.asarray(keep)).sum())
    if cf == 8.0:
        assert int(drops) == 0


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared_expert"])
def test_forward_matches_reference(shared):
    """Reduced moonshot (with a shared expert too): prefill logits of every
    position and three decode steps over the caches at 2e-4 of the
    reference's forward (no mesh: the local path), at TP 1."""
    jcfg, cfg = _pair(num_shared_experts=shared)
    jparams = _jax_params(jcfg)
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU])
    params = store.rebind(store.build(to_torch(jparams, device="cpu")), 1)
    ec, jec = make_exec_config(cfg, 1), j_make_exec_config(jcfg, 1)
    B, prompt, max_len = 2, 12, 16
    tokens = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(B, prompt + 3))
    jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None,
                              tokens=jnp.asarray(tokens[:, :prompt]), mode="prefill", block_q=4, block_k=4)
    h, kv = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, :prompt]), mode="prefill", block_q=4, block_k=4)
    np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                               np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), rtol=2e-4, atol=2e-4)
    cache = [{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, max_len - prompt)).contiguous() for k in c} for c in kv]
    jcache = {pos: {k: jnp.pad(c, ((0, 0), (0, 0), (0, max_len - prompt), (0, 0), (0, 0))) for k, c in d.items()}
              for pos, d in jcache.items()}
    tables = [torch.arange(B * 2, dtype=torch.int32).view(B, 2)] * cfg.num_layers
    for step in range(3):
        pos = np.full((B,), prompt + step)
        tok = tokens[:, prompt + step:prompt + step + 1]
        jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, tokens=jnp.asarray(tok),
                                  positions=jnp.asarray(pos, jnp.int32), cache=jcache, mode="decode")
        lens = [torch.from_numpy((pos + 1).astype(np.int32))] * cfg.num_layers
        h, _ = forward(params, cfg, ec, tokens=torch.from_numpy(tok), positions=torch.from_numpy(pos), cache=cache,
                       block_tables=tables, seq_lens=lens, mode="decode")
        np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                                   np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# on a mesh of 4 host devices (subprocess)
# ---------------------------------------------------------------------------
# (data, model) mesh over the pool of 4, and (B, S): every path and capacity
# the engine's prefill (B = 1) and decode (S = 1) reach, and check_moe_sharded's
PATH_CASES = [
    ((2, 2), (4, 8)),  # sharded: 2 x 2 blocks of 2 x 4 tokens (check_moe_sharded's shape)
    ((1, 4), (1, 16)),  # prefill at TP = N: sharded over S, 4 tokens a rank
    ((2, 2), (1, 16)),  # prefill at 1 < TP < N: B % dp != 0, one replicated group, psum
    ((1, 4), (1, 6)),  # prefill at TP = N, S % TP != 0: one group, psum
    ((2, 2), (8, 1)),  # decode at 1 < TP < N: two data groups of 4 slots
    ((1, 4), (8, 1)),  # decode at TP = N
    ((1, 4), (16, 1)),  # decode at TP = N, 16 slots: capacity 10 of 16 tokens
]


def _check_paths():
    from repro.core.weight_store import make_exec_mesh

    devices = jax.devices()[:N_POOL]
    assert len(devices) == N_POOL, jax.devices()
    dropped = 0
    for cf in (8.0, 1.25):
        for shared in (0, 1):
            jcfg, cfg = _pair(num_shared_experts=shared, capacity_factor=cf)
            jp = j_init_params(j_moe.moe_param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
            for (dp, tp), (B, S) in PATH_CASES:
                mesh = make_exec_mesh(devices, tp)
                assert dict(mesh.shape) == {"data": dp, "model": tp}
                x = _x((B, S), cfg.d_model, B * S + tp)
                with mesh:
                    jy, jaux = jax.jit(lambda p, x: j_moe.moe_apply(p, x, jcfg, DEFAULT_RULES, mesh))(jp, jnp.asarray(x))
                drops = torch.zeros(1, dtype=torch.int64)
                y, aux = moe.moe_apply(_bind_moe(cfg, jp, tp), torch.from_numpy(x), cfg, N_POOL, drops=drops)
                what = f"cf {cf}, shared {shared}, mesh {(dp, tp)}, x {(B, S)}"
                np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MESH_TOL, err_msg=what)
                for k in ("lb", "z"):
                    np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **MESH_TOL, err_msg=f"{what}: {k}")
                assert cf == 1.25 or int(drops) == 0, what
                dropped += int(drops)
                print(f"{what}: max |y - ref| {np.abs(y.numpy() - np.asarray(jy)).max():.3g}, dropped {int(drops)}")
    assert dropped > 0, "no case dropped an assignment at capacity factor 1.25"
    print(f"OK paths: {dropped} assignments dropped at 1.25 over the cases")


def _serve_cfgs(cf):
    """Reduced moonshot with 4 KV heads, so the engines take TP 4."""
    jcfg, cfg = _pair(capacity_factor=cf)
    return replace(jcfg, num_kv_heads=4), replace(cfg, num_kv_heads=4)


# (capacity factor, slots, requests): 16 slots let a TP 1 decode drop (capacity 10 of 16 tokens)
ENGINE_CASES = {"cf8_slots8": (8.0, 8, 10), "cf1.25_slots8": (1.25, 8, 10), "cf1.25_slots16": (1.25, 16, 20)}


def _requests(cls, n):
    rng = np.random.RandomState(0)
    return [cls(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(n)]


def _engine_kw(n_slots):
    return dict(candidate_tps=(1, 2, 4), n_slots=n_slots, max_len=96, prefill_buckets=(16, 32), record_logits=True)


def _reference_engines(out):
    """The reference engine over 4 host devices, per case, under SCHEDULE;
    the weights, trajectories and logits go to ``out`` (pickle)."""
    from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine
    from repro.serving.request import Request as JRequest

    assert len(jax.devices()) >= N_POOL, jax.devices()
    res = {}
    for case, (cf, n_slots, n_req) in ENGINE_CASES.items():
        jcfg, _ = _serve_cfgs(cf)
        jparams = _jax_params(jcfg)
        eng = JServingEngine(jcfg, jparams, devices=jax.devices()[:N_POOL],
                             econf=JEngineConfig(**_engine_kw(n_slots), dtype=jnp.float32))
        done = eng.run(_requests(JRequest, n_req), switch_schedule=SCHEDULE)
        assert eng.tps == [1, 2, 4] and eng.stats.switches == len(SCHEDULE)
        res[case] = {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
                     "logits": {k: [np.asarray(x) for x in v] for k, v in eng.logit_trace.items()},
                     "params": jax.tree_util.tree_map(np.asarray, jparams)}
        print(f"{case}: {len(done)} requests")
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("OK engine")


def _run(check, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), check, *args], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, f"{check} failed:\n{r.stdout}\n{r.stderr}"
    assert f"OK {check}" in r.stdout
    return r.stdout


def test_moe_paths_match_reference_on_a_4_device_mesh():
    """The sharded and decode paths, as loops over a TP group's ranks in a
    pool of 4, against the reference's shard_map paths on (data, model)
    meshes of 4 host devices, at capacity factors 8.0 and 1.25, with and
    without a shared expert: y and aux at check_moe_sharded's 5e-4, and
    drops at 1.25 in some case, none at 8.0."""
    _run("paths")


@pytest.fixture(scope="module")
def reference_engines(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_engine") / "reference.pkl"
    _run("engine", str(out))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_reference_engine(reference_engines, case):
    """The port's engine over a pool of 4 ranks (TP 1/2/4) against the
    reference engine over 4 host devices, both under SCHEDULE: the same
    greedy tokens and every step's logits within 2e-4. At 1.25 some prefill
    drops an assignment (capacity depends on the TP level there); at 8.0
    nothing drops; with 16 slots the decode groups of TP 2 (two data groups
    of 8) are the reference's."""
    cf, n_slots, n_req = ENGINE_CASES[case]
    ref = reference_engines[case]
    _, cfg = _serve_cfgs(cf)
    eng = ServingEngine(cfg, to_torch(ref["params"], device="cpu"), EngineConfig(**_engine_kw(n_slots)), device="cpu")
    done = eng.run(_requests(Request, n_req), switch_schedule=SCHEDULE)
    assert eng.stats.switches == len(SCHEDULE) and len(done) == n_req
    assert {r.req_id: r.generated for r in done} == ref["tokens"]
    for rid, steps in ref["logits"].items():
        assert len(eng.logit_trace[rid]) == len(steps) == 24
        for g, w in zip(eng.logit_trace[rid], steps):
            np.testing.assert_allclose(g, w, **ENGINE_TOL, err_msg=f"request {rid}")
    dropped = eng.moe_dropped()
    assert sorted(dropped) == sorted((tp, s) for tp in (1, 2, 4) for s in ("prefill", "decode"))
    if cf == 8.0:
        assert not any(dropped.values()), dropped
    else:
        assert sum(n for (_, s), n in dropped.items() if s == "prefill") > 0, dropped
    assert dropped[(2, "decode")] == 0  # groups of n_slots / 2 tokens never overflow a capacity of 8
    if n_slots == 16:  # one group of 16 tokens at capacity 10 at TP 1 and 4: decode drops there
        assert dropped[(1, "decode")] > 0 and dropped[(4, "decode")] > 0, dropped


if __name__ == "__main__":
    {"paths": _check_paths, "engine": lambda: _reference_engines(sys.argv[2])}[sys.argv[1]]()
