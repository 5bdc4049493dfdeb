"""The port's Mamba family (models/mamba.py) against the reference's on the
same weights and numpy inputs: configs and parameter and cache trees; the
conv, the chunked SSD and the chunked selective scan; mamba2_apply and
mamba1_apply in prefill and decode at the bound weights of TP 1, 2 and 4;
reduced mamba2-2.7b's forward (prefill S, then decode 1); the weight store's
1-D and conv leaves, the weight carry, the state path of the migration byte
count; the engine's refusal of mamba2; and, on a mesh of 4 host devices, the
serving engine on reduced jamba-v0.1-52b (mamba1 + attention + MoE) against
the reference engine at fixed TP 1 and under a switch schedule (in one
process, and at each layer's own fan-in also across a pool of 4 processes
under gloo, each Mamba layer on its rank's d_inner/t channels), and the
reference's padded-bucket behaviour (a prompt prefilled in a longer bucket
carries the padding into its recurrent state).

The engine checks run the reference in a subprocess, ``python
tests/test_torch_mamba.py engine <out.pkl>``, whose XLA_FLAGS ask for 4 host
devices before JAX starts, as tests/test_torch_moe.py does.

Tolerances. 1e-5 (relative to the output's scale) where the port sums in
the reference's order: the conv, the SSD, the layers. The selective scan's
doubling scan associates its products in another order than
jax.lax.associative_scan: 1e-5 of the output's scale too (measured 2.5e-7).
Reduced jamba is ill-conditioned in f32: its residual stream reaches 1e10
(A_log = 0 and the MoE's std-0.5 expert leaves), and the relative error of
any f32 evaluation grows ~3x at each Mamba layer. Over the fixed-TP-1
engine run here, the reference's own f32 logits lie up to 1.3e-3 from an
f64 evaluation of the same steps (the port's up to 3.4e-3; the two differ
by up to 2.1e-3), so 2e-4 against the reference is out of reach of f32:
the engine's tokens are held exactly and its logits within 1e-2 (absolute;
logits are ~3). ``python tests/test_torch_mamba.py conditioning`` prints
those readings, step by step.
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
from repro.core.migration import kv_migration_bytes as j_kv_migration_bytes  # noqa: E402
from repro.models import forward as j_forward, init_cache_defs as j_cache_defs  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402

from repro_torch.checkpoint.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.migration import kv_migration_bytes  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import forward, init_cache_defs, model_param_defs  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.models.params import _fan_in_scale, tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import ShardView, make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MAMBA2, JAMBA = "mamba2-2.7b", "jamba-v0.1-52b"
N_POOL = 4
FWD_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models.py's prefill/decode tolerance
ENGINE_TOL = dict(rtol=0, atol=1e-2)  # reduced jamba's f32 conditioning (module docstring)
FAN_IN_TOL = dict(rtol=2e-4, atol=2e-4)  # the other engine tests' bound, on weights drawn at each layer's fan-in


def _pair(name):
    return j_reduced(j_get_config(name)), reduced(get_config(name))


def _jax_params(jcfg, seed=0):
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)


def _jax_leaves(tree):
    return {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


def _bind(cfg, defs, params, tp):
    """``params`` (tensors) laid out over a pool of 4 CPU ranks and bound at TP ``tp``."""
    store = WeightStore(cfg, defs, [CPU] * N_POOL)
    return store.rebind(store.build(params), tp)


def _close(got, want, tol=1e-5, what=""):
    """|got - want| <= tol x max|want| (+ tol)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * max(1.0, np.abs(want).max()), err_msg=what)


# ---------------------------------------------------------------------------
# configs and parameter / cache trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_mamba_config_fields_match_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    for c, jc in ((cfg, jcfg), (reduced(cfg), j_reduced(jcfg))):
        for f in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "vocab_padded", "subquadratic", "source", "num_periods", "n_attn_layers",
                  "n_mamba_layers", "d_inner"):
            assert getattr(c, f) == getattr(jc, f), f
        assert vars(c.mamba) == vars(jc.mamba) and vars(c.attn) == vars(jc.attn)
        assert (c.moe is None) == (jc.moe is None) and (c.moe is None or vars(c.moe) == vars(jc.moe))
        assert [(t.mixer, t.ffn) for t in c.layer_pattern] == [(t.mixer, t.ffn) for t in jc.layer_pattern]
        assert (c.param_count(), c.active_param_count()) == (jc.param_count(), jc.active_param_count())
        check_supported(c)
    assert cfg.mamba.version == (2 if name == MAMBA2 else 1)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_mamba_param_and_cache_defs_match_reference(name, tp):
    """Same leaves (shape, axes, init, scale); the per-layer cache defs are
    the reference's stacked ones, one period entry each; the fan-in rule
    gives the 1-D and (d_conv, C) leaves the reference's scale."""
    jcfg, cfg = _pair(name)
    jcfg, cfg = replace(jcfg, num_kv_heads=4), replace(cfg, num_kv_heads=4)
    want = {p: (d.shape, d.axes, d.init, d.scale)
            for p, d in _jax_leaves(j_param_defs(jcfg, j_make_exec_config(jcfg, tp))).items()}
    defs = model_param_defs(cfg, make_exec_config(cfg, tp))
    got = {p: (d.shape, d.axes, d.init, d.scale) for p, d in tree_leaves_with_path(defs)}
    assert got == want
    for _, d in tree_leaves_with_path(defs):
        fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
        assert _fan_in_scale(d) == (d.scale if d.scale is not None else 1.0 / np.sqrt(max(fan_in, 1)))
    jcache = _jax_leaves(j_cache_defs(jcfg, j_make_exec_config(jcfg, tp), 3, 40))
    cache = init_cache_defs(cfg, make_exec_config(cfg, tp), 3, 40)
    period = len(cfg.layer_pattern)
    assert len(cache) == cfg.num_layers
    for i, layer in enumerate(cache):
        for k, d in layer.items():
            jd = jcache[(f"pos{i % period}", k)]
            assert (jd.shape[0],) + d.shape == (cfg.num_periods,) + d.shape == jd.shape and jd.axes[1:] == d.axes


# ---------------------------------------------------------------------------
# the functions, in process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_reference(with_tail):
    rng = np.random.RandomState(0)
    x, w, tail = rng.randn(2, 9, 24).astype(np.float32), rng.randn(4, 24).astype(np.float32), rng.randn(2, 3, 24)
    tail = tail.astype(np.float32) if with_tail else None
    jy, jt = j_mamba.causal_conv(jnp.asarray(x), jnp.asarray(w), None if tail is None else jnp.asarray(tail))
    y, t = mamba.causal_conv(torch.from_numpy(x), torch.from_numpy(w), None if tail is None else torch.from_numpy(tail))
    _close(y.numpy(), jy)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


@pytest.mark.parametrize("S,chunk,with_h0", [(32, 8, False), (20, 16, False), (32, 8, True)],
                         ids=["S_multiple", "S_not_multiple_one_chunk", "h0"])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    rng = np.random.RandomState(S + with_h0)
    B, H, P, G, N = 2, 4, 8, 1, 16
    xh = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    Bh, Ch = rng.randn(B, S, G, N).astype(np.float32), rng.randn(B, S, G, N).astype(np.float32)
    h0 = rng.randn(B, H, P, N).astype(np.float32) if with_h0 else None
    jy, jh = j_mamba._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bh, Ch)), chunk,
                                  None if h0 is None else jnp.asarray(h0))
    y, h = mamba._ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bh, Ch)), chunk,
                              None if h0 is None else torch.from_numpy(h0))
    _close(y.numpy(), jy, what="y")
    _close(h.numpy(), jh, what="h_final")


@pytest.mark.parametrize("chunk", [1, 4, 8, 16, 24])
def test_sel_scan_fused_matches_reference(chunk):
    """The doubling scan against the reference's associative scan, at
    chunks of 1 (no combine), powers of two, and one chunk of 24 (not a
    power of two)."""
    rng = np.random.RandomState(chunk)
    B, S, C, N = 2, 24, 32, 16
    u = rng.randn(B, S, C).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, C))).astype(np.float32)
    Bc, Cc = rng.randn(B, S, N).astype(np.float32), rng.randn(B, S, N).astype(np.float32)
    A = -np.exp(rng.randn(C, N)).astype(np.float32)
    h0 = rng.randn(B, C, N).astype(np.float32)
    jy, jh = j_mamba._sel_scan_fused(*map(jnp.asarray, (u, dt, Bc, Cc, A, h0)), chunk)
    y, h = mamba._sel_scan_fused(*map(torch.from_numpy, (u, dt, Bc, Cc, A, h0)), chunk)
    _close(y.numpy(), jy, what="y")
    _close(h.numpy(), jh, what="h_final")


def _apply_case(version, tp):
    """Reduced mamba2 (version 2) or jamba (1): one layer's reference params
    and the port's bound at TP ``tp``, and both apply functions."""
    name = MAMBA2 if version == 2 else JAMBA
    jcfg, cfg = _pair(name)
    jdefs = (j_mamba.mamba2_param_defs if version == 2 else j_mamba.mamba1_param_defs)(jcfg)
    jp = j_init_params(jdefs, jax.random.PRNGKey(version), jnp.float32)
    # non-trivial A, D, dt_bias and norm, as a trained model has
    rng = np.random.RandomState(version)
    jp = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.5) if k in ("A_log", "D", "dt_bias", "norm") else v)
          for k, v in jp.items()}
    defs = (mamba.mamba2_param_defs if version == 2 else mamba.mamba1_param_defs)(cfg)
    p = _bind(cfg, {"m": defs}, {"m": to_torch(jp, device="cpu")}, tp)["m"]
    fns = (j_mamba.mamba2_apply, mamba.mamba2_apply) if version == 2 else (j_mamba.mamba1_apply, mamba.mamba1_apply)
    return jcfg, cfg, jp, p, fns


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("version", [2, 1], ids=["mamba2", "mamba1"])
def test_mamba_apply_matches_reference(version, mode, tp):
    """One Mamba layer at the port's bound weights of TP ``tp`` against the
    reference's layer: prefill (S = 32, two chunks of 16) output and cache,
    then (decode) two steps from that cache, the port's cache updated in
    place, at 1e-5 of each tensor's scale."""
    jcfg, cfg, jp, p, (j_apply, apply) = _apply_case(version, tp)
    x = np.random.RandomState(10 + tp).randn(2, 34, cfg.d_model).astype(np.float32)
    kw = dict(cfg=jcfg, rules=DEFAULT_RULES, mesh=None)
    jy, jc = j_apply(jp, jnp.asarray(x[:, :32]), mode="prefill", **kw)
    y, c = apply(p, torch.from_numpy(x[:, :32]), cfg=cfg, mode="prefill")
    if mode == "prefill":
        _close(y.numpy(), jy, what="y")
        for k in jc:
            _close(c[k].numpy(), jc[k], what=k)
        return
    cache = {k: v.clone() for k, v in c.items()}
    jcache = jc
    for step in (32, 33):
        jy, jcache = j_apply(jp, jnp.asarray(x[:, step:step + 1]), mode="decode", cache=jcache, **kw)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        y, out = apply(p, torch.from_numpy(x[:, step:step + 1]), cfg=cfg, mode="decode", cache=cache)
        assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
        _close(y.numpy(), jy, what=f"y at {step}")
        for k in jcache:
            _close(cache[k].numpy(), jcache[k], what=f"{k} at {step}")


def test_gated_rmsnorm_sums_ranks_in_order():
    """The gated norm over d_inner shared by t ranks equals the norm over
    the whole (the reference's), at every t."""
    rng = np.random.RandomState(0)
    y, z, s = (rng.randn(3, 5, 64).astype(np.float32), rng.randn(3, 5, 64).astype(np.float32),
               rng.randn(64).astype(np.float32))
    want = j_mamba._gated_rmsnorm(*map(jnp.asarray, (y, z, s)))
    for tp in (1, 2, 4, 8):
        _close(mamba._gated_rmsnorm(*map(torch.from_numpy, (y, z, s)), tp=tp).numpy(), want, what=f"tp {tp}")


# ---------------------------------------------------------------------------
# reduced mamba2-2.7b forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mamba2_forward_matches_reference(tp):
    """Prefill S = 24 then decode 1 against the reference's forward
    (tests/test_models.py's check), at 2e-4, at the port's TP ``tp``: hidden
    states of every prefill position, the decode step's, and the caches."""
    jcfg, cfg = _pair(MAMBA2)
    jparams = _jax_params(jcfg)
    params = _bind(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), to_torch(jparams, device="cpu"), tp)
    ec, jec = make_exec_config(cfg, tp), j_make_exec_config(jcfg, 1)
    B, S = 2, 24
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(B, S + 1))
    kw = dict(rules=DEFAULT_RULES, mesh=None)
    jh, jcache, _ = j_forward(jparams, jcfg, jec, tokens=jnp.asarray(tokens[:, :S]), mode="prefill", **kw)
    h, cache = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, :S]), mode="prefill")
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FWD_TOL)
    pos = jnp.full((B,), S, jnp.int32)
    jh, jcache, _ = j_forward(jparams, jcfg, jec, tokens=jnp.asarray(tokens[:, S:]), positions=pos, cache=jcache,
                              mode="decode", **kw)
    h, _ = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, S:]), positions=torch.full((B,), S),
                   cache=cache, mode="decode")
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FWD_TOL)
    for i, c in enumerate(cache):
        for k, t in c.items():
            _close(t.numpy(), jcache["pos0"][k][i], tol=2e-4, what=f"layer {i} {k}")


def test_engine_refuses_mamba2():
    """num_kv_heads = 0 < the largest TP level: refused, as the reference
    engine refuses it (src/repro/serving/engine.py:69)."""
    jcfg, cfg = _pair(MAMBA2)
    params = to_torch(_jax_params(jcfg), device="cpu")
    with pytest.raises(ValueError, match="num_kv_heads"):
        ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2), n_slots=2, max_len=32, prefill_buckets=(16,)),
                      device="cpu")


# ---------------------------------------------------------------------------
# weight store, weight carry, migration bytes
# ---------------------------------------------------------------------------
def test_weight_carry_round_trip():
    """checkpoint.convert carries the Mamba and hybrid trees by path, both ways."""
    for name in (MAMBA2, JAMBA):
        jparams = _jax_params(_pair(name)[0])
        back = dict(tree_leaves_with_path(to_numpy(to_torch(jparams, device="cpu"))))
        want = _jax_leaves(jparams)
        assert set(back) == set(want)
        for p, x in back.items():
            np.testing.assert_array_equal(x, np.asarray(want[p]))


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_rebind_is_zero_copy_for_state_leaves(tp):
    """Reduced jamba over a pool of 4 ranks: each rank's slice of a 1-D leaf
    (A_log's (C, N) rows, D, dt_bias) and of the conv leaf's columns is a
    view inside the stored tensor holding that rank's channels, and
    ``joined`` is the whole leaf in place."""
    jcfg, cfg = _pair(JAMBA)
    params = to_torch(_jax_params(jcfg), device="cpu")
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * N_POOL)
    bound = store.rebind(store.build(params), tp)
    C = cfg.d_inner
    w = C // tp
    for i in (0, 2):  # mamba layers of the first period
        mixer, stored = bound["layers"][i]["mixer"], params["periods"][f"pos{i}"]["mixer"]
        for name in ("D", "dt_bias", "A_log", "conv"):
            v, full = mixer[name], stored[name][0]
            assert isinstance(v, ShardView) and v.tp == tp
            for r in range(tp):
                part = v.mats[r].narrow(1, v.offsets[r], v.width) if name == "conv" else v.block(r, *full.shape[1:])
                want = full[:, r * w:(r + 1) * w] if name == "conv" else full[r * w:(r + 1) * w]
                assert torch.equal(part, want) and part.data_ptr() == want.data_ptr()
            whole = v.joined(1 if name == "conv" else 0)
            assert whole.data_ptr() == full.data_ptr() and torch.equal(whole.reshape(full.shape), full)


@pytest.mark.parametrize("n_seqs,ctx,from_tp,to_tp", [(16, 256, 1, 8), (8, 4096, 2, 4), (1, 9000, 4, 1), (3, 7, 2, 2)])
@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_kv_migration_bytes_matches_reference_for_state_families(name, n_seqs, ctx, from_tp, to_tp):
    from repro.profiles.perf_model import PerfModel as JPerfModel

    from repro_torch.profiles.perf_model import PerfModel

    cfg, jcfg = get_config(name), j_get_config(name)
    assert PerfModel(cfg).state_bytes() == JPerfModel(jcfg).state_bytes()
    assert kv_migration_bytes(cfg, n_seqs, ctx, from_tp, to_tp) == j_kv_migration_bytes(jcfg, n_seqs, ctx, from_tp,
                                                                                         to_tp)
    if name == MAMBA2:  # 80 heads x 64 x 128 x 64 layers in f32 per sequence
        assert PerfModel(cfg).state_bytes() == 80 * 64 * 128 * 64 * 4


# ---------------------------------------------------------------------------
# the engine on reduced jamba, against the reference engine on 4 host devices
# ---------------------------------------------------------------------------
SCHEDULE = {1: 4, 2: 2, 5: 4, 8: 1}  # requests 4-5 are prefilled at TP 2 (step 2), 6-7 at TP 4 (step 5)
NEW_TOKENS = (3, 3, 6, 6, 9, 6, 6, 6)
PADDED_PROMPT_LEN = 20


def _serve_cfgs():
    """Reduced jamba with 4 KV heads, so the engines take TP 4."""
    jcfg, cfg = _pair(JAMBA)
    return replace(jcfg, num_kv_heads=4), replace(cfg, num_kv_heads=4)


def _requests(cls):
    rng = np.random.RandomState(0)
    lens = (5, 14, 16, 9, 30, 17, 12, 32)  # all but the last shorter than their bucket
    return [cls(i, "strict", rng.randint(0, 256, size=n).astype(np.int32), k)
            for i, (n, k) in enumerate(zip(lens, NEW_TOKENS))]


def _fan_in_params(jcfg, seed=0):
    """The reference's weights with each stacked leaf of rank >= 3 drawn at
    its layer's own fan-in, 1/sqrt(shape[-2]), given to ``init_params``
    through ``ParamDef.scale`` (the init rule's fan-in for such a leaf is
    its number of periods: std 1 at one period)."""
    from repro.models.params import tree_map_defs

    defs = j_param_defs(jcfg, j_make_exec_config(jcfg, 1))
    own = (lambda d: replace(d, scale=d.shape[-2] ** -0.5)
           if d.scale is None and d.init == "normal" and len(d.shape) >= 3 else d)
    defs = {k: tree_map_defs(own, v) if k == "periods" else v for k, v in defs.items()}
    return j_init_params(defs, jax.random.PRNGKey(seed), jnp.float32)


def _engine_kw():
    return dict(candidate_tps=(1, 2, 4), n_slots=4, max_len=64, prefill_buckets=(32,), record_logits=True)


def _padded_kw(bucket):
    return dict(candidate_tps=(1,), n_slots=1, max_len=64, prefill_buckets=(bucket,), record_logits=True)


def _padded_request(cls):
    prompt = np.random.RandomState(5).randint(0, 256, size=PADDED_PROMPT_LEN).astype(np.int32)
    return cls(100, "strict", prompt, 4)


def _reference_engines(out):
    """The reference engine over 4 host devices at fixed TP 1, then under
    SCHEDULE, then (TP 1) the padded-bucket prompt in its bucket of 32, then
    fixed and under SCHEDULE again on ``_fan_in_params`` (the engine's
    storage rebuilt from them at TP 1); and an engine on one device whose
    only bucket is the prompt's length, 20. One engine serves the five
    runs, so its executables compile once. The weights, trajectories and
    logits go to ``out`` (pickle)."""
    from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine
    from repro.serving.request import Request as JRequest

    assert len(jax.devices()) >= N_POOL, jax.devices()
    jcfg, _ = _serve_cfgs()
    jparams = _jax_params(jcfg)
    res = {"params": jax.tree_util.tree_map(np.asarray, jparams)}
    eng = JServingEngine(jcfg, jparams, devices=jax.devices()[:N_POOL],
                         econf=JEngineConfig(**_engine_kw(), dtype=jnp.float32))
    assert eng.tps == [1, 2, 4]
    for case, schedule, reqs in (("fixed", None, _requests(JRequest)), ("switch", SCHEDULE, _requests(JRequest)),
                                 ("bucket32", None, [_padded_request(JRequest)])):
        eng.logit_trace = {}
        switches = eng.stats.switches
        done = eng.run(reqs, switch_schedule=schedule)
        assert eng.tp == 1 and eng.stats.switches - switches == len(schedule or {})
        res[case] = {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
                     "logits": {k: [np.asarray(x) for x in v] for k, v in eng.logit_trace.items()}}
        print(f"{case}: {len(done)} requests")
    fan_in = _fan_in_params(jcfg)
    res["fan_in_params"] = jax.tree_util.tree_map(np.asarray, fan_in)
    eng.storage = eng.store.build(fan_in, eng.meshes[eng.tp])
    for case, schedule in (("fan_in_fixed", None), ("fan_in_switch", SCHEDULE)):
        eng.logit_trace = {}
        done = eng.run(_requests(JRequest), switch_schedule=schedule)
        assert eng.tp == 1
        res[case] = {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
                     "logits": {k: [np.asarray(x) for x in v] for k, v in eng.logit_trace.items()}}
        print(f"{case}: {len(done)} requests")
    eng = JServingEngine(jcfg, jparams, devices=jax.devices()[:1], econf=JEngineConfig(**_padded_kw(PADDED_PROMPT_LEN)))
    done = eng.run([_padded_request(JRequest)])
    res[f"bucket{PADDED_PROMPT_LEN}"] = {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
                                         "logits": {k: [np.asarray(x) for x in v] for k, v in eng.logit_trace.items()}}
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


@pytest.fixture(scope="module")
def reference_engines(tmp_path_factory):
    out = tmp_path_factory.mktemp("mamba_engine") / "reference.pkl"
    _run("engine", str(out))
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("case", ["fixed", "switch"])
def test_jamba_engine_matches_reference_engine(reference_engines, case):
    """The port's engine over a pool of 4 ranks (TP 1/2/4) against the
    reference engine over 4 host devices, at fixed TP 1 and under SCHEDULE
    (requests 4-7 prefilled after switches; prompts shorter than their
    bucket among them): the same greedy tokens, every step's logits within
    ENGINE_TOL, no assignment dropped (capacity factor 8.0), and the same
    tokens in both cases."""
    ref = reference_engines[case]
    _, cfg = _serve_cfgs()
    eng = ServingEngine(cfg, to_torch(reference_engines["params"], device="cpu"), EngineConfig(**_engine_kw()),
                        device="cpu")
    done = eng.run(_requests(Request), switch_schedule=SCHEDULE if case == "switch" else None)
    assert len(done) == len(NEW_TOKENS) and eng.stats.switches == (len(SCHEDULE) if case == "switch" else 0)
    got = {r.req_id: r.generated for r in done}
    assert got == ref["tokens"] == reference_engines["fixed"]["tokens"]
    for rid, steps in ref["logits"].items():
        assert len(eng.logit_trace[rid]) == len(steps) == NEW_TOKENS[rid]
        for g, w in zip(eng.logit_trace[rid], steps):
            np.testing.assert_allclose(g, w, **ENGINE_TOL, err_msg=f"request {rid}")
    assert not any(eng.moe_dropped().values())


@pytest.mark.parametrize("case", ["fixed", "switch"])
def test_jamba_engine_matches_reference_engine_at_own_fan_in(reference_engines, case):
    """test_jamba_engine_matches_reference_engine on weights drawn at each
    layer's own fan-in (``_fan_in_params``), where reduced jamba is well
    conditioned in f32: the same tokens, every step's logits within
    FAN_IN_TOL, the bound of the other engine tests."""
    ref = reference_engines[f"fan_in_{case}"]
    _, cfg = _serve_cfgs()
    eng = ServingEngine(cfg, to_torch(reference_engines["fan_in_params"], device="cpu"), EngineConfig(**_engine_kw()),
                        device="cpu")
    done = eng.run(_requests(Request), switch_schedule=SCHEDULE if case == "switch" else None)
    assert len(done) == len(NEW_TOKENS) and eng.stats.switches == (len(SCHEDULE) if case == "switch" else 0)
    assert {r.req_id: r.generated for r in done} == ref["tokens"] == reference_engines["fan_in_fixed"]["tokens"]
    for rid, steps in ref["logits"].items():
        assert len(eng.logit_trace[rid]) == len(steps) == NEW_TOKENS[rid]
        for g, w in zip(eng.logit_trace[rid], steps):
            np.testing.assert_allclose(g, w, **FAN_IN_TOL, err_msg=f"request {rid}")
    assert not any(eng.moe_dropped().values())


@pytest.fixture(scope="module")
def pool_engines(reference_engines, tmp_path_factory):
    """The port's engine across processes on reduced jamba at its own
    fan-in: ``multidev_checks engine`` on a pool of 4 processes under gloo,
    fixed TP 1 and under SCHEDULE, on the reference's ``_fan_in_params``."""
    case = {"model": JAMBA, "params": reference_engines["fan_in_params"], "engine": _engine_kw(),
            "schedule": SCHEDULE, "requests": [(r.prompt, r.max_new_tokens) for r in _requests(Request)]}
    tmp = tmp_path_factory.mktemp("jamba_pool")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"engine": case}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.testing.multidev_checks", "engine", str(N_POOL), "cpu",
                        "--inputs", str(tmp / "inputs.pkl"), "--out", str(tmp / "out.pkl")], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK engine" in r.stdout, f"engine failed:\n{r.stdout}\n{r.stderr}"
    with open(tmp / "out.pkl", "rb") as f:
        return [rank["engine"] for rank in pickle.load(f)]


@pytest.mark.parametrize("case", ["fixed", "switch"])
def test_jamba_pool_engine_matches_reference_engine_at_own_fan_in(reference_engines, pool_engines, case):
    """The engine across a pool of 4 processes (gloo) on reduced jamba at
    each layer's own fan-in: each Mamba layer runs on its rank's d_inner/t
    channels and keeps only their state, which a switch reshards with the
    KV. On every rank, at fixed TP 1 and under SCHEDULE, the reference
    engine's tokens and every step's logits within FAN_IN_TOL; nothing
    dropped (capacity factor 8.0)."""
    ref = reference_engines[f"fan_in_{case}"]
    key = "logits_fixed" if case == "fixed" else "logits_switched"
    for rank in pool_engines:
        s, a = rank["summary"], rank["arrays"]
        assert s["switches"] == len(SCHEDULE) and s["requests"] == len(NEW_TOKENS) and s["tps"] == [1, 2, 4]
        assert a["trajectories"] == ref["tokens"] == reference_engines["fan_in_fixed"]["tokens"]
        for rid, steps in ref["logits"].items():
            assert len(a[key][rid]) == len(steps) == NEW_TOKENS[rid]
            np.testing.assert_allclose(a[key][rid], np.stack(steps), **FAN_IN_TOL, err_msg=f"request {rid}")
        assert not any(n for run in a["moe_dropped"].values() for n in run.values())


def test_jamba_slot_holds_the_prefill_state(reference_engines):
    """After admit, each Mamba layer's slot row is the prefill's final state
    and conv tail of the padded bucket, in the cache's dtype; the attention
    layer's K/V fill the bucket's rows."""
    _, cfg = _serve_cfgs()
    params = to_torch(reference_engines["params"], device="cpu")
    eng = ServingEngine(cfg, params, EngineConfig(**_engine_kw()), device="cpu")
    req = _requests(Request)[0]
    assert eng.admit(req)
    tokens = torch.zeros((1, 32), dtype=torch.int64)
    tokens[0, :req.prompt_len] = torch.from_numpy(req.prompt.astype(np.int64))
    _, kv = forward(eng.ctl.bindings[1], cfg, eng.ec, tokens=tokens, mode="prefill", block_q=64, block_k=64,
                    pool=N_POOL)
    for layer, c in zip(eng.slots.layers, kv):
        if "k" in c:
            assert torch.equal(layer["k"][req.slot, :32], c["k"][0])
        else:
            assert set(c) == {"h", "conv"}
            for k in c:
                assert torch.equal(layer[k][req.slot], c[k][0])


def test_padded_bucket_changes_the_state_in_both_packages(reference_engines):
    """The reference prefills the whole padded bucket, so a 20-token prompt
    in bucket 32 carries 12 padding tokens into its recurrent state: its
    first token is the same as in a bucket of 20 (logits within
    ENGINE_TOL), the decode steps after it are not. The port's engine gives
    the reference's tokens in both buckets (32: the engine of the other
    tests, with its 4 slots; 20: an engine whose only bucket is 20)."""
    _, cfg = _serve_cfgs()
    params = to_torch(reference_engines["params"], device="cpu")
    got = {}
    for bucket, kw in ((32, _engine_kw()), (PADDED_PROMPT_LEN, _padded_kw(PADDED_PROMPT_LEN))):
        eng = ServingEngine(cfg, params, EngineConfig(**kw), device="cpu")
        req = eng.run([_padded_request(Request)])[0]
        ref = reference_engines[f"bucket{bucket}"]
        assert {req.req_id: req.generated} == ref["tokens"], bucket
        for g, w in zip(eng.logit_trace[req.req_id], ref["logits"][req.req_id]):
            np.testing.assert_allclose(g, w, **ENGINE_TOL, err_msg=f"bucket {bucket}")
        got[bucket] = req.generated
    short, padded = got[PADDED_PROMPT_LEN], got[32]
    assert short[0] == padded[0] and short[1:] != padded[1:]


def _conditioning():
    """Print, for every step of the fixed-TP-1 engine run, the largest
    logit difference between the reference and the port, and of each from
    an f64 evaluation of the same steps (the port's forward with every
    product and sum in f64: plain matmul and attention versions, ``float()``
    of an f64 tensor left as it is; one request at a time, TP 1; checked
    against the same evaluation at TP 4)."""
    import tempfile

    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref
    from repro_torch.models import attention, layers, logits_for

    with tempfile.TemporaryDirectory() as tmp:
        _run("engine", f"{tmp}/reference.pkl")
        with open(f"{tmp}/reference.pkl", "rb") as f:
            ref = pickle.load(f)
    _, cfg = _serve_cfgs()
    eng = ServingEngine(cfg, to_torch(ref["params"], device="cpu"), EngineConfig(**_engine_kw()), device="cpu")
    eng.run(_requests(Request))

    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else to_f32(t, *a, **k)
    layers.tp_shard_matmul = mamba.tp_shard_matmul = (
        lambda x, w, off, *, n_out, mode="col", out_dtype=None:
        tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=x.dtype))
    attention.paged_decode_attention = (lambda q, kp, vp, bt, sl, softcap=None:
                                        paged_decode_attention_ref(q, kp, vp, bt, sl, softcap=softcap))
    params = to_torch(ref["params"], device="cpu", dtype=torch.float64)
    ec = make_exec_config(cfg, 4)
    L, max_len = _engine_kw()["prefill_buckets"][0], _engine_kw()["max_len"]

    def exact(req, tp):
        b = _bind(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), params, tp)
        toks = torch.zeros((1, L), dtype=torch.int64)
        toks[0, :req.prompt_len] = torch.from_numpy(req.prompt.astype(np.int64))
        h, kv = forward(b, cfg, ec, tokens=toks, mode="prefill", block_q=64, block_k=64, pool=N_POOL)
        out = [logits_for(b, cfg, h[:, req.prompt_len - 1:req.prompt_len])[0, 0, :cfg.vocab_size].numpy()]
        cache = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, max_len - L)) if "k" in c else v.clone()
                  for k, v in c.items()} for c in kv]
        table = torch.arange(max_len // 16, dtype=torch.int32).view(1, -1)
        for s, tok in enumerate(ref["fixed"]["tokens"][req.req_id][:-1]):
            pos = req.prompt_len + s
            attn = ["k" in c for c in cache]
            h, _ = forward(b, cfg, ec, tokens=torch.tensor([[tok]]), positions=torch.tensor([pos]), cache=cache,
                           block_tables=[table if a else None for a in attn],
                           seq_lens=[torch.tensor([pos + 1], dtype=torch.int32) if a else None for a in attn],
                           mode="decode", pool=N_POOL)
            out.append(logits_for(b, cfg, h)[0, 0, :cfg.vocab_size].numpy())
        return out

    worst = {"ref-port": 0.0, "ref-f64": 0.0, "port-f64": 0.0}
    for req in _requests(Request):
        f64 = exact(req, 1)
        assert max(np.abs(a - b).max() for a, b in zip(f64, exact(req, 4))) < 1e-9  # f64 throughout
        for s, (w, p, t) in enumerate(zip(ref["fixed"]["logits"][req.req_id], eng.logit_trace[req.req_id], f64)):
            d = {"ref-port": np.abs(w - p).max(), "ref-f64": np.abs(w - t).max(), "port-f64": np.abs(p - t).max()}
            worst = {k: max(v, d[k]) for k, v in worst.items()}
            print(f"request {req.req_id} step {s}: " + ", ".join(f"{k} {v:.2e}" for k, v in d.items())
                  + f"; max |logit| {np.abs(t).max():.2f}")
    print("largest: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


def _fan_in_readings():
    """Print the largest logit difference between the port's engine and
    the reference's on ``_fan_in_params``, fixed and under SCHEDULE, and
    the largest logit."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _run("engine", f"{tmp}/reference.pkl")
        with open(f"{tmp}/reference.pkl", "rb") as f:
            ref = pickle.load(f)
    _, cfg = _serve_cfgs()
    for case, schedule in (("fixed", None), ("switch", SCHEDULE)):
        eng = ServingEngine(cfg, to_torch(ref["fan_in_params"], device="cpu"), EngineConfig(**_engine_kw()),
                            device="cpu")
        eng.run(_requests(Request), switch_schedule=schedule)
        want = ref[f"fan_in_{case}"]["logits"]
        diff = max(np.abs(g - w).max() for rid in want for g, w in zip(eng.logit_trace[rid], want[rid]))
        top = max(np.abs(w).max() for steps in want.values() for w in steps)
        print(f"{case}: max |port - reference| {diff:.3g}, max |logit| {top:.3g}")


if __name__ == "__main__":
    {"engine": lambda: _reference_engines(sys.argv[2]), "conditioning": _conditioning,
     "fan_in": _fan_in_readings}[sys.argv[1]]()
