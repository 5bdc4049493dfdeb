"""The port's model stack against the reference on the same weights: parameter
trees, layers, prefill/decode forward and logits, TP-decomposed logits, the
weight carry and initialisation."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.configs.base import AttnSpec as JAttnSpec, ModelConfig as JModelConfig  # noqa: E402
from repro.models import forward as j_forward, model_param_defs as j_param_defs  # noqa: E402
from repro.models.layers import apply_rope as j_apply_rope, rmsnorm as j_rmsnorm  # noqa: E402
from repro.models.model import logits_for as j_logits_for  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402

from repro_torch.checkpoint.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AttnSpec, ModelConfig  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import count_params, forward, init_params, logits_for, model_param_defs  # noqa: E402
from repro_torch.models.layers import apply_rope, rmsnorm  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402

CPU = torch.device("cpu")


def _tiny_pair():
    """multidev_checks._tiny_cfg in both packages: 8 heads, 2 KV heads."""
    kw = dict(name="tiny-dense", family="dense", num_layers=2, d_model=64, num_heads=8,
              num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    return JModelConfig(**kw, attn=JAttnSpec(kind="full")), ModelConfig(**kw, attn=AttnSpec(kind="full"))


def _llama_pair():
    return j_reduced(j_get_config("llama3-8b")), reduced(get_config("llama3-8b"))


def _jax_params(jcfg, seed=0):
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)


def _bind(cfg, params, tp, n_ranks=None):
    """The port's params bound at TP ``tp`` over CPU ranks."""
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * (n_ranks or tp))
    return store, store.rebind(store.build(params), tp)


def _jax_leaves(tree):
    return {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("which", ["llama3-8b-reduced", "tiny-dense"])
def test_param_defs_match_reference(which, tp):
    jcfg, cfg = _llama_pair() if which.startswith("llama") else _tiny_pair()
    assert cfg.name == jcfg.name
    want = {p: (d.shape, d.axes, d.init, d.scale) for p, d in _jax_leaves(j_param_defs(jcfg, j_make_exec_config(jcfg, tp))).items()}
    got = {p: (d.shape, d.axes, d.init, d.scale) for p, d in tree_leaves_with_path(model_param_defs(cfg, make_exec_config(cfg, tp)))}
    assert got == want
    ec, jec = make_exec_config(cfg, tp), j_make_exec_config(jcfg, tp)
    assert (ec.heads_exec, ec.kv_exec, ec.q_per_kv, ec.kv_repeat) == (jec.heads_exec, jec.kv_exec, jec.q_per_kv, jec.kv_repeat)


def test_llama3_8b_config_matches_reference():
    jcfg, cfg = j_get_config("llama3-8b"), get_config("llama3-8b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
              "vocab_padded", "norm_eps", "num_periods"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.attn.rope_theta == jcfg.attn.rope_theta and cfg.attn.kind == jcfg.attn.kind
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    assert count_params(defs) == 8_030_261_248  # 8.03 B parameters, f32: 32.1 GB


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    scale = (rng.randn(16) * 0.1).astype(np.float32)
    pos = np.array([[0, 3, 7, 100, 255]])
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    got = rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(scale), 1e-6).float().numpy()
    want = np.asarray(j_rmsnorm(jnp.asarray(x).astype(jd), jnp.asarray(scale), 1e-6), np.float32)
    np.testing.assert_allclose(got, want, **tol)
    got = apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), 500_000.0).float().numpy()
    want = np.asarray(j_apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos), 500_000.0), np.float32)
    np.testing.assert_allclose(got, want, **tol)


def test_forward_prefill_decode_and_logits_match_reference():
    """Reduced llama3-8b, same weights: prefill logits, the prefill cache, and
    one decode step against a cache of length 32 agree at 2e-4."""
    jcfg, cfg = _llama_pair()
    jparams = _jax_params(jcfg)
    ec, jec = make_exec_config(cfg, 1), j_make_exec_config(jcfg, 1)
    _, params = _bind(cfg, to_torch(jparams, device="cpu"), 1)
    rng = np.random.RandomState(1)
    B, S, Sc = 2, 12, 32
    tokens = rng.randint(0, cfg.vocab_size, size=(B, S + 1))

    jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None,
                              tokens=jnp.asarray(tokens[:, :S]), mode="prefill", block_q=4, block_k=4)
    h, kv = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, :S]), mode="prefill", block_q=4, block_k=4)
    np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                               np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), rtol=2e-4, atol=2e-4)
    for i, c in enumerate(kv):
        np.testing.assert_allclose(c["k"].numpy(), np.asarray(jcache["pos0"]["k"][i]), rtol=2e-4, atol=2e-4)

    # decode token S at position S over caches of length Sc
    jpad = jax.tree_util.tree_map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, Sc - S), (0, 0), (0, 0))), jcache)
    pos = np.full((B,), S)
    jh1, jnew, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, tokens=jnp.asarray(tokens[:, S:]),
                          positions=jnp.asarray(pos, jnp.int32), cache=jpad, mode="decode")
    cache = [{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, Sc - S)).contiguous() for k in c} for c in kv]
    n_pages = Sc // 8
    tables = torch.arange(B * n_pages, dtype=torch.int32).view(B, n_pages)
    h1, _ = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, S:]), positions=torch.from_numpy(pos),
                    cache=cache, block_tables=[tables] * cfg.num_layers,
                    seq_lens=[torch.full((B,), S + 1, dtype=torch.int32)] * cfg.num_layers, mode="decode")
    np.testing.assert_allclose(logits_for(params, cfg, h1).numpy(),
                               np.asarray(j_logits_for(jparams, jcfg, jh1, DEFAULT_RULES, None)), rtol=2e-4, atol=2e-4)
    for i, c in enumerate(cache):  # decode wrote the new K/V at position S in place
        for k in ("k", "v"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jnew["pos0"][k][i]), rtol=2e-4, atol=2e-4)


def test_tp_decomposed_logits_match_tp1():
    """check_weight_store's invariant on the port: the same storage served at
    TP 1/2/4/8 over 8 CPU ranks gives the same logits (kv=2, so TP 4 and 8
    block-replicate KV heads)."""
    jcfg, cfg = _tiny_pair()
    params = to_torch(_jax_params(jcfg), device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, size=(8, 16)))
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * 8)
    storage = store.build(params)
    outs = {}
    for tp in (1, 2, 4, 8):
        bound = store.rebind(storage, tp)
        h, _ = forward(bound, cfg, make_exec_config(cfg, tp), tokens=tokens, mode="prefill", block_q=16, block_k=16)
        outs[tp] = logits_for(bound, cfg, h)[..., : cfg.vocab_size].numpy()
    for tp in (2, 4, 8):
        np.testing.assert_allclose(outs[tp], outs[1], rtol=2e-4, atol=2e-4, err_msg=f"TP={tp}")
    # KV heads are replicated as j // repeat: at tp=4 ranks 0,1 read KV head 0
    wk = store.rebind(storage, 4)["layers"][0]["mixer"]["wk"]
    assert wk.offsets == (0, 0, 16, 16) and wk.width == 16


def test_weight_carry_round_trip():
    jcfg, _ = _llama_pair()
    jparams = _jax_params(jcfg)
    for dtype in (torch.float32, torch.bfloat16):
        t = to_torch(jparams, device="cpu", dtype=dtype)
        got = {p: x for p, x in tree_leaves_with_path(t)}
        want = _jax_leaves(jparams)
        assert set(got) == set(want)
        for p, x in got.items():
            assert x.dtype == dtype and tuple(x.shape) == want[p].shape and x.is_contiguous()
        back = {p: x for p, x in tree_leaves_with_path(to_numpy(t))}
        for p, x in back.items():
            tol = 0 if dtype == torch.float32 else 1e-2
            np.testing.assert_allclose(x, np.asarray(want[p]), rtol=tol, atol=tol)
    bf = to_torch(jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jparams), device="cpu")
    assert all(x.dtype == torch.bfloat16 for _, x in tree_leaves_with_path(bf))


def test_init_params_follows_reference_scale_rule():
    _, cfg = _llama_pair()
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    a = init_params(defs, torch.Generator().manual_seed(0))
    b = init_params(defs, torch.Generator().manual_seed(0))
    for (path, x), (_, y), (_, d) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b), tree_leaves_with_path(defs)):
        assert torch.equal(x, y) and tuple(x.shape) == d.shape
        if d.init == "zeros":
            assert not x.any()
        else:  # N(0, 1/shape[0]); stacked leaves count the period dim, as the reference does
            want = d.scale if d.scale is not None else 1 / math.sqrt(d.shape[0])
            assert abs(x.std().item() / want - 1) < 0.05, path
