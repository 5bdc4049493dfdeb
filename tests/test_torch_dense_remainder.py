"""The dense family's remainder in the port against the reference, on the
same weights and numpy inputs: yi-34b and mistral-large-123b (llama-shaped
GQA) and musicgen-large (audio, the encodec frontend: codebook ids through
the embedding, or frame embeddings through ``forward``'s ``embeds``).
Configs, parameter trees, reduced prefill/decode forward and logits, and the
serving engine against the reference engine."""
import functools
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models import forward as j_forward, model_param_defs as j_param_defs  # noqa: E402
from repro.models.model import logits_for as j_logits_for  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import count_params, forward, logits_for, model_param_defs  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

CPU = torch.device("cpu")
MODELS = ["yi-34b", "mistral-large-123b", "musicgen-large"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(name, **kw):
    jcfg, cfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    return replace(jcfg, **kw), replace(cfg, **kw)


def _jax_params(jcfg, seed=0):
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)


def _jax_leaves(tree):
    return {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


def _bind(cfg, params, tp):
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * tp)
    return store.rebind(store.build(params), tp)


@functools.lru_cache(maxsize=1)
def _model(name):
    """(reference config, port config, reference params, port params at TP 1 and 2)."""
    jcfg, cfg = _pair(name)
    jparams = _jax_params(jcfg)
    params = to_torch(jparams, device="cpu")
    return jcfg, cfg, jparams, {tp: _bind(cfg, params, tp) for tp in (1, 2)}


@pytest.mark.parametrize("name", MODELS)
def test_config_fields_match_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    for f in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "vocab_padded", "norm_eps", "final_logit_softcap", "tie_embeddings", "frontend",
              "subquadratic", "source", "num_periods", "n_attn_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.attn) == vars(jcfg.attn) and cfg.moe is None
    assert [(t.mixer, t.ffn) for t in cfg.layer_pattern] == [(t.mixer, t.ffn) for t in jcfg.layer_pattern]
    check_supported(cfg)
    r, jr = reduced(cfg), j_reduced(jcfg)
    assert (r.num_layers, r.num_heads, r.num_kv_heads, r.d_model) == (jr.num_layers, jr.num_heads, jr.num_kv_heads,
                                                                      jr.d_model)


@pytest.mark.parametrize("name", MODELS + ["moonshot-v1-16b-a3b", "dbrx-132b"])
def test_full_width_param_counts(name):
    """The defs hold the config's parameters and the final norm: yi-34b
    34.39 B (68.8 GB in bf16), mistral-large-123b 122.6 B, musicgen-large
    3.23 B (12.9 GB in f32), moonshot 28.06 B, dbrx 131.6 B."""
    cfg = get_config(name)
    assert cfg.param_count() == j_get_config(name).param_count()
    assert count_params(model_param_defs(cfg, make_exec_config(cfg, 1))) == cfg.param_count() + cfg.d_model
    assert cfg.param_count() == {"yi-34b": 34_388_910_080, "mistral-large-123b": 122_610_057_216,
                                 "musicgen-large": 3_229_810_688, "moonshot-v1-16b-a3b": 28_057_993_216,
                                 "dbrx-132b": 131_596_517_376}[name]


@pytest.mark.parametrize("tp", [1, 2, 8])
@pytest.mark.parametrize("name", MODELS)
def test_param_defs_match_reference(name, tp):
    """Full width: yi-34b's 56 heads and mistral's 96 over 8 KV heads,
    musicgen's 32 MHA heads."""
    jcfg, cfg = j_get_config(name), get_config(name)
    want = {p: (d.shape, d.axes, d.init, d.scale)
            for p, d in _jax_leaves(j_param_defs(jcfg, j_make_exec_config(jcfg, tp))).items()}
    got = {p: (d.shape, d.axes, d.init, d.scale)
           for p, d in tree_leaves_with_path(model_param_defs(cfg, make_exec_config(cfg, tp)))}
    assert got == want
    ec, jec = make_exec_config(cfg, tp), j_make_exec_config(jcfg, tp)
    assert (ec.heads_exec, ec.kv_exec, ec.q_per_kv) == (jec.heads_exec, jec.kv_exec, jec.q_per_kv)


def _inputs(jcfg, cfg, jparams, B, S, seed, embeds):
    """(reference kwargs, port kwargs) of the same tokens, or of the same
    frame embeddings (B, S, d_model)."""
    rng = np.random.RandomState(seed)
    if embeds:
        e = rng.randn(B, S, cfg.d_model).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.randint(0, cfg.vocab_size, size=(B, S))
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("name,embeds", [(n, False) for n in MODELS] + [("musicgen-large", True)],
                         ids=[f"{n}-tokens" for n in MODELS] + ["musicgen-large-embeds"])
def test_prefill_then_decode_matches_reference(name, embeds, tp):
    """Prefill of 12 positions in blocks of 4, then 3 decode steps over the
    slot cache's layout, at TP 1 and 2: logits and caches at 2e-4, through
    token ids, and for musicgen-large also through frame embeddings (its
    frontend's input)."""
    jcfg, cfg, jparams, bound = _model(name)
    params = bound[tp]
    ec, jec = make_exec_config(cfg, tp), j_make_exec_config(jcfg, tp)
    B, prompt, max_len = 2, 12, 16
    jin, pin = _inputs(jcfg, cfg, jparams, B, prompt + 3, 5, embeds)
    head = {k: v[:, :prompt] for k, v in jin.items()}
    jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, mode="prefill", block_q=4, block_k=4,
                              **head)
    h, kv = forward(params, cfg, ec, mode="prefill", block_q=4, block_k=4, **{k: v[:, :prompt] for k, v in pin.items()})
    np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                               np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), **TOL)
    for i, c in enumerate(kv):
        for k in ("k", "v"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jcache["pos0"][k][i]), **TOL)
    cache = [{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, max_len - prompt)).contiguous() for k in c} for c in kv]
    jcache = {pos: {k: jnp.pad(c, ((0, 0), (0, 0), (0, max_len - prompt), (0, 0), (0, 0))) for k, c in d.items()}
              for pos, d in jcache.items()}
    tables = [torch.arange(B * 2, dtype=torch.int32).view(B, 2)] * cfg.num_layers
    for step in range(3):
        pos = np.full((B,), prompt + step)
        jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None,
                                  positions=jnp.asarray(pos, jnp.int32), cache=jcache, mode="decode",
                                  **{k: v[:, prompt + step:prompt + step + 1] for k, v in jin.items()})
        lens = [torch.from_numpy((pos + 1).astype(np.int32))] * cfg.num_layers
        h, _ = forward(params, cfg, ec, positions=torch.from_numpy(pos), cache=cache, block_tables=tables,
                       seq_lens=lens, mode="decode", **{k: v[:, prompt + step:prompt + step + 1] for k, v in pin.items()})
        np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                                   np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), **TOL,
                                   err_msg=f"step {step}")


def test_forward_takes_one_input():
    jcfg, cfg = _pair("musicgen-large")
    params = _bind(cfg, to_torch(_jax_params(jcfg), device="cpu"), 1)
    ec = make_exec_config(cfg, 1)
    with pytest.raises(ValueError, match="exactly one"):
        forward(params, cfg, ec, mode="prefill")
    with pytest.raises(ValueError, match="exactly one"):
        forward(params, cfg, ec, tokens=torch.zeros((1, 4), dtype=torch.long),
                embeds=torch.zeros((1, 4, cfg.d_model)), mode="prefill")


# ---------------------------------------------------------------------------
# the serving engine (token ids, as the reference engine serves musicgen)
# ---------------------------------------------------------------------------
SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}


def _requests(cls, vocab):
    rng = np.random.RandomState(0)
    return [cls(i, "strict", rng.randint(0, vocab, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(10)]


def _engine_kw():
    return dict(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32), record_logits=True)


@pytest.fixture(scope="module", params=MODELS)
def served(request):
    """The reference engine on one CPU device (TP 1), and the same weights
    for the port; 4 KV heads, so the port takes TP 4."""
    jcfg, cfg = _pair(request.param, num_kv_heads=4)
    jparams = _jax_params(jcfg)
    eng = JServingEngine(jcfg, jparams, devices=jax.devices()[:1], econf=JEngineConfig(**_engine_kw(), dtype=jnp.float32))
    done = eng.run(_requests(JRequest, cfg.vocab_size))
    return cfg, to_torch(jparams, device="cpu"), {r.req_id: list(r.generated) for r in done}, eng.logit_trace


@pytest.mark.parametrize("schedule", [None, SCHEDULE], ids=["fixed_tp1", "switch_schedule"])
def test_engine_matches_reference(served, schedule):
    """Greedy tokens identical and every step's logits within 2e-4 of the
    reference engine, at TP 1 and under TP switches over 1/2/4, with no
    weight moved by a rebind."""
    cfg, params, want_tokens, want_logits = served
    eng = ServingEngine(cfg, params, EngineConfig(**_engine_kw()), device="cpu")
    ptrs = sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos)
    done = eng.run(_requests(Request, cfg.vocab_size), switch_schedule=schedule)
    assert eng.stats.switches == (len(schedule) if schedule else 0)
    assert sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos) == ptrs
    assert {r.req_id: r.generated for r in done} == want_tokens
    for rid, steps in want_logits.items():
        assert len(eng.logit_trace[rid]) == len(steps) == 24
        for g, w in zip(eng.logit_trace[rid], steps):
            np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=f"request {rid}")
