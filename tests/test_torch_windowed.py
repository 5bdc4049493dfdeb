"""The port's sliding-window and local/global attention, qk-norm and tied
embeddings against the reference, on the same weights and numpy inputs:
configs, parameter trees, prefill/decode forward and logits (past the
window too), the serving engine's trajectories and logits (also for a
prompt shorter than a bucket larger than the window, and under a TP
switch), and the KV bytes a switch moves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.core.migration import kv_migration_bytes as j_kv_migration_bytes  # noqa: E402
from repro.models import forward as j_forward, model_param_defs as j_param_defs  # noqa: E402
from repro.models.model import logits_for as j_logits_for  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402

from repro_torch.checkpoint.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.migration import kv_migration_bytes  # noqa: E402
from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import forward, logits_for, model_param_defs  # noqa: E402
from repro_torch.models.model import check_supported, init_cache_defs, layer_windows  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import ShardView, make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PAGE_SIZE, SlotCache  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

CPU = torch.device("cpu")
MODELS = ["gemma2-2b", "h2o-danube-1.8b", "chameleon-34b"]
SERVED = ["gemma2-2b", "h2o-danube-1.8b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _pair(name):
    return j_reduced(j_get_config(name)), reduced(get_config(name))


def _jax_params(jcfg, seed=0):
    return j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)


def _bind(cfg, params, tp):
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * tp)
    return store.rebind(store.build(params), tp)


def _jax_leaves(tree):
    return {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "axes"))[0]}


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, reference config, port config, reference params, port params at TP 1)."""
    jcfg, cfg = _pair(request.param)
    jparams = _jax_params(jcfg)
    return request.param, jcfg, cfg, jparams, _bind(cfg, to_torch(jparams, device="cpu"), 1)


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MODELS)
def test_config_fields_match_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    for f in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "vocab_padded", "norm_eps", "final_logit_softcap", "tie_embeddings", "frontend",
              "subquadratic", "source", "num_periods", "n_attn_layers"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.attn) == vars(jcfg.attn)
    assert [(t.mixer, t.ffn) for t in cfg.layer_pattern] == [(t.mixer, t.ffn) for t in jcfg.layer_pattern]
    check_supported(cfg)
    r, jr = reduced(cfg), j_reduced(jcfg)
    assert (r.num_layers, r.num_kv_heads, r.attn.window) == (jr.num_layers, jr.num_kv_heads, jr.attn.window)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_param_defs_match_reference(name, tp):
    jcfg, cfg = _pair(name)
    want = {p: (d.shape, d.axes, d.init, d.scale) for p, d in _jax_leaves(j_param_defs(jcfg, j_make_exec_config(jcfg, tp))).items()}
    got = {p: (d.shape, d.axes, d.init, d.scale) for p, d in tree_leaves_with_path(model_param_defs(cfg, make_exec_config(cfg, tp)))}
    assert got == want
    assert ("lm_head",) not in got if cfg.tie_embeddings else ("lm_head",) in got
    assert any(p[-1] == "q_norm" for p in got) == cfg.attn.qk_norm


def test_full_width_param_counts():
    """gemma2-2b's tied embedding is counted once: 2.61 B parameters, 10.5 GB
    in f32; h2o-danube-1.8b 1.83 B."""
    from repro_torch.models import count_params

    counts = {n: count_params(model_param_defs(get_config(n), make_exec_config(get_config(n), 1))) for n in SERVED}
    assert counts == {"gemma2-2b": 2_614_222_080, "h2o-danube-1.8b": 1_831_201_280}
    assert [w for w in layer_windows(get_config("gemma2-2b"))[:4]] == [4096, None, 4096, None]


@pytest.mark.parametrize("name", MODELS)
def test_weight_carry_round_trip(name):
    jcfg, _ = _pair(name)
    jparams = _jax_params(jcfg)
    back = dict(tree_leaves_with_path(to_numpy(to_torch(jparams, device="cpu"))))
    want = _jax_leaves(jparams)
    assert set(back) == set(want)
    for p, x in back.items():
        np.testing.assert_array_equal(x, np.asarray(want[p]))


# ---------------------------------------------------------------------------
# forward and logits
# ---------------------------------------------------------------------------
def _layer_cache(jcache, cfg, i):
    period = len(cfg.layer_pattern)
    return jcache[f"pos{i % period}"], i // period


def test_prefill_logits_and_cache_match_reference(model):
    """Prefill of 24 tokens (> the reduced window of 16: the rotating
    buffer) in blocks of 8; logits of every position and every layer's
    cache at 2e-4."""
    name, jcfg, cfg, jparams, params = model
    ec, jec = make_exec_config(cfg, 1), j_make_exec_config(jcfg, 1)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 24))
    jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, tokens=jnp.asarray(tokens),
                              mode="prefill", block_q=8, block_k=8)
    h, kv = forward(params, cfg, ec, tokens=torch.from_numpy(tokens), mode="prefill", block_q=8, block_k=8)
    np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                               np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), **TOL)
    for i, (c, window) in enumerate(zip(kv, layer_windows(cfg))):
        jc, period = _layer_cache(jcache, cfg, i)
        assert c["k"].shape[1] == (window if window is not None else 24)
        for k in ("k", "v"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k][period]), **TOL)


@pytest.mark.parametrize("prompt", [12, 24], ids=["prompt_inside_window", "prompt_past_window"])
def test_decode_steps_past_the_window_match_reference(model, prompt):
    """Prefill, then 6 decode steps over the slot cache's layout (a windowed
    layer's cache is min(window, max_len) rows, written at position % window;
    max_len 48): from a prompt of 12 the buffer wraps after 4 steps, from 24
    every step writes a wrapped buffer. Hidden-state logits and the caches at
    each step at 2e-4."""
    name, jcfg, cfg, jparams, params = model
    ec, jec = make_exec_config(cfg, 1), j_make_exec_config(jcfg, 1)
    B, max_len, page = 2, 48, 8
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, cfg.vocab_size, size=(B, prompt + 6))
    _, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, tokens=jnp.asarray(tokens[:, :prompt]),
                             mode="prefill", block_q=4, block_k=4)
    _, kv = forward(params, cfg, ec, tokens=torch.from_numpy(tokens[:, :prompt]), mode="prefill", block_q=4, block_k=4)
    sizes = [d["k"].shape[1] for d in init_cache_defs(cfg, ec, B, max_len)]
    cache = [{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, Sc - c[k].shape[1])).contiguous() for k in c}
             for c, Sc in zip(kv, sizes)]
    # pos{i} holds the layers i, i + period, ...; layer i's cache length is theirs
    jcache = {pos: {k: jnp.pad(c, ((0, 0), (0, 0), (0, sizes[int(pos[3:])] - c.shape[2]), (0, 0), (0, 0)))
                    for k, c in d.items()} for pos, d in jcache.items()}
    for step in range(6):
        pos = np.full((B,), prompt + step)
        tok = tokens[:, prompt + step:prompt + step + 1]
        jh, jcache, _ = j_forward(jparams, jcfg, jec, rules=DEFAULT_RULES, mesh=None, tokens=jnp.asarray(tok),
                                  positions=jnp.asarray(pos, jnp.int32), cache=jcache, mode="decode")
        tables = [torch.arange(B * Sc // page, dtype=torch.int32).view(B, Sc // page) for Sc in sizes]
        lens = [torch.from_numpy(np.minimum(pos + 1, Sc).astype(np.int32)) for Sc in sizes]
        h, _ = forward(params, cfg, ec, tokens=torch.from_numpy(tok), positions=torch.from_numpy(pos), cache=cache,
                       block_tables=tables, seq_lens=lens, mode="decode")
        np.testing.assert_allclose(logits_for(params, cfg, h).numpy(),
                                   np.asarray(j_logits_for(jparams, jcfg, jh, DEFAULT_RULES, None)), **TOL,
                                   err_msg=f"{name} step {step}")
        for i, c in enumerate(cache):
            jc, period = _layer_cache(jcache, cfg, i)
            for k in ("k", "v"):
                np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k][period]), **TOL)


@pytest.mark.parametrize("tp", [2])
def test_tied_head_reads_the_embedding_in_place(tp):
    """Reduced gemma2 at TP 2: no lm_head leaf; each rank's head is a view of
    the embedding storage, the logits equal TP 1's, and the bound embed's
    pointers are the storage's own."""
    jcfg, cfg = _pair("gemma2-2b")
    params = to_torch(_jax_params(jcfg), device="cpu")
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [CPU] * tp)
    storage = store.build(params)
    tokens = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab_size, size=(2, 16)))
    outs = {}
    for t in (1, tp):
        bound = store.rebind(storage, t)
        assert "lm_head" not in bound and isinstance(bound["embed"], ShardView)
        assert {m.data_ptr() for m in bound["embed"].mats} == {storage["embed"][0].data_ptr()}
        h, _ = forward(bound, cfg, make_exec_config(cfg, t), tokens=tokens, mode="prefill", block_q=8, block_k=8)
        outs[t] = logits_for(bound, cfg, h).numpy()
    np.testing.assert_allclose(outs[tp], outs[1], **TOL)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
# prompt lengths: 20 and 29 pad into bucket 32 > window 16 (the padded
# rotating buffer), 32 fills it, 10 wraps the buffer during decode
PROMPTS = [5, 20, 32, 10, 16, 17, 3, 29, 8, 24]
SCHEDULE = {3: 2, 7: 1, 13: 2}


def _requests(cls, vocab):
    rng = np.random.RandomState(0)
    return [cls(i, "strict", rng.randint(0, vocab, size=n).astype(np.int32), 24) for i, n in enumerate(PROMPTS)]


def _engine_kw():
    return dict(candidate_tps=(1, 2), n_slots=4, max_len=64, prefill_buckets=(8, 16, 32), record_logits=True)


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    """The reference engine on one CPU device (TP 1) and the same weights
    for the port."""
    jcfg, cfg = _pair(request.param)
    jparams = _jax_params(jcfg)
    eng = JServingEngine(jcfg, jparams, devices=jax.devices()[:1], econf=JEngineConfig(**_engine_kw(), dtype=jnp.float32))
    done = eng.run(_requests(JRequest, cfg.vocab_size))
    return cfg, to_torch(jparams, device="cpu"), {r.req_id: list(r.generated) for r in done}, eng.logit_trace


@pytest.mark.parametrize("schedule", [None, SCHEDULE], ids=["fixed_tp1", "switch_schedule"])
def test_engine_matches_reference(served, schedule):
    """Greedy trajectories token for token and every step's logits within
    2e-4 of the reference engine, at TP 1 and under TP switches, with no
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


def test_engine_padded_bucket_keeps_the_reference_behaviour(served):
    """A prompt of 20 tokens prefilled in bucket 32 (> window 16) keeps the
    bucket's last 16 positions, padding included, and decode attends to
    them, as the reference does: the port follows it, so its first decoded
    logits differ from those of a prompt prefilled in a bucket of 20."""
    cfg, params, _, _ = served
    if cfg.attn.kind not in ("swa", "local_global"):
        pytest.skip("windowed models only")
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, size=20).astype(np.int32)
    firsts = {}
    for buckets in ((32,), (20, 32)):
        kw = {**_engine_kw(), "prefill_buckets": buckets, "max_len": 64}
        eng = ServingEngine(cfg, params, EngineConfig(**kw), device="cpu")
        eng.admit(Request(0, "strict", prompt, 4))
        eng.step()
        firsts[buckets] = eng.logit_trace[0][1]
        local = next(i for i, w in enumerate(layer_windows(cfg)) if w is not None)
        assert eng.slots.layers[local]["k"].shape[1] == 16
    assert np.abs(firsts[(32,)] - firsts[(20, 32)]).max() > 1e-3


def test_slot_cache_per_layer_tables():
    """gemma2's alternating layers: local caches min(window, max_len) rows,
    global max_len, one identity table per length, seq_lens clamped per
    layer; a cache length that is not a multiple of PAGE_SIZE takes pages
    of its largest divisor up to PAGE_SIZE (window 20 and max_len 100:
    pages of 10; a prime length: pages of 1)."""
    from dataclasses import replace

    cfg = reduced(get_config("gemma2-2b"))
    ec = make_exec_config(cfg, 2)
    slots = SlotCache.create(cfg, ec, n_slots=3, max_len=48, dtype=torch.float32, device=CPU)
    assert [c["k"].shape[1] for c in slots.layers] == [16, 48]
    tables, lens = slots.page_tables(torch.tensor([3, 20, 47]))
    assert [t.shape for t in tables] == [(3, 16 // PAGE_SIZE), (3, 48 // PAGE_SIZE)]
    assert [x.tolist() for x in lens] == [[4, 16, 16], [4, 21, 48]]
    assert tables[0] is slots.tables[16] and tables[1] is slots.tables[48]
    odd = SlotCache.create(replace(cfg, attn=replace(cfg.attn, window=20)), ec, 2, 100, torch.float32, CPU)
    assert [c["k"].shape[1] for c in odd.layers] == [20, 100]
    assert [tuple(odd.tables[n].shape) for n in (20, 100)] == [(2, 2), (2, 10)]
    prime = SlotCache.create(cfg, ec, 2, 97, torch.float32, CPU)
    assert tuple(prime.tables[97].shape) == (2, 97) and tuple(prime.tables[16].shape) == (2, 1)


@pytest.mark.parametrize("S,window,block", [(64, None, 8), (64, 16, 8), (60, 16, 8), (48, 20, 16), (32, 64, 8)])
def test_live_blocks_are_the_pairs_with_an_unmasked_score(S, window, block):
    """The prefill's skipped block pairs, reckoned on the host from block
    position ranges, are exactly those whose every score is masked."""
    from repro_torch.models.attention import _block_sizes, live_blocks

    pos = torch.arange(S)
    bq, bk = _block_sizes(S, block, block)
    d = pos[:, None] - pos[None, :]
    mask = (d >= 0) & (d < window if window is not None else True)
    exact = mask.view(S // bq, bq, S // bk, bk).any(3).any(1)
    assert torch.equal(live_blocks(pos, window, block, block), exact)


def test_blockwise_prefill_over_unordered_positions_matches_dense_softmax():
    """With positions that are not increasing the host's live blocks may keep
    a masked pair, which changes nothing: the output equals a dense masked
    softmax."""
    from repro_torch.models.attention import _blockwise, live_blocks

    rng = np.random.RandomState(3)
    S, KV, G, hd, window = 32, 2, 2, 8, 12
    pos = torch.from_numpy(rng.permutation(S))
    q, k, v = (torch.from_numpy(rng.randn(1, S, KV, *r).astype(np.float32)) for r in ((G, hd), (hd,), (hd,)))
    got = _blockwise(q, k, v, pos, live_blocks(pos, window, 8, 8), window=window, cap=None, block_q=8, block_k=8)
    d = pos[:, None] - pos[None, :]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * hd ** -0.5
    s = s.masked_fill(~((d >= 0) & (d < window)), float("-inf"))
    want = torch.einsum("bkgqs,bskh->bqkgh", s.softmax(-1), v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_decode_takes_one_table_per_layer():
    cfg = reduced(get_config("h2o-danube-1.8b"))
    ec = make_exec_config(cfg, 1)
    params = _bind(cfg, to_torch(_jax_params(j_reduced(j_get_config("h2o-danube-1.8b"))), device="cpu"), 1)
    slots = SlotCache.create(cfg, ec, n_slots=2, max_len=32, dtype=torch.float32, device=CPU)
    pos = torch.tensor([3, 5])
    tables, lens = slots.page_tables(pos)
    with pytest.raises(ValueError, match="per layer"):
        forward(params, cfg, ec, tokens=torch.zeros((2, 1), dtype=torch.long), positions=pos, cache=slots.layers,
                block_tables=tables[:1], seq_lens=lens[:1], mode="decode")


def test_check_supported_refuses_what_is_still_missing():
    """MoE, the encodec frontend and the state families (an SSM, a hybrid
    with mamba mixers) are served now; an unknown frontend, MoE layers
    without a spec and mamba layers without one are not."""
    from dataclasses import replace

    from repro_torch.configs.base import LayerTemplate, MambaSpec

    llama = get_config("llama3-8b")
    for name in ("moonshot-v1-16b-a3b", "dbrx-132b", "musicgen-large", "mamba2-2.7b", "jamba-v0.1-52b"):
        check_supported(get_config(name))
    check_supported(replace(llama, family="ssm", mamba=MambaSpec()))
    hybrid = (LayerTemplate("mamba", "none"), LayerTemplate("attn", "dense"))
    check_supported(replace(llama, family="hybrid", pattern=hybrid, mamba=MambaSpec(version=1)))
    with pytest.raises(NotImplementedError, match="MambaSpec"):
        check_supported(replace(llama, family="hybrid", pattern=hybrid))
    with pytest.raises(NotImplementedError, match="frontend"):
        check_supported(replace(llama, family="audio", frontend="waveform"))
    with pytest.raises(NotImplementedError, match="MoESpec"):
        check_supported(replace(llama, family="moe", pattern=(LayerTemplate("attn", "moe"),)))


# ---------------------------------------------------------------------------
# KV bytes a switch moves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("n_seqs,ctx,from_tp,to_tp", [(16, 256, 1, 8), (8, 4096, 2, 4), (4, 9000, 1, 2), (1, 5000, 4, 1)])
def test_kv_migration_bytes_matches_reference(name, n_seqs, ctx, from_tp, to_tp):
    got = kv_migration_bytes(get_config(name), n_seqs, ctx, from_tp, to_tp)
    assert got == j_kv_migration_bytes(j_get_config(name), n_seqs, ctx, from_tp, to_tp)
    if ctx > 4096:  # the window bounds what moves
        assert got == kv_migration_bytes(get_config(name), n_seqs, 4096, from_tp, to_tp)
