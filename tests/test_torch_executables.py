"""The port's counterpart of the reference's ExecutableCache (one CUDA graph
per TP level and stage or bucket; on the CPU the step functions
themselves): its bookkeeping, the engine's warm-up filling it, and the
engine serving through it. The graphs themselves run on the card
(tests/test_torch_gpu.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import AttnSpec, ModelConfig  # noqa: E402
from repro_torch.core.tp_switch import ExecutableCache, TPSwitchController  # noqa: E402
from repro_torch.models import init_params, model_param_defs  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

CFG = ModelConfig(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
                  head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))
ECONF = EngineConfig(candidate_tps=(1, 2, 4), n_slots=4, max_len=64, prefill_buckets=(16, 32))


@pytest.fixture(scope="module")
def params():
    return init_params(model_param_defs(CFG, make_exec_config(CFG, 1)), torch.Generator().manual_seed(0))


def test_executable_cache_bookkeeping():
    """put / get / has / tps / capture_s, as the reference's put / get /
    has / tps / compile_s; on the CPU put neither runs nor captures, and a
    call runs the function on the inputs it is given."""
    cache = ExecutableCache()
    assert cache.tps() == [] and not cache.has(1, "decode") and cache.graphs() == 0
    assert cache.pool_bytes() is None and cache.replayed_launches() == {}
    calls = []

    def fn(x, y):
        calls.append((x, y))
        return (x + y,)

    static = (torch.zeros(3), torch.zeros(3))
    for tp, key in ((2, "decode"), (1, 32), (2, 64), (4, "decode")):
        cache.put(tp, key, fn, static)
    assert calls == []
    assert cache.tps() == [1, 2, 4]
    assert cache.has(2, 64) and cache.has(1, 32) and not cache.has(1, "decode") and not cache.has(2, 32)
    assert sorted(cache.capture_s, key=str) == sorted([(2, "decode"), (1, 32), (2, 64), (4, "decode")], key=str)
    assert all(s >= 0.0 for s in cache.capture_s.values())
    exe = cache.get(1, 32)
    out, = exe(torch.ones(3), torch.arange(3.0))
    assert torch.equal(out, torch.tensor([1.0, 2.0, 3.0])) and len(calls) == 1
    assert exe.graph is None and exe.replays == 0 and exe.launches == () and cache.graphs() == 0
    with pytest.raises(KeyError):
        cache.get(8, "decode")


def test_every_counted_wrapper_registers_itself():
    """The cache takes a capture's launches back off, and adds them at each
    replay, for the wrappers in ``_build.COUNTED``: each kernel wrapper
    registers itself there once, with its count at an int."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    wrappers = (tp_shard_matmul, paged_decode_attention, kv_gather, kv_scatter)
    assert len(_build.COUNTED) == len(wrappers)
    assert all(_build.COUNTED.count(w) == 1 and isinstance(w.launches, int) for w in wrappers)


def test_controller_owns_the_cache(params):
    from repro_torch.core.weight_store import WeightStore

    store = WeightStore(CFG, model_param_defs(CFG, make_exec_config(CFG, 1)), [torch.device("cpu")] * 4)
    ctl = TPSwitchController(store, (1, 2, 4))
    assert isinstance(ctl.cache, ExecutableCache) and ctl.cache.tps() == []


def test_engine_warmup_fills_the_cache(params):
    """One executable per candidate TP level for decode and per (TP level,
    bucket) for prefill, owned by the switch controller; a switch changes
    only which of them runs."""
    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    assert eng.cache is eng.ctl.cache and eng.cache.tps() == []
    eng.warmup()
    assert eng.cache.tps() == [1, 2, 4]
    keys = {(tp, key) for tp in (1, 2, 4) for key in ("decode", 16, 32)}
    assert all(eng.cache.has(*k) for k in keys) and set(eng.cache.capture_s) == keys
    assert eng.stats.warmup_s > 0
    before = dict(eng.cache.capture_s)
    eng.switch_tp(2)
    assert eng.tp == 2 and eng.cache.capture_s == before


def test_engine_warms_up_on_first_use_and_refuses_a_late_warmup(params):
    """An engine not warmed up makes its executables at the first admit;
    warmup() while a request holds a slot is refused (its runs write the
    KV cache)."""
    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    prompt = np.arange(5, dtype=np.int32)
    assert eng.admit(Request(0, "strict", prompt, 4))
    assert eng.cache.tps() == [1, 2, 4]
    with pytest.raises(RuntimeError, match="before admitting"):
        eng.warmup()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_prefill_step_gathers_the_last_token_and_inserts_into_the_slot(params, tp):
    """``_prefill`` takes the prompt's last position and the slot as index
    tensors: its logits equal the forward's at that position, and the
    slot's first L rows of every layer hold the prompt's K/V, other slots
    untouched."""
    from repro_torch.models import forward, logits_for

    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    bound = eng.ctl.bindings[tp]
    tokens = torch.from_numpy(np.random.RandomState(tp).randint(0, 256, size=(1, 16)))
    h, kv = forward(bound, CFG, eng.ec, tokens=tokens, mode="prefill", block_q=64, block_k=64)
    want = logits_for(bound, CFG, h[:, 10:11])[:, 0, : CFG.vocab_size]
    nxt, logits = eng._prefill(bound, tokens, torch.tensor([10]), torch.tensor([2]))
    assert torch.equal(logits, want) and torch.equal(nxt, want.argmax(-1))
    for layer, c in zip(eng.slots.layers, kv):
        for name in ("k", "v"):
            assert torch.equal(layer[name][2, :16], c[name][0])
            assert not layer[name][[0, 1, 3]].any() and not layer[name][2, 16:].any()


def test_engine_goes_without_a_garbage_collection(params):
    """The executables hold their engine weakly: an engine warmed up and
    served goes, with its executables (on the card its CUDA graphs, whose
    NCCL kernels must be gone before a pool's communicators are), when its
    last reference does, with the collector off."""
    import gc
    import weakref

    eng = ServingEngine(CFG, params, ECONF, device="cpu")
    eng.warmup()
    eng.run([Request(0, "strict", np.arange(5, dtype=np.int32), 3)], switch_schedule={1: 2})
    gone = [weakref.ref(eng), weakref.ref(eng.cache), weakref.ref(eng.cache.get(2, "decode"))]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert [r() for r in gone] == [None, None, None]
    finally:
        if collecting:
            gc.enable()
