"""The f64 witness of an f32 flip at a TP split (``testing.multicard.
witness_run``), at reduced dbrx-132b with its published 16 experts, top 4
and 6 query heads a KV head (``multidev_checks.engine_cfg``), on the CPU.

The witness runs the port's own model over one sequence in one process at
TP 1 and TP 4, one period's weights at a time, in the weights' dtype: in
f64 the plain versions of the kernels sum in f64, and the norms, RoPE,
attention, router and head compute in f64 (``layers.wide``). Held: the f64
TP 4 logits within F64_RTOL of the greatest |logit| from the f64 TP 1
logits, every token routed to the same experts in every layer, nothing
dropped, for a sequence whose length TP 4 divides (the MoE's sharded path)
and one it does not (its decode path's psum); the f64 TP 1 logits are
``forward``'s and ``logits_for``'s bit for bit, and the f32 run lies near
them. The control, failing the same hold: a TP 4 split that leaves out one
rank's partial sum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.weight_store import WeightStore  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import forward, logits_for, model_param_defs  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.testing.multicard import WITNESS_TPS, draw_weights, witness_run  # noqa: E402
from repro_torch.testing.multidev_checks import engine_cfg  # noqa: E402

F64_RTOL = 1e-12  # f64 TP 4 against f64 TP 1 (f64 rounding of the split's sums: ~1e-16 of each)
F32_ATOL = 2e-4  # the f32 run against the f64 one (9.1e-5 measured on this CPU; f64 TP 4 vs TP 1: 7.4e-15)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """Reduced dbrx at 16 experts, top 4, capacity factor 8.0, its weights
    drawn in f32 and copied to f64."""
    cfg = engine_cfg("dbrx-132b")
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.num_heads // cfg.num_kv_heads) == (16, 4, 6)
    params = draw_weights(cfg, torch.device("cpu"), torch.float32)
    return cfg, params, tree_map(lambda t: t.double(), params)


def _run(cfg, params, seq):
    shared = {k: v for k, v in params.items() if k != "periods"}
    return witness_run(cfg, shared, lambda p: tree_map(lambda x: x[p:p + 1], params["periods"]), cfg.num_periods, seq)


def _seq(cfg, n):
    return np.random.RandomState(n).randint(0, cfg.vocab_size, size=n)


def _gap(out) -> float:
    l1, l4 = out[1]["logits"], out[4]["logits"]
    return float(np.abs(l4 - l1).max() / np.abs(l1).max())


@pytest.mark.parametrize("n", [45, 48])
def test_f64_tp4_equals_tp1_with_equal_routing(model, n):
    """f64 TP 4 within F64_RTOL of f64 TP 1, the same experts for every
    token in every layer, nothing dropped, f64 logits throughout."""
    cfg, _, p64 = model
    out = _run(cfg, p64, _seq(cfg, n))
    assert WITNESS_TPS == (1, 4)
    assert out[1]["logits"].shape == (n, cfg.vocab_size)
    assert _gap(out) <= F64_RTOL
    assert len(out[1]["routing"]) == cfg.num_layers
    for a, b in zip(out[1]["routing"], out[4]["routing"]):
        assert a.shape == (n, cfg.moe.top_k) and np.array_equal(a, b)
    for t in WITNESS_TPS:
        assert out[t]["dropped"] == 0
        assert all(m.dtype == np.float64 and (m >= 0).all() for m in out[t]["margins"])


def test_f64_tp1_is_forward_and_f32_lies_near(model):
    """The witness at TP 1, a period at a time, is ``forward`` and
    ``logits_for`` of the whole model in f64 bit for bit; the f32 run lies
    within F32_ATOL of it (the f64 evaluation is not rounded to f32
    anywhere)."""
    cfg, p32, p64 = model
    seq = _seq(cfg, 45)
    got = _run(cfg, p64, seq)[1]["logits"]
    store = WeightStore(cfg, model_param_defs(cfg, make_exec_config(cfg, 1)), [torch.device("cpu")], storage_tp=1)
    bound = store.rebind(store.build(p64), 1)
    with torch.no_grad():
        h, _ = forward(bound, cfg, make_exec_config(cfg, 1), tokens=torch.as_tensor(seq).view(1, -1), mode="prefill",
                       block_q=64, block_k=64, pool=1)
        want = logits_for(bound, cfg, h)[0, :, :cfg.vocab_size]
    assert want.dtype == torch.float64
    assert np.array_equal(got, want.numpy())
    f32 = _run(cfg, p32, seq)[1]["logits"]
    gap = float(np.abs(f32 - got).max())
    assert 0 < gap <= F32_ATOL


def test_control_split_leaving_out_a_partial_fails(model, monkeypatch):
    """A TP 4 split whose row-parallel sums leave out the last rank's
    partial lies far past F64_RTOL from TP 1."""
    cfg, _, p64 = model
    plain = layers.reduce_ranks
    monkeypatch.setattr(layers, "reduce_ranks", lambda parts, level, n: plain(parts[:-1] if len(parts) > 1 else parts,
                                                                            level, n))
    assert _gap(_run(cfg, p64, _seq(cfg, 45))) > 1e3 * F64_RTOL

