"""The port's CUDA kernels against their plain versions on the card, and the
engine through them. Marked ``gpu``: each test skips where there is no CUDA
device. This file imports neither JAX nor the reference, so it runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AttnSpec, ModelConfig  # noqa: E402
from repro_torch.core.migration import migrate_pages  # noqa: E402
from repro_torch.core.tp_switch import SwitchAborted  # noqa: E402
from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter  # noqa: E402
from repro_torch.kernels.kv_gather.ref import kv_gather_ref, kv_scatter_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    T_SPLIT, paged_decode_attention_ref, paged_decode_attention_split_ref,
)
from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul  # noqa: E402
from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref  # noqa: E402
from repro_torch.models import init_params, model_param_defs  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedPool  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,m,k,store,n_out,off", [
    ("col", 8, 4096, 14336, 1792, 3 * 1792), ("col", 32, 64, 576, 144, 144),
    ("row", 8, 1792, 14336, 4096, 5 * 1792), ("row", 33, 100, 300, 70, 200),
])
def test_tp_shard_matmul_kernel_matches_plain(cuda, dtype, mode, m, k, store, n_out, off):
    """store: the stored width (col) or the stored rows (row) of the weight."""
    g = torch.Generator(device=cuda).manual_seed(0)
    w_shape = (k, store) if mode == "col" else (store, n_out)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(*w_shape, generator=g, device=cuda).to(dtype)
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
    scale = want.float().abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def test_tp_shard_matmul_kernel_equals_presliced(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(8, 512, generator=g, device=cuda)
    w = torch.randn(512, 1024, generator=g, device=cuda)
    for tp in (1, 2, 4, 8):
        n = 1024 // tp
        for s in range(tp):
            got = tp_shard_matmul(x, w, s * n, n_out=n, mode="col")
            assert torch.equal(got, tp_shard_matmul(x, w[:, s * n:(s + 1) * n].contiguous(), 0, n_out=n, mode="col"))


# bf16 runs on the tensor cores (wgmma), fed by TMA where x and the weight
# are 16-byte aligned and by the producer warp's own loads where not.
# (mode, k, store, n_out, off): the last two of each mode are misaligned
# (a row stride or an offset that is not a multiple of 16 bytes).
_BF16_SHAPES = [
    ("col", 4096, 14336, 1792, 3 * 1792), ("row", 1792, 14336, 4096, 5 * 1792),
    ("col", 96, 210, 70, 70), ("col", 576, 1024, 144, 3),
    ("row", 100, 300, 70, 200), ("row", 1000, 3000, 516, 1000),
]


def _bf16_case(cuda, seed, mode, m, k, store, n_out):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w_shape = (k, store) if mode == "col" else (store, n_out)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(*w_shape, generator=g, device=cuda) / k ** 0.5).to(torch.bfloat16)
    return x, w


@pytest.mark.parametrize("m", [1, 3, 7, 8, 9, 32, 64, 100, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off", _BF16_SHAPES)
def test_tp_shard_matmul_bf16_matches_plain_at_every_m(cuda, m, mode, k, store, n_out, off):
    x, w = _bf16_case(cuda, m, mode, m, k, store, n_out)
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
    scale = want.float().abs().max().item()
    assert got.dtype == torch.bfloat16 and (got.float() - want.float()).abs().max().item() <= 1e-2 * scale
    logits = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode, out_dtype=torch.float32)  # f32 out, not rounded
    want32 = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=torch.float32)
    assert logits.dtype == torch.float32 and (logits - want32).abs().max().item() <= 1e-5 * scale
    assert torch.equal(tp_shard_matmul(x, w, off, n_out=n_out, mode=mode), got)  # a second call, bit for bit


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("mode", ["col", "row"])
def test_tp_shard_matmul_bf16_in_place_equals_presliced(cuda, m, mode):
    """Each rank's shard at TP 1/2/4/8 read in place equals the same call on
    the pre-sliced contiguous weight, bit for bit. The second pass puts the
    storage 2 bytes past a 16-byte boundary: the producer warp's own loads
    in place, against TMA on the (aligned) pre-sliced copy."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(m, 4096, generator=g, device=cuda).to(torch.bfloat16)
    shape = (4096, 4104) if mode == "col" else (4104, 1024)
    buf = torch.randn(shape[0] * shape[1] + 1, generator=g, device=cuda).to(torch.bfloat16)
    for lead in (0, 1):
        store = buf[lead:lead + shape[0] * shape[1]].view(shape)
        assert store.data_ptr() % 16 == 2 * lead
        for tp in (1, 2, 4, 8):
            n = 4096 // tp
            for s in range(tp):
                off = s * n
                if mode == "col":
                    got = tp_shard_matmul(x, store, off, n_out=n, mode="col")
                    want = tp_shard_matmul(x, store[:, off:off + n].contiguous(), 0, n_out=n, mode="col")
                else:
                    xs = x[:, :n].contiguous()
                    got = tp_shard_matmul(xs, store, off, n_out=1024, mode="row")
                    want = tp_shard_matmul(xs, store[off:off + n].contiguous(), 0, n_out=1024, mode="row")
                assert torch.equal(got, want), (lead, tp, s)


@pytest.mark.parametrize("m", [3, 8, 100])
@pytest.mark.parametrize("mode,k,store,n_out,off", _BF16_SHAPES)
def test_tp_shard_matmul_bf16_nan_past_the_shard_stays_out(cuda, m, mode, k, store, n_out, off):
    """Rows around a row-mode shard and columns around a col-mode shard hold
    NaN: the output is finite and equals the plain version."""
    x, w = _bf16_case(cuda, 100 + m, mode, m, k, store, n_out)
    if mode == "col":
        w[:, :off] = w[:, off + n_out:] = float("nan")
    else:
        w[:off] = w[off + k:] = float("nan")
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.float().abs().max().item()


# col_t: the tied head, the embedding's (vocab, d) rows read in place and
# transposed, f32 logits. bf16 feeds wgmma a K-major weight tile (TMA, or
# the producer warp's loads where a base or row stride is not 16-byte
# aligned); f32 the FMA kernels. (m, k, n_store, n_out, off); d = 100 and
# off 75 are misaligned.
_COL_T_SHAPES = [(2304, 4096, 1024, 3 * 1024), (2304, 1024, 1024, 0), (100, 300, 75, 75), (576, 2048, 144, 288)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 64, 128])
@pytest.mark.parametrize("k,n_store,n_out,off", _COL_T_SHAPES)
def test_tp_shard_matmul_col_t_matches_plain(cuda, dtype, m, k, n_store, n_out, off):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(n_store, k, generator=g, device=cuda) / k ** 0.5).to(dtype)
    before = tp_shard_matmul.launches
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode="col_t", out_dtype=torch.float32)
    assert tp_shard_matmul.launches == before + 1 and got.dtype == torch.float32
    want = tp_shard_matmul_ref(x, w, off, mode="col_t", n_out=n_out, out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(tp_shard_matmul(x, w, off, n_out=n_out, mode="col_t", out_dtype=torch.float32), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 128])
def test_tp_shard_matmul_col_t_in_place_equals_presliced(cuda, dtype, m):
    """Each rank's vocab rows at TP 1/2/4 read in place equal the call on the
    pre-sliced rows, bit for bit; again with the storage 2 bytes past a
    16-byte boundary (bf16: the producer warp's loads in place against TMA),
    and NaN in the rows around the shard stays out."""
    g = torch.Generator(device=cuda).manual_seed(13)
    V, d = 8192, 2304
    x = torch.randn(m, d, generator=g, device=cuda).to(dtype)
    buf = (torch.randn(V * d + 1, generator=g, device=cuda) / d ** 0.5).to(dtype)
    for lead in (0, 1):
        store = buf[lead:lead + V * d].view(V, d)
        for tp in (1, 2, 4):
            n = V // tp
            for s in range(tp):
                got = tp_shard_matmul(x, store, s * n, n_out=n, mode="col_t", out_dtype=torch.float32)
                want = tp_shard_matmul(x, store[s * n:(s + 1) * n].contiguous(), 0, n_out=n, mode="col_t",
                                       out_dtype=torch.float32)
                assert torch.equal(got, want), (lead, tp, s)
    w = store.clone()
    w[:1024] = w[2048:] = float("nan")
    got = tp_shard_matmul(x, w, 1024, n_out=1024, mode="col_t", out_dtype=torch.float32)
    want = tp_shard_matmul_ref(x, w, 1024, mode="col_t", n_out=1024, out_dtype=torch.float32)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# f32 at M <= 8 (decode) runs skinny_mm, at M > 8 (prefill) fma_mm: each a
# ring of weight tiles (32 K x 128 columns, or 128 weight rows x 32 K) fed by
# TMA, or by 4-byte cp.async where a base or row stride is not 16-byte
# aligned, split-K added in the same launch. (mode, k, store, n_out, off,
# split): store is the stored width (col), rows (row) or weight rows
# (col_t); K at one stage (32), at stage boundaries (1792, 2304, 4096) and
# between them (99, 100, 1000); N not a multiple of 128 except two; split:
# whether a decode call splits K (S > 1); off 70, 75 and stride 210, 99 put
# the weight off 16-byte alignment.
_F32_DECODE_SHAPES = [
    ("col", 32, 300, 200, 100, False), ("col", 4096, 2000, 1000, 1000, True), ("col", 1000, 210, 70, 70, True),
    ("col", 1000, 34000, 34000, 0, False), ("row", 1792, 14336, 4096, 5 * 1792, True), ("row", 100, 300, 70, 200, False),
    ("col_t", 2304, 4096, 1000, 1024, True), ("col_t", 99, 300, 75, 75, False), ("col_t", 4096, 40000, 34000, 0, False),
]
_F32_SPLIT_SHAPES = [c for c in _F32_DECODE_SHAPES if c[-1]]
# prefill rows: around the 32-, 64- and 128-row tiles, and one row past them.
# The same shapes (at these rows the two 34000-wide ones split K too: S
# evens out the grid's last wave), and two with K = 64, never split, whose
# 266 tiles keep 64-row tiles on 128 threads at M = 64 (tiles of 64 and 128
# rows that split run on 256 threads, narrow shards on tiles of 32 rows).
_F32_PREFILL_M = [9, 16, 31, 32, 33, 64, 100, 127, 128, 129]
_F32_PREFILL_SHAPES = [(*c[:-1], c[-1] or c[3] == 34000) for c in _F32_DECODE_SHAPES] + [
    ("col", 64, 34000, 34000, 0, False), ("col_t", 64, 34000, 34000, 0, False)]


def _f32_case(cuda, seed, mode, m, k, store, n_out):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w_shape = {"col": (k, store), "row": (store, n_out), "col_t": (store, k)}[mode]
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(*w_shape, generator=g, device=cuda) / k ** 0.5
    return x, w


def _f32_call(x, w, off, n_out, mode):
    return tp_shard_matmul(x, w, off, n_out=n_out, mode=mode, out_dtype=torch.float32)


def _splits_k(m, n, k, mode):
    """Whether the call splits K over blocks: it then asks for a workspace."""
    import ctypes

    from repro_torch.kernels.tp_shard_matmul.ops import _lib

    ws, cnt = ctypes.c_longlong(), ctypes.c_longlong()
    _lib().tp_shard_matmul_scratch(m, n, k, 0, int(mode == "col_t"), ctypes.byref(ws), ctypes.byref(cnt))
    return ws.value > 0


def _f32_matches_plain(cuda, m, mode, k, store, n_out, off, split):
    x, w = _f32_case(cuda, 7 * m + k, mode, m, k, store, n_out)
    assert _splits_k(m, n_out, k, mode) == split
    before = tp_shard_matmul.launches
    got = _f32_call(x, w, off, n_out, mode)
    assert tp_shard_matmul.launches == before + 1
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(_f32_call(x, w, off, n_out, mode), got)  # a second call, bit for bit


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_DECODE_SHAPES)
def test_tp_shard_matmul_f32_decode_matches_plain(cuda, m, mode, k, store, n_out, off, split):
    _f32_matches_plain(cuda, m, mode, k, store, n_out, off, split)


@pytest.mark.parametrize("m", _F32_PREFILL_M)
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_PREFILL_SHAPES)
def test_tp_shard_matmul_f32_prefill_matches_plain(cuda, m, mode, k, store, n_out, off, split):
    _f32_matches_plain(cuda, m, mode, k, store, n_out, off, split)


@pytest.mark.parametrize("mode,k,store,n_out,off,split", [
    ("col", 4096, 2000, 1000, 1000, False), ("col", 1000, 210, 70, 70, True),
    ("row", 1792, 14336, 4096, 5 * 1792, False), ("col_t", 2304, 4096, 1000, 1024, False),
])
def test_tp_shard_matmul_f32_prefill_matches_plain_at_4160_rows(cuda, mode, k, store, n_out, off, split):
    """The windowed models' longest bucket: 4160 rows, 32 and a half tiles of
    128 (the last one ragged)."""
    _f32_matches_plain(cuda, 4160, mode, k, store, n_out, off, split)


def _f32_in_place_equals_presliced(cuda, m, mode):
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(m, 4096, generator=g, device=cuda)
    shape = {"col": (4096, 4096), "row": (4096, 1024), "col_t": (8192, 4096)}[mode]
    buf = torch.randn(shape[0] * shape[1] + 1, generator=g, device=cuda) / 64
    for lead in (0, 1):
        store = buf[lead:lead + shape[0] * shape[1]].view(shape)
        assert store.data_ptr() % 16 == 4 * lead
        for tp in (1, 2, 4, 8):
            n = shape[0 if mode != "col" else 1] // tp
            for s in range(tp):
                off = s * n
                if mode == "col":
                    got = _f32_call(x, store, off, n, "col")
                    want = _f32_call(x, store[:, off:off + n].contiguous(), 0, n, "col")
                elif mode == "row":
                    xs = x[:, :n].contiguous()
                    got = _f32_call(xs, store, off, 1024, "row")
                    want = _f32_call(xs, store[off:off + n].contiguous(), 0, 1024, "row")
                else:
                    got = _f32_call(x, store, off, n, "col_t")
                    want = _f32_call(x, store[off:off + n].contiguous(), 0, n, "col_t")
                assert torch.equal(got, want), (lead, tp, s)


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mode", ["col", "row", "col_t"])
def test_tp_shard_matmul_f32_decode_in_place_equals_presliced(cuda, m, mode):
    """Each rank's shard at TP 1/2/4/8 read in place equals the same call on
    the pre-sliced contiguous weight, bit for bit; the second pass puts the
    storage 4 bytes past a 16-byte boundary (cp.async in place, TMA on the
    pre-sliced copy)."""
    _f32_in_place_equals_presliced(cuda, m, mode)


@pytest.mark.parametrize("m", [9, 32, 128])
@pytest.mark.parametrize("mode", ["col", "row", "col_t"])
def test_tp_shard_matmul_f32_prefill_in_place_equals_presliced(cuda, m, mode):
    """As the decode test, at prefill rows (tiles of 32 and 128 rows)."""
    _f32_in_place_equals_presliced(cuda, m, mode)


def _f32_nan_stays_out(cuda, m, mode, k, store, n_out, off):
    x, w = _f32_case(cuda, 200 + m, mode, m, k, store, n_out)
    if mode == "col":
        w[:, :off] = w[:, off + n_out:] = float("nan")
    elif mode == "row":
        w[:off] = w[off + k:] = float("nan")
    else:
        w[:off] = w[off + n_out:] = float("nan")
    got = _f32_call(x, w, off, n_out, mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=torch.float32)
    assert torch.isfinite(got).all() and (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_DECODE_SHAPES[1:3] + _F32_DECODE_SHAPES[4:8])
def test_tp_shard_matmul_f32_decode_nan_past_the_shard_stays_out(cuda, m, mode, k, store, n_out, off, split):
    """NaN in the columns (col), rows (row) or weight rows (col_t) around
    the shard: the output is finite and equals the plain version."""
    _f32_nan_stays_out(cuda, m, mode, k, store, n_out, off)


@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_DECODE_SHAPES[1:3] + _F32_DECODE_SHAPES[4:8])
def test_tp_shard_matmul_f32_prefill_nan_past_the_shard_stays_out(cuda, m, mode, k, store, n_out, off, split):
    _f32_nan_stays_out(cuda, m, mode, k, store, n_out, off)


def _f32_repeats(cuda, m, mode, k, store, n_out, off):
    x, w = _f32_case(cuda, 31, mode, m, k, store, n_out)
    first = _f32_call(x, w, off, n_out, mode)
    for _ in range(50):
        assert torch.equal(_f32_call(x, w, off, n_out, mode), first)


@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_decode_repeats_bit_for_bit(cuda, mode, k, store, n_out, off, split):
    """50 calls at split-K shapes give the same bits: the last block of each
    tile adds the splits in order, whichever block that is."""
    _f32_repeats(cuda, 8, mode, k, store, n_out, off)


@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_prefill_repeats_bit_for_bit(cuda, m, mode, k, store, n_out, off, split):
    _f32_repeats(cuda, m, mode, k, store, n_out, off)


def _kernels_in_one_call(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if (getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)) > 0}


def _f32_one_kernel(cuda, m, mode, k, store, n_out, off, name):
    x, w = _f32_case(cuda, 5, mode, m, k, store, n_out)
    kernels = _kernels_in_one_call(lambda: _f32_call(x, w, off, n_out, mode))
    assert len(kernels) == 1 and sum(kernels.values()) == 1, kernels
    assert name in next(iter(kernels)), kernels


@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_decode_launches_one_kernel(cuda, mode, k, store, n_out, off, split):
    """Under torch.profiler one f32 decode call at a split-K shape launches
    skinny_mm alone: no splitk_reduce."""
    _f32_one_kernel(cuda, 8, mode, k, store, n_out, off, "skinny_mm")


@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_prefill_launches_one_kernel(cuda, m, mode, k, store, n_out, off, split):
    """One f32 prefill call at a split-K shape launches fma_mm alone."""
    _f32_one_kernel(cuda, m, mode, k, store, n_out, off, "fma_mm")


def _f32_graph_equals_eager(cuda, m, mode, k, store, n_out, off):
    x, w = _f32_case(cuda, 9, mode, m, k, store, n_out)
    eager = _f32_call(x, w, off, n_out, mode)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _f32_call(x, w, off, n_out, mode)
    with torch.cuda.graph(graph, stream=stream):
        out = _f32_call(x, w, off, n_out, mode)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_decode_graph_replay_equals_eager(cuda, mode, k, store, n_out, off, split):
    """The call captured in a CUDA graph (scratch grown on the capture stream
    first) replays equal to the eager call, bit for bit, replay after replay:
    the arrival counters end each launch at zero."""
    _f32_graph_equals_eager(cuda, 8, mode, k, store, n_out, off)


@pytest.mark.parametrize("m", [32, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off,split", _F32_SPLIT_SHAPES)
def test_tp_shard_matmul_f32_prefill_graph_replay_equals_eager(cuda, m, mode, k, store, n_out, off, split):
    _f32_graph_equals_eager(cuda, m, mode, k, store, n_out, off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 64])
@pytest.mark.parametrize("hd", [80, 256])
@pytest.mark.parametrize("draw", range(4))
def test_paged_split_kernel_new_head_dims_at_split_boundaries(cuda, dtype, hd, G, draw):
    """hd 80 (a row is 10 or 20 16-byte vectors: not a power of two) and 256
    (f32: one ring slot), at the lengths where a split begins or ends, and
    with gemma2's attention softcap; four draws of the inputs."""
    n_pages = 3 * T_SPLIT // 16
    lens = [1, T_SPLIT - 1, T_SPLIT, T_SPLIT + 1, 2 * T_SPLIT, 2 * T_SPLIT + 1, 3 * T_SPLIT - 1, 3 * T_SPLIT]
    args = _paged_case(cuda, dtype, lens, 2, G, hd, 16, n_pages, seed=hd + G + 1000 * draw)
    f32 = dtype == torch.float32
    for cap in (None, 50.0):
        before = paged_decode_attention.launches
        got = paged_decode_attention(*args, softcap=cap)
        assert paged_decode_attention.launches == before + 1 and got.dtype == dtype
        _assert_paged_close(got, paged_decode_attention_split_ref(*args, softcap=cap), _TOL_SPLIT_F32 if f32 else None)
        _assert_paged_close(got, paged_decode_attention_ref(*args, softcap=cap), _TOL_DENSE_F32 if f32 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd,cap", [(8, 4, 80, None), (4, 2, 256, 50.0)], ids=["danube", "gemma2"])
def test_paged_split_kernel_full_window_rows(cuda, dtype, KV, G, hd, cap):
    """8 slots of a 4096-token window buffer, every row full (seq_len = Sc,
    the wrapped case) but one: more splits than a wave holds, so blocks walk
    several through the ring (one slot at f32 hd 256). Batch invariant:
    a row alone equals it in the batch, bit for bit."""
    lens = [4096, 4096, 4096, 4096, 4096, 4096, 4096, 4000]
    q, kp, vp, tables, lens_t = _paged_case(cuda, dtype, lens, KV, G, hd, 16, 256, seed=hd)
    got = paged_decode_attention(q, kp, vp, tables, lens_t, softcap=cap)
    f32 = dtype == torch.float32
    _assert_paged_close(got, paged_decode_attention_split_ref(q, kp, vp, tables, lens_t, softcap=cap),
                        _TOL_SPLIT_F32 if f32 else None)
    _assert_paged_close(got, paged_decode_attention_ref(q, kp, vp, tables, lens_t, softcap=cap),
                        _TOL_DENSE_F32 if f32 else None)
    alone = paged_decode_attention(q[7:].contiguous(), kp, vp, tables[7:].contiguous(), lens_t[7:].contiguous(),
                                   softcap=cap)
    assert torch.equal(alone[0], got[7])


@pytest.mark.parametrize("name", ["gemma2-2b", "h2o-danube-1.8b"])
def test_windowed_engine_on_card_matches_cpu(cuda, name):
    """Reduced gemma2 / danube (window 16): prompts shorter and longer than
    the window and than their bucket, the buffer wrapping in decode, TP
    switches; the card's trajectories equal the CPU plain path's."""
    cfg = reduced(get_config(name))
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(0))
    econf = EngineConfig(candidate_tps=(1, 2), n_slots=4, max_len=64, prefill_buckets=(8, 16, 32))

    def requests():
        rng = np.random.RandomState(0)
        return [Request(i, "strict", rng.randint(0, cfg.vocab_size, size=n).astype(np.int32), 24)
                for i, n in enumerate([5, 20, 32, 10, 16, 17, 3, 29, 8, 24])]

    base = {r.req_id: r.generated for r in ServingEngine(cfg, params, econf, device="cpu").run(requests())}
    before = (tp_shard_matmul.launches, paged_decode_attention.launches)
    done = ServingEngine(cfg, params, econf, device=cuda).run(requests(), switch_schedule={3: 2, 7: 1, 13: 2})
    assert {r.req_id: r.generated for r in done} == base
    assert tp_shard_matmul.launches > before[0] and paged_decode_attention.launches > before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,page,n_pages,cap", [
    (2, 2, 4, 32, 8, 4, None), (1, 1, 8, 64, 16, 2, None), (4, 4, 1, 16, 4, 8, None),
    (8, 8, 4, 128, 16, 16, None), (2, 2, 2, 16, 8, 2, 20.0),
])
def test_paged_decode_attention_kernel_matches_plain(cuda, dtype, B, KV, G, hd, page, n_pages, cap):
    rng = np.random.RandomState(B * 31 + n_pages)
    P = B * n_pages + 2
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(B, KV, G, hd, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=g, device=cuda).to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=g, device=cuda).to(dtype)
    tables = torch.from_numpy(rng.permutation(P)[: B * n_pages].reshape(B, n_pages).astype(np.int32)).to(cuda)
    lens = torch.from_numpy(rng.randint(1, page * n_pages + 1, size=(B,)).astype(np.int32)).to(cuda)
    got = paged_decode_attention(q, kp, vp, tables, lens, softcap=cap)
    want = paged_decode_attention_ref(q, kp, vp, tables, lens, softcap=cap)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# The split-KV kernel: splits of T_SPLIT tokens merged by log-sum-exp in
# the same launch. f32 is held to the plain split version (the kernel's own
# arithmetic) at 5e-6 and to the dense plain version at 2e-5; bf16 to both at
# 1e-3 + 8e-3 x |plain| (both sum in f32 and round once to bf16).
_TOL_SPLIT_F32, _TOL_DENSE_F32 = 5e-6, 2e-5


def _assert_paged_close(got, want, tol_f32):
    got, want = got.float(), want.float()
    if tol_f32 is None:  # bf16
        assert ((got - want).abs() - 8e-3 * want.abs()).max().item() <= 1e-3
    else:
        torch.testing.assert_close(got, want, rtol=tol_f32, atol=tol_f32)


def _paged_case(cuda, dtype, lens, KV, G, hd, page, n_pages, seed):
    """B = len(lens) rows over a permuted block table of n_pages pages each."""
    B = len(lens)
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = B * n_pages + 3
    q = torch.randn(B, KV, G, hd, generator=g, device=cuda).to(dtype)
    kp = torch.randn(P, page, KV, hd, generator=g, device=cuda).to(dtype)
    vp = torch.randn(P, page, KV, hd, generator=g, device=cuda).to(dtype)
    perm = np.random.RandomState(seed).permutation(P)[: B * n_pages]
    tables = torch.from_numpy(perm.reshape(B, n_pages).astype(np.int32)).to(cuda)
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 8, 64])
@pytest.mark.parametrize("page", [4, 8, 16])
def test_paged_split_kernel_at_split_boundaries(cuda, dtype, page, G, hd):
    """One row at each length where a split begins or ends, the table's last
    token among them (3 T_SPLIT tokens in the table)."""
    n_pages = 3 * T_SPLIT // page
    lens = [1, T_SPLIT - 1, T_SPLIT, T_SPLIT + 1, 2 * T_SPLIT, 2 * T_SPLIT + 1, 3 * T_SPLIT - 1, 3 * T_SPLIT]
    args = _paged_case(cuda, dtype, lens, 2, G, hd, page, n_pages, seed=page * G + hd)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before + 1 and got.dtype == dtype
    f32 = dtype == torch.float32
    _assert_paged_close(got, paged_decode_attention_split_ref(*args), _TOL_SPLIT_F32 if f32 else None)
    _assert_paged_close(got, paged_decode_attention_ref(*args), _TOL_DENSE_F32 if f32 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_kernel_4096_token_sequence(cuda, dtype):
    """8 KV heads over a 4096-token table: enough splits that a block walks
    several of them through its ring."""
    args = _paged_case(cuda, dtype, [4096, 4001, 1], 8, 4, 128, 16, 256, seed=3)
    got = paged_decode_attention(*args)
    f32 = dtype == torch.float32
    _assert_paged_close(got, paged_decode_attention_split_ref(*args), _TOL_SPLIT_F32 if f32 else None)
    _assert_paged_close(got, paged_decode_attention_ref(*args), _TOL_DENSE_F32 if f32 else None)


def _poison_past_seq_len(pages, tables, lens):
    """A copy of pages with NaN at every position past seq_len that the
    table names: whole pages and the last page's tail."""
    page = pages.shape[1]
    pos = torch.arange(tables.shape[1] * page, device=pages.device).view(1, -1, page)
    dead = pos >= lens.long().view(-1, 1, 1)
    slots = tables.long()[:, :, None] * page + torch.arange(page, device=pages.device)
    out = pages.clone()
    out.view(-1, *pages.shape[2:])[slots[dead]] = float("nan")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("B,KV,n_tokens", [(5, 2, 3 * T_SPLIT), (8, 8, 1024)])
def test_paged_split_kernel_never_reads_past_seq_len(cuda, dtype, page, B, KV, n_tokens):
    """NaN in every page named past seq_len and in the last page's tail: the
    output is finite, equals the plain split version, and equals the kernel
    over the clean pages bit for bit (the wider case walks several splits
    per block)."""
    lens = [1, 5, T_SPLIT, T_SPLIT + 3, 2 * T_SPLIT + 7, n_tokens, n_tokens - 1, 300][:B]
    q, kp, vp, tables, lens_t = _paged_case(cuda, dtype, lens, KV, 4, 64, page, n_tokens // page, seed=17)
    clean = paged_decode_attention(q, kp, vp, tables, lens_t)
    kn, vn = _poison_past_seq_len(kp, tables, lens_t), _poison_past_seq_len(vp, tables, lens_t)
    assert torch.isnan(kn).any() and torch.isnan(vn).any()
    got = paged_decode_attention(q, kn, vn, tables, lens_t)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    want = paged_decode_attention_split_ref(q, kn, vn, tables, lens_t)
    _assert_paged_close(got, want, _TOL_SPLIT_F32 if dtype == torch.float32 else None)


@pytest.mark.parametrize("dtype,G,hd", [
    (torch.bfloat16, 4, 128), (torch.float32, 4, 128), (torch.bfloat16, 1, 16), (torch.bfloat16, 64, 64),
    (torch.float32, 8, 32),
])
def test_paged_split_kernel_batch_invariant_and_repeatable(cuda, dtype, G, hd):
    """A row computed alone equals the same row in a batch of 8, bit for bit:
    split boundaries depend on the position alone, and alone a block takes
    one split where in the batch it walks several through its ring. A wider
    table over the same tokens, and the same call twice, give equal results."""
    lens = [2000, 1, 64, 65, 129, 37, 2048, 700]
    q, kp, vp, tables, lens_t = _paged_case(cuda, dtype, lens, 8, G, hd, 16, 128, seed=23)
    batch = paged_decode_attention(q, kp, vp, tables, lens_t)
    assert torch.equal(paged_decode_attention(q, kp, vp, tables, lens_t), batch)
    for b in range(8):
        alone = paged_decode_attention(q[b:b + 1].contiguous(), kp, vp, tables[b:b + 1].contiguous(),
                                       lens_t[b:b + 1].contiguous())
        assert torch.equal(alone[0], batch[b]), b
    wide = torch.cat([tables, tables], dim=1)
    assert torch.equal(paged_decode_attention(q, kp, vp, wide, lens_t), batch)
    f32 = dtype == torch.float32
    _assert_paged_close(batch, paged_decode_attention_split_ref(q, kp, vp, tables, lens_t),
                        _TOL_SPLIT_F32 if f32 else None)


def test_engine_on_card_matches_cpu_and_launches_kernels(cuda):
    cfg = ModelConfig(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8,
                      num_kv_heads=8, head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(0))
    econf = EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32))

    def requests():
        rng = np.random.RandomState(0)
        return [Request(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24)
                for i in range(10)]

    base = {r.req_id: r.generated for r in ServingEngine(cfg, params, econf, device="cpu").run(requests())}
    before = (tp_shard_matmul.launches, paged_decode_attention.launches)
    eng = ServingEngine(cfg, params, econf, device=cuda)
    done = eng.run(requests(), switch_schedule={3: 2, 7: 4, 13: 1, 19: 2})
    assert {r.req_id: r.generated for r in done} == base
    assert tp_shard_matmul.launches > before[0] and paged_decode_attention.launches > before[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("P,F,n", [(16, 128, 4), (64, 256, 64), (8, 512, 1), (512, 16384, 300), (16, 129, 7)])
def test_kv_gather_scatter_kernels_equal_plain(cuda, dtype, P, F, n):
    """Bit for bit against the plain versions; F = 129 in uint8 (odd rows)
    takes the byte path, the rest the 16-byte path."""
    g = torch.Generator(device=cuda).manual_seed(P + F)
    pool = torch.randint(0, 255, (P, F), generator=g, device=cuda, dtype=torch.uint8)
    if dtype != torch.uint8:
        pool = torch.randn(P, F, generator=g, device=cuda).to(dtype)
    ids = np.random.RandomState(n).permutation(P)[:n]
    before = (kv_gather.launches, kv_scatter.launches)
    staged = kv_gather(pool, ids)
    assert torch.equal(staged, kv_gather_ref(pool, ids))
    other = staged.flip(0).contiguous()
    want = kv_scatter_ref(pool.clone(), other, ids)
    ptr = pool.data_ptr()
    assert kv_scatter(pool, other, ids) is pool and pool.data_ptr() == ptr
    assert torch.equal(pool, want)  # named rows written, the rest untouched
    kv_scatter(pool, staged, ids)
    assert torch.equal(kv_gather(pool, ids), staged)
    torch.cuda.synchronize()
    assert (kv_gather.launches - before[0], kv_scatter.launches - before[1]) == (2, 2)


def test_kv_gather_scatter_misaligned_base(cuda):
    """A pool that starts 2 bytes past a 16-byte boundary takes the byte path."""
    buf = torch.randn(33 * 256 + 1, device=cuda).to(torch.bfloat16)
    pool = buf[1:].view(33, 256)
    assert pool.data_ptr() % 16 == 2
    head = buf[0].clone()
    ids = np.random.RandomState(0).permutation(33)[:9]
    staged = kv_gather(pool, ids)
    assert torch.equal(staged, kv_gather_ref(pool, ids))
    want = kv_scatter_ref(pool.clone(), staged * 2, ids)
    kv_scatter(pool, staged * 2, ids)
    assert torch.equal(pool, want) and torch.equal(buf[0], head)


def test_migrate_pages_on_card_keeps_attention_bitwise(cuda):
    """llama3-8b's page geometry, 4 layers: dst pages equal src pages and
    decode attention over dst equals attention over src, bit for bit."""
    geom = dict(num_pages=160, page_size=16, kv_heads=8, head_dim=128, n_layers=4, dtype=torch.bfloat16)
    src, dst = PagedPool(**geom, device=cuda), PagedPool(**geom, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    src.k_pages.normal_(generator=g)
    src.v_pages.normal_(generator=g)
    lens = [100, 37, 256, 1, 64, 200, 17, 129]
    for s in range(8):
        src.alloc_seq(s, 1)
    for _ in range(256):
        for s, n in enumerate(lens):
            if src.seq_lens[s] < n:
                src.extend_seq(s, 1)
    before = (kv_gather.launches, kv_scatter.launches)
    tables, _ = migrate_pages(src, dst, list(range(8)))
    assert (kv_gather.launches - before[0], kv_scatter.launches - before[1]) == (2, 2)
    for s in range(8):
        assert torch.equal(dst.k_pages[:, dst.tables[s]], src.k_pages[:, src.tables[s]])
        assert torch.equal(dst.v_pages[:, dst.tables[s]], src.v_pages[:, src.tables[s]])
    q = torch.randn(8, 8, 4, 128, generator=g, device=cuda).to(torch.bfloat16)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    t_dst = torch.from_numpy(tables).to(cuda)
    t_src = torch.from_numpy(src.block_table_array(list(range(8)))).to(cuda)
    for layer in range(4):
        a = paged_decode_attention(q, dst.k_pages[layer], dst.v_pages[layer], t_dst, lens_t)
        b = paged_decode_attention(q, src.k_pages[layer], src.v_pages[layer], t_src, lens_t)
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,KV,G,hd,cap,lens", [
    (torch.float32, 8, 4, 80, None, [4096] * 7 + [4000]), (torch.float32, 4, 2, 256, 50.0, [4096] * 7 + [4000]),
    (torch.float32, 2, 4, 80, 50.0, [1, 63, 64, 65, 128, 129, 191, 192]),
    (torch.float32, 2, 64, 256, None, [1, 63, 64, 65, 128, 129, 191, 192]),
], ids=["danube_full", "gemma2_full", "hd80_boundaries", "hd256_boundaries"])
def test_paged_split_kernel_repeats_bit_for_bit(cuda, dtype, KV, G, hd, cap, lens):
    """50 calls on the same inputs give the same bits (a race would show as
    calls that differ), and they equal the plain split version within its
    5e-6."""
    n_pages = -(-max(lens) // 16)
    args = _paged_case(cuda, dtype, lens, KV, G, hd, 16, n_pages, seed=hd + G)
    first = paged_decode_attention(*args, softcap=cap)
    for _ in range(49):
        assert torch.equal(paged_decode_attention(*args, softcap=cap), first)
    _assert_paged_close(first, paged_decode_attention_split_ref(*args, softcap=cap), _TOL_SPLIT_F32)


# ---------------------------------------------------------------------------
# The engine's CUDA graphs, one per (TP level, stage, bucket), against the
# eager step functions they capture: full width, 2 layers (gemma2-2b: one
# local, one global; moonshot-v1-16b-a3b: MoE at its published capacity
# factor, so prefill may drop), f32
# ---------------------------------------------------------------------------
_GRAPH_TPS = {"llama3-8b": (1, 2, 4, 8), "gemma2-2b": (1, 2, 4), "h2o-danube-1.8b": (1, 2, 4, 8),
              "moonshot-v1-16b-a3b": (1, 2, 4, 8)}
_GRAPH_ENGINES = {}


@pytest.fixture
def graph_engine(cuda):
    def get(name):
        if name not in _GRAPH_ENGINES:
            _GRAPH_ENGINES.clear()
            cfg = dataclasses.replace(get_config(name), num_layers=2)
            params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)),
                                 torch.Generator(device=cuda).manual_seed(0))
            windowed = cfg.attn.window is not None
            econf = EngineConfig(candidate_tps=_GRAPH_TPS[name], n_slots=8, max_len=4224 if windowed else 256,
                                 prefill_buckets=(32, 128, 4160) if windowed else (32, 64, 128))
            eng = ServingEngine(cfg, params, econf, device=cuda)
            eng.warmup()
            _GRAPH_ENGINES[name] = (cfg, eng)
        return _GRAPH_ENGINES[name]

    yield get
    torch.cuda.synchronize()


def _replay_against_eager(eng, eager, exe, host_args):
    """Run ``eager`` on the device copies of host_args and ``exe`` (a
    replay) on host_args, each from the same KV cache: their outputs, the
    caches they leave, and the launches of each kernel each added."""
    layers = eng.slots.layers
    start = [{k: t.clone() for k, t in c.items()} for c in layers]
    runs = []
    for fn, args in ((eager, [a.to(eng.device) for a in host_args]), (exe, host_args)):
        for c, s0 in zip(layers, start):
            for k in c:
                c[k].copy_(s0[k])
        before = (tp_shard_matmul.launches, paged_decode_attention.launches)
        out = [t.clone() for t in fn(*args)]
        torch.cuda.synchronize()
        runs.append((out, [{k: t.clone() for k, t in c.items()} for c in layers],
                     (tp_shard_matmul.launches - before[0], paged_decode_attention.launches - before[1])))
    return runs


def _same_caches(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize("name,tp", [(n, tp) for n, tps in _GRAPH_TPS.items() for tp in tps])
def test_graph_replays_equal_the_eager_steps(graph_engine, name, tp):
    """At each TP level: the decode graph's replay equals the eager
    ``_decode`` bit for bit (next tokens, f32 logits, the K/V it writes),
    with the windowed models' slots past their 4096-token window (the
    rotating buffer wrapped); the prefill graph of every bucket equals the
    eager ``_prefill`` (next token, logits, the K/V inserted into the slot)
    for a prompt shorter than its bucket. Each replay adds the launches of
    the eager call to the kernels' counts."""
    cfg, eng = graph_engine(name)
    eng.switch_tp(tp)
    params = eng.ctl.bindings[tp]
    g = torch.Generator(device=eng.device).manual_seed(tp)
    for c in eng.slots.layers:
        for t in c.values():
            t.normal_(generator=g)
    rng = np.random.RandomState(tp)
    n, max_len = eng.econf.n_slots, eng.econf.max_len
    pos = [max_len - 1, 4100, 4095, 17, 0, 4096, 300, 64] if max_len > 4096 else [255, 0, 17, 64, 100, 128, 200, 3]
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(n, 1)))
    (want, want_cache, want_n), (got, got_cache, got_n) = _replay_against_eager(
        eng, lambda t, p: eng._decode(params, t, p), eng.cache.get(tp, "decode"), (tokens, torch.tensor(pos)))
    assert all(torch.equal(a, b) for a, b in zip(want, got)), "decode: replay != eager"
    assert _same_caches(want_cache, got_cache) and got_n == want_n and got_n[1] == cfg.num_layers
    for L in eng.econf.prefill_buckets:
        prompt = torch.zeros((1, L), dtype=torch.int64)
        prompt[0, : L - 3] = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=L - 3))
        args = (prompt, torch.tensor([L - 4]), torch.tensor([(tp + L) % n]))
        (want, want_cache, want_n), (got, got_cache, got_n) = _replay_against_eager(
            eng, lambda *a: eng._prefill(params, *a), eng.cache.get(tp, L), args)
        assert all(torch.equal(a, b) for a, b in zip(want, got)), f"prefill {L}: replay != eager"
        assert _same_caches(want_cache, got_cache) and got_n == want_n and got_n[0] > 0, L


def test_graph_capture_refuses_to_allocate_scratch(cuda):
    """A call captured on a stream that has no scratch yet raises instead of
    allocating a workspace inside the graph."""
    x = torch.randn(8, 4096, device=cuda).to(torch.bfloat16)
    w = torch.randn(4096, 1024, device=cuda).to(torch.bfloat16)
    tp_shard_matmul(x, w, 0, n_out=1024)  # built, and scratch for the default stream
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="before a CUDA graph capture"):
        with torch.cuda.graph(graph, stream=stream):
            tp_shard_matmul(x, w, 0, n_out=1024)


def test_switch_refuses_a_cache_moved_under_graphs(cuda, monkeypatch):
    """A migration that hands back new KV storage while graphs read the old
    one rolls the switch back."""
    import repro_torch.serving.engine as engine_mod

    cfg = ModelConfig(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8,
                      num_kv_heads=8, head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2), n_slots=4, max_len=64, prefill_buckets=(16,)),
                        device=cuda)
    eng.warmup()
    assert eng.cache.graphs() == 4 and eng.cache.tps() == [1, 2]
    eng.switch_tp(2)  # the cache stays where it is
    monkeypatch.setattr(engine_mod, "migrate_cache",
                        lambda cache, device: ([{k: t.clone() for k, t in c.items()} for c in cache], 0.0))
    with pytest.raises(SwitchAborted):
        eng.switch_tp(1)
    assert eng.tp == 2


# ---------------------------------------------------------------------------
# MoE (models/moe.py) on the card: deterministic (no atomics), and equal to
# the same layer on the CPU
# ---------------------------------------------------------------------------
def _bound_moe(cfg, params, tp, device, pool):
    """One MoE layer's params bound at TP ``tp`` in a pool of ``pool`` ranks on ``device``."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models.moe import moe_param_defs
    from repro_torch.models.params import tree_map

    store = WeightStore(cfg, {"ffn": moe_param_defs(cfg)}, [device] * pool)
    return store.rebind(store.build(tree_map(lambda t: t.to(device), params)), tp)["ffn"]


def _moe_params(cfg, device, dtype=torch.float32, seed=0):
    from repro_torch.models.moe import moe_param_defs

    return init_params({"ffn": moe_param_defs(cfg)}, torch.Generator(device=device).manual_seed(seed), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [1, 2, 8])
@pytest.mark.parametrize("B,S", [(8, 1), (1, 128)], ids=["decode", "prefill"])
def test_moe_layer_repeats_bit_for_bit(cuda, B, S, tp, dtype):
    """moonshot-v1-16b-a3b's MoE layer at full width (64 experts, top 6), at
    its published capacity factor, in a pool of 8 at TP 1, 2 and 8 (local,
    decode and sharded paths): 50 calls give the same bits, and the drop
    count is the same each call."""
    from repro_torch.models.moe import moe_apply

    cfg = get_config("moonshot-v1-16b-a3b")
    p = _bound_moe(cfg, _moe_params(cfg, cuda, dtype), tp, cuda, 8)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda).to(dtype)
    drops = torch.zeros(1, dtype=torch.int64, device=cuda)
    first, _ = moe_apply(p, x, cfg, 8, drops=drops)
    n0 = int(drops)
    for _ in range(49):
        y, _ = moe_apply(p, x, cfg, 8, drops=drops)
        assert torch.equal(y, first)
    assert int(drops) == 50 * n0 and bool(torch.isfinite(first.float()).all())


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("B,S", [(8, 1), (16, 1), (1, 32), (1, 6)], ids=["decode", "decode16", "prefill", "prefill6"])
def test_moe_layer_on_card_matches_cpu(cuda, B, S, tp):
    """A narrow MoE layer with a shared expert (d 256, 16 experts, top 4,
    capacity factor 1.25: drops happen) in a pool of 4, f32, on the card
    against the same weights and input on the CPU (plain versions): within
    1e-5 of the output's scale, the same dropped assignments, the same aux
    losses within 1e-5."""
    from repro_torch.models.moe import moe_apply

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), d_model=256)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=16, top_k=4, d_ff_expert=128,
                                                           num_shared_experts=1))
    cpu = torch.device("cpu")
    params = _moe_params(cfg, cpu)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(tp + B + S))
    d_gpu, d_cpu = torch.zeros(1, dtype=torch.int64, device=cuda), torch.zeros(1, dtype=torch.int64)
    got, aux = moe_apply(_bound_moe(cfg, params, tp, cuda, 4), x.to(cuda), cfg, 4, drops=d_gpu)
    want, aux_cpu = moe_apply(_bound_moe(cfg, params, tp, cpu, 4), x, cfg, 4, drops=d_cpu)
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert int(d_gpu) == int(d_cpu)
    for k in ("lb", "z"):
        assert abs(float(aux[k]) - float(aux_cpu[k])) <= 1e-5 * abs(float(aux_cpu[k]))


# ---------------------------------------------------------------------------
# the new models' kernel instances against their plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,hd", [(32, 1, 64), (16, 1, 128), (8, 7, 128), (8, 12, 128), (8, 6, 128)],
                         ids=["musicgen", "moonshot", "yi-34b", "mistral-large", "dbrx"])
def test_paged_split_kernel_new_model_geometries(cuda, dtype, KV, G, hd):
    """The engine's decode attention of each new model (the cache keeps TP
    8's KV heads): rows at each split boundary of a 256-token table."""
    n_pages = 256 // 16
    lens = [1, T_SPLIT - 1, T_SPLIT, T_SPLIT + 1, 2 * T_SPLIT, 2 * T_SPLIT + 1, 3 * T_SPLIT - 1, 256]
    args = _paged_case(cuda, dtype, lens, KV, G, hd, 16, n_pages, seed=KV * G + hd)
    got = paged_decode_attention(*args)
    f32 = dtype == torch.float32
    _assert_paged_close(got, paged_decode_attention_split_ref(*args), _TOL_SPLIT_F32 if f32 else None)
    _assert_paged_close(got, paged_decode_attention_ref(*args), _TOL_DENSE_F32 if f32 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off", [
    ("col", 7168, 20480, 2560, 3 * 2560), ("row", 2560, 20480, 7168, 5 * 2560),  # yi-34b w_gate / w_out, TP 8
    ("col", 12288, 28672, 28672, 0), ("row", 3584, 28672, 12288, 7 * 3584),  # mistral-large w_gate TP 1, w_out TP 8
    ("col", 2048, 163840, 20480, 20480),  # moonshot's head, rank 1 at TP 8
    ("col", 2048, 2048, 256, 6 * 256),  # musicgen's 2048-entry head, rank 6 at TP 8
])
def test_tp_shard_matmul_new_model_shapes(cuda, dtype, m, mode, k, store, n_out, off):
    """The projections of the new models at a rank's offset, against the
    plain version; f32 heads take f32 outputs as the engine's do."""
    g = torch.Generator(device=cuda).manual_seed(k + n_out)
    w_shape = (k, store) if mode == "col" else (store, n_out)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(*w_shape, generator=g, device=cuda) / k ** 0.5).to(dtype)
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


# ---------------------------------------------------------------------------
# the Mamba family (models/mamba.py) on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 128])
@pytest.mark.parametrize("mode,k,store,n_out,off", [
    ("col", 2560, 5120, 5120, 0), ("col", 2560, 5120, 640, 640),  # mamba2 w_z / w_x: TP 1, rank 1 at TP 8
    ("col", 2560, 80, 80, 0), ("col", 2560, 80, 10, 10), ("col", 2560, 80, 10, 30),  # w_dt: 10 columns at TP 8
    ("col", 2560, 256, 256, 0),  # w_BC (replicated)
    ("row", 640, 5120, 2560, 640),  # mamba2 w_out, rank 1 at TP 8
    ("col", 4096, 8192, 1024, 3 * 1024),  # jamba w_x / w_z, rank 3 at TP 8
    ("row", 8192, 8192, 256, 0), ("row", 1024, 8192, 256, 5 * 1024),  # w_dtr: TP 1, rank 5 at TP 8
    ("row", 8192, 8192, 16, 0), ("row", 1024, 8192, 16, 1024),  # w_B / w_C: N = 16
    ("col", 256, 8192, 8192, 0), ("col", 256, 8192, 1024, 7 * 1024),  # dt_proj: K = 256
    ("row", 1024, 8192, 4096, 2 * 1024),  # jamba w_out, rank 2 at TP 8
])
def test_tp_shard_matmul_mamba_shapes(cuda, dtype, m, mode, k, store, n_out, off):
    """mamba2-2.7b's and jamba's projections at a rank's offset, against the
    plain version: narrow N (10, 16), short K (256) and w_dt's shards at
    20- and 60-byte offsets in bf16 (not 16-byte aligned: the producer
    warp's own loads)."""
    g = torch.Generator(device=cuda).manual_seed(k + n_out + off)
    w_shape = (k, store) if mode == "col" else (store, n_out)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(*w_shape, generator=g, device=cuda) / k ** 0.5).to(dtype)
    got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
    want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mamba2_forward_on_card_matches_cpu(cuda, tp):
    """Reduced mamba2-2.7b, f32: prefill of 40 tokens (chunks of 16: one
    chunk, S % chunk != 0) and of 32 (two chunks), then 3 decode steps over
    the state cache, on the card at TP ``tp`` against the CPU's plain path:
    hidden states and caches within 1e-4 of their scale."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models import forward
    from repro_torch.models.params import tree_map

    cfg = reduced(get_config("mamba2-2.7b"))
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    params = init_params(defs, torch.Generator().manual_seed(0))
    ec = make_exec_config(cfg, tp)
    tokens = torch.from_numpy(np.random.RandomState(tp).randint(0, cfg.vocab_size, size=(2, 43)))

    def close(a, b):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())

    before = tp_shard_matmul.launches
    for S in (40, 32):
        runs = []
        for dev in (cuda, torch.device("cpu")):
            store = WeightStore(cfg, defs, [dev] * 4)
            bound = store.rebind(store.build(tree_map(lambda t: t.to(dev), params)), tp)
            h, cache = forward(bound, cfg, ec, tokens=tokens[:, :S].to(dev), mode="prefill")
            hs = [h]
            for s in range(3):
                h, _ = forward(bound, cfg, ec, tokens=tokens[:, S + s:S + s + 1].to(dev),
                               positions=torch.full((2,), S + s, device=dev), cache=cache, mode="decode")
                hs.append(h)
            runs.append((hs, cache))
        (g_hs, g_cache), (c_hs, c_cache) = runs
        for a, b in zip(g_hs, c_hs):
            close(a, b)
        for a, b in zip(g_cache, c_cache):
            for k in b:
                close(a[k], b[k])
    assert tp_shard_matmul.launches > before


def test_jamba_graph_replays_equal_the_eager_steps(cuda):
    """Reduced jamba-v0.1-52b (4 KV heads; mamba1, attention and MoE layers)
    served in f32 at TP 1/2/4: at each TP level the decode graph's replay
    and every bucket's prefill graph (a prompt shorter than its bucket)
    equal the eager step bit for bit: next tokens, logits, the K/V and each
    Mamba layer's state and conv window they leave in the cache."""
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")), num_kv_heads=4)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=256,
                                                  prefill_buckets=(32, 64, 128)), device=cuda)
    eng.warmup()
    assert {k for c in eng.slots.layers for k in c} == {"k", "v", "h", "conv"}
    for tp in (1, 2, 4):
        eng.switch_tp(tp)
        params_tp = eng.ctl.bindings[tp]
        g = torch.Generator(device=cuda).manual_seed(tp)
        for c in eng.slots.layers:
            for t in c.values():
                t.normal_(generator=g)
        rng = np.random.RandomState(tp)
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(8, 1)))
        pos = torch.tensor([255, 0, 17, 64, 100, 128, 200, 3])
        (want, want_cache, want_n), (got, got_cache, got_n) = _replay_against_eager(
            eng, lambda t, p: eng._decode(params_tp, t, p), eng.cache.get(tp, "decode"), (tokens, pos))
        assert all(torch.equal(a, b) for a, b in zip(want, got)), f"TP {tp} decode: replay != eager"
        assert _same_caches(want_cache, got_cache) and got_n == want_n and got_n[1] == cfg.n_attn_layers
        for L in eng.econf.prefill_buckets:
            prompt = torch.zeros((1, L), dtype=torch.int64)
            prompt[0, : L - 3] = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=L - 3))
            args = (prompt, torch.tensor([L - 4]), torch.tensor([(tp + L) % 8]))
            (want, want_cache, want_n), (got, got_cache, got_n) = _replay_against_eager(
                eng, lambda *a: eng._prefill(params_tp, *a), eng.cache.get(tp, L), args)
            assert all(torch.equal(a, b) for a, b in zip(want, got)), f"TP {tp} prefill {L}: replay != eager"
            assert _same_caches(want_cache, got_cache) and got_n == want_n and got_n[0] > 0, L
    torch.cuda.synchronize()


def test_profile_engine_on_card_replays_graphs(cuda, tmp_path):
    """profile_engine on llama3-8b at full width, 2 layers, bf16, TP
    1/2/4/8: every tp_shard_matmul and paged_decode_attention launch of the
    profile comes from a graph replay, the table has the reference's keys
    with positive times, the engine stays at its TP level, and the table
    round-trips through its JSON."""
    from repro_torch.profiles.profiler import ProfileTable, profile_engine

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=cuda).manual_seed(0),
                         torch.bfloat16)
    econf = EngineConfig(candidate_tps=(1, 2, 4, 8), n_slots=8, max_len=256, prefill_buckets=(32, 64, 128),
                         dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, econf, device=cuda)
    eng.warmup()
    eng.switch_tp(4)
    tp_shard_matmul.launches = paged_decode_attention.launches = 0
    table = profile_engine(eng, batches=(1, 4, 8), ctxs=(64,))
    launches = {"tp_shard_matmul": tp_shard_matmul.launches, "paged_decode_attention": paged_decode_attention.launches}
    assert all(n > 0 for n in launches.values())
    assert launches == {k: eng.cache.replayed_launches()[k] for k in launches}
    assert set(table.decode_s) == {(tp, b, 64) for tp in (1, 2, 4, 8) for b in (1, 4, 8)}
    assert set(table.prefill_s) == {(tp, L) for tp in (1, 2, 4, 8) for L in (32, 64, 128)}
    assert all(v > 0 for v in [*table.decode_s.values(), *table.prefill_s.values()])
    assert eng.tp == 4
    table.save(str(tmp_path / "t.json"))
    back = ProfileTable.load(str(tmp_path / "t.json"))
    assert back.decode_s == table.decode_s and back.prefill_s == table.prefill_s


def test_time_fn_waits_for_the_device(cuda):
    """time_fn synchronises: a call that queues ~10 ms of device work
    (torch.cuda._sleep) and returns at once is read at no less than its
    CUDA-event time, and so is a decode graph's replay."""
    from repro_torch.profiles.profiler import time_fn

    x = torch.zeros(1, device=cuda)

    def busy():
        torch.cuda._sleep(20_000_000)
        return x.add(1)

    def event_ms(fn, *args):
        fn(*args)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    want = event_ms(busy)
    assert want > 2.0
    assert time_fn(busy) * 1e3 >= 0.9 * want
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=cuda).manual_seed(0),
                         torch.bfloat16)
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1,), n_slots=8, max_len=256, prefill_buckets=(32,),
                                                  dtype=torch.bfloat16), device=cuda)
    eng.warmup()
    args = (torch.zeros((8, 1), dtype=torch.int64, device=cuda), torch.full((8,), 64, dtype=torch.int64, device=cuda))
    decode = eng.cache.get(1, "decode")
    assert time_fn(decode, *args, iters=5) * 1e3 >= 0.9 * event_ms(decode, *args)


# ---------------------------------------------------------------------------
# training: the matmul under autograd, loss_fn's backward, check_train_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["col", "row", "col_t"])
@pytest.mark.parametrize("tp,rank", [(1, 0), (2, 1), (4, 2)])
def test_tp_shard_matmul_autograd_matches_plain(cuda, mode, tp, rank):
    """dX and the storage's gradient of one call at TP tp's rank offset,
    against the plain version's autograd on the same CUDA tensors (1e-5 of
    the scale, f32): the gradient is zero outside the shard; a row call's
    dX is one col_t launch and a col_t call's one row launch."""
    m, k, n = 96, 256, 384  # n: the whole weight's output width (col, col_t) or input rows (row)
    width = n // tp
    if mode == "col":
        w_shape, x_shape, n_out = (k, n), (m, k), width
    elif mode == "row":
        w_shape, x_shape, n_out = (n, k), (m, width), k
    else:
        w_shape, x_shape, n_out = (n, k), (m, k), width
    out_dtype = torch.float32
    grads = {}
    for which in ("kernel", "plain"):
        x = torch.randn(*x_shape, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda).requires_grad_()
        w = torch.randn(*w_shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda).requires_grad_()
        gy = torch.randn(m, n_out, generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
        before = (tp_shard_matmul.launches, tp_shard_matmul.backward_launches)
        if which == "kernel":
            y = tp_shard_matmul(x, w, rank * width, n_out=n_out, mode=mode, out_dtype=out_dtype)
        else:
            y = tp_shard_matmul_ref(x, w, rank * width, mode=mode, n_out=n_out, out_dtype=out_dtype)
        (y * gy).sum().backward()
        torch.cuda.synchronize()
        grads[which] = (x.grad, w.grad)
        if which == "kernel":
            assert tp_shard_matmul.launches - before[0] == 1
            assert tp_shard_matmul.backward_launches - before[1] == (mode != "col")
    for got, want in zip(grads["kernel"], grads["plain"]):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale
    dw = grads["kernel"][1]
    outside = dw.clone()
    outside.narrow(1 if mode == "col" else 0, rank * width, width).zero_()
    assert not outside.any()


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "gemma2-2b", "moonshot-v1-16b-a3b"])
def test_loss_backward_on_card_reaches_every_weight(cuda, monkeypatch, name):
    """loss_fn's backward on CUDA tensors at TP 2 through the kernel under
    autograd gives every storage leaf a gradient (the kernel's output has an
    autograd edge), the one the plain version gives on the same tensors to
    the CPU tests' tolerance against the reference, of each leaf's max |g|:
    1e-4, and 5e-4 for the MoE model, whose f32 gradients are that far from
    an f64 evaluation (routing equal, kernel against plain measured 3.5e-4
    for moonshot, 2.3e-5 for gemma2, 2.6e-5 for h2o-danube); the forward
    and the layers' recompute launch the kernel."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models import layers
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.training.data import synthetic_batch

    cfg = reduced(get_config(name))
    ec = make_exec_config(cfg, 2)
    defs = model_param_defs(cfg, ec)
    params = init_params(defs, torch.Generator(device=cuda).manual_seed(0))
    for _, t in tree_leaves_with_path(params):
        t.requires_grad_()
    store = WeightStore(cfg, defs, [cuda] * 2)
    bound = store.rebind(store.build(params), 2)
    tb = {k: torch.from_numpy(v).long().to(cuda) for k, v in synthetic_batch(cfg, 4, 32, 0).items()}
    grads = {}
    for which in ("kernel", "plain"):
        if which == "plain":
            monkeypatch.setattr(layers, "tp_shard_matmul", lambda x, w, off, *, n_out, mode="col", out_dtype=None:
                                tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=out_dtype))
        for _, t in tree_leaves_with_path(params):
            t.grad = None
        fwd = tp_shard_matmul.launches
        loss, _ = loss_fn(bound, cfg, ec, tb, seq_chunk=16, block_q=16, block_k=16)
        mid = tp_shard_matmul.launches
        loss.backward()
        torch.cuda.synchronize()
        if which == "kernel":
            assert mid > fwd and 0 < tp_shard_matmul.launches - mid < mid - fwd  # the layers' recompute, not the head's
        else:
            assert tp_shard_matmul.launches == mid == fwd
        grads[which] = {p: t.grad.clone() for p, t in tree_leaves_with_path(params)}
    for path, want in grads["plain"].items():
        got = grads["kernel"][path]
        scale = want.abs().max().item()
        assert scale > 0 and got.abs().max().item() > 0, path
        assert (got - want).abs().max().item() <= (5e-4 if cfg.moe else 1e-4) * scale, path


def test_check_train_step_on_card(cuda):
    from repro_torch.testing.multidev_checks import check_train_step

    out = check_train_step(cuda)
    assert out["zero1_split_leaves"] == out["leaves"]


def test_serve_launcher_on_card_matches_cpu(cuda):
    """launch.serve on the card (the demo model, a TP switch every 3 steps)
    against the same weights served on the CPU (plain versions): the same
    tokens, the counts the launcher prints, both kernels launched."""
    from repro_torch.launch import serve
    from repro_torch.models.params import tree_map

    argv = ["--tps", "1,2,4", "--requests", "6", "--max-new", "8", "--switch-every", "3"]
    args = serve.parse_args(argv)
    cfg, params = serve.build(args)
    tp_shard_matmul.launches = paged_decode_attention.launches = 0
    done, stats = serve.serve(cfg, params, args)
    assert tp_shard_matmul.launches > 0 and paged_decode_attention.launches > 0
    cpu_args = serve.parse_args(argv + ["--device", "cpu"])
    cpu_done, cpu_stats = serve.serve(cfg, tree_map(lambda t: t.cpu(), params), cpu_args)
    assert {r.req_id: r.generated for r in done} == {r.req_id: r.generated for r in cpu_done}
    assert {k: stats[k] for k in ("switches", "steps", "final_tp")} == {
        k: cpu_stats[k] for k in ("switches", "steps", "final_tp")}
    assert stats["switches"] > 0


def test_op_cost_on_card_equals_meta(cuda):
    """A plain PyTorch program counts the same on CUDA tensors as on meta:
    operations, bytes and ops (a kernel wrapper's launch is not an aten op,
    which is why the dry run counts on meta, where the wrappers take their
    plain versions)."""
    from repro_torch.launch import op_cost

    def program(x, ws, b):
        h = x
        for w in ws:
            h = torch.nn.functional.silu(h @ w) + b
        return torch.bmm(h.view(4, 8, -1), h.view(4, 8, -1).transpose(1, 2)).softmax(-1)

    counts = {}
    for dev in (cuda, torch.device("meta")):
        g = torch.Generator(device="cpu").manual_seed(0)
        x = torch.randn(32, 64, generator=g).to(dev)
        ws = [torch.randn(64, 64, generator=g).to(dev) for _ in range(3)]
        b = torch.randn(64, generator=g).to(dev)
        _, cost = op_cost.count(program, x, ws, b)
        counts[dev.type] = (cost.dot_flops, cost.hbm_bytes, cost.ops)
    assert counts["cuda"] == counts["meta"]
    assert counts["meta"][0] == 3 * 2 * 32 * 64 * 64 + 2 * 4 * 8 * 8 * 64


# ---------------------------------------------------------------------------
# across cards: one process per card, joined by NCCL
# ---------------------------------------------------------------------------
def _cards(n):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")


def _pool(world, names):
    from repro_torch.testing.multidev_checks import spawn

    return [{n: r[n]["summary"] for n in names} for r in spawn(world, "cuda", names)]


def test_nccl_collectives_match_one_process_sums(cuda):
    """all-reduce, all-gather, all-to-all and the uneven exchange over every
    TP level's groups, against one process's sums and joins of the ranks'
    tensors (check_collectives)."""
    _cards(2)
    world = min(torch.cuda.device_count(), 4)
    ranks = _pool(world, ["collectives"])
    assert all(r["collectives"]["backend"] == "nccl" for r in ranks)
    assert sorted(ranks[0]["collectives"]["levels"]) == [str(t) for t in (1, 2, 4) if world % t == 0]


def test_migrate_pages_between_cards_matches_plain(cuda):
    """migrate_pages from a pool on cuda:0 into one on cuda:1 in one process
    (the transfer a copy between the cards), then between two ranks of a
    pool (gather and send on card 0, receive and scatter on card 1): the
    pages equal kv_gather / kv_scatter's plain versions bit for bit."""
    _cards(2)
    a, b = torch.device("cuda", 0), torch.device("cuda", 1)
    src = PagedPool(num_pages=64, page_size=16, kv_heads=8, head_dim=128, n_layers=3, dtype=torch.bfloat16, device=a)
    dst = PagedPool(num_pages=64, page_size=16, kv_heads=8, head_dim=128, n_layers=3, dtype=torch.bfloat16, device=b)
    g = torch.Generator(device=a).manual_seed(0)
    src.k_pages.normal_(generator=g)
    src.v_pages.normal_(generator=g)
    for s in range(4):
        src.alloc_seq(s, 16)
    for _ in range(5):
        for s in range(4):
            src.extend_seq(s, 16)
    dst.alloc_seq(9, 40)
    seqs = [0, 1, 2, 3]
    g0, s0 = kv_gather.launches, kv_scatter.launches
    tables, _ = migrate_pages(src, dst, seqs)
    assert (kv_gather.launches - g0, kv_scatter.launches - s0) == (2, 2)
    for k in ("k", "v"):
        plain = kv_scatter_ref(torch.zeros_like(dst.page_rows(k).cpu()),
                               kv_gather_ref(src.page_rows(k).cpu(), src.row_ids(src.migration_page_ids(seqs))),
                               dst.row_ids(dst.migration_page_ids(seqs)))
        rows = dst.row_ids(dst.migration_page_ids(seqs))
        assert torch.equal(dst.page_rows(k).cpu()[rows], plain[rows])
    ranks = _pool(2, ["migration"])
    assert ranks[1]["migration"]["pages"]["bit_identical"]


def test_engine_across_four_cards_equals_one_card(cuda):
    """check_engine at world 4 (TP 1/2/4, the reference's switch schedule)
    and at world 1: the same tokens, equal to the one-process engine's."""
    from repro_torch.testing.multidev_checks import SCHEDULE, engine_requests, serve_cfg, spawn

    _cards(4)
    four = spawn(4, "cuda", ["engine"])
    one = spawn(1, "cuda", ["engine"])
    cfg = serve_cfg()
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(cuda).manual_seed(0))
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96,
                                                  prefill_buckets=(16, 32)), device=cuda)
    base = {r.req_id: list(r.generated) for r in eng.run(engine_requests(Request), switch_schedule=SCHEDULE)}
    assert four[0]["engine"]["summary"]["switches"] == 4
    for r in four + one:
        assert r["engine"]["arrays"]["trajectories"] == base


@pytest.mark.parametrize("model", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_family_engine_across_four_cards_equals_one_card(cuda, model):
    """check_engine on reduced moonshot (MoE) and reduced jamba (Mamba-1,
    attention and MoE) at world 4 (TP 1/2/4, the reference's switch
    schedule): on every card the one-process engine's tokens at fixed TP 1
    and under the schedule, and the pool's MoE drops per (TP level, stage)
    equal to the one-process engine's."""
    from repro_torch.testing.multidev_checks import SCHEDULE, engine_cfg, engine_params, engine_requests, spawn

    _cards(4)
    four = spawn(4, "cuda", ["engine"], inputs={"engine": {"model": model}})
    cfg = engine_cfg(model)
    eng = ServingEngine(cfg, engine_params(cfg, cuda), EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96,
                                                                     prefill_buckets=(16, 32)), device=cuda)
    base = {r.req_id: list(r.generated) for r in eng.run(engine_requests(Request), switch_schedule=SCHEDULE)}
    dropped = {f"{tp}/{stage}": n for (tp, stage), n in eng.moe_dropped().items()}
    for r in four:
        assert r["engine"]["summary"]["switches"] == 4
        assert r["engine"]["arrays"]["trajectories"] == base
        assert r["engine"]["arrays"]["moe_dropped"]["switched"] == dropped


@pytest.mark.parametrize("model", ["gemma2-2b", "h2o-danube-1.8b"])
def test_windowed_engine_across_four_cards_equals_one_card(cuda, model):
    """check_engine on reduced gemma2-2b and h2o-danube-1.8b (windows of
    16, 4 KV heads) at world 4, at tests/test_torch_windowed_multidev.py's
    engine settings (8 slots, max_len 64, buckets 8/16/32, so that the
    rings wrap before the switches): on every card the one-process
    engine's tokens at fixed TP 1 and under the reference's switch
    schedule."""
    from repro_torch.testing.multidev_checks import SCHEDULE, engine_cfg, engine_params, engine_requests, spawn

    _cards(4)
    settings = dict(candidate_tps=(1, 2, 4), n_slots=8, max_len=64, prefill_buckets=(8, 16, 32))
    four = spawn(4, "cuda", ["engine"], inputs={"engine": {"model": model, "engine": settings}})
    cfg = engine_cfg(model)
    eng = ServingEngine(cfg, engine_params(cfg, cuda), EngineConfig(**settings), device=cuda)
    base = {r.req_id: list(r.generated) for r in eng.run(engine_requests(Request), switch_schedule=SCHEDULE)}
    for r in four:
        assert r["engine"]["summary"]["switches"] == 4
        assert r["engine"]["arrays"]["trajectories"] == base


@pytest.mark.parametrize("model", ["yi-34b", "chameleon-34b", "musicgen-large", "mistral-large-123b", "dbrx-132b"])
def test_remainder_engine_across_four_cards_equals_one_card(cuda, model):
    """check_engine on the last five served models at
    tests/test_torch_remainder_multidev.py's shapes (``engine_cfg``: yi G
    7, mistral G 12, dbrx G 6 with 16 experts, top 4, musicgen's MHA over 8
    KV heads, chameleon's qk-norm with nonzero scales) at world 4 (TP
    1/2/4): on every card the one-process engine's tokens at fixed TP 1
    and under the reference's switch schedule, and dbrx's drops per (TP
    level, stage) equal to the one-process engine's."""
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.testing.multidev_checks import SCHEDULE, engine_cfg, engine_params, engine_requests, spawn

    _cards(4)
    four = spawn(4, "cuda", ["engine"], inputs={"engine": {"model": model}})
    cfg = engine_cfg(model)
    params = engine_params(cfg, cuda)
    scales = [t for path, t in tree_leaves_with_path(params) if path[-1] in ("q_norm", "k_norm")]
    assert len(scales) == (2 if cfg.attn.qk_norm else 0) and all(bool((t != 0).all()) for t in scales)
    eng = ServingEngine(cfg, params, EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96,
                                                  prefill_buckets=(16, 32)), device=cuda)
    base = {r.req_id: list(r.generated) for r in eng.run(engine_requests(Request), switch_schedule=SCHEDULE)}
    dropped = {f"{tp}/{stage}": n for (tp, stage), n in eng.moe_dropped().items()}
    for r in four:
        assert r["engine"]["summary"]["switches"] == 4
        assert r["engine"]["arrays"]["trajectories"] == base
        assert r["engine"]["arrays"]["moe_dropped"]["switched"] == dropped


def test_train_step_across_four_cards(cuda):
    """Training across cards: check_train_step's pool check at world 4 on
    NCCL (reduced h2o-danube-1.8b at data 2 x model 2 against a single-rank
    step, each leaf within 1e-2 of its update, ZeRO-1 moments on each data
    rank, the replication after every step: it raises otherwise), the
    collectives'
    gradients against the one-process TP 2 ranks (within 1e-6), and
    multicard's train_f32 leg at 2 layers (h2o-danube-1.8b at full width,
    8 x 512, against the one-card run within check_train_step's tolerances
    and each leaf within 1e-2 of its update)."""
    from repro_torch.testing import multicard
    from repro_torch.testing.multidev_checks import UPDATE_RTOL, spawn

    _cards(4)
    ranks = _pool(4, ["train_step", "train_grads"])
    for r in ranks:
        case = r["train_step"]["cases"]["plain"]
        assert r["train_step"]["mesh"] == {"data": 2, "model": 2} and case["replicated_after_every_step"]
        assert case["zero1_split_leaves"] == case["leaves"] and case["update_rel"] < UPDATE_RTOL
        assert max(r["train_grads"]["max_abs_err"].values()) <= 1e-6
    legs = spawn(4, "cuda", task="repro_torch.testing.multicard:legs",
                 inputs={"layers": 2, "only": ["train_f32"], "skip": []})
    rec = legs[0]["repro_torch.testing.multicard:legs"]["train_f32"]
    assert rec["failures"] == [] and rec["mesh"] == {"data": 2, "model": 2}
    dist = rec["one_card_tp1_dp1"]["distance"]
    assert dist["loss_rel"] < 2e-4 and dist["outside"] is None and dist["update_rel"] < UPDATE_RTOL
    assert all(np.isfinite(rec["losses"]))
    assert rec["launches_per_step"]["forward"] > 0 and rec["launches_per_step"]["backward"] > 0
    assert multicard.TRAIN_BATCH * multicard.TRAIN_SEQ == 8 * 512


def test_moe_and_mamba_train_step_across_four_cards(cuda):
    """The MoE and Mamba families trained across cards: check_train_moe at
    world 4 on NCCL, reduced moonshot-v1-16b-a3b at (data 2, model 2),
    (4, 1) and (1, 4), reduced jamba-v0.1-52b (own fan-in, and
    init_params' weights for one step) and mamba2-2.7b at (2, 2): rank 0
    holds each to the one-process step at its layout (gradients within
    5e-4 / 1e-4 of each leaf's greatest element, losses within 2e-4,
    each leaf within 1e-2 of its update; it raises otherwise), the
    replication after every step on every rank."""
    from repro_torch.testing.multidev_checks import TRAIN_MOE_CASES, UPDATE_RTOL

    _cards(4)
    ranks = _pool(4, ["train_moe"])
    for r in ranks:
        assert sorted(r["train_moe"]) == sorted(TRAIN_MOE_CASES)
        for case, s in r["train_moe"].items():
            assert s["replicated_after_every_step"] and all(np.isfinite(s["losses"]))
            assert s["mesh"] == {"data": 4 // TRAIN_MOE_CASES[case][1], "model": TRAIN_MOE_CASES[case][1]}
    for s in ranks[0]["train_moe"].values():
        one = s["one_process"]
        assert one["outside"] is None and one["update_rel"] < UPDATE_RTOL and one["loss_rel"] < 2e-4


def test_tp_shard_matmul_col_t_bf16_backward_reads_the_f32_gradient(cuda):
    """The tied head in bf16 (col_t, f32 logits): dX is a product of the
    f32 logits' gradient, unrounded, as the plain version's autograd (and
    the reference's transpose) takes it, and the shard read; dW the
    shard's. Against the plain version's autograd within 1e-2 of each
    gradient's greatest element (bf16 outputs: two ulps)."""
    m, k, n, tp, rank = 16, 256, 512, 2, 1
    width = n // tp
    grads = {}
    for which in ("kernel", "plain"):
        gen = lambda s: torch.Generator(device=cuda).manual_seed(s)  # noqa: E731
        x = torch.randn(m, k, generator=gen(1), device=cuda).bfloat16().requires_grad_()
        w = torch.randn(n, k, generator=gen(2), device=cuda).bfloat16().requires_grad_()
        gy = torch.randn(m, width, generator=gen(3), device=cuda)
        fn = tp_shard_matmul if which == "kernel" else (
            lambda x, w, off, **kw: tp_shard_matmul_ref(x, w, off, mode=kw["mode"], n_out=kw["n_out"],
                                                        out_dtype=kw["out_dtype"]))
        y = fn(x, w, rank * width, n_out=width, mode="col_t", out_dtype=torch.float32)
        (y * gy).sum().backward()
        grads[which] = (x.grad.float(), w.grad.float())
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


def test_pipeline_and_profile_across_cards(cuda):
    """The pipeline schedule across cards (check_pipeline: at 4 cards
    (pipe 4), (pipe 2, data 2), (pipe 2, model 2); the toy body and a
    reduced llama3-8b decoder layer against the sequential stack within
    2e-5: it raises otherwise) and profile_engine over the pool
    (check_profile: every rank's table equal, each key the slowest rank's
    time)."""
    from repro_torch.testing.multidev_checks import PIPE_TOL, pipe_meshes

    _cards(2)
    world = min(torch.cuda.device_count(), 4)
    ranks = _pool(world, ["pipeline", "profile"])
    names = [name for name, _, _ in pipe_meshes(world)]
    for r in ranks:
        assert sorted(r["pipeline"]) == sorted(f"{n}/{w}" for n in names for w in ("toy", "llama"))
        assert max(max(e.values()) for e in r["pipeline"].values()) <= PIPE_TOL
        assert r["profile"]["tps"] == [t for t in (1, 2, 4, 8) if world % t == 0]


def _leg_checks(leg: str, rec: dict) -> None:
    """What each of the bring-up legs holds beyond its own failures."""
    from repro_torch.testing import multicard

    if leg == "dbrx_witness":
        assert rec["verdict"] == "f32 rounding" and rec["f64_routing_equal"]
        assert rec["f64_tp4_vs_tp1"] <= multicard.WITNESS_F64_RTOL
        assert max(rec["f32_engine_vs_f64"].values()) <= multicard.WITNESS_F32_GAP
        assert not any(rec["f64_dropped"].values())
    elif leg.startswith("train_bf16_"):
        assert rec["bf16"]["dtype"] == "bfloat16" and rec["f32"]["dtype"] == "float32"
        assert max(rec["loss_rel_to_f32"]) < multicard.BF16_VS_F32_RTOL
        for run in (rec["f32"], rec["bf16"]):
            assert run["replicated_after_every_step"] and run["launches_per_step"]["forward"] > 0
            assert run["peak_gb"] > 0 and "collective_share" in run
    else:  # train_rules_dbrx
        assert rec["held"]["against_default"]["update_rel"] < 1e-2
        assert rec["held"]["peak_gb"] < rec["held"]["default_rules"]["peak_gb"]
        assert rec["deep"]["layers"] == multicard.TRAIN_RULES_DBRX_DEEP_LAYERS
        assert rec["deep"]["peak_gb"] < multicard.PEAK_LIMIT_GB
        assert any(k.startswith("all-gather (weights)") for k in rec["deep"]["collectives_per_step"])


@pytest.mark.parametrize("leg", ["dbrx_witness", "train_bf16_moe", "train_bf16_jamba", "train_bf16_mamba2",
                                 "train_rules_dbrx"])
def test_bring_up_legs_across_four_cards(cuda, leg):
    """``python -m repro_torch.testing.multicard --nproc 4 --only <leg>``:
    dbrx-132b's f32 flip at TP 4 against its f64 witness (verdict: f32
    rounding), bf16 moonshot, jamba and mamba2 training across the cards
    against f32 from the same seed (losses within BF16_VS_F32_RTOL, falling
    in both), and dbrx-132b under the reference's train rules (2 layers
    held to DEFAULT_RULES, 4 under the rules alone, under 80 GB a card).
    The leg's record lands in chiprun_out/c4_<leg>.json."""
    import json
    import os
    import subprocess
    import sys

    _cards(4)
    out = os.path.join("chiprun_out", f"c4_{leg}.json")
    run = subprocess.run([sys.executable, "-m", "repro_torch.testing.multicard", "--nproc", "4", "--only", leg,
                          "--out", out], capture_output=True, text=True, timeout=3000)
    assert run.returncode == 0, run.stdout[-6000:] + run.stderr[-6000:]
    with open(out) as f:
        rec = json.load(f)["ranks"][0][leg]
    assert rec["failures"] == []
    _leg_checks(leg, rec)
