"""The port's kernel wrappers (their plain versions, on CPU tensors) against
the reference's Pallas kernels in interpret mode and its jnp oracles, on
the same numpy inputs, at tests/test_kernels.py's shapes and tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import paged_decode_attention as j_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_decode_attention_ref as j_paged_ref  # noqa: E402
from repro.kernels.tp_shard_matmul.ops import tp_shard_matmul as j_mm  # noqa: E402
from repro.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref as j_mm_ref  # noqa: E402
from repro.models.attention import decode_attention as j_decode_attention  # noqa: E402

from repro_torch.kernels.paged_attention.ops import paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_attention.ref import T_SPLIT, paged_decode_attention_split_ref  # noqa: E402
from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jax array and a torch tensor of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _grid_values(rng, *shape):
    """Multiples of 1/8 in [-1, 1]: exact in bf16, and every product and
    partial sum of the sweeps is exact in f32, so the result does not depend
    on the order either framework sums in and the comparison checks shard
    selection and layout, not rounding."""
    return (rng.randint(-8, 9, size=shape) / 8).astype(np.float32)


def _mm_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# tp_shard_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "m,k,n_store,n_out,shard",
    [
        (64, 128, 512, 128, 0),
        (64, 128, 512, 128, 3),
        (128, 256, 256, 64, 2),
        (32, 64, 576, 144, 1),  # non-128-aligned (gemma2 d_ff/16 = 576)
        (256, 512, 1024, 512, 1),
    ],
)
def test_tp_shard_matmul_col_matches_reference(dtype, m, k, n_store, n_out, shard):
    rng = np.random.RandomState(m + k + n_out + shard)
    jx, tx = _pair(_grid_values(rng, m, k), dtype)
    jw, tw = _pair(_grid_values(rng, k, n_store), dtype)
    off = shard * n_out
    got = tp_shard_matmul(tx, tw, off, n_out=n_out, mode="col")
    assert got.dtype == tx.dtype and got.shape == (m, n_out)
    np.testing.assert_allclose(_f32(got), _f32(j_mm(jx, jw, off, n_out=n_out, mode="col")), **_mm_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(j_mm_ref(jx, jw, off, mode="col", n_out=n_out)), **_mm_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "m,k_store,k,n,shard",
    [(64, 512, 128, 128, 0), (64, 512, 128, 128, 2), (32, 256, 64, 96, 1)],
)
def test_tp_shard_matmul_row_matches_reference(dtype, m, k_store, k, n, shard):
    rng = np.random.RandomState(7 * m + k + n + shard)
    jx, tx = _pair(_grid_values(rng, m, k), dtype)
    jw, tw = _pair(_grid_values(rng, k_store, n), dtype)
    off = shard * k
    got = tp_shard_matmul(tx, tw, off, n_out=n, mode="row")
    np.testing.assert_allclose(_f32(got), _f32(j_mm(jx, jw, off, n_out=n, mode="row")), **_mm_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(j_mm_ref(jx, jw, off, mode="row", n_out=n)), **_mm_tol(dtype))


def test_tp_shard_matmul_equals_presliced_weights():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    w = torch.from_numpy(rng.randn(128, 512).astype(np.float32))
    for tp in (1, 2, 4):
        n_out = 512 // tp
        for s in range(tp):
            got = tp_shard_matmul(x, w, s * n_out, n_out=n_out, mode="col")
            direct = tp_shard_matmul(x, w[:, s * n_out:(s + 1) * n_out].contiguous(), 0, n_out=n_out, mode="col")
            assert torch.equal(got, direct)


def test_tp_shard_matmul_f32_output_for_logits():
    rng = np.random.RandomState(1)
    jx, tx = _pair(rng.randn(8, 64).astype(np.float32), "bfloat16")
    jw, tw = _pair(rng.randn(64, 96).astype(np.float32), "bfloat16")
    got = tp_shard_matmul(tx, tw, 32, n_out=32, mode="col", out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = jnp.einsum("md,dv->mv", jx, jw[:, 32:64], preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "x_shape,w_shape,kw,err",
    [
        ((8, 64), (64, 128), dict(offset=96, n_out=64, mode="col"), ValueError),  # past the end
        ((8, 64), (32, 128), dict(offset=0, n_out=64, mode="col"), ValueError),  # K mismatch
        ((8, 64), (128, 32), dict(offset=96, n_out=32, mode="row"), ValueError),  # rows past the end
        ((8, 64), (64, 128), dict(offset=0, n_out=64, mode="diag"), ValueError),
        ((8, 2, 32), (64, 128), dict(offset=0, n_out=64, mode="col"), ValueError),
    ],
)
def test_tp_shard_matmul_rejects_bad_inputs(x_shape, w_shape, kw, err):
    with pytest.raises(err):
        tp_shard_matmul(torch.zeros(x_shape), torch.zeros(w_shape), kw.pop("offset"), **kw)
    with pytest.raises(TypeError):
        tp_shard_matmul(torch.zeros(8, 64), torch.zeros(64, 64, dtype=torch.bfloat16), 0, n_out=64)


# col_t: the tied head, y = x @ embed[offset:offset+n_out].T with f32 logits,
# against the reference's logits_for einsum with embed.T and against the
# pre-sliced rows; (m, k, n_store, n_out, shard); 576 = gemma2 d_ff / 16
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n_store,n_out,shard", [(8, 64, 512, 128, 3), (1, 128, 256, 64, 2), (33, 48, 576, 144, 1),
                                                     (8, 100, 300, 75, 3)])
def test_tp_shard_matmul_col_t_matches_reference_head(dtype, m, k, n_store, n_out, shard):
    rng = np.random.RandomState(m + k + shard)
    jx, tx = _pair(rng.randn(m, k).astype(np.float32), dtype)
    jw, tw = _pair(rng.randn(n_store, k).astype(np.float32), dtype)
    off = shard * n_out
    got = tp_shard_matmul(tx, tw, off, n_out=n_out, mode="col_t", out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n_out)
    want = jnp.einsum("md,dv->mv", jx, jw.T[:, off:off + n_out], preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    sliced = tp_shard_matmul(tx, tw[off:off + n_out].contiguous(), 0, n_out=n_out, mode="col_t", out_dtype=torch.float32)
    assert torch.equal(got, sliced)
    np.testing.assert_allclose(got.numpy(), _f32(j_mm_ref(jx, jw.T, off, mode="col", n_out=n_out)), **_mm_tol(dtype))


@pytest.mark.parametrize(
    "x_shape,w_shape,kw,err",
    [
        ((8, 64), (128, 64), dict(offset=96, n_out=64), ValueError),  # rows past the end
        ((8, 64), (128, 32), dict(offset=0, n_out=64), ValueError),  # K mismatch
        ((8, 64), (64, 128), dict(offset=0, n_out=64), ValueError),  # stored (K, N), not (N, K)
    ],
)
def test_tp_shard_matmul_col_t_rejects_bad_inputs(x_shape, w_shape, kw, err):
    with pytest.raises(err):
        tp_shard_matmul(torch.zeros(x_shape), torch.zeros(w_shape), kw.pop("offset"), mode="col_t", **kw)
    with pytest.raises(TypeError, match="float32"):  # logits only: bf16 in, f32 out
        tp_shard_matmul(torch.zeros(8, 64, dtype=torch.bfloat16), torch.zeros(128, 64, dtype=torch.bfloat16), 0,
                        n_out=64, mode="col_t")


def test_cpu_path_launches_no_kernel():
    before = (tp_shard_matmul.launches, paged_decode_attention.launches)
    tp_shard_matmul(torch.zeros(8, 16), torch.zeros(16, 32), 16, n_out=16, mode="col")
    q = torch.zeros(1, 1, 1, 16)
    pages = torch.zeros(2, 4, 1, 16)
    paged_decode_attention(q, pages, pages, torch.tensor([[1, 0]], dtype=torch.int32), torch.tensor([5], dtype=torch.int32))
    assert (tp_shard_matmul.launches, paged_decode_attention.launches) == before


# ---------------------------------------------------------------------------
# paged_decode_attention
# ---------------------------------------------------------------------------
def _paged_inputs(B, KV, G, hd, page, n_pages, seed, extra_pages=2):
    rng = np.random.RandomState(seed)
    P = B * n_pages + extra_pages
    q = rng.randn(B, KV, G, hd).astype(np.float32)
    kp = rng.randn(P, page, KV, hd).astype(np.float32)
    vp = rng.randn(P, page, KV, hd).astype(np.float32)
    tables = rng.permutation(P)[: B * n_pages].reshape(B, n_pages).astype(np.int32)
    lens = rng.randint(1, page * n_pages + 1, size=(B,)).astype(np.int32)
    return q, kp, vp, tables, lens


def _run_paged(q, kp, vp, tables, lens, dtype, softcap=None):
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(kp, dtype), _pair(vp, dtype)
    got = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lens), softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    j_tables, j_lens = jnp.asarray(tables), jnp.asarray(lens)
    return (_f32(got), _f32(j_paged(jq, jk, jv, j_tables, j_lens, softcap=softcap)),
            _f32(j_paged_ref(jq, jk, jv, j_tables, j_lens, softcap=softcap)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "B,KV,G,hd,page,n_pages",
    [(2, 2, 4, 32, 8, 4), (1, 1, 8, 64, 16, 2), (4, 4, 1, 16, 4, 8)],
)
def test_paged_decode_attention_matches_reference(dtype, B, KV, G, hd, page, n_pages):
    got, kernel, oracle = _run_paged(*_paged_inputs(B, KV, G, hd, page, n_pages, B * 31 + n_pages), dtype)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)


def test_paged_decode_attention_softcap():
    q, kp, vp, _, _ = _paged_inputs(2, 2, 2, 16, 8, 2, 3, extra_pages=0)
    tables = np.arange(4, dtype=np.int32).reshape(2, 2)
    lens = np.array([13, 16], np.int32)
    got, kernel, oracle = _run_paged(q, kp, vp, tables, lens, "float32", softcap=20.0)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", range(4))
def test_paged_attention_any_block_table_permutation(seed):
    """A shuffled block table gives dense attention over the same logical
    sequence."""
    B, G, page, n_pages = 1 + seed % 3, 1 + seed, (4, 8)[seed % 2], 1 + seed
    got, _, oracle = _run_paged(*_paged_inputs(B, 2, G, 16, page, n_pages, seed, extra_pages=0), "float32")
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


# The CUDA kernel's arithmetic (splits of T_SPLIT tokens merged by
# log-sum-exp, in plain PyTorch) against the Pallas kernel and the jnp
# oracle, in f32 at 2e-5, at the lengths where a split begins or ends.
_SPLIT_LENGTHS = {
    "seq_len 1": 1, "T_SPLIT": T_SPLIT, "T_SPLIT + 1": T_SPLIT + 1,
    "a multiple of the page": 48, "the table's last token": 2 * T_SPLIT + 32,
}


def _run_split(q, kp, vp, tables, lens, softcap=None):
    got = paged_decode_attention_split_ref(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                                           torch.from_numpy(tables), torch.from_numpy(lens), softcap=softcap)
    jq, jk, jv, jt, jl = (jnp.asarray(a) for a in (q, kp, vp, tables, lens))
    return got.numpy(), _f32(j_paged(jq, jk, jv, jt, jl, softcap=softcap)), _f32(j_paged_ref(jq, jk, jv, jt, jl, softcap=softcap))


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("length", list(_SPLIT_LENGTHS))
def test_split_merge_version_matches_reference(length, page):
    """Row 0 has the named length; the table holds 2 T_SPLIT + 32 tokens, so
    its last token ends a third, partial split."""
    n_pages = (2 * T_SPLIT + 32) // page
    q, kp, vp, tables, lens = _paged_inputs(3, 2, 4, 32, page, n_pages, seed=len(length) + page)
    lens[0] = _SPLIT_LENGTHS[length]
    got, kernel, oracle = _run_split(q, kp, vp, tables, lens)
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


def test_split_merge_version_softcap():
    q, kp, vp, tables, _ = _paged_inputs(2, 2, 2, 16, 16, 8, seed=5)
    lens = np.array([T_SPLIT + 1, 2 * T_SPLIT + 13], np.int32)
    got, kernel, oracle = _run_split(q * 8, kp, vp, tables, lens, softcap=20.0)  # scores large enough to cap
    np.testing.assert_allclose(got, kernel, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t_split", [1, 5, 16, 4096])
def test_split_merge_version_any_split_equals_dense(t_split):
    """The merge is exact arithmetic up to rounding at any split width, one
    token to the whole table."""
    q, kp, vp, tables, lens = _paged_inputs(4, 2, 3, 16, 4, 10, seed=t_split)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    got = paged_decode_attention_split_ref(*args, t_split=t_split)
    np.testing.assert_allclose(got.numpy(), paged_decode_attention(*args).numpy(), rtol=2e-5, atol=2e-5)


def test_split_merge_version_never_reads_past_seq_len():
    """NaN in every page named past seq_len and in the last page's tail does
    not reach the output."""
    q, kp, vp, tables, _ = _paged_inputs(2, 2, 4, 16, 8, 12, seed=9, extra_pages=0)
    lens = np.array([T_SPLIT + 3, 21], np.int32)
    clean = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens)]
    kn, vn = kp.copy(), vp.copy()
    for b, n in enumerate(lens):
        for j, pid in enumerate(tables[b]):
            kn[pid, max(0, n - j * 8):] = np.nan
            vn[pid, max(0, n - j * 8):] = np.nan
    got = paged_decode_attention_split_ref(clean[0], torch.from_numpy(kn), torch.from_numpy(vn), *clean[3:])
    assert torch.isfinite(got).all()
    assert torch.equal(got, paged_decode_attention_split_ref(*clean))


@pytest.mark.parametrize("page", [4, 8, 16])
def test_dense_slot_cache_as_pages_equals_decode_attention(page):
    """The engine's decode path: a dense (B,S,KV,hd) slot cache viewed as
    pages with identity tables and seq_lens = min(pos+1, S) gives the
    reference's dense decode attention."""
    rng = np.random.RandomState(page)
    B, S, KV, G, hd = 3, 32, 2, 4, 16
    q = rng.randn(B, KV, G, hd).astype(np.float32)
    kc = rng.randn(B, S, KV, hd).astype(np.float32)
    vc = rng.randn(B, S, KV, hd).astype(np.float32)
    pos = np.array([0, 17, S - 1])
    n_pages = S // page
    tables = torch.arange(B * n_pages, dtype=torch.int32).view(B, n_pages)
    lens = torch.from_numpy(np.minimum(pos + 1, S).astype(np.int32))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), tables, lens, None)
    valid = np.arange(S)[None] <= pos[:, None]
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid), None, None, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# The new models' decode shapes: h2o-danube-1.8b (hd 80, G 4) and gemma2-2b
# (hd 256, G 2, attention softcap 50), against the Pallas kernel in interpret
# mode and the jnp oracle, including a windowed layer's wrapped buffer:
# identity tables over Sc = 64 rows, seq_len = Sc for every row.
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd,G,cap", [(80, 4, None), (256, 2, 50.0)], ids=["danube_hd80", "gemma2_hd256"])
def test_paged_decode_attention_new_head_dims(dtype, hd, G, cap):
    q, kp, vp, tables, lens = _paged_inputs(3, 2, G, hd, 16, 5, seed=hd + G)
    got, kernel, oracle = _run_paged(q * 4, kp, vp, tables, lens, dtype, softcap=cap)
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    B, Sc, page = 2, 64, 16
    q, kp, vp, _, _ = _paged_inputs(B, 2, G, hd, page, Sc // page, seed=hd, extra_pages=0)
    tables = np.arange(B * Sc // page, dtype=np.int32).reshape(B, Sc // page)
    full = np.full((B,), Sc, np.int32)
    got, kernel, oracle = _run_paged(q, kp, vp, tables, full, dtype, softcap=cap)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    if dtype == "float32":
        split, _, _ = _run_split(q, kp, vp, tables, full, softcap=cap)
        np.testing.assert_allclose(split, oracle, rtol=2e-5, atol=2e-5)


def test_wrapped_window_buffer_equals_attention_in_position_order():
    """After a windowed layer's buffer wraps, slot s holds the latest position
    p with p % window = s, so the buffer is the window in rotated order;
    attention over it with seq_len = window equals attention over the same
    keys in position order."""
    rng = np.random.RandomState(11)
    B, KV, G, hd, window, page = 2, 2, 4, 80, 32, 16
    pos = np.array([40, 75])  # the position each row writes now
    keys = rng.randn(B, 80, KV, hd).astype(np.float32)  # K/V by absolute position
    vals = rng.randn(B, 80, KV, hd).astype(np.float32)
    buf_k, buf_v = np.zeros((B, window, KV, hd), np.float32), np.zeros((B, window, KV, hd), np.float32)
    for b in range(B):
        for p in range(pos[b] + 1):
            buf_k[b, p % window], buf_v[b, p % window] = keys[b, p], vals[b, p]
    q = rng.randn(B, KV, G, hd).astype(np.float32)
    tables = torch.arange(B * window // page, dtype=torch.int32).view(B, window // page)
    lens = torch.from_numpy(np.minimum(pos + 1, window).astype(np.int32))
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(buf_k), torch.from_numpy(buf_v), tables, lens, None)
    for b in range(B):
        lo = pos[b] + 1 - window
        want = j_decode_attention(jnp.asarray(q[b:b + 1]), jnp.asarray(keys[b:b + 1, lo:pos[b] + 1]),
                                  jnp.asarray(vals[b:b + 1, lo:pos[b] + 1]), jnp.ones((1, window), bool),
                                  None, None, None)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_paged_decode_attention_rejects_bad_inputs():
    q = torch.zeros(2, 2, 4, 16)
    pages = torch.zeros(4, 8, 2, 16)
    tables = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_decode_attention(q, torch.zeros(4, 8, 1, 16), torch.zeros(4, 8, 1, 16), tables, lens)
    with pytest.raises(TypeError):
        paged_decode_attention(q, pages.bfloat16(), pages.bfloat16(), tables, lens)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pages, pages, tables[:1], lens)
