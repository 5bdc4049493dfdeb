"""The port's paged-KV migration path against the reference on the same
numpy inputs: kv_gather / kv_scatter (plain versions on CPU tensors) against
the Pallas kernels in interpret mode and the jnp oracles, bit for bit;
PagedPool against the reference's PagedPool, op for op; migrate_pages
against the same composition of reference pieces; kv_migration_bytes."""
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.migration import kv_migration_bytes as j_kv_migration_bytes  # noqa: E402
from repro.kernels.kv_gather.ops import kv_gather as j_gather, kv_scatter as j_scatter  # noqa: E402
from repro.kernels.kv_gather.ref import kv_gather_ref as j_gather_ref, kv_scatter_ref as j_scatter_ref  # noqa: E402
from repro.kernels.paged_attention.ops import paged_decode_attention as j_paged  # noqa: E402
from repro.serving.kv_cache import PagedPool as JPagedPool  # noqa: E402

import repro_torch.core.migration as migration_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.migration import MigrationAborted, kv_migration_bytes, migrate_pages  # noqa: E402
from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter  # noqa: E402
from repro_torch.kernels.kv_gather.ref import kv_gather_ref, kv_scatter_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import paged_decode_attention  # noqa: E402
from repro_torch.serving.kv_cache import PagedPool  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numpy values as a jax array and a torch tensor of one dtype
    (both round f32 to bf16 to nearest even, so the bits agree)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _bits(x) -> np.ndarray:
    """The raw bits of a tensor or array, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.element_size() == 4 else torch.int16).numpy()
    x = np.asarray(x)
    return x.view(np.int32 if x.itemsize == 4 else np.int16)


# ---------------------------------------------------------------------------
# kv_gather / kv_scatter (tests/test_kernels.py's shapes)
# ---------------------------------------------------------------------------
SWEEP = [(16, 128, 4), (64, 256, 64), (8, 512, 1)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P,F,n", SWEEP)
def test_kv_gather_matches_reference(dtype, P, F, n):
    rng = np.random.RandomState(P + F)
    jpool, pool = _pair(rng.randn(P, F).astype(np.float32), dtype)
    ids = np.random.RandomState(n).permutation(P)[:n]
    got = kv_gather(pool, ids)
    assert got.shape == (n, F) and got.dtype == pool.dtype
    for want in (j_gather(jpool, ids), j_gather_ref(jpool, ids), kv_gather_ref(pool, ids)):
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P,F,n", [(32, 128, 8)] + SWEEP)
def test_kv_scatter_matches_reference(dtype, P, F, n):
    rng = np.random.RandomState(P * 7 + n)
    jpool, pool = _pair(rng.randn(P, F).astype(np.float32), dtype)
    jstaged, staged = _pair(rng.randn(n, F).astype(np.float32), dtype)
    ids = np.random.RandomState(2).permutation(P)[:n]
    before = pool.clone()  # kv_scatter writes into pool: keep the original for the oracles
    ptr = pool.data_ptr()
    got = kv_scatter(pool, staged, ids)
    assert got is pool and got.data_ptr() == ptr
    for want in (j_scatter(jpool + 0, jstaged, ids), j_scatter_ref(jpool, jstaged, ids),
                 kv_scatter_ref(before.clone(), staged, ids)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    rest = np.setdiff1d(np.arange(P), ids)
    assert torch.equal(pool[rest], before[rest])  # pages not named keep their contents


@settings(max_examples=20, deadline=None)
@given(P=st.integers(2, 32), n_frac=st.floats(0.1, 1.0), seed=st.integers(0, 99))
def test_kv_gather_scatter_inverse_property(P, n_frac, seed):
    """scatter(gather(pool, ids), ids) reproduces pool exactly, in place."""
    F = 64
    n = max(1, int(P * n_frac))
    pool = torch.from_numpy(np.random.RandomState(seed).randn(P, F).astype(np.float32))
    want = pool.clone()
    ids = np.random.RandomState(seed).permutation(P)[:n]
    back = kv_scatter(pool, kv_gather(pool, ids), ids)
    assert back is pool and torch.equal(back, want)


def test_kv_gather_scatter_any_dtype_and_edges():
    pool = torch.arange(16 * 129, dtype=torch.int64).remainder(251).to(torch.uint8).view(16, 129)  # odd rows
    ids = np.array([5, 0, 15, 7])
    assert torch.equal(kv_gather(pool, torch.from_numpy(ids)), pool[torch.from_numpy(ids)])
    assert kv_gather(pool, np.zeros(0, np.int32)).shape == (0, 129)
    assert kv_scatter(pool, torch.zeros(0, 129, dtype=torch.uint8), []) is pool
    staged = torch.full((4, 129), 7, dtype=torch.uint8)
    want = pool.clone()
    want[torch.from_numpy(ids)] = 7
    assert torch.equal(kv_scatter(pool, staged, ids.tolist()), want)
    with pytest.raises(ValueError, match="distinct"):
        kv_scatter(pool, staged, [1, 2, 1, 3])
    with pytest.raises(IndexError):
        kv_gather(pool, [0, 16])
    with pytest.raises(IndexError):
        kv_gather(pool, [-1])
    with pytest.raises(ValueError):
        kv_scatter(pool, staged[:3], ids)
    with pytest.raises(TypeError):
        kv_scatter(pool, staged.to(torch.int16), ids)
    with pytest.raises(ValueError):
        kv_gather(pool.t(), [0])


# ---------------------------------------------------------------------------
# PagedPool, op for op against the reference (tests/test_kv_cache.py's cases)
# ---------------------------------------------------------------------------
GEOM = dict(num_pages=16, page_size=4, kv_heads=2, head_dim=8, n_layers=2)
FIG7 = dict(num_pages=1024, page_size=16, kv_heads=4, head_dim=64, n_layers=1)


def _fig7_growth():
    """benchmarks/fig7_kv_migration.py: 16 sequences grown a page at a time, interleaved."""
    ops = [("alloc_seq", s, 16) for s in range(16)]
    ops += [("extend_seq", s, 16) for _ in range(40) for s in range(16)]
    return ops + [("migration_page_ids", list(range(16))), ("block_table_array", list(range(16)))]


POOL_CASES = {
    "fresh": (GEOM, []),
    "zero_token_alloc": (GEOM, [("alloc_seq", 0, 0), ("extend_seq", 0, 1), ("release_seq", 0)]),
    "block_table_array_empty": (GEOM, [("block_table_array", []), ("alloc_seq", 1, 0), ("block_table_array", [1])]),
    "extend_across_page_boundary": (GEOM, [("alloc_seq", 7, 3), ("extend_seq", 7, 1), ("extend_seq", 7, 1)]),
    "release_then_realloc": (GEOM, [("alloc_seq", 1, 8), ("release_seq", 1), ("alloc_seq", 2, 64), ("alloc_seq", 3, 1)]),
    "alloc_failure_leaves_pool_intact": (GEOM, [("alloc_seq", 1, 60), ("extend_seq", 1, 8), ("extend_seq", 1, 4)]),
    "fragmentation_and_migration_ids": (GEOM, [("alloc_seq", 1, 8), ("alloc_seq", 2, 8), ("release_seq", 1),
                                               ("alloc_seq", 3, 12), ("migration_page_ids", [2, 3])]),
    "empty_free_list_is_refilled": (dict(GEOM, free_pages=[]), [("alloc_seq", 0, 5)]),
    "free_list_given_as_list": (dict(GEOM, free_pages=[3, 1, 2]), [("alloc_seq", 0, 9), ("alloc_seq", 1, 4),
                                                                   ("alloc_seq", 1, 0), ("extend_seq", 1, 1)]),
    "fig7_interleaved_growth": (FIG7, _fig7_growth()),
}


def _state(pool):
    live = list(pool.tables)
    return (pool.tables, dict(pool.seq_lens), list(pool.free_pages), pool.fragmentation(),
            pool.block_table_array(live).tolist(), pool.migration_page_ids(live).tolist())


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_paged_pool_matches_reference(case):
    kw, ops = POOL_CASES[case]
    ours = PagedPool(**kw, device="cpu")
    ref = JPagedPool(**kw)
    assert isinstance(ours.free_pages, deque) and ours.k_pages.shape == tuple(ref.k_pages.shape)
    assert ours.page_rows("k").data_ptr() == ours.k_pages.data_ptr()  # a view, not a copy
    assert _state(ours) == _state(ref)
    for name, *args in ops:
        _same(getattr(ours, name)(*args), getattr(ref, name)(*args))
        assert _state(ours) == _state(ref), f"after {name}{tuple(args)}"


# ---------------------------------------------------------------------------
# migrate_pages against the reference's pieces
# ---------------------------------------------------------------------------
SMALL = dict(num_pages=40, page_size=4, kv_heads=2, head_dim=16, n_layers=2)
LENS = {0: 9, 1: 3, 2: 16, 3: 1, 4: 13}  # tokens per sequence


def _fragmented(cls, dtype, **extra):
    """A pool grown the way continuous batching grows one: a token at a time,
    interleaved; sequence 5 is released at the end, so the free list is out
    of page order."""
    pool = cls(**SMALL, dtype=dtype, **extra)
    for s in LENS:
        pool.alloc_seq(s, 1)
    pool.alloc_seq(5, 8)
    for _ in range(16):
        for s, n in LENS.items():
            if pool.seq_lens[s] < n:
                pool.extend_seq(s, 1)
    pool.release_seq(5)
    return pool


def _filled_pair(dtype: str, seed: int, fragmented: bool = True):
    """The same pool, filled with the same values, in both packages: grown
    as ``_fragmented`` does, or fresh (no sequence, stale data in every page)."""
    jd, td = DTYPES[dtype]
    if fragmented:
        jp, tp = _fragmented(JPagedPool, jd), _fragmented(PagedPool, td, device="cpu")
    else:
        jp, tp = JPagedPool(**SMALL, dtype=jd), PagedPool(**SMALL, dtype=td, device="cpu")
    rng = np.random.RandomState(seed)
    for kind in ("k_pages", "v_pages"):
        a, t = _pair(rng.randn(*tp.k_pages.shape).astype(np.float32), dtype)
        setattr(jp, kind, a)
        getattr(tp, kind).copy_(t)
    return jp, tp


def _jax_migrate(jsrc, jdst, seq_ids):
    """The reference's documented composition: migration_page_ids, kv_gather
    into staging, (transfer), kv_scatter into the receiving pool's pages."""
    L, P = jsrc.n_layers, jsrc.num_pages
    for s in seq_ids:
        assert jdst.alloc_seq(s, jsrc.seq_lens[s])

    def rows(ids):  # page p of layer l is row l * P + p of the (L * P, F) view
        return (np.arange(L)[:, None] * P + ids[None, :]).reshape(-1)

    src_rows, dst_rows = rows(jsrc.migration_page_ids(seq_ids)), rows(jdst.migration_page_ids(seq_ids))
    for kind in ("k_pages", "v_pages"):
        shape = getattr(jdst, kind).shape
        staged = j_gather(getattr(jsrc, kind).reshape(L * P, -1), src_rows)
        setattr(jdst, kind, j_scatter(getattr(jdst, kind).reshape(L * P, -1), staged, dst_rows).reshape(shape))
    return jdst.block_table_array(seq_ids)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_migrate_pages_matches_reference_composition(dtype):
    jsrc, src = _filled_pair(dtype, seed=0)
    jdst, dst = _filled_pair(dtype, seed=1, fragmented=False)  # stale data: pages not written keep it
    assert src.fragmentation() > 0.5
    seqs = [2, 0, 4, 1, 3]
    src_before = (src.k_pages.clone(), src.v_pages.clone(), _state(src))
    want_tables = _jax_migrate(jsrc, jdst, seqs)
    tables, seconds = migrate_pages(src, dst, seqs)
    assert seconds >= 0
    np.testing.assert_array_equal(tables, want_tables)
    assert _state(dst) == _state(jdst)
    np.testing.assert_array_equal(_bits(dst.k_pages), _bits(jdst.k_pages))
    np.testing.assert_array_equal(_bits(dst.v_pages), _bits(jdst.v_pages))
    # src is only read
    assert torch.equal(src.k_pages, src_before[0]) and torch.equal(src.v_pages, src_before[1])
    assert _state(src) == src_before[2]


def test_attention_over_migrated_pages():
    """Decode attention over dst with dst's tables: the reference's paged
    kernel (interpret) over src within 2e-5, the port over src bit for bit."""
    jsrc, src = _filled_pair("float32", seed=2)
    dst = PagedPool(**SMALL, device="cpu")
    seqs = list(LENS)
    tables, _ = migrate_pages(src, dst, seqs)
    src_tables = torch.from_numpy(src.block_table_array(seqs))
    lens = torch.tensor([LENS[s] for s in seqs], dtype=torch.int32)
    q = np.random.RandomState(3).randn(len(seqs), 2, 4, 16).astype(np.float32)
    for layer in range(SMALL["n_layers"]):
        got = paged_decode_attention(torch.from_numpy(q), dst.k_pages[layer], dst.v_pages[layer],
                                     torch.from_numpy(tables), lens)
        on_src = paged_decode_attention(torch.from_numpy(q), src.k_pages[layer], src.v_pages[layer], src_tables, lens)
        assert torch.equal(got, on_src)
        want = j_paged(jnp.asarray(q), jsrc.k_pages[layer], jsrc.v_pages[layer], src_tables.numpy(), lens.numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _fail_scatter(monkeypatch):
    calls = []

    def dying(pool, staged, ids):
        calls.append(1)
        if len(calls) == 2:  # K landed, V fails: the abort comes mid-copy
            raise RuntimeError("receiving device lost")
        return kv_scatter(pool, staged, ids)

    monkeypatch.setattr(migration_mod, "kv_scatter", dying)


ABORTS = {
    "dst_too_small": lambda dst, mp: dst.alloc_seq(99, 4 * 36),  # 4 pages left, 13 needed
    "scatter_fails": lambda dst, mp: _fail_scatter(mp),
    "sequence_already_in_dst": lambda dst, mp: dst.alloc_seq(4, 2),
}


@pytest.mark.parametrize("case", list(ABORTS))
def test_migrate_pages_abort_leaves_src_and_dst_free_list(case, monkeypatch):
    _, src = _filled_pair("float32", seed=4)
    dst = PagedPool(**SMALL, device="cpu")
    dst.alloc_seq(50, 5)
    dst.release_seq(50)  # a free list that is not in page order
    ABORTS[case](dst, monkeypatch)
    src_before = (src.k_pages.clone(), src.v_pages.clone(), _state(src))
    dst_before = _state(dst)
    with pytest.raises(MigrationAborted):
        migrate_pages(src, dst, list(LENS))
    assert torch.equal(src.k_pages, src_before[0]) and torch.equal(src.v_pages, src_before[1])
    assert _state(src) == src_before[2]
    assert _state(dst) == dst_before and isinstance(dst.free_pages, deque)


def test_migrate_pages_refuses_other_geometry():
    _, src = _filled_pair("float32", seed=5)
    dst = PagedPool(**dict(SMALL, head_dim=8), device="cpu")
    with pytest.raises(MigrationAborted, match="head_dim"):
        migrate_pages(src, dst, [0])
    assert not dst.tables and list(dst.free_pages) == list(range(SMALL["num_pages"]))


# ---------------------------------------------------------------------------
# kv_migration_bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_seqs,ctx,from_tp,to_tp", [
    (16, 256, 1, 8), (16, 2048, 1, 8), (1, 1, 1, 1), (8, 4096, 2, 4), (32, 1000, 8, 2), (3, 777, 4, 1),
])
def test_kv_migration_bytes_matches_reference(n_seqs, ctx, from_tp, to_tp):
    got = kv_migration_bytes(get_config("llama3-8b"), n_seqs, ctx, from_tp, to_tp)
    assert got == j_kv_migration_bytes(j_get_config("llama3-8b"), n_seqs, ctx, from_tp, to_tp)
    assert got == kv_migration_bytes(get_config("llama3-8b"), n_seqs, ctx, to_tp, from_tp)


def test_kv_migration_bytes_refuses_state_families():
    """The state families count as the reference counts them (they were
    refused until the Mamba slice): an SSM moves each sequence's recurrent
    state whatever the TP levels, a hybrid adds it to each sequence's KV
    before the moved fraction."""
    for name in ("mamba2-2.7b", "jamba-v0.1-52b"):
        for args in ((1, 128, 1, 2), (16, 256, 1, 8), (8, 4096, 4, 2)):
            got = kv_migration_bytes(get_config(name), *args)
            assert got == j_kv_migration_bytes(j_get_config(name), *args) > 0
