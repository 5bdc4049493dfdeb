"""The reference's multi-device checks, run by the port across processes
(mirrors repro/testing/multidev_checks.py).

    PYTHONPATH=src python -m repro_torch.testing.multidev_checks <check|all> <nproc> [cpu|cuda] \
        [--inputs IN.pkl] [--out OUT.pkl] [--model NAME]
    PYTHONPATH=src python -m repro_torch.testing.multidev_checks train_step [cpu|cuda]

A pool check spawns ``nproc`` processes, one rank each (``collectives.
init_pool``: NCCL on cuda:0..nproc-1, gloo when ``cpu`` is given), which
meet through a ``file://`` rendezvous in a temporary directory (no port, so
runs side by side do not collide). Each rank runs the check; the parent
prints one line per check, ``OK <check>: <JSON summary>``, and with
``--out`` pickles every rank's result (summaries and numpy arrays) for a
caller that holds them against the reference. ``--inputs`` is a pickle of
numpy arrays (weights as the reference's trees, carried by
``checkpoint.convert``; tokens, activations) that replace the check's own
seeded draws.

weight_store — the paper's §3.2.1 invariant: the same storage serves TP
    1/2/4/8 with logits within 2e-4 of TP 1, and a rebind is zero-copy on
    every card (every bound view lies in this card's storage, whose
    data_ptrs do not change).
moe_sharded — the sharded MoE path on a (data 2, model 2) mesh, with the
    real all-to-all, against ``moe_apply_local``: y within 5e-4, the
    load-balancing loss within 5e-2 relative of the local path's (reduced
    moonshot), or, with ``lb_held_to`` "sharded loop" in its inputs (at
    full routing width), within 1e-4 of the one-process sharded loop's.
migration — the slot cache resharded TP 1 -> 2 -> 4 -> 1 across the
    ranks: every block bit-identical (the tiny dense model's K/V, or with
    ``--model`` a reduced config's, e.g. jamba's K/V, Mamba states and conv
    tails); and ``migrate_pages`` from rank 0's pool to rank 1's, pages
    bit-identical.
collectives — the pool's all-reduce, all-gather, all-to-all and uneven
    exchange over every TP level's groups against one process's sums and
    joins of every rank's tensors.
fault_abort — the reference's three parts: a switch whose migration
    fails on one rank rolls back on every rank (then serves the reference
    logits, and a retry succeeds); a reshard that fails on one rank raises
    on every rank and leaves every source block intact; a weight reload on
    a shrunken pool (``WeightStore.shrink`` over ``Pool.shrink``): half the
    ranks survive, rebuild their positions from the canonical weights and
    serve at TP 2 within 2e-4 of the TP 1 logits of the whole pool.
engine — the reference's check_engine: greedy trajectories under the
    switch schedule {3: 2, 7: 4, 13: 1, 19: 2} equal to fixed TP 1, no
    storage data_ptr moved; on the reference's tiny dense model, or with
    ``--model`` on a reduced config of the port (moonshot-v1-16b-a3b,
    jamba-v0.1-52b: ``engine_cfg``); an MoE model's drops per (TP level,
    stage) reported.
train_step — one process: a (data 2 x model 2) train step with ZeRO-1
    moments equals a single-rank step over 5 steps of reduced
    h2o-danube-1.8b, at the reference's tolerances (losses within 2e-4
    relative, params at rtol 5e-3, atol 5e-4). The two data groups run one
    after another and the two TP ranks read their shards of the same
    tensors.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import forward, init_cache_defs, logits_for, model_param_defs
from repro_torch.models.params import init_params, tree_leaves_with_path, tree_map
from repro_torch.parallel.collectives import Pool, all_gather, close_pool, init_pool, rendezvous_file
from repro_torch.parallel.sharding import ShardView, make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
LOGIT_TOL = 2e-4  # the reference's across TP levels (f32)
MOE_TOL, LB_RTOL = 5e-4, 5e-2
SHARDED_LB_RTOL = 1e-4  # the same blocks' lb across processes and in one: f32 rounding of the router's product
SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}


def tiny_cfg() -> ModelConfig:
    """The reference's ``_tiny_cfg``: 8 heads, 2 KV heads."""
    return ModelConfig(name="tiny-dense", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))


def serve_cfg() -> ModelConfig:
    """check_engine's model: 8 heads, 8 KV heads."""
    return ModelConfig(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
                       head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))


def engine_requests(cls):
    rng = np.random.RandomState(0)
    return [cls(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(10)]


def _weights(inputs: Optional[dict], key: str, defs: dict, dev: torch.device) -> dict:
    """The reference's weights from ``inputs``, or drawn from seed 0 on this
    rank's device (every rank draws the same)."""
    if inputs is not None and key in inputs:
        from repro_torch.checkpoint.convert import to_torch

        return to_torch(inputs[key], dev)
    return init_params(defs, torch.Generator(dev).manual_seed(0), torch.float32)


def _array(inputs: Optional[dict], key: str, make) -> np.ndarray:
    return np.asarray(inputs[key]) if inputs is not None and key in inputs else make()


def _storage_ptrs(storage: dict) -> List[int]:
    return sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(storage) for t in per_pos if t is not None)


def _views(bound) -> List[ShardView]:
    if isinstance(bound, ShardView):
        return [bound]
    if isinstance(bound, dict):
        return [v for x in bound.values() for v in _views(x)]
    if isinstance(bound, (list, tuple)):
        return [v for x in bound for v in _views(x)]
    return []


def _prefill_logits(pool: Pool, cfg: ModelConfig, bound: dict, tp: int, tokens: torch.Tensor) -> torch.Tensor:
    """The reference's serve step: prefill logits of ``tokens`` (B, S) at TP
    ``tp``, the batch split over the data groups as P("data", None), the
    groups' logits gathered."""
    lv = pool.level(tp)
    n = tokens.shape[0] // lv.dp
    rows = tokens[lv.data_rank * n:(lv.data_rank + 1) * n]
    h, _ = forward(bound, cfg, make_exec_config(cfg, tp), tokens=rows, mode="prefill", block_q=16, block_k=16)
    return all_gather(logits_for(bound, cfg, h)[..., : cfg.vocab_size], lv.data, 0)


def _close(a: torch.Tensor, b: torch.Tensor, tol: float, what: str) -> float:
    diff = float((a.double() - b.double()).abs().max())
    if not torch.allclose(a, b, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: differs by {diff} (tolerance {tol})")
    return diff


# ---------------------------------------------------------------------------
# the pool checks: each runs on every rank and returns {"summary": ..., "arrays": ...}
# ---------------------------------------------------------------------------
def check_weight_store(pool: Pool, inputs: Optional[dict] = None) -> dict:
    from repro_torch.core.weight_store import WeightStore

    cfg, dev = tiny_cfg(), pool.device
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    params = _weights(inputs, "params", defs, dev)
    tokens = torch.from_numpy(_array(inputs, "tokens", lambda: np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(8, 16)))).long().to(dev)
    store = WeightStore(cfg, defs, pool.devices, storage_tp=1, pool=pool)
    storage = store.build(params)
    ptrs = _storage_ptrs(storage)
    tps = [t for t in (1, 2, 4, 8) if t <= pool.world and pool.world % t == 0]
    outs = {tp: _prefill_logits(pool, cfg, store.rebind(storage, tp), tp, tokens) for tp in tps}
    diffs = {tp: _close(outs[tp], outs[tps[0]], LOGIT_TOL, f"TP {tp} logits against TP {tps[0]}") for tp in tps[1:]}
    # zero-copy rebind: every bound view lies in this card's storage, whose tensors stay where they were
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for _, per_pos in tree_leaves_with_path(storage) for t in per_pos if t is not None]
    t0 = time.perf_counter()
    rebound = store.rebind(storage, tps[-1])
    rebind_s = time.perf_counter() - t0
    views = _views(rebound)
    if not all(any(lo <= m.data_ptr() < hi for lo, hi in spans) for v in views for m in v.mats):
        raise AssertionError("rebind made a tensor outside the storage")
    if _storage_ptrs(storage) != ptrs:
        raise AssertionError("rebind moved a storage tensor")
    post = _close(_prefill_logits(pool, cfg, rebound, tps[-1], tokens), outs[tps[0]], LOGIT_TOL, "post-rebind")
    return {"summary": {"tps": tps, "max_diff_vs_tp1": {str(k): v for k, v in diffs.items()},
                        "rebind_ms": rebind_s * 1e3, "views": len(views), "storage_tensors": len(ptrs),
                        "post_rebind_diff": post, "zero_copy": True},
            "arrays": {"logits": {tp: o.cpu().numpy() for tp, o in outs.items()}}}


def check_moe_sharded(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """TP 2 over the pool (world 4: data 2 x model 2) of the reference's
    reduced moonshot-v1-16b-a3b (capacity factor 8: nothing drops, so the
    paths' capacities do not matter), or of ``inputs["full_width"]``, a
    config taken unreduced, with ``inputs["moe"]``'s MoESpec fields (e.g.
    moonshot's routing at full width with a narrow ``d_ff_expert``).
    ``inputs["lb_held_to"]`` says what the load-balancing loss is held to:
    "local" (default), the local path's within LB_RTOL; or "sharded loop",
    the port's one-process sharded loop over the same blocks
    (``moe_apply_sharded`` over 4 ranks in this process) within
    SHARDED_LB_RTOL. A block's lb is its own estimate of the global
    statistic, so the sharded lb is the blocks' mean, not the local path's
    (8-token blocks over 64 experts: ~20% apart, as the reference's own
    sharded path gives)."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models.moe import moe_apply_local, moe_apply_sharded, moe_param_defs

    inputs = inputs or {}
    held_to = inputs.get("lb_held_to", "local")
    if held_to not in ("local", "sharded loop"):
        raise ValueError(f"lb_held_to {held_to!r}: 'local' or 'sharded loop'")
    cfg = get_config(inputs["full_width"]) if "full_width" in inputs else reduced(get_config("moonshot-v1-16b-a3b"))
    cfg = replace(cfg, moe=replace(cfg.moe, **inputs.get("moe", {})))
    dev, tp = pool.device, 2
    defs = moe_param_defs(cfg)
    params = _weights(inputs, "params", defs, dev)
    x = torch.from_numpy(_array(inputs, "x", lambda: np.random.RandomState(1).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32))).to(dev)
    one = WeightStore(cfg, defs, [dev])  # the local oracle: one rank, in this process
    y_local, aux_local = moe_apply_local(one.rebind(one.build(params), 1), x, cfg)
    store = WeightStore(cfg, defs, pool.devices, pool=pool)
    bound = store.rebind(store.build(params), tp)
    lv = pool.level(tp)
    n = x.shape[0] // lv.dp
    t0 = time.perf_counter()
    y, aux = moe_apply_sharded(bound, x[lv.data_rank * n:(lv.data_rank + 1) * n], cfg, pool.world)
    y = all_gather(y, lv.data, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    diff = _close(y, y_local, MOE_TOL, "moe_sharded y against moe_apply_local")
    lb, lb_local = float(aux["lb"]), float(aux_local["lb"])
    summary = {"mesh": {"data": lv.dp, "model": lv.tp}, "max_abs_diff": diff, "lb": lb, "lb_local": lb_local,
               "lb_held_to": held_to, "path_s": seconds, "d_model": cfg.d_model, "experts": cfg.moe.num_experts,
               "block_tokens": x.shape[0] // lv.dp * x.shape[1] // tp}
    want, rtol = lb_local, LB_RTOL
    if held_to == "sharded loop":
        four = WeightStore(cfg, defs, [dev] * pool.world)  # the one-process sharded loop: every rank here
        _, aux_loop = moe_apply_sharded(four.rebind(four.build(params), tp), x, cfg, pool.world)
        want = summary["lb_one_process_sharded"] = float(aux_loop["lb"])
        rtol = SHARDED_LB_RTOL
    if not abs(lb - want) <= rtol * abs(want):
        raise AssertionError(f"moe_sharded lb {lb} against the {held_to} path's {want}")
    return {"summary": summary, "arrays": {"y": y.cpu().numpy(), "lb": lb}}


def _full_cache(defs: List[dict], dev: torch.device) -> List[dict]:
    """Recognisable contents: every leaf's elements numbered (exact in f32)."""
    return [{k: torch.arange(int(np.prod(d.shape)), dtype=torch.float32, device=dev).view(d.shape) + 1e5 * i
             for k, d in layer.items()} for i, layer in enumerate(defs)]


def _blocks(full: List[dict], layout, rank: int) -> List[dict]:
    return [{k: t[tuple(slice(lo, hi) for lo, hi in layout.block(rank, d))].clone() for (k, t), d in
             zip(layer.items(), dlayer.values())} for layer, dlayer in zip(full, layout.defs)]


def check_migration(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """``inputs["model"]``: the cache of ``engine_cfg(model)`` (e.g. reduced
    jamba: K/V and each Mamba layer's state and conv tail) in place of the
    tiny dense model's."""
    from repro_torch.core.migration import cache_shardings, migrate_cache, migrate_pages, moved_bytes

    model = (inputs or {}).get("model")
    cfg, dev = (tiny_cfg() if model is None else engine_cfg(model)), pool.device
    defs = init_cache_defs(cfg, make_exec_config(cfg, 4), 8, 32)  # KV heads re-expanded to 4
    full = _full_cache(defs, dev)
    path = [t for t in (1, 2, 4, 1) if pool.world % t == 0]
    layout = cache_shardings(defs, pool.world, path[0])
    cache = _blocks(full, layout, pool.rank)
    steps = []
    for tp in path[1:]:
        target = cache_shardings(defs, pool.world, tp)
        before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        moved, seconds = migrate_cache(cache, target, source=layout, pool=pool)
        for got, want in zip(moved, _blocks(full, target, pool.rank)):
            for k in got:
                if not torch.equal(got[k], want[k]):
                    raise AssertionError(f"TP {layout.tp} -> {tp}: {k} block changed")
        if any(not torch.equal(a[k], b[k]) for a, b in zip(cache, before) for k in a):
            raise AssertionError("the reshard wrote its source")
        steps.append({"from": layout.tp, "to": tp, "ms": seconds * 1e3, "bytes_between_ranks": moved_bytes(layout, target, 4),
                      "blocks": {k: list(t.shape) for layer in moved for k, t in layer.items()}})  # a shape per kind
        cache, layout = moved, target
    return {"summary": {"reshards": steps, "pages": _pages_between_ranks(pool, migrate_pages)}, "arrays": {}}


def _page_pools(pool: Pool, src_rank: int, dst_rank: int, n_layers=2, heads=2, hd=8, page=4, dtype=torch.float32):
    """A fragmented source pool on ``src_rank`` and a destination pool on
    ``dst_rank``; on every other rank (and for the pool a rank does not own)
    the bookkeeping alone, on the meta device. Contents: every element of the
    source numbered (exact in f32; in bf16 up to 256)."""
    from repro_torch.serving.kv_cache import PagedPool

    def make(owner):
        return PagedPool(num_pages=48, page_size=page, kv_heads=heads, head_dim=hd, n_layers=n_layers, dtype=dtype,
                         device=pool.device if pool.rank == owner else "meta")

    src, dst = make(src_rank), make(dst_rank)
    for s in range(4):
        src.alloc_seq(s, 3)
    for _ in range(3):  # interleaved growth: every sequence's pages are fragmented
        for s in range(4):
            src.extend_seq(s, 4)
    dst.alloc_seq(99, 9)  # the destination's pages are not the source's
    return src, dst


def _numbered(p, dev) -> tuple:
    n = p.k_pages.numel()
    k = (torch.arange(n, device=dev) % 4096).to(p.dtype).view(p.k_pages.shape)
    return k, (k + 1)


def _pages_between_ranks(pool: Pool, migrate_pages, src_rank: int = 0, dst_rank: int = 1) -> dict:
    """migrate_pages from ``src_rank``'s pool to ``dst_rank``'s; the
    destination checks every moved page bit for bit against the source's
    numbered contents (which it can make itself)."""
    src, dst = _page_pools(pool, src_rank, dst_rank)
    if pool.rank == src_rank:
        src.k_pages.copy_(_numbered(src, pool.device)[0])
        src.v_pages.copy_(_numbered(src, pool.device)[1])
    seqs = [0, 1, 2, 3]
    if pool.rank not in (src_rank, dst_rank):
        return {}
    tables, seconds = migrate_pages(src, dst, seqs, ranks=(src_rank, dst_rank))
    out = {"seqs": len(seqs), "pages": int(sum(len(src.tables[s]) for s in seqs)), "ms": seconds * 1e3,
           "fragmentation": src.fragmentation()}
    if pool.rank == dst_rank:
        want_k, want_v = _numbered(src, pool.device)
        for s, row in zip(seqs, tables):
            for a, b in zip(src.tables[s], row):
                for got, want in ((dst.k_pages, want_k), (dst.v_pages, want_v)):
                    if not torch.equal(got[:, b], want[:, a]):
                        raise AssertionError(f"sequence {s}: page {a} -> {b} differs")
        out["bit_identical"] = True
    return out


def check_fault_abort(pool: Pool, inputs: Optional[dict] = None) -> dict:
    from repro_torch.core.migration import MigrationAborted, cache_shardings, migrate_cache
    from repro_torch.core.tp_switch import SwitchAborted, TPSwitchController
    from repro_torch.core.weight_store import WeightStore

    cfg, dev = tiny_cfg(), pool.device
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    params = _weights(inputs, "params", defs, dev)
    tokens = torch.from_numpy(_array(inputs, "tokens", lambda: np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(8, 16)))).long().to(dev)
    store = WeightStore(cfg, defs, pool.devices, storage_tp=1, pool=pool)
    tps = [t for t in (1, 2, 4) if pool.world % t == 0]
    ctl = TPSwitchController(store, tps)
    ctl.install(params, 1)
    ref = _prefill_logits(pool, cfg, ctl.params, 1, tokens)
    cdefs = init_cache_defs(cfg, make_exec_config(cfg, max(tps)), 8, 32)
    full = _full_cache(cdefs, dev)
    src_layout = cache_shardings(cdefs, pool.world, 1)
    cache = _blocks(full, src_layout, pool.rank)
    failing = 1 % pool.world

    # 1. a switch whose migration fails on one rank: every rank rolls back
    def dying_migrate(to_tp):
        target = object() if pool.rank == failing else cache_shardings(cdefs, pool.world, to_tp)
        return migrate_cache(cache, target, source=src_layout, pool=pool)

    storage_before, params_before = ctl.storage, ctl.params
    try:
        ctl.switch(2, migrate_fn=dying_migrate)
        raise AssertionError("switch did not abort")
    except SwitchAborted:
        pass
    if not (ctl.current_tp == 1 and ctl.storage is storage_before and ctl.params is params_before):
        raise AssertionError("the aborted switch did not roll back")
    if not (ctl.stats.n_aborts == 1 and ctl.stats.n_switches == 0):
        raise AssertionError(f"stats after the abort: {ctl.stats}")
    rolled = _close(_prefill_logits(pool, cfg, ctl.params, 1, tokens), ref, LOGIT_TOL, "rolled back")
    moved = ctl.switch(2, migrate_fn=lambda t: migrate_cache(cache, cache_shardings(cdefs, pool.world, t),
                                                             source=src_layout, pool=pool))  # the retry
    if not (ctl.current_tp == 2 and ctl.stats.n_switches == 1):
        raise AssertionError("the retry did not switch")
    for got, want in zip(moved, _blocks(full, cache_shardings(cdefs, pool.world, 2), pool.rank)):
        if any(not torch.equal(got[k], want[k]) for k in got):
            raise AssertionError("the retried reshard changed the cache")

    # 2. a reshard that dies on one rank (its target buffers are wrong): every source intact
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    target = cache_shardings(cdefs, pool.world, 4 if 4 in tps else tps[-1])
    into = None
    if pool.rank == failing:
        into = [{k: torch.empty(1, device=dev) for k in layer} for layer in cdefs]
    try:
        migrate_cache(cache, target, source=src_layout, pool=pool, into=into)
        raise AssertionError("migration did not abort")
    except MigrationAborted:
        pass
    if any(not torch.equal(a[k], b[k]) for a, b in zip(cache, before) for k in a):
        raise AssertionError("the aborted reshard touched its source")

    # 3. weight reload on a shrunken pool (half the pool lost): the survivors rebuild their positions from the
    # canonical weights and serve at TP 2; the others leave and wait at the end
    survivors = list(range(pool.world // 2))
    t0 = time.perf_counter()
    small = store.shrink(survivors)
    shrunk = {"survivors": len(survivors), "left": small is None}
    arrays = {}
    if small is not None:
        reloaded = small.build(params)  # the reload storm
        shrink_s = time.perf_counter() - t0
        tp = min(2, small.N)
        logits = _prefill_logits(small.pool, cfg, small.rebind(reloaded, tp), tp, tokens)
        shrunk.update(pool=small.N, tp=tp, storage_tp=small.s, bytes_per_device=small.bytes_per_device(4),
                      shrink_and_reload_s=shrink_s,
                      diff=_close(logits, ref, LOGIT_TOL, f"shrunken pool of {small.N} at TP {tp}"))
        arrays["shrunk_logits"] = logits.cpu().numpy()
        del reloaded, small
    pool.barrier()  # the leavers wait here for the survivors
    return {"summary": {"rolled_back": True, "rolled_back_diff": rolled, "retry_switched": True,
                        "source_cache_intact": True, "failing_rank": failing, "shrunk": shrunk}, "arrays": arrays}


def engine_cfg(model: Optional[str] = None, capacity_factor: Optional[float] = None) -> ModelConfig:
    """check_engine's model: the reference's tiny dense one (``serve_cfg``),
    or a config of the port by name reduced with ``reduced()`` and given 4
    KV heads (so that the engine takes TP 4), as the port's CPU tests serve
    moonshot-v1-16b-a3b and jamba-v0.1-52b; ``capacity_factor`` replaces
    an MoE model's."""
    if model is None:
        return serve_cfg()
    cfg = replace(reduced(get_config(model)), num_kv_heads=4)
    if capacity_factor is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=capacity_factor))
    return cfg


def engine_params(cfg: ModelConfig, dev: torch.device, inputs: Optional[dict] = None) -> dict:
    """check_engine's weights: the reference's (``inputs["params"]``), or
    drawn from seed 0 on ``dev`` from ``multicard.weight_defs`` (jamba at
    each layer's own fan-in, where reduced jamba is well conditioned in
    f32), as the full-width legs draw them."""
    from repro_torch.testing.multicard import weight_defs

    return _weights(inputs, "params", weight_defs(cfg), dev)


def _engine_case(pool: Pool, inputs: dict) -> dict:
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    cfg, dev = engine_cfg(inputs.get("model"), inputs.get("capacity_factor")), pool.device
    params = engine_params(cfg, dev, inputs)
    kw = dict(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32), record_logits=True)
    econf = EngineConfig(**{**kw, **inputs.get("engine", {})}, dtype=torch.float32)

    def requests():
        if "requests" not in inputs:
            return engine_requests(Request)
        return [Request(i, "strict", np.asarray(prompt, np.int32), n) for i, (prompt, n) in enumerate(inputs["requests"])]

    def run(schedule):
        eng = ServingEngine(cfg, params, econf, pool=pool)
        warm = eng.warmup()
        ptrs = _storage_ptrs(eng.storage)
        done = eng.run(requests(), switch_schedule=schedule)
        if _storage_ptrs(eng.storage) != ptrs:
            raise AssertionError("a switch moved a storage tensor")
        return eng, warm, done  # one engine's graphs at a time: the caller drops it before the next

    fixed = inputs.get("fixed", True)
    base, logits_fixed, dropped = None, None, {}
    if fixed:
        eng, _, done = run(None)
        base = {r.req_id: list(r.generated) for r in done}
        logits_fixed = {k: np.stack(v) for k, v in eng.logit_trace.items()}
        dropped["fixed"] = eng.moe_dropped()
        del eng
    schedule = {k: v for k, v in inputs.get("schedule", SCHEDULE).items()
                if v in econf.candidate_tps and pool.world % v == 0}  # the levels this pool runs
    eng_b, warm, done = run(schedule)
    st = eng_b.stats
    if st.switches < sum(1 for a, b in zip([1] + list(schedule.values()), schedule.values()) if a != b):
        raise AssertionError(f"{st.switches} switches of {schedule}")
    dropped["switched"] = eng_b.moe_dropped()
    if base is not None:
        changed = [r.req_id for r in done if base[r.req_id] != list(r.generated)]
        if changed:
            rid = changed[0]
            got = next(list(r.generated) for r in done if r.req_id == rid)
            i = next(j for j, (a, b) in enumerate(zip(got, base[rid])) if a != b)
            top = np.sort(logits_fixed[rid][i])[-2:]
            raise AssertionError(f"trajectories changed across TP switches for requests {changed}; request {rid} "
                                 f"step {i}: {got[i]} for {base[rid][i]}, fixed-TP top-2 margin {top[1] - top[0]}")
    arrays = {"trajectories": {r.req_id: list(r.generated) for r in done},
              "logits_switched": {k: np.stack(v) for k, v in eng_b.logit_trace.items()},
              "moe_dropped": {run: {f"{tp}/{stage}": n for (tp, stage), n in d.items()} for run, d in dropped.items()}}
    if logits_fixed is not None:
        arrays["logits_fixed"] = logits_fixed
    summary = {"model": cfg.name, "requests": len(done), "switches": st.switches, "steps": st.steps,
               "warmup_s": warm, "rebind_ms_total": st.rebind_s * 1e3, "migrate_ms_total": st.migrate_s * 1e3,
               "tps": eng_b.tps, "graphs": eng_b.cache.graphs(), "moe_dropped": arrays["moe_dropped"]}
    return {"summary": summary, "arrays": arrays}


def check_engine(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """One engine case, or each of ``inputs["cases"]`` ({name: inputs}) in
    turn. A case's inputs (all optional): "model" and "capacity_factor"
    (``engine_cfg``), "params" (the reference's tree), "engine"
    (EngineConfig fields over check_engine's own), "requests" ([(prompt,
    new tokens)], default ``engine_requests``), "schedule" (default
    SCHEDULE; the levels the pool does not divide left out) and "fixed"
    (default True: also serve at fixed TP 1 and require the same
    trajectories; False where the reference's own trajectory may change
    with the TP level, an MoE model at a capacity factor that drops)."""
    inputs = inputs or {}
    if "cases" not in inputs:
        return _engine_case(pool, inputs)
    out = {name: _engine_case(pool, case) for name, case in inputs["cases"].items()}
    return {"summary": {name: r["summary"] for name, r in out.items()},
            "arrays": {name: r["arrays"] for name, r in out.items()}}


def check_collectives(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The pool's collectives against what one process computes from every
    rank's tensors: the all-reduce of row-parallel partials (exact on
    integer-valued floats, within 1e-5 relative on random f32, whose sum
    order differs), the all-gather of vocab shards, the all-to-all of MoE
    dispatch and the uneven exchange of a reshard (exact), at every TP level
    over its model groups."""
    from repro_torch.parallel.collectives import all_to_all, exchange, gather_ranks, reduce_ranks

    dev, world, out = pool.device, pool.world, {}

    def part(rank: int, salt: int, shape=(3, 40)) -> torch.Tensor:
        g = torch.Generator().manual_seed(1000 * salt + rank)
        return torch.randn(shape, generator=g).to(dev)

    for tp, lv in sorted(pool.levels.items()):
        ranks = lv.model.ranks
        ints = [part(r, 1).round() for r in ranks]
        whole = ints[0].clone()
        for x in ints[1:]:
            whole = whole + x
        if not torch.equal(reduce_ranks([ints[lv.model.index].clone()], lv, tp), whole):
            raise AssertionError(f"TP {tp}: all-reduce of integer partials")
        rnd = [part(r, 2) for r in ranks]
        want = rnd[0].clone()
        for x in rnd[1:]:
            want = want + x
        err = _close(reduce_ranks([rnd[lv.model.index].clone()], lv, tp), want, 1e-5, f"TP {tp}: all-reduce")
        cols = [part(r, 3) for r in ranks]
        if not torch.equal(gather_ranks([cols[lv.model.index]], lv, -1), torch.cat(cols, -1)):
            raise AssertionError(f"TP {tp}: all-gather of vocab shards")
        sent = [part(r, 4, (tp, 2, 5)) for r in ranks]  # chunk k for member k
        got = all_to_all(sent[lv.model.index], lv.model)
        if not torch.equal(got, torch.stack([s[lv.model.index] for s in sent])):
            raise AssertionError(f"TP {tp}: all-to-all")
        out[str(tp)] = {"model_group": list(ranks), "allreduce_max_abs_err": err}
    me = pool.rank
    sizes = [[(a + 2 * b) % 5 for b in range(world)] for a in range(world)]  # [sender][receiver] elements
    send = [torch.full((sizes[me][b],), float(100 * me + b), device=dev) for b in range(world)]
    got = exchange(send, pool.world_group, [sizes[a][me] for a in range(world)])
    if any(not torch.equal(g, torch.full((sizes[a][me],), float(100 * a + me), device=dev)) for a, g in enumerate(got)):
        raise AssertionError("uneven exchange")
    return {"summary": {"levels": out, "backend": pool.backend}, "arrays": {}}


POOL_CHECKS = {
    "collectives": (check_collectives, 4),
    "weight_store": (check_weight_store, 8),
    "moe_sharded": (check_moe_sharded, 4),
    "migration": (check_migration, 8),
    "fault_abort": (check_fault_abort, 8),
    "engine": (check_engine, 4),
}
MODEL_CHECKS = ("engine", "migration")  # the checks ``--model`` gives a reduced config (``engine_cfg``)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def check_train_step(device=None, steps: int = 5) -> dict:
    """Sharded (data x model) train step == single-rank train step, with
    ZeRO-1 sharded optimizer state and f32 numerics. Returns the losses and
    the worst parameter difference; raises if a tolerance is missed."""
    dev = resolve_device(device)
    cfg = reduced(get_config("h2o-danube-1.8b"))
    ec1 = make_exec_config(cfg, 1)
    params0 = init_params(model_param_defs(cfg, ec1), torch.Generator(dev).manual_seed(0), torch.float32)
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=1e-3), seq_chunk=16, block_q=16, block_k=16)
    ds = SyntheticDataset(cfg, batch=4, seq=32)

    def run(ec, dp):
        p = tree_map(lambda t: t.detach().clone(), params0)
        step, plan = make_train_step(cfg, ec, p, tcfg, dp=dp)
        o = init_opt_state(p, tcfg, plan if dp > 1 else None)
        losses = [float(step(p, o, ds.at(i))[2]["loss"]) for i in range(steps)]
        return p, losses, plan

    ref_params, losses_ref, _ = run(ec1, 1)
    # exec kv == canonical (kv=2 >= tp=2) so the params carry over directly
    params, losses_sh, plan = run(make_exec_config(cfg, 2), 2)
    for a, b in zip(losses_ref, losses_sh):
        if not abs(a - b) / abs(a) < LOSS_RTOL:
            raise AssertionError(f"train_step: losses differ: {losses_ref} vs {losses_sh}")
    worst = 0.0
    for (path, a), (_, b) in zip(tree_leaves_with_path(ref_params), tree_leaves_with_path(params)):
        a, b = a.detach().double(), b.detach().double()
        if not torch.allclose(a, b, **PARAM_TOL):
            raise AssertionError(f"train_step: {'/'.join(path)} differs by {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    split = sum(d is not None for d in plan.dims.values())
    return {"losses_single": losses_ref, "losses_sharded": losses_sh, "max_param_diff": worst,
            "zero1_split_leaves": split, "leaves": len(plan.dims)}


CHECKS = {"train_step": check_train_step}


# ---------------------------------------------------------------------------
# spawning the pool
# ---------------------------------------------------------------------------
def _worker(rank: int, world: int, device: str, names: List[str], workdir: str, task: Optional[str]) -> None:
    torch.set_num_threads(1)
    try:
        inputs = None
        if os.path.exists(os.path.join(workdir, "inputs.pkl")):
            with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
                inputs = pickle.load(f)
        pool = init_pool(world, rank, device, tps=(1, 2, 4, 8), init_method=rendezvous_file(workdir))
        if task is not None:  # a function given as "module:name", called with the pool
            module, name = task.split(":")
            __import__(module)
            results = {task: getattr(sys.modules[module], name)(pool, inputs)}
        else:
            results = {n: POOL_CHECKS[n][0](pool, None if inputs is None else inputs.get(n)) for n in names}
        with open(os.path.join(workdir, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        close_pool()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)  # not through the process group's teardown, which would wait for the other ranks


def spawn(world: int, device: str, names: List[str] = (), inputs: Optional[dict] = None,
          task: Optional[str] = None, timeout: float = 600.0) -> List[dict]:
    """Run checks ``names`` (or ``task``, "module:function", called as
    function(pool, inputs)) on a pool of ``world`` spawned processes; returns
    each rank's {check: result}. Raises, with every failing rank's
    traceback, if a rank fails or the pool outlasts ``timeout``; a rank left
    waiting in a collective is then stopped."""
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} cards, {torch.cuda.device_count()} found")
        _build.build_all()  # once, here, not in every rank at first use
    workdir = tempfile.mkdtemp(prefix="pool-")
    try:
        if inputs is not None:
            with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
                pickle.dump(inputs, f)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker, args=(r, world, device, list(names), workdir, task)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout

        def failed() -> bool:
            return (any(p.exitcode not in (None, 0) for p in procs)
                    or any(os.path.exists(os.path.join(workdir, f"err{r}.txt")) for r in range(world)))

        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if failed():  # one rank failed: the others may wait for it in a collective; give them a moment
                time.sleep(5)
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        errors = []
        for r in range(world):
            path = os.path.join(workdir, f"err{r}.txt")
            if os.path.exists(path):
                errors.append(f"rank {r}:\n{open(path).read()}")
        if errors or any(p.exitcode != 0 for p in procs):
            codes = [p.exitcode for p in procs]
            raise RuntimeError(f"pool of {world} failed (exit codes {codes}):\n" + "\n".join(errors))
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    name = argv[0]
    if name in CHECKS:
        out = CHECKS[name](argv[1] if len(argv) > 1 else None)
        print(f"OK {name}: {out}")
        return 0
    opts: Dict[str, str] = {}
    for flag in ("--inputs", "--out", "--model"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    names = list(POOL_CHECKS) if name == "all" else [name]
    world = int(argv[1]) if len(argv) > 1 else POOL_CHECKS[names[0]][1]
    device = argv[2] if len(argv) > 2 else "cuda"
    inputs = None
    if "--inputs" in opts:
        with open(opts["--inputs"], "rb") as f:
            inputs = pickle.load(f)
    if "--model" in opts:  # the reduced model of check_engine and check_migration (engine_cfg)
        takes = [n for n in names if n in MODEL_CHECKS]
        if not takes:
            raise SystemExit(f"--model applies to {', '.join(MODEL_CHECKS)} only")
        inputs = inputs or {}
        for n in takes:
            inputs.setdefault(n, {})["model"] = opts["--model"]
    t0 = time.perf_counter()
    results = spawn(world, device, names, inputs)
    for n in names:
        print(f"OK {n}: {json.dumps({'world': world, 'device': device, 'rank0': results[0][n]['summary']})}")
    print(f"pool of {world} on {device}: {time.perf_counter() - t0:.1f} s for {', '.join(names)}")
    if "--out" in opts:
        with open(opts["--out"], "wb") as f:
            pickle.dump(results, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
