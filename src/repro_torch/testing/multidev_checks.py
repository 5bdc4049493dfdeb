"""The reference's multi-device checks, run by the port across processes
(mirrors repro/testing/multidev_checks.py).

    PYTHONPATH=src python -m repro_torch.testing.multidev_checks <check[,check...]|all> <nproc> [cpu|cuda] \
        [--inputs IN.pkl] [--out OUT.pkl] [--model NAME]
    PYTHONPATH=src python -m repro_torch.testing.multidev_checks train_step [cpu|cuda]

A pool check spawns ``nproc`` processes, one rank each (``collectives.
init_pool``: NCCL on cuda:0..nproc-1, gloo when ``cpu`` is given), which
meet through a ``file://`` rendezvous in a temporary directory (no port, so
runs side by side do not collide). Each rank runs the check; the parent
prints one line per check (several, comma-separated, run in one pool),
``OK <check>: <JSON summary>``, and with
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
    ``--model`` on a reduced config of the port (``engine_cfg``: e.g.
    moonshot-v1-16b-a3b, jamba-v0.1-52b, or yi-34b at G 7 and dbrx-132b's
    16 experts, top 4, by ENGINE_FIELDS); an MoE model's drops per (TP
    level, stage) reported.
train_step — the reference's check_train_step across processes: reduced
    h2o-danube-1.8b at (data N/2 x model 2), each rank holding its model
    shard of the weights and its data rank's ZeRO-1 slice of the moments,
    equals a single-rank step over 5 steps at the reference's tolerances
    (losses within 2e-4 relative, params at rtol 5e-3, atol 5e-4); after
    every step the parameters bit-equal across each data group and the
    replicated leaves across each model group. With ``--inputs``: the
    reference's weights, more cases (accumulation, compression) and the
    elastic checkpoint (cut at step 3, resumed at data N x model 1).
train_grads — the collectives under autograd at TP 2: a vocab-parallel
    embedding, two norms before column -> row MLPs and the tied head,
    every gradient within 1e-6 of the one-process TP 2 ranks'; each
    autograd collective alone (all_to_all, reduce_shared, gather_summed,
    pool_mean) and the MoE and Mamba layers through them against one
    process holding every rank's inputs.
train_moe — the MoE and Mamba families trained across processes: reduced
    moonshot-v1-16b-a3b at (data 2, model 2), (4, 1) and (1, 4), reduced
    jamba-v0.1-52b and mamba2-2.7b at (2, 2), each held by rank 0 to the
    one-process step at its layout (gradients of batch 0, losses,
    parameters), the replication checked after every step. With
    ``--inputs``: the reference's weights, and rank 0's gathered gradients
    and parameters for a caller that holds them to the reference's mesh.
train_rules — the train step under the reference's train rules
    (``rules_for(cfg, "train", 32, 4)``: weight and expert-weight FSDP over
    the data group, sequence parallelism at period boundaries): reduced
    h2o-danube-1.8b, moonshot-v1-16b-a3b and jamba-v0.1-52b at (data 2,
    model 2), moonshot at (4, 1); resident bytes equal to the rules' local
    shapes, the pool against itself under DEFAULT_RULES, the presets a
    train step takes, one step's collectives leaf by leaf against the
    design and the dry run's stand-ins, and the elastic checkpoint cut
    under the rules and resumed under DEFAULT_RULES at (4, 1) and in one
    process. With ``--inputs``: the reference's weights, and rank 0's
    gathered gradients and parameters for a caller that holds them to the
    reference's mesh under the same rules.
pipeline — the pipeline schedule across processes (``parallel.pipeline``
    over a pool: a stage per process, a send and receive per tick under
    autograd) at (pipe 4), (pipe 2, data 2) and (pipe 2, model 2) on 4
    ranks (every rank a stage on another pool): the reference's toy body and
    a reduced llama3-8b decoder layer, output and gradients against the
    sequential stack in one process within 2e-5. With ``--inputs``: the
    toy's arrays, and every rank's pieces for a caller that holds them to
    the reference.
profile — ``profile_engine`` over ``ServingEngine(pool=...)`` (reduced
    llama3-8b, 4 KV heads): the same table on every rank, the slowest
    rank's time for each key.
train_step (one process, ``train_step [cpu|cuda]``) — the same (data 2 x
    model 2) step in one process: the two data groups run one after
    another and the two TP ranks read their shards of the same tensors.
"""
from __future__ import annotations

import json
import math
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
from repro_torch.models.params import init_params, tree_leaves_with_path, tree_map, tree_map_with_path
from repro_torch.parallel.collectives import Pool, all_gather, close_pool, init_pool, rendezvous_file
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, ShardView, make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig, Zero1Shards
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
UPDATE_RTOL = 1e-2  # a trained leaf's distance over its update (1.0 for a leaf left where it started)
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
    tiny dense model's; ``inputs["cases"]`` ({name: inputs}): each in turn."""
    if inputs and "cases" in inputs:
        out = {name: check_migration(pool, case) for name, case in inputs["cases"].items()}
        return {"summary": {name: r["summary"] for name, r in out.items()}, "arrays": {}}
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
                      "blocks": {k: list(t.shape) for layer in moved for k, t in layer.items()},  # a shape per kind
                      "rows": [layer["k"].shape[1] for layer in moved if "k" in layer]})  # an attention layer's (a ring's)
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


# the fields over reduced() (and its 4 KV heads, engine_cfg's) that keep a model's published shape at CPU width:
# its query heads a KV head (yi-34b G 7, mistral-large-123b G 12, dbrx-132b G 6, musicgen-large's MHA) and dbrx's
# experts (16, top 4; reduced()'s d_ff_expert 64 and capacity factor 8.0). reduced() keeps chameleon-34b's qk-norm.
ENGINE_FIELDS = {"yi-34b": {"num_heads": 28},
                 "mistral-large-123b": {"num_heads": 48},
                 "dbrx-132b": {"num_heads": 24, "moe": {"num_experts": 16, "top_k": 4}},
                 "musicgen-large": {"num_heads": 8, "num_kv_heads": 8}}


def with_fields(cfg, fields: dict):
    """``cfg`` (a config of either package) with ``fields`` replaced; a dict
    value replaces fields of the nested spec (``moe``, ``attn``)."""
    return replace(cfg, **{k: replace(getattr(cfg, k), **v) if isinstance(v, dict) else v for k, v in fields.items()})


def engine_cfg(model: Optional[str] = None, capacity_factor: Optional[float] = None) -> ModelConfig:
    """check_engine's model: the reference's tiny dense one (``serve_cfg``),
    or a config of the port by name reduced with ``reduced()``, given 4 KV
    heads (so that the engine takes TP 4) and its ENGINE_FIELDS, as the
    port's CPU tests serve it; ``capacity_factor`` replaces an MoE model's."""
    if model is None:
        return serve_cfg()
    cfg = with_fields(replace(reduced(get_config(model)), num_kv_heads=4), ENGINE_FIELDS.get(model, {}))
    if capacity_factor is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=capacity_factor))
    return cfg


def engine_params(cfg: ModelConfig, dev: torch.device, inputs: Optional[dict] = None) -> dict:
    """check_engine's weights: the reference's (``inputs["params"]``), or
    drawn on ``dev`` by ``multicard.draw_weights`` as the full-width legs
    draw them (a qk-norm model's scales nonzero)."""
    from repro_torch.testing.multicard import draw_weights

    if inputs is not None and "params" in inputs:
        return _weights(inputs, "params", {}, dev)
    return draw_weights(cfg, dev, torch.float32)


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


TRAIN_STEPS = 5  # check_train_step's
ELASTIC_CUT = 3  # the step the elastic checkpoint cuts the plain case at
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL_AT = 8, 4, 6  # checkpoint_round_trip's run


def _train_cfg(case: dict) -> TrainStepConfig:
    """check_train_step's step config (the reference's: lr 1e-3, its
    default warm-up of 100, chunks and blocks of 16), with a case's
    warm-up, accumulation and compression. At a warm-up of 100 five steps
    move no parameter past PARAM_TOL's atol: UPDATE_RTOL is what holds the
    parameters there."""
    from repro_torch.training.grad_compress import CompressConfig

    return TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=case.get("warmup_steps", AdamWConfig.warmup_steps)),
                           compress=CompressConfig(enabled=case.get("compress", False), block=case.get("block", 2048)),
                           seq_chunk=16, block_q=16, block_k=16, accum_steps=case.get("accum_steps", 1))


def _replicated(pool: Pool, params: dict, layout) -> None:
    """The replication a train step keeps: a rank's parameters bit-equal
    across its data group (but the blocks of the leaves the rules shard
    over data), its replicated leaves across its model group."""
    from repro_torch.parallel.collectives import check_replicated

    check_replicated({"/".join(path): t for path, t in tree_leaves_with_path(params) if layout.data_dim(path) is None},
                     pool, layout.level.data)
    check_replicated({"/".join(path): t for path, t in tree_leaves_with_path(params) if layout.model_dim(path) is None},
                     pool, layout.level.model)


def _numpy_tree(tree: dict) -> dict:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def single_train(cfg: ModelConfig, tp: int, dp: int, params: dict, tcfg: TrainStepConfig, ds, steps: int):
    """``steps`` steps of the one-process train step at (TP ``tp``, dp
    ``dp``), updating ``params`` in place: (losses, each step's seconds)."""
    step, plan = make_train_step(cfg, make_exec_config(cfg, tp), params, tcfg, dp=dp)
    opt = init_opt_state(params, tcfg, plan if dp > 1 else None)
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(params, opt, ds.at(i))[2]["loss"]))
        times.append(time.perf_counter() - t0)
    return losses, times


def param_distance(got: dict, want: dict, moved: dict) -> dict:
    """Two canonical trees of trained parameters, leaf by leaf: the greatest
    |got - want| ("param_abs"), the first leaf outside PARAM_TOL ("outside",
    None: every leaf within), and the greatest ||got - want|| / ||want -
    start|| ("update_rel"; ``moved``: each path's ||want - start||): a
    tree left where it started reads 1.0. A leaf ``want`` left where it
    started (a bf16 leaf whose steps all round away) reads 0 if ``got``
    equals it, else infinity."""
    worst, outside, update = 0.0, None, 0.0
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        a, b = a.detach().double(), b.detach().to(a.device).double()
        worst = max(worst, float((a - b).abs().max()))
        d = float((a - b).norm())
        update = max(update, d / moved[path] if moved[path] > 0 else (0.0 if d == 0 else math.inf))
        if outside is None and not torch.allclose(a, b, **PARAM_TOL):
            outside = "/".join(path)
    return {"param_abs": worst, "outside": outside, "update_rel": update}


def moved_from(params: dict, start: dict) -> dict:
    """Each leaf's ||params - start|| by path (``start`` may lie on the
    host)."""
    return {path: float((t.detach() - start[path].to(t.device)).norm()) for path, t in tree_leaves_with_path(params)}


def pool_step(pool: Pool, cfg: ModelConfig, params0: Optional[dict], tcfg: TrainStepConfig, tp: int, draw=None,
              rules: ShardingRules = DEFAULT_RULES):
    """The pool's train step at TP ``tp`` under ``rules`` and this rank's
    state, from the canonical weights ``params0`` (or drawn: ``draw``, as
    ``train_params`` takes it): (step, params, optimizer state)."""
    from repro_torch.training.train_step import train_params

    ec = make_exec_config(cfg, tp)
    mine = train_params(cfg, ec, pool, params0, draw, rules)
    step, plan = make_train_step(cfg, ec, mine, tcfg, pool=pool, rules=rules)
    return step, mine, init_opt_state(mine, tcfg, plan, step)


def checked(pool: Pool, step, on_step=None):
    """``step`` with the replication checked after every call, and
    ``on_step(seconds)`` called before the check with the step's seconds
    (its launches and the sync of its loss); it carries the step's
    ``layout``."""

    def run(p, o, batch):
        t0 = time.perf_counter()
        out = step(p, o, batch)
        float(out[2]["loss"])
        if on_step is not None:
            on_step(time.perf_counter() - t0)
        _replicated(pool, p, step.layout)
        return out

    run.layout = step.layout
    return run


def pool_train(pool: Pool, cfg: ModelConfig, params0: Optional[dict], tcfg: TrainStepConfig, tp: int, ds,
               steps: int, start: int = 0, loop_dir: Optional[str] = None, draw=None, on_step=None,
               rules: ShardingRules = DEFAULT_RULES):
    """``steps`` steps (from ``start``) of ``pool_step``'s step (under
    ``rules``), the
    replication checked after every step (``checked``, which calls
    ``on_step``). With ``loop_dir`` the steps run through ``train_loop``,
    resuming from its newest checkpoint and writing one at the end.
    Returns (losses, this rank's params, the step function, the optimizer
    state)."""
    from repro_torch.training.loop import LoopConfig, train_loop

    step, mine, opt = pool_step(pool, cfg, params0, tcfg, tp, draw, rules)
    run = checked(pool, step, on_step)
    if loop_dir is not None:
        total = start + steps
        st = train_loop(run, mine, opt, ds, LoopConfig(total_steps=total, ckpt_every=total, ckpt_dir=loop_dir))
        return st.losses, mine, step, opt
    return [float(run(mine, opt, ds.at(start + i))[2]["loss"]) for i in range(steps)], mine, step, opt


def _state_parts(tree) -> List[torch.Tensor]:
    """Host copies of the tensors this process holds of a train state (a
    ZeRO-1 moment's slices as they lie)."""
    from repro_torch.checkpoint.checkpoint import tree_leaves

    return [t.detach().cpu().clone() for x in tree_leaves(tree)
            for t in (x.parts if isinstance(x, Zero1Shards) else [x])]


def checkpoint_round_trip(fresh, ds, root: str):
    """``train_loop``'s checkpoints put to the test, in one process or
    across a pool (every rank calls this; a step made over a pool carries
    its ``layout``, and the checkpoints are the elastic ones). ``fresh()``
    gives (step, params, optimizer state), from the same start each call.
    Run a: CKPT_STEPS steps, a checkpoint every CKPT_EVERY; run b: the same
    failing at CKPT_FAIL_AT, then resumed from its newest checkpoint, which
    must load back bit for bit against this process's state as it was
    saved, and give run a's losses within LOSS_RTOL. Returns (run a's
    ``LoopState``, its state kept; the record: each save's and load's
    seconds, this process's state bytes, both runs' losses, where b
    resumed, and "failures")."""
    from repro_torch.training import loop

    step, params, opt = fresh()
    layout = getattr(step, "layout", None)
    lead = layout is None or layout.pool.rank == 0
    dev = next(iter(tree_leaves_with_path(params)))[1].device
    saves, loads, saved, bitwise = [], [], {}, []
    save, load = loop.save_checkpoint, loop.load_checkpoint

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed_save(d, n, tree, metadata=None, layout=None):
        sync()
        t0 = time.perf_counter()
        path = save(d, n, tree, metadata, layout)
        saves.append({"step": n, "s": time.perf_counter() - t0})
        if d.endswith("b") and n == CKPT_EVERY:
            saved["state"] = _state_parts(tree)
        return path

    def timed_load(path, target, layout=None):
        t0 = time.perf_counter()
        out = load(path, target, layout)
        sync()
        loads.append(time.perf_counter() - t0)
        got = _state_parts(out[0])
        bitwise.append(len(got) == len(saved["state"]) and all(torch.equal(a, b) for a, b in zip(got, saved["state"])))
        return out

    def barrier():
        if layout is not None:
            layout.pool.barrier()

    if lead:
        shutil.rmtree(root, ignore_errors=True)
    barrier()
    cfg_of = lambda d: loop.LoopConfig(total_steps=CKPT_STEPS, ckpt_every=CKPT_EVERY, ckpt_dir=os.path.join(root, d))
    loop.save_checkpoint, loop.load_checkpoint = timed_save, timed_load
    failures = []
    try:
        a = loop.train_loop(step, params, opt, ds, cfg_of("a"))
        del step, params, opt
        if lead:
            shutil.rmtree(os.path.join(root, "a"))
        step, p, o = fresh()
        try:
            loop.train_loop(step, p, o, ds, cfg_of("b"), fail_at=CKPT_FAIL_AT)
            failures.append(f"the run did not fail at step {CKPT_FAIL_AT}")
        except loop.SimulatedFailure:
            pass
        del step, p, o
        step, p, o = fresh()
        b = loop.train_loop(step, p, o, ds, cfg_of("b"))
        del step, p, o, b.params, b.opt_state
    finally:
        loop.save_checkpoint, loop.load_checkpoint = save, load
        barrier()
        if lead:
            shutil.rmtree(root, ignore_errors=True)
    diffs = [abs(x - y) / abs(x) for x, y in zip(a.losses[CKPT_EVERY:], b.losses)]
    if b.resumed_from != CKPT_EVERY or b.step != CKPT_STEPS:
        failures.append(f"resumed from {b.resumed_from}, ended at {b.step}")
    if bitwise != [True]:
        failures.append(f"step {CKPT_EVERY}'s checkpoint did not load back bit for bit: {bitwise}")
    if len(diffs) != CKPT_STEPS - CKPT_EVERY or max(diffs) > LOSS_RTOL:
        failures.append(f"resumed losses {b.losses} against {a.losses[CKPT_EVERY:]}")
    rec = {"steps": CKPT_STEPS, "every": CKPT_EVERY, "fail_at": CKPT_FAIL_AT, "resumed_from": b.resumed_from,
           "state_bytes": sum(t.numel() * t.element_size() for t in _state_parts((a.params, a.opt_state))),
           "saves": saves, "load_s": loads, "losses": a.losses, "resumed_losses": b.losses,
           "loaded_bit_for_bit": bitwise == [True], "max_rel_diff": max(diffs) if diffs else None,
           "bitwise_equal_resumed": b.losses == a.losses[CKPT_EVERY:], "failures": failures}
    return a, rec


def check_train_step_pool(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """check_train_step across processes: reduced h2o-danube-1.8b at (data
    N/2 x model 2), ZeRO-1 moments on each data rank, TRAIN_STEPS steps,
    against a single-rank step each rank runs itself (TP 1, dp 1), at the
    reference's tolerances and each leaf within UPDATE_RTOL of its update;
    after every step the parameters bit-equal across each data group and
    the replicated leaves across each model group. ``inputs`` (optional):
    "params" (the reference's weights), "cases" ({name: {"warmup_steps",
    "accum_steps", "compress", "block"}}, default one plain case at the
    reference's config), and "ckpt_dir": the plain case cut
    at step ELASTIC_CUT through ``train_loop``'s checkpoint, resumed at
    (data N, model 1) from a copy of it. Rank 0's arrays: each case's
    losses and gathered parameters, the checkpoint's state gathered at the
    cut."""
    from repro_torch.training.train_step import gather_params

    inputs = inputs or {}
    cfg, dev = reduced(get_config("h2o-danube-1.8b")), pool.device
    tp = 2 if pool.world % 2 == 0 else 1
    params0 = _weights(inputs, "params", model_param_defs(cfg, make_exec_config(cfg, 1)), dev)
    ds = SyntheticDataset(cfg, batch=4, seq=32)
    summary, arrays = {"mesh": {"data": pool.world // tp, "model": tp}, "cases": {}}, {"cases": {}}
    for name, case in inputs.get("cases", {"plain": {}}).items():
        tcfg = _train_cfg(case)
        ref = tree_map(lambda t: t.detach().clone(), params0)  # the single rank, here
        want, _ = single_train(cfg, 1, 1, ref, tcfg, ds, TRAIN_STEPS)
        losses, mine, step, opt = pool_train(pool, cfg, params0, tcfg, tp, ds, TRAIN_STEPS)
        for a, b in zip(want, losses):
            if not abs(a - b) / abs(a) < LOSS_RTOL:
                raise AssertionError(f"train_step {name}: losses differ: {want} vs {losses}")
        whole = gather_params(mine, step.layout)
        dist = param_distance(whole, ref, moved_from(ref, dict(tree_leaves_with_path(params0))))
        if dist["outside"] is not None or not dist["update_rel"] < UPDATE_RTOL:
            raise AssertionError(f"train_step {name}: parameters against the single rank's: {dist}")
        split = sum(isinstance(m, Zero1Shards) for _, m in tree_leaves_with_path(opt["mu"]))
        summary["cases"][name] = {"losses_single": want, "losses_pool": losses, "max_param_diff": dist["param_abs"],
                                  "update_rel": dist["update_rel"],
                                  "zero1_split_leaves": split, "leaves": len(list(tree_leaves_with_path(mine))),
                                  "replicated_after_every_step": True}
        if pool.rank == 0:
            arrays["cases"][name] = {"losses": losses, "params": _numpy_tree(whole)}
        del mine, step, opt, whole
    if "ckpt_dir" in inputs:
        summary["elastic"], arrays["elastic"] = _elastic(pool, cfg, params0, tp, ds, inputs,
                                                         summary["cases"]["plain"]["losses_pool"])
    return {"summary": summary, "arrays": arrays if pool.rank == 0 else {}}


def _elastic(pool: Pool, cfg: ModelConfig, params0: dict, tp: int, ds, inputs: dict, uncut: list):
    """The plain case cut at ELASTIC_CUT under (data N/tp, model tp), its
    checkpoint copied to ``<ckpt_dir>-resume`` and resumed there at (data
    N, model 1): the resumed losses within LOSS_RTOL of the uncut run's.
    Rank 0 also returns the state gathered at the cut."""
    from repro_torch.checkpoint.checkpoint import _leaves_with_path, _whole

    cut, root = ELASTIC_CUT, inputs["ckpt_dir"]
    tcfg = _train_cfg(inputs.get("cases", {}).get("plain", {}))
    losses, mine, step, opt = pool_train(pool, cfg, params0, tcfg, tp, ds, cut, loop_dir=root)
    state = [_whole(path, x, step.layout) for path, x in _leaves_with_path((mine, opt))]
    gathered = [x.detach().cpu().numpy() for x in state] if pool.rank == 0 else None
    del mine, step, opt, state
    again = root + "-resume"
    if pool.rank == 0:
        shutil.copytree(root, again)
    pool.barrier()
    resumed, mine, _, _ = pool_train(pool, cfg, params0, tcfg, 1, ds, TRAIN_STEPS - cut, start=cut, loop_dir=again)
    diffs = [abs(a - b) / abs(b) for a, b in zip(resumed, uncut[cut:])]
    if len(resumed) != TRAIN_STEPS - cut or max(diffs) >= LOSS_RTOL:
        raise AssertionError(f"resumed at (data {pool.world}, model 1): {resumed} against {uncut[cut:]}")
    summary = {"cut": cut, "losses_before_cut": losses, "resumed_data_model": [pool.world, 1],
               "resumed_losses": resumed, "max_rel_diff": max(diffs)}
    return summary, ({"state_at_cut": gathered, "resumed_params": _numpy_tree(mine)} if pool.rank == 0 else {})


# check_train_moe's cases: name -> (model, TP, steps, weights at each layer's own fan-in); at world 4 the mesh
# is (data 4/TP, model TP), which the name gives as data x model
TRAIN_MOE_CASES = {
    "moonshot_2x2": ("moonshot-v1-16b-a3b", 2, 3, False),
    "moonshot_4x1": ("moonshot-v1-16b-a3b", 1, 3, False),  # the TP-1 gather of the data groups' rows
    "moonshot_1x4": ("moonshot-v1-16b-a3b", 4, 3, False),  # the all-to-all over 4 ranks
    "jamba_2x2": ("jamba-v0.1-52b", 2, 3, True),
    "jamba_init_2x2": ("jamba-v0.1-52b", 2, 1, False),  # init_params' weights: several steps mean nothing there
    "mamba2_2x2": ("mamba2-2.7b", 2, 3, False),
}
# a gradient's greatest error over its leaf's greatest |g|, against the reference's value_and_grad (the CPU
# tests') and the pool's against one process
GRAD_TOL = {"moonshot-v1-16b-a3b": 5e-4, "jamba-v0.1-52b": 5e-4}  # others 1e-4


def grad_distance(got: dict, want: dict) -> dict:
    """Two canonical gradient trees, leaf by leaf: the greatest
    max|got - want| / max|want| ("rel") and its leaf ("leaf")."""
    worst, leaf = 0.0, None
    for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        a, b = a.detach().double(), b.detach().to(a.device).double()
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel >= worst:
            worst, leaf = rel, "/".join(path)
    return {"rel": worst, "leaf": leaf}


def one_process_run(cfg: ModelConfig, tp: int, dp: int, params0: dict, tcfg: TrainStepConfig, ds, steps: int) -> dict:
    """The one-process train step at (TP ``tp``, dp ``dp``) from a copy of
    ``params0``: its gradients of batch 0 (``step_fn.gradients``), then
    ``single_train``'s ``steps`` steps; {"grads", "losses", "params",
    "moved"} (each leaf's ||params - params0||), as ``held_to`` reads
    them."""
    params = tree_map(lambda t: t.detach().clone(), params0)
    step, _ = make_train_step(cfg, make_exec_config(cfg, tp), params, tcfg, dp=dp)
    grads = tree_map(lambda g: g.detach().clone(), step.gradients(ds.at(0))[2])
    del step
    losses, _ = single_train(cfg, tp, dp, params, tcfg, ds, steps)
    return {"grads": grads, "losses": losses, "params": params,
            "moved": moved_from(params, dict(tree_leaves_with_path(params0)))}


def held_to(losses: list, whole: dict, one: dict) -> dict:
    """A pool's losses and gathered parameters against a one-process run's
    (``one_process_run``, ``multicard.one_card_train``): the losses'
    greatest relative difference ("loss_rel") and ``param_distance``'s
    "param_abs", "outside" (the first leaf outside PARAM_TOL) and
    "update_rel" (1.0 for a pool that left its parameters where they
    started), and "bitwise" (losses and parameters bit for bit)."""
    d = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"])),
         **param_distance(whole, one["params"], one["moved"])}
    d["bitwise"] = d["loss_rel"] == 0 and d["param_abs"] == 0
    return d


def within(d: dict) -> bool:
    """``held_to``'s distances within LOSS_RTOL, PARAM_TOL and UPDATE_RTOL,
    f32 and bf16 runs alike (a pool that never applies its update reads
    update_rel 1.0)."""
    return d["loss_rel"] < LOSS_RTOL and d["outside"] is None and d["update_rel"] < UPDATE_RTOL


def check_train_moe(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The pool's train step on the MoE and Mamba families: each case of
    TRAIN_MOE_CASES (``inputs["cases"]``: some of them), reduced config at
    (data N/TP, model TP), check_train_step's optimizer at a warm-up of 2,
    SyntheticDataset(4, 32): the step's gradients of batch 0
    (``step_fn.gradients``), then its steps, the replication checked after
    every one. Rank 0 holds them to the one-process step that computes the
    reference's mesh step (at (TP t, dp N/t); at TP 1 the one-process step
    (TP 1, dp 1), whose MoE routes the whole batch as the mesh's does):
    every leaf's gradient within GRAD_TOL of its greatest element, the
    losses within LOSS_RTOL, the parameters within PARAM_TOL and each leaf
    within UPDATE_RTOL of its update. Weights: ``inputs["params"][case]``
    (the reference's), else seed 0 on this rank's device (at each layer's
    own fan-in where the case says so, ``per_layer_fan_in``). Rank 0's
    arrays: each case's gathered gradients, losses and parameters."""
    from repro_torch.checkpoint.convert import to_torch
    from repro_torch.models.params import per_layer_fan_in
    from repro_torch.training.train_step import gather_params

    inputs = inputs or {}
    dev, tcfg = pool.device, _train_cfg({"warmup_steps": 2})
    summary, arrays = {}, {}
    for name in inputs.get("cases", list(TRAIN_MOE_CASES)):
        model, tp, steps, own = TRAIN_MOE_CASES[name]
        cfg = reduced(get_config(model))
        defs = model_param_defs(cfg, make_exec_config(cfg, tp))
        if name in inputs.get("params", {}):
            params0 = to_torch(inputs["params"][name], dev)
        else:
            params0 = init_params(per_layer_fan_in(defs) if own else defs, torch.Generator(dev).manual_seed(0))
        ds = SyntheticDataset(cfg, batch=4, seq=32)
        step, mine, opt = pool_step(pool, cfg, params0, tcfg, tp)
        grads = gather_params(step.gradients(ds.at(0))[2], step.layout)
        losses = [float(checked(pool, step)(mine, opt, ds.at(i))[2]["loss"]) for i in range(steps)]
        whole = gather_params(mine, step.layout)
        rec = {"model": cfg.name, "mesh": {"data": pool.world // tp, "model": tp}, "losses": losses,
               "replicated_after_every_step": True}
        if pool.rank == 0:
            one_tp, one_dp = (tp, pool.world // tp) if tp > 1 else (1, 1)
            one = one_process_run(cfg, one_tp, one_dp, params0, tcfg, ds, steps)
            g, held = grad_distance(grads, one["grads"]), held_to(losses, whole, one)
            rec["one_process"] = {"tp": one_tp, "dp": one_dp, "losses": one["losses"], "grad_rel": g["rel"],
                                  "grad_leaf": g["leaf"], **held}
            if g["rel"] > GRAD_TOL.get(model, 1e-4) or not within(held):
                raise AssertionError(f"train_moe {name}: the pool against the one-process step: {rec['one_process']}")
            arrays[name] = {"grads": _numpy_tree(grads), "losses": losses, "params": _numpy_tree(whole)}
        summary[name] = rec
        del step, mine, opt, grads, whole
    return {"summary": summary, "arrays": arrays}


# check_train_rules' cases: name -> (model, TP, steps, weights at each layer's own fan-in); at world 4 the mesh
# is (data 4/TP, model TP), the rules rules_for(cfg, "train", RULES_SEQ, RULES_BATCH), the config
# ``train_case_cfg``'s
TRAIN_RULES_CASES = {
    "danube_2x2": ("h2o-danube-1.8b", 2, 3, False),
    "moonshot_2x2": ("moonshot-v1-16b-a3b", 2, 3, False),
    "moonshot_4x1": ("moonshot-v1-16b-a3b", 1, 3, False),
    "jamba_2x2": ("jamba-v0.1-52b", 2, 1, True),  # its 8-layer period, the Mamba leaves on "embed"
    "dbrx_2x2": ("dbrx-132b", 2, 3, False),  # the paper-scale MoE the rules' expert-weight FSDP was written for
}
# the fields over reduced() a train case's model takes (a config of either package, ``with_fields``): dbrx-132b's
# published 16 experts, top 4, and 6 query heads a KV head over reduced()'s 2 KV heads
TRAIN_FIELDS = {"dbrx-132b": {"num_heads": 12, "moe": {"num_experts": 16, "top_k": 4}}}


def train_case_cfg(model: str) -> ModelConfig:
    """A train case's model: ``reduced()`` with its TRAIN_FIELDS."""
    return with_fields(reduced(get_config(model)), TRAIN_FIELDS.get(model, {}))
RULES_BATCH, RULES_SEQ = 4, 32
PRESETS_CASE, ELASTIC_CASE, VARIANTS_CASE = "moonshot_2x2", "danube_2x2", "danube_2x2"
TRAIN_PRESETS = ("no-fsdp", "zero-off", "fsdp-pod")  # the presets a train step takes (rules_presets.preset)
# the train rules against DEFAULT_RULES at one layout, where only the sums' order differs: a gradient's greatest
# |diff| over its leaf's greatest |g| (0 at (2, 2), 1.7e-7 at (4, 1) on this CPU), and a loss's relative
# difference; each parameter leaf's ||diff|| over its update ||p - p0|| (1.0e-5 for moonshot on this CPU: a
# one-ulp difference of the clip's global norm, through Adam's first steps; measured over each leaf's greatest
# |p| it reads 2e-5 on the zero-initialised norm scales, whose greatest |p| is a few lr-sized steps)
RULES_TOL, RULES_UPDATE_RTOL = 1e-6, 1e-4


def variant_rtol(variant: str) -> float:
    """The update distance a run of VARIANTS_CASE is held to against
    DEFAULT_RULES: RULES_UPDATE_RTOL plain (``variant`` ""), UPDATE_RTOL
    with accumulation or compression. Accumulation adds a leaf's
    microbatches and data ranks in another order, (a0 + b0) + (a1 + b1)
    reduce-scattered a microbatch at a time against (a0 + a1) + (b0 + b1)
    all-reduced once: where an element's gradient sums to about its
    rounding, Adam's first steps turn that into part of a step (1.28e-3 of
    a leaf's update on an H100, 7.2e-6 under gloo on the CPU).
    Compression's int8 rounding turns a last-bit difference of a later
    step's gradient into a whole quantization step of its block (1.7e-4 on
    the reference's weights on the CPU)."""
    return UPDATE_RTOL if variant else RULES_UPDATE_RTOL


def train_rules(cfg: ModelConfig) -> ShardingRules:
    """The reference's train rules of check_train_rules' batches."""
    from repro_torch.parallel.sharding import rules_for

    return rules_for(cfg, "train", RULES_SEQ, RULES_BATCH)


def state_bytes(tree) -> int:
    """The bytes this process holds of a train state (a ZeRO-1 moment's
    slices as they lie)."""
    from repro_torch.checkpoint.checkpoint import tree_leaves

    return sum(sum(p.numel() * p.element_size() for p in (x.parts if isinstance(x, Zero1Shards) else [x]))
               for x in tree_leaves(tree))


def rules_local_bytes(defs: dict, rules: ShardingRules, mesh: dict, dtype_bytes: int = 4) -> dict:
    """One rank's parameter and moment (mu and nu) bytes by the rules' local
    shapes on ``mesh``: ``sharding.local_shape``, and for the moments the
    reference's ``zero1_pspec`` (``launch.cells._zero1_spec``)."""
    from repro_torch.launch.cells import _zero1_spec
    from repro_torch.parallel.sharding import local_shape, spec_ways

    p = m = 0
    for _, d in tree_leaves_with_path(defs):
        p += math.prod(local_shape(d.shape, d.axes, rules, mesh)) * dtype_bytes
        ways = spec_ways(_zero1_spec(d, rules, mesh), mesh)
        m += 2 * math.prod(-(-n // w) for n, w in zip(d.shape, ways)) * dtype_bytes
    return {"params": p, "moments": m}


def _rules_run(pool: Pool, cfg: ModelConfig, params0: dict, tcfg: TrainStepConfig, tp: int, ds, steps: int,
               rules: ShardingRules, count: bool = False) -> dict:
    """The pool's step under ``rules``: its resident bytes, its gradients of
    batch 0 gathered whole, then ``steps`` steps (the replication checked
    after each; with ``count`` the first counted leaf by leaf,
    ``count_traffic(by_leaf=True)``), the losses and the parameters
    gathered whole."""
    from repro_torch.parallel.collectives import count_traffic
    from repro_torch.training.train_step import gather_params

    step, mine, opt = pool_step(pool, cfg, params0, tcfg, tp, rules=rules)
    rec = {"resident": {"params": state_bytes(mine), "moments": state_bytes({"mu": opt["mu"], "nu": opt["nu"]})},
           "zero1_split": sum(isinstance(m, Zero1Shards) for _, m in tree_leaves_with_path(opt["mu"])),
           "data_sharded": sorted("/".join(path) for path in step.layout.data_dims), "layout": step.layout}
    rec["grads"] = gather_params(step.gradients(ds.at(0))[2], step.layout)
    run, losses = checked(pool, step), []
    for i in range(steps):
        if count and i == 0:
            with count_traffic(by_leaf=True) as traffic:
                losses.append(float(run(mine, opt, ds.at(i))[2]["loss"]))
            rec["traffic"] = dict(traffic)
        else:
            losses.append(float(run(mine, opt, ds.at(i))[2]["loss"]))
    rec.update(losses=losses, params=gather_params(mine, step.layout))
    return rec


def _against(got: dict, want: dict, params0: dict) -> dict:
    """Two ``_rules_run``s from ``params0``: the gradients' greatest
    relative error (``grad_distance``), the losses' greatest relative
    difference and ``param_distance``'s "param_abs" and "update_rel"."""
    g = grad_distance(got["grads"], want["grads"])
    d = param_distance(got["params"], want["params"], moved_from(want["params"], dict(tree_leaves_with_path(params0))))
    return {"grad_rel": g["rel"], "grad_leaf": g["leaf"],
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
            "param_abs": d["param_abs"], "update_rel": d["update_rel"]}


def _bitwise(a: dict, b: dict) -> bool:
    """Two runs' losses and gathered parameters bit for bit."""
    return a["losses"] == b["losses"] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves_with_path(a["params"]), tree_leaves_with_path(b["params"])))


def traffic_held(cfg: ModelConfig, tp: int, rules: ShardingRules, run: dict, accum: int = 1) -> dict:
    """The first step's collectives counted leaf by leaf (``_rules_run``'s
    ``count``) against the design, one data rank's RULES_BATCH / dp rows in
    ``accum`` microbatches: each data-sharded leaf gathered at its forward
    and its recompute (a layer's; the embedding, final norm and head once)
    and its gradient reduce-scattered once, each a microbatch, and never
    all-reduced; the sequence-parallel joins and cuts at each period
    boundary; and every kind's totals against ``cells.rules_traffic``, the
    dry run's stand-ins for the same cell. Returns the record; raises where
    one differs."""
    from repro_torch.launch.cells import rules_traffic

    layout, traffic = run["layout"], run["traffic"]
    mesh = {"data": layout.level.dp, "model": tp}
    failures, by_kind = [], {}
    for key, (calls, nbytes) in traffic.items():
        kind = key[:key.index(")") + 1] if ")" in key else key
        c, b = by_kind.get(kind, (0, 0))
        by_kind[kind] = (c + calls, b + nbytes)
    names = []
    for path in layout.data_dims:
        name = "/".join(path)
        inst = [f"{name}@{i}" for i in range(cfg.num_periods)] if path[0] == "periods" else [name]
        for leaf in inst:
            names.append(leaf)
            want = (accum * (2 if path[0] == "periods" else 1), accum)
            got = (traffic.get(f"all-gather (weights) {leaf}", (0, 0))[0],
                   traffic.get(f"reduce-scatter (gradients) {leaf}", (0, 0))[0])
            if got != want:
                failures.append(f"{leaf}: gathered {got[0]} times (not {want[0]}), its gradient "
                                f"reduce-scattered {got[1]} times (not {want[1]})")
        if f"all-reduce (gradients) {name}" in traffic:
            failures.append(f"{name}: its gradient all-reduced")
    want = rules_traffic(cfg, make_exec_config(cfg, tp), rules, mesh, RULES_BATCH // layout.level.dp // accum,
                         RULES_SEQ, accum)
    for kind in set(want) | set(by_kind) & {"all-reduce (gradients)", "all-gather (parameters)"}:
        if by_kind.get(kind, (0, 0)) != want.get(kind, (0, 0)):
            failures.append(f"{kind}: {by_kind.get(kind)} counted, {want.get(kind)} by rules_traffic")
    if failures:
        raise AssertionError(f"train_rules traffic: {failures}")
    return {"by_kind": by_kind, "rules_traffic": want, "data_sharded_instances": len(names),
            "sequence_joins": by_kind.get("all-gather (sequence)", (0, 0))[0],
            "sequence_cuts_backward": by_kind.get("all-gather (sequence, backward)", (0, 0))[0]}


def check_train_rules(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The pool's train step under the reference's train rules
    (``rules_for(cfg, "train", 32, 4)``: weight FSDP over the data group,
    expert-weight FSDP, sequence parallelism at period boundaries), each
    case of TRAIN_RULES_CASES (``inputs["cases"]``: some of them), reduced
    config at (data N/TP, model TP), check_train_moe's optimizer and
    batches: each rank's resident parameter and moment bytes equal to the
    rules' local shapes exactly; the gradients of batch 0 and the losses
    within RULES_TOL, and the parameters within RULES_UPDATE_RTOL of their
    update, of the same pool under DEFAULT_RULES (only the sums' order
    differs), the replication checked after every step. PRESETS_CASE
    also runs the presets a train step takes: "no-fsdp" bit for bit equal
    to DEFAULT_RULES, "zero-off" (no moment split) and "fsdp-pod" ("pod"
    absent on one host) bit for bit equal to the train rules. VARIANTS_CASE
    also runs accumulation (2 microbatches) and compression (int8 blocks
    of 256) under both tables, held as the plain runs but for the
    parameters (``variant_rtol``). Every case's first step under the train
    rules, and the accumulated one's, is counted (``traffic_held``).
    ELASTIC_CASE's run is cut through ``train_loop``'s
    checkpoint under the rules and resumed at (data N, model 1) under
    DEFAULT_RULES and in one process (``_elastic_rules``). Weights:
    ``inputs["params"][case]`` (the reference's), else seed 0 on this
    rank's device. Rank 0's arrays: each case's gathered gradients, losses
    and parameters under the train rules."""
    from repro_torch.checkpoint.convert import to_torch
    from repro_torch.launch.rules_presets import preset
    from repro_torch.models.params import per_layer_fan_in

    inputs = inputs or {}
    dev, tcfg = pool.device, _train_cfg({"warmup_steps": 2})
    summary, arrays = {}, {}
    for name in inputs.get("cases", list(TRAIN_RULES_CASES)):
        model, tp, steps, own = TRAIN_RULES_CASES[name]
        cfg = train_case_cfg(model)
        defs = model_param_defs(cfg, make_exec_config(cfg, tp))
        if name in inputs.get("params", {}):
            params0 = to_torch(inputs["params"][name], dev)
        else:
            params0 = init_params(per_layer_fan_in(defs) if own else defs, torch.Generator(dev).manual_seed(0))
        ds = SyntheticDataset(cfg, batch=RULES_BATCH, seq=RULES_SEQ)
        rules, mesh = train_rules(cfg), {"data": pool.world // tp, "model": tp}
        tables = {"rules": (rules, tcfg), "default": (DEFAULT_RULES, tcfg)}
        if name == PRESETS_CASE:
            tables.update({p: (preset(p, rules), tcfg) for p in TRAIN_PRESETS})
        if name == VARIANTS_CASE:  # accumulation and compression, each under both tables
            for v, case in (("accum", {"accum_steps": 2}), ("compress", {"compress": True, "block": 256})):
                t = _train_cfg({"warmup_steps": 2, **case})
                tables.update({v: (rules, t), f"{v}_default": (DEFAULT_RULES, t)})
        runs = {label: _rules_run(pool, cfg, params0, t, tp, ds, steps, r,
                                  count=label in ("rules", "accum"))
                for label, (r, t) in tables.items()}
        rec = {"model": cfg.name, "mesh": mesh, "losses": runs["rules"]["losses"],
               "data_sharded": runs["rules"]["data_sharded"], "zero1_split": runs["rules"]["zero1_split"],
               "resident": runs["rules"]["resident"], "replicated_after_every_step": True}
        failures = []
        for label, (r, _) in tables.items():
            want = rules_local_bytes(defs, r, mesh)
            if runs[label]["resident"] != want:
                failures.append(f"{label}: resident {runs[label]['resident']}, the local shapes {want}")
        for v in ("", "accum", "compress") if name == VARIANTS_CASE else ("",):
            got, base = runs[v or "rules"], runs[f"{v}_default" if v else "default"]
            rec[f"{v}_against_default" if v else "against_default"] = d = _against(got, base, params0)
            if d["grad_rel"] > RULES_TOL or d["loss_rel"] > RULES_TOL or not d["update_rel"] < variant_rtol(v):
                failures.append(f"{v or 'plain'} against DEFAULT_RULES: {d}")
        if name == PRESETS_CASE:
            rec["presets"] = {"no-fsdp_bitwise_default": _bitwise(runs["no-fsdp"], runs["default"]),
                              "zero-off_bitwise_rules": _bitwise(runs["zero-off"], runs["rules"]),
                              "zero-off_split_leaves": runs["zero-off"]["zero1_split"],
                              "fsdp-pod_bitwise_rules": _bitwise(runs["fsdp-pod"], runs["rules"])}
            if not (rec["presets"]["no-fsdp_bitwise_default"] and rec["presets"]["zero-off_bitwise_rules"]
                    and rec["presets"]["fsdp-pod_bitwise_rules"] and runs["zero-off"]["zero1_split"] == 0
                    and runs["fsdp-pod"]["data_sharded"] == runs["rules"]["data_sharded"]):
                failures.append(f"presets: {rec['presets']}")
        rec["traffic"] = traffic_held(cfg, tp, rules, runs["rules"])
        if name == VARIANTS_CASE:
            rec["accum_traffic"] = traffic_held(cfg, tp, rules, runs["accum"], accum=2)
        if failures:
            raise AssertionError(f"train_rules {name}: {failures}")
        if name == ELASTIC_CASE:
            rec["elastic"] = _elastic_rules(pool, cfg, params0, tp, ds, rules, inputs)
        if pool.rank == 0:
            arrays[name] = {k: _numpy_tree(runs["rules"][k]) for k in ("grads", "params")}
            arrays[name]["losses"] = runs["rules"]["losses"]
        summary[name] = rec
        del runs
    return {"summary": summary, "arrays": arrays}


def _elastic_rules(pool: Pool, cfg: ModelConfig, params0: dict, tp: int, ds, rules: ShardingRules,
                   inputs: dict) -> dict:
    """TRAIN_STEPS steps under ``rules`` at (data N/tp, model tp),
    checkpointed at ELASTIC_CUT through ``train_loop``; the checkpoint
    copied twice and resumed there at (data N, model 1) under
    DEFAULT_RULES, and in one process on rank 0: the resumed losses within
    LOSS_RTOL of the uncut run's. The checkpoints lie in
    ``inputs["ckpt_dir"]`` (default: a directory of the system's temporary
    one named after the parent process, which every rank shares)."""
    from repro_torch.training.loop import LoopConfig, train_loop

    cut, tcfg = ELASTIC_CUT, _train_cfg({"warmup_steps": 2})
    root = inputs.get("ckpt_dir") or os.path.join(tempfile.gettempdir(), f"train-rules-{os.getppid()}")
    if pool.rank == 0:
        for d in (root, root + "-pool", root + "-one"):
            shutil.rmtree(d, ignore_errors=True)
    pool.barrier()
    before, mine, step, opt = pool_train(pool, cfg, params0, tcfg, tp, ds, cut, loop_dir=root, rules=rules)
    run = checked(pool, step)
    uncut = [float(run(mine, opt, ds.at(i))[2]["loss"]) for i in range(cut, TRAIN_STEPS)]
    del mine, step, opt, run
    if pool.rank == 0:
        shutil.copytree(root, root + "-pool")
        shutil.copytree(root, root + "-one")
    pool.barrier()
    resumed, mine, _, _ = pool_train(pool, cfg, params0, tcfg, 1, ds, TRAIN_STEPS - cut, start=cut,
                                     loop_dir=root + "-pool")
    rec = {"cut": cut, "losses_before_cut": before, "uncut": uncut, "resumed_data_model": [pool.world, 1],
           "resumed": resumed}
    failures = [] if max(abs(a - b) / abs(b) for a, b in zip(resumed, uncut)) < LOSS_RTOL else [
        f"resumed at (data {pool.world}, model 1) under DEFAULT_RULES: {resumed} against {uncut}"]
    if pool.rank == 0:
        params = tree_map(lambda t: t.detach().clone(), params0)
        step, _ = make_train_step(cfg, make_exec_config(cfg, 1), params, tcfg)
        st = train_loop(step, params, init_opt_state(params, tcfg), ds,
                        LoopConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, ckpt_dir=root + "-one"))
        rec.update(one_process=st.losses, one_process_resumed_from=st.resumed_from)
        if st.resumed_from != cut or max(abs(a - b) / abs(b) for a, b in zip(st.losses, uncut)) >= LOSS_RTOL:
            failures.append(f"resumed in one process from {st.resumed_from}: {st.losses} against {uncut}")
        for d in (root, root + "-pool", root + "-one"):
            shutil.rmtree(d, ignore_errors=True)
    pool.barrier()
    if failures:
        raise AssertionError(f"train_rules elastic: {failures}")
    return rec


def check_train_grads(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The collectives under autograd at TP 2 across the pool against the
    one process's TP 2 ranks: a vocab-parallel embedding, twice a norm
    scale before a column -> row MLP, and the tied head, gathered, under a
    random linear loss; every leaf's gradient (this rank's shard of a
    model-sharded leaf, the norm scales whole: a missing all-reduce of dX
    leaves them this rank's part) within 1e-6."""
    import torch.nn.functional as F

    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models.layers import col_parallel, rmsnorm, row_parallel, tied_head, vocab_parallel_embed
    from repro_torch.models.params import ParamDef
    from repro_torch.parallel.collectives import gather_ranks

    cfg, dev, tp, d, ff, V, M = tiny_cfg(), pool.device, 2, 32, 64, 128, 12
    defs = {"embed": ParamDef((V, d), ("vocab", "embed"), scale=1.0),
            "norm1": ParamDef((d,), ("embed",), scale=0.3), "norm2": ParamDef((d,), ("embed",), scale=0.3),
            "w1": ParamDef((d, ff), ("embed", "mlp")), "w2": ParamDef((ff, d), ("mlp", "embed")),
            "w3": ParamDef((d, ff), ("embed", "mlp")), "w4": ParamDef((ff, d), ("mlp", "embed"))}
    g = torch.Generator().manual_seed(4)
    params = init_params(defs, g)
    tokens = torch.randint(0, V, (M,), generator=g).to(dev)
    weight = torch.randn((M, V), generator=g).to(dev)

    def loss(b):
        h = vocab_parallel_embed(tokens, b["embed"])
        for n, wa, wb in (("norm1", "w1", "w2"), ("norm2", "w3", "w4")):
            x = rmsnorm(h, b[n], 1e-5)
            h = h + row_parallel([F.silu(y) for y in col_parallel(x, b[wa])], b[wb])
        return (gather_ranks(tied_head(h, b["embed"]), b["embed"].level, -1) * weight).sum()

    def grads(store, tree, storage):
        for t in tree.values():
            t.requires_grad_(True)
        loss(store.rebind(storage, tp)).backward()
        return {k: t.grad for k, t in tree.items()}

    one = WeightStore(cfg, defs, [dev] * tp)
    whole = {k: t.clone().to(dev) for k, t in params.items()}
    want = grads(one, whole, one.build(whole))
    store = WeightStore(cfg, defs, pool.devices, storage_tp=tp, pool=pool)
    mine = {k: store.lay((k,), t.to(dev), pool.rank) for k, t in params.items()}
    got = grads(store, mine, store.storage_of(mine))
    level, errs = pool.level(tp), {}
    for k, gk in got.items():
        dim = store.plans[(k,)].dim
        w = want[k] if dim is None else want[k].narrow(dim, level.model_rank * gk.shape[dim], gk.shape[dim])
        errs[k] = float((gk - w).abs().max())
        if errs[k] > GRAD_ATOL:
            raise AssertionError(f"train_grads: {k}'s gradient {errs[k]} from the one-process TP {tp} ranks'")
    return {"summary": {"tp": tp, "max_abs_err": errs, "collectives": _collective_grads(pool),
                        "layers": _layer_grads(pool)}, "arrays": {}}


GRAD_ATOL = 1e-6  # check_train_grads': a gradient across processes against one process's
# a layer's gradients over their greatest element: f32 sums over another batch split (on 4 H100s mamba2's
# layer read 1.11e-6 at data 2 x model 2; the CPU <= 5.1e-7)
LAYER_GRAD_RTOL = 1e-5


def _held(errs: dict, name: str, got: torch.Tensor, want: torch.Tensor, scaled: bool = False) -> None:
    """``got`` within GRAD_ATOL of ``want`` (``scaled``: within
    LAYER_GRAD_RTOL of the greatest |want|, for a layer's leaves, whose
    gradients reach ~100); ``errs[name]`` keeps the greatest error."""
    err = float((got - want).abs().max()) / (float(want.abs().max()) if scaled else 1.0)
    errs[name] = max(errs.get(name, 0.0), err)
    if err > (LAYER_GRAD_RTOL if scaled else GRAD_ATOL):
        raise AssertionError(f"train_grads {name}: the gradient across processes differs by {err}"
                             f"{' of its greatest element' if scaled else ''} from one process's")


def _collective_grads(pool: Pool) -> dict:
    """The autograd collectives alone at world 2, each against one process
    holding every rank's inputs: ``all_to_all`` and ``reduce_shared`` over
    the model group at TP 2 (a loss every model rank computes, summed over
    the ranks' own parts), ``gather_summed`` over the data group at TP 1
    and ``pool_mean`` at TP 1 and 2 (the data groups' objectives summed,
    each a different multiple of the mean), each rank's objective
    nonlinear in what it received. Returns each one's greatest error."""
    from repro_torch.parallel.collectives import all_to_all, gather_summed, pool_mean, reduce_ranks, reduce_shared

    dev, errs = pool.device, {}

    def draw(rank: int, salt: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 * salt + rank)).to(dev)

    def inputs(n: int, salt: int, shape):
        return [draw(r, salt, shape).requires_grad_(True) for r in range(n)]

    lv = pool.level(2)
    t, me = lv.tp, lv.model.index
    # all_to_all: chunk k of rank r's (t, 3, 4) to rank k
    xs, ws = inputs(t, 1, (t, 3, 4)), [draw(r, 2, (t, 3, 4)) for r in range(t)]
    x = xs[me].detach().clone().requires_grad_(True)
    reduce_ranks([(torch.tanh(all_to_all(x, lv.model)) * ws[me]).sum()], lv, t).backward()
    sum((torch.tanh(torch.stack([xs[k][r] for k in range(t)])) * ws[r]).sum() for r in range(t)).backward()
    _held(errs, "all_to_all", x.grad, xs[me].grad)
    # reduce_shared: the partials' sum, which each rank weighs its own way
    ps, ws = inputs(t, 3, (3, 4)), [draw(r, 4, (3, 4)) for r in range(t)]
    part = ps[me].detach().clone().requires_grad_(True)
    reduce_ranks([(torch.tanh(reduce_shared([part], lv, t)) * ws[me]).sum()], lv, t).backward()
    whole = ps[0]
    for q in ps[1:]:
        whole = whole + q
    sum((torch.tanh(whole) * ws[r]).sum() for r in range(t)).backward()
    _held(errs, "reduce_shared", part.grad, ps[me].grad)
    # gather_summed over the data group at TP 1: each data rank's objective reads every rank's rows
    lv1 = pool.level(1)
    n, me1 = lv1.dp, lv1.data.index
    xs, ws = inputs(n, 5, (2, 5)), [draw(r, 6, (2 * n, 5)) for r in range(n)]
    x = xs[me1].detach().clone().requires_grad_(True)
    (torch.tanh(gather_summed(x, lv1.data)) * ws[me1]).sum().backward()
    sum((torch.tanh(torch.cat(xs)) * ws[d]).sum() for d in range(n)).backward()
    _held(errs, "gather_summed", x.grad, xs[me1].grad)
    # pool_mean: every rank's value in the mean once; data group d's objective a_d * mean^2
    for tp in (1, 2):
        lvt = pool.level(tp)
        vs = inputs(pool.world, 7, (3,))
        a = [1.5 - d for d in range(lvt.dp)]
        v = vs[pool.rank].detach().clone().requires_grad_(True)
        (a[lvt.data_rank] * pool_mean(torch.tanh(v).sum(), lvt) ** 2).backward()
        mean = sum(torch.tanh(u).sum() for u in vs) / pool.world
        sum(a_d * mean ** 2 for a_d in a).backward()
        _held(errs, "pool_mean", v.grad, vs[pool.rank].grad)
    return errs


def _layer_grads(pool: Pool) -> dict:
    """The layers that train across processes through those collectives,
    at world 2, against one process holding every rank: reduced
    moonshot's MoE on the sharded path (TP 2), the decode path (TP 2, an
    odd sequence) and the TP-1 path over two data groups; reduced jamba's
    Mamba-1 and reduced mamba2's Mamba-2 layer (TP 2). The objective is a
    fixed linear map of the output plus the aux losses (the data groups'
    objectives summed at TP 1); every leaf's gradient (this rank's shard
    of a model-sharded leaf; at TP 1 summed over the data group, as the
    train step sums) and the input's within LAYER_GRAD_RTOL of its
    greatest element (f32 rounding of sums taken in another order)."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.models.mamba import mamba1_apply, mamba1_param_defs, mamba2_apply, mamba2_param_defs
    from repro_torch.models.moe import moe_apply, moe_param_defs
    from repro_torch.models.params import tree_map_with_path
    from repro_torch.parallel.collectives import all_reduce_leaves

    dev, errs = pool.device, {}
    moon, jamba, mamba2 = (reduced(get_config(n)) for n in ("moonshot-v1-16b-a3b", "jamba-v0.1-52b", "mamba2-2.7b"))

    def moe_fn(cfg):
        def run(b, x, n_pool):
            y, aux = moe_apply(b, x, cfg, n_pool)
            return y, 3.0 * aux["lb"] + 5.0 * aux["z"]
        return run

    def mamba_fn(apply, cfg):
        return lambda b, x, n_pool: (apply(b, x, cfg=cfg, mode="prefill")[0], 0.0)

    cases = {"moe_sharded": (moon, moe_param_defs(moon), moe_fn(moon), 2, (2, 8)),
             "moe_decode": (moon, moe_param_defs(moon), moe_fn(moon), 2, (2, 3)),
             "moe_tp1": (moon, moe_param_defs(moon), moe_fn(moon), 1, (4, 4)),
             "mamba1": (jamba, mamba1_param_defs(jamba), mamba_fn(mamba1_apply, jamba), 2, (2, 16)),
             "mamba2": (mamba2, mamba2_param_defs(mamba2), mamba_fn(mamba2_apply, mamba2), 2, (2, 16))}
    for name, (cfg, defs, fn, tp, (B, S)) in cases.items():
        g = torch.Generator().manual_seed(8)
        params = init_params(defs, g)
        x0 = torch.randn((B, S, cfg.d_model), generator=g).to(dev)
        weight = (0.1 * torch.randn((B, S, cfg.d_model), generator=g)).to(dev)
        lv = pool.level(tp)
        rows = slice(lv.data_rank * (B // lv.dp), (lv.data_rank + 1) * (B // lv.dp))
        # one process: every rank of the TP group here, the whole batch; the data groups' objectives summed
        one = WeightStore(cfg, defs, [dev] * tp)
        whole = tree_map(lambda t: t.clone().to(dev).requires_grad_(True), params)
        x = x0.clone().requires_grad_(True)
        y, aux = fn(one.rebind(one.build(whole), tp), x, pool.world)
        ((y * weight).sum() + lv.dp * aux).backward()
        # across the pool: this rank's shards, its data group's rows
        store = WeightStore(cfg, defs, pool.devices, storage_tp=tp, pool=pool)
        mine = tree_map_with_path(lambda path, t: store.lay(path, t.to(dev), pool.rank).requires_grad_(True), params)
        xr = x0[rows].clone().requires_grad_(True)
        y, aux = fn(store.rebind(store.storage_of(mine), tp), xr, pool.world)
        ((y * weight[rows]).sum() + aux).backward()
        _held(errs, name, xr.grad, x.grad[rows], scaled=True)
        got = list(tree_leaves_with_path(mine))
        all_reduce_leaves([t.grad for _, t in got], lv.data)
        for (path, t), (_, w) in zip(got, tree_leaves_with_path(whole)):
            dim = store.plans[path].dim
            want = w.grad if dim is None or tp == 1 else w.grad.narrow(dim, lv.model_rank * t.shape[dim], t.shape[dim])
            _held(errs, name, t.grad, want, scaled=True)
    return errs


# check_train_bf16's cases: name -> (model, TP, steps); at world 4 the mesh is (data 4/TP, model TP). Beyond the
# dense layers, the MoE's sharded path and its decode path's psum (moonshot at (2, 2)), its bf16 all-to-all over 4
# ranks (1, 4), the aux losses' pmean, and Mamba's shared reductions (jamba: Mamba-1 and MoE; mamba2)
TRAIN_BF16_CASES = {"danube_2x2": ("h2o-danube-1.8b", 2, 3),
                    "moonshot_2x2": ("moonshot-v1-16b-a3b", 2, 3),
                    "moonshot_1x4": ("moonshot-v1-16b-a3b", 4, 3),
                    "jamba_2x2": ("jamba-v0.1-52b", 2, 3),
                    "mamba2_2x2": ("mamba2-2.7b", 2, 3)}
BF16_OWN_FAN_IN = ("jamba-v0.1-52b",)  # drawn at each layer's own fan-in (TRAIN_MOE_CASES' jamba_2x2)


def check_train_bf16(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The pool's train step on bf16 parameters with f32 moments (the
    reference's ``AdamWConfig.dtype``), each case of TRAIN_BF16_CASES,
    reduced config at (data N/TP, model TP) under DEFAULT_RULES,
    check_train_moe's optimizer and batches: the gradients of batch 0
    (bf16, summed over the data group in f32 and rounded once, as the
    reference's compiled psum of the parameter-dtype gradient; every bf16
    sum across ranks so, ``collectives._summed``), then the case's steps (the ZeRO-1
    slices gathered in bf16), the replication checked after every step.
    Weights: ``inputs["params"][case]`` (the reference's bf16 values as
    f32 arrays), else seed 0 on this rank's device, cast to bf16. Rank 0's
    arrays: each case's gathered gradients, losses and parameters, as f32;
    a caller holds them to the reference's bf16 mesh step."""
    from repro_torch.checkpoint.convert import to_numpy, to_torch
    from repro_torch.models.params import per_layer_fan_in
    from repro_torch.training.train_step import gather_params

    inputs = inputs or {}
    dev, tcfg = pool.device, _train_cfg({"warmup_steps": 2})
    summary, arrays = {}, {}
    for name in inputs.get("cases", list(TRAIN_BF16_CASES)):
        model, tp, steps = TRAIN_BF16_CASES[name]
        cfg = reduced(get_config(model))
        if name in inputs.get("params", {}):
            params0 = to_torch(inputs["params"][name], dev, torch.bfloat16)
        else:
            defs = model_param_defs(cfg, make_exec_config(cfg, tp))
            defs = per_layer_fan_in(defs) if model in BF16_OWN_FAN_IN else defs
            params0 = init_params(defs, torch.Generator(dev).manual_seed(0), torch.bfloat16)
        ds = SyntheticDataset(cfg, batch=4, seq=32)
        step, mine, opt = pool_step(pool, cfg, params0, tcfg, tp)
        grads = gather_params(step.gradients(ds.at(0))[2], step.layout)
        run = checked(pool, step)
        losses = [float(run(mine, opt, ds.at(i))[2]["loss"]) for i in range(steps)]
        whole = gather_params(mine, step.layout)
        dtypes = sorted({str(t.dtype) for _, t in tree_leaves_with_path(whole)} | {str(t.dtype) for _, t in
                                                                                   tree_leaves_with_path(grads)})
        summary[name] = {"model": cfg.name, "mesh": {"data": pool.world // tp, "model": tp}, "losses": losses,
                         "dtypes": dtypes, "replicated_after_every_step": True}
        if pool.rank == 0:
            arrays[name] = {"grads": to_numpy(grads), "losses": losses, "params": to_numpy(whole)}
        del step, mine, opt, grads, whole
    return {"summary": summary, "arrays": arrays}


# check_train_one's cases: name -> (model, dtype, layers or None for the reduced config's)
TRAIN_ONE_CASES = {"danube_f32": ("h2o-danube-1.8b", torch.float32, None),
                   "danube_bf16": ("h2o-danube-1.8b", torch.bfloat16, None),
                   "jamba_bf16": ("jamba-v0.1-52b", torch.bfloat16, 1)}


def _bitwise_trees(a: dict, b: dict) -> List[str]:
    """The leaves of two trees (of one order) that differ in any bit."""
    return ["/".join(path) for (path, x), (_, y) in zip(tree_leaves_with_path(a), tree_leaves_with_path(b))
            if not torch.equal(x.detach(), y.detach().to(x.device))]


def check_train_one(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """A pool of one process against the one-process train step, each case
    of TRAIN_ONE_CASES (reduced config, jamba cut to its first layer,
    check_train_moe's optimizer and batches, weights from seed 0 in the
    case's dtype): the gradients of batch 0, then three steps' losses and
    parameters, bit for bit (under torch's deterministic algorithms, as a
    card runs them). Raises where a bit differs; returns each case's
    losses."""
    from repro_torch.testing.multicard import deterministic
    from repro_torch.training.train_step import gather_params

    if pool.world != 1:
        raise ValueError(f"check_train_one runs on a pool of one process, not {pool.world}")
    dev, tcfg = pool.device, _train_cfg({"warmup_steps": 2})
    summary = {}
    for name, (model, dtype, layers) in TRAIN_ONE_CASES.items():
        cfg = reduced(get_config(model))
        if layers is not None:
            cfg = replace(cfg, num_layers=layers, pattern=cfg.layer_pattern[:layers])
        defs = model_param_defs(cfg, make_exec_config(cfg, 1))
        params0 = init_params(defs, torch.Generator(dev).manual_seed(0), dtype)
        ds = SyntheticDataset(cfg, batch=4, seq=32)
        with deterministic():
            one = tree_map(lambda t: t.detach().clone(), params0)
            one_step, _ = make_train_step(cfg, make_exec_config(cfg, 1), one, tcfg)
            one_opt = init_opt_state(one, tcfg)
            step, mine, opt = pool_step(pool, cfg, params0, tcfg, 1)
            g_one = tree_map(lambda g: g.detach().clone(), one_step.gradients(ds.at(0))[2])
            g_pool = gather_params(step.gradients(ds.at(0))[2], step.layout)
            failures = [f"gradient {leaf}" for leaf in _bitwise_trees(g_pool, g_one)]
            losses = []
            for i in range(3):
                a = float(one_step(one, one_opt, ds.at(i))[2]["loss"])
                b = float(step(mine, opt, ds.at(i))[2]["loss"])
                losses.append((a, b))
            failures += [f"losses {losses}"] if any(a != b for a, b in losses) else []
            failures += [f"parameter {leaf}" for leaf in _bitwise_trees(gather_params(mine, step.layout), one)]
        if failures:
            raise AssertionError(f"train_one {name}: the pool of one against one process: {failures}")
        summary[name] = {"model": cfg.name, "dtype": str(dtype), "layers": cfg.num_layers,
                         "losses": [a for a, _ in losses], "bitwise": True}
    return {"summary": summary}


# ---------------------------------------------------------------------------
# the pipeline schedule across processes
# ---------------------------------------------------------------------------
PIPE_TOL = 2e-5  # tests/test_pipeline.py's bound; gradients over each leaf's max |g|
PIPE_MESHES = {4: [("pipe4", 4, 1), ("pipe2_data2", 2, 1), ("pipe2_model2", 2, 2)]}  # (name, stages, tp)


def pipe_meshes(world: int) -> list:
    """The (name, stages, tp) meshes the pipeline check runs on a pool of
    ``world``: at 4 the reference's three, else every rank a stage."""
    return PIPE_MESHES.get(world, [(f"pipe{world}", world, 1)])


def toy_body(h: torch.Tensor, p: dict, k: int) -> torch.Tensor:
    """tests/test_pipeline.py's period: tanh(h @ w)."""
    return torch.tanh(h @ p["w"])


def toy_arrays() -> dict:
    """tests/test_pipeline.py's shapes (its draws are jax's), from a seed:
    w (8 periods, 32, 32) at std 0.3, h0 (4 microbatches, 2, 8, 32)."""
    rng = np.random.RandomState(0)
    return {"w": (rng.randn(8, 32, 32) * 0.3).astype(np.float32),
            "h0": rng.randn(4, 2, 8, 32).astype(np.float32)}


def decoder_body(cfg: ModelConfig, S: int, block: int = 512):
    """pipeline_apply's body of one dense decoder layer of ``cfg`` in train
    mode (``model.decoder_layer``, the layer ``forward`` runs), recomputed
    in backward as a train step's layers are: one period
    of ``model_param_defs``' canonical "periods"/"pos0" leaves, bound at
    TP 1 in this process (every model-sharded leaf a ``ShardView`` of its
    whole matrix), over hidden states (B, S, D) at positions 0..S-1."""
    import functools

    from torch.utils.checkpoint import checkpoint

    from repro_torch.models.attention import live_blocks
    from repro_torch.models.model import decoder_layer, layer_templates, layer_windows
    from repro_torch.parallel.sharding import as_matrix, model_dim_of

    ec = make_exec_config(cfg, 1)
    defs = model_param_defs(cfg, ec)["periods"]["pos0"]
    t, window = layer_templates(cfg)[0], layer_windows(cfg)[0]
    if not t.mixer.startswith("attn") or t.ffn != "dense":
        raise ValueError(f"{cfg.name}: a dense decoder layer, not {t}")
    live = live_blocks(torch.arange(S), window, block, block)

    def bind(path, x):
        d = functools.reduce(lambda tree, key: tree[key], path, defs)
        k = model_dim_of(d.axes)
        if k is None:
            return x
        mat, unit = as_matrix(x, k - 1)  # the period's slice: one dim fewer
        return ShardView((mat,), (0,), d.shape[k] * unit)

    def layer(h, lp):
        pos = torch.arange(S, device=h.device)
        return decoder_layer(h, lp, t, window, cfg=cfg, ec=ec, mode="train", positions=pos, live=live, block_q=block,
                             block_k=block)[0]

    def body(h, p, k):
        return checkpoint(layer, h, tree_map_with_path(bind, p), use_reentrant=False, preserve_rng_state=False)

    return body


def stack_params(cfg: ModelConfig, n_periods: int, dev: torch.device, seed: int = 0) -> dict:
    """``n_periods`` periods of ``cfg``'s "periods"/"pos0" leaves drawn as
    ``init_params`` draws them (at each layer's own fan-in), on ``dev``."""
    from repro_torch.models.params import per_layer_fan_in

    defs = model_param_defs(replace(cfg, num_layers=n_periods * len(cfg.layer_pattern)), make_exec_config(cfg, 1))
    return init_params(per_layer_fan_in(defs)["periods"]["pos0"], torch.Generator(dev).manual_seed(seed),
                       torch.float32)


def sequential_stack(body, params: dict, h0: torch.Tensor, n_periods: int) -> dict:
    """One process: every period over every microbatch in turn, and the
    gradient of the sum of squares of the result; {"out", "dh0", "grads"}."""
    params = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    h0 = h0.detach().clone().requires_grad_(True)
    outs = []
    for m in range(h0.shape[0]):
        h = h0[m]
        for i in range(n_periods):
            h = body(h, tree_map(lambda x: x[i], params), i)
        outs.append(h)
    out = torch.stack(outs)
    (out.float() ** 2).sum().backward()
    return {"out": out.detach(), "dh0": h0.grad, "grads": tree_map(lambda x: x.grad, params)}


def pipe_run(mesh, body, params: dict, h0: torch.Tensor, n_periods: int) -> dict:
    """``pipeline_apply`` on this process's part of the whole ``params`` and
    ``h0`` (its stage's periods, its data rank's rows), then the gradient
    of the sum of squares of its result (each process's share of the whole
    result's), its stage's gradients summed over the mesh's data group:
    {"out", "dh0", "grads", "periods" (first, last + 1), "rows"}."""
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.parallel.pipeline import pipeline_apply

    c, shape = mesh.coords, mesh.shape
    per = n_periods // shape["pipe"]
    periods = (c["pipe"] * per, (c["pipe"] + 1) * per)
    n = h0.shape[1] // shape["data"]
    rows = (c["data"] * n, (c["data"] + 1) * n)
    mine = tree_map(lambda x: x[periods[0]:periods[1]].detach().clone().requires_grad_(True), params)
    h = h0[:, rows[0]:rows[1]].detach().clone().requires_grad_(True)
    out = pipeline_apply(body, mine, h, mesh, n_periods)
    (out.float() ** 2).sum().backward()
    grads = tree_map(lambda x: x.grad, mine)
    if shape["data"] > 1:
        for _, g in tree_leaves_with_path(grads):
            all_reduce(g, mesh.groups["data"])
    return {"out": out.detach(), "dh0": h.grad, "grads": grads, "periods": periods, "rows": rows}


def pipe_errs(got: dict, want: dict) -> dict:
    """A pipe_run's result against the sequential stack's, each over its
    greatest element: the output, the worst gradient leaf and (stage 0)
    dh0."""
    r0, r1 = got["rows"]
    p0, p1 = got["periods"]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))

    gw = {path: g for path, g in tree_leaves_with_path(want["grads"])}
    errs = {"out": rel(got["out"], want["out"][:, r0:r1]),
            "grads": max(rel(g, gw[path][p0:p1]) for path, g in tree_leaves_with_path(got["grads"]))}
    if got["dh0"] is not None:  # stage 0's: the others do not read h0
        errs["dh0"] = rel(got["dh0"], want["dh0"][:, r0:r1])
    return errs


def check_pipeline(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """The pipeline schedule across processes at each mesh of
    ``pipe_meshes`` against the sequential stack in one process: the
    reference's toy body (tanh(h @ w), 8 periods, 4 microbatches) and a
    reduced llama3-8b decoder layer (8 periods, 4 microbatches of (2, 16)),
    the output, dh0 and each stage's gradients summed over its data group
    within PIPE_TOL of their greatest element; the gradient is the
    sequential stack's, not a multiple of it. With ``inputs`` {"toy": {"w",
    "h0"}}: those arrays; every rank's toy pieces are returned for a caller
    that holds them to the reference."""
    from repro_torch.parallel.pipeline import make_pipe_mesh

    dev = pool.device
    toy = (inputs or {}).get("toy") or toy_arrays()
    cfg = reduced(get_config("llama3-8b"))
    cases = {
        "toy": (toy_body, {"w": torch.as_tensor(toy["w"], device=dev)}, torch.as_tensor(toy["h0"], device=dev),
                toy["w"].shape[0]),
        "llama": (decoder_body(cfg, 16, block=8), stack_params(cfg, 8, dev),
                  torch.randn(4, 2, 16, cfg.d_model, generator=torch.Generator(dev).manual_seed(1), device=dev), 8),
    }
    want = {which: sequential_stack(body, params, h0, n) for which, (body, params, h0, n) in cases.items()}
    summary, pieces = {}, {}
    for name, stages, tp in pipe_meshes(pool.world):
        mesh = make_pipe_mesh(pool.devices, stages, tp, pool=pool)
        for which, (body, params, h0, n) in cases.items():
            got = pipe_run(mesh, body, params, h0, n)
            errs = pipe_errs(got, want[which])
            if max(errs.values()) > PIPE_TOL:
                raise AssertionError(f"pipeline {name} {which} on rank {pool.rank} {mesh.coords}: {errs}")
            summary[f"{name}/{which}"] = errs
            if which == "toy":
                pieces[name] = {"coords": mesh.coords, "periods": got["periods"], "rows": got["rows"],
                                "out": got["out"].cpu().numpy(),
                                "dh0": None if got["dh0"] is None else got["dh0"].cpu().numpy(),
                                "dw": got["grads"]["w"].cpu().numpy()}
        pool.barrier()
    return {"summary": summary, "toy": pieces}


def check_profile(pool: Pool, inputs: Optional[dict] = None) -> dict:
    """``profile_engine`` over ``ServingEngine(pool=...)``: reduced
    llama3-8b with 4 KV heads (``engine_cfg``), every TP level the pool
    runs, decode batches (1, 4, 8) of 8 slots at ctx 64 and prefill buckets
    16/32; every rank's table equal (the values' bits all-gathered), the
    engine's TP level unchanged, every value positive. Returns the table as
    the reference's JSON lists."""
    from repro_torch.profiles.profiler import profile_engine
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = engine_cfg("llama3-8b")
    eng = ServingEngine(cfg, engine_params(cfg, pool.device, inputs),
                        EngineConfig(candidate_tps=(1, 2, 4, 8), n_slots=8, max_len=96, prefill_buckets=(16, 32),
                                     dtype=torch.float32), pool=pool)
    table = profile_engine(eng, batches=(1, 4, 8), ctxs=(64,))
    vals = torch.tensor([*table.decode_s.values(), *table.prefill_s.values()], dtype=torch.float64,
                        device=pool.device)
    every = all_gather(vals[None], pool.world_group, 0)
    if not bool((every == every[:1]).all()) or not bool((vals > 0).all()) or eng.tp != eng.tps[0]:
        raise AssertionError(f"profile over the pool: rank {pool.rank}'s table differs, or a value is not positive")
    decode = [[*k, v] for k, v in table.decode_s.items()]
    prefill = [[*k, v] for k, v in table.prefill_s.items()]
    return {"summary": {"tps": eng.tps, "decode": len(decode), "prefill": len(prefill)},
            "table": {"decode": decode, "prefill": prefill}}


POOL_CHECKS = {
    "collectives": (check_collectives, 4),
    "weight_store": (check_weight_store, 8),
    "moe_sharded": (check_moe_sharded, 4),
    "migration": (check_migration, 8),
    "fault_abort": (check_fault_abort, 8),
    "engine": (check_engine, 4),
    "train_step": (check_train_step_pool, 4),
    "train_grads": (check_train_grads, 2),
    "train_moe": (check_train_moe, 4),
    "train_rules": (check_train_rules, 4),
    "train_bf16": (check_train_bf16, 4),
    "train_one": (check_train_one, 1),
    "pipeline": (check_pipeline, 4),
    "profile": (check_profile, 2),
}
MODEL_CHECKS = ("engine", "migration")  # the checks ``--model`` gives a reduced config (``engine_cfg``)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
def check_train_step(device=None, steps: int = 5) -> dict:
    """Sharded (data x model) train step == single-rank train step, with
    ZeRO-1 sharded optimizer state and f32 numerics. Returns the losses,
    the worst parameter difference and the update distance; raises if a
    tolerance (UPDATE_RTOL too) is missed."""
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
    dist = param_distance(params, ref_params, moved_from(ref_params, dict(tree_leaves_with_path(params0))))
    if dist["outside"] is not None or not dist["update_rel"] < UPDATE_RTOL:
        raise AssertionError(f"train_step: parameters against the single rank's: {dist}")
    split = sum(d is not None for d in plan.dims.values())
    return {"losses_single": losses_ref, "losses_sharded": losses_sh, "max_param_diff": dist["param_abs"],
            "update_rel": dist["update_rel"], "zero1_split_leaves": split, "leaves": len(plan.dims)}


CHECKS = {"train_step": check_train_step}


# ---------------------------------------------------------------------------
# spawning the pool
# ---------------------------------------------------------------------------
def _worker(rank: int, world: int, device: str, names: List[str], workdir: str, task: Optional[str]) -> None:
    torch.set_num_threads(1)
    if device == "cuda":  # not inherited by a spawned process: the backward's f32 products need it
        torch.backends.cuda.matmul.allow_tf32 = False
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
    if name in CHECKS and not (len(argv) > 1 and argv[1].isdigit()):  # the one-process check
        out = CHECKS[name](argv[1] if len(argv) > 1 else None)
        print(f"OK {name}: {out}")
        return 0
    opts: Dict[str, str] = {}
    for flag in ("--inputs", "--out", "--model"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    names = list(POOL_CHECKS) if name == "all" else name.split(",")
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
