"""KV migration for TP switching (paper §3.2.2), mirroring
repro/core/migration.py.

Two paths:
  * ``migrate_cache`` - the engine's. In one process the engine keeps its
    dense slot cache in one layout for every TP level (KV heads at the
    largest candidate TP, a Mamba layer's state and conv tail whole) on the
    device it runs on, so a switch moves no cache byte: ``Tensor.to`` of a
    tensor already on the target device returns that tensor. Across
    processes each rank holds one block of the cache, (its data group's
    slots) x (its model group's KV heads, or a Mamba state's channels)
    (``cache_shardings``, the reference's ``batch -> data``, ``act_kv ->
    model``, ``inner -> model``), so a switch
    reshards: each rank sends every other rank the part of its block that
    the new layout gives that rank and receives its own, in one
    ``all_to_all_single`` over the pool (NCCL between the cards), into the
    new level's buffers.
  * ``migrate_pages`` - the paper's aggregated migration of a paged pool,
    as the reference documents it: the sequences' fragmented pages are
    gathered (kernels/kv_gather) into one contiguous staging buffer per kind,
    transferred, and scattered (kv_scatter) into the receiving pool's
    pages. In one process the transfer is ``Tensor.to`` (the identity on
    one card, a copy between two cards of the process); between two ranks
    of a pool it is a send from the source card and a receive on the
    destination card. The overlap of gather and send in staging chunks
    (``MigrationModel.pipelined_s``) is modelled, not run.

Both are abort-safe: nothing of the source is written, and across
processes the ranks agree on a flag before anything is sent, so a failure
on any rank raises ``MigrationAborted`` on every rank and leaves none
waiting in a collective.

``kv_migration_bytes`` is the reference's byte count for attention KV and,
for the Mamba families, their recurrent state (``PerfModel.state_bytes``).
``MigrationModel`` is the reference's analytic latency model (paper Fig.
7), priced with a ``HardwareSpec``: at ``V5E`` the reference's numbers, at
``H100`` the card's (its link fields are published figures, not measured).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
from repro_torch.models.params import ParamDef
from repro_torch.parallel.collectives import Pool, agree, coords, exchange
from repro_torch.parallel.sharding import pool_axis
from repro_torch.profiles.perf_model import V5E, HardwareSpec, PerfModel
from repro_torch.serving.kv_cache import PagedPool


class MigrationAborted(RuntimeError):
    """The source cache is untouched: migration builds new tensors and
    frees or mutates nothing of the source, so after an abort the caller
    can retry or restart the sequences."""


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(f, v) for v in tree)
    return f(tree)


@dataclass(frozen=True)
class CacheShardings:
    """Where each block of the slot cache lives at TP ``tp`` of a pool of
    ``world`` ranks: rank d holds, of every leaf, the slots of its data
    coordinate d % (N/t) and, of every axis the rules shard over "model"
    (KV heads, a Mamba state's channels), the part of its model coordinate
    d // (N/t); every other axis whole."""

    defs: tuple  # per layer {name: ParamDef} of the whole cache
    world: int
    tp: int

    def block(self, rank: int, d: ParamDef) -> Tuple[Tuple[int, int], ...]:
        """(lo, hi) of every dim of leaf ``d`` that ``rank`` holds."""
        data, model = coords(rank, self.world, self.tp)
        where = {"data": (data, self.world // self.tp), "model": (model, self.tp), None: (0, 1)}
        out = []
        for n, ax in zip(d.shape, d.axes):
            i, ways = where[pool_axis(ax)]
            out.append((i * n // ways, (i + 1) * n // ways))
        return tuple(out)


def cache_shardings(defs: Sequence[dict], world: int, tp: int) -> CacheShardings:
    """The layout of a slot cache of ``defs`` at TP ``tp`` of a pool of
    ``world`` ranks (mirrors the reference's ``cache_shardings``)."""
    bad = [f"{name} {d.axes}" for layer in defs for name, d in layer.items() if "batch" not in d.axes]
    if bad or world % tp:
        raise ValueError(f"no layout at TP {tp} of {world} ranks for {bad}")
    return CacheShardings(tuple(defs), world, tp)


def _pieces(src: CacheShardings, dst: CacheShardings, s_rank: int, d_rank: int):
    """Per leaf (layer, name), the slices of ``s_rank``'s block at ``src``
    and of ``d_rank``'s block at ``dst`` that hold the same elements (None
    where the blocks do not meet)."""
    out = []
    for layer in src.defs:
        for name, d in layer.items():
            a, b = src.block(s_rank, d), dst.block(d_rank, d)
            lo = [max(x[0], y[0]) for x, y in zip(a, b)]
            hi = [min(x[1], y[1]) for x, y in zip(a, b)]
            if any(l >= h for l, h in zip(lo, hi)):
                out.append(None)
                continue
            out.append((tuple(slice(l - x[0], h - x[0]) for l, h, x in zip(lo, hi, a)),
                        tuple(slice(l - y[0], h - y[0]) for l, h, y in zip(lo, hi, b))))
    return out


def moved_bytes(src: CacheShardings, dst: CacheShardings, dtype_bytes: int) -> int:
    """Bytes a reshard from ``src`` to ``dst`` sends between two different
    ranks (what crosses the links), summed over the pool."""
    total = 0
    for s_rank in range(src.world):
        for d_rank in range(dst.world):
            if s_rank == d_rank:
                continue
            for piece in _pieces(src, dst, s_rank, d_rank):
                if piece is not None:
                    total += math.prod(sl.stop - sl.start for sl in piece[0]) * dtype_bytes
    return total


def migrate_cache(cache, target, *, source: Optional[CacheShardings] = None, pool: Optional[Pool] = None,
                  into=None) -> Tuple[object, float]:
    """Move the cache to ``target``; returns (cache, seconds).

    In one process (no ``pool``) ``target`` is a device and every cache
    tensor is placed on it. Across processes ``cache`` is this rank's block
    at the ``source`` layout and ``target`` a ``CacheShardings``: every rank
    of ``pool`` calls this together, and each gets its block at ``target``,
    written into ``into`` (this rank's cache tensors at ``target``, which
    keep their addresses) or into new tensors.

    The time covers the copies to their end (the device is synchronised).
    Any failure raises ``MigrationAborted`` with the source cache intact;
    across processes on every rank.
    """
    t0 = time.perf_counter()
    if pool is not None:
        return _reshard(cache, target, source, pool, into, t0)
    try:
        target = torch.device(target)
        out = _map(lambda t: t.to(target), cache)
        if target.type == "cuda":
            torch.cuda.synchronize(target)
    except Exception as e:  # any failure of the move aborts it; the source is intact
        raise MigrationAborted(f"cache migration aborted: {e}") from e
    return out, time.perf_counter() - t0


def _reshard(cache, target, source, pool: Pool, into, t0: float):
    me, world = pool.rank, pool.world
    err = None
    try:
        if not isinstance(target, CacheShardings) or not isinstance(source, CacheShardings):
            raise TypeError(f"a reshard goes from one CacheShardings to another, not {type(source)} -> {type(target)}")
        if source.world != world or target.world != world:
            raise ValueError(f"layouts of {source.world} / {target.world} ranks in a pool of {world}")
        leaves = [t for layer in cache for t in layer.values()]
        defs = [d for layer in target.defs for d in layer.values()]
        if into is None:
            into = [{name: torch.empty(tuple(hi - lo for lo, hi in target.block(me, d)), dtype=leaves[0].dtype,
                                       device=leaves[0].device) for name, d in layer.items()} for layer in target.defs]
        outs = [t for layer in into for t in layer.values()]
        for t, d, blk in ((t, d, source.block(me, d)) for t, d in zip(leaves, defs)):
            if tuple(t.shape) != tuple(hi - lo for lo, hi in blk):
                raise ValueError(f"this rank's cache {tuple(t.shape)} is not its block {blk} of {d.shape}")
        for t, d in zip(outs, defs):
            if tuple(t.shape) != tuple(hi - lo for lo, hi in target.block(me, d)) or t.dtype != leaves[0].dtype:
                raise ValueError(f"target tensor {tuple(t.shape)} {t.dtype} is not this rank's block of {d.shape}")
        send = []
        for d_rank in range(world):  # this rank's part of each leaf that d_rank holds at the target
            parts = [leaves[i][piece[0]].reshape(-1) for i, piece in enumerate(_pieces(source, target, me, d_rank))
                     if piece is not None]
            send.append(torch.cat(parts) if parts else leaves[0].new_empty(0))
        recv_plan = [_pieces(source, target, s_rank, me) for s_rank in range(world)]
        recv_numels = [sum(math.prod(sl.stop - sl.start for sl in p[1]) for p in plan if p is not None)
                       for plan in recv_plan]
    except Exception as e:  # noqa: BLE001  (any failure: the ranks agree to abort)
        err = e
    if not agree(err is None, pool.world_group):
        raise MigrationAborted(f"cache reshard aborted on rank {me}: "
                               f"{err if err is not None else 'another rank failed'}") from err
    got = exchange(send, pool.world_group, recv_numels)
    for flat, plan in zip(got, recv_plan):
        off = 0
        for i, piece in enumerate(plan):
            if piece is None:
                continue
            view = outs[i][piece[1]]
            n = view.numel()
            view.copy_(flat[off:off + n].view(view.shape))
            off += n
    if pool.device.type == "cuda":
        torch.cuda.synchronize(pool.device)
    return into, time.perf_counter() - t0


def migrate_pages(src: PagedPool, dst: PagedPool, seq_ids: Sequence[int],
                  ranks: Optional[Tuple[int, int]] = None) -> Tuple[np.ndarray, float]:
    """Move sequences' KV from ``src`` into newly allocated pages of ``dst``.

    Each sequence is allocated in ``dst`` with its length in ``src``; its
    pages of every layer are gathered into one contiguous staging buffer per
    kind (K, V) and scattered into its ``dst`` pages: 2 gather and 2 scatter
    launches per call, whatever the number of layers. Returns ``dst``'s block
    tables for ``seq_ids`` and the seconds taken (the copies run to their
    end: the device is synchronised).

    Between two ranks of a pool, ``ranks`` = (source rank, destination
    rank): both call this with the same arguments, each holding its own
    pool's pages and the other's bookkeeping only (e.g. a pool on the
    ``meta`` device), so both allocate alike. The source gathers and sends
    each staging buffer to the destination's card; the destination receives
    it and scatters. The two agree on a flag first.

    ``src`` is never mutated; releasing its sequences is the caller's
    choice. If ``dst`` cannot hold the sequences, or anything else fails,
    every allocation made in ``dst`` is undone (tables, lengths and the
    free list's order as before) and ``MigrationAborted`` is raised (on
    both ranks). Pages that the failed call wrote to are free again, so
    their contents do not matter.
    """
    t0 = time.perf_counter()
    seq_ids: List[int] = list(seq_ids)
    free_before = deque(dst.free_pages)
    allocated: List[int] = []

    def undo():
        for s in allocated:
            dst.tables.pop(s)
            dst.seq_lens.pop(s)
        dst.free_pages = free_before

    local = peer = None
    if ranks is not None:
        import torch.distributed as dist

        me = dist.get_rank()
        if me not in ranks or ranks[0] == ranks[1]:  # no peer to tell: nothing was allocated
            raise MigrationAborted(f"page migration aborted: rank {me} is not one of the two ranks {ranks}")
        local, peer = (src, ranks[1]) if me == ranks[0] else (dst, ranks[0])
    err = None
    try:
        differ = [f"{a} {getattr(src, a)} != {getattr(dst, a)}"
                  for a in ("page_size", "kv_heads", "head_dim", "n_layers", "dtype") if getattr(src, a) != getattr(dst, a)]
        if differ:
            raise ValueError("src and dst pools differ: " + ", ".join(differ))
        if len(set(seq_ids)) != len(seq_ids):
            raise ValueError(f"repeated sequence ids in {seq_ids}")
        for s in seq_ids:
            if s in dst.tables:
                raise ValueError(f"sequence {s} already lives in dst")
            if not dst.alloc_seq(s, src.seq_lens[s]):
                raise ValueError(f"dst has {len(dst.free_pages)} free pages, too few for sequence {s}")
            allocated.append(s)
        src_rows = src.row_ids(src.migration_page_ids(seq_ids))
        dst_rows = dst.row_ids(dst.migration_page_ids(seq_ids))
        if local is not None and local.device.type == "meta":
            raise ValueError("this rank's own pool is on the meta device")
    except Exception as e:  # noqa: BLE001  (any failure aborts the move; src was only read)
        err = e
    if ranks is not None and not _agree_pair(err is None, peer):
        err = err or RuntimeError("the other rank failed")
    if err is not None:
        undo()
        raise MigrationAborted(f"page migration aborted: {err}") from err
    try:
        for kind in ("k", "v"):
            if ranks is None:
                staged = kv_gather(src.page_rows(kind), src_rows)
                staged = staged.to(dst.device)  # the transfer: the identity on one device
                kv_scatter(dst.page_rows(kind), staged, dst_rows)
            elif local is src:  # to the destination's card
                _p2p(dist.isend, kv_gather(src.page_rows(kind), src_rows), peer)
            else:
                staged = torch.empty((len(dst_rows), dst.page_rows(kind).shape[1]), dtype=dst.dtype, device=dst.device)
                _p2p(dist.irecv, staged, peer)
                kv_scatter(dst.page_rows(kind), staged, dst_rows)
            staged = None
        for dev in {src.device, dst.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    except Exception as e:  # any failure aborts the move; src was only read
        undo()
        raise MigrationAborted(f"page migration aborted: {e}") from e
    return dst.block_table_array(seq_ids), time.perf_counter() - t0


def _p2p(op, t: torch.Tensor, peer: int) -> None:
    """One send or receive between the pair, as a batch of one (NCCL runs a
    batched point-to-point op on the pair's own communicator)."""
    import torch.distributed as dist

    for req in dist.batch_isend_irecv([dist.P2POp(op, t, peer)]):
        req.wait()


def _agree_pair(ok: bool, peer: int) -> bool:
    """Two ranks swap an ok flag (a send and a receive at once); True on
    both only if both are ok."""
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    theirs = torch.empty_like(mine)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer), dist.P2POp(dist.irecv, theirs, peer)]):
        req.wait()
    return bool(ok and theirs.item())


# ---------------------------------------------------------------------------
# Analytic migration-latency model (paper Fig. 7)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MigrationModel:
    hw: HardwareSpec = V5E
    page_bytes: int = 32 * 1024  # 16 tokens x 8 kv heads x 128 x 2B
    # per-op issue overhead: dominated by host-side descriptor setup for
    # small async copies; 50us/page reproduces the paper's measured Fig. 7
    # endpoints (0.88s naive @ 0.5GB, 24.8ms pipelined @ 5GB) on the
    # reference's V5E link constants (the reference's calibration, kept
    # as it is at every HardwareSpec).
    per_transfer_overhead_s: float = 50e-6
    staging_bytes: int = 16 * 1024 * 1024  # double-buffer stage size

    def ici_bw(self) -> float:
        return self.hw.ici_bw * self.hw.ici_links

    def naive_per_page_s(self, total_bytes: float) -> float:
        """cudaMemcpyAsync-per-page analogue: one transfer per page."""
        n_pages = max(int(np.ceil(total_bytes / self.page_bytes)), 1)
        # small transfers do not reach link bandwidth; model an effective
        # bandwidth that saturates with transfer size
        eff_bw = self.ici_bw() * self.page_bytes / (self.page_bytes + 256 * 1024)
        return n_pages * (self.per_transfer_overhead_s + self.page_bytes / eff_bw)

    def aggregated_s(self, total_bytes: float) -> float:
        """Gather all pages into one buffer, then one big transfer."""
        gather = total_bytes * 2 / (self.hw.hbm_bw * self.hw.bw_eff)  # r+w
        send = total_bytes / self.ici_bw() + self.per_transfer_overhead_s
        return gather + send

    def pipelined_s(self, total_bytes: float) -> float:
        """Nitsum: double-buffered overlap of gather and transmit."""
        gather = total_bytes * 2 / (self.hw.hbm_bw * self.hw.bw_eff)
        send = total_bytes / self.ici_bw()
        stage = self.staging_bytes
        fill = stage * 2 / (self.hw.hbm_bw * self.hw.bw_eff)
        return max(gather, send) + fill + self.per_transfer_overhead_s

    def migration_s(self, total_bytes: float, strategy: str = "pipelined") -> float:
        return {
            "naive": self.naive_per_page_s,
            "aggregated": self.aggregated_s,
            "pipelined": self.pipelined_s,
        }[strategy](total_bytes)


def kv_migration_bytes(
    cfg: ModelConfig, n_seqs: int, ctx_len: int, from_tp: int, to_tp: int,
    dtype_bytes: int = 2,
) -> float:
    """Bytes that must cross chips when re-partitioning KV heads.

    Head-repartitioning moves the fraction of heads whose owner changes;
    upper bound (paper's Fig. 6 worst case) is the full per-group cache. An
    SSM moves each sequence's recurrent state instead; a hybrid adds the
    state to each sequence's KV before the moved fraction, as the
    reference counts it.
    """
    if cfg.n_attn_layers == 0:  # SSM: migrate recurrent state instead
        return n_seqs * PerfModel(cfg).state_bytes()
    win = cfg.attn.window or ctx_len
    eff = min(ctx_len, win)
    per_seq = 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes * eff * cfg.n_attn_layers
    lo, hi = min(from_tp, to_tp), max(from_tp, to_tp)
    moved_frac = 1.0 - lo / hi  # heads staying on the same chip
    if cfg.mamba is not None:  # hybrid: add state bytes
        per_seq += PerfModel(cfg).state_bytes()
    return n_seqs * per_seq * moved_frac
