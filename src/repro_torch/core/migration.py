"""KV migration for TP switching (paper §3.2.2), mirroring
repro/core/migration.py.

Two paths:
  * ``migrate_cache`` - the engine's. The engine keeps its dense slot cache
    in one layout for every TP level (KV heads at the largest candidate TP,
    a Mamba layer's state and conv tail whole) on the device it runs on.
    On one card a switch therefore moves no cache byte: ``Tensor.to`` of a
    tensor already on the target device returns that tensor.
  * ``migrate_pages`` - the paper's aggregated migration of a paged pool,
    as the reference documents it: the sequences' fragmented pages are
    gathered (kernels/kv_gather) into one contiguous staging buffer per kind,
    transferred, and scattered (kv_scatter) into the receiving pool's
    pages. On one card the transfer is the identity; the move between cards
    (NCCL) and the overlap of gather and send come with the multi-card slice.

``kv_migration_bytes`` is the reference's byte count for attention KV and,
for the Mamba families, their recurrent state (``state_bytes``, the
reference's ``PerfModel._state_bytes_raw``). The analytic ``MigrationModel``
stays in the reference: its constants are a TPU's.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
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


def migrate_cache(cache, device: Union[str, torch.device]) -> Tuple[object, float]:
    """Place every cache tensor on ``device``; returns (cache, seconds).

    The time covers the copies to their end (the device is synchronised).
    Any failure raises ``MigrationAborted`` with the source cache intact.
    """
    t0 = time.perf_counter()
    try:
        target = torch.device(device)
        out = _map(lambda t: t.to(target), cache)
        if target.type == "cuda":
            torch.cuda.synchronize(target)
    except Exception as e:  # any failure of the move aborts it; the source is intact
        raise MigrationAborted(f"cache migration aborted: {e}") from e
    return out, time.perf_counter() - t0


def migrate_pages(src: PagedPool, dst: PagedPool, seq_ids: Sequence[int]) -> Tuple[np.ndarray, float]:
    """Move sequences' KV from ``src`` into newly allocated pages of ``dst``.

    Each sequence is allocated in ``dst`` with its length in ``src``; its
    pages of every layer are gathered into one contiguous staging buffer per
    kind (K, V) and scattered into its ``dst`` pages: 2 gather and 2 scatter
    launches per call, whatever the number of layers. Returns ``dst``'s block
    tables for ``seq_ids`` and the seconds taken (the copies run to their
    end: the device is synchronised).

    ``src`` is never mutated; releasing its sequences is the caller's
    choice. If ``dst`` cannot hold the sequences, or anything else fails,
    every allocation made in ``dst`` is undone (tables, lengths and the
    free list's order as before) and ``MigrationAborted`` is raised. Pages
    that the failed call wrote to are free again, so their contents do not
    matter.
    """
    t0 = time.perf_counter()
    seq_ids: List[int] = list(seq_ids)
    free_before = deque(dst.free_pages)
    allocated: List[int] = []
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
        for kind in ("k", "v"):
            staged = kv_gather(src.page_rows(kind), src_rows)
            staged = staged.to(dst.device)  # the transfer: the identity on one device
            kv_scatter(dst.page_rows(kind), staged, dst_rows)
            del staged
        if dst.device.type == "cuda":
            torch.cuda.synchronize(dst.device)
    except Exception as e:  # any failure aborts the move; src was only read
        for s in allocated:
            dst.tables.pop(s)
            dst.seq_lens.pop(s)
        dst.free_pages = free_before
        raise MigrationAborted(f"page migration aborted: {e}") from e
    return dst.block_table_array(seq_ids), time.perf_counter() - t0


def state_bytes(cfg: ModelConfig) -> float:
    """O(1) recurrent state of one sequence over every Mamba layer, in f32,
    conv tail excluded (the reference's ``PerfModel._state_bytes_raw``)."""
    if cfg.mamba is None:
        return 0.0
    m = cfg.mamba
    if m.version == 2:
        per = (cfg.d_inner // m.head_dim) * m.head_dim * m.d_state
    else:
        per = cfg.d_inner * m.d_state
    return per * cfg.n_mamba_layers * 4  # f32 state


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
        return n_seqs * state_bytes(cfg)
    win = cfg.attn.window or ctx_len
    eff = min(ctx_len, win)
    per_seq = 2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes * eff * cfg.n_attn_layers
    lo, hi = min(from_tp, to_tp), max(from_tp, to_tp)
    moved_frac = 1.0 - lo / hi  # heads staying on the same chip
    if cfg.mamba is not None:  # hybrid: add state bytes
        per_seq += state_bytes(cfg)
    return n_seqs * per_seq * moved_frac
