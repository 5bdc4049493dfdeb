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
for the Mamba families, their recurrent state (``PerfModel.state_bytes``).
``MigrationModel`` is the reference's analytic latency model (paper Fig.
7), priced with a ``HardwareSpec``: at ``V5E`` the reference's numbers, at
``H100`` the card's (its link fields are published figures, not measured).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
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
