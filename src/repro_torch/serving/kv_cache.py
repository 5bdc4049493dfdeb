"""KV cache management (mirrors repro/serving/kv_cache.py). Two layouts:

  * SlotCache - the serving engine's dense slot cache, one K and one V
    tensor per layer: max_len rows a slot, or min(window, max_len) for a
    windowed layer's rotating buffer. Decode reads it through the
    paged-attention kernel: ``page_tables`` gives each layer identity block
    tables of Sc / page pages per slot (one table per cache length; the
    page is ``page_for(Sc)``, the largest divisor of Sc up to PAGE_SIZE,
    so any cache length is whole pages) and seq_lens = min(position + 1,
    Sc), and
    ``models.attention.decode_attention`` views each layer's cache as those
    pages, which gives exactly the reference's dense masked decode attention
    (a wrapped window buffer is all valid; attention does not depend on the
    order of the keys). A Mamba layer holds each slot's state and conv
    tail instead, {"ssd", "conv"} (mamba2) or {"h", "conv"} (mamba1), one
    row a slot, and takes no block table.
  * PagedPool - PagedAttention-style paged pool with free-list allocation
    and block tables; the layout the migration kernels (kv_gather /
    kv_scatter) aggregate from, driven by ``core.migration.migrate_pages``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import init_cache_defs
from repro_torch.parallel.sharding import ExecConfig

PAGE_SIZE = 16  # tokens per page of the paged view, at most


def page_for(Sc: int) -> int:
    """Tokens per page of a cache of Sc rows: the largest divisor of Sc
    that is not above PAGE_SIZE (the kernel takes any page size)."""
    return next(p for p in range(min(PAGE_SIZE, Sc), 0, -1) if Sc % p == 0)


@dataclass
class SlotCache:
    cfg: ModelConfig
    ec: ExecConfig
    n_slots: int
    max_len: int
    layers: List[dict]  # per layer {"k", "v"}: (n_slots, Sc, KV, hd), or a Mamba layer's (n_slots, ...) state
    lengths: np.ndarray  # host-side per-slot lengths
    free: Deque[int]
    tables: Dict[int, torch.Tensor]  # Sc -> (n_slots, Sc / page_for(Sc)) int32 identity block table

    @classmethod
    def create(cls, cfg, ec, n_slots: int, max_len: int, dtype: torch.dtype, device) -> "SlotCache":
        layers = [
            {k: torch.zeros(d.shape, dtype=dtype, device=device) for k, d in layer.items()}
            for layer in init_cache_defs(cfg, ec, n_slots, max_len)
        ]
        tables = {}
        for layer in layers:
            if "k" not in layer:  # a Mamba layer's state
                continue
            Sc = layer["k"].shape[1]
            if Sc not in tables:
                n_pages = Sc // page_for(Sc)
                tables[Sc] = torch.arange(n_slots * n_pages, dtype=torch.int32, device=device).view(n_slots, n_pages)
        return cls(cfg, ec, n_slots, max_len, layers, np.zeros(n_slots, np.int64), deque(range(n_slots)), tables)

    def page_tables(self, positions: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per layer, its identity block table and seq_lens = min(position +
        1, Sc) for a decode step that writes each slot at ``positions``
        (None for a Mamba layer)."""
        lens = {Sc: (positions + 1).clamp(max=Sc).to(torch.int32) for Sc in self.tables}
        sizes = [layer["k"].shape[1] if "k" in layer else None for layer in self.layers]
        return [self.tables.get(Sc) for Sc in sizes], [lens.get(Sc) for Sc in sizes]

    def alloc(self) -> Optional[int]:
        return self.free.popleft() if self.free else None

    def release(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.free.append(slot)


# ---------------------------------------------------------------------------
# Paged pool + block tables
# ---------------------------------------------------------------------------
@dataclass
class PagedPool:
    """Per-layer paged KV pool with free-list allocation.

    The bookkeeping (free list, tables, lengths) is the reference's, op for
    op; the pages are torch tensors on ``device`` (CUDA unless the caller
    names one).
    """

    num_pages: int
    page_size: int
    kv_heads: int
    head_dim: int
    n_layers: int
    dtype: torch.dtype = torch.float32
    device: Optional[Union[str, torch.device]] = None

    k_pages: torch.Tensor = None  # (L, P, page, KV, hd)
    v_pages: torch.Tensor = None
    free_pages: Deque[int] = field(default_factory=deque)
    tables: Dict[int, List[int]] = field(default_factory=dict)  # seq -> pages
    seq_lens: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        shape = (self.n_layers, self.num_pages, self.page_size, self.kv_heads, self.head_dim)
        if self.k_pages is None:
            self.k_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
            self.v_pages = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if not self.free_pages:  # as in the reference, an empty free list is refilled
            self.free_pages = deque(range(self.num_pages))
        elif not isinstance(self.free_pages, deque):
            self.free_pages = deque(self.free_pages)

    def page_rows(self, kind: str) -> torch.Tensor:
        """Kind "k" or "v" as a (L * P, F) row view, no copy: layer l's page
        p is row l * P + p, so one gather or scatter covers every layer."""
        pages = {"k": self.k_pages, "v": self.v_pages}[kind]
        return pages.view(self.n_layers * self.num_pages, -1)

    def row_ids(self, page_ids: np.ndarray) -> np.ndarray:
        """The rows of ``page_rows`` that hold these pages in every layer,
        layer-major: l * P + page for l = 0 .. L-1."""
        layers = np.arange(self.n_layers, dtype=np.int64)[:, None] * self.num_pages
        return (layers + np.asarray(page_ids, np.int64)[None, :]).reshape(-1)

    def alloc_seq(self, seq_id: int, n_tokens: int) -> bool:
        need = -(-n_tokens // self.page_size)
        if len(self.free_pages) < need:
            return False
        self.tables[seq_id] = [self.free_pages.popleft() for _ in range(need)]
        self.seq_lens[seq_id] = n_tokens
        return True

    def extend_seq(self, seq_id: int, n_new: int = 1) -> bool:
        cur = self.seq_lens[seq_id]
        new = cur + n_new
        need = -(-new // self.page_size) - len(self.tables[seq_id])
        if need > len(self.free_pages):
            return False
        for _ in range(need):
            self.tables[seq_id].append(self.free_pages.popleft())
        self.seq_lens[seq_id] = new
        return True

    def release_seq(self, seq_id: int) -> None:
        self.free_pages.extend(self.tables.pop(seq_id))
        self.seq_lens.pop(seq_id)

    def fragmentation(self) -> float:
        """Fraction of live pages that are non-contiguous with their
        predecessor: the quantity the paper's aggregation attacks."""
        frag = tot = 0
        for pages in self.tables.values():
            for a, b in zip(pages, pages[1:]):
                tot += 1
                frag += b != a + 1
        return frag / tot if tot else 0.0

    def block_table_array(self, seq_ids: List[int]) -> np.ndarray:
        width = max((len(self.tables[s]) for s in seq_ids), default=0)
        out = np.zeros((len(seq_ids), width), np.int32)
        for i, s in enumerate(seq_ids):
            pg = self.tables[s]
            out[i, : len(pg)] = pg
        return out

    def migration_page_ids(self, seq_ids: List[int]) -> np.ndarray:
        """All pages that must be aggregated to migrate these sequences."""
        out: List[int] = []
        for s in seq_ids:
            out.extend(self.tables[s])
        return np.asarray(out, np.int32)
