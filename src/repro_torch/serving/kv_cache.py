"""Dense slot KV cache of the serving engine (mirrors ``SlotCache`` of
repro/serving/kv_cache.py), one K and one V tensor per layer.

Decode reads it through the paged-attention kernel: ``page_tables`` gives
identity block tables of ``max_len / PAGE_SIZE`` pages per slot, and
``models.attention.decode_attention`` views each layer's cache as those
pages, which gives exactly the reference's dense masked decode attention. The
``PagedPool`` with free-list allocation comes with the paged-pool
migration slice.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_cache_defs
from repro_torch.parallel.sharding import ExecConfig

PAGE_SIZE = 16  # tokens per page of the paged view


@dataclass
class SlotCache:
    cfg: ModelConfig
    ec: ExecConfig
    n_slots: int
    max_len: int
    layers: List[dict]  # per layer {"k", "v"}: (n_slots, max_len, KV, hd)
    lengths: np.ndarray  # host-side per-slot lengths
    free: Deque[int]
    tables: torch.Tensor  # (n_slots, max_len / PAGE_SIZE) int32 identity block table

    @classmethod
    def create(cls, cfg, ec, n_slots: int, max_len: int, dtype: torch.dtype, device) -> "SlotCache":
        if max_len % PAGE_SIZE:
            raise ValueError(f"max_len {max_len} must be a multiple of the page size {PAGE_SIZE}")
        layers = [
            {k: torch.zeros(d.shape, dtype=dtype, device=device) for k, d in layer.items()}
            for layer in init_cache_defs(cfg, ec, n_slots, max_len)
        ]
        n_pages = max_len // PAGE_SIZE
        tables = torch.arange(n_slots * n_pages, dtype=torch.int32, device=device).view(n_slots, n_pages)
        return cls(cfg, ec, n_slots, max_len, layers, np.zeros(n_slots, np.int64),
                   deque(range(n_slots)), tables)

    def page_tables(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Identity block tables and seq_lens = min(position + 1, max_len)
        for a decode step that writes each slot at ``positions``."""
        return self.tables, (positions + 1).clamp(max=self.max_len).to(torch.int32)

    def alloc(self) -> Optional[int]:
        return self.free.popleft() if self.free else None

    def release(self, slot: int) -> None:
        self.lengths[slot] = 0
        self.free.append(slot)
