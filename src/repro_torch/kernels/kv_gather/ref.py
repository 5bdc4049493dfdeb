"""Plain PyTorch versions of paged-KV gather and scatter (mirror
repro/kernels/kv_gather/ref.py): the oracles of the tests and of
chip_smoke.py. Nothing on the CUDA path uses them."""
from __future__ import annotations

import numpy as np
import torch


def _ids(page_ids, device: torch.device) -> torch.Tensor:
    if not isinstance(page_ids, torch.Tensor):
        page_ids = torch.from_numpy(np.asarray(page_ids, np.int64))
    return page_ids.to(device=device, dtype=torch.long)


def kv_gather_ref(pool: torch.Tensor, page_ids) -> torch.Tensor:
    """pool (P, F); page_ids (n,) -> staged (n, F), staged[i] = pool[page_ids[i]]."""
    return pool[_ids(page_ids, pool.device)]


def kv_scatter_ref(pool: torch.Tensor, staged: torch.Tensor, page_ids) -> torch.Tensor:
    """pool[page_ids[i]] = staged[i], in place; returns ``pool``."""
    pool[_ids(page_ids, pool.device)] = staged
    return pool
