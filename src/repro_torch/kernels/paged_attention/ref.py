"""Plain PyTorch version of paged flash-decode: densify the pages through the
block table, then a masked softmax (mirrors
repro/kernels/paged_attention/ref.py)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """q (B,KV,G,hd); pages (P,page,KV,hd); tables (B,n_pages); lens (B,)."""
    B, KV, G, hd = q.shape
    page = k_pages.shape[1]
    S = block_tables.shape[1] * page
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, S, KV, hd).float()
    v = v_pages[tables].reshape(B, S, KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * (hd ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(S, device=q.device)[None] < seq_lens.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskh->bkgh", p, v).to(q.dtype)
