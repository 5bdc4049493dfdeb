"""Plain PyTorch versions of paged flash-decode.

``paged_decode_attention_ref`` densifies the pages through the block table
and takes a masked softmax (mirrors repro/kernels/paged_attention/ref.py);
it is the wrapper's CPU path. ``paged_decode_attention_split_ref`` repeats
the CUDA kernel's arithmetic, splits of ``T_SPLIT`` tokens merged by
log-sum-exp, for the tests to hold the kernel to more tightly.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
T_SPLIT = 64  # tokens per split of csrc/paged_attention.cu; its boundaries depend on the position alone


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


def paged_decode_attention_split_ref(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    t_split: int = T_SPLIT,
) -> torch.Tensor:
    """The same function as the kernel computes it: split j holds tokens
    [j t_split, (j + 1) t_split); each live split takes its own max m_j, sum
    l_j and accumulator acc_j over its live tokens; then, in split order,
    M = max m_j, w_j = exp(m_j - M), L = sum l_j w_j, A = sum acc_j w_j, and
    the output is A / max(L, 1e-30). Positions at or past seq_len are never
    used, so whatever they hold (NaN too) does not reach the output."""
    B, KV, G, hd = q.shape
    page = k_pages.shape[1]
    S = block_tables.shape[1] * page
    n_split = -(-S // t_split)
    pad = n_split * t_split - S
    tables = block_tables.long()
    lens = seq_lens.to(q.device).long().clamp(max=S)
    valid = torch.arange(n_split * t_split, device=q.device)[None] < lens[:, None]  # (B, n_split * t_split)
    vm = valid[:, :, None, None]
    k = torch.nn.functional.pad(k_pages[tables].reshape(B, S, KV, hd).float(), (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v_pages[tables].reshape(B, S, KV, hd).float(), (0, 0, 0, 0, 0, pad))
    k, v = torch.where(vm, k, torch.zeros_like(k)), torch.where(vm, v, torch.zeros_like(v))
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k) * (hd ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    vs = valid.view(B, 1, 1, n_split, t_split)
    s = torch.where(vs, s.view(B, KV, G, n_split, t_split), torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1)  # (B, KV, G, n_split)
    p = torch.where(vs, torch.exp(s - m[..., None]), torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bkgjt,bjtkh->bkgjh", p, v.view(B, n_split, t_split, KV, hd))
    live = (torch.arange(n_split, device=q.device) * t_split)[None] < lens[:, None]  # (B, n_split)
    live = live[:, None, None, :]
    M = torch.where(live, m, torch.full((), NEG_INF, device=q.device)).amax(-1)
    L = torch.zeros_like(M)
    A = torch.zeros((B, KV, G, hd), device=q.device)
    for j in range(n_split):  # in split order
        w = torch.where(live[..., j], torch.exp(m[..., j] - M), torch.zeros((), device=q.device))
        L = L + l[..., j] * w
        A = A + acc[..., j, :] * w[..., None]
    return (A / L.clamp_min(1e-30)[..., None]).to(q.dtype)
