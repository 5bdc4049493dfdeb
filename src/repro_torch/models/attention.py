"""GQA attention with full causal masking (mirrors repro/models/attention.py).

Prefill runs the reference's blockwise streaming softmax as plain torch ops.
Decode writes the new token's K/V into the dense slot cache at its position,
views that cache as pages, and runs the ``paged_decode_attention`` kernel
over it. Sliding-window and local/global attention and qk-norm come with the
next dense slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models.layers import apply_rope, col_parallel, row_parallel
from repro_torch.models.params import ParamDef
from repro_torch.parallel.sharding import ExecConfig

NEG_INF = -1e30


def attn_param_defs(cfg: ModelConfig, ec: ExecConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": ParamDef((d, ec.heads_exec, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, ec.kv_exec, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, ec.kv_exec, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((ec.heads_exec, hd, d), ("heads", "head_dim", "embed")),
    }


def attn_cache_defs(cfg: ModelConfig, ec: ExecConfig, batch: int, seq_len: int) -> dict:
    """Cache ParamDefs for one attention layer."""
    shape = (batch, seq_len, ec.kv_exec, cfg.head_dim)
    axes = ("batch", "kv_seq", "act_kv", "head_dim")
    return {"k": ParamDef(shape, axes, init="zeros"), "v": ParamDef(shape, axes, init="zeros")}


def _blockwise(q, k, v, q_pos, k_pos, *, cap, block_q, block_k):
    """q: (B,Sq,KV,G,hd); k,v: (B,Sk,KV,hd); positions (Sq,), (Sk,).

    Returns (B,Sq,KV,G,hd) in f32: the reference's flash-style loop over Q
    blocks and KV blocks with a running max, sum and accumulator.
    """
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq:
        bq = Sq
    if Sk % bk:
        bk = Sk
    scale = hd ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    outs = []
    for i in range(0, Sq, bq):
        q_i, qp = qf[:, i:i + bq], q_pos[i:i + bq]
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, bq, hd), dtype=torch.float32, device=q.device)
        for j in range(0, Sk, bk):
            k_j, v_j, kp = kf[:, j:j + bk], vf[:, j:j + bk], k_pos[j:j + bk]
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i, k_j) * scale
            if cap is not None:
                s = cap * torch.tanh(s / cap)
            mask = qp[:, None] >= kp[None, :]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, v_j)
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]  # (B,KV,G,bq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1)


def as_pages(cache: torch.Tensor, page: int) -> torch.Tensor:
    """Dense slot cache (B,Sc,KV,hd) viewed as pages (B*Sc/page, page, KV,
    hd): slot b's j-th page is page b*(Sc/page) + j. A view, not a copy."""
    B, Sc, KV, hd = cache.shape
    return cache.view(B * Sc // page, page, KV, hd)


def decode_attention(q, k_cache, v_cache, block_tables, seq_lens, cap: Optional[float]):
    """q: (B,KV,G,hd); dense caches (B,Sc,KV,hd) viewed as pages of
    Sc // n_pages tokens, addressed through ``block_tables``."""
    page = k_cache.shape[1] // block_tables.shape[1]
    return paged_decode_attention(q, as_pages(k_cache, page), as_pages(v_cache, page),
                                  block_tables, seq_lens, softcap=cap)


def attn_apply(
    p: dict,
    x: torch.Tensor,
    *,
    cfg: ModelConfig,
    ec: ExecConfig,
    positions: torch.Tensor,  # (S,) for prefill; (B,) for decode
    mode: str,  # prefill | decode
    cache: Optional[dict] = None,  # decode: {"k","v"}: (B,Sc,KV,hd), written in place
    block_tables: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
    block_q: int = 512,
    block_k: int = 512,
):
    B, S, d = x.shape
    hd = cfg.head_dim
    KV, G = ec.kv_exec, ec.q_per_kv
    cap = cfg.attn.logit_softcap
    x2 = x.reshape(B * S, d)
    qs = col_parallel(x2, p["wq"])
    q = torch.cat(qs, dim=-1).view(B, S, -1, hd)
    k = torch.cat(col_parallel(x2, p["wk"]), dim=-1).view(B, S, -1, hd)
    v = torch.cat(col_parallel(x2, p["wv"]), dim=-1).view(B, S, -1, hd)
    if q.shape[2] != ec.heads_exec or k.shape[2] != KV:
        raise ValueError(f"bound weights give {q.shape[2]} q / {k.shape[2]} kv heads; {ec} expects "
                         f"{ec.heads_exec} / {KV}")

    rope_pos = positions[:, None] if mode == "decode" else positions[None, :]
    q = apply_rope(q, rope_pos, cfg.attn.rope_theta)
    k = apply_rope(k, rope_pos, cfg.attn.rope_theta)

    if mode == "prefill":
        o = _blockwise(q.view(B, S, KV, G, hd), k, v, positions, positions,
                       cap=cap, block_q=block_q, block_k=block_k).to(x.dtype)
        new_cache = {"k": k, "v": v}
    elif mode == "decode":
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, positions] = k[:, 0]
        cache["v"][rows, positions] = v[:, 0]
        o = decode_attention(q[:, 0].reshape(B, KV, G, hd).contiguous(), cache["k"], cache["v"],
                             block_tables, seq_lens, cap)
        new_cache = cache
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")

    # rank r's query heads are the r-th contiguous block of the concatenation
    o2 = o.reshape(B * S, -1)
    w = qs[0].shape[1]
    y = row_parallel([o2[:, r * w:(r + 1) * w].contiguous() for r in range(len(qs))], p["wo"])
    return y.view(B, S, d), new_cache
