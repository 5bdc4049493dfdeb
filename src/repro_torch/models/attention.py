"""GQA attention with full, sliding-window and local/global variants and
optional qk-norm (mirrors repro/models/attention.py).

Prefill runs the reference's blockwise streaming softmax as plain torch ops,
every Q block of the sequence at once against one KV block at a time; train
mode runs the same loop without writing into a tensor that autograd saved,
and builds no cache.
Decode writes the new token's K/V into the dense slot cache (at its
position, or at position % window in a windowed layer's rotating buffer),
views that cache as pages, and runs the ``paged_decode_attention`` kernel
over it. The heads are those of the ranks this process holds: all of them
in one process, one model coordinate's across processes, whose cache then
holds that coordinate's KV heads (the reference's ``act_kv -> model``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models.layers import apply_rope, col_parallel, row_parallel
from repro_torch.models.params import ParamDef
from repro_torch.parallel.collectives import enter_model_group
from repro_torch.parallel.sharding import ExecConfig

NEG_INF = -1e30


def attn_param_defs(cfg: ModelConfig, ec: ExecConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    defs = {
        "wq": ParamDef((d, ec.heads_exec, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, ec.kv_exec, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, ec.kv_exec, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((ec.heads_exec, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.attn.qk_norm:
        defs["q_norm"] = ParamDef((hd,), ("head_dim",), init="zeros")
        defs["k_norm"] = ParamDef((hd,), ("head_dim",), init="zeros")
    return defs


def _qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(dt)


def attn_cache_defs(cfg: ModelConfig, ec: ExecConfig, batch: int, seq_len: int, window: Optional[int]) -> dict:
    """Cache ParamDefs for one attention layer: min(window, seq_len) rows
    for a windowed layer."""
    Sc = min(window, seq_len) if window is not None else seq_len
    shape = (batch, Sc, ec.kv_exec, cfg.head_dim)
    axes = ("batch", "kv_seq", "act_kv", "head_dim")
    return {"k": ParamDef(shape, axes, init="zeros"), "v": ParamDef(shape, axes, init="zeros")}


def _block_sizes(S: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """The reference's prefill block sizes: one block when S is not a multiple."""
    bq, bk = min(block_q, S), min(block_k, S)
    return (bq if S % bq == 0 else S), (bk if S % bk == 0 else S)


def live_blocks(positions: torch.Tensor, window: Optional[int], block_q: int, block_k: int) -> torch.Tensor:
    """(nq, nk) bool on the host, from ``positions`` on the host: False for
    a (Q block, KV block) pair of a prefill whose every score is masked.

    Reckoned from each block's least and greatest position, so it is exact
    for increasing positions; otherwise it may leave a masked pair live,
    which adds nothing either (see ``_blockwise``)."""
    S = positions.shape[0]
    bq, bk = _block_sizes(S, block_q, block_k)
    pq, pk = positions.view(S // bq, bq), positions.view(S // bk, bk)
    live = pq.amax(1)[:, None] >= pk.amin(1)[None, :]  # some q >= k
    if window is not None:
        live &= pq.amin(1)[:, None] - pk.amax(1)[None, :] < window  # some q - k < window
    return live


def _with_rows(t: torch.Tensor, dim: int, i0: int, i1: int, rows: torch.Tensor) -> torch.Tensor:
    """``t`` with its Q blocks i0:i1 along ``dim`` replaced by ``rows``, as a
    new tensor: the train path's update, which leaves every tensor that
    autograd saved as it was."""
    return torch.cat([t.narrow(dim, 0, i0), rows, t.narrow(dim, i1, t.shape[dim] - i1)], dim)


def _blockwise(q, k, v, pos, live, *, window, cap, block_q, block_k, differentiable=False):
    """q: (B,S,KV,G,hd); k,v: (B,S,KV,hd); positions (S,); ``live`` from
    ``live_blocks`` over the same positions, window and blocks.

    Returns (B,S,KV,G,hd) in f32: the reference's flash-style loop, each Q
    block carrying a running max, sum and accumulator over the KV blocks in
    order. All Q blocks go through one KV block together. A (Q block, KV
    block) pair whose every score is masked is skipped: the reference adds
    exactly nothing for it (p = 0 and the rescale is 1 once a row has a live
    key; before that its sums are zeroed by the first live block's rescale,
    exp(-1e30 - m) = 0, and every row's own position is a live key).

    Prefill writes the running max, sum and accumulator of the Q blocks a
    KV block reaches in place. ``differentiable`` (train mode) makes new
    tensors instead (``_with_rows``), so that backward finds what it saved:
    the same arithmetic in the same order, so the same bits.
    """
    B, S, KV, G, hd = q.shape
    bq, bk = _block_sizes(S, block_q, block_k)
    nq, nk = S // bq, S // bk
    if tuple(live.shape) != (nq, nk):
        raise ValueError(f"live blocks {tuple(live.shape)} do not match {S} positions in blocks of {bq} x {bk}")
    scale = hd ** -0.5
    qf = q.float().view(B, nq, bq, KV, G, hd).permute(0, 3, 4, 1, 2, 5)  # (B,KV,G,nq,bq,hd)
    kf, vf = k.float(), v.float()
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    mask = mask.view(nq, bq, nk, bk)
    m = torch.full((B, KV, G, nq, bq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, nq, bq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, nq, bq, hd), dtype=torch.float32, device=q.device)
    for j in range(nk):
        rows = live[:, j].nonzero()
        if not len(rows):
            continue
        i0, i1 = int(rows[0]), int(rows[-1]) + 1  # the Q blocks this KV block reaches
        k_j, v_j = kf[:, j * bk:(j + 1) * bk], vf[:, j * bk:(j + 1) * bk]
        s = torch.einsum("bkgnqh,bskh->bkgnqs", qf[:, :, :, i0:i1], k_j) * scale
        if cap is not None:
            s = cap * torch.tanh(s / cap)
        s = torch.where(mask[i0:i1, :, j], s, torch.full_like(s, NEG_INF))
        m_i = m[..., i0:i1, :]
        m_new = torch.maximum(m_i, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_i - m_new)
        l_new = l[..., i0:i1, :] * corr + p.sum(-1)
        acc_new = acc[..., i0:i1, :, :] * corr[..., None] + torch.einsum("bkgnqs,bskh->bkgnqh", p, v_j)
        if differentiable:
            m, l = _with_rows(m, -2, i0, i1, m_new), _with_rows(l, -2, i0, i1, l_new)
            acc = _with_rows(acc, -3, i0, i1, acc_new)
        else:
            l[..., i0:i1, :] = l_new
            acc[..., i0:i1, :, :] = acc_new
            m[..., i0:i1, :] = m_new
    out = acc / l.clamp_min(1e-30)[..., None]  # (B,KV,G,nq,bq,hd)
    return out.permute(0, 3, 4, 1, 2, 5).reshape(B, S, KV, G, hd)


def swa_cache_slots(window: int, seq_len: int, device=None) -> torch.Tensor:
    """Rotating-buffer slot of each of the last ``window`` positions, made
    on ``device`` (no copy from the host, so a CUDA graph can hold it)."""
    return torch.arange(max(seq_len - window, 0), seq_len, device=device) % window


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
    window: Optional[int],
    mode: str,  # train | prefill | decode
    cache: Optional[dict] = None,  # decode: {"k","v"}: (B,Sc,KV,hd), written in place
    block_tables: Optional[torch.Tensor] = None,
    seq_lens: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,  # train/prefill: live_blocks(positions, window, block_q, block_k)
    block_q: int = 512,
    block_k: int = 512,
):
    B, S, d = x.shape
    hd = cfg.head_dim
    wq = p["wq"]
    n_held = len(wq.mats)  # ranks of the group this process holds: their heads
    H, KV, G = ec.heads_exec * n_held // wq.tp, ec.kv_exec * n_held // wq.tp, ec.q_per_kv
    cap = cfg.attn.logit_softcap
    x2 = enter_model_group(x.reshape(B * S, d), wq.level)  # q, k and v share one gradient all-reduce
    qs = col_parallel(x2, wq, entered=True)
    q = torch.cat(qs, dim=-1).view(B, S, -1, hd)
    k = torch.cat(col_parallel(x2, p["wk"], entered=True), dim=-1).view(B, S, -1, hd)
    v = torch.cat(col_parallel(x2, p["wv"], entered=True), dim=-1).view(B, S, -1, hd)
    if q.shape[2] != H or k.shape[2] != KV:
        raise ValueError(f"bound weights give {q.shape[2]} q / {k.shape[2]} kv heads; {ec} expects "
                         f"{H} / {KV} on {n_held} of {wq.tp} ranks")
    if cfg.attn.qk_norm:  # a rank's heads give its part of the scales' gradient
        q = _qk_norm(q, enter_model_group(p["q_norm"], wq.level))
        k = _qk_norm(k, enter_model_group(p["k_norm"], wq.level))

    rope_pos = positions[:, None] if mode == "decode" else positions[None, :]
    q = apply_rope(q, rope_pos, cfg.attn.rope_theta)
    k = apply_rope(k, rope_pos, cfg.attn.rope_theta)

    if mode in ("train", "prefill"):
        o = _blockwise(q.view(B, S, KV, G, hd), k, v, positions, live, window=window, cap=cap,
                       block_q=block_q, block_k=block_k, differentiable=mode == "train").to(x.dtype)
        if mode == "train":
            new_cache = None
        elif window is not None and S > window:  # the rotating buffer of the last window positions
            slots = swa_cache_slots(window, S, x.device)
            new_cache = {}
            for name, t in (("k", k), ("v", v)):
                buf = torch.zeros((B, window, KV, hd), dtype=t.dtype, device=t.device)
                buf[:, slots] = t[:, -window:]
                new_cache[name] = buf
        else:
            new_cache = {"k": k, "v": v}
    elif mode == "decode":
        rows = torch.arange(B, device=x.device)
        slot = positions % window if window is not None else positions
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        o = decode_attention(q[:, 0].reshape(B, KV, G, hd).contiguous(), cache["k"], cache["v"],
                             block_tables, seq_lens, cap)
        new_cache = cache
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")

    # rank r's query heads are the r-th contiguous block of the concatenation
    o2 = o.reshape(B * S, -1)
    w = qs[0].shape[1]
    y = row_parallel([o2[:, r * w:(r + 1) * w].contiguous() for r in range(len(qs))], p["wo"])
    return y.view(B, S, d), new_cache
