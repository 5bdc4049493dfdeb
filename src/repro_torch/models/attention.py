"""GQA attention with full, sliding-window and local/global variants and
optional qk-norm (mirrors repro/models/attention.py).

Prefill runs the reference's blockwise streaming softmax as plain torch ops,
every Q block of the sequence at once against one KV block at a time; train
mode runs the same loop inside an autograd Function whose backward is the
reference's autodiff of that loop (each block pair's gradients cast to the
inputs' dtype and summed in it), and builds no cache.
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
from repro_torch.models.layers import apply_rope, col_parallel, row_parallel, wide
from repro_torch.models.params import ParamDef
from repro_torch.models.rounding import shared
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


def _scores(q_i, k_j, mask, scale, cap):
    """One (Q block, KV block) pair's scores, softcapped and masked: the
    reference's ``kv_step`` up to its max. q_i (..., bq, hd) and k_j
    (B,bk,KV,hd) in f32. Returns (s, tanh(s / cap) or None)."""
    s = torch.einsum("bkgnqh,bskh->bkgnqs", q_i, k_j) * scale
    t = None
    if cap is not None:
        t = torch.tanh(s / cap)
        s = cap * t
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), t


def _blockwise(q, k, v, pos, live, *, window, cap, block_q, block_k, keep=None):
    """q: (B,S,KV,G,hd); k,v: (B,S,KV,hd); positions (S,); ``live`` from
    ``live_blocks`` over the same positions, window and blocks.

    Returns (B,S,KV,G,hd) in f32 (``layers.wide``): the reference's flash-style loop, each Q
    block carrying a running max, sum and accumulator over the KV blocks in
    order. All Q blocks go through one KV block together, and the running
    max, sum and accumulator of the Q blocks a KV block reaches are written
    in place. A (Q block, KV block) pair whose every score is masked is
    skipped: the reference adds exactly nothing for it (p = 0 and the
    rescale is 1 once a row has a live key; before that its sums are zeroed
    by the first live block's rescale, exp(-1e30 - m) = 0, and every row's
    own position is a live key). Not differentiable: train mode goes
    through ``train_attention``, whose backward runs this loop again with
    ``keep``, a list that takes each step's inputs and what its
    vector-Jacobian product reads (``_step_backward``), and then takes the
    final sum and accumulator, (B,KV,G,nq,bq[,hd]).
    """
    B, S, KV, G, hd = q.shape
    bq, bk = _block_sizes(S, block_q, block_k)
    nq, nk = S // bq, S // bk
    if tuple(live.shape) != (nq, nk):
        raise ValueError(f"live blocks {tuple(live.shape)} do not match {S} positions in blocks of {bq} x {bk}")
    scale = hd ** -0.5
    ct = wide(q.dtype)
    qf = q.to(ct).view(B, nq, bq, KV, G, hd).permute(0, 3, 4, 1, 2, 5)  # (B,KV,G,nq,bq,hd)
    kf, vf = k.to(ct), v.to(ct)
    mask = _mask(pos, window).view(nq, bq, nk, bk)
    m = torch.full((B, KV, G, nq, bq), NEG_INF, dtype=ct, device=q.device)
    l = torch.zeros((B, KV, G, nq, bq), dtype=ct, device=q.device)
    acc = torch.zeros((B, KV, G, nq, bq, hd), dtype=ct, device=q.device)
    for j in range(nk):
        rows = live[:, j].nonzero()
        if not len(rows):
            continue
        i0, i1 = int(rows[0]), int(rows[-1]) + 1  # the Q blocks this KV block reaches
        q_i, k_j, v_j = qf[:, :, :, i0:i1], kf[:, j * bk:(j + 1) * bk], vf[:, j * bk:(j + 1) * bk]
        s, t = _scores(q_i, k_j, mask[i0:i1, :, j], scale, cap)
        m_i, l_i, acc_i = m[..., i0:i1, :], l[..., i0:i1, :], acc[..., i0:i1, :, :]
        smax = s.amax(-1)
        m_new = torch.maximum(m_i, smax)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_i - m_new)
        if keep is not None:  # the input carry is copied: the writes below overwrite it
            keep.append(((i0, i1, j * bk, (j + 1) * bk), (q_i, k_j, v_j, mask[i0:i1, :, j], scale, cap),
                         (m_i.clone(), l_i.clone(), acc_i.clone(), p, smax, s == smax[..., None], t, m_new, corr)))
        l[..., i0:i1, :] = l_i * corr + p.sum(-1)
        acc[..., i0:i1, :, :] = acc_i * corr[..., None] + torch.einsum("bkgnqs,bskh->bkgnqh", p, v_j)
        m[..., i0:i1, :] = m_new
    if keep is not None:
        keep.append((l, acc))
    out = acc / l.clamp_min(1e-30)[..., None]  # (B,KV,G,nq,bq,hd)
    return out.permute(0, 3, 4, 1, 2, 5).reshape(B, S, KV, G, hd)


def _mask(pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """(S, S) bool: key k is visible from query q."""
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return mask


def _step_backward(q_i, k_j, v_j, mask, scale, cap, saved, grads):
    """The vector-Jacobian product of one step of ``_blockwise``'s
    recurrence for the Q blocks ``q_i`` (B,KV,G,n,bq,hd) against one KV
    block, in the order the reference's autodiff of its ``kv_step`` takes
    it: from what the step computed (``saved``: its input carry m, l, acc,
    p, the row max of the scores and where they reach it, tanh(s / cap),
    m_new and the rescale) and the cotangents (dm, dl, dacc) of its output
    carry, the cotangents of its input carry and the pairs' dq
    (B,KV,G,n,bq,hd), dk and dv (B,n,bk,KV,hd), all in f32. max's cotangent
    is split evenly between ties, as jax's is."""
    m, l, acc, p, smax, at_max, t, m_new, corr = saved
    dm, dl, dacc = grads
    dv = torch.einsum("bkgnqh,bkgnqs->bnskh", dacc, p)
    dp = torch.einsum("bkgnqh,bskh->bkgnqs", dacc, v_j).add_(dl[..., None])
    dcorr = (acc * dacc).sum(-1) + l * dl
    dl_in = dl * corr
    ko = dcorr * corr
    dacc_in = dacc * corr[..., None]
    kr = dp.mul_(p)  # the cotangent of s - m_new
    kw = (dm + -ko) + (-kr).sum(-1)  # of m_new
    at_s, at_m = smax == m_new, m == m_new
    dm_in = ko + kw * (at_m.float() / torch.where(at_s, 2.0, 1.0))
    ds = kr.add_((kw * (at_s.float() / torch.where(at_m, 2.0, 1.0)) / at_max.sum(-1))[..., None] * at_max)
    ds.masked_fill_(~mask, 0.0)
    if cap is not None:  # cap * tanh(s / cap), as jax's tanh rule transposes
        g = ds.mul_(cap).mul_(1.0 - t)
        ds = g.add_(g * t).div_(cap)
    ds.mul_(scale)
    dq = torch.einsum("bkgnqs,bskh->bkgnqh", ds, k_j)
    dk = torch.einsum("bkgnqs,bkgnqh->bnskh", ds, q_i)
    return (dm_in, dl_in, dacc_in), dq, dk, dv


class _TrainAttention(torch.autograd.Function):
    """``_blockwise`` whose backward is the reference's: the transpose of
    its scan over Q blocks around a checkpointed scan over KV blocks. The
    backward runs the forward loop again, keeping what each step's
    vector-Jacobian product reads (the reference's checkpointed
    ``kv_step``), then takes the steps in reverse, each KV block with every
    Q block it reaches at once (``_step_backward``): each Q block meets its
    live KV blocks in descending order, as in the reference's inner
    transpose. Each pair's dq, dk and dv is cast to q's, k's and v's dtype
    and added in that dtype: dq into its Q block's sum over KV blocks, dk
    and dv into their KV block's sum over Q blocks, the Q blocks in
    descending order (the reference's cotangent carries; in bf16 each add
    rounds). A dead pair adds nothing: the reference adds exact zeros for
    it. Nothing per pair is saved by the forward."""

    @staticmethod
    def forward(ctx, q, k, v, pos, live, window, cap, block_q, block_k):
        ctx.save_for_backward(q, k, v, pos)
        ctx.args = dict(live=live, window=window, cap=cap, block_q=block_q, block_k=block_k)
        return _blockwise(q, k, v, pos, **ctx.args)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pos = ctx.saved_tensors
        steps = []
        _blockwise(q, k, v, pos, **ctx.args, keep=steps)
        l, acc = steps.pop()
        B, S, KV, G, hd = q.shape
        nq, bq = l.shape[-2:]
        # out = acc / max(l, 1e-30)
        lm = l.clamp_min(1e-30)
        g = dout.float().view(B, nq, bq, KV, G, hd).permute(0, 3, 4, 1, 2, 5)
        share = (l == lm).float() / torch.where(lm == 1e-30, 2.0, 1.0)
        dm, dl, dacc = torch.zeros_like(l), -(g * lm[..., None].pow(-2) * acc).sum(-1) * share, g / lm[..., None]
        del l, acc, lm, g
        dq = torch.zeros((B, KV, G, nq, bq, hd), dtype=q.dtype, device=q.device)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        while steps:
            (i0, i1, k0, k1), inputs, saved = steps.pop()
            (dm_i, dl_i, dacc_i), dq_j, dk_j, dv_j = _step_backward(
                *inputs, saved, (dm[..., i0:i1, :], dl[..., i0:i1, :], dacc[..., i0:i1, :, :]))
            del inputs, saved
            dm[..., i0:i1, :], dl[..., i0:i1, :], dacc[..., i0:i1, :, :] = dm_i, dl_i, dacc_i
            dq[..., i0:i1, :, :] += dq_j.to(q.dtype)
            dk_j, dv_j = dk_j.to(k.dtype), dv_j.to(v.dtype)
            for n in reversed(range(i1 - i0)):  # the Q blocks in descending order
                dk[:, k0:k1] += dk_j[:, n]
                dv[:, k0:k1] += dv_j[:, n]
        return dq.permute(0, 3, 4, 1, 2, 5).reshape(q.shape), dk, dv, None, None, None, None, None, None


def train_attention(q, k, v, pos, live, *, window, cap, block_q, block_k):
    """``_blockwise`` under autograd, with the reference's backward
    (``_TrainAttention``)."""
    return _TrainAttention.apply(q, k, v, pos, live, window, cap, block_q, block_k)


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
    xq, xk, xv = shared(x2, 3, wq.mats[0].dtype)
    qs = col_parallel(xq, wq, entered=True)
    q = torch.cat(qs, dim=-1).view(B, S, -1, hd)
    k = torch.cat(col_parallel(xk, p["wk"], entered=True), dim=-1).view(B, S, -1, hd)
    v = torch.cat(col_parallel(xv, p["wv"], entered=True), dim=-1).view(B, S, -1, hd)
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
        attend = train_attention if mode == "train" else _blockwise
        o = attend(q.view(B, S, KV, G, hd), k, v, positions, live, window=window, cap=cap,
                   block_q=block_q, block_k=block_k).to(q.dtype)
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
