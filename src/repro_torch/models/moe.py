"""Top-k MoE with expert parallelism over a TP group's ranks (mirrors
repro/models/moe.py).

The reference runs at TP t over a pool of N devices, a mesh of (data = N/t,
model = t), and picks its path and its capacity from t, N and the shape:

  * local   — t = 1: sort-based capacity dispatch of all B*S tokens, all
              experts resident, capacity ``_capacity(B*S)``.
  * sharded — t > 1 with S % t == 0 and B % dp == 0 (dp = N/t): the tokens
              split into dp x t blocks of (B/dp) x (S/t), each dispatched on
              its own at ``_capacity(block)``, moved to their expert shards
              (the reference's all_to_all) and back; no psum.
  * decode  — otherwise: the batch split into dp contiguous groups of B/dp
              slots when B % dp == 0 (else one group of B), each dispatched
              at ``_capacity(B_loc*S)``; each rank computes only its E/t
              experts and the ranks' partial outputs are summed (psum).

The port runs every rank of the group in one process, so the sharded and
decode paths are loops over the ranks: rank r runs its E/t experts (the
bound ``ShardView``'s ``block(r, ...)``, a view of the stored experts) over
every group's rows.

Dispatch gathers each expert's rows (no scatter), and on every path the
combine sums a token's K contributions from zero in ascending expert order,
the order the reference's ``.at[tok].add`` reaches them through the stable
``order``. In the decode path the reference instead sums each rank's share
and then the ranks (its psum); the two sums differ only in f32 rounding,
within the tolerances the tests hold the paths and the engine to. Neither
dispatch nor combine uses atomics, so a step gives the same bits on every
run on the card and a CUDA graph replays it bit for bit. Every shape is static
(argsort, searchsorted, an (E, C) buffer per group, ``torch.where``), so the
paths capture into a graph; padding tokens are routed and take capacity
after the real tokens of their group, as in the reference.

The expert FFN is ``torch.bmm`` on each rank's expert shard: the reference
computes it with einsum outside any Pallas kernel. The router and an f32
expert FFN run in full f32, so on the card they need TF32 off (PyTorch's
default) and raise otherwise. Shared experts are column- then row-parallel
through ``tp_shard_matmul`` (``layers.mlp_apply``). The expert weights lie
whole on one card: the reference's FSDP gather of expert weights
(``expert_embed -> data``) is the identity under the engine's rules and is
not ported.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models.layers import mlp_apply
from repro_torch.models.params import ParamDef
from repro_torch.parallel.collectives import stand_in


def moe_param_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "w_gate": ParamDef((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "w_in": ParamDef((e, d, f), ("experts", "expert_embed", "expert_mlp")),
        "w_out": ParamDef((e, f, d), ("experts", "expert_mlp", "expert_embed")),
    }
    if m.num_shared_experts:
        fs = m.num_shared_experts * f
        defs["shared"] = {
            "w_gate": ParamDef((d, fs), ("embed", "mlp")),
            "w_in": ParamDef((d, fs), ("embed", "mlp")),
            "w_out": ParamDef((fs, d), ("mlp", "embed")),
        }
    return defs


def _full_f32(t: torch.Tensor) -> None:
    if t.is_cuda and t.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE f32 products run in full f32: set torch.backends.cuda.matmul.allow_tf32 = False")


def _route(x2d: torch.Tensor, router_w: torch.Tensor, m: MoESpec, with_aux: bool = True):
    """x2d: (..., T, D) -> (probs (..., T, K), idx (..., T, K), aux dict);
    with leading dims, aux is the mean of each group's losses."""
    xf = x2d.float()
    _full_f32(xf)
    logits = xf @ router_w.float()
    probs_all = torch.softmax(logits, -1)
    top_p, top_i = torch.topk(probs_all, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    if not with_aux:
        return top_p, top_i, {}
    # Switch-style load-balancing + router z losses
    me = probs_all.mean(-2)  # (..., E)
    picks = top_i.flatten(-2)
    ce = F.one_hot(picks, m.num_experts).sum(-2).float() / picks.shape[-1]
    lb = m.num_experts * (me * ce).sum(-1)
    z = torch.logsumexp(logits, -1).pow(2).mean(-1)
    return top_p, top_i, {"lb": lb.mean(), "z": z.mean()}


def _sorted_dispatch(top_i: torch.Tensor, E: int, C: int):
    K = top_i.shape[-1]
    flat_e = top_i.flatten(-2)
    TK = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(TK, device=top_i.device) - first
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e, torch.full_like(sorted_e, E * C))
    return dest, order // K, keep, order, sorted_e


def _dispatch_indices(top_i: torch.Tensor, E: int, C: int):
    """Sort-based capacity dispatch; top_i (..., T, K), each group on its own.

    Returns (dest, tok, keep, order), each (..., T*K): assignment a (in
    sorted order) goes to dispatch row ``dest[a]`` (within (E*C)) from
    token ``tok[a]``; dropped assignments (over capacity) have keep=False
    and dest pointing at a trash row E*C.
    """
    return _sorted_dispatch(top_i, E, C)[:4]


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """buf: (E,C,D); weights: (E,D,F)/(E,F,D) -> (E,C,D)."""
    _full_f32(buf)
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_in)
    return torch.bmm(F.silu(g) * u, w_out)


def _capacity(T: int, m: MoESpec, floor: int = 8) -> int:
    c = math.ceil(T * m.top_k / m.num_experts * m.capacity_factor)
    return max(int(c), floor)


def _moe_groups(xg: torch.Tensor, p: dict, m: MoESpec, C: int, *, with_aux: bool,
                drops: Optional[torch.Tensor], mask: Optional[torch.Tensor]):
    """Dispatch -> per-rank expert FFN -> combine for G groups of tokens,
    each group dispatched on its own at capacity C.

    xg: (G, Tg, D). ``drops``, a (1,)
    int64 tensor, gains the dropped assignments of the tokens ``mask``
    (G, Tg) holds (all tokens without a mask). Returns (y (G, Tg, D), aux).
    """
    G, Tg, D = xg.shape
    E, K = m.num_experts, m.top_k
    t = p["w_gate"].tp
    E_loc, Fe = E // t, m.d_ff_expert
    dev = xg.device
    top_p, top_i, aux = _route(xg, p["router"], m, with_aux)
    dest, tok, keep, order, sorted_e = _sorted_dispatch(top_i, E, C)
    TK = Tg * K

    # each expert's C rows, gathered: row c of expert e is the e-th run's c-th assignment
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    first = torch.searchsorted(sorted_e, experts, side="left")
    count = torch.searchsorted(sorted_e, experts, side="right") - first
    c_idx = torch.arange(C, device=dev)
    filled = (c_idx < count[..., None]).reshape(G, E * C)
    src = torch.gather(tok, -1, (first[..., None] + c_idx).clamp(max=TK - 1).reshape(G, E * C))
    rows = torch.gather(xg, 1, src[..., None].expand(G, E * C, D))
    buf = torch.where(filled[..., None], rows, torch.zeros((), dtype=xg.dtype, device=dev)).view(G, E, C, D)

    outs = []
    for r in range(t):  # rank r: its E/t experts over every group's rows
        b = buf[:, r * E_loc:(r + 1) * E_loc].transpose(0, 1).reshape(E_loc, G * C, D)
        outs.append(_expert_ffn(b, p["w_gate"].block(r, D, Fe), p["w_in"].block(r, D, Fe), p["w_out"].block(r, Fe, D)))
    out = (torch.cat(outs, 0) if t > 1 else outs[0]).reshape(E * G * C, D)  # row (e, g, c)

    # combine: each token's picks in ascending expert order, from its sorted position
    perm = top_i.sort(-1).indices
    top_p_s = torch.gather(top_p, -1, perm)
    a = (torch.arange(Tg, device=dev)[:, None] * K + perm).reshape(G, TK)
    s = torch.gather(torch.argsort(order, dim=-1), -1, a)
    d = torch.gather(dest, -1, s)
    kept = torch.gather(keep, -1, s)
    g_idx = torch.arange(G, device=dev)[:, None]
    row = (d // C).clamp(max=E - 1) * (G * C) + g_idx * C + d % C
    got = out.index_select(0, row.reshape(-1)).view(G, Tg, K, D)
    got = torch.where(kept.view(G, Tg, K, 1), got, torch.zeros((), dtype=xg.dtype, device=dev))
    contrib = got * top_p_s.to(xg.dtype)[..., None]
    y = contrib[..., 0, :]
    for j in range(1, K):
        y = y + contrib[..., j, :]
    if drops is not None:
        lost = ~kept.view(G, Tg, K)
        if mask is not None:
            lost = lost & mask.view(G, Tg, 1)
        drops.add_(lost.sum())
    return y, aux


def _shared_ffn(ps: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(ps, x)


def _finish(p: dict, x: torch.Tensor, y: torch.Tensor, m: MoESpec) -> torch.Tensor:
    if m.num_shared_experts:
        y = y + _shared_ffn(p["shared"], x)
    return y


def moe_apply_local(p: dict, x: torch.Tensor, cfg: ModelConfig, *, with_aux: bool = True,
                    drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
    m = cfg.moe
    B, S, D = x.shape
    y, aux = _moe_groups(x.reshape(1, B * S, D), p, m, _capacity(B * S, m), with_aux=with_aux,
                         drops=drops, mask=mask)
    return _finish(p, x, y.view(B, S, D), m), aux


def moe_apply_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig, n_pool: int, *, with_aux: bool = True,
                      drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
    """The reference's sharded train/prefill path at TP t over a pool of
    ``n_pool`` ranks; falls back to the decode path as the reference does."""
    m = cfg.moe
    B, S, D = x.shape
    tp = p["w_gate"].tp
    dp = n_pool // tp
    if S % tp != 0 or B % dp != 0:  # decode / tiny shapes: replicated dispatch per data group
        return _moe_apply_decode(p, x, cfg, n_pool, with_aux=with_aux, drops=drops, mask=mask)
    Bl, Sl = B // dp, S // tp

    def blocks(t: torch.Tensor) -> torch.Tensor:  # (B, S, ...) -> (dp*tp, Bl*Sl, ...), block (data i, model j)
        return t.reshape(dp, Bl, tp, Sl, *t.shape[2:]).transpose(1, 2).reshape(dp * tp, Bl * Sl, *t.shape[2:])

    C = _capacity(Bl * Sl, m)
    y, aux = _moe_groups(blocks(x), p, m, C, with_aux=with_aux, drops=drops,
                         mask=None if mask is None else blocks(mask))
    for _ in ("dispatch", "return"):  # each block's (E, C, D) rows to the experts' ranks and back
        stand_in("all-to-all", m.num_experts * C * D * x.element_size(), dp * tp)
    y = y.view(dp, tp, Bl, Sl, D).transpose(1, 2).reshape(B, S, D)
    return _finish(p, x, y, m), aux


def _moe_apply_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, n_pool: int, *, with_aux: bool = True,
                      drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
    """Replicated dispatch per data group + local-expert compute per rank,
    the ranks' outputs combined (the reference's psum)."""
    m = cfg.moe
    B, S, D = x.shape
    dp = n_pool // p["w_gate"].tp
    B_loc = B // dp if B % dp == 0 else B
    G = B // B_loc
    y, aux = _moe_groups(x.reshape(G, B_loc * S, D), p, m, _capacity(B_loc * S, m), with_aux=with_aux,
                         drops=drops, mask=mask)
    stand_in("all-reduce", B_loc * S * D * x.element_size(), n_pool)  # each group's ranks sum their experts'
    return _finish(p, x, y.view(B, S, D), m), aux


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, n_pool: Optional[int] = None, *, with_aux: bool = True,
              drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """x (B, S, D) at the TP level of the bound weights ``p``, in a pool of
    ``n_pool`` ranks (default: the TP level, one data group)."""
    tp = p["w_gate"].tp
    n_pool = tp if n_pool is None else n_pool
    if n_pool % tp:
        raise ValueError(f"TP {tp} does not divide the pool of {n_pool} ranks")
    if tp == 1:
        return moe_apply_local(p, x, cfg, with_aux=with_aux, drops=drops, mask=mask)
    return moe_apply_sharded(p, x, cfg, n_pool, with_aux=with_aux, drops=drops, mask=mask)
