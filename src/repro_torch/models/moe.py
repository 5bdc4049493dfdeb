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

In one process the sharded and decode paths are loops over the ranks: rank
r runs its E/t experts (the bound ``ShardView``'s ``block(r, ...)``, a view
of the stored experts) over every group's rows. Across processes (weights
bound to a level of a ``collectives.Pool``) each process is one rank and
holds its data group's rows: the sharded path dispatches its own (B/dp) x
(S/t) block, moves each expert shard's rows to its rank and back with two
real all-to-alls over the model group and gathers the blocks back along
the sequence; the decode path runs its E/t experts on its group's rows and
all-reduces the combined outputs over the model group; at TP 1 the data
groups' rows are gathered, dispatched together and cut back. Rows that are
one batch replicated over the data groups (``replicated``: the engine's
prefill of one prompt, run by every data group) are the reference's batch
itself, not dp batches: at TP 1 the local path at ``_capacity(B*S)``, at
1 < t < N the decode path's one group (B % dp != 0), at t = N the sharded
path. Drops are counted once per dispatch: a dispatch that several ranks
run alike (a model group's, or every data group's) counts on one of them,
so the pool's count is the sum over its ranks.

Across processes every path is differentiable (``make_train_step(...,
pool=)`` trains through it), each collective a ``parallel.collectives``
Function: the sharded path's two all-to-alls send each chunk's gradient
back the way it came; its block of the rows and the router (a replicated
leaf each rank applies to its own block) enter through
``enter_model_group``, and its output is gathered along the sequence with
``gather_ranks`` (each rank's slice of the replicated gradient). The
decode path's rows and router enter the same way (each rank combines only
its experts' rows) and its psum is ``reduce_ranks``. At TP 1 the data
groups' rows are gathered with ``gather_summed``: every data rank's
objective holds the whole batch's aux losses, so a rank's rows take the
data group's gradients summed. The aux losses' pmean over the pool is
``pool_mean``, whose gradient is that of the mean of every block's loss,
each counted once (the reference's, measured on its mesh).

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
through ``tp_shard_matmul`` (``layers.mlp_apply``). Under a train step's
rules with ``expert_embed -> data`` (expert-weight FSDP, the reference's
``_gather_weights``) each card holds its data block of its experts'
weights, w_gate and w_in split along D (dim 1 of a layer's (E, D, F)),
w_out along D (dim 2); ``models.model`` gathers them over the data group
at the start of the layer, as every other leaf the rules shard over data,
so every path here (the all-to-all at t = N, the TP-1 gather of the data
groups' rows, the decode path at 1 < t < N) reads them whole, and their
gradients go back reduce-scattered. The engine's rules shard nothing over
data: its expert weights lie whole on each card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models.layers import mlp_apply
from repro_torch.models.params import ParamDef
from repro_torch.parallel.collectives import (
    all_gather, all_to_all, enter_model_group, gather_ranks, gather_summed, pool_mean, reduce_ranks, stand_in,
)


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


def _rank_ffn(p: dict, i: int, b: torch.Tensor, m: MoESpec) -> torch.Tensor:
    """The expert FFN of the i-th rank this process holds over its experts'
    rows b (E/t, rows, D)."""
    D, Fe = b.shape[-1], m.d_ff_expert
    return _expert_ffn(b, p["w_gate"].block(i, D, Fe), p["w_in"].block(i, D, Fe), p["w_out"].block(i, Fe, D))


def _experts_in_process(buf: torch.Tensor, p: dict, m: MoESpec) -> torch.Tensor:
    """buf (G, E, C, D) -> each expert's output rows, (E*G*C, D) in (e, g,
    c) order: every rank of the group in this process, rank r its E/t
    experts over every group's rows."""
    G, E, C, D = buf.shape
    t = p["w_gate"].tp
    E_loc = E // t
    outs = []
    for r in range(t):
        outs.append(_rank_ffn(p, r, buf[:, r * E_loc:(r + 1) * E_loc].transpose(0, 1).reshape(E_loc, G * C, D), m))
    return (torch.cat(outs, 0) if t > 1 else outs[0]).reshape(E * G * C, D)


def _experts_own(buf: torch.Tensor, p: dict, m: MoESpec) -> torch.Tensor:
    """Across processes, the decode path: this rank's E/t experts over every
    group's rows, the other experts' rows zero (the model group's all-reduce
    of the combined outputs adds them)."""
    G, E, C, D = buf.shape
    lv = p["w_gate"].level
    E_loc = E // lv.tp
    e0 = lv.model_rank * E_loc
    own = _rank_ffn(p, 0, buf[:, e0:e0 + E_loc].transpose(0, 1).reshape(E_loc, G * C, D), m)
    out = torch.zeros((E, G * C, D), dtype=own.dtype, device=own.device)
    out[e0:e0 + E_loc] = own
    return out.reshape(E * G * C, D)


def _experts_all_to_all(buf: torch.Tensor, p: dict, m: MoESpec) -> torch.Tensor:
    """Across processes, the sharded path (one group of this rank's tokens):
    each expert shard's (E/t, C, D) rows to the rank that holds it and back,
    two all-to-alls over the model group, as the reference's."""
    _, E, C, D = buf.shape
    lv = p["w_gate"].level
    t, E_loc = lv.tp, E // lv.tp
    got = all_to_all(buf.reshape(t, E_loc, C, D), lv.model)  # [k]: rank k's tokens for this rank's experts
    out = _rank_ffn(p, 0, got.transpose(0, 1).reshape(E_loc, t * C, D), m)
    back = all_to_all(out.view(E_loc, t, C, D).transpose(0, 1), lv.model)  # [k]: expert rank k's outputs
    return back.reshape(E * C, D)


def _moe_groups(xg: torch.Tensor, p: dict, m: MoESpec, C: int, *, with_aux: bool,
                drops: Optional[torch.Tensor], mask: Optional[torch.Tensor], expert_fn=_experts_in_process):
    """Dispatch -> expert FFN (``expert_fn``) -> combine for G groups of
    tokens, each group dispatched on its own at capacity C.

    xg: (G, Tg, D). ``drops``, a (1,)
    int64 tensor, gains the dropped assignments of the tokens ``mask``
    (G, Tg) holds (all tokens without a mask). Returns (y (G, Tg, D), aux).
    """
    G, Tg, D = xg.shape
    E, K = m.num_experts, m.top_k
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

    out = expert_fn(buf, p, m)  # row (e, g, c)

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
                      drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                      replicated: bool = False):
    """The reference's sharded train/prefill path at TP t over a pool of
    ``n_pool`` ranks; falls back to the decode path as the reference does.
    Across processes ``x`` is this rank's data group's rows, or with
    ``replicated`` the whole batch on every data group."""
    m = cfg.moe
    B, S, D = x.shape
    lv = p["w_gate"].level
    tp = p["w_gate"].tp
    dp = n_pool // tp
    if lv is not None:  # the whole batch, over the pool's data groups
        B, dp = (B if replicated else B * lv.dp), lv.dp
    if S % tp != 0 or B % dp != 0:  # decode / tiny shapes: replicated dispatch per data group
        return _moe_apply_decode(p, x, cfg, n_pool, with_aux=with_aux, drops=drops, mask=mask)
    Bl, Sl = B // dp, S // tp
    if lv is not None:  # this rank's block (its data group's rows, its model coordinate's positions)
        cols = slice(lv.model_rank * Sl, (lv.model_rank + 1) * Sl)
        C = _capacity(Bl * Sl, m)
        xe, pe = _entered(p, x, lv)
        y, aux = _moe_groups(xe[:, cols].reshape(1, Bl * Sl, D), pe, m, C, with_aux=with_aux, drops=drops,
                             mask=None if mask is None else mask[:, cols].reshape(1, Bl * Sl),
                             expert_fn=_experts_all_to_all)
        for _ in ("dispatch", "return"):
            stand_in("all-to-all", m.num_experts * C * D * x.element_size(), dp * tp)
        y = gather_ranks([y.view(Bl, Sl, D)], lv, dim=1)  # the residual stream whole on the model group
        return _finish(p, x, y, m), _pool_mean(aux, lv)

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
    lv = p["w_gate"].level
    dp = n_pool // p["w_gate"].tp
    B_loc = B // dp if B % dp == 0 else B
    if lv is not None:  # across processes x is already this data group's rows (or one replicated group)
        B_loc = B
        if lv.model_rank:  # the model group's ranks dispatch the same rows: counted on its first
            drops = None
    G = B // B_loc
    xe, pe = _entered(p, x, lv)
    y, aux = _moe_groups(xe.reshape(G, B_loc * S, D), pe, m, _capacity(B_loc * S, m), with_aux=with_aux,
                         drops=drops, mask=mask, expert_fn=_experts_in_process if lv is None else _experts_own)
    if lv is None:
        stand_in("all-reduce", B_loc * S * D * x.element_size(), n_pool)  # each group's ranks sum their experts'
    else:
        y = reduce_ranks([y], lv, lv.tp)
        aux = _pool_mean(aux, lv)
    return _finish(p, x, y.view(B, S, D), m), aux


def _entered(p: dict, x: torch.Tensor, lv) -> Tuple[torch.Tensor, dict]:
    """Across processes, the rows and the router as the routed experts
    take them: each model rank's dispatch and combine give only its part of
    their gradients (its block of the rows, or its experts' share of every
    row), so both go through ``enter_model_group`` (the router is a
    replicated leaf, as the qk-norm scales are). The shared experts take
    ``x`` itself, entered on their own."""
    if lv is None:
        return x, p
    return enter_model_group(x, lv), {**p, "router": enter_model_group(p["router"], lv)}


def _pool_mean(aux: dict, lv) -> dict:
    """Across processes, each aux loss averaged over the pool (the
    reference's pmean over model and data; ``collectives.pool_mean``, under
    autograd the gradient of the mean of every rank's loss)."""
    return {k: pool_mean(v, lv) for k, v in aux.items()}


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, n_pool: Optional[int] = None, *, with_aux: bool = True,
              drops: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
              replicated: bool = False) -> Tuple[torch.Tensor, dict]:
    """x (B, S, D) at the TP level of the bound weights ``p``, in a pool of
    ``n_pool`` ranks (default: the TP level, one data group). Across
    processes (the weights bound to a level of a pool) ``x`` is this rank's
    data group's rows, the same on its model group, and so is the output;
    with ``replicated`` it is the whole batch, the same on every rank (the
    engine's prefill of one prompt: a batch the reference does not split
    over the data groups), and so is the output. In one process
    ``replicated`` changes nothing: ``x`` is the whole batch."""
    tp = p["w_gate"].tp
    lv = p["w_gate"].level
    n_pool = (tp if n_pool is None else n_pool) if lv is None else lv.tp * lv.dp
    if n_pool % tp:
        raise ValueError(f"TP {tp} does not divide the pool of {n_pool} ranks")
    if lv is not None and replicated and lv.dp > 1:
        if tp > 1 and x.shape[0] % lv.dp == 0:
            raise ValueError(f"replicated rows: a batch of {x.shape[0]} the reference splits over {lv.dp} data groups")
        if lv.data_rank:  # every data group dispatches the same rows: counted on the first
            drops = None
    if tp == 1 and lv is not None and lv.dp > 1 and not replicated:  # the reference dispatches the whole batch
        B = x.shape[0]
        whole = gather_summed(x, lv.data)  # every data rank's objective holds the whole batch's aux losses
        y, aux = moe_apply_local(p, whole, cfg, with_aux=with_aux, drops=drops if lv.data_rank == 0 else None,
                                 mask=None if mask is None else all_gather(mask, lv.data, 0))
        return y[lv.data_rank * B:(lv.data_rank + 1) * B], aux
    if tp == 1:
        return moe_apply_local(p, x, cfg, with_aux=with_aux, drops=drops, mask=mask)
    return moe_apply_sharded(p, x, cfg, n_pool, with_aux=with_aux, drops=drops, mask=mask, replicated=replicated)
