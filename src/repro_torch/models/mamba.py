"""Mamba layers (mirrors repro/models/mamba.py).

Mamba-2 (SSD / state-space duality, arXiv:2405.21060): chunked matmul-form
algorithm, an intra-chunk attention-like term plus an inter-chunk state
recurrence. Mamba-1 (selective scan, used by Jamba): a chunked scan.

Tensor parallelism as in the reference: each rank of a TP group owns
d_inner / t channels (H / t heads for v2); across processes (weights bound
to a level of a pool) a layer runs on its rank's channels alone (mamba1's
state cache holds only them; mamba2, which the engine refuses, only
trains there, its heads reading the B/C groups they belong to). Under
autograd across processes the sums that each rank then uses for its own
channels (mamba1's B and C, the gated norm's sum of squares) are
``collectives.reduce_shared``, whose backward sums the ranks' gradients;
the replicated ``w_BC`` and ``conv_BC`` and the layer's input go through
``enter_model_group``. The column-parallel projections
(``w_z``, ``w_x``, ``w_dt``, mamba1's ``dt_proj``) and the row-parallel ones
(``w_out``, mamba1's ``w_dtr``, ``w_B``, ``w_C``, whose contraction runs over
the sharded channels; the ranks' partials summed in rank order) run once per
rank through the ``tp_shard_matmul`` kernel; so does the replicated
``w_BC``, once. The conv, the scans and the gated norm act on each channel
(head) alone, so they run once over the ranks' channels joined in rank
order; the gated norm's variance over all of d_inner is each rank's partial
sum of squares, added in rank order. The reference computes these in jnp,
outside any Pallas kernel, and so does the port, in plain PyTorch.

Decode is a single-step state update that writes the cache's state and conv
window **in place** (a CUDA graph reads the cache at fixed addresses): the
SSM state is what a TP switch carries for these families. Nothing here
syncs with the host or takes a data-dependent shape.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
from repro_torch.models.layers import col_parallel, row_parallel
from repro_torch.models.rounding import silu
from repro_torch.models.params import ParamDef
from repro_torch.parallel.collectives import Level, enter_model_group, reduce_shared
from repro_torch.parallel.sharding import ShardView


def causal_conv(x: torch.Tensor, w: torch.Tensor, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,C), w: (K,C), tail: (B,K-1,C) or None.

    Returns (y, new_tail) where new_tail is the last K-1 inputs.
    """
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    y = sum(w[k] * xp[:, k:k + S] for k in range(K))
    return y, xp[:, -(K - 1):]


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, tp: int = 1,
                   level: Optional[Level] = None):
    """RMSNorm of y * silu(z) over the last dim, which ``tp`` ranks share
    in equal contiguous parts: the sum of squares is each rank's partial
    sum, added in rank order (``reduce_shared``: in one process over the
    parts ``y`` holds, all ``tp`` of them; across processes ``y`` is this
    rank's part alone and the sum runs over the level's model group, whose
    ranks each normalise their own channels by the total, so that their
    gradients of it are summed too)."""
    dt = y.dtype
    y = y.float() * F.silu(z.float())
    here = tp if level is None else tp // level.tp  # the parts this process holds
    parts = (y * y).unflatten(-1, (here, -1)).sum(-1)  # (..., here)
    total = reduce_shared(list(parts.unbind(-1)), level, tp)
    var = (total / (y.shape[-1] * tp // here))[..., None]
    return (y * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def _col(x2: torch.Tensor, w: ShardView, entered: bool = False) -> torch.Tensor:
    """Column-parallel product, the ranks' outputs joined in rank order."""
    ys = col_parallel(x2, w, entered=entered)
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)


def _rank_parts(x2: torch.Tensor, tp: int) -> List[torch.Tensor]:
    """(M, C) -> each rank's (M, C / tp) contiguous input of a row-parallel product."""
    w = x2.shape[1] // tp
    return [x2[:, r * w:(r + 1) * w].contiguous() for r in range(tp)]


def _vec(p: ShardView) -> torch.Tensor:
    """A model-sharded 1-D leaf, the ranks' slices joined (a view at storage TP 1)."""
    return p.joined(0).view(-1)


# ===========================================================================
# Mamba-2 (SSD)
# ===========================================================================
def mamba2_param_defs(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d, d_in = cfg.d_model, cfg.d_inner
    H = d_in // m.head_dim
    gn = m.ngroups * m.d_state
    return {
        "w_z": ParamDef((d, d_in), ("embed", "inner")),
        "w_x": ParamDef((d, d_in), ("embed", "inner")),
        "w_BC": ParamDef((d, 2 * gn), ("embed", None)),
        "w_dt": ParamDef((d, H), ("embed", "inner")),
        "conv_x": ParamDef((m.d_conv, d_in), ("conv", "inner"), scale=0.5),
        "conv_BC": ParamDef((m.d_conv, 2 * gn), ("conv", None), scale=0.5),
        "A_log": ParamDef((H,), ("inner",), init="zeros"),
        "D": ParamDef((H,), ("inner",), init="ones"),
        "dt_bias": ParamDef((H,), ("inner",), init="zeros"),
        "norm": ParamDef((d_in,), ("inner",), init="zeros"),
        "w_out": ParamDef((d_in, d), ("inner", "embed")),
    }


def _ssd_chunked(xh, dt, A, Bh, Ch, chunk: int, h0: Optional[torch.Tensor] = None):
    """xh:(B,S,H,P) dt:(B,S,H) A:(H,) Bh,Ch:(B,S,G,N). Returns (y, h_final).

    Chunked SSD: within-chunk quadratic term via cumsum-difference decay,
    across-chunk linear recurrence (a loop over the chunks, the reference's
    lax.scan), which uses the state entering each chunk.
    """
    B, S, H, P = xh.shape
    G, N = Bh.shape[2], Bh.shape[3]
    rep = H // G
    if S % chunk != 0:  # odd small shapes: single chunk
        chunk = S
    nc = S // chunk
    Q = chunk

    x_c = xh.reshape(B, nc, Q, H, P)
    dt_c = dt.reshape(B, nc, Q, H).float()
    B_c = Bh.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3).float()  # (B,nc,Q,H,N)
    C_c = Ch.reshape(B, nc, Q, G, N).repeat_interleave(rep, dim=3).float()

    dA = dt_c * A.float()  # (B,nc,Q,H), <= 0
    cs = torch.cumsum(dA, dim=2)  # inclusive
    # L[l, s] = exp(sum_{k=s+1..l} dA_k) = exp(cs_l - cs_s), l >= s. The
    # *argument* is masked, not the result: exp of the (positive, huge)
    # upper-triangle differences would overflow to inf.
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B,nc,l,s,H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e9))

    xdt = x_c.float() * dt_c[..., None]  # (B,nc,Q,H,P)
    CB = torch.einsum("bclhn,bcshn->bclsh", C_c, B_c)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", CB * L, xdt)

    # chunk-final states: state_c = sum_s exp(cs_last - cs_s) B_s xdt_s
    decay_states = torch.exp(cs[:, :, -1:, :] - cs)  # (B,nc,Q,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", B_c, decay_states, xdt)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B,nc,H)

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device) if h0 is None else h0.float()
    prev = []
    for c in range(nc):
        prev.append(h)  # the state *entering* chunk c
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N)

    state_decay = torch.exp(cs)  # (B,nc,Q,H): decay from chunk start to l
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", C_c, prev_states, state_decay)
    return (y_diag + y_off).reshape(B, S, H, P), h


def mamba2_apply(p: dict, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
                 cache: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x (B,S,D) -> (out (B,S,D), cache). prefill: a new cache {"ssd":
    (B,H,P,N), "conv": (B,K-1,conv_dim)} in x's dtype; decode (S = 1): the
    given cache, updated in place (states kept in its dtype)."""
    m = cfg.mamba
    B, S, d = x.shape
    wo = p["w_out"]
    here, tp, level = len(wo.mats), wo.tp, wo.level  # the ranks this process holds: the TP group's, or its own
    d_in = cfg.d_inner * here // tp  # their channels
    H, P, G, N = d_in // m.head_dim, m.head_dim, m.ngroups, m.d_state
    if mode == "decode" and here != tp:
        raise NotImplementedError("mamba2 decodes in one process only: the engine refuses it, as the reference's does")
    rep = cfg.d_inner // m.head_dim // G  # heads per B/C group
    h0 = wo.ranks[0] * H // here  # this process's first head
    if H % rep and rep % H:
        raise NotImplementedError(f"{cfg.name}: {H} heads a process at {rep} heads a B/C group: a process's heads "
                                  f"must fill whole groups or lie in one, or B/C would reach the wrong heads")
    g0, g1 = h0 // rep, (h0 + H - 1) // rep + 1  # the groups its heads read (every group in one process)
    A = -torch.exp(_vec(p["A_log"]).float())
    D, dt_bias = _vec(p["D"]).float(), _vec(p["dt_bias"]).float()
    conv_x = p["conv_x"].joined(1)  # (K, d_in)
    # replicated leaves that feed every rank's heads: each rank's heads give their part of the gradient
    w_BC, conv_BC = enter_model_group(p["w_BC"], level), enter_model_group(p["conv_BC"], level)

    x2 = enter_model_group(x.reshape(B * S, d), level)  # z, x, dt and the shared B/C: one gradient all-reduce
    z = _col(x2, p["w_z"], entered=True).view(B, S, d_in)
    xs = _col(x2, p["w_x"], entered=True).view(B, S, d_in)
    BC = tp_shard_matmul(x2, w_BC, 0, n_out=2 * G * N, mode="col").view(B, S, 2 * G * N)
    dt = _col(x2, p["w_dt"], entered=True).view(B, S, H)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the cache")
        win = torch.cat([cache["conv"], torch.cat([xs[:, 0], BC[:, 0]], -1)[:, None]], 1)  # (B,K,conv_dim)
        xs1 = silu((win[..., :d_in] * conv_x).sum(1)).view(B, H, P)
        BC1 = silu((win[..., d_in:] * conv_BC).sum(1))
        cache["conv"].copy_(win[:, 1:])  # the shifted window; win was read first
        B1 = BC1[:, :G * N].reshape(B, G, N).repeat_interleave(H // G, dim=1)
        C1 = BC1[:, G * N:].reshape(B, G, N).repeat_interleave(H // G, dim=1)
        dt1 = F.softplus(dt[:, 0].float() + dt_bias)
        dA = torch.exp(dt1 * A)  # (B,H)
        h = cache["ssd"].float()
        h = h * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt1, B1.float(), xs1.float())
        y1 = torch.einsum("bhpn,bhn->bhp", h, C1.float())
        y1 = y1 + D[None, :, None] * xs1.float()
        y = y1.reshape(B, 1, d_in).to(x.dtype)
        cache["ssd"].copy_(h)
        new_cache = cache
    elif mode == "prefill":
        xs, conv_tail_x = causal_conv(xs, conv_x)
        BC, conv_tail_bc = causal_conv(BC, conv_BC)
        xs = silu(xs)
        BC = silu(BC)
        xh = xs.reshape(B, S, H, P)
        Bh = BC[..., :G * N].reshape(B, S, G, N)[:, :, g0:g1]
        Ch = BC[..., G * N:].reshape(B, S, G, N)[:, :, g0:g1]
        dt = F.softplus(dt.float() + dt_bias)
        y, h_final = _ssd_chunked(xh, dt, A, Bh, Ch, min(m.chunk, S))
        y = y + D[None, None, :, None] * xh.float()
        y = y.reshape(B, S, d_in).to(x.dtype)
        new_cache = {"ssd": h_final.to(x.dtype), "conv": torch.cat([conv_tail_x, conv_tail_bc], -1)}
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")

    y = _gated_rmsnorm(y, z, _vec(p["norm"]), tp=tp, level=level)
    out = row_parallel(_rank_parts(y.reshape(B * S, d_in), here), wo)
    return out.view(B, S, d), new_cache


def mamba2_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    m = cfg.mamba
    d_in = cfg.d_inner
    H = d_in // m.head_dim
    conv_dim = d_in + 2 * m.ngroups * m.d_state
    return {
        "ssd": ParamDef((batch, H, m.head_dim, m.d_state), ("batch", "inner", None, "state"), init="zeros"),
        "conv": ParamDef((batch, m.d_conv - 1, conv_dim), ("batch", None, None), init="zeros"),
    }


# ===========================================================================
# Mamba-1 (selective scan) — used by Jamba
# ===========================================================================
def mamba1_param_defs(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d, d_in, N = cfg.d_model, cfg.d_inner, m.d_state
    R = max(d // 16, 1)  # dt_rank
    return {
        "w_x": ParamDef((d, d_in), ("embed", "inner")),
        "w_z": ParamDef((d, d_in), ("embed", "inner")),
        "conv": ParamDef((m.d_conv, d_in), ("conv", "inner"), scale=0.5),
        "w_dtr": ParamDef((d_in, R), ("inner", None)),
        "w_B": ParamDef((d_in, N), ("inner", "state")),
        "w_C": ParamDef((d_in, N), ("inner", "state")),
        "dt_proj": ParamDef((R, d_in), (None, "inner")),
        "dt_bias": ParamDef((d_in,), ("inner",), init="zeros"),
        "A_log": ParamDef((d_in, N), ("inner", "state"), init="zeros"),
        "D": ParamDef((d_in,), ("inner",), init="ones"),
        "w_out": ParamDef((d_in, d), ("inner", "embed")),
    }


def _scan_pairs(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs (a, b) under the reference's
    combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2): h_q = a_q h_{q-1} + b_q
    unrolled. A doubling (Hillis-Steele) scan: ceil(log2 Q) whole-tensor
    steps, each combining every position with the one d before it. Its
    products associate in another order than jax.lax.associative_scan's
    tree, which moves the results by f32 rounding only."""
    Q, d = a.shape[1], 1
    while d < Q:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _sel_scan_fused(u, dt, Bc, Cc, A, h0, chunk: int):
    """Chunked selective scan.

    u, dt: (B,S,C); Bc, Cc: (B,S,N); A: (C,N); h0: (B,C,N).
    Returns (y (B,S,C), h_final).

    The (B,Q,C,N) discretized operands dA/dBx are built one chunk at a time
    (a loop over the chunks, the reference's lax.scan) and contracted with
    C_t at once, so the working set is O(B·Q·C·N), not O(B·S·C·N).
    """
    B_, S, C = u.shape
    if S % chunk != 0:
        chunk = S
    Q = chunk
    h, ys = h0, []
    for c in range(S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        uq, dtq, bq, cq = u[:, sl], dt[:, sl], Bc[:, sl], Cc[:, sl]
        dA = torch.exp(dtq[..., None] * A[None, None])  # (B,Q,C,N)
        dBx = dtq[..., None] * bq[:, :, None, :] * uq[..., None]
        a_pref, b_scan = _scan_pairs(dA, dBx)
        h_states = a_pref * h[:, None] + b_scan  # (B,Q,C,N)
        ys.append(torch.einsum("bqcn,bqn->bqc", h_states, cq))
        h = h_states[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_apply(p: dict, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
                 cache: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """x (B,S,D) -> (out (B,S,D), cache). prefill: a new cache {"h":
    (B,C,N), "conv": (B,K-1,C)} in x's dtype; decode (S = 1): the given
    cache, updated in place (states kept in its dtype). C is the channels
    of the ranks this process holds: d_inner in one process; across
    processes its rank's d_inner/t, which its column-parallel projections
    give and its conv, scan and state keep, the row-parallel ones summed
    over the model group."""
    m = cfg.mamba
    B, S, d = x.shape
    here = len(p["w_out"].mats)  # the ranks this process holds: the TP group's, or across processes its own
    d_in = cfg.d_inner * here // p["w_out"].tp  # their channels
    A = -torch.exp(p["A_log"].joined(0).float())  # (C,N)
    D, dt_bias = _vec(p["D"]).float(), _vec(p["dt_bias"]).float()
    conv = p["conv"].joined(1)  # (K, C)

    x2 = enter_model_group(x.reshape(B * S, d), p["w_out"].level)  # x and z share one gradient all-reduce
    xs = _col(x2, p["w_x"], entered=True).view(B, S, d_in)
    z = _col(x2, p["w_z"], entered=True).view(B, S, d_in)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs the cache")
        win = torch.cat([cache["conv"], xs[:, 0][:, None]], 1)  # (B,K,C)
        u = silu((win * conv).sum(1))  # (B,C)
        cache["conv"].copy_(win[:, 1:])  # the shifted window; win was read first
    elif mode == "prefill":
        u, conv_tail = causal_conv(xs, conv)
        u = silu(u)
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")

    parts = _rank_parts(u.reshape(-1, d_in), here)
    dtr = row_parallel(parts, p["w_dtr"])
    dt = F.softplus(_col(dtr, p["dt_proj"]).float() + dt_bias)  # (M, C); dt_proj's input takes *f*
    Bc = row_parallel(parts, p["w_B"], shared=True).float()  # (M, N), read by every rank's channels
    Cc = row_parallel(parts, p["w_C"], shared=True).float()
    uf = u.float()

    if mode == "decode":
        dA = torch.exp(dt[..., None] * A)  # (B,C,N)
        dBx = dt[..., None] * Bc[:, None, :] * uf[..., None]
        h = cache["h"].float() * dA + dBx
        y1 = torch.einsum("bcn,bn->bc", h, Cc) + D * uf
        y = y1[:, None].to(x.dtype)
        cache["h"].copy_(h)
        new_cache = cache
    else:
        N = m.d_state
        h0 = torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
        y, h_final = _sel_scan_fused(uf, dt.view(B, S, d_in), Bc.view(B, S, N), Cc.view(B, S, N), A, h0,
                                     min(m.chunk, S))
        y = (y + D * uf).to(x.dtype)
        new_cache = {"h": h_final.to(x.dtype), "conv": conv_tail}

    y = (y.float() * F.silu(z.float())).to(x.dtype)
    out = row_parallel(_rank_parts(y.reshape(B * S, d_in), here), p["w_out"])
    return out.view(B, S, d), new_cache


def mamba1_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    m = cfg.mamba
    return {
        "h": ParamDef((batch, cfg.d_inner, m.d_state), ("batch", "inner", "state"), init="zeros"),
        "conv": ParamDef((batch, m.d_conv - 1, cfg.d_inner), ("batch", None, "inner"), init="zeros"),
    }
