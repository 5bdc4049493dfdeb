"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, softcap, and the
tensor-parallel projections every model-sharded weight goes through.

Mirrors repro/models/layers.py. A TP-bound weight is a ``ShardView``: each
rank's product runs through the ``tp_shard_matmul`` kernel at that rank's
offset into the shared storage tensor. The functions work on the ranks this
process holds (every rank of the group in one process, its own rank across
processes). Column-parallel outputs stay per rank (or are concatenated in
rank order); row-parallel partials are summed in rank order and, across
processes, over the model group (``collectives.reduce_ranks``, the
reference's psum). Under autograd across processes a column-parallel
product's replicated input goes through ``enter_model_group`` first, so
that its gradient sums every rank's part (Megatron's *f*; the psum is its
*g*).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
from repro_torch.models.params import ParamDef
from repro_torch.models.rounding import shared, silu
from repro_torch.parallel.collectives import enter_model_group, reduce_ranks, reduce_shared
from repro_torch.parallel.sharding import ShardView


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a norm, RoPE, softmax, router or head computes in: f32, or
    f64 for f64 inputs (an f64 evaluation of the model keeps its precision
    end to end; bf16 and f32 are computed as before, in f32)."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """In f32 (``wide``), cast to ``dtype`` (x's by default; a train-mode
    layer's norms take theirs from ``rounding.norm_dtype``)."""
    dt = dtype or x.dtype
    x = x.to(wide(x.dtype))
    y = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(x.dtype))).to(dt)


def norm_def(d_model: int) -> ParamDef:
    # stored as (scale - 1) so zeros-init => identity (gemma convention)
    return ParamDef((d_model,), ("embed",), init="zeros")


def rope_freqs(head_dim: int, theta: float, device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=dtype, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Rotates the
    two halves of hd (not interleaved pairs), angles in f32 (``wide``)."""
    ct = wide(x.dtype)
    freqs = rope_freqs(x.shape[-1], theta, x.device, ct)
    ang = positions[..., None].to(ct) * freqs  # (..., S, hd/2)
    cos = ang.cos()[..., None, :]
    sin = ang.sin()[..., None, :]
    x1, x2 = x.to(ct).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Tensor-parallel projections
# ---------------------------------------------------------------------------
def col_parallel(x: torch.Tensor, w: ShardView, out_dtype=None, entered: bool = False) -> List[torch.Tensor]:
    """x (M, K) -> one (M, width) output per rank. ``entered``: x went
    through ``enter_model_group`` already (one input shared by several
    projections takes one all-reduce of its gradient)."""
    if not entered:
        x = enter_model_group(x, w.level)
    return [
        tp_shard_matmul(x, m, off, n_out=w.width, mode="col", out_dtype=out_dtype)
        for m, off in zip(w.mats, w.offsets)
    ]


def row_parallel(xs: List[torch.Tensor], w: ShardView, shared: bool = False) -> torch.Tensor:
    """Per-rank inputs (M, width) -> sum over the group's ranks, in rank
    order. ``shared``: each rank then uses the sum in its own way, so under
    autograd across processes its gradient is summed over the model group
    too (``collectives.reduce_shared``)."""
    parts = [tp_shard_matmul(x, m, off, n_out=m.shape[1], mode="row") for x, m, off in zip(xs, w.mats, w.offsets)]
    return (reduce_shared if shared else reduce_ranks)(parts, w.level, w.tp)


def tied_head(x: torch.Tensor, embed: ShardView) -> List[torch.Tensor]:
    """The tied LM head per rank, in f32: rank r's logits are
    x @ embed[r's vocab rows].T, the embedding's (vocab, d) rows read in
    place at the rank's offset."""
    x = enter_model_group(x, embed.level)
    return [
        tp_shard_matmul(x, m, off, n_out=embed.width, mode="col_t", out_dtype=torch.float32)
        for m, off in zip(embed.mats, embed.offsets)
    ]


def vocab_parallel_embed(tokens: torch.Tensor, w: ShardView) -> torch.Tensor:
    """Embedding lookup with the table sharded over the vocab: rank r owns
    global rows r*width..(r+1)*width and contributes only those tokens."""
    parts = []
    for r, m, off in zip(w.ranks, w.mats, w.offsets):
        local = tokens - r * w.width
        mine = (local >= 0) & (local < w.width)
        rows = m.narrow(0, off, w.width)[local.clamp(0, w.width - 1)]
        parts.append(torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
    return reduce_ranks(parts, w.level, w.tp)


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP (column -> row parallel; one reduction at the output)
# ---------------------------------------------------------------------------
def mlp_param_defs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_in": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_out": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = enter_model_group(x.reshape(-1, x.shape[-1]), p["w_gate"].level)
    xg, xi = shared(x2, 2, p["w_gate"].mats[0].dtype)
    hs = [silu(g) * u for g, u in zip(col_parallel(xg, p["w_gate"], entered=True),
                                        col_parallel(xi, p["w_in"], entered=True))]
    return row_parallel(hs, p["w_out"]).reshape(*lead, -1)
