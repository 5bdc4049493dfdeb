"""Gradient compression for the data-parallel gradient sum (mirrors
repro/training/grad_compress.py).

int8 block-quantization with error feedback: each leaf is quantized per
block of 2048 with a per-block absmax scale; the quantization residual is
carried in an error-feedback buffer so compression bias vanishes over steps
(1-bit-Adam-style convergence argument). As in the reference on one host,
the quantize/dequantize transform is applied in place of the wire: the
same numerics, no transfer. ``torch.round`` rounds half to even, as
``jnp.round`` does.

Across processes (``compress_grads(..., level=)``) the blocks are still
those of each logical leaf flattened whole: a model shard or a ZeRO slice
is not a contiguous span of that flattening, so each rank gathers the
leaf's reduced gradient over the model group and its error over the data
and model groups, quantizes the whole leaf (every rank the same), and keeps
its own model shard of the result. The error lives as the reference shards
it, like the first moment: each rank holds its model shard's ZeRO slice.
A leaf the rules shard over data (weight FSDP) is this rank's block of its
model shard, gradient and error alike: both are gathered over the data
group as well, so each block's scale spans the whole logical leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves_with_path, tree_map
from repro_torch.parallel.collectives import Level, all_gather
from repro_torch.training.optimizer import Zero1Shards


@dataclass(frozen=True)
class CompressConfig:
    enabled: bool = False
    block: int = 2048
    bits: int = 8


def quantize_leaf(g: torch.Tensor, err: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int8 blocks (n_blocks, block), dequantized g in g's dtype, new error
    (f32, g's shape)) of g plus its carried error."""
    flat = g.float().reshape(-1)
    if err is not None:
        flat = flat + err.reshape(-1)
    n = flat.shape[0]
    fp = torch.nn.functional.pad(flat, (0, (-n) % block)).view(-1, block)
    scale = (fp.abs().amax(1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:n]
    new_err = flat - deq
    return q, deq.view(g.shape).to(g.dtype), new_err.view(g.shape)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads, err_state, cfg: CompressConfig, model_dims: Optional[Dict] = None,
                   level: Optional[Level] = None, data_dims: Optional[Dict] = None):
    """Returns (the gradients as they would arrive after the sum, the new
    error-feedback state). Both trees are written in place (the port owns
    its gradient buffers) and returned. Across processes ``level`` is the
    pool's level, ``model_dims`` {path: the model-sharded dim or None} and
    ``data_dims`` {path: the data-sharded dim} of the leaves sharded over
    data."""
    if not cfg.enabled:
        return grads, err_state
    errs = dict(tree_leaves_with_path(err_state))
    with torch.no_grad():
        for path, g in tree_leaves_with_path(grads):
            e = errs[path]
            if level is None:
                _, deq, new_err = quantize_leaf(g, e, cfg.block)
                g.copy_(deq)
                e.copy_(new_err)
                continue
            g_w, e_w = g, e.full() if isinstance(e, Zero1Shards) else e
            cuts = []  # the logical leaf, then this rank's block of the results
            for dim, group, index in (((data_dims or {}).get(path) if level.dp > 1 else None, level.data,
                                       level.data_rank),
                                      (model_dims[path] if level.tp > 1 else None, level.model, level.model_rank)):
                if dim is not None:
                    cuts.append((dim, index * g_w.shape[dim], g_w.shape[dim]))
                    g_w, e_w = all_gather(g_w, group, dim), all_gather(e_w, group, dim)
            _, deq, new_err = quantize_leaf(g_w, e_w, cfg.block)
            for dim, start, n in cuts:
                deq, new_err = deq.narrow(dim, start, n), new_err.narrow(dim, start, n)
            g.copy_(deq)
            if isinstance(e, Zero1Shards):
                n = new_err.shape[e.dim] // e.n
                e.parts[0].copy_(new_err.narrow(e.dim, e.index * n, n))
            else:
                e.copy_(new_err)
    return grads, err_state
