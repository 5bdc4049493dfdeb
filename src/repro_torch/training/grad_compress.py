"""Gradient compression for the data-parallel gradient sum (mirrors
repro/training/grad_compress.py).

int8 block-quantization with error feedback: each leaf is quantized per
block of 2048 with a per-block absmax scale; the quantization residual is
carried in an error-feedback buffer so compression bias vanishes over steps
(1-bit-Adam-style convergence argument). As in the reference on one host,
the quantize/dequantize transform is applied in place of the wire: the
same numerics, no transfer. ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.models.params import tree_leaves_with_path, tree_map


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


def compress_grads(grads, err_state, cfg: CompressConfig):
    """Returns (the gradients as they would arrive after the sum, the new
    error-feedback state). Both trees are written in place (the port owns
    its gradient buffers) and returned."""
    if not cfg.enabled:
        return grads, err_state
    errs = dict(tree_leaves_with_path(err_state))
    with torch.no_grad():
        for path, g in tree_leaves_with_path(grads):
            _, deq, new_err = quantize_leaf(g, errs[path], cfg.block)
            g.copy_(deq)
            errs[path].copy_(new_err)
    return grads, err_state
