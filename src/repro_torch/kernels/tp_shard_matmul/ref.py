"""Plain PyTorch version of the TP-shard-selecting matmul (mirrors
repro/kernels/tp_shard_matmul/ref.py)."""
from __future__ import annotations

from typing import Optional

import torch


def tp_shard_matmul_ref(
    x: torch.Tensor,
    w_store: torch.Tensor,
    offset: int,
    *,
    mode: str,
    n_out: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """col: x @ w_store[:, offset:offset+n_out]; row: x @ w_store[offset:offset+K, :];
    col_t: x @ w_store[offset:offset+n_out, :].T (w_store holds the weight's
    columns as rows, as a tied head reads the (vocab, d) embedding).

    Products are taken in f32 (in f64 for f64 operands, an f64 evaluation
    on a plain device); the result is cast to ``out_dtype`` (x's dtype by
    default).
    """
    if mode == "col":
        w = w_store[:, offset:offset + n_out]
    elif mode == "row":
        w = w_store[offset:offset + x.shape[1], :]
    elif mode == "col_t":
        w = w_store[offset:offset + n_out, :].t()
    else:
        raise ValueError(mode)
    ct = torch.promote_types(x.dtype, torch.float32)
    return (x.to(ct) @ w.to(ct)).to(out_dtype or x.dtype)
