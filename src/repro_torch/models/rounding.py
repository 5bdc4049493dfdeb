"""Where a train step in a low precision (bf16) rounds: the reference's
rounding points, in one place.

The reference's numbers are its compiled train step's, not its source's op
by op: XLA fuses a layer's residual add into the norm that reads it, keeps
the norm's output in f32 until each projection rounds its own copy, sums
those projections' gradients in a fixed order, and evaluates ``silu`` step
by step. A train-mode layer (``model.decoder_layer``) runs inside
``train_rounding(True)``, and the functions here follow those points
there. Everywhere else (serving's prefill and decode) they are the plain
ops, one rounding each: no serving test reads the train step's bits, and
the extra elementwise passes cost a decode step 3-11% on an H100. In f32
every function here is the plain op either way.

The switch is per thread: a layer sets it inside itself, so the layer's
recompute in backward (``torch.utils.checkpoint``, on autograd's thread)
sets it again.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Tuple

import torch
import torch.nn.functional as F

_state = threading.local()


@contextmanager
def train_rounding(on: bool):
    """The reference's train-step rounding points inside the block when
    ``on``, the plain ops when not."""
    before = getattr(_state, "on", False)
    _state.on = on
    try:
        yield
    finally:
        _state.on = before


def _on(dtype: torch.dtype) -> bool:
    return dtype != torch.float32 and getattr(_state, "on", False)


def norm_dtype(kind: str, dtype: torch.dtype) -> torch.dtype:
    """The dtype a layer's norm hands to its mixer or FFN of ``kind``: at
    the rounding points f32 for attention and the dense MLP, which round it
    once for each projection (``shared``), so that the projections'
    gradients are summed in f32 as the reference's compiled step sums them;
    else ``dtype``."""
    return torch.float32 if _on(dtype) and (kind.startswith("attn") or kind == "dense") else dtype


def residual_sum(h: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h + y in h's dtype, the same sum for the norm that reads it next).
    At the rounding points the norm's is the f32 sum, unrounded: the
    reference's compiled step fuses the add into the norm. Under autograd
    its gradient flows as the rounded sum's, as the reference's does (the
    f32 sum's excess over the rounded one is held constant and adds back
    exactly: the two lie within a factor of 2)."""
    if not _on(h.dtype):
        r = h + y
        return r, r
    s = h.float() + y  # exact but where the two lie 2^16 apart; then rounded as h + y rounds it
    r = s.to(h.dtype)
    if not (torch.is_grad_enabled() and r.requires_grad):
        return r, s
    rf = r.float()
    return r, rf + (s - rf).detach()


class _Shared(torch.autograd.Function):
    """A norm's f32 output rounded to the projections' dtype, one copy for
    each of ``n`` projections that read it. Backward sums their gradients
    as the reference's compiled step does before the norm's backward: from
    the last projection's to the first's, each add rounded to the
    projections' dtype but the last, which is kept in f32."""

    @staticmethod
    def forward(ctx, x, n, dtype):
        r = x.to(dtype)
        return tuple(r.view_as(r) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        total = gs[-1]
        for g in gs[-2:0:-1]:
            total = total + g
        return total.float() + gs[0].float(), None, None


def shared(x: torch.Tensor, n: int, dtype: torch.dtype) -> List[torch.Tensor]:
    """``x`` for ``n`` projections of ``dtype``: itself when it is of that
    dtype (``norm_dtype`` gave it), else ``_Shared``'s copies."""
    if x.dtype == dtype:
        return [x] * n
    return list(_Shared.apply(x, n, dtype))


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` in a low-precision dtype as XLA evaluates it, each
    step rounded to x's dtype: forward x * f, f = 1 / (1 + exp(-x)); backward
    (jax's custom JVP, transposed) g * f + (x * g) * (f * (1 - f))."""

    @staticmethod
    def forward(ctx, x):
        f = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, f)
        return x * f

    @staticmethod
    def backward(ctx, g):
        x, f = ctx.saved_tensors
        return g * f + (x * g) * (f * (1.0 - f))


def silu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.silu``: at the rounding points ``_Silu``'s
    steps, each rounded, which is not ``F.silu``'s one rounding; else
    ``F.silu`` (in f32 the two agree to an ulp)."""
    return _Silu.apply(x) if _on(x.dtype) else F.silu(x)
