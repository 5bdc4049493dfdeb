"""AdamW with ZeRO-1 optimizer-state sharding (mirrors
repro/training/optimizer.py).

The update writes the parameters in place under ``torch.no_grad()``, so
the ``ShardView``s that ``WeightStore.rebind`` made of them stay valid
without a rebind: the counterpart of the reference's ``donate_argnums``.
Bias corrections and the learning rate are f32 tensors computed as the
reference computes them.

ZeRO-1: each moment leaf is split over the dp data ranks along one dim,
the first that the reference's rules leave unsharded and dp divides
(``zero1_dim``, the reference's ``zero1_pspec`` under ``DEFAULT_RULES``).
On one card each rank's slice is a tensor of its own (``Zero1Shards``),
updated one rank after another against the same slice of the gradient and
of the parameter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.params import ParamDef, tree_leaves_with_path
from repro_torch.parallel.sharding import MODEL_AXES

Path = Tuple[str, ...]

# logical axes that DEFAULT_RULES place on the "data" mesh axis (activations only)
DATA_AXES = frozenset({"batch", "res_batch"})


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    dtype: torch.dtype = torch.float32  # moment dtype


@dataclass
class Zero1Shards:
    """One moment leaf split over the data ranks: rank r holds ``parts[r]``,
    the r-th equal slice along ``dim``."""

    dim: int
    parts: List[torch.Tensor]

    def full(self) -> torch.Tensor:
        return torch.cat(self.parts, self.dim)


def zero1_dim(d: ParamDef, dp: int) -> Optional[int]:
    """The dim a leaf's moments split over ``dp`` data ranks, or None: the
    first dim that no rule shards, that dp divides and that is at least dp
    long, on a (data, model) mesh under DEFAULT_RULES (the reference's
    ``zero1_pspec``)."""
    if any(ax in DATA_AXES for ax in d.axes):  # the data axis is taken already
        return None
    for i, (n, ax) in enumerate(zip(d.shape, d.axes)):
        if ax not in MODEL_AXES and n % dp == 0 and n >= dp:
            return i
    return None


@dataclass(frozen=True)
class Zero1Plan:
    dp: int
    dims: Dict[Path, Optional[int]]


def zero1_plan(defs, dp: int) -> Zero1Plan:
    """``zero1_dim`` of every leaf of a ParamDef tree."""
    return Zero1Plan(dp, {path: zero1_dim(d, dp) for path, d in tree_leaves_with_path(defs)})


def _split(t: torch.Tensor, dim: Optional[int], dp: int) -> List[Tuple[int, int]]:
    """(start, length) of each rank's slice along ``dim``."""
    n = t.shape[dim] // dp
    return [(r * n, n) for r in range(dp)]


def adamw_init(params, dtype: torch.dtype = torch.float32, plan: Optional[Zero1Plan] = None):
    def zeros(path, p):
        dim = plan.dims[path] if plan is not None else None
        if dim is None:
            return torch.zeros(p.shape, dtype=dtype, device=p.device)
        return Zero1Shards(dim, [torch.zeros(p.narrow(dim, s, n).shape, dtype=dtype, device=p.device)
                                 for s, n in _split(p, dim, plan.dp)])

    def moments():
        out: dict = {}
        for path, p in tree_leaves_with_path(params):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = zeros(path, p)
        return out

    return {"mu": moments(), "nu": moments(), "count": torch.zeros((), dtype=torch.int32,
                                                                   device=_device_of(params))}


def _device_of(tree) -> torch.device:
    return next(iter(tree_leaves_with_path(tree)))[1].device


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    return cfg.lr * warm


def _pieces(m, v, g: torch.Tensor, p: torch.Tensor):
    """(g, m, v, p) per data rank: the moments' own tensors against the
    same slices of the gradient and the parameter."""
    if not isinstance(m, Zero1Shards):
        return [(g, m, v, p)]
    return [(g.narrow(m.dim, s, n), m_r, v_r, p.narrow(m.dim, s, n))
            for (s, n), m_r, v_r in zip(_split(p, m.dim, len(m.parts)), m.parts, v.parts)]


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step. Writes ``params`` and the moments in place and
    returns (params, state) with the count advanced."""
    count = state["count"] + 1
    step = count.float()
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=step.device) ** step
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=step.device) ** step
    mus, nus, gs = (dict(tree_leaves_with_path(t)) for t in (state["mu"], state["nu"], grads))
    with torch.no_grad():
        for path, p_leaf in tree_leaves_with_path(params):
            for g, m, v, p in _pieces(mus[path], nus[path], gs[path], p_leaf):
                # the reference's expressions, evaluated in place where that
                # rounds the same (a product's operands commute): at most
                # three leaf-sized temporaries
                g = g.to(cfg.dtype)
                m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
                v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
                step_ = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
                step_.add_(cfg.weight_decay * p.to(cfg.dtype)).mul_(lr)
                if p.dtype == cfg.dtype:
                    p.sub_(step_)
                else:
                    p.copy_((p.to(cfg.dtype) - step_).to(p.dtype))
        state["count"].copy_(count)
    return params, state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for _, x in tree_leaves_with_path(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    with torch.no_grad():
        for _, g in tree_leaves_with_path(grads):
            if g.dtype == scale.dtype:
                g.mul_(scale)
            else:
                g.copy_((g * scale).to(g.dtype))
    return grads, norm

