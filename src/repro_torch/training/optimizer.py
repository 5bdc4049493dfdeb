"""AdamW with ZeRO-1 optimizer-state sharding (mirrors
repro/training/optimizer.py).

The update writes the parameters in place under ``torch.no_grad()``, so
the ``ShardView``s that ``WeightStore.rebind`` made of them stay valid
without a rebind: the counterpart of the reference's ``donate_argnums``.
Bias corrections and the learning rate are f32 tensors computed as the
reference computes them.

ZeRO-1: each moment leaf is split over the dp data ranks along one dim,
the first that the reference's rules leave unsharded and dp divides
(``zero1_dim``, the reference's ``zero1_pspec``); a leaf the rules shard
over data already (weight FSDP) is not split again: its moments are its
block, as its parameter is, updated in place with no gather.
On one card each rank's slice is a tensor of its own (``Zero1Shards``),
updated one rank after another against the same slice of the gradient and
of the parameter. Across processes (``adamw_init(..., group=)``, the data
group of a pool) each data rank holds its own slice alone, updates that
slice of the parameter, and the slices are all-gathered along the ZeRO dim
over the data group into every rank's parameter; a leaf ``zero1_dim``
leaves whole is updated whole on every rank, from the same reduced
gradient, so it comes out the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.params import ParamDef, tree_leaves_with_path, tree_map_with_path
from repro_torch.parallel.collectives import Group, all_gather, gather_into
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, pspec_for

Path = Tuple[str, ...]


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
    """One moment leaf split over the data ranks along ``dim``: in one
    process rank r holds ``parts[r]``, the r-th equal slice; across
    processes (``group``, the data group) ``parts`` holds this rank's
    slice alone, the ``index``-th."""

    dim: int
    parts: List[torch.Tensor]
    index: int = 0
    group: Optional[Group] = None

    @property
    def n(self) -> int:
        """The number of slices."""
        return len(self.parts) if self.group is None else self.group.size

    def full(self) -> torch.Tensor:
        """The whole leaf (across processes an all-gather over the data
        group: every member calls it)."""
        if self.group is None:
            return torch.cat(self.parts, self.dim)
        return all_gather(self.parts[0], self.group, self.dim)


def zero1_dim(d: ParamDef, dp: int, rules: ShardingRules = DEFAULT_RULES) -> Optional[int]:
    """The dim a leaf's moments split over ``dp`` data ranks, or None: the
    first dim that no rule shards, that dp divides and that is at least dp
    long, on a (data, model) mesh under ``rules`` (the reference's
    ``zero1_pspec``); None where the rules' ``zero`` axis is not "data" or
    the leaf's spec uses the data axis already."""
    mesh = {"data": dp, "model": 1}
    if rules.get("zero") != "data":
        return None
    spec = pspec_for(d.axes, rules, mesh)
    if any(m is not None and "data" in ((m,) if isinstance(m, str) else m) for m in spec):
        return None
    for i, (n, m) in enumerate(zip(d.shape, spec)):
        if m is None and n % dp == 0 and n >= dp:
            return i
    return None


@dataclass(frozen=True)
class Zero1Plan:
    dp: int
    dims: Dict[Path, Optional[int]]


def zero1_plan(defs, dp: int, rules: ShardingRules = DEFAULT_RULES) -> Zero1Plan:
    """``zero1_dim`` of every leaf of a ParamDef tree."""
    return Zero1Plan(dp, {path: zero1_dim(d, dp, rules) for path, d in tree_leaves_with_path(defs)})


def _split(t: torch.Tensor, dim: Optional[int], dp: int) -> List[Tuple[int, int]]:
    """(start, length) of each rank's slice along ``dim``."""
    n = t.shape[dim] // dp
    return [(r * n, n) for r in range(dp)]


def moment_zeros(plan: Optional[Zero1Plan], dtype: torch.dtype, group: Optional[Group] = None):
    """zeros(path, p): a zero moment of parameter ``p``; with ``plan``, a
    leaf it splits as a ``Zero1Shards``: every slice here, or with
    ``group`` (the data group, of ``plan.dp`` ranks) this rank's slice
    alone."""
    if group is not None and (plan is None or plan.dp != group.size):
        raise ValueError(f"a ZeRO-1 plan over {None if plan is None else plan.dp} ranks for a data group of "
                         f"{group.size}")

    def zeros(path, p):
        dim = plan.dims[path] if plan is not None else None
        if dim is None:
            return torch.zeros(p.shape, dtype=dtype, device=p.device)
        slices = _split(p, dim, plan.dp)
        if group is not None:
            slices = slices[group.index:group.index + 1]
        return Zero1Shards(dim, [torch.zeros(p.narrow(dim, s, n).shape, dtype=dtype, device=p.device)
                                 for s, n in slices], 0 if group is None else group.index, group)

    return zeros


def adamw_init(params, dtype: torch.dtype = torch.float32, plan: Optional[Zero1Plan] = None,
               group: Optional[Group] = None):
    """Zero moments of ``params`` (``moment_zeros``) and the step count."""
    zeros = moment_zeros(plan, dtype, group)
    return {"mu": tree_map_with_path(zeros, params), "nu": tree_map_with_path(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}


def _device_of(tree) -> torch.device:
    return next(iter(tree_leaves_with_path(tree)))[1].device


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    return cfg.lr * warm


def _pieces(m, v, g: torch.Tensor, p: torch.Tensor):
    """(g, m, v, p) per data rank held here: the moments' own tensors
    against the same slices of the gradient and the parameter."""
    if not isinstance(m, Zero1Shards):
        return [(g, m, v, p)]
    slices = _split(p, m.dim, m.n)
    if m.group is not None:
        slices = slices[m.index:m.index + 1]
    return [(g.narrow(m.dim, s, n), m_r, v_r, p.narrow(m.dim, s, n))
            for (s, n), m_r, v_r in zip(slices, m.parts, v.parts)]


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step. Writes ``params`` and the moments in place and
    returns (params, state) with the count advanced. Across processes a
    leaf's updated ZeRO slices are all-gathered into every data rank's
    parameter before the next leaf."""
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
            m = mus[path]
            if isinstance(m, Zero1Shards) and m.group is not None and m.n > 1:
                gather_into(p_leaf, p, m.group, m.dim)
        state["count"].copy_(count)
    return params, state


def global_norm(tree, sharded: Sequence[Path] = (), group: Optional[Group] = None,
                data_sharded: Sequence[Path] = (), data_group: Optional[Group] = None) -> torch.Tensor:
    """The square root of every leaf's sum of squares. Across processes
    (``group``, the model group) the leaves at ``sharded`` paths are this
    rank's model shards, and those at ``data_sharded`` paths its blocks of
    leaves that ``data_group`` shards besides (weight FSDP): each leaf's sum
    is summed over the groups that split it, every leaf counted once."""
    if group is None:
        return torch.sqrt(sum(torch.sum(x.float() ** 2) for _, x in tree_leaves_with_path(tree)))
    import torch.distributed as dist

    model, data = set(sharded), set(data_sharded)
    sums = {(m, d): [] for m in (False, True) for d in (False, True)}
    for path, x in tree_leaves_with_path(tree):
        sums[(path in model, path in data)].append(torch.sum(x.float() ** 2))
    dev = _device_of(tree)
    total = {k: torch.stack(v).sum() if v else torch.zeros((), device=dev) for k, v in sums.items()}
    over_data = torch.stack([total[(False, True)], total[(True, True)]])
    if data and data_group.size > 1:
        dist.all_reduce(over_data, group=data_group.handle)
    over_model = total[(True, False)] + over_data[1]
    if group.size > 1:
        dist.all_reduce(over_model, group=group.handle)
    return torch.sqrt(total[(False, False)] + over_data[0] + over_model)


def clip_by_global_norm(grads, max_norm: float, sharded: Sequence[Path] = (), group: Optional[Group] = None,
                        data_sharded: Sequence[Path] = (), data_group: Optional[Group] = None):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before). ``sharded``, ``group``,
    ``data_sharded`` and ``data_group``: as ``global_norm``'s."""
    norm = global_norm(grads, sharded, group, data_sharded, data_group)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    with torch.no_grad():
        for _, g in tree_leaves_with_path(grads):
            if g.dtype == scale.dtype:
                g.mul_(scale)
            else:
                g.copy_((g * scale).to(g.dtype))
    return grads, norm
