"""Train step: loss -> grads -> (compression) -> clip -> AdamW (mirrors
repro/training/train_step.py).

The step runs over the bound params of a ``WeightStore`` at TP t: every
projection goes through ``tp_shard_matmul`` at its rank's offset into the
parameter tensors, and each layer is recomputed in backward
(``models.model.forward``'s train mode). The reference shards the batch
over a (data, model) mesh.

In one process (the default) the t ranks read the one device's tensors,
and dp data groups run their slices of the batch one after another, their
gradients adding up in data order in the parameters' ``.grad``, which
stands for the all-reduce. Each group's objective is its share of the
global loss (its CE sum over the global mask's count, its MoE aux terms
over dp), so the sum is the reference's global loss. With ``accum_steps``
k, microbatch i is rows i*B/k.. of the batch, and its gradients accumulate
into f32 buffers, each divided by k, as the reference's scan does. ZeRO-1
splits the moments over the dp ranks (``optimizer.Zero1Plan``).

Across processes (``pool``: one process per card, the reference's mesh at
TP t, data = N/t) each process holds its rank's parameters as the
reference's ``param_shardings`` place them (``train_params``: a
model-sharded leaf's model shard, a replicated leaf whole, at storage TP
t), runs its data coordinate's share of each microbatch, accumulates
locally, and sums the gradients over its data group once a step, a
collective a leaf; the collectives inside the model carry the gradient
across the model group (``parallel.collectives``). ZeRO-1 keeps each data
rank's slice of the moments alone and all-gathers the updated slices;
clipping sums the model shards' squares over the model group. The loss
metric is summed over the data group: every rank reports the global loss.

``rules`` (across processes; the reference's ``ShardingRules``, e.g.
``rules_for(cfg, "train", S, B)``) place each leaf as the reference's
``param_shardings`` does on the mesh (data N/t, model t): a leaf with an
axis the rules send to "data" (``embed``, ``expert_embed``: weight FSDP)
lies on each rank as its (model, data) block (``sharding.local_shape``),
is gathered over the data group at use inside each recomputed layer
(``sharding.DataShard``), and its gradient arrives reduce-scattered: it
leaves the once-a-step all-reduce, and ZeRO-1 does not split its moments
again (the reference's ``zero1_pspec``). ``seq_res -> model`` cuts the
residual stream saved at each period boundary to this rank's S/t
positions (``models.model.forward``'s ``seq_parallel``); ``zero -> None``
keeps the moments whole on every data rank. Any other entry that differs
from ``DEFAULT_RULES`` raises (``sharding.check_train_rules``). In one
process the rules place nothing, as the reference's with no mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.weight_store import WeightStore
from repro_torch.models.model import loss_fn, model_param_defs
from repro_torch.models.params import tree_leaves_with_path, tree_map, tree_map_with_path
from repro_torch.parallel.collectives import Level, Pool, all_gather, all_reduce, all_reduce_leaves
from repro_torch.parallel.sharding import DEFAULT_RULES, ExecConfig, ShardingRules, local_shape, seq_parallel
from repro_torch.training.grad_compress import CompressConfig, compress_grads, init_error_feedback
from repro_torch.training.optimizer import (
    AdamWConfig, Zero1Plan, adamw_init, adamw_update, clip_by_global_norm, moment_zeros, zero1_plan,
)


@dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    compress: CompressConfig = field(default_factory=CompressConfig)
    seq_chunk: int = 512
    block_q: int = 512
    block_k: int = 512
    # gradient accumulation: split the global batch into k microbatches,
    # which bounds the saved activations by 1/k at the cost of one f32
    # gradient accumulator
    accum_steps: int = 1


def batch_to(batch: Dict[str, np.ndarray], device: torch.device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A numpy batch (or one of tensors) on ``device``: token ids as int64,
    a mask in f32, frame embeddings in the params' dtype."""
    kinds = {"tokens": torch.int64, "targets": torch.int64, "mask": torch.float32, "embeds": dtype}
    return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))).to(device=device, dtype=kinds[k])
            for k, v in batch.items()}


@dataclass(frozen=True)
class PoolLayout:
    """How a train state lies over a pool at one TP level: each parameter
    path's model-sharded dim (None: replicated), the data-sharded dim of
    each leaf the rules shard over data, the level's groups. A moment leaf
    of a ZeRO-split parameter is a ``Zero1Shards`` over the data group
    besides; a data-sharded leaf's moments are its block, as it is."""

    pool: Pool
    level: Level
    model_dims: Dict[Tuple[str, ...], Optional[int]]
    data_dims: Dict[Tuple[str, ...], int] = field(default_factory=dict)

    @staticmethod
    def _of(dims: dict, path: Tuple) -> Optional[int]:
        """The dim that ``dims`` give the parameter path ``path`` ends in (a
        moment's or an error's key leads), None for any other leaf (the
        step count)."""
        for i in range(len(path)):
            if tuple(path[i:]) in dims:
                return dims[tuple(path[i:])]
        return None

    def model_dim(self, path: Tuple) -> Optional[int]:
        """The model-sharded dim of a leaf of a state tree, by its path
        (None at TP 1)."""
        return None if self.level.tp == 1 else self._of(self.model_dims, path)

    def data_dim(self, path: Tuple) -> Optional[int]:
        """The data-sharded dim of a leaf of a state tree, by its path (None
        where the data group is one rank)."""
        return None if self.level.dp == 1 else self._of(self.data_dims, path)


def train_store(cfg: ModelConfig, ec: ExecConfig, pool: Pool, defs: Optional[dict] = None,
                rules: ShardingRules = DEFAULT_RULES) -> WeightStore:
    """The store a train step across ``pool`` binds: storage TP ``ec.tp``,
    so a card holds its model shard of every model-sharded leaf (the
    reference's ``param_shardings``) and every replicated leaf whole; under
    ``rules`` that shard over data, its data block of those."""
    return WeightStore(cfg, defs or model_param_defs(cfg, ec), pool.devices, storage_tp=ec.tp, pool=pool,
                       rules=rules)


def train_params(cfg: ModelConfig, ec: ExecConfig, pool: Pool, params: Optional[dict] = None,
                 draw: Optional[Tuple[dict, torch.Generator, torch.dtype]] = None,
                 rules: ShardingRules = DEFAULT_RULES) -> dict:
    """This rank's parameters for ``make_train_step(..., pool=, rules=)``,
    tensors of their own: the canonical tree ``params`` (left as it is)
    laid out at storage TP ``ec.tp``, each leaf this rank's (model, data)
    block under ``rules``, or drawn leaf by leaf, ``draw`` = (defs,
    generator, dtype) as ``init_params`` draws them, each leaf cut to this
    rank's block as it comes (the whole tree is never held: llama3-8b's f32
    leaves take 32 GB)."""
    from repro_torch.models.params import init_params

    store = train_store(cfg, ec, pool, rules=rules)
    if params is not None:
        return tree_map_with_path(lambda path, t: store.lay(path, t.detach().clone(), pool.rank), params)
    defs, gen, dtype = draw
    return init_params(defs, gen, dtype, place=lambda path, t: store.lay(path, t, pool.rank))


def gather_params(params: dict, layout: PoolLayout) -> dict:
    """The canonical tree of a pool's parameters, in tensors of its own
    (later steps leave it as it is): every data-sharded leaf gathered over
    the data group, every model-sharded leaf over the model group
    (collectives: every rank calls it), a replicated leaf copied."""
    def whole(path, t):
        t = t.detach()
        if layout.data_dim(path) is None and layout.model_dim(path) is None:
            return t.clone()
        for dim, group in ((layout.data_dim(path), layout.level.data), (layout.model_dim(path), layout.level.model)):
            if dim is not None:
                t = all_gather(t, group, dim)
        return t

    return tree_map_with_path(whole, params)  # every rank's tree, made by train_params, has one order


def make_train_step(
    cfg: ModelConfig,
    ec: ExecConfig,
    params: dict,
    tcfg: TrainStepConfig = TrainStepConfig(),
    *,
    dp: int = 1,
    pool: Optional[Pool] = None,
    rules: ShardingRules = DEFAULT_RULES,
) -> Tuple[Callable, Zero1Plan]:
    """Returns (step_fn, the ZeRO-1 plan over the dp data ranks).

    In one process ``params`` is a canonical parameter tree
    (``model_param_defs(cfg, ec)``'s keys and shapes) on one device; it is
    set to require grad and bound at TP ``ec.tp`` (a ``WeightStore`` of
    ``ec.tp`` ranks on that device, at storage TP 1, keeps the tensors
    themselves). Across ``pool`` it is this rank's tree
    (``train_params``, under the same ``rules``), dp is the level's data
    size, and ``step_fn.layout``
    is the state's ``PoolLayout`` (``train_loop``'s checkpoints read it),
    and ``step_fn.gradients(batch)`` the step's (loss, metrics, grads)
    without the update.
    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    updates that same tree and the state in place; the batch is numpy
    (``data.py``), the global batch, every rank the same, with B a multiple
    of dp x accum_steps (or tensors: the dry run's meta batch); metrics
    are 0-d tensors on the device.
    """
    defs = model_param_defs(cfg, ec)
    leaves = [t for _, t in tree_leaves_with_path(params)]
    device, dtype = leaves[0].device, leaves[0].dtype
    level, layout, seq_level = None, None, None
    if pool is None:
        store = WeightStore(cfg, defs, [device] * ec.tp)
        storage = store.build(params)
        rules = DEFAULT_RULES  # one process: the rules place nothing
    else:
        level = pool.level(ec.tp)
        if dp not in (1, level.dp):
            raise ValueError(f"dp {dp} on a pool of {pool.world} at TP {ec.tp}: the data size is {level.dp}")
        dp = level.dp
        mesh = {"data": dp, "model": ec.tp}
        store = train_store(cfg, ec, pool, defs, rules)
        for (path, t), (_, d) in zip(tree_leaves_with_path(params), tree_leaves_with_path(defs)):
            want = local_shape(d.shape, d.axes, rules, mesh)
            if tuple(t.shape) != want:
                raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)}, not this rank's block {want} "
                                 f"(train_params lays them out under the same rules)")
        storage = store.storage_of(params)
        layout = PoolLayout(pool, level, {path: plan.dim for path, plan in store.plans.items()}, store.data_dims)
        seq_level = level if seq_parallel(rules, mesh) else None
    for t in leaves:
        t.requires_grad_(True)
    bound = store.rebind(storage, ec.tp)
    plan = zero1_plan(defs, dp, rules)
    k = tcfg.accum_steps
    mine = range(dp) if level is None else (level.data_rank,)

    def microbatch(mb: Dict[str, torch.Tensor]):
        """Backward of one microbatch, its data groups held here in data
        order, into the params' .grad; returns (loss, metrics) of the
        microbatch (across processes summed over the data group)."""
        B, S = mb["targets"].shape
        if B % dp:
            raise ValueError(f"batch of {B} rows does not split over {dp} data groups")
        mask = mb.get("mask")
        count = (mask.sum() if mask is not None else torch.tensor(float(B * S), device=device)).clamp_min(1.0)
        loss = ce = lb = z = 0.0
        rows = B // dp
        for g in mine:
            part = {key: v[g * rows:(g + 1) * rows] for key, v in mb.items()}
            loss_g, met = loss_fn(bound, cfg, ec, part, seq_chunk=tcfg.seq_chunk, block_q=tcfg.block_q,
                                  block_k=tcfg.block_k, seq_parallel=seq_level)
            if dp == 1:
                obj, share = loss_g, 1.0
            else:  # this group's share of the global loss
                m_g = part["mask"].sum() if mask is not None else torch.tensor(float(rows * S), device=device)
                share = m_g.clamp_min(1.0) / count
                obj = share * met["ce"] + (loss_g - met["ce"]) / dp
            obj.backward()
            loss = loss + obj.detach()
            ce = ce + share * met["ce"].detach()
            lb = lb + met["lb"].detach() / dp
            z = z + met["z"].detach() / dp
        if level is not None and dp > 1:  # every rank reports the global loss
            summed = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=device) for x in (loss, ce, lb, z)])
            loss, ce, lb, z = all_reduce(summed, level.data).unbind()
        return loss, {"ce": ce, "lb": lb, "z": z}

    def gradients(batch):
        """(loss, metrics, grads) of the global batch at the params as they
        are: the reference's ``value_and_grad`` of its loss (across
        processes this rank's shards, summed over the data group), before
        compression and clipping."""
        full = batch_to(batch, device, dtype)
        for t in leaves:
            t.grad = None
        if k <= 1:
            loss, metrics = microbatch(full)
            grads = _grads(params)
        else:
            B = full["targets"].shape[0]
            if B % k:
                raise ValueError(f"batch of {B} rows does not split into {k} microbatches")
            acc = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, device=device), params)
            losses, mets = [], []
            for i in range(k):
                mb = {key: v[i * (B // k):(i + 1) * (B // k)] for key, v in full.items()}
                l_i, m_i = microbatch(mb)
                losses.append(l_i)
                mets.append(m_i)
                with torch.no_grad():
                    for (_, a), t in zip(tree_leaves_with_path(acc), leaves):
                        a.add_(t.grad.float() / k)
                        t.grad = None
            grads = acc
            loss = torch.stack(losses).mean()
            metrics = {key: torch.stack([torch.as_tensor(m[key], device=device) for m in mets]).mean()
                       for key in mets[0]}
        if level is not None:  # the data-parallel gradient sum, once a step (data-sharded leaves' came reduce-scattered)
            with torch.no_grad():
                summed = [(path, g) for path, g in tree_leaves_with_path(grads) if layout.data_dim(path) is None]
                all_reduce_leaves([g for _, g in summed], level.data, ["/".join(path) for path, _ in summed])
        return loss, metrics, grads

    def step(p, opt_state, batch):
        if p is not params:
            raise ValueError("step_fn updates the params tree it was made over in place: pass that tree")
        loss, metrics, grads = gradients(batch)
        split = {}
        if level is not None:
            split = dict(sharded=[path for path, d in layout.model_dims.items() if d is not None and level.tp > 1],
                         group=level.model, data_sharded=[path for path in layout.data_dims if level.dp > 1],
                         data_group=level.data)
        err = opt_state.get("err")
        if tcfg.compress.enabled:
            grads, err = compress_grads(grads, err, tcfg.compress, None if layout is None else layout.model_dims, level,
                                        None if layout is None else layout.data_dims)
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.grad_clip, **split)
        inner = {key: opt_state[key] for key in ("mu", "nu", "count")}
        adamw_update(grads, inner, params, tcfg.opt)
        for t in leaves:
            t.grad = None
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    step.layout = layout
    step.gradients = gradients
    return step, plan


def _grads(params):
    return tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)


def init_opt_state(params, tcfg: TrainStepConfig, plan: Zero1Plan = None, step_fn: Optional[Callable] = None):
    """AdamW's state of ``params`` (ZeRO-1 split by ``plan``) and, with
    compression, the error feedback. Across processes pass the step
    function: each data rank then holds its own slices of the moments and
    of the error (which the reference shards like the first moment)."""
    layout = getattr(step_fn, "layout", None)
    group = None if layout is None else layout.level.data
    if group is not None and plan is None:
        raise ValueError("across processes the state takes the step's ZeRO-1 plan")
    state = adamw_init(params, tcfg.opt.dtype, plan, group)
    if tcfg.compress.enabled:
        state["err"] = init_error_feedback(params) if group is None else tree_map_with_path(
            moment_zeros(plan, torch.float32, group), params)
    return state
