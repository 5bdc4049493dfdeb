"""Train step: loss -> grads -> (compression) -> clip -> AdamW (mirrors
repro/training/train_step.py).

The step runs over the bound params of a ``WeightStore`` at TP t on one
device: every projection goes through ``tp_shard_matmul`` at its rank's
offset into the parameter tensors, and each layer is recomputed in
backward (``models.model.forward``'s train mode). The reference shards the
batch over a (data, model) mesh; here dp data groups run their slices of
the batch one after another, and their gradients add up in data order in
the parameters' ``.grad``, which stands for the all-reduce. Each group's
objective is its share of the global loss (its CE sum over the global
mask's count, its MoE aux terms over dp), so the sum is the reference's
global loss. With ``accum_steps`` k, microbatch i is rows i*B/k.. of the
batch, and its gradients accumulate into f32 buffers, each divided by k,
as the reference's scan does. ZeRO-1 splits the moments over the dp ranks
(``optimizer.Zero1Plan``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.weight_store import WeightStore
from repro_torch.models.model import loss_fn, model_param_defs
from repro_torch.models.params import tree_leaves_with_path, tree_map
from repro_torch.parallel.sharding import ExecConfig
from repro_torch.training.grad_compress import CompressConfig, compress_grads, init_error_feedback
from repro_torch.training.optimizer import (
    AdamWConfig, Zero1Plan, adamw_init, adamw_update, clip_by_global_norm, zero1_plan,
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


def make_train_step(
    cfg: ModelConfig,
    ec: ExecConfig,
    params: dict,
    tcfg: TrainStepConfig = TrainStepConfig(),
    *,
    dp: int = 1,
) -> Tuple[Callable, Zero1Plan]:
    """Returns (step_fn, the ZeRO-1 plan over ``dp`` data ranks).

    ``params`` is a canonical parameter tree (``model_param_defs(cfg, ec)``'s
    keys and shapes) on one device; it is set to require grad and bound at
    TP ``ec.tp`` (a ``WeightStore`` of ``ec.tp`` ranks on that device, at
    storage TP 1, keeps the tensors themselves). step_fn(params,
    opt_state, batch) -> (params, opt_state, metrics) updates that same
    tree and the state in place; the batch is numpy (``data.py``) with B
    a multiple of dp x accum_steps (or tensors: the dry run's meta batch);
    metrics are 0-d tensors on the device.
    """
    defs = model_param_defs(cfg, ec)
    leaves = [t for _, t in tree_leaves_with_path(params)]
    device, dtype = leaves[0].device, leaves[0].dtype
    store = WeightStore(cfg, defs, [device] * ec.tp)
    for t in leaves:
        t.requires_grad_(True)
    bound = store.rebind(store.build(params), ec.tp)
    plan = zero1_plan(defs, dp)
    k = tcfg.accum_steps

    def microbatch(mb: Dict[str, torch.Tensor]):
        """Backward of one microbatch, its dp groups in data order, into
        the params' .grad; returns (loss, metrics) of the microbatch."""
        B, S = mb["targets"].shape
        if B % dp:
            raise ValueError(f"batch of {B} rows does not split over {dp} data groups")
        mask = mb.get("mask")
        count = (mask.sum() if mask is not None else torch.tensor(float(B * S), device=device)).clamp_min(1.0)
        loss = ce = lb = z = 0.0
        rows = B // dp
        for g in range(dp):
            part = {key: v[g * rows:(g + 1) * rows] for key, v in mb.items()}
            loss_g, met = loss_fn(bound, cfg, ec, part, seq_chunk=tcfg.seq_chunk, block_q=tcfg.block_q,
                                  block_k=tcfg.block_k)
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
        return loss, {"ce": ce, "lb": lb, "z": z}

    def step(p, opt_state, batch):
        if p is not params:
            raise ValueError("step_fn updates the params tree it was made over in place: pass that tree")
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
        err = opt_state.get("err")
        if tcfg.compress.enabled:
            grads, err = compress_grads(grads, err, tcfg.compress)
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.grad_clip)
        inner = {key: opt_state[key] for key in ("mu", "nu", "count")}
        adamw_update(grads, inner, params, tcfg.opt)
        for t in leaves:
            t.grad = None
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step, plan


def _grads(params):
    return tree_map(lambda t: t.grad if t.grad is not None else torch.zeros_like(t), params)


def init_opt_state(params, tcfg: TrainStepConfig, plan: Zero1Plan = None):
    state = adamw_init(params, tcfg.opt.dtype, plan)
    if tcfg.compress.enabled:
        state["err"] = init_error_feedback(params)
    return state
