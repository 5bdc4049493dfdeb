"""Tensor-parallel planning: which axes are model-sharded, and how an
architecture resolves against a TP degree.

The reference maps logical axes to mesh axes and lets XLA partition the
program. The port runs every rank of a TP group in one process, so the only
part of that table it needs is which logical axes the "model" mesh axis
shards. ``ShardView`` is how a TP-bound weight reaches the model code: each
rank reads its own contiguous slice of a shared storage tensor at an offset.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ceil_to

# Logical axes that the reference's DEFAULT_RULES place on the "model" mesh
# axis (repro/parallel/sharding.py); every other axis is replicated across a
# TP group.
MODEL_AXES = frozenset(
    {"act_heads", "act_kv", "act_mlp", "act_inner", "vocab", "heads", "kv_heads",
     "mlp", "experts", "inner"}
)


def model_dim_of(axes: Tuple[Optional[str], ...]) -> Optional[int]:
    """Index of the (single) model-sharded dim of a parameter, or None."""
    dims = [i for i, ax in enumerate(axes) if ax in MODEL_AXES]
    if len(dims) > 1:
        raise ValueError(f"more than one model-sharded axis in {axes}")
    return dims[0] if dims else None


@dataclass(frozen=True)
class ExecConfig:
    """An architecture resolved against a tensor-parallel degree.

    heads_exec: query heads padded to a multiple of tp.
    kv_exec: KV heads block-replicated to max(kv, tp); head j of kv_exec is
      original head j // kv_repeat, which keeps GQA grouping local and the
      same at every TP level.
    """

    cfg: ModelConfig
    tp: int
    heads_exec: int
    kv_exec: int

    @property
    def kv_repeat(self) -> int:
        return self.kv_exec // max(self.cfg.num_kv_heads, 1)

    @property
    def q_per_kv(self) -> int:
        return self.heads_exec // self.kv_exec


def make_exec_config(cfg: ModelConfig, tp: int) -> ExecConfig:
    if cfg.moe is not None and cfg.moe.num_experts % tp:  # the experts axis is model-sharded
        raise ValueError(f"{cfg.name}: experts={cfg.moe.num_experts} not divisible by tp={tp}")
    if cfg.family == "ssm":  # no attention: no heads to resolve
        return ExecConfig(cfg, tp, 0, 0)
    h = ceil_to(cfg.num_heads, tp)
    kv = cfg.num_kv_heads
    if tp > kv:
        if tp % kv != 0:
            raise ValueError(f"tp={tp} not a multiple of kv_heads={kv}")
        kv = tp
    if h % kv != 0:  # query-head grouping must stay uniform
        h = ceil_to(h, kv)
    return ExecConfig(cfg, tp, h, kv)


@dataclass(frozen=True)
class ShardView:
    """One model-sharded weight bound at TP t.

    Rank r multiplies by ``mats[r]`` (a 2-D view of a storage tensor) from
    ``offsets[r]`` for ``width`` columns (column-parallel) or rows
    (row-parallel). Ranks that share a storage tensor share the same
    ``mats`` entry, so binding copies nothing.
    """

    mats: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    width: int

    @property
    def tp(self) -> int:
        return len(self.mats)

    def block(self, r: int, *inner: int) -> torch.Tensor:
        """Rank r's rows of a weight sharded on its first dim, as a view of
        shape (-1, *inner): an expert leaf's (E/t, D, F) shard, or a 1-D
        leaf's (n/t,) slice."""
        return self.mats[r].narrow(0, self.offsets[r], self.width).view(-1, *inner)

    def joined(self, dim: int) -> torch.Tensor:
        """The ranks' shards joined in rank order along ``dim`` of the 2-D
        views (0: rows, 1: columns): the whole leaf as a matrix. A view
        when the shards tile one storage tensor in order, as at storage TP
        1 on one card; else a copy."""
        first, off = self.mats[0], self.offsets[0]
        if all(m is first and o == off + r * self.width for r, (m, o) in enumerate(zip(self.mats, self.offsets))):
            return first.narrow(dim, off, self.width * self.tp)
        return torch.cat([m.narrow(dim, o, self.width) for m, o in zip(self.mats, self.offsets)], dim)
