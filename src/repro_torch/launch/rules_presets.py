"""Named sharding-rule presets of the dry run (mirrors
repro/launch/rules_presets.py).

`default` delegates to parallel.sharding.rules_for. The other presets are
the reference's hillclimb levers, each one hypothesis about the
distribution strategy.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from repro_torch.parallel.sharding import ShardingRules, rules_for


def resolve_rules(name: str, arch: str, shape_name: str) -> ShardingRules:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return preset(name, rules_for(cfg, shape.kind, shape.seq_len, shape.global_batch))


def preset(name: str, base: ShardingRules) -> ShardingRules:
    """The preset ``name`` over a cell's ``rules_for`` table ``base``."""
    if name == "default":
        return base
    if name == "no-fsdp":  # replicate weights over data (baseline TP-only)
        return base.override(embed=None, expert_embed=None)
    if name == "fsdp-pod":  # shard weights over pod axis too
        return base.override(embed=("data", "pod"))
    if name == "seq-data":  # context-parallel decode over data axis
        return base.override(batch=None, kv_seq=("pod", "data"))
    if name == "zero-off":  # optimizer state replicated over data
        return base.override(zero=None)
    if name == "decode-2d":
        # weight-stationary 2D decode: residual activations replicated over
        # data so the contraction dim shards over data
        return base.override(res_batch=None, embed=("data",))
    raise KeyError(f"unknown rules preset {name!r}")
