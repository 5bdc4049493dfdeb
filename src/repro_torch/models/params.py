"""Parameter definitions: a nested dict of ``ParamDef`` leaves.

Shapes, logical axes and initialisation all derive from one tree, as in the
reference (repro/models/params.py). Trees are plain nested dicts; leaves are
visited in sorted-key order, the order ``jax.tree_util`` flattens dicts in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # stddev; None => 1/sqrt(shape[0])

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_leaves_with_path(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(f: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    return f(tree)


def tree_map_with_path(f: Callable, tree, prefix: Tuple[str, ...] = ()):
    """``f(path, leaf)`` over a nested dict's leaves (in ``tree_map``'s
    order), in the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(f, v, prefix + (k,)) for k, v in tree.items()}
    return f(prefix, tree)


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in tree_leaves_with_path(defs))


def stack_defs(defs, n: int, axis_name: str = "periods"):
    """Prefix every leaf with a leading stacking dim (one entry per period)."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes, d.init, d.scale), defs)


def _fan_in_scale(d: ParamDef) -> float:
    if d.scale is not None:
        return d.scale
    fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _materialize(d: ParamDef, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    out = torch.empty(d.shape, dtype=dtype, device=gen.device)
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1.0)
    scale = _fan_in_scale(d)
    # draw in f32 a slab of the leading dim at a time, so a bf16 weight never
    # needs a full-size f32 temporary
    rows = max(1, (1 << 26) // max(math.prod(d.shape[1:]), 1))
    for i in range(0, d.shape[0], rows):
        n = min(rows, d.shape[0] - i)
        slab = torch.randn((n,) + d.shape[1:], generator=gen, dtype=torch.float32, device=gen.device)
        out[i:i + n] = slab.mul_(scale)
    return out


def init_params(defs, gen: torch.Generator, dtype: torch.dtype = torch.float32,
                place: Optional[Callable[[Tuple[str, ...], torch.Tensor], torch.Tensor]] = None):
    """Random weights on ``gen.device``: N(0, 1/fan_in) with fan_in =
    shape[0] (the reference's rule, including for stacked leaves).
    ``place(path, leaf)``, if given, takes each leaf as it is drawn and
    returns what the tree keeps (e.g. one card's shard of it), so that the
    whole tree is never held at once; the draws are the same."""
    def draw(path, d):
        leaf = _materialize(d, gen, dtype)
        return leaf if place is None else place(path, leaf)

    return tree_map_with_path(draw, defs)  # tree_map's order: the draws' order


def per_layer_fan_in(defs: dict) -> dict:
    """``defs`` (a model's, with its stacked ``periods``) with each stacked
    leaf's unset scale set to the init rule applied to its layer's own
    shape (shape[1:]): 1/sqrt of the layer's fan-in. The reference's rule
    takes a stacked leaf's shape[0], the number of periods, which draws
    every projection of a model of one or two periods at std 1 or 0.71:
    jamba's f32 activations then overflow at full width."""
    def own(d: ParamDef) -> ParamDef:
        layer = d.shape[1:]
        fan_in = layer[0] if len(layer) > 1 else layer[-1]
        return d if d.scale is not None else ParamDef(d.shape, d.axes, d.init, fan_in ** -0.5)

    return {k: tree_map(own, v) if k == "periods" else v for k, v in defs.items()}
