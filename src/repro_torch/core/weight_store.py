"""Storage-TP weight store: zero-copy TP switching (paper §3.2.1).

Mirrors repro/core/weight_store.py. A pool of N ranks stores each weight
sharded at ``storage_tp`` = s along its model-sharded dim: pool position j
holds canonical shard floor(j*s/N). At execution TP t, rank r runs on
position r*(N/t) and reads its execution shard as a contiguous slice of
that position's storage shard, at

    off = (r*n)//t - (r*s//t)*(n//s)        (n = canonical length)

so switching TP moves no weight byte: ``rebind`` only makes new views.

In one process every rank is the same device, and positions that hold the
same canonical shard on the same device share one tensor, so the weights
take their canonical size, not N copies. With s = 1, ``build`` keeps the
caller's tensors themselves.

Across processes (``pool``: one process per pool position, each on its own
card) ``build`` lays out only this process's position, the counterpart of
the reference's ``storage_shardings``: the other positions' entries are
None. ``rebind`` then binds, on every card, the one rank this process runs
at TP t: model coordinate d // (N/t) of position d, reading its own storage
at that coordinate's offset (the formula above with r = d // (N/t); its
canonical shard floor(d*s/N) is the one the offset assumes). No weight byte
moves on any card. ``shrink`` over a pool makes the survivors' pool and a
store over it, into which each survivor builds its position again.

A train step's store (``rules``: the reference's rules, e.g. ``rules_for(cfg,
"train")``) lays out each position's (model, data) block: of its storage
shard, the slice of the dim the rules shard over data (weight FSDP),
position d's data coordinate d % (N/s) of N/s, the reference's
``param_shardings`` on the mesh (data N/s, model s).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import tree_leaves_with_path
from repro_torch.parallel.collectives import Pool
from repro_torch.parallel.sharding import (
    DataShard, ShardingRules, ShardView, as_matrix, check_train_rules, data_dim_of, model_dim_of,
)

Path = Tuple[str, ...]


@dataclass(frozen=True)
class _LeafPlan:
    dim: Optional[int]  # model-sharded dim of the canonical leaf
    n_units: int  # canonical length of that dim


def _get(tree: dict, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path: Path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class WeightStore:
    def __init__(self, cfg: ModelConfig, canonical_defs: dict, devices: Sequence[torch.device],
                 storage_tp: int = 1, pool: Optional[Pool] = None, rules: Optional[ShardingRules] = None):
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices]
        self.N = len(self.devices)
        self.s = storage_tp
        self.pool = pool
        if not self.N or self.N % storage_tp:
            raise ValueError(f"storage_tp {storage_tp} must divide the pool size {self.N}")
        if pool is not None and pool.world != self.N:
            raise ValueError(f"a store of {self.N} positions over a pool of {pool.world} processes")
        self.canonical_defs = canonical_defs
        self.plans: Dict[Path, _LeafPlan] = {}
        for path, d in tree_leaves_with_path(canonical_defs):
            k = model_dim_of(d.axes)
            self.plans[path] = _LeafPlan(k, d.shape[k] if k is not None else 0)
        # weight FSDP: each leaf's data-sharded dim under ``rules`` on the train mesh (data N/s, model s)
        self.dp = self.N // storage_tp
        self.data_dims: Dict[Path, int] = {}
        if rules is not None and pool is not None:
            mesh = {"data": self.dp, "model": storage_tp}
            check_train_rules(rules, mesh)
            for path, d in tree_leaves_with_path(canonical_defs):
                k = data_dim_of(d.axes, rules, mesh)
                if k is not None:
                    if d.shape[k] % self.dp:
                        raise ValueError(f"{'/'.join(path)}: {d.shape[k]} does not split over {self.dp} data ranks")
                    self.data_dims[path] = k

    # ---- storage layout -------------------------------------------------
    def build(self, canonical_params: dict) -> dict:
        """Lay canonical params out in storage: each leaf becomes a tuple of
        N tensors, one per pool position, shared where the canonical shard
        and the device coincide. Across processes only this process's
        position is laid out; the others are None."""
        out: dict = {}
        mine = range(self.N) if self.pool is None else (self.pool.rank,)
        for path, plan in self.plans.items():
            x = _get(canonical_params, path)
            shared: Dict[Tuple[int, torch.device], torch.Tensor] = {}
            per_pos = []
            for j, dev in enumerate(self.devices):
                if j not in mine:
                    per_pos.append(None)
                    continue
                shard = 0 if plan.dim is None else j * self.s // self.N
                if (shard, dev) not in shared:
                    shared[(shard, dev)] = self.lay(path, x, j)
                per_pos.append(shared[(shard, dev)])
            _put(out, path, tuple(per_pos))
        return out

    def lay(self, path: Path, x: torch.Tensor, j: int) -> torch.Tensor:
        """Pool position ``j``'s storage of the canonical leaf ``x`` at
        ``path``: its storage shard, a tensor of its own on its device (a
        view would keep the whole leaf alive), or ``x`` itself where it is
        whole and already so."""
        plan = self.plans[path]
        if plan.dim is not None and self.s > 1:
            w = plan.n_units // self.s
            x = x.narrow(plan.dim, (j * self.s // self.N) * w, w).clone(memory_format=torch.contiguous_format)
        if path in self.data_dims:  # and of that, its data coordinate's block (``coords``: j % (N/s))
            k = self.data_dims[path]
            w = x.shape[k] // self.dp
            x = x.narrow(k, (j % self.dp) * w, w).clone(memory_format=torch.contiguous_format)
        return x.to(self.devices[j]).contiguous()

    def storage_of(self, mine: dict) -> dict:
        """The storage ``build`` makes across processes, from this
        position's tensors (a tree of ``lay``'s results: a train step's
        parameters, each the leaf that requires grad)."""
        out: dict = {}
        for path in self.plans:
            _put(out, path, tuple(_get(mine, path) if j == self.pool.rank else None for j in range(self.N)))
        return out

    # ---- pool shrink after a device or host loss ------------------------
    def shrink(self, surviving_positions: Sequence[int]) -> Optional["WeightStore"]:
        """New store over the surviving pool positions (in pool order).

        The caller reloads canonical params into it with ``build`` (the
        reload storm: each survivor lays its position out again).
        ``storage_tp`` is clamped to the largest value that still divides
        the surviving pool size. Across processes every process of the pool
        calls this together: the survivors get a store over the shrunken
        pool (``Pool.shrink``), a process that leaves gets None.
        """
        keep = sorted(set(surviving_positions))
        if not keep:
            raise ValueError("shrink: no surviving positions")
        devs = [self.devices[j] for j in keep]
        s = min(self.s, len(devs))
        while len(devs) % s:
            s -= 1
        pool = None
        if self.pool is not None:
            pool = self.pool.shrink(keep)
            if pool is None:
                return None
        return WeightStore(self.cfg, self.canonical_defs, devs, storage_tp=s, pool=pool)

    # ---- execution-time shard selection ---------------------------------
    def select(self, tp: int) -> Dict[Path, List[Tuple[int, int, int]]]:
        """Per model-sharded leaf, (pool position, offset, width) for each
        rank at TP ``tp``, in units of the sharded dim."""
        if not (tp >= self.s and tp % self.s == 0 and self.N % tp == 0):
            raise ValueError(f"tp={tp} needs storage_tp {self.s} | tp | pool size {self.N}")
        s = self.s
        out = {}
        for path, plan in self.plans.items():
            if plan.dim is None:
                continue
            n = plan.n_units
            if (n >= tp and n % tp) or (n < tp and tp % n):
                raise ValueError(f"{'/'.join(path)}: {n} units do not split over tp={tp}")
            width = max(n // tp, 1)
            out[path] = [
                (r * (self.N // tp), (r * n) // tp - (r * s // tp) * (n // s), width)
                for r in range(tp)
            ]
        return out

    def rebind(self, storage: dict, tp: int) -> dict:
        """Bind storage to TP ``tp`` without moving data.

        Returns the bound params ``models.forward`` runs on: ``embed``,
        ``layers`` (one dict per layer), ``final_norm`` and, unless the
        embeddings are tied, ``lm_head`` (a tied head reads ``embed``'s
        ShardView in place); every model-sharded weight is a ``ShardView``
        of the storage tensors, so every ``data_ptr()`` is the storage's own.
        Across processes each ShardView holds this process's rank at TP ``tp``
        and that level of the pool. A leaf the store's rules shard over data
        binds as a ``DataShard`` of this rank's block, which the model code
        gathers at use (``sharding.gathered``); such a store binds at its
        storage TP alone.
        """
        if self.data_dims and tp != self.s:
            raise ValueError(f"a store of weights sharded over data binds at its storage TP {self.s}, not {tp}")
        sel = self.select(tp)
        level = None if self.pool is None else self.pool.level(tp)
        n_pos = len(self.cfg.layer_pattern)
        bound: dict = {"layers": [dict() for _ in range(self.cfg.num_layers)]}
        for path, plan in self.plans.items():
            per_pos = _get(storage, path)
            stacked = path[0] == "periods"
            if path in self.data_dims:  # gathered over the data group at use
                mine = per_pos[self.pool.rank]
                k, dim = self.data_dims[path] - stacked, None if plan.dim is None else plan.dim - stacked
                name = "/".join(path)
                if stacked:
                    pos = int(path[1][len("pos"):])
                    for i in range(self.cfg.num_periods):
                        _put(bound["layers"][i * n_pos + pos], path[2:],
                             DataShard(mine[i], k, dim, level, f"{name}@{i}"))
                else:
                    _put(bound, path, DataShard(mine, k, dim, level, name))
                continue
            if stacked:  # one entry per period
                pos = int(path[1][len("pos"):])
                dim = None if plan.dim is None else plan.dim - 1
                items = []
                for i in range(self.cfg.num_periods):
                    layer = {id(t): t[i] for t in per_pos if t is not None}  # shared tensors keep one view
                    items.append((bound["layers"][i * n_pos + pos], path[2:],
                                  tuple(None if t is None else layer[id(t)] for t in per_pos), dim))
            else:
                items = [(bound, path, per_pos, plan.dim)]
            for tree, sub, tensors, dim in items:
                if dim is None:
                    _put(tree, sub, next(t for t in tensors if t is not None))
                    continue
                mats: Dict[int, Tuple[torch.Tensor, int]] = {}
                views, offsets = [], []
                ranks = sel[path] if level is None else [(self.pool.rank, *sel[path][level.model_rank][1:])]
                for position, off, width in ranks:
                    key = id(tensors[position])
                    if key not in mats:
                        mats[key] = as_matrix(tensors[position], dim)
                    mat, unit = mats[key]
                    views.append(mat)
                    offsets.append(off * unit)
                _put(tree, sub, ShardView(tuple(views), tuple(offsets), width * unit, level))
        return bound

    # ---- memory accounting ----------------------------------------------
    def bytes_per_device(self, dtype_bytes: int = 2) -> int:
        total = 0
        for path, d in tree_leaves_with_path(self.canonical_defs):
            n = math.prod(d.shape) * dtype_bytes
            total += n if self.plans[path].dim is None else n // self.s
        return total
