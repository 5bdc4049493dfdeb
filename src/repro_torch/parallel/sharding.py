"""Logical-axis sharding rules and tensor-parallel planning: which axes are
model-sharded, and how an architecture resolves against a TP degree.

Tensors carry *logical* axis names; a ``ShardingRules`` table maps each
logical axis to zero or more mesh axes (the reference's MaxText-style
tables, copied). The reference lets XLA partition the program by them. The
port runs a TP group's ranks in one process, or one per process over a pool
(``parallel.collectives``, whose ``coords`` gives a rank's data and model
coordinates at each TP level); either way what its model code needs of the
table is which logical axes the "model" mesh axis shards (``MODEL_AXES``),
and, across processes, that the slot cache's batch follows "data"
(``core.migration.cache_shardings``); the whole table, ``pspec_for`` and ``local_shape`` serve
the dry run (``launch.cells``), which sizes each device's share of a cell
on a mesh that is only described: an ordered {axis name: size} dict. A
train step across processes takes a table too (``check_train_rules``:
the entries of TRAIN_RULE_AXES): the leaves it shards over "data" bind
as ``DataShard``s, gathered at use (``gathered``).
``ShardView`` is how a TP-bound weight reaches the model code: each rank
reads its own contiguous slice of a shared storage tensor at an offset.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ceil_to
from repro_torch.parallel.collectives import Level, gather_weight

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes, or None)."""

    table: Mapping[str, MeshAxes]

    def get(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]

    def override(self, **kw: MeshAxes) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(t)


DEFAULT_RULES = ShardingRules(
    {
        # activations
        "batch": ("pod", "data"),
        # residual-stream batch: usually follows "batch", but weight-
        # stationary 2D decode replicates it so the contraction dim can
        # shard over data instead
        "res_batch": ("pod", "data"),
        "seq": None,
        "seq_res": None,  # residual stream at layer boundaries; "model" = SP
        "kv_seq": None,  # set to "data" for context-parallel long decode
        "embed": None,
        "act_heads": "model",
        "act_kv": "model",
        "act_mlp": "model",
        "act_inner": "model",
        # params
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,
        "expert_embed": None,  # -> "data" enables expert-weight FSDP
        "inner": "model",
        "state": None,
        "conv": None,
        "periods": None,
        "zero": "data",  # extra axis for ZeRO-sharded optimizer state
    }
)

# Logical axes that DEFAULT_RULES place on the "model" mesh axis; every
# other axis is replicated across a TP group.
MODEL_AXES = frozenset(ax for ax, m in DEFAULT_RULES.table.items() if m == "model")


def pool_axis(logical: Optional[str]) -> Optional[str]:
    """The axis of a pool (``collectives.Level``) that splits a cache axis:
    "data" for the batch (the slot cache's ``batch -> data``), "model" for
    an axis in MODEL_AXES (attention's KV heads, a Mamba state's channels),
    else None (whole on every rank)."""
    if logical == "batch":
        return "data"
    return "model" if logical in MODEL_AXES else None


def _axes_in_mesh(mesh: Mapping[str, int], axes: MeshAxes) -> MeshAxes:
    """Drop mesh axes the mesh doesn't have (e.g. 'pod' single-pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if axes in mesh else None
    kept = tuple(a for a in axes if a in mesh)
    return kept if kept else None


def pspec_for(logical_axes: Sequence[Optional[str]], rules: ShardingRules,
              mesh: Optional[Mapping[str, int]]) -> Tuple[MeshAxes, ...]:
    """The mesh axes of each dim, as the reference's PartitionSpec entries:
    None, one axis name, or a tuple of them. ``mesh`` is an ordered {axis
    name: size} description; axes it lacks are dropped, and a mesh axis is
    used at most once (by the first dim that asks for it)."""
    if mesh is None:
        return ()
    out = []
    used: set = set()
    for ax in logical_axes:
        m = _axes_in_mesh(mesh, rules.get(ax))
        if m is not None:
            flat = (m,) if isinstance(m, str) else m
            flat = tuple(a for a in flat if a not in used)
            used.update(flat)
            m = flat[0] if len(flat) == 1 else (flat if flat else None)
        out.append(m)
    return tuple(out)


def spec_ways(spec: Sequence[MeshAxes], mesh: Mapping[str, int]) -> Tuple[int, ...]:
    """How many ways each dim of ``spec`` is split on ``mesh``."""
    return tuple(1 if m is None else math.prod(mesh[a] for a in ((m,) if isinstance(m, str) else m))
                 for m in spec)


def local_shape(shape: Sequence[int], logical_axes: Sequence[Optional[str]], rules: ShardingRules,
                mesh: Mapping[str, int]) -> Tuple[int, ...]:
    """One device's shard of a tensor laid out by ``rules`` on ``mesh``: each
    dim divided by the ways it is split, rounded up (an uneven split pads
    its last shard, as XLA's does)."""
    ways = spec_ways(pspec_for(logical_axes, rules, mesh), mesh)
    return tuple(-(-n // w) for n, w in zip(shape, ways))


def model_dim_of(axes: Tuple[Optional[str], ...]) -> Optional[int]:
    """Index of the (single) model-sharded dim of a parameter, or None."""
    dims = [i for i, ax in enumerate(axes) if ax in MODEL_AXES]
    if len(dims) > 1:
        raise ValueError(f"more than one model-sharded axis in {axes}")
    return dims[0] if dims else None


# The entries of a rules table that a train step across processes acts on:
# weight FSDP (``embed``, ``expert_embed`` -> data), sequence parallelism of
# the residual stream at period boundaries (``seq_res`` -> model) and the
# ZeRO-1 axis of the moments (``zero``), each to the one mesh axis it may
# take. The serving presets' entries (``batch``, ``res_batch``, ``kv_seq``)
# and every other entry must stay as DEFAULT_RULES have them.
TRAIN_RULE_AXES = {"embed": "data", "expert_embed": "data", "seq_res": "model", "zero": "data"}


def check_train_rules(rules: ShardingRules, mesh: Mapping[str, int]) -> None:
    """Raise unless a train step across processes implements ``rules`` on
    ``mesh``: every entry as DEFAULT_RULES have it, but those of
    TRAIN_RULE_AXES, each either unsharded or on its one axis (axes the
    mesh lacks, as "pod" on one host, dropped first)."""
    bad = []
    for ax in sorted(set(rules.table) | set(DEFAULT_RULES.table)):
        got = _axes_in_mesh(mesh, rules.table.get(ax))
        if ax in TRAIN_RULE_AXES:
            if got not in (None, TRAIN_RULE_AXES[ax], (TRAIN_RULE_AXES[ax],)):
                bad.append(f"{ax} -> {rules.table.get(ax)!r} (the step takes {ax} -> None or "
                           f"{TRAIN_RULE_AXES[ax]!r})")
        elif got != _axes_in_mesh(mesh, DEFAULT_RULES.table.get(ax)):
            bad.append(f"{ax} -> {rules.table.get(ax)!r}")
    if bad:
        raise NotImplementedError("the train step across processes implements the rule entries "
                                  f"{sorted(TRAIN_RULE_AXES)} only; not: {'; '.join(bad)}")


def data_dim_of(axes: Sequence[Optional[str]], rules: ShardingRules, mesh: Mapping[str, int]) -> Optional[int]:
    """The dim of a parameter that ``rules`` shard over "data" on ``mesh``
    (its spec from ``pspec_for``: a mesh axis is used once), or None."""
    for i, m in enumerate(pspec_for(axes, rules, mesh)):
        if m is not None and "data" in ((m,) if isinstance(m, str) else m):
            return i
    return None


def seq_parallel(rules: ShardingRules, mesh: Mapping[str, int]) -> bool:
    """Whether ``rules`` cut the residual stream at period boundaries over
    the model axis (``seq_res -> model``)."""
    return pspec_for(("seq_res",), rules, mesh) == ("model",)


def as_matrix(w: torch.Tensor, dim: int) -> Tuple[torch.Tensor, int]:
    """2-D view of one layer's weight for the shard matmul, and the number
    of matrix columns (dim > 0) or rows (dim == 0) per unit of the sharded
    dim. Always a view: binding never copies."""
    sh = w.shape
    if w.dim() == 1:  # a 1-D leaf (mamba's A_log, D, dt_bias, norm): one row per unit
        return w.view(sh[0], 1), 1
    if dim == 0:  # row-parallel (wo, w_out), the vocab-sharded embedding, or experts (ShardView.block)
        return w.view(math.prod(sh[:-1]), sh[-1]), math.prod(sh[1:-1])
    return w.view(sh[0], math.prod(sh[1:])), math.prod(sh[dim + 1:])


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

    Each rank this process holds multiplies by its ``mats`` entry (a 2-D
    view of a storage tensor) from its ``offsets`` entry for ``width``
    columns (column-parallel) or rows (row-parallel). In one process the
    entries are all t ranks', in rank order, and ranks that share a storage
    tensor share the same ``mats`` entry, so binding copies nothing. Across
    processes (``level`` given) there is one entry, this process's rank's,
    and ``level`` names its model coordinate and groups.
    """

    mats: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    width: int
    level: Optional[Level] = None

    @property
    def tp(self) -> int:
        return len(self.mats) if self.level is None else self.level.tp

    @property
    def ranks(self) -> Tuple[int, ...]:
        """The model coordinates of the entries this process holds."""
        return tuple(range(len(self.mats))) if self.level is None else (self.level.model_rank,)

    def block(self, r: int, *inner: int) -> torch.Tensor:
        """The rows of this process's r-th entry of a weight sharded on its
        first dim, as a view of shape (-1, *inner): an expert leaf's (E/t,
        D, F) shard, or a 1-D leaf's (n/t,) slice."""
        return self.mats[r].narrow(0, self.offsets[r], self.width).view(-1, *inner)

    def joined(self, dim: int) -> torch.Tensor:
        """The shards this process holds joined in rank order along ``dim``
        of the 2-D views (0: rows, 1: columns): in one process the whole
        leaf as a matrix. A view
        when the shards tile one storage tensor in order, as at storage TP
        1 on one card; else a copy."""
        first, off = self.mats[0], self.offsets[0]
        if all(m is first and o == off + r * self.width for r, (m, o) in enumerate(zip(self.mats, self.offsets))):
            return first.narrow(dim, off, self.width * len(self.mats))
        return torch.cat([m.narrow(dim, o, self.width) for m, o in zip(self.mats, self.offsets)], dim)


# ---------------------------------------------------------------------------
# Rule presets per (arch, shape-kind): how each dry-run cell is distributed
# ---------------------------------------------------------------------------
def rules_for(cfg: ModelConfig, shape_kind: str, seq_len: int = 0, batch: int = 0) -> ShardingRules:
    """Distribution strategy per cell, the reference's:

      * dense weights FSDP over data (embed -> data) when the TP-16 shard
        would not fit, and in every train cell;
      * expert-weight FSDP (expert_embed -> data) when per-chip expert
        shards are too large, and in every train cell;
      * long_500k decode: batch=1 -> batch unsharded, KV sequence sharded
        over (pod, data) = context-parallel split-KV decode.

    The thresholds (8 GB of a TP-16 shard) size shards for the reference's
    16 GB TPU chip. They are kept as the reference's, so that both packages
    give every cell the same table; they are not an H100 setting.
    """
    rules = DEFAULT_RULES
    dtype_bytes = 2
    tp_shard_gb = cfg.param_count() * dtype_bytes / 16 / 1e9
    if shape_kind == "train" or tp_shard_gb > 8.0:
        rules = rules.override(embed=("data",))
        if shape_kind == "decode" and batch > 1:
            # weight-stationary 2D decode: replicate the (tiny) residual
            # activations over data so the embed contraction shards over data
            rules = rules.override(res_batch=None)
    if shape_kind == "train" and seq_len % 16 == 0:
        # sequence parallelism on the residual stream at layer boundaries
        rules = rules.override(seq_res="model")
    if cfg.moe is not None:
        e = cfg.moe
        n_moe_layers = sum(1 for t in cfg.layer_pattern if t.ffn == "moe") * cfg.num_periods
        expert_params = n_moe_layers * (e.num_experts + e.num_shared_experts) * 3 * cfg.d_model * e.d_ff_expert
        if expert_params * dtype_bytes / 16 > 8e9 or shape_kind == "train":
            rules = rules.override(expert_embed="data")
    if shape_kind == "decode" and batch == 1:
        rules = rules.override(batch=None, kv_seq=("pod", "data"))
    return rules


@dataclass(frozen=True)
class DataShard:
    """A weight the rules shard over the data group besides (FSDP), bound
    across processes: this rank's block of its model shard, all-gathered at
    use. ``gather()`` gives what the model code reads otherwise: the model
    shard as a ``ShardView`` at ``level`` (``model_dim`` its model-sharded
    dim, at storage TP = TP, so at offset 0), or the tensor itself for a
    leaf the model group replicates. Under autograd the block's gradient
    is the reduce-scatter of the whole's over the data group."""

    block: torch.Tensor
    dim: int  # the data-sharded dim of ``block``
    model_dim: Optional[int]
    level: Level
    leaf: str  # the leaf's name, for ``collectives.count_traffic(by_leaf=True)``

    def gather(self) -> Union[torch.Tensor, ShardView]:
        whole = gather_weight(self.block, self.level.data, self.dim, self.leaf)
        if self.model_dim is None:
            return whole
        mat, unit = as_matrix(whole.contiguous(), self.model_dim)
        return ShardView((mat,), (0,), whole.shape[self.model_dim] * unit, self.level)


def gathered(params):
    """``params`` (one layer's bound weights, or the top of a bound tree)
    with every ``DataShard`` in it gathered (``DataShard.gather``): a new
    dict where one was gathered, else the tree itself."""
    if isinstance(params, DataShard):
        return params.gather()
    if not isinstance(params, dict):
        return params
    out = {k: gathered(v) for k, v in params.items()}
    return params if all(out[k] is v for k, v in params.items()) else out
