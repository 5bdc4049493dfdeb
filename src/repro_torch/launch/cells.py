"""Dry-run cells: (architecture x input shape x mesh) -> one TP group's step
on ``meta`` tensors (mirrors repro/launch/cells.py).

The reference lowers each cell's step for XLA with ShapeDtypeStruct
stand-ins. The port runs one device's share instead: a TP group of
t = mesh["model"] ranks runs as one program on one device, as the engine
runs it, on the batch of one data replica, B / (pod x data), and
``launch.op_cost`` counts that program and divides by t. Every tensor is
on ``meta``: shapes and dtypes without data, so nothing is allocated or
launched. Frontends are stubs as in the reference: musicgen takes
precomputed frame embeddings (B, S, d_model), chameleon VQ token ids inside
the shared vocabulary.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.weight_store import WeightStore
from repro_torch.launch.op_cost import tensor_bytes
from repro_torch.models.model import forward, init_cache_defs, logits_for, model_param_defs
from repro_torch.models.params import ParamDef, tree_leaves_with_path, tree_map
from repro_torch.parallel.collectives import stand_in
from repro_torch.parallel.sharding import (
    ExecConfig, ShardingRules, local_shape, make_exec_config, pspec_for, rules_for, seq_parallel, spec_ways,
)
from repro_torch.serving.kv_cache import SlotCache
from repro_torch.training.optimizer import AdamWConfig, zero1_dim
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

META = torch.device("meta")
PARAM_DTYPE = torch.bfloat16


def _dp(mesh: Dict[str, int]) -> int:
    return math.prod(mesh.get(a, 1) for a in ("pod", "data"))


def accum_steps_for(cfg: ModelConfig, shape: ShapeSpec, mesh: Dict[str, int]) -> int:
    """Microbatch count: bound per-chip remat-saved residuals to ~2.5 GB
    (the reference's formula and its REPRO_ACCUM override)."""
    dp = _dp(mesh)
    tp = mesh["model"]
    b_loc = max(shape.global_batch // dp, 1)
    s_loc = shape.seq_len // tp if shape.seq_len % tp == 0 else shape.seq_len
    resid = cfg.num_periods * b_loc * s_loc * cfg.d_model * 2  # bf16
    # per-layer backward working set also scales with the microbatch:
    # selective-scan f32 chunk states for mamba-1 dominate (jamba)
    layer_ws = 0
    if cfg.mamba is not None and cfg.mamba.version == 1:
        layer_ws = b_loc * shape.seq_len * (cfg.d_inner // tp) * 4 * 64
    k = 1
    while (max(resid, layer_ws) / k > 2.5e9 and k < 8
           and shape.global_batch // (dp * 2 * k) >= 1):
        k *= 2
    return int(os.environ.get("REPRO_ACCUM", k))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _local(d: ParamDef, rules: ShardingRules, mesh: Dict[str, int], dtype) -> torch.Tensor:
    return _meta(local_shape(d.shape, d.axes, rules, mesh), dtype)


def _zero1_spec(d: ParamDef, rules: ShardingRules, mesh: Dict[str, int]) -> tuple:
    """The reference's zero1_pspec: the param's spec with the zero axis on
    the first free dim that its size divides."""
    base = list(pspec_for(d.axes, rules, mesh))
    zero = rules.get("zero")
    if zero is None or zero not in mesh:
        return tuple(base)
    used = {a for b in base if b is not None for a in ((b,) if isinstance(b, str) else b)}
    if zero in used:
        return tuple(base)
    for i, (n, cur) in enumerate(zip(d.shape, base)):
        if cur is None and n % mesh[zero] == 0 and n >= mesh[zero]:
            base[i] = zero
            break
    return tuple(base)


def input_specs(arch: str, shape_name: str, mesh: Dict[str, int], rules: Optional[ShardingRules] = None):
    """Meta stand-ins for every input of the cell's step, each at one
    device's local shape under ``rules`` on ``mesh``: params in bf16; train:
    f32 moments split over ``zero`` as ZeRO-1 splits them, tokens and
    targets; prefill: tokens; decode: the cache, positions and tokens;
    musicgen takes frame embeddings in place of tokens."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ec = make_exec_config(cfg, mesh["model"])
    rules = rules or rules_for(cfg, shape.kind, shape.seq_len, shape.global_batch)
    B, S = shape.global_batch, shape.seq_len
    defs = model_param_defs(cfg, ec)
    params = tree_map(lambda d: _local(d, rules, mesh, PARAM_DTYPE), defs)

    def tokens(seq):
        return _meta(local_shape((B, seq), ("batch", "seq"), rules, mesh), torch.int32)

    def embeds(seq):
        return _meta(local_shape((B, seq, cfg.d_model), ("batch", "seq", "embed"), rules, mesh), PARAM_DTYPE)

    if shape.kind == "train":
        def moment(d):
            ways = spec_ways(_zero1_spec(d, rules, mesh), mesh)
            return _meta(tuple(-(-n // w) for n, w in zip(d.shape, ways)), torch.float32)

        opt = {"mu": tree_map(moment, defs), "nu": tree_map(moment, defs), "count": _meta((), torch.int32)}
        batch = {"tokens": tokens(S), "targets": tokens(S)}
        if cfg.frontend == "encodec":
            batch["embeds"] = embeds(S)
        return dict(params=params, opt_state=opt, batch=batch)
    if shape.kind == "prefill":
        return dict(params=params, **({"embeds": embeds(S)} if cfg.frontend == "encodec" else {"tokens": tokens(S)}))
    cache = [{k: _local(d, rules, mesh, PARAM_DTYPE) for k, d in layer.items()}
             for layer in init_cache_defs(cfg, ec, B, S)]
    out = dict(params=params, cache=cache,
               positions=_meta(local_shape((B,), ("batch",), rules, mesh), torch.int32))
    out.update({"embeds": embeds(1)} if cfg.frontend == "encodec" else {"tokens": tokens(1)})
    return out


@dataclass
class GroupStep:
    """One TP group's step on meta tensors: ``run()`` is the program that
    ``op_cost.count`` counts (``devices`` = t); ``gathered`` are the group's
    weights that the rules shard over data, each read of which counts as
    an all-gather (none in a train step, which stands in its own);
    ``output_bytes(out)`` is one device's share of what the step returns."""

    kind: str
    devices: int
    run: Callable[[], object]
    gathered: List[torch.Tensor]
    output_bytes: Callable[[object], int]
    notes: List[str] = field(default_factory=list)

    def __call__(self):
        return self.run()


def _group_params(defs) -> dict:
    return tree_map(lambda d: _meta(d.shape, PARAM_DTYPE), defs)


def _data_sharded(defs, params, rules, mesh) -> List[torch.Tensor]:
    """The group's weights whose spec uses a data axis (pod or data)."""
    out = []
    for (path, d), (_, t) in zip(tree_leaves_with_path(defs), tree_leaves_with_path(params)):
        spec = pspec_for(d.axes, rules, mesh)
        if any(m is not None and {"pod", "data"} & set((m,) if isinstance(m, str) else m) for m in spec):
            out.append(t)
    return out


def rules_traffic(cfg: ModelConfig, ec: ExecConfig, rules: ShardingRules, mesh: Mapping[str, int], rows: int,
                  seq: int, accum: int = 1, dtype_bytes: int = 4) -> Dict[str, Tuple[int, int]]:
    """The collectives that a train step across processes runs for its
    rules on ``mesh`` ({"data": dp, "model": t}; the dry run's may hold
    "pod", which shards with "data"), per device and step, as
    ``collectives.count_traffic`` names them: {kind: (calls, bytes)}.
    ``rows``: each data rank's rows of a microbatch of ``seq`` positions;
    ``accum`` microbatches; parameters of ``dtype_bytes``.

    * "all-gather (weights)": each leaf the rules shard over data, gathered
      whole (its model shard) at each use: a layer's in its forward and in
      its recompute, the embedding, final norm and head once a microbatch;
    * "reduce-scatter (gradients)": each such leaf's gradient (a layer's
      block, each layer on its own) once a microbatch;
    * "all-reduce (gradients)": every other leaf's, once a step over the
      data replicas (f32 accumulators when ``accum`` > 1);
    * "all-gather (parameters)": ZeRO-1's updated slices of each leaf it
      splits, once a step;
    * "all-gather (sequence)" and "all-gather (sequence, backward)":
      sequence parallelism's joins at each period's start, in forward
      (and once more after the last period) and in recompute, and the
      backward of its cuts at each period's end (and before the first).
    """
    defs = model_param_defs(cfg, ec)
    data_axes = ("pod", "data")
    replicas = math.prod(mesh.get(a, 1) for a in data_axes)
    k = accum
    out: Dict[str, Tuple[int, int]] = {}

    def add(kind: str, calls: int, each: int) -> None:
        c, b = out.get(kind, (0, 0))
        out[kind] = (c + calls, b + calls * each)

    unread = cfg.frontend == "encodec" and not cfg.tie_embeddings  # frame embeddings in: the table is not read
    for path, d in tree_leaves_with_path(defs):
        spec = pspec_for(d.axes, rules, mesh)
        block = math.prod(local_shape(d.shape, d.axes, rules, mesh)) * dtype_bytes
        ways = math.prod(mesh[a] for m in spec if m is not None for a in ((m,) if isinstance(m, str) else m)
                         if a in data_axes)
        if ways > 1:
            if path == ("embed",) and unread:
                continue
            layers = d.shape[0] if path[0] == "periods" else 1
            add("all-gather (weights)", k * layers * (2 if path[0] == "periods" else 1), block // layers * ways)
            add("reduce-scatter (gradients)", k * layers, block // layers)
            continue
        if replicas > 1:
            add("all-reduce (gradients)", 1, block // dtype_bytes * (4 if k > 1 else dtype_bytes))
        if mesh.get("data", 1) > 1 and zero1_dim(d, mesh["data"], rules) is not None:
            add("all-gather (parameters)", 1, block)
    if seq_parallel(rules, mesh) and mesh["model"] > 1:
        h = rows * seq * cfg.d_model * dtype_bytes
        add("all-gather (sequence)", k * (2 * cfg.num_periods + 1), h)
        add("all-gather (sequence, backward)", k * (cfg.num_periods + 1), h)
    return out


def build_step(arch: str, shape_name: str, mesh: Dict[str, int], rules: Optional[ShardingRules] = None
               ) -> Tuple[GroupStep, dict, ShardingRules]:
    """Returns (the TP group's step, input_specs, rules). The step runs the
    port's own train step (``make_train_step``), or its prefill or decode
    through ``models.model.forward`` and ``logits_for`` (not the engine's
    CUDA graphs), at t = mesh["model"] on the batch of one data replica.
    A train step stands in for the collectives that the step across
    processes runs for the rules (``rules_traffic``: weight
    FSDP's gathers and reduce-scatters, the data-parallel gradient sum,
    ZeRO-1's gathers and sequence parallelism's joins and cuts), each as
    often as that step runs it; the other cells count an all-gather of
    each read of a weight the rules shard over data (``gathered``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        raise ValueError(f"{arch} x {shape_name}: inapplicable (long_500k needs sub-quadratic attention)")
    t = mesh["model"]
    ec = make_exec_config(cfg, t)
    rules = rules or rules_for(cfg, shape.kind, shape.seq_len, shape.global_batch)
    specs = input_specs(arch, shape_name, mesh, rules)
    defs = model_param_defs(cfg, ec)
    params = _group_params(defs)
    gathered = _data_sharded(defs, params, rules, mesh)
    group_mesh = {a: n for a, n in mesh.items() if a != "model"}  # the group holds every model shard
    B, S = shape.global_batch, shape.seq_len
    b_loc = local_shape((B,), ("batch",), rules, group_mesh)[0]

    def inputs(seq):
        if cfg.frontend == "encodec":
            return {"embeds": _meta((b_loc, seq, cfg.d_model), PARAM_DTYPE)}
        return {"tokens": _meta((b_loc, seq), torch.int64)}

    if shape.kind == "train":
        k = accum_steps_for(cfg, shape, mesh)
        tcfg = TrainStepConfig(opt=AdamWConfig(), accum_steps=k)
        step_fn, _ = make_train_step(cfg, ec, params, tcfg)
        opt = init_opt_state(params, tcfg)
        batch = {**inputs(S), "targets": _meta((b_loc, S), torch.int64)}

        def train():
            out = step_fn(params, opt, batch)
            for kind, (calls, nbytes) in rules_traffic(cfg, ec, rules, mesh, b_loc // k, S, k,
                                                       PARAM_DTYPE.itemsize).items():
                each, rest = divmod(nbytes, calls)
                for i in range(calls):  # each of the t devices takes part in one (the production meshes' t > 1)
                    stand_in(kind, each + (rest if i == 0 else 0), t)
            return out

        notes = [f"{k} microbatch(es) of {b_loc // k} rows; each layer recomputed in backward",
                 "weights the rules shard over data: gathered at each layer's forward and recompute, their "
                 "gradients reduce-scattered a microbatch; every other gradient all-reduced over the data "
                 "replicas once a step",
                 "the optimizer updates the group's whole moments, where ZeRO-1 gives each data rank 1/"
                 f"{mesh.get('data', 1)} of them: its bytes are overcounted by that factor"]
        return (GroupStep("train", t, train, [],
                          lambda out: tensor_bytes(specs["params"]) + tensor_bytes(specs["opt_state"]), notes),
                specs, rules)

    if shape.kind == "prefill":
        x = inputs(S)
        store = WeightStore(cfg, defs, [META] * t)
        bound = store.rebind(store.build(params), t)

        def prefill():
            with torch.no_grad():
                h, cache = forward(bound, cfg, ec, mode="prefill", **x)
                return logits_for(bound, cfg, h[:, -1:]), cache

        return (GroupStep("prefill", t, prefill, gathered, lambda out: tensor_bytes(out) // t), specs, rules)

    # decode: one new token against the cache of one data replica's share of the sequence
    s_loc = local_shape((S,), ("kv_seq",), rules, group_mesh)[0]
    slots = SlotCache.create(cfg, ec, b_loc, s_loc, PARAM_DTYPE, META)
    positions = _meta((b_loc,), torch.int64)
    x = inputs(1)
    store = WeightStore(cfg, defs, [META] * t)
    bound = store.rebind(store.build(params), t)

    def decode():
        with torch.no_grad():
            tables, lens = slots.page_tables(positions)
            h, _ = forward(bound, cfg, ec, positions=positions, cache=slots.layers, block_tables=tables,
                           seq_lens=lens, mode="decode", **x)
            return logits_for(bound, cfg, h)

    notes = []
    if s_loc < S:
        notes.append(f"the cache's sequence is split {S // s_loc} ways over the data replicas (context-parallel "
                     "decode); the cross-device merge of the split attention is not counted")
    return (GroupStep("decode", t, decode, gathered,
                      lambda out: tensor_bytes(out) // t + tensor_bytes(specs["cache"]), notes),
            specs, rules)


def all_cells():
    """The assigned 10 archs x 4 shapes grid (minus documented skips)."""
    cells = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            cells.append((arch, shape_name, shape_applicable(cfg, shape)))
    return cells
