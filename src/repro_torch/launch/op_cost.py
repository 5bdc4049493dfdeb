"""Per-device counts of a torch program: operations, an HBM-traffic proxy
and collective bytes, with the roofline terms they give.

The port's counterpart of both ``repro/launch/hlo_analysis.py`` (collective
bytes from the per-device HLO, the ``Roofline``) and
``repro/launch/hlo_loop_cost.py`` (loop-aware dot FLOPs and the HBM proxy).
The port has no XLA program to parse: ``count`` runs a callable under a
``TorchDispatchMode`` and counts every aten op it dispatches. On the
``meta`` device (the dry run) that allocates nothing and launches nothing,
and the kernel wrappers take their plain versions, whose ops are counted.
A plain PyTorch program counts the same on CPU or CUDA tensors; on CUDA a
kernel wrapper's launch is not an aten op and is not counted.

* Operations: ``torch.utils.flop_counter``'s formulas, which count matrix
  products (2*M*N*K, batch-aware) and attention calls, as the reference
  counts ``dot``.
* Bytes: each op's output bytes, plus the operands each matrix product
  reads, the proxy ``hlo_loop_cost.py`` describes. An in-place op writes
  only what it updates (an indexed write its values, a copy its
  destination); views and allocations move nothing; a dtype conversion is
  taken as fused into its consumer, as XLA fuses converts and as the
  kernels read their inputs' dtype directly.
* Collectives, by kind, at the points where the one-card program stands in
  for one (``parallel.collectives.stand_in``: a row-parallel projection's
  and the vocab-parallel embedding's all-reduce, an MoE layer's all-to-alls
  or its all-reduce), plus an all-gather of each read of a weight that the
  rules shard over data (``gathered``: each op that reads such a tensor
  gathers what it reads; prefill and decode cells, while a train cell
  stands in the gathers its step runs, ``launch.cells.build_step``).
  Bytes are each collective's result on one device.
  A train step's backward runs no stand-in: the all-reduce of the
  column-parallel projections' input gradients is not counted.
* No loop-trip machinery: an eager program runs every layer and microbatch,
  so a loop of L layers is counted L times by construction.
* Per device: a TP group of t ranks runs as one program on one device, so
  ``count(fn, devices=t)`` divides the group's totals by t. The ranks' work
  is equal by construction. Where an op runs once for the whole group (a
  norm, the residual adds, RoPE, the attention of all heads at once and the
  reads of weights that the model axis does not shard), the real group runs
  it on every rank, so dividing by t undercounts those ops.
"""
from __future__ import annotations

import math
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.parallel import collectives
from repro_torch.profiles.perf_model import H100, HardwareSpec

_aten = torch.ops.aten
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
               _aten._to_copy.default, _aten.lift_fresh.default}
_INDEXED_WRITES = {_aten.index_put_.default, _aten.index_put.default, _aten._index_put_impl_.default}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


@dataclass
class OpCost:
    """A program's counts; ``per_device`` divides them by a group's devices."""

    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_count_by_kind: Dict[str, float] = field(default_factory=dict)
    ops: int = 0

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective_bytes_by_kind.values())

    def add_collective(self, kind: str, each_bytes: float, n: float) -> None:
        self.collective_bytes_by_kind[kind] = self.collective_bytes_by_kind.get(kind, 0.0) + each_bytes * n
        self.collective_count_by_kind[kind] = self.collective_count_by_kind.get(kind, 0.0) + n

    def per_device(self, devices: int) -> "OpCost":
        return OpCost(self.dot_flops / devices, self.hbm_bytes / devices,
                      {k: v / devices for k, v in self.collective_bytes_by_kind.items()},
                      {k: v / devices for k, v in self.collective_count_by_kind.items()}, self.ops)


def _tensors(x, out):
    """Append every tensor of an op's (nested list/tuple/dict) arguments or result to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost, gathered: Iterable[torch.Tensor], gather_needs_grad: bool):
        super().__init__()
        self.cost = cost
        self.gathered = {_storage_key(t) for t in gathered}
        self.gather_needs_grad = gather_needs_grad
        # storage of a conversion's output -> (that output, weakly; the input's element size)
        self.converted: Dict[int, Tuple[weakref.ref, int]] = {}
        self.kinds: Dict[object, tuple] = {}  # op -> (is a view, mutates, flop formula)

    def _read_bytes(self, t: torch.Tensor) -> int:
        """Bytes a matrix product reads of an operand: a converted operand at
        its source's element size (the conversion is fused into the read)."""
        entry = self.converted.get(_storage_key(t))
        if entry is not None and entry[0]() is not None:
            return t.numel() * entry[1]
        return _bytes(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = self.kinds.get(func)
        if kind is None:
            kind = self.kinds[func] = (func.is_view, func._schema.is_mutable, flop_registry.get(func._overloadpacket))
        is_view, mutates, flops = kind
        if is_view:
            return out
        if func is _aten._to_copy.default and args[0].dtype != out.dtype:
            self.converted[_storage_key(out)] = (weakref.ref(out), args[0].element_size())
        cost = self.cost
        if self.gathered and (not self.gather_needs_grad or torch.is_grad_enabled()):
            ins = _tensors(kwargs, _tensors(args, []))
            mutated = args[0] if mutates else None
            for a in {id(a): a for a in ins}.values():
                if a is not mutated and _storage_key(a) in self.gathered:
                    cost.add_collective("all-gather", _bytes(a), 1)
        if func in _NO_TRAFFIC:
            return out
        cost.ops += 1
        if flops is not None:
            cost.dot_flops += flops(*args, **kwargs, out_val=out)
            cost.hbm_bytes += sum(self._read_bytes(a) for a in _tensors(kwargs, _tensors(args, [])))
        if mutates:  # in place: only what it updates
            written = args[2] if func in _INDEXED_WRITES else args[0]
            cost.hbm_bytes += written.numel() * args[0].element_size()
        else:
            cost.hbm_bytes += sum(_bytes(o) for o in _tensors(out, []))
        return out


@contextmanager
def _listening(cost: OpCost):
    collectives.LISTENERS.append(cost.add_collective)
    try:
        yield
    finally:
        collectives.LISTENERS.remove(cost.add_collective)


def count(fn: Callable, *args, devices: int = 1, gathered: Iterable[torch.Tensor] = (),
          gather_needs_grad: bool = False, **kwargs) -> Tuple[object, OpCost]:
    """Run ``fn(*args, **kwargs)`` once, counting what it does; returns
    (its result, the counts per device of a program that stands for
    ``devices`` devices). ``gathered``: tensors (weights the rules shard over
    data) whose every read is an all-gather of what is read; with
    ``gather_needs_grad``, only reads while grad mode is on count (a train
    step's forward and recompute, not its optimizer, which updates each
    device's own shard)."""
    cost = OpCost()
    with _listening(cost), _Counter(cost, gathered, gather_needs_grad):
        out = fn(*args, **kwargs)
    return out, cost.per_device(devices)


@dataclass
class Roofline:
    """The least time of one device's share, by each of its three limits.

    ``collective_s`` divides the collective bytes by the link rate times the
    links: with the default ``H100`` spec those are NVLink's published
    figures, not measured ones (one card has no link), and every print of
    ``collective_s`` says so."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    hw: HardwareSpec = H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        # conservative single-direction normalization: bytes / (link_bw x links)
        return self.collective_bytes_per_device / (self.hw.ici_bw * self.hw.ici_links)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hw": self.hw.name,
            "collective_rate": "published link figures, not measured",
        }


def roofline(cost: OpCost, hw: Optional[HardwareSpec] = None) -> Roofline:
    return Roofline(cost.dot_flops, cost.hbm_bytes, cost.collective_bytes, hw or H100)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested structure of lists, tuples and dicts."""
    return sum(_bytes(t) for t in _tensors(tree, []))


def model_flops_share(flops: float, device_s: float, peak_flops: float = H100.peak_flops) -> float:
    """Counted operations over the time the device took, as a share of its peak."""
    if not device_s > 0 or math.isinf(device_s):
        raise ValueError(f"device time must be positive and finite, got {device_s}")
    return flops / device_s / peak_flops
