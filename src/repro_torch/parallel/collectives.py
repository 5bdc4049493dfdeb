"""The pool of ranks and the collectives that join them.

Two ways to run a TP group. In one process (the default, and what the dry
run counts) every rank of the group lives in the process: a row-parallel
projection's psum is a sum of the ranks' partial products in rank order, an
MoE layer's all-to-all a gather. Across processes (``init_pool``) each
process is one rank of a pool of N on its own device, joined by
``torch.distributed``: NCCL on CUDA, gloo only when the CPU is asked for.
The pool's layout is the reference's ``make_exec_mesh``: at TP t, rank d has
model coordinate d // (N/t) and data coordinate d % (N/t); its model group
is the t ranks of its data coordinate, its data group the N/t ranks of its
model coordinate, each in coordinate order. After a loss the survivors form
a smaller pool of their own (``Pool.shrink``: new groups over the
surviving processes).

Both ways go through the functions below (``reduce_ranks``,
``gather_ranks``, ``all_to_all``, ...). Given ``level=None`` they leave the
one-process sums to the caller; given a ``Level`` they run the collective
over its group. Under autograd (training across processes) the
collectives are ``torch.autograd.Function``s: the psum passes its
gradient through, the gather hands each rank its slice, and
``enter_model_group`` (Megatron's *f*) all-reduces the gradient of a
replicated activation before column-parallel products; ``reduce_shared``
is a psum whose backward sums too (a sum each rank uses in its own way),
``all_to_all`` sends each chunk's gradient back the way it came,
``gather_summed`` (over a data group) gives each member's rows the sum of
every member's gradient, and ``pool_mean`` is the MoE aux losses' pmean
over the pool, each rank's value counted once. A train step's rules add
``gather_weight`` (weight FSDP: a weight's data blocks all-gathered at
use, its gradient reduce-scattered) and sequence parallelism's pair,
``split_sequence`` and ``join_sequence`` (a slice of the residual stream
and an all-gather along the sequence, each the other's transpose in
backward). Where no gradient is taken
(the engine's steps and graphs) they launch what the plain calls did: the
psum in place, the gather's one all-gather, *f* nothing. Each point where the reference runs a collective also calls
``stand_in`` with that collective. Nothing listens unless a counter is
installed (``launch.op_cost`` does so while it counts a program), so a call
costs one test of an empty list.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

# listeners (kind, bytes of each collective's result on one device, number
# of collectives: one per device taking part)
LISTENERS: List[Callable[[str, int, int], None]] = []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def stand_in(kind: str, each_bytes: int, n: int) -> None:
    """Here the reference runs ``n`` collectives of ``kind`` ("all-reduce",
    "all-to-all", ...), one per device taking part, each giving that device
    a result of ``each_bytes``. A group of one device runs none."""
    if n <= 1:
        return
    for f in LISTENERS:
        f(kind, each_bytes, n)


# bytes of each real collective's result on this device, by kind, while a
# dict is installed here (``count_traffic``); None: nothing is counted
TRAFFIC: Optional[Dict[str, Tuple[int, int]]] = None
BY_LEAF = False  # count_traffic(by_leaf=True): a note that names its leaf is counted under "<kind> <leaf>"


def note(kind: str, each_bytes: int, leaf: Optional[str] = None) -> None:
    """A collective of ``kind`` ran across processes, giving this device a
    result of ``each_bytes`` (``leaf``: the weight it carried, if any)."""
    if TRAFFIC is not None:
        if BY_LEAF and leaf is not None:
            kind = f"{kind} {leaf}"
        calls, total = TRAFFIC.get(kind, (0, 0))
        TRAFFIC[kind] = (calls + 1, total + each_bytes)


@contextmanager
def count_traffic(by_leaf: bool = False) -> Iterator[Dict[str, Tuple[int, int]]]:
    """``with count_traffic() as t:`` t is {kind: (calls, bytes)} of the
    collectives this process ran across the pool inside the block; with
    ``by_leaf`` the gathers of a weight and the reduce-scatters of its
    gradient are counted leaf by leaf, as {"<kind> <leaf>": ...}."""
    global TRAFFIC, BY_LEAF
    outer, TRAFFIC = TRAFFIC, {}
    outer_by, BY_LEAF = BY_LEAF, by_leaf
    try:
        yield TRAFFIC
    finally:
        TRAFFIC, BY_LEAF = outer, outer_by


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Group:
    """A process group of the pool: its ranks in coordinate order and this
    process's place among them."""

    ranks: Tuple[int, ...]
    index: int
    handle: object = field(compare=False, repr=False)
    backend: str = "gloo"

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class Level:
    """One TP level of the pool as this process sees it."""

    tp: int
    dp: int
    model_rank: int  # model coordinate: this rank's shard of a model-sharded axis
    data_rank: int  # data coordinate: this rank's share of the batch
    model: Group  # the tp ranks of this data coordinate
    data: Group  # the dp ranks of this model coordinate


def coords(rank: int, world: int, tp: int) -> Tuple[int, int]:
    """(data, model) coordinates of ``rank`` at TP ``tp`` in a pool of
    ``world`` ranks, model-major as the reference's ``make_exec_mesh``."""
    if world % tp:
        raise ValueError(f"TP {tp} does not divide the pool of {world} ranks")
    dp = world // tp
    return rank % dp, rank // dp


def model_ranks(world: int, tp: int, data: int) -> Tuple[int, ...]:
    dp = world // tp
    return tuple(m * dp + data for m in range(tp))


def data_ranks(world: int, tp: int, model: int) -> Tuple[int, ...]:
    dp = world // tp
    return tuple(model * dp + i for i in range(dp))


class Pool:
    """This process's rank in a pool of ``world`` processes, one device each,
    with the model and data groups of every candidate TP level (made once,
    by every process in one order, as ``new_group`` requires).

    ``members``: the processes (global ranks) at the pool's positions, in
    order; default every process of the job, position j being rank j. A
    ``Group``'s ranks are pool positions. Process r runs on card r."""

    def __init__(self, world: int, rank: int, device: torch.device, backend: str, tps: Sequence[int],
                 members: Optional[Sequence[int]] = None):
        self.world, self.rank, self.device, self.backend = world, rank, torch.device(device), backend
        self.members = tuple(range(world)) if members is None else tuple(members)
        self.tps = tuple(t for t in tps if world % t == 0)
        handles = _make_groups(self.members, self.tps, backend)
        self.levels: Dict[int, Level] = {}
        for t in sorted(set(self.tps) | {1, world}):
            data, model = coords(rank, world, t)
            mr, dr = model_ranks(world, t, data), data_ranks(world, t, model)
            self.levels[t] = Level(t, world // t, model, data, Group(mr, mr.index(rank), handles[mr], backend),
                                   Group(dr, dr.index(rank), handles[dr], backend))
        self.world_group = self.levels[world].model  # at TP N the model group is the pool
        # pool position j's device: its process's card, or the CPU for every position under gloo
        self.devices = [torch.device("cuda", r) if self.device.type == "cuda" else self.device for r in self.members]
        self._warm()

    def shrink(self, survivors: Sequence[int]) -> Optional["Pool"]:
        """The pool of the ``survivors`` (positions of this pool) after the
        others are lost, with the model and data groups of every TP level
        they can run (the candidate levels that divide their number, and 1
        and that number), warmed as at start-up. Every process of this pool
        calls it together, as ``new_group`` requires (the lost positions'
        processes are left out of every group; a process that really died
        cannot be simulated under NCCL without hanging the others). Returns
        None on a process that leaves: it gets no pool, and waits at the
        end (e.g. in this pool's ``barrier``) for the survivors to finish.
        Only a pool of every process of the job shrinks."""
        import torch.distributed as dist

        keep = sorted(set(survivors))
        if not keep or not all(0 <= j < self.world for j in keep):
            raise ValueError(f"survivors {list(survivors)} of a pool of {self.world}")
        if self.world != dist.get_world_size():
            raise ValueError("only a pool of every process of the job shrinks")
        members = tuple(self.members[j] for j in keep)
        tps = tuple(t for t in self.tps if len(keep) % t == 0)
        if self.rank not in keep:
            _make_groups(members, tps, self.backend)  # the leaver's part of every new_group call
            return None
        return Pool(len(keep), keep.index(self.rank), self.device, self.backend, tps, members)

    def level(self, tp: int) -> Level:
        return self.levels[tp]

    def _warm(self) -> None:
        """One eager collective on each group, so that every NCCL
        communicator exists before a CUDA graph captures a collective on it
        (a communicator cannot be made inside a capture). Every process walks
        the groups in one order, so no two wait on each other."""
        import torch.distributed as dist

        x = torch.ones(1, device=self.device)
        for t in sorted(self.levels):
            lv = self.levels[t]
            for g in (lv.model, lv.data):
                dist.all_reduce(x, group=g.handle)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.world_group.handle,
                     **({"device_ids": [self.device.index]} if self.device.type == "cuda" else {}))


def _make_groups(members: Tuple[int, ...], tps: Sequence[int], backend: str) -> Dict[Tuple[int, ...], object]:
    """The process group of every model and data group (as tuples of pool
    positions) of every TP level a pool of ``members`` runs. Every process
    of the job calls this with the same arguments, making the groups in one
    order; a process outside a group gets a handle it does not use."""
    import torch.distributed as dist

    world = len(members)
    handles: Dict[Tuple[int, ...], object] = {}
    if world == dist.get_world_size():  # the whole job: its default group
        handles[tuple(range(world))] = dist.group.WORLD
    for t in sorted(set(tps) | {1, world}):
        for ranks in [model_ranks(world, t, i) for i in range(world // t)] + [data_ranks(world, t, m) for m in range(t)]:
            if ranks not in handles:
                handles[ranks] = dist.new_group([members[j] for j in ranks], backend=backend)
    return handles


def init_pool(world: int, rank: int, device: Union[str, torch.device] = "cuda",
              tps: Sequence[int] = (1, 2, 4, 8), init_method: Optional[str] = None) -> Pool:
    """Join the pool as ``rank`` of ``world``: NCCL on ``cuda:rank`` (the
    process's current device is set first), gloo when ``device`` is the CPU.
    ``init_method`` is the rendezvous (a ``file://`` path shared by the
    processes, or ``tcp://localhost:<port>``); default: the environment's."""
    import torch.distributed as dist

    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the pool on the CPU under gloo")
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"a pool runs on CUDA or the CPU, not {device}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank, **kw)
    return Pool(world, rank, dev, backend, tps)


def close_pool() -> None:
    """Leave the pool. Objects no longer referenced are collected first: a
    CUDA graph that captured an NCCL collective (an engine's, kept in a
    reference cycle until a collection) must be gone before its
    communicator is destroyed, or the teardown waits on it."""
    import gc

    import torch.distributed as dist

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------
class _AllReduce(torch.autograd.Function):
    """All-reduce forward (into a new tensor), identity backward: the
    reference's psum of a row-parallel product, whose every input rank
    gets the same gradient of the sum (every model rank computes the same
    loss)."""

    @staticmethod
    def forward(ctx, y, handle):
        import torch.distributed as dist

        y = y.clone()
        dist.all_reduce(y, group=handle)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModelGroup(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over the model group in
    backward (Megatron's *f*): a replicated activation feeding column-
    parallel products gets each rank's part of its gradient, summed."""

    @staticmethod
    def forward(ctx, x, handle):
        ctx.handle = handle
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.handle)
        note("all-reduce (backward)", nbytes(g))
        return g, None


def reduce_ranks(parts: Sequence[torch.Tensor], level: Optional[Level], n: int) -> torch.Tensor:
    """The sum of a row-parallel product's partials over a TP group of ``n``
    ranks (the reference's psum): the parts this process holds, summed in
    rank order, then over the level's model group when there is one (under
    autograd into a new tensor, the gradient passed through unchanged)."""
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    stand_in("all-reduce", nbytes(y), n)
    if level is not None:
        note("all-reduce", nbytes(y))
        if torch.is_grad_enabled() and y.requires_grad:  # into a new tensor, which autograd sees
            return _AllReduce.apply(y, level.model.handle)
        import torch.distributed as dist

        dist.all_reduce(y, group=level.model.handle)
    return y


def enter_model_group(x: torch.Tensor, level: Optional[Level]) -> torch.Tensor:
    """``x``, a replicated activation about to enter this rank's column-
    parallel products: under autograd across processes its gradient is
    all-reduced over the level's model group in backward (each rank's
    products give only its part of dX). Its forward launches nothing; in
    one process it is ``x`` itself."""
    if level is None or level.tp == 1:
        return x
    return _EnterModelGroup.apply(x, level.model.handle)


def reduce_shared(parts: Sequence[torch.Tensor], level: Optional[Level], n: int) -> torch.Tensor:
    """The psum of partials that each rank then uses in its own way (a
    Mamba-1 layer's B and C, read by each rank's channels; the gated norm's
    sum of squares): ``reduce_ranks``, then ``enter_model_group``, so that
    in backward the ranks' gradients of the sum are summed too.
    ``reduce_ranks`` alone passes each rank only its own part, which is
    right only where everything after the sum is replicated."""
    return enter_model_group(reduce_ranks(parts, level, n), level)


class _PoolMean(torch.autograd.Function):
    """Forward: the mean over the pool of a value each rank computes (the
    reference's pmean over model and data), summed over the model group,
    then over the data group. Backward: each rank's value counts once in
    the objective, which is the data groups' objectives summed (each model
    group computes its own once): its gradient is the data group's
    gradients of the mean, summed, over N."""

    @staticmethod
    def forward(ctx, v, level):
        import torch.distributed as dist

        ctx.level = level
        v = v.clone()
        dist.all_reduce(v, group=level.model.handle)
        dist.all_reduce(v, group=level.data.handle)
        return v / (level.tp * level.dp)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        lv = ctx.level
        g = g.contiguous().clone()
        dist.all_reduce(g, group=lv.data.handle)
        note("all-reduce (backward)", nbytes(g))
        return g / (lv.tp * lv.dp), None


def pool_mean(v: torch.Tensor, level: Level) -> torch.Tensor:
    """``v`` averaged over the level's pool, the same on every rank; under
    autograd as ``_PoolMean`` says (an MoE layer's aux losses)."""
    note("all-reduce", 2 * nbytes(v))
    return _PoolMean.apply(v, level)


def _gather_into(t: torch.Tensor, group: Group) -> torch.Tensor:
    """(size * t.shape[0], ...): the group's tensors stacked along dim 0 in
    group order."""
    import torch.distributed as dist

    t = t.contiguous()
    if group.backend == "nccl":
        out = torch.empty((group.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group.handle)
        return out
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.handle)
    return torch.cat(parts, 0)


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's tensors joined along ``dim`` in group order; every member
    gets the same bits."""
    dim = dim % t.dim()
    if dim == 0:
        return _gather_into(t, group)
    moved = t.movedim(dim, 0)
    out = _gather_into(moved, group)  # (size * n, ...)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward takes this rank's slice of
    the gradient (every model rank computes the same loss on the gathered
    tensor, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.conf = (group.index, y.shape[dim], dim)
        return all_gather(y, group, dim)

    @staticmethod
    def backward(ctx, g):
        index, n, dim = ctx.conf
        return g.narrow(dim, index * n, n), None, None


def gather_ranks(parts: Sequence[torch.Tensor], level: Optional[Level], dim: int = -1) -> torch.Tensor:
    """Column-parallel outputs joined in rank order along ``dim``: the parts
    this process holds, then the model group's when there is one (under
    autograd, each rank's slice of the gradient goes back to its part)."""
    y = torch.cat(list(parts), dim) if len(parts) > 1 else parts[0]
    if level is None:
        return y
    note("all-gather", nbytes(y) * level.tp)
    return _Gather.apply(y, level.model, dim % y.dim())


def gather_first(t: torch.Tensor, group: Group, dim: int) -> Optional[torch.Tensor]:
    """The group's tensors (of one shape) joined along ``dim`` in group
    order on its first member, None on the others: a gather, so that only
    the first holds the whole."""
    if group.size == 1:
        return t
    import torch.distributed as dist

    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)] if group.index == 0 else None
    dist.gather(t, parts, dst=dist.get_global_rank(group.handle, 0), group=group.handle)
    return None if parts is None else torch.cat(parts, dim)


def _swap_chunks(t: torch.Tensor, group: Group) -> torch.Tensor:
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group.handle)
    return out


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all under autograd. Chunk k of this member's input
    is chunk (this member) of member k's output: the exchange is its own
    transpose, so its backward is the same all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _swap_chunks(t, group)

    @staticmethod
    def backward(ctx, g):
        g = _swap_chunks(g, ctx.group)
        note("all-to-all (backward)", nbytes(g))
        return g, None


def all_to_all(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Dim 0 cut in ``group.size`` equal chunks, chunk k sent to member k;
    returns the chunks received, in member order along dim 0 (under
    autograd, each chunk's gradient goes back the way it came)."""
    note("all-to-all", nbytes(t))
    return _AllToAll.apply(t, group)


class _GatherSum(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward sums the members'
    gradients of the whole and hands each its own slice (a reduce-scatter,
    noted as ``kind``): every member computes something of its own from the
    whole tensor (the MoE at TP 1 routes the whole batch on each data rank,
    and each one's objective holds the whole batch's aux losses; under
    weight FSDP each data rank's objective reads the whole weight)."""

    @staticmethod
    def forward(ctx, t, group, dim, kind, leaf):
        ctx.conf = (group, dim, kind, leaf)
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, kind, leaf = ctx.conf
        out = reduce_scatter(g, group, dim)
        note(kind, nbytes(out), leaf)
        return out, None, None, None, None


def gather_summed(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The group's tensors stacked along dim 0 in group order, on every
    member; under autograd each member's rows get the sum over the members
    of their gradients (``_GatherSum``)."""
    if group.size == 1:
        return t
    note("all-gather", nbytes(t) * group.size)
    return _GatherSum.apply(t, group, 0, "reduce-scatter (backward)", None)


def reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of its members' ``t``, cut in ``group.size``
    equal slices along ``dim``: this member's slice, a tensor of its own."""
    import torch.distributed as dist

    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // group.size, *moved.shape[1:]), dtype=t.dtype, device=t.device)
    # gloo and NCCL both take it; torch 2.13 renames it reduce_scatter_single (and warns), a name 2.11 lacks
    dist.reduce_scatter_tensor(out, moved, group=group.handle)
    return out.movedim(0, dim)


def gather_weight(t: torch.Tensor, group: Group, dim: int, leaf: Optional[str] = None) -> torch.Tensor:
    """A weight's blocks, which the rules shard over ``group`` (the data
    group) along ``dim``, joined in group order: the reference's FSDP
    all-gather at use. Under autograd the gradient of the whole is
    reduce-scattered back to the blocks (``_GatherSum``: each data rank's
    objective reads the whole weight, and a block's gradient is the sum of
    theirs, the data-parallel sum of a leaf that FSDP shards). A group of
    one rank gives ``t`` itself. ``leaf`` names the weight for
    ``count_traffic(by_leaf=True)``."""
    if group.size == 1:
        return t
    note("all-gather (weights)", nbytes(t) * group.size, leaf)
    return _GatherSum.apply(t, group, dim, "reduce-scatter (gradients)", leaf)


class _SplitRows(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor the model group holds
    whole (a copy: the whole can be freed); backward, the slices'
    gradients all-gathered, so that every rank holds the whole gradient of
    the replicated tensor. The transpose of ``_Gather``."""

    @staticmethod
    def forward(ctx, y, group, dim):
        ctx.conf = (group, dim)
        n = y.shape[dim] // group.size
        return y.narrow(dim, group.index * n, n).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.conf
        whole = all_gather(g, group, dim)
        note("all-gather (sequence, backward)", nbytes(whole))
        return whole, None, None


def split_sequence(h: torch.Tensor, level: Level, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism's cut at a period boundary (``seq_res ->
    model``): the residual stream (B, S, D), whole on the model group, cut
    to this rank's S/t positions. Its pair is ``join_sequence``; neither
    changes a bit of the values or of their gradients."""
    if level.tp == 1:
        return h
    if h.shape[dim] % level.tp:
        raise ValueError(f"sequence parallelism: {h.shape[dim]} positions do not split over TP {level.tp}")
    return _SplitRows.apply(h, level.model, dim)


def join_sequence(h: torch.Tensor, level: Level, dim: int = 1) -> torch.Tensor:
    """The model group's S/t-position slices of the residual stream joined
    whole in rank order (an all-gather; backward, each rank's slice of the
    whole gradient)."""
    if level.tp == 1:
        return h
    note("all-gather (sequence)", nbytes(h) * level.tp)
    return _Gather.apply(h, level.model, dim)


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """In place over ``group``: "sum" or "min"."""
    import torch.distributed as dist

    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op], group=group.handle)
    return t


def exchange(send: Sequence[torch.Tensor], group: Group, recv_numels: Sequence[int]) -> List[torch.Tensor]:
    """Each member sends ``send[k]`` (flat, one dtype) to member k and gets
    ``recv_numels[j]`` elements from member j, in one ``all_to_all_single``
    with uneven splits."""
    import torch.distributed as dist

    flat = torch.cat([s.reshape(-1) for s in send])
    out = torch.empty(sum(recv_numels), dtype=flat.dtype, device=flat.device)
    dist.all_to_all_single(out, flat, output_split_sizes=list(recv_numels),
                           input_split_sizes=[s.numel() for s in send], group=group.handle)
    return list(out.split(list(recv_numels)))


def agree(ok: bool, group: Group) -> bool:
    """True on every member if ``ok`` on every member, else False on every
    member: one all-reduce of a flag, so that no member goes on to a
    collective that another has left."""
    dev = torch.device("cuda", torch.cuda.current_device()) if group.backend == "nccl" else torch.device("cpu")
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    all_reduce(flag, group, "min")
    return bool(flag.item())


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


_CHUNK = 1 << 26  # elements summed at once: the int64 temporary of a chunk is 512 MiB


def _bit_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum (int64, wrapping) of ``t``'s elements' bit patterns, a chunk
    at a time: the int64 temporary of a whole leaf (a model's stacked
    experts) would not fit beside it."""
    flat = t.detach().contiguous().view(_BITS[t.element_size()]).view(-1)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for chunk in flat.split(_CHUNK):
        total += chunk.sum(dtype=torch.int64)
    return total


def checksums(tree) -> torch.Tensor:
    """One int64 checksum per tensor of ``tree`` (keys in sorted order): the
    sum of its elements' bit patterns, so equal tensors give equal sums."""
    sums = [_bit_sum(t) for t in _leaves(tree)]
    return torch.stack(sums) if sums else torch.zeros(0, dtype=torch.int64)


def check_replicated(tree, pool: "Pool", group: Optional[Group] = None) -> None:
    """Raise unless every member of ``group`` (default: the whole pool)
    holds the same bits in ``tree`` (e.g. weights each process drew from
    one seed on its own card; a data group's parameters after a train
    step): the members' checksums, all-gathered, must agree."""
    group = pool.world_group if group is None else group
    mine = checksums(tree).to(pool.device)
    every = all_gather(mine[None], group, 0)
    differ = (every != every[:1]).any(0).nonzero().flatten().tolist()
    if differ:
        raise RuntimeError(f"{len(differ)} of {mine.numel()} tensors differ between the ranks {list(group.ranks)} "
                           f"of the pool")


def all_reduce_leaves(leaves: Sequence[torch.Tensor], group: Group, names: Optional[Sequence[str]] = None) -> None:
    """Sum each tensor over ``group`` in place, one collective a leaf (a
    model's leaves are stacked over its layers: a handful of large
    tensors): the data-parallel gradient sum. ``names``: the leaves', for
    ``count_traffic(by_leaf=True)``."""
    if group.size == 1:
        return
    import torch.distributed as dist

    for i, t in enumerate(leaves):
        dist.all_reduce(t, group=group.handle)
        note("all-reduce (gradients)", nbytes(t), None if names is None else names[i])


def gather_into(t: torch.Tensor, part: torch.Tensor, group: Group, dim: int) -> None:
    """Write the group's parts, joined along ``dim`` in group order, into
    ``t`` (whose slice ``part`` is this member's): the all-gather of a
    ZeRO-1 update's slices."""
    whole = all_gather(part, group, dim)
    note("all-gather (parameters)", nbytes(whole))
    t.copy_(whole)


def rendezvous_file(directory: str) -> str:
    """A ``file://`` rendezvous in ``directory`` (no port: pools started side
    by side do not collide)."""
    return "file://" + os.path.join(os.path.abspath(directory), "rendezvous")
