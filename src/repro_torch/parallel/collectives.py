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
over its group. Each point where the reference runs a collective also calls
``stand_in`` with that collective. Nothing listens unless a counter is
installed (``launch.op_cost`` does so while it counts a program), so a call
costs one test of an empty list.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

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
def reduce_ranks(parts: Sequence[torch.Tensor], level: Optional[Level], n: int) -> torch.Tensor:
    """The sum of a row-parallel product's partials over a TP group of ``n``
    ranks (the reference's psum): the parts this process holds, summed in
    rank order, then over the level's model group when there is one."""
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    stand_in("all-reduce", nbytes(y), n)
    if level is not None:
        import torch.distributed as dist

        dist.all_reduce(y, group=level.model.handle)
    return y


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


def gather_ranks(parts: Sequence[torch.Tensor], level: Optional[Level], dim: int = -1) -> torch.Tensor:
    """Column-parallel outputs joined in rank order along ``dim``: the parts
    this process holds, then the model group's when there is one."""
    y = torch.cat(list(parts), dim) if len(parts) > 1 else parts[0]
    return y if level is None else all_gather(y, level.model, dim)


def all_to_all(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Dim 0 cut in ``group.size`` equal chunks, chunk k sent to member k;
    returns the chunks received, in member order along dim 0."""
    import torch.distributed as dist

    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group.handle)
    return out


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


def check_replicated(tree, pool: "Pool") -> None:
    """Raise unless every rank of ``pool`` holds the same bits in ``tree``
    (e.g. weights each process drew from one seed on its own card): the
    ranks' checksums, all-gathered, must agree."""
    mine = checksums(tree).to(pool.device)
    every = all_gather(mine[None], pool.world_group, 0)
    differ = (every != every[:1]).any(0).nonzero().flatten().tolist()
    if differ:
        raise RuntimeError(f"{len(differ)} of {mine.numel()} tensors differ between the ranks of the pool")


def rendezvous_file(directory: str) -> str:
    """A ``file://`` rendezvous in ``directory`` (no port: pools started side
    by side do not collide)."""
    return "file://" + os.path.join(os.path.abspath(directory), "rendezvous")
