"""GPipe-style pipeline schedule over a ``pipe`` axis (mirrors
repro/parallel/pipeline.py).

Stage s owns periods [s·P/S, (s+1)·P/S); microbatches stream through the
stages. The reference runs the classic shard_map schedule: ``n_micro +
n_stages - 1`` ticks, in each of which every stage processes the
microbatch it holds (or a bubble) and ``ppermute``s its output to the next
stage; only the last stage records finished microbatches, and a ``psum``
over ``pipe`` hands them to every stage. A stage in a bubble computes
nothing here: the reference computes and then discards its result, so the
outputs agree.

Two forms. On one device (a mesh of devices, ``make_pipe_mesh(devices,
...)``) the stages of a tick run one after another, and a handoff list
takes the place of the ``ppermute``. Across processes (``make_pipe_mesh(
pool.devices, ..., pool=pool)``) each process is one (pipe, data, model)
coordinate of the reference's mesh, laid out as the reference lays its
devices out: ``devices.reshape(n_stages, N // (n_stages * tp), tp)``,
row-major, so pool position r is stage r // (N/S), data coordinate
(r % (N/S)) // tp and model coordinate r % tp (model-minor, unlike the
serving pool's levels, ``collectives.coords``, which are model-major). Each
process holds its stage's periods alone and its data rank's rows of every
microbatch; the handoff is a point-to-point send and receive per tick
under autograd, and the final ``psum`` a broadcast from the last stage over
the pipe group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_leaves_with_path, tree_map
from repro_torch.parallel.collectives import Group, Pool, nbytes, note

AXES = ("pipe", "data", "model")


@dataclass(frozen=True)
class PipeMesh:
    """The reference's (pipe, data, model) mesh as a device array; across
    processes also the pool and this process's group along each axis."""

    devices: np.ndarray  # (n_stages, data, tp) of torch.device
    pool: Optional[Pool] = None
    groups: Optional[Dict[str, Group]] = None  # across processes: {"pipe", "data", "model"}

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def coords(self) -> Dict[str, int]:
        """This process's coordinate along each axis (across processes)."""
        return {ax: g.index for ax, g in self.groups.items()}


def _axis_groups(shape: Tuple[int, int, int], pool: Pool) -> Dict[str, Group]:
    """This process's group along each axis of a mesh of ``shape`` over the
    pool's positions in row-major order. Every process makes every group of
    every axis, in one order, as ``new_group`` requires."""
    import torch.distributed as dist

    pos = np.arange(pool.world).reshape(shape)
    mine: Dict[str, Group] = {}
    for a, ax in enumerate(AXES):
        lines = np.moveaxis(pos, a, -1).reshape(-1, shape[a])  # the positions that differ along this axis alone
        for line in lines:
            ranks = tuple(int(j) for j in line)
            handle = dist.new_group([pool.members[j] for j in ranks], backend=pool.backend) if len(ranks) > 1 else None
            if pool.rank in ranks:
                mine[ax] = Group(ranks, ranks.index(pool.rank), handle, pool.backend)
    return mine


def make_pipe_mesh(devices: Sequence[torch.device], n_stages: int, tp: int = 1,
                   pool: Optional[Pool] = None) -> PipeMesh:
    """The (pipe, data, model) mesh of ``devices`` (the reference's
    ``make_pipe_mesh``); with ``pool`` (every process calls it together:
    it makes the axes' process groups) the devices are the pool's, one
    coordinate a process."""
    n = len(devices)
    if n % (n_stages * tp):
        raise ValueError(f"{n} devices do not split into {n_stages} stages of TP {tp}")
    shape = (n_stages, n // (n_stages * tp), tp)
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    if pool is None:
        return PipeMesh(arr.reshape(shape))
    if n != pool.world:
        raise ValueError(f"a pipe mesh over a pool of {pool.world} processes takes its {pool.world} devices, not {n}")
    return PipeMesh(arr.reshape(shape), pool, _axis_groups(shape, pool))


def pipeline_apply(
    body: Callable,  # (h, stage_params, period_idx_within_stage) -> h
    params_stacked,  # tree, leaves (n_periods, ...); across processes this stage's (n_periods / n_stages, ...)
    h0: torch.Tensor,  # (n_micro, B_micro, S, D); across processes this data rank's (n_micro, B_micro / data, S, D)
    mesh: PipeMesh,
    n_periods: int,
) -> torch.Tensor:
    """Returns h after all periods, microbatched: (n_micro, B_micro, S, D),
    across processes this data rank's rows, on every stage.

    Across processes the gradient is the sequential stack's, as the
    reference's is: the loss each process takes of the result counts once
    (the last stage's cotangent goes back; the other stages' copies of the
    result carry none, as in the serving collectives, where every rank
    computes the same loss), and each stage's parameters get their own
    periods' gradient of this data rank's rows. The caller sums those over
    the mesh's data group (``mesh.groups["data"]``), as a train step sums
    its gradients over its data group; the model axis replicates the
    stage (a body may shard over ``mesh.groups["model"]`` itself)."""
    n_stages = mesh.shape["pipe"]
    if n_periods % n_stages:
        raise ValueError(f"{n_periods} periods do not split over {n_stages} stages")
    per_stage = n_periods // n_stages
    if mesh.pool is not None:
        return _across_processes(body, params_stacked, h0, mesh, per_stage)
    n_micro = h0.shape[0]
    carry = [torch.zeros_like(h0[0]) for _ in range(n_stages)]  # what each stage received last tick
    out = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent = []
        for sid in range(n_stages):
            mb = t - sid  # the microbatch this stage works on
            h = h0[min(max(mb, 0), n_micro - 1)] if sid == 0 else carry[sid]
            if 0 <= mb < n_micro:
                for k in range(per_stage):
                    h = body(h, tree_map(lambda x: x[sid * per_stage + k], params_stacked), k)
                if sid == n_stages - 1:  # the last stage records its finished microbatch
                    out[mb] = h
            sent.append(h)
        carry = [sent[(i - 1) % n_stages] for i in range(n_stages)]  # stage i -> i + 1
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Across processes
# ---------------------------------------------------------------------------
def _exchange(send: Optional[torch.Tensor], to: Optional[int], recv: Optional[torch.Tensor],
              frm: Optional[int]) -> None:
    """One batched send of ``send`` to global rank ``to`` and receive into
    ``recv`` from ``frm`` (either may be absent), waited for: posted
    together, so that neighbours exchanging at once never wait on each
    other."""
    import torch.distributed as dist

    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send, to))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, frm))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Handoff(torch.autograd.Function):
    """One tick's handoff on a stage: forward sends ``send`` (this tick's
    output, or None) to the next stage and receives the previous stage's
    into a tensor like ``like`` (or nothing); backward sends the received
    tensor's cotangent back to the previous stage and receives the sent
    one's from the next. ``token`` chains a stage's handoffs in tick order,
    so that backward takes them in reverse tick order on every stage (the
    order their sends and receives pair up in), each one even where no
    gradient reaches its received tensor."""

    @staticmethod
    def forward(ctx, token, send, like, nxt, prev):
        ctx.conf = (send is not None, nxt, prev, None if send is None else (send.shape, send.dtype))
        recv = None if like is None else torch.empty_like(like)
        _exchange(None if send is None else send.contiguous(), nxt, recv, prev)
        if send is not None:
            note("send (pipeline)", nbytes(send))
        return token.clone(), (torch.empty(0, device=token.device) if recv is None else recv)

    @staticmethod
    def backward(ctx, g_token, g_recv):
        sent, nxt, prev, meta = ctx.conf
        g_send = None
        if sent:
            g_send = torch.empty(meta[0], dtype=meta[1], device=g_token.device)
        back = g_recv.contiguous() if prev is not None else None
        _exchange(back, prev, g_send, nxt if sent else None)
        return g_token, g_send, None, None, None


class _FromLast(torch.autograd.Function):
    """The reference's final psum over ``pipe``: the last stage's finished
    microbatches broadcast to every stage. Backward passes the last stage's
    own cotangent back and nothing from the others (each stage takes the
    same loss of the same result: it counts once)."""

    @staticmethod
    def forward(ctx, token, out, like, src, handle):
        import torch.distributed as dist

        ctx.mine = out is not None
        y = out.clone() if out is not None else torch.empty_like(like)
        if handle is not None:
            dist.broadcast(y, src=src, group=handle)
        return y

    @staticmethod
    def backward(ctx, g):
        return torch.zeros((), device=g.device), (g if ctx.mine else None), None, None, None


def _across_processes(body: Callable, params, h0: torch.Tensor, mesh: PipeMesh, per_stage: int) -> torch.Tensor:
    """The schedule on this process's stage: ``n_micro + S - 1`` ticks; at
    tick t the stage works on microbatch t - s if there is one (stage 0
    reads it from ``h0``, the others from what they received the tick
    before), sends the result to stage s + 1 and receives stage s - 1's.
    A stage sends only what it computed and receives only what its next
    tick reads: the reference's ring pair (S-1) -> 0 and its bubbles'
    handoffs carry nothing a stage reads and are not sent."""
    pipe = mesh.groups["pipe"]
    S, s = pipe.size, pipe.index
    for path, x in tree_leaves_with_path(params):
        if x.shape[0] != per_stage:
            raise ValueError(f"{'/'.join(path)}: {x.shape[0]} periods here, not this stage's {per_stage}")
    members = mesh.pool.members
    nxt = members[pipe.ranks[s + 1]] if s + 1 < S else None
    prev = members[pipe.ranks[s - 1]] if s > 0 else None
    n_micro = h0.shape[0]
    needs_grad = torch.is_grad_enabled() and (h0.requires_grad or any(
        x.requires_grad for _, x in tree_leaves_with_path(params)))
    token = torch.zeros((), device=h0.device, requires_grad=needs_grad)
    like = h0[0]
    received: Optional[torch.Tensor] = None
    out: List[torch.Tensor] = []
    for t in range(n_micro + S - 1):
        mb = t - s
        send = None
        if 0 <= mb < n_micro:
            h = h0[mb] if s == 0 else received
            for k in range(per_stage):
                h = body(h, tree_map(lambda x: x[k], params), k)
            if s == S - 1:
                out.append(h)
            else:
                send = h
        takes = s > 0 and 0 <= t + 1 - s < n_micro  # the previous stage computed this tick what this one reads next
        token, recv = _Handoff.apply(token, send, like if takes else None, nxt if send is not None else None,
                                     prev if takes else None)
        received = recv if takes else None
    mine = torch.stack(out) if s == S - 1 else None
    return _FromLast.apply(token, mine, h0, members[pipe.ranks[-1]], pipe.handle)
