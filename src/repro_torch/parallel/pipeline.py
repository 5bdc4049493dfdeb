"""GPipe-style pipeline schedule over a ``pipe`` axis (mirrors
repro/parallel/pipeline.py).

Stage s owns periods [s·P/S, (s+1)·P/S); microbatches stream through the
stages. The reference runs the classic shard_map schedule: ``n_micro +
n_stages - 1`` ticks, in each of which every stage processes the
microbatch it holds (or a bubble) and ``ppermute``s its output to the next
stage; only the last stage records finished microbatches. On one device
the stages of a tick run one after another, and a handoff list takes the
place of the ``ppermute``. A stage in a bubble computes nothing: the
reference computes and then discards its result, so the outputs agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.models.params import tree_map


@dataclass(frozen=True)
class PipeMesh:
    """The reference's (pipe, data, model) mesh as a device array."""

    devices: np.ndarray  # (n_stages, data, tp) of torch.device

    axis_names = ("pipe", "data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_pipe_mesh(devices: Sequence[torch.device], n_stages: int, tp: int = 1) -> PipeMesh:
    n = len(devices)
    if n % (n_stages * tp):
        raise ValueError(f"{n} devices do not split into {n_stages} stages of TP {tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = list(devices)
    return PipeMesh(arr.reshape(n_stages, n // (n_stages * tp), tp))


def pipeline_apply(
    body: Callable,  # (h, stage_params, period_idx_within_stage) -> h
    params_stacked,  # tree, leaves (n_periods, ...)
    h0: torch.Tensor,  # (n_micro, B_micro, S, D) microbatched activations
    mesh: PipeMesh,
    n_periods: int,
) -> torch.Tensor:
    """Returns h after all periods, microbatched: (n_micro, B_micro, S, D)."""
    n_stages = mesh.shape["pipe"]
    if n_periods % n_stages:
        raise ValueError(f"{n_periods} periods do not split over {n_stages} stages")
    per_stage = n_periods // n_stages
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
