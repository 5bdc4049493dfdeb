"""The points where the one-card program stands in for a collective.

The port runs every rank of a TP group in one process, so what the
reference does with a collective is a plain op here: a row-parallel
projection's psum is a sum of the ranks' partial products, an MoE layer's
all-to-all a gather. Each such point calls ``stand_in`` with the collective
the reference runs there. Nothing listens unless a counter is installed
(``launch.op_cost`` does so while it counts a program), so a call costs one
test of an empty list.
"""
from __future__ import annotations

from typing import Callable, List

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
