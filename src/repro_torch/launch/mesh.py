"""Production mesh descriptions (mirrors repro/launch/mesh.py).

The reference builds a ``jax`` mesh over 256 (or 512) devices for its dry
run. The port's dry run runs one TP group's program on ``meta`` tensors, so
its mesh is only a description, an ordered {axis name: size} dict: which
axes the sharding rules may use and how many ways each splits. Nothing
here touches a device.
"""
from __future__ import annotations

import math
from typing import Dict


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16x16 = 256 chips per pod; multi-pod adds a 2-pod leading axis."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_chips(mesh: Dict[str, int]) -> int:
    return math.prod(mesh.values())
