"""KV migration for TP switching (paper §3.2.2), mirroring
``migrate_cache`` and ``MigrationAborted`` of repro/core/migration.py.

The engine keeps its KV cache in one layout for every TP level (KV heads at
the largest candidate TP) on the device its attention runs on. On one card
a switch therefore moves no KV byte: ``Tensor.to`` of a tensor already on
the target device returns that tensor. Moving pages between cards
(kv_gather, NCCL, kv_scatter) comes with the multi-card slice. The
analytic ``MigrationModel`` stays in the reference.
"""
from __future__ import annotations

import time
from typing import Tuple, Union

import torch


class MigrationAborted(RuntimeError):
    """The source cache is untouched: migration builds new tensors and
    frees or mutates nothing of the source, so after an abort the caller
    can retry or restart the sequences."""


def _map(f, tree):
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(f, v) for v in tree)
    return f(tree)


def migrate_cache(cache, device: Union[str, torch.device]) -> Tuple[object, float]:
    """Place every cache tensor on ``device``; returns (cache, seconds).

    The time covers the copies to their end (the device is synchronised).
    Any failure raises ``MigrationAborted`` with the source cache intact.
    """
    t0 = time.perf_counter()
    try:
        target = torch.device(device)
        out = _map(lambda t: t.to(target), cache)
        if target.type == "cuda":
            torch.cuda.synchronize(target)
    except Exception as e:  # any failure of the move aborts it; the source is intact
        raise MigrationAborted(f"cache migration aborted: {e}") from e
    return out, time.perf_counter() - t0
