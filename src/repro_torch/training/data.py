"""Data pipeline: deterministic synthetic token streams + memmap shards
(a copy of repro/training/data.py, which needs nothing of JAX).

Determinism matters for fault tolerance: batch(step) is a pure function of
(seed, step), so a restarted run consumes exactly the continuation of the
stream, and the restart test asserts bitwise-identical training
trajectories. Batches are numpy int32 arrays, the same bits the reference
draws; the train step moves them to its device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int, seed: int = 0):
    """Markov-ish synthetic tokens (pure function of (seed, step))."""
    rng = np.random.RandomState((seed * 1_000_003 + step) % (2**31 - 1))
    base = rng.randint(0, cfg.vocab_size, size=(batch, seq + 1), dtype=np.int32)
    # inject local structure so the loss actually decreases: every odd
    # position repeats its predecessor (50% of targets exactly predictable)
    base[:, 1::2] = base[:, :-1:2]
    return {
        "tokens": base[:, :-1],
        "targets": base[:, 1:],
    }


@dataclass
class SyntheticDataset:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield synthetic_batch(self.cfg, self.batch, self.seq, step, self.seed)
            step += 1

    def at(self, step: int) -> dict:
        return synthetic_batch(self.cfg, self.batch, self.seq, step, self.seed)


class MemmapDataset:
    """Flat token shards on disk (one .bin uint32 file per shard)."""

    def __init__(self, path: str, batch: int, seq: int, seed: int = 0):
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".bin")
        )
        if not self.files:
            raise FileNotFoundError(f"no .bin shards under {path}")
        self.arrays = [np.memmap(f, dtype=np.uint32, mode="r") for f in self.files]
        self.total = sum(a.size for a in self.arrays)
        self.batch, self.seq, self.seed = batch, seq, seed

    def at(self, step: int) -> dict:
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2**31 - 1))
        need = self.seq + 1
        toks = np.empty((self.batch, need), np.int32)
        for b in range(self.batch):
            a = self.arrays[rng.randint(len(self.arrays))]
            off = rng.randint(0, a.size - need)
            toks[b] = a[off:off + need].astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def write_memmap_shard(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.uint32).tofile(path)
