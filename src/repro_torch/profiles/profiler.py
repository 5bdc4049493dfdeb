"""On-card profiler: measures the tables the planner consumes (mirrors
repro/profiles/profiler.py).

The paper expects admins to profile each accelerator type offline (§3.3.1).
``profile_engine`` times a ServingEngine's decode step and prefill buckets
at each of its TP levels by replaying the CUDA graphs its warm-up captured,
and emits the reference's table format (the same JSON, so each package
loads the other's files), which ``TabulatedPerfModel`` puts in front of the
analytic model. On the CPU the engine calls its step functions directly and
the table characterises the host (the tests use it for the machinery).

On one card the t ranks of TP t run one after another, so a TP t > 1 row
is their summed work on one card, not the step time of t cards. Over a
pool of processes (``ServingEngine(pool=...)``, a card each) a TP t row is
the step of t cards: every rank replays the same graphs in lockstep (each
replay holds its NCCL collectives), and the time written for a key is the
slowest rank's, all-reduced with max, so every rank returns the same
table.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.profiles.perf_model import PerfModel


@dataclass
class ProfileTable:
    """Measured (tp, batch, ctx) -> seconds tables + interpolation."""

    decode_s: Dict[Tuple[int, int, int], float] = field(default_factory=dict)
    prefill_s: Dict[Tuple[int, int], float] = field(default_factory=dict)  # (tp, len)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "decode": [[*k, v] for k, v in self.decode_s.items()],
                    "prefill": [[*k, v] for k, v in self.prefill_s.items()],
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "ProfileTable":
        with open(path) as f:
            d = json.load(f)
        t = cls()
        for *k, v in d["decode"]:
            t.decode_s[tuple(k)] = v
        for *k, v in d["prefill"]:
            t.prefill_s[tuple(k)] = v
        return t

    def decode_time(self, batch: int, ctx: int, tp: int) -> float:
        keys = [k for k in self.decode_s if k[0] == tp]
        if not keys:
            raise KeyError(f"no decode profile for tp={tp}")
        # nearest-neighbor in log space + linear batch scaling beyond grid
        best = min(keys, key=lambda k: abs(np.log(k[1] / batch)) + abs(np.log(k[2] / max(ctx, 1))))
        base = self.decode_s[best]
        return base * max(batch / best[1], 1.0) ** 0.8

    def prefill_time(self, length: int, tp: int) -> float:
        keys = [k for k in self.prefill_s if k[0] == tp]
        if not keys:
            raise KeyError(f"no prefill profile for tp={tp}")
        best = min(keys, key=lambda k: abs(np.log(k[1] / max(length, 1))))
        return self.prefill_s[best] * length / best[1]


def _sync(out) -> None:
    """Wait for the CUDA devices that ``out``'s tensors live on (the
    counterpart of ``jax.block_until_ready``); CPU tensors need no wait."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)`` on the host clock, each call waited
    for to its end on the device."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(fn(*args))
    return (time.perf_counter() - t0) / iters


def profile_engine(engine, batches: Sequence[int] = (1, 4), ctxs: Sequence[int] = (64,)) -> ProfileTable:
    """Profile a ServingEngine's executables over its TP levels: the decode
    step, keyed (tp, b, ctx), and each prefill bucket L, keyed (tp, L).

    As in the reference, the batch and context axes are not measured: every
    decode replay steps all ``n_slots`` slots at position ``ctxs[0]``, and
    the one time is written under every (tp, b, ctx) with b <= n_slots. A
    prefill replay takes L zero tokens, its last position L - 1, into slot
    0 (the reference's ``true_len = L``).

    Each TP level's graphs hold that level's bindings, so the engine is not
    switched: ``engine.tp`` is left as it was (the reference leaves its
    engine bound at the last TP level it profiled; the table is the same
    either way). The engine is warmed up first if an executable is missing.
    The replays write KV rows, so this is refused while a request holds a
    slot, and for a position past the cache; the MoE drop counters are
    restored after them (each rank's). Over a pool every rank calls this
    together and gets the same table: each key's time is the greatest of
    the ranks' (a collective over the pool).
    """
    if any(r is not None for r in engine.slot_req):
        raise RuntimeError("profile_engine() writes the KV cache: call it while no request holds a slot")
    if not 0 <= ctxs[0] < engine.econf.max_len:
        raise ValueError(f"decode position {ctxs[0]} outside the cache's max_len {engine.econf.max_len}")
    buckets = list(engine.econf.prefill_buckets)
    if not all(engine.cache.has(tp, key) for tp in engine.tps for key in ("decode", *buckets)):
        engine.warmup()
    drops = {key: n.clone() for key, n in engine._drops.items()}
    n, dev = engine.econf.n_slots, engine.device
    table = ProfileTable()
    for tp in engine.tps:
        tokens = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        positions = torch.full((n,), ctxs[0], dtype=torch.int64, device=dev)
        for b in batches:
            if b > n:
                continue
            dt = time_fn(engine.cache.get(tp, "decode"), tokens, positions)
            for ctx in ctxs:
                table.decode_s[(tp, b, ctx)] = dt
        for L in buckets:
            args = (torch.zeros((1, L), dtype=torch.int64, device=dev),
                    torch.full((1,), L - 1, dtype=torch.int64, device=dev),
                    torch.zeros((1,), dtype=torch.int64, device=dev))
            table.prefill_s[(tp, L)] = time_fn(engine.cache.get(tp, L), *args)
    for key, count in drops.items():
        engine._drops[key].copy_(count)
    if engine.pool is not None:
        _slowest_rank(table, engine.pool)
    return table


def _slowest_rank(table: ProfileTable, pool) -> None:
    """Every value of ``table`` replaced by its greatest over the pool's
    ranks (whose tables have the same keys, made in the same order)."""
    from repro_torch.parallel.collectives import all_reduce

    keys = [("decode", k) for k in table.decode_s] + [("prefill", k) for k in table.prefill_s]
    vals = torch.tensor([table.decode_s[k] if kind == "decode" else table.prefill_s[k] for kind, k in keys],
                        dtype=torch.float64, device=pool.device)
    for (kind, k), v in zip(keys, all_reduce(vals, pool.world_group, "max").tolist()):
        (table.decode_s if kind == "decode" else table.prefill_s)[k] = v


class TabulatedPerfModel(PerfModel):
    """PerfModel backed by measured tables where available, analytic
    otherwise — the drop-in the Planner uses on real hardware.

    As in the reference, the table is not a dataclass field: two tabulated
    models of one (cfg, hw, dtype_bytes) hash and compare equal, so they
    share the module's memoised queries (``max_prefill_rps``,
    ``max_decode_batch``) whatever their tables. Call
    ``clear_perf_caches()`` before querying a second one."""

    def __init__(self, cfg, table: ProfileTable, **kw):
        super().__init__(cfg, **kw)
        object.__setattr__(self, "table", table)

    def decode_step_time_s(self, batch: int, ctx_len: int, tp: int) -> float:
        try:
            return self.table.decode_time(batch, ctx_len, tp)
        except KeyError:
            return super().decode_step_time_s(batch, ctx_len, tp)

    def prefill_time_s(self, prompt_len: int, tp: int, batch: int = 1) -> float:
        try:
            return self.table.prefill_time(prompt_len, tp) * batch
        except KeyError:
            return super().prefill_time_s(prompt_len, tp, batch)
