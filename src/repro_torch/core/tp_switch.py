"""TP switch controller: warm executables per TP level, zero-copy weight
rebinding with transactional rollback (mirrors ExecutableCache,
TPSwitchController and SwitchAborted of repro/core/tp_switch.py).

The paper keeps one pre-profiled (CUDA-graph captured) process per TP level
and a switch routes work to a different warm one. The port's counterpart of
the reference's AOT executables is one CUDA graph per (TP level, stage,
bucket), captured up front into one memory pool; a switch only changes
which graphs are replayed. Weights never move (``WeightStore.rebind``).
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.weight_store import WeightStore
from repro_torch.kernels import _build


class SwitchAborted(RuntimeError):
    """A TP switch failed mid-flight (e.g. during cache migration). The
    controller has rolled back to the pre-switch binding and TP before
    raising, so the caller may keep serving at the old TP or retry."""


@dataclass
class SwitchStats:
    n_switches: int = 0
    n_aborts: int = 0
    total_rebind_s: float = 0.0
    total_migrate_s: float = 0.0
    last_rebind_s: float = 0.0
    last_migrate_s: float = 0.0


class Executable:
    """One step function at one (TP level, key).

    On a CUDA device it is a captured graph: a call copies its inputs into
    the static input tensors, replays the graph, adds the launches the
    capture recorded to each kernel wrapper's count, and returns the static
    outputs. Every graph of the cache shares one memory pool, so the next
    replay of another graph may overwrite them: read or copy them first. On the CPU there is no
    graph: a call runs the function on the inputs it is given, the
    counterpart of the kernel wrappers' plain path.
    """

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], graph=None, outputs=None,
                 launches: Sequence[Tuple[Callable, int]] = (), keep: Sequence[torch.Tensor] = ()):
        self.fn, self.inputs, self.graph, self.outputs = fn, tuple(inputs), graph, outputs
        self.launches = tuple(launches)  # (wrapper, launches of it in one replay)
        self.keep = tuple(keep)  # scratch the graph points at, alive as long as it is
        self.replays = 0

    def __call__(self, *args: torch.Tensor):
        if self.graph is None:
            return self.fn(*args)
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        self.replays += 1
        return self.outputs


class ExecutableCache:
    """Executables per (tp, key), made once at start-up ("offline", like the
    paper's CUDA-graph capture); switches only dispatch. ``capture_s``
    mirrors the reference's ``compile_s``.

    On a CUDA device, ``put`` runs the function once on the cache's own
    capture stream (which builds the kernels, grows their scratch for that
    stream and warms the allocator), then captures it into a graph in the
    cache's memory pool. The graphs never run at the same time (one engine
    replays one at a time, on the caller's stream), so they share the pool
    and the scratch. PyTorch's notes on graph memory management call a
    shared pool safe when the graphs replay in the order they were captured
    (torch 2.11's docstrings only call ``pool`` a hint and ask for one
    capture stream, as here). The engine replays them in any order, which
    is safe because a replay may overwrite only what lives in the pool:
    other graphs' intermediates, dead once their replay ended, and their
    outputs, which are read or copied before another graph replays. The
    inputs, the weights and the KV cache are allocated outside the
    captures, so outside the pool. A graph replays fixed addresses: the
    weights, the KV cache and the static inputs must keep theirs.

    Across processes a step holds NCCL collectives, and every rank captures
    the same steps in the same order, so the graphs hold the same
    collectives in the same order on every card. The pool warmed each
    group's communicator with an eager collective before any capture, and
    the warm-up run on the capture stream runs each step's collectives
    eagerly once more.
    """

    def __init__(self):
        self._exe: Dict[Tuple[int, Any], Executable] = {}
        self.capture_s: Dict[Tuple[int, Any], float] = {}
        self.pool = None
        self.stream = None
        # "thread_local" across processes: NCCL's watchdog thread queries
        # events while this thread captures, which the "global" mode forbids
        self.capture_error_mode = "global"

    def put(self, tp: int, key: Any, fn: Callable, inputs: Sequence[torch.Tensor]) -> None:
        """fn(*inputs) -> tuple of tensors. On CUDA, inputs are the static
        input tensors the graph reads."""
        t0 = time.perf_counter()
        dev = inputs[0].device
        self._exe[(tp, key)] = self._capture(fn, inputs, dev) if dev.type == "cuda" else Executable(fn, inputs)
        self.capture_s[(tp, key)] = time.perf_counter() - t0

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor], dev: torch.device) -> Executable:
        if self.pool is None:
            self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            fn(*inputs)  # warm-up on the capture stream
        counted = tuple(_build.COUNTED)
        before = [w.launches for w in counted]
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph collects garbage before it starts; a collection
        # that Python starts inside the capture could run the teardown of
        # another CUDA graph (an engine dropped in a reference cycle), which
        # a capturing stream does not allow: the capture is invalidated
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode=self.capture_error_mode):
                outputs = fn(*inputs)
        finally:
            if collecting:
                gc.enable()
        launches = [(w, w.launches - b) for w, b in zip(counted, before) if w.launches != b]
        for w, n in launches:  # the capture launched nothing; each replay adds these
            w.launches -= n
        keep = _build.scratch_buffers(dev, self.stream.cuda_stream)
        return Executable(fn, inputs, graph, outputs, launches, keep)

    def get(self, tp: int, key: Any) -> Executable:
        return self._exe[(tp, key)]

    def has(self, tp: int, key: Any) -> bool:
        return (tp, key) in self._exe

    def tps(self) -> List[int]:
        return sorted({tp for tp, _ in self._exe})

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches made by the graphs' replays so far, by wrapper."""
        out: Dict[str, int] = {}
        for exe in self._exe.values():
            for wrapper, n in exe.launches:
                out[wrapper.__name__] = out.get(wrapper.__name__, 0) + n * exe.replays
        return out

    def graphs(self) -> int:
        """How many of the executables are captured graphs."""
        return sum(e.graph is not None for e in self._exe.values())

    def pool_bytes(self) -> Optional[int]:
        """Bytes the graphs' memory pool holds on the card (its segments in
        the allocator's snapshot), or None without graphs or without pool
        ids in the snapshot."""
        segments = torch.cuda.memory_snapshot() if self.pool is not None else []
        if not any("segment_pool_id" in seg for seg in segments):
            return None
        return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == tuple(self.pool))


class TPSwitchController:
    """Coordinates a switch: rebind weights (zero-copy), migrate caches,
    point dispatch at the new TP level's executables (``cache``, filled by
    the engine's warm-up).

    ``install`` binds the storage at every candidate TP once, the
    counterpart of the reference's per-TP executables compiled up front; a
    switch then re-points to the warm binding. The bindings are views, so
    they hold no weight bytes of their own.

    So the work the reference's ``switch`` times as ``rebind`` (building the
    per-rank views) is done here at install and timed per TP level in
    ``bind_s``; a switch's ``rebind_s`` is only the lookup of that binding.

    Across processes every rank runs the same switches in lockstep: the
    bindings are each card's own views, and a ``migrate_fn`` that reshards
    across ranks (``migration.migrate_cache`` with a pool) fails on every
    rank or on none, so every rank rolls back together.
    """

    def __init__(self, store: WeightStore, candidate_tps: Sequence[int]):
        self.store = store
        self.tps = tuple(candidate_tps)
        self.cache = ExecutableCache()
        self.stats = SwitchStats()
        self.current_tp: Optional[int] = None
        self.storage: Optional[dict] = None
        self.params: Optional[dict] = None
        self.bindings: dict = {}
        self.bind_s: dict = {}  # TP level -> seconds to bind the storage at it

    def install(self, canonical_params: dict, tp: int) -> None:
        self.storage = self.store.build(canonical_params)
        for t in self.tps:
            t0 = time.perf_counter()
            self.bindings[t] = self.store.rebind(self.storage, t)
            self.bind_s[t] = time.perf_counter() - t0
        self.params = self.bindings[tp]
        self.current_tp = tp

    def switch(self, to_tp: int, migrate_fn: Optional[Callable] = None):
        """migrate_fn: to_tp -> (migrated_caches, seconds).

        Transactional: if migrate_fn raises, the pre-switch binding and
        current_tp are restored and ``SwitchAborted`` is raised. Rollback is
        free because rebinding never touched the storage tensors.
        """
        if self.storage is None:
            raise RuntimeError("install() before switch()")
        if to_tp not in self.tps:
            raise ValueError(f"tp={to_tp} is not a candidate {self.tps}")
        prev_params, prev_tp = self.params, self.current_tp
        t0 = time.perf_counter()
        self.params = self.bindings[to_tp]
        rebind_s = time.perf_counter() - t0
        migrate_s = 0.0
        migrated = None
        if migrate_fn is not None:
            try:
                migrated, migrate_s = migrate_fn(to_tp)
            except Exception as e:  # any mid-flight failure rolls the switch back
                self.params, self.current_tp = prev_params, prev_tp
                self.stats.n_aborts += 1
                raise SwitchAborted(f"switch {prev_tp}->{to_tp} aborted during cache migration: {e}") from e
        self.current_tp = to_tp
        st = self.stats
        st.n_switches += 1
        st.total_rebind_s += rebind_s
        st.total_migrate_s += migrate_s
        st.last_rebind_s, st.last_migrate_s = rebind_s, migrate_s
        return migrated
