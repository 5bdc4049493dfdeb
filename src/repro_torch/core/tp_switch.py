"""TP switch controller: zero-copy weight rebinding with transactional
rollback (mirrors TPSwitchController and SwitchAborted of
repro/core/tp_switch.py).

The reference also keeps one AOT-compiled executable per TP level; the
port's analogue, one CUDA graph per TP level, is later work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from repro_torch.core.weight_store import WeightStore


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


class TPSwitchController:
    """Coordinates a switch: rebind weights (zero-copy), migrate caches.

    ``install`` binds the storage at every candidate TP once, the
    counterpart of the reference's per-TP executables compiled up front; a
    switch then re-points to the warm binding. The bindings are views, so
    they hold no weight bytes of their own.

    So the work the reference's ``switch`` times as ``rebind`` (building the
    per-rank views) is done here at install and timed per TP level in
    ``bind_s``; a switch's ``rebind_s`` is only the lookup of that binding.
    """

    def __init__(self, store: WeightStore, candidate_tps: Sequence[int]):
        self.store = store
        self.tps = tuple(candidate_tps)
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
