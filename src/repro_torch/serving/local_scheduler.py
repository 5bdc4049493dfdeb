"""Per-group local scheduler (paper §3.3.2; mirrors
repro/serving/local_scheduler.py): iteration-level batch formation
over three queues — feasible SLO requests first, then best-effort (spilled
infeasible), then background — capped by the group's agreed throughput."""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional


@dataclass
class LocalScheduler:
    batch_cap: int  # from THD_tier / THP_tier for the group's tier & tp

    feasible: Deque = field(default_factory=deque)
    best_effort: Deque = field(default_factory=deque)
    background: Deque = field(default_factory=deque)

    def enqueue(self, item, feasible: bool = True, background: bool = False) -> None:
        if background:
            self.background.append(item)
        elif feasible:
            self.feasible.append(item)
        else:
            self.best_effort.append(item)

    def form_batch(self, running: List) -> List:
        """Fill the next iteration's batch: running requests keep their slots
        (continuous batching); free slots go feasible -> best-effort ->
        background."""
        batch = list(running[: self.batch_cap])
        for q in (self.feasible, self.best_effort, self.background):
            while q and len(batch) < self.batch_cap:
                batch.append(q.popleft())
        return batch

    def __len__(self) -> int:
        return len(self.feasible) + len(self.best_effort) + len(self.background)
