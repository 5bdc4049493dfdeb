"""Request lifecycle for tiered serving (a copy of repro/serving/request.py)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    REJECTED = "rejected"


@dataclass
class Request:
    req_id: int
    tier: str
    prompt: np.ndarray  # token ids (int32)
    max_new_tokens: int
    arrival_s: float = 0.0
    background: bool = False
    tenant_id: str = "default"

    state: RequestState = RequestState.QUEUED
    feasible: bool = True  # global scheduler's SLO feasibility label (§3.3.2)
    slot: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens
