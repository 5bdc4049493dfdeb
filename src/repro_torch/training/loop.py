"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler-aware step timing (mirrors repro/training/loop.py).

Restart contract: (deterministic data at(step)) + (checkpointed params/opt
state/step) => a crashed-and-resumed run reproduces the uninterrupted
trajectory; bitwise on the CPU. On CUDA the backward of the embedding's
lookup, of the CE's gather and of the MoE's index ops adds with atomics,
so a resumed run agrees within f32 rounding. The step function updates
its params in place, so a resume loads the checkpoint into the same
tensors.

Across processes (a step function made over a pool carries its
``layout``) the checkpoints are the reference's elastic ones: rank 0 writes
every leaf whole and all ranks wait for it; a resume places each rank's
shard and ZeRO slice, whatever layout (or one process) wrote them.

Straggler mitigation: per-step wall times feed an EWMA; steps slower than
``straggler_factor`` x the EWMA are counted and surfaced. ``float(loss)``
is the step's sync.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.checkpoint.checkpoint import assign_, latest_checkpoint, load_checkpoint, save_checkpoint


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "repro_ckpt"
    resume: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclass
class LoopState:
    step: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    straggler_steps: int = 0
    resumed_from: Optional[int] = None
    params: object = None
    opt_state: object = None


def train_loop(
    step_fn,
    params,
    opt_state,
    dataset,
    loop: LoopConfig,
    fail_at: Optional[int] = None,
    on_step: Optional[Callable] = None,
) -> LoopState:
    state = LoopState()
    start = 0
    layout = getattr(step_fn, "layout", None)
    ckpt = latest_checkpoint(loop.ckpt_dir) if loop.resume else None
    if ckpt is not None:
        loaded, start, _ = load_checkpoint(ckpt, (params, opt_state), layout)
        assign_((params, opt_state), loaded)
        state.resumed_from = start
    ewma = None
    for step in range(start, loop.total_steps):
        if fail_at is not None and step == fail_at:
            raise SimulatedFailure(f"injected failure at step {step}")
        batch = dataset.at(step)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > loop.straggler_factor * ewma and step > start + 3:
            state.straggler_steps += 1
        state.step_times.append(dt)
        state.losses.append(loss)
        state.step = step + 1
        if on_step is not None:
            on_step(step, metrics)
        if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.total_steps:
            save_checkpoint(loop.ckpt_dir, step + 1, (params, opt_state), layout=layout)
    state.params = params
    state.opt_state = opt_state
    return state
