"""Training launcher (mirrors repro/launch/train.py).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 50 --batch 8 --seq 128 \
        [--reduced] [--devices 4] [--tp 2] [--ckpt-dir DIR] [--compress] \
        [--layers 4] [--device cpu]

Weights are f32, drawn from a seeded ``torch.Generator`` on the device.
``--tp t`` runs the model's projections at TP t (``make_exec_config(cfg,
t)``: every rank's product through the ``tp_shard_matmul`` kernel at its
offset); ``--devices N`` with ``--tp t`` gives dp = N/t data ranks, which
run their slices of each batch one after another on the one card, their
gradients summed in data order, with ZeRO-1 moments split over them
(``training.train_step.make_train_step``). ``--layers`` cuts the model's
depth at full width. Fault tolerance: re-running the same command resumes
from the newest checkpoint under ``--ckpt-dir`` (default
``repro_torch_train_ckpt`` in the temporary directory, never the
reference's); ``--fresh`` clears it first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import init_params
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.grad_compress import CompressConfig
from repro_torch.training.loop import LoopConfig, LoopState, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--devices", type=int, default=0, help="ranks of the data x model mesh (0: one rank per TP rank)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true", help="int8 grad compression")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fresh", action="store_true", help="ignore existing ckpts")
    ap.add_argument("--layers", type=int, default=None, help="cut the model's depth")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[ModelConfig, dict]:
    """The model's config and its random weights on the device."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, args.tp)), gen, torch.float32)
    return cfg, params


def run(cfg: ModelConfig, params: dict, args: argparse.Namespace) -> LoopState:
    """Train ``params`` (updated in place) for ``--steps`` steps through
    ``train_loop``, resuming from ``--ckpt-dir``'s newest checkpoint."""
    if args.devices and args.devices % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide --devices {args.devices}")
    dp = args.devices // args.tp if args.devices else 1
    ec = make_exec_config(cfg, args.tp)
    tcfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=10),
        compress=CompressConfig(enabled=args.compress),
        seq_chunk=min(512, args.seq),
        block_q=min(512, args.seq),
        block_k=min(512, args.seq),
        accum_steps=args.accum,
    )
    step_fn, plan = make_train_step(cfg, ec, params, tcfg, dp=dp)
    opt_state = init_opt_state(params, tcfg, plan)
    ds = SyntheticDataset(cfg, args.batch, args.seq)
    if args.fresh and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)

    def log(step, metrics):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    return train_loop(step_fn, params, opt_state, ds, loop, on_step=log)


def main(argv: Optional[Sequence[str]] = None) -> LoopState:
    args = parse_args(argv)
    cfg, params = build(args)
    state = run(cfg, params, args)
    if state.resumed_from:
        print(f"(resumed from step {state.resumed_from})")
    if state.losses:
        times = state.step_times[3:] or state.step_times
        print(f"done: {state.step} steps, final loss {state.losses[-1]:.4f}, "
              f"mean step {np.mean(times):.3f}s, stragglers {state.straggler_steps}")
    return state


if __name__ == "__main__":
    main()
