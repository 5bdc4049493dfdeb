"""Training launcher (mirrors repro/launch/train.py).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --steps 50 --batch 8 --seq 128 \
        [--reduced] [--nproc 4] [--devices 4] [--tp 2] [--ckpt-dir DIR] [--compress] \
        [--layers 4] [--device cpu]

Weights are f32, drawn from a seeded ``torch.Generator`` on the device.
``--tp t`` runs the model's projections at TP t (``make_exec_config(cfg,
t)``: every rank's product through the ``tp_shard_matmul`` kernel at its
offset). ``--nproc P`` trains across P processes, one per card (the
reference's mesh over every device; gloo on the CPU with ``--device
cpu``): data P/t x model t, each rank holding its model shard of the
weights (drawn leaf by leaf, never whole) and its ZeRO-1 slice of the
moments, gradients summed over NCCL (``make_train_step(..., pool=)``);
only rank 0 logs. Without it, ``--devices N`` with ``--tp t`` gives dp =
N/t data ranks, which run their slices of each batch one after another on
the one card, their gradients summed in data order, with ZeRO-1 moments
split over them. ``--layers`` cuts the model's depth at full width. Fault
tolerance: re-running the same command resumes from the newest checkpoint
under ``--ckpt-dir`` (default ``repro_torch_train_ckpt`` in the temporary
directory, never the reference's), at any ``--nproc`` and ``--tp`` (the
checkpoint holds every leaf whole); ``--fresh`` clears it first.
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
from repro_torch.parallel.collectives import Pool
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.grad_compress import CompressConfig
from repro_torch.training.loop import LoopConfig, LoopState, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step, train_params

def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--nproc", type=int, default=1, help="processes, one per card (data nproc/tp x model tp)")
    ap.add_argument("--devices", type=int, default=0,
                    help="one process: ranks of the data x model mesh run on its card (0: one rank per TP rank)")
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


def model_config(args: argparse.Namespace) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def build(args: argparse.Namespace, pool: Optional[Pool] = None) -> Tuple[ModelConfig, dict]:
    """The model's config and its random weights on the device; across
    ``pool``, this rank's shards of them (the same draws)."""
    cfg = model_config(args)
    dev = resolve_device(args.device) if pool is None else pool.device
    gen = torch.Generator(device=dev).manual_seed(0)
    ec = make_exec_config(cfg, args.tp)
    defs = model_param_defs(cfg, ec)
    if pool is not None:
        return cfg, train_params(cfg, ec, pool, draw=(defs, gen, torch.float32))
    return cfg, init_params(defs, gen, torch.float32)


def run(cfg: ModelConfig, params: dict, args: argparse.Namespace, pool: Optional[Pool] = None) -> LoopState:
    """Train ``params`` (updated in place) for ``--steps`` steps through
    ``train_loop``, resuming from ``--ckpt-dir``'s newest checkpoint; across
    ``pool``, this rank's share of the run."""
    if pool is None and args.devices and args.devices % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide --devices {args.devices}")
    dp = args.devices // args.tp if args.devices and pool is None else 1
    ec = make_exec_config(cfg, args.tp)
    tcfg = TrainStepConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=10),
        compress=CompressConfig(enabled=args.compress),
        seq_chunk=min(512, args.seq),
        block_q=min(512, args.seq),
        block_k=min(512, args.seq),
        accum_steps=args.accum,
    )
    step_fn, plan = make_train_step(cfg, ec, params, tcfg, dp=dp, pool=pool)
    opt_state = init_opt_state(params, tcfg, plan, step_fn)
    ds = SyntheticDataset(cfg, args.batch, args.seq)
    lead = pool is None or pool.rank == 0
    if args.fresh and lead and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)
    if pool is not None:
        pool.barrier()
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)

    def log(step, metrics):
        if lead and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    return train_loop(step_fn, params, opt_state, ds, loop, on_step=log)


def train_rank(pool: Pool, inputs: dict) -> dict:
    """One rank of ``--nproc``: its shards of the launcher's model, trained
    across the pool; the run's record (every rank's is the same)."""
    args = argparse.Namespace(**inputs)
    cfg, params = build(args, pool)
    st = run(cfg, params, args, pool)
    return {"step": st.step, "losses": st.losses, "step_times": st.step_times, "resumed_from": st.resumed_from,
            "straggler_steps": st.straggler_steps, "cfg": cfg.name, "layers": cfg.num_layers,
            "mesh": [pool.world // args.tp, args.tp]}


def main(argv: Optional[Sequence[str]] = None) -> LoopState:
    args = parse_args(argv)
    if args.nproc > 1:
        from repro_torch.testing.multidev_checks import spawn

        kind = "cpu" if args.device is not None and torch.device(args.device).type == "cpu" else "cuda"
        rank0 = spawn(args.nproc, kind, task="repro_torch.launch.train:train_rank", inputs=vars(args),
                      timeout=3600)[0]["repro_torch.launch.train:train_rank"]
        state = LoopState(step=rank0["step"], losses=rank0["losses"], step_times=rank0["step_times"],
                          straggler_steps=rank0["straggler_steps"], resumed_from=rank0["resumed_from"])
        print(f"{rank0['cfg']} ({rank0['layers']} layers) on {args.nproc} processes, data {rank0['mesh'][0]} x "
              f"model {rank0['mesh'][1]}")
    else:
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
