"""Train a reduced-config model for a few hundred steps with checkpointing
(mirrors examples/train_tiny.py).

    PYTHONPATH=src python -m repro_torch.examples.train_tiny [--arch mamba2-2.7b] [--steps 200] [--device cpu]

The loss must fall: the mean of the last ten steps below the first ten's.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import count_params, init_params, model_param_defs
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.loop import LoopConfig, LoopState, train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step


def main(argv: Optional[Sequence[str]] = None) -> LoopState:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_tiny_ckpt"))
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    ec = make_exec_config(cfg, 1)
    defs = model_param_defs(cfg, ec)
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0), torch.float32)
    print(f"{cfg.name}: {count_params(defs)/1e6:.2f}M params on {dev}")
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=20), seq_chunk=32, block_q=32, block_k=32)
    step_fn, _ = make_train_step(cfg, ec, params, tcfg)
    opt = init_opt_state(params, tcfg)
    ds = SyntheticDataset(cfg, batch=8, seq=64)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir)

    def log(step, m):
        if step % 20 == 0:
            print(f"step {step:4d} loss {float(m['loss']):.4f}")

    state = train_loop(step_fn, params, opt, ds, loop, on_step=log)
    first = np.mean(state.losses[:10])
    last = np.mean(state.losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} over {state.step} steps "
          f"(mean step {np.mean(state.step_times[3:]):.3f}s)")
    if not last < first:
        raise RuntimeError(f"loss did not decrease: {first:.4f} -> {last:.4f}")
    return state


if __name__ == "__main__":
    main()
