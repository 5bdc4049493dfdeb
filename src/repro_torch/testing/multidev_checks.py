"""The reference's multi-device checks that the port runs on one device
(mirrors repro/testing/multidev_checks.py).

check_train_step: a (data 2 x model 2) train step with ZeRO-1 moments
    equals a single-rank step over 5 steps of reduced h2o-danube-1.8b, at
    the reference's tolerances (losses within 2e-4 relative, params at
    rtol 5e-3, atol 5e-4). The two data groups run one after another and
    the two TP ranks read their shards of the same tensors.

    PYTHONPATH=src python -m repro_torch.testing.multidev_checks train_step [cpu|cuda]
"""
from __future__ import annotations

import sys

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import init_params, tree_leaves_with_path, tree_map
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)


def check_train_step(device=None, steps: int = 5) -> dict:
    """Sharded (data x model) train step == single-rank train step, with
    ZeRO-1 sharded optimizer state and f32 numerics. Returns the losses and
    the worst parameter difference; raises if a tolerance is missed."""
    dev = resolve_device(device)
    cfg = reduced(get_config("h2o-danube-1.8b"))
    ec1 = make_exec_config(cfg, 1)
    params0 = init_params(model_param_defs(cfg, ec1), torch.Generator(dev).manual_seed(0), torch.float32)
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=1e-3), seq_chunk=16, block_q=16, block_k=16)
    ds = SyntheticDataset(cfg, batch=4, seq=32)

    def run(ec, dp):
        p = tree_map(lambda t: t.detach().clone(), params0)
        step, plan = make_train_step(cfg, ec, p, tcfg, dp=dp)
        o = init_opt_state(p, tcfg, plan if dp > 1 else None)
        losses = [float(step(p, o, ds.at(i))[2]["loss"]) for i in range(steps)]
        return p, losses, plan

    ref_params, losses_ref, _ = run(ec1, 1)
    # exec kv == canonical (kv=2 >= tp=2) so the params carry over directly
    params, losses_sh, plan = run(make_exec_config(cfg, 2), 2)
    for a, b in zip(losses_ref, losses_sh):
        if not abs(a - b) / abs(a) < LOSS_RTOL:
            raise AssertionError(f"train_step: losses differ: {losses_ref} vs {losses_sh}")
    worst = 0.0
    for (path, a), (_, b) in zip(tree_leaves_with_path(ref_params), tree_leaves_with_path(params)):
        a, b = a.detach().double(), b.detach().double()
        if not torch.allclose(a, b, **PARAM_TOL):
            raise AssertionError(f"train_step: {'/'.join(path)} differs by {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    split = sum(d is not None for d in plan.dims.values())
    return {"losses_single": losses_ref, "losses_sharded": losses_sh, "max_param_diff": worst,
            "zero1_split_leaves": split, "leaves": len(plan.dims)}


CHECKS = {"train_step": check_train_step}


def main() -> None:
    out = CHECKS[sys.argv[1]](sys.argv[2] if len(sys.argv) > 2 else None)
    print(f"OK {sys.argv[1]}: {out}")


if __name__ == "__main__":
    main()
