"""Dry run: count one device's share of every (architecture x input shape)
cell on the production mesh (mirrors repro/launch/dryrun.py).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch chameleon-34b] [--shape train_4k] [--multi-pod] \
        [--rules default] [--out build/dryrun_results]

With no filters it sweeps the 10x4 grid (minus the long_500k cells that
need sub-quadratic attention) on the single-pod 16x16 mesh; --multi-pod
switches to the 2x16x16 = 512-chip mesh.

This is not XLA's analysis. The reference lowers and compiles each cell
and reads XLA's memory and cost analyses and the per-device HLO. The port
runs one TP group's step (t = 16 ranks in one program, as the engine runs
them) on ``meta`` tensors, which allocate nothing and launch nothing, and
counts what it does (``launch.op_cost``): operations, the HBM proxy and
collectives, each divided by t, and the H100 roofline terms they give.
Each cell's JSON keeps the reference's keys where they mean the same, with
``count_s`` (the seconds the count took on the host) in place of
``compile_s``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Sequence

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import op_cost
from repro_torch.launch.cells import build_step
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.rules_presets import resolve_rules

DEFAULT_OUT = "build/dryrun_results"
MEMORY_NOTE = ("temp_bytes and peak_bytes_estimate are left out: the count does not track when a meta "
               "tensor is freed, and an eager program's peak depends on the caching allocator")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Optional[str],
             rules_name: str = "default", log=print) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_chips(mesh)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.perf_counter()
    rules = resolve_rules(rules_name, arch, shape_name)
    step, specs, rules = build_step(arch, shape_name, mesh, rules)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, cost = op_cost.count(step, devices=step.devices, gathered=step.gathered,
                              gather_needs_grad=step.kind == "train")
    t_count = time.perf_counter() - t0
    roof = op_cost.roofline(cost)
    info = {
        "roofline": roof.as_dict(),
        "collectives": {"bytes_by_kind": cost.collective_bytes_by_kind,
                        "count_by_kind": cost.collective_count_by_kind},
        "memory": {"argument_bytes": op_cost.tensor_bytes(specs), "output_bytes": step.output_bytes(out),
                   "note": MEMORY_NOTE},
        "chips": chips,
        "tp_group": step.devices,
        "ops_counted": cost.ops,
        "notes": step.notes,
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "rules": rules_name,
        "build_s": round(t_build, 2), "count_s": round(t_count, 2), "ok": True,
    }
    log(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({rules_name}): counted {cost.ops} ops in {t_count:.1f}s")
    log(f"  per device: flops={cost.dot_flops:.3e} hbm_bytes={cost.hbm_bytes:.3e} "
        f"collective_bytes={cost.collective_bytes:.3e} {dict(cost.collective_count_by_kind)}")
    log(f"  roofline (H100): compute={roof.compute_s:.4f}s memory={roof.memory_s:.4f}s "
        f"collective={roof.collective_s:.4f}s (published link figures, not measured) dominant={roof.dominant}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}__{mesh_name}__{rules_name}.json"
        with open(os.path.join(out_dir, tag), "w") as f:
            json.dump(info, f, indent=1)
    return info


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="default")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            if not shape_applicable(cfg, SHAPES[shape_name]):
                print(f"[dryrun] SKIP {arch} x {shape_name} (long_500k needs sub-quadratic attention)")
                continue
            try:
                run_cell(arch, shape_name, args.multi_pod, args.out, args.rules)
            except Exception as e:  # noqa: BLE001 - one failed cell must not stop the sweep
                failures.append((arch, shape_name, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape_name}: {e}")
                traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("[dryrun] all cells counted OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
