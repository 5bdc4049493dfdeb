"""Serving launcher: the adaptive-TP engine on one card (mirrors
repro/launch/serve.py).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --devices 8 --tps 1,2,4 --requests 24 [--switch-every 6] [--max-new 24]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --dtype bfloat16 --tps 1,2,4,8 [--layers 4] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --nproc 4 [--arch ...] [--device cpu]

Runs the engine (continuous batching, zero-copy TP switching, KV
migration, one CUDA graph per TP level and stage) with the reference's
tiny ``serve-demo`` model, or with a registered model at full width
(``--arch``; ``--layers`` cuts its depth), on requests drawn as the
reference draws them and a TP switch every ``--switch-every`` decode steps.
Weights are random, drawn from a seeded ``torch.Generator`` on the device
with the reference's scale rule.

``--devices N`` is the reference's pool of N devices, which runs TP t on a
(data = N/t, model = t) mesh and drops the TP levels above N. The port
keeps that filter. On one card every rank is the card, and the engine's
pool is the largest TP level kept, not N: a dense model's tokens do not
depend on N, an MoE model's dispatch path and capacity (which follow the
data groups of N/t ranks) follow the pool.

``--nproc N`` serves across N cards instead, one process each, joined by
NCCL (gloo with ``--device cpu``): every process draws the same weights on
its card and runs the same engine (``ServingEngine(pool=...)``), over the
TP levels that divide N. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import init_params, tree_leaves_with_path
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

DEMO = ModelConfig(
    name="serve-demo", family="dense", num_layers=4, d_model=128,
    num_heads=8, num_kv_heads=8, head_dim=16, d_ff=256, vocab_size=512,
    attn=AttnSpec(kind="full"),
)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--tps", default="1,2,4")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--switch-every", type=int, default=8,
                    help="decode steps between TP switches (demo schedule)")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--arch", default=None, help="a registered model at full width (default: serve-demo)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--layers", type=int, default=None, help="cut the model's depth")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--nproc", type=int, default=1,
                    help="serve across N cards, one process each (NCCL; gloo with --device cpu)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[ModelConfig, dict]:
    """The model's config and its random weights on the device."""
    cfg = get_config(args.arch) if args.arch else DEMO
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), gen, DTYPES[args.dtype])
    return cfg, params


def make_requests(cfg: ModelConfig, n: int, max_new: int) -> List[Request]:
    """The reference launcher's requests: a third relaxed, prompts of 4-59 tokens."""
    rng = np.random.RandomState(0)
    return [
        Request(
            i, "strict" if i % 3 else "relaxed",
            rng.randint(0, cfg.vocab_size, size=rng.randint(4, 60)).astype(np.int32),
            max_new,
        )
        for i in range(n)
    ]


def switch_schedule(tps: Sequence[int], every: int) -> dict:
    """{decode step: TP}: a switch every ``every`` steps, round the levels."""
    schedule = {}
    if every:
        for i, step in enumerate(range(every, 10_000, every)):
            schedule[step] = tps[(i + 1) % len(tps)]
    return schedule


def serve(cfg: ModelConfig, params: dict, args: argparse.Namespace, *, record_logits: bool = False,
          pool=None):
    """Serve the launcher's requests; returns (finished requests, stats):
    the engine's counts and seconds, "final_tp", "warmup_s", "seconds" and,
    with ``record_logits``, "logits" ({request: per-step logits}). With a
    ``pool`` this process is one rank of the engine across processes."""
    tps = tuple(int(t) for t in args.tps.split(","))
    dtype = next(t for _, t in tree_leaves_with_path(params)).dtype
    econf = EngineConfig(
        candidate_tps=[t for t in tps if t <= args.devices], n_slots=8, max_len=128,
        prefill_buckets=(16, 32, 64), dtype=dtype, record_logits=record_logits,
    )
    eng = ServingEngine(cfg, params, econf=econf, device=args.device, pool=pool)
    warm = eng.warmup()
    reqs = make_requests(cfg, args.requests, args.max_new)
    t0 = time.perf_counter()
    done = eng.run(reqs, switch_schedule=switch_schedule([t for t in tps if t in eng.tps], args.switch_every))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    st = eng.stats
    stats = {"switches": st.switches, "steps": st.steps, "rebind_s": st.rebind_s, "migrate_s": st.migrate_s,
             "final_tp": eng.tp, "tps": list(eng.tps), "warmup_s": warm, "seconds": time.perf_counter() - t0}
    if record_logits:
        stats["logits"] = eng.logit_trace
    return done, stats


def serve_rank(pool, inputs: dict) -> dict:
    """One rank of ``--nproc``: the launcher's model on this process's card,
    served by the engine across the pool."""
    args = argparse.Namespace(**{**inputs, "device": str(pool.device)})
    cfg, params = build(args)
    done, st = serve(cfg, params, args, pool=pool)
    return {"done": len(done), "stats": st, "cfg": cfg.name, "layers": cfg.num_layers,
            "where": torch.cuda.get_device_name(pool.device) if pool.device.type == "cuda" else "the CPU"}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.nproc > 1:
        from repro_torch.testing.multidev_checks import spawn

        kind = "cpu" if args.device is not None and torch.device(args.device).type == "cpu" else "cuda"
        rank0 = spawn(args.nproc, kind, task="repro_torch.launch.serve:serve_rank", inputs=vars(args),
                      timeout=3600)[0]["repro_torch.launch.serve:serve_rank"]
        st = rank0["stats"]
        print(f"{rank0['cfg']} ({rank0['layers']} layers, {args.dtype}) on {args.nproc} x {rank0['where']}, "
              f"one process each")
        _report(st, len(st["tps"]), rank0["done"])
        return 0
    cfg, params = build(args)
    done, st = serve(cfg, params, args)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"{cfg.name} ({cfg.num_layers} layers, {args.dtype}) on {where}")
    _report(st, len(st["tps"]), len(done))
    return 0


def _report(st: dict, n_levels: int, n_done: int) -> None:
    sw = max(st["switches"], 1)
    print(f"warmed {n_levels} TP levels (prefill+decode executables) in {st['warmup_s']:.1f}s — "
          f"offline CUDA-graph capture")
    print(f"served {n_done} requests in {st['seconds']:.1f}s across {st['switches']} TP switches")
    print(f"  switch cost: rebind {st['rebind_s'] * 1e3 / sw:.2f} ms avg (zero-copy), "
          f"migrate {st['migrate_s'] * 1e3 / sw:.1f} ms avg")
    print(f"  decode steps: {st['steps']}; final TP {st['final_tp']}")


if __name__ == "__main__":
    raise SystemExit(main())
