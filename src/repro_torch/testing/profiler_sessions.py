"""How often a torch.profiler session on the card comes back with no device
time, and how many sessions in a row a retry has to wait.

chip_smoke.py checks that one call of a kernel's wrapper launches one
kernel by counting the kernels of one call under torch.profiler, and
retries a session that saw no device time. This script measures what that
retry has to cover: it profiles one ``tp_shard_matmul`` call per session
(f32 and bf16, M 8 and 128, a whole weight and a TP 8 shard, as in the
Mamba projections' check), and on an empty session retries as chip_smoke
does, recording after how many attempts the kernel was seen and whether
the empty session's host events held an "Activity Buffer Request".

    PYTHONPATH=src python -m repro_torch.testing.profiler_sessions --rounds 120

Needs a CUDA device; prints one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

# (mode, stored K, stored N) at mamba2-2.7b's and jamba-v0.1-52b's widths
SHAPES = (("col", 2560, 5120), ("col", 2560, 80), ("row", 5120, 2560), ("col", 4096, 8192), ("row", 8192, 16))


def device_kernels(prof) -> dict:
    return {e.key[:60]: e.count for e in prof.key_averages()
            if (getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)) > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--attempts", type=int, default=12)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    _build.build_all()
    dev = torch.device("cuda", 0)
    cases = []
    for mode, k_store, n_store in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(k_store, n_store, device=dev).to(dtype)
            for m in (8, 128):
                for tp in (1, 8):
                    k, n, off = ((k_store, n_store // tp, n_store // tp) if mode == "col"
                                 else (k_store // tp, n_store, k_store // tp))
                    x = torch.randn(m, k, device=dev).to(dtype)
                    cases.append(lambda x=x, w=w, off=off if tp > 1 else 0, n=n, mode=mode:
                                 tp_shard_matmul(x, w, off, n_out=n, mode=mode))
    stats = collections.Counter()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        for fn in cases:
            fn()
            torch.cuda.synchronize()
            for attempt in range(args.attempts):
                if attempt:
                    time.sleep(0.01 * attempt)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                stats["sessions"] += 1
                kernels = device_kernels(prof)
                if kernels:
                    stats[f"seen_at_attempt_{attempt + 1}"] += 1
                    stats["not_one_kernel"] += sum(kernels.values()) != 1
                    break
                stats["empty"] += 1
                stats["empty_with_buffer_request"] += any("Activity Buffer Request" in e.name for e in prof.events())
            else:
                stats["never_seen"] += 1
    print(json.dumps({"card": torch.cuda.get_device_name(0), "calls": args.rounds * len(cases),
                      "seconds": time.perf_counter() - t0, **dict(sorted(stats.items()))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
