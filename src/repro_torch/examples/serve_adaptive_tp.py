"""End-to-end serving example: the paper's system, live (mirrors
examples/serve_adaptive_tp.py).

    PYTHONPATH=src python -m repro_torch.examples.serve_adaptive_tp [--device cpu]

Boots the engine with the tiny demo model at TP 1/2/4 on one card, serves
a bursty two-tier request stream with continuous batching, switches TP on
a schedule (high TP in the burst, low TP for the tail), and prints the
switch costs and each tier's p50 TTFT and TPOT. On the card those are the
card's own latencies on the host clock, printed with its name.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.goodput import GoodputMeter, RequestRecord, SLOTier
from repro_torch.device import resolve_device
from repro_torch.launch.serve import DEMO
from repro_torch.models import init_params, model_param_defs
from repro_torch.parallel.sharding import make_exec_config
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.request import Request

SCHEDULE = {5: 2, 15: 4, 35: 2, 60: 1}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = DEMO
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=dev).manual_seed(0),
                         torch.float32)
    econf = EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=160, prefill_buckets=(16, 32, 64))
    eng = ServingEngine(cfg, params, econf=econf, device=dev)
    print(f"warming {tuple(econf.candidate_tps)} executables (offline, one-time)...")
    print(f"  capture: {eng.warmup():.1f}s")

    rng = np.random.RandomState(0)
    # bursty stream: interactive (strict) + background (relaxed)
    reqs = []
    for i in range(30):
        tier = "strict" if rng.rand() < 0.5 else "relaxed"
        plen = rng.randint(4, 60)
        reqs.append(Request(i, tier, rng.randint(0, 512, plen).astype(np.int32),
                            max_new_tokens=16 + 8 * (tier == "relaxed")))

    t0 = time.perf_counter()
    done = eng.run(reqs, switch_schedule=SCHEDULE)
    wall = time.perf_counter() - t0

    tiers = {"strict": SLOTier("strict", 1e9, 1e9), "relaxed": SLOTier("relaxed", 1e9, 1e9)}
    meter = GoodputMeter(tiers)
    for r in done:
        meter.add(RequestRecord(r.req_id, r.tier, r.arrival_s, r.prompt_len, len(r.generated), r.first_token_s,
                                r.finish_s, len(r.generated)))
    st = eng.stats
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print(f"served {len(done)}/{len(reqs)} requests in {wall:.1f}s ({st.steps} decode iterations)")
    print(f"TP switches: {st.switches}; avg rebind "
          f"{st.rebind_s / max(st.switches, 1) * 1e3:.2f} ms (zero-copy), avg migrate "
          f"{st.migrate_s / max(st.switches, 1) * 1e3:.1f} ms (stop-and-migrate)")
    lat = {t: meter.latency_percentiles(t) for t in ("strict", "relaxed")}
    for t, q in lat.items():
        if q:
            print(f"  {t}: ttft_p50 {q.get('ttft_ms_p50', 0):.1f}ms "
                  f"tpot_p50 {q.get('tpot_ms_p50', 0):.2f}ms ({where} wall-clock)")
    print("adaptive-TP serving demo done")
    return {"served": len(done), "switches": st.switches, "steps": st.steps, "latency": lat, "device": where}


if __name__ == "__main__":
    main()
