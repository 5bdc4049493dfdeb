"""The engine across cards at full width: one process per card, joined by NCCL.

    PYTHONPATH=src python -m repro_torch.testing.multicard [--nproc 4] [--layers N] [--only LEGS] [--skip LEGS]
        [--out FILE]

Spawns ``--nproc`` processes (``multidev_checks.spawn``; the kernels are
built once, first) and runs, on every rank together, these legs (all by
default; ``--only`` / ``--skip`` take comma-separated names):

  f32  llama3-8b (``--layers`` cuts its depth): the one-card engine (one
       process, TP 1, 8 slots, on card 0) serves 10 requests of 24 tokens;
       the pool serves them at fixed TP 1, 2 and 4 and under the switch
       schedule {3: 2, 7: 4, 13: 1, 19: 2}; checked, as phase 4 checks its
       engine: greedy tokens identical at every fixed level, under the
       schedule and on one card (at a flip, the one-card top-2 logit margin
       is printed), no storage data_ptr moved on any card, every kernel
       launch by a graph replay. The logits: at TP t each card decodes
       8/(4/t) slots, and torch's row reductions (the norms') and the TP
       split's sums round differently at another batch or split, so the
       one-card engine also serves the requests at (TP t, 8/(4/t) slots)
       and at (TP 1, 2 and 4 slots), which reproduce each cause on one card
       without a collective. Held: the pool's TP t logits within 2e-4 of
       the one-card engine at its own (TP t, per-card batch); that engine's
       distance from the one-card TP 1 logits is reported;
  bf16 llama3-8b, 8 slots, max_len 2048: TTFT per bucket (32/64/128) and
       the decode step per TP level on the host clock (medians of repeats),
       one decode replay's device ms (CUDA events) and the host ms around
       it, the NCCL kernels' share of a decode step's device time (rank 0,
       torch.profiler), and the switch's cost: the binding lookup (rebind),
       and the cache reshard's bytes between cards, ms and GB/s;
  pages migrate_pages from card 0 to card 1 at llama3-8b's page geometry,
       16 sequences of 256 and 2048 tokens (0.537 and 4.295 GB): pages bit
       for bit, 2 gathers on card 0 and 2 scatters on card 1 per call, ms
       and GB/s (NVLink's published 450 GB/s each way beside them);
  moe  moonshot-v1-16b-a3b's MoE layer at full width on a (data 2, model 2)
       mesh, the real all-to-all, against ``moe_apply_local``
       (``check_moe_sharded``: y within 5e-4), at capacity factor 8 (nothing
       drops). The load-balancing loss is held to the port's one-process
       sharded loop over the same 8-token blocks (within 1e-4): the sharded
       path's lb is the mean of its blocks' estimates, ~20% from the local
       one, as the reference's own sharded path gives (the CPU test holds
       the port's to it);
  moonshot_f32, jamba_f32  moonshot-v1-16b-a3b at 4 layers and
       jamba-v0.1-52b at one period (8 layers, each layer's weights at its
       own fan-in) in f32 at capacity factor 8.0: 14 requests (six end
       early, so the switch run prefills at TP 2, 4 and 1), the f32 leg's
       checks on tokens, storage and launches; drops per (TP level, stage);
  moonshot_bf16, jamba_bf16  moonshot at its 48 layers and jamba at two
       periods (16 layers) in bf16 at the published capacity factor 1.25:
       the bf16 leg's timings (TTFT at 128 tokens), the drops per (TP level,
       stage), and the reshard's bytes of K/V and of the Mamba state.

Prints one JSON line per leg prefixed with the card's name and power
limit; writes everything to ``--out``, and each rank's legs so far to
``--out``.rank<r>.json after each leg (what is left if a later leg fails).
Exits non-zero if any check failed, after every leg has run.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import init_params, per_layer_fan_in, tree_leaves_with_path
from repro_torch.parallel.collectives import Pool, all_gather, checksums
from repro_torch.parallel.sharding import make_exec_config

SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}
LOGIT_TOL = 2e-4
NVLINK_GBPS_EACH_WAY = 450.0  # H100 SXM data sheet (published, not measured)
# the models whose weights take each layer's own fan-in (``weight_defs``)
PER_LAYER_FAN_IN = ("jamba-v0.1-52b",)
# an MoE model's f32 runs: 14 requests, of which the first 8 fill the slots and two each end after 5, 9 and
# 15 tokens, so that a switch run prefills requests 8-13 after its switches: the reference's prefill path and
# capacity change with the TP level
MOE_NEW_TOKENS = (5, 5, 9, 9, 15, 15) + (24,) * 8
# the full-width legs of moonshot-v1-16b-a3b and jamba-v0.1-52b: depth (80 GB a card, and time), f32 capacity
# factor (nothing drops, so tokens do not depend on the TP level's capacities) and bf16 (published)
FAMILY_LEGS = {"moonshot-v1-16b-a3b": {"f32_layers": 4, "bf16_layers": None},
               "jamba-v0.1-52b": {"f32_layers": 8, "bf16_layers": 16}}


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def requests(vocab: int, n: int = 10, new_tokens=24, prompts: Optional[List[np.ndarray]] = None):
    """Seeded prompts of 4 to 120 tokens (or the given ``prompts``), ``n``
    of them, or one per entry of ``new_tokens`` when it is a sequence."""
    from repro_torch.serving.request import Request

    counts = list(new_tokens) if isinstance(new_tokens, (list, tuple)) else [new_tokens] * n
    if prompts is None:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, vocab, size=rng.randint(4, 121)).astype(np.int32) for _ in counts]
    return [Request(i, "strict", np.asarray(p, np.int32), k) for i, (p, k) in enumerate(zip(prompts, counts))]


def _sync(pool: Pool) -> None:
    if pool.device.type == "cuda":
        torch.cuda.synchronize(pool.device)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _ptrs(eng) -> List[int]:
    return sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos if t is not None)


def model_cfg(inputs: dict):
    """``inputs["model"]`` (default llama3-8b) cut to ``inputs["layers"]``
    (None: all), an MoE model at ``inputs["capacity_factor"]`` if given."""
    cfg = get_config(inputs.get("model", "llama3-8b"))
    if inputs.get("layers") is not None:
        cfg = dataclasses.replace(cfg, num_layers=inputs["layers"])
    if cfg.moe is not None and inputs.get("capacity_factor") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=inputs["capacity_factor"]))
    return cfg


def weight_defs(cfg, own_fan_in: Optional[bool] = None) -> dict:
    """The parameter defs an engine's weights are drawn from. The
    reference's rule (``init_params``) fills an unset scale with
    1/sqrt(shape[0]), which for a leaf stacked over the pattern's periods is
    the number of periods: jamba at one or two periods (8 or 16 layers)
    then draws every projection at std 1 or 0.71, and its f32 activations
    overflow. For the models in PER_LAYER_FAN_IN (or with ``own_fan_in``)
    each stacked leaf takes the rule applied to its layer's own shape
    (``per_layer_fan_in``): 1/sqrt(fan-in) of the layer's weight."""
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    if not (cfg.name in PER_LAYER_FAN_IN if own_fan_in is None else own_fan_in):
        return defs
    return per_layer_fan_in(defs)


def _weights(cfg, dev, dtype):
    """Every rank draws the same weights from seed 0 on its own card."""
    return init_params(weight_defs(cfg), torch.Generator(device=dev).manual_seed(0), dtype)


def _new_tokens(cfg):
    return MOE_NEW_TOKENS if cfg.moe is not None else 24


def _counts() -> Dict[str, int]:
    from repro_torch.kernels import _build

    return {w.__name__: w.launches for w in _build.COUNTED}


def _reset_counts() -> None:
    from repro_torch.kernels import _build

    for w in _build.COUNTED:
        w.launches = 0


def serve_f32(pool: Pool, inputs: dict) -> dict:
    """The engine across the pool: ``model_cfg(inputs)`` (llama3-8b by
    default) in ``inputs["dtype"]`` (default f32), candidate TP levels
    ``inputs["tps"]`` (those the pool divides), the given prompts with
    ``inputs["new_tokens"]`` each (default 24; an MoE model's
    MOE_NEW_TOKENS), at the lowest level or under ``inputs["schedule"]``.
    Returns the trajectories, the launches of the run (counts set to 0 after
    the warm-up: every one by a graph replay), whether every storage
    data_ptr stayed, and an MoE model's drops per (TP level, stage)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg, dev = model_cfg(inputs), pool.device
    dtype = inputs.get("dtype", torch.float32)
    params = _weights(cfg, dev, dtype)
    econf = EngineConfig(candidate_tps=inputs.get("tps", (1, 2, 4, 8)), n_slots=8, max_len=256,
                         prefill_buckets=(32, 64, 128), dtype=dtype, record_logits=inputs.get("record_logits", False))
    eng = ServingEngine(cfg, params, econf, pool=pool)
    warm = eng.warmup()
    ptrs = _ptrs(eng)
    schedule = {k: v for k, v in (inputs.get("schedule") or {}).items() if v in eng.tps}
    _reset_counts()
    t0 = time.perf_counter()
    done = eng.run(requests(cfg.vocab_size, prompts=inputs.get("prompts"),
                            new_tokens=inputs.get("new_tokens", _new_tokens(cfg))), switch_schedule=schedule)
    _sync(pool)
    seconds = time.perf_counter() - t0
    launches = {k: n for k, n in _counts().items() if n}
    out = {"trajectories": {r.req_id: list(r.generated) for r in done}, "launches": launches,
           "replayed": eng.cache.replayed_launches(), "graphs": eng.cache.graphs(), "tps": eng.tps,
           "schedule": {str(k): v for k, v in schedule.items()}, "switches": eng.stats.switches,
           "steps": eng.stats.steps, "warmup_s": warm, "run_s": seconds, "ptrs_unchanged": _ptrs(eng) == ptrs,
           "backend": pool.backend, "world": pool.world, "rank": pool.rank, "model": cfg.name,
           "layers": cfg.num_layers, "moe_dropped": {f"{tp}/{st}": n for (tp, st), n in eng.moe_dropped().items()}}
    if econf.record_logits:
        out["logits"] = {k: np.stack(v) for k, v in eng.logit_trace.items()}
    del eng, params
    _free()
    return out


def serve_runs(pool: Pool, inputs: dict) -> dict:
    """``serve_f32`` for each of ``inputs["runs"]`` ({name: inputs}) in
    turn, in one pool (one spawn)."""
    return {name: serve_f32(pool, run) for name, run in inputs["runs"].items()}


def _flip(got: dict, want: dict, want_logits: dict) -> Optional[dict]:
    """The first token where ``got`` leaves ``want``, with the top-2 margin
    of the reference's logits there."""
    for rid, toks in want.items():
        for i, (a, b) in enumerate(zip(got[rid], toks)):
            if a != b:
                top = np.sort(want_logits[rid][i])[-2:]
                return {"request": rid, "step": i, "got": a, "want": b, "top2_margin": float(top[1] - top[0])}
    return None


def one_card(cfg, params, dev, tp: int, n_slots: int) -> dict:
    """The one-process engine on one card at fixed TP ``tp`` (its ranks one
    after another on the card) with ``n_slots`` slots: trajectories and f32
    logits of the leg's requests."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    econf = EngineConfig(candidate_tps=(tp,), n_slots=n_slots, max_len=256, prefill_buckets=(32, 64, 128),
                         dtype=torch.float32, record_logits=True)
    eng = ServingEngine(cfg, params, econf, device=dev)
    eng.warmup()
    done = eng.run(requests(cfg.vocab_size, new_tokens=_new_tokens(cfg)))
    out = {"trajectories": {r.req_id: list(r.generated) for r in done},
           "logits": {k: np.stack(v) for k, v in eng.logit_trace.items()},
           "moe_dropped": {f"{t}/{st}": n for (t, st), n in eng.moe_dropped().items()}}
    del eng
    _free()
    return out


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k] - b[k]).max()) for k in b)


def f32_check(pool: Pool, inputs: dict) -> dict:
    """f32: the pool's tokens at fixed TP 1/2/4 and under the switch
    schedule against the one-card engine's at TP 1 (``model_cfg(inputs)``).
    With ``inputs["isolate"]`` (llama3-8b) the logits too: the one-card
    engine also runs at each pool level's (TP t, per-card batch) and at TP
    1 with 2 and 4 slots; the pool's TP t logits are held within LOGIT_TOL
    of the one-card engine at its (TP t, per-card batch), and that engine's
    distance from the one-card TP 1 logits is reported."""
    cfg, dev = model_cfg(inputs), pool.device
    failures = []
    ref, iso = None, {}
    n_slots, tps = 8, [t for t in (1, 2, 4) if pool.world % t == 0]
    per_card = {t: n_slots * t // pool.world for t in tps}  # slots a card decodes at TP t
    if pool.rank == 0:  # the one-card port: every rank in this process, on card 0
        params = _weights(cfg, dev, torch.float32)
        ref = one_card(cfg, params, dev, 1, n_slots)
        if inputs.get("isolate"):
            configs = {(1, 2), (1, 4), (2, n_slots)} | {(t, per_card[t]) for t in tps}
            for tp, slots in sorted(configs - {(1, n_slots)}):
                iso[(tp, slots)] = one_card(cfg, params, dev, tp, slots)
        del params
        _free()
    pool.barrier()
    runs = {}
    for tp in tps:
        runs[f"fixed TP {tp}"] = serve_f32(pool, {**inputs, "tps": (tp,), "record_logits": True})
    runs["switch schedule"] = serve_f32(pool, {**inputs, "tps": tuple(tps), "schedule": SCHEDULE})
    out = {"model": cfg.name, "layers": cfg.num_layers, "tolerance": {"rtol": LOGIT_TOL, "atol": LOGIT_TOL}}
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
    for name, r in runs.items():
        rec = {k: r[k] for k in ("tps", "schedule", "switches", "steps", "warmup_s", "run_s", "launches",
                                 "ptrs_unchanged", "graphs", "moe_dropped")}
        if r["launches"] != r["replayed"]:
            failures.append(f"{name}: launches {r['launches']} != graph replays {r['replayed']}")
        if not r["ptrs_unchanged"]:
            failures.append(f"{name}: a storage data_ptr moved on rank {pool.rank}")
        if ref is not None:
            rec["tokens_equal_one_card"] = r["trajectories"] == ref["trajectories"]
            if not rec["tokens_equal_one_card"]:
                rec["first_flip"] = _flip(r["trajectories"], ref["trajectories"], ref["logits"])
            if "logits" in r:
                rec.update(max_abs_logit_diff=_max_diff(r["logits"], ref["logits"]),
                           max_abs_logit=max(float(np.abs(v).max()) for v in ref["logits"].values()),
                           max_abs_logit_diff_prefill=max(float(np.abs(r["logits"][k][0] - ref["logits"][k][0]).max())
                                                          for k in ref["logits"]))
            tp = r["tps"][0]
            if "logits" in r and (tp, per_card[tp]) in iso:
                same = iso[(tp, per_card[tp])]  # the one-card engine at this level's TP and per-card batch
                collectives = _max_diff(r["logits"], same["logits"])
                cause = _max_diff(same["logits"], ref["logits"])
                rec.update(one_card_at_same_tp_and_batch={"tp": tp, "slots": per_card[tp]},
                           max_abs_logit_diff_vs_same_tp_and_batch=collectives,
                           one_card_same_tp_and_batch_vs_tp1=cause)
                if collectives > LOGIT_TOL:
                    failures.append(f"{name}: logits {collectives} from the one-card engine at TP {tp}, "
                                    f"{per_card[tp]} slots (tolerance {LOGIT_TOL})")
        out[name] = rec
    if ref is not None:
        for name in runs:
            if not out[name]["tokens_equal_one_card"]:
                failures.append(f"{name}: tokens differ from the one-card engine: {out[name].get('first_flip')}")
        if runs["switch schedule"]["trajectories"] != runs["fixed TP 1"]["trajectories"]:
            failures.append("the switch schedule's tokens differ from fixed TP 1")
        out["first_tokens"] = ref["trajectories"][0]
        if iso:  # the one-card experiment: each (TP, slots) against (TP 1, 8 slots)
            out["one_card"] = {f"TP {tp}, {slots} slots": {
                "max_abs_logit_diff_vs_tp1_8_slots": _max_diff(r["logits"], ref["logits"]),
                "max_abs_logit_diff_prefill": max(float(np.abs(r["logits"][k][0] - ref["logits"][k][0]).max())
                                                  for k in ref["logits"]),
                "tokens_equal": r["trajectories"] == ref["trajectories"]} for (tp, slots), r in sorted(iso.items())}
    out["failures"] = failures
    return out


def llama_f32(pool: Pool, inputs: dict) -> dict:
    out = f32_check(pool, {**inputs, "isolate": True})
    if pool.rank == 0:
        out["rmsnorm_max_diff_by_rows_of_8"] = rms_batch_variance(pool.device)
    return out


def family_f32(pool: Pool, inputs: dict, name: str) -> dict:
    """moonshot or jamba in f32 at FAMILY_LEGS' depth and capacity factor
    8.0: tokens against one card, storage and launches."""
    return f32_check(pool, {**inputs, "model": name, "layers": FAMILY_LEGS[name]["f32_layers"],
                            "capacity_factor": 8.0})


def rms_batch_variance(dev) -> dict:
    """The norm's mean of squares over a row of 4096 on rows of 2, 4 and 8
    at once: whether the row's result depends on how many rows share the
    call (torch picks its reduction's split from the shape)."""
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 4096), generator=g, device=dev) * 20
    scale = torch.randn((4096,), generator=g, device=dev) * 0.1
    whole = rmsnorm(x, scale, 1e-5)
    return {str(n): float((rmsnorm(x[:n], scale, 1e-5) - whole[:n]).abs().max()) for n in (1, 2, 4)}


def _event_ms(fn, iters: int = 5) -> float:
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _nccl_share(pool: Pool, step, n: int = 6, warm: int = 2) -> dict:
    """Device ms of ``n`` calls of ``step`` under torch.profiler, split into
    the NCCL kernels and the rest (every rank profiles; each reports its
    own). ``warm`` calls inside the profiler are left out of the window, so
    the ranks' skew at the profiler's start is not counted; within the
    window an NCCL kernel's time is its transfer and its wait for the other
    ranks to arrive, as in serving."""
    from torch.profiler import ProfilerActivity, profile, schedule

    step()
    _sync(pool)
    pool.barrier()
    # one cycle, its events kept (without acc_events a finished cycle's
    # events are cleared, and key_averages() comes back empty)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=n, repeat=1), acc_events=True) as prof:
        for _ in range(warm + n):
            step()
            _sync(pool)
            prof.step()
    total = nccl = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if us <= 0:
            continue
        total += us
        if "nccl" in ev.key.lower():
            nccl += us
    if total == 0:
        return {"measured": False}
    return {"measured": True, "device_ms_per_step": total / 1e3 / n, "nccl_ms_per_step": nccl / 1e3 / n,
            "nccl_share": nccl / total}


def bf16_timings(pool: Pool, inputs: dict) -> dict:
    """bf16 timings per TP level and the switch's cost, of
    ``model_cfg(inputs)`` (llama3-8b by default): TTFT at
    ``inputs["ttft_buckets"]`` (default every bucket), an MoE model's drops
    per (TP level, stage), and the reshard's bytes of K/V and of a Mamba
    state apart."""
    from repro_torch.core.migration import cache_shardings, moved_bytes
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    cfg, dev = model_cfg(inputs), pool.device
    params = _weights(cfg, dev, torch.bfloat16)
    tps = [t for t in (1, 2, 4) if pool.world % t == 0]
    econf = EngineConfig(candidate_tps=tps, n_slots=8, max_len=2048, prefill_buckets=(32, 64, 128),
                         dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, econf, pool=pool)
    warm = eng.warmup()
    rng = np.random.RandomState(3)
    out = {"model": cfg.name, "layers": cfg.num_layers, "warmup_s": warm, "ttft_ms": {}, "decode_ms": {},
           "replay_device_ms": {}, "host_ms_around_replay": {}, "nccl": {}, "switch": []}
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
    rid = 1000

    def prompt(n):
        return rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)

    for tp in tps:  # TTFT: one prompt of each bucket's length into a free slot, on the host clock
        eng.switch_tp(tp)
        out["ttft_ms"][str(tp)] = {}
        for L in inputs.get("ttft_buckets", econf.prefill_buckets):
            times = []
            for rep in range(6):
                rid += 1
                req = Request(rid, "strict", prompt(L), 1)
                _sync(pool)
                t0 = time.perf_counter()
                eng.admit(req)
                times.append((time.perf_counter() - t0) * 1e3)
                eng.slot_req[req.slot] = None
                eng.slots.release(req.slot)
            out["ttft_ms"][str(tp)][str(L)] = {"median": statistics.median(times[1:]), "min": min(times[1:]),
                                               "max": max(times[1:]), "n": len(times) - 1}
    eng.switch_tp(tps[0])
    for i in range(econf.n_slots):  # every slot busy through the decode timings
        rid += 1
        eng.admit(Request(rid, "strict", prompt(64), 10_000))
    exe_tokens = lambda: torch.from_numpy(eng.next_tokens).view(-1, 1)  # noqa: E731
    for tp in tps:
        eng.switch_tp(tp)
        eng.step()
        rounds = []
        for _ in range(3):
            _sync(pool)
            t0 = time.perf_counter()
            for _ in range(6):
                eng.step()
            rounds.append((time.perf_counter() - t0) * 1e3 / 6)
        out["decode_ms"][str(tp)] = {"median": statistics.median(rounds), "min": min(rounds), "max": max(rounds),
                                     "n": len(rounds)}
        exe = eng.cache.get(tp, "decode")
        positions = torch.from_numpy(eng.slots.lengths.copy())
        dev_ms = _event_ms(lambda: exe(exe_tokens(), positions))
        out["replay_device_ms"][str(tp)] = dev_ms
        out["host_ms_around_replay"][str(tp)] = out["decode_ms"][str(tp)]["median"] - dev_ms
        out["nccl"][str(tp)] = _nccl_share(pool, lambda: exe(exe_tokens(), positions))
    defs = eng.slots.cache_defs()
    state = [{k: d for k, d in layer.items() if k not in ("k", "v")} for layer in defs]  # a Mamba layer's
    for a, b in zip([tps[-1]] + tps[:-1], tps):  # every level to the next, round to the first
        if a == b:
            continue
        eng.switch_tp(a)
        info = eng.switch_tp(b)
        moved = moved_bytes(cache_shardings(defs, pool.world, a), cache_shardings(defs, pool.world, b), 2)
        rec = {"from": a, "to": b, "rebind_ms": info["rebind_s"] * 1e3, "reshard_ms": info["migrate_s"] * 1e3,
               "bytes_between_cards": moved,
               "cache_bytes": sum(2 * int(np.prod(d.shape)) for layer in defs for d in layer.values()),
               "gb_per_s": moved / info["migrate_s"] / 1e9}
        if any(state):
            rec["state_bytes_between_cards"] = moved_bytes(cache_shardings(state, pool.world, a),
                                                           cache_shardings(state, pool.world, b), 2)
            rec["state_bytes"] = sum(2 * int(np.prod(d.shape)) for layer in state for d in layer.values())
        out["switch"].append(rec)
    out["bind_s"] = {str(t): s for t, s in eng.ctl.bind_s.items()}
    if cfg.moe is not None:
        out["moe_dropped"] = {f"{tp}/{st}": n for (tp, st), n in eng.moe_dropped().items()}
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del eng, params
    _free()
    return out


def family_bf16(pool: Pool, inputs: dict, name: str) -> dict:
    """moonshot or jamba in bf16 at FAMILY_LEGS' depth and the published
    capacity factor, TTFT at 128 tokens."""
    return bf16_timings(pool, {**inputs, "model": name, "layers": FAMILY_LEGS[name]["bf16_layers"],
                               "ttft_buckets": (128,)})


def pages(pool: Pool, inputs: dict) -> dict:
    """migrate_pages from card 0's pool to card 1's at two payloads."""
    from repro_torch.core.migration import migrate_pages
    from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
    from repro_torch.serving.kv_cache import PagedPool

    cfg = model_cfg(inputs)
    src_rank, dst_rank = 0, 1
    out, failures = {}, []
    page, n_seqs = 16, 16
    for ctx in (256, 2048):
        need = n_seqs * ctx // page

        def make(owner):
            return PagedPool(num_pages=need * 9 // 8, page_size=page, kv_heads=cfg.num_kv_heads,
                             head_dim=cfg.head_dim, n_layers=cfg.num_layers, dtype=torch.bfloat16,
                             device=pool.device if pool.rank == owner else "meta")

        src, dst = make(src_rank), make(dst_rank)
        for s in range(n_seqs):  # phase 3's fragmentation: grown a page at a time, interleaved
            src.alloc_seq(s, page)
        for _ in range(ctx // page - 1):
            for s in range(n_seqs):
                src.extend_seq(s, page)

        def fill(p):
            g = torch.Generator(device=pool.device).manual_seed(10 + ctx)
            p.k_pages.normal_(generator=g)
            p.v_pages.normal_(generator=g)

        if pool.rank == src_rank:
            fill(src)
        seqs = list(range(n_seqs))
        row_bytes = page * cfg.num_kv_heads * cfg.head_dim * 2
        moved = 2 * cfg.num_layers * n_seqs * (ctx // page) * row_bytes
        rec = {"gb": moved / 1e9, "pages_per_layer": need, "fragmentation": src.fragmentation(), "ms": []}
        if pool.rank in (src_rank, dst_rank):
            for rep in range(4):
                g0, s0 = kv_gather.launches, kv_scatter.launches
                tables, seconds = migrate_pages(src, dst, seqs, ranks=(src_rank, dst_rank))
                rec["launches"] = {"kv_gather": kv_gather.launches - g0, "kv_scatter": kv_scatter.launches - s0}
                if rep == 0 and pool.rank == dst_rank:  # the moved pages against the source's, made again here
                    want = make(dst_rank)
                    fill(want)
                    same = all(torch.equal(dst.k_pages[:, b], want.k_pages[:, a]) and
                               torch.equal(dst.v_pages[:, b], want.v_pages[:, a])
                               for s, row in zip(seqs, tables) for a, b in zip(src.tables[s], row))
                    rec["bit_identical"] = same
                    if not same:
                        failures.append(f"ctx {ctx}: pages differ after migrate_pages between cards")
                    del want
                    _free()
                if rep:  # the first call makes the pair's communicator
                    rec["ms"].append(seconds * 1e3)
                for s in seqs:
                    dst.release_seq(s)
            want_launches = {"kv_gather": 2 if pool.rank == src_rank else 0,
                             "kv_scatter": 2 if pool.rank == dst_rank else 0}
            if rec["launches"] != want_launches:
                failures.append(f"ctx {ctx} rank {pool.rank}: launches {rec['launches']} != {want_launches}")
            rec["median_ms"] = statistics.median(rec["ms"])
            rec["gb_per_s"] = moved / (rec["median_ms"] / 1e3) / 1e9
            rec["nvlink_published_gb_per_s_each_way"] = NVLINK_GBPS_EACH_WAY
        out[str(ctx)] = rec
        del src, dst
        _free()
        pool.barrier()
    out["failures"] = failures
    return out


def moe(pool: Pool, inputs: dict) -> dict:
    from repro_torch.testing.multidev_checks import check_moe_sharded

    try:
        return {**check_moe_sharded(pool, {"full_width": MOON, "moe": {"capacity_factor": 8.0},
                                           "lb_held_to": "sharded loop"})["summary"],
                "capacity_factor": 8.0, "failures": []}
    except AssertionError as e:
        return {"failures": [f"moe: {e}"]}


MOON, JAMBA = "moonshot-v1-16b-a3b", "jamba-v0.1-52b"
LEGS = {"f32": llama_f32, "bf16": bf16_timings, "pages": pages, "moe": moe,
        "moonshot_f32": lambda pool, inputs: family_f32(pool, inputs, MOON),
        "jamba_f32": lambda pool, inputs: family_f32(pool, inputs, JAMBA),
        "moonshot_bf16": lambda pool, inputs: family_bf16(pool, inputs, MOON),
        "jamba_bf16": lambda pool, inputs: family_bf16(pool, inputs, JAMBA)}


def legs(pool: Pool, inputs: dict) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 products (MoE bmm, router) in full f32
    out = {"card": card_line() if pool.rank == 0 else None, "world": pool.world}
    mine = checksums({"x": torch.arange(3, device=pool.device)})  # a first collective on every group is done
    out["pool_ok"] = bool((all_gather(mine[None], pool.world_group) == mine).all())
    for name, fn in LEGS.items():
        if name in inputs.get("skip", ()) or (inputs.get("only") and name not in inputs["only"]):
            continue
        t0 = time.perf_counter()
        leg_inputs = {k: v for k, v in inputs.items() if k not in ("skip", "only")}
        if name in ("moonshot_f32", "jamba_f32", "moonshot_bf16", "jamba_bf16"):
            leg_inputs.pop("layers", None)  # FAMILY_LEGS' depth
        out[name] = fn(pool, leg_inputs)
        out[name]["wall_s"] = time.perf_counter() - t0
        if inputs.get("partial"):  # the legs so far, kept if a later one fails
            with open(f"{inputs['partial']}.rank{pool.rank}.json", "w") as f:
                json.dump(out, f, default=str)
        pool.barrier()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.testing.multidev_checks import spawn

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--layers", type=int, default=None, help="cut llama3-8b's depth (default: all 32)")
    ap.add_argument("--only", default="", help=f"the legs to run, of {','.join(LEGS)} (default: all)")
    ap.add_argument("--skip", default="", help="legs to leave out, e.g. bf16,pages")
    ap.add_argument("--out", default="chiprun_out/multicard.json")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    names = lambda arg: [s for s in arg.split(",") if s]  # noqa: E731
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    ranks = spawn(args.nproc, "cuda", task="repro_torch.testing.multicard:legs",
                  inputs={"layers": args.layers, "skip": names(args.skip), "only": names(args.only),
                          "partial": args.out}, timeout=3000)
    res = [r["repro_torch.testing.multicard:legs"] for r in ranks]
    card = res[0]["card"]
    failures = [f for r in res for leg in LEGS if leg in r for f in r[leg].get("failures", ())]
    for leg in LEGS:
        if leg in res[0]:
            print(f"{card} ({args.nproc} cards) {leg}: {json.dumps(res[0][leg])}")
    if "pages" in res[0]:
        print(f"{card} ({args.nproc} cards) pages on card 1: {json.dumps(res[1]['pages'])}")
    wall = time.perf_counter() - t0
    print(f"multicard: {args.nproc} processes, {wall:.1f} s; failures: {failures}")
    with open(args.out, "w") as f:
        json.dump({"card": card, "nproc": args.nproc, "wall_s": wall, "ranks": res, "failures": failures}, f,
                  indent=1, default=str)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
