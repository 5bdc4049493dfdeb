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
       is printed; ``f32_check`` passes a fixed TP t > 1 level's flip
       only where the one-card engine at that split flips alike, at a
       margin within twice the split's logit gap), no storage data_ptr
       moved on any card, every kernel launch by a graph replay. The
       logits: at TP t each card decodes 8/(4/t) slots, and torch's row
       reductions (the norms') and the TP split's sums round differently
       at another batch or split, so the one-card engine also serves the requests at (TP t, 8/(4/t) slots)
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
  yi_f32, chameleon_f32, musicgen_f32, mistral_f32, dbrx_f32  yi-34b,
       chameleon-34b (q_norm / k_norm drawn nonzero), musicgen-large,
       mistral-large-123b and dbrx-132b in f32 at chip_smoke.py phases 7-8's
       depths (FAMILY_LEGS: 4, 4, 48, 2, 2 layers), dbrx at capacity factor
       8.0 with no assignment dropped: the f32 leg's checks on tokens (at
       a fixed TP t > 1, a flip of the split's own rounding passes only as
       ``f32_check`` bounds it), storage and launches, each level's logits
       against the one-card engine at its TP and per-card batch reported;
  yi_bf16, chameleon_bf16, musicgen_bf16, mistral_bf16, dbrx_bf16  the same
       in bf16, yi, chameleon and musicgen at full depth, mistral at 24 and
       dbrx at 10 layers (80 GB a card: a whole copy of the weights on every
       card), dbrx at the published capacity factor 1.25: the bf16 leg's
       timings (TTFT at 32, 64 and 128 tokens), drops per (TP level,
       stage), the weights' GB and the peak a card.
  gemma2_f32, danube_f32  gemma2-2b and h2o-danube-1.8b at full width and
       depth in f32 with chip_smoke.py phase 6's engine (max_len 4224,
       buckets to 4160) and requests (a 4160-token prompt and a 4090-token
       one that wraps the 4096 window after 6 decode steps, and short
       ones): the f32 leg's checks on tokens, storage and launches, the
       switches (WINDOWED_SCHEDULE) all after the wrap;
  gemma2_bf16, danube_bf16  the same in bf16: the bf16 leg's timings
       (TTFT at buckets 128 and 4096) and the rings' reshard.

  train_f32  h2o-danube-1.8b at full width and depth (``--layers`` cuts it)
       in f32, SyntheticDataset(8, 512), trained at (data N/2, model 2)
       through ``make_train_step(pool=)`` with check_train_step's optimizer
       (lr 1e-3, warm-up 100): held to the one-card run (TP 1, dp 1, rank 0
       on card 0 first) within check_train_step's tolerances and each leaf
       within UPDATE_RTOL (1e-2) of its update, the one-card (TP 2, dp 2)
       run's distance reported; the replication checked after every step;
       step seconds (the first apart: it waits for every rank's build, and
       NCCL connects at first use), tokens/s, per-card peak memory against the reckoning and one
       card's 36.72 GB, the moments' bytes per card, each collective's
       bytes per step and the NCCL kernels' share of a step's device time;
  train_llama  llama3-8b at full width and depth in f32 at (data N/2,
       model 2), 10 steps at lr 3e-4 (warm-up 5, phase 12's): ~48 GB a card
       before activations by the reckoning, which one card cannot hold;
       finite losses, the replication, the mean of the last 3 losses below
       the first; timed as train_f32.
  train_moe  moonshot-v1-16b-a3b in f32 at capacity factor 1.25 (published)
       at (data N/2, model 2): 4 layers (~46 GB of f32 state on one card)
       held to the one-card (TP 2, dp 2) run, whose blocks, capacities and
       block-mean aux losses are the pool's (losses within 2e-4, each leaf
       within UPDATE_RTOL of its update); then 8 layers (~31 GB a card
       before activations), 20 steps at lr 1e-3 (warm-up 5): the loss falls,
       the replication; both timed as train_f32;
  train_jamba  jamba-v0.1-52b at one period (8 layers, each at its own
       fan-in) in f32 at (data 1, model N): ~51.5 GB a card before
       activations at N = 4; as train_llama: the loss falls, the
       replication, timed, with the all-to-all's bytes and NCCL share;
  train_mamba2  mamba2-2.7b at full width and depth (64 layers) in f32 at
       (data N/2, model 2), held to the one-card (TP 2, dp 2) run as
       train_moe's 4 layers.
  train_rules_llama  train_llama's run under DEFAULT_RULES, then the same
       under the reference's train rules (``rules_for(cfg, "train", 512,
       8)``: weight FSDP over the data group, sequence parallelism): the
       losses within 2e-4 relative, each leaf within UPDATE_RTOL of the
       DEFAULT run's update (from each card's blocks, none gathered whole),
       the peak a card below the DEFAULT run's; both timed as train_f32;
  train_rules_moe  train_moe's 4 layers at (data N/2, model 2) as
       train_rules_llama (expert-weight FSDP besides); then moonshot at 16
       layers at (data N, model 1), which fits a card only under the train
       rules (98 GB reckoned without them, 39.2 with), 20 steps at lr 1e-3:
       the loss falls, the peak beside the reckoning.
  train_bf16_llama  train_llama's run in f32 and then from the same seed in
       bf16 with f32 moments: the bf16 losses within 2e-2 relative of the
       f32 ones, both falling; peaks against the reckonings, step seconds.
  pipeline_llama  llama3-8b's decoder layers in f32 through the pipeline
       schedule, a stage a card: at 2 layers a stage held to the
       sequential stack within 2e-5, then at full depth the step, the
       bubble share against (S-1)/(n_micro+S-1), a handoff's bytes and the
       link's GB/s, the peak a card.
  profile_pool  llama3-8b bf16 served across the pool at TP 1/2/4,
       ``profile_engine`` over it (the slowest rank's time a key): the
       table (chiprun_out/llama3-8b_h100x4.json) and the plans for phase
       10's workload from it and from the one-card table.

Prints one JSON line per leg prefixed with the card's name and power
limit; writes everything to ``--out``, and each rank's legs so far to
``--out``.rank<r>.json after each leg (what is left if a later leg fails).
Exits non-zero if any check failed, after every leg has run.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import model_param_defs
from repro_torch.models.params import init_params, per_layer_fan_in, tree_leaves_with_path, tree_map
from repro_torch.parallel.collectives import Pool, all_gather, checksums
from repro_torch.parallel.sharding import DEFAULT_RULES, ShardingRules, make_exec_config

SCHEDULE = {3: 2, 7: 4, 13: 1, 19: 2}
LOGIT_TOL = 2e-4
NVLINK_GBPS_EACH_WAY = 450.0  # H100 SXM data sheet (published, not measured)
# the models whose weights take each layer's own fan-in (``weight_defs``)
PER_LAYER_FAN_IN = ("jamba-v0.1-52b",)
QK_NORM_STD = 0.5  # a qk-norm model's drawn q_norm / k_norm (``draw_weights``)
# f32_check's one exception to equal tokens, a TP t split's own f32 rounding: the most that split may move a logit
# before the flip, as a share of the largest |logit| (measured up to 1.6e-3 on full-width models); the top-2
# margin at the flip, against that gap: two logits that each move by the gap close a margin of twice it
SPLIT_GAP_LIMIT = 1e-2
FLIP_MARGIN_MULTIPLE = 2.0
# an MoE model's f32 runs: 14 requests, of which the first 8 fill the slots and two each end after 5, 9 and
# 15 tokens, so that a switch run prefills requests 8-13 after its switches: the reference's prefill path and
# capacity change with the TP level
MOE_NEW_TOKENS = (5, 5, 9, 9, 15, 15) + (24,) * 8
MOON, JAMBA, GEMMA, DANUBE = "moonshot-v1-16b-a3b", "jamba-v0.1-52b", "gemma2-2b", "h2o-danube-1.8b"
# the full-width legs <leg>_f32 and <leg>_bf16 of each model: the f32 depth (chip_smoke.py phases 7-9's; None: all
# layers), at capacity factor 8.0 (nothing drops, so tokens do not depend on the TP level's capacities), and the
# bf16 depth at the published capacity factor (80 GB a card: mistral-large-123b and dbrx-132b at the deepest
# whose bf16 weights stay at or under yi-34b's 69.6 GB, 24 of 88 and 10 of 40 layers; jamba two periods), with
# the TTFT buckets it times
FAMILY_LEGS = {MOON: {"leg": "moonshot", "f32_layers": 4, "bf16_layers": None, "ttft_buckets": (128,)},
               JAMBA: {"leg": "jamba", "f32_layers": 8, "bf16_layers": 16, "ttft_buckets": (128,)},
               "yi-34b": {"leg": "yi", "f32_layers": 4, "bf16_layers": None, "ttft_buckets": (32, 64, 128)},
               "chameleon-34b": {"leg": "chameleon", "f32_layers": 4, "bf16_layers": None,
                                 "ttft_buckets": (32, 64, 128)},
               "musicgen-large": {"leg": "musicgen", "f32_layers": None, "bf16_layers": None,
                                  "ttft_buckets": (32, 64, 128)},
               "mistral-large-123b": {"leg": "mistral", "f32_layers": 2, "bf16_layers": 24,
                                      "ttft_buckets": (32, 64, 128)},
               "dbrx-132b": {"leg": "dbrx", "f32_layers": 2, "bf16_layers": 10, "ttft_buckets": (32, 64, 128)}}
# the windowed models' legs, at full width and depth, with the engine and requests chip_smoke.py phase 6 serves
# them with (a 4160-token prompt wraps the 4096 window in prefill, a 4090-token one in its 7th token's decode
# step), and switches that all fall after the wrap
WINDOWED_ENGINE = {"max_len": 4224, "prefill_buckets": (32, 64, 128, 4096, 4160)}
WINDOWED_PROMPTS = (4160, 17, 100, 4090, 64, 3, 128, 45, 31, 77)
WINDOWED_SCHEDULE = {8: 2, 12: 4, 16: 1, 20: 2}


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


def draw_weights(cfg, dev, dtype):
    """Every rank draws the same weights from seed 0 on its own card; a
    qk-norm model's ``q_norm`` and ``k_norm``, which the reference's rule
    draws as zeros (a scale of 1 + 0, under which a wrong scale would not
    show), then from seed 1, N(0, QK_NORM_STD) per element."""
    params = init_params(weight_defs(cfg), torch.Generator(device=dev).manual_seed(0), dtype)
    if cfg.attn.qk_norm:
        g = torch.Generator(device=dev).manual_seed(1)
        for path, t in tree_leaves_with_path(params):
            if path[-1] in ("q_norm", "k_norm"):
                t.normal_(0.0, QK_NORM_STD, generator=g)
    return params


def _new_tokens(cfg):
    return MOE_NEW_TOKENS if cfg.moe is not None else 24


def _counts() -> Dict[str, int]:
    from repro_torch.kernels import _build

    return {w.__name__: w.launches for w in _build.COUNTED}


def _reset_counts() -> None:
    from repro_torch.kernels import _build

    for w in _build.COUNTED:
        w.launches = 0


def engine_settings(inputs: dict, **over) -> dict:
    """The legs' EngineConfig fields: 8 slots, max_len 256, buckets
    32/64/128, with ``inputs["engine"]`` over them (the windowed models'
    WINDOWED_ENGINE), then ``over``."""
    return {"n_slots": 8, "max_len": 256, "prefill_buckets": (32, 64, 128), **inputs.get("engine", {}), **over}


def serve_f32(pool: Pool, inputs: dict) -> dict:
    """The engine across the pool: ``model_cfg(inputs)`` (llama3-8b by
    default) in ``inputs["dtype"]`` (default f32), at ``engine_settings``,
    candidate TP levels ``inputs["tps"]`` (those the pool divides), the
    given prompts with ``inputs["new_tokens"]`` each (default 24; an MoE
    model's MOE_NEW_TOKENS), at the lowest level or under
    ``inputs["schedule"]``.
    Returns the trajectories, the launches of the run (counts set to 0 after
    the warm-up: every one by a graph replay), whether every storage
    data_ptr stayed, and an MoE model's drops per (TP level, stage)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg, dev = model_cfg(inputs), pool.device
    dtype = inputs.get("dtype", torch.float32)
    params = draw_weights(cfg, dev, dtype)
    econf = EngineConfig(**engine_settings(inputs, candidate_tps=inputs.get("tps", (1, 2, 4, 8))), dtype=dtype,
                         record_logits=inputs.get("record_logits", False))
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


def _flips(got: dict, want: dict, want_logits: dict) -> List[dict]:
    """Each request's first token where ``got`` leaves ``want``, with the
    top-2 margin of the reference's logits there."""
    out = []
    for rid, toks in want.items():
        i = next((i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b), None)
        if i is not None:
            top = np.sort(want_logits[rid][i])[-2:]
            out.append({"request": rid, "step": i, "got": got[rid][i], "want": toks[i],
                        "top2_margin": float(top[1] - top[0])})
    return out


def _gap_before_flips(got: dict, want: dict, got_logits: dict, want_logits: dict) -> float:
    """The largest logit difference over each request's steps before its
    first flip, where both runs decoded the same tokens."""
    gap = 0.0
    for rid, toks in want.items():
        n = next((i for i, (a, b) in enumerate(zip(got[rid], toks)) if a != b), len(toks))
        n = min(n, len(got_logits[rid]), len(want_logits[rid]))
        if n:
            gap = max(gap, float(np.abs(got_logits[rid][:n] - want_logits[rid][:n]).max()))
    return gap


def one_card(cfg, params, dev, tp: int, n_slots: int, inputs: dict) -> dict:
    """The one-process engine on one card at fixed TP ``tp`` (its ranks one
    after another on the card) with ``n_slots`` slots, at the leg's
    ``engine_settings``: trajectories and f32 logits of the leg's requests
    (``inputs["prompts"]``, or ``requests``' own)."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    econf = EngineConfig(**engine_settings(inputs, candidate_tps=(tp,), n_slots=n_slots), dtype=torch.float32,
                         record_logits=True)
    eng = ServingEngine(cfg, params, econf, device=dev)
    eng.warmup()
    done = eng.run(requests(cfg.vocab_size, prompts=inputs.get("prompts"), new_tokens=_new_tokens(cfg)))
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
    schedule (``inputs["schedule"]``, default SCHEDULE) against the
    one-card engine's at TP 1 with 8 slots (``model_cfg(inputs)``, at the
    leg's ``engine_settings`` and prompts).
    The one-card engine also runs at each pool level's (TP t, per-card
    batch) and at ``inputs["extra_one_card"]``'s (TP, slots); the pool's
    TP t logits' distance from the one-card engine at its (TP t, per-card
    batch), and that engine's from the one-card TP 1 logits, are reported
    (``llama_f32`` holds the first within LOGIT_TOL; an MoE model's
    one-card engine takes another path than the pool's at a TP level
    below the pool's world, and a long context sums NCCL's order over more
    rows, so elsewhere it is a reading, not a bound).
    Tokens must equal the one-card TP 1 engine's in the switch schedule,
    at fixed TP 1 and at a fixed TP t > 1 but for one case, a flip of the
    TP t split's own f32 rounding (``split_flip``): the one-card engine at
    (TP t, per-card batch) gives the pool's tokens exactly; before the
    first flip of each request the pool's logits lie within
    SPLIT_GAP_LIMIT of the largest |logit| from the one-card TP 1 engine's
    (the gap); and the one-card TP 1 logits' top-2 margin at every such
    flip is at most FLIP_MARGIN_MULTIPLE times the gap."""
    cfg, dev = model_cfg(inputs), pool.device
    failures = []
    ref, iso = None, {}
    n_slots, tps = 8, [t for t in (1, 2, 4) if pool.world % t == 0]
    per_card = {t: n_slots * t // pool.world for t in tps}  # slots a card decodes at TP t
    if pool.rank == 0:  # the one-card port: every rank in this process, on card 0
        params = draw_weights(cfg, dev, torch.float32)
        ref = one_card(cfg, params, dev, 1, n_slots, inputs)
        configs = {(t, per_card[t]) for t in tps} | set(inputs.get("extra_one_card", ()))
        for tp, slots in sorted(configs - {(1, n_slots)}):
            iso[(tp, slots)] = one_card(cfg, params, dev, tp, slots, inputs)
        del params
        _free()
    pool.barrier()
    runs = {}
    for tp in tps:
        runs[f"fixed TP {tp}"] = serve_f32(pool, {**inputs, "tps": (tp,), "schedule": None, "record_logits": True})
    runs["switch schedule"] = serve_f32(pool, {**inputs, "tps": tuple(tps), "schedule": inputs.get("schedule", SCHEDULE)})
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
                rec["flips"] = _flips(r["trajectories"], ref["trajectories"], ref["logits"])
            tp = r["tps"][0]
            if "logits" in r:
                rec.update(max_abs_logit_diff=_max_diff(r["logits"], ref["logits"]),
                           max_abs_logit=max(float(np.abs(v).max()) for v in ref["logits"].values()),
                           max_abs_logit_diff_prefill=max(float(np.abs(r["logits"][k][0] - ref["logits"][k][0]).max())
                                                          for k in ref["logits"]))
                same = iso[(tp, per_card[tp])]  # the one-card engine at this level's TP and per-card batch
                collectives = _max_diff(r["logits"], same["logits"])
                cause = _max_diff(same["logits"], ref["logits"])
                rec.update(one_card_at_same_tp_and_batch={"tp": tp, "slots": per_card[tp]},
                           max_abs_logit_diff_vs_same_tp_and_batch=collectives,
                           one_card_same_tp_and_batch_vs_tp1=cause)
                if not rec["tokens_equal_one_card"] and tp > 1:
                    gap = _gap_before_flips(r["trajectories"], ref["trajectories"], r["logits"], ref["logits"])
                    alike = same["trajectories"] == r["trajectories"]
                    flip = {"one_card_at_same_tp_and_batch_flips_alike": alike, "gap_before_flips": gap,
                            "gap_limit": SPLIT_GAP_LIMIT * rec["max_abs_logit"],
                            "margin_limit": FLIP_MARGIN_MULTIPLE * gap}
                    flip["excused"] = (alike and collectives <= LOGIT_TOL and gap <= flip["gap_limit"]
                                       and all(f["top2_margin"] <= flip["margin_limit"] for f in rec["flips"]))
                    rec["split_flip"] = flip
        out[name] = rec
    if ref is not None:
        for name in runs:
            rec = out[name]
            if not (rec["tokens_equal_one_card"] or rec.get("split_flip", {}).get("excused")):
                failures.append(f"{name}: tokens differ from the one-card engine at TP 1: {rec['flips']} "
                                f"{rec.get('split_flip', '')}")
        if runs["switch schedule"]["trajectories"] != runs["fixed TP 1"]["trajectories"]:
            failures.append("the switch schedule's tokens differ from fixed TP 1")
        out["first_tokens"] = ref["trajectories"][0]
        out["one_card"] = {f"TP {tp}, {slots} slots": {  # each (TP, slots) against (TP 1, 8 slots)
            "max_abs_logit_diff_vs_tp1_8_slots": _max_diff(r["logits"], ref["logits"]),
            "max_abs_logit_diff_prefill": max(float(np.abs(r["logits"][k][0] - ref["logits"][k][0]).max())
                                              for k in ref["logits"]),
            "tokens_equal": r["trajectories"] == ref["trajectories"]} for (tp, slots), r in sorted(iso.items())}
    out["failures"] = failures
    return out


def llama_f32(pool: Pool, inputs: dict) -> dict:
    """llama3-8b in f32: ``f32_check``, the one-card engine also at (TP 1,
    4 slots) and (TP 2, 8 slots), each fixed level's logits held within
    LOGIT_TOL of the one-card engine at its (TP t, per-card batch)."""
    out = f32_check(pool, {**inputs, "extra_one_card": ((1, 4), (2, 8))})
    if pool.rank == 0:
        out["rmsnorm_max_diff_by_rows_of_8"] = rms_batch_variance(pool.device)
        for name, rec in out.items():
            diff = rec.get("max_abs_logit_diff_vs_same_tp_and_batch") if isinstance(rec, dict) else None
            if diff is not None and diff > LOGIT_TOL:
                same = rec["one_card_at_same_tp_and_batch"]
                out["failures"].append(f"{name}: logits {diff} from the one-card engine at TP {same['tp']}, "
                                       f"{same['slots']} slots (tolerance {LOGIT_TOL})")
    return out


def family_f32(pool: Pool, inputs: dict, name: str) -> dict:
    """A model of FAMILY_LEGS in f32 at its depth and capacity factor 8.0:
    tokens against one card, storage and launches; an MoE model drops no
    assignment in any run."""
    out = f32_check(pool, {**inputs, "model": name, "layers": FAMILY_LEGS[name]["f32_layers"],
                           "capacity_factor": 8.0})
    dropped = {run: rec["moe_dropped"] for run, rec in out.items() if isinstance(rec, dict) and "moe_dropped" in rec}
    if any(n for d in dropped.values() for n in d.values()):
        out["failures"].append(f"assignments dropped at capacity factor 8.0 on rank {pool.rank}: {dropped}")
    return out


def windowed_prompts(cfg) -> List[np.ndarray]:
    """The windowed legs' and chip_smoke.py phase 6's prompts: WINDOWED_PROMPTS' lengths drawn from seed 0."""
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in WINDOWED_PROMPTS]


def windowed_f32(pool: Pool, inputs: dict, name: str) -> dict:
    """gemma2-2b or h2o-danube-1.8b in f32 at full width and depth, phase
    6's engine and requests, WINDOWED_SCHEDULE's switches after the wrap:
    tokens against one card's at TP 1, storage and launches."""
    cfg = get_config(name)
    return f32_check(pool, {**inputs, "model": name, "layers": None, "engine": WINDOWED_ENGINE,
                            "prompts": windowed_prompts(cfg), "schedule": WINDOWED_SCHEDULE})


def windowed_bf16(pool: Pool, inputs: dict, name: str) -> dict:
    """gemma2-2b or h2o-danube-1.8b in bf16 at full width and depth and
    phase 6's engine: TTFT at buckets 128 and 4096, the decode step per TP
    level, the NCCL share, the reshard of the rings (K/V of max_len rows in
    a global layer, of the window's in a windowed one)."""
    return bf16_timings(pool, {**inputs, "model": name, "layers": None, "engine": WINDOWED_ENGINE,
                               "ttft_buckets": (128, 4096)})


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
    ``model_cfg(inputs)`` (llama3-8b by default) at max_len 2048 or
    ``inputs["engine"]``: TTFT at ``inputs["ttft_buckets"]`` (default every
    bucket), an MoE model's drops per (TP level, stage), and the reshard's
    bytes of K/V and of a Mamba state apart."""
    from repro_torch.core.migration import cache_shardings, moved_bytes
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    cfg, dev = model_cfg(inputs), pool.device
    if dev.type == "cuda":  # this leg's own peak
        torch.cuda.reset_peak_memory_stats(dev)
    params = draw_weights(cfg, dev, torch.bfloat16)
    tps = [t for t in (1, 2, 4) if pool.world % t == 0]
    econf = EngineConfig(**engine_settings({"engine": {"max_len": 2048, **inputs.get("engine", {})}},
                                           candidate_tps=tps), dtype=torch.bfloat16)
    eng = ServingEngine(cfg, params, econf, pool=pool)
    warm = eng.warmup()
    rng = np.random.RandomState(3)
    out = {"model": cfg.name, "layers": cfg.num_layers, "published_layers": get_config(cfg.name).num_layers,
           "weights_gb": sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(params)) / 1e9,
           "warmup_s": warm, "ttft_ms": {}, "decode_ms": {}, "replay_device_ms": {}, "host_ms_around_replay": {},
           "nccl": {}, "switch": []}
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
    """A model of FAMILY_LEGS in bf16 at its depth, the published capacity
    factor and its TTFT buckets."""
    leg = FAMILY_LEGS[name]
    return bf16_timings(pool, {**inputs, "model": name, "layers": leg["bf16_layers"],
                               "ttft_buckets": leg["ttft_buckets"]})


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


# ---------------------------------------------------------------------------
# training across cards
# ---------------------------------------------------------------------------
TRAIN_MODEL = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_F32_STEPS, TRAIN_LLAMA_STEPS = 6, 10
ONE_CARD_PEAK_GB = 36.72  # h2o-danube-1.8b's f32 step, 24 layers, 8 x 512, one NVIDIA H100 80GB HBM3 at 700 W


def _train_tcfg(lr: float = 1e-3, warmup: int = 100):
    """check_train_step's optimizer (lr 1e-3, the default warm-up of 100),
    chunks of 256, attention blocks of 128 (phase 12's)."""
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig

    return TrainStepConfig(opt=AdamWConfig(lr=lr, warmup_steps=warmup), seq_chunk=256, block_q=128, block_k=128)


def _draw(cfg, dev, dtype=torch.float32):
    """The weights every training leg starts from: seed 0, each layer at its
    own fan-in where the model asks for it, as ``train_params`` takes
    them, in ``dtype``."""
    return weight_defs(cfg, own_fan_in=True), torch.Generator(device=dev).manual_seed(0), dtype


def one_card_train(cfg, dev, tp: int, dp: int, tcfg, steps: int, dtype: torch.dtype = torch.float32) -> dict:
    """The one-process train step on one card at (TP ``tp``, dp ``dp``) from
    ``_draw``'s weights in ``dtype``: losses, step seconds, peak memory, the
    parameters on the host and each leaf's update ||p - p0||."""
    from repro_torch.testing.multidev_checks import moved_from, single_train
    from repro_torch.training.data import SyntheticDataset

    defs, gen, dtype = _draw(cfg, dev, dtype)
    params = init_params(defs, gen, dtype)
    start = {path: t.detach().to("cpu", copy=True) for path, t in tree_leaves_with_path(params)}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = single_train(cfg, tp, dp, params, tcfg, SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ), steps)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {"tp": tp, "dp": dp, "losses": losses, "step_s": times, "peak_gb": peak / 1e9,
           "moved": moved_from(params, start), "params": tree_map(lambda t: t.detach().cpu(), params)}
    del params, start
    _free()
    return out


# NCCL kernel names by collective: an all-to-all runs as grouped sends and receives
_NCCL_KINDS = (("allgather", "all-gather"), ("allreduce", "all-reduce"), ("reducescatter", "reduce-scatter"),
               ("sendrecv", "all-to-all"), ("alltoall", "all-to-all"))


def _collective_share(pool: Pool, run) -> dict:
    """One call of ``run`` under torch.profiler: the device ms of the NCCL
    kernels by collective (all-reduce, all-gather, reduce-scatter,
    all-to-all) and of everything, on this rank (an NCCL kernel's time
    holds its wait for the other ranks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(pool)
    pool.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        _sync(pool)
    total, by = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        total += us
        name = e.name.lower()
        if "nccl" in name:
            kind = next((k for key, k in _NCCL_KINDS if key in name), "other")
            by[kind] = by.get(kind, 0.0) + us
    if total == 0:
        return {"measured": False}
    return {"measured": True, "device_ms": total / 1e3, "nccl_ms": {k: v / 1e3 for k, v in by.items()},
            "nccl_share": {k: v / total for k, v in by.items()}}


def pool_train_leg(pool: Pool, cfg, tcfg, tp: int, steps: int, ones: Optional[dict] = None,
                   check_loss_falls: bool = False, held: tuple = (1, 1), measure: bool = True,
                   rules: ShardingRules = DEFAULT_RULES, keep: Optional[dict] = None,
                   dtype: torch.dtype = torch.float32) -> dict:
    """``steps`` steps of ``cfg`` across the pool at (data N/tp, model tp)
    from ``_draw``'s weights (``multidev_checks.pool_train``, the
    replication checked after every step): losses, step seconds (the first
    apart: it waits for every rank to finish building, and NCCL connects
    at first use), the kernel's launches over the steps (set to 0 just
    before, read just after), peak memory against the reckoning, the
    moments' bytes. With ``ones`` (rank 0's one-card runs by (TP, dp),
    empty on the other ranks) the parameters after the steps are gathered
    whole and held to the one-card runs' (``multidev_checks.held_to``; the
    one-card run at ``held``, (TP, dp), ``within`` its tolerances, in bf16
    as in f32). With ``measure``, then one more step with the collectives' bytes counted and
    one under the profiler (the NCCL kernels' share). ``rules``: the
    step's (``make_train_step``'s); ``keep``, a dict, gets this rank's
    parameters after the steps on the host ("params", by path) and the
    step's layout ("layout"); ``dtype``: the parameters' (the moments stay
    f32)."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.parallel.collectives import count_traffic
    from repro_torch.testing.multidev_checks import held_to, pool_train, state_bytes, within
    from repro_torch.training.data import SyntheticDataset
    from repro_torch.training.train_step import gather_params

    dev = pool.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ds, times = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ), []
    tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
    losses, mine, step, opt = pool_train(pool, cfg, None, tcfg, tp, ds, steps, draw=_draw(cfg, dev, dtype),
                                         on_step=times.append, rules=rules)
    launches = {"forward": tp_shard_matmul.launches, "backward": tp_shard_matmul.backward_launches}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    reckoned = {"params": state_bytes(mine), "grads": state_bytes(mine),
                "moments": state_bytes({"mu": opt["mu"], "nu": opt["nu"]})}
    reckoned["before_activations"] = sum(reckoned.values())
    med = statistics.median(times[1:]) if len(times) > 1 else times[0]
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": str(dtype).replace("torch.", ""),
           "pattern": [f"{t.mixer}+{t.ffn}" for t in cfg.layer_pattern],
           "mesh": {"data": pool.world // tp, "model": tp},
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "lr": tcfg.opt.lr, "warmup": tcfg.opt.warmup_steps, "losses": losses,
           "step_s": times, "first_step_s": times[0], "step_s_median": med, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
           "peak_gb": peak / 1e9, "reckoned_gb": {k: v / 1e9 for k, v in reckoned.items()},
           "moments_gb": reckoned["moments"] / 1e9, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "replicated_after_every_step": True}
    if keep is not None:
        keep.update(params={path: t.detach().cpu() for path, t in tree_leaves_with_path(mine)}, layout=step.layout)
    failures = [] if all(np.isfinite(losses)) else [f"{cfg.name}: losses not finite: {losses}"]
    if check_loss_falls and not sum(losses[-3:]) / 3 < losses[0]:
        failures.append(f"{cfg.name}: the loss did not fall: {losses}")
    if ones is not None:
        whole = gather_params(mine, step.layout)
        for (otp, odp), one in ones.items():
            diff = held_to(losses, whole, one)
            rec[f"one_card_tp{otp}_dp{odp}"] = {"losses": one["losses"], "step_s_median": statistics.median(
                one["step_s"][1:]), "peak_gb": one["peak_gb"], "distance": diff}
            if (otp, odp) == tuple(held) and not within(diff):
                failures.append(f"{cfg.name}: the pool against one card (TP {otp}, dp {odp}): {diff}")
        del whole
        _free()
    if measure:
        with count_traffic() as traffic:
            float(step(mine, opt, ds.at(steps))[2]["loss"])
        rec["collectives_per_step"] = {k: {"calls": c, "bytes": b} for k, (c, b) in traffic.items()}
        rec["collective_share"] = _collective_share(pool, lambda: float(step(mine, opt, ds.at(steps + 1))[2]["loss"]))
    rec["failures"] = failures
    del mine, opt, step
    _free()
    return rec


def train_f32(pool: Pool, inputs: dict) -> dict:
    """h2o-danube-1.8b in f32 (``inputs["layers"]`` cuts its depth) at
    (data N/2, model 2), TRAIN_F32_STEPS steps, against the one-card run at
    (TP 1, dp 1): held within check_train_step's tolerances (losses 2e-4
    relative, parameters rtol 5e-3, atol 5e-4, its optimizer) and each
    leaf within UPDATE_RTOL of its update; the one-card (TP 2, dp 2) run's
    distance reported."""
    cfg = get_config(TRAIN_MODEL)
    if inputs.get("layers") is not None:
        cfg = dataclasses.replace(cfg, num_layers=inputs["layers"])
    tcfg, ones = _train_tcfg(), {}
    if pool.rank == 0:  # one card, every rank of each layout on card 0 in turn
        for tp, dp in ((1, 1), (2, 2)):
            ones[(tp, dp)] = one_card_train(cfg, pool.device, tp, dp, tcfg, TRAIN_F32_STEPS)
    pool.barrier()
    rec = pool_train_leg(pool, cfg, tcfg, 2 if pool.world % 2 == 0 else 1, TRAIN_F32_STEPS, ones=ones)
    if pool.rank == 0:
        rec["one_card_peak_gb_pr23"] = ONE_CARD_PEAK_GB
    del ones
    _free()
    return rec


def train_llama(pool: Pool, inputs: dict) -> dict:
    """llama3-8b in f32 (``inputs["layers"]`` cuts its depth) at (data
    N/2, model 2), TRAIN_LLAMA_STEPS steps of phase 12's optimizer (lr
    3e-4, warm-up 5): finite losses, the replication after every step, the
    mean of the last 3 losses below the first; timed as train_f32."""
    cfg = model_cfg({"layers": inputs.get("layers")})
    return pool_train_leg(pool, cfg, _train_tcfg(lr=3e-4, warmup=5), 2 if pool.world % 2 == 0 else 1,
                          TRAIN_LLAMA_STEPS, check_loss_falls=True)


TRAIN_MOE_LAYERS, TRAIN_MOE_DEEP_LAYERS, TRAIN_JAMBA_LAYERS = 4, 8, 8
# moonshot's deeper run: at phase 12's lr 3e-4 its loss stayed within the batches' noise over 10 steps on
# 4 H100s (12.502 first, 12.508 the last 3); llama3-8b's began to fall only at step 7 there
TRAIN_MOE_DEEP_STEPS, TRAIN_MOE_DEEP_LR = 20, 1e-3
MAMBA2 = "mamba2-2.7b"


@contextmanager
def deterministic():
    """torch's deterministic algorithms inside the block (warnings, not
    errors, where none exists): on CUDA the backward of an index op (the
    MoE dispatch's gathers and ``index_select``, the embedding's lookup)
    otherwise adds with atomics, in an order that changes the last bits
    from run to run."""
    before = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _held_to_one_card(pool: Pool, cfg, tcfg, tp: int, steps: int, measure: bool = True,
                      dtype: torch.dtype = torch.float32, exact: bool = False) -> dict:
    """``cfg`` across the pool at (data N/tp, model tp) (``pool_train_leg``,
    ``measure`` and ``dtype`` passed on), held to the one-process step at
    the same (TP, dp) on one card (rank 0 on card 0 first): the layout
    whose arithmetic the pool's is, blocks and capacities included. With
    ``exact`` both run under ``deterministic()``: an atomic add's last bit
    (the MoE's backward) can turn a rounding, and Adam's first steps make a
    whole step of it (moonshot's f32 run at world 1 read 2.5e-5 to 6.1e-3
    of its update apart without)."""
    dp, ones = pool.world // tp, {}
    with deterministic() if exact else nullcontext():
        if pool.rank == 0:
            ones[(tp, dp)] = one_card_train(cfg, pool.device, tp, dp, tcfg, steps, dtype)
        pool.barrier()
        rec = pool_train_leg(pool, cfg, tcfg, tp, steps, ones=ones, held=(tp, dp), measure=measure, dtype=dtype)
    del ones
    _free()
    return rec


def train_moe(pool: Pool, inputs: dict) -> dict:
    """moonshot-v1-16b-a3b in f32 at its published capacity factor 1.25 at
    (data N/2, model 2): at TRAIN_MOE_LAYERS layers, TRAIN_F32_STEPS steps
    of check_train_step's optimizer held to the one-card (TP 2, dp 2) run
    (losses within 2e-4 relative, each leaf within UPDATE_RTOL of its
    update); then at TRAIN_MOE_DEEP_LAYERS, TRAIN_MOE_DEEP_STEPS steps at lr
    TRAIN_MOE_DEEP_LR (warm-up 5): finite losses falling, the replication.
    Both timed as train_f32, the peak beside the reckoning."""
    cfg, tp = get_config(MOON), 2 if pool.world % 2 == 0 else 1
    rec = {"held": _held_to_one_card(pool, dataclasses.replace(cfg, num_layers=TRAIN_MOE_LAYERS), _train_tcfg(), tp,
                                     TRAIN_F32_STEPS),
           "deep": pool_train_leg(pool, dataclasses.replace(cfg, num_layers=TRAIN_MOE_DEEP_LAYERS),
                                  _train_tcfg(lr=TRAIN_MOE_DEEP_LR, warmup=5), tp, TRAIN_MOE_DEEP_STEPS,
                                  check_loss_falls=True)}
    rec["failures"] = rec["held"]["failures"] + rec["deep"]["failures"]
    return rec


def train_jamba(pool: Pool, inputs: dict) -> dict:
    """jamba-v0.1-52b at one period (TRAIN_JAMBA_LAYERS layers, each at its
    own fan-in) in f32 at (data 1, model N): (data 2, model 2) would need
    ~77 GB a card before activations. TRAIN_LLAMA_STEPS steps of phase 12's
    optimizer: finite losses falling, the replication; timed as train_f32
    (the sharded MoE path exchanges over the N ranks)."""
    cfg = dataclasses.replace(get_config(JAMBA), num_layers=TRAIN_JAMBA_LAYERS)
    return pool_train_leg(pool, cfg, _train_tcfg(lr=3e-4, warmup=5), pool.world, TRAIN_LLAMA_STEPS,
                          check_loss_falls=True)


def train_mamba2(pool: Pool, inputs: dict) -> dict:
    """mamba2-2.7b at full width and depth in f32 at (data N/2, model 2),
    TRAIN_F32_STEPS steps of check_train_step's optimizer, held to the
    one-card (TP 2, dp 2) run as train_moe's first part."""
    return _held_to_one_card(pool, get_config(MAMBA2), _train_tcfg(), 2 if pool.world % 2 == 0 else 1,
                             TRAIN_F32_STEPS)


def train_phase(pool: Pool, inputs: dict) -> dict:
    """chip_smoke's phase 16 on every rank: h2o-danube-1.8b at full width
    cut to ``inputs["layers"]`` in f32, phase 12's step config
    (``inputs["tcfg"]``), SyntheticDataset(8, 512), at (data N/t, model t)
    (t = 2 where the pool is even) through ``make_train_step(pool=)``:
    ``multidev_checks.checkpoint_round_trip`` (phase 12 (d)) through the
    pool's checkpoint in ``inputs["ckpt_dir"]``, the replication checked
    after every step and the kernel's launches counted over its three runs
    (set to 0 just before, read just after); its uninterrupted run held to
    the one-process step rank 0 first runs on card 0, within
    check_train_step's tolerances and UPDATE_RTOL. Then each model of
    ``phase16_families`` under "families": PHASE16_STEPS steps held to the
    one-process step at the same (TP, dp) (``_held_to_one_card``, without
    the traffic and profiler steps); moonshot's step under the train rules
    ("rules", ``rules_step``); under "families_bf16" h2o-danube and
    ``phase16_families`` the same way in bf16 (f32 moments); and under
    "pipeline" ``pipeline_llama`` at PHASE16_PIPE_LAYERS layers a stage, a
    stage a card (on one card: pipe 1, world 1)."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.testing.multidev_checks import (
        CKPT_STEPS, checked, checkpoint_round_trip, held_to, pool_step, within,
    )
    from repro_torch.training.data import SyntheticDataset
    from repro_torch.training.train_step import gather_params

    cfg = dataclasses.replace(get_config(TRAIN_MODEL), num_layers=inputs["layers"])
    tcfg, dev = inputs["tcfg"], pool.device
    tp = 2 if pool.world % 2 == 0 else 1

    made = {}

    def fresh():
        step, params, opt = pool_step(pool, cfg, None, tcfg, tp, _draw(cfg, dev))
        made["layout"] = step.layout
        return checked(pool, step), params, opt

    out = {"model": cfg.name, "layers": cfg.num_layers, "mesh": [pool.world // tp, tp]}
    one = one_card_train(cfg, dev, 1, 1, tcfg, CKPT_STEPS) if pool.rank == 0 else None
    pool.barrier()
    _sync(pool)
    tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
    t0 = time.perf_counter()
    a, ck = checkpoint_round_trip(fresh, SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ), inputs["ckpt_dir"])
    _sync(pool)
    out.update(wall_s=time.perf_counter() - t0, losses=a.losses, checkpoint=ck, failures=list(ck["failures"]),
               launches={"forward": tp_shard_matmul.launches, "backward": tp_shard_matmul.backward_launches})
    whole = gather_params(a.params, made["layout"])
    if one is not None:
        out["one_process"] = held_to(a.losses, whole, one)
        if not within(out["one_process"]):
            out["failures"].append(f"the pool against the one-process step: {out['one_process']}")
    del a, whole, one
    _free()
    out["families"] = {}
    for cfg in phase16_families():
        out["families"][cfg.name] = rec = _held_to_one_card(pool, cfg, tcfg, tp, PHASE16_STEPS, measure=False,
                                                            exact=True)
        out["failures"] += rec["failures"]
    out["rules"] = rec = rules_step(pool, phase16_families()[0], tcfg, tp)
    out["failures"] += rec["failures"]
    out["families_bf16"] = {}
    for cfg in [dataclasses.replace(get_config(TRAIN_MODEL), num_layers=inputs["layers"])] + phase16_families():
        out["families_bf16"][cfg.name] = rec = _held_to_one_card(pool, cfg, tcfg, tp, PHASE16_STEPS, measure=False,
                                                                 dtype=torch.bfloat16, exact=True)
        out["failures"] += rec["failures"]
    out["pipeline"] = rec = pipeline_llama(pool, {"layers": PHASE16_PIPE_LAYERS * pool.world})
    out["failures"] += rec["failures"]
    return out


def rules_step(pool: Pool, cfg, tcfg, tp: int) -> dict:
    """One step of ``cfg`` from ``_draw``'s weights at (data N/tp, model
    tp) under DEFAULT_RULES and then under the train rules (the kernel's
    launches counted over each: set to 0 just before, read just after):
    at world 1, where every group is one rank and the gathers give the
    block itself, the loss and every parameter bit for bit equal; on more
    ranks the losses within LOSS_RTOL. Both steps run with torch's
    deterministic algorithms: on CUDA the MoE dispatch's backward (the
    gradients of its gathers and ``index_select``) otherwise adds with
    atomics, and two steps under DEFAULT_RULES alone differ in the last
    bits (3.1e-6 at most on an H100)."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.testing.multidev_checks import LOSS_RTOL, pool_step
    from repro_torch.training.data import SyntheticDataset

    ds, runs = SyntheticDataset(cfg, TRAIN_BATCH, TRAIN_SEQ), {}
    rec = {"model": cfg.name, "layers": cfg.num_layers, "mesh": {"data": pool.world // tp, "model": tp}}
    with deterministic():
        for label, rules in (("default", DEFAULT_RULES), ("rules", rules_for(cfg, "train", TRAIN_SEQ, TRAIN_BATCH))):
            step, mine, opt = pool_step(pool, cfg, None, tcfg, tp, _draw(cfg, pool.device), rules)
            _sync(pool)
            tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
            t0 = time.perf_counter()
            loss = float(step(mine, opt, ds.at(0))[2]["loss"])
            rec[f"{label}_step_s"] = time.perf_counter() - t0
            rec[f"{label}_launches"] = {"forward": tp_shard_matmul.launches,
                                        "backward": tp_shard_matmul.backward_launches}
            runs[label] = (loss, {path: t.detach().cpu() for path, t in tree_leaves_with_path(mine)})
            if label == "rules":
                rec["data_sharded"] = sorted("/".join(p) for p in step.layout.data_dims)
            del step, mine, opt
            _free()
    (a, pa), (b, pb) = runs["rules"], runs["default"]
    rec["losses"] = {"rules": a, "default": b}
    rec["failures"] = []
    if pool.world == 1:
        rec["bitwise"] = a == b and all(torch.equal(pa[k], pb[k]) for k in pb)
        if not rec["bitwise"]:
            rec["failures"].append(f"{cfg.name}: one step under the train rules is not DEFAULT_RULES' bit for bit")
    elif not abs(a - b) / abs(b) < LOSS_RTOL:
        rec["failures"].append(f"{cfg.name}: the train rules' loss {a} against DEFAULT_RULES' {b}")
    del runs
    return rec


# the train rules' legs: rules_for(cfg, "train", TRAIN_SEQ, TRAIN_BATCH) (weight and expert-weight FSDP over the
# data group, sequence parallelism at period boundaries) against the same pool under DEFAULT_RULES
TRAIN_RULES_MOE_LAYERS, TRAIN_RULES_DEEP_LAYERS, TRAIN_RULES_DEEP_TP = 4, 16, 1
# f32 parameters, gradients and moments a card under the train rules (a reckoning: 16 bytes a parameter over
# the 4 cards): llama3-8b (8.03e9 parameters) at (2, 2), moonshot at 16 layers (9.80e9) at (4, 1)
RULES_RECKONED_GB = {"llama3-8b": 32.1, "moonshot-v1-16b-a3b": 39.2}


def _rules_distance(pool: Pool, got: dict, want: dict, start: dict, layout) -> dict:
    """The rules' run's parameters (``got``: this rank's blocks) against the
    DEFAULT_RULES run's (``want``: this rank's model shards) from the same
    start (``start``: the rules' blocks before the steps), all on the
    host: the greatest |got - want| and each leaf's ||got - want|| over
    its update ||want - start||, both over the whole pool (each block
    counted once), with no leaf gathered whole."""
    sums, worst = [], 0.0
    for path, g in got.items():
        w, k = want[path], layout.data_dim(path)
        if k is not None:  # this rank's data block of its model shard
            n = w.shape[k] // layout.level.dp
            w = w.narrow(k, layout.level.data_rank * n, n)
        copies = pool.world // ((layout.level.dp if k is not None else 1)
                                * (layout.level.tp if layout.model_dim(path) is not None else 1))
        d = g.double() - w.double()
        worst = max(worst, float(d.abs().max()))
        sums.append([float(d.pow(2).sum()) / copies, float((w.double() - start[path].double()).pow(2).sum()) / copies])
    tot = torch.tensor(sums, dtype=torch.float64, device=pool.device)
    peak = torch.tensor([worst], dtype=torch.float64, device=pool.device)
    import torch.distributed as dist

    dist.all_reduce(tot, group=pool.world_group.handle)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=pool.world_group.handle)
    rel = (tot[:, 0].sqrt() / tot[:, 1].sqrt().clamp_min(1e-30)).cpu()
    i = int(rel.argmax())
    return {"param_abs": float(peak[0]), "update_rel": float(rel[i]), "update_rel_leaf": "/".join(list(got)[i])}


def rules_against_default(pool: Pool, cfg, tcfg, tp: int, steps: int, check_loss_falls: bool = False) -> dict:
    """``cfg`` across the pool at (data N/tp, model tp) under DEFAULT_RULES
    and then under the train rules (``pool_train_leg`` each, measured),
    from ``_draw``'s weights: the rules' losses within LOSS_RTOL of the
    DEFAULT run's, each leaf within UPDATE_RTOL of its update
    (``_rules_distance``), and its peak a card below the DEFAULT run's."""
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.testing.multidev_checks import LOSS_RTOL, UPDATE_RTOL
    from repro_torch.training.train_step import train_params

    rules, base, mine = rules_for(cfg, "train", TRAIN_SEQ, TRAIN_BATCH), {}, {}
    default = pool_train_leg(pool, cfg, tcfg, tp, steps, check_loss_falls=check_loss_falls, keep=base)
    start = {path: t.detach().cpu() for path, t in tree_leaves_with_path(
        train_params(cfg, make_exec_config(cfg, tp), pool, None, _draw(cfg, pool.device), rules))}
    _free()
    rec = pool_train_leg(pool, cfg, tcfg, tp, steps, check_loss_falls=check_loss_falls, rules=rules, keep=mine)
    dist = _rules_distance(pool, mine["params"], base["params"], start, mine["layout"])
    dist["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], default["losses"]))
    rec.update(default_rules=default, against_default=dist, rules={k: v for k, v in rules.table.items()
                                                                     if v != DEFAULT_RULES.table.get(k)},
               data_sharded=sorted("/".join(p) for p in mine["layout"].data_dims))
    if not (dist["loss_rel"] < LOSS_RTOL and dist["update_rel"] < UPDATE_RTOL):
        rec["failures"].append(f"{cfg.name}: the train rules against DEFAULT_RULES: {dist}")
    if pool.device.type == "cuda" and not rec["peak_gb"] < default["peak_gb"]:
        rec["failures"].append(f"{cfg.name}: peak {rec['peak_gb']:.2f} GB under the train rules, "
                               f"{default['peak_gb']:.2f} under DEFAULT_RULES")
    rec["failures"] += default["failures"]
    del base, mine, start
    _free()
    return rec


def train_rules_llama(pool: Pool, inputs: dict) -> dict:
    """llama3-8b in f32 (``inputs["layers"]`` cuts its depth) at (data N/2,
    model 2), train_llama's TRAIN_LLAMA_STEPS steps (lr 3e-4, warm-up 5),
    under DEFAULT_RULES (train_llama itself) and then under the train rules
    (``rules_against_default``); the reckoning beside the peak."""
    cfg = model_cfg({"layers": inputs.get("layers")})
    rec = rules_against_default(pool, cfg, _train_tcfg(lr=3e-4, warmup=5), 2 if pool.world % 2 == 0 else 1,
                                TRAIN_LLAMA_STEPS, check_loss_falls=True)
    rec["reckoned_gb_full_depth"] = RULES_RECKONED_GB[cfg.name]
    return rec


def train_rules_moe(pool: Pool, inputs: dict) -> dict:
    """moonshot-v1-16b-a3b in f32 at its published capacity factor 1.25:
    at TRAIN_RULES_MOE_LAYERS layers and (data N/2, model 2), train_moe's
    held run (TRAIN_F32_STEPS steps of check_train_step's optimizer) under
    DEFAULT_RULES and then under the train rules
    (``rules_against_default``); then at TRAIN_RULES_DEEP_LAYERS layers and
    (data N, model 1), which fits a card only under the train rules,
    TRAIN_MOE_DEEP_STEPS steps at lr TRAIN_MOE_DEEP_LR (warm-up 5): finite
    losses falling, the replication, the peak beside the reckoning."""
    from repro_torch.parallel.sharding import rules_for

    cfg = get_config(MOON)
    held = rules_against_default(pool, dataclasses.replace(cfg, num_layers=TRAIN_RULES_MOE_LAYERS), _train_tcfg(),
                                 2 if pool.world % 2 == 0 else 1, TRAIN_F32_STEPS)
    deep_cfg = dataclasses.replace(cfg, num_layers=TRAIN_RULES_DEEP_LAYERS)
    deep = pool_train_leg(pool, deep_cfg, _train_tcfg(lr=TRAIN_MOE_DEEP_LR, warmup=5), TRAIN_RULES_DEEP_TP,
                          TRAIN_MOE_DEEP_STEPS, check_loss_falls=True,
                          rules=rules_for(deep_cfg, "train", TRAIN_SEQ, TRAIN_BATCH))
    deep["reckoned_gb_16_layers"] = RULES_RECKONED_GB[MOON]
    return {"held": held, "deep": deep, "failures": held["failures"] + deep["failures"]}


PHASE16_STEPS = 3  # the MoE and Mamba models' steps in phase 16
PHASE16_PIPE_LAYERS = 2  # llama3-8b's layers a stage in phase 16's pipeline


# ---------------------------------------------------------------------------
# bf16 training, the pipeline across cards, the profile over the pool
# ---------------------------------------------------------------------------
BF16_VS_F32_RTOL = 2e-2  # bf16 against f32 losses over 10 steps (a bf16 ulp is 7.8e-3 relative)


def train_bf16_llama(pool: Pool, inputs: dict) -> dict:
    """llama3-8b (``inputs["layers"]`` cuts its depth) at (data N/2, model
    2), TRAIN_LLAMA_STEPS steps of phase 12's optimizer: in f32, then from
    the same seed's weights in bf16 with f32 moments (the reference's
    default) on the same batches. Reports the bf16 losses against the f32
    ones (held within BF16_VS_F32_RTOL), each run's peak against its
    reckoning, step seconds; the loss falls in both."""
    cfg = model_cfg({"layers": inputs.get("layers")})
    tcfg, tp = _train_tcfg(lr=3e-4, warmup=5), 2 if pool.world % 2 == 0 else 1
    rec = {"f32": pool_train_leg(pool, cfg, tcfg, tp, TRAIN_LLAMA_STEPS, check_loss_falls=True, measure=False)}
    rec["bf16"] = pool_train_leg(pool, cfg, tcfg, tp, TRAIN_LLAMA_STEPS, check_loss_falls=True, measure=False,
                                 dtype=torch.bfloat16)
    rel = [abs(a - b) / abs(b) for a, b in zip(rec["bf16"]["losses"], rec["f32"]["losses"])]
    rec["loss_rel_to_f32"] = rel
    rec["failures"] = rec["f32"]["failures"] + rec["bf16"]["failures"]
    if not max(rel) < BF16_VS_F32_RTOL:
        rec["failures"].append(f"bf16 losses against f32: {rel}")
    return rec


PIPE_MICRO, PIPE_ROWS, PIPE_SEQ, PIPE_STEPS = 8, 1, 512, 4


def _pipe_step(mesh, body, params: dict, h0: torch.Tensor, n_periods: int):
    """One forward and backward of ``pipeline_apply`` (loss: the sum of
    squares of the result), the gradients left in ``params``' .grad."""
    from repro_torch.parallel.pipeline import pipeline_apply

    for _, x in tree_leaves_with_path(params):
        x.grad = None
    out = pipeline_apply(body, params, h0, mesh, n_periods)
    (out.float() ** 2).sum().backward()


def _stage_alone(body, params: dict, h0: torch.Tensor):
    """The stage's compute alone: every period of ``params`` over every
    microbatch, forward and backward, with no handoff."""
    for _, x in tree_leaves_with_path(params):
        x.grad = None
    per = next(iter(tree_leaves_with_path(params)))[1].shape[0]
    for m in range(h0.shape[0]):
        h = h0[m]
        for k in range(per):
            h = body(h, tree_map(lambda x: x[k], params), k)
        (h.float() ** 2).sum().backward()


def pipeline_llama(pool: Pool, inputs: dict) -> dict:
    """llama3-8b's decoder layers in f32 through the pipeline across the
    pool's cards, one stage a card (pipe N, data 1, model 1), PIPE_MICRO
    microbatches of (PIPE_ROWS, PIPE_SEQ) hidden states, forward and
    backward (the sum of squares of the result). First at 2 layers a stage
    against the sequential stack on each card (``multidev_checks.
    pipe_run`` / ``sequential_stack``: output, dh0 and the stage's
    gradients within PIPE_TOL); then at full depth (``inputs["layers"]``
    cuts it; 8 layers a card on 4): step ms on the host clock, the
    slowest rank's (the first apart: NCCL connects each pair at its first
    send), the bubble share
    (1 - the stage's compute alone over the step, against (S-1)/(n_micro +
    S - 1)), the bytes a handoff sends and the link's GB/s (a send and
    receive of that size between neighbours, timed alone), peak GB a
    card, and the kernel's launches over the PIPE_STEPS timed steps (set
    to 0 just before, read just after)."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.parallel.pipeline import _exchange, make_pipe_mesh
    from repro_torch.testing.multidev_checks import (
        PIPE_TOL, decoder_body, pipe_errs, pipe_run, sequential_stack, stack_params,
    )

    dev, S = pool.device, pool.world
    cfg = model_cfg({"layers": inputs.get("layers")})
    mesh = make_pipe_mesh(pool.devices, S, 1, pool=pool)
    body = decoder_body(cfg, PIPE_SEQ)
    gen = torch.Generator(device=dev).manual_seed(1)
    h0 = torch.randn(PIPE_MICRO, PIPE_ROWS, PIPE_SEQ, cfg.d_model, generator=gen, device=dev)
    rec = {"model": cfg.name, "stages": S, "micro": [PIPE_MICRO, PIPE_ROWS, PIPE_SEQ], "failures": []}
    # held: 2 layers a stage, every card holding the whole stack too
    whole = stack_params(cfg, 2 * S, dev, seed=7)
    want = sequential_stack(body, whole, h0, 2 * S)
    got = pipe_run(mesh, body, whole, h0, 2 * S)
    rec["held"] = errs = pipe_errs(got, want)
    if max(errs.values()) > PIPE_TOL:
        rec["failures"].append(f"pipeline against the sequential stack on card {pool.rank}: {errs}")
    del whole, want, got
    _free()
    # full depth
    layers = cfg.num_layers
    if layers % S:
        raise ValueError(f"{layers} layers do not split over {S} stages")
    per = layers // S
    # this stage's periods, drawn on its card from a seed of the stage's own
    params = tree_map(lambda x: x.requires_grad_(True), stack_params(cfg, per, dev, seed=100 + mesh.coords["pipe"]))
    _sync(pool)
    pool.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
    for _ in range(PIPE_STEPS):
        t0 = time.perf_counter()
        _pipe_step(mesh, body, params, h0, layers)
        _sync(pool)
        times.append(time.perf_counter() - t0)
        pool.barrier()
    launches = {"forward": tp_shard_matmul.launches, "backward": tp_shard_matmul.backward_launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # a step ends when its last rank does (stage 0: the backward reaches it last)
    times = all_reduce(torch.tensor(times, dtype=torch.float64, device=dev), pool.world_group, "max").tolist()
    t0 = time.perf_counter()
    _stage_alone(body, params, h0)
    _sync(pool)
    alone = time.perf_counter() - t0
    step_s = statistics.median(times[1:])
    pool.barrier()
    # the link: a handoff's bytes between neighbours, timed alone
    x = h0[0].contiguous()
    nxt = pool.members[pool.rank + 1] if pool.rank + 1 < S else None
    prev = pool.members[pool.rank - 1] if pool.rank > 0 else None
    buf = torch.empty_like(x)
    _exchange(x if nxt is not None else None, nxt, buf if prev is not None else None, prev)
    _sync(pool)
    pool.barrier()
    t0 = time.perf_counter()
    for _ in range(20):
        _exchange(x if nxt is not None else None, nxt, buf if prev is not None else None, prev)
    _sync(pool)
    link_s = (time.perf_counter() - t0) / 20
    nb = x.numel() * x.element_size()
    rec.update(layers=layers, layers_per_card=per, steps=PIPE_STEPS, launches=launches,
               first_step_ms=times[0] * 1e3, step_ms=step_s * 1e3,
               step_ms_all=[t * 1e3 for t in times], stage_alone_ms=alone * 1e3,
               bubble_share=1 - alone / step_s, bubble_share_expected=(S - 1) / (PIPE_MICRO + S - 1),
               handoff_bytes=nb, link_ms=link_s * 1e3, link_gbps=nb / link_s / 1e9 if S > 1 else None,
               peak_gb=peak / 1e9, weights_gb=sum(x.numel() * x.element_size()
                                                  for _, x in tree_leaves_with_path(params)) / 1e9)
    del params
    _free()
    return rec


PLAN_DEMANDS = {"strict": 2.0, "relaxed": 6.0}  # phase 10's workload: req/s, prompt 64, output 24
PLAN_CHIPS = 8
PROFILE_TABLE = "llama3-8b_h100x4.json"


def plan_of(cfg, table, tiers) -> dict:
    """The planner's plan for PLAN_DEMANDS on PLAN_CHIPS chips under
    ``tiers`` from a ``TabulatedPerfModel`` of ``table`` at the H100 spec
    (analytic where the table has no row)."""
    from repro_torch.core.planner import Planner, PlannerInputs, TierDemand
    from repro_torch.profiles.perf_model import H100, clear_perf_caches
    from repro_torch.profiles.profiler import TabulatedPerfModel

    clear_perf_caches()  # tabulated models of one config share the memo (ROADMAP, Reference notes)
    perf = TabulatedPerfModel(cfg, table, hw=H100)
    plan = Planner(perf, tiers).plan(PlannerInputs(
        {name: TierDemand(rps, 64, 24) for name, rps in PLAN_DEMANDS.items()}, total_chips=PLAN_CHIPS))
    return {"leftover_chips": plan.leftover_chips,
            "plan": {n: {"prefill": [t.prefill.tp, t.prefill.chips], "decode": [t.decode.tp, t.decode.chips],
                         "mixed": None if t.mixed is None else [t.mixed.tp, t.mixed.chips], "served_rps": t.served_rps}
                     for n, t in plan.tiers.items()},
            "decode_ms_tp_1_2_4": [perf.decode_step_time_s(8, 64, tp) * 1e3 for tp in (1, 2, 4)],
            "prefill128_ms_tp_1_2_4": [perf.prefill_time_s(128, tp) * 1e3 for tp in (1, 2, 4)]}


def profile_pool(pool: Pool, inputs: dict) -> dict:
    """llama3-8b (``inputs["layers"]`` cuts its depth) at full width in bf16
    served by ``ServingEngine(pool=...)`` at TP 1, 2 and 4 (as the pool
    divides), 8 slots, profiled by ``profile_engine``: decode batches 1/4/8
    at ctx 64 and prefill buckets 32/64/128, each key the slowest rank's
    time. Rank 0 writes the table to chiprun_out/PROFILE_TABLE (at full
    depth; ``-<n>l`` in the name when cut) and prints the planner's plan
    for phase 10's workload from it, beside the plan from the one-card
    table (TP 1 measured, the rest analytic), both under phase 10's tiers
    (``derive_tiers`` of the one-card table)."""
    from repro_torch.profiles.perf_model import H100, clear_perf_caches
    from repro_torch.profiles.profiler import ProfileTable, TabulatedPerfModel, profile_engine
    from repro_torch.profiles.slo import derive_tiers
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    cfg = model_cfg({"layers": inputs.get("layers")})
    eng = ServingEngine(cfg, draw_weights(cfg, pool.device, torch.bfloat16),
                        EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=256, prefill_buckets=(32, 64, 128),
                                     dtype=torch.bfloat16), pool=pool)
    rec = {"warmup_s": eng.warmup(), "tps": eng.tps}
    t0 = time.perf_counter()
    table = profile_engine(eng, batches=(1, 4, 8), ctxs=(64,))
    rec["profile_s"] = time.perf_counter() - t0
    rec["decode_ms"] = {f"{tp}/{b}/{c}": v * 1e3 for (tp, b, c), v in table.decode_s.items()}
    rec["prefill_ms"] = {f"{tp}/{L}": v * 1e3 for (tp, L), v in table.prefill_s.items()}
    del eng
    _free()
    if pool.rank == 0:
        full = cfg.num_layers == get_config(cfg.name).num_layers
        name = PROFILE_TABLE if full else PROFILE_TABLE.replace("_h100", f"-{cfg.num_layers}l_h100")
        path = os.path.join(inputs.get("out_dir", "chiprun_out"), name)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        table.save(path)
        rec["table_file"] = path
        one_card = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "profiles", "tables",
                                "llama3-8b_h100.json")
        one = ProfileTable.load(one_card)
        clear_perf_caches()
        tiers = derive_tiers(TabulatedPerfModel(cfg, one, hw=H100), 64)
        rec["tiers"] = [dataclasses.asdict(t) for t in tiers]
        rec["plan_from_pool_table"] = plan_of(cfg, table, tiers)
        rec["plan_from_one_card_table"] = plan_of(cfg, one, tiers)
    rec["failures"] = []
    return rec


def phase16_families() -> list:
    """Phase 16's MoE and Mamba models at full width on one card:
    moonshot-v1-16b-a3b at 2 layers (~29 GB of f32 training state), and
    jamba-v0.1-52b cut to its pattern's first layer, Mamba-1 with a dense
    FFN (~13 GB). One period of jamba (8 layers) is ~206 GB; its (Mamba-1,
    MoE) layer alone ~55 GB, to which the scan's saved doubling steps at
    8 x 512 add ~25 GB by the reckoning: it ran out of memory on one H100."""
    jamba = get_config(JAMBA)
    return [dataclasses.replace(get_config(MOON), num_layers=2),
            dataclasses.replace(jamba, pattern=jamba.layer_pattern[:1], num_layers=1)]


LEGS = {"f32": llama_f32, "bf16": bf16_timings, "pages": pages, "moe": moe,
        **{f"{leg['leg']}_{kind}": functools.partial(fn, name=name) for kind, fn in (("f32", family_f32),
                                                                                   ("bf16", family_bf16))
           for name, leg in FAMILY_LEGS.items()},
        "gemma2_f32": lambda pool, inputs: windowed_f32(pool, inputs, GEMMA),
        "danube_f32": lambda pool, inputs: windowed_f32(pool, inputs, DANUBE),
        "gemma2_bf16": lambda pool, inputs: windowed_bf16(pool, inputs, GEMMA),
        "danube_bf16": lambda pool, inputs: windowed_bf16(pool, inputs, DANUBE),
        "train_f32": train_f32, "train_llama": train_llama,
        "train_moe": train_moe, "train_jamba": train_jamba, "train_mamba2": train_mamba2,
        "train_rules_llama": train_rules_llama, "train_rules_moe": train_rules_moe,
        "train_bf16_llama": train_bf16_llama, "pipeline_llama": pipeline_llama, "profile_pool": profile_pool}


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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut llama3-8b's depth (default: all 32), and h2o-danube's in train_f32")
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
