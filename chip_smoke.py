#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--layers N] [--skip-timed]
    python3 chip_smoke.py --timings-of build/parent/src   # host cost, f32 matmul, attention, bf16 engine timings and f32 profiles of another tree
    python3 chip_smoke.py --timings-of src --serving-only   # phase 5's bf16 engine timings alone (TTFT, decode step per TP, tokens/s)

Phases; any failure raises and the script exits non-zero:
  1. card and build: the card's name and power limit, then every CUDA
     kernel (tp_shard_matmul, paged_attention, kv_gather) built from
     src/repro_torch/csrc with nvcc for sm_90a, one nvcc per source;
  2. kernels against their plain PyTorch versions on the card: the shape
     sweeps of the tests, the presliced bit-identity (f32 and bf16, also
     with misaligned storage: the producer warp's own loads against TMA),
     NaN around a shard kept out of the output, repeated calls bitwise
     equal, every llama3-8b projection at each rank's offset for TP 1/2/4/8
     at decode and prefill widths, decode attention at the engine's shape,
     and kv_gather / kv_scatter bit for bit (sweeps, a llama3-8b page row,
     round trip in place, both misaligned cases); a matmul call (decode in
     f32 and bf16, prefill at M = 32 and 128 in f32; col and row, split-K
     shapes) and one attention call (rows of 1 to 4 splits) each launching
     one kernel under torch.profiler; matmul timed in f32 and bf16 at the
     decode shapes, the prefill buckets and TP 8's shards (f32 also at
     prefill, M = 128, on a TP 8 rank's shard, and at the windowed models'
     4096- and 4160-token buckets: each projection of gemma2-2b and
     h2o-danube-1.8b at TP 1), and attention at the decode shape and over
     16 x 2048 tokens of a fragmented pool, beside their bound, their plain
     version and one PyTorch library call; attention timed with every row
     at one length, 1 and 32 to 256 (fixed cost, cost per token); the
     host's cost per matmul wrapper call; and the windowed models' new
     instances: decode attention at hd 80 (h2o-danube-1.8b) and 256
     (gemma2-2b, softcap 50), f32 and bf16, at split boundaries and over 8
     full-window rows of 4096 tokens (more splits than a wave; f32 hd 256 on
     one ring slot), a full-window row alone equal to it in the batch; the
     tied head (tp_shard_matmul's col_t mode) at gemma2's 256000 x 2304
     embedding for each rank's vocab rows at TP 1/2/4, bit-identical to the
     pre-sliced rows, also from misaligned storage; one kernel per call of
     each under torch.profiler; attention timed at each model's engine
     shape and full window against SDPA, the tied head (whole, TP 2 and 4
     ranks) against torch.matmul(x, w.t());
  3. paged KV migration at llama3-8b's page geometry: a bf16 PagedPool
     fragmented by interleaved growth (16 sequences of 256 and of 2048
     tokens, 0.537 and 4.295 GB) moved by migrate_pages into a fresh pool;
     pages and decode attention over every layer must be bit-identical
     before and after; kv_gather / kv_scatter timed per launch beside
     their bound, plain version and library call; kv_gather against
     index_select in turns at both payloads, like for like (host ids: the
     wrapper against index_select with the ids copied in the call; device
     ids: the wrapper's launch against index_select), and the host us per
     call of each; migrate_pages timed; and Fig. 7's pair at 0.537 GB: one
     copy per page against the aggregated gathers;
  4. the serving engine at llama3-8b width in f32 (check_engine at full
     width), which replays one CUDA graph per (TP level, stage, bucket)
     captured at warm-up: 10 requests served at fixed TP 1 and under a TP
     switch schedule must give identical greedy trajectories, launch the
     matmul and attention kernels (every launch by a replay: the counts
     equal the replays times the launches each graph holds) and rebind
     without moving a weight; then every graph against the eager step it
     captured, decode at every TP level and prefill at every (TP, bucket),
     bit for bit (tokens, f32 logits, KV cache); the matmul's launches by
     stage (decode and prefill graphs); the f32 decode step at TP 1 and 8
     and one f32 prefill of 128 tokens at TP 1 under torch.profiler (device
     ms, the matmul's ms and share); plus a tiny model served on the card
     against the same model on the CPU;
  5. the engine in bf16, timed on the host clock with repeats (median and
     spread): TTFT per bucket, decode step per TP level, tokens/s, the
     switch's binding lookup, the bind per TP level made at install, and
     migrate; the capture seconds per graph, the graph pool's bytes, one
     replay's device ms (CUDA events) per TP level and per bucket and the
     busy share they give, peak device memory over the weights; then,
     last, one prefill per bucket and decode at TP 1 and 8 under
     torch.profiler (device ms, busy share, ms per kernel);
  6. the windowed models at full width and depth: gemma2-2b (alternating
     4096-token local and global layers, both softcaps, tied embeddings:
     the head is col_t over the embedding) and h2o-danube-1.8b (sliding
     window 4096, hd 80), max_len 4224, buckets 32/64/128/4096/4160, 8
     slots, 10 requests of 24 new tokens (one prompt of 4160 tokens, so
     prefill builds the rotating buffer, one of 4090, which wraps it after
     6 decode steps, short ones shorter than their bucket); in f32 at fixed
     TP 1 and under a switch schedule over TP 1/2/4 (gemma2) or 1/2/4/8
     (danube): identical trajectories, both kernels launched, no weight
     moved by a rebind, every launch by a graph replay, and every graph
     equal to its eager step; the f32 decode step profiled at TP 1 and the
     largest TP as in phase 4, and one f32 prefill of 4096 tokens at TP 1;
     then in bf16 TTFT at buckets 128 and 4096, the decode step per TP
     level, capture, replay times and memory as in phase 5, and one
     torch.profiler pass. Each model is freed before the next.
  7. the dense family's remainder at full width, 8 slots, buckets
     32/64/128, max_len 256, TP 1/2/4/8: yi-34b in bf16 at full depth
     (timed as in phase 5: TTFT per bucket, decode step per TP level,
     capture, pool, peak memory, profiles), then phase 4's f32 switch check
     of yi-34b and chameleon-34b at 4 layers, mistral-large-123b at 2 and
     musicgen-large at full depth;
  8. MoE: moonshot-v1-16b-a3b in bf16 at full depth at its published
     capacity factor 1.25, timed as in phase 5 (the profiles split a step
     into the matmul kernel, attention, the library's GEMMs - the expert
     bmm and the router - and the rest; dropped assignments per TP level
     and stage), then the f32 switch check of moonshot at 4 layers and
     dbrx-132b at 2 at capacity factor 8.0 (no drop) and again at 1.25
     (trajectories and drops printed, not asserted), with 14 requests of
     which six are prefilled after the switches, two each at TP 2, 4 and
     8. Phase 2 also holds these models' attention geometries and matmul
     widths to their plain versions and times them.
  9. the Mamba family: mamba2-2.7b at full width and depth (64 layers,
     11.3 GB in f32) through ``forward`` over a pool of 8 ranks (the
     reference's path for it: its engine refuses a model without KV
     heads): 8 prompts of 3-128 tokens prefilled, then 24 greedy decode
     steps as a batch of 8 with the state cache, at fixed TP 1 and with
     rebinds TP 1 -> 2 -> 4 -> 8 -> 1 (identical tokens, finite hidden
     states, no weight byte moved, the matmul launched); in bf16 one
     128-token prefill and the decode step of 8 at TP 1 and 8 under
     torch.profiler (eager, not graph replays); then jamba-v0.1-52b through
     the engine: the f32 switch check at one period (8 layers, 53.2 GB) at
     capacity factor 8.0 (no drop; every graph equal to its eager step,
     the Mamba states included), and in bf16 at two periods (16 layers,
     52.1 GB) at the published capacity factor 1.25, timed as in phase 8.
     Phase 2 also holds the Mamba projections (narrow N, K = 256, w_dt's
     10-column shards at 20-byte offsets) to their plain versions, one
     kernel a call, and times them.
 10. the H100's offline profile and the planner that consumes it: the
     fields of ``profiles.perf_model.H100`` measured on this card beside
     the committed ones; llama3-8b in bf16 (phase 5's engine configuration,
     --layers cuts it) profiled by ``profile_engine`` through its CUDA
     graphs (every launch by a replay), its TP 1 rows written to
     src/repro_torch/profiles/tables/llama3-8b_h100.json (full depth) and
     chiprun_out/, the TP > 1 rows printed apart (one card runs the t ranks
     one after another); the TP 1 times beside ``PerfModel(cfg, H100)``;
     tiers derived from a ``TabulatedPerfModel`` of the table and the
     planner's plan for two tiers on 8 chips (at most 8 used); 16 requests
     served and scored with ``GoodputMeter``; ``MigrationModel(hw=H100)``
     beside phase 3's ``migrate_pages``.
 11. the serving simulator on the card's numbers (host code, in spawned
     worker processes; every kernel's launch count must stay as it was):
     the 24 cases of ``testing.sim_equivalence`` at V5E held to the
     reference's goldens (benchmarks/results/sim_golden.json) at
     DEFAULT_RTOL, the fault cases with the KV audit armed; the Fig. 9
     matrix (benchmarks/fig9_goodput.py's six systems on the two-tier
     servegen and azure traces, rps_scale 0.5/1/2, 300 s, 16 chips) under
     phase 10's tabulated model and under ``PerfModel(cfg, H100)``,
     printed; phase 10's 16 served requests replayed through static-tp1
     on 1 chip, the predicted p50 TTFT/TPOT and requests met beside the
     measured ones, printed.
 12. training: (a) h2o-danube-1.8b at full width and 2 layers in f32,
     batch 4 x 256: one loss_fn gradient through the kernel and through its
     plain version on the same CUDA tensors, every leaf within 1e-4 of its
     max |g| (the CPU tests' tolerance against the reference), and the
     matmul's autograd (row and col_t at a TP 2 rank's offset) against the
     plain version's; (b) check_train_step (reduced h2o-danube, data 2 x
     model 2, ZeRO-1 moments, against one rank); (c) h2o-danube-1.8b at
     full width and depth (24 layers, 1.831 B parameters) trained in f32
     with the layer recompute for 20 steps of SyntheticDataset(8, 512)
     through make_train_step: finite losses, the mean of the last 5 below
     the first; step times, tokens/s, peak memory against the reckoning,
     the matmul's launches per step (forward with the recompute, backward
     dX) and one step under torch.profiler split into the matmul kernel,
     the attention, the optimizer, the library's other GEMMs and the rest;
     then the same in bf16 with f32 moments (12 steps), beside the f32 run;
     (d) train_loop at 2 layers: 8 steps with a checkpoint every 4, a run
     failing at step 6 and a resumed run; step 4's checkpoint loads back
     onto the card bit for bit, the resumed losses within 2e-4 of the
     uninterrupted run's; save and load seconds; (e) train mode's
     attention (``models.attention.train_attention``, whose backward sums
     each block pair's gradients as the reference does) at h2o-danube's
     and gemma2-2b's attention geometry, S 2048, blocks of 512, a window
     of 1024 (dead pairs), f32 and bf16, on the card against the same
     Function on the CPU (in host workers, started before phase 6): f32
     within 1e-5 of each gradient's max |g|, bf16 within one bf16 ulp of
     its max |g| with fewer than 1% of the elements differing.
 13. the launchers and examples on the card, each module's ``main(argv)`` called
     in-process: (a) ``launch.serve`` with the demo defaults, then
     llama3-8b in bf16 at full width and depth (TP 1/2/4/8, 24 requests,
     a switch every 8 steps), then the same requests in f32 at phase 4's
     depth under that schedule and at fixed TP 1 (``serve.serve``): every
     token equal; (b) ``launch.train`` on h2o-danube-1.8b at full width in
     f32, cut to LAUNCH_TRAIN_LAYERS layers, batch 8 x 256: N steps with a
     checkpoint, the same argv with 2N (must resume from N), and an uncut
     2N-step run (losses within 2e-4 relative); (c) the four examples
     (``plan_trace`` is host code); (d) the length-regime gate at V5E
     (must pass, as the reference's CI requires) and at the H100 table
     (verdict and violations printed), in host workers.
 14. the dry run: every applicable cell of the 10 x 4 grid on the 16x16
     mesh counted on ``meta`` in host workers (started with phase 13), each
     cell's counts and H100 roofline terms printed, the sweep's wall time;
     then llama3-8b's bf16 prefill of 128 tokens and 8-slot decode step at
     TP 1 counted by ``launch.op_cost`` at phase 5's shapes, over phase 5's
     profiled device ms: the model-FLOPs share of 989 TFLOP/s, in (0, 1].
 15. the engine across processes: ``torch.cuda.device_count()`` processes
     spawned, one per card, joined by NCCL (``collectives.init_pool``; on
     one card, world 1), each drawing phase 4's f32 weights on its own card
     (the ranks' checksums must agree) and serving phase 4's 10 requests
     through the process-group path (every collective a real NCCL call,
     captured in the graphs) at fixed TP 1, then, with more than one card,
     under phase 4's schedule over the TP levels the pool divides: the
     tokens must equal phase 4's one-process engine's, every launch a graph
     replay, no storage data_ptr moved; then, in the same processes,
     moonshot-v1-16b-a3b (4 layers), dbrx-132b (2) and jamba-v0.1-52b (8
     layers, weights at each layer's own fan-in) in f32 at capacity factor
     8.0, phases 8 and 9's 14 requests at fixed TP 1, yi-34b,
     chameleon-34b (4 layers each), mistral-large-123b (2) and
     musicgen-large (48) with phase 7's 10 requests at fixed TP 1, and
     gemma2-2b and h2o-danube-1.8b
     at full width and depth with phase 6's engine and 10 requests (the
     4160-token prompt wraps the window in prefill, the 4090-token one in
     decode) at fixed TP 1: the tokens must equal those phases'
     one-process engine's (MoE drops printed), with the same checks. The
     four-card legs are ``python -m repro_torch.testing.multicard`` and
     ``python -m repro_torch.testing.multidev_checks all 4 cuda``.
 16. training across processes: the pool of phase 15 (a new spawn; world
     1 on one card; data N/2 x model 2 on an even pool) trains
     h2o-danube-1.8b at full width and 2 layers in f32 through
     ``make_train_step(pool=)``, phase 12's step config and
     SyntheticDataset(8, 512), in phase 12 (d)'s round trip through the
     pool's elastic checkpoint (rank 0 writes every leaf whole): 8 steps
     with a checkpoint every 4, then a run failing at step 6, resumed from
     step 4, whose checkpoint loads back bit for bit against each rank's
     state as it was saved, the resumed losses within 2e-4 of the
     uninterrupted run's. The uninterrupted run's losses are held within
     2e-4 relative, and its parameters within rtol 5e-3, atol 5e-4 and
     within 1e-2 of their update, of the one-process step (run first on
     card 0); after every step the parameters bit-equal across each data
     group and the replicated leaves across each model group. Then
     moonshot (2 layers) and jamba (one layer) the same way for 3 steps,
     moonshot's step under the train rules, and h2o-danube (2 layers),
     moonshot and jamba for 3 steps in bf16 with f32 moments, each held to
     the one-process bf16 step as the f32 runs are (a pool that never
     applies its update reads 1.0 of its update) and read for bit for bit
     (the MoE and Mamba runs, f32 and bf16, all under torch's
     deterministic algorithms); last,
     llama3-8b's decoder layers in f32 through the pipeline schedule, a
     stage a card (on one card pipe 1, world 1; 2 layers a stage), held to
     the sequential stack within 2e-5 and timed.
Each kernel's launch count is set to 0 just before the path that runs it
(phase 3 for kv_gather / kv_scatter; phase 4 in f32, phase 5's bf16
serving runs, each model's f32 runs in phases 6-9 and the bf16 runs of
phases 7-9 for the others; after the engines' warm-up, so that the counts
are the replays') and read just after. The kernels line's ``launches``
adds phase 5's counts (phase 4's when phase 5 is skipped) and those of
phases 6-10 (phase 10: the profile's replays), 12 (the training
steps of (c): "train" the forward's and the recompute's launches, "train
backward" the backward's dX launches) and 13 (each launcher's and
example's run, warm-up included), with the split in
``launches_by_path``; ``instances`` holds the new instances' rows. Phases 15
and 16's launches are made in their processes and added as their own
paths (16: the round trip's three runs, each family's steps in f32 and in
bf16, the rules' step and the pipeline's timed steps, forward and
backward). The full
record goes to chiprun_out/chip_smoke.json. The last lines are the kernels
line, the card line and the contract line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # FMA f32; dense bf16 tensor cores
TPU_SOURCES = {
    "tp_shard_matmul": "src/repro/kernels/tp_shard_matmul/kernel.py:41",
    "paged_decode_attention": "src/repro/kernels/paged_attention/kernel.py:74",
    "kv_gather": "src/repro/kernels/kv_gather/kernel.py:29",
    "kv_scatter": "src/repro/kernels/kv_gather/kernel.py:51",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, flush=None, spin: int = 400_000) -> float:
    """Median device time of one call, from CUDA events around each call;
    ``flush`` (a large buffer) is overwritten before each call so the call
    finds the 50 MB L2 cold, as it does inside a forward pass. A spin of
    ``spin`` cycles (~0.2 ms by default) queued before the start event keeps
    the card busy while the host issues the call, so the host's launch cost
    is not counted."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


class ReadFlush:
    """A flush for time_ms that reads a 64 MB buffer: the call finds the L2
    cold, as after zero_, but holding no dirty lines, where zero_ leaves
    ~50 MB of them to be written back inside the timed call."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.buf = torch.ones(64 * 2**20, dtype=torch.uint8, device=dev)
        self.out = torch.zeros((), dtype=torch.int64, device=dev)

    def zero_(self):
        self.torch.sum(self.buf, dim=0, dtype=self.torch.int64, out=self.out)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profiled(torch, fn):
    """Run fn once under torch.profiler (CUDA activity only), ending in a
    sync: [(event key, self device us)] and the wall us of the traced run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = [(e.key, getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0))
          for e in prof.key_averages()]
    return ev, wall_us


PROFILER_SESSIONS = {"sessions": 0, "empty": 0}  # of kernels_in_one_call; empty: no device time seen


def kernels_in_one_call(torch, fn, sessions: int = 12):
    """{kernel name: count} of one call under torch.profiler (after one
    untraced call), or None when the profiler sees no device time in any of
    ``sessions`` sessions. On the card a session now and then comes back
    empty, a few in a row (repro_torch.testing.profiler_sessions measures
    how often); each empty session is counted in PROFILER_SESSIONS and
    retried after a pause that grows with the attempt."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(sessions):
        if attempt:
            time.sleep(0.01 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key[:60]: e.count for e in prof.key_averages()
                   if (getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)) > 0}
        PROFILER_SESSIONS["sessions"] += 1
        if kernels:
            return kernels
        PROFILER_SESSIONS["empty"] += 1
    return None


# by substring of the kernel's name: bf16 wgmma_mm, f32 skinny_mm (decode)
# and fma_mm (prefill); an earlier tree's skinny_t_mm, tiled_mm and
# splitk_reduce under --timings-of
MATMUL_KERNELS = ("wgmma_mm", "skinny", "fma_mm", "tiled_mm", "splitk_reduce")
PORT_KERNELS = MATMUL_KERNELS + ("paged_decode",)


def kernel_ms(ev, n):
    """Device ms per step (or per call) of the port's kernels, by name."""
    return {k: sum(t for key, t in ev if k in key) / n / 1e3 for k in PORT_KERNELS}


def decode_profile(torch, eng, n=3):
    """n decode steps under torch.profiler: the card's busy share of the
    traced wall time and the kernels that fill it."""
    ev, wall_us = profiled(torch, lambda: [eng.step() for _ in range(n)])
    dev_us = sum(t for _, t in ev)
    if dev_us == 0:
        return {"busy_share": "not measured (the profiler saw no device time)"}
    top = sorted(ev, key=lambda kv: -kv[1])[:6]
    return {"traced_step_ms": wall_us / n / 1e3, "device_ms_per_step": dev_us / n / 1e3,
            "busy_share": dev_us / wall_us, "top_ms_per_step": {k[:80]: t / n / 1e3 for k, t in top},
            "kernel_ms_per_step": kernel_ms(ev, n), "split_ms_per_step": step_split(ev, n)}


# by substring: the library's GEMM kernels, which run the MoE expert bmm and
# the router (cuBLAS's nvjet / xmma / cutlass / gemm / gemv kernels)
LIBRARY_GEMM = ("nvjet", "xmma", "cutlass", "gemm", "gemv")


def step_split(ev, n):
    """Device ms per step: the port's matmul kernel, decode attention, the
    library's GEMMs (the expert bmm and the router in an MoE model) and the
    rest (plain PyTorch ops: norms, RoPE, dispatch, copies)."""
    out = {"tp_shard_matmul": 0.0, "paged_decode_attention": 0.0, "library_gemm": 0.0, "rest": 0.0}
    for key, t in ev:
        if any(k in key for k in MATMUL_KERNELS):
            out["tp_shard_matmul"] += t
        elif "paged_decode" in key:
            out["paged_decode_attention"] += t
        elif any(k in key.lower() for k in LIBRARY_GEMM):
            out["library_gemm"] += t
        else:
            out["rest"] += t
    return {k: v / n / 1e3 for k, v in out.items()}


# ---------------------------------------------------------------------------
# phase 2: kernels against plain versions
# ---------------------------------------------------------------------------
def check_matmul_sweeps(torch, dev, log):
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

    g = torch.Generator(device=dev).manual_seed(0)

    def grid(*shape):  # multiples of 1/8: every sum exact, so kernel == plain bit for bit
        return torch.randint(-8, 9, shape, generator=g, device=dev).float() / 8

    worst = 0.0
    cases = [("col", 64, 128, 512, 128, 0), ("col", 64, 128, 512, 128, 3), ("col", 128, 256, 256, 64, 2),
             ("col", 32, 64, 576, 144, 1), ("col", 256, 512, 1024, 512, 1),
             ("row", 64, 512, 128, 128, 0), ("row", 64, 512, 128, 128, 2), ("row", 32, 256, 64, 96, 1),
             # decode widths (M <= 8), ragged and misaligned (scalar loads at offset 70)
             ("col", 8, 128, 512, 128, 3), ("col", 3, 72, 576, 144, 1), ("col", 6, 96, 210, 70, 1),
             ("row", 7, 256, 64, 96, 1), ("row", 8, 3000, 1000, 520, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        for mode, m, a, b, c, shard in cases:
            if mode == "col":  # (m, k, n_store, n_out)
                x, w, off, n_out = grid(m, a).to(dtype), grid(a, b).to(dtype), shard * c, c
            else:  # (m, k_store, k, n)
                x, w, off, n_out = grid(m, b).to(dtype), grid(a, c).to(dtype), shard * b, c
            got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
            err = (got.float() - tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out).float()).abs().max().item()
            check(err <= (2e-5 if dtype == torch.float32 else 2e-2), f"tp_shard_matmul {mode} {dtype} err {err}")
            worst = max(worst, err)
    # the paper's invariant: a shard read in place equals the pre-sliced weight, bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 4096, generator=g, device=dev).to(dtype)
        w = torch.randn(4096, 4096, generator=g, device=dev).to(dtype)
        wr = torch.randn(4096, 1024, generator=g, device=dev).to(dtype)
        for tp in (1, 2, 4, 8):
            n = 4096 // tp
            for s in range(tp):
                col = tp_shard_matmul(x, w, s * n, n_out=n, mode="col")
                check(torch.equal(col, tp_shard_matmul(x, w[:, s * n:(s + 1) * n].contiguous(), 0, n_out=n, mode="col")),
                      f"presliced col tp={tp} shard={s} {dtype}")
                row = tp_shard_matmul(x[:, :n].contiguous(), wr, s * n, n_out=1024, mode="row")
                check(torch.equal(row, tp_shard_matmul(x[:, :n].contiguous(), wr[s * n:(s + 1) * n].contiguous(), 0,
                                                       n_out=1024, mode="row")), f"presliced row tp={tp} shard={s}")
    # again with the storage one element past a 16-byte boundary (bf16 2
    # bytes, f32 4): in place the producer warp loads the tiles itself (bf16
    # with plain loads, f32 with 4-byte cp.async), the pre-sliced copy goes
    # through TMA
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 4096, generator=g, device=dev).to(dtype)
        buf = torch.randn(4096 * 4096 + 1, generator=g, device=dev).to(dtype)
        for mode in ("col", "row"):
            w = buf[1:].view(4096, 4096) if mode == "col" else buf[1:1 + 4096 * 1024].view(4096, 1024)
            check(w.data_ptr() % 16 == w.element_size(), "misaligned storage")
            for tp in (1, 2, 4, 8):
                n = 4096 // tp
                for s in range(tp):
                    if mode == "col":
                        got = tp_shard_matmul(x, w, s * n, n_out=n, mode="col")
                        want = tp_shard_matmul(x, w[:, s * n:(s + 1) * n].contiguous(), 0, n_out=n, mode="col")
                    else:
                        xs = x[:, :n].contiguous()
                        got = tp_shard_matmul(xs, w, s * n, n_out=1024, mode="row")
                        want = tp_shard_matmul(xs, w[s * n:(s + 1) * n].contiguous(), 0, n_out=1024, mode="row")
                    check(torch.equal(got, want), f"presliced {mode} tp={tp} shard={s} {dtype}, misaligned storage")
        del x, buf
    # NaN around the shard never reaches the output; two calls agree bit for bit
    n_poison = 0
    for dtype in (torch.float32, torch.bfloat16):
        for mode, m, k, store, n_out, off in (("col", 8, 4096, 14336, 1792, 3 * 1792),
                                              ("row", 8, 1792, 14336, 4096, 5 * 1792),
                                              ("col", 3, 96, 210, 70, 70), ("row", 33, 100, 300, 70, 200),
                                              ("col", 128, 4096, 4096, 512, 1024), ("row", 100, 1000, 3000, 516, 1000)):
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            w = (torch.randn(*((k, store) if mode == "col" else (store, n_out)), generator=g, device=dev)
                 / math.sqrt(k)).to(dtype)
            if mode == "col":
                w[:, :off] = w[:, off + n_out:] = float("nan")
            else:
                w[:off] = w[off + k:] = float("nan")
            got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode)
            want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out)
            err = (got.float() - want.float()).abs().max().item()
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            check(bool(torch.isfinite(got).all()) and err <= tol * want.float().abs().max().item(),
                  f"NaN past the {mode} shard ({dtype}, M={m}, K={k}, N={n_out}): finite "
                  f"{bool(torch.isfinite(got).all())}, err {err}")
            check(torch.equal(tp_shard_matmul(x, w, off, n_out=n_out, mode=mode), got), f"repeat bitwise {mode} M={m}")
            n_poison += 1
    log(f"tp_shard_matmul: sweeps (exact inputs) max |err| {worst:.3g} (tol f32 2e-5, bf16 2e-2); "
        f"presliced bit-identity holds at tp 1/2/4/8, col and row, f32 and bf16, also with misaligned "
        f"storage (the producer warp's own loads in place vs TMA pre-sliced); NaN around the shard stays out and a "
        f"second call is bitwise equal in {n_poison} cases (f32 and bf16)")
    return worst


def check_paged_sweeps(torch, dev, log):
    import numpy as np

    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

    g = torch.Generator(device=dev).manual_seed(1)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(2, 2, 4, 32, 8, 4, None), (1, 1, 8, 64, 16, 2, None), (4, 4, 1, 16, 4, 8, None),
             (2, 2, 2, 16, 8, 2, 20.0), (3, 2, 3, 16, 4, 4, None), (3, 2, 4, 128, 8, 3, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, KV, G, hd, page, n_pages, cap) in enumerate(cases):
            rng = np.random.RandomState(B * 31 + n_pages + i)
            P = B * n_pages + 2
            q = torch.randn(B, KV, G, hd, generator=g, device=dev).to(dtype)
            kp = torch.randn(P, page, KV, hd, generator=g, device=dev).to(dtype)
            vp = torch.randn(P, page, KV, hd, generator=g, device=dev).to(dtype)
            tables = torch.from_numpy(rng.permutation(P)[: B * n_pages].reshape(B, n_pages).astype(np.int32)).to(dev)
            lens = torch.from_numpy(rng.randint(1, page * n_pages + 1, size=(B,)).astype(np.int32)).to(dev)
            got = paged_decode_attention(q, kp, vp, tables, lens, softcap=cap).float()
            want = paged_decode_attention_ref(q, kp, vp, tables, lens, softcap=cap).float()
            tol = 2e-5 if dtype == torch.float32 else 3e-2
            err = ((got - want).abs() - tol * want.abs()).max().item()
            check(err <= tol, f"paged_decode_attention case {i} {dtype}: err {err}")
            worst[dtype] = max(worst[dtype], (got - want).abs().max().item())
    log(f"paged_decode_attention: sweeps (permuted tables, softcap) max |err| f32 {worst[torch.float32]:.3g} "
        f"(tol 2e-5), bf16 {worst[torch.bfloat16]:.3g} (tol 3e-2)")


def check_matmul_main_shapes(torch, dev, cfg, log):
    """Every projection of llama3-8b as the engine calls it: each rank's
    shard at its offset, TP 1/2/4/8, M = 8 (decode) and 32/64/128 (the
    prefill buckets, where the tiled path and split-K run), f32 and bf16.
    Each shard is held to tol x max|plain| of that shard."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

    d, ff, hd, H, KV, V = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.vocab_padded
    # (name, mode, stored weight shape, units along the sharded axis, unit width)
    projections = [("wq", "col", (d, H * hd), H, hd), ("wk/wv", "col", (d, KV * hd), KV, hd),
                   ("wo", "row", (H * hd, d), H, hd), ("w_gate/w_in", "col", (d, ff), ff, 1),
                   ("w_out", "row", (ff, d), ff, 1), ("lm_head", "col", (d, V), V, 1)]
    g = torch.Generator(device=dev).manual_seed(5)
    worst, n_cases = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for name, mode, (k_store, n_store), n, unit in projections:
            w = (torch.randn(k_store, n_store, generator=g, device=dev) / math.sqrt(k_store)).to(dtype)
            x_all = torch.randn(128, k_store, generator=g, device=dev).to(dtype)
            out_dtype = torch.float32 if name == "lm_head" else dtype
            for tp in (1, 2, 4, 8):
                width = max(n // tp, 1) * unit
                for r in range(tp):
                    off = (r * n) // tp * unit  # weight_store's per-rank offset, storage_tp 1
                    for m in (8, 32, 64, 128):
                        if mode == "col":
                            x, n_out = x_all[:m], width
                        else:
                            x, n_out = x_all[:m, off:off + width].contiguous(), n_store
                        got = tp_shard_matmul(x, w, off, n_out=n_out, mode=mode, out_dtype=out_dtype).float()
                        want = tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out, out_dtype=out_dtype).float()
                        ratio = (got - want).abs().max().item() / want.abs().max().item()
                        check(ratio <= tol, f"tp_shard_matmul {name} {dtype} tp={tp} rank={r} M={m}: "
                                            f"err {ratio:.3g} x max|plain| > {tol}")
                        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), ratio)
                        n_cases += 1
            del w, x_all
    log(f"tp_shard_matmul: every llama3-8b projection, each rank's shard at TP 1/2/4/8, M 8/32/64/128: "
        f"{n_cases} cases, worst max|err| / max|plain| f32 {worst['torch.float32']:.3g} (tol 1e-5), "
        f"bf16 {worst['torch.bfloat16']:.3g} (tol 1e-2)")
    return {"cases": n_cases, "worst_err_over_max_plain": worst}


def projection_shapes(cfg):
    """(name, mode, stored K, stored N) of a layer's projections as the
    engine calls tp_shard_matmul at TP 1 (in prefill the head takes only
    the last token, M = 1)."""
    d, hd = cfg.d_model, cfg.head_dim
    return [("wq col", "col", d, cfg.num_heads * hd), ("wk/wv col", "col", d, cfg.num_kv_heads * hd),
            ("wo row", "row", cfg.num_heads * hd, d), ("w_gate/w_in col", "col", d, cfg.d_ff),
            ("w_out row", "row", cfg.d_ff, d)]


def measure_matmul(torch, dev, cfg, flush, log, f32_only=False):
    """The projections as the main path runs them, bf16 and f32: llama3-8b
    at TP 1 at decode (M = 8 slots) and at the prefill buckets (M =
    32/64/128), and at decode and (f32) at M = 128 on a TP 8 rank's shard
    (rank 1's offset into the full storage); the windowed models' f32
    prefill at their 4096- and 4160-token buckets, TP 1. f32_only: the f32
    rows alone. Kernel vs plain vs torch.matmul on the pre-sliced shard
    (TF32 off); the bound counts the shard's bytes and FMAs. Each weight is
    made and freed in turn. The f32 decode rows also take f32_decode_extras."""
    from repro_torch.configs import get_config

    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    shapes = [("wq/wo col", "col", d, d), ("wk/wv col", "col", d, cfg.num_kv_heads * hd), ("w_gate/w_in col", "col", d, ff),
              ("w_out row", "row", ff, d), ("lm_head col f32-out", "col", d, cfg.vocab_padded)]
    bf, f32 = torch.bfloat16, torch.float32
    dtypes = (f32,) if f32_only else (bf, f32)
    cases = [(cfg.name, s, 8, dt, tp) for tp in (1, 8) for dt in dtypes for s in shapes]
    cases += [(cfg.name, s, m, dt, 1) for dt in dtypes for m in (32, 64, 128) for s in shapes]
    cases += [(cfg.name, s, 128, f32, 8) for s in shapes]
    for name in WINDOWED[::-1]:
        cases += [(name, s, m, f32, 1) for m in (4096, 4160) for s in projection_shapes(get_config(name))]
    return measure_matmul_cases(torch, dev, cases, flush, log, cfg.name)


def measure_matmul_cases(torch, dev, cases, flush, log, main_model, seed=3):
    """measure_matmul's rows for ``cases``, (model, (name, mode, stored K,
    stored N), M, dtype, TP): TP 1 takes the whole weight, TP > 1 rank 1's
    shard of it; each row held to its plain version (tol x max|plain|) and
    timed beside its bound, its plain version and torch.matmul."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    clean = ReadFlush(torch, dev)
    rows = []
    for model, (name, mode, k_store, n_store), m, dtype, tp in cases:
        dname = str(dtype).split(".")[1]
        w = (torch.randn(k_store, n_store, generator=g, device=dev) / math.sqrt(k_store)).to(dtype)
        if mode == "col":  # rank 1's columns at TP 8
            k, n = k_store, n_store // tp
            off = n if tp > 1 else 0
            sliced = w[:, off:off + n].contiguous()
        else:  # rank 1's rows at TP 8
            k, n = k_store // tp, n_store
            off = k if tp > 1 else 0
            sliced = w[off:off + k].contiguous()
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        out_dtype = f32 if name.startswith("lm_head") else dtype
        run = lambda: tp_shard_matmul(x, w, off, n_out=n, mode=mode, out_dtype=out_dtype)  # noqa: E731
        got, want = run(), tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n, out_dtype=out_dtype)
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 if dtype == f32 else 1e-2
        check(err <= tol * scale, f"tp_shard_matmul {model} {name} {dname} M={m} TP {tp}: err {err} > {tol} x {scale}")
        es, eo = x.element_size(), torch.finfo(out_dtype).bits // 8
        b_ms, b_by = bound_ms(es * (m * k + k * n) + eo * m * n, 2.0 * m * k * n, dname)
        shape = (f"{name} {dname} M={m} K={k} N={n}" + (f" (TP {tp} rank 1 shard)" if tp > 1 else "")
                 + ("" if model == main_model else f" ({model})"))
        iters = 20 if m * k * n < 2**34 else 10
        del got, want
        row = {
            "name": name, "model": model, "dtype": dname, "m": m, "tp": tp,
            "shape": shape, "max_abs_err": err, "tol": f"{tol} x max|plain| = {tol * scale:.3g}",
            "ms": time_ms(torch, run, iters=iters, flush=flush),
            "plain_ms": time_ms(torch, lambda: tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n, out_dtype=out_dtype),
                                iters=iters, flush=flush),
            "library_ms": time_ms(torch, lambda: torch.matmul(x, sliced), iters=iters, flush=flush),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        if dtype == f32 and m == 8:
            row.update(f32_decode_extras(torch, run, lambda: torch.matmul(x, sliced), clean))
        rows.append(row)
        log(f"  {shape}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, {b_ms / row['ms']:.2f} of it), "
            f"plain {row['plain_ms']:.4f}, torch.matmul {row['library_ms']:.4f}, err {err:.3g} (tol {row['tol']})"
            + (f"; read-only flush {row['ms_clean_l2']:.4f} (torch.matmul {row['library_ms_clean_l2']:.4f}), "
               f"profiler {row['profiler_ms']}" if "ms_clean_l2" in row else ""))
        del w, sliced, x
    return rows


def f32_decode_extras(torch, run, lib, clean):
    """An f32 decode row's times after the read-only flush ``clean`` (kernel
    and library call: no dirty lines to write back inside the call) and the
    kernel's own device ms in one profiled call (the event window adds the
    launch; None when the profiler sees no device time)."""
    ev, _ = profiled(torch, run)
    dev_us = sum(t for _, t in ev)
    return {"ms_clean_l2": time_ms(torch, run, flush=clean), "library_ms_clean_l2": time_ms(torch, lib, flush=clean),
            "profiler_ms": dev_us / 1e3 if dev_us else None}


def host_us(torch, fn, n_calls):
    """Host time of one call of fn, in us: n_calls calls queued back to back
    behind a spin that keeps the card busy, so the host never waits for the
    card; the wall time of the loop over n_calls, 5 loops (median, min, max)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spin: the queue never drains while the host enqueues the calls
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        walls.append((time.perf_counter() - t0) / n_calls * 1e6)
        torch.cuda.synchronize()
    walls.sort()
    return {"median": walls[2], "min": walls[0], "max": walls[4], "n": 5}


def host_us_per_call(torch, dev, cfg, log, tp_shard_matmul, n_calls=400):
    """Host time of one wrapper call (host_us) at TP 8 decode shapes (bf16
    and f32): the shapes whose device time is shortest."""
    d, hd = cfg.d_model, cfg.head_dim
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, mode, k, n_store, n in (("wk/wv TP 8 shard", "col", d, cfg.num_kv_heads * hd, hd),
                                          ("w_gate TP 8 shard", "col", d, cfg.d_ff, cfg.d_ff // 8)):
            w = torch.randn(k, n_store, device=dev).to(dtype)
            x = torch.randn(8, k, device=dev).to(dtype)
            key = f"{name} {str(dtype).split('.')[1]} M=8"
            out[key] = r = host_us(torch, lambda: tp_shard_matmul(x, w, n, n_out=n, mode="col"), n_calls)
            log(f"  host us per tp_shard_matmul call, {key}: {r['median']:.2f} (min {r['min']:.2f}, max {r['max']:.2f}, "
                f"5 loops of {n_calls})")
            del w, x
    return out


def check_one_launch(torch, dev, log):
    """Under torch.profiler, one call at split-K shapes launches one kernel
    and no splitk_reduce: w_gate and wk/wv (col) and w_out (row), at decode
    (M = 8) in bf16 and f32 and at prefill (M = 32 and 128) in f32. Fails
    when the profiler sees no device time in any of three sessions."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    seen = {}
    for dtype, ms in ((torch.bfloat16, (8,)), (torch.float32, (8, 32, 128))):
        for m in ms:
            for name, mode, k, n in (("w_gate col", "col", 4096, 14336), ("wk/wv col", "col", 4096, 1024),
                                     ("w_out row", "row", 14336, 4096)):
                x = torch.randn(m, k, device=dev).to(dtype)
                w = torch.randn(k, n, device=dev).to(dtype)
                seen[f"{name} {str(dtype).split('.')[1]} M={m}"] = kernels_in_one_call(
                    torch, lambda: tp_shard_matmul(x, w, 0, n_out=n, mode=mode))
                del x, w
    for key, kernels in seen.items():
        check(kernels is not None, f"{key}: the profiler saw device time in one of twelve sessions")
        check(sum(kernels.values()) == 1 and not any("splitk_reduce" in k for k in kernels),
              f"one {key} tp_shard_matmul call launches one kernel, no splitk_reduce: {kernels}")
    log(f"tp_shard_matmul: one decode or prefill call under torch.profiler launches one kernel: {json.dumps(seen)}")
    return seen


def measure_paged(torch, dev, cfg, flush, log):
    """Decode attention of llama3-8b at the engine's layout: 8 slots, 8 KV
    heads, G = 4, hd = 128, pages of 16 over max_len 256."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref, paged_decode_attention_split_ref

    B, S, page = 8, 256, 16
    KV, hd, G = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    n_pages = S // page
    lens_np = np.random.RandomState(0).randint(5, 145, size=B).astype(np.int32)  # prompts 4..120 + up to 24 tokens
    g = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q = torch.randn(B, KV, G, hd, generator=g, device=dev).to(dtype)
        kc = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
        vc = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
        kp, vp = kc.view(B * n_pages, page, KV, hd), vc.view(B * n_pages, page, KV, hd)
        tables = torch.arange(B * n_pages, dtype=torch.int32, device=dev).view(B, n_pages)
        lens = torch.from_numpy(lens_np).to(dev)
        run = lambda: paged_decode_attention(q, kp, vp, tables, lens)  # noqa: E731
        got, want = run().float(), paged_decode_attention_ref(q, kp, vp, tables, lens).float()
        split = paged_decode_attention_split_ref(q, kp, vp, tables, lens).float()
        err, err_split = (got - want).abs().max().item(), (got - split).abs().max().item()
        # both sum in f32 and round once: bf16 within ~2 ulp of |plain|
        rel, atol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 1e-3)
        check(((got - want).abs() - rel * want.abs()).max().item() <= atol, f"paged main shape {dname}: err {err}")
        check(((got - split).abs() - rel * split.abs()).max().item() <= atol, f"paged main shape {dname}: split err {err_split}")
        tol = f"{atol} abs + {rel} x |plain|"
        # yardstick: SDPA over the densified cache, heads grouped as in the kernel
        qs = q.reshape(B, KV * G, 1, hd)
        ks, vs = kc.permute(0, 2, 1, 3).contiguous(), vc.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(S, device=dev)[None] < lens[:, None].long())[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)  # noqa: E731
        live = int(lens_np.sum())
        es = q.element_size()
        nbytes = es * (2 * q.numel() + 2 * live * KV * hd) + 4 * (tables.numel() + B)
        b_ms, b_by = bound_ms(nbytes, 4.0 * live * KV * G * hd, dname)
        row = {"shape": f"{dname} B={B} KV={KV} G={G} hd={hd} page={page} n_pages={n_pages} live_tokens={live}",
               "max_abs_err": err, "max_abs_err_vs_split": err_split, "tol": tol, "ms": time_ms(torch, run, flush=flush),
               "plain_ms": time_ms(torch, lambda: paged_decode_attention_ref(q, kp, vp, tables, lens), flush=flush),
               "library_ms": time_ms(torch, lib, flush=flush), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(f"  {row['shape']}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}), plain {row['plain_ms']:.4f}, "
            f"SDPA {row['library_ms']:.4f}, err {err:.3g}, vs the split version {err_split:.3g} (tol {row['tol']})")
    return rows


def measure_paged_long(torch, dev, cfg, flush, log, paged_decode_attention, check_plain=True):
    """Decode attention over 16 sequences x 2048 tokens of llama3-8b KV in
    the phase-3 fragmented pool (one layer of it), bf16, page 16: the kernel
    against its plain versions, beside its byte bound and SDPA over the
    densified cache. ``check_plain=False`` only times the kernel (for
    --timings-of, whose tree may lack the split version)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

    n_seqs, ctx = 16, 2048
    KV, hd, G = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    pool = fragmented_pool(torch, dev, dataclasses.replace(cfg, num_layers=1), ctx, n_seqs, seed=30)
    seqs = list(range(n_seqs))
    tables = torch.from_numpy(pool.block_table_array(seqs)).to(dev)
    lens = torch.tensor([pool.seq_lens[s] for s in seqs], dtype=torch.int32, device=dev)
    kp, vp = pool.k_pages[0], pool.v_pages[0]
    q = torch.randn(n_seqs, KV, G, hd, generator=torch.Generator(device=dev).manual_seed(31), device=dev)
    q = q.to(torch.bfloat16)
    run = lambda: paged_decode_attention(q, kp, vp, tables, lens)  # noqa: E731
    live = int(lens.sum().item())
    nbytes = 2 * (2 * q.numel() + 2 * live * KV * hd) + 4 * (tables.numel() + n_seqs)
    b_ms, b_by = bound_ms(nbytes, 4.0 * live * KV * G * hd, "bfloat16")
    shape = (f"bfloat16 B={n_seqs} KV={KV} G={G} hd={hd} page={pool.page_size} {ctx} tokens each, "
             f"fragmented pool of {pool.num_pages} pages")
    clean = ReadFlush(torch, dev)
    row = {"shape": shape, "ms": time_ms(torch, run, flush=flush), "ms_clean_l2": time_ms(torch, run, flush=clean),
           "bound_ms": b_ms, "bound_by": b_by}
    if check_plain:
        from repro_torch.kernels.paged_attention.ref import paged_decode_attention_split_ref

        got = run().float()
        worst = {}
        for name, fn in (("dense", paged_decode_attention_ref), ("split", paged_decode_attention_split_ref)):
            want = fn(q, kp, vp, tables, lens).float()
            worst[name] = (got - want).abs().max().item()
            check(((got - want).abs() - 8e-3 * want.abs()).max().item() <= 1e-3,
                  f"paged long context vs the {name} plain version: err {worst[name]}")
        dense = kp[tables.long()].reshape(n_seqs, ctx, KV, hd), vp[tables.long()].reshape(n_seqs, ctx, KV, hd)
        ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in dense)
        del dense
        qs = q.reshape(n_seqs, KV * G, 1, hd)  # every token live: no mask
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)  # noqa: E731
        want = lib().reshape(q.shape).float()
        check(((got - want).abs() - 8e-3 * want.abs()).max().item() <= 1e-3, "paged long context vs SDPA")
        row.update(max_abs_err=worst["dense"], max_abs_err_vs_split=worst["split"],
                   tol="0.001 abs + 0.008 x |plain|",
                   plain_ms=time_ms(torch, lambda: paged_decode_attention_ref(q, kp, vp, tables, lens), flush=flush),
                   library_ms=time_ms(torch, lib, flush=flush), library_ms_clean_l2=time_ms(torch, lib, flush=clean))
        del ks, vs
    log(f"  {shape}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, {b_ms / row['ms']:.2f} of it; "
        f"{row['ms_clean_l2']:.4f} after a read-only flush)"
        + (f", plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f} ({row['library_ms_clean_l2']:.4f} after a "
           f"read-only flush), err {row['max_abs_err']:.3g}, vs the split version {row['max_abs_err_vs_split']:.3g} "
           f"(tol {row['tol']})" if check_plain else ""))
    del pool, clean
    return row


def paged_breakdown(torch, dev, cfg, flush, log, paged_decode_attention):
    """Device ms of one call at the engine's layout (8 slots, 8 KV heads,
    G 4, hd 128, pages of 16 over max_len 256, identity tables), bf16, every
    row at one length: seq_len 1 gives the fixed cost, 32 to 256 the cost of
    the tokens. The wrapper is an argument, so --timings-of times the
    kernel of another tree."""
    B, S, page = 8, 256, 16
    KV, hd, G = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, KV, G, hd, generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn(B * S // page, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn(B * S // page, page, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    tables = torch.arange(B * S // page, dtype=torch.int32, device=dev).view(B, S // page)
    out = {}
    for L in (1, 32, 64, 96, 128, 160, 192, 224, 256):
        lens = torch.full((B,), L, dtype=torch.int32, device=dev)
        out[str(L)] = time_ms(torch, lambda: paged_decode_attention(q, kp, vp, tables, lens), flush=flush)
    log(f"  paged_decode_attention breakdown, bf16, B={B} KV={KV} G={G} hd={hd} page={page}, every row at "
        f"seq_len L: ms by L {json.dumps({k: round(v, 5) for k, v in out.items()})}")
    return out


def check_paged_one_launch(torch, dev, cfg, log):
    """Under torch.profiler, one call launches one kernel: at the engine's
    layout with rows of one, two and three splits (merged in the launch).
    Fails when the profiler sees no device time in any of three sessions."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention

    KV, hd, G = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    q = torch.randn(8, KV, G, hd, device=dev).to(torch.bfloat16)
    kp = torch.randn(128, 16, KV, hd, device=dev).to(torch.bfloat16)
    vp = torch.randn_like(kp)
    tables = torch.arange(128, dtype=torch.int32, device=dev).view(8, 16)
    lens = torch.tensor([1, 64, 65, 100, 128, 129, 192, 256], dtype=torch.int32, device=dev)
    kernels = kernels_in_one_call(torch, lambda: paged_decode_attention(q, kp, vp, tables, lens))
    check(kernels is not None, "paged_decode_attention: the profiler saw device time in one of twelve sessions")
    check(sum(kernels.values()) == 1 and all("paged_decode" in k for k in kernels),
          f"one paged_decode_attention call launches one kernel: {kernels}")
    log(f"paged_decode_attention: one call (rows of 1 to 4 splits) under torch.profiler launches {kernels}")
    return kernels


# ---------------------------------------------------------------------------
# phase 2, the windowed models' new instances: decode attention at hd 80
# (h2o-danube-1.8b) and 256 (gemma2-2b), and the tied head (col_t)
# ---------------------------------------------------------------------------
WINDOWED = ("h2o-danube-1.8b", "gemma2-2b")


def attention_geometry(cfg):
    """(KV heads, G, hd, softcap) of a model's decode attention."""
    return cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cfg.attn.logit_softcap


def paged_close(torch, got, want, dtype, f32_tol):
    """f32: |got - want| <= f32_tol (abs and x |want|); bf16: 1e-3 + 8e-3 x |want|."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        return ((got - want).abs() - f32_tol * want.abs()).max().item() <= f32_tol
    return ((got - want).abs() - 8e-3 * want.abs()).max().item() <= 1e-3


def dense_window_case(torch, dev, dtype, KV, G, hd, lens, Sc, seed, page=16):
    """The engine's layout: a dense (8, Sc, KV, hd) slot cache viewed as
    pages of 16 with identity tables, rows of ``lens`` live tokens."""
    B = len(lens)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, KV, G, hd, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, Sc, KV, hd, generator=g, device=dev).to(dtype)
    tables = torch.arange(B * Sc // page, dtype=torch.int32, device=dev).view(B, Sc // page)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, kc.view(-1, page, KV, hd), vc.view(-1, page, KV, hd), tables, lens_t


def check_paged_windowed(torch, dev, log):
    """hd 80 and 256, f32 and bf16, against the dense and split plain
    versions: rows at every split boundary over a permuted table, and 8
    full-window rows (8 x 4096 tokens, seq_len = Sc: a wrapped buffer; more
    splits than a wave holds, so blocks walk several; f32 at hd 256 on one
    ring slot) with the model's softcap; a full-window row alone equals it
    in the batch, bit for bit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import (
        T_SPLIT, paged_decode_attention_ref, paged_decode_attention_split_ref,
    )

    worst = {}
    for name in WINDOWED:
        KV, G, hd, cap = attention_geometry(get_config(name))
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            g = torch.Generator(device=dev).manual_seed(hd)
            lens = [1, T_SPLIT - 1, T_SPLIT, T_SPLIT + 1, 2 * T_SPLIT, 2 * T_SPLIT + 1, 3 * T_SPLIT - 1, 3 * T_SPLIT]
            n_pages, P = 3 * T_SPLIT // 16, 8 * 3 * T_SPLIT // 16 + 3
            perm = np.random.RandomState(hd).permutation(P)[: 8 * n_pages].reshape(8, n_pages).astype(np.int32)
            q = torch.randn(8, KV, G, hd, generator=g, device=dev).to(dtype)
            kp = torch.randn(P, 16, KV, hd, generator=g, device=dev).to(dtype)
            vp = torch.randn(P, 16, KV, hd, generator=g, device=dev).to(dtype)
            cases = {"split boundaries": (q, kp, vp, torch.from_numpy(perm).to(dev),
                                          torch.tensor(lens, dtype=torch.int32, device=dev))}
            full = dense_window_case(torch, dev, dtype, KV, G, hd, [4096] * 7 + [4000], 4096, seed=hd + 1)
            cases["8 x 4096 full window"] = (full[0],) + full[3:]
            for case, args in cases.items():
                got = paged_decode_attention(*args, softcap=cap)
                for ref_name, fn, tol in (("dense", paged_decode_attention_ref, 2e-5),
                                          ("split", paged_decode_attention_split_ref, 5e-6)):
                    want = fn(*args, softcap=cap)
                    err = (got.float() - want.float()).abs().max().item()
                    check(paged_close(torch, got, want, dtype, tol), f"paged {name} hd {hd} {dname} {case} vs {ref_name}: "
                                                                      f"err {err}")
                    key = f"{name} hd {hd} {dname} vs {ref_name}"
                    worst[key] = max(worst.get(key, 0.0), err)
            q, _, _, kp, vp, tables, lens_t = full
            batch = paged_decode_attention(q, kp, vp, tables, lens_t, softcap=cap)
            alone = paged_decode_attention(q[7:].contiguous(), kp, vp, tables[7:].contiguous(), lens_t[7:].contiguous(),
                                           softcap=cap)
            check(torch.equal(alone[0], batch[7]), f"paged {name} hd {hd} {dname}: a row alone equals it in the batch")
            del full, kp, vp, cases, args, got, want
    log(f"paged_decode_attention hd 80 / 256 (split boundaries; 8 x 4096 full window, softcap as the model; "
        f"tol f32 2e-5 dense, 5e-6 split; bf16 1e-3 + 8e-3 |plain|): max |err| {json.dumps(worst)}; "
        f"a full-window row alone equals it in the batch")
    return worst


def check_col_t(torch, dev, log):
    """The tied head: gemma2-2b's (256000, 2304) embedding read transposed
    in place, f32 logits, against the plain version at each rank's vocab
    offset for TP 1/2/4, M = 8 (decode) and 1 (prefill's last token), f32
    and bf16; bit-identical to the pre-sliced rows; again with the storage
    2 (bf16) or 4 (f32) bytes past a 16-byte boundary (32768 rows: the
    producer warp's or scalar loads in place against TMA or vector loads on
    the pre-sliced copy); NaN in the rows around a shard stays out."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

    cfg = get_config("gemma2-2b")
    V, d, f32 = cfg.vocab_padded, cfg.d_model, torch.float32
    g = torch.Generator(device=dev).manual_seed(9)
    worst, n_cases = {}, 0

    def head(x, w, off, n):
        return tp_shard_matmul(x, w, off, n_out=n, mode="col_t", out_dtype=f32)

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        w = (torch.randn(V, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
        x8 = torch.randn(8, d, generator=g, device=dev).to(dtype)
        for tp in (1, 2, 4):
            n = V // tp
            for r in range(tp):
                sliced = w[r * n:(r + 1) * n].contiguous()
                for x in (x8, x8[:1].contiguous()):
                    got = head(x, w, r * n, n)
                    want = tp_shard_matmul_ref(x, w, r * n, mode="col_t", n_out=n, out_dtype=f32)
                    ratio = (got - want).abs().max().item() / want.abs().max().item()
                    check(ratio <= 1e-5, f"col_t {dname} tp={tp} rank={r} M={x.shape[0]}: err {ratio:.3g} x max|plain|")
                    worst[dname] = max(worst.get(dname, 0.0), ratio)
                    check(torch.equal(got, head(x, sliced, 0, n)), f"col_t {dname} tp={tp} rank={r}: presliced")
                    n_cases += 1
                del sliced
        Vm = min(32768, V)
        buf = (torch.randn(Vm * d + 1, generator=g, device=dev) / math.sqrt(d)).to(dtype)
        store = buf[1:].view(Vm, d)
        check(store.data_ptr() % 16 != 0, "misaligned storage")
        for tp in (1, 2, 4):
            n = Vm // tp
            for r in range(tp):
                check(torch.equal(head(x8, store, r * n, n), head(x8, store[r * n:(r + 1) * n].contiguous(), 0, n)),
                      f"col_t {dname} misaligned storage tp={tp} rank={r}: presliced")
        poisoned = w[:Vm].clone()
        poisoned[:Vm // 4] = poisoned[Vm // 2:] = float("nan")
        got = head(x8, poisoned, Vm // 4, Vm // 4)
        want = tp_shard_matmul_ref(x8, poisoned, Vm // 4, mode="col_t", n_out=Vm // 4, out_dtype=f32)
        check(bool(torch.isfinite(got).all()) and (got - want).abs().max().item() <= 1e-5 * want.abs().max().item(),
              f"col_t {dname}: NaN around the shard stays out")
        del w, buf, store, poisoned
    log(f"tp_shard_matmul col_t (tied head, gemma2-2b's 256000 x 2304 embedding in place): {n_cases} shard cases at "
        f"TP 1/2/4, M 8 and 1, worst max|err| / max|plain| {json.dumps(worst)} (tol 1e-5); in place bit-identical "
        f"to the pre-sliced rows, also from misaligned storage; NaN around the shard stays out")
    return {"cases": n_cases, "worst_err_over_max_plain": worst}


def check_windowed_one_launch(torch, dev, log):
    """Each new instance, one call under torch.profiler, launches one
    kernel: attention at hd 80 and 256 (f32 and bf16; f32 hd 256 on one
    ring slot) over 8 full-window rows, and col_t at gemma2's head (bf16
    and f32, M = 8). Fails when the profiler sees no device time in any of
    three sessions."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    seen = {}
    for name, dtype in ((n, dt) for n in WINDOWED for dt in (torch.bfloat16, torch.float32)):
        KV, G, hd, cap = attention_geometry(get_config(name))
        q, _, _, kp, vp, tables, lens = dense_window_case(torch, dev, dtype, KV, G, hd, [4096] * 8, 4096, seed=2)
        seen[f"paged_decode_attention hd {hd} {str(dtype).split('.')[1]}"] = kernels_in_one_call(
            torch, lambda: paged_decode_attention(q, kp, vp, tables, lens, softcap=cap))
        del q, kp, vp
    cfg = get_config("gemma2-2b")
    for dtype in (torch.bfloat16, torch.float32):
        w = torch.randn(cfg.vocab_padded, cfg.d_model, device=dev).to(dtype)
        x = torch.randn(8, cfg.d_model, device=dev).to(dtype)
        seen[f"tp_shard_matmul col_t {str(dtype).split('.')[1]}"] = kernels_in_one_call(
            torch, lambda: tp_shard_matmul(x, w, 0, n_out=cfg.vocab_padded, mode="col_t", out_dtype=torch.float32))
        del w, x
    for key, kernels in seen.items():
        check(kernels is not None, f"{key}: the profiler saw device time in one of twelve sessions")
        check(sum(kernels.values()) == 1, f"one {key} call launches one kernel: {kernels}")
    log(f"new instances under torch.profiler, one kernel per call: {json.dumps(seen)}")
    return seen


def measure_windowed(torch, dev, flush, log):
    """Decode attention of each windowed model at its engine shape (8 slots
    of phase 6's decode mix, 12 steps in, over the 4096-row window cache of
    a local or sliding layer) and over 8 full-window rows, f32 and bf16,
    against the kernel's bound, its plain version and SDPA over the dense
    cache; and the tied head (measure_tied_head)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref
    from repro_torch.testing.multicard import WINDOWED_PROMPTS

    att = []
    engine_lens = [min(n + 12, 4096) for n in WINDOWED_PROMPTS[:8]]
    for name in WINDOWED:
        KV, G, hd, cap = attention_geometry(get_config(name))
        for label, lens in (("engine shape", engine_lens), ("8 x 4096 full window", [4096] * 8)):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                q, kc, vc, kp, vp, tables, lens_t = dense_window_case(torch, dev, dtype, KV, G, hd, lens, 4096, seed=5)
                run = lambda: paged_decode_attention(q, kp, vp, tables, lens_t, softcap=cap)  # noqa: E731
                plain = lambda: paged_decode_attention_ref(q, kp, vp, tables, lens_t, softcap=cap)  # noqa: E731
                got, want = run(), plain()
                err = (got.float() - want.float()).abs().max().item()
                check(paged_close(torch, got, want, dtype, 2e-5), f"paged {name} {label} {dname}: err {err}")
                qs, ks, vs = q.reshape(8, KV * G, 1, hd), kc.permute(0, 2, 1, 3).contiguous(), vc.permute(0, 2, 1, 3).contiguous()
                mask = (torch.arange(4096, device=dev)[None] < lens_t[:, None].long())[:, None, None, :]
                lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)  # noqa: E731
                live = sum(lens)
                es = q.element_size()
                b_ms, b_by = bound_ms(es * (2 * q.numel() + 2 * live * KV * hd) + 4 * (tables.numel() + 8),
                                      4.0 * live * KV * G * hd, dname)
                row = {"model": name, "shape": f"{name} {label} {dname} B=8 KV={KV} G={G} hd={hd} page=16 Sc=4096 "
                                                f"live_tokens={live}" + (f" softcap {cap}" if cap else ""),
                       "max_abs_err": err, "tol": "2e-5 (f32) or 1e-3 + 8e-3 |plain| (bf16)",
                       "ms": time_ms(torch, run, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
                       "library_ms": time_ms(torch, lib, flush=flush), "bound_ms": b_ms, "bound_by": b_by}
                att.append(row)
                log(f"  {row['shape']}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, {b_ms / row['ms']:.2f} of it), "
                    f"plain {row['plain_ms']:.4f}, SDPA (softcap not applied) {row['library_ms']:.4f}, err {err:.3g}")
                del q, kc, vc, kp, vp, ks, vs
    return att, measure_tied_head(torch, dev, flush, log)


def measure_tied_head(torch, dev, flush, log, dtypes=None):
    """The tied head at decode (x (8, 2304) against gemma2's 256000 x 2304
    embedding, f32 logits), whole and rank 1's vocab rows at TP 2 and 4,
    against torch.matmul(x, w.t()), bf16 and f32 (or ``dtypes``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

    heads = []
    cfg = get_config("gemma2-2b")
    V, d = cfg.vocab_padded, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(12)
    clean = ReadFlush(torch, dev)
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        w = (torch.randn(V, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
        x = torch.randn(8, d, generator=g, device=dev).to(dtype)
        for tp in (1, 2, 4):
            n, off = V // tp, (V // tp if tp > 1 else 0)  # rank 1's vocab rows
            sliced = w[off:off + n]
            run = lambda: tp_shard_matmul(x, w, off, n_out=n, mode="col_t", out_dtype=torch.float32)  # noqa: E731
            plain = lambda: tp_shard_matmul_ref(x, w, off, mode="col_t", n_out=n, out_dtype=torch.float32)  # noqa: E731
            got, want = run(), plain()
            err = (got - want).abs().max().item()
            check(err <= 1e-5 * want.abs().max().item(), f"col_t {dname} TP {tp}: err {err}")
            es = x.element_size()
            b_ms, b_by = bound_ms(es * (8 * d + n * d) + 4 * 8 * n, 2.0 * 8 * d * n, dname)
            row = {"shape": f"col_t tied head {dname} M=8 K={d} N={n}" + (f" (TP {tp} rank 1 rows)" if tp > 1 else ""),
                   "max_abs_err": err, "tol": f"1e-5 x max|plain| = {1e-5 * want.abs().max().item():.3g}",
                   "ms": time_ms(torch, run, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
                   "library_ms": time_ms(torch, lambda: torch.matmul(x, sliced.t()).float(), flush=flush),
                   "bound_ms": b_ms, "bound_by": b_by}
            if dtype == torch.float32:
                row.update(f32_decode_extras(torch, run, lambda: torch.matmul(x, sliced.t()), clean))
            heads.append(row)
            log(f"  {row['shape']}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, {b_ms / row['ms']:.2f} of it), "
                f"plain {row['plain_ms']:.4f}, torch.matmul(x, w.t()).float() {row['library_ms']:.4f}, err {err:.3g}")
        del w, x, sliced
    return heads


# ---------------------------------------------------------------------------
# phase 2, the instances of phases 7 and 8: decode attention at each new
# model's engine geometry, and the matmul at their widths and heads
# ---------------------------------------------------------------------------
NEW_MODELS = ("musicgen-large", "moonshot-v1-16b-a3b", "yi-34b", "mistral-large-123b", "dbrx-132b")


def engine_geometry(cfg):
    """(KV, G, hd) of the engine's decode attention: the cache keeps the
    largest TP level's (8) KV heads."""
    from repro_torch.parallel.sharding import make_exec_config

    ec = make_exec_config(cfg, 8)
    return ec.kv_exec, ec.q_per_kv, cfg.head_dim


def measure_new_attention(torch, dev, flush, log):
    """Decode attention at each new model's engine geometry (musicgen hd 64
    G 1 over 32 KV heads, moonshot hd 128 G 1, yi-34b G 7, mistral G 12,
    dbrx G 6), f32 and bf16, over the engine's dense 8 x 256-row slot cache
    in pages of 16: rows at every split boundary, held to the dense and the
    split plain versions; and rows of the engine's decode mix (make_requests'
    first 8 prompts, 12 steps in), held to the plain version and timed
    beside the bound, the plain version and SDPA over the dense cache."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.paged_attention.ref import (
        T_SPLIT, paged_decode_attention_ref, paged_decode_attention_split_ref,
    )

    Sc, rows, worst = 256, [], {}
    bounds = [1, T_SPLIT - 1, T_SPLIT, T_SPLIT + 1, 2 * T_SPLIT, 2 * T_SPLIT + 1, 3 * T_SPLIT - 1, Sc]
    for name in NEW_MODELS:
        cfg = get_config(name)
        KV, G, hd = engine_geometry(cfg)
        mix = [min(len(r.prompt) + 12, Sc) for r in make_requests(cfg)[:8]]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            for label, lens in (("split boundaries", bounds), ("engine shape", mix)):
                q, kc, vc, kp, vp, tables, lens_t = dense_window_case(torch, dev, dtype, KV, G, hd, lens, Sc, seed=hd + G)
                run = lambda: paged_decode_attention(q, kp, vp, tables, lens_t)  # noqa: E731
                got, errs = run(), {}
                for ref_name, fn, tol in (("dense", paged_decode_attention_ref, 2e-5),
                                          ("split", paged_decode_attention_split_ref, 5e-6)):
                    want = fn(q, kp, vp, tables, lens_t)
                    errs[ref_name] = err = (got.float() - want.float()).abs().max().item()
                    check(paged_close(torch, got, want, dtype, tol), f"paged {name} {label} {dname} vs {ref_name}: "
                                                                      f"err {err}")
                    key = f"G {G} hd {hd} {dname} vs {ref_name}"
                    worst[key] = max(worst.get(key, 0.0), err)
                if label == "engine shape":
                    plain = lambda: paged_decode_attention_ref(q, kp, vp, tables, lens_t)  # noqa: E731
                    qs = q.reshape(8, KV * G, 1, hd)
                    ks, vs = kc.permute(0, 2, 1, 3).contiguous(), vc.permute(0, 2, 1, 3).contiguous()
                    mask = (torch.arange(Sc, device=dev)[None] < lens_t[:, None].long())[:, None, None, :]
                    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)  # noqa: E731
                    live = sum(lens)
                    b_ms, b_by = bound_ms(q.element_size() * (2 * q.numel() + 2 * live * KV * hd) + 4 * (tables.numel() + 8),
                                          4.0 * live * KV * G * hd, dname)
                    err = errs["dense"]
                    row = {"model": name, "shape": f"{name} engine shape {dname} B=8 KV={KV} G={G} hd={hd} page=16 "
                                                   f"Sc={Sc} live_tokens={live}",
                           "max_abs_err": err, "tol": "2e-5 (f32) or 1e-3 + 8e-3 |plain| (bf16)",
                           "ms": time_ms(torch, run, flush=flush), "plain_ms": time_ms(torch, plain, flush=flush),
                           "library_ms": time_ms(torch, lib, flush=flush), "bound_ms": b_ms, "bound_by": b_by}
                    rows.append(row)
                    log(f"  {row['shape']}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, {b_ms / row['ms']:.2f} of "
                        f"it), plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, err {err:.3g}")
                    del ks, vs, qs
                del q, kc, vc, kp, vp, got, want
    log(f"paged_decode_attention at the new models' geometries (split boundaries and the engine's mix; tol f32 2e-5 "
        f"dense, 5e-6 split; bf16 1e-3 + 8e-3 |plain|): max |err| {json.dumps(worst)}")
    return rows, worst


def new_matmul_cases(torch):
    """tp_shard_matmul at the new models' widths: yi-34b (K 7168, N 20480),
    mistral-large-123b (K 12288, N 28672), moonshot's d 2048 and its
    163840-row head, musicgen's 2048-entry head; decode (M 8) at TP 1 and a
    TP 8 rank's shard in bf16, decode and prefill (M 128) in f32 and bf16."""
    shapes = [("yi-34b", ("wq/wo col", "col", 7168, 7168)), ("yi-34b", ("w_gate/w_in col", "col", 7168, 20480)),
              ("yi-34b", ("w_out row", "row", 20480, 7168)),
              ("mistral-large-123b", ("w_gate/w_in col", "col", 12288, 28672)),
              ("mistral-large-123b", ("w_out row", "row", 28672, 12288)),
              ("moonshot-v1-16b-a3b", ("wq/wo col", "col", 2048, 2048)),
              ("moonshot-v1-16b-a3b", ("lm_head col f32-out", "col", 2048, 163840)),
              ("musicgen-large", ("lm_head col f32-out", "col", 2048, 2048))]
    bf, f32 = torch.bfloat16, torch.float32
    return [(model, shape, m, dt, tp) for model, shape in shapes
            for m, dt, tp in ((8, bf, 1), (8, bf, 8), (128, bf, 1), (8, f32, 1), (128, f32, 1))]


def check_new_one_launch(torch, dev, log):
    """One call of each kind of new instance under torch.profiler launches
    one kernel: attention at mistral's G 12 and musicgen's hd 64 over 32 KV
    heads, the matmul at mistral's w_out (row) and moonshot's head, bf16
    and f32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    seen = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for name in ("mistral-large-123b", "musicgen-large"):
            KV, G, hd = engine_geometry(get_config(name))
            q, _, _, kp, vp, tables, lens = dense_window_case(torch, dev, dtype, KV, G, hd, [200] * 8, 256, seed=3)
            seen[f"paged_decode_attention G {G} hd {hd} {dname}"] = kernels_in_one_call(
                torch, lambda: paged_decode_attention(q, kp, vp, tables, lens))
            del q, kp, vp
        for label, k, n, mode, m in (("w_out row 28672 x 12288", 28672, 12288, "row", 8),
                                     ("lm_head 2048 x 163840", 2048, 163840, "col", 128)):
            w = torch.randn(k, n, device=dev).to(dtype)
            x = torch.randn(m, k, device=dev).to(dtype)
            seen[f"tp_shard_matmul {label} M={m} {dname}"] = kernels_in_one_call(
                torch, lambda: tp_shard_matmul(x, w, 0, n_out=n, mode=mode))
            del w, x
    for key, kernels in seen.items():
        check(kernels is not None, f"{key}: the profiler saw device time in one of twelve sessions")
        check(sum(kernels.values()) == 1, f"one {key} call launches one kernel: {kernels}")
    log(f"phase 7 and 8 instances under torch.profiler, one kernel per call: {json.dumps(seen)}")
    return seen


def check_kv_sweeps(torch, dev, cfg, log):
    """kv_gather / kv_scatter bit for bit against their plain versions: the
    reference test shapes in f32 and bf16, a llama3-8b page row (F = 16384,
    bf16) with permuted ids, the in-place round trip, rows not named left
    untouched, and the byte path (odd row bytes; a base 2 bytes off a
    16-byte boundary)."""
    import numpy as np

    from repro_torch.kernels.kv_gather.ops import kv_gather, kv_scatter
    from repro_torch.kernels.kv_gather.ref import kv_gather_ref, kv_scatter_ref

    g = torch.Generator(device=dev).manual_seed(6)
    F_page = 16 * cfg.num_kv_heads * cfg.head_dim
    cases = [(P, F, n, dt) for dt in (torch.float32, torch.bfloat16) for P, F, n in ((16, 128, 4), (64, 256, 64), (8, 512, 1))]
    cases += [(512, F_page, 300, torch.bfloat16), (16, 129, 7, torch.uint8)]
    n_checks = 0
    for P, F, n, dt in cases:
        if dt == torch.uint8:
            pool = torch.randint(0, 256, (P, F), generator=g, device=dev, dtype=torch.uint8)
        else:
            pool = torch.randn(P, F, generator=g, device=dev).to(dt)
        ids = np.random.RandomState(P + n).permutation(P)[:n]
        staged = kv_gather(pool, ids)
        check(torch.equal(staged, kv_gather_ref(pool, ids)), f"kv_gather ({P},{F},{n}) {dt} bit for bit")
        ptr, orig = pool.data_ptr(), pool.clone()
        check(kv_scatter(pool, staged, ids) is pool and pool.data_ptr() == ptr and torch.equal(pool, orig),
              f"scatter(gather(pool, ids), ids) leaves pool ({P},{F},{n}) {dt} unchanged, in place")
        other = staged.flip(0).contiguous() if n > 1 else staged + 1
        want = kv_scatter_ref(pool.clone(), other, ids)
        kv_scatter(pool, other, ids)
        rest = torch.from_numpy(np.setdiff1d(np.arange(P), ids)).to(dev)
        check(torch.equal(pool, want) and torch.equal(pool[rest], orig[rest]),
              f"kv_scatter ({P},{F},{n}) {dt} bit for bit, rows not named untouched")
        n_checks += 1
    buf = torch.randn(33 * 256 + 1, generator=g, device=dev).to(torch.bfloat16)
    pool, head = buf[1:].view(33, 256), buf[:1].clone()
    check(pool.data_ptr() % 16 == 2, "misaligned base")
    ids = np.random.RandomState(0).permutation(33)[:9]
    staged = kv_gather(pool, ids)
    check(torch.equal(staged, kv_gather_ref(pool, ids)), "kv_gather at a misaligned base")
    want = kv_scatter_ref(pool.clone(), staged * 2, ids)
    kv_scatter(pool, staged * 2, ids)
    check(torch.equal(pool, want) and torch.equal(buf[:1], head), "kv_scatter at a misaligned base")
    torch.cuda.synchronize()
    log(f"kv_gather/kv_scatter: {n_checks} shapes (reference sweeps f32/bf16, llama3-8b row F={F_page} bf16, "
        f"odd rows uint8) plus a misaligned base: bit for bit, round trip in place, rows not named untouched")


def fragmented_pool(torch, dev, cfg, ctx, n_seqs, seed):
    """benchmarks/fig7_kv_migration.py's fragmentation at llama3-8b's page
    geometry: n_seqs sequences grown a page at a time, interleaved, in a
    bf16 pool of 9/8 the pages they need, filled from a seeded generator."""
    from repro_torch.serving.kv_cache import PagedPool

    page = 16
    need = n_seqs * ctx // page
    pool = PagedPool(num_pages=need * 9 // 8, page_size=page, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                     n_layers=cfg.num_layers, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    pool.k_pages.normal_(generator=g)
    pool.v_pages.normal_(generator=g)
    for s in range(n_seqs):
        pool.alloc_seq(s, page)
    for _ in range(ctx // page - 1):
        for s in range(n_seqs):
            pool.extend_seq(s, page)
    return pool


def migration_phase(torch, dev, cfg, flush, log):
    """Paged KV migration at llama3-8b's page geometry, at two payloads.
    Returns (launches of the kv kernels in the larger migrate_pages call,
    per-size records)."""
    import numpy as np

    from repro_torch.core.migration import kv_migration_bytes, migrate_pages
    from repro_torch.kernels.kv_gather.ops import _gather, kv_gather, kv_scatter
    from repro_torch.kernels.kv_gather.ref import kv_gather_ref, kv_scatter_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.serving.kv_cache import PagedPool

    n_seqs, G = 16, cfg.num_heads // cfg.num_kv_heads
    seqs = list(range(n_seqs))
    records, launches = {}, None
    for ctx in (256, 2048):
        src = fragmented_pool(torch, dev, cfg, ctx, n_seqs, seed=10 + ctx)
        dst = PagedPool(num_pages=src.num_pages, page_size=src.page_size, kv_heads=src.kv_heads,
                        head_dim=src.head_dim, n_layers=src.n_layers, dtype=src.dtype, device=dev)
        F = src.page_rows("k").shape[1]
        row_bytes = F * src.k_pages.element_size()
        kv_gather.launches = kv_scatter.launches = 0
        tables, first_s = migrate_pages(src, dst, seqs)
        counts = {"kv_gather": kv_gather.launches, "kv_scatter": kv_scatter.launches}
        check(counts == {"kv_gather": 2, "kv_scatter": 2}, f"migrate_pages launched 2 gathers and 2 scatters: {counts}")
        launches = counts
        for s in seqs:  # every page of every layer, bit for bit
            for kind in ("k_pages", "v_pages"):
                a, b = getattr(dst, kind)[:, dst.tables[s]], getattr(src, kind)[:, src.tables[s]]
                check(torch.equal(a, b), f"ctx {ctx}: sequence {s} {kind} equal after migration")
        g = torch.Generator(device=dev).manual_seed(20 + ctx)
        lens = torch.tensor([src.seq_lens[s] for s in seqs], dtype=torch.int32, device=dev)
        t_dst = torch.from_numpy(tables).to(dev)
        t_src = torch.from_numpy(src.block_table_array(seqs)).to(dev)
        for layer in range(cfg.num_layers):
            q = torch.randn(n_seqs, cfg.num_kv_heads, G, cfg.head_dim, generator=g, device=dev).to(torch.bfloat16)
            a = paged_decode_attention(q, dst.k_pages[layer], dst.v_pages[layer], t_dst, lens)
            b = paged_decode_attention(q, src.k_pages[layer], src.v_pages[layer], t_src, lens)
            check(torch.equal(a, b), f"ctx {ctx}: decode attention over dst == over src, layer {layer}")
        moved = 2 * cfg.num_layers * n_seqs * (ctx // 16) * row_bytes
        rec = {"tokens_per_seq": ctx, "n_seqs": n_seqs, "pages_per_layer": src.num_pages, "bytes_moved": moved,
               "page_rows": 2 * cfg.num_layers * n_seqs * (ctx // 16),
               "fragmentation_src": src.fragmentation(), "fragmentation_dst": dst.fragmentation(),
               "kv_migration_bytes_tp1_to_tp8": kv_migration_bytes(cfg, n_seqs, ctx, 1, 8),
               "first_migrate_s": first_s}
        log(f"migration ctx {ctx}: {moved / 1e9:.3f} GB moved ({rec['page_rows']} page rows of {row_bytes} B, "
            f"{n_seqs} sequences x {cfg.num_layers} layers x K/V), pages {src.num_pages}/layer; fragmentation src "
            f"{rec['fragmentation_src']:.3f} -> dst {rec['fragmentation_dst']:.3f}; kv_migration_bytes(TP 1 -> 8) "
            f"{rec['kv_migration_bytes_tp1_to_tp8'] / 1e9:.3f} GB; pages and attention on all {cfg.num_layers} layers "
            f"bit-identical; launches {counts}")

        # per-launch times of the K kind (V is the same shape)
        src_k, dst_k = src.page_rows("k"), dst.page_rows("k")
        src_rows = src.row_ids(src.migration_page_ids(seqs))
        dst_rows = dst.row_ids(dst.migration_page_ids(seqs))
        src_ids = torch.from_numpy(src_rows).to(dev)
        dst_ids = torch.from_numpy(dst_rows).to(dev)
        n = src_rows.size
        staged = kv_gather(src_k, src_rows)
        plain = kv_gather_ref(src_k, src_ids)
        g_err = 0.0 if torch.equal(staged, plain) else float("inf")
        check(g_err == 0.0, f"kv_gather at ctx {ctx} equals its plain version")
        del plain
        d_kernel = kv_scatter(dst_k.clone(), staged, dst_rows)
        s_err = 0.0 if torch.equal(d_kernel, kv_scatter_ref(dst_k.clone(), staged, dst_ids)) else float("inf")
        check(s_err == 0.0, f"kv_scatter at ctx {ctx} equals its plain version")
        del d_kernel
        b_ms, b_by = bound_ms(2 * n * row_bytes + 4 * n, 0.0, "bfloat16")
        spin = 4_000_000  # ~2 ms: covers the wrapper's host-side id checks
        shape = f"bfloat16 K rows n={n} F={F} ({n * row_bytes / 1e9:.3f} GB) of a ({src_k.shape[0]}, {F}) pool, ctx {ctx}"
        rows = []
        for name, err, run, ref, lib in (
            ("kv_gather", g_err, lambda: kv_gather(src_k, src_rows), lambda: kv_gather_ref(src_k, src_ids),
             lambda: torch.index_select(src_k, 0, src_ids)),
            ("kv_scatter", s_err, lambda: kv_scatter(dst_k, staged, dst_rows), lambda: kv_scatter_ref(dst_k, staged, dst_ids),
             lambda: dst_k.index_copy_(0, dst_ids, staged)),
        ):
            row = {"name": name, "shape": shape, "max_abs_err": err, "tol": "0 (bit for bit)",
                   "ms": time_ms(torch, run, flush=flush, spin=spin),
                   "plain_ms": time_ms(torch, ref, flush=flush, spin=spin),
                   "library_ms": time_ms(torch, lib, flush=flush, spin=spin), "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            log(f"  {name} {shape}: {row['ms']:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                f"{b_ms / row['ms']:.2f} of it), plain {row['plain_ms']:.4f}, "
                f"{'index_select' if name == 'kv_gather' else 'index_copy_'} {row['library_ms']:.4f}")
        rec["kernels"] = rows
        # kv_gather against index_select in turns (kernel, library, library,
        # kernel, twice), like for like: the public wrapper with host ids
        # (checked, copied to the card from pinned memory) against
        # index_select with the ids copied to the card in the call (a
        # blocking copy); the wrapper's launch with int32 ids already on the
        # card against index_select with device ids
        dev_ids = torch.from_numpy(src_rows.astype(np.int32)).to(dev)
        pairs = {"host ids": (lambda: kv_gather(src_k, src_rows),
                              lambda: torch.index_select(src_k, 0, torch.from_numpy(src_rows).to(dev))),
                 "device ids": (lambda: _gather(src_k, dev_ids), lambda: torch.index_select(src_k, 0, src_ids))}
        check(torch.equal(pairs["device ids"][0](), staged), f"kv_gather at ctx {ctx} from device ids")
        rec["gather_in_turns_ms"] = {}
        for label, (kern, lib) in pairs.items():
            turns = {"kernel": [], "index_select": []}
            for who in ("kernel", "index_select", "index_select", "kernel") * 2:
                turns[who].append(time_ms(torch, kern if who == "kernel" else lib, flush=flush, spin=spin))
            rec["gather_in_turns_ms"][label] = turns
            log(f"  kv_gather vs index_select, {label}, in turns (K, L, L, K, twice), ms: {json.dumps(turns)}")
        rec["gather_host_us_per_call"] = {label: host_us(torch, pairs[label][0], 100) for label in pairs}
        log(f"  host us per call, kv_gather (host ids) and its launch (device ids): "
            f"{json.dumps(rec['gather_host_us_per_call'])}")
        del staged, dev_ids

        walls = []  # migrate_pages again into the same pool, its sequences released first
        for _ in range(3):
            for s in seqs:
                dst.release_seq(s)
            _, sec = migrate_pages(src, dst, seqs)
            walls.append(sec * 1e3)
        walls.sort()
        rec["migrate_pages_ms"] = {"median": walls[1], "min": walls[0], "max": walls[2], "n": 3}
        log(f"  migrate_pages ctx {ctx}: {walls[1]:.3f} ms median of 3 ({walls[0]:.3f}-{walls[2]:.3f}), "
            f"first call {first_s * 1e3:.3f} ms; {moved / 1e9:.3f} GB over {walls[1]:.3f} ms = "
            f"{2 * moved / (walls[1] / 1e3) / 1e12:.2f} TB/s read+write")

        if ctx == 256:  # Fig. 7's measured pair: one copy per page row against the aggregated gathers
            all_rows = [(kind, r) for kind in ("k", "v") for r in src_rows]
            out = {kind: torch.empty(n, F, dtype=src.dtype, device=dev) for kind in ("k", "v")}
            pools = {kind: src.page_rows(kind) for kind in ("k", "v")}

            def per_page():
                for j, (kind, r) in enumerate(all_rows):
                    out[kind][j % n].copy_(pools[kind][int(r)])

            def aggregated():
                return [kv_gather(pools[kind], src_rows) for kind in ("k", "v")]

            def wall(fn):
                fn()
                torch.cuda.synchronize()
                ts = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                return sorted(ts)

            pp, ag = wall(per_page), wall(aggregated)
            agg = aggregated()
            check(torch.equal(out["k"], agg[0]) and torch.equal(out["v"], agg[1]), "per-page copies == aggregated gathers")
            del agg
            rec["fig7"] = {"page_rows": len(all_rows), "bytes": len(all_rows) * row_bytes,
                           "per_page_copy_ms": {"median": pp[1], "min": pp[0], "max": pp[2]},
                           "aggregated_gather_ms": {"median": ag[1], "min": ag[0], "max": ag[2]},
                           "ratio": pp[1] / ag[1]}
            log(f"  Fig. 7 pair at {len(all_rows) * row_bytes / 1e9:.3f} GB: {len(all_rows)} per-page copy_ "
                f"{pp[1]:.2f} ms ({pp[0]:.2f}-{pp[2]:.2f}) vs 2 aggregated kv_gather {ag[1]:.3f} ms "
                f"({ag[0]:.3f}-{ag[2]:.3f}), host clock to a sync: {pp[1] / ag[1]:.1f}x")
            del out, pools
        records[str(ctx)] = rec
        del src, dst, src_k, dst_k, src_ids, dst_ids
        gc.collect()
        torch.cuda.empty_cache()
    return launches, records


# ---------------------------------------------------------------------------
# phases 4 and 5: the serving engine
# ---------------------------------------------------------------------------
def make_requests(cfg, n=10, new_tokens=24):
    """``n`` seeded prompts of 4 to 120 tokens; ``new_tokens``, an int or
    one count per request."""
    import numpy as np

    from repro_torch.serving.request import Request

    counts = [new_tokens] * n if isinstance(new_tokens, int) else list(new_tokens)
    rng = np.random.RandomState(0)
    return [Request(i, "strict", rng.randint(0, cfg.vocab_size, size=rng.randint(4, 121)).astype(np.int32), counts[i])
            for i in range(len(counts))]


# an MoE model's f32 runs take multicard.MOE_NEW_TOKENS' 14 requests: under F32_SCHEDULE requests 8-13 are
# prefilled two each at TP 2, 4 and 8 (steps 4, 8 and 14), where the reference's prefill path and capacity
# change with the TP level
F32_SCHEDULE = {3: 2, 7: 4, 13: 8, 19: 1}


def storage_ptrs(eng):
    from repro_torch.models.params import tree_leaves_with_path

    return sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(eng.storage) for t in per_pos)


def graph_stats(eng):
    """An engine's executables: capture seconds per (TP, key), how many are
    graphs, their pool's bytes; None for an engine without a cache (an
    earlier tree's, under --timings-of)."""
    cache = getattr(eng, "cache", None)
    if cache is None:
        return None
    return {"graphs": cache.graphs(), "capture_s": {f"{tp}/{key}": t for (tp, key), t in cache.capture_s.items()},
            "capture_s_total": sum(cache.capture_s.values()), "pool_bytes": cache.pool_bytes()}


def graphs_vs_eager(torch, eng, log):
    """Every executable of the engine against the eager step function it
    captured, at every TP level, each from the same KV cache (N(0, 1)
    values): the decode graph with one slot at the cache's last position
    (past the window in a windowed model: the rotating buffer wrapped) and
    the others at random ones, and every bucket's prefill graph for a prompt
    3 tokens shorter than its bucket. Next tokens, f32 logits and the KV
    cache must be equal bit for bit, and a replay must add the launches of
    the eager call to the counts."""
    import numpy as np

    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    cfg, layers, dev = eng.cfg, eng.slots.layers, eng.device
    n, max_len = eng.econf.n_slots, eng.econf.max_len
    g = torch.Generator(device=dev).manual_seed(11)
    for c in layers:
        for t in c.values():
            t.normal_(generator=g)
    start = [{k: t.clone() for k, t in c.items()} for c in layers]
    rng = np.random.RandomState(12)
    pos = rng.randint(0, max_len, size=n)
    pos[0] = max_len - 1
    decode_args = (torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(n, 1))), torch.from_numpy(pos))
    t0, n_cases = time.perf_counter(), 0
    for tp in eng.tps:
        eng.switch_tp(tp)
        params = eng.ctl.bindings[tp]
        cases = [("decode", lambda *a: eng._decode(params, *a), decode_args)]
        for L in eng.econf.prefill_buckets:
            prompt = torch.zeros((1, L), dtype=torch.int64)
            prompt[0, : L - 3] = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=L - 3))
            cases.append((L, lambda *a: eng._prefill(params, *a), (prompt, torch.tensor([L - 4]), torch.tensor([L % n]))))
        for key, eager, host_args in cases:
            runs = []
            for fn, args in ((eager, [a.to(dev) for a in host_args]), (eng.cache.get(tp, key), host_args)):
                for c, c0 in zip(layers, start):
                    for k in c:
                        c[k].copy_(c0[k])
                before = (tp_shard_matmul.launches, paged_decode_attention.launches)
                out = [t.clone() for t in fn(*args)]
                torch.cuda.synchronize()
                runs.append((out, (tp_shard_matmul.launches - before[0], paged_decode_attention.launches - before[1])))
                if len(runs) == 1:
                    want_cache = [{k: t.clone() for k, t in c.items()} for c in layers]
            (want, want_n), (got, got_n) = runs
            what = f"{cfg.name} TP {tp} {key}"
            check(all(torch.equal(a, b) for a, b in zip(want, got)), f"{what}: graph replay != eager (tokens, logits)")
            check(all(torch.equal(c[k], w[k]) for c, w in zip(layers, want_cache) for k in c),
                  f"{what}: the KV cache after the replay != after the eager call")
            check(got_n == want_n and got_n[0] > 0, f"{what}: launches added by the replay {got_n}, eager {want_n}")
            del want_cache
            n_cases += 1
    del start
    eng.switch_tp(eng.tps[0])
    log(f"engine {cfg.name}: {n_cases} graphs (decode at TP {list(eng.tps)}, prefill at every (TP, bucket "
        f"{list(eng.econf.prefill_buckets)})) replay equal to the eager step, bit for bit (tokens, f32 logits, KV "
        f"cache), each adding the eager call's launches; {time.perf_counter() - t0:.1f} s")
    return n_cases


def replayed(*engines):
    """Launches the engines' graph replays made, by kernel."""
    out = {}
    for eng in engines:
        for k, v in eng.cache.replayed_launches().items():
            out[k] = out.get(k, 0) + v
    return out


def matmul_launches_by_stage(*engines):
    """tp_shard_matmul launches the engines' graph replays made, by stage:
    decode graphs (M = 8 slots: skinny_mm in f32) and prefill graphs (the
    bucket's projections, M > 8, plus the last token's head, M = 1)."""
    out = {"decode": 0, "prefill": 0}
    for eng in engines:
        for tp in eng.cache.tps():
            for key in ("decode", *eng.econf.prefill_buckets):
                if eng.cache.has(tp, key):
                    exe = eng.cache.get(tp, key)
                    n = sum(k for w, k in exe.launches if w.__name__ == "tp_shard_matmul")
                    out["decode" if key == "decode" else "prefill"] += n * exe.replays
    return out


def prefill_replays(eng):
    """{"TP/bucket": replays} of the engine's prefill graphs."""
    return {f"{tp}/{key}": eng.cache.get(tp, key).replays for tp in eng.cache.tps()
            for key in eng.econf.prefill_buckets if eng.cache.has(tp, key)}


def f32_step_profile(torch, eng, requests):
    """The engine's decode step with its slots busy with ``requests``: 3
    steps under torch.profiler at TP 1 and at the largest TP, device ms per
    step and the matmul kernels' ms and share of it; the slots are freed
    after."""
    for req in requests:
        eng.admit(req)
    out = {}
    for tp in (eng.tps[0], eng.tps[-1]):
        eng.switch_tp(tp)
        prof = decode_profile(torch, eng)
        if "kernel_ms_per_step" in prof:
            mm = sum(prof["kernel_ms_per_step"][k] for k in MATMUL_KERNELS)
            prof.update(matmul_ms_per_step=mm, matmul_share=mm / prof["device_ms_per_step"])
        out[str(tp)] = prof
    for slot, req in enumerate(eng.slot_req):
        if req is not None:
            eng.slot_req[slot] = None
            eng.slots.release(slot)
    eng.switch_tp(eng.tps[0])
    return out


def f32_prefill_profile(torch, eng, cfg):
    """One prompt that fills the prefill bucket the f32 trajectory check
    leans on most (llama3-8b 128 tokens, the windowed models 4096), admitted
    at TP 1 with every slot free, under torch.profiler: device ms, the port's
    kernels' ms and the matmul kernels' ms and share of it."""
    import numpy as np

    from repro_torch.serving.request import Request

    L = 4096 if cfg.name in WINDOWED else 128
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, size=L).astype(np.int32)
    req = Request(900, "strict", prompt, 1)
    eng.switch_tp(eng.tps[0])
    ev, wall_us = profiled(torch, lambda: eng.admit(req))
    eng.slot_req[req.slot] = None
    eng.slots.release(req.slot)
    dev_us = sum(t for _, t in ev)
    if dev_us == 0:
        return {"bucket": L, "device_ms": "not measured (the profiler saw no device time)"}
    km = kernel_ms(ev, 1)
    mm = sum(km[k] for k in MATMUL_KERNELS)
    return {"bucket": L, "traced_ms": wall_us / 1e3, "device_ms": dev_us / 1e3, "kernel_ms": km, "matmul_ms": mm,
            "matmul_share": mm / (dev_us / 1e3)}


def profile_requests(cfg):
    """8 requests that keep the slots busy through a profile: phase 6's
    first 8 for a windowed model, else 64-token prompts."""
    import numpy as np

    from repro_torch.serving.request import Request

    if cfg.name in WINDOWED:
        return windowed_requests(cfg, base_id=500, new_tokens=10_000)[:8]
    rng = np.random.RandomState(3)
    return [Request(500 + i, "strict", rng.randint(0, cfg.vocab_size, size=64).astype(np.int32), 10_000)
            for i in range(8)]


def engine_conf(torch, cfg, dtype):
    """The engine configuration phases 4-6 serve ``cfg`` with."""
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.testing.multicard import WINDOWED_ENGINE

    if cfg.name in WINDOWED:  # max_len 4224, buckets to 4160
        return EngineConfig(candidate_tps=WINDOWED_TPS[cfg.name], n_slots=8, dtype=dtype, **WINDOWED_ENGINE)
    return EngineConfig(candidate_tps=(1, 2, 4, 8), n_slots=8, max_len=256, prefill_buckets=(32, 64, 128), dtype=dtype)


def engine_f32_profiled(torch, dev, cfg, log):
    """An f32 engine warmed up, then f32_step_profile (for --timings-of)."""
    from repro_torch.models import init_params, model_param_defs
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.serving.engine import ServingEngine

    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(cfg, params, engine_conf(torch, cfg, torch.float32), device=dev)
    eng.warmup()
    out = {"decode": f32_step_profile(torch, eng, profile_requests(cfg)), "prefill": f32_prefill_profile(torch, eng, cfg)}
    log(f"engine {cfg.name} f32 decode and prefill under the profiler: {json.dumps(out)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def engine_f32(torch, dev, cfg, log, must_match=True, extras=True):
    """One model at full width in f32: the 10 requests (an MoE model:
    MOE_NEW_TOKENS' 14, so that the switch run also prefills at TP 2, 4 and
    8) served at fixed TP 1 and under F32_SCHEDULE over TP 1/2/4/8, by two
    engines warmed up
    (counts set to 0 just before the runs, read just after): identical
    greedy trajectories (``must_match``; else the requests whose tokens
    changed are reported), both kernels launched, every launch by a graph
    replay, no weight moved by a rebind; an MoE model's dropped
    assignments per (TP level, stage) of both runs. ``extras``: then every
    graph against its eager step (graphs_vs_eager), and the f32 decode step
    and one prefill under the profiler."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.testing.multicard import MOE_NEW_TOKENS, draw_weights

    econf = engine_conf(torch, cfg, torch.float32)
    what = f"engine {cfg.name} f32 ({cfg.num_layers} layers)"
    t0 = time.perf_counter()
    params = draw_weights(cfg, dev, torch.float32)
    torch.cuda.synchronize()
    log(f"{what}: weights {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    schedule = F32_SCHEDULE
    new_tokens = 24 if cfg.moe is None else MOE_NEW_TOKENS
    eng = ServingEngine(cfg, params, econf, device=dev)
    warm = eng.warmup()
    eng_b = ServingEngine(cfg, params, econf, device=dev)
    eng_b.warmup()
    ptrs = storage_ptrs(eng_b)
    tp_shard_matmul.launches = paged_decode_attention.launches = 0  # from here on only replays launch
    t0 = time.perf_counter()
    base = {r.req_id: list(r.generated) for r in eng.run(make_requests(cfg, new_tokens=new_tokens))}
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    done = eng_b.run(make_requests(cfg, new_tokens=new_tokens), switch_schedule=schedule)
    t_b = time.perf_counter() - t0
    launches = {"tp_shard_matmul": tp_shard_matmul.launches, "paged_decode_attention": paged_decode_attention.launches}
    check(launches == replayed(eng, eng_b), f"every launch came from a graph replay: {launches}")
    want = {r.req_id: r.max_new_tokens for r in make_requests(cfg, new_tokens=new_tokens)}
    check(len(base) == len(want) and len(done) == len(want), f"all {len(want)} requests served")
    check(all(len(v) == want[i] and all(0 <= t < cfg.vocab_size for t in v) for i, v in base.items()),
          "each request's count of valid tokens")
    prefills = prefill_replays(eng_b)
    if cfg.moe is not None:
        check(all(any(n for k, n in prefills.items() if k.startswith(f"{tp}/")) for tp in (2, 4, 8)),
              f"{cfg.name}: the switch run prefilled at TP 2, 4 and 8: {prefills}")
    changed = [r.req_id for r in done if base[r.req_id] != list(r.generated)]
    check(not (must_match and changed), f"{cfg.name}: trajectories changed across TP switches for requests {changed}")
    check(eng_b.stats.switches == 4, f"4 switches, got {eng_b.stats.switches}")
    prompt = torch.zeros((1, 128), dtype=torch.int64, device=dev)
    _, logits = eng_b._prefill(eng_b.ctl.bindings[1], prompt, torch.tensor([127], device=dev),
                               torch.tensor([0], device=dev))
    check(bool(torch.isfinite(logits).all()), f"{what}: a prefill's logits are finite (eager, TP 1)")
    check(storage_ptrs(eng_b) == ptrs, "rebind kept every storage data_ptr")
    check(all(n > 0 for n in launches.values()), f"both kernels launched on the main path: {launches}")
    by_stage = matmul_launches_by_stage(eng, eng_b)
    dropped = {"fixed TP 1": {f"{tp}/{st}": n for (tp, st), n in eng.moe_dropped().items()},
               "switch schedule": {f"{tp}/{st}": n for (tp, st), n in eng_b.moe_dropped().items()}}
    st = eng_b.stats
    graphs = graph_stats(eng)
    log(f"{what}: warmup {warm:.1f} s ({graphs['graphs']} graphs, pool {graphs['pool_bytes']} bytes); fixed TP 1 "
        f"run {t_a:.1f} s, {eng.stats.steps} steps; switch run {t_b:.1f} s, {st.steps} steps, {st.switches} switches "
        f"({schedule}); trajectories {'identical' if not changed else f'changed for requests {changed}'}; launches "
        f"{launches}, all by graph replays; tp_shard_matmul's by stage {by_stage}; the switch run's prefills "
        f"per TP level/bucket {prefills}")
    log(f"{what}: first request's tokens {base[0]}" + (f"; with the schedule {done[0].generated}" if changed else ""))
    if cfg.moe is not None:
        log(f"{what}: capacity factor {cfg.moe.capacity_factor}; MoE assignments dropped per TP level/stage "
            f"{json.dumps(dropped)}")
    del eng
    rec = {"layers": cfg.num_layers, "schedule": {str(k): v for k, v in schedule.items()}, "fixed_run_s": t_a,
           "switch_run_s": t_b, "warmup_s": warm, "rebind_s_total": st.rebind_s, "migrate_s_total": st.migrate_s,
           "graphs": graphs, "matmul_launches_by_stage": by_stage, "switch_run_prefills": prefills,
           "changed_requests": changed,
           "first_tokens": base[0], "trajectories": {str(k): v for k, v in base.items()}}
    if cfg.moe is not None:
        rec.update(capacity_factor=cfg.moe.capacity_factor, moe_dropped=dropped)
    if extras:
        rec["graphs_equal_to_eager"] = graphs_vs_eager(torch, eng_b, log)
        rec["profile"] = f32_step_profile(torch, eng_b, profile_requests(cfg))
        log(f"{what}: decode under the profiler: {json.dumps(rec['profile'])}")
        rec["prefill_profile"] = f32_prefill_profile(torch, eng_b, cfg)
        log(f"{what}: prefill of {rec['prefill_profile']['bucket']} tokens at TP 1 under the profiler: "
            f"{json.dumps(rec['prefill_profile'])}")
    del eng_b, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def engine_tiny_vs_cpu(torch, dev, log):
    """A small model on the card against the same model on the CPU (plain
    versions), which the CPU tests hold to the reference engine."""
    import numpy as np

    from repro_torch.configs.base import AttnSpec, ModelConfig
    from repro_torch.models import init_params, model_param_defs
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request

    cfg = ModelConfig(name="tiny-serve", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
                      head_dim=16, d_ff=128, vocab_size=256, attn=AttnSpec(kind="full"))
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(0))
    econf = EngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32))

    def reqs():
        rng = np.random.RandomState(0)
        return [Request(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(10)]

    cpu = {r.req_id: r.generated for r in ServingEngine(cfg, params, econf, device="cpu").run(reqs())}
    gpu = {r.req_id: r.generated for r in ServingEngine(cfg, params, econf, device=dev).run(reqs(), switch_schedule={3: 2, 7: 4, 13: 1, 19: 2})}
    check(cpu == gpu, "tiny-serve on the card (kernels, TP switches) equals the CPU plain path")
    log("engine tiny-serve: card with TP switches == CPU plain path, token for token")


def engine_bf16_timed(torch, dev, cfg, log):
    import numpy as np

    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.testing.multicard import draw_weights

    econf = engine_conf(torch, cfg, torch.bfloat16)
    params = draw_weights(cfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, econf, device=dev)
    warm = eng.warmup()
    rng = np.random.RandomState(1)
    out = {"warmup_s": warm, "graphs": graph_stats(eng), "ttft_ms": {}, "decode_step_ms": {}, "rebind_lookup_us": [],
           "migrate_ms": []}

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    def spread(xs):
        return {"median": median(xs), "min": min(xs), "max": max(xs), "n": len(xs)}

    def fill_slots(base_id):
        for i in range(econf.n_slots):
            eng.admit(Request(base_id + i, "strict", rng.randint(0, cfg.vocab_size, size=64).astype(np.int32), 10_000))

    def empty_slots():
        for slot, req in enumerate(eng.slot_req):
            if req is not None:
                eng.slot_req[slot] = None
                eng.slots.release(slot)

    # every host-clock timing first; the profiler runs last, on its own
    for L in econf.prefill_buckets:  # a prompt that fills the bucket, TP 1, empty engine
        times = []
        for i in range(5):
            req = Request(100 + i, "strict", rng.randint(0, cfg.vocab_size, size=L).astype(np.int32), 1)
            t0 = time.perf_counter()
            eng.admit(req)
            times.append((time.perf_counter() - t0) * 1e3)
            eng.slot_req[req.slot] = None
            eng.slots.release(req.slot)
        out["ttft_ms"][str(L)] = spread(times)
    out["prefill_replay_ms"] = replay_ms(torch, eng, econf.prefill_buckets)
    fill_slots(200)  # every slot busy; decode steps at each TP, three rounds of 1 -> 2 -> 4 -> 8
    rounds = {tp: [] for tp in econf.candidate_tps}
    for _ in range(3):
        for tp in econf.candidate_tps:
            sw = eng.switch_tp(tp)
            if sw["rebind_s"] or sw["migrate_s"]:
                out["rebind_lookup_us"].append(sw["rebind_s"] * 1e6)
                out["migrate_ms"].append(sw["migrate_s"] * 1e3)
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                eng.step()
                times.append((time.perf_counter() - t0) * 1e3)
            rounds[tp].append(median(times))
    for tp, meds in rounds.items():  # median of the three rounds' medians, and their spread
        out["decode_step_ms"][str(tp)] = spread(meds)
    out["decode_replay_ms"] = replay_ms(torch, eng, ["decode"])
    if out["decode_replay_ms"]:
        out["busy_share_from_events"] = {tp: out["decode_replay_ms"][tp]["decode"] / out["decode_step_ms"][tp]["median"]
                                         for tp in out["decode_replay_ms"]}
    eng.switch_tp(1)
    empty_slots()
    runs = []
    tp_shard_matmul.launches = paged_decode_attention.launches = 0
    for rep in range(3):
        t0 = time.perf_counter()
        done = eng.run(make_requests(cfg))
        dt = time.perf_counter() - t0
        n_tok = sum(len(r.generated) for r in done)
        runs.append(n_tok / dt)
    out["tokens_per_s"] = spread(runs)
    out["launches"] = {"tp_shard_matmul": tp_shard_matmul.launches,
                       "paged_decode_attention": paged_decode_attention.launches}
    check(all(n > 0 for n in out["launches"].values()), f"both kernels launched serving in bf16: {out['launches']}")
    out["workload"] = f"10 requests, prompts 4-120, 24 new tokens, TP 1: {n_tok} tokens per run, 3 runs"
    out["bind_ms_per_tp"] = {str(tp): s * 1e3 for tp, s in eng.ctl.bind_s.items()}
    out["memory_gb"] = {"weights": weights / 1e9, "peak": torch.cuda.max_memory_allocated() / 1e9,
                        "peak_over_weights": (torch.cuda.max_memory_allocated() - weights) / 1e9}
    moe = getattr(cfg, "moe", None)  # None for a dense model, or an earlier tree's config (--timings-of)
    if moe is not None:  # over the TTFT, decode-step and tokens/s runs above
        out["moe_dropped"] = {f"{tp}/{st}": n for (tp, st), n in eng.moe_dropped().items()}

    def prefill_profile(L):
        """One prompt that fills bucket L, admitted at TP 1 under torch.profiler:
        its device ms, and the port's kernels' share of it."""
        req = Request(400 + L, "strict", rng.randint(0, cfg.vocab_size, size=L).astype(np.int32), 1)
        ev, wall_us = profiled(torch, lambda: eng.admit(req))
        eng.slot_req[req.slot] = None
        eng.slots.release(req.slot)
        dev_us = sum(t for _, t in ev)
        if dev_us == 0:
            return {"device_ms": "not measured (the profiler saw no device time)"}
        return {"traced_ttft_ms": wall_us / 1e3, "device_ms": dev_us / 1e3, "kernel_ms": kernel_ms(ev, 1),
                "split_ms": step_split(ev, 1)}

    eng.switch_tp(1)
    empty_slots()
    out["prefill_profile"] = {str(L): prefill_profile(L) for L in econf.prefill_buckets}
    fill_slots(300)
    out["profile"] = {}
    for tp in (1, 8):
        eng.switch_tp(tp)
        out["profile"][str(tp)] = decode_profile(torch, eng)
    log(f"engine {cfg.name} bf16 (host clock, before any profiler): TTFT ms per bucket {json.dumps(out['ttft_ms'])}; "
        f"decode step ms per TP (3 rounds of 6 steps) {json.dumps(out['decode_step_ms'])}; "
        f"tokens/s {json.dumps(out['tokens_per_s'])} ({out['workload']}); launches over those runs "
        f"{json.dumps(out['launches'])}")
    log(f"engine {cfg.name} bf16: warmup {warm:.1f} s, graphs {json.dumps(out['graphs'])}; replay device ms (CUDA events) "
        f"decode {json.dumps(out['decode_replay_ms'])}, prefill at TP 1 {json.dumps(out['prefill_replay_ms'])}; "
        f"busy share from events {json.dumps(out.get('busy_share_from_events'))}; memory GB {json.dumps(out['memory_gb'])}")
    log(f"engine {cfg.name} bf16: TP switch = lookup of a binding made at install: lookup us "
        f"{[round(x, 2) for x in out['rebind_lookup_us']]}; bind ms per TP level (once, at install) "
        f"{json.dumps({k: round(v, 2) for k, v in out['bind_ms_per_tp'].items()})}; "
        f"migrate ms {[round(x, 3) for x in out['migrate_ms']]}")
    for tp, prof in out["profile"].items():
        log(f"engine {cfg.name} bf16: decode at TP {tp} under the profiler: {json.dumps(prof)}")
    if moe is not None:
        log(f"engine {cfg.name} bf16: capacity factor {moe.capacity_factor}; MoE assignments dropped per TP "
            f"level/stage over the timed runs {json.dumps(out['moe_dropped'])}")
    for L, prof in out["prefill_profile"].items():
        log(f"engine {cfg.name} bf16: prefill of {L} tokens at TP 1 under the profiler: {json.dumps(prof)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def replay_ms(torch, eng, keys):
    """{TP: {key: device ms of one replay of that graph}} (CUDA events,
    time_ms; no replay goes through the engine, so no count moves): every
    TP level for "decode", TP 1 for the prefill buckets; {} without graphs.
    A decode replay writes the K/V of its last inputs again, the same bits;
    a prefill replay rewrites its last slot, so it is timed while no slot is
    in use."""
    cache = getattr(eng, "cache", None)
    if cache is None or not cache.graphs():
        return {}
    tps = eng.tps if keys == ["decode"] else eng.tps[:1]
    return {str(tp): {str(k): time_ms(torch, cache.get(tp, k).graph.replay, iters=10) for k in keys} for tp in tps}


# ---------------------------------------------------------------------------
# phase 6: the windowed models served at full width and depth
# ---------------------------------------------------------------------------
# the requests: multicard.WINDOWED_PROMPTS' lengths (4160 fills its bucket past the 4096-token window, so
# prefill builds the rotating buffer; 4090 wraps it after 6 decode steps; 17, 100, 45, 77 and 31 are shorter
# than their buckets)
WINDOWED_TPS = {"gemma2-2b": (1, 2, 4), "h2o-danube-1.8b": (1, 2, 4, 8)}
WINDOWED_SCHEDULES = {"gemma2-2b": {3: 2, 7: 4, 13: 1, 19: 2}, "h2o-danube-1.8b": {3: 2, 7: 4, 13: 8, 19: 1}}


def windowed_requests(cfg, base_id=0, new_tokens=24):
    from repro_torch.serving.request import Request
    from repro_torch.testing.multicard import windowed_prompts

    return [Request(base_id + i, "strict", p, new_tokens) for i, p in enumerate(windowed_prompts(cfg))]


def engine_windowed_f32(torch, dev, cfg, log):
    """One windowed model in f32 at full width and depth: the 10 requests
    at fixed TP 1 and under the switch schedule over its TP levels; the
    greedy trajectories must be identical, both kernels must launch (counts
    set to 0 just before, read just after), a rebind must keep every
    storage pointer, and the windowed layers' buffers must wrap, in prefill
    (4160 > window) and in decode (4090 + 24 > window)."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.models import init_params, model_param_defs
    from repro_torch.models.model import layer_windows
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.serving.engine import ServingEngine

    tps, schedule = WINDOWED_TPS[cfg.name], WINDOWED_SCHEDULES[cfg.name]
    econf = engine_conf(torch, cfg, torch.float32)
    t0 = time.perf_counter()
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"engine {cfg.name} f32: weights {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    window = cfg.attn.window
    lens = [len(r.prompt) for r in windowed_requests(cfg)]
    check(max(lens) > window and any(n < window < n + 24 for n in lens),
          "the requests wrap the window in prefill and in decode")
    def counted_run(eng, **kw):  # counts set to 0 after the warm-up, just before the run, read just after
        eng.warmup()
        tp_shard_matmul.launches = paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        done = eng.run(windowed_requests(cfg), **kw)
        n = {"tp_shard_matmul": tp_shard_matmul.launches, "paged_decode_attention": paged_decode_attention.launches}
        check(n == replayed(eng), f"{cfg.name}: every launch came from a graph replay: {n}")
        return done, time.perf_counter() - t0, n

    eng = ServingEngine(cfg, params, econf, device=dev)
    sizes = sorted({layer["k"].shape[1] for layer in eng.slots.layers})
    done, t_a, n_a = counted_run(eng)
    by_stage = matmul_launches_by_stage(eng)
    base = {r.req_id: list(r.generated) for r in done}
    graphs = graph_stats(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng_b = ServingEngine(cfg, params, econf, device=dev)
    ptrs = storage_ptrs(eng_b)
    done, t_b, n_b = counted_run(eng_b, switch_schedule=schedule)
    launches = {k: n_a[k] + n_b[k] for k in n_a}
    by_stage = {k: n + matmul_launches_by_stage(eng_b)[k] for k, n in by_stage.items()}
    check(len(base) == 10 and len(done) == 10, "all 10 requests served")
    check(all(len(v) == 24 and all(0 <= t < cfg.vocab_size for t in v) for v in base.values()), "24 valid tokens each")
    changed = [r.req_id for r in done if base[r.req_id] != list(r.generated)]
    check(not changed, f"{cfg.name}: trajectories changed across TP switches for requests {changed}")
    check(eng_b.stats.switches == len(schedule), f"{len(schedule)} switches, got {eng_b.stats.switches}")
    check(storage_ptrs(eng_b) == ptrs, "rebind kept every storage data_ptr")
    check(all(n > 0 for n in launches.values()), f"both kernels launched on the main path: {launches}")
    check(window in sizes and sum(w is not None for w in layer_windows(cfg)) > 0, f"window caches {sizes}")
    st = eng_b.stats
    log(f"engine {cfg.name} f32 (TP {tps}): fixed TP 1 run {t_a:.1f} s; switch run {t_b:.1f} s, {st.steps} steps, "
        f"{st.switches} switches ({schedule}); cache rows per layer {sizes}; trajectories identical; launches {launches}; "
        f"tp_shard_matmul's by stage {by_stage}")
    log(f"engine {cfg.name} f32: tokens of the 4160- and 4090-token requests {base[0]} {base[3]}; graphs "
        f"{graphs['graphs']}, capture {graphs['capture_s_total']:.1f} s, pool {graphs['pool_bytes']} bytes; every "
        f"launch by a graph replay")
    n_graphs = graphs_vs_eager(torch, eng_b, log)
    profile = f32_step_profile(torch, eng_b, profile_requests(cfg))
    log(f"engine {cfg.name} f32: decode under the profiler: {json.dumps(profile)}")
    prefill_profile = f32_prefill_profile(torch, eng_b, cfg)
    log(f"engine {cfg.name} f32: prefill of {prefill_profile['bucket']} tokens at TP 1 under the profiler: "
        f"{json.dumps(prefill_profile)}")
    del eng_b, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"tps": list(tps), "schedule": {str(k): v for k, v in schedule.items()}, "trajectories": base,
                      "fixed_run_s": t_a,
                      "switch_run_s": t_b, "cache_rows": sizes, "rebind_s_total": st.rebind_s,
                      "migrate_s_total": st.migrate_s, "graphs": graphs, "graphs_equal_to_eager": n_graphs,
                      "matmul_launches_by_stage": by_stage, "profile": profile, "prefill_profile": prefill_profile}


def engine_windowed_bf16_timed(torch, dev, cfg, log):
    """One windowed model in bf16, on the host clock before any profiler:
    TTFT at buckets 128 and 4096 (TP 1, empty engine; median, min, max of
    5 and 3), the decode step per TP level with the 8 slots holding the
    first 8 requests (three rounds over the TP levels, 6 steps each; the
    median of the rounds' medians, min, max); then 3 decode steps at TP 1
    and at the largest TP under torch.profiler (device ms, busy share, ms
    per kernel)."""
    import numpy as np

    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.models import init_params, model_param_defs
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request

    tps = WINDOWED_TPS[cfg.name]
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator(device=dev).manual_seed(0),
                         torch.bfloat16)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, engine_conf(torch, cfg, torch.bfloat16), device=dev)
    warm = eng.warmup()
    rng = np.random.RandomState(2)
    out = {"warmup_s": warm, "graphs": graph_stats(eng), "ttft_ms": {}, "decode_step_ms": {}}

    def spread(xs):
        xs = sorted(xs)
        return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1], "n": len(xs)}

    def release_all():
        for slot, req in enumerate(eng.slot_req):
            if req is not None:
                eng.slot_req[slot] = None
                eng.slots.release(slot)

    for L, reps in ((128, 5), (4096, 3)):
        times = []
        for i in range(reps):
            req = Request(100 + i, "strict", rng.randint(0, cfg.vocab_size, size=L).astype(np.int32), 1)
            t0 = time.perf_counter()
            eng.admit(req)
            times.append((time.perf_counter() - t0) * 1e3)
            release_all()
        out["ttft_ms"][str(L)] = spread(times)
    out["prefill_replay_ms"] = replay_ms(torch, eng, [128, 4096])
    tp_shard_matmul.launches = paged_decode_attention.launches = 0
    for req in windowed_requests(cfg, base_id=200, new_tokens=10_000)[:8]:
        eng.admit(req)
    rounds = {tp: [] for tp in tps}
    for _ in range(3):
        for tp in tps:
            eng.switch_tp(tp)
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                eng.step()
                times.append((time.perf_counter() - t0) * 1e3)
            rounds[tp].append(sorted(times)[3])
    out["decode_step_ms"] = {str(tp): spread(meds) for tp, meds in rounds.items()}
    out["launches"] = {"tp_shard_matmul": tp_shard_matmul.launches,
                       "paged_decode_attention": paged_decode_attention.launches}
    check(all(n > 0 for n in out["launches"].values()), f"both kernels launched in bf16: {out['launches']}")
    out["decode_replay_ms"] = replay_ms(torch, eng, ["decode"])
    if out["decode_replay_ms"]:
        out["busy_share_from_events"] = {tp: out["decode_replay_ms"][tp]["decode"] / out["decode_step_ms"][tp]["median"]
                                         for tp in out["decode_replay_ms"]}
    out["memory_gb"] = {"weights": weights / 1e9, "peak": torch.cuda.max_memory_allocated() / 1e9,
                        "peak_over_weights": (torch.cuda.max_memory_allocated() - weights) / 1e9}
    out["profile"] = {}
    for tp in (tps[0], tps[-1]):
        eng.switch_tp(tp)
        out["profile"][str(tp)] = decode_profile(torch, eng)
    log(f"engine {cfg.name} bf16 (host clock, before any profiler): warmup {warm:.1f} s; TTFT ms "
        f"{json.dumps(out['ttft_ms'])}; decode step ms per TP (3 rounds of 6 steps, 8 slots of the phase's mix) "
        f"{json.dumps(out['decode_step_ms'])}; launches {json.dumps(out['launches'])}")
    log(f"engine {cfg.name} bf16: graphs {json.dumps(out['graphs'])}; replay device ms (CUDA events) decode "
        f"{json.dumps(out['decode_replay_ms'])}, prefill at TP {tps[0]} {json.dumps(out['prefill_replay_ms'])}; busy share "
        f"from events {json.dumps(out.get('busy_share_from_events'))}; memory GB {json.dumps(out['memory_gb'])}")
    for tp, prof in out["profile"].items():
        log(f"engine {cfg.name} bf16: decode at TP {tp} under the profiler: {json.dumps(prof)}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 7 and 8: the dense family's remainder and MoE
# ---------------------------------------------------------------------------
DENSE_REMAINDER = ("yi-34b", "chameleon-34b", "mistral-large-123b", "musicgen-large")  # phase 7's f32 checks


def family_layers(name, dtype="f32"):
    """A model's depth in its f32 switch check or its bf16 timing (None: full depth), the four-card
    legs' (``multicard.FAMILY_LEGS``); widths stay the published ones."""
    from repro_torch.testing.multicard import FAMILY_LEGS

    return FAMILY_LEGS[name][f"{dtype}_layers"]


def cut(cfg, layers):
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def with_capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def dense_remainder_phase(torch, dev, log, skip_timed):
    """Phase 7: yi-34b in bf16 at full depth (engine_bf16_timed: TTFT per
    bucket, decode step per TP level, capture, pool, peak memory, profiles),
    then the f32 switch check (engine_f32) of yi-34b and chameleon-34b at 4
    layers (chameleon's q_norm / k_norm drawn nonzero: ``draw_weights``),
    mistral-large-123b at 2 and musicgen-large at full depth, all at full
    width. Returns ({path: launches}, record)."""
    from repro_torch.configs import get_config

    by_path, rec = {}, {}
    if not skip_timed:
        t0 = time.perf_counter()
        rec["yi-34b bf16"] = engine_bf16_timed(torch, dev, get_config("yi-34b"), log)
        by_path["yi-34b bf16"] = rec["yi-34b bf16"]["launches"]
        log(f"phase 7 yi-34b bf16 (60 layers): {time.perf_counter() - t0:.1f} s")
    for name in DENSE_REMAINDER:
        t0 = time.perf_counter()
        cfg = cut(get_config(name), family_layers(name))
        key = f"{name} f32 ({cfg.num_layers} layers)"
        by_path[key], rec[key] = engine_f32(torch, dev, cfg, log)
        rec[key]["wall_s"] = time.perf_counter() - t0
        log(f"phase 7 {key}: {rec[key]['wall_s']:.1f} s")
    return by_path, rec


def moe_phase(torch, dev, log, skip_timed):
    """Phase 8: moonshot-v1-16b-a3b in bf16 at full depth at its published
    capacity factor 1.25 (engine_bf16_timed, whose profiles split the step
    into the matmul kernel, attention, the library's GEMMs — the expert bmm
    and the router — and the rest; drops per TP level and stage); the f32
    switch check of moonshot at 4 layers and dbrx-132b at 2, full width, at
    reduced()'s capacity factor 8.0 with no assignment dropped; and once
    more at 1.25, trajectories and drops printed, not asserted. Returns
    ({path: launches}, record)."""
    from repro_torch.configs import get_config

    by_path, rec = {}, {}
    moon = get_config("moonshot-v1-16b-a3b")
    if not skip_timed:
        t0 = time.perf_counter()
        rec["moonshot bf16"] = engine_bf16_timed(torch, dev, moon, log)
        by_path[f"{moon.name} bf16"] = rec["moonshot bf16"]["launches"]
        log(f"phase 8 {moon.name} bf16 (48 layers): {time.perf_counter() - t0:.1f} s")
    for factor in (8.0, 1.25):
        if factor == 1.25:
            log("phase 8 at the published capacity factor 1.25: the reference's prefill capacity depends on the TP "
                "level (bucket 128 at TP 1: one dispatch of 128 tokens; at TP 8: 8 dispatches of 16, capacity 8 "
                "each; at TP 2 and 4 one replicated dispatch of 128), so assignments it drops, and with them its "
                "own greedy trajectory, may change with the TP level: trajectories and drops printed, not asserted")
        for name in ("moonshot-v1-16b-a3b", "dbrx-132b"):
            t0 = time.perf_counter()
            cfg = with_capacity(cut(get_config(name), family_layers(name)), factor)
            key = f"{name} f32 cf {factor} ({cfg.num_layers} layers)"
            by_path[key], rec[key] = engine_f32(torch, dev, cfg, log, must_match=factor == 8.0, extras=factor == 8.0)
            if factor == 8.0:
                dropped = rec[key]["moe_dropped"]
                check(not any(n for run in dropped.values() for n in run.values()),
                      f"{key}: no assignment dropped at capacity factor 8.0: {dropped}")
            rec[key]["wall_s"] = time.perf_counter() - t0
            log(f"phase 8 {key}: {rec[key]['wall_s']:.1f} s")
    return by_path, rec


# ---------------------------------------------------------------------------
# phase 9: the Mamba family (mamba2-2.7b through forward, jamba through the engine)
# ---------------------------------------------------------------------------
# (model, (name, mode, stored K, stored N)): the new projections; measure_matmul_cases takes TP 8's rank 1 shard
MAMBA_SHAPES = [("mamba2-2.7b", ("w_z/w_x col", "col", 2560, 5120)), ("mamba2-2.7b", ("w_dt col", "col", 2560, 80)),
                ("mamba2-2.7b", ("w_out row", "row", 5120, 2560)), ("mamba2-2.7b", ("w_BC col", "col", 2560, 256)),
                ("jamba-v0.1-52b", ("w_x/w_z col", "col", 4096, 8192)), ("jamba-v0.1-52b", ("w_dtr row", "row", 8192, 256)),
                ("jamba-v0.1-52b", ("w_B/w_C row", "row", 8192, 16)),
                ("jamba-v0.1-52b", ("dt_proj col", "col", 256, 8192)),
                ("jamba-v0.1-52b", ("w_out row", "row", 8192, 4096))]


def mamba_matmul_cases(torch):
    """tp_shard_matmul at the Mamba projections' shapes: decode (M 8) and
    prefill (M 128), f32 and bf16, at TP 1 and on a TP 8 rank's shard (the
    replicated w_BC at TP 1 only). w_dt's TP 8 shard is 10 columns at a
    20-byte offset in bf16; w_B/w_C have N = 16; dt_proj has K = 256."""
    bf, f32 = torch.bfloat16, torch.float32
    return [(model, shape, m, dt, tp) for model, shape in MAMBA_SHAPES for dt in (bf, f32) for m in (8, 128)
            for tp in ((1,) if shape[0].startswith("w_BC") else (1, 8))]


def check_mamba_one_launch(torch, dev, log):
    """Each Mamba projection, one call under torch.profiler, launches one
    kernel: every shape of MAMBA_SHAPES at M 8 and 128, f32 and bf16, whole
    and (but w_BC) on a TP 8 rank's shard."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    seen = {}
    for model, (name, mode, k_store, n_store), m, dtype, tp in mamba_matmul_cases(torch):
        w = torch.randn(k_store, n_store, device=dev).to(dtype)
        k, n, off = (k_store, n_store // tp, n_store // tp) if mode == "col" else (k_store // tp, n_store, k_store // tp)
        x = torch.randn(m, k, device=dev).to(dtype)
        key = f"{model} {name} {str(dtype).split('.')[1]} M={m} TP {tp}"
        seen[key] = kernels_in_one_call(torch, lambda: tp_shard_matmul(x, w, off if tp > 1 else 0, n_out=n, mode=mode))
        del w, x
    for key, kernels in seen.items():
        check(kernels is not None, f"{key}: the profiler saw device time in one of twelve sessions")
        check(sum(kernels.values()) == 1, f"one {key} call launches one kernel: {kernels}")
    log(f"phase 9 instances under torch.profiler, one kernel per call ({len(seen)} calls): {json.dumps(seen)}")
    return seen


MAMBA2_PROMPTS = (3, 128, 17, 64, 100, 5, 45, 77)  # tokens of the 8 prompts
MAMBA2_STEPS = 24
MAMBA2_REBINDS = {4: 2, 9: 4, 14: 8, 19: 1}  # decode step -> TP level


def mamba2_serve(torch, cfg, store, storage, prompts, rebinds):
    """mamba2's path (the reference's: forward, the engine refuses the
    model): each prompt prefilled alone at TP 1 (its last token's logits
    give its first token), the 8 states and conv tails stacked into one
    cache, then MAMBA2_STEPS greedy decode steps as a batch of 8 from that
    cache, updated in place; at the steps in ``rebinds`` the weights are
    rebound to another TP level (``WeightStore.rebind``: views, no byte
    moves), the state left where it is. Returns the tokens (8, 1 + steps)
    on the host and whether every hidden state was finite."""
    from repro_torch.models import forward, logits_for
    from repro_torch.parallel.sharding import make_exec_config

    V = cfg.vocab_size
    params, tp = store.rebind(storage, 1), 1
    finite = torch.ones((), dtype=torch.bool, device=prompts[0].device)
    caches, first = [], []
    for p in prompts:
        h, c = forward(params, cfg, make_exec_config(cfg, tp), tokens=p[None], mode="prefill")
        finite &= torch.isfinite(h).all()
        first.append(logits_for(params, cfg, h[:, -1:])[0, 0, :V].argmax())
        caches.append(c)
    cache = [{k: torch.cat([c[i][k] for c in caches]) for k in caches[0][i]} for i in range(cfg.num_layers)]
    tok = torch.stack(first)[:, None]
    out = [tok]
    for step in range(MAMBA2_STEPS):
        if step in rebinds:
            tp = rebinds[step]
            params = store.rebind(storage, tp)
        h, _ = forward(params, cfg, make_exec_config(cfg, tp), tokens=tok, cache=cache, mode="decode")
        finite &= torch.isfinite(h).all()
        tok = logits_for(params, cfg, h)[:, 0, :V].argmax(-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, 1).cpu(), bool(finite)


def mamba2_phase(torch, dev, log, skip_timed):
    """Phase 9, mamba2-2.7b at full width and depth (64 layers) through
    ``forward`` over a pool of 8 ranks: in f32 (11.3 GB) the 8 prompts
    served at fixed TP 1 and with rebinds TP 1 -> 2 -> 4 -> 8 -> 1 (counts
    set to 0 just before, read just after): identical tokens, every hidden
    state finite, no weight byte moved, the matmul kernel launched; then in
    bf16 (5.7 GB) one 128-token prefill and the decode step of 8 sequences
    at TP 1 and 8 under torch.profiler (device ms split into the matmul
    kernel, the library's GEMMs - the SSD's einsums - and the rest: the
    scan and the plain ops) and the peak memory. All of it runs eagerly,
    not as graph replays. Returns (launches, record)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.models import forward, init_params, logits_for, model_param_defs
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.profiles.perf_model import PerfModel

    cfg = get_config("mamba2-2.7b")
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    rng = np.random.RandomState(9)
    prompts = [torch.from_numpy(rng.randint(0, cfg.vocab_size, size=n)).to(dev) for n in MAMBA2_PROMPTS]
    what = f"{cfg.name} f32 ({cfg.num_layers} layers)"
    t0 = time.perf_counter()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold (the kernels' scratch among it)
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0))
    store = WeightStore(cfg, defs, [dev] * 8)
    storage = store.build(params)
    ptrs = sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(storage) for t in per_pos)
    torch.cuda.synchronize()
    state = PerfModel(cfg).state_bytes()
    rec = {"layers": cfg.num_layers, "param_count": cfg.param_count(), "allocated_before_gb": before / 1e9,
           "weights_gb_f32": (torch.cuda.memory_allocated() - before) / 1e9,
           "state_bytes_per_seq_f32": state, "state_bytes_8_seqs_f32": 8 * state,
           "prompts": list(MAMBA2_PROMPTS), "rebinds": {str(k): v for k, v in MAMBA2_REBINDS.items()},
           "note": "forward called eagerly (no CUDA graphs): times are not comparable with the engine's steps"}
    log(f"{what}: weights {rec['weights_gb_f32']:.2f} GB on the card, made in {time.perf_counter() - t0:.1f} s; "
        f"SSD state {rec['state_bytes_per_seq_f32'] / 1e6:.1f} MB per sequence in f32 "
        f"({rec['state_bytes_8_seqs_f32'] / 1e9:.3f} GB for 8)")
    tp_shard_matmul.launches = 0
    t0 = time.perf_counter()
    base, finite_a = mamba2_serve(torch, cfg, store, storage, prompts, {})
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    moved, finite_b = mamba2_serve(torch, cfg, store, storage, prompts, MAMBA2_REBINDS)
    t_b = time.perf_counter() - t0
    launches = {"tp_shard_matmul": tp_shard_matmul.launches}
    check(finite_a and finite_b, f"{what}: every hidden state finite")
    check(bool(((base >= 0) & (base < cfg.vocab_size)).all()), f"{what}: tokens in the vocabulary")
    changed = [i for i in range(len(prompts)) if not torch.equal(base[i], moved[i])]
    check(not changed, f"{what}: tokens changed under the rebinds for prompts {changed}")
    check(sorted(t.data_ptr() for _, per_pos in tree_leaves_with_path(storage) for t in per_pos) == ptrs,
          f"{what}: the rebinds kept every storage data_ptr")
    check(launches["tp_shard_matmul"] > 0, f"{what}: tp_shard_matmul launched on the path: {launches}")
    rec.update(fixed_run_s=t_a, rebind_run_s=t_b, launches=launches, first_tokens=base[0].tolist())
    log(f"{what}: 8 prompts of {list(MAMBA2_PROMPTS)} tokens prefilled, {MAMBA2_STEPS} greedy decode steps as a batch "
        f"of 8 with the state cache: fixed TP 1 {t_a:.1f} s, with rebinds {MAMBA2_REBINDS} {t_b:.1f} s (eager); "
        f"tokens identical, every hidden state finite, no weight byte moved; launches {launches}; first prompt's "
        f"tokens {rec['first_tokens']}")
    del params, storage, store
    gc.collect()
    torch.cuda.empty_cache()
    if skip_timed:
        return launches, rec

    before = torch.cuda.memory_allocated()
    params = init_params(defs, torch.Generator(device=dev).manual_seed(0), torch.bfloat16)
    store = WeightStore(cfg, defs, [dev] * 8)
    storage = store.build(params)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    bound = {tp: store.rebind(storage, tp) for tp in (1, 8)}
    ec = {tp: make_exec_config(cfg, tp) for tp in (1, 8)}
    V = cfg.vocab_size

    def split(ev, wall_us, n):
        dev_us = sum(t for _, t in ev)
        if dev_us == 0:
            return {"device_ms": "not measured (the profiler saw no device time)"}
        sp = step_split(ev, n)
        return {"traced_ms": wall_us / n / 1e3, "device_ms": dev_us / n / 1e3, "busy_share": dev_us / wall_us,
                "tp_shard_matmul_ms": sp["tp_shard_matmul"], "library_gemm_ms": sp["library_gemm"],
                "scan_and_plain_ops_ms": sp["rest"], "top_ms": {k[:80]: t / n / 1e3
                                                                for k, t in sorted(ev, key=lambda kv: -kv[1])[:6]}}

    prompt = torch.from_numpy(rng.randint(0, V, size=(1, 128))).to(dev)

    def prefill():
        h, _ = forward(bound[1], cfg, ec[1], tokens=prompt, mode="prefill")
        return logits_for(bound[1], cfg, h[:, -1:])[0, 0, :V].argmax()

    prefill()
    ev, wall_us = profiled(torch, prefill)
    bf16 = {"weights_gb": weights / 1e9, "prefill_128_tp1": split(ev, wall_us, 1), "decode_8": {}}
    batch = torch.from_numpy(rng.randint(0, V, size=(8, 64))).to(dev)
    _, cache = forward(bound[1], cfg, ec[1], tokens=batch, mode="prefill")
    tok = batch[:, -1:]
    for tp in (1, 8):
        def steps(n=3):
            for _ in range(n):
                h, _ = forward(bound[tp], cfg, ec[tp], tokens=tok, cache=cache, mode="decode")
                logits_for(bound[tp], cfg, h)[:, 0, :V].argmax(-1)

        steps(1)
        ev, wall_us = profiled(torch, steps)
        bf16["decode_8"][str(tp)] = split(ev, wall_us, 3)
    peak = torch.cuda.max_memory_allocated() - before
    bf16["memory_gb"] = {"weights": weights / 1e9, "peak": peak / 1e9, "peak_over_weights": (peak - weights) / 1e9,
                         "allocated_before": before / 1e9}
    rec["bf16"] = bf16
    log(f"{cfg.name} bf16 ({cfg.num_layers} layers, eager forward, under torch.profiler): prefill of 128 tokens at TP "
        f"1 {json.dumps(bf16['prefill_128_tp1'])}; decode step of 8 sequences {json.dumps(bf16['decode_8'])}; memory GB "
        f"{json.dumps(bf16['memory_gb'])}")
    del params, storage, store, bound, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rec


def jamba_phase(torch, dev, log, skip_timed):
    """Phase 9, jamba-v0.1-52b at full width through the engine: the f32
    switch check (engine_f32) at one period, 8 layers (7 mamba1, 1
    attention, 4 MoE), at capacity factor 8.0 with no assignment dropped;
    then in bf16 at two periods, 16 layers, at the published capacity
    factor 1.25, timed (engine_bf16_timed: TTFT per bucket, decode step per
    TP level, capture, pool, peak memory, drops, and profiles that split a
    step into the matmul kernel, attention, the library's GEMMs - the expert
    bmm and the router - and the rest: the scan and the plain ops). Its
    weights take each layer's own fan-in (weight_defs). Returns
    ({path: launches}, record)."""
    from repro_torch.configs import get_config

    cfg = get_config("jamba-v0.1-52b")
    by_path, rec = {}, {}
    t0 = time.perf_counter()
    f32 = with_capacity(cut(cfg, family_layers(cfg.name)), 8.0)  # one period
    key = f"{cfg.name} f32 cf 8.0 ({f32.num_layers} layers)"
    by_path[key], rec[key] = engine_f32(torch, dev, f32, log)
    dropped = rec[key]["moe_dropped"]
    check(not any(n for run in dropped.values() for n in run.values()),
          f"{key}: no assignment dropped at capacity factor 8.0: {dropped}")
    rec[key]["wall_s"] = time.perf_counter() - t0
    log(f"phase 9 {key}: {rec[key]['wall_s']:.1f} s")
    if not skip_timed:
        t0 = time.perf_counter()
        bf16 = cut(cfg, family_layers(cfg.name, "bf16"))  # two; the full 32 layers are 103 GB in bf16
        key = f"{cfg.name} bf16 ({bf16.num_layers} layers)"
        rec[key] = engine_bf16_timed(torch, dev, bf16, log)
        by_path[key] = rec[key]["launches"]
        rec[key]["wall_s"] = time.perf_counter() - t0
        log(f"phase 9 {key}: {rec[key]['wall_s']:.1f} s")
    return by_path, rec


# ---------------------------------------------------------------------------
# phase 10: the H100's offline profile and the planner that consumes it
# ---------------------------------------------------------------------------
TABLES = ROOT / "src" / "repro_torch" / "profiles" / "tables"
PROFILE_BATCHES, PROFILE_CTXS = (1, 4, 8), (64,)


def h100_fields(torch, dev, cfg, decode_row, flush, log):
    """The fields of repro_torch.profiles.perf_model.H100 measured on this
    card: total memory and L2 size (the card's properties), flops_eff (the
    bf16 tp_shard_matmul's TFLOP/s at a prefill-sized product, (4096, d) @
    (d, d_ff), over the 989 TFLOP/s peak), bw_eff (bound_ms / ms of phase
    2's bf16 w_gate decode row) and ici_latency_s (the CUDA-event time of a
    4-byte device-to-device copy, a lower bound for a hop)."""
    props = torch.cuda.get_device_properties(dev)
    shape = ("w_gate/w_in col", "col", cfg.d_model, cfg.d_ff)
    big = measure_matmul_cases(torch, dev, [(cfg.name, shape, 4096, torch.bfloat16, 1)], flush, log, cfg.name, seed=29)[0]
    src, dst = torch.zeros(1, device=dev), torch.empty(1, device=dev)
    copy_ms = time_ms(torch, lambda: dst.copy_(src), iters=50)
    return {"hbm_bytes": float(props.total_memory), "vmem_bytes": float(props.L2_cache_size),
            "flops_eff": 2.0 * 4096 * cfg.d_model * cfg.d_ff / (big["ms"] * 1e-3) / PEAK_FLOPS["bfloat16"],
            "bw_eff": decode_row["bound_ms"] / decode_row["ms"], "ici_latency_s": copy_ms * 1e-3,
            "rows": {"prefill": big["shape"], "prefill_ms": big["ms"], "decode": decode_row["shape"],
                     "decode_ms": decode_row["ms"], "decode_bound_ms": decode_row["bound_ms"]}}


def profile_plan_phase(torch, dev, cfg, log, decode_row, migration):
    """Phase 10: ``cfg`` (llama3-8b, 32 layers unless --layers) in bf16
    through phase 5's engine configuration, profiled with
    ``profile_engine`` (batches 1/4/8, context 64, buckets 32/64/128) by
    replaying its CUDA graphs: every tp_shard_matmul and
    paged_decode_attention launch of the profile must come from a replay
    (counts set to 0 just before, read just after). The TP 1 rows are the
    H100 table (written to src/repro_torch/profiles/tables/ at full depth,
    and to chiprun_out/); the TP > 1 rows are printed apart, labelled, and
    kept out of the table. Then: the H100 spec's measured fields beside the
    committed ones; the TP 1 times beside PerfModel(cfg, H100); the tiers
    derive_tiers makes from a TabulatedPerfModel of the table and the
    planner's plan for two tiers on 8 chips (the plan's one check: it uses
    at most 8, mixed groups counted); 16 requests (half each tier) served at TP 1 and scored with
    GoodputMeter (arrival at admission, as the engine stamps it: TTFT
    excludes waiting for a slot); MigrationModel(hw=H100) beside phase 3's
    measured migrate_pages. Returns (launches, record, the TP 1 table, the
    tiers); the record's ``served`` holds the 16 requests' stamps for
    phase 11."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.goodput import GoodputMeter, RequestRecord
    from repro_torch.core.migration import MigrationModel
    from repro_torch.core.planner import Planner, PlannerInputs, TierDemand
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.profiles.perf_model import H100, PerfModel, clear_perf_caches
    from repro_torch.profiles.profiler import ProfileTable, TabulatedPerfModel, profile_engine
    from repro_torch.profiles.slo import derive_tiers
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    from repro_torch.testing.multicard import PLAN_CHIPS, PLAN_DEMANDS, draw_weights

    t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    measured = h100_fields(torch, dev, cfg, decode_row, flush, log)
    del flush
    rec = {"h100": {k: {"measured": measured[k], "committed": getattr(H100, k)}
                    for k in ("hbm_bytes", "vmem_bytes", "flops_eff", "bw_eff", "ici_latency_s")},
           "h100_rows": measured["rows"], "h100_spec": dataclasses.asdict(H100)}
    log(f"phase 10: H100 spec fields, measured on this card vs committed in perf_model.H100: {json.dumps(rec['h100'])}; "
        f"rows {json.dumps(measured['rows'])}")

    econf = engine_conf(torch, cfg, torch.bfloat16)
    params = draw_weights(cfg, dev, torch.bfloat16)
    eng = ServingEngine(cfg, params, econf, device=dev)
    rec["warmup_s"] = eng.warmup()
    tp_shard_matmul.launches = paged_decode_attention.launches = 0
    before = replayed(eng)
    t1 = time.perf_counter()
    table = profile_engine(eng, batches=PROFILE_BATCHES, ctxs=PROFILE_CTXS)
    rec["profile_s"] = time.perf_counter() - t1
    launches = {"tp_shard_matmul": tp_shard_matmul.launches, "paged_decode_attention": paged_decode_attention.launches}
    by_replay = {k: n - before.get(k, 0) for k, n in replayed(eng).items()}
    check(all(n > 0 for n in launches.values()) and launches == {k: by_replay.get(k, 0) for k in launches},
          f"phase 10: every launch of the profile came from a graph replay: {launches} vs replays {by_replay}")
    rec["launches"] = launches

    tp1 = ProfileTable({k: v for k, v in table.decode_s.items() if k[0] == 1},
                       {k: v for k, v in table.prefill_s.items() if k[0] == 1})
    full_depth = cfg.num_layers == get_config(cfg.name).num_layers
    fname = f"{cfg.name}_h100.json" if full_depth else f"{cfg.name}-{cfg.num_layers}l_h100.json"
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    paths = [out_dir / fname] + ([TABLES / fname] if full_depth else [])
    for path in paths:
        tp1.save(str(path))
        back = ProfileTable.load(str(path))
        check(back.decode_s == tp1.decode_s and back.prefill_s == tp1.prefill_s, f"{path} round-trips")
    rec["table"] = {"files": [str(p.relative_to(ROOT)) for p in paths],
                    "decode_ms": {f"{tp}/{b}/{c}": v * 1e3 for (tp, b, c), v in tp1.decode_s.items()},
                    "prefill_ms": {f"{tp}/{L}": v * 1e3 for (tp, L), v in tp1.prefill_s.items()}}
    rec["one_card_tp_rows"] = {
        "label": "t ranks run one after another on one card; not a t-card step",
        "decode_ms": {f"{tp}/{b}/{c}": v * 1e3 for (tp, b, c), v in table.decode_s.items() if tp > 1},
        "prefill_ms": {f"{tp}/{L}": v * 1e3 for (tp, L), v in table.prefill_s.items() if tp > 1}}
    log(f"phase 10: {cfg.name} bf16 ({cfg.num_layers} layers) profiled by graph replays in {rec['profile_s']:.1f} s, "
        f"launches {json.dumps(launches)}; TP 1 table ({', '.join(rec['table']['files'])}): "
        f"decode ms {json.dumps(rec['table']['decode_ms'])}, prefill ms {json.dumps(rec['table']['prefill_ms'])}")
    log(f"phase 10: TP > 1 rows, t ranks run one after another on one card; not a t-card step: "
        f"{json.dumps({k: v for k, v in rec['one_card_tp_rows'].items() if k != 'label'})}")

    analytic = PerfModel(cfg, H100)
    calib = {"decode 8 x ctx 64": (tp1.decode_s[(1, 8, 64)], analytic.decode_step_time_s(8, 64, 1))}
    calib.update({f"prefill {L}": (tp1.prefill_s[(1, L)], analytic.prefill_time_s(L, 1)) for L in econf.prefill_buckets})
    rec["calibration"] = {k: {"measured_ms": m * 1e3, "analytic_ms": a * 1e3, "measured_over_analytic": m / a}
                          for k, (m, a) in calib.items()}
    log(f"phase 10: TP 1 measured vs PerfModel(cfg, H100): {json.dumps(rec['calibration'])}")

    clear_perf_caches()  # the memo is shared by every tabulated model of this config (ROADMAP, Reference notes)
    perf = TabulatedPerfModel(cfg, tp1, hw=H100)
    tiers = derive_tiers(perf, 64)
    plan = Planner(perf, tiers).plan(PlannerInputs(
        {name: TierDemand(rps, 64, 24) for name, rps in PLAN_DEMANDS.items()}, total_chips=PLAN_CHIPS))
    rec["tiers"] = [dataclasses.asdict(t) for t in tiers]
    # chips_used() counts prefill and decode groups only, not mixed ones (ROADMAP, Reference notes)
    allocated = sum(t.prefill.chips + t.decode.chips + (t.mixed.chips if t.mixed else 0) for t in plan.tiers.values())
    rec["plan"] = {"chips_used": plan.chips_used(), "chips_with_mixed": allocated, "leftover_chips": plan.leftover_chips,
                   "planning_ms": plan.planning_ms, "demands_rps": PLAN_DEMANDS,
                   "tiers": {n: {"prefill_tp": t.prefill.tp, "prefill_chips": t.prefill.chips, "decode_tp": t.decode.tp,
                                 "decode_chips": t.decode.chips, "served_rps": t.served_rps,
                                 "mixed": None if t.mixed is None else {"tp": t.mixed.tp, "chips": t.mixed.chips}}
                             for n, t in plan.tiers.items()}}
    check(plan.chips_used() <= allocated <= PLAN_CHIPS, f"phase 10: the plan uses at most {PLAN_CHIPS} chips: {rec['plan']}")
    log(f"phase 10: tiers from the table {json.dumps(rec['tiers'])}; plan on {PLAN_CHIPS} chips for "
        f"{json.dumps(PLAN_DEMANDS)} req/s (prompt 64, output 24): {json.dumps(rec['plan'])}")

    rng = np.random.RandomState(11)
    reqs = [Request(900 + i, ("strict", "relaxed")[i % 2], rng.randint(0, cfg.vocab_size, size=64).astype(np.int32), 24)
            for i in range(16)]
    t1 = time.perf_counter()
    done = eng.run(reqs)
    horizon = time.perf_counter() - t1
    check(len(done) == 16 and all(len(r.generated) == 24 for r in done), "phase 10: 16 requests served")
    rec["served"] = {"run_start_s": t1, "requests": [
        {"tier": r.tier, "arrival_s": r.arrival_s, "first_token_s": r.first_token_s, "finish_s": r.finish_s,
         "prompt_len": r.prompt_len, "tokens_out": len(r.generated)} for r in done]}
    meter = GoodputMeter({t.name: t for t in tiers})
    for r in done:
        meter.add(RequestRecord(r.req_id, r.tier, r.arrival_s, r.prompt_len, len(r.generated), r.first_token_s,
                                r.finish_s, len(r.generated)))
    rec["goodput"] = {"horizon_s": horizon, "per_tier_rps": meter.per_tier_goodput(horizon),
                      "latency_ms": {t: meter.latency_percentiles(t, q=(50,)) for t in ("strict", "relaxed")},
                      "met": {t: sum(meter.meets_slo(r) for r in meter.records if r.tier == t) for t in ("strict", "relaxed")}}
    log(f"phase 10: 16 requests (8 per tier, prompt 64, 24 tokens) at TP 1 scored against those tiers: "
        f"{json.dumps(rec['goodput'])}")

    mm = MigrationModel(hw=H100)
    rec["migration_model"] = {}
    for ctx, m in migration.items():
        nbytes = m["bytes_moved"]
        rec["migration_model"][ctx] = {
            "bytes": nbytes, "measured_migrate_pages_ms": m["migrate_pages_ms"]["median"],
            "aggregated_ms": mm.aggregated_s(nbytes) * 1e3, "pipelined_ms": mm.pipelined_s(nbytes) * 1e3,
            "gather_term_ms": 2 * nbytes / (H100.hbm_bw * H100.bw_eff) * 1e3}
        if "fig7" in m:
            rec["migration_model"][ctx].update(naive_ms=mm.naive_per_page_s(m["fig7"]["bytes"]) * 1e3,
                                               measured_per_page_copy_ms=m["fig7"]["per_page_copy_ms"]["median"])
    log(f"phase 10: MigrationModel(hw=H100) (link fields published, not measured) beside phase 3's migrate_pages "
        f"(on one card the send is the identity): {json.dumps(rec['migration_model'])}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t0
    return launches, rec, tp1, tiers


# phase 11: the serving simulator on the card's numbers
# ---------------------------------------------------------------------------
FIG9_SYSTEMS = ("nitsum", "sglang", "sglang-pd", "split", "llumnix", "chiron")  # benchmarks/fig9_goodput.py
FIG9_TRACES = ("servegen", "azure")
FIG9_SCALES = (0.5, 1.0, 2.0)
FIG9_HORIZON_S = 300.0
FIG9_CHIPS = 16  # benchmarks/common.py's pool for llama3-8b
SIM_WORKERS = min(8, os.cpu_count() or 1)


def sim_pool():
    """Worker processes for the simulator's replays (host code, numpy):
    spawned, so that none inherits the parent's CUDA context, and each with
    its own perf-model memo."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=SIM_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def golden_case(name):
    from repro_torch.testing import sim_equivalence as eq

    return eq.run_case(name)


def fig9_perf(kind, model, table):
    """A fresh perf model after a cleared memo: tabulated models of one
    config share it (ROADMAP, Reference notes)."""
    from repro_torch.configs import get_config
    from repro_torch.profiles.perf_model import H100, PerfModel, clear_perf_caches
    from repro_torch.profiles.profiler import TabulatedPerfModel
    from repro_torch.profiles.slo import derive_tiers

    clear_perf_caches()
    cfg = get_config(model)
    perf = TabulatedPerfModel(cfg, table, hw=H100) if kind == "tabulated" else PerfModel(cfg, H100)
    return perf, derive_tiers(perf, prompt_len=900, ctx_len=1000, candidate_tps=(1, 2, 4, 8))


def fig9_cell(kind, model, table, trace, scale, system):
    """One run of the Fig. 9 matrix (benchmarks/fig9_goodput.py): azure at
    rps_scale x 10, as fig9 does."""
    from repro_torch.serving.simulator import run_system
    from repro_torch.traces.azure import azure_two_tier
    from repro_torch.traces.servegen import servegen_two_tier

    perf, tiers = fig9_perf(kind, model, table)
    wl = (servegen_two_tier(horizon_s=FIG9_HORIZON_S, rps_scale=scale) if trace == "servegen"
          else azure_two_tier(horizon_s=FIG9_HORIZON_S, rps_scale=scale * 10))
    sim, _ = run_system(system, perf, tiers, FIG9_CHIPS, wl)
    res = sim.result(wl.horizon_s)
    return {"goodput": res.goodput, "per_tier": res.per_tier_goodput, "finished": res.finished,
            "reconfig_count": res.reconfig_count, "spill_total": res.spill_total, "n_requests": len(wl.requests),
            "rps": wl.rps, "horizon_s": wl.horizon_s}


def check_goldens(pool, card, log):
    """Every case of the port's sim_equivalence at V5E against the
    reference's committed goldens (benchmarks/results/sim_golden.json),
    with check_case at DEFAULT_RTOL; the fault cases run with the KV audit
    armed. Any violation raises."""
    from repro_torch.testing import sim_equivalence as eq

    golden = eq.load_golden()
    names = list(eq.CASES)
    out, bad = {}, []
    for name, got in zip(names, pool.map(golden_case, names)):
        bad += eq.check_case(name, golden, got=got)
        out[name] = {"goodput": got["goodput"], "golden_goodput": golden["cases"][name]["goodput"],
                     "finished": got["finished"], "golden_finished": golden["cases"][name]["finished"]}
    check(not bad, f"phase 11: the simulator's goldens: {bad}")
    log(f"[{card}] phase 11: {len(out)} of {len(names)} golden cases within rtol {eq.DEFAULT_RTOL} of "
        f"{eq.GOLDEN_PATH.relative_to(ROOT)} (V5E, the fault cases with the KV audit armed)")
    return out


def fig9_matrix(pool, kind, label, model, table, card, log):
    """The Fig. 9 comparison: six systems on servegen_two_tier and
    azure_two_tier, rps_scale 0.5/1/2, a 300 s horizon, 16 chips, tiers
    from derive_tiers(perf, prompt_len=900, ctx_len=1000). Goodput per
    system and tier, and nitsum's ratio to the best baseline at each load;
    the checks are finite values and each run's own accounting."""
    _, tiers = fig9_perf(kind, model, table)
    out = {"tiers": [dataclasses.asdict(t) for t in tiers], "traces": {}}
    log(f"[{card}] phase 11 fig9 ({label}): tiers {json.dumps(out['tiers'])}")
    cells = [(tr, sc, sy) for tr in FIG9_TRACES for sc in FIG9_SCALES for sy in FIG9_SYSTEMS]
    runs = dict(zip(cells, pool.map(fig9_cell, *zip(*[(kind, model, table, *c) for c in cells]))))
    for (trace, scale, system), r in runs.items():
        good = [r["goodput"], *r["per_tier"].values()]
        n_good = round(r["goodput"] * r["horizon_s"])
        check(all(math.isfinite(g) and g >= 0 for g in good)
              and n_good == sum(round(v * r["horizon_s"]) for v in r["per_tier"].values())
              and n_good <= r["finished"] <= r["n_requests"],
              f"phase 11 fig9 {label} {trace} x{scale} {system}: {r}")
    for trace in FIG9_TRACES:
        rows = out["traces"][trace] = []
        for scale in FIG9_SCALES:
            systems = {sy: runs[(trace, scale, sy)] for sy in FIG9_SYSTEMS}
            base = max(FIG9_SYSTEMS[1:], key=lambda sy: systems[sy]["goodput"])
            best = systems[base]["goodput"]
            row = {"rps_scale": scale, "rps": systems["nitsum"]["rps"], "n_requests": systems["nitsum"]["n_requests"],
                   "systems": {sy: {k: v for k, v in r.items() if k not in ("rps", "n_requests", "horizon_s")}
                               for sy, r in systems.items()},
                   "best_baseline": base,
                   "nitsum_over_best_baseline": systems["nitsum"]["goodput"] / best if best > 0 else None}
            rows.append(row)
            log(f"[{card}] phase 11 fig9 ({label}) {trace} rps_scale {scale} ({row['rps']:.4f} req/s, "
                f"{row['n_requests']} requests): goodput req/s " + ", ".join(
                    f"{sy} {r['goodput']:.4f} ({', '.join(f'{t} {g:.4f}' for t, g in r['per_tier'].items())})"
                    for sy, r in row["systems"].items())
                + f"; nitsum / best baseline ({base}) {row['nitsum_over_best_baseline']}")
    return out


def simulator_fit(perf, tiers, served, card, log):
    """Phase 10's 16 served requests replayed through the simulator
    (static-tp1 on 1 chip, all arriving at 0, the same tiers and lengths):
    predicted per-tier p50 TTFT, p50 TPOT and requests met beside the
    measured ones, TTFT measured from admission (as the engine stamps it)
    and from the run's start (like for like with the simulator's arrival
    0)."""
    from repro_torch.core.goodput import GoodputMeter, RequestRecord
    from repro_torch.serving.simulator import run_system
    from repro_torch.traces.workload import TraceRequest, Workload

    reqs = served["requests"]
    wl = Workload("phase10-replay", [TraceRequest(i, r["tier"], 0.0, r["prompt_len"], r["tokens_out"])
                                     for i, r in enumerate(reqs)], horizon_s=60.0)
    _, predicted = run_system("static-tp1", perf, tiers, 1, wl)
    check(len(predicted.records) == len(reqs), f"phase 11 fit: {len(predicted.records)} of {len(reqs)} replayed")
    by_tier = {t.name: t for t in tiers}
    meters = {"predicted": predicted}
    for name, start in (("measured_from_admission", None), ("measured_from_run_start", served["run_start_s"])):
        m = meters[name] = GoodputMeter(by_tier)
        for i, r in enumerate(reqs):
            m.add(RequestRecord(i, r["tier"], r["arrival_s"] if start is None else start, r["prompt_len"],
                                r["tokens_out"], r["first_token_s"], r["finish_s"], r["tokens_out"]))
    out = {name: {t: {**m.latency_percentiles(t, q=(50,)),
                      "met": sum(m.meets_slo(r) for r in m.records if r.tier == t),
                      "n": sum(r.tier == t for r in m.records)} for t in by_tier}
           for name, m in meters.items()}
    log(f"[{card}] phase 11 fit: {len(reqs)} requests of phase 10 (prompt {reqs[0]['prompt_len']}, "
        f"{reqs[0]['tokens_out']} tokens) through static-tp1 on 1 chip at the tabulated model vs the engine: "
        f"{json.dumps(out)}")
    return out


def simulator_phase(cfg, table, tiers, served, card, log):
    """Phase 11: host code only, the replays in SIM_WORKERS spawned
    processes. The goldens (asserted), the Fig. 9 matrix of the full model
    under TabulatedPerfModel(cfg, table, hw=H100) and PerfModel(cfg, H100)
    (printed; ``table`` is phase 10's, or the committed one when --layers
    cut the depth), and the one-card fit of phase 10's ``cfg``, ``table``
    and tiers against its served requests (printed). Asserts that every
    kernel's launch count stays as it was."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.profiles.perf_model import H100, clear_perf_caches
    from repro_torch.profiles.profiler import ProfileTable, TabulatedPerfModel

    t0 = time.perf_counter()
    before = {k.__name__: k.launches for k in _build.COUNTED}
    full = get_config(cfg.name)
    fig9_table = table if cfg.num_layers == full.num_layers else ProfileTable.load(str(TABLES / f"{cfg.name}_h100.json"))
    with sim_pool() as pool:
        rec = {"workers": SIM_WORKERS, "goldens": check_goldens(pool, card, log), "fig9": {}}
        for kind, label in (("tabulated", "tabulated: H100 TP 1 table, analytic past it"),
                            ("analytic", "analytic: PerfModel(cfg, H100)")):
            rec["fig9"][label] = fig9_matrix(pool, kind, label, full.name, fig9_table, card, log)
    clear_perf_caches()
    rec["fit"] = simulator_fit(TabulatedPerfModel(cfg, table, hw=H100), tiers, served, card, log)
    clear_perf_caches()
    after = {k.__name__: k.launches for k in _build.COUNTED}
    check(after == before, f"phase 11 launches no kernel: {before} -> {after}")
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[{card}] phase 11: {rec['wall_s']:.1f} s on {SIM_WORKERS} worker processes, launch counts unchanged "
        f"{json.dumps(after)}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: training
# ---------------------------------------------------------------------------
TRAIN_MODEL = "h2o-danube-1.8b"
GRAD_TOL = 1e-4  # per leaf, of the leaf's max |g|: the CPU tests' bound against the reference
TRAIN_LOSS_RTOL = 2e-4  # the resumed run's losses against the uninterrupted run's (check_train_step's bound)


class PlainMatmul:
    """Within the block the model's projections take tp_shard_matmul's plain
    version (autograd through torch ops) instead of the kernel: the
    comparison run of phase 12 (a)."""

    def __enter__(self):
        from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref
        from repro_torch.models import layers

        self.layers, self.kernel = layers, layers.tp_shard_matmul
        layers.tp_shard_matmul = lambda x, w, off, *, n_out, mode="col", out_dtype=None: tp_shard_matmul_ref(
            x, w, off, mode=mode, n_out=n_out, out_dtype=out_dtype)
        return self

    def __exit__(self, *exc):
        self.layers.tp_shard_matmul = self.kernel


def train_params(torch, dev, cfg, dtype=None):
    """Weights from seed 0 (f32, or ``dtype``), each layer's leaves at its
    own fan-in."""
    from repro_torch.models import init_params
    from repro_torch.testing.multicard import weight_defs

    return init_params(weight_defs(cfg, own_fan_in=True), torch.Generator(device=dev).manual_seed(0),
                       dtype or torch.float32)


def tree_bytes(tree):
    from repro_torch.checkpoint.checkpoint import tree_leaves
    from repro_torch.training.optimizer import Zero1Shards

    return sum(sum(p.numel() * p.element_size() for p in (x.parts if isinstance(x, Zero1Shards) else [x]))
               for x in tree_leaves(tree))


def grad_check(torch, dev, cfg, log, batch=4, seq=256):
    """(a) One loss_fn gradient of ``cfg`` through the kernel and through
    the plain version on the same CUDA tensors, per leaf within GRAD_TOL of
    the leaf's max |g|; then the matmul's autograd (row and col_t at a TP 2
    rank's offset, the shapes of wo and the tied head's embedding rows)
    against the plain version's autograd."""
    from repro_torch.core.weight_store import WeightStore
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref
    from repro_torch.models.model import loss_fn
    from repro_torch.models.params import tree_leaves_with_path
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.testing.multicard import weight_defs
    from repro_torch.training.data import synthetic_batch
    from repro_torch.training.train_step import batch_to

    ec = make_exec_config(cfg, 1)
    params = train_params(torch, dev, cfg)
    leaves = [t for _, t in tree_leaves_with_path(params)]
    for t in leaves:
        t.requires_grad_(True)
    store = WeightStore(cfg, weight_defs(cfg, own_fan_in=True), [dev])
    bound = store.rebind(store.build(params), 1)
    tb = batch_to(synthetic_batch(cfg, batch, seq, 0), dev, torch.float32)
    kw = dict(seq_chunk=min(256, seq), block_q=128, block_k=128)
    grads, losses, counts = {}, {}, {}
    for which in ("kernel", "plain"):
        for t in leaves:
            t.grad = None
        tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
        with PlainMatmul() if which == "plain" else contextlib.nullcontext():
            loss, _ = loss_fn(bound, cfg, ec, tb, **kw)
            loss.backward()
        sync(torch, dev)
        counts[which] = {"forward": tp_shard_matmul.launches, "backward": tp_shard_matmul.backward_launches}
        losses[which] = float(loss.detach())
        grads[which] = {"/".join(p): t.grad.clone() for p, t in tree_leaves_with_path(params)}
    check(counts["kernel"]["forward"] > 0 and counts["kernel"]["backward"] > 0 and not any(counts["plain"].values()),
          f"(a) the kernel ran in the kernel pass alone: {counts}")
    errs = {}
    for path, want in grads["plain"].items():
        got, scale = grads["kernel"][path], want.abs().max().item()
        check(scale > 0 and got.abs().max().item() > 0, f"(a) {path} has a gradient in both passes")
        errs[path] = (got - want).abs().max().item() / scale
    worst = max(errs, key=errs.get)
    check(errs[worst] <= GRAD_TOL, f"(a) per-leaf gradient within {GRAD_TOL} of max|g|: {worst} {errs[worst]:.2e}")
    check(abs(losses["kernel"] - losses["plain"]) <= 1e-5 * abs(losses["plain"]), f"(a) losses {losses}")
    del grads, params, bound, store, leaves
    gc.collect()
    # the matmul's autograd at a TP 2 rank's offset: row (wo's rows, dX a col_t launch), col_t (the
    # embedding's vocab rows as the tied head reads them, dX a row launch)
    g = torch.Generator(device=dev).manual_seed(5)
    M, d, hd_all, V = batch * seq, cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.vocab_padded
    modes = {}
    for mode, w_shape, x_shape, off, n_out in (("row", (hd_all, d), (M, hd_all // 2), hd_all // 2, d),
                                               ("col_t", (V, d), (M, d), V // 2, V // 2)):
        w0 = torch.randn(*w_shape, generator=g, device=dev) * d ** -0.5
        x0 = torch.randn(*x_shape, generator=g, device=dev)
        gy = torch.randn(M, n_out, generator=g, device=dev)
        out = {}
        for which in ("kernel", "plain"):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            fn = tp_shard_matmul if which == "kernel" else (
                lambda x, w, off, *, n_out, mode, out_dtype: tp_shard_matmul_ref(x, w, off, mode=mode, n_out=n_out,
                                                                                  out_dtype=out_dtype))
            (fn(x, w, off, n_out=n_out, mode=mode, out_dtype=torch.float32) * gy).sum().backward()
            out[which] = (x.grad, w.grad)
        sync(torch, dev)
        e = {}
        for name, got, want in zip(("dx", "dw"), out["kernel"], out["plain"]):
            e[name] = (got - want).abs().max().item() / want.abs().max().item()
            check(e[name] <= 1e-5, f"(a) {mode} at a TP 2 rank's offset: {name} within 1e-5 of the scale: {e[name]:.2e}")
        outside = out["kernel"][1].clone()
        outside.narrow(0, off, x_shape[1] if mode == "row" else n_out).zero_()
        check(not bool(outside.any()), f"(a) {mode}: the storage's gradient is zero outside the shard")
        modes[mode] = {"shape": f"x {x_shape}, w {w_shape}, offset {off}", **e}
    rec = {"model": f"{cfg.name} ({cfg.num_layers} layers, d {cfg.d_model})", "batch": [batch, seq],
           "loss": losses, "launches": counts, "worst_leaf": worst, "worst_err": errs[worst],
           "errs": errs, "autograd_tp2": modes}
    log(f"phase 12 (a) {rec['model']} f32, batch {batch} x {seq}: loss kernel {losses['kernel']:.6f} plain "
        f"{losses['plain']:.6f}; worst per-leaf gradient error {errs[worst]:.2e} of max|g| ({worst}; tolerance "
        f"{GRAD_TOL}); the kernel's launches {counts['kernel']}; autograd at a TP 2 offset {json.dumps(modes)}")
    return rec


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_train_step(torch, dev, run):
    """One train step under torch.profiler (CPU and CUDA activity): device ms
    by what ran: the matmul kernel (forward, recompute and backward dX
    launches), the attention (``train_attention``'s ops in the forward and
    the recompute and its backward node, its einsums included), the
    optimizer (clip and AdamW), the library's other GEMMs (the backward's
    dW and col dX products, the CE head's) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import attention
    from repro_torch.training import train_step

    labelled = {}

    def label(mod, name, tag):
        fn = getattr(mod, name)
        labelled[(mod, name)] = fn

        def wrapped(*a, **k):
            with record_function(tag):
                return fn(*a, **k)
        setattr(mod, name, wrapped)

    label(attention, "train_attention", "train.attention")  # the Function: its forward, and its backward node
    label(train_step, "clip_by_global_norm", "train.optimizer")
    label(train_step, "adamw_update", "train.optimizer")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    try:
        sync(torch, dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            sync(torch, dev)
            wall = time.perf_counter() - t0
    finally:
        for (mod, name), fn in labelled.items():
            setattr(mod, name, fn)
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.time_range.elapsed_us() for e in device)

    def tagged(e, tag):
        while e is not None:
            if e.name == tag:
                return True
            e = e.cpu_parent
        return False

    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    attn_seq = {e.sequence_nr for e in cpu if e.sequence_nr >= 0 and tagged(e, "train.attention")}

    def backward_of_attention(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in attn_seq:
                return True
            e = e.cpu_parent
        return False

    split = {"tp_shard_matmul": 0.0, "attention": 0.0, "optimizer": 0.0, "library_gemm": 0.0}
    split["tp_shard_matmul"] = sum(e.time_range.elapsed_us() for e in device if any(k in e.name for k in MATMUL_KERNELS))
    for e in cpu:
        for k in e.kernels:
            if any(m in k.name for m in MATMUL_KERNELS):
                continue
            if tagged(e, "train.optimizer"):
                split["optimizer"] += k.duration
            elif tagged(e, "train.attention") or backward_of_attention(e):
                split["attention"] += k.duration
            elif any(m in k.name.lower() for m in LIBRARY_GEMM):
                split["library_gemm"] += k.duration
    split["rest"] = total - sum(split.values())
    out = {k: v / 1e3 for k, v in split.items()}
    out.update(device_ms=total / 1e3, traced_wall_ms=wall * 1e3, busy_share=total / 1e6 / wall if wall else 0.0)
    return out


def train_full(torch, dev, cfg, log, steps=20, batch=8, seq=512, dtype=None):
    """(c) ``cfg`` trained for ``steps`` steps of SyntheticDataset(batch, seq)
    in f32 (or ``dtype``, the moments f32) through make_train_step (the
    layer recompute; seq_chunk 256, blocks 128): finite losses, the mean of
    the last 5 below the first; step times, tokens/s, peak memory against
    the reckoning, the matmul's launches per step (counts set to 0 just
    before the steps, read just after), then one step profiled."""
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.models.params import count_params
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.testing.multicard import weight_defs
    from repro_torch.training.data import SyntheticDataset
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

    t0 = time.perf_counter()
    n_params = count_params(weight_defs(cfg, own_fan_in=True))
    dtype = dtype or torch.float32
    params = train_params(torch, dev, cfg, dtype)
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=5), seq_chunk=min(256, seq), block_q=128,
                           block_k=128)
    step, _ = make_train_step(cfg, make_exec_config(cfg, 1), params, tcfg)
    opt = init_opt_state(params, tcfg)
    reckoned = {"params": tree_bytes(params), "grads": tree_bytes(params), "moments": tree_bytes(opt)}
    reckoned["before_activations"] = sum(reckoned.values())
    ds = SyntheticDataset(cfg, batch, seq)
    sync(torch, dev)
    made_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tp_shard_matmul.launches = tp_shard_matmul.backward_launches = 0
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, _, m = step(params, opt, ds.at(i))
        losses.append(float(m["loss"]))  # the sync
        times.append(time.perf_counter() - t0)
    launches = {"forward": tp_shard_matmul.launches, "backward": tp_shard_matmul.backward_launches}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    check(all(math.isfinite(x) for x in losses), f"(c) finite losses: {losses}")
    check(sum(losses[-5:]) / 5 < losses[0], f"(c) the mean of the last 5 losses below the first: {losses}")
    check(launches["forward"] > 0 and launches["backward"] > 0, f"(c) tp_shard_matmul launched: {launches}")
    split = profile_train_step(torch, dev, lambda: float(step(params, opt, ds.at(steps))[2]["loss"]))
    st = sorted(times[1:]) if len(times) > 1 else times
    med = st[len(st) // 2]
    name = str(dtype).replace("torch.", "")
    rec = {"model": cfg.name, "layers": cfg.num_layers, "dtype": name, "params": n_params, "steps": steps,
           "batch": [batch, seq],
           "losses": losses, "step_s": times, "step_s_median": med, "step_s_min": st[0], "step_s_max": st[-1],
           "first_step_s": times[0], "tokens_per_s": batch * seq / med, "peak_bytes": peak,
           "reckoned_bytes": reckoned, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}, "profiled_step": split,
           "setup_s": made_s}
    log(f"phase 12 (c) {cfg.name} {name}, {cfg.num_layers} layers, {n_params / 1e9:.3f} B parameters, batch {batch} x "
        f"{seq}, {steps} steps: losses {[round(x, 4) for x in losses]}; step {med:.3f} s median (min {st[0]:.3f}, max "
        f"{st[-1]:.3f}; first {times[0]:.3f}), {batch * seq / med:.0f} tokens/s; peak "
        f"{(peak or 0) / 1e9:.2f} GB (reckoned before activations {reckoned['before_activations'] / 1e9:.2f}: params "
        f"{reckoned['params'] / 1e9:.2f}, grads {reckoned['grads'] / 1e9:.2f}, moments {reckoned['moments'] / 1e9:.2f}); "
        f"tp_shard_matmul launches per step {rec['launches_per_step']}; one step under the profiler {json.dumps(split)}")
    del params, opt, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, rec


def checkpoint_round_trip(torch, dev, cfg, log, batch=8, seq=512):
    """(d) ``multidev_checks.checkpoint_round_trip`` over ``cfg`` in one
    process: train_loop runs 8 steps with a checkpoint every 4; a second
    run fails at step 6 and is resumed from its latest checkpoint, which
    must load back onto the card bit for bit (against a copy taken as it
    was saved) and give the uninterrupted run's losses within
    TRAIN_LOSS_RTOL (CUDA's atomics in the embedding's and the CE's
    backward keep it from being bitwise). The save and load seconds are
    timed; the directory is removed after."""
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.testing.multidev_checks import checkpoint_round_trip as round_trip
    from repro_torch.training.data import SyntheticDataset
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step

    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=5), seq_chunk=min(256, seq), block_q=128,
                           block_k=128)

    def fresh():
        params = train_params(torch, dev, cfg)
        step, _ = make_train_step(cfg, make_exec_config(cfg, 1), params, tcfg)
        return step, params, init_opt_state(params, tcfg)

    a, ck = round_trip(fresh, SyntheticDataset(cfg, batch, seq), str(ROOT / "build" / "train_ckpt"))
    del a
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(not ck["failures"], f"(d) the round trip through the checkpoint: {ck['failures']}")
    check(ck["max_rel_diff"] <= TRAIN_LOSS_RTOL, f"(d) resumed within {TRAIN_LOSS_RTOL}: {ck['max_rel_diff']}")
    rec = {"model": f"{cfg.name} ({cfg.num_layers} layers)", "checkpoint_bytes": ck["state_bytes"],
           "saves": ck["saves"], "load_s": ck["load_s"], "losses": ck["losses"],
           "resumed_losses": ck["resumed_losses"], "max_rel_diff": ck["max_rel_diff"],
           "bitwise_equal_resumed": ck["bitwise_equal_resumed"]}
    log(f"phase 12 (d) {rec['model']}: checkpoint {rec['checkpoint_bytes'] / 1e9:.2f} GB; saves "
        f"{[round(x['s'], 2) for x in ck['saves']]} s, load {[round(x, 2) for x in ck['load_s']]} s; step "
        f"{ck['every']} loaded back bit for bit; resumed losses {ck['resumed_losses']} against "
        f"{ck['losses'][ck['every']:]} (max relative difference {ck['max_rel_diff']:.2e}, bitwise equal: "
        f"{rec['bitwise_equal_resumed']})")
    return rec


BF16_TRAIN_STEPS = 12


# the train attention check: each windowed model's attention geometry at S 2048, blocks of 512 and a window of
# 1024 (which leaves the pairs of Q block 3 and KV block 0 dead), batch 1
TRAIN_ATTENTION = {"S": 2048, "block": 512, "window": 1024}
TRAIN_ATTENTION_CASES = [(name, dtype) for name in WINDOWED for dtype in ("float32", "bfloat16")]


def train_attention_grads(name, dtype, device):
    """``models.attention.train_attention`` at ``name``'s attention geometry
    (TRAIN_ATTENTION) on ``device``: inputs and the output's cotangent
    drawn with numpy from seed 0, in ``dtype``; returns the output, dq, dk
    and dv as f32 numpy arrays, and the seconds of the backward."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.attention import live_blocks, train_attention

    KV, G, hd, cap = attention_geometry(get_config(name))
    S, block, window = TRAIN_ATTENTION["S"], TRAIN_ATTENTION["block"], TRAIN_ATTENTION["window"]
    r = np.random.RandomState(0)
    dt = getattr(torch, dtype)
    q, c = (torch.from_numpy(r.randn(1, S, KV, G, hd).astype(np.float32)).to(device, dt) for _ in range(2))
    k, v = (torch.from_numpy(r.randn(1, S, KV, hd).astype(np.float32)).to(device, dt) for _ in range(2))
    for t in (q, k, v):
        t.requires_grad_(True)
    pos = torch.arange(S, device=device)
    live = live_blocks(pos.cpu(), window, block, block)
    out = train_attention(q, k, v, pos, live, window=window, cap=cap, block_q=block, block_k=block).to(dt)
    t0 = time.perf_counter()
    out.backward(c)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return [t.detach().float().cpu().numpy() for t in (out, q.grad, k.grad, v.grad)], seconds, int((~live).sum())


def train_attention_cpu(name, dtype):
    """In a host worker: ``train_attention_grads`` on the CPU."""
    import torch

    torch.set_num_threads(2)
    return train_attention_grads(name, dtype, torch.device("cpu"))


def bf16_ulp(x):
    import numpy as np

    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def check_train_attention(torch, dev, futures, log):
    """Train mode's attention (``models.attention._TrainAttention``, plain
    torch: no kernel of its own) on the card against the same Function on
    the CPU (run in a host worker) on the same inputs, at each
    TRAIN_ATTENTION_CASES case: in f32 the output and each gradient within
    1e-5 of its max |g|; in bf16 every element within one bf16 ulp of the
    tensor's max |g|, fewer than 1% of the elements differing (a gradient
    element is a bf16 sum of its block pairs' rounded gradients, so where
    one pair's f32 value lies an f32 ulp or so apart and rounds the other
    way, the element moves by an ulp of that addend, which cancellation can
    leave far above the element itself; the share differing, and the count
    past two ulps of the larger of the element and 1e-3 of max |g|, are
    printed)."""
    import numpy as np

    rec = {}
    for name, dtype in TRAIN_ATTENTION_CASES:
        got, seconds, dead = train_attention_grads(name, dtype, dev)
        want, cpu_s, _ = futures[(name, dtype)].get(timeout=900)
        check(dead > 0, f"the train attention case leaves dead pairs: {dead}")
        row = {"cuda_backward_s": seconds, "cpu_backward_s": cpu_s, "dead_pairs": dead}
        for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
            check(np.isfinite(g).all(), f"train attention {name} {dtype} {what}: finite")
            top, diff = float(np.abs(w).max()), np.abs(g - w)
            r = {"max_abs_err_over_max": float(diff.max()) / top, "share_differing": float(np.mean(g != w))}
            if dtype == "float32":
                check(diff.max() <= 1e-5 * top, f"train attention {name} f32 {what}: {r} (tolerance 1e-5 of max |g|)")
            else:
                floor = bf16_ulp(np.maximum(np.abs(w), 1e-3 * top))
                r["past_two_ulps_of_max_self_or_1e-3_max"] = int((diff > 2 * floor).sum())
                r["ulps_of_max"] = float(diff.max() / bf16_ulp(top))
                check(diff.max() <= bf16_ulp(top) and r["share_differing"] < 1e-2,
                      f"train attention {name} bf16 {what}: {r} (tolerance: one bf16 ulp of max |g|, < 1% differing)")
            row[what] = r
        rec[f"{name} {dtype}"] = row
        log(f"phase 12 (e) train attention {name} {dtype} (S {TRAIN_ATTENTION['S']}, blocks {TRAIN_ATTENTION['block']}, "
            f"window {TRAIN_ATTENTION['window']}, {dead} dead pairs) on the card against the CPU: {json.dumps(row)}")
    return rec


def training_phase(torch, dev, log, cfg=None, steps=20, batch=8, seq=512, small_batch=(4, 256), attention=None):
    """Phase 12: (a) grad_check on ``cfg`` cut to 2 layers, (b)
    check_train_step, (c) train_full at ``cfg``'s depth in f32, then in
    bf16 (BF16_TRAIN_STEPS steps; f32 moments), (d) checkpoint_round_trip
    at 2 layers. Returns ({"train": forward launches, "train backward":
    backward launches} of (c) in f32, and "train bf16", "train bf16
    backward" of the bf16 run, the record). With ``attention`` (the host
    workers' futures of ``train_attention_cpu``), last, the train
    attention check (``check_train_attention``)."""
    from repro_torch.configs import get_config
    from repro_torch.testing.multidev_checks import check_train_step

    cfg = cfg or get_config(TRAIN_MODEL)
    t_phase = time.perf_counter()
    rec = {}
    t0 = time.perf_counter()
    rec["grad_check"] = grad_check(torch, dev, cut(cfg, 2), log, *small_batch)
    rec["grad_check"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["check_train_step"] = check_train_step(dev)
    rec["check_train_step"]["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 (b) check_train_step (reduced {TRAIN_MODEL}, data 2 x model 2, ZeRO-1, 5 steps) holds in "
        f"{rec['check_train_step']['wall_s']:.1f} s: {json.dumps(rec['check_train_step'])}")
    t0 = time.perf_counter()
    launches, rec["train"] = train_full(torch, dev, cfg, log, steps, batch, seq)
    rec["train"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf16, rec["train_bf16"] = train_full(torch, dev, cfg, log, BF16_TRAIN_STEPS, batch, seq, torch.bfloat16)
    rec["train_bf16"]["wall_s"] = time.perf_counter() - t0
    f32_peak = rec["train"]["peak_bytes"]
    log(f"phase 12 (c) {cfg.name} bf16 against f32: peak {(rec['train_bf16']['peak_bytes'] or 0) / 1e9:.2f} GB against "
        f"{(f32_peak or 0) / 1e9:.2f}; step {rec['train_bf16']['step_s_median']:.3f} s against "
        f"{rec['train']['step_s_median']:.3f}; losses over the first {BF16_TRAIN_STEPS} steps "
        f"{[round(x, 4) for x in rec['train_bf16']['losses']]} against {[round(x, 4) for x in rec['train']['losses'][:BF16_TRAIN_STEPS]]}")
    t0 = time.perf_counter()
    rec["checkpoint"] = checkpoint_round_trip(torch, dev, cut(cfg, 2), log, batch=batch, seq=seq)
    rec["checkpoint"]["wall_s"] = time.perf_counter() - t0
    if attention is not None:
        t0 = time.perf_counter()
        rec["train_attention"] = check_train_attention(torch, dev, attention, log)
        rec["train_attention"]["wall_s"] = time.perf_counter() - t0
    rec["wall_s"] = time.perf_counter() - t_phase
    return {"train": launches["forward"], "train backward": launches["backward"], "train bf16": bf16["forward"],
            "train bf16 backward": bf16["backward"]}, rec


# ---------------------------------------------------------------------------
# phases 13 and 14: the launchers, the examples, the gate and the dry run
# ---------------------------------------------------------------------------
# the train launcher's run: h2o-danube-1.8b at full width, cut to this depth, N then 2N steps
LAUNCH_TRAIN_LAYERS, LAUNCH_TRAIN_STEPS = 4, 5


HOST_WORKERS = max(1, min(8, os.cpu_count() or 1) - 2)


def lowest_priority():
    os.nice(19)


@contextlib.contextmanager
def host_pool(workers):
    """Spawned worker processes for host code (the gates, the dry run), at
    the lowest priority, so that the process driving the card keeps its
    core: none inherits the parent's CUDA context or touches the card. If
    the body raises, the workers are terminated at once."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(workers, initializer=lowest_priority)
    try:
        yield pool
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.close()
        pool.join()


def gate_run(hw):
    """In a worker: the length-regime gate at ``hw``, (exit code, its lines, seconds)."""
    import contextlib
    import io

    from repro_torch.testing import length_regime_gate

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = length_regime_gate.main(["--hw", hw])
    return rc, out.getvalue(), time.perf_counter() - t0


def dryrun_cell(arch, shape, out_dir):
    """In a worker: one dry-run cell, (its JSON or None, its lines or the traceback)."""
    import traceback

    from repro_torch.launch import dryrun

    lines = []
    try:
        return dryrun.run_cell(arch, shape, False, out_dir, log=lines.append), lines
    except Exception:  # noqa: BLE001 - reported per cell; any failure fails phase 14
        return None, [traceback.format_exc()]


def start_host_work(pool):
    """Submit the gates and every applicable cell of the dry-run grid (the
    longest first); returns the futures and the submission time."""
    from repro_torch.launch.cells import all_cells

    from repro_torch.configs import SHAPES, get_config

    def cost(cell):
        """A rough count of the cell's ops: layers x the step's work, the
        selective scan's chunks (mamba-1) four times as many."""
        cfg = get_config(cell[0])
        per_layer = {"train": 8, "prefill": 2, "decode": 0.1}[SHAPES[cell[1]].kind]
        return cfg.num_layers * per_layer * (4 if cfg.mamba is not None and cfg.mamba.version == 1 else 1)

    cells = sorted((c for c in all_cells() if c[2]), key=cost, reverse=True)
    out_dir = str(ROOT / "chiprun_out" / "dryrun")
    futures = {"gate": {hw: pool.apply_async(gate_run, (hw,)) for hw in ("v5e", "h100")},
               "cells": {(a, sh): pool.apply_async(dryrun_cell, (a, sh, out_dir)) for a, sh, _ in cells},
               "skipped": [(a, sh) for a, sh, ok in all_cells() if not ok]}
    return futures, time.perf_counter()


# ---------------------------------------------------------------------------
# phase 15: the engine across processes
# ---------------------------------------------------------------------------
def pool_families(record):
    """Phase 15's runs of the other models: {name: (config, the one-process
    engine's fixed TP 1 trajectories in ``record``, their phase, the run's
    serve_f32 inputs)}, each at its phase's depth, engine and requests."""
    from repro_torch.configs import get_config
    from repro_torch.testing.multicard import MOE_NEW_TOKENS, WINDOWED_ENGINE

    families = {}
    for name, rec_of, layers, phase in (("moonshot-v1-16b-a3b", "moe", family_layers("moonshot-v1-16b-a3b"), 8),
                                        ("jamba-v0.1-52b", "jamba", family_layers("jamba-v0.1-52b"), 9),
                                        ("dbrx-132b", "moe", family_layers("dbrx-132b"), 8)):
        fcfg = with_capacity(cut(get_config(name), layers), 8.0)
        reqs = make_requests(fcfg, new_tokens=MOE_NEW_TOKENS)
        families[name] = (fcfg, record[rec_of][f"{name} f32 cf 8.0 ({fcfg.num_layers} layers)"]["trajectories"], phase,
                          {"capacity_factor": 8.0, "prompts": [r.prompt for r in reqs],
                           "new_tokens": [r.max_new_tokens for r in reqs]})
    for name in DENSE_REMAINDER:  # at phase 7's depths, engine and requests
        dcfg = cut(get_config(name), family_layers(name))
        families[name] = (dcfg, record["dense_remainder"][f"{name} f32 ({dcfg.num_layers} layers)"]["trajectories"], 7,
                          {"prompts": [r.prompt for r in make_requests(dcfg)]})
    for name in WINDOWED[::-1]:  # at full depth, phase 6's engine and requests
        wcfg = get_config(name)
        families[name] = (wcfg, record["windowed"][name]["trajectories"], 6,
                          {"prompts": [r.prompt for r in windowed_requests(wcfg)], "engine": WINDOWED_ENGINE})
    return families


def pool_phase(torch, cfg, phase4, families, card, log):
    """Phase 4's f32 engine through the process-group path, one process per
    card (on one card, world 1): tokens equal to phase 4's; then moonshot
    (4 layers), dbrx (2) and jamba (8) in f32 at capacity factor 8.0,
    yi-34b, chameleon-34b (4 layers each), mistral-large-123b (2) and
    musicgen-large (48) with phase 7's engine and requests, and gemma2-2b
    and h2o-danube-1.8b at full depth with phase 6's, at fixed TP 1, tokens
    equal to phases 8, 9, 7 and 6's one-process engine's (``families``:
    {name: (config, that run's trajectories, its phase, the run's
    serve_f32 inputs)}). One spawn serves every run. Returns the ranks'
    launches ({path: {kernel: n}}, rank 0's) and the record."""
    from repro_torch.testing.multidev_checks import spawn

    world = torch.cuda.device_count()
    prompts = [r.prompt for r in make_requests(cfg)]
    runs = {"fixed TP 1": {"layers": cfg.num_layers, "prompts": prompts, "tps": (1,)}}
    if world > 1:
        runs["schedule"] = {"layers": cfg.num_layers, "prompts": prompts, "tps": (1, 2, 4, 8), "schedule": F32_SCHEDULE}
    want = {name: {int(k): v for k, v in phase4["trajectories"].items()} for name in runs}
    phase = {name: 4 for name in runs}
    for name, (fcfg, trajectories, phase_of, inputs) in families.items():
        runs[f"{name} fixed TP 1"] = {"model": name, "layers": fcfg.num_layers, "tps": (1,), **inputs}
        want[f"{name} fixed TP 1"] = {int(k): v for k, v in trajectories.items()}
        phase[f"{name} fixed TP 1"] = phase_of
    t0 = time.perf_counter()
    ranks = spawn(world, "cuda", task="repro_torch.testing.multicard:serve_runs", inputs={"runs": runs}, timeout=900)
    wall = time.perf_counter() - t0
    rec, paths = {"world": world, "backend": "nccl", "wall_s": wall}, {}
    for name in runs:
        res = [r["repro_torch.testing.multicard:serve_runs"][name] for r in ranks]
        model, run = res[0]["model"], name.removeprefix(res[0]["model"] + " ")
        what = f"phase 15 {model} f32 ({res[0]['layers']} layers) {run}"
        check(all(r["trajectories"] == want[name] for r in res),
              f"{what}: every rank's tokens equal the one-process engine's (phase {phase[name]})")
        check(all(r["backend"] == "nccl" and r["world"] == world for r in res), f"{what}: NCCL, world {world}")
        check(all(r["launches"] == r["replayed"] and r["launches"].get("tp_shard_matmul", 0) > 0
                  and r["launches"].get("paged_decode_attention", 0) > 0 for r in res),
              f"{what}: both kernels launched, every launch by a graph replay: {[r['launches'] for r in res]}")
        check(all(r["ptrs_unchanged"] for r in res), f"{what}: no storage data_ptr moved on any card")
        keep = ("model", "layers", "tps", "schedule", "switches", "steps", "warmup_s", "run_s", "launches", "graphs",
                "moe_dropped")
        rec[name] = {k: res[0][k] for k in keep}
        paths[f"{model} f32 across processes ({run}, world {world})"] = res[0]["launches"]
        log(f"[{card}] {what}: {world} process(es) on {world} card(s), NCCL, TP levels {res[0]['tps']}, "
            f"{res[0]['switches']} switches, {res[0]['steps']} steps; tokens of all {len(want[name])} requests equal "
            f"the one-process engine's on every rank; launches (rank 0, all by graph replays) {res[0]['launches']}; "
            f"MoE drops {res[0]['moe_dropped']}; warmup {res[0]['warmup_s']:.1f} s, run {res[0]['run_s']:.2f} s")
    log(f"[{card}] phase 15: {len(runs)} runs in one spawn of {world} process(es), {wall:.1f} s with the spawn")
    return paths, rec


# ---------------------------------------------------------------------------
# phase 16: training across processes
# ---------------------------------------------------------------------------
POOL_TRAIN_LAYERS = 2


def pool_train_phase(torch, card, log):
    """Phase 16: the pool of phase 15 (one process per card; world 1 on
    one card) trains h2o-danube-1.8b at full width and POOL_TRAIN_LAYERS
    layers in f32 with phase 12's step config through
    ``make_train_step(pool=)`` (``multicard.train_phase``): phase 12 (d)'s
    round trip through the pool's checkpoint (8 steps; a failure at step
    6, resumed from step 4: loaded back bit for bit, the losses within
    TRAIN_LOSS_RTOL), the kernel's launches counted in the ranks over its
    three runs (set to 0 just before, read just after), the uninterrupted
    run held to the one-process step on card 0 within check_train_step's
    tolerances. Then moonshot-v1-16b-a3b (2 layers) and jamba-v0.1-52b
    (its Mamba-1 + dense layer) at full width, three steps each through the
    same pool path (``multicard.phase16_families``), each held to the
    one-process step at its layout, the launches counted over each model's
    steps; and moonshot's one step under the reference's train rules
    (``multicard.rules_step``: weight and expert-weight FSDP, sequence
    parallelism), at world 1 its loss and parameters bit for bit those of
    the same step under DEFAULT_RULES, both under torch's deterministic
    algorithms (the MoE's backward adds with atomics otherwise). Then
    h2o-danube (POOL_TRAIN_LAYERS layers), moonshot and jamba as above in
    bf16 with f32 moments, each held to the one-process bf16 step; and
    llama3-8b's decoder layers in f32 through the pipeline schedule across
    the pool, a stage a card (``multicard.pipeline_llama``: on one card
    pipe 1, world 1), against the sequential stack, timed, its launches
    counted. Returns ({path: {"tp_shard_matmul": n}} of rank 0, the
    record)."""
    from repro_torch.testing.multidev_checks import spawn
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainStepConfig

    world = torch.cuda.device_count()
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=5), seq_chunk=256, block_q=128, block_k=128)
    log(f"[{card}] phase 16 on {world} card(s): the pipeline runs a stage a card, here pipe {world}, world {world}")
    t0 = time.perf_counter()
    ranks = spawn(world, "cuda", task="repro_torch.testing.multicard:train_phase", timeout=600,
                  inputs={"layers": POOL_TRAIN_LAYERS, "tcfg": tcfg, "ckpt_dir": str(ROOT / "build" / "pool_train_ckpt")})
    res = [r["repro_torch.testing.multicard:train_phase"] for r in ranks]
    rec = {**res[0], "world": world, "spawn_wall_s": time.perf_counter() - t0}
    what = f"phase 16 {rec['model']} f32 ({rec['layers']} layers) across {world} process(es), data {rec['mesh'][0]} x model {rec['mesh'][1]}"
    for r in res:
        check(not r["failures"], f"{what}: {r['failures']}")
        check(r["launches"]["forward"] > 0 and r["launches"]["backward"] > 0, f"{what}: tp_shard_matmul launched: "
              f"{r['launches']}")
    one, ck = rec["one_process"], rec["checkpoint"]
    log(f"[{card}] {what}: losses {[round(x, 4) for x in rec['losses']]} within {one['loss_rel']:.2e} (relative) "
        f"of the one-process step's, parameters within {one['param_abs']:.2e} (update distance "
        f"{one['update_rel']:.2e}); tp_shard_matmul launches (rank 0) {rec['launches']}; the three runs "
        f"{rec['wall_s']:.1f} s, {rec['spawn_wall_s']:.1f} s with the spawn")
    log(f"[{card}] {what}: checkpoint every {ck['every']} steps, failure at step {ck['fail_at']}, resumed from "
        f"step {ck['resumed_from']} (loaded back bit for bit: {ck['loaded_bit_for_bit']}); resumed losses within "
        f"{ck['max_rel_diff']:.2e} of the uninterrupted run's; saves {[round(x['s'], 2) for x in ck['saves']]} s, "
        f"load {[round(x, 2) for x in ck['load_s']]} s")
    path = f"h2o-danube-1.8b f32 train across processes ({rec['layers']} layers, world {world})"
    paths = {path: {"tp_shard_matmul": rec["launches"]["forward"]},
             f"{path} backward": {"tp_shard_matmul": rec["launches"]["backward"]}}
    for name, fam in rec["families"].items():
        what = f"phase 16 {name} f32 ({fam['layers']} layers: {', '.join(fam['pattern'])}) across {world} process(es)"
        for r in res:
            check(r["families"][name]["launches"]["forward"] > 0 and r["families"][name]["launches"]["backward"] > 0,
                  f"{what}: tp_shard_matmul launched: {r['families'][name]['launches']}")
        tp, dp = fam["mesh"]["model"], fam["mesh"]["data"]
        one = fam[f"one_card_tp{tp}_dp{dp}"]["distance"]
        log(f"[{card}] {what}: losses {[round(x, 4) for x in fam['losses']]} within {one['loss_rel']:.2e} (relative) "
            f"of the one-process step's (TP {tp}, dp {dp}), parameters within {one['param_abs']:.2e} "
            f"(update distance {one['update_rel']:.2e}); tp_shard_matmul launches (rank 0) {fam['launches']}; "
            f"steps {sum(fam['step_s']):.1f} s")
        path = f"{name} f32 train across processes ({fam['layers']} layers, world {world})"
        paths[path] = {"tp_shard_matmul": fam["launches"]["forward"]}
        paths[f"{path} backward"] = {"tp_shard_matmul": fam["launches"]["backward"]}
    rules = rec["rules"]
    what = (f"phase 16 {rules['model']} f32 ({rules['layers']} layers) one step under the train rules across {world} "
            f"process(es)")
    for r in res:
        check(r["rules"]["rules_launches"]["forward"] > 0 and r["rules"]["rules_launches"]["backward"] > 0,
              f"{what}: tp_shard_matmul launched: {r['rules']['rules_launches']}")
        if world == 1:
            check(r["rules"]["bitwise"], f"{what}: loss and parameters bit for bit those of DEFAULT_RULES' step")
    log(f"[{card}] {what}: loss {rules['losses']['rules']!r} (DEFAULT_RULES {rules['losses']['default']!r}), "
        f"bit for bit: {rules.get('bitwise')}; {len(rules['data_sharded'])} leaves sharded over data; step "
        f"{rules['rules_step_s']:.2f} s ({rules['default_step_s']:.2f} under DEFAULT_RULES); tp_shard_matmul "
        f"launches (rank 0) {rules['rules_launches']}")
    path = f"{rules['model']} f32 train step under the train rules ({rules['layers']} layers, world {world})"
    paths[path] = {"tp_shard_matmul": rules["rules_launches"]["forward"]}
    paths[f"{path} backward"] = {"tp_shard_matmul": rules["rules_launches"]["backward"]}
    for name, fam in rec["families_bf16"].items():
        what = f"phase 16 {name} bf16 ({fam['layers']} layers: {', '.join(fam['pattern'])}) across {world} process(es)"
        for r in res:
            check(r["families_bf16"][name]["launches"]["forward"] > 0
                  and r["families_bf16"][name]["launches"]["backward"] > 0,
                  f"{what}: tp_shard_matmul launched: {r['families_bf16'][name]['launches']}")
        tp, dp = fam["mesh"]["model"], fam["mesh"]["data"]
        one = fam[f"one_card_tp{tp}_dp{dp}"]["distance"]
        log(f"[{card}] {what}: losses {[round(x, 4) for x in fam['losses']]} within {one['loss_rel']:.2e} (relative) "
            f"of the one-process bf16 step's (TP {tp}, dp {dp}), parameters within {one['param_abs']:.2e} "
            f"(update distance {one['update_rel']:.2e}; bit for bit: {one['bitwise']}); peak "
            f"{fam['peak_gb']:.2f} GB; tp_shard_matmul launches (rank 0) "
            f"{fam['launches']}; steps {sum(fam['step_s']):.1f} s")
        path = f"{name} bf16 train across processes ({fam['layers']} layers, world {world})"
        paths[path] = {"tp_shard_matmul": fam["launches"]["forward"]}
        paths[f"{path} backward"] = {"tp_shard_matmul": fam["launches"]["backward"]}
    pipe = rec["pipeline"]
    what = (f"phase 16 {pipe['model']} f32 pipeline, {pipe['stages']} stage(s) of {pipe['layers_per_card']} layers, "
            f"a stage a card")
    for r in res:
        check(r["pipeline"]["launches"]["forward"] > 0 and r["pipeline"]["launches"]["backward"] > 0,
              f"{what}: tp_shard_matmul launched: {r['pipeline']['launches']}")
    log(f"[{card}] {what}: against the sequential stack {json.dumps(pipe['held'])}; {pipe['micro'][0]} microbatches "
        f"of {pipe['micro'][1:]}, step {pipe['step_ms']:.1f} ms (first {pipe['first_step_ms']:.1f}), the stage alone "
        f"{pipe['stage_alone_ms']:.1f} ms, bubble share {pipe['bubble_share']:.3f} (schedule "
        f"{pipe['bubble_share_expected']:.3f}); peak {pipe['peak_gb']:.2f} GB; tp_shard_matmul launches (rank 0, "
        f"{pipe['steps']} steps) {pipe['launches']}")
    path = f"{pipe['model']} f32 pipeline ({pipe['layers']} layers, {pipe['stages']} stage(s), world {world})"
    paths[path] = {"tp_shard_matmul": pipe["launches"]["forward"]}
    paths[f"{path} backward"] = {"tp_shard_matmul": pipe["launches"]["backward"]}
    return paths, rec


def kernel_counts():
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    return {"tp_shard_matmul": tp_shard_matmul.launches, "paged_decode_attention": paged_decode_attention.launches}


def zero_counts():
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    tp_shard_matmul.launches = paged_decode_attention.launches = tp_shard_matmul.backward_launches = 0


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def serve_launcher_phase(torch, cfg, log):
    """Phase 13 (a): launch.serve's main with the demo defaults, then
    llama3-8b in bf16 at full width and depth (TP 1/2/4/8, 24 requests, a
    switch every 8 steps); then in f32 at ``cfg``'s depth (phase 4's) the
    same requests under that schedule and at fixed TP 1 through
    ``serve.serve``: identical tokens. Counts set to 0 just before each run
    and read just after."""
    from repro_torch.launch import serve

    paths, rec = {}, {}
    for name, argv in (("demo", []), ("llama3-8b bf16", ["--arch", "llama3-8b", "--dtype", "bfloat16", "--tps",
                                                          "1,2,4,8", "--requests", "24", "--switch-every", "8"])):
        zero_counts()
        t0 = time.perf_counter()
        check(serve.main(argv) == 0, f"launch.serve {name}")
        torch.cuda.synchronize()
        paths[f"launch.serve {name}"] = kernel_counts()
        rec[name] = {"argv": argv, "wall_s": time.perf_counter() - t0, "launches": paths[f"launch.serve {name}"]}
        check(all(n > 0 for n in paths[f"launch.serve {name}"].values()), f"launch.serve {name} launched both kernels")
        free_card(torch)
    base = ["--arch", "llama3-8b", "--dtype", "float32", "--layers", str(cfg.num_layers), "--requests", "24"]
    args_sw = serve.parse_args(base + ["--tps", "1,2,4,8", "--switch-every", "8"])
    args_fx = serve.parse_args(base + ["--tps", "1", "--switch-every", "0"])
    t0 = time.perf_counter()
    mcfg, params = serve.build(args_sw)
    zero_counts()
    done_sw, st_sw = serve.serve(mcfg, params, args_sw)
    done_fx, st_fx = serve.serve(mcfg, params, args_fx)
    torch.cuda.synchronize()
    paths[f"launch.serve llama3-8b f32 ({cfg.num_layers} layers, switched and fixed)"] = kernel_counts()
    sw = {r.req_id: list(r.generated) for r in done_sw}
    fx = {r.req_id: list(r.generated) for r in done_fx}
    changed = sorted(i for i in fx if sw.get(i) != fx[i])
    check(len(sw) == len(fx) == 24 and not changed,
          f"launch.serve llama3-8b f32: tokens under the switch schedule equal fixed TP 1's (changed: {changed})")
    check(st_sw["switches"] > 0 and st_fx["switches"] == 0, "the switch run switched, the fixed run did not")
    rec["llama3-8b f32"] = {"layers": cfg.num_layers, "switches": st_sw["switches"], "steps": [st_sw["steps"],
                            st_fx["steps"]], "tokens_equal": True, "wall_s": time.perf_counter() - t0}
    log(f"phase 13 (a) launch.serve llama3-8b f32 ({cfg.num_layers} layers): 24 requests, {st_sw['switches']} switches "
        f"over TP {st_sw['tps']}: every token equal to fixed TP 1's; {rec['llama3-8b f32']['wall_s']:.1f} s")
    del params, done_sw, done_fx
    free_card(torch)
    return paths, rec


def train_launcher_phase(torch, log):
    """Phase 13 (b): launch.train's main on h2o-danube-1.8b at full width in
    f32, cut to LAUNCH_TRAIN_LAYERS layers: N steps with a checkpoint, the
    same argv with 2N steps (must resume from N), and an uncut 2N-step run;
    the losses within 2e-4 relative (on the card the backward adds with
    atomics: phase 12 (d)'s tolerance)."""
    import shutil

    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul
    from repro_torch.launch import train

    n = LAUNCH_TRAIN_STEPS
    cut_dir, whole_dir = ROOT / "build" / "train_launch_ckpt", ROOT / "build" / "train_launch_whole"
    argv = ["--arch", "h2o-danube-1.8b", "--layers", str(LAUNCH_TRAIN_LAYERS), "--batch", "8", "--seq", "256",
            "--ckpt-every", str(n)]
    t0 = time.perf_counter()
    zero_counts()
    first = train.main(argv + ["--steps", str(n), "--ckpt-dir", str(cut_dir), "--fresh"]).losses
    resumed = train.main(argv + ["--steps", str(2 * n), "--ckpt-dir", str(cut_dir)])
    torch.cuda.synchronize()
    got = {"launch.train h2o-danube-1.8b f32": tp_shard_matmul.launches,
           "launch.train h2o-danube-1.8b f32 backward": tp_shard_matmul.backward_launches}
    check(resumed.resumed_from == n and resumed.step == 2 * n, f"the second run resumed from step {n}")
    resumed_losses = list(resumed.losses)
    del resumed
    free_card(torch)
    whole = train.main(argv + ["--steps", str(2 * n), "--ckpt-dir", str(whole_dir), "--fresh"]).losses
    diffs = [abs(a - b) / abs(b) for a, b in zip(first + resumed_losses, whole)]
    check(len(diffs) == 2 * n and max(diffs) <= 2e-4 and all(math.isfinite(x) for x in whole),
          f"resumed losses within 2e-4 of the uncut run's: {first + resumed_losses} against {whole}")
    for d in (cut_dir, whole_dir):
        shutil.rmtree(d, ignore_errors=True)
    rec = {"layers": LAUNCH_TRAIN_LAYERS, "steps": [n, 2 * n], "resumed_from": n, "losses": whole,
           "max_rel_diff": max(diffs), "launches": got, "wall_s": time.perf_counter() - t0}
    log(f"phase 13 (b) launch.train h2o-danube-1.8b f32 ({LAUNCH_TRAIN_LAYERS} layers, batch 8 x 256): {n} steps, "
        f"then {2 * n} resumed from step {n}; losses within {max(diffs):.2e} of an uncut run's {whole}; "
        f"launches {got}; {rec['wall_s']:.1f} s")
    free_card(torch)
    return {k: {"tp_shard_matmul": v} for k, v in got.items()}, rec


def examples_phase(torch, card, log):
    """Phase 13 (c): the four examples' mains on the card (plan_trace is
    host code). Counts set to 0 just before each and read just after."""
    from repro_torch.examples import plan_trace, quickstart, serve_adaptive_tp, train_tiny

    paths, rec = {}, {}
    for name, fn in (("quickstart", lambda: quickstart.main([])),
                     ("serve_adaptive_tp", lambda: serve_adaptive_tp.main([])),
                     ("train_tiny", lambda: train_tiny.main(["--steps", "100", "--ckpt-dir",
                                                             str(ROOT / "build" / "train_tiny_ckpt")]))):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        paths[f"examples.{name}"] = kernel_counts()
        rec[name] = {"wall_s": time.perf_counter() - t0, "launches": paths[f"examples.{name}"]}
        check(paths[f"examples.{name}"]["tp_shard_matmul"] > 0, f"examples.{name} launched the matmul")
        if name == "serve_adaptive_tp":
            rec[name].update(out)
            log(f"{card}: examples.serve_adaptive_tp p50 TTFT / TPOT per tier on the host clock: "
                f"{json.dumps(out['latency'])}")
        if name == "train_tiny":
            rec[name]["losses_first_last"] = [out.losses[0], out.losses[-1]]
        free_card(torch)
    import shutil

    shutil.rmtree(ROOT / "build" / "train_tiny_ckpt", ignore_errors=True)
    before = kernel_counts()
    t0 = time.perf_counter()
    plan_trace.main(["--horizon", "30"])
    rec["plan_trace"] = {"wall_s": time.perf_counter() - t0}
    check(kernel_counts() == before, "plan_trace (host code) launched nothing")
    return paths, rec


def gate_phase(futures, card, log):
    """Phase 13 (d): the gates' results from the host workers. v5e must
    pass (the reference's CI gate); h100's verdict and violations are a
    reading of the system priced at this card's table, printed."""
    rec = {}
    for hw, fut in futures["gate"].items():
        rc, text, secs = fut.get()
        rec[hw] = {"rc": rc, "seconds": secs, "lines": text.splitlines()}
        prefix = card + ": " if hw == "h100" else "V5E spec (parity, not a measurement): "
        for line in text.splitlines():
            log(f"  {prefix}{line}")
        log(f"phase 13 (d) length_regime_gate --hw {hw}: {'passed' if rc == 0 else 'FAILED'} in {secs:.1f} s")
    check(rec["v5e"]["rc"] == 0, "the length-regime gate passes at V5E, as the reference's CI requires")
    return rec


def dryrun_phase(torch, cfg, futures, t_submit, engine_bf16, card, log):
    """Phase 14: the dry run's grid on the single-pod mesh (host workers):
    each cell's counts and H100 roofline terms, and the sweep's wall time;
    then llama3-8b's bf16 prefill of 128 tokens and 8-slot decode step at
    TP 1 counted with op_cost at phase 5's shapes, over phase 5's profiled
    device ms: the step's model-FLOPs share of 989 TFLOP/s."""
    from repro_torch.launch import op_cost
    from repro_torch.models import model_param_defs
    from repro_torch.models.params import tree_map
    from repro_torch.parallel.sharding import make_exec_config
    from repro_torch.serving.engine import ServingEngine

    rec = {"cells": {}, "skipped": [f"{a} x {sh}" for a, sh in futures["skipped"]]}
    failed = []
    for (arch, shape), fut in futures["cells"].items():
        info, lines = fut.get()
        for line in lines:
            log("  " + line)
        if info is None:
            failed.append(f"{arch} x {shape}")
            continue
        r = info["roofline"]
        rec["cells"][f"{arch} x {shape}"] = {
            "flops_per_device": r["flops_per_device"], "hbm_bytes_per_device": r["hbm_bytes_per_device"],
            "collective_bytes_per_device": r["collective_bytes_per_device"], "compute_s": r["compute_s"],
            "memory_s": r["memory_s"], "collective_s": r["collective_s"], "dominant": r["dominant"],
            "count_by_kind": info["collectives"]["count_by_kind"], "count_s": info["count_s"],
            "ops": info["ops_counted"]}
    rec["sweep_wall_s"] = time.perf_counter() - t_submit
    log(f"phase 14 dry run: {len(rec['cells'])} cells counted on meta (16x16 mesh, TP 16 groups), "
        f"{len(rec['skipped'])} skipped ({', '.join(rec['skipped'])}), {len(failed)} failed; sweep "
        f"{rec['sweep_wall_s']:.1f} s wall on {HOST_WORKERS} host workers from submission (before phase 6) to "
        f"here; the cells' own count seconds sum to {sum(c['count_s'] for c in rec['cells'].values()):.1f}; collective_s "
        f"uses NVLink's published figures, not measured ones")
    check(not failed and len(rec["cells"]) == len(futures["cells"]), f"every applicable cell counted: failed {failed}")

    meta = torch.device("meta")
    params = tree_map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device=meta),
                      model_param_defs(cfg, make_exec_config(cfg, 1)))
    eng = ServingEngine(cfg, params, engine_conf(torch, cfg, torch.bfloat16), device=meta)
    bound = eng.ctl.bindings[1]

    def idx(*shape):
        return torch.empty(shape, dtype=torch.int64, device=meta)

    with torch.no_grad():
        _, pre = op_cost.count(eng._prefill, bound, idx(1, 128), idx(1), idx(1))
        _, dec = op_cost.count(eng._decode, bound, idx(8, 1), idx(8))
    rec["engine_counts"] = {"prefill_128": {"flops": pre.dot_flops, "hbm_bytes": pre.hbm_bytes},
                            "decode_8": {"flops": dec.dot_flops, "hbm_bytes": dec.hbm_bytes}}
    shares = {}
    if engine_bf16 is None:
        log("phase 14 model-FLOPs share: not measured (phase 5 was skipped)")
    else:
        ms = {"prefill_128": engine_bf16["prefill_profile"]["128"].get("device_ms"),
              "decode_8": engine_bf16["profile"]["1"].get("device_ms_per_step")}
        for key, cost in (("prefill_128", pre), ("decode_8", dec)):
            if not isinstance(ms[key], float):
                shares[key] = f"not measured ({ms[key]})"
                continue
            share = op_cost.model_flops_share(cost.dot_flops, ms[key] / 1e3)
            check(0 < share <= 1, f"{key}: model-FLOPs share {share} in (0, 1]")
            shares[key] = {"flops": cost.dot_flops, "device_ms": ms[key], "share_of_989_tflops": share}
        log(f"{card}: phase 14 model-FLOPs share of llama3-8b bf16 at TP 1 ({cfg.num_layers} layers; counted "
            f"operations over phase 5's profiled device ms, against 989 TFLOP/s): {json.dumps(shares)}")
    rec["model_flops_share"] = shares
    del eng, params, bound
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None, help="cut llama3-8b's depth (default: all 32)")
    ap.add_argument("--skip-timed", action="store_true", help="leave out the bf16 timings of phases 5-9")
    ap.add_argument("--timings-of", metavar="SRC", default=None,
                    help="only take the host cost of tp_shard_matmul calls, the f32 matmul timings (decode, "
                         "prefill, TP 8 shards, the windowed models' 4096- and 4160-token buckets, the tied head), "
                         "the attention timings, phase 5's and phase 6's bf16 engine timings and profiles, and the "
                         "f32 decode step's and one f32 prefill's profile of all three models, importing repro_torch "
                         "from SRC (e.g. the src/ of an unpacked earlier commit, to compare two commits in one "
                         "call); print them as one JSON line")
    ap.add_argument("--serving-only", action="store_true",
                    help="with --timings-of: only phase 5's bf16 engine timings of llama3-8b (TTFT, decode step "
                         "per TP level, tokens/s)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 oracle and library calls run in full f32
    torch.backends.cudnn.allow_tf32 = False
    if args.timings_of is not None:
        sys.path.insert(0, str(Path(args.timings_of).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul

    if args.timings_of is not None:
        from repro_torch.kernels.paged_attention.ops import paged_decode_attention

        dev, cfg = torch.device("cuda", 0), get_config("llama3-8b")
        print(card_line())
        if args.serving_only:
            _build.build_all()
            r = engine_bf16_timed(torch, dev, cfg, print)
            print(json.dumps({"src": args.timings_of, "card": card_line(), "engine_bf16": {
                k: r[k] for k in ("ttft_ms", "decode_step_ms", "tokens_per_s")}}))
            return 0
        us = host_us_per_call(torch, dev, cfg, print, tp_shard_matmul)
        flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
        f32 = {"matmul": measure_matmul(torch, dev, cfg, flush, print, f32_only=True),
               "tied_head": measure_tied_head(torch, dev, flush, print, dtypes=(torch.float32,))}
        paged = {"breakdown_ms": paged_breakdown(torch, dev, cfg, flush, print, paged_decode_attention),
                 "long_context": measure_paged_long(torch, dev, cfg, flush, print, paged_decode_attention,
                                                    check_plain=False)}
        del flush
        timed = {"engine_bf16": engine_bf16_timed(torch, dev, cfg, print)}
        for name in WINDOWED[::-1]:
            timed[name] = engine_windowed_bf16_timed(torch, dev, get_config(name), print)
        f32["step_profile"] = {name: engine_f32_profiled(torch, dev, get_config(name), print)
                               for name in ("llama3-8b", "gemma2-2b", "h2o-danube-1.8b")}
        print(json.dumps({"src": args.timings_of, "card": card_line(), "host_us_per_call": us, "f32": f32,
                          "paged_decode_attention": paged, **timed}))
        return 0

    dev = torch.device("cuda", 0)
    record = {}

    def log(msg):
        print(msg, flush=True)

    # ---- phase 1: card and build ----
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build_all(ptxas_verbose=True)
    log(f"build: {len(built)} kernel sources ({', '.join(built)}) in {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in built.items()))
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    record["build_s"] = {k: v["seconds"] for k, v in built.items()}

    cfg = get_config("llama3-8b")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    log(f"model: {cfg.name} at full width, {cfg.num_layers} of 32 layers")

    # ---- phase 2: kernels against plain versions ----
    t0 = time.perf_counter()
    check_matmul_sweeps(torch, dev, log)
    record["tp_shard_matmul_main_shapes"] = check_matmul_main_shapes(torch, dev, cfg, log)
    check_paged_sweeps(torch, dev, log)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    record["tp_shard_matmul_launches_per_call"] = check_one_launch(torch, dev, log)
    log("tp_shard_matmul at the main path's shapes (decode TP 1, prefill buckets, decode TP 8 shards):")
    mm_rows = measure_matmul(torch, dev, cfg, flush, log)
    record["tp_shard_matmul_host_us"] = host_us_per_call(torch, dev, cfg, log, tp_shard_matmul)
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention

    record["paged_decode_attention_launches_per_call"] = check_paged_one_launch(torch, dev, cfg, log)
    log("paged_decode_attention at the main path's shape, at a long context, and by sequence length:")
    pa_rows = measure_paged(torch, dev, cfg, flush, log)
    record["paged_decode_attention_long_context"] = measure_paged_long(torch, dev, cfg, flush, log, paged_decode_attention)
    record["paged_decode_attention_breakdown_ms"] = paged_breakdown(torch, dev, cfg, flush, log, paged_decode_attention)
    record["tp_shard_matmul"], record["paged_decode_attention"] = mm_rows, pa_rows
    record["windowed_paged_errors"] = check_paged_windowed(torch, dev, log)
    record["col_t"] = check_col_t(torch, dev, log)
    record["windowed_launches_per_call"] = check_windowed_one_launch(torch, dev, log)
    log("new instances at the windowed models' shapes (attention at the engine shape and full window, tied head):")
    record["windowed_attention"], record["tied_head"] = measure_windowed(torch, dev, flush, log)
    log("new instances of phases 7 and 8 (attention at each model's engine geometry; matmul at their widths):")
    record["new_attention"], record["new_attention_errors"] = measure_new_attention(torch, dev, flush, log)
    record["new_matmul"] = measure_matmul_cases(torch, dev, new_matmul_cases(torch), flush, log, None, seed=19)
    record["new_launches_per_call"] = check_new_one_launch(torch, dev, log)
    log("new instances of phase 9 (the Mamba projections: narrow N, K = 256, misaligned shard offsets):")
    record["mamba_matmul"] = measure_matmul_cases(torch, dev, mamba_matmul_cases(torch), flush, log, None, seed=23)
    record["mamba_launches_per_call"] = check_mamba_one_launch(torch, dev, log)
    check_kv_sweeps(torch, dev, cfg, log)
    record["profiler_sessions"] = dict(PROFILER_SESSIONS)
    log(f"phase 2: {time.perf_counter() - t0:.1f} s; one-launch checks: {PROFILER_SESSIONS['empty']} of "
        f"{PROFILER_SESSIONS['sessions']} profiler sessions came back empty and were retried")

    # ---- phase 3: paged KV migration (kv counts reset just before each migrate_pages, read just after) ----
    kv_launches, record["migration"] = migration_phase(torch, dev, cfg, flush, log)
    del flush

    # ---- phase 4: the engine in f32 (counts reset just before, read just after) ----
    launches, record["engine_f32"] = engine_f32(torch, dev, cfg, log)
    launches.update(kv_launches)
    engine_tiny_vs_cpu(torch, dev, log)

    # ---- phase 5: the engine in bf16, timed ----
    if not args.skip_timed:  # the kernels line times bf16, so it takes the bf16 run's counts
        record["engine_bf16"] = engine_bf16_timed(torch, dev, cfg, log)
        launches.update(record["engine_bf16"]["launches"])
    by_path = {name: {f"{cfg.name} {'f32' if args.skip_timed else 'bf16'}": launches[name]}
               for name in ("tp_shard_matmul", "paged_decode_attention")}

    def add_paths(paths):
        for path, got in paths.items():
            for k, n in got.items():
                launches[k] += n
                by_path[k][path] = n

    # the gates (phase 13) and the dry run's grid (phase 14) are host code: they run from here on in
    # HOST_WORKERS spawned processes at the lowest priority, beside phases 6-13
    with host_pool(HOST_WORKERS) as pool:
        attention = {case: pool.apply_async(train_attention_cpu, case) for case in TRAIN_ATTENTION_CASES}  # first
        futures, t_submit = start_host_work(pool)
        # ---- phase 6: the windowed models (counts reset just before each f32 model's runs, read just after) ----
        record["windowed"] = {}
        for name in WINDOWED[::-1]:  # gemma2-2b first
            t0 = time.perf_counter()
            wcfg = get_config(name)
            got, rec = engine_windowed_f32(torch, dev, wcfg, log)
            add_paths({f"{name} f32": got})
            if not args.skip_timed:
                rec["bf16"] = engine_windowed_bf16_timed(torch, dev, wcfg, log)
            rec["wall_s"] = time.perf_counter() - t0
            record["windowed"][name] = rec
            log(f"phase 6 {name}: {rec['wall_s']:.1f} s")

        # ---- phase 7: the dense family's remainder (counts reset just before each path's runs, read just after) ----
        t0 = time.perf_counter()
        paths, record["dense_remainder"] = dense_remainder_phase(torch, dev, log, args.skip_timed)
        add_paths(paths)
        log(f"phase 7: {time.perf_counter() - t0:.1f} s")

        # ---- phase 8: MoE (counts reset just before each path's runs, read just after) ----
        t0 = time.perf_counter()
        paths, record["moe"] = moe_phase(torch, dev, log, args.skip_timed)
        add_paths(paths)
        log(f"phase 8: {time.perf_counter() - t0:.1f} s")

        # ---- phase 9: the Mamba family (counts reset just before each path's runs, read just after) ----
        t0 = time.perf_counter()
        got, record["mamba2"] = mamba2_phase(torch, dev, log, args.skip_timed)
        add_paths({"mamba2-2.7b f32 (64 layers, forward)": got})
        paths, record["jamba"] = jamba_phase(torch, dev, log, args.skip_timed)
        add_paths(paths)
        log(f"phase 9: {time.perf_counter() - t0:.1f} s")

        # main-path entries: the bf16 decode shapes that take the most time per step
        main_mm = next(r for r in mm_rows if (r["name"], r["dtype"], r["m"], r["tp"]) == ("w_gate/w_in col", "bfloat16", 8, 1))

        # ---- phase 10: the H100's profile, then the plan (counts reset just before the profile, read just after) ----
        got, record["profile_plan"], table, tiers = profile_plan_phase(torch, dev, cfg, log, main_mm, record["migration"])
        add_paths({f"{cfg.name} bf16 profile ({cfg.num_layers} layers)": got})
        log(f"phase 10: {record['profile_plan']['wall_s']:.1f} s")

        # ---- phase 11: the simulator on the card's numbers (host code: every launch count must stay as it is) ----
        record["simulator"] = simulator_phase(cfg, table, tiers, record["profile_plan"]["served"], card, log)

        # ---- phase 12: training (counts reset just before (c)'s steps, read just after) ----
        got, record["training"] = training_phase(torch, dev, log, attention=attention)
        add_paths({name: {"tp_shard_matmul": n} for name, n in got.items()})
        log(f"phase 12: {record['training']['wall_s']:.1f} s")

        # ---- phase 13: the launchers and examples on the card (counts reset just before each run, read after) ----
        t0 = time.perf_counter()
        record["launchers"] = {}
        paths, record["launchers"]["serve"] = serve_launcher_phase(torch, cfg, log)
        add_paths(paths)
        paths, record["launchers"]["train"] = train_launcher_phase(torch, log)
        add_paths(paths)
        paths, record["launchers"]["examples"] = examples_phase(torch, card, log)
        add_paths(paths)
        record["launchers"]["gate"] = gate_phase(futures, card, log)
        record["launchers"]["wall_s"] = time.perf_counter() - t0
        log(f"phase 13: {record['launchers']['wall_s']:.1f} s")

        # ---- phase 14: the dry run (host code on meta: no launch count may move) ----
        t0 = time.perf_counter()
        before = kernel_counts()
        record["dryrun"] = dryrun_phase(torch, cfg, futures, t_submit, record.get("engine_bf16"), card, log)
        check(kernel_counts() == before, "the dry run launched nothing")
        log(f"phase 14: {time.perf_counter() - t0:.1f} s after phase 13")

    # ---- phase 15: the engine across processes, one per card (counts in the ranks, after their warm-up) ----
    t0 = time.perf_counter()
    families = pool_families(record)
    got, record["pool"] = pool_phase(torch, cfg, record["engine_f32"], families, card, log)
    add_paths(got)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")

    # ---- phase 16: training across processes (counts in the ranks, set to 0 just before the steps) ----
    t0 = time.perf_counter()
    got, record["pool_train"] = pool_train_phase(torch, card, log)
    add_paths(got)
    log(f"phase 16: {time.perf_counter() - t0:.1f} s")
    main_pa = next(r for r in pa_rows if r["shape"].startswith("bfloat16"))
    # the kv kernels at the larger payload (4.295 GB at full depth), K rows
    main_kv = {r["name"]: r for r in record["migration"]["2048"]["kernels"]}
    # the new instances: the tied head, the f32 prefill kernel at llama3-8b's bucket 128 and the windowed
    # models' 4096-token bucket, and the shapes of phases 7 and 8
    f32_prefill = [r for r in mm_rows if r["dtype"] == "float32" and r["tp"] == 1 and r["m"] in (128, 4096)]
    instances = {"tp_shard_matmul": record["tied_head"] + f32_prefill + record["new_matmul"] + record["mamba_matmul"],
                 "paged_decode_attention": record["windowed_attention"] + record["new_attention"]}
    kernels = []
    for name, route_src, row in (("tp_shard_matmul", "src/repro_torch/csrc/tp_shard_matmul.cu", main_mm),
                                 ("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu", main_pa),
                                 ("kv_gather", "src/repro_torch/csrc/kv_gather.cu", main_kv["kv_gather"]),
                                 ("kv_scatter", "src/repro_torch/csrc/kv_gather.cu", main_kv["kv_scatter"])):
        kernels.append({"name": name, "route": "cuda", "source": route_src, "replaces": TPU_SOURCES[name],
                        "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "tol": row["tol"], "shape": row["shape"]})
        if name in by_path:
            kernels[-1]["launches_by_path"] = by_path[name]
        if instances.get(name):
            kernels[-1]["instances"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                            "max_abs_err")} for r in instances[name]]
    record.update(card=card, layers=cfg.num_layers, kernels=kernels, wall_s=time.perf_counter() - t_start)
    log(f"chip_smoke: {record['wall_s']:.1f} s from the build to here")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
