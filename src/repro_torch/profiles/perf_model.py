"""Analytic performance model, the planner's "offline profiles" (mirrors
repro/profiles/perf_model.py).

The paper assumes admins profile each accelerator offline (its Fig. 2). The
reference models a TPU v5e from first principles (``V5E``); on an H100 the
same roofline takes the card's data-sheet peaks and the efficiencies the
port measured on it (``H100``), and ``profiles/profiler.py`` measures the
tables that replace it where a measurement exists. The planner only
consumes the interface below. Every query's arithmetic is the reference's,
line for line, so that at ``V5E`` both packages return the same floats.

The reference's VMEM-residency term (weights that fit stay resident and
stop paying HBM reads per token) stands in for the paper's GPU L2 effect;
at ``H100`` it reads the card's L2 size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# Query memoization (docs/simulator.md §Cache-key quantization)
#
# The planner re-runs the same SLO-throughput queries verbatim inside its
# itertools.product inner loop every control window, and the simulator's hot
# path asks for decode step times whose only drifting input is the batch's
# mean context length. All four expensive queries are memoized behind LRU
# caches; float length inputs are snapped to a geometric grid with relative
# spacing LEN_QUANT_REL so that slowly-drifting inputs (window-mean prompt
# lengths, growing decode contexts) hit the same cache line. The induced
# input error is <= LEN_QUANT_REL/2 per length; every model output below is
# at most ~linear in each length input, so the output error is bounded by
# ~LEN_QUANT_REL. The grid is 5x coarser than it used to be (0.002): decode
# caps now carry an explicit TPOT_DESIGN_MARGIN of slack instead of sitting
# exactly on the TPOT boundary, so a ~1% query error can no longer flip a
# cap across the SLO — it is absorbed by the margin (docs/simulator.md
# §Cache-key), and the coarser grid is a direct warm-cache-rate speedup.
# ---------------------------------------------------------------------------
LEN_QUANT_REL = 0.01
_LN_Q = math.log1p(LEN_QUANT_REL)

# Decode caps and the planner's decode-rate estimates budget this fraction
# of the tier's TPOT SLO: realized mean TPOT then lands safely inside the
# SLO instead of exactly on the boundary, where context drift, cache-grid
# quantization, and prefill preemption pauses each flip ~50% of requests
# into violation (SLOs-Serve/Ascendra: deadline slack as the control
# surface). Callers multiply the SLO by this before querying
# max_decode_batch / max_decode_rps.
TPOT_DESIGN_MARGIN = 0.85


def mid_decode_ctx(prompt_len: float, output_len: float) -> float:
    """Mean decode-step context of a (prompt, output) demand point.

    A request's decode steps run at ctx = prompt + k for k in [0, output),
    so the average step — the operating point realized TPOT is determined
    by — sees prompt + output/2. Caps and plans designed here (with
    TPOT_DESIGN_MARGIN slack) agree with realized per-group context instead
    of a fixed reference length."""
    return float(prompt_len) + 0.5 * float(output_len)


@lru_cache(maxsize=1 << 14)
def quantize_len(x: float) -> float:
    """Snap a (prompt/context/output) length to a LEN_QUANT_REL-relative grid.

    Memoized: the hot callers re-quantize the same slowly-drifting floats
    (window-mean lengths) many times per simulated second."""
    if x <= 16.0:
        return float(max(round(x), 0))
    return math.exp(round(math.log(x) / _LN_Q) * _LN_Q)


@lru_cache(maxsize=1 << 17)
def _prefill_time_cached(pm: "PerfModel", prompt_len: float, tp: int, batch: int) -> float:
    return pm._prefill_time_raw(prompt_len, tp, batch)


@lru_cache(maxsize=1 << 14)
def _decode_affine_cached(pm: "PerfModel", batch: int, tp: int):
    return pm._decode_affine_raw(batch, tp)


@lru_cache(maxsize=1 << 16)
def _max_prefill_rps_cached(
    pm: "PerfModel", prompt_len: float, tp: int, ttft_slo_ms: float
) -> float:
    return pm._max_prefill_rps_raw(prompt_len, tp, ttft_slo_ms)


@lru_cache(maxsize=1 << 16)
def _max_decode_batch_cached(
    pm: "PerfModel", ctx_len: float, tp: int, tpot_slo_ms: float,
    hbm_free_bytes: Optional[float],
) -> int:
    return pm._max_decode_batch_raw(ctx_len, tp, tpot_slo_ms, hbm_free_bytes)


_CACHING_ENABLED = True


class perf_caches_disabled:
    """Context manager: bypass memoization AND input quantization so every
    query runs the raw roofline math on exact inputs. For experiments that
    need quantization-free numbers from the live model."""

    def __enter__(self):
        global _CACHING_ENABLED
        self._prev = _CACHING_ENABLED
        _CACHING_ENABLED = False
        return self

    def __exit__(self, *exc):
        global _CACHING_ENABLED
        _CACHING_ENABLED = self._prev
        return False


def clear_perf_caches() -> None:
    """Drop all memoized perf-model queries (cold-cache benchmarking)."""
    for f in (
        quantize_len,
        _prefill_time_cached,
        _decode_affine_cached,
        _max_prefill_rps_cached,
        _max_decode_batch_cached,
    ):
        f.cache_clear()


def perf_cache_info() -> dict:
    return {
        "prefill_time": _prefill_time_cached.cache_info()._asdict(),
        "decode_step": _decode_affine_cached.cache_info()._asdict(),
        "max_prefill_rps": _max_prefill_rps_cached.cache_info()._asdict(),
        "max_decode_batch": _max_decode_batch_cached.cache_info()._asdict(),
    }


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12  # bf16
    hbm_bw: float = 819e9  # bytes/s
    hbm_bytes: float = 16e9
    ici_bw: float = 50e9  # bytes/s per link per direction
    ici_links: int = 4
    ici_latency_s: float = 1e-6  # per hop
    vmem_bytes: float = 128e6
    flops_eff: float = 0.55  # achievable fraction of peak (matmul-heavy)
    bw_eff: float = 0.8


V5E = HardwareSpec()

# One NVIDIA H100 SXM. The peaks are the data sheet's; the measured fields
# come from chip_smoke.py's phase 10 on an "NVIDIA H100 80GB HBM3, 700.00 W"
# card (name and power limit as nvidia-smi prints them), torch 2.11.0+cu128.
H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,  # bf16 dense, H100 SXM data sheet
    hbm_bw=3.35e12,  # bytes/s, H100 SXM data sheet
    hbm_bytes=85_017_493_504,  # measured: torch.cuda.get_device_properties(0).total_memory
    ici_bw=25e9,  # NVLink 4, bytes/s per link per direction: published, not measured (one card has no link)
    ici_links=18,  # NVLink 4 links of an H100 SXM: published, not measured (one card has no link)
    ici_latency_s=5.376e-6,  # measured: CUDA-event time of a 4-byte device-to-device copy, a lower bound for a hop
    vmem_bytes=52_428_800,  # measured: the card's L2_cache_size, the VMEM-residency term's GPU analogue
    flops_eff=0.3325,  # measured: bf16 tp_shard_matmul at (4096, 4096) @ (4096, 14336), 1.4627 ms, over 989 TFLOP/s
    bw_eff=0.6580,  # measured: bound_ms / ms of the bf16 w_gate decode row (8, 4096) @ (4096, 14336), 0.0351 / 0.0534
)


@dataclass(frozen=True)
class PerfModel:
    cfg: ModelConfig
    hw: HardwareSpec = V5E
    dtype_bytes: int = 2

    def __post_init__(self):
        # The memoized queries hash `self` on every lookup; the generated
        # dataclass __hash__ walks the whole nested ModelConfig each time
        # (~5us), which would dominate warm cache hits. Precompute it once,
        # along with the model-derived constants the raw queries re-derive.
        object.__setattr__(
            self, "_hash", hash((self.cfg, self.hw, self.dtype_bytes))
        )
        object.__setattr__(self, "_n_params", self.cfg.param_count())
        object.__setattr__(self, "_n_active", self.cfg.active_param_count())
        object.__setattr__(self, "_kv_per_tok", self._kv_bytes_per_token())
        object.__setattr__(self, "_state_bytes", self._state_bytes_raw())

    def __hash__(self) -> int:  # overrides the generated field-walking hash
        return self._hash

    # ---- derived model quantities ------------------------------------
    @property
    def n_params(self) -> int:
        return self._n_params

    @property
    def n_active(self) -> int:
        return self._n_active

    def kv_bytes_per_token(self) -> float:
        return self._kv_per_tok

    def state_bytes(self) -> float:
        """O(1) recurrent state (mamba) per sequence."""
        return self._state_bytes

    def _kv_bytes_per_token(self) -> float:
        c = self.cfg
        if c.family == "ssm":
            return 0.0  # state is O(1) in sequence length
        per_layer = 2 * c.num_kv_heads * c.head_dim * self.dtype_bytes
        return per_layer * c.n_attn_layers

    def _state_bytes_raw(self) -> float:
        c = self.cfg
        if c.mamba is None:
            return 0.0
        m = c.mamba
        if m.version == 2:
            per = (c.d_inner // m.head_dim) * m.head_dim * m.d_state
        else:
            per = c.d_inner * m.d_state
        return per * c.n_mamba_layers * 4  # f32 state

    # ---- collective models -------------------------------------------
    def allreduce_time(self, bytes_per_chip: float, tp: int) -> float:
        if tp <= 1:
            return 0.0
        ring = 2.0 * (tp - 1) / tp * bytes_per_chip / (self.hw.ici_bw * self.hw.ici_links)
        return ring + 2.0 * math.log2(tp) * self.hw.ici_latency_s

    # ---- prefill -------------------------------------------------------
    def prefill_time_s(self, prompt_len: int, tp: int, batch: int = 1) -> float:
        """Time to prefill `batch` prompts of `prompt_len` on a TP-`tp` group.

        Memoized on a quantized prompt length (see module header)."""
        if not _CACHING_ENABLED:
            return self._prefill_time_raw(prompt_len, tp, batch)
        return _prefill_time_cached(self, quantize_len(prompt_len), tp, batch)

    def _prefill_time_raw(self, prompt_len: float, tp: int, batch: int = 1) -> float:
        tokens = prompt_len * batch
        flops = 2.0 * self.n_active * tokens
        # attention quadratic term
        c = self.cfg
        if c.n_attn_layers:
            win = c.attn.window or prompt_len
            eff_ctx = min(prompt_len, win)
            flops += (
                4.0 * c.num_heads * c.head_dim * prompt_len * eff_ctx
                * c.n_attn_layers * batch * 0.5
            )
        t_compute = flops / (tp * self.hw.peak_flops * self.hw.flops_eff)
        t_mem = (self.n_params * self.dtype_bytes / tp) / (self.hw.hbm_bw * self.hw.bw_eff)
        # per-layer collectives: 1 all-reduce of activations per block
        act_bytes = tokens * c.d_model * self.dtype_bytes / tp
        t_coll = 2 * c.num_layers * self.allreduce_time(act_bytes, tp)
        return max(t_compute, t_mem) + t_coll

    def ttft_ms(self, prompt_len: int, tp: int, batch: int = 1) -> float:
        return self.prefill_time_s(prompt_len, tp, batch) * 1e3

    # ---- decode --------------------------------------------------------
    def decode_step_time_s(self, batch: int, ctx_len: int, tp: int) -> float:
        """One decode iteration for `batch` sequences with context `ctx_len`.

        For fixed (batch, tp) the roofline is exactly piecewise-affine in
        the context length (linear KV term under a max() with a constant
        compute term, plus constant collectives), so the hot path evaluates
        cached affine coefficients in O(1) — exact, no quantization."""
        if not _CACHING_ENABLED:
            return self._decode_step_raw(batch, ctx_len, tp)
        base_mem, kv_coeff, t_comp, t_coll, win = _decode_affine_cached(
            self, int(batch), tp
        )
        eff = ctx_len if ctx_len < win else win
        t_mem = base_mem + kv_coeff * eff
        return (t_mem if t_mem > t_comp else t_comp) + t_coll

    def _decode_affine_raw(self, batch: int, tp: int):
        """(base_mem, kv_coeff, t_compute, t_coll, window) such that
        step(ctx) = max(base_mem + kv_coeff*min(ctx, window), t_compute)
                    + t_coll  — algebraically identical to _decode_step_raw."""
        c = self.cfg
        w_bytes = self.n_params * self.dtype_bytes / tp
        if w_bytes <= self.hw.vmem_bytes * 0.8:
            w_bytes = 0.0
        bw = self.hw.hbm_bw * self.hw.bw_eff
        kv_coeff = batch * self.kv_bytes_per_token() / tp / bw
        base_mem = (w_bytes + batch * self.state_bytes() / tp) / bw
        t_compute = 2.0 * self.n_active * batch / (
            tp * self.hw.peak_flops * self.hw.flops_eff
        )
        act_bytes = batch * c.d_model * self.dtype_bytes / tp
        t_coll = 2 * c.num_layers * self.allreduce_time(act_bytes, tp)
        win = c.attn.window
        return base_mem, kv_coeff, t_compute, t_coll, (win or math.inf)

    def _decode_step_raw(self, batch: int, ctx_len: float, tp: int) -> float:
        c = self.cfg
        w_bytes = self.n_params * self.dtype_bytes / tp
        # VMEM residency: shards that fit stay resident (TPU analogue of the
        # paper's L2 effect) — weight HBM traffic vanishes.
        if w_bytes <= self.hw.vmem_bytes * 0.8:
            w_bytes = 0.0
        kv_bytes = batch * self.kv_bytes_per_token() * min(
            ctx_len, self.cfg.attn.window or ctx_len
        ) / tp
        state_bytes = batch * self.state_bytes() / tp
        t_mem = (w_bytes + kv_bytes + state_bytes) / (self.hw.hbm_bw * self.hw.bw_eff)
        flops = 2.0 * self.n_active * batch
        t_compute = flops / (tp * self.hw.peak_flops * self.hw.flops_eff)
        act_bytes = batch * c.d_model * self.dtype_bytes / tp
        t_coll = 2 * c.num_layers * self.allreduce_time(act_bytes, tp)
        return max(t_mem, t_compute) + t_coll

    def tpot_ms(self, batch: int, ctx_len: int, tp: int) -> float:
        return self.decode_step_time_s(batch, ctx_len, tp) * 1e3

    # ---- KV occupancy queries (simulator backpressure) ------------------
    def kv_capacity_bytes(self, tp: int) -> float:
        """HBM bytes available for KV cache (+ recurrent state) on a TP-`tp`
        group after weights, at the same 0.9 utilization ceiling
        `max_decode_batch` assumes. The simulator's per-group occupancy
        accounting measures against this capacity."""
        return max(
            self.hw.hbm_bytes * tp * 0.9 - self.n_params * self.dtype_bytes, 0.0
        )

    def seq_kv_bytes(self, ctx_len: float) -> float:
        """Resident KV + state bytes of one sequence at context `ctx_len`.
        Sliding-window models cap resident KV at the window."""
        eff = min(ctx_len, self.cfg.attn.window or ctx_len)
        return self.kv_bytes_per_token() * eff + self.state_bytes()

    # ---- memory feasibility ---------------------------------------------
    def fits(self, tp: int, kv_headroom: float = 0.15) -> bool:
        """Do the weights (+ some KV headroom) fit a TP-`tp` group's HBM?
        (The paper's 'minimal TP level that a model fits'.)"""
        need = self.n_params * self.dtype_bytes * (1.0 + kv_headroom)
        return need <= self.hw.hbm_bytes * tp * 0.92

    def min_tp(self, candidate_tps=(1, 2, 4, 8, 16)) -> int:
        for tp in sorted(candidate_tps):
            if self.fits(tp):
                return tp
        return max(candidate_tps)

    # ---- SLO-constrained throughputs (planner inputs) -------------------
    def max_prefill_rps(self, prompt_len: int, tp: int, ttft_slo_ms: float) -> float:
        """Max sustainable req/s on one TP-`tp` prefill group under the SLO.

        TTFT ≈ queue + execution; sustained at utilization u, M/D/1-ish queue
        inflation 1/(1-u). We find the largest u where TTFT is still met.
        Memoized on a quantized prompt length (the 40-step bisection only
        runs on cache misses).
        """
        if not _CACHING_ENABLED:
            return self._max_prefill_rps_raw(prompt_len, tp, ttft_slo_ms)
        return _max_prefill_rps_cached(self, quantize_len(prompt_len), tp, ttft_slo_ms)

    def _max_prefill_rps_raw(self, prompt_len: float, tp: int, ttft_slo_ms: float) -> float:
        if not self.fits(tp):
            return 0.0
        t_exec = self.prefill_time_s(prompt_len, tp)
        if t_exec * 1e3 > ttft_slo_ms:
            return 0.0
        slo_s = ttft_slo_ms / 1e3
        # TTFT = t_exec * (1 + u/(1-u)) <= slo — M/M/1-like wait, deliberately
        # pessimistic because production arrivals are burstier than Poisson
        # (ServeGen/BurstGPT); an optimistic bound oversubscribes prefill and
        # blows the TTFT tail.
        lo, hi = 0.0, 0.99
        for _ in range(40):
            u = 0.5 * (lo + hi)
            ttft = t_exec * (1.0 + u / max(1e-9, 1.0 - u))
            if ttft <= slo_s:
                lo = u
            else:
                hi = u
        return 0.9 * lo / t_exec

    def max_decode_batch(
        self, ctx_len: int, tp: int, tpot_slo_ms: float,
        hbm_free_bytes: Optional[float] = None,
    ) -> int:
        """Largest batch a TP-`tp` decode group can run within the TPOT SLO.

        ``hbm_free_bytes`` overrides the KV-memory budget (default: all HBM
        after weights). The simulator passes the group's TOTAL watermarked
        KV budget (watermark × kv_capacity_bytes), not capacity minus live
        occupancy — the batch being sized IS the occupancy, so subtracting
        it would double-count resident sequences. Memoized on a quantized
        context length and quantized byte budget (the binary search only
        runs on cache misses)."""
        if not _CACHING_ENABLED:
            return self._max_decode_batch_raw(ctx_len, tp, tpot_slo_ms, hbm_free_bytes)
        free_q = None if hbm_free_bytes is None else quantize_len(hbm_free_bytes)
        return _max_decode_batch_cached(
            self, quantize_len(ctx_len), tp, tpot_slo_ms, free_q
        )

    def _max_decode_batch_raw(
        self, ctx_len: float, tp: int, tpot_slo_ms: float,
        hbm_free_bytes: Optional[float] = None,
    ) -> int:
        if not self.fits(tp):
            return 0
        lo, hi = 0, 4096
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.tpot_ms(mid, ctx_len, tp) <= tpot_slo_ms:
                lo = mid
            else:
                hi = mid - 1
        # KV memory cap
        kv_per_seq = self.seq_kv_bytes(ctx_len)
        if kv_per_seq > 0:
            hbm_free = (
                self.kv_capacity_bytes(tp)
                if hbm_free_bytes is None else hbm_free_bytes
            )
            lo = min(lo, max(int(hbm_free / kv_per_seq), 0))
        return lo

    def max_decode_rps(
        self, ctx_len: int, out_len: int, tp: int, tpot_slo_ms: float
    ) -> float:
        b = self.max_decode_batch(ctx_len, tp, tpot_slo_ms)
        if b <= 0:
            return 0.0
        t = self.decode_step_time_s(b, ctx_len, tp)
        tok_rate = b / t
        return tok_rate / max(out_len, 1)
