"""Scenario matrix: parameterized, seeded hour-scale tiered workloads
(mirrors repro/traces/scenarios.py, seeds and draw order included).

The paper's headline claim is goodput under *time-varying* workload mix,
request lengths, and load intensity (§2.3 motivation; Fig. 9/12 sweeps).
This module turns the ServeGen/azure trace machinery into a library of
named, composable non-stationary scenarios:

  * ``diurnal``          — hour-scale sinusoidal rate cycle, tiers in
                           antiphase (conversation peaks while code dips);
  * ``flash_crowd``      — steady base load punctuated by short flash
                           crowds (synchronized user events, 4-6x rate);
  * ``tier_drift``       — the strict:relaxed request mix ramps from
                           strict-light to strict-heavy across the trace,
                           so the goodput-optimal TP layout drifts;
  * ``longctx_phases``   — short-context base with square-wave phases of
                           8-32k-token document traffic (KV backpressure
                           engages only inside the phases);
  * ``prefill_heavy``    — long prompts, short outputs (retrieval /
                           summarization ingest): prefill-bound regime;
  * ``decode_heavy``     — short prompts, long outputs (generation /
                           reasoning): decode-bound regime.

Every scenario is a :class:`ScenarioSpec` — a frozen, declarative
composition of per-tier :class:`StreamSpec` s with deterministic
:class:`EnvelopeSpec` rate modulation. ``spec.build(seed)`` realizes a
:class:`~repro_torch.traces.workload.Workload`; the same (spec, seed) always
yields the identical trace (tests/test_torch_traces.py gates this), and the
spec exposes its *expected* statistics (total rate, tier mix, length
means) so realized traces can be checked against it
(repro_torch.testing.scenario_checks).

Envelopes are normalized to mean 1.0 over the horizon, so a stream's
realized average rate equals ``mean_rps`` no matter how the modulation
reshapes it — scenario intensity is controlled solely by ``rps_scale``
(benchmarks/scenario_matrix.py scales it with cluster size).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.traces.servegen import STATS as SERVEGEN_STATS
from repro_torch.traces.workload import (
    DEFAULT_TENANT,
    FAULT_DOMAINS,
    FAULT_KINDS,
    FaultEvent,
    Topology,
    Workload,
    make_workload,
    merge_workloads,
)

ENVELOPE_DT_S = 1.0  # envelope sample spacing (matches bursty_arrivals bins)


@dataclass(frozen=True)
class EnvelopeSpec:
    """Deterministic rate-multiplier shape over the (unit-scaled) horizon.

    All knobs are expressed in fractions of the horizon so a scenario can
    be built at any length (hour-long for the matrix, seconds-long for
    tests) without re-tuning. The sampled envelope is normalized to mean
    1.0, so it redistributes a stream's arrivals in time without changing
    the average rate.
    """

    # sinusoid: 1 + amplitude * sin(2*pi*(cycles * t/horizon) + phase)
    diurnal_amplitude: float = 0.0
    diurnal_cycles: float = 1.0  # full cycles across the horizon
    diurnal_phase: float = 0.0
    # linear mix drift: multiplier ramps (1 - drift) -> (1 + drift)
    drift: float = 0.0
    # flash crowds: (t0_frac, dur_frac, magnitude) — adds `magnitude` to
    # the multiplier inside [t0, t0 + dur)
    flash_crowds: Tuple[Tuple[float, float, float], ...] = ()
    # active phases: stream only emits inside these [t0_frac, t1_frac)
    # windows (empty = always on)
    phases: Tuple[Tuple[float, float], ...] = ()

    def values(self, horizon_s: float) -> np.ndarray:
        n = max(int(horizon_s / ENVELOPE_DT_S), 1)
        t = (np.arange(n) + 0.5) / n  # bin centers, in horizon fractions
        env = np.ones(n)
        if self.diurnal_amplitude:
            env += self.diurnal_amplitude * np.sin(
                2.0 * math.pi * (self.diurnal_cycles * t) + self.diurnal_phase
            )
        if self.drift:
            env *= 1.0 + self.drift * (2.0 * t - 1.0)
        for t0, dur, mag in self.flash_crowds:
            env += mag * ((t >= t0) & (t < t0 + dur))
        if self.phases:
            mask = np.zeros(n, dtype=bool)
            for t0, t1 in self.phases:
                mask |= (t >= t0) & (t < t1)
            env *= mask
        env = np.clip(env, 0.0, None)
        mean = env.mean()
        return env / mean if mean > 0 else env


@dataclass(frozen=True)
class StreamSpec:
    """One tier's request stream: rate, length distributions, modulation."""

    tier: str
    mean_rps: float
    prompt_mean: float
    output_mean: float
    prompt_sigma: float = 0.9
    prompt_lo: int = 8
    prompt_hi: int = 32768
    output_sigma: float = 0.7
    output_lo: int = 2
    output_hi: int = 4096
    burstiness: float = 0.6
    envelope: EnvelopeSpec = field(default_factory=EnvelopeSpec)
    # tenant identity (docs/tenancy.md): every request of this stream
    # belongs to `tenant`; DEFAULT_TENANT keeps legacy single-tenant
    # behavior (and golden traces) exactly
    tenant: str = DEFAULT_TENANT
    # contracted sustained rate for admission budgeting (req/s): what the
    # tenant *paid for*, as opposed to mean_rps, what it *sends*. None =
    # no contract — admission.budgets_from_spec leaves the tenant
    # unlimited. An aggressor floods by sending mean_rps >> budget_rps.
    budget_rps: Optional[float] = None


@dataclass(frozen=True)
class FaultSpec:
    """Declarative, horizon-relative fault event (docs/faults.md).

    Like :class:`EnvelopeSpec`, times are fractions of the horizon so a
    fault scenario builds at any length (600s for tests, hour-long for the
    matrix) without re-tuning. ``build(seed)`` realizes each FaultSpec into
    a concrete :class:`~repro_torch.traces.workload.FaultEvent` with absolute
    times and a victim-selection seed derived deterministically from the
    build seed and the fault's index — the same seeding discipline the
    per-stream RandomStates follow.
    """

    kind: str  # one of workload.FAULT_KINDS
    t_frac: float  # fire time as a fraction of the horizon
    chips: int = 0  # chips lost (chip/host loss) or rejoining (recovery)
    duration_frac: float = 0.0  # straggler window, fraction of horizon
    slowdown: float = 1.0  # straggler perf multiplier (>1 = slower)
    # --- failure-domain correlation (docs/faults.md §Failure domains) ---
    # domain: victim scope — "" keeps the legacy anonymous draw; "host" /
    # "rack" / "power" resolve a whole topology unit in the simulator
    domain: str = ""
    # wave: which member host of the cascade's rack/power domain fails at
    # this event (-1 = the seeded first); events sharing `corr` share one
    # victim seed, so a cascade's waves all land in the same domain
    wave: int = -1
    corr: int = -1  # correlation id; -1 = independent (seed by index)
    # seeded per-host lag: build() adds U(0, lag_jitter_frac·horizon) to
    # the fire time, drawn from the build seed — cascades fan out with
    # host-to-host lag that varies by seed but replays bit-identically
    lag_jitter_frac: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )
        if self.domain not in FAULT_DOMAINS:
            raise ValueError(
                f"unknown fault domain {self.domain!r}; known: {FAULT_DOMAINS}"
            )


@dataclass(frozen=True)
class ScenarioSpec:
    """A named, seeded, non-stationary tiered workload composition."""

    name: str
    horizon_s: float
    streams: Tuple[StreamSpec, ...]
    description: str = ""
    faults: Tuple[FaultSpec, ...] = ()
    # failure-domain tree the realized trace carries (None = simulator
    # default); only domain-scoped faults read it
    topology: Optional[Topology] = None

    # ---- expected statistics (what scenario_checks verifies against) ----
    @property
    def expected_rps(self) -> float:
        return sum(s.mean_rps for s in self.streams)

    @property
    def expected_tier_mix(self) -> Dict[str, float]:
        """Expected fraction of requests per tier."""
        tot = self.expected_rps or 1.0
        mix: Dict[str, float] = {}
        for s in self.streams:
            mix[s.tier] = mix.get(s.tier, 0.0) + s.mean_rps / tot
        return mix

    @property
    def expected_prompt_mean(self) -> float:
        """Rate-weighted mean prompt length (before lo/hi clipping)."""
        tot = self.expected_rps or 1.0
        return sum(s.mean_rps * s.prompt_mean for s in self.streams) / tot

    @property
    def expected_output_mean(self) -> float:
        tot = self.expected_rps or 1.0
        return sum(s.mean_rps * s.output_mean for s in self.streams) / tot

    # ---- realization -----------------------------------------------------
    def build(
        self,
        seed: int = 0,
        horizon_s: Optional[float] = None,
        rps_scale: float = 1.0,
    ) -> Workload:
        """Realize the scenario as a concrete trace. Deterministic in
        (spec, seed, horizon_s, rps_scale): stream *i* draws from
        ``RandomState(seed + i)``, envelopes are deterministic."""
        horizon = float(horizon_s if horizon_s is not None else self.horizon_s)
        parts = []
        for i, s in enumerate(self.streams):
            parts.append(
                make_workload(
                    f"{self.name}/{s.tier}{i}",
                    s.tier,
                    s.mean_rps * rps_scale,
                    s.prompt_mean,
                    s.output_mean,
                    horizon_s=horizon,
                    seed=seed + i,
                    burstiness=s.burstiness,
                    prompt_sigma=s.prompt_sigma,
                    prompt_lo=s.prompt_lo,
                    prompt_hi=s.prompt_hi,
                    output_sigma=s.output_sigma,
                    output_lo=s.output_lo,
                    output_hi=s.output_hi,
                    envelope=s.envelope.values(horizon),
                    tenant_id=s.tenant,
                )
            )
        wl = merge_workloads(self.name, *parts)
        # faults ride along in horizon fractions; victim seeds derive from
        # (build seed, fault index) so replays are bit-deterministic and a
        # different build seed picks different victims. Correlated cascade
        # members (corr >= 0) share the victim seed of their correlation
        # id, so every wave resolves to the same rack/power domain; their
        # per-host lag jitter is drawn per-event from the build seed.
        events = []
        for j, f in enumerate(self.faults):
            vic = (seed + 1) * 7919 + 101 * (f.corr if f.corr >= 0 else j)
            t_s = f.t_frac * horizon
            if f.lag_jitter_frac > 0.0:
                t_s += float(
                    np.random.RandomState(vic + 17 * (j + 1)).uniform(
                        0.0, f.lag_jitter_frac * horizon
                    )
                )
            events.append(
                FaultEvent(
                    t_s=t_s,
                    kind=f.kind,
                    chips=f.chips,
                    duration_s=f.duration_frac * horizon,
                    slowdown=f.slowdown,
                    seed=vic,
                    domain=f.domain,
                    wave=f.wave,
                )
            )
        wl.faults = tuple(sorted(events, key=lambda ev: ev.t_s))
        wl.topology = self.topology
        return wl

    def scaled(self, rps_scale: float) -> "ScenarioSpec":
        """Spec with every stream's rate scaled (expected stats follow)."""
        return replace(
            self,
            streams=tuple(
                replace(s, mean_rps=s.mean_rps * rps_scale) for s in self.streams
            ),
        )


# ===========================================================================
# Named scenarios (the matrix rows). Base rates are the ServeGen two-tier
# operating point that saturates the 16-chip reference pool; the matrix
# runner scales them with cluster size.
# ===========================================================================
_CONV = SERVEGEN_STATS["conversation"]
_CODE = SERVEGEN_STATS["code"]
_HOUR = 3600.0


def _diurnal() -> ScenarioSpec:
    return ScenarioSpec(
        name="diurnal",
        horizon_s=_HOUR,
        description=(
            "Hour-scale sinusoidal load cycle; strict conversation and "
            "relaxed code traffic peak in antiphase, so both total load "
            "and the tier mix vary continuously."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"], _CONV["prompt_mean"],
                _CONV["output_mean"], burstiness=0.7,
                envelope=EnvelopeSpec(diurnal_amplitude=0.6, diurnal_cycles=1.0),
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"], _CODE["prompt_mean"],
                _CODE["output_mean"], burstiness=0.7,
                envelope=EnvelopeSpec(
                    diurnal_amplitude=0.6, diurnal_cycles=1.0,
                    diurnal_phase=math.pi,
                ),
            ),
        ),
    )


def _flash_crowd() -> ScenarioSpec:
    # three crowds of growing magnitude; each lasts ~2% of the horizon
    crowds = ((0.25, 0.02, 3.0), (0.55, 0.02, 4.0), (0.8, 0.02, 5.0))
    return ScenarioSpec(
        name="flash_crowd",
        horizon_s=_HOUR,
        description=(
            "Steady two-tier base load punctuated by synchronized flash "
            "crowds (4-6x rate for ~70s) hitting the strict tier."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"], _CONV["prompt_mean"],
                _CONV["output_mean"], burstiness=0.5,
                envelope=EnvelopeSpec(flash_crowds=crowds),
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"], _CODE["prompt_mean"],
                _CODE["output_mean"], burstiness=0.5,
            ),
        ),
    )


def _tier_drift() -> ScenarioSpec:
    return ScenarioSpec(
        name="tier_drift",
        horizon_s=_HOUR,
        description=(
            "The strict:relaxed mix ramps from 30:70-ish to 70:30-ish "
            "across the trace (linear antiphase drift), so the "
            "goodput-optimal configuration shifts mid-replay — the "
            "paper's §2.3 time-varying-mix motivation at hour scale."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"], _CONV["prompt_mean"],
                _CONV["output_mean"], burstiness=0.7,
                envelope=EnvelopeSpec(drift=0.7),
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"], _CODE["prompt_mean"],
                _CODE["output_mean"], burstiness=0.7,
                envelope=EnvelopeSpec(drift=-0.7),
            ),
        ),
    )


def _longctx_phases() -> ScenarioSpec:
    return ScenarioSpec(
        name="longctx_phases",
        horizon_s=_HOUR,
        description=(
            "Short-context two-tier base with two long-context phases "
            "(8-32k document prompts at ~15% of base rate) occupying the "
            "middle fifths of the trace — KV occupancy and admission "
            "backpressure engage only inside the phases."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"], _CONV["prompt_mean"],
                _CONV["output_mean"], burstiness=0.6,
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"] * 0.85, _CODE["prompt_mean"],
                _CODE["output_mean"], burstiness=0.6,
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"] * 0.15, 16384, 400,
                prompt_sigma=0.5, prompt_lo=8192, prompt_hi=32768,
                burstiness=0.6,
                envelope=EnvelopeSpec(phases=((0.2, 0.4), (0.6, 0.8))),
            ),
        ),
    )


def _prefill_heavy() -> ScenarioSpec:
    return ScenarioSpec(
        name="prefill_heavy",
        horizon_s=_HOUR,
        description=(
            "Retrieval/summarization ingest: 4-6k-token prompts, <=64-token "
            "outputs. Prefill-bound — stresses TTFT routing and "
            "prefill/decode interference. Rates are 0.25x the two-tier "
            "base: per-request prefill work is ~5.7x, so this is the "
            "16-chip saturation point for THIS regime (calibrated: "
            "goodput/injected ~0.95 at 0.2x, ~0.77 at 0.3x)."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"] * 0.25, 4096, 48,
                prompt_sigma=0.5, output_sigma=0.5, output_hi=256,
                burstiness=0.6,
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"] * 0.25, 6144, 64,
                prompt_sigma=0.5, output_sigma=0.5, output_hi=256,
                burstiness=0.6,
            ),
        ),
    )


def _decode_heavy() -> ScenarioSpec:
    return ScenarioSpec(
        name="decode_heavy",
        horizon_s=_HOUR,
        description=(
            "Generation/reasoning traffic: short (~200-token) prompts, "
            "600-900-token outputs. Decode-bound — stresses TPOT batch "
            "caps and KV growth during generation."
        ),
        streams=(
            StreamSpec(
                "strict", _CONV["mean_rps"] * 0.6, 200, 600,
                prompt_sigma=0.6, output_sigma=0.5, burstiness=0.6,
            ),
            StreamSpec(
                "relaxed", _CODE["mean_rps"] * 0.6, 256, 900,
                prompt_sigma=0.6, output_sigma=0.5, burstiness=0.6,
            ),
        ),
    )


# ---------------------------------------------------------------------------
# Noisy-neighbor scenarios (docs/tenancy.md, benchmarks/noisy_neighbor.py):
# two well-behaved victim tenants under their contracted budgets, plus one
# aggressor flooding the strict tier at `flood_x` times ITS contract. The
# isolation acceptance bar: with admission on, victim goodput holds within
# a few percent of the aggressor-free baseline while the aggressor is
# throttled. The aggressor stream is deliberately LAST: stream i draws
# RandomState(seed + i), so dropping the aggressor (`streams[:-1]` — the
# baseline leg) leaves every victim's arrival/length draws untouched.
# ---------------------------------------------------------------------------
_NOISY_HORIZON = 600.0


def noisy_neighbor_spec(flood_x: float = 5.0) -> ScenarioSpec:
    """The noisy-neighbor family at an aggressor flood factor of
    ``flood_x`` (>= 1; the registered default is 5x — the ISSUE/ROADMAP
    isolation bar)."""
    agg_base = _CONV["mean_rps"] * 0.10  # the aggressor's *contract*
    victims = (
        StreamSpec(
            "strict", _CONV["mean_rps"] * 0.70, _CONV["prompt_mean"],
            _CONV["output_mean"], burstiness=0.6,
            tenant="tenant_a", budget_rps=_CONV["mean_rps"] * 0.70 * 2.0,
        ),
        StreamSpec(
            "relaxed", _CODE["mean_rps"] * 0.70, _CODE["prompt_mean"],
            _CODE["output_mean"], burstiness=0.6,
            tenant="tenant_b", budget_rps=_CODE["mean_rps"] * 0.70 * 2.0,
        ),
    )
    aggressor = StreamSpec(
        "strict", agg_base * flood_x, _CONV["prompt_mean"],
        _CONV["output_mean"], burstiness=0.4,
        tenant="mallory", budget_rps=agg_base,
    )
    return ScenarioSpec(
        name="noisy_neighbor",
        horizon_s=_NOISY_HORIZON,
        description=(
            "Two victim tenants (tenant_a on strict conversation, tenant_b "
            "on relaxed code, both at 0.70x the two-tier base and under "
            f"2x-mean contracts) share the pool with 'mallory', flooding "
            f"the strict tier at {flood_x:g}x its contracted rate. "
            "Acceptance bar is isolation, not throughput: victim goodput "
            "within a few percent of the aggressor-free baseline, "
            "aggressor throttled (docs/tenancy.md)."
        ),
        streams=victims + (aggressor,),
    )


# ---------------------------------------------------------------------------
# Fault scenarios (the incident-matrix rows, benchmarks/fault_matrix.py).
# The request load is deliberately steady — a flat two-tier base at the
# 16-chip saturation point — so every goodput dip in the replay is
# attributable to the injected fault, not to envelope shape. Fire times
# sit mid-trace with a long post-fault window so time-to-recover and dip
# width are measurable before the horizon ends.
# ---------------------------------------------------------------------------
_FAULT_HORIZON = 600.0


def _fault_base_streams() -> Tuple[StreamSpec, ...]:
    return (
        StreamSpec(
            "strict", _CONV["mean_rps"], _CONV["prompt_mean"],
            _CONV["output_mean"], burstiness=0.5,
        ),
        StreamSpec(
            "relaxed", _CODE["mean_rps"], _CODE["prompt_mean"],
            _CODE["output_mean"], burstiness=0.5,
        ),
    )


def _fault_chip_loss() -> ScenarioSpec:
    return ScenarioSpec(
        name="fault_chip_loss",
        horizon_s=_FAULT_HORIZON,
        description=(
            "Steady two-tier base; a single chip fails at 35% of the "
            "horizon (killing its group and orphaning the group's "
            "surviving chips) and rejoins at 65%, triggering a "
            "weight-reload storm on re-formed groups."
        ),
        streams=_fault_base_streams(),
        faults=(
            FaultSpec("chip_loss", 0.35, chips=1),
            FaultSpec("recovery", 0.65, chips=1),
        ),
    )


def _fault_host_loss() -> ScenarioSpec:
    return ScenarioSpec(
        name="fault_host_loss",
        horizon_s=_FAULT_HORIZON,
        description=(
            "Steady two-tier base; a whole host (8 chips) drops at 35% of "
            "the horizon — every group intersecting it dies and its "
            "mid-decode sequences restart — and rejoins at 65%."
        ),
        streams=_fault_base_streams(),
        faults=(
            FaultSpec("host_loss", 0.35, chips=8),
            FaultSpec("recovery", 0.65, chips=8),
        ),
    )


def _fault_kv_loss() -> ScenarioSpec:
    return ScenarioSpec(
        name="fault_kv_loss",
        horizon_s=_FAULT_HORIZON,
        description=(
            "Steady two-tier base; one group dumps its HBM KV pool at 35% "
            "and again (fresh victim draw) at 60% of the horizon. The "
            "group and its chips survive; every resident sequence "
            "restarts through the admission/spill path."
        ),
        streams=_fault_base_streams(),
        faults=(
            FaultSpec("kv_loss", 0.35),
            FaultSpec("kv_loss", 0.60),
        ),
    )


def _fault_straggler() -> ScenarioSpec:
    return ScenarioSpec(
        name="fault_straggler",
        horizon_s=_FAULT_HORIZON,
        description=(
            "Steady two-tier base; one group runs 3x slower for 25% of "
            "the horizon starting at 35% (ECC storm / thermal throttle), "
            "then recovers in place."
        ),
        streams=_fault_base_streams(),
        faults=(
            FaultSpec("straggler", 0.35, duration_frac=0.25, slowdown=3.0),
        ),
    )


def cascade_faults(
    family: str,
    t_frac: float = 0.30,
    recover_t_frac: float = 0.62,
    waves: int = 3,
    wave_lag_frac: float = 0.02,
    lag_jitter_frac: float = 0.012,
    slowdown: float = 3.0,
    degrade_frac: float = 0.22,
    corr: int = 0,
    topology: Optional[Topology] = None,
) -> Tuple[FaultSpec, ...]:
    """Generate one correlated failure cascade as a FaultSpec sequence.

    This replaces the hand-coded composed incidents: a cascade is a
    family name plus timing knobs, and the member events come out
    correlated — they share the correlation id ``corr``, so ``build``
    gives them one victim seed and the simulator resolves every wave to
    the SAME host/rack/power domain, with per-host lag jitter drawn from
    the build seed (``lag_jitter_frac``).

    Families:
      * ``host``   — a whole host drops (its chips fail together), a
                     surviving chip of the blast neighborhood straggles,
                     then the host rejoins (reload storm);
      * ``rack``   — ``waves`` hosts of one rack drop one by one with
                     seeded lag, then the rack rejoins at once;
      * ``power``  — a power-feed event: ``waves+1`` hosts across the
                     feed's racks drop in quick succession, rejoin at once;
      * ``flaky``  — partial degradation only: a single-chip straggler
                     plus an intermittent flaky link, no kills;
      * ``legacy_host`` — the anonymous (domain-free) composed incident
                     the old hand-coded ``incident_replay`` declared:
                     host loss, a correlated single-chip follower, one
                     combined recovery. Kept so the recorded golden
                     trace is byte-identical while the literal is gone.
    """
    topo = topology or Topology()
    cph = topo.chips_per_host
    if family == "legacy_host":
        # round the derived fraction so the generated spec reproduces the
        # old hand-written literal bit-for-bit (0.30 + 0.04 != 0.34 in fp)
        return (
            FaultSpec("host_loss", t_frac, chips=cph),
            FaultSpec("chip_loss", round(t_frac + 0.04, 10), chips=1),
            FaultSpec("recovery", recover_t_frac, chips=cph + 1),
        )
    dur = max(recover_t_frac - t_frac - wave_lag_frac, 0.05)
    if family == "host":
        return (
            FaultSpec("host_loss", t_frac, chips=cph, domain="host",
                      corr=corr),
            FaultSpec("chip_straggler", t_frac + wave_lag_frac,
                      duration_frac=min(degrade_frac, dur),
                      slowdown=slowdown, corr=corr + 1,
                      lag_jitter_frac=lag_jitter_frac),
            FaultSpec("recovery", recover_t_frac, chips=cph, domain="host",
                      corr=corr),
        )
    if family in ("rack", "power"):
        dom = family
        n = waves if family == "rack" else waves + 1
        events = [
            FaultSpec("host_loss", t_frac + k * wave_lag_frac, chips=cph,
                      domain=dom, wave=k, corr=corr,
                      lag_jitter_frac=(lag_jitter_frac if k else 0.0))
            for k in range(n)
        ]
        events.append(
            FaultSpec("recovery", recover_t_frac, chips=n * cph, domain=dom,
                      corr=corr)
        )
        return tuple(events)
    if family == "flaky":
        return (
            FaultSpec("chip_straggler", t_frac, duration_frac=degrade_frac,
                      slowdown=slowdown, corr=corr),
            FaultSpec("link_flap", t_frac + wave_lag_frac,
                      duration_frac=degrade_frac, slowdown=slowdown,
                      corr=corr + 1, lag_jitter_frac=lag_jitter_frac),
        )
    raise ValueError(
        f"unknown cascade family {family!r}; known: host, rack, power, "
        "flaky, legacy_host"
    )


def _incident_replay() -> ScenarioSpec:
    return ScenarioSpec(
        name="incident_replay",
        horizon_s=_FAULT_HORIZON,
        description=(
            "Composed incident (generated: cascade_faults('legacy_host')): "
            "a host (8 chips) drops at 30%, a second correlated "
            "single-chip failure lands at 34% while the pool is already "
            "degraded, and all 9 chips rejoin at once at 60% — a recovery "
            "storm of simultaneous weight reloads."
        ),
        streams=_fault_base_streams(),
        faults=cascade_faults("legacy_host", t_frac=0.30,
                              recover_t_frac=0.60),
    )


def _cascade(family: str) -> ScenarioSpec:
    desc = {
        "host": (
            "Domain-correlated host cascade: one host's chips fail "
            "together at 30%, a neighboring chip straggles 3x through the "
            "incident, and the host rejoins at 62% (reload storm)."
        ),
        "rack": (
            "Rack cascade: three hosts of ONE rack drop one by one with "
            "seeded per-host lag from 30%, and the rack rejoins at once "
            "at 62% — the fan-out the hand-coded incident_replay only "
            "gestured at."
        ),
        "power": (
            "Power-feed cascade: four hosts across the feed's racks drop "
            "in quick succession from 30% and rejoin at once at 62% — the "
            "widest blast radius in the matrix."
        ),
        "flaky": (
            "Partial degradation, no kills: a single chip inside a TP "
            "group straggles 3x (the group runs at its slowest chip) and "
            "an ICI link flaps intermittently — the shrink-TP-in-place "
            "case."
        ),
    }[family]
    return ScenarioSpec(
        name=f"cascade_{family}",
        horizon_s=_FAULT_HORIZON,
        description=desc,
        streams=_fault_base_streams(),
        faults=cascade_faults(family),
        topology=Topology(),
    )


FAULT_SCENARIOS = (
    "fault_chip_loss", "fault_host_loss", "fault_kv_loss", "fault_straggler",
    "incident_replay",
)

# the cascade-matrix rows (benchmarks/cascade_matrix.py)
CASCADE_SCENARIOS = (
    "cascade_host", "cascade_rack", "cascade_power", "cascade_flaky",
)

_REGISTRY = {
    s.name: s
    for s in (
        _diurnal(), _flash_crowd(), _tier_drift(), _longctx_phases(),
        _prefill_heavy(), _decode_heavy(), noisy_neighbor_spec(),
        _fault_chip_loss(), _fault_host_loss(), _fault_kv_loss(),
        _fault_straggler(), _incident_replay(),
        _cascade("host"), _cascade("rack"), _cascade("power"),
        _cascade("flaky"),
    )
}


def list_scenarios() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


# Fleet-scale population model (benchmarks/fleet_throughput.py): per-user
# request rate at peak engagement. ServeGen's population traces put an
# active chat/code user at roughly one request every ~8 s while engaged;
# 1M users at this rate is a ~120k req/s front door — the ROADMAP's
# "millions of users" operating point for the fleet control plane.
RPS_PER_USER = 0.12


def user_scaled_scenario(
    name: str = "diurnal", users: int = 1_000_000,
    rps_per_user: float = RPS_PER_USER,
) -> ScenarioSpec:
    """The named scenario scaled so its expected aggregate rate models a
    ``users``-sized population: every stream's rate envelope is multiplied
    by ``users * rps_per_user / expected_rps``. The composition (tier mix,
    length distributions, envelope phases, burstiness) is untouched — only
    the population behind it grows."""
    spec = get_scenario(name)
    scale = users * rps_per_user / max(spec.expected_rps, 1e-9)
    return replace(spec.scaled(scale), name=f"{name}_{users}u")
