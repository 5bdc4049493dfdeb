"""Workload representation + bursty arrival-process machinery (mirrors
repro/traces/workload.py; every seeded draw is the reference's, in its order).

Arrivals are a doubly-stochastic (Cox) process: a Poisson process whose rate
is modulated by a slowly-varying log-Gaussian intensity plus micro-bursts —
matching the burstiness findings of the trace studies the paper cites
(ServeGen, BurstGPT, Azure): strong temporal variation across minutes plus
sub-10s micro-bursts from synchronized user behavior.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

FAULT_KINDS = (
    "chip_loss", "host_loss", "kv_loss", "straggler", "recovery",
    # partial degradation (docs/faults.md §Partial degradation): a single
    # chip inside a TP group straggles (the group runs at its slowest
    # chip), or one ICI link flaps — seeded intermittent slowdown
    "chip_straggler", "link_flap",
)

# Victim scopes for domain-correlated faults (docs/faults.md §Failure
# domains). "" = legacy anonymous-chip selection (seeded permutation over
# groups); the rest select a whole topology domain, so one cascade's
# events share a victim and fan out deterministically.
FAULT_DOMAINS = ("", "host", "rack", "power")


@dataclass(frozen=True)
class Topology:
    """Seeded failure-domain tree over an anonymous chip count.

    Chips are integers ``0..n_chips-1``; the tree is positional —
    chip → host (``chips_per_host``), host → rack (``hosts_per_rack``),
    rack → power domain (``racks_per_domain``) — so the same Topology
    describes any pool size and two replays of one (trace, seed) agree
    on every domain membership. Defaults model a v5e-ish pod slice: 8
    chips per host, 4 hosts per rack, 2 racks per power feed.
    """

    chips_per_host: int = 8
    hosts_per_rack: int = 4
    racks_per_domain: int = 2

    def host_of(self, chip: int) -> int:
        return chip // self.chips_per_host

    def rack_of(self, chip: int) -> int:
        return self.host_of(chip) // self.hosts_per_rack

    def domain_of(self, chip: int) -> int:
        return self.rack_of(chip) // self.racks_per_domain

    def n_hosts(self, n_chips: int) -> int:
        return -(-n_chips // self.chips_per_host)

    def n_racks(self, n_chips: int) -> int:
        return -(-self.n_hosts(n_chips) // self.hosts_per_rack)

    def n_domains(self, n_chips: int) -> int:
        return -(-self.n_racks(n_chips) // self.racks_per_domain)

    def host_chips(self, host: int, n_chips: int) -> Tuple[int, ...]:
        lo = host * self.chips_per_host
        return tuple(range(lo, min(lo + self.chips_per_host, n_chips)))

    def rack_hosts(self, rack: int, n_chips: int) -> Tuple[int, ...]:
        lo = rack * self.hosts_per_rack
        return tuple(range(lo, min(lo + self.hosts_per_rack, self.n_hosts(n_chips))))

    def domain_hosts(self, domain: int, n_chips: int) -> Tuple[int, ...]:
        racks = range(
            domain * self.racks_per_domain,
            min((domain + 1) * self.racks_per_domain, self.n_racks(n_chips)),
        )
        out: List[int] = []
        for r in racks:
            out.extend(self.rack_hosts(r, n_chips))
        return tuple(out)

    def hosts_spanned(self, tp: int) -> int:
        """Host-failure modes a host-aligned TP group of size ``tp`` is
        exposed to (the planner's recovery-cost term reads this)."""
        return -(-tp // self.chips_per_host)

# Tenant identity (docs/tenancy.md): every request belongs to a tenant.
# Tenant-free workloads carry this sentinel, and every tenant-aware layer
# (admission, shard keying, fleet fan-out) degrades to today's
# tenant-oblivious behavior when it sees it — recorded goldens stay
# byte-identical for single-default-tenant traces.
DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TraceRequest:
    req_id: int
    tier: str
    arrival_s: float
    prompt_len: int
    output_len: int
    tenant_id: str = DEFAULT_TENANT


@dataclass(frozen=True)
class FaultEvent:
    """One seeded infrastructure disruption, anchored in absolute trace time.

    Faults are part of the *workload*, not the simulator: a trace declares
    what goes wrong and when, and any engine replaying the trace must apply
    the same disruption. ``seed`` drives victim selection (which groups die
    or straggle) so a (trace, seed) pair replays bit-identically.

    Kinds (see docs/faults.md):
      * ``chip_loss``  — ``chips`` chips fail; every group holding one dies.
      * ``host_loss``  — same mechanics, host-sized (``chips`` ~ one host).
      * ``kv_loss``    — one group's HBM KV pool is dumped; the group and
                         its chips survive, resident sequences restart.
      * ``straggler``  — one group runs ``slowdown``x slower for
                         ``duration_s`` seconds, then recovers.
      * ``recovery``   — ``chips`` chips rejoin the pool; newly formed
                         groups pay a full weight-reload storm.
      * ``chip_straggler`` — ONE chip of a group runs ``slowdown``x
                         slower; its group runs at its slowest chip.
      * ``link_flap``  — one chip's ICI link flaps: seeded intermittent
                         ``slowdown`` windows inside ``duration_s``.

    Domain correlation (docs/faults.md §Failure domains): ``domain``
    scopes the victim to a topology unit instead of the legacy anonymous
    draw — events of one cascade share a ``seed`` so they resolve to the
    SAME host/rack/power domain, and ``wave`` indexes the member host
    that fails at this event (rack/power cascades fan out host by host
    with seeded per-host lag realized at build time).
    """

    t_s: float
    kind: str
    chips: int = 0
    duration_s: float = 0.0
    slowdown: float = 1.0
    seed: int = 0
    domain: str = ""  # "" | "host" | "rack" | "power"
    wave: int = -1  # member-host index within the cascade (-1 = first)


@dataclass
class Workload:
    name: str
    requests: List[TraceRequest]
    horizon_s: float
    faults: Tuple[FaultEvent, ...] = ()
    # failure-domain tree for domain-scoped faults; None = the default
    # Topology (the simulator binds one either way, so chip identity and
    # domain membership are always defined)
    topology: Optional[Topology] = None

    @property
    def rps(self) -> float:
        return len(self.requests) / self.horizon_s

    def stats(self) -> dict:
        pl = np.array([r.prompt_len for r in self.requests])
        ol = np.array([r.output_len for r in self.requests])
        return {
            "n": len(self.requests),
            "rps": self.rps,
            "prompt_mean": float(pl.mean()),
            "output_mean": float(ol.mean()),
        }

    def scaled_rps(self, target_rps: float, seed: int = 0) -> "Workload":
        """Rescale arrival density to a target average RPS (paper Fig. 9
        sweeps injected RPS) by time-compressing the arrival process."""
        f = self.rps / target_rps
        reqs = [
            TraceRequest(r.req_id, r.tier, r.arrival_s * f, r.prompt_len,
                         r.output_len, r.tenant_id)
            for r in self.requests
        ]
        faults = tuple(
            FaultEvent(ev.t_s * f, ev.kind, ev.chips, ev.duration_s * f,
                       ev.slowdown, ev.seed, ev.domain, ev.wave)
            for ev in self.faults
        )
        return Workload(
            f"{self.name}@{target_rps:.1f}rps", reqs, self.horizon_s * f,
            faults, self.topology,
        )


def bursty_arrivals(
    rng: np.random.RandomState,
    mean_rps: float,
    horizon_s: float,
    burstiness: float = 0.6,
    micro_burst_rate: float = 0.02,
    micro_burst_size: int = 8,
    envelope: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Cox-process arrival times with minute-scale modulation + micro-bursts.

    ``envelope`` is an optional deterministic rate-multiplier series (one
    value per 1-second bin; resampled if its length differs) composed on
    top of the stochastic log-AR(1) modulation — this is how scenario
    generators impose diurnal cycles, flash crowds, and tier-mix drift
    (traces/scenarios.py). The product is renormalized so the *realized*
    mean rate stays ``mean_rps`` regardless of the envelope's shape.
    """
    dt = 1.0
    n_bins = int(horizon_s / dt)
    # slow modulation: log-AR(1)
    log_rate = np.zeros(n_bins)
    rho = 0.98
    sigma = burstiness * np.sqrt(1 - rho**2)
    for i in range(1, n_bins):
        log_rate[i] = rho * log_rate[i - 1] + rng.normal(0, sigma)
    rate = np.exp(log_rate)
    env_n = None
    if envelope is not None:
        env = np.asarray(envelope, dtype=float)
        if len(env) != n_bins:
            env = np.interp(
                np.linspace(0.0, 1.0, n_bins),
                np.linspace(0.0, 1.0, max(len(env), 2)),
                env if len(env) >= 2 else np.repeat(env, 2),
            )
        env = np.clip(env, 0.0, None)
        if env.mean() <= 0:
            return np.zeros(0)
        env_n = env / env.mean()  # mean-1 multiplier (also gates bursts)
        rate *= env_n
    mean = rate.mean()
    if mean <= 0:
        return np.zeros(0)
    rate *= mean_rps / mean  # normalize realized mean to the target
    arrivals: List[float] = []
    for i in range(n_bins):
        n = rng.poisson(rate[i] * dt)
        arrivals.extend(i * dt + rng.uniform(0, dt, size=n))
        # synchronized burst; micro-bursts follow the envelope (a silent
        # phase window must not emit bursts), drawn unconditionally so the
        # rng stream — hence every envelope-free seed trace — is unchanged
        p_burst = micro_burst_rate * dt * (env_n[i] if env_n is not None else 1.0)
        if rng.uniform() < p_burst:
            t0 = i * dt + rng.uniform(0, dt)
            k = rng.poisson(micro_burst_size)
            arrivals.extend(t0 + rng.exponential(0.3, size=k))
    out = np.sort(np.asarray(arrivals))
    return out[out < horizon_s]


def lognormal_lengths(
    rng: np.random.RandomState, mean: float, n: int, sigma: float = 0.9,
    lo: int = 8, hi: int = 32768,
) -> np.ndarray:
    mu = np.log(mean) - sigma**2 / 2
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(x.astype(int), lo, hi)


def make_workload(
    name: str,
    tier: str,
    mean_rps: float,
    prompt_mean: float,
    output_mean: float,
    horizon_s: float = 600.0,
    seed: int = 0,
    burstiness: float = 0.6,
    req_id_base: int = 0,
    prompt_sigma: float = 0.9,
    prompt_lo: int = 8,
    prompt_hi: int = 32768,
    output_sigma: float = 0.7,
    output_lo: int = 2,
    output_hi: int = 4096,
    envelope: Optional[np.ndarray] = None,
    tenant_id: str = DEFAULT_TENANT,
) -> Workload:
    rng = np.random.RandomState(seed)
    t = bursty_arrivals(rng, mean_rps, horizon_s, burstiness, envelope=envelope)
    pl = lognormal_lengths(
        rng, prompt_mean, len(t), sigma=prompt_sigma, lo=prompt_lo, hi=prompt_hi
    )
    ol = lognormal_lengths(
        rng, output_mean, len(t), sigma=output_sigma, lo=output_lo, hi=output_hi
    )
    reqs = [
        TraceRequest(req_id_base + i, tier, float(t[i]), int(pl[i]), int(ol[i]),
                     tenant_id)
        for i in range(len(t))
    ]
    return Workload(name, reqs, horizon_s)


def merge_workloads(name: str, *wls: Workload) -> Workload:
    reqs = sorted(
        (r for w in wls for r in w.requests), key=lambda r: r.arrival_s
    )
    reqs = [
        TraceRequest(i, r.tier, r.arrival_s, r.prompt_len, r.output_len,
                     r.tenant_id)
        for i, r in enumerate(reqs)
    ]
    faults = tuple(
        sorted((ev for w in wls for ev in w.faults), key=lambda ev: ev.t_s)
    )
    topo = next((w.topology for w in wls if w.topology is not None), None)
    return Workload(name, reqs, max(w.horizon_s for w in wls), faults, topo)
