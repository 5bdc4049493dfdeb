"""Incident analysis: recovery metrics from per-second goodput timelines
(mirrors repro/core/incidents.py).

Turns a replay's fault log plus its (t, SLO-good finishes per second)
series into the per-incident metrics the robustness evaluation reports
(docs/faults.md §Metrics):

  * ``baseline_goodput`` — mean goodput over the window before the fault;
  * ``dip_depth`` / ``dip_frac`` — how far below baseline the smoothed
    goodput falls after the fault;
  * ``dip_width_s`` — total time the smoothed goodput spends below the
    recovery threshold (``recover_frac`` × baseline) inside the incident
    window;
  * ``time_to_recover_s`` — first time after the dip begins at which the
    smoothed goodput is back above the threshold and **stays above it for
    ``sustain_s`` seconds** (clipped at the window end). This is the
    operational SRE definition — stable above threshold for a sustain
    window — and it is deliberately NOT "the last below-threshold
    excursion": the arrival process carries minute-scale rate modulation
    (Cox/log-AR(1)), so on a saturated pool an arrival lull minutes after
    real recovery dips measured goodput below threshold again; chasing
    the last excursion turns the metric into arrival-noise roulette.
    ``censored`` is True when no sustained recovery happens before the
    replay ends or the next fault fires — the value then lower-bounds the
    true recovery time at the window length. When the NEXT fault fires
    inside this incident's sustain window, a run cut short by it does
    not count as sustained: overlapping cascades would otherwise
    attribute the moment before the second hit as "recovery" from the
    first (the clip-at-end shortcut is only valid at the end of
    observation, where no later event can contradict the run);
  * ``slo_damage`` — per-tier count of requests denied their SLO relative
    to the pre-fault trend: baseline tier rate × window − realized good
    finishes, clamped at zero. This is deadline-slack damage in request
    units, directly comparable across policies on the same trace.

Smoothing is a centered moving mean over ``smooth_s`` seconds: per-second
goodput counts on a saturated pool are noisy (±10% Poisson jitter), and an
unsmoothed minimum would report dips that are pure arrival noise.

Every incident window runs from the fault's fire time to the next fault
(or the end of the series), so composed scenarios (incident_replay's
double failure + recovery storm) attribute each dip to the fault that
caused it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Timeline = Sequence[Tuple[float, float]]


def _smooth(values: np.ndarray, width: int) -> np.ndarray:
    if width <= 1 or len(values) == 0:
        return values.astype(float)
    kernel = np.ones(width) / width
    # 'same' with edge renormalization: boundary means over fewer samples
    num = np.convolve(values, kernel, mode="same")
    den = np.convolve(np.ones_like(values, dtype=float), kernel, mode="same")
    return num / den


def time_to_recover_at(
    timeline: Timeline,
    t0: float,
    bar: float,
    smooth_s: float = 5.0,
    sustain_s: float = 30.0,
) -> Tuple[float, bool]:
    """Sustained time-to-recover against an EXTERNAL absolute bar.

    ``analyze_incidents`` measures each run against its own pre-fault
    baseline — the right per-run dip accounting, but across systems it
    credits a deeply degraded baseline with a trivially fast "recovery"
    to its own lowered bar. This variant scores the smoothed series
    against a caller-chosen goodput level (the cascade matrix uses
    ``recover_frac`` x the best system's pre-cascade baseline), making
    recovery times comparable across systems whose baselines differ by
    double digits. Same sustain rule: recovered at the first sample at or
    above the bar that starts a run of ``sustain_s`` consecutive
    above-bar samples (clipped at the observation end). Returns
    ``(ttr_s, censored)``; a series that never sustains the bar is
    censored at the observation end (ttr = remaining window)."""
    t = np.asarray([p[0] for p in timeline], dtype=float)
    v = np.asarray([p[1] for p in timeline], dtype=float)
    post = t >= t0
    if not post.any():
        return 0.0, False
    dt = float(np.median(np.diff(t))) if len(t) > 1 else 1.0
    dt = max(dt, 1e-9)
    width = max(int(round(smooth_s / dt)), 1)
    seg = _smooth(v, width)[post]
    seg_t = t[post]
    below = seg < bar
    if not below.any():
        return 0.0, False
    n = len(below)
    sustain = max(int(round(sustain_s / dt)), 1)
    run = np.zeros(n + 1, dtype=int)
    for i in range(n - 1, -1, -1):
        run[i] = 0 if below[i] else run[i + 1] + 1
    need = np.minimum(sustain, n - np.arange(n))
    first_below = int(np.nonzero(below)[0][0])
    cand = np.nonzero((run[:n] >= need) & (np.arange(n) >= first_below))[0]
    if len(cand):
        return float(seg_t[cand[0]] - t0), False
    return float(seg_t[-1] - t0), True


def analyze_incidents(
    timeline: Timeline,
    tier_timelines: Dict[str, Timeline],
    fault_log: List[dict],
    horizon_s: float,
    baseline_window_s: float = 60.0,
    smooth_s: float = 5.0,
    recover_frac: float = 0.95,
    sustain_s: float = 30.0,
) -> List[dict]:
    """One metrics dict per fault-log entry (``straggler_end`` markers are
    skipped — they close an incident rather than open one)."""
    events = [f for f in fault_log if f.get("kind") != "straggler_end"]
    if not events or not timeline:
        return []
    t = np.asarray([p[0] for p in timeline])
    v = np.asarray([p[1] for p in timeline], dtype=float)
    sm = _smooth(v, max(int(round(smooth_s)), 1))
    tier_series = {
        tier: np.asarray([p[1] for p in tl], dtype=float)
        for tier, tl in tier_timelines.items()
        if len(tl) == len(t)
    }
    out: List[dict] = []
    fire_times = [f["t"] for f in events] + [min(horizon_s, float(t[-1]))]
    for j, f in enumerate(events):
        t0, t1 = f["t"], fire_times[j + 1]
        # truncated: this window ends because ANOTHER fault fires, not
        # because observation ends — a sustain run may not clip there
        truncated = j + 1 < len(events)
        if t1 <= t0:
            t1 = float(t[-1])
            truncated = False
        pre = (t >= t0 - baseline_window_s) & (t < t0)
        post = (t >= t0) & (t <= t1)
        inc = dict(f)
        if not pre.any() or not post.any():
            inc.update(baseline_goodput=None)
            out.append(inc)
            continue
        baseline = float(sm[pre].mean())
        seg = sm[post]
        seg_t = t[post]
        thresh = recover_frac * baseline
        below = seg < thresh
        dip_depth = max(baseline - float(seg.min()), 0.0)
        inc["baseline_goodput"] = baseline
        inc["dip_depth"] = dip_depth
        inc["dip_frac"] = dip_depth / baseline if baseline > 0 else 0.0
        inc["dip_width_s"] = float(below.sum())  # 1-second samples
        if not below.any():
            inc["time_to_recover_s"] = 0.0
            inc["censored"] = False
        else:
            # recovered = first post-dip sample that starts a run of
            # >= sustain_s consecutive above-threshold samples (run
            # clipped at the window end). run[i] = consecutive above-
            # threshold samples starting at i.
            n = len(below)
            sustain = max(int(round(sustain_s)), 1)
            run = np.zeros(n + 1, dtype=int)
            for i in range(n - 1, -1, -1):
                run[i] = 0 if below[i] else run[i + 1] + 1
            if truncated:
                # the next incident fires inside this window: only a FULL
                # sustain run before it proves recovery — anything shorter
                # is censored, not credited to the moment before the
                # second hit (the overlapping-cascade misattribution bug)
                need = np.full(n, sustain)
            else:
                need = np.minimum(sustain, n - np.arange(n))
            first_below = int(np.nonzero(below)[0][0])
            cand = np.nonzero(
                (run[:n] >= need) & (np.arange(n) >= first_below)
            )[0]
            if len(cand):
                inc["time_to_recover_s"] = float(seg_t[cand[0]] - t0)
                inc["censored"] = False
            else:
                inc["time_to_recover_s"] = float(t1 - t0)
                inc["censored"] = True
        damage: Dict[str, float] = {}
        wlen = float(t1 - t0)
        for tier, series in tier_series.items():
            base_rate = float(series[pre].mean())
            got = float(series[post].sum())
            damage[tier] = max(base_rate * wlen - got, 0.0)
        inc["slo_damage"] = damage
        out.append(inc)
    return out
