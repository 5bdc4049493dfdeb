"""The port's schedulers and incident analysis (repro_torch.serving.
{global_scheduler, admission, local_scheduler}, repro_torch.core.incidents)
against the reference's.

Each test drives both packages through the same seeded sequence of
operations (drawn once with numpy) and compares every decision and the
state after it. Both packages run the same float arithmetic in the same
order, so the tolerance is exact everywhere.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import incidents as R_inc  # noqa: E402  (repro.core pulls in jax; fine in a test)
from repro.serving import admission as R_adm  # noqa: E402
from repro.serving import global_scheduler as R_gs  # noqa: E402
from repro.serving import local_scheduler as R_ls  # noqa: E402
from repro.traces import scenarios as R_scen  # noqa: E402
from repro_torch.core import incidents as P_inc  # noqa: E402
from repro_torch.serving import admission as P_adm  # noqa: E402
from repro_torch.serving import global_scheduler as P_gs  # noqa: E402
from repro_torch.serving import local_scheduler as P_ls  # noqa: E402
from repro_torch.traces import scenarios as P_scen  # noqa: E402

TIERS = ("strict", "relaxed", "batch")
STAGES = ("prefill", "decode", "mixed")
TENANTS = ("default", "tenant_a", "tenant_b", "mallory")


def handles(gs, rng, n, gid0=0):
    out = []
    for g in range(gid0, gid0 + n):
        tier = (None, *TIERS[:2])[rng.randint(3)]
        h = gs.GroupHandle(
            g, tier, STAGES[rng.randint(3)], int(2 ** rng.randint(4)), float(rng.uniform(0.5, 6.0)),
            accepts_background=bool(rng.rand() < 0.7), queue_len=int(rng.randint(5)),
        )
        h.kv_free_frac = float(rng.choice([0.0, 0.3, 1.0]))
        h.kv_stamp_s = float(rng.uniform(0.0, 2.0))
        out.append(h)
    return out


def state(sched):
    return sorted(
        (g.gid, g.committed_rps, g.alive, g.queue_len, g.kv_free_frac) for g in sched.groups.values()
    )


def drive(gs, seed, sharded=None, n_ops=400, kv_stale_s=math.inf):
    """Apply one seeded operation sequence to a fresh scheduler of package
    ``gs``; returns every decision and the handle table after each op."""
    rng = np.random.RandomState(seed)
    groups = handles(gs, rng, 10)
    if sharded is None:
        sched = gs.GlobalScheduler(groups, kv_stale_s=kv_stale_s)
    else:
        sched = gs.ShardedScheduler(groups, kv_stale_s=kv_stale_s, seed=seed, **sharded)
    log, outstanding, now, next_gid = [], [], 0.0, 10
    for _ in range(n_ops):
        now += float(rng.exponential(0.05))
        op = rng.randint(100)
        if op < 40:
            tier, cost, bg = TIERS[rng.randint(3)], float(rng.uniform(0.01, 1.5)), bool(rng.rand() < 0.1)
            tenant = TENANTS[rng.randint(4)]
            k = gs.tenant_key(tenant, int(rng.randint(10_000)))
            g, ok = sched.dispatch(tier, cost, bg, now=now, key=k)
            log.append(("dispatch", g.gid, ok, k))
            if ok and not bg:
                outstanding.append((g.gid, cost))
        elif op < 60:
            n = int(rng.randint(1, 12))
            items = [(TIERS[rng.randint(3)], float(rng.uniform(0.01, 1.5)), bool(rng.rand() < 0.1)) for _ in range(n)]
            keys = [int(x) for x in rng.randint(0, 10_000, size=n)]
            picks = sched.dispatch_batch(items, now=now, keys=keys)
            log.append(("batch", [(g.gid, ok) for g, ok in picks]))
            outstanding += [(g.gid, it[1]) for (g, ok), it in zip(picks, items) if ok and not it[2]]
        elif op < 75 and outstanding:
            gid, cost = outstanding.pop(int(rng.randint(len(outstanding))))
            sched.complete(gid, cost)
            log.append(("complete", gid))
        elif op < 85:
            for g in sched.groups.values():
                g.queue_len = int(rng.randint(6))
                g.kv_free_frac = float(rng.choice([0.0, 0.5, 1.0]))
                g.kv_stamp_s = now - float(rng.uniform(0.0, 1.0))
            log.append(("sync",))
        elif op < 90:
            gid = int(rng.randint(next_gid))
            sched.mark_dead(gid)
            log.append(("dead", gid))
        elif op < 95:
            keep = [g for g in sched.groups.values() if rng.rand() < 0.8]
            fresh = [gs.GroupHandle(g.gid, g.tier, g.stage, g.tp, g.max_rps, queue_len=g.queue_len) for g in keep]
            fresh += handles(gs, rng, int(rng.randint(1, 4)), next_gid)
            next_gid += len(fresh) - len(keep)
            sched.replace_groups(fresh)
            log.append(("replace", sorted(sched.groups)))
        else:
            t = sched.decode_target(TIERS[rng.randint(3)])
            log.append(("decode_target", None if t is None else t.gid))
        log.append(state(sched))
    return log


@pytest.mark.parametrize("kv_stale_s", (math.inf, 0.3))
@pytest.mark.parametrize("seed", range(4))
def test_global_scheduler_matches_reference(seed, kv_stale_s):
    assert drive(P_gs, seed, kv_stale_s=kv_stale_s) == drive(R_gs, seed, kv_stale_s=kv_stale_s)


@pytest.mark.parametrize(
    "sharded",
    (
        {"n_shards": 1},
        {"n_shards": 3, "shard_by": "hash", "reconcile_interval_s": 0.2},
        {"n_shards": 4, "shard_by": "tier", "reconcile_interval_s": 0.0},
        {"n_shards": 2, "shard_by": "hash", "reconcile_interval_s": 1.5},
    ),
    ids=("one", "hash", "tier", "stale"),
)
@pytest.mark.parametrize("seed", range(2))
def test_sharded_scheduler_matches_reference(seed, sharded):
    assert drive(P_gs, seed, sharded) == drive(R_gs, seed, sharded)


def test_tenant_key_and_scheduler_validation_match_reference():
    for t in TENANTS + ("", "ünïcode"):
        assert [P_gs.tenant_key(t, r) for r in (0, 7, 123_456)] == [R_gs.tenant_key(t, r) for r in (0, 7, 123_456)]
    for bad in ({"n_shards": 0}, {"shard_by": "moon"}):
        with pytest.raises(ValueError):
            P_gs.ShardedScheduler([], **bad)
        with pytest.raises(ValueError):
            R_gs.ShardedScheduler([], **bad)
    with pytest.raises(RuntimeError):
        P_gs.GlobalScheduler([]).dispatch_batch([("strict", 1.0, False)])


@pytest.mark.parametrize("seed", range(3))
def test_token_bucket_and_admission_match_reference(seed):
    def run(adm_mod):
        rng = np.random.RandomState(seed)
        out = []
        b = adm_mod.TokenBucket(rate=float(rng.uniform(50, 500)), cap=float(rng.uniform(500, 5000)))
        budgets = {
            "tenant_a": adm_mod.TenantBudget(300.0, 3000.0),
            "mallory": adm_mod.TenantBudget(80.0, 400.0, max_retries=2),
        }
        ctl = adm_mod.AdmissionController(budgets, default_budget=adm_mod.TenantBudget(1000.0, 2000.0, 1)
                                          if seed % 2 else None)
        now = 0.0
        for _ in range(500):
            now += float(rng.exponential(0.2))
            cost = float(rng.lognormal(5.5, 1.0))
            tenant = TENANTS[rng.randint(4)]
            out.append((b.try_take(cost, now), b.delay_for(cost, now), b.tokens, b.t))
            out.append((ctl.try_admit(tenant, cost, now), ctl.retry_delay_s(tenant, cost, now),
                        ctl.max_retries(tenant)))
        return out

    assert run(P_adm) == run(R_adm)


def test_budgets_from_spec_match_reference():
    for flood in (1.0, 5.0):
        for kw in ({}, {"headroom": 1.5, "burst_s": 3.0, "max_retries": 5}):
            got = P_adm.budgets_from_spec(P_scen.noisy_neighbor_spec(flood), **kw)
            want = R_adm.budgets_from_spec(R_scen.noisy_neighbor_spec(flood), **kw)
            assert {t: (b.tokens_per_s, b.burst_tokens, b.max_retries) for t, b in got.items()} == {
                t: (b.tokens_per_s, b.burst_tokens, b.max_retries) for t, b in want.items()
            }
    assert P_adm.budgets_from_spec(P_scen.get_scenario("diurnal")) == {}


@pytest.mark.parametrize("seed", range(3))
def test_local_scheduler_matches_reference(seed):
    def run(ls_mod):
        rng = np.random.RandomState(seed)
        s = ls_mod.LocalScheduler(batch_cap=int(rng.randint(1, 9)))
        running, out = [], []
        for i in range(300):
            if rng.rand() < 0.6:
                s.enqueue(i, feasible=bool(rng.rand() < 0.7), background=bool(rng.rand() < 0.15))
            else:
                batch = s.form_batch(running)
                running = [x for x in batch if rng.rand() < 0.6]
                out.append((batch, len(s)))
            out.append((list(s.feasible), list(s.best_effort), list(s.background)))
        return out

    assert run(P_ls) == run(R_ls)


def series(rng, n=600, faults=((120.0, 0.5, 40.0), (300.0, 0.8, 20.0), (330.0, 0.3, 90.0))):
    t = np.arange(n, dtype=float)
    v = 20.0 + rng.normal(0.0, 1.5, size=n)
    for t0, depth, width in faults:
        hit = (t >= t0) & (t < t0 + width)
        v[hit] *= 1.0 - depth * (1.0 - (t[hit] - t0) / width)
    return list(zip(t.tolist(), np.clip(v, 0.0, None).tolist()))


@pytest.mark.parametrize("seed", range(3))
def test_analyze_incidents_matches_reference(seed):
    rng = np.random.RandomState(seed)
    tl = series(rng)
    tier_tl = {"strict": [(t, 0.4 * v) for t, v in tl], "relaxed": [(t, 0.6 * v) for t, v in tl],
               "short": tl[:10]}
    log = [{"t": 120.0, "kind": "chip_loss", "victims": [1, 2]}, {"t": 300.0, "kind": "host_loss"},
           {"t": 310.0, "kind": "straggler_end"}, {"t": 330.0, "kind": "kv_loss"},
           {"t": 599.5, "kind": "straggler"}]
    for kw in ({}, {"baseline_window_s": 30.0, "smooth_s": 1.0, "recover_frac": 0.9, "sustain_s": 10.0},
               {"sustain_s": 200.0}):
        got = P_inc.analyze_incidents(tl, tier_tl, log, 600.0, **kw)
        want = R_inc.analyze_incidents(tl, tier_tl, log, 600.0, **kw)
        assert got == want and len(got) == 4
    assert P_inc.analyze_incidents([], {}, log, 600.0) == R_inc.analyze_incidents([], {}, log, 600.0) == []
    for t0, bar in ((120.0, 18.0), (300.0, 19.5), (590.0, 25.0), (700.0, 10.0)):
        for kw in ({}, {"smooth_s": 1.0, "sustain_s": 5.0}):
            assert P_inc.time_to_recover_at(tl, t0, bar, **kw) == R_inc.time_to_recover_at(tl, t0, bar, **kw)
