"""``profile_engine`` over a pool of processes against the reference's.

The port's ``profiles.profiler.profile_engine`` over ``ServingEngine(pool=
...)`` on 2 gloo processes (``multidev_checks profile 2 cpu``: reduced
llama3-8b with 4 KV heads, 8 slots, decode batches (1, 4, 8) at ctx 64,
buckets 16/32), against the reference's ``profile_engine`` over its
engine on 2 XLA host devices (``python tests/test_torch_profiles_multidev.py
reference <out.pkl>``, a subprocess: its device count is set before jax
starts): every rank returns the same table (each key the slowest rank's
time), and its keys are the reference's. The table four H100s gave loads
the same in both packages.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(candidate_tps=(1, 2, 4, 8), n_slots=8, max_len=96, prefill_buckets=(16, 32))
BATCHES, CTXS = (1, 4, 8), (64,)


def _reference(out: str) -> None:
    """The reference engine's profile keys on 2 host devices."""
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config, reduced
    from repro.models import model_param_defs
    from repro.models.params import init_params
    from repro.parallel.sharding import make_exec_config
    from repro.profiles.profiler import profile_engine
    from repro.serving.engine import EngineConfig, ServingEngine

    assert len(jax.devices()) >= 2, jax.devices()
    cfg = replace(reduced(get_config("llama3-8b")), num_kv_heads=4)
    params = init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), jax.random.PRNGKey(0), jnp.float32)
    eng = ServingEngine(cfg, params, devices=jax.devices()[:2], econf=EngineConfig(**ENGINE_KW, dtype=jnp.float32))
    table = profile_engine(eng, batches=BATCHES, ctxs=CTXS)
    with open(out, "wb") as f:
        pickle.dump({"decode": sorted(table.decode_s), "prefill": sorted(table.prefill_s)}, f)
    print("OK reference")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's keys and each rank's table, the two started together."""
    tmp = tmp_path_factory.mktemp("profile")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "reference", str(tmp / "ref.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu")),
        "pool": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.multidev_checks", "profile", "2", "cpu",
             "--out", str(tmp / "out.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
    }
    failed = []
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        ok = "OK reference" if name == "reference" else "OK profile"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "out.pkl", "rb") as f:
        tables = [r["profile"]["table"] for r in pickle.load(f)]
    return ref, tables


def test_every_rank_gets_the_same_table(runs):
    _, tables = runs
    assert len(tables) == 2 and tables[0] == tables[1]
    assert all(row[-1] > 0 for kind in ("decode", "prefill") for row in tables[0][kind])


def test_pool_table_keys_are_the_reference_engines(runs):
    """TP 1 and 2 (the levels 2 devices run), batches 1/4/8 of 8 slots at
    ctx 64, buckets 16 and 32: the reference's keys on 2 host devices."""
    ref, tables = runs
    assert sorted(tuple(row[:-1]) for row in tables[0]["decode"]) == [tuple(k) for k in ref["decode"]]
    assert sorted(tuple(row[:-1]) for row in tables[0]["prefill"]) == [tuple(k) for k in ref["prefill"]]
    assert {k[0] for k in ref["decode"]} == {1, 2}


def test_four_card_table_loads_in_both_packages():
    """The table ``multicard``'s profile_pool measured on four H100s
    (``profiles/tables/llama3-8b_h100x4.json``): TP 1, 2 and 4 rows of
    decode (batches 1/4/8 at ctx 64) and prefill (32/64/128), loaded the
    same by both packages; and a tabulated model of it answers TP 2 and 4
    from its rows, not the analytic fallback."""
    from repro.profiles.profiler import ProfileTable as JProfileTable
    from repro_torch.configs import get_config
    from repro_torch.profiles.perf_model import H100, clear_perf_caches
    from repro_torch.profiles.profiler import ProfileTable, TabulatedPerfModel

    path = ROOT / "src" / "repro_torch" / "profiles" / "tables" / "llama3-8b_h100x4.json"
    got, want = ProfileTable.load(str(path)), JProfileTable.load(str(path))
    assert got.decode_s == want.decode_s and got.prefill_s == want.prefill_s
    assert set(got.decode_s) == {(tp, b, 64) for tp in (1, 2, 4) for b in (1, 4, 8)}
    assert set(got.prefill_s) == {(tp, L) for tp in (1, 2, 4) for L in (32, 64, 128)}
    clear_perf_caches()
    perf = TabulatedPerfModel(get_config("llama3-8b"), got, hw=H100)
    for tp in (2, 4):
        assert perf.decode_step_time_s(8, 64, tp) == got.decode_s[(tp, 8, 64)]
        assert perf.prefill_time_s(128, tp) == got.prefill_s[(tp, 128)]
    clear_perf_caches()


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
