"""The windowed models served across processes, held to the reference engine.

Reduced gemma2-2b (local/global windows of 16, softcap 50, a tied head)
and reduced h2o-danube-1.8b (a sliding window of 16), each given 4 KV heads
so that the engine takes TP 4, on the reference's weights:

  - the reference engine over 4 host devices (at fixed TP 1 and under
    SCHEDULE) and on one device, in a subprocess whose ``XLA_FLAGS`` ask
    for 4 host devices (``python tests/test_torch_windowed_multidev.py
    reference <out.pkl>``);
  - the port's engine over a pool of 4 processes joined by gloo
    (``python -m repro_torch.testing.multidev_checks engine 4 cpu``, the
    weights carried by ``checkpoint.convert``) at fixed TP 1, under
    SCHEDULE and at fixed TP 4.

8 slots, max_len 64, buckets 8/16/32, 10 requests of 4-30 tokens with 24
new tokens each: every request that passes 16 positions wraps its
rotating buffers, and the switches after step 3 reshard wrapped rings.
Held: the greedy tokens of every run equal the reference's (on 4 devices,
fixed and switched, and on one), every step's logits within
``test_torch_windowed.TOL`` (2e-4), no storage tensor moved by a switch
(checked on every rank). And ``multidev_checks migration 4 cpu --model``:
each model's slot cache, its windowed layers' rings of 16 rows beside
gemma2's global layers of 32, resharded TP 1 -> 2 -> 4 -> 1 bit for bit.
"""
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402

from repro_torch.testing.multidev_checks import SCHEDULE, engine_requests  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODELS = ["gemma2-2b", "h2o-danube-1.8b"]
N_POOL = 4
ENGINE = dict(candidate_tps=(1, 2, 4), n_slots=8, max_len=64, prefill_buckets=(8, 16, 32))
TOL = dict(rtol=2e-4, atol=2e-4)  # test_torch_windowed's
WINDOW = 16  # reduced()'s


def _jcfg(name):
    return replace(j_reduced(j_get_config(name)), num_kv_heads=4)


def _served(eng, requests, schedule=None) -> dict:
    eng.logit_trace = {}
    done = eng.run(requests, switch_schedule=schedule)
    return {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
            "logits": {k: np.stack([np.asarray(x) for x in v]) for k, v in eng.logit_trace.items()}}


def _reference(out):
    """Each model's reference engine over 4 host devices at fixed TP 1 and
    under SCHEDULE, and on one device; the weights, tokens and logits to
    ``out`` (pickle)."""
    from repro.serving.engine import EngineConfig, ServingEngine
    from repro.serving.request import Request

    assert len(jax.devices()) >= N_POOL, jax.devices()
    res = {}
    for name in MODELS:
        jcfg = _jcfg(name)
        params = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)
        econf = EngineConfig(**ENGINE, dtype=jnp.float32, record_logits=True)
        eng = ServingEngine(jcfg, params, devices=jax.devices()[:N_POOL], econf=econf)
        assert eng.tps == [1, 2, 4]
        rec = {"params": jax.tree_util.tree_map(np.asarray, params),
               "fixed": _served(eng, engine_requests(Request)),
               "switch": _served(eng, engine_requests(Request), SCHEDULE)}
        assert eng.stats.switches == len(SCHEDULE)
        eng = ServingEngine(jcfg, params, devices=jax.devices()[:1],
                            econf=replace(econf, candidate_tps=(1,)))
        rec["one_device"] = _served(eng, engine_requests(Request))
        res[name] = rec
        print(f"{name}: reference served")
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("OK reference")


def _port(tmp: Path, params: dict) -> subprocess.Popen:
    """The port's engine check over 4 gloo processes, started: per model a
    case at fixed TP 1 and under SCHEDULE (``fixed``) and one at fixed TP 4."""
    cases = {}
    for name in MODELS:
        cases[name] = {"model": name, "params": params[name], "engine": ENGINE}
        cases[f"{name} TP 4"] = {"model": name, "params": params[name], "engine": {**ENGINE, "candidate_tps": (4,)},
                                 "fixed": False, "schedule": {}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"engine": {"cases": cases}}, f)
    return subprocess.Popen([sys.executable, "-m", "repro_torch.testing.multidev_checks", "engine", str(N_POOL), "cpu",
                             "--inputs", str(tmp / "inputs.pkl"), "--out", str(tmp / "port.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))


def _params() -> dict:
    """The reference's weights of each model, drawn here as the reference
    subprocess draws them (seed 0), as numpy trees."""
    out = {}
    for name in MODELS:
        jcfg = _jcfg(name)
        out[name] = jax.tree_util.tree_map(np.asarray, j_init_params(
            j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32))
    return out


def _migration(tmp: Path, name: str) -> subprocess.Popen:
    """``multidev_checks migration 4 cpu --model name``, started."""
    return subprocess.Popen([sys.executable, "-m", "repro_torch.testing.multidev_checks", "migration", str(N_POOL),
                             "cpu", "--model", name, "--out", str(tmp / f"migration {name}.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"reference": its runs, "port": each rank's engine results,
    "migration <model>": each rank's reshards}: the reference subprocess,
    the port's engine pool and its migration pools run side by side."""
    tmp = tmp_path_factory.mktemp("windowed_multidev")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}")
    params = _params()
    procs = {"reference": subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "reference",
                                            str(tmp / "reference.pkl")],
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
             "port": _port(tmp, params)}
    procs.update({f"migration {name}": _migration(tmp, name) for name in MODELS})
    outs = {}
    for what, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=400)
        ok = {"reference": "OK reference", "port": "OK engine"}.get(what, "OK migration")
        assert proc.returncode == 0 and ok in stdout, f"{what} failed:\n{stdout}\n{stderr}"
        with open(tmp / f"{what}.pkl", "rb") as f:
            outs[what] = pickle.load(f)
    for name in MODELS:  # both sides drew the same weights
        for a, b in zip(jax.tree_util.tree_leaves(outs["reference"][name]["params"]),
                        jax.tree_util.tree_leaves(params[name])):
            assert np.array_equal(a, b)
    for what in procs:
        if what != "reference":
            assert len(outs[what]) == N_POOL
    return outs


@pytest.mark.parametrize("run", ["fixed TP 1", "switch schedule", "fixed TP 4"])
@pytest.mark.parametrize("name", MODELS)
def test_windowed_engine_across_processes_matches_reference(served, name, run):
    """On every rank: the port's greedy tokens equal the reference engine's
    on 4 devices (fixed and switched) and on one device, and each step's
    logits lie within TOL of the reference's at fixed TP 1 on 4 devices
    (and under the schedule, of its switched run's); the ranks agree."""
    want, ranks = served["reference"][name], [rank["engine"] for rank in served["port"]]
    assert want["fixed"]["tokens"] == want["switch"]["tokens"] == want["one_device"]["tokens"]
    assert max(len(t) for t in want["fixed"]["tokens"].values()) == 24
    case = name if run != "fixed TP 4" else f"{name} TP 4"
    for r in ranks:
        summary, arrays = r["summary"][case], r["arrays"][case]
        # a case's summary is of its switch run, whose tokens the check held to its fixed run's
        assert summary["switches"] == (0 if run == "fixed TP 4" else len(SCHEDULE))
        assert summary["tps"] == ([4] if run == "fixed TP 4" else [1, 2, 4])
        key = "logits_fixed" if run == "fixed TP 1" else "logits_switched"
        assert arrays["trajectories"] == want["fixed"]["tokens"]
        got, against = arrays[key], want["switch" if run == "switch schedule" else "fixed"]["logits"]
        assert sorted(got) == sorted(against)
        for rid, steps in against.items():
            assert got[rid].shape == steps.shape
            np.testing.assert_allclose(got[rid], steps, **TOL, err_msg=f"{case} {key} request {rid}")
    for r in ranks[1:]:
        assert r["arrays"][case]["trajectories"] == ranks[0]["arrays"][case]["trajectories"]


@pytest.mark.parametrize("name", MODELS)
def test_windowed_cache_reshard_across_processes_is_bit_identical(served, name):
    """The slot cache of 8 slots at max_len 32 (each windowed layer's ring
    of 16 rows, gemma2's global layers of 32) resharded TP 1 -> 2 -> 4 -> 1
    over 4 processes: every block bit for bit and the source untouched
    (checked on every rank), the rows of every layer kept."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import layer_windows

    rows = [32 if w is None else min(w, 32) for w in layer_windows(reduced(get_config(name)))]
    assert WINDOW in rows
    for rank in served[f"migration {name}"]:
        steps = rank["migration"]["summary"]["reshards"]
        assert [(s["from"], s["to"]) for s in steps] == [(1, 2), (2, 4), (4, 1)]
        for s in steps:
            assert s["rows"] == rows and s["bytes_between_ranks"] > 0


if __name__ == "__main__":
    {"reference": lambda: _reference(sys.argv[2])}[sys.argv[1]]()
