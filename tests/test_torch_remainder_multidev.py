"""The last five served models across processes, held to the reference engine.

yi-34b, chameleon-34b, musicgen-large, mistral-large-123b and dbrx-132b,
each ``reduced()`` with 4 KV heads (8 for musicgen's MHA) and the fields of
``multidev_checks.ENGINE_FIELDS`` over it, which keep the published shape
at CPU width: yi 28 heads over 4 KV heads (G 7), mistral 48 (G 12), dbrx 24
(G 6) with 16 experts, top 4 (d_ff_expert 64, capacity factor 8.0),
musicgen 8 heads over 8 KV heads, chameleon's qk-norm with its q_norm and
k_norm drawn N(0, 0.5) (the reference draws them as zeros, a scale of 1 + 0
under which a wrong scale would not show). On the reference's weights:

  - the reference engine over 4 host devices (at fixed TP 1 and under
    SCHEDULE) and on one device, a subprocess per model whose
    ``XLA_FLAGS`` ask for 4 host devices (``python
    tests/test_torch_remainder_multidev.py reference <model> <params.pkl>
    <out.pkl>``);
  - the port's engine over a pool of 4 processes joined by gloo, every case
    in one pool (``python -m repro_torch.testing.multidev_checks
    engine,migration 4 cpu``, the weights carried by ``checkpoint.convert``)
    at fixed TP 1, under SCHEDULE and at fixed TP 4.

Held: the greedy tokens of every run equal the reference's (on 4 devices,
fixed and switched, and on one), every step's logits within
``test_torch_windowed.TOL`` (2e-4), no storage tensor moved by a switch
(checked on every rank), dbrx's drops per (TP level, stage) equal to the
reference's (none: at capacity factor 8.0 its capacity is at least the
tokens of every group), and each model's slot cache resharded TP 1 -> 2 ->
4 -> 1 bit for bit (``check_migration`` on the same configs).
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

from repro_torch.testing.multicard import QK_NORM_STD  # noqa: E402
from repro_torch.testing.multidev_checks import ENGINE_FIELDS, SCHEDULE, engine_requests, with_fields  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODELS = ["yi-34b", "chameleon-34b", "musicgen-large", "mistral-large-123b", "dbrx-132b"]
N_POOL = 4
ENGINE = dict(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32))
TOL = dict(rtol=2e-4, atol=2e-4)  # test_torch_windowed's


def _jcfg(name):
    """The reference's config of ``engine_cfg(name)``."""
    return with_fields(replace(j_reduced(j_get_config(name)), num_kv_heads=4), ENGINE_FIELDS.get(name, {}))


def _qk_norm_drawn(tree: dict, rng: np.random.RandomState) -> dict:
    """``tree`` with every q_norm and k_norm drawn N(0, QK_NORM_STD), in key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _qk_norm_drawn(v, rng)
        elif k in ("q_norm", "k_norm"):
            out[k] = rng.normal(0.0, QK_NORM_STD, size=v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


def _params(name) -> dict:
    """The reference's weights (seed 0) as a numpy tree; a qk-norm model's
    scales drawn nonzero from seed 1."""
    jcfg = _jcfg(name)
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)),
                                                            jax.random.PRNGKey(0), jnp.float32))
    return _qk_norm_drawn(tree, np.random.RandomState(1)) if jcfg.attn.qk_norm else tree


def _served(eng, requests, schedule=None) -> dict:
    eng.logit_trace = {}
    done = eng.run(requests, switch_schedule=schedule)
    return {"tokens": {r.req_id: list(map(int, r.generated)) for r in done},
            "logits": {k: np.stack([np.asarray(x) for x in v]) for k, v in eng.logit_trace.items()}}


def _reference(name, params_path, out):
    """The reference engine over 4 host devices at fixed TP 1 and under
    SCHEDULE, and on one device, on the weights in ``params_path``; tokens
    and logits to ``out`` (pickle)."""
    from repro.serving.engine import EngineConfig, ServingEngine
    from repro.serving.request import Request

    assert len(jax.devices()) >= N_POOL, jax.devices()
    with open(params_path, "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f))
    jcfg = _jcfg(name)
    econf = EngineConfig(**ENGINE, dtype=jnp.float32, record_logits=True)
    eng = ServingEngine(jcfg, params, devices=jax.devices()[:N_POOL], econf=econf)
    assert eng.tps == [1, 2, 4]
    rec = {"fixed": _served(eng, engine_requests(Request)),
           "switch": _served(eng, engine_requests(Request), SCHEDULE)}
    assert eng.stats.switches == len(SCHEDULE)
    eng = ServingEngine(jcfg, params, devices=jax.devices()[:1], econf=replace(econf, candidate_tps=(1,)))
    rec["one_device"] = _served(eng, engine_requests(Request))
    with open(out, "wb") as f:
        pickle.dump(rec, f)
    print(f"OK reference {name}")


def _port(tmp: Path, params: dict) -> subprocess.Popen:
    """The port's engine and migration checks over 4 gloo processes, one
    pool, started: per model an engine case at fixed TP 1 and under
    SCHEDULE (``fixed``), one at fixed TP 4, and a migration case."""
    cases = {}
    for name in MODELS:
        cases[name] = {"model": name, "params": params[name], "engine": ENGINE}
        cases[f"{name} TP 4"] = {"model": name, "params": params[name], "engine": {**ENGINE, "candidate_tps": (4,)},
                                 "fixed": False, "schedule": {}}
    inputs = {"engine": {"cases": cases}, "migration": {"cases": {name: {"model": name} for name in MODELS}}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    return subprocess.Popen([sys.executable, "-m", "repro_torch.testing.multidev_checks", "engine,migration",
                             str(N_POOL), "cpu", "--inputs", str(tmp / "inputs.pkl"), "--out", str(tmp / "port.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{"reference": {model: its runs}, "port": each rank's engine and
    migration results}: a reference subprocess per model and the port's
    pool run side by side."""
    tmp = tmp_path_factory.mktemp("remainder_multidev")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}")
    params = {name: _params(name) for name in MODELS}
    procs = {"port": _port(tmp, params)}
    for name in MODELS:
        with open(tmp / f"params {name}.pkl", "wb") as f:
            pickle.dump(params[name], f)
        procs[name] = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "reference", name,
                                        str(tmp / f"params {name}.pkl"), str(tmp / f"{name}.pkl")],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    outs = {}
    for what, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=400)
        ok = "OK engine" if what == "port" else f"OK reference {what}"
        assert proc.returncode == 0 and ok in stdout, f"{what} failed:\n{stdout}\n{stderr}"
        with open(tmp / f"{what}.pkl", "rb") as f:
            outs[what] = pickle.load(f)
    assert len(outs["port"]) == N_POOL
    return {"reference": {name: outs[name] for name in MODELS}, "port": outs["port"]}


@pytest.mark.parametrize("name", MODELS)
def test_remainder_configs_keep_the_published_shape(name):
    """The port's ``engine_cfg`` is the reference's config field by field;
    it keeps the published model's query heads a KV head (but chameleon's,
    whose 4 heads meet 4 KV heads) and dbrx's experts; chameleon keeps its
    qk-norm, and the drawn scales are nonzero."""
    from repro_torch.testing.multidev_checks import engine_cfg

    cfg, jcfg, full = engine_cfg(name), _jcfg(name), j_get_config(name)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.attn) == vars(jcfg.attn)
    assert (cfg.moe is None) == (jcfg.moe is None) and (cfg.moe is None or vars(cfg.moe) == vars(jcfg.moe))
    assert cfg.num_kv_heads % N_POOL == 0
    if name == "chameleon-34b":
        assert cfg.attn.qk_norm
        leaves = [v for path, v in jax.tree_util.tree_flatten_with_path(_params(name))[0]
                  if str(path[-1].key) in ("q_norm", "k_norm")]
        assert len(leaves) == 2 and all(np.abs(v).min() > 0 for v in leaves)
    else:
        assert cfg.num_heads // cfg.num_kv_heads == full.num_heads // full.num_kv_heads
    if name == "dbrx-132b":
        assert (cfg.moe.num_experts, cfg.moe.top_k) == (full.moe.num_experts, full.moe.top_k) == (16, 4)
        assert cfg.moe.capacity_factor == 8.0


@pytest.mark.parametrize("run", ["fixed TP 1", "switch schedule", "fixed TP 4"])
@pytest.mark.parametrize("name", MODELS)
def test_remainder_engine_across_processes_matches_reference(served, name, run):
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


@pytest.mark.parametrize("case", ["dbrx-132b", "dbrx-132b TP 4"])
def test_dbrx_drops_across_processes_equal_the_reference(served, case):
    """dbrx's dropped assignments per (TP level, stage), counted on every
    rank in each run of the case (fixed TP 1 and the switch schedule, or
    fixed TP 4), equal the reference's: none, since at capacity factor
    8.0, 16 experts and top 4 the reference's capacity (``_capacity``) of a
    group of T tokens is at least T, and a token sends an expert one
    assignment at most."""
    from repro.models.moe import _capacity

    m = _jcfg("dbrx-132b").moe
    most = ENGINE["n_slots"] * max(ENGINE["prefill_buckets"])  # the largest group any stage dispatches
    assert all(_capacity(T, m) >= T for T in range(1, most + 1))
    runs, tps = (["fixed", "switched"], [1, 2, 4]) if case == "dbrx-132b" else (["switched"], [4])
    want = {run: {f"{tp}/{stage}": 0 for tp in tps for stage in ("prefill", "decode")} for run in runs}
    for rank in served["port"]:
        assert rank["engine"]["arrays"][case]["moe_dropped"] == want


@pytest.mark.parametrize("name", MODELS)
def test_remainder_cache_reshard_across_processes_is_bit_identical(served, name):
    """The slot cache of 8 slots at max_len 32 resharded TP 1 -> 2 -> 4 ->
    1 over 4 processes: every block bit for bit and the source untouched
    (``check_migration`` raises otherwise, on every rank), K/V moved
    between ranks at every step, each layer's 32 rows kept and its KV heads
    split by the level."""
    from repro_torch.testing.multidev_checks import engine_cfg

    cfg = engine_cfg(name)
    for rank in served["port"]:
        steps = rank["migration"]["summary"][name]["reshards"]
        assert [(s["from"], s["to"]) for s in steps] == [(1, 2), (2, 4), (4, 1)]
        for s in steps:
            assert s["rows"] == [32] * cfg.num_layers and s["bytes_between_ranks"] > 0
            assert s["blocks"]["k"][2] == cfg.num_kv_heads // s["to"]


if __name__ == "__main__":
    {"reference": lambda: _reference(sys.argv[2], sys.argv[3], sys.argv[4])}[sys.argv[1]]()
