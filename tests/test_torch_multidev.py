"""The port's multi-device checks across processes, held to the reference.

Each check runs in a subprocess, as tests/test_multidev.py runs the
reference's: ``python -m repro_torch.testing.multidev_checks <check> <n>
cpu``, a pool of n processes joined by gloo, fed the reference's weights and
inputs (numpy, carried by ``checkpoint.convert``). The test computes the
reference's answer from the same numpy inputs in this process (JAX on the
CPU) and holds the port's to it:

  weight_store — world 8: logits at TP 1/2/4/8 within 2e-4 of the
      reference's TP 1 logits; every rank's rebind zero-copy.
  moe_sharded — world 4 on a (data 2, model 2) mesh: y within 5e-4 of the
      reference's moe_apply_local, lb within 5e-2 relative.
  migration — world 8: the cache resharded TP 1 -> 2 -> 4 -> 1 bit for bit,
      and migrate_pages between two ranks' pools bit for bit (exact checks
      made inside the check, on every rank).
  engine — world 4: the reference's config, requests and switch schedule;
      trajectories equal to the reference engine's, every step's logits
      within 2e-4 of its.
  fault_abort — world 8, parts 1 and 2: an injected failure on one rank
      raises on every rank, which rolls back with its cache intact; part 3:
      4 ranks survive, reload and serve at TP 2 within 2e-4 of the
      reference's logits.
  collectives — world 4: the pool's collectives against one process's sums.
  migration on reduced jamba — world 8: K/V, Mamba states and conv tails
      resharded bit for bit, the states split by channel.
  moe_sharded at moonshot's routing width (d_model 2048, 64 experts,
      top-6): the sharded lb equals the reference's sharded lb (computed
      over 4 host devices in a subprocess, ``python
      tests/test_torch_multidev.py lb <out.pkl>``), ~20% from the local one.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.configs.base import AttnSpec as JAttnSpec, ModelConfig as JModelConfig  # noqa: E402
from repro.models import forward as j_forward, model_param_defs as j_param_defs  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.model import logits_for as j_logits_for  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402

from repro_torch.testing.multidev_checks import LB_RTOL, LOGIT_TOL, MOE_TOL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_TINY = dict(name="tiny-dense", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=256)
_SERVE = dict(_TINY, name="tiny-serve", num_kv_heads=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run(tmp_path, check: str, world: int, inputs: dict) -> list:
    """The port's check on a pool of ``world`` processes under gloo; every
    rank's result."""
    src, out = tmp_path / "inputs.pkl", tmp_path / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump({check: inputs}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.testing.multidev_checks", check, str(world), "cpu",
                        "--inputs", str(src), "--out", str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and f"OK {check}" in r.stdout, f"{check} failed:\n{r.stdout}\n{r.stderr}"
    with open(out, "rb") as f:
        ranks = pickle.load(f)
    assert len(ranks) == world
    return [rank[check] for rank in ranks]


def _tiny_params(**over):
    jcfg = JModelConfig(**{**_TINY, **over}, attn=JAttnSpec(kind="full"))
    return jcfg, j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)


def test_weight_store_across_processes_matches_reference(tmp_path):
    jcfg, jparams = _tiny_params()
    tokens = np.random.RandomState(1).randint(0, 256, size=(8, 16))
    h, _, _ = j_forward(jparams, jcfg, j_make_exec_config(jcfg, 1), rules=DEFAULT_RULES, mesh=None,
                        tokens=jnp.asarray(tokens), mode="prefill", block_q=16, block_k=16)
    want = np.asarray(j_logits_for(jparams, jcfg, h, DEFAULT_RULES, None))[..., :256]
    ranks = _run(tmp_path, "weight_store", 8, {"params": _np(jparams), "tokens": tokens})
    for r in ranks:
        assert r["summary"]["tps"] == [1, 2, 4, 8] and r["summary"]["zero_copy"]
        for tp, logits in r["arrays"]["logits"].items():
            np.testing.assert_allclose(logits, want, rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=f"TP {tp}")
    # every rank gathered the same logits
    for r in ranks[1:]:
        for tp in (1, 2, 4, 8):
            np.testing.assert_array_equal(r["arrays"]["logits"][tp], ranks[0]["arrays"]["logits"][tp])


def test_moe_sharded_across_processes_matches_reference(tmp_path):
    jcfg = j_reduced(j_get_config("moonshot-v1-16b-a3b"))
    jp = j_init_params(j_moe.moe_param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    x = np.random.RandomState(1).standard_normal((4, 8, jcfg.d_model)).astype(np.float32)
    jy, jaux = j_moe.moe_apply_local(jp, jnp.asarray(x), jcfg)
    ranks = _run(tmp_path, "moe_sharded", 4, {"params": _np(jp), "x": x})
    for r in ranks:
        assert r["summary"]["mesh"] == {"data": 2, "model": 2}
        np.testing.assert_allclose(r["arrays"]["y"], np.asarray(jy), rtol=MOE_TOL, atol=MOE_TOL)
        assert abs(r["arrays"]["lb"] - float(jaux["lb"])) <= LB_RTOL * abs(float(jaux["lb"]))


def test_cache_reshard_and_pages_across_processes_are_bit_identical(tmp_path):
    ranks = _run(tmp_path, "migration", 8, {})
    for r in ranks:
        steps = r["summary"]["reshards"]
        assert [(s["from"], s["to"]) for s in steps] == [(1, 2), (2, 4), (4, 1)]
        assert all(s["bytes_between_ranks"] > 0 for s in steps)
    pages = [r["summary"]["pages"] for r in ranks]
    assert pages[1]["bit_identical"] and pages[1]["pages"] == 16 and pages[0]["pages"] == 16
    assert all(p == {} for p in pages[2:])  # the other ranks take no part


def test_jamba_cache_reshard_across_processes_is_bit_identical(tmp_path):
    """Reduced jamba's slot cache (the attention layer's K/V, each Mamba-1
    layer's state h and conv tail) resharded TP 1 -> 2 -> 4 -> 1 over 8
    ranks: every block bit for bit (checked on every rank), the Mamba
    leaves split over the model group by channel as the KV heads are."""
    from repro_torch.configs import get_config, reduced

    d_in = reduced(get_config("jamba-v0.1-52b")).d_inner
    ranks = _run(tmp_path, "migration", 8, {"model": "jamba-v0.1-52b"})
    for r in ranks:
        steps = r["summary"]["reshards"]
        assert [(s["from"], s["to"]) for s in steps] == [(1, 2), (2, 4), (4, 1)]
        for s in steps:
            dp, tp = 8 // s["to"], s["to"]
            assert s["blocks"]["h"] == [8 // dp, d_in // tp, 16] and s["blocks"]["conv"] == [8 // dp, 3, d_in // tp]
            assert s["blocks"]["k"] == [8 // dp, 32, 4 // tp, 16] and s["bytes_between_ranks"] > 0


def test_collectives_across_processes_match_one_process(tmp_path):
    """The pool's all-reduce, all-gather, all-to-all and uneven exchange at
    TP 1/2/4 against one process's sums and joins (checked in every rank)."""
    ranks = _run(tmp_path, "collectives", 4, {})
    for rank, r in enumerate(ranks):
        levels = r["summary"]["levels"]
        assert sorted(levels) == ["1", "2", "4"] and r["summary"]["backend"] == "gloo"
        assert rank in levels["2"]["model_group"] and len(levels["4"]["model_group"]) == 4


@pytest.fixture(scope="module")
def fault_abort_ranks(tmp_path_factory):
    """fault_abort on a pool of 8 processes, on the reference's weights and
    tokens, with the reference's TP 1 logits of those tokens."""
    jcfg, jparams = _tiny_params()
    tokens = np.random.RandomState(1).randint(0, 256, size=(8, 16))
    h, _, _ = j_forward(jparams, jcfg, j_make_exec_config(jcfg, 1), rules=DEFAULT_RULES, mesh=None,
                        tokens=jnp.asarray(tokens), mode="prefill", block_q=16, block_k=16)
    want = np.asarray(j_logits_for(jparams, jcfg, h, DEFAULT_RULES, None))[..., :256]
    return _run(tmp_path_factory.mktemp("fault_abort"), "fault_abort", 8,
                {"params": _np(jparams), "tokens": tokens}), want


def test_fault_aborts_across_processes_are_transactional(fault_abort_ranks):
    ranks, _ = fault_abort_ranks
    for r in ranks:
        s = r["summary"]
        assert s["rolled_back"] and s["retry_switched"] and s["source_cache_intact"]
        assert s["rolled_back_diff"] == 0.0


def test_shrunken_pool_reloads_and_serves_reference_logits(fault_abort_ranks):
    """fault_abort part 3, the reference's weight reload on a shrunken pool:
    of 8 processes the first 4 survive (``WeightStore.shrink`` over
    ``Pool.shrink``), rebuild their positions from the canonical weights and
    serve at TP 2 (data 2 x model 2) within 2e-4 of the reference's logits;
    the other 4 leave with no pool."""
    ranks, want = fault_abort_ranks
    for rank, r in enumerate(ranks):
        shrunk = r["summary"]["shrunk"]
        assert shrunk["survivors"] == 4 and shrunk["left"] == (rank >= 4)
        if rank < 4:
            assert shrunk["pool"] == 4 and shrunk["tp"] == 2 and shrunk["storage_tp"] == 1
            np.testing.assert_allclose(r["arrays"]["shrunk_logits"], want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        else:
            assert "shrunk_logits" not in r["arrays"]


# moonshot-v1-16b-a3b's routing at full width (d_model 2048, 64 experts, top-6) with narrow experts: the
# load-balancing loss depends on the router and the blocks, not on the experts' width
LB_MOE = dict(d_ff_expert=32, capacity_factor=8.0)


def _moonshot_routing():
    jcfg = j_get_config("moonshot-v1-16b-a3b")
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "moe": jcfg.moe.__class__(**{**jcfg.moe.__dict__, **LB_MOE})})
    jp = j_init_params(j_moe.moe_param_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    x = np.random.RandomState(1).standard_normal((4, 8, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, x


def _reference_sharded_lb(out):
    """The reference's moe_apply_sharded on (data 2, model 2) of 4 host
    devices and its moe_apply_local, at moonshot's routing: lb of each."""
    from repro.core.weight_store import make_exec_mesh

    jcfg, jp, x = _moonshot_routing()
    mesh = make_exec_mesh(jax.devices()[:4], 2)
    assert dict(mesh.shape) == {"data": 2, "model": 2}, mesh.shape
    with mesh:
        _, aux = jax.jit(lambda p, x: j_moe.moe_apply_sharded(p, x, jcfg, DEFAULT_RULES, mesh))(jp, jnp.asarray(x))
    _, aux_local = j_moe.moe_apply_local(jp, jnp.asarray(x), jcfg)
    with open(out, "wb") as f:
        pickle.dump({"lb": float(aux["lb"]), "lb_local": float(aux_local["lb"])}, f)
    print("OK lb")


def test_sharded_lb_at_moonshot_routing_is_the_reference_sharded_lb(tmp_path):
    """The sharded path's load-balancing loss at moonshot's routing (d_model
    2048, 64 experts, top-6; 8-token blocks on data 2 x model 2): the
    reference's own sharded lb lies ~20% from its local one (each block
    routes on its own, and the blocks' losses are averaged), and the port's
    across 4 processes is the reference's sharded lb, within 5e-4
    relative; the port's y stays within 5e-4 of its local path."""
    out = tmp_path / "lb.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "lb", str(out)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0 and "OK lb" in r.stdout, f"{r.stdout}\n{r.stderr}"
    with open(out, "rb") as f:
        ref = pickle.load(f)
    assert abs(ref["lb"] - ref["lb_local"]) > 0.1 * ref["lb_local"], ref  # the reference's own gap
    _, jp, x = _moonshot_routing()
    ranks = _run(tmp_path, "moe_sharded", 4, {"params": _np(jp), "x": x, "full_width": "moonshot-v1-16b-a3b",
                                              "moe": LB_MOE, "lb_held_to": "sharded loop"})
    for rk in ranks:
        s = rk["summary"]
        assert s["d_model"] == 2048 and s["experts"] == 64 and s["block_tokens"] == 8
        assert abs(s["lb"] - ref["lb"]) <= MOE_TOL * abs(ref["lb"]), (s, ref)
        assert abs(s["lb_local"] - ref["lb_local"]) <= MOE_TOL * abs(ref["lb_local"]), (s, ref)


@pytest.fixture(scope="module")
def reference_engine():
    jcfg = JModelConfig(**_SERVE, attn=JAttnSpec(kind="full"))
    params = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)
    econf = JEngineConfig(candidate_tps=(1, 2, 4), n_slots=8, max_len=96, prefill_buckets=(16, 32), dtype=jnp.float32,
                          record_logits=True)
    eng = JServingEngine(jcfg, params, devices=jax.devices()[:1], econf=econf)
    rng = np.random.RandomState(0)
    reqs = [JRequest(i, "strict", rng.randint(0, 256, size=rng.randint(4, 30)).astype(np.int32), 24) for i in range(10)]
    done = eng.run(reqs)
    return _np(params), {r.req_id: list(r.generated) for r in done}, eng.logit_trace


def test_engine_across_processes_matches_reference(tmp_path, reference_engine):
    params, want, want_logits = reference_engine
    ranks = _run(tmp_path, "engine", 4, {"params": params})
    for r in ranks:
        assert r["summary"]["switches"] == 4 and r["summary"]["tps"] == [1, 2, 4]
        assert r["arrays"]["trajectories"] == want
        for key in ("logits_fixed", "logits_switched"):
            got = r["arrays"][key]
            assert sorted(got) == sorted(want_logits)
            for rid, steps in want_logits.items():
                np.testing.assert_allclose(got[rid], np.stack([np.asarray(s) for s in steps]), rtol=LOGIT_TOL,
                                           atol=LOGIT_TOL, err_msg=f"{key} request {rid}")


if __name__ == "__main__":
    {"lb": lambda: _reference_sharded_lb(sys.argv[2])}[sys.argv[1]]()
