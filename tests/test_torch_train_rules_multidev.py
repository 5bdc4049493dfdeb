"""Training across processes under the reference's train rules, held to the
reference's mesh step under the same rules, under gloo.

The rules are ``rules_for(cfg, "train", 32, 4)``: ``embed -> data`` (weight
FSDP: every leaf with an embed axis lies on a rank as its (model, data)
block and is gathered at use), ``expert_embed -> data`` for the MoE models
(expert-weight FSDP) and ``seq_res -> model`` (32 % 16 == 0: the residual
stream saved at each period boundary is the rank's S/t positions).

The pool runs in a subprocess, ``python -m repro_torch.testing.multidev_checks
train_rules 4 cpu`` (four processes, one rank each; every case in one
spawn), fed the reference's weights through ``checkpoint.convert``. The
reference's mesh step runs in another subprocess, ``python
tests/test_torch_train_rules_multidev.py reference <weights.pkl> <out.pkl>``,
whose XLA_FLAGS ask for 4 host devices before JAX starts: ``make_train_step``
under the same rules on a mesh of (data 4/t, model t), and
``jax.value_and_grad`` of its ``loss_fn`` on that mesh, on the same numpy
weights and batches. Both start together.

The cases (``multidev_checks.TRAIN_RULES_CASES``): reduced h2o-danube-1.8b
at (data 2, model 2), reduced moonshot-v1-16b-a3b at (2, 2) and (4, 1),
three steps each; reduced jamba-v0.1-52b at (2, 2), one step on weights
drawn at each layer's own fan-in (its 8-layer period, the Mamba
projections on ``embed``). lr 1e-3, warm-up 2, SyntheticDataset(4, 32),
chunks and blocks of 16.

Held against the reference's mesh, with test_torch_train_moe_multidev.py's
tolerances: every leaf's gradient of batch 0 within GRAD_TOL of its greatest
element, the losses within LOSS_RTOL, the parameters within PARAM_TOL but
for elements whose step-1 gradient lies within the gradient tolerance of
zero (Adam's first steps are sign steps). Held inside the pool
(``check_train_rules``, whose summary is read here): each rank's resident
parameter and moment bytes equal the rules' local shapes exactly; the pool
under the train rules against the same pool under DEFAULT_RULES
(gradients and losses within 1e-6, parameters within 1e-4 of their
update); the presets a train step takes ("no-fsdp" bit for bit equal to
DEFAULT_RULES, "zero-off" and "fsdp-pod" to the train rules); each case's
first step counted leaf by leaf (danube's also with 2 microbatches),
against the design and against the dry run's stand-ins for the same
cell; and danube's run cut through
the elastic checkpoint under the rules, resumed at (data 4, model 1) under
DEFAULT_RULES and in one process; danube also with 2 microbatches and
with int8 compression under both tables.
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
from repro.models.params import init_params as j_init_params, tree_map_defs  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import cells, op_cost  # noqa: E402
from repro_torch.launch.rules_presets import preset  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import DEFAULT_RULES, check_train_rules, make_exec_config  # noqa: E402
from repro_torch.testing.multidev_checks import (  # noqa: E402
    GRAD_TOL, LOSS_RTOL, PARAM_TOL, RULES_BATCH, RULES_SEQ, RULES_TOL, RULES_UPDATE_RTOL, TRAIN_RULES_CASES,
    VARIANTS_CASE, _train_cfg, train_rules, variant_rtol,
)

ROOT = Path(__file__).resolve().parents[1]
N_POOL = 4
# the most parameter elements a case may hold outside PARAM_TOL, each one whose step-1 gradient lies within the
# gradient tolerance of zero (measured on this CPU: 1 of jamba, as under DEFAULT_RULES in
# test_torch_train_moe_multidev.py; none elsewhere); about twice that
UNSIGNED_OFF = {"jamba_2x2": 2}


def _jax_params(case: str) -> dict:
    """The reference's weights of a case, numpy; at each stacked leaf's own
    fan-in where the case says so (test_torch_training.py's rule)."""
    model, tp, _, own = TRAIN_RULES_CASES[case]
    jcfg = j_reduced(j_get_config(model))
    defs = j_param_defs(jcfg, j_make_exec_config(jcfg, tp))
    if own:
        rule = (lambda d: replace(d, scale=d.shape[-2] ** -0.5)
                if d.scale is None and d.init == "normal" and len(d.shape) >= 3 else d)
        defs = {k: tree_map_defs(rule, v) if k == "periods" else v for k, v in defs.items()}
    return jax.tree_util.tree_map(np.asarray, j_init_params(defs, jax.random.PRNGKey(0), jnp.float32))


def _reference(weights: str, out: str) -> None:
    """Each case's mesh step over 4 host devices under rules_for(jcfg,
    "train", 32, 4): value_and_grad of loss_fn on batch 0, then the case's
    steps of make_train_step."""
    from jax.sharding import Mesh

    from repro.models.model import loss_fn as j_loss_fn
    from repro.parallel.sharding import rules_for as j_rules_for
    from repro.training.data import SyntheticDataset as JSyntheticDataset
    from repro.training.optimizer import AdamWConfig as JAdamWConfig
    from repro.training.train_step import (
        TrainStepConfig as JTrainStepConfig, init_opt_state as j_init_opt_state, make_train_step as j_make_train_step,
    )

    assert len(jax.devices()) >= N_POOL, jax.devices()
    with open(weights, "rb") as f:
        params = pickle.load(f)
    res = {}
    for case, (model, tp, steps, _) in TRAIN_RULES_CASES.items():
        jcfg = j_reduced(j_get_config(model))
        ec = j_make_exec_config(jcfg, tp)
        rules = j_rules_for(jcfg, "train", RULES_SEQ, RULES_BATCH)
        mesh = Mesh(np.array(jax.devices()[:N_POOL]).reshape(N_POOL // tp, tp), ("data", "model"))
        jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=2), seq_chunk=16, block_q=16, block_k=16)
        step, sh = j_make_train_step(jcfg, ec, rules, mesh, jt)
        ds = JSyntheticDataset(jcfg, batch=RULES_BATCH, seq=RULES_SEQ)
        p0 = jax.tree_util.tree_map(jnp.asarray, params[case])
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=rules, mesh=mesh, seq_chunk=16, block_q=16,
                                   block_k=16), has_aux=True), in_shardings=(sh["params"], sh["batch"]))
        (_, _), grads = grad_fn(jax.device_put(p0, sh["params"]), ds.at(0))
        o = jax.tree_util.tree_map(jax.device_put, j_init_opt_state(p0, jt), dict(sh["opt_state"]))
        p, losses = jax.device_put(p0, sh["params"]), []
        for i in range(steps):
            p, o, m = step(p, o, ds.at(i))
            losses.append(float(m["loss"]))
        res[case] = {"grads": dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, grads))),
                     "losses": losses, "params": dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, p)))}
        print(f"{case}: losses {losses}")
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("OK reference")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mesh steps and the pool's check, started together:
    ({case: reference}, [each rank's summary], rank 0's arrays)."""
    tmp = tmp_path_factory.mktemp("train_rules")
    weights = {case: _jax_params(case) for case in TRAIN_RULES_CASES}
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"train_rules": {"params": weights, "ckpt_dir": str(tmp / "ckpt")}}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "reference", str(tmp / "weights.pkl"), str(tmp / "ref.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}", JAX_PLATFORMS="cpu")),
        "pool": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.multidev_checks", "train_rules", str(N_POOL), "cpu",
             "--inputs", str(tmp / "in.pkl"), "--out", str(tmp / "out.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)}
    failed = []
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        ok = "OK reference" if name == "reference" else "OK train_rules"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "out.pkl", "rb") as f:
        ranks = [r["train_rules"] for r in pickle.load(f)]
    assert len(ranks) == N_POOL
    return ref, [r["summary"] for r in ranks], ranks[0]["arrays"]


def _leaves(tree) -> dict:
    return {path: np.asarray(t) for path, t in tree_leaves_with_path(tree)}


def _grad_tol(case: str) -> float:
    return GRAD_TOL.get(TRAIN_RULES_CASES[case][0], 1e-4)


@pytest.mark.parametrize("case", list(TRAIN_RULES_CASES))
def test_pool_gradients_match_reference_mesh(case, runs):
    """Every leaf's gradient of batch 0 (the pool's blocks gathered over the
    data and model groups) within GRAD_TOL of its greatest element from
    the mesh's value_and_grad under the same rules: the FSDP gathers'
    reduce-scattered gradients and sequence parallelism's cuts."""
    ref, _, arrays = runs
    got, want = _leaves(arrays[case]["grads"]), ref[case]["grads"]
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = np.abs(got[path] - w).max() / np.abs(w).max()
        assert err <= _grad_tol(case), f"{case}: {'/'.join(path)}: {err:.2e} of max|g| {np.abs(w).max():.3e}"


@pytest.mark.parametrize("case", list(TRAIN_RULES_CASES))
def test_pool_steps_match_reference_mesh(case, runs):
    """The losses within LOSS_RTOL and every parameter element within
    PARAM_TOL of the mesh step's after the case's steps, but at most
    UNSIGNED_OFF[case] elements whose step-1 gradient the gradient check
    cannot sign, each within two lr-sized steps a step; every rank reports
    the same losses."""
    ref, summaries, arrays = runs
    want = ref[case]
    losses = arrays[case]["losses"]
    assert len(losses) == TRAIN_RULES_CASES[case][2]
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL, err_msg=case)
    opt = _train_cfg({"warmup_steps": 2}).opt
    reach = 2 * sum(opt.lr * min(t / opt.warmup_steps, 1.0) for t in range(1, len(losses) + 1))
    params, off_total = _leaves(arrays[case]["params"]), 0
    for path, w in want["params"].items():
        g = want["grads"][path]
        unsigned = np.abs(g) <= _grad_tol(case) * np.abs(g).max()
        off = ~np.isclose(params[path], w, **PARAM_TOL)
        assert not (off & ~unsigned).any(), f"{case}: {'/'.join(path)} outside PARAM_TOL"
        assert (np.abs(params[path] - w)[off] <= reach + PARAM_TOL["atol"]).all(), f"{case}: {'/'.join(path)}"
        off_total += int(off.sum())
    assert off_total <= UNSIGNED_OFF.get(case, 0), f"{case}: {off_total} unsigned elements outside PARAM_TOL"
    for s in summaries:
        assert s[case]["losses"] == losses


@pytest.mark.parametrize("case", list(TRAIN_RULES_CASES))
def test_resident_bytes_equal_rules_local_shapes(case, runs):
    """The check raised otherwise on every rank (each rank's parameter and
    moment bytes against the rules' local shapes): here, that every rank
    holds the same bytes, its blocks of every leaf with an embed axis
    (and, for the MoE models, the experts'), and that the moments took no
    ZeRO split where the rules shard over data."""
    _, summaries, _ = runs
    model, tp, _, _ = TRAIN_RULES_CASES[case]
    cfg = reduced(get_config(model))
    for s in summaries:
        rec = s[case]
        assert rec["mesh"] == {"data": N_POOL // tp, "model": tp} and rec["replicated_after_every_step"]
        assert rec["resident"] == summaries[0][case]["resident"]
    names = summaries[0][case]["data_sharded"]
    assert "embed" in names and "final_norm" in names
    assert any(n.endswith("/norm1") for n in names)
    if cfg.moe is not None:
        assert any(n.endswith("ffn/w_gate") for n in names) and any(n.endswith("ffn/router") for n in names)


@pytest.mark.parametrize("case", list(TRAIN_RULES_CASES))
def test_rules_against_default_rules_at_one_layout(case, runs):
    """The pool under the train rules against the same pool under
    DEFAULT_RULES: gradients of batch 0 within 1e-6 of each leaf's greatest
    element, losses within 1e-6, each parameter leaf within 1e-4 of its
    update (only the sums' order differs)."""
    _, summaries, _ = runs
    d = summaries[0][case]["against_default"]
    assert d["grad_rel"] <= RULES_TOL and d["loss_rel"] <= RULES_TOL and d["update_rel"] < RULES_UPDATE_RTOL, d


@pytest.mark.parametrize("variant", ["accum", "compress"])
def test_accumulation_and_compression_under_rules(variant, runs):
    """Danube's run with 2 microbatches (their gradients reduce-scattered
    one microbatch at a time into the f32 accumulators) and with int8
    compression in blocks of 256 (each block's scale over the whole leaf,
    gathered over the data group too), each against the same under
    DEFAULT_RULES: gradients and losses as the plain runs, parameters
    within RULES_UPDATE_RTOL of their update with accumulation, as the
    plain runs, and within ``variant_rtol`` with compression."""
    _, summaries, _ = runs
    d = summaries[0][VARIANTS_CASE][f"{variant}_against_default"]
    # the pool check allows accumulation UPDATE_RTOL (an H100's sums needed it); on the CPU it stays inside
    # the plain runs' limit (7.2e-6)
    limit = RULES_UPDATE_RTOL if variant == "accum" else variant_rtol(variant)
    assert d["grad_rel"] <= RULES_TOL and d["loss_rel"] <= RULES_TOL and d["update_rel"] < limit, d


def test_presets_a_train_step_takes(runs):
    """no-fsdp bit for bit equal to DEFAULT_RULES; zero-off (moments whole
    on every data rank) and fsdp-pod ("pod" absent on one host) bit for bit
    equal to the train rules."""
    _, summaries, _ = runs
    p = summaries[0]["moonshot_2x2"]["presets"]
    assert p == {"no-fsdp_bitwise_default": True, "zero-off_bitwise_rules": True, "zero-off_split_leaves": 0,
                 "fsdp-pod_bitwise_rules": True}


@pytest.mark.parametrize("name,entry", [("seq-data", "kv_seq"), ("decode-2d", "res_batch")])
def test_serving_presets_raise(name, entry):
    """A rule entry the train step does not implement (the serving
    presets') raises, naming the entry."""
    rules = preset(name, train_rules(reduced(get_config("moonshot-v1-16b-a3b"))))
    with pytest.raises(NotImplementedError, match=entry):
        check_train_rules(rules, {"data": 2, "model": 2})


@pytest.mark.parametrize("name", ["default", "no-fsdp", "zero-off", "fsdp-pod"])
def test_train_presets_accepted(name):
    check_train_rules(preset(name, train_rules(reduced(get_config("moonshot-v1-16b-a3b")))), {"data": 2, "model": 2})
    check_train_rules(DEFAULT_RULES, {"data": 4, "model": 1})


@pytest.mark.parametrize("case,record", [(case, "traffic") for case in TRAIN_RULES_CASES]
                         + [(VARIANTS_CASE, "accum_traffic")])
def test_traffic_counted_leaf_by_leaf(case, record, runs):
    """Each case's first step (and danube's with 2 microbatches): every
    data-sharded leaf gathered at its forward and its recompute (a
    layer's; the embedding, final norm and head once), its gradient
    reduce-scattered once, each a microbatch, and never all-reduced, and
    sequence parallelism's joins (2 x periods + 1) and backward cuts
    (periods + 1) a microbatch at model 2: the check raised otherwise, on
    every rank; here the totals by kind against ``cells.rules_traffic``
    (moonshot's and danube's every leaf lies on embed: none all-reduced)."""
    _, summaries, _ = runs
    model, tp, _, _ = TRAIN_RULES_CASES[case]
    cfg = reduced(get_config(model))
    k = 2 if record == "accum_traffic" else 1
    for s in summaries:
        t = s[case][record]
        assert t["rules_traffic"] and t["data_sharded_instances"] > 0
        for kind, want in t["rules_traffic"].items():
            assert tuple(t["by_kind"][kind]) == tuple(want), kind
        for kind in ("all-reduce (gradients)", "all-gather (parameters)"):  # only where the rules' step runs one
            assert (kind in t["by_kind"]) == (kind in t["rules_traffic"]), kind
        assert t["sequence_joins"] == (k * (2 * cfg.num_periods + 1) if tp > 1 else 0)
        assert t["sequence_cuts_backward"] == (k * (cfg.num_periods + 1) if tp > 1 else 0)
        assert t["by_kind"]["reduce-scatter (gradients)"][0] == k * t["data_sharded_instances"]


# at model 1 the dry run's group is one device, which stands in no collective (``collectives.stand_in``)
@pytest.mark.parametrize("case", [c for c, (_, tp, _, _) in TRAIN_RULES_CASES.items() if tp > 1])
def test_dry_run_stands_in_the_counted_traffic(case, runs, monkeypatch):
    """The dry run's train cell, built for the same reduced config at
    (data 2, model 2) and counted on meta (bf16), stands in the
    collectives the pool counted: the same calls by kind, at half the f32
    bytes."""
    _, summaries, _ = runs
    cfg = reduced(get_config(TRAIN_RULES_CASES[case][0]))
    mesh = {"data": 2, "model": 2}
    monkeypatch.setattr(cells, "get_config", lambda arch: cfg)
    monkeypatch.setitem(cells.SHAPES, "reduced", ShapeSpec("reduced", RULES_SEQ, RULES_BATCH, "train"))
    step, _, rules = cells.build_step(cfg.name, "reduced", mesh, train_rules(cfg))
    _, cost = op_cost.count(step, devices=step.devices, gathered=step.gathered, gather_needs_grad=True)
    counted = summaries[0][case]["traffic"]["by_kind"]
    want = cells.rules_traffic(cfg, make_exec_config(cfg, 2), rules, mesh, 2, RULES_SEQ)
    assert want
    for kind, (calls, nbytes) in want.items():
        assert (cost.collective_count_by_kind[kind], cost.collective_bytes_by_kind[kind] * 2) == (calls, nbytes)
        assert tuple(counted[kind]) == (calls, nbytes)


def test_elastic_checkpoint_under_rules_resumes_elsewhere(runs):
    """Danube's run under the train rules at (2, 2), cut at step 3 through
    train_loop's checkpoint, resumed at (data 4, model 1) under
    DEFAULT_RULES and in one process: the check raised unless both resumed
    losses lie within LOSS_RTOL of the uncut run's."""
    _, summaries, _ = runs
    el = summaries[0]["danube_2x2"]["elastic"]
    assert el["cut"] == 3 and el["resumed_data_model"] == [N_POOL, 1] and el["one_process_resumed_from"] == 3
    np.testing.assert_allclose(el["resumed"], el["uncut"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(el["one_process"], el["uncut"], rtol=LOSS_RTOL)


if __name__ == "__main__":
    {"reference": lambda: _reference(sys.argv[2], sys.argv[3])}[sys.argv[1]]()
