"""bf16 training of the MoE and Mamba families across processes, held to the
reference's bf16 mesh step, under gloo.

The pool runs in a subprocess, ``python -m repro_torch.testing.multidev_checks
train_bf16 4 cpu`` (four processes, one rank each), on bf16 parameters with
f32 moments, fed the reference's bf16 weights. The reference's mesh step
runs in another subprocess, ``python tests/test_torch_train_bf16_moe_multidev.py
reference <weights.pkl> <out.pkl>``, whose XLA_FLAGS ask for 4 host devices
before JAX starts: ``make_train_step`` with ``DEFAULT_RULES`` on a mesh of
(data 4/t, model t) on the same bf16 weights (f32 moments, its
``AdamWConfig.dtype``), and ``jax.value_and_grad`` of its ``loss_fn`` on
that mesh. Both start together.

The cases (``multidev_checks.TRAIN_BF16_CASES`` but danube's, which
tests/test_torch_train_bf16_multidev.py holds): reduced moonshot-v1-16b-a3b
at (data 2, model 2), the sharded MoE path with its all-to-all, its decode
path's psum and the aux losses' pmean, and at (1, 4), the all-to-all over 4
ranks; reduced jamba-v0.1-52b at (2, 2) (Mamba-1 and MoE, each layer at its
own fan-in, test_torch_training.py's OWN_FAN_IN rule); reduced mamba2-2.7b
at (2, 2) (Mamba-2's shared reductions). Three steps each, lr 1e-3,
warm-up 2, SyntheticDataset(4, 32), chunks and blocks of 16.

Held: every leaf's bf16 gradient of batch 0 within BF16_GRAD_TOL[case] of
its greatest element; the first loss within FIRST_LOSS_RTOL[case] and every
loss within BF16_LOSS_RTOL[case] (later steps carry Adam's sign steps of
rounding-level gradient gaps, and routing turns with them); every
parameter leaf within BF16_UPDATE_RTOL of the reference's update after the
steps (Adam's first steps are near sign steps: a rounding-level gradient
gap steps either way). Jamba is held by its losses alone, as
tests/test_torch_train_bf16.py holds it on one device: its Mamba-1 scans
amplify rounding into every leaf (there the reference's own bf16 gradient
lies 1.03 of max |g| from its f32 one). Control, failing the same gradient
hold: the gradient of one data group's rows alone (a data group that
broadcasts one rank's gradient instead of summing), for each case with two
data groups.

Where the reference rounds at a collective: XLA on the CPU promotes a bf16
all-reduce (the row-parallel psum, its transpose, the data group's
gradient sum) to f32 and rounds the whole sum once (its optimized HLO on 4
host devices: every all-reduce f32, ``add.clone_promoted``); the port's
collectives under autograd sum bf16 in f32 alike (``collectives._summed``).
An all-to-all or all-gather moves bf16 values unchanged on both sides, and
the aux losses' pmean is f32 on both.

The tolerances rest on readings on this CPU (``python
tests/test_torch_train_bf16_moe_multidev.py`` prints each), about twice
each: see READINGS.
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

from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.testing.multidev_checks import BF16_OWN_FAN_IN, TRAIN_BF16_CASES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_POOL = 4
CASES = ["moonshot_2x2", "moonshot_1x4", "jamba_2x2", "mamba2_2x2"]
LOSS_ONLY = ("jamba_2x2",)
# readings on this CPU (``readings``): the gradient gap (the worst leaf's, over its max |g|) and its leaf, one
# data group's gradient alone, the first loss's and every loss's greatest relative gap, the worst leaf's update
# distance. Before the bf16 sums across ranks went through f32 (``collectives._summed``), moonshot_1x4 read a
# gradient gap of 0.41 (wq) and a first loss 3.1e-4 off.
READINGS = {
    "moonshot_2x2": {"grad_gap": 1.42e-2, "grad_leaf": "periods/pos0/ffn/w_gate", "one_data_group_alone": 1.30,
                     "first_loss_rel": 2.8e-6, "loss_rel": 1.99e-3, "update_rel": 0.317},
    "moonshot_1x4": {"grad_gap": 1.60e-2, "grad_leaf": "periods/pos0/norm2", "first_loss_rel": 1.3e-5,
                     "loss_rel": 3.55e-3, "update_rel": 0.386},
    "jamba_2x2": {"grad_gap": 0.944, "grad_leaf": "periods/pos6/mixer/dt_proj", "one_data_group_alone": 2.35,
                  "first_loss_rel": 1.73e-3, "loss_rel": 1.73e-3, "update_rel": 0.862},
    "mamba2_2x2": {"grad_gap": 2.75e-2, "grad_leaf": "embed", "one_data_group_alone": 1.13, "first_loss_rel": 1.6e-7,
                   "loss_rel": 7.5e-5, "update_rel": 0.141},
}
# about twice each reading (one device, test_torch_train_bf16.py: moonshot 1.1e-2, mamba2 2.0e-2)
BF16_GRAD_TOL = {"moonshot_2x2": 3e-2, "moonshot_1x4": 3e-2, "mamba2_2x2": 5.5e-2}
FIRST_LOSS_RTOL = {"moonshot_2x2": 6e-6, "moonshot_1x4": 3e-5, "jamba_2x2": 3.5e-3, "mamba2_2x2": 1e-6}
BF16_LOSS_RTOL = {"moonshot_2x2": 4e-3, "moonshot_1x4": 7e-3, "jamba_2x2": 3.5e-3, "mamba2_2x2": 1.5e-4}
BF16_UPDATE_RTOL = 0.5  # test_torch_train_bf16_multidev.py's: Adam's first steps turn rounding-level gaps into steps


def _weights(case: str) -> dict:
    """The reference's weights of a case rounded to bf16, as f32 numpy; at
    each stacked leaf's own fan-in for BF16_OWN_FAN_IN's models."""
    model, tp, _ = TRAIN_BF16_CASES[case]
    jcfg = j_reduced(j_get_config(model))
    defs = j_param_defs(jcfg, j_make_exec_config(jcfg, tp))
    if model in BF16_OWN_FAN_IN:
        own = (lambda d: replace(d, scale=d.shape[-2] ** -0.5)
               if d.scale is None and d.init == "normal" and len(d.shape) >= 3 else d)
        defs = {k: tree_map_defs(own, v) if k == "periods" else v for k, v in defs.items()}
    p = j_init_params(defs, jax.random.PRNGKey(0), jnp.float32)
    return jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32)), p)


def _f32(tree) -> dict:
    return dict(tree_leaves_with_path(jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), tree)))


def _reference(weights: str, out: str) -> None:
    """Each case's bf16 mesh step over 4 host devices: value_and_grad of
    loss_fn on batch 0 (and, with two data groups, on the first data
    group's rows of it alone), then the case's steps of make_train_step."""
    from jax.sharding import Mesh

    from repro.models.model import loss_fn as j_loss_fn
    from repro.parallel.sharding import DEFAULT_RULES
    from repro.training.data import SyntheticDataset as JSyntheticDataset
    from repro.training.optimizer import AdamWConfig as JAdamWConfig
    from repro.training.train_step import (
        TrainStepConfig as JTrainStepConfig, init_opt_state as j_init_opt_state, make_train_step as j_make_train_step,
    )

    assert len(jax.devices()) >= N_POOL, jax.devices()
    with open(weights, "rb") as f:
        params = pickle.load(f)
    res = {}
    kw = dict(seq_chunk=16, block_q=16, block_k=16)
    for case in params:
        model, tp, steps = TRAIN_BF16_CASES[case]
        jcfg = j_reduced(j_get_config(model))
        ec = j_make_exec_config(jcfg, tp)
        mesh = Mesh(np.array(jax.devices()[:N_POOL]).reshape(N_POOL // tp, tp), ("data", "model"))
        jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=2), **kw)
        step, sh = j_make_train_step(jcfg, ec, DEFAULT_RULES, mesh, jt)
        ds = JSyntheticDataset(jcfg, batch=4, seq=32)
        p0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params[case])
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=DEFAULT_RULES, mesh=mesh, **kw), has_aux=True),
            in_shardings=(sh["params"], sh["batch"]))
        _, grads = grad_fn(jax.device_put(p0, sh["params"]), ds.at(0))
        rec = {"grads": _f32(grads)}
        dp = N_POOL // tp
        if dp > 1:  # one data group's rows alone, on the same mesh's model group
            half_mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))
            half = {k: v[:4 // dp] for k, v in ds.at(0).items()}
            _, half_grads = jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=DEFAULT_RULES, mesh=half_mesh, **kw),
                has_aux=True))(p0, half)
            rec["half_grads"] = _f32(half_grads)
        o = jax.tree_util.tree_map(jax.device_put, j_init_opt_state(p0, jt), dict(sh["opt_state"]))
        p, losses = jax.device_put(p0, sh["params"]), []
        for i in range(steps):
            p, o, m = step(p, o, ds.at(i))
            losses.append(float(m["loss"]))
        rec.update(losses=losses, params=_f32(p), dtypes=sorted({str(x.dtype) for x in jax.tree_util.tree_leaves(p)}),
                   moment_dtypes=sorted({str(x.dtype) for x in jax.tree_util.tree_leaves(o["mu"])}))
        res[case] = rec
        print(f"{case}: losses {losses}", flush=True)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("OK reference")


def run_both(tmp: Path):
    """The reference's bf16 mesh steps and the pool's, started together in
    ``tmp``: (reference, [each rank's summary], rank 0's arrays, the
    weights by case)."""
    weights = {case: _weights(case) for case in CASES}
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"train_bf16": {"params": weights, "cases": CASES}}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "reference", str(tmp / "weights.pkl"), str(tmp / "ref.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}", JAX_PLATFORMS="cpu")),
        "pool": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.multidev_checks", "train_bf16", str(N_POOL), "cpu",
             "--inputs", str(tmp / "in.pkl"), "--out", str(tmp / "out.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)}
    failed = []
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        ok = "OK reference" if name == "reference" else "OK train_bf16"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "out.pkl", "rb") as f:
        ranks = [r["train_bf16"] for r in pickle.load(f)]
    assert len(ranks) == N_POOL
    return ref, [r["summary"] for r in ranks], ranks[0]["arrays"], {c: dict(tree_leaves_with_path(w))
                                                                    for c, w in weights.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("train_bf16_moe"))


def grad_gaps(got: dict, want: dict) -> dict:
    """Each leaf's max |got - want| over its max |want|."""
    return {path: float(np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30)) for path, w in want.items()}


def update_rel(got: dict, want: dict, start: dict) -> float:
    """The greatest leaf's ||got - want|| over the reference's update
    ||want - start||: a pool left where it started reads 1.0."""
    return max(float(np.linalg.norm(got[path] - w) / np.linalg.norm(w - start[path])) for path, w in want.items())


def _leaves(tree) -> dict:
    return {path: np.asarray(t) for path, t in tree_leaves_with_path(tree)}


def readings(ref, arrays, start) -> dict:
    """What each tolerance rests on, case by case."""
    out = {}
    for case in CASES:
        got = _leaves(arrays[case]["grads"])
        gaps = grad_gaps(got, ref[case]["grads"])
        worst = max(gaps, key=gaps.get)
        rel = [abs(a - b) / abs(b) for a, b in zip(arrays[case]["losses"], ref[case]["losses"])]
        rec = {"grad_gap": gaps[worst], "grad_leaf": "/".join(worst), "first_loss_rel": rel[0], "loss_rel": max(rel),
               "update_rel": update_rel(_leaves(arrays[case]["params"]), ref[case]["params"], start[case])}
        if "half_grads" in ref[case]:
            rec["one_data_group_alone"] = max(grad_gaps(ref[case]["half_grads"], ref[case]["grads"]).values())
        out[case] = rec
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c not in LOSS_ONLY])
def test_bf16_pool_gradients_match_reference_mesh(case, runs):
    """Every leaf's bf16 gradient of batch 0, gathered over the data and
    model groups, within BF16_GRAD_TOL[case] of its greatest element from
    the mesh's."""
    ref, _, arrays, _ = runs
    got, want = _leaves(arrays[case]["grads"]), ref[case]["grads"]
    assert sorted(got) == sorted(want)
    gaps = grad_gaps(got, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= BF16_GRAD_TOL[case], f"{case}: {'/'.join(worst)} {gaps[worst]:.3e}"


@pytest.mark.parametrize("case", [c for c in CASES if c not in LOSS_ONLY and N_POOL // TRAIN_BF16_CASES[c][1] > 1])
def test_one_data_groups_gradient_fails_the_hold(case, runs):
    """The control: one data group's rows alone (a data group that
    broadcasts one rank's gradient instead of summing) lies past
    BF16_GRAD_TOL[case] from the mesh's gradient."""
    ref, _, _, _ = runs
    assert max(grad_gaps(ref[case]["half_grads"], ref[case]["grads"]).values()) > BF16_GRAD_TOL[case]


@pytest.mark.parametrize("case", CASES)
def test_bf16_pool_steps_match_reference_mesh(case, runs):
    """The first loss within FIRST_LOSS_RTOL[case] and every loss within
    BF16_LOSS_RTOL[case] of the mesh step's (bf16
    parameters on both sides, f32 moments); every parameter leaf within
    BF16_UPDATE_RTOL of the mesh step's update but jamba's (its losses
    alone); every rank the same losses and the replication after every
    step. The parameters left where they started read 1.0, past it."""
    ref, summaries, arrays, start = runs
    losses = arrays[case]["losses"]
    assert len(losses) == TRAIN_BF16_CASES[case][2]
    assert ref[case]["dtypes"] == ["bfloat16"] and ref[case]["moment_dtypes"] == ["float32"]
    np.testing.assert_allclose(losses[0], ref[case]["losses"][0], rtol=FIRST_LOSS_RTOL[case])
    np.testing.assert_allclose(losses, ref[case]["losses"], rtol=BF16_LOSS_RTOL[case])
    if case not in LOSS_ONLY:
        assert update_rel(_leaves(arrays[case]["params"]), ref[case]["params"], start[case]) < BF16_UPDATE_RTOL
        assert update_rel(start[case], ref[case]["params"], start[case]) > BF16_UPDATE_RTOL
    for s in summaries:
        assert s[case]["losses"] == losses and s[case]["dtypes"] == ["torch.bfloat16"]
        assert s[case]["replicated_after_every_step"]


if __name__ == "__main__":
    if sys.argv[1:2] == ["reference"]:
        _reference(sys.argv[2], sys.argv[3])
    else:  # the readings the tolerances rest on
        import json
        import tempfile

        ref, summaries, arrays, start = run_both(Path(tempfile.mkdtemp(prefix="train_bf16_moe")))
        print(json.dumps(readings(ref, arrays, start), indent=1))
