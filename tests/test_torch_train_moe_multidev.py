"""Training the MoE and Mamba families across processes, held to the
reference's (data, model) mesh step, under gloo.

The pool runs in subprocesses, one per layout, as
tests/test_torch_train_multidev.py runs its check: ``python -m
repro_torch.testing.multidev_checks train_moe 4 cpu`` (four processes, one
rank each), fed the reference's weights through ``checkpoint.convert``.
The reference's mesh step runs in another subprocess, ``python
tests/test_torch_train_moe_multidev.py reference <weights.pkl> <out.pkl>``,
whose XLA_FLAGS ask for 4 host devices before JAX starts, on the same
numpy weights and batches: ``make_train_step`` with ``DEFAULT_RULES`` on a
mesh of (data 4/t, model t), and ``jax.value_and_grad`` of its
``loss_fn`` on that mesh. All start together.

The cases (``multidev_checks.TRAIN_MOE_CASES``): reduced moonshot-v1-16b-a3b
at (data 2, model 2), (4, 1) (the TP-1 gather of the data groups' rows)
and (1, 4) (the all-to-all over 4 ranks); reduced jamba-v0.1-52b and
reduced mamba2-2.7b at (2, 2). Jamba takes three steps on weights drawn at
each layer's own fan-in (test_torch_training.py's OWN_FAN_IN rule), and
one on ``init_params``' weights, where its residual stream reaches ~1e10
and several steps mean nothing. lr 1e-3, warm-up 2, SyntheticDataset(4,
32), chunks and blocks of 16.

Held, for the pool and for the one-process (TP 2, dp 2) step (here) at
(2, 2): every leaf's gradient of batch 0 within GRAD_TOL of its greatest
element (5e-4 for the MoE models, 1e-4 for mamba2: test_torch_training.py's
against the reference's value_and_grad; on jamba's init_params weights
3e-2, CONDITIONED_GRAD_TOL, where one device alone is 1.64e-2 from the
reference's one device); the losses within 2e-4 relative and the
parameters at rtol 5e-3, atol 5e-4 after the steps, but for the elements
whose step-1 gradient lies within the gradient tolerance of zero: Adam's
first steps are sign steps, and there an f32 rounding of the gradient
steps the other way (2 elements of moonshot at (1, 4), 1 of jamba on own
fan-in, 20 of jamba on init_params' weights, on this CPU; UNSIGNED_OFF
caps each case at about twice that); those lie within two lr-sized steps
a step of the reference. On jamba's init_params weights one step at
warm-up 2 moves a parameter by at most 5e-4, within PARAM_TOL's atol, so
there the parameter check cannot tell a pool that did not move: that
case's gradient check (and the one-process hold's UPDATE_RTOL) carries it.
Inside the
pool: after every step the parameters bit-equal across each data group and
the replicated leaves across each model group, and rank 0 holds the pool
to the one-process step (``check_train_moe``). The mesh and one device
differ here (the sharded lb is its blocks' mean, ROADMAP's Reference
notes), which is why the pool is held to the mesh.
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

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.testing.multidev_checks import (  # noqa: E402
    GRAD_TOL, LOSS_RTOL, PARAM_TOL, TRAIN_MOE_CASES, UPDATE_RTOL, _train_cfg, one_process_run,
)
from repro_torch.training.data import SyntheticDataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_POOL = 4
LAYOUTS = {tp: [c for c, v in TRAIN_MOE_CASES.items() if v[1] == tp] for tp in (2, 1, 4)}  # a spawn per TP level
ONE_PROCESS = LAYOUTS[2]  # the one-process (TP 2, dp 2) step
# jamba on init_params' weights (its residual stream reaches ~1e10): f32 rounding moves its gradients by more
# than GRAD_TOL on one device already. Measured on this CPU: the port's one-device gradient lies 1.64e-2 of a
# leaf's greatest element (dt_proj) from the reference's one-device gradient, and the one-process (TP 2, dp 2)
# step's 1.44e-2 from the mesh's; the pool lies 3.9e-6 from the one-process step (check_train_moe).
CONDITIONED_GRAD_TOL = {"jamba_init_2x2": 3e-2}
# the most parameter elements a case may hold outside PARAM_TOL, all of them elements whose step-1 gradient lies
# within the gradient tolerance of zero (measured on this CPU, the pool and the one-process step alike: 2 of
# moonshot at (1, 4), 1 of jamba on own fan-in, 20 of jamba on init_params' weights, none elsewhere)
UNSIGNED_OFF = {"moonshot_1x4": 4, "jamba_2x2": 2, "jamba_init_2x2": 40}  # others 0


def _jax_params(case: str) -> dict:
    """The reference's weights of a case, numpy; at each stacked leaf's own
    fan-in where the case says so (test_torch_training.py's rule)."""
    model, tp, _, own = TRAIN_MOE_CASES[case]
    jcfg = j_reduced(j_get_config(model))
    defs = j_param_defs(jcfg, j_make_exec_config(jcfg, tp))
    if own:
        rule = (lambda d: replace(d, scale=d.shape[-2] ** -0.5)
                if d.scale is None and d.init == "normal" and len(d.shape) >= 3 else d)
        defs = {k: tree_map_defs(rule, v) if k == "periods" else v for k, v in defs.items()}
    return jax.tree_util.tree_map(np.asarray, j_init_params(defs, jax.random.PRNGKey(0), jnp.float32))


def _reference(weights: str, out: str) -> None:
    """Each case's mesh step over 4 host devices: value_and_grad of loss_fn
    on batch 0, then the case's steps of make_train_step."""
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
    for case, (model, tp, steps, _) in TRAIN_MOE_CASES.items():
        jcfg = j_reduced(j_get_config(model))
        ec = j_make_exec_config(jcfg, tp)
        mesh = Mesh(np.array(jax.devices()[:N_POOL]).reshape(N_POOL // tp, tp), ("data", "model"))
        jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=2), seq_chunk=16, block_q=16, block_k=16)
        step, sh = j_make_train_step(jcfg, ec, DEFAULT_RULES, mesh, jt)
        ds = JSyntheticDataset(jcfg, batch=4, seq=32)
        p0 = jax.tree_util.tree_map(jnp.asarray, params[case])
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=DEFAULT_RULES, mesh=mesh, seq_chunk=16, block_q=16,
                                   block_k=16), has_aux=True), in_shardings=(sh["params"], sh["batch"]))
        (_, met), grads = grad_fn(jax.device_put(p0, sh["params"]), ds.at(0))
        o = jax.tree_util.tree_map(jax.device_put, j_init_opt_state(p0, jt), dict(sh["opt_state"]))
        p, losses = jax.device_put(p0, sh["params"]), []
        for i in range(steps):
            p, o, m = step(p, o, ds.at(i))
            losses.append(float(m["loss"]))
        res[case] = {"grads": dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, grads))),
                     "losses": losses, "lb": float(met["lb"]),
                     "params": dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, p)))}
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
def weights():
    return {case: _jax_params(case) for case in TRAIN_MOE_CASES}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """The reference's mesh steps and the pool's three layouts, started
    together: ({case: reference}, {case: [each rank's summary]}, {case:
    rank 0's arrays})."""
    tmp = tmp_path_factory.mktemp("train_moe")
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {"reference": subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "reference", str(tmp / "weights.pkl"), str(tmp / "ref.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={N_POOL}", JAX_PLATFORMS="cpu"))}
    for tp, cases in LAYOUTS.items():
        with open(tmp / f"in{tp}.pkl", "wb") as f:
            pickle.dump({"train_moe": {"cases": cases, "params": {c: weights[c] for c in cases}}}, f)
        procs[tp] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.multidev_checks", "train_moe", str(N_POOL), "cpu",
             "--inputs", str(tmp / f"in{tp}.pkl"), "--out", str(tmp / f"out{tp}.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    failed = []
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        ok = "OK reference" if name == "reference" else "OK train_moe"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    summaries, arrays = {}, {}
    for tp in LAYOUTS:
        with open(tmp / f"out{tp}.pkl", "rb") as f:
            ranks = [r["train_moe"] for r in pickle.load(f)]
        assert len(ranks) == N_POOL
        for case in LAYOUTS[tp]:
            summaries[case] = [r["summary"][case] for r in ranks]
            arrays[case] = ranks[0]["arrays"][case]
    return ref, summaries, arrays


@pytest.fixture(scope="module")
def one_process(weights):
    """The port's one-process (TP 2, dp 2) step of each (2, 2) case, here."""
    out = {}
    for case in ONE_PROCESS:
        model, tp, steps, _ = TRAIN_MOE_CASES[case]
        cfg = reduced(get_config(model))
        run = one_process_run(cfg, tp, N_POOL // tp, to_torch(weights[case], device="cpu"), _train_cfg(
            {"warmup_steps": 2}), SyntheticDataset(cfg, batch=4, seq=32), steps)
        out[case] = {"grads": _leaves(run["grads"]), "losses": run["losses"], "params": _leaves(run["params"])}
    return out


def _leaves(tree) -> dict:
    """{path: numpy array} of a tree of arrays or tensors."""
    return {path: t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for path, t in tree_leaves_with_path(tree)}


def _grad_tol(case: str) -> float:
    return CONDITIONED_GRAD_TOL.get(case, GRAD_TOL.get(TRAIN_MOE_CASES[case][0], 1e-4))


def _grads_within(got: dict, want: dict, tol: float, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        err = np.abs(got[path] - w).max() / np.abs(w).max()
        assert err <= tol, f"{what}: {'/'.join(path)}: {err:.2e} of max|g| {np.abs(w).max():.3e}"


def _steps_within(losses, params: dict, want: dict, case: str, what: str) -> None:
    """The losses within LOSS_RTOL; every parameter element within
    PARAM_TOL but at most UNSIGNED_OFF[case] of those whose step-1
    gradient the gradient check cannot sign (within its tolerance of
    zero): Adam's first steps are sign steps, so there an f32 rounding of
    the gradient steps the other way. Those lie within two lr-sized steps
    a step of the reference."""
    np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL, err_msg=what)
    opt = _train_cfg({"warmup_steps": 2}).opt
    reach = 2 * sum(opt.lr * min(t / opt.warmup_steps, 1.0) for t in range(1, len(losses) + 1))
    unsigned_off = 0
    for path, w in want["params"].items():
        g = want["grads"][path]
        unsigned = np.abs(g) <= _grad_tol(case) * np.abs(g).max()
        off = ~np.isclose(params[path], w, **PARAM_TOL)
        leaf = f"{what}: {'/'.join(path)}"
        assert not (off & ~unsigned).any(), f"{leaf}: {np.argwhere(off & ~unsigned)[:5]} outside PARAM_TOL"
        assert (np.abs(params[path] - w)[off] <= reach + PARAM_TOL["atol"]).all(), f"{leaf}: past {reach}"
        unsigned_off += int(off.sum())
    assert unsigned_off <= UNSIGNED_OFF.get(case, 0), f"{what}: {unsigned_off} unsigned elements outside PARAM_TOL"


@pytest.mark.parametrize("case", list(TRAIN_MOE_CASES))
def test_pool_gradients_match_reference_mesh(case, runs):
    """Every leaf's gradient of batch 0 (the pool's shards gathered whole,
    summed over the data groups) within GRAD_TOL of the mesh's
    value_and_grad: the MoE's block-mean aux losses, the all-to-all, the
    TP-1 gather and the Mamba layers' shared sums under autograd."""
    ref, _, arrays = runs
    _grads_within(_leaves(arrays[case]["grads"]), ref[case]["grads"], _grad_tol(case), f"pool {case}")


@pytest.mark.parametrize("case", list(TRAIN_MOE_CASES))
def test_pool_steps_match_reference_mesh(case, runs):
    """The losses and the parameters after the case's steps (three; one on
    jamba's init_params weights) against the mesh step's."""
    ref, summaries, arrays = runs
    a = arrays[case]
    assert len(a["losses"]) == TRAIN_MOE_CASES[case][2]
    _steps_within(a["losses"], _leaves(a["params"]), ref[case], case, f"pool {case}")
    for s in summaries[case]:  # every rank reports the global loss
        assert s["losses"] == a["losses"]


@pytest.mark.parametrize("case", list(TRAIN_MOE_CASES))
def test_pool_keeps_replication_and_matches_one_process(case, runs):
    """The check raised otherwise: the replication after every step on
    every rank, and rank 0's hold of the pool to the one-process step
    (whose layout computes the mesh's), each leaf within UPDATE_RTOL of its
    update."""
    _, summaries, _ = runs
    _, tp, _, _ = TRAIN_MOE_CASES[case]
    for s in summaries[case]:
        assert s["mesh"] == {"data": N_POOL // tp, "model": tp} and s["replicated_after_every_step"]
    one = summaries[case][0]["one_process"]
    assert (one["tp"], one["dp"]) == ((tp, N_POOL // tp) if tp > 1 else (1, 1))
    assert one["outside"] is None and one["update_rel"] < UPDATE_RTOL and one["loss_rel"] < LOSS_RTOL


@pytest.mark.parametrize("case", ONE_PROCESS)
def test_one_process_step_matches_reference_mesh(case, runs, one_process):
    """The one-process (TP 2, dp 2) step, its data groups one after another
    and its TP ranks in one process, against the mesh: gradients, losses
    and parameters as the pool's."""
    ref, _, _ = runs
    got = one_process[case]
    _grads_within(got["grads"], ref[case]["grads"], _grad_tol(case), f"one process {case}")
    _steps_within(got["losses"], got["params"], ref[case], case, f"one process {case}")


if __name__ == "__main__":
    {"reference": lambda: _reference(sys.argv[2], sys.argv[3])}[sys.argv[1]]()
