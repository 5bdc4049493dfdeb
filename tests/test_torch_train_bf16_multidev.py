"""bf16 training across processes, held to the reference's bf16 mesh step,
under gloo.

The pool runs in a subprocess, ``python -m repro_torch.testing.multidev_checks
train_bf16 4 cpu`` (four processes, one rank each), on bf16 parameters with
f32 moments, fed the reference's bf16 weights. The reference's mesh step
runs in another subprocess, ``python tests/test_torch_train_bf16_multidev.py
reference <weights.pkl> <out.pkl>``, whose XLA_FLAGS ask for 4 host devices
before JAX starts: ``make_train_step`` with ``DEFAULT_RULES`` on a mesh of
(data 4/t, model t) on the same bf16 weights (f32 moments, its
``AdamWConfig.dtype``), and ``jax.value_and_grad`` of its ``loss_fn`` on
that mesh. Both start together.

The case (``multidev_checks.TRAIN_BF16_CASES``): reduced h2o-danube-1.8b
at (data 2, model 2), three steps, lr 1e-3, warm-up 2,
SyntheticDataset(4, 32), chunks and blocks of 16. What it holds: the
gradients of batch 0 summed over the data group (the reference's psum of
the parameter-dtype gradient, in f32 and rounded once to bf16 as XLA
compiles it), the ZeRO-1 slices gathered in bf16,
and the rounding points of a bf16 train step (``models.rounding``) across
processes.

Held: every leaf's bf16 gradient of batch 0 within BF16_GRAD_TOL of its
greatest element; the first loss within FIRST_LOSS_RTOL and the others
within BF16_LOSS_RTOL; every parameter leaf within BF16_UPDATE_RTOL of
its update of the reference's after the steps (Adam's first steps are
near sign steps: there a rounding-level gradient gap steps either way,
and later steps carry it on). Controls, each failing the same holds: the
parameters left where they started (a pool that never applies its
update), and the gradient of one data group's rows alone (a data group
that broadcasts one rank's gradient instead of summing them).
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
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402

from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.testing.multidev_checks import TRAIN_BF16_CASES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_POOL = 4
CASE = "danube_2x2"
# measured on this CPU (``python tests/test_torch_train_bf16_multidev.py`` prints each reading): the gradient gap
# 2.44e-2 (one data group's gradient alone: 1.41); the first loss bit for bit, the next two 5.8e-5 and 1.7e-4; the
# worst leaf's update distance 0.238 (wq), the parameters left where they started 1.0
BF16_GRAD_TOL = 3e-2  # test_torch_train_bf16.py's for h2o-danube on one device (1.5e-2 measured there)
FIRST_LOSS_RTOL = 1e-6  # test_torch_train_bf16.py's for h2o-danube
BF16_LOSS_RTOL = 4e-4
BF16_UPDATE_RTOL = 0.5  # Adam's first steps turn rounding-level gradient gaps into whole steps


def _weights() -> dict:
    """The reference's weights of CASE rounded to bf16, as f32 numpy."""
    model, tp, _ = TRAIN_BF16_CASES[CASE]
    jcfg = j_reduced(j_get_config(model))
    p = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, tp)), jax.random.PRNGKey(0), jnp.float32)
    return jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.bfloat16).astype(jnp.float32)), p)


def _f32(tree) -> dict:
    return dict(tree_leaves_with_path(jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.float32)), tree)))


def _reference(weights: str, out: str) -> None:
    """CASE's bf16 mesh step over 4 host devices: value_and_grad of loss_fn
    on batch 0 (and on the first data group's rows of it alone), then the
    case's steps of make_train_step."""
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
    model, tp, steps = TRAIN_BF16_CASES[CASE]
    jcfg = j_reduced(j_get_config(model))
    ec = j_make_exec_config(jcfg, tp)
    mesh = Mesh(np.array(jax.devices()[:N_POOL]).reshape(N_POOL // tp, tp), ("data", "model"))
    jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=2), seq_chunk=16, block_q=16, block_k=16)
    step, sh = j_make_train_step(jcfg, ec, DEFAULT_RULES, mesh, jt)
    ds = JSyntheticDataset(jcfg, batch=4, seq=32)
    p0 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=DEFAULT_RULES, mesh=mesh, seq_chunk=16, block_q=16,
                               block_k=16), has_aux=True), in_shardings=(sh["params"], sh["batch"]))
    _, grads = grad_fn(jax.device_put(p0, sh["params"]), ds.at(0))
    half = {k: v[:4 // (N_POOL // tp)] for k, v in ds.at(0).items()}  # one data group's rows
    _, half_grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, ec, b, rules=DEFAULT_RULES, mesh=None, seq_chunk=16, block_q=16,
                               block_k=16), has_aux=True))(p0, half)
    o = jax.tree_util.tree_map(jax.device_put, j_init_opt_state(p0, jt), dict(sh["opt_state"]))
    p, losses = jax.device_put(p0, sh["params"]), []
    for i in range(steps):
        p, o, m = step(p, o, ds.at(i))
        losses.append(float(m["loss"]))
    res = {"grads": _f32(grads), "half_grads": _f32(half_grads), "losses": losses, "params": _f32(p),
           "dtypes": sorted({str(x.dtype) for x in jax.tree_util.tree_leaves(p)}),
           "moment_dtypes": sorted({str(x.dtype) for x in jax.tree_util.tree_leaves(o["mu"])})}
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print(f"{CASE}: losses {losses}\nOK reference")


def run_both(tmp: Path):
    """The reference's bf16 mesh step and the pool's, started together in
    ``tmp``: (reference, [each rank's summary], rank 0's arrays, the
    weights)."""
    weights = _weights()
    with open(tmp / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"train_bf16": {"params": {CASE: weights}, "cases": [CASE]}}, f)
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
        stdout, stderr = p.communicate(timeout=600)
        ok = "OK reference" if name == "reference" else "OK train_bf16"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "out.pkl", "rb") as f:
        ranks = [r["train_bf16"] for r in pickle.load(f)]
    assert len(ranks) == N_POOL
    return ref, [r["summary"] for r in ranks], ranks[0]["arrays"], dict(tree_leaves_with_path(weights))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("train_bf16"))


def grad_gap(got: dict, want: dict) -> float:
    """The greatest leaf's max |got - want| over its max |want|."""
    return max(float(np.abs(got[path] - w).max() / np.abs(w).max()) for path, w in want.items())


def update_rel(got: dict, want: dict, start: dict) -> float:
    """The greatest leaf's ||got - want|| over the reference's update
    ||want - start||: a pool left where it started reads 1.0."""
    return max(float(np.linalg.norm(got[path] - w) / np.linalg.norm(w - start[path])) for path, w in want.items())


def _leaves(tree) -> dict:
    return {path: np.asarray(t) for path, t in tree_leaves_with_path(tree)}


def test_bf16_pool_gradients_match_reference_mesh(runs):
    """Every leaf's bf16 gradient of batch 0, gathered over the data and
    model groups, within BF16_GRAD_TOL of its greatest element from the
    mesh's; one data group's gradient alone (a data group that does not
    sum) lies past it."""
    ref, _, arrays, _ = runs
    got = _leaves(arrays[CASE]["grads"])
    assert sorted(got) == sorted(ref["grads"])
    assert grad_gap(got, ref["grads"]) <= BF16_GRAD_TOL
    assert grad_gap(ref["half_grads"], ref["grads"]) > BF16_GRAD_TOL


def test_bf16_pool_steps_match_reference_mesh(runs):
    """The first loss within FIRST_LOSS_RTOL of the mesh step's and every
    loss within BF16_LOSS_RTOL; every parameter leaf within
    BF16_UPDATE_RTOL of the mesh step's update (bf16 parameters on both
    sides, f32 moments); every rank the same losses. The parameters left
    where they started read 1.0, past it."""
    ref, summaries, arrays, start = runs
    losses = arrays[CASE]["losses"]
    assert len(losses) == TRAIN_BF16_CASES[CASE][2]
    assert ref["dtypes"] == ["bfloat16"] and ref["moment_dtypes"] == ["float32"]
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, ref["losses"], rtol=BF16_LOSS_RTOL)
    assert update_rel(_leaves(arrays[CASE]["params"]), ref["params"], start) < BF16_UPDATE_RTOL
    assert update_rel(start, ref["params"], start) > BF16_UPDATE_RTOL
    for s in summaries:
        assert s[CASE]["losses"] == losses and s[CASE]["dtypes"] == ["torch.bfloat16"]
        assert s[CASE]["replicated_after_every_step"]


def test_pool_of_one_is_one_process_bit_for_bit(tmp_path):
    """A pool of one process against the one-process step (``python -m
    repro_torch.testing.multidev_checks train_one 1 cpu``: reduced
    h2o-danube in f32 and bf16, jamba's first layer in bf16): the gradients
    of batch 0, three losses and the parameters after them bit for bit (the
    check raises otherwise). A model group of one gathers nothing: the
    logits keep one process's layout, so the CE sums in its order."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.testing.multidev_checks", "train_one", "1", "cpu",
                          "--out", str(tmp_path / "out.pkl")], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0 and "OK train_one" in out.stdout, out.stdout + out.stderr
    with open(tmp_path / "out.pkl", "rb") as f:
        summary = pickle.load(f)[0]["train_one"]["summary"]
    assert sorted(summary) == ["danube_bf16", "danube_f32", "jamba_bf16"]
    assert all(s["bitwise"] and len(s["losses"]) == 3 for s in summary.values())


if __name__ == "__main__":
    if sys.argv[1:2] == ["reference"]:
        _reference(sys.argv[2], sys.argv[3])
    else:  # the readings the tolerances rest on
        import tempfile

        ref, summaries, arrays, start = run_both(Path(tempfile.mkdtemp(prefix="train_bf16")))
        got = _leaves(arrays[CASE]["grads"])
        print(f"gradient gap {grad_gap(got, ref['grads']):.3e}; one data group's alone "
              f"{grad_gap(ref['half_grads'], ref['grads']):.3e}")
        print(f"losses {arrays[CASE]['losses']} vs {ref['losses']}")
        print(f"update distance: pool {update_rel(_leaves(arrays[CASE]['params']), ref['params'], start):.3e}, "
              f"left at the start {update_rel(start, ref['params'], start):.3e}")
