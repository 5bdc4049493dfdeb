"""Training across processes (slice 17) held to the reference, under gloo.

The pool runs in a subprocess, as tests/test_torch_multidev.py runs its
checks: ``python -m repro_torch.testing.multidev_checks train_step 4 cpu``
(four processes, one rank each, at data 2 x model 2) fed the reference's
weights through ``checkpoint.convert``. This process computes the
reference's single-device ``make_train_step`` in JAX on the CPU from the
same numpy weights and batches, and holds the pool's to it:

  five steps at a warm-up of 2 (so that the parameters move past the
      tolerance), plain, with accum_steps=2 and compressed (int8 blocks of
      256): losses within 2e-4 relative, parameters (gathered over the
      model group) at rtol 5e-3, atol 5e-4 (tests/test_torch_train_step.py's
      tolerances); inside the pool, against its own single-rank step, each
      leaf within 1e-2 of its update, after every step, the parameters
      bit-equal across each data group and the replicated leaves across
      each model group, and the ZeRO-1 moments one slice per data rank;
  the elastic checkpoint: the plain run cut at step 3 (rank 0 writes every
      leaf whole), resumed at data 4 x model 1 (in the pool) and on one
      process (here), within those tolerances of the uncut run; the saved
      leaves load into one process bit for bit equal to the pool's state
      gathered at the cut;
  the collectives under autograd (world 2): every gradient of a vocab-
      parallel embedding, two norm scales before column -> row MLPs and the
      tied head equal to the one-process TP 2 ranks' within 1e-6; the
      all-to-all, ``reduce_shared``, ``gather_summed`` and ``pool_mean``
      alone, and the MoE and Mamba layers through them, against one
      process holding every rank's inputs.
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
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402
from repro.training.data import SyntheticDataset as JSyntheticDataset  # noqa: E402
from repro.training.grad_compress import CompressConfig as JCompressConfig  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.train_step import (  # noqa: E402
    TrainStepConfig as JTrainStepConfig, init_opt_state as j_init_opt_state, make_train_step as j_make_train_step,
)

from repro_torch.checkpoint.checkpoint import latest_checkpoint, load_checkpoint, tree_leaves  # noqa: E402
from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.testing.multidev_checks import (  # noqa: E402
    ELASTIC_CUT, LOSS_RTOL, PARAM_TOL, TRAIN_STEPS, UPDATE_RTOL, _train_cfg,
)
from repro_torch.training.data import SyntheticDataset  # noqa: E402
from repro_torch.training.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.training.train_step import init_opt_state, make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = "h2o-danube-1.8b"
CASES = {"plain": {"warmup_steps": 2}, "accum_2": {"warmup_steps": 2, "accum_steps": 2},
         "compressed": {"warmup_steps": 2, "compress": True, "block": 256}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(tmp_path, check: str, world: int, inputs: dict) -> list:
    """The port's pool check ``check`` on ``world`` processes under gloo;
    every rank's result."""
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


def _jax_params():
    jcfg = j_reduced(j_get_config(NAME))
    return jcfg, j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def pool_run(tmp_path_factory):
    """The pool's three cases and the elastic checkpoint, in one spawn."""
    tmp = tmp_path_factory.mktemp("train_pool")
    _, jp = _jax_params()
    inputs = {"params": jax.tree_util.tree_map(np.asarray, jp), "cases": CASES, "ckpt_dir": str(tmp / "ckpt")}
    return _pool(tmp, "train_step", 4, inputs), tmp / "ckpt"


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device step, five steps of each case."""
    jcfg, jp0 = _jax_params()
    out = {}
    for kind, case in CASES.items():
        jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=case["warmup_steps"]),
                              compress=JCompressConfig(enabled=case.get("compress", False), block=case.get("block", 2048)),
                              seq_chunk=16, block_q=16, block_k=16, accum_steps=case.get("accum_steps", 1))
        jstep, _ = j_make_train_step(jcfg, j_make_exec_config(jcfg, 1), DEFAULT_RULES, None, jt)
        jp = jax.tree_util.tree_map(jnp.copy, jp0)
        jo = j_init_opt_state(jp, jt)
        ds, losses = JSyntheticDataset(jcfg, batch=4, seq=32), []
        for i in range(TRAIN_STEPS):
            jp, jo, m = jstep(jp, jo, ds.at(i))
            losses.append(float(m["loss"]))
        out[kind] = (losses, dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))))
    return out


def _close_params(got: dict, want: dict, what: str) -> None:
    for path, a in tree_leaves_with_path(got):
        np.testing.assert_allclose(a, want[path], **PARAM_TOL, err_msg=f"{what}: {'/'.join(path)}")


@pytest.mark.parametrize("kind", list(CASES))
def test_pool_five_steps_match_reference(kind, pool_run, reference):
    ranks, _ = pool_run
    got = ranks[0]["arrays"]["cases"][kind]
    want_losses, want_params = reference[kind]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _close_params(got["params"], want_params, kind)
    for r in ranks:  # every rank reports the global loss
        assert r["summary"]["cases"][kind]["losses_pool"] == got["losses"]
        assert r["summary"]["cases"][kind]["update_rel"] < UPDATE_RTOL


@pytest.mark.parametrize("kind", list(CASES))
def test_pool_keeps_replication_and_splits_moments(kind, pool_run):
    """The check raised otherwise: each data group's parameters and each
    model group's replicated leaves bit-equal after every step; every leaf
    of reduced h2o-danube has a dim data 2 splits."""
    ranks, _ = pool_run
    for r in ranks:
        s = r["summary"]
        assert s["mesh"] == {"data": 2, "model": 2}
        case = s["cases"][kind]
        assert case["replicated_after_every_step"] and case["zero1_split_leaves"] == case["leaves"] == 12


def test_elastic_checkpoint_resumes_at_another_layout(pool_run, reference):
    """Cut at step 3 under data 2 x model 2, resumed at data 4 x model 1:
    the losses (held inside the pool) and the parameters within the
    tolerances of the uncut run, and of the reference."""
    ranks, _ = pool_run
    el = ranks[0]["summary"]["elastic"]
    assert el["cut"] == ELASTIC_CUT == 3 and el["resumed_data_model"] == [4, 1] and len(el["resumed_losses"]) == 2
    uncut = ranks[0]["arrays"]["cases"]["plain"]
    np.testing.assert_allclose(el["resumed_losses"], uncut["losses"][ELASTIC_CUT:], rtol=LOSS_RTOL)
    np.testing.assert_allclose(el["resumed_losses"], reference["plain"][0][ELASTIC_CUT:], rtol=LOSS_RTOL)
    resumed = ranks[0]["arrays"]["elastic"]["resumed_params"]
    _close_params(resumed, dict(tree_leaves_with_path(uncut["params"])), "resumed at (4, 1)")


def test_elastic_checkpoint_loads_and_resumes_on_one_process(pool_run, reference):
    """The pool's step-3 checkpoint loads into one process bit for bit (the
    state the pool gathered at the cut), and two more steps there match the
    uncut run within the tolerances."""
    ranks, ckpt = pool_run
    path = latest_checkpoint(str(ckpt))
    assert path is not None and path.endswith("step_00000003")
    cfg = reduced(get_config(NAME))
    _, jp = _jax_params()
    params = to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tcfg = _train_cfg(CASES["plain"])
    step, _ = make_train_step(cfg, make_exec_config(cfg, 1), params, tcfg)
    opt = init_opt_state(params, tcfg)
    (p3, o3), at, _ = load_checkpoint(path, (params, opt))
    assert at == 3
    saved = ranks[0]["arrays"]["elastic"]["state_at_cut"]
    loaded = [x.detach().numpy() for x in tree_leaves((p3, o3))]
    assert len(saved) == len(loaded)
    for a, b in zip(loaded, saved):
        np.testing.assert_array_equal(a, b)
    st = train_loop(step, params, opt, SyntheticDataset(cfg, batch=4, seq=32),
                    LoopConfig(total_steps=5, ckpt_every=10 ** 9, ckpt_dir=str(ckpt)))
    assert st.resumed_from == 3
    uncut = ranks[0]["arrays"]["cases"]["plain"]
    np.testing.assert_allclose(st.losses, uncut["losses"][3:], rtol=LOSS_RTOL)
    _close_params(_nested(params), reference["plain"][1], "resumed on one process")


def _nested(params):
    return {k: _nested(v) if isinstance(v, dict) else v.detach().numpy() for k, v in params.items()}


@pytest.fixture(scope="module")
def grads_run(tmp_path_factory):
    """check_train_grads on a pool of 2, every rank's summary."""
    return [r["summary"] for r in _pool(tmp_path_factory.mktemp("train_grads"), "train_grads", 2, {})]


def test_collectives_gradients_equal_one_process(grads_run):
    """world 2: every leaf's gradient (shards and the norm scales whole)
    within 1e-6 of the one-process TP 2 ranks' (the check raises
    otherwise)."""
    for s in grads_run:
        errs = s["max_abs_err"]
        assert set(errs) == {"embed", "norm1", "norm2", "w1", "w2", "w3", "w4"}
        assert max(errs.values()) <= 1e-6


@pytest.mark.parametrize("name", ["all_to_all", "reduce_shared", "gather_summed", "pool_mean"])
def test_autograd_collective_equals_one_process(name, grads_run):
    """world 2: each collective under autograd, alone, against one process
    holding every rank's inputs, within 1e-6: the all-to-all (its backward
    the same exchange), the psum whose backward sums (``reduce_shared``),
    the data group's gather whose backward is a reduce-scatter, and the
    aux losses' mean over the pool at TP 1 and 2 (each rank's value counted
    once though every data group's objective holds it)."""
    for s in grads_run:
        assert s["collectives"][name] <= 1e-6


@pytest.mark.parametrize("name", ["moe_sharded", "moe_decode", "moe_tp1", "mamba1", "mamba2"])
def test_layer_gradients_across_processes_equal_one_process(name, grads_run):
    """world 2: reduced moonshot's MoE layer on the sharded path, the decode
    path and the TP-1 path over two data groups, reduced jamba's Mamba-1
    and reduced mamba2's Mamba-2 layer: the input's and every leaf's
    gradient (this rank's shard; at TP 1 summed over the data group)
    within 1e-6 of its greatest element from one process's: the CPU's
    sums hold it tighter than the check's LAYER_GRAD_RTOL, which the
    card's kernels at another batch split need."""
    for s in grads_run:
        assert s["layers"][name] <= 1e-6
