"""The port's checkpoint/checkpoint.py, training/loop.py and
parallel/pipeline.py: a crashed-and-resumed run equals the uninterrupted
one bit for bit (the reference's restart test, also with ZeRO-1 moments),
checkpoints written by either package load into the other, and
pipeline_apply's tick schedule equals the sequential stack.

Tolerances: the restart and the checkpoint round trips are bitwise. The
pipeline equals the port's own sequential stack bitwise (the same matmuls
on the same microbatches) and the reference's stack (jnp on all
microbatches at once) within 2e-5, tests/test_pipeline.py's bound
(measured 1.9e-6 at every stage count).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as j_ckpt  # noqa: E402
from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training.train_step import TrainStepConfig as JTrainStepConfig, init_opt_state as j_init_opt_state  # noqa: E402

from repro_torch.checkpoint import checkpoint  # noqa: E402
from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import init_params, model_param_defs  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.parallel.pipeline import make_pipe_mesh, pipeline_apply  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.training.data import SyntheticDataset  # noqa: E402
from repro_torch.training.grad_compress import CompressConfig  # noqa: E402
from repro_torch.training.loop import LoopConfig, SimulatedFailure, train_loop  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, Zero1Shards, zero1_plan  # noqa: E402
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step  # noqa: E402

NAME = "h2o-danube-1.8b"
KW = dict(seq_chunk=16, block_q=16, block_k=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return [np.asarray(x.full() if isinstance(x, Zero1Shards) else x.detach() if isinstance(x, torch.Tensor) else x)
            for x in checkpoint.tree_leaves(tree)]


@pytest.mark.parametrize("dp", [1, 2])
def test_checkpoint_restart_bitwise_identical(tmp_path, dp):
    """Crash at step 7, resume from step 4's checkpoint into fresh tensors:
    the losses of steps 4-11 and the end state (params, moments, the error
    feedback, the count) equal the uninterrupted run's exactly; at dp 2 the
    moments are ZeRO-1 shards."""
    cfg = reduced(get_config(NAME))
    ec = make_exec_config(cfg, dp)
    params0 = init_params(model_param_defs(cfg, ec), torch.Generator().manual_seed(0))
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=1e-3), compress=CompressConfig(enabled=True, block=256), **KW)
    ds = SyntheticDataset(cfg, batch=2 * dp, seq=32)

    def fresh():
        p = tree_map(lambda t: t.clone(), params0)
        step, plan = make_train_step(cfg, ec, p, tcfg, dp=dp)
        return step, p, init_opt_state(p, tcfg, plan)

    step, p, o = fresh()
    ref = train_loop(step, p, o, ds, LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "a")))
    step, p, o = fresh()
    with pytest.raises(SimulatedFailure):
        train_loop(step, p, o, ds, LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "b")), fail_at=7)
    assert checkpoint.latest_checkpoint(str(tmp_path / "b")).endswith("step_00000004")
    step, p, o = fresh()
    res = train_loop(step, p, o, ds, LoopConfig(total_steps=12, ckpt_every=4, ckpt_dir=str(tmp_path / "b")))
    assert res.resumed_from == 4 and res.step == 12
    assert res.losses == ref.losses[4:]
    assert res.params is p and res.opt_state is o  # resumed into the same tensors
    for a, b in zip(_leaves((ref.params, ref.opt_state)), _leaves((res.params, res.opt_state))):
        np.testing.assert_array_equal(a, b)


def _jax_state():
    jcfg = j_reduced(j_get_config(NAME))
    jp = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)
    jo = j_init_opt_state(jp, JTrainStepConfig(opt=JAdamWConfig()))
    rng = np.random.RandomState(0)
    jo = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)) if x.ndim else x + 3, jo)
    return jp, jo


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """The reference's (params, opt_state) checkpoint loads into the port's
    trees, with whole and with ZeRO-1 moments, bit for bit."""
    jp, jo = _jax_state()
    path = j_ckpt.save_checkpoint(str(tmp_path), 4, (jp, jo), {"note": "from jax"})
    cfg = reduced(get_config(NAME))
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    params = init_params(defs, torch.Generator().manual_seed(1))
    for plan in (None, zero1_plan(defs, 2)):
        opt = init_opt_state(params, TrainStepConfig(), plan)
        (p2, o2), step, meta = checkpoint.load_checkpoint(path, (params, opt))
        assert step == 4 and meta == {"note": "from jax"} and int(o2["count"]) == 3
        assert o2["count"].dtype == torch.int32
        assert isinstance(o2["mu"]["embed"], Zero1Shards) == (plan is not None)
        for a, b in zip(_leaves((jp, jo)), _leaves((p2, o2))):
            np.testing.assert_array_equal(a, b)
        checkpoint.assign_((params, opt), (p2, o2))
        for a, b in zip(_leaves((jp, jo)), _leaves((params, opt))):
            np.testing.assert_array_equal(a, b)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """The port's checkpoint (ZeRO-1 moments written whole, leaves in the
    reference's order) loads with the reference's load_checkpoint into its
    (params, opt_state) tree, bit for bit; the files are the reference's
    layout, written atomically."""
    jp, jo = _jax_state()
    cfg = reduced(get_config(NAME))
    defs = model_param_defs(cfg, make_exec_config(cfg, 1))
    params = to_torch(jp, device="cpu")
    opt = init_opt_state(params, TrainStepConfig(), zero1_plan(defs, 2))
    src = (to_torch(jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
           {"count": torch.tensor(3, dtype=torch.int32), "mu": to_torch(jo["mu"], device="cpu"),
            "nu": to_torch(jo["nu"], device="cpu")})
    checkpoint.assign_((params, opt), src)
    path = checkpoint.save_checkpoint(str(tmp_path), 8, (params, opt))
    assert os.path.basename(path) == "step_00000008" and not any(n.startswith(".tmp") for n in os.listdir(tmp_path))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["leaves"][0]["path"] == "leaf_00000.npy" and manifest["n_leaves"] == len(_leaves((jp, jo)))
    (jp2, jo2), step, _ = j_ckpt.load_checkpoint(path, (jp, jo))
    assert step == 8
    for a, b in zip(_leaves((jp, jo)), _leaves((jp2, jo2))):
        np.testing.assert_array_equal(a, b)


def test_pipeline_matches_sequential_stack():
    """tests/test_pipeline.py's check on the port: 8 periods of tanh(h @ w)
    over 1, 2 and 4 stages and 4 microbatches (bubbles included) against the
    port's sequential stack and the reference's."""
    L, D, n_micro, Bm, S = 8, 32, 4, 2, 8
    rng = np.random.RandomState(0)
    w = (rng.randn(L, D, D) * 0.3).astype(np.float32)
    h0 = rng.randn(n_micro, Bm, S, D).astype(np.float32)
    want = jnp.asarray(h0)
    for i in range(L):
        want = jnp.tanh(want @ jnp.asarray(w[i]))
    params, th0 = {"w": torch.from_numpy(w)}, torch.from_numpy(h0)
    seq = [th0[m] for m in range(n_micro)]
    for i in range(L):
        seq = [torch.tanh(h @ params["w"][i]) for h in seq]
    calls = []

    def body(h, p, k):
        calls.append(k)
        return torch.tanh(h @ p["w"])

    for n_stages in (1, 2, 4):
        calls.clear()
        mesh = make_pipe_mesh([torch.device("cpu")] * 4, n_stages=n_stages, tp=4 // n_stages)
        assert mesh.shape == {"pipe": n_stages, "data": 1, "model": 4 // n_stages}
        out = pipeline_apply(body, params, th0, mesh, n_periods=L)
        assert len(calls) == n_micro * L  # bubbles compute nothing
        assert torch.equal(out, torch.stack(seq))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        pipeline_apply(body, params, th0, make_pipe_mesh([torch.device("cpu")] * 3, n_stages=3), n_periods=L)
