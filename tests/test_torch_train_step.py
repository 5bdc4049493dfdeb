"""The port's train step (training/train_step.py) against the reference's
make_train_step on reduced h2o-danube-1.8b and the same weights and
batches: five steps plain, with accum_steps=2 and with int8 compression;
the port of check_train_step (data 2 x model 2 with ZeRO-1 against a single
rank); data groups under a mask; and the counterparts of
tests/test_training.py: the loss falls, and compressed training converges.

Tolerances: the reference's check_train_step's own, losses within 2e-4
relative (measured <= 3.4e-6, the compressed run's) and params at
rtol=5e-3, atol=5e-4 (measured <= 3.1e-4 absolute plain and with
accumulation, 1.0e-3 with compression, within rtol). Adam's update
normalises each gradient element, so where a gradient is ~0 its f32
rounding moves the step by up to lr; int8 rounding amplifies that.
"""
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

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import init_params, model_param_defs  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.testing.multidev_checks import check_train_step  # noqa: E402
from repro_torch.training.data import SyntheticDataset  # noqa: E402
from repro_torch.training.grad_compress import CompressConfig  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, Zero1Shards  # noqa: E402
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step  # noqa: E402

NAME = "h2o-danube-1.8b"
LOSS_RTOL, PARAM_TOL = 2e-4, dict(rtol=5e-3, atol=5e-4)
KW = dict(seq_chunk=16, block_q=16, block_k=16)


@pytest.fixture(autouse=True)
def _one_thread():
    """The shapes here are tiny: one intra-op thread runs them faster, and
    keeps parallel test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return j_reduced(j_get_config(NAME)), reduced(get_config(NAME))


def _port_params(seed=0):
    cfg = reduced(get_config(NAME))
    return init_params(model_param_defs(cfg, make_exec_config(cfg, 1)), torch.Generator().manual_seed(seed))


def _run(cfg, params, tcfg, steps, dp=1, tp=1, batch=4):
    step, plan = make_train_step(cfg, make_exec_config(cfg, tp), params, tcfg, dp=dp)
    opt = init_opt_state(params, tcfg, plan if dp > 1 else None)
    ds = SyntheticDataset(cfg, batch=batch, seq=32)
    return [float(step(params, opt, ds.at(i))[2]["loss"]) for i in range(steps)], opt


@pytest.mark.parametrize("kind", ["plain", "accum_2", "compressed"])
def test_five_steps_match_reference(kind):
    jcfg, cfg = _cfgs()
    extra = {"accum_steps": 2} if kind == "accum_2" else {}
    on = kind == "compressed"
    jt = JTrainStepConfig(opt=JAdamWConfig(lr=1e-3, warmup_steps=2), compress=JCompressConfig(enabled=on, block=256),
                          **KW, **extra)
    tt = TrainStepConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2), compress=CompressConfig(enabled=on, block=256),
                         **KW, **extra)
    jp = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(0), jnp.float32)
    params = to_torch(jp, device="cpu")
    jstep, _ = j_make_train_step(jcfg, j_make_exec_config(jcfg, 1), DEFAULT_RULES, None, jt)
    jo = j_init_opt_state(jp, jt)
    ds = JSyntheticDataset(jcfg, batch=4, seq=32)
    want = []
    for i in range(5):
        jp, jo, m = jstep(jp, jo, ds.at(i))
        want.append(float(m["loss"]))
    got, opt = _run(cfg, params, tt, 5)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    jleaves = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp)))
    for path, t in tree_leaves_with_path(params):
        np.testing.assert_allclose(t.detach().numpy(), jleaves[path], **PARAM_TOL, err_msg="/".join(path))
    assert int(opt["count"]) == 5 and ("err" in opt) == on


def test_check_train_step():
    """Data 2 x model 2 with ZeRO-1 moments equals one rank over 5 steps (the
    reference's check_train_step, its tolerances); every leaf's moments
    split over the 2 data ranks."""
    out = check_train_step("cpu")
    assert len(out["losses_sharded"]) == 5 and out["zero1_split_leaves"] == out["leaves"]


def test_data_groups_share_the_global_loss_under_a_mask():
    """Two data groups of a batch whose masks hold different counts: the
    loss and the gradients are the single group's (each group's CE over
    the global count)."""
    cfg = reduced(get_config(NAME))
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=1e-3), **KW)
    base = SyntheticDataset(cfg, batch=4, seq=32).at(0)
    mask = np.ones((4, 32), np.float32)
    mask[0, 5:] = 0.0
    mask[3, 30:] = 0.0
    batch = dict(base, mask=mask)
    out = {}
    for dp in (1, 2):
        p = _port_params()
        step, plan = make_train_step(cfg, make_exec_config(cfg, 1), p, tcfg, dp=dp)
        _, opt, m = step(p, init_opt_state(p, tcfg, plan), batch)
        out[dp] = (float(m["loss"]), p, opt)
    assert out[2][0] == pytest.approx(out[1][0], rel=1e-6)
    for (path, a), (_, b) in zip(tree_leaves_with_path(out[1][1]), tree_leaves_with_path(out[2][1])):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), **PARAM_TOL, err_msg="/".join(path))
    assert any(isinstance(mu, Zero1Shards) for _, mu in tree_leaves_with_path(out[2][2]["mu"]))


@pytest.mark.parametrize("compressed", [False, True])
def test_training_loss_falls(compressed):
    """tests/test_training.py's test_train_step_loss_decreases and
    test_compressed_training_still_converges on the port: 60 steps, the
    best of the last 10 losses 0.3 below the first."""
    cfg = reduced(get_config(NAME))
    tcfg = TrainStepConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=5),
                           compress=CompressConfig(enabled=compressed, block=256), **KW)
    losses, _ = _run(cfg, _port_params(), tcfg, 60)
    assert np.isfinite(losses).all()
    assert min(losses[-10:]) < losses[0] - 0.3, (losses[0], losses[-5:])


def test_step_refuses_another_params_tree():
    cfg = reduced(get_config(NAME))
    p = _port_params()
    step, _ = make_train_step(cfg, make_exec_config(cfg, 1), p, TrainStepConfig(**KW))
    other = tree_map(lambda t: t.detach().clone(), p)
    with pytest.raises(ValueError, match="in place"):
        step(other, init_opt_state(p, TrainStepConfig(**KW)), SyntheticDataset(cfg, 4, 32).at(0))
