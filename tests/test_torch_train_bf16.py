"""bf16 training against the reference: bf16 parameters, f32 moments (the
reference's ``AdamWConfig.dtype``), the same numpy inputs.

- loss_fn and the gradient of every parameter leaf for every family of
  ``test_torch_training.FAMILIES`` against ``jax.value_and_grad`` of the
  reference's loss_fn on the same bf16 weights (the f32 test's batch:
  ``synthetic_batch(cfg, 4, 32, 0)``, one padded row, chunks and blocks of
  16);
- three steps of the port's ``make_train_step`` against the reference's
  bf16 ``make_train_step`` (lr 1e-3, warm-up 2), losses and parameters;
- the one rounding point left unaligned: the reference's train-mode
  attention adds each (Q block, KV block) pair's gradients in bf16 (its
  scans' cotangent carries), the port's in f32.

The port follows the reference's compiled step where it rounds
(``models.rounding``, on in train mode: ``silu`` step by step,
``residual_sum`` and the f32 norm output that ``shared`` rounds once for
each projection, its gradients summed as XLA sums them;
``optimizer.clip_by_global_norm``'s scale in f32).
Measured on this CPU (``python tests/test_torch_train_bf16.py`` prints
each), the losses' relative gaps (``LOSS_RTOL``): h2o-danube 0 (bit for
bit), llama3-8b 7.9e-8, gemma2-2b 3.8e-6, moonshot 8.1e-8, mamba2 3.7e-6,
jamba 3.7e-3. Per leaf, the greatest gradient gap over the leaf's max |g|
(``BF16_GRAD_TOL``, about twice each): h2o-danube 1.5e-2, llama3-8b
8.2e-3, gemma2-2b 1.1e-2, moonshot 1.1e-2, mamba2 2.0e-2. Jamba (own
fan-in, as the f32 test draws it) is held by its loss alone: its leaves'
gaps run from 0.12 (final_norm) through 0.20-0.37 (attention, router)
to 1.32 (a Mamba-1 A_log), where the reference's own bf16 gradient lies
1.03 of max |g| from its f32 one and its own bf16 loss 4.5e-3 from its
f32 loss (the port's f32 gradient 1.8e-5 from the reference's): its
Mamba-1 scans amplify rounding into every leaf upstream and downstream,
and no rounding point can be told from that noise. Before the alignment
h2o-danube's loss lay 1.2e-4 from the reference's and its gradients up to
0.20 of max |g|.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models.attention import _blockwise as j_blockwise  # noqa: E402
from repro.models.model import loss_fn as j_loss_fn  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES, make_exec_config as j_make_exec_config  # noqa: E402
from repro.training import data as j_data  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training import train_step as j_train_step  # noqa: E402

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.attention import _blockwise, live_blocks  # noqa: E402
from repro_torch.models.model import loss_fn  # noqa: E402
from repro_torch.models.params import tree_leaves_with_path  # noqa: E402
from repro_torch.parallel.sharding import make_exec_config  # noqa: E402
from repro_torch.training import optimizer  # noqa: E402
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_training import FAMILIES, OWN_FAN_IN, _bound, _jax_params  # noqa: E402

KW = dict(seq_chunk=16, block_q=16, block_k=16)
LOSS_RTOL = {"gemma2-2b": 1e-5, "mamba2-2.7b": 1e-5, "jamba-v0.1-52b": 5e-3}  # others 1e-6
# jamba has none: every leaf's gap, attention, MoE and norms included, lies in the reference's own bf16 noise
BF16_GRAD_TOL = {"h2o-danube-1.8b": 3e-2, "llama3-8b": 2e-2, "gemma2-2b": 3e-2, "moonshot-v1-16b-a3b": 3e-2,
                 "mamba2-2.7b": 4e-2}
STEP_RTOL = 2e-2  # of a step's lr: what a gradient gap within BF16_GRAD_TOL moves a signed element's Adam step
STEP_FAMILIES = ["h2o-danube-1.8b"]
LR, WARMUP, STEPS = 1e-3, 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree) -> dict:
    """{path: f32 numpy array} of a tree of jax arrays or tensors."""
    return {path: (t.detach().float().numpy() if isinstance(t, torch.Tensor)
                   else np.asarray(jnp.asarray(t).astype(jnp.float32)))
            for path, t in tree_leaves_with_path(tree)}


def _batch(jcfg):
    batch = j_data.synthetic_batch(jcfg, 4, 32, 0)
    mask = np.ones((4, 32), np.float32)
    mask[1, 20:] = 0.0  # a padded row: the mask weighs the CE
    batch["mask"] = mask
    return batch


def _torch_batch(batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    return tb


def _weights(name):
    jcfg, cfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), _jax_params(jcfg, own_fan_in=name in OWN_FAN_IN))
    return jcfg, cfg, jp


def loss_and_grads(name):
    """(reference loss, port loss, reference grads, port grads) in bf16."""
    jcfg, cfg, jp = _weights(name)
    batch = _batch(jcfg)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_loss_fn(p, jcfg, j_make_exec_config(jcfg, 1), {k: jnp.asarray(v) for k, v in batch.items()},
                            rules=DEFAULT_RULES, mesh=None, **KW), has_aux=True)(jp)
    params = to_torch(jp, device="cpu")
    loss, _ = loss_fn(_bound(cfg, params), cfg, make_exec_config(cfg, 1), _torch_batch(batch), **KW)
    loss.backward()
    return float(j_loss), float(loss), _f32(j_grads), {p: t.grad.float().numpy() for p, t in tree_leaves_with_path(params)}


def _grad_gap(got: dict, want: dict) -> dict:
    return {path: float(np.abs(got[path] - w).max() / np.abs(w).max()) for path, w in want.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_loss_and_gradients_match_reference(name):
    """The bf16 loss within LOSS_RTOL and each leaf's bf16 gradient within
    BF16_GRAD_TOL of its max |g| of the reference's (jamba's loss alone:
    see the module's docstring)."""
    j_loss, loss, want, got = loss_and_grads(name)
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL.get(name, 1e-6))
    if name not in BF16_GRAD_TOL:
        return
    for path, err in _grad_gap(got, want).items():
        assert err <= BF16_GRAD_TOL[name], f"{'/'.join(path)}: {err:.2e} of max|g| {np.abs(want[path]).max():.3e}"


def three_steps(name):
    """STEPS steps of the reference's bf16 ``make_train_step`` and, from the
    same parameters and moments at each step, the port's: per step the two
    losses, the two updated parameter trees, and the reference's gradients
    at the step's start. Each step starts the port where the reference
    stands, so a step's gap is its own (Adam turns rounding-level gradient
    gaps into whole steps, which later steps would carry on)."""
    jcfg, cfg, jp = _weights(name)
    opt_kw = dict(lr=LR, warmup_steps=WARMUP)
    j_tcfg = j_train_step.TrainStepConfig(opt=j_opt.AdamWConfig(**opt_kw), **KW)
    j_step, _ = j_train_step.make_train_step(jcfg, j_make_exec_config(jcfg, 1), DEFAULT_RULES, None, j_tcfg)
    j_state = j_train_step.init_opt_state(jp, j_tcfg)
    params = to_torch(jp, device="cpu")
    tcfg = TrainStepConfig(opt=optimizer.AdamWConfig(**opt_kw), **KW)
    step, _ = make_train_step(cfg, make_exec_config(cfg, 1), params, tcfg)
    state = init_opt_state(params, tcfg)
    out = []
    for t in range(STEPS):
        b = j_data.synthetic_batch(jcfg, 4, 32, t)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        grads = _f32(jax.grad(lambda p: j_loss_fn(p, jcfg, j_make_exec_config(jcfg, 1), jb, rules=DEFAULT_RULES,
                                                  mesh=None, **KW)[0])(jp))
        with torch.no_grad():  # the port starts where the reference stands
            for tree, j_tree in ((params, jp), (state["mu"], j_state["mu"]), (state["nu"], j_state["nu"])):
                for (_, mine), (_, theirs) in zip(tree_leaves_with_path(tree), tree_leaves_with_path(j_tree)):
                    mine.copy_(torch.from_numpy(np.array(theirs.astype(jnp.float32))))
            state["count"].fill_(int(j_state["count"]))
        jp, j_state, j_met = j_step(jp, j_state, jb)
        _, state, met = step(params, state, b)
        out.append({"losses": (float(j_met["loss"]), float(met["loss"])), "want": _f32(jp), "got": _f32(params),
                    "grads": grads, "lr": LR * min((t + 1) / WARMUP, 1.0)})
    return out


def _ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 at |x| (2^-7 of its power of two; 2^-133 at 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_bf16_three_steps_match_reference(name):
    """Each step from the reference's parameters and moments: the losses
    within LOSS_RTOL; every updated parameter element within a bf16 ulp
    plus STEP_RTOL of the step's lr of the reference's (measured: 7.6e-3 of
    lr past the ulp, at elements near zero, where an ulp is far below a
    step), but those whose gradient at the step's start lies within
    BF16_GRAD_TOL of zero (Adam's early steps are near sign steps: there a
    rounding-level gradient gap steps either way), which lie within two of
    the step's lr-sized steps."""
    for t, s in enumerate(three_steps(name)):
        np.testing.assert_allclose(s["losses"][1], s["losses"][0], rtol=LOSS_RTOL.get(name, 1e-6), err_msg=f"step {t}")
        for path, w in s["want"].items():
            g = s["grads"][path]
            unsigned = np.abs(g) <= BF16_GRAD_TOL[name] * np.abs(g).max()
            diff = np.abs(s["got"][path] - w)
            off = diff > _ulp(w) + STEP_RTOL * s["lr"]
            leaf = f"step {t} {'/'.join(path)}"
            assert not (off & ~unsigned).any(), f"{leaf}: {np.argwhere(off & ~unsigned)[:5]} past a bf16 ulp"
            assert (diff[off] <= 2 * s["lr"] + _ulp(w)[off]).all(), f"{leaf}: past two steps of {s['lr']}"


def blockwise_grads(bk: int, reference: bool):
    """dq of one bf16 attention's blockwise loop (B 2, S 32, 2 KV heads of
    2 queries, hd 16) in blocks of ``bk``, the reference's or the port's."""
    r = np.random.RandomState(5)
    q = r.randn(2, 32, 2, 2, 16).astype(np.float32)
    k, v = (r.randn(2, 32, 2, 16).astype(np.float32) for _ in range(2))
    c = r.randn(2, 32, 2, 2, 16).astype(np.float32)
    if reference:
        pos = jnp.arange(32)
        f = lambda q, k, v: j_blockwise(q, k, v, pos, pos, window=None, cap=None, block_q=bk,  # noqa: E731
                                        block_k=bk).astype(jnp.bfloat16)
        args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, c)]
        dq = jax.jit(lambda q, k, v, c: jax.vjp(f, q, k, v)[1](c)[0])(*args)
        return np.asarray(dq.astype(jnp.float32))
    ts = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, k, v)]
    out = _blockwise(*ts, torch.arange(32), live_blocks(torch.arange(32), None, bk, bk), window=None, cap=None,
                     block_q=bk, block_k=bk, differentiable=True).bfloat16()
    out.backward(torch.from_numpy(c).bfloat16())
    return ts[0].grad.float().numpy()


def test_reference_attention_rounds_its_gradient_per_block_pair():
    """A reference note, not a fault of the port: in bf16 the reference's
    dq depends on the blocking (each (Q block, KV block) pair's dq rounded
    to bf16 and added in bf16; measured: 18% of dq's elements move from one
    block of 32 to two of 16), the port's does not (its sums stay in f32:
    0.05% of elements, f32 order). At one block the two packages agree
    (0.05%). So past one block of a training sequence the gradients keep a
    per-block rounding gap."""
    ref1, ref2 = blockwise_grads(32, True), blockwise_grads(16, True)
    port1, port2 = blockwise_grads(32, False), blockwise_grads(16, False)
    assert np.mean(ref1 != ref2) > 0.05
    assert np.mean(port1 != port2) < 5e-3
    assert np.mean(port1 != ref1) < 5e-3
    assert np.mean(port2 != ref2) > 0.05


if __name__ == "__main__":  # the readings the docstring quotes
    for name in FAMILIES:
        j_loss, loss, want, got = loss_and_grads(name)
        gap = _grad_gap(got, want)
        leaf = max(gap, key=gap.get)
        print(f"{name}: loss {loss:.7f} vs {j_loss:.7f} (rel {abs(loss - j_loss) / abs(j_loss):.2e}); "
              f"worst gradient {gap[leaf]:.2e} ({'/'.join(leaf)})")
    for name in STEP_FAMILIES:
        for t, s in enumerate(three_steps(name)):
            off = sum(int((np.abs(s["got"][p] - w) > _ulp(w)).sum()) for p, w in s["want"].items())
            print(f"{name} step {t}: loss {s['losses'][1]:.7f} vs {s['losses'][0]:.7f}; {off} elements past a bf16 ulp, "
                  f"greatest gap {max(np.abs(s['got'][p] - w).max() for p, w in s['want'].items()):.3e}")
    for bk in (32, 16):
        print(f"dq, blocks of {bk}: reference vs port {np.mean(blockwise_grads(bk, True) != blockwise_grads(bk, False)):.4f}")
