"""The pipeline schedule across processes against the reference's.

The port's ``parallel.pipeline.pipeline_apply`` over a pool of 4 gloo
processes (a stage per process, a send and receive per tick under
autograd; ``multidev_checks pipeline 4 cpu``) at (pipe 4), (pipe 2,
data 2) and (pipe 2, model 2), on tests/test_pipeline.py's toy body
(tanh(h @ w), 8 periods, 4 microbatches of (2, 8, 32)), against the
reference's ``pipeline_apply`` on 4 XLA host devices at the same meshes
(``python tests/test_torch_pipeline_multidev.py reference <in.pkl>
<out.pkl>``, a subprocess: its device count is set before jax starts):
the output, and ``jax.grad`` of the sum of squares of the output with
respect to w and h0, within 2e-5 (tests/test_pipeline.py's bound; the
gradients over their greatest element). The reference's gradient is the
sequential stack's, not the number of stages times it, and so is the
port's. The check itself also holds a reduced llama3-8b decoder-layer body
(8 periods, 4 microbatches of (2, 16)) against the port's sequential stack
in one process at every mesh (measured: bit for bit but the data-group
sums, 3.0e-7 of max |g|).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
MESHES = [("pipe4", 4, 1), ("pipe2_data2", 2, 1), ("pipe2_model2", 2, 2)]
TOL = 2e-5


def _reference(inp: str, out: str) -> None:
    """The reference's pipeline_apply and its gradient at each mesh."""
    import jax
    import jax.numpy as jnp

    from repro.parallel.pipeline import make_pipe_mesh, pipeline_apply

    assert len(jax.devices()) >= 4, jax.devices()
    with open(inp, "rb") as f:
        toy = pickle.load(f)
    L = toy["w"].shape[0]

    def body(h, p, k):
        return jnp.tanh(h @ p["w"])

    res = {}
    for name, stages, tp in MESHES:
        mesh = make_pipe_mesh(jax.devices()[:4], n_stages=stages, tp=tp)

        def loss(w, h0):
            return jnp.sum(pipeline_apply(body, {"w": w}, h0, mesh, n_periods=L) ** 2)

        y = pipeline_apply(body, {"w": jnp.asarray(toy["w"])}, jnp.asarray(toy["h0"]), mesh, n_periods=L)
        dw, dh0 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(toy["w"]), jnp.asarray(toy["h0"]))
        res[name] = {"out": np.asarray(y), "dw": np.asarray(dw), "dh0": np.asarray(dh0)}
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print("OK reference")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's three meshes and the pool's check, started together:
    ({mesh: reference arrays}, the pool's summary, {mesh: the whole output,
    dW and dh0 joined from the ranks' pieces})."""
    from repro_torch.testing.multidev_checks import toy_arrays

    tmp = tmp_path_factory.mktemp("pipeline")
    toy = toy_arrays()
    with open(tmp / "toy.pkl", "wb") as f:
        pickle.dump(toy, f)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"pipeline": {"toy": toy}}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "reference", str(tmp / "toy.pkl"), str(tmp / "ref.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")),
        "pool": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.testing.multidev_checks", "pipeline", "4", "cpu",
             "--inputs", str(tmp / "in.pkl"), "--out", str(tmp / "out.pkl")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env),
    }
    failed = []
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        ok = "OK reference" if name == "reference" else "OK pipeline"
        if p.returncode != 0 or ok not in stdout:
            failed.append(f"{name} failed:\n{stdout}\n{stderr}")
    assert not failed, "\n".join(failed)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "out.pkl", "rb") as f:
        ranks = [r["pipeline"] for r in pickle.load(f)]
    assert len(ranks) == 4
    joined = {}
    for name, _, _ in MESHES:
        out, dw, dh0 = np.zeros_like(toy["h0"]), np.zeros_like(toy["w"]), np.zeros_like(toy["h0"])
        for r in ranks:
            piece = r["toy"][name]
            (r0, r1), (p0, p1) = piece["rows"], piece["periods"]
            out[:, r0:r1] = piece["out"]
            dw[p0:p1] = piece["dw"]  # the stage's periods, summed over its data group
            if piece["dh0"] is not None:  # stage 0 reads h0
                dh0[:, r0:r1] = piece["dh0"]
        joined[name] = {"out": out, "dw": dw, "dh0": dh0}
    return ref, ranks[0]["summary"], joined


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_pool_pipeline_matches_reference(mesh, runs):
    """The output within 2e-5 of the reference's, dW and dh0 within 2e-5 of
    their greatest element (rank 0 reads the port's own sequential stack
    within the same bound: the check raises otherwise)."""
    ref, _, joined = runs
    np.testing.assert_allclose(joined[mesh]["out"], ref[mesh]["out"], rtol=TOL, atol=TOL)
    for k in ("dw", "dh0"):
        want = ref[mesh][k]
        err = np.abs(joined[mesh][k] - want).max() / np.abs(want).max()
        assert err <= TOL, f"{mesh} {k}: {err:.2e}"


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_pool_gradient_is_not_a_multiple_of_the_stages(mesh, runs):
    """The projection of the pool's dW on the reference's is 1 (the final
    broadcast counts the loss's cotangent once, not once per stage)."""
    ref, _, joined = runs
    a, b = joined[mesh]["dw"].ravel(), ref[mesh]["dw"].ravel()
    assert abs(float(a @ b / (b @ b)) - 1.0) < 1e-5


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_pool_decoder_layer_body_matches_sequential_stack(mesh, runs):
    """A reduced llama3-8b decoder layer (8 periods, 4 microbatches) through
    the pool's schedule against the port's one-process sequential stack:
    output, stage gradients (summed over the data group) and dh0 within
    2e-5 of their greatest element, on rank 0."""
    _, summary, _ = runs
    errs = summary[f"{mesh}/llama"]
    assert set(errs) == {"out", "grads", "dh0"} and max(errs.values()) <= TOL, errs


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2], sys.argv[3])
