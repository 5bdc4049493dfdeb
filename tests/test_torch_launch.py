"""The port's launchers and examples against the reference's.

* ``launch.serve`` on the demo config with the reference's weights: every
  request's tokens equal the reference launcher's, every step's logits
  within 2e-4 (the engine tests' tolerance), and the counts that ``main``
  prints (served, switches, decode steps, final TP) equal the reference
  launcher's. The reference runs in a subprocess over 8 XLA host devices,
  ``python tests/test_torch_launch.py serve <out.pkl> <argv...>``.
* ``launch.train`` on reduced h2o-danube-1.8b with the reference
  launcher's weights: per-step losses within 2e-4 relative (the training
  tests' tolerance) of the reference launcher's ``train_loop``; N steps and
  then 2N in the same directory end bitwise equal to an uncut 2N-step run.
* ``examples.plan_trace --horizon 30`` prints the reference's table, digit
  for digit; ``quickstart`` and ``train_tiny`` run on the CPU, and
  ``train_tiny``'s loss falls.
"""
import contextlib
import io
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# the reference launcher's flags, cut to keep the run short; both packages take the same
SERVE_ARGV = ["--devices", "8", "--tps", "1,2,4", "--requests", "12", "--max-new", "16", "--switch-every", "5"]
TRAIN_ARGV = ["--reduced", "--batch", "4", "--seq", "32", "--ckpt-every", "3"]
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread runs them faster and keeps parallel
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(stdout: str) -> dict:
    """served, switches, decode steps and final TP from a serve launcher's lines."""
    served = re.search(r"served (\d+) requests in [\d.]+s across (\d+) TP switches", stdout)
    steps = re.search(r"decode steps: (\d+); final TP (\d+)", stdout)
    assert served and steps, stdout
    return {"served": int(served[1]), "switches": int(served[2]), "steps": int(steps[1]), "final_tp": int(steps[2])}


def _reference_serve(out: str, argv) -> None:
    """The reference launcher's main with its engine recording logits; its
    lines, every request's tokens and logits and the weights go to ``out``."""
    import jax

    import repro.serving.engine as E

    engines, runs = [], []
    init, run = E.ServingEngine.__init__, E.ServingEngine.run

    def recording_init(self, cfg, params, *a, **kw):
        init(self, cfg, params, *a, **kw)
        self.econf.record_logits = True
        engines.append((self, params))

    def recording_run(self, reqs, **kw):
        runs.append(run(self, reqs, **kw))
        return runs[-1]

    E.ServingEngine.__init__, E.ServingEngine.run = recording_init, recording_run
    from repro.launch import serve

    sys.argv = ["serve", *argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main()
    eng, params = engines[0]
    res = {"stdout": buf.getvalue(), "tokens": {r.req_id: list(map(int, r.generated)) for r in runs[0]},
           "logits": {k: [np.asarray(x) for x in v] for k, v in eng.logit_trace.items()},
           "params": jax.tree_util.tree_map(np.asarray, params)}
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print(res["stdout"])
    print("OK serve")


@pytest.fixture(scope="module")
def reference_serve(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve") / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "serve", str(out), *SERVE_ARGV],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK serve" in r.stdout, f"{r.stdout}\n{r.stderr}"
    with open(out, "rb") as f:
        return pickle.load(f)


def test_serve_launcher_tokens_and_logits_match_reference(reference_serve):
    from repro_torch.checkpoint.convert import to_torch
    from repro_torch.launch import serve

    args = serve.parse_args(SERVE_ARGV + ["--device", "cpu"])
    cfg, _ = serve.build(args)
    done, stats = serve.serve(cfg, to_torch(reference_serve["params"], device="cpu"), args, record_logits=True)
    assert {r.req_id: r.generated for r in done} == reference_serve["tokens"]
    assert stats["switches"] > 0 and stats["tps"] == [1, 2, 4]
    for rid, steps in reference_serve["logits"].items():
        got = stats["logits"][rid]
        assert len(got) == len(steps) == 16
        for g, w in zip(got, steps):
            np.testing.assert_allclose(g, w, **LOGIT_TOL, err_msg=f"request {rid}")


def test_serve_launcher_main_prints_reference_counts(reference_serve, capsys):
    """A dense model's counts do not depend on its weights: main draws its
    own, and prints the reference launcher's served, switches, decode steps
    and final TP."""
    from repro_torch.launch import serve

    assert serve.main(SERVE_ARGV + ["--device", "cpu"]) == 0
    assert _counts(capsys.readouterr().out) == _counts(reference_serve["stdout"])


def _reference_train(monkeypatch, ckpt_dir, steps):
    """The reference launcher's main in this process; returns (its initial
    weights as numpy, the train_loop state)."""
    import jax

    import repro.models.params as jparams
    import repro.training.loop as jloop
    from repro.launch import train as jtrain

    got = {}
    init, loop = jparams.init_params, jloop.train_loop

    def recording_init(*a, **kw):
        params = init(*a, **kw)
        got["params"] = jax.tree_util.tree_map(np.array, params)  # a copy: the step donates its params
        return params

    def recording_loop(*a, **kw):
        got["state"] = loop(*a, **kw)
        return got["state"]

    monkeypatch.setattr(jparams, "init_params", recording_init)
    monkeypatch.setattr(jloop, "train_loop", recording_loop)
    monkeypatch.setattr(sys, "argv", ["train", *TRAIN_ARGV, "--steps", str(steps), "--ckpt-dir", str(ckpt_dir),
                                      "--fresh"])
    jtrain.main()
    return got["params"], got["state"]


def test_train_launcher_losses_match_reference(monkeypatch, tmp_path):
    from repro_torch.checkpoint.convert import to_torch
    from repro_torch.launch import train

    jparams, jstate = _reference_train(monkeypatch, tmp_path / "ref", 5)
    args = train.parse_args(TRAIN_ARGV + ["--steps", "5", "--ckpt-dir", str(tmp_path / "port"), "--fresh",
                                          "--device", "cpu"])
    cfg, _ = train.build(args)
    state = train.run(cfg, to_torch(jparams, device="cpu"), args)
    assert state.step == jstate.step == 5 and state.resumed_from is None
    np.testing.assert_allclose(state.losses, jstate.losses, rtol=LOSS_RTOL)


def test_train_launcher_resume_is_bitwise(tmp_path):
    """N steps, then the same command with 2N: the resumed run ends bitwise
    equal to an uncut 2N-step run (the reference's
    test_checkpoint_restart_bitwise_identical, through the launcher)."""
    from repro_torch.checkpoint.convert import to_numpy
    from repro_torch.launch import train

    def launch(steps, ckpt, *extra):
        return train.main(TRAIN_ARGV + ["--steps", str(steps), "--ckpt-dir", str(ckpt), "--device", "cpu", *extra])

    first = launch(3, tmp_path / "cut", "--fresh")
    resumed = launch(6, tmp_path / "cut")
    whole = launch(6, tmp_path / "whole", "--fresh")
    assert first.step == 3 and resumed.resumed_from == 3 and resumed.step == whole.step == 6
    assert first.losses + resumed.losses == whole.losses
    for (path, a), (_, b) in zip(_leaves(to_numpy(resumed.params)), _leaves(to_numpy(whole.params))):
        assert np.array_equal(a, b), "/".join(path)
    for (path, a), (_, b) in zip(_leaves(resumed.opt_state), _leaves(whole.opt_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), "/".join(path)


def _leaves(tree):
    from repro_torch.models.params import tree_leaves_with_path

    return list(tree_leaves_with_path(tree))


def test_plan_trace_prints_reference_table(monkeypatch, capsys):
    import importlib.util

    from repro_torch.examples import plan_trace

    plan_trace.main(["--horizon", "30"])
    got = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location("ref_plan_trace", ROOT / "examples" / "plan_trace.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["plan_trace", "--horizon", "30"])
    ref.main()
    want = capsys.readouterr().out
    assert "nitsum" in got and got == want


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch.examples import quickstart

    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "decode ok; hidden: (2, 1, 64)" in out and out.rstrip().endswith("quickstart done")


def test_train_tiny_loss_falls(tmp_path):
    from repro_torch.examples import train_tiny

    state = train_tiny.main(["--steps", "40", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert state.step == 40 and np.mean(state.losses[-10:]) < np.mean(state.losses[:10])
    assert all(np.isfinite(state.losses))


if __name__ == "__main__":
    {"serve": lambda: _reference_serve(sys.argv[2], sys.argv[3:])}[sys.argv[1]]()
