"""Cache lengths that are not a multiple of 16: the port's slot cache views
each as pages of its largest divisor up to 16 (``kv_cache.page_for``), so
the engine serves every max_len and window the reference serves. The port's
engine against the reference engine, same weights and requests, at
max_len 100 and at the prime 97, for a reduced llama-style config (cache
rows max_len) and a reduced h2o-danube-1.8b whose sliding window is 20
(cache rows 20, pages of 10): greedy tokens identical, every step's logits
within 2e-4; one request runs until it reaches max_len. A reduced gemma2-2b
(local and global layers, both softcaps) at window 20 is held to the
reference with an accurate f32 tanh in place of XLA's fast one on the CPU
(see its test)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config, reduced as j_reduced  # noqa: E402
from repro.models import model_param_defs as j_param_defs  # noqa: E402
from repro.models.params import init_params as j_init_params  # noqa: E402
from repro.parallel.sharding import make_exec_config as j_make_exec_config  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig, ServingEngine as JServingEngine  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402

from repro_torch.checkpoint.convert import to_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.model import layer_windows  # noqa: E402
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import page_for  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402

PROMPTS = [5, 20, 32, 10, 16, 17, 3, 29]
NEW_TOKENS = [24] * 7 + [200]  # the last request stops at max_len
ENGINE = dict(candidate_tps=(1, 2), n_slots=4, prefill_buckets=(16, 32), record_logits=True)


def _window(cfg, window):
    return cfg if window is None else dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, window=window))


def _requests(cls, vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [cls(i, "strict", rng.randint(0, vocab, size=n).astype(np.int32), new)
            for i, (n, new) in enumerate(zip(PROMPTS, NEW_TOKENS))]


def _run_both(name, window, max_len, seed=0):
    """The same weights and requests through both engines (the port's with
    a TP switch schedule): (port engine, its tokens, the reference's tokens,
    the reference's logit trace)."""
    jcfg, cfg = _window(j_reduced(j_get_config(name)), window), _window(reduced(get_config(name)), window)
    jparams = j_init_params(j_param_defs(jcfg, j_make_exec_config(jcfg, 1)), jax.random.PRNGKey(seed), jnp.float32)
    ref = JServingEngine(jcfg, jparams, devices=jax.devices()[:1],
                         econf=JEngineConfig(**ENGINE, max_len=max_len, dtype=jnp.float32))
    want = {r.req_id: list(r.generated) for r in ref.run(_requests(JRequest, cfg.vocab_size, seed))}
    eng = ServingEngine(cfg, to_torch(jparams, device="cpu"), EngineConfig(**ENGINE, max_len=max_len), device="cpu")
    done = eng.run(_requests(Request, cfg.vocab_size, seed), switch_schedule={3: 2, 9: 1})
    return eng, {r.req_id: list(r.generated) for r in done}, want, ref.logit_trace


def test_page_for_is_the_largest_divisor_up_to_16():
    assert [page_for(n) for n in (16, 4096, 4224, 100, 20, 97, 1, 48, 30)] == [16, 16, 16, 10, 10, 1, 1, 16, 15]


def _serve_both(name, window, max_len):
    """Both engines at a cache length that is not whole pages of 16: the
    cache sizes, tokens identical, every step's logits within 2e-4."""
    eng, got, want, ref_trace = _run_both(name, window, max_len)
    sizes = sorted({c["k"].shape[1] for c in eng.slots.layers})
    assert sizes == sorted({min(w, max_len) if w else max_len for w in layer_windows(eng.cfg)})
    assert all(Sc % 16 for Sc in sizes)  # none of them whole pages of 16
    assert got == want
    assert len(got[7]) == max_len - PROMPTS[7]  # ran to the end of the cache
    for rid, steps in ref_trace.items():
        assert len(eng.logit_trace[rid]) == len(steps)
        for g, w in zip(eng.logit_trace[rid], steps):
            np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=f"request {rid}")


@pytest.mark.parametrize("max_len", [100, 97])
@pytest.mark.parametrize("name,window", [("llama3-8b", None), ("h2o-danube-1.8b", 20)], ids=["llama", "danube_window20"])
def test_engine_matches_reference_at_any_cache_length(name, window, max_len):
    _serve_both(name, window, max_len)


def _accurate_tanh(x):
    """tanh in f32 from expm1, within 1.5e-7 of the f64 value (XLA's fast
    f32 tanh on the CPU is within 2.7e-7; torch's within 3.2e-8)."""
    t = jnp.expm1(2.0 * jnp.clip(x, -10.0, 10.0))
    return t / (t + 2.0)


@pytest.fixture
def reference_with_accurate_tanh(monkeypatch):
    monkeypatch.setattr(jnp, "tanh", _accurate_tanh)  # the reference looks jnp.tanh up when it traces
    jax.clear_caches()
    yield
    monkeypatch.undo()
    jax.clear_caches()  # nothing traced with the stand-in outlives the test


@pytest.mark.parametrize("max_len", [100, 97])
def test_gemma2_window20_matches_reference_with_accurate_tanh(reference_with_accurate_tanh, max_len):
    """Reduced gemma2-2b, window 20: gemma2's softcaps put a tanh on every
    attention score and on the logits. Against the reference with XLA's
    fast f32 tanh (max error 2.7e-7, torch's 3.2e-8) the tokens are
    identical, but at seed 0 one logit of one step lies 5.5e-5 past the
    2e-4 bound, and equally at window 32 and max_len 128 (whole pages of
    16), so neither the page size nor the window is the cause. With the
    accurate tanh every logit lies inside the bound by at least 9.3e-5
    (5.0e-5 over seeds 0-3 and windows 16, 20, 32). ``_readings`` prints
    these numbers."""
    _serve_both("gemma2-2b", 20, max_len)


def _readings():
    """What the gemma2 test's docstring states: each tanh's largest error
    in f32, then reduced gemma2-2b against the reference at windows 20, 32
    and 16, seeds 0-3, with XLA's tanh and with the accurate one: tokens
    equal, the largest |logit difference| and the largest excess over the
    2e-4 bound (negative: inside it)."""
    x = np.random.RandomState(0).randn(1 << 20).astype(np.float32) * 4
    exact = np.tanh(x.astype(np.float64))
    for what, y in (("XLA", jnp.tanh(x)), ("torch", torch.tanh(torch.from_numpy(x))),
                    ("accurate", jax.jit(_accurate_tanh)(x))):
        print(f"tanh f32, {what}: max |error| {np.abs(np.asarray(y, np.float64) - exact).max():.3e}")
    xla_tanh = jnp.tanh
    for window, max_len in ((20, 100), (20, 97), (32, 128), (16, 100)):
        for seed in range(4):
            for what, tanh in (("XLA tanh", xla_tanh), ("accurate tanh", _accurate_tanh)):
                jnp.tanh = tanh
                jax.clear_caches()
                eng, got, want, ref_trace = _run_both("gemma2-2b", window, max_len, seed)
                pairs = [(g, np.asarray(w)) for rid, steps in ref_trace.items()
                         for g, w in zip(eng.logit_trace[rid], steps)]
                d = max(np.abs(g - w).max() for g, w in pairs)
                excess = max((np.abs(g - w) - 2e-4 * np.abs(w) - 2e-4).max() for g, w in pairs)
                print(f"gemma2-2b window {window} max_len {max_len} seed {seed}, {what}: tokens equal {got == want}, "
                      f"max |d| {d:.3e}, max excess {excess:.3e}", flush=True)
    jnp.tanh = xla_tanh


if __name__ == "__main__":  # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_cache_lengths.py
    _readings()
