"""The port's serving path held to the JAX package's on the CPU, on the
reference's weights (reference ``init_model`` -> numpy ->
``load_reference_params``): the prefill and decode steps (with the
whisper and VLM contexts), ``greedy_generate`` and ``ServePool`` tokens
for an attention model, a recurrent one and gemma2-2b decoding past its
16-token smoke window (the local layers' ring buffer wraps); slot reuse
leaks no state; a poisoned decode step evicts its slots as in the
reference; the entry points refuse to run without a card unless asked for
the CPU; the launcher in a subprocess.

Tolerances: logits within ``ATOL`` / ``RTOL`` (f32); tokens exactly.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.launch import serve as r_serve  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models import serve as r_serve_steps  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import Request, ServePool  # noqa: E402
from repro_torch.models.convert import load_reference_params  # noqa: E402
from repro_torch.models.model import build_caches, init_model  # noqa: E402
from repro_torch.models.serve import (  # noqa: E402
    greedy_generate, make_decode_step, make_prefill_step)

ATOL = RTOL = 2e-5
SRC = Path(__file__).resolve().parents[1] / "src"
#: arch -> (pool context, new tokens a request); gemma2-2b's 6 + 14
#: positions pass its smoke local window of 16
POOL_CASES = {"smollm-135m": (32, 6), "recurrentgemma-2b": (32, 6),
              "gemma2-2b": (40, 14)}


def _models(arch, seed=0):
    rcfg = r_get_config(arch, smoke=True)
    rparams = r_model.init_model(jax.random.PRNGKey(seed), rcfg,
                                 dtype=jnp.float32)
    cfg = get_config(arch, smoke=True)
    model = load_reference_params(cfg, jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return rcfg, rparams, cfg, model


def _extra(cfg, B, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return {"frames": (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)}
    if cfg.n_patch_tokens:
        return {"patches": (rng.normal(size=(B, cfg.n_patch_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_prefill_and_decode_steps_match_reference(arch):
    rcfg, rparams, cfg, model = _models(arch)
    B, S = 2, 7
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    extra = _extra(cfg, B)
    r_extra = {k: jnp.asarray(v) for k, v in extra.items()}
    want = r_serve_steps.make_prefill_step(rcfg)(
        rparams, {"tokens": jnp.asarray(toks), **r_extra})
    got = make_prefill_step(cfg, device="cpu")(model,
                                               {"tokens": toks, **extra})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)

    r_dec = r_serve_steps.make_decode_step(rcfg)
    dec = make_decode_step(cfg, device="cpu")
    r_caches = r_model.build_caches(rcfg, B, S, dtype=jnp.float32)
    caches = build_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    for t in range(3):
        want, r_caches = r_dec(rparams, r_caches,
                               {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                "pos": jnp.asarray(t, jnp.int32), **r_extra})
        got, caches = dec(model, caches, {"tokens": toks[:, t:t + 1],
                                          "pos": t, **extra})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)


def _prompts(cfg, n=5, length=6):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, length) for _ in range(n)]


@pytest.mark.parametrize("arch", list(POOL_CASES))
def test_greedy_and_pool_match_reference(arch):
    ctx, max_new = POOL_CASES[arch]
    rcfg, rparams, cfg, model = _models(arch)
    prompts = _prompts(cfg)

    # greedy decoding of all prompts as one batch
    want = np.asarray(r_serve_steps.greedy_generate(
        rparams, rcfg, jnp.asarray(np.stack(prompts), jnp.int32),
        steps=max_new, ctx_capacity=ctx))
    got = greedy_generate(model, cfg, np.stack(prompts), steps=max_new,
                          ctx_capacity=ctx, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

    # 2 slots serving 5 requests forces slot reuse
    r_reqs = [r_serve.Request(rid=i, prompt=p, max_new=max_new)
              for i, p in enumerate(prompts)]
    r_done = r_serve.ServePool(rcfg, rparams, 2, ctx).run(r_reqs)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    done = ServePool(cfg, model, 2, ctx, device="cpu").run(reqs)
    assert len(done) == len(r_done) == len(prompts)
    for req, r_req in zip(reqs, r_reqs):
        assert req.done and req.out == r_req.out, (arch, req.rid)
        # slot reuse leaks nothing: the pool gives the isolated tokens
        assert req.out == got[req.rid].tolist(), (arch, req.rid)


def _poisoned(decode, bad_call):
    calls = []

    def step(*args):
        calls.append(1)
        if len(calls) == bad_call:
            raise RuntimeError("poisoned request")
        return decode(*args)
    return step


def test_failed_step_evicts_its_slots_as_the_reference(capsys):
    rcfg, rparams, cfg, model = _models("smollm-135m")
    prompts = _prompts(cfg, n=4, length=4)
    r_pool = r_serve.ServePool(rcfg, rparams, 2, 32)
    r_pool.decode = _poisoned(r_pool.decode, 3)
    r_reqs = [r_serve.Request(rid=i, prompt=p, max_new=3)
              for i, p in enumerate(prompts)]
    r_done = r_pool.run(r_reqs)
    pool = ServePool(cfg, model, 2, 32, device="cpu")
    pool.decode = _poisoned(pool.decode, 3)
    reqs = [Request(rid=i, prompt=p, max_new=3)
            for i, p in enumerate(prompts)]
    done = pool.run(reqs)
    assert "[evict] decode error" in capsys.readouterr().out
    assert [r.rid for r in done] == [r.rid for r in r_done] == [2, 3]
    assert [r.out for r in reqs] == [r.out for r in r_reqs]
    assert not reqs[0].done and not reqs[1].done


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-135m", smoke=True)
    model = init_model(0, cfg, device="cpu")
    for call in (lambda: ServePool(cfg, model, 2, 16),
                 lambda: init_model(0, cfg),
                 lambda: build_caches(cfg, 1, 8),
                 lambda: make_decode_step(cfg),
                 lambda: make_prefill_step(cfg),
                 lambda: greedy_generate(model, cfg, np.zeros((1, 2), int),
                                         2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ServePool(cfg, model, 2, 16, device="cpu").device.type == "cpu"


def test_launcher_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "recurrentgemma-2b", "--requests", "3", "--slots", "2",
         "--max-new", "4"],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}).stdout
    assert "served 3/3 requests, 12 tokens" in out, out
    assert "slots, cpu)" in out, out
