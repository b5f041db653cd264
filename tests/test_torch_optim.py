"""The port's optimizer pieces held to the JAX package's on the CPU:
``cosine_schedule`` at the warm-up and decay edges, ``adamw_update`` for
three steps on a tree with an f32 and a bf16 leaf (the state's keys and
dtypes too), the int8 quantization and error-feedback compression, the
reference's error-feedback drift bound, and ``compressed_psum_ef`` over
two gloo ranks in subprocesses against the reference's formula.

Tolerances: the schedule within ``SCHED_RTOL`` (f32 transcendentals may
differ by an ulp); AdamW within ``ADAM_TOL`` (its bias corrections and
``b ** t`` are rounded by different libraries); int8 payloads exactly,
scales and residuals within ``QUANT_TOL``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import grad_compression as r_gc  # noqa: E402
from repro.optim import schedule as r_schedule  # noqa: E402

from repro_torch.optim import adamw_init, adamw_update, cosine_schedule  # noqa: E402,E501
from repro_torch.optim.grad_compression import (  # noqa: E402
    compressed_psum_ef, dequantize_int8, ef_compress_tree, quantize_int8)

SCHED_RTOL = 1e-6
ADAM_TOL = 1e-6
QUANT_TOL = 1e-7
SRC = Path(__file__).resolve().parents[1] / "src"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 20000])
def test_cosine_schedule_matches_reference(step):
    want = float(r_schedule.cosine_schedule(jnp.asarray(step, jnp.int32)))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = cosine_schedule(s)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=SCHED_RTOL)
    kw = dict(peak_lr=1e-3, warmup=10, total=200, min_ratio=0.0)
    np.testing.assert_allclose(
        float(cosine_schedule(step, **kw)),
        float(r_schedule.cosine_schedule(jnp.asarray(step), **kw)),
        rtol=SCHED_RTOL, atol=1e-12)


def _tree(rng):
    """One f32 and one bf16 leaf, nested, as numpy f32 arrays."""
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "blk": {"b": rng.normal(size=(5,)).astype(np.float32)}}


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def test_adamw_matches_reference_three_steps():
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    r_params = {"w": jnp.asarray(p0["w"]), "blk": {"b": _bf16(p0["blk"]["b"])}}
    params = {"w": torch.from_numpy(p0["w"].copy()),
              "blk": {"b": torch.from_numpy(p0["blk"]["b"]).bfloat16()}}
    # the port's bf16 leaf starts from the reference's rounding
    np.testing.assert_array_equal(
        _np(params["blk"]["b"]),
        np.asarray(r_params["blk"]["b"], np.float32))
    r_opt, opt = r_adamw.adamw_init(r_params), adamw_init(params)
    assert opt["m"]["w"].dtype == opt["m"]["blk"]["b"].dtype == torch.float32
    assert opt["v"]["blk"]["b"].dtype == torch.float32
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()
    assert set(opt) == set(r_opt)
    for _ in range(3):
        g = _tree(rng)
        r_grads = {"w": jnp.asarray(g["w"]), "blk": {"b": _bf16(g["blk"]["b"])}}
        grads = {"w": torch.from_numpy(g["w"]),
                 "blk": {"b": torch.from_numpy(g["blk"]["b"]).bfloat16()}}
        r_params, r_opt = r_adamw.adamw_update(r_params, r_grads, r_opt,
                                               lr=1e-2)
        params, opt = adamw_update(params, grads, opt, lr=1e-2)
        assert params["blk"]["b"].dtype == torch.bfloat16
        for got, want in ((params["w"], r_params["w"]),
                          (opt["m"]["w"], r_opt["m"]["w"]),
                          (opt["v"]["w"], r_opt["v"]["w"]),
                          (opt["m"]["blk"]["b"], r_opt["m"]["blk"]["b"]),
                          (opt["v"]["blk"]["b"], r_opt["v"]["blk"]["b"])):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       atol=ADAM_TOL, rtol=ADAM_TOL)
        np.testing.assert_allclose(
            _np(params["blk"]["b"]),
            np.asarray(r_params["blk"]["b"], np.float32), atol=ADAM_TOL)
        assert int(opt["step"]) == int(r_opt["step"])
    assert opt["step"].device.type == "cpu"


def test_adamw_on_a_model_keys_the_state_by_parameter_name():
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    model = init_model(0, get_config("smollm-135m", smoke=True), device="cpu")
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    assert list(opt["m"]) == list(params) and list(opt["v"]) == list(params)
    before = {n: p.detach().clone() for n, p in params.items()}
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    out, opt = adamw_update(params, grads, opt, lr=1e-3)
    assert out is params and int(opt["step"]) == 1
    for n, p in model.named_parameters():
        # first step: |delta| = 1 / (1 + eps) plus the decay
        d = (before[n] - p.detach()) - 1e-3 * 0.1 * before[n]
        np.testing.assert_allclose(d.numpy(), 1e-3, rtol=1e-4)


@pytest.mark.parametrize("scale", [None, 0.05])
@pytest.mark.parametrize("n", [1, 256, 1000])
def test_quantize_matches_reference(n, scale):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n,)) * 3).astype(np.float32)
    g[0] = 0.5 * 127 * (scale or 1.0)    # a tie when scaled by 1 / scale
    rq, rs = r_gc.quantize_int8(jnp.asarray(g),
                                None if scale is None else jnp.float32(scale))
    q, s = quantize_int8(torch.from_numpy(g),
                         None if scale is None else torch.tensor(scale))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(float(s), float(rs), rtol=QUANT_TOL)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(r_gc.dequantize_int8(rq, rs)),
                               rtol=QUANT_TOL, atol=QUANT_TOL)


def test_round_half_to_even_as_the_reference():
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    q, _ = quantize_int8(torch.from_numpy(g), torch.tensor(1.0))
    rq, _ = r_gc.quantize_int8(jnp.asarray(g), jnp.float32(1.0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(q.numpy(), [0, 2, 2, 0, -2, 127])


def test_ef_compress_tree_matches_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(64,)).astype(np.float32),
         "b": {"c": rng.normal(size=(4, 8)).astype(np.float32)}}
    r = {"a": (rng.normal(size=(64,)) * 0.01).astype(np.float32),
         "b": {"c": np.zeros((4, 8), np.float32)}}
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    q, s, res = ef_compress_tree(to_t(g), to_t(r))
    rq, rs, rres = r_gc.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                         jax.tree.map(jnp.asarray, r))
    for k in (("a",), ("b", "c")):
        pick = lambda t: t[k[0]] if len(k) == 1 else t[k[0]][k[1]]  # noqa
        np.testing.assert_array_equal(pick(q).numpy(), np.asarray(pick(rq)))
        np.testing.assert_allclose(float(pick(s)), float(pick(rs)),
                                   rtol=QUANT_TOL)
        np.testing.assert_allclose(pick(res).numpy(), np.asarray(pick(rres)),
                                   atol=QUANT_TOL)


def test_error_feedback_unbiased():
    """The reference's drift bound (``tests/test_fault_tolerance.py``):
    with error feedback the cumulative compressed sum tracks the true
    cumulative gradient; the residual never grows."""
    rng = np.random.default_rng(1)
    rng.normal(size=(64,))          # the reference test's first, unused draw
    resid = {"w": torch.zeros(64)}
    total_true = np.zeros(64)
    total_comp = np.zeros(64)
    for _ in range(50):
        g = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
        q, s, resid = ef_compress_tree(g, resid)
        total_true += g["w"].numpy()
        total_comp += dequantize_int8(q["w"], s["w"]).numpy()
    drift = np.abs(total_comp - total_true).max()
    assert drift <= float(resid["w"].abs().max()) + 1e-4


TWO_RANKS = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.optim.grad_compression import compressed_psum_ef

rank, store_path, data = int(sys.argv[1]), sys.argv[2], sys.argv[3]
arrs = np.load(data)
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
g = {"a": torch.from_numpy(arrs[f"g{rank}"]),
     "b": [torch.from_numpy(arrs[f"h{rank}"])]}
r = {"a": torch.from_numpy(arrs[f"r{rank}"]),
     "b": [torch.zeros_like(g["b"][0])]}
total, new_r = compressed_psum_ef(g, r)
print(json.dumps({"rank": rank, "a": total["a"].tolist(),
                  "b": total["b"][0].tolist(), "ra": new_r["a"].tolist(),
                  "rb": new_r["b"][0].tolist()}))
dist.barrier()
dist.destroy_process_group()
"""


def _reference_psum(gs, rs):
    """The reference's ``compressed_psum_ef`` arithmetic for ranks holding
    ``gs`` and residuals ``rs``: the shared scale, each rank's int8
    payload by ``quantize_int8`` at that scale, the int32 sum."""
    gfs = [jnp.asarray(g) + jnp.asarray(r) for g, r in zip(gs, rs)]
    s = max(float(jnp.maximum(jnp.max(jnp.abs(gf)), 1e-30)) for gf in gfs)
    s = jnp.float32(s) / 127.0
    qs = [r_gc.quantize_int8(gf, s)[0] for gf in gfs]
    total = sum(q.astype(jnp.int32) for q in qs).astype(jnp.float32) * s
    return (np.asarray(total),
            [np.asarray(gf - q.astype(jnp.float32) * s)
             for gf, q in zip(gfs, qs)])


def test_compressed_psum_ef_two_gloo_ranks(tmp_path):
    rng = np.random.default_rng(0)
    arrs = {}
    for k in range(2):
        arrs[f"g{k}"] = rng.normal(size=(128,)).astype(np.float32)
        arrs[f"r{k}"] = (rng.normal(size=(128,)) * 1e-3).astype(np.float32)
        arrs[f"h{k}"] = (rng.normal(size=(3, 5)) * (k + 1)).astype(np.float32)
    np.savez(tmp_path / "data.npz", **arrs)
    script = tmp_path / "ranks.py"
    script.write_text(TWO_RANKS)
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store"),
         str(tmp_path / "data.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    outs = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            o = json.loads(out.strip().splitlines()[-1])
            outs[o["rank"]] = o
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted(outs) == [0, 1]
    for key, (gk, rk) in {"a": ("g", "r"), "b": ("h", None)}.items():
        gs = [arrs[f"{gk}{k}"] for k in range(2)]
        rs = [arrs[f"{rk}{k}"] if rk else np.zeros_like(gs[k])
              for k in range(2)]
        total, resid = _reference_psum(gs, rs)
        for k in range(2):
            got = np.asarray(outs[k][key], np.float32).reshape(total.shape)
            np.testing.assert_array_equal(got, total)
            np.testing.assert_array_equal(
                np.asarray(outs[k]["r" + key], np.float32).reshape(
                    total.shape), resid[k])
        want = np.mean([g + r for g, r in zip(gs, rs)], axis=0)
        rel = np.abs(total / 2 - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 0.05, rel
