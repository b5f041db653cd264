"""The port's training launcher held to the JAX package's on the CPU:
``SyntheticCorpus`` batches equal the reference's token for token (and
its frames and patches), the cursor state round-trips, the port's
crash-resume equivalence, a reference checkpoint resumes in the port with
the reference's losses and a port checkpoint in the reference with the
port's, a checkpoint of another model is refused, the AdamW state
conversion round trip is exact, and the CLI runs.

Tolerance: resumed losses within ``rtol`` 1e-4 and ``atol`` 1e-5 of the
uninterrupted run's, the bound of the reference's
``tests/test_fault_tolerance.py::test_crash_resume_equivalence``.
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
from repro.launch import train as r_launch  # noqa: E402
from repro.models import model as r_model  # noqa: E402
from repro.models.train import make_train_step as r_make_step  # noqa: E402
from repro.optim.adamw import adamw_init as r_adamw_init  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import SyntheticCorpus, train_loop  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    load_reference_opt_state, load_reference_params, to_reference_opt_state)
from repro_torch.models.train import make_train_step  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
RUN = dict(smoke=True, steps=12, batch=2, seq=32, ckpt_every=4, lr=1e-3)
RESUME_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b",
                                  "whisper-small", "llama-3.2-vision-11b"])
def test_corpus_batches_match_reference(arch):
    cfg, rcfg = get_config(arch, smoke=True), r_get_config(arch, smoke=True)
    ours = SyntheticCorpus(cfg.vocab, 3, 24, seed=7)
    theirs = r_launch.SyntheticCorpus(rcfg.vocab, 3, 24, seed=7)
    for cursor in (0, 1, 5):
        ours.load_state({"cursor": np.asarray(cursor)})
        theirs.load_state({"cursor": np.asarray(cursor)})
        got, want = ours.next_batch(cfg), theirs.next_batch(rcfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == {"tokens": torch.int32,
                                    "labels": torch.int32}.get(
                k, torch.float32)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert ours.state()["cursor"] == theirs.state()["cursor"] == cursor + 1


def test_cursor_state_round_trips():
    d1 = SyntheticCorpus(100, 2, 8)
    for _ in range(5):
        d1.next_batch()
    d2 = SyntheticCorpus(100, 2, 8)
    d2.load_state(d1.state())
    np.testing.assert_array_equal(d1.next_batch()["tokens"].numpy(),
                                  d2.next_batch()["tokens"].numpy())


@pytest.fixture(scope="module")
def uninterrupted():
    """The 12 losses of an uninterrupted run of each package."""
    return {"port": train_loop("smollm-135m", device="cpu", **RUN)[2],
            "reference": r_launch.train_loop("smollm-135m", **RUN)[2]}


def test_crash_resume_equivalence(tmp_path, uninterrupted):
    ck = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected failure at step 9"):
        train_loop("smollm-135m", ckpt_dir=ck, fail_at_step=9, device="cpu",
                   **RUN)
    _, opt, resumed = train_loop("smollm-135m", ckpt_dir=ck, device="cpu",
                                 **RUN)
    # the resumed run re-executes steps 8..11 (last checkpoint at 8)
    assert int(opt["step"]) == 12
    np.testing.assert_allclose(resumed, uninterrupted["port"][8:],
                               **RESUME_TOL)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, uninterrupted):
    ck = str(tmp_path / "ref")
    r_launch.train_loop("smollm-135m", ckpt_dir=ck, **dict(RUN, steps=8))
    _, _, resumed = train_loop("smollm-135m", ckpt_dir=ck, device="cpu",
                               **RUN)
    np.testing.assert_allclose(resumed, uninterrupted["reference"][8:],
                               **RESUME_TOL)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, uninterrupted):
    ck = str(tmp_path / "port")
    train_loop("smollm-135m", ckpt_dir=ck, device="cpu", **dict(RUN, steps=8))
    _, r_opt, resumed = r_launch.train_loop("smollm-135m", ckpt_dir=ck,
                                            **RUN)
    assert int(r_opt["step"]) == 12
    np.testing.assert_allclose(resumed, uninterrupted["port"][8:],
                               **RESUME_TOL)


def test_checkpoint_of_another_model_is_refused(tmp_path):
    ck = str(tmp_path / "gemma")
    small = dict(batch=1, seq=8, device="cpu")
    train_loop("gemma2-2b", ckpt_dir=ck, steps=1, ckpt_every=1, **small)
    with pytest.raises(ValueError, match="does not hold"):
        train_loop("smollm-135m", ckpt_dir=ck, steps=2, **small)


def test_async_save_of_a_cpu_tensor_is_a_snapshot(tmp_path, monkeypatch):
    """ROADMAP C11: an in-place update made after ``save`` returns does not
    reach a checkpoint written in the background."""
    import threading
    from repro_torch.runtime import checkpoint
    go = threading.Event()
    write = checkpoint.CheckpointManager._write

    def held(self, *a):
        go.wait(30)
        write(self, *a)
    monkeypatch.setattr(checkpoint.CheckpointManager, "_write", held)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"))
    w = torch.zeros(4)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    go.set()
    mgr.wait()
    step, flat, _ = mgr.restore()
    assert step == 1
    np.testing.assert_array_equal(flat["w"], np.zeros(4, np.float32))


def _tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small"])
def test_opt_state_round_trip_is_exact(arch):
    """A stepped state (nonzero moments) crosses both ways bit for bit:
    recurrentgemma-2b has tail layers, whisper-small an encoder."""
    rcfg, cfg = r_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.normal(size=(2, cfg.encoder.n_frames,
                                           cfg.d_model)).astype(np.float32)
    params = r_model.init_model(jax.random.PRNGKey(0), rcfg)
    _, r_opt, _ = jax.jit(r_make_step(rcfg))(
        params, r_adamw_init(params), jax.tree.map(jnp.asarray, batch))
    r_opt = jax.tree.map(np.asarray, r_opt)
    opt = load_reference_opt_state(cfg, r_opt, device="cpu")
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    _tree_equal(to_reference_opt_state(cfg, opt), r_opt)

    model = load_reference_params(cfg, jax.tree.map(np.asarray, params),
                                  device="cpu")
    _, ours, _ = make_train_step(cfg, device="cpu")(
        model, adamw_init(dict(model.named_parameters())), batch)
    back = load_reference_opt_state(cfg, to_reference_opt_state(cfg, ours),
                                    device="cpu")
    # the moments are looked up by name, so their order does not matter
    assert set(back["m"]) == set(ours["m"]) == {
        n for n, _ in model.named_parameters()}
    for k in ("m", "v"):
        for n, t in ours[k].items():
            assert torch.equal(back[k][n], t), (k, n)
    assert int(back["step"]) == int(ours["step"]) == 1


def test_cli_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "6"], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done in" in r.stdout and "on cpu" in r.stdout
