"""The port's partitioned launcher held to the JAX package's: ``run_join``
static through the sharded APRIL filter and through the host filter, the
sharded MBR join and refine, fused, adaptive and RI (with the torch build
backend) returns the reference's pairs (``run_join`` where it runs here,
else ``spatial_intersection_join(method="none")``), its counts where they
are defined alike, and a partition checkpoint resumes to the same pairs;
``run_tiled_join`` and the CLI ``main`` (``--device cpu``, in a
subprocess) give the reference's pairs. T1 60 x T2 90, ``parts=2``,
``n_order`` 7 (the reference's test size), on the CPU; tolerance zero."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.launch import spatial_join as r_launch  # noqa: E402
from repro.spatial import spatial_intersection_join as r_join  # noqa: E402

from repro_torch.launch import spatial_join as launch  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.spatial.distributed import make_join_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
SIZE = dict(n_order=7, parts=2, seed=0, count_r=60, count_s=90)


def _set(pairs):
    return set(map(tuple, np.asarray(pairs).tolist()))


@pytest.fixture(scope="module")
def want():
    """The refine-everything reference's pair set."""
    R = r_make_dataset("T1", seed=0, count=60)
    S = r_make_dataset("T2", seed=1, count=90)
    pairs, _ = r_join(R, S, method="none")
    return _set(pairs)


@pytest.fixture(scope="module")
def mesh():
    return make_join_mesh(device="cpu")


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jnp"),
                                                 ("numpy", "numpy")])
def test_static_equals_reference(mesh, want, backend, ref_backend):
    res, totals = launch.run_join(mesh=mesh, backend=backend, **SIZE)
    rres, rtotals = r_launch.run_join(backend=ref_backend, **SIZE)
    assert np.array_equal(res, rres) and totals == rtotals
    assert _set(res) == want and totals["true_neg"] > 0


@pytest.mark.parametrize("opts", [
    {"mbr_backend": "torch", "refine_backend": "device64"},
    {"refine_backend": "torch"},
    {"method": "ri", "build_backend": "torch"},
    {"method": "ra"},
    {"method": "april-c", "backend": "numpy", "refine_backend": "sequential"},
])
def test_stages_equal_reference(mesh, want, opts):
    res, totals = launch.run_join(mesh=mesh, **opts, **SIZE)
    assert _set(res) == want
    # the reference's host backends, where the port's runs the device
    ropts = {"backend": "numpy", "method": opts.get("method", "april"),
             "refine_backend": opts.get("refine_backend", "numpy")}
    if ropts["refine_backend"] not in ("numpy", "sequential"):
        ropts["refine_backend"] = "numpy"
    rres, rtotals = r_launch.run_join(**ropts, **SIZE)
    assert _set(res) == _set(rres)
    assert totals == rtotals


def test_fused_and_adaptive(mesh, want):
    res, totals = launch.run_join(mesh=mesh, pipeline_mode="fused", **SIZE)
    assert _set(res) == want
    staged, st_totals = launch.run_join(mesh=mesh, **SIZE)
    assert totals["true_hit"] >= st_totals["true_hit"]
    with pytest.raises(ValueError, match="april"):
        launch.run_join(mesh=mesh, pipeline_mode="fused", method="ri",
                        **SIZE)
    res, totals = launch.run_join(mesh=mesh, plan_mode="adaptive", **SIZE)
    assert _set(res) == want


def test_checkpoint_resume(tmp_path, mesh, want, capsys):
    ck = str(tmp_path / "ck")
    res, _ = launch.run_join(mesh=mesh, ckpt_dir=ck, **SIZE)
    assert _set(res) == want
    step, flat, _ = CheckpointManager(ck).restore()
    assert step == 4 and sorted(flat) == [f"part_{p}" for p in range(4)]
    capsys.readouterr()
    res2, _ = launch.run_join(mesh=mesh, ckpt_dir=ck, **SIZE)
    assert "[resume] 4 partitions already joined" in capsys.readouterr().out
    assert _set(res2) == want
    # a checkpoint the reference wrote resumes here too
    rck = str(tmp_path / "rck")
    r_launch.run_join(ckpt_dir=rck, backend="numpy", **SIZE)
    res3, totals = launch.run_join(mesh=mesh, ckpt_dir=rck, **SIZE)
    assert _set(res3) == want and totals["true_hit"] == 0


def test_run_tiled_join_equals_reference(tmp_path):
    kw = dict(tile_budget=60_000, n_order=7, count_r=150, count_s=200,
              chunk_size=64)
    pairs, st = launch.run_tiled_join("T1", "T2", device="cpu",
                                      ckpt_dir=str(tmp_path / "ck"), **kw)
    rpairs, rst = r_launch.run_tiled_join("T1", "T2", **kw)
    assert np.array_equal(pairs, rpairs) and st.tiles == rst.tiles > 1
    assert st.n_candidates == rst.n_candidates
    again, st2 = launch.run_tiled_join("T1", "T2", device="cpu",
                                       ckpt_dir=str(tmp_path / "ck"), **kw)
    assert st2.extra["resumed_tiles"] == st.tiles
    assert np.array_equal(again, pairs)


def _cli(*args):
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.spatial_join",
         "--device", "cpu", "--count-r", "60", "--count-s", "90",
         "--n-order", "7", *args], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_rank_device_under_torchrun(monkeypatch):
    """Each torchrun rank takes the card of its LOCAL_RANK."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.rank_device("cuda") == "cuda"
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert launch.rank_device("cpu") == "cpu"
    assert launch.rank_device("cuda:0") == "cuda:0"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    mesh = make_join_mesh(device=launch.rank_device("cuda"))
    assert mesh.device == torch.device("cuda", 1)


def test_cli_main(want):
    got = re.search(r"results (\d+)", _cli("--parts", "2")).group(1)
    assert int(got) == len(want)
    out = _cli("--tile-budget", "40000", "--chunk-size", "32")
    rpairs, rst = r_launch.run_tiled_join(
        "T1", "T2", tile_budget=40_000, n_order=7, count_r=60, count_s=90,
        chunk_size=32)
    assert f"tiles {rst.tiles} (0 resumed)" in out
    assert f"results {len(rpairs)}" in out and "filter=" in out
