"""The port's rank-sharded join stages held to the JAX package's: the
packed and bucketed filter batches array for array; the trichotomy over a
packed batch against the reference's jnp kernel and its sharded filter;
``verdicts_mesh`` and ``distributed_filter`` for all six filters; the
sharded MBR join against the reference's numpy ``mbr_join`` (pairs and
order); the sharded refine against its numpy ``refine`` for all three
kinds; the sharded fused chain against its staged numpy ``JoinPlan``, with
and without a skip-filter plan. Then two gloo ranks in two processes
(a ``FileStore``) run the four stages and must return the world-of-one
outputs. T1 60 x T2 90 (the reference's test size), ``n_order`` 7, on the
CPU; tolerance zero."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.april import build_april as r_build_april  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import distributed as rdist  # noqa: E402
from repro.spatial import refine as r_refine  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.mbr_join import mbr_join as r_mbr_join  # noqa: E402

from repro_torch import make_dataset, make_linestrings  # noqa: E402
from repro_torch.core import join  # noqa: E402
from repro_torch.spatial import PlanChoice, get_filter  # noqa: E402
from repro_torch.spatial import distributed as D  # noqa: E402
from repro_torch.spatial.mbr_join import mbr_inside, mbr_join  # noqa: E402

N_ORDER = 7
SRC = Path(__file__).resolve().parents[1] / "src"
FILTERS = ("april", "april-c", "ri", "ra", "5cch", "none")


@pytest.fixture(scope="module")
def data():
    R0 = r_make_dataset("T1", seed=51, count=60)
    S0 = r_make_dataset("T2", seed=52, count=90)
    R = make_dataset("T1", seed=51, count=60)
    S = make_dataset("T2", seed=52, count=90)
    return R0, S0, R, S, mbr_join(R.mbrs, S.mbrs)


@pytest.fixture(scope="module")
def mesh():
    return D.make_join_mesh(device="cpu")


def test_mesh_of_one(mesh):
    assert (mesh.rank, mesh.size, mesh.device.type, mesh.group) == \
        (0, 1, "cpu", None)
    assert mesh.backend == "torch" and mesh.shard(8) == slice(0, 8)
    with pytest.raises(ValueError, match="rank"):
        D.make_join_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="'torch'"):
        D.distributed_filter("april", None, None, np.zeros((0, 2)),
                             mesh=mesh, backend="jnp")


@pytest.mark.parametrize("n_dev", [1, 4])
def test_packing_and_buckets_match(data, n_dev):
    R0, S0, R, S, pairs = data
    ar, as_ = r_build_april(R0, N_ORDER), r_build_april(S0, N_ORDER)
    pr, ps = (get_filter("april").build(X, n_order=N_ORDER).store
              for X in (R, S))
    got = D.pack_pair_batch(pr, ps, pairs, pad_batch_to=n_dev)
    want = rdist.pack_pair_batch(ar, as_, pairs, pad_batch_to=n_dev)
    for k, v in want.arrays().items():
        assert np.array_equal(got.arrays()[k], v) and \
            got.arrays()[k].dtype == v.dtype, k
    assert np.array_equal(got.pair_idx, want.pair_idx)
    assert np.array_equal(got.valid, want.valid)
    # at a finer order the lists spread over several width buckets
    ar, as_ = r_build_april(R0, 9), r_build_april(S0, 9)
    pr, ps = (get_filter("april").build(X, n_order=9).store
              for X in (R, S))
    gb = D.bucket_pairs(pr, ps, pairs, n_devices=n_dev)
    wb = rdist.bucket_pairs(ar, as_, pairs, n_devices=n_dev)
    assert len(gb) == len(wb) == 3
    for g, w in zip(gb, wb):
        assert all(np.array_equal(g.arrays()[k], v)
                   for k, v in w.arrays().items())
        assert np.array_equal(g.pair_idx, w.pair_idx)
    assert D.bucket_pairs(pr, ps, np.zeros((0, 2))) == []


def test_april_filter_matches_jnp_kernel(data, mesh):
    R0, S0, R, S, pairs = data
    ar, as_ = r_build_april(R0, N_ORDER), r_build_april(S0, N_ORDER)
    pr, ps = (get_filter("april").build(X, n_order=N_ORDER).store
              for X in (R, S))
    for pad_batch, pad_width in ((1, 8), (4, 8), (2, 64)):
        packed = D.pack_pair_batch(pr, ps, pairs, pad_batch_to=pad_batch,
                                   pad_width_to=pad_width)
        with join.record_joins() as calls:
            verd, counts = D.distributed_april_filter(packed, mesh)
        assert [name for name, _ in calls] == ["april_trichotomy"]
        rpacked = rdist.pack_pair_batch(ar, as_, pairs,
                                        pad_batch_to=pad_batch,
                                        pad_width_to=pad_width)
        want, wcounts = rdist.distributed_april_filter(rpacked)
        assert verd.dtype == want.dtype and np.array_equal(verd, want)
        assert counts == wcounts
        kern = np.asarray(rdist.april_filter_kernel_jnp(
            {k: np.asarray(v) for k, v in rpacked.arrays().items()}))
        assert np.array_equal(verd[packed.valid], kern[packed.valid])
        assert (verd[~packed.valid] == -1).all()


@pytest.mark.parametrize("method", FILTERS)
def test_filter_and_verdicts_mesh_match(data, mesh, method):
    R0, S0, R, S, pairs = data
    fr, f = r_get_filter(method), get_filter(method)
    ar0, as0 = (fr.build(X, n_order=N_ORDER, side=side)
                for X, side in ((R0, "r"), (S0, "s")))
    ar, as_ = (f.build(X, n_order=N_ORDER, side=side)
               for X, side in ((R, "r"), (S, "s")))
    assert f.supports_mesh == fr.supports_mesh == (method == "april")
    ref_backend = "jnp" if method == "april" else "numpy"
    want, wcounts = rdist.distributed_filter(method, ar0, as0, pairs,
                                             backend=ref_backend)
    for backend in ("torch", "numpy"):
        got, counts = D.distributed_filter(method, ar, as_, pairs,
                                           mesh=mesh, backend=backend)
        assert np.array_equal(got, want) and counts == wcounts, backend
    if method == "april":
        got, counts = f.verdicts_mesh(ar, as_, pairs, mesh=mesh)
        want, wcounts = fr.verdicts_mesh(ar0, as0, pairs)
        assert np.array_equal(got, want) and counts == wcounts
    else:
        with pytest.raises(NotImplementedError):
            f.verdicts_mesh(ar, as_, pairs, mesh=mesh)
    # other predicates take the filter's batched path
    got, _ = D.distributed_filter(method, ar, as_, pairs, mesh=mesh,
                                  backend="torch", predicate="selection")
    want, _ = rdist.distributed_filter(method, ar0, as0, pairs,
                                       backend="numpy",
                                       predicate="selection")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_shard_pairs_cover_the_batch(data, size):
    pairs = data[4][:7]
    shards = [D.JoinMesh(torch.device("cpu"), None, r, size).shard_pairs(
        pairs) for r in range(size)]
    rows = np.concatenate([s for s, _ in shards])
    real = np.concatenate([r for _, r in shards])
    assert len(rows) % size == 0 and real.sum() == len(pairs)
    assert np.array_equal(rows[real], pairs)
    assert (rows[~real] == pairs[0]).all()


def test_verdicts_mesh_is_one_launch_over_csr(data, mesh):
    """One trichotomy call over the batch's own rows, on the cached CSR
    lists (no width buckets, no padded copies); a duplicated pair gets its
    own verdict in every slot."""
    R0, S0, R, S, pairs = data
    f = get_filter("april")
    ar, as_ = (f.build(X, n_order=N_ORDER, side=side)
               for X, side in ((R, "r"), (S, "s")))
    batch = np.concatenate([pairs, pairs[:5]])
    with join.record_joins() as calls:
        got, counts = f.verdicts_mesh(ar, as_, batch, mesh=mesh)
    assert [name for name, _ in calls] == ["april_trichotomy"]
    lists = calls[0][1]
    assert lists[0] is f._lists(ar, "A").to(mesh.device)
    assert np.array_equal(lists[-2].numpy(), batch[:, 0])
    want = f.verdicts(ar, as_, batch, backend="torch", device="cpu")
    assert np.array_equal(got, want)
    assert counts == {k: int(np.sum(want == v)) for k, v in (
        ("true_neg", join.TRUE_NEG), ("true_hit", join.TRUE_HIT),
        ("indecisive", join.INDECISIVE))}
    assert f.verdicts_mesh(ar, as_, np.zeros((0, 2)), mesh=mesh)[1] == \
        {"true_neg": 0, "true_hit": 0, "indecisive": 0}


@pytest.mark.parametrize("grid", [None, 1, 7])
def test_mbr_join_matches_numpy(data, mesh, grid):
    R0, S0, R, S, _ = data
    got, counts = D.distributed_mbr_join(R.mbrs, S.mbrs, grid=grid,
                                         mesh=mesh)
    want = r_mbr_join(R0.mbrs, S0.mbrs, grid=grid, backend="numpy")
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert counts["mbr_pairs"] == len(want) <= counts["mbr_candidates"]
    empty, zero = D.distributed_mbr_join(R.mbrs[:0], S.mbrs, mesh=mesh)
    assert empty.shape == (0, 2) and zero == {"mbr_candidates": 0,
                                              "mbr_pairs": 0}


@pytest.mark.parametrize("predicate", ["intersects", "within",
                                       "linestring"])
def test_refine_matches_numpy(data, mesh, predicate):
    R0, S0, R, S, pairs = data
    if predicate == "within":
        # S against itself: every polygon lies within itself
        R0, R = S0, S
        pairs = mbr_join(S.mbrs, S.mbrs)
        pairs = pairs[mbr_inside(S.mbrs[pairs[:, 0]], S.mbrs[pairs[:, 1]])]
    if predicate == "linestring":
        R0 = r_make_linestrings("T8", seed=53, count=60)
        R = make_linestrings("T8", seed=53, count=60)
        pairs = mbr_join(R.mbrs, S.mbrs)
    got, counts = D.distributed_refine(R, S, pairs, predicate=predicate,
                                       mesh=mesh)
    want = r_refine.refine(R0, S0, pairs, predicate=predicate,
                           backend="numpy")
    assert len(pairs) > 10 and 0 < want.sum() < len(want)
    assert np.array_equal(got, want)
    assert counts == {"refined_true": int(want.sum())}
    assert D.distributed_refine(R, S, pairs[:0], mesh=mesh)[0].shape == (0,)


@pytest.mark.parametrize("skip", [False, True])
def test_fused_join_matches_staged_numpy(data, mesh, skip):
    from repro_torch.kernels.compact import compact_mask_plain
    from repro_torch.spatial import fused
    R0, S0, R, S, _ = data
    method = "none" if skip else "april"
    want, st = RJoinPlan(R0, S0, filter=method, n_order=N_ORDER,
                         filter_backend="numpy",
                         refine_backend="numpy").build().execute(
        "intersects")
    ar = as_ = plan = None
    if skip:
        plan = PlanChoice(method="april", n_order=N_ORDER, skip_filter=True)
    else:
        ar, as_ = (get_filter("april").build(X, n_order=N_ORDER)
                   for X in (R, S))
    with fused.record_chains() as chains, join.record_joins() as calls:
        got, counts = D.distributed_fused_join(R, S, ar, as_, mesh=mesh,
                                               plan=plan)
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert len(got) == len(want)
    assert counts == {"mbr_pairs": st.n_candidates,
                      "true_neg": st.n_true_negs,
                      "true_hit": st.n_true_hits,
                      "indecisive": st.n_indecisive}
    assert len(calls) == (0 if skip else 1)
    (cs,) = chains
    perm, count = compact_mask_plain(cs.status == join.INDECISIVE)
    assert int(count) == st.n_indecisive
    # the staged numpy JoinPlan of the port gives the same pairs in order
    from repro_torch import JoinPlan
    ours, _ = JoinPlan(R, S, n_order=N_ORDER, device="cpu",
                       mbr_backend="torch",
                       pipeline_mode="fused").build().execute("intersects")
    if not skip:
        assert np.array_equal(np.sort(got, axis=0), np.sort(ours, axis=0))


TWO_RANKS = """
import json, sys
import numpy as np
import torch.distributed as dist
from repro_torch import make_dataset
from repro_torch.spatial import PlanChoice, get_filter
from repro_torch.spatial import distributed as D
from repro_torch.spatial.mbr_join import mbr_join

rank, store_path = int(sys.argv[1]), sys.argv[2]
R = make_dataset("T1", seed=51, count=60)
S = make_dataset("T2", seed=52, count=90)
ar, as_ = (get_filter("april").build(X, n_order=7) for X in (R, S))
pairs = mbr_join(R.mbrs, S.mbrs)


def run(mesh):
    packed = D.pack_pair_batch(ar.store, as_.store, pairs, pad_batch_to=2)
    return {"mbr": D.distributed_mbr_join(R.mbrs, S.mbrs, mesh=mesh),
            "filter": D.distributed_april_filter(packed, mesh),
            "mesh": get_filter("april").verdicts_mesh(ar, as_, pairs,
                                                      mesh=mesh),
            "refine": D.distributed_refine(R, S, pairs, mesh=mesh),
            "fused": D.distributed_fused_join(R, S, ar, as_, mesh=mesh),
            "skip": D.distributed_fused_join(
                R, S, None, None, mesh=mesh,
                plan=PlanChoice(method="none"))}


one = run(D.make_join_mesh(device="cpu"))
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
mesh = D.make_join_mesh(2, device="cpu")
two = run(mesh)
same = {k: bool(np.array_equal(one[k][0], two[k][0])
                and one[k][1] == two[k][1]) for k in one}
print(json.dumps({"rank": mesh.rank, "size": mesh.size, "same": same,
                  "pairs": len(two["fused"][0]),
                  "mbr_candidates": two["mbr"][1]["mbr_candidates"]}))
dist.barrier()          # no rank tears the group down under another
dist.destroy_process_group()
"""


def test_two_gloo_ranks_equal_world_of_one(tmp_path):
    script = tmp_path / "ranks.py"
    script.write_text(TWO_RANKS)
    env = {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp_path / "store")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        assert o["size"] == 2 and all(o["same"].values()), o
        assert o["pairs"] > 0 and o["mbr_candidates"] > 0
