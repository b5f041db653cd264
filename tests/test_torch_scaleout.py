"""The port's out-of-core tiled join held to the JAX package's:
``plan_scaleout`` gives the reference's ``TilePlan`` (``to_dict``, the
cost floats to the bit) for both balance modes; ``tiled_join`` gives the
reference's pair arrays and ``JoinStats`` counts for every filter x
``intersects`` / ``within`` / ``selection`` / ``linestring``, adaptive with
a ``ProfileCache`` and static balance; kill and resume, the fingerprint
guard and ``resume=False`` behave as the reference's, and a checkpoint the
reference wrote resumes here to its pairs; ``tiled_spatial_join``
forwards. The reference's test sizes (T1 280 x T2 400 streamed in chunks
of 100, ``n_order`` 7, a budget of 150,000 bytes), on the CPU; tolerance
zero."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import iter_dataset_chunks as r_iter_chunks  # noqa: E402
from repro.datagen import make_chunked_dataset as r_chunked  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.spatial import scaleout as rscaleout  # noqa: E402
from repro.spatial import tiled_spatial_join as r_tiled_spatial_join  # noqa: E402,E501
from repro.spatial.planner import ProfileCache as RProfileCache  # noqa: E402

from repro_torch import JoinPlan, JoinStats  # noqa: E402
from repro_torch.datagen import (iter_dataset_chunks,  # noqa: E402
                                 make_chunked_dataset, make_linestrings)
from repro_torch.spatial import (ProfileCache, available_filters,  # noqa: E402
                                 plan_scaleout, tiled_join,
                                 tiled_spatial_join)
from repro_torch.spatial.distributed import make_join_mesh  # noqa: E402

COUNT_R, COUNT_S, CHUNK = 280, 400, 100
N_ORDER = 7
TILED = dict(tile_budget=150_000, split_factor=1.0, min_split_objs=32)
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results", "tiles")


def _chunks(it):
    return (it("T1", seed=5, count=COUNT_R, chunk_size=CHUNK),
            it("T2", seed=6, count=COUNT_S, chunk_size=CHUNK))


def _same(got, want):
    (pairs, st), (rpairs, rst) = got, want
    assert pairs.dtype == rpairs.dtype and np.array_equal(pairs, rpairs)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k
    assert st.extra["tile_plan"] == rst.extra["tile_plan"]
    assert st.extra["resumed_tiles"] == rst.extra["resumed_tiles"]


@pytest.mark.parametrize("balance", ["cost", "static"])
def test_plan_scaleout_equals_reference(tmp_path, balance):
    opts = dict(TILED, balance=balance)
    plan, store, tot = plan_scaleout(*_chunks(iter_dataset_chunks),
                                     spill_dir=str(tmp_path / "p"),
                                     n_order=N_ORDER, **opts)
    rplan, rstore, rtot = rscaleout.plan_scaleout(
        *_chunks(r_iter_chunks), spill_dir=str(tmp_path / "r"),
        n_order=N_ORDER, **opts)
    assert tot == rtot == (COUNT_R, COUNT_S)
    assert plan.to_dict() == rplan.to_dict()
    assert np.array_equal(plan.cover(), rplan.cover())
    # the cost floats themselves, unrounded
    for p, q in zip(plan.parts, rplan.parts):
        assert p.est == q.est
        assert (p.extent.x0, p.extent.y0, p.extent.side) == \
            (q.extent.x0, q.extent.y0, q.extent.side)
    if balance == "cost":
        assert plan.est["n_splits"] > 0 and len(plan.tiles) >= 4
        assert sum(p.est["bytes"] for p in plan.parts) >= \
            4 * TILED["tile_budget"]
    else:
        assert plan.est["n_splits"] == 0
    assert sorted(store.spills) == sorted(rstore.spills)
    with pytest.raises(TypeError, match="scaleout option"):
        plan_scaleout([], [], spill_dir=str(tmp_path / "x"), bogus=1)
    with pytest.raises(ValueError, match="balance"):
        plan_scaleout([], [], spill_dir=str(tmp_path / "y"), balance="x")


@pytest.mark.parametrize("method", sorted(available_filters()))
@pytest.mark.parametrize("predicate", ["intersects", "within", "selection",
                                       "linestring"])
def test_tiled_join_equals_reference(method, predicate):
    if predicate == "linestring":
        ours = (make_linestrings(seed=7, count=150),
                make_chunked_dataset("T2", seed=6, count=COUNT_S,
                                     chunk_size=CHUNK))
        ref = (r_make_linestrings(seed=7, count=150),
               r_chunked("T2", seed=6, count=COUNT_S, chunk_size=CHUNK))
        kw = {"r_kind": "line"}
    else:
        ours, ref, kw = _chunks(iter_dataset_chunks), \
            _chunks(r_iter_chunks), {}
    got = tiled_join(*ours, predicate=predicate, method=method,
                     n_order=N_ORDER, device="cpu", **kw, **TILED)
    want = rscaleout.tiled_join(*ref, predicate=predicate, method=method,
                                n_order=N_ORDER, **kw, **TILED)
    _same(got, want)
    assert got[1].tiles > 1 and got[1].filter_backend == "torch"


def test_tiled_join_matches_in_memory_plan():
    R = make_chunked_dataset("T1", seed=5, count=COUNT_R, chunk_size=CHUNK)
    S = make_chunked_dataset("T2", seed=6, count=COUNT_S, chunk_size=CHUNK)
    want, _ = JoinPlan(R, S, n_order=N_ORDER, device="cpu").execute(
        "intersects")
    for opts in ({"pipeline_mode": "fused", "mbr_backend": "torch"},
                 {"refine_backend": "device64"}):
        pairs, st = tiled_join(*_chunks(iter_dataset_chunks),
                               n_order=N_ORDER, device="cpu", **opts,
                               **TILED)
        assert set(map(tuple, pairs.tolist())) == \
            set(map(tuple, want.tolist())), opts
    # a mesh of one sends the fused APRIL and none plans through the
    # sharded chain, and the pairs stay those of the reference
    mesh = make_join_mesh(device="cpu")
    for method in ("april", "none"):
        got = tiled_join(*_chunks(iter_dataset_chunks), method=method,
                         n_order=N_ORDER, pipeline_mode="fused", mesh=mesh,
                         device="cpu", **TILED)
        rpairs, rst = rscaleout.tiled_join(*_chunks(r_iter_chunks),
                                           method=method, n_order=N_ORDER,
                                           **TILED)
        assert set(map(tuple, got[0].tolist())) == \
            set(map(tuple, rpairs.tolist()))
        for k in COUNTS[:4]:
            assert getattr(got[1], k) == getattr(rst, k), (method, k)


def test_static_balance_and_adaptive_equal_reference():
    got = tiled_join(*_chunks(iter_dataset_chunks), n_order=N_ORDER,
                     balance="static", tile_budget=TILED["tile_budget"],
                     device="cpu")
    want = rscaleout.tiled_join(*_chunks(r_iter_chunks), n_order=N_ORDER,
                                balance="static",
                                tile_budget=TILED["tile_budget"])
    _same(got, want)
    assert got[1].extra["tile_plan"]["n_splits"] == 0
    cache, rcache = ProfileCache(), RProfileCache()
    got = tiled_join(*_chunks(iter_dataset_chunks), n_order=N_ORDER,
                     plan_mode="adaptive", profile_cache=cache,
                     device="cpu", **TILED)
    want = rscaleout.tiled_join(*_chunks(r_iter_chunks), n_order=N_ORDER,
                                plan_mode="adaptive", profile_cache=rcache,
                                **TILED)
    _same(got, want)
    assert got[1].extra["profile_cache"] == want[1].extra["profile_cache"]
    assert len(cache) == len(rcache) > 0


def test_kill_resume_guard_and_fresh(tmp_path):
    ck, rck = str(tmp_path / "ck"), str(tmp_path / "rck")
    kw = dict(method="april", n_order=N_ORDER, **TILED)
    part = tiled_join(*_chunks(iter_dataset_chunks), ckpt_dir=ck,
                      stop_after_tiles=2, device="cpu", **kw)
    rpart = rscaleout.tiled_join(*_chunks(r_iter_chunks), ckpt_dir=rck,
                                 stop_after_tiles=2, **kw)
    _same(part, rpart)
    assert part[1].extra["interrupted"] is True
    resumed = tiled_join(*_chunks(iter_dataset_chunks), ckpt_dir=ck,
                         device="cpu", **kw)
    rresumed = rscaleout.tiled_join(*_chunks(r_iter_chunks), ckpt_dir=rck,
                                    **kw)
    _same(resumed, rresumed)
    assert resumed[1].extra["resumed_tiles"] == 2
    assert "interrupted" not in resumed[1].extra
    clean = tiled_join(*_chunks(iter_dataset_chunks), device="cpu", **kw)
    assert np.array_equal(np.sort(clean[0], axis=0),
                          np.sort(resumed[0], axis=0))
    for k in COUNTS:
        assert getattr(clean[1], k) == getattr(resumed[1], k), k
    # another configuration does not resume the manifest; nor resume=False
    other = tiled_join(*_chunks(iter_dataset_chunks), ckpt_dir=ck,
                       method="ri", n_order=N_ORDER, device="cpu", **TILED)
    assert other[1].extra["resumed_tiles"] == 0
    fresh = tiled_join(*_chunks(iter_dataset_chunks), ckpt_dir=ck,
                       resume=False, device="cpu", **kw)
    assert fresh[1].extra["resumed_tiles"] == 0
    assert np.array_equal(fresh[0], clean[0])


def test_reference_checkpoint_resumes_here(tmp_path):
    ck = str(tmp_path / "ck")
    kw = dict(method="april", n_order=N_ORDER, **TILED)
    rscaleout.tiled_join(*_chunks(r_iter_chunks), ckpt_dir=ck,
                         stop_after_tiles=2, **kw)
    full, rst = rscaleout.tiled_join(*_chunks(r_iter_chunks), **kw)
    pairs, st = tiled_join(*_chunks(iter_dataset_chunks), ckpt_dir=ck,
                           device="cpu", **kw)
    assert st.extra["resumed_tiles"] == 2
    assert np.array_equal(pairs, full)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k


def test_tiled_spatial_join_and_stats():
    got = tiled_spatial_join(*_chunks(iter_dataset_chunks),
                             n_order=N_ORDER, device="cpu", **TILED)
    want = r_tiled_spatial_join(*_chunks(r_iter_chunks), n_order=N_ORDER,
                                **TILED)
    _same(got, want)
    st = got[1]
    assert st.tiles > 1 and st.t_partition > 0
    back = JoinStats.from_dict(st.to_dict())
    assert (back.tiles, back.t_partition) == (st.tiles, st.t_partition)
    assert f"tiles={st.tiles}" in st.row()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tiled_join([], [], **TILED)
