"""The port's fused chain (``JoinPlan(pipeline_mode="fused")``) held to the
JAX package: the compaction's plain version against the Pallas scan in
interpret mode and the argsort oracle, bit for bit; the APRIL status lane
against ``fused_status_rows``; the float64 MBR lane against
``pair_mask_body`` and the brute-force oracle; the float64 refine cores
against ``_intersects_impl_jnp`` (verdicts equal on every row neither side
flags uncertain, and equal to the numpy refine after the host re-check);
and the whole chain against the reference's staged numpy plan, pairs,
order and counts. The scan kernel itself runs only on the card (``cuda``
marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import join as rjoin  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.kernels.compact import compact_mask as r_compact_mask  # noqa: E402
from repro.kernels.compact.ref import compact_mask_ref  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial.mbr_join import _prepare as r_prepare  # noqa: E402
from repro.spatial.mbr_join import (  # noqa: E402
    candidate_rows as r_candidate_rows, mbr_intersect_mask,
    mbr_join as r_mbr_join, pair_mask_body)
from repro.spatial import refine as rrefine  # noqa: E402

from repro_torch import JoinPlan, JoinStats, make_dataset, state  # noqa: E402
from repro_torch.core import geometry  # noqa: E402
from repro_torch.core.join import INDECISIVE, TRUE_NEG  # noqa: E402
from repro_torch.datagen.fixtures import SNAPPED_HOST, SNAPPED_TRI  # noqa: E402
from repro_torch.kernels.interval_join import (  # noqa: E402
    april_trichotomy_plain)
from repro_torch.kernels.compact import cases as compact_cases  # noqa: E402
from repro_torch.kernels.compact import (compact_mask,  # noqa: E402
                                         compact_mask_plain)
from repro_torch.kernels.compact.ops import TILE  # noqa: E402
from repro_torch.spatial import PIPELINE_MODES, fused, refine  # noqa: E402
from repro_torch.spatial.mbr_join import (  # noqa: E402
    MBR_BACKENDS, _prepare, candidate_rows, check_mbr_backend, mbr_join,
    pair_mask_lane)
from repro_torch.spatial.filters import get_filter  # noqa: E402

COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
DEFAULT = ("AA", "AF", "FA")


def _masks():
    """The lanes of the reference's compaction test."""
    rng = np.random.default_rng(9)
    return [np.zeros(0, bool), np.zeros(1, bool), np.ones(1, bool),
            np.zeros(257, bool), np.ones(257, bool), rng.random(1) < 0.5,
            rng.random(513) < 0.3, rng.random(4096) < 0.7,
            rng.random(5000) < 0.01]


def _carry(D):
    return state.dataset_from_arrays(D.name, D.verts, D.nverts)


def _ds(verts_list, name="fixture"):
    """A reference dataset and the port's copy of it over the given rings."""
    V = max(len(v) for v in verts_list)
    verts = np.zeros((len(verts_list), V, 2))
    nv = np.zeros(len(verts_list), np.int64)
    for i, v in enumerate(verts_list):
        verts[i, : len(v)] = v
        nv[i] = len(v)
    return (PolygonDataset(name=name, verts=verts, nverts=nv),
            state.dataset_from_arrays(name, verts, nv))


@pytest.fixture(scope="module")
def t1t2():
    """T1 x T2 (80 x 160): reference datasets and plan, the port's copies."""
    R0 = r_make_dataset("T1", seed=0, count=80)
    S0 = r_make_dataset("T2", seed=1, count=160)
    rplan = RJoinPlan(R0, S0, filter="april", n_order=8).build()
    return R0, S0, rplan, make_dataset("T1", seed=0, count=80), \
        make_dataset("T2", seed=1, count=160)


# ---------------------------------------------------------------------------
# compaction (B3)
# ---------------------------------------------------------------------------

def _compact_matches_reference(mask):
    """The wrapper on a CPU lane (the plain version) equals the Pallas scan
    in interpret mode and the argsort oracle bit for bit, and keeps the
    front-pack contract."""
    m = jnp.asarray(mask)
    want_perm, want_count = r_compact_mask(m, backend="pallas",
                                           interpret=True)
    ref_perm, ref_count = compact_mask_ref(m)
    perm, count = compact_mask(torch.from_numpy(mask))
    assert perm.dtype == count.dtype == torch.int32 and count.dim() == 0
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ref_perm))
    assert int(count) == int(want_count) == int(ref_count) == mask.sum()
    k = int(count)
    np.testing.assert_array_equal(perm[:k].numpy(), np.flatnonzero(mask))
    np.testing.assert_array_equal(perm[k:].numpy(), np.flatnonzero(~mask))


@pytest.mark.parametrize("i", range(len(_masks())))
def test_compact_mask_matches_reference(i):
    _compact_matches_reference(_masks()[i])


@pytest.mark.parametrize("name", list(compact_cases.lanes()))
def test_compact_mask_tiling_edges_match_reference(name):
    """The lanes at the kernel's tiling edges (``compact.cases``, also the
    card sweep): lengths 0, 1, 1023, 1024 and 1025, set all, none, first,
    last or alternating."""
    _compact_matches_reference(compact_cases.lanes()[name])


def test_compact_cases_cover_the_edges():
    lanes = compact_cases.lanes()
    assert {len(m) for m in lanes.values()} == set(compact_cases.LENGTHS)
    for n in (1023, 1024, 1025):
        assert len([m for m in lanes.values() if len(m) == n]) == 5
    big = compact_cases.lanes(long=True)
    longs = [m for m in big.values() if len(m) == compact_cases.LONG_ROWS]
    assert len(longs) == 2 and all(0 < m.sum() < len(m) for m in longs)
    # more tiles than the resident grid of an H100 (132 SMs x 8 blocks)
    assert compact_cases.LONG_ROWS > 132 * 8 * TILE


def test_compact_mask_checks_its_lane():
    with pytest.raises(ValueError, match="1-D bool"):
        compact_mask(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D bool"):
        compact_mask(torch.zeros((2, 2), dtype=torch.bool))
    perm, count = compact_mask_plain(torch.ones(3, dtype=torch.bool))
    assert perm.tolist() == [0, 1, 2] and int(count) == 3


# ---------------------------------------------------------------------------
# the filter stage's status lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,order", [
    ("torch", DEFAULT), ("numpy", DEFAULT), ("sequential", DEFAULT),
    ("torch", ("AA", "AF")), ("numpy", ("FA", "AA"))])
def test_status_lane_matches_reference(t1t2, backend, order):
    """The APRIL lane equals the reference's: ``fused_status_rows`` for the
    full order, the uploaded host verdicts for the sequential backend and
    a degenerate order."""
    R0, S0, rplan, R, S = t1t2
    pairs = rplan.candidates("intersects")
    ri, si = pairs[:, 0], pairs[:, 1]
    want = np.asarray(rplan.filter.status_lane(
        rplan.approx_r, rplan.approx_s, ri, si, backend="numpy",
        order=order))
    if set(order) == set(DEFAULT):
        L = [rplan.filter._lists(a, k) for a in (rplan.approx_r,
                                                 rplan.approx_s)
             for k in ("A", "F")]
        np.testing.assert_array_equal(
            want, np.asarray(rjoin.fused_status_rows("intersects", *L, ri,
                                                     si)))
    plan = JoinPlan(R, S, n_order=8, device="cpu").build()
    f = get_filter("april")
    lane = f.status_lane(plan.approx_r, plan.approx_s, ri, si,
                         backend=backend, device="cpu", order=order)
    assert lane.dtype == torch.int8 and lane.device.type == "cpu"
    np.testing.assert_array_equal(lane.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2}
    empty = f.status_lane(plan.approx_r, plan.approx_s, ri[:0], si[:0],
                          backend=backend, device="cpu", order=order)
    assert empty.shape == (0,) and empty.dtype == torch.int8


def test_status_lane_checks_the_frame(t1t2):
    _, _, _, R, S = t1t2
    plan = JoinPlan(R, S, n_order=8, device="cpu").build()
    with pytest.raises(IndexError, match="si"):
        get_filter("april").status_lane(plan.approx_r, plan.approx_s,
                                        np.array([0]), np.array([len(S)]),
                                        backend="torch", device="cpu")


# ---------------------------------------------------------------------------
# the MBR stage's valid lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,shift", [(1.0, (0.0, 0.0)),
                                         (3.7, (1000.0, -55.0)),
                                         (1e-3, (2.0, 2.0)),
                                         (1e6, (-3e5, 4e4))])
def test_pair_mask_lane_matches_reference(scale, shift):
    """The float64 lane equals ``pair_mask_body(jnp, ...)`` under x64 on the
    co-bucket rows; its pair set equals the brute-force oracle, on a
    translated and scaled extent too; the staged ``torch`` backend keeps
    the numpy backend's pair order."""
    mr = r_make_dataset("T1", seed=61, count=110).mbrs * scale
    ms = r_make_dataset("T2", seed=62, count=160).mbrs * scale
    mr = mr + np.array(list(shift) * 2)
    ms = ms + np.array(list(shift) * 2)
    a, b, k, extent = r_prepare(mr, ms, None)
    rows = r_candidate_rows(a, b, k, extent)
    ta, tb, tk, textent = _prepare(mr, ms, None)
    assert (tk, textent) == (k, extent)
    got_rows = candidate_rows(ta, tb, tk, textent)
    for x, y in zip(got_rows, rows):
        np.testing.assert_array_equal(x, y)
    ri, si, ox, oy, lo_r, lo_s = rows
    with jax.enable_x64(True):
        want = np.asarray(pair_mask_body(
            jnp, jnp.asarray(a), jnp.asarray(b), jnp.asarray(lo_r),
            jnp.asarray(lo_s), jnp.asarray(ri), jnp.asarray(si),
            jnp.asarray(ox), jnp.asarray(oy)))
    lane = pair_mask_lane(a, b, lo_r, lo_s, torch.from_numpy(ri),
                          torch.from_numpy(si), ox, oy, "cpu")
    assert lane.dtype == torch.bool
    np.testing.assert_array_equal(lane.numpy(), want)
    oracle = set(map(tuple, np.argwhere(mbr_intersect_mask(mr, ms))
                     .tolist()))
    keep = lane.numpy()
    assert set(zip(ri[keep].tolist(), si[keep].tolist())) == oracle
    assert keep.sum() == len(oracle)
    staged = mbr_join(mr, ms, backend="torch", device="cpu")
    np.testing.assert_array_equal(staged, mbr_join(mr, ms))
    np.testing.assert_array_equal(staged, r_mbr_join(mr, ms))


def test_mbr_backend_names():
    assert MBR_BACKENDS == ("numpy", "torch", "sequential")
    with pytest.raises(ValueError, match="mbr_backend='torch'"):
        check_mbr_backend("jnp")
    with pytest.raises(ValueError, match="unknown mbr backend"):
        check_mbr_backend("gpu")


# ---------------------------------------------------------------------------
# the float64 refine cores
# ---------------------------------------------------------------------------

def _touchy():
    sq = np.array([[0., 0.], [4., 0.], [4., 4.], [0., 4.]])
    R = [sq + np.array([4.0, 0.0]), sq + np.array([4.0, 4.0]),
         np.array([[2., 4.], [3., 3.], [1., 3.]]),
         np.array([[1., 1.], [3., 1.], [2., 3.]]), sq,
         sq + np.array([10., 10.]),
         np.array([[-1., -1.], [5., -1.], [5., 5.], [-1., 5.]])]
    return _ds(R, "r") + _ds([sq] * len(R), "s")


def _inputs(name):
    """(R0, S0, R, S, pairs): reference datasets, the port's copies and the
    pair rows the cores refine."""
    if name == "t1t2":
        R0 = r_make_dataset("T1", seed=0, count=80)
        S0 = r_make_dataset("T2", seed=1, count=160)
        pairs = r_mbr_join(R0.mbrs, S0.mbrs)
        return R0, S0, _carry(R0), _carry(S0), pairs
    if name == "touchy":
        R0, R, S0, S = _touchy()
        return R0, S0, R, S, np.stack([np.arange(7)] * 2, axis=1)
    R0, R = _ds([SNAPPED_TRI], "r")
    S0, S = _ds([SNAPPED_HOST], "s")
    return R0, S0, R, S, np.zeros((1, 2), np.int64)


@pytest.mark.parametrize("name", ["t1t2", "touchy", "snapped"])
def test_intersects_core_matches_reference(name):
    R0, S0, R, S, pairs = _inputs(name)
    ri, si = pairs[:, 0], pairs[:, 1]
    rep_r = geometry.representative_points(R.verts, R.nverts)
    rep_s = geometry.representative_points(S.verts, S.nverts)
    args = (R.verts[ri], R.nverts[ri], S.verts[si], S.nverts[si], rep_r[ri],
            rep_s[si])
    with jax.enable_x64(True):
        wv, wu = (np.asarray(x) for x in jax.jit(
            rrefine._intersects_impl_jnp)(*(jnp.asarray(a) for a in args)))
    gv, gu = (x.numpy() for x in refine._intersects_impl(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
    sure = ~wu & ~gu
    assert sure.sum() >= len(pairs) - 2
    np.testing.assert_array_equal(gv[sure], wv[sure])
    want = rrefine.refine_pairs(R0, S0, pairs, backend="numpy")
    got = gv.copy()
    if gu.any():
        got[gu] = refine.refine_pairs(R, S, pairs[gu], backend="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, rrefine.refine_pairs_seq(R0, S0,
                                                                 pairs))


def test_fused_refine_lanes_are_row_wise(t1t2, monkeypatch):
    """The packed lanes do not depend on the chunk size, rows past the
    count are False, and the live rows equal the numpy refine."""
    _, _, _, R, S = t1t2
    pairs = mbr_join(R.mbrs, S.mbrs)
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random(len(pairs)) < 0.4)
    perm, count = compact_mask(mask)
    ri, si = (torch.from_numpy(pairs[:, c].copy()) for c in (0, 1))
    lanes = []
    for rows in (None, 7, 64):        # one chunk, then chunks of 7 and 64
        if rows:
            couples = int(R.nverts.max()) * int(S.nverts.max())
            monkeypatch.setattr(refine, "_FUSED_CHUNK_BYTES",
                                rows * couples * refine._BYTES_PER_COUPLE)
        lanes.append(refine.fused_refine_lanes(R, S, ri, si, perm, count,
                                               "cpu"))
    for res, unc in lanes[1:]:
        assert torch.equal(res, lanes[0][0]) and torch.equal(unc, lanes[0][1])
    res = lanes[0][0].numpy()
    k = int(count)
    assert not res[k:].any() and res[:k].any()
    live = pairs[perm[:k].numpy()]
    want = refine.refine_pairs(R, S, live, backend="numpy")
    np.testing.assert_array_equal(res[:k], want)
    g = refine.device_geometry(R, "cpu")
    assert refine.device_geometry(R, "cpu") is g
    assert g["verts"].shape[1] == int(R.nverts.max())


# ---------------------------------------------------------------------------
# the whole chain against the reference's staged plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mbr_backend", ["numpy", "torch"])
@pytest.mark.parametrize("order", [DEFAULT, ("AA", "AF")],
                         ids=["default", "degenerate"])
def test_fused_plan_matches_reference_staged(t1t2, order, mbr_backend):
    R0, S0, _, R, S = t1t2
    ref, rst = RJoinPlan(R0, S0, filter="april", n_order=8,
                         filter_opts={"order": order}).build().execute(
        "intersects")
    got, st = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                       pipeline_mode="fused", mbr_backend=mbr_backend,
                       filter_opts={"order": order}).build().execute(
        "intersects")
    assert len(ref) > 100
    np.testing.assert_array_equal(got, ref)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k
    assert st.pipeline_mode == "fused" and st.mbr_backend == mbr_backend
    assert st.extra["n_escalated"] >= 0
    staged, sst = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                           mbr_backend=mbr_backend,
                           filter_opts={"order": order}).build().execute(
        "intersects")
    np.testing.assert_array_equal(staged, ref)
    assert sst.t_sync == 0.0


def _one(square, name):
    return (PolygonDataset(name=name, verts=square[None],
                           nverts=np.asarray([4], np.int64)),
            state.dataset_from_arrays(name, square[None], [4]))


@pytest.mark.parametrize("mbr_backend", ["numpy", "torch"])
def test_fused_empty_and_one_pair_frames(mbr_backend):
    """An empty candidate frame and a one-live-pair frame go through the
    chain as through the reference's staged plan."""
    sq = np.array([[0.1, 0.1], [0.2, 0.1], [0.2, 0.2], [0.1, 0.2]])
    a0, a = _one(sq, "a")
    for other in (sq + 0.05, sq + 0.6):
        b0, b = _one(other, "b")
        ref, rst = RJoinPlan(a0, b0, filter="april", n_order=6).build() \
            .execute("intersects")
        got, st = JoinPlan(a, b, filter="april", n_order=6, device="cpu",
                           pipeline_mode="fused",
                           mbr_backend=mbr_backend).build().execute(
            "intersects")
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.int64 and got.shape[1:] == (2,)
        for k in COUNTS:
            assert getattr(st, k) == getattr(rst, k), k
    assert st.n_candidates == 0 and len(got) == 0


def _star(rng):
    """Random star polygon in [0.01, 0.99]^2 (the reference's draw)."""
    nv = int(rng.integers(4, 17))
    cx, cy = rng.uniform(0.2, 0.8, 2)
    r = rng.uniform(0.01, 0.2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv)) + np.linspace(0, 1e-4, nv)
    rad = r * (1 + 0.5 * rng.uniform(-1, 1, nv))
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return np.clip(pts, 0.01, 0.99)


@pytest.mark.parametrize("seed", range(10))
def test_fused_random_star_batches(seed):
    """The reference's seeded star batches, intersects with APRIL."""
    rng = np.random.default_rng(1000 + seed)
    pr = [_star(rng) for _ in range(int(rng.integers(1, 7)))]
    ps = [_star(rng) for _ in range(int(rng.integers(1, 7)))]
    (R0, R), (S0, S) = _ds(pr, "hr"), _ds(ps, "hs")
    ref, rst = RJoinPlan(R0, S0, filter="april", n_order=6).build() \
        .execute("intersects")
    got, st = JoinPlan(R, S, filter="april", n_order=6, device="cpu",
                       pipeline_mode="fused",
                       mbr_backend=("numpy", "torch")[seed % 2]).build() \
        .execute("intersects")
    np.testing.assert_array_equal(got, ref)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k


@pytest.mark.parametrize("mbr_backend", ["numpy", "torch"])
def test_record_chains_keeps_each_runs_inputs(t1t2, mbr_backend):
    """``record_chains`` keeps one CandidateSet per fused execution: its
    device frame is the host frame, uploaded once, its status lane is the
    plain trichotomy over that frame under the valid lane, and its
    INDECISIVE lane is the one the join counted."""
    _, _, _, R, S = t1t2
    plan = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                    pipeline_mode="fused", mbr_backend=mbr_backend).build()
    with fused.record_chains() as chains:
        _, st = plan.execute("intersects")
    plan.execute("intersects")
    (cs,) = chains
    assert torch.equal(cs.ri_dev, torch.from_numpy(cs.ri))
    assert torch.equal(cs.si_dev, torch.from_numpy(cs.si))
    assert (cs.valid is None) == (mbr_backend == "numpy")
    lists = [plan.filter._lists(a, k).to("cpu")
             for a in (plan.approx_r, plan.approx_s) for k in ("A", "F")]
    want = april_trichotomy_plain(*lists, cs.ri_dev, cs.si_dev)
    if cs.valid is not None:
        assert len(cs) > st.n_candidates
        want = torch.where(cs.valid, want, TRUE_NEG)
    assert torch.equal(cs.status, want)
    assert int((cs.status == INDECISIVE).sum()) == st.n_indecisive > 0


def test_pipeline_modes():
    assert PIPELINE_MODES == ("staged", "fused")
    fused.check_pipeline_mode("fused")
    with pytest.raises(ValueError, match="pipeline_mode"):
        fused.check_pipeline_mode("streamed")
    R = make_dataset("T9", seed=1, count=4)
    with pytest.raises(ValueError, match="pipeline_mode"):
        JoinPlan(R, R, device="cpu", pipeline_mode="streamed")


def test_to_host_gathers_every_lane():
    status = torch.tensor([0, 1, 2, 2], dtype=torch.int8)
    hit = torch.tensor([False, True, True, False])
    s, h = fused.to_host(status, hit)
    assert s.dtype == np.int8 and h.dtype == bool
    assert s.tolist() == [0, 1, 2, 2] and h.tolist() == [False, True, True,
                                                         False]


def test_stats_stage_times_roundtrip(t1t2):
    _, _, _, R, S = t1t2
    plan = JoinPlan(R, S, filter="april", n_order=6, device="cpu",
                    pipeline_mode="fused").build()
    _, stats = plan.execute("intersects")
    times = stats.stage_times()
    assert set(times) == {"t_mbr", "t_filter", "t_refine", "t_sync",
                          "t_partition", "t_total"}
    assert times["t_partition"] == 0.0
    assert times["t_total"] == pytest.approx(
        times["t_mbr"] + times["t_filter"] + times["t_refine"]
        + times["t_sync"])
    assert times["t_sync"] > 0.0
    d = stats.to_dict()
    back = JoinStats.from_dict(d)
    assert back.pipeline_mode == "fused"
    assert back.stage_times() == times
    assert d["t_sync"] == stats.t_sync
    h, g, i = stats.rates()
    assert h + g + i == pytest.approx(1.0)
    assert JoinStats(method="april").rates() == (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# the CUDA kernel, on the card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_compact_kernel_equals_plain_version(cuda_device):
    """The kernel (one cooperative launch a call) equals the plain version
    and the stable-argsort oracle on the reference's lanes, a lane longer
    than 2^21 and the tiling edges of ``compact.cases``, the lane longer
    than one sweep of the resident grid included."""
    rng = np.random.default_rng(11)
    lanes = _masks() + [rng.random((1 << 21) + 999) < 0.37] \
        + list(compact_cases.lanes(long=True).values())
    for mask in lanes:
        m = torch.from_numpy(mask).to(cuda_device)
        n0 = compact_mask.launches
        perm, count = compact_mask(m)
        assert compact_mask.launches == n0 + (1 if len(mask) else 0)
        want_perm, want_count = compact_mask_plain(m)
        oracle = torch.argsort((~m).to(torch.uint8), stable=True)
        assert torch.equal(perm, want_perm)
        assert torch.equal(perm.long(), oracle)
        assert int(count) == int(want_count) == int(mask.sum())
