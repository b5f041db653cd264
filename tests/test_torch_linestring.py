"""The port's ``linestring`` predicate (polygon x linestring joins, §4.3.3)
held to the JAX package exactly: the chains themselves, the open-chain
rasterization and every filter's line store, the per-pair and batched
linestring trichotomies and every filter's verdicts and fused lanes, the
refinement of every backend on boundary fixtures (a touch, a vertex on a
ring edge, a collinear overlap, a chain inside, a C-shaped chain whose
closing segment would cross, 2-vertex chains), the float64 chain core
against ``_line_impl_jnp``, and ``JoinPlan(r_kind="line")`` end to end
against the reference's staged numpy plan, staged and fused, pairs, order
and counts; plus a hypothesis property over stores with F inside A. Small
sizes, on the CPU (``device="cpu"``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import fivec_ch as rfivec  # noqa: E402
from repro.baselines import ra as rra  # noqa: E402
from repro.core import join as rjoin  # noqa: E402
from repro.core import rasterize as rrasterize  # noqa: E402
from repro.core import ri as rri  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import refine as rrefine  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.filters.april_filter import (  # noqa: E402
    build_line_cells as r_build_line_cells)

from repro_torch import JoinPlan, make_dataset, make_linestrings  # noqa: E402
from repro_torch import state  # noqa: E402
from repro_torch.baselines import fivec_ch, ra  # noqa: E402
from repro_torch.core import rasterize, ri  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.kernels.interval_join import (  # noqa: E402
    interval_overlap, interval_overlap_plain)
from repro_torch.spatial import fused, refine  # noqa: E402
from repro_torch.spatial.filters import get_filter  # noqa: E402
from repro_torch.spatial.filters.april_filter import (  # noqa: E402
    LineCellStore, build_line_cells)

FILTERS = ("april", "april-c", "ri", "ra", "5cch", "none")
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
N_ORDER = 8
#: RA grids capped small, so that the stores build fast
BUILD_OPTS = {"ra": {"max_cells": 256}}


@pytest.fixture(scope="module")
def lz():
    """Chains (T8) x zip codes (T10), 160 x 40, and short chains: mostly 2
    and 3 vertices, long steps that the clamp at the map's border cuts
    (repeated vertices), against the same zip codes. The reference's
    datasets and the port's."""
    out = {}
    for key, kw in (("t8", {"seed": 73, "count": 160}),
                    ("short", {"seed": 5, "count": 120, "avg_vertices": 2,
                               "step": 0.2})):
        out[key] = (r_make_linestrings("T8", **kw),
                    make_linestrings("T8", **kw))
    out["t10"] = (r_make_dataset("T10", seed=2, count=40),
                  make_dataset("T10", seed=2, count=40))
    return out


@pytest.fixture(scope="module")
def plans(lz):
    """Each filter's reference and port line plans at N_ORDER, built once."""
    (L0, L), (S0, S) = lz["t8"], lz["t10"]
    out = {}
    for name in FILTERS:
        bo = BUILD_OPTS.get(name, {})
        out[name] = (RJoinPlan(L0, S0, filter=name, n_order=N_ORDER,
                               r_kind="line", build_opts=bo).build(),
                     JoinPlan(L, S, filter=name, n_order=N_ORDER,
                              r_kind="line", device="cpu",
                              build_opts=bo).build())
    return out


# ---------------------------------------------------------------------------
# the chains and the line stores
# ---------------------------------------------------------------------------

def _same_arrays(got, want, keys):
    for k in keys:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("key", ["t8", "short"])
def test_chains_and_line_stores_match_reference(lz, key):
    """make_linestrings, the open-chain traversal and every filter's line
    store equal the reference's numpy builds, array for array."""
    L0, L = lz[key]
    _same_arrays(L, L0, ("verts", "nverts", "mbrs"))
    if key == "short":
        assert (L.nverts == 2).sum() > 10
        # clamped steps repeat a vertex: zero-length edges
        e = np.diff(L.verts, axis=1)
        assert ((np.abs(e).sum(axis=2) == 0)
                & (np.arange(L.verts.shape[1] - 1) < L.nverts[:, None] - 1)
                ).any()
    for n in (6, N_ORDER):
        want = rrasterize.dda_partial_cells_multi(L0.verts, L0.nverts, n,
                                                  closed=False)
        got = rasterize.dda_partial_cells_multi(L.verts, L.nverts, n,
                                                closed=False)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        _same_arrays(build_line_cells(L, n), r_build_line_cells(L0, n),
                     ("off", "ids"))
    for enc in ("R", "S"):
        _same_arrays(ri.build_ri_lines(L, N_ORDER, encoding=enc),
                     rri.build_ri_lines(L0, N_ORDER, encoding=enc),
                     ("off", "ints", "bit_off", "bits"))
    got, want = ra.build_ra_lines(L, max_cells=256), \
        rra.build_ra_lines(L0, max_cells=256)
    _same_arrays(got, want, ("k", "origin", "shape"))
    assert len(got.cells) == len(want.cells)
    for a, b in zip(got.cells, want.cells):
        np.testing.assert_array_equal(a, b)
    _same_arrays(fivec_ch.build_5cch_lines(L), rfivec.build_5cch_lines(L0),
                 ("pent", "hull_off", "hull_pts"))
    # APRIL-C keeps the line side uncompressed
    a = get_filter("april-c").build(L, n_order=N_ORDER, kind="line")
    b = r_get_filter("april-c").build(L0, n_order=N_ORDER, kind="line")
    assert isinstance(a.store, LineCellStore) and a.kind == "line"
    _same_arrays(a.store, b.store, ("off", "ids"))
    assert a.size_bytes() == b.size_bytes()


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------

def test_trichotomy_rows_match_reference(plans):
    """The staged linestring trichotomy of every backend, the fused lane
    and the per-pair verdict equal the reference's numpy driver; a
    recorded run's joins replay to the same verdicts."""
    rplan, tplan = plans["april"]
    pairs = rplan.candidates("linestring")
    f = tplan.filter
    C, Ya, Yf = (f._lists(tplan.approx_r, "line"),
                 f._lists(tplan.approx_s, "A"), f._lists(tplan.approx_s, "F"))
    rf = rplan.filter
    want = rjoin.linestring_trichotomy_rows(
        rf._lists(rplan.approx_r, "line"), rf._lists(rplan.approx_s, "A"),
        rf._lists(rplan.approx_s, "F"), pairs[:, 0], pairs[:, 1],
        backend="numpy")
    assert {0, 1, 2} <= set(want.tolist())
    for backend in ("numpy", "torch", "sequential"):
        got = tjoin.linestring_trichotomy_rows(C, Ya, Yf, pairs[:, 0],
                                               pairs[:, 1], backend=backend,
                                               device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
    with tjoin.record_joins() as joins:
        lane = tjoin.fused_status_rows(C, None, Ya, Yf, pairs[:, 0],
                                       pairs[:, 1], predicate="linestring",
                                       backend="torch", device="cpu")
    np.testing.assert_array_equal(lane.numpy(), want)
    # two overlap calls over every frame row, replayed through the wrapper
    assert [name for name, _ in joins] == ["interval_overlap"] * 2
    aa, fhit = (interval_overlap(*args) for _, args in joins)
    for _, args in joins:
        assert torch.equal(interval_overlap(*args),
                           interval_overlap_plain(*args))
    replay = torch.where(aa, torch.where(fhit, 1, 2), 0).to(torch.int8)
    assert torch.equal(replay, lane)
    sr, ss = tplan.approx_r.store, tplan.approx_s.store
    per_pair = [tjoin.linestring_verdict_pair(ss.a_list(j), ss.f_list(j),
                                              sr.cell_ids(i))
                for i, j in pairs]
    assert per_pair == [rjoin.linestring_verdict_pair(
        rplan.approx_s.store.a_list(j), rplan.approx_s.store.f_list(j),
        rplan.approx_r.store.cell_ids(i)) for i, j in pairs]
    np.testing.assert_array_equal(per_pair, want)


@pytest.mark.parametrize("name", FILTERS)
def test_filter_verdicts_and_lanes_match_reference(plans, lz, name):
    """Every filter's batched verdicts (numpy, torch, sequential) and its
    fused status lane equal the reference's numpy verdicts, on the T8
    chains and on the short chains."""
    rplan, tplan = plans[name]
    bo = BUILD_OPTS.get(name, {})
    cases = [(rplan.approx_r, tplan.approx_r, rplan)]
    (L0, L), (S0, S) = lz["short"], lz["t10"]
    rshort = RJoinPlan(L0, S0, filter=name, n_order=N_ORDER, r_kind="line",
                       build_opts=bo).build(prebuilt=(None, rplan.approx_s))
    tshort = JoinPlan(L, S, filter=name, n_order=N_ORDER, r_kind="line",
                      device="cpu", build_opts=bo).build(
        prebuilt=(None, tplan.approx_s))
    cases.append((rshort.approx_r, tshort.approx_r, rshort))
    rf, tf = rplan.filter, tplan.filter
    for ra_, ta, rp in cases:
        pairs = rp.candidates("linestring")
        assert len(pairs) > 0
        want = rf.verdicts(ra_, rplan.approx_s, pairs, predicate="linestring",
                           backend="numpy")
        np.testing.assert_array_equal(
            want, rf.verdicts_seq(ra_, rplan.approx_s, pairs,
                                  predicate="linestring"))
        for backend in ("numpy", "torch", "sequential"):
            got = tf.verdicts(ta, tplan.approx_s, pairs,
                              predicate="linestring", backend=backend,
                              device="cpu")
            np.testing.assert_array_equal(got, want, err_msg=backend)
        lane = tf.status_lane(ta, tplan.approx_s, pairs[:, 0], pairs[:, 1],
                              predicate="linestring", backend="torch",
                              device="cpu")
        np.testing.assert_array_equal(lane.numpy(), want)


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

#: the boundary fixtures, drawn on a 0-10 grid and mapped into the unit
#: square by (v + 2) / 16, which is exact in binary
_SQ = np.array([[0., 0.], [10., 0.], [10., 10.], [0., 10.]])
#: a rectangle that the C-shaped chain's closing segment would cross
_RECT = np.array([[6., 4.], [8., 4.], [8., 6.], [6., 6.]])
_CHAINS = [
    np.array([[10., 5.], [12., 5.]]),                  # touches an edge
    np.array([[11., 3.], [10., 5.], [11., 7.]]),       # vertex on an edge
    np.array([[12., 5.], [10., 5.], [8., 5.]]),        # vertex on, then in
    np.array([[10., -2.], [10., 3.]]),                 # collinear overlap
    np.array([[12., 10.], [10., 10.], [10., 12.]]),    # vertex on a corner
    np.array([[2., 2.], [5., 5.], [8., 3.]]),          # wholly inside
    np.array([[7., 2.], [3., 2.], [3., 8.], [7., 8.]]),   # C around _RECT
    np.array([[1., 1.], [9., 9.]]),                    # 2 vertices across
    np.array([[-1., 5.], [-.5, 5.]]),                  # 2 vertices, apart
    np.array([[5., 11.], [5., 11.], [5., 10.]]),       # repeated vertex
]


def _ds(verts_list, name):
    """A reference dataset and the port's copy of it over the given
    vertex lists."""
    V = max(len(v) for v in verts_list)
    verts = np.zeros((len(verts_list), V, 2))
    nv = np.zeros(len(verts_list), np.int64)
    for i, v in enumerate(verts_list):
        verts[i, : len(v)] = v
        nv[i] = len(v)
    return (PolygonDataset(name=name, verts=verts, nverts=nv),
            state.dataset_from_arrays(name, verts, nv))


def _fixture(name, lz):
    """(L0, S0, L, S, pairs): reference chains and polygons, the port's
    copies and the rows to refine."""
    if name == "t8":
        (L0, L), (S0, S) = lz["t8"], lz["t10"]
    elif name == "short":
        (L0, L), (S0, S) = lz["short"], lz["t10"]
    else:
        (L0, L), (S0, S) = (_ds([(v + 2) / 16 for v in vs], n) for vs, n in
                            ((_CHAINS, "l"), ([_SQ, _RECT], "s")))
        pairs = np.stack(np.meshgrid(np.arange(len(_CHAINS)), np.arange(2),
                                     indexing="ij"), axis=-1).reshape(-1, 2)
        return L0, S0, L, S, pairs
    return (L0, S0, L, S,
            RJoinPlan(L0, S0, filter="none").candidates("linestring"))


FIXTURES = ["boundary", "t8", "short"]


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("backend", ["numpy", "torch", "sequential",
                                     "device64"])
def test_refine_matches_reference(lz, name, backend):
    """``refine(..., "linestring")`` on every backend equals the
    reference's numpy and sequential refines."""
    L0, S0, L, S, pairs = _fixture(name, lz)
    want = rrefine.refine(L0, S0, pairs, predicate="linestring",
                          backend="numpy")
    np.testing.assert_array_equal(
        want, rrefine.refine_line_poly_pairs_seq(L0, S0, pairs))
    with refine.record_sweeps() as sweeps:
        got = refine.refine(L, S, pairs, predicate="linestring",
                            backend=backend, device="cpu")
    np.testing.assert_array_equal(got, want)
    if backend == "torch":
        # one sweep over every chain edge, no closing edge, unpruned
        (sw,) = sweeps
        assert sw[0].shape[0] == int((L.nverts[pairs[:, 0]] - 1).sum())
        assert sw[3].shape[0] == int(S.nverts[pairs[:, 1]].sum())
    if name == "boundary":
        got = want.reshape(len(_CHAINS), 2)
        # every contact with the square counts; the C misses the rectangle
        np.testing.assert_array_equal(
            got[:, 0], [True] * 8 + [False, True])
        assert not got[6, 1] and got[7, 1]


@pytest.mark.parametrize("name", FILTERS)
def test_boundary_fixture_joins(lz, name):
    """Every filter's join of the boundary fixtures, staged and fused,
    equals the reference's staged numpy plan; the C-shaped chain's closing
    segment crosses the rectangle, so as a ring it intersects it, and as
    a chain it does not."""
    L0, S0, L, S, _ = _fixture("boundary", lz)
    want, wst = RJoinPlan(L0, S0, filter=name, n_order=6, r_kind="line",
                          build_opts=BUILD_OPTS.get(name, {})).build(
        ).execute("linestring")
    for kw in ({}, {"pipeline_mode": "fused"}):
        got, st = JoinPlan(L, S, filter=name, n_order=6, r_kind="line",
                           device="cpu", build_opts=BUILD_OPTS.get(name, {}),
                           **kw).build().execute("linestring")
        _same(got, st, want, wst)
    pairs = set(map(tuple, want.tolist()))
    assert (7, 1) in pairs and (6, 1) not in pairs and (6, 0) in pairs
    assert rrefine.refine(L0, S0, np.array([[6, 1]]), predicate="intersects",
                          backend="numpy")[0]


@pytest.mark.parametrize("name", FIXTURES)
def test_line_core_matches_reference(lz, name):
    """The float64 chain core equals ``_line_impl_jnp``, verdicts and
    uncertain flags, and equals the numpy refine after the host re-check
    of its uncertain rows."""
    L0, S0, L, S, pairs = _fixture(name, lz)
    li, si = pairs[:, 0], pairs[:, 1]
    args = (L.verts[li], L.nverts[li], S.verts[si], S.nverts[si])
    with jax.enable_x64(True):
        wv, wu = (np.asarray(x) for x in jax.jit(rrefine._line_impl_jnp)(
            *(jnp.asarray(a) for a in args)))
    gv, gu = (x.numpy() for x in refine._line_impl(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gv, wv)
    want = rrefine.refine(L0, S0, pairs, predicate="linestring",
                          backend="numpy")
    got = gv.copy()
    if gu.any():
        got[gu] = refine.refine(L, S, pairs[gu], predicate="linestring",
                                backend="numpy")
    np.testing.assert_array_equal(got, want)


def test_device_geometry_of_chains_has_no_reps(lz):
    _, L = lz["t8"]
    geom = refine.device_geometry(L, "cpu", kind="line")
    assert "reps" not in geom
    assert "reps" in refine.device_geometry(L, "cpu")
    assert refine.device_geometry(L, "cpu", kind="line") is geom


# ---------------------------------------------------------------------------
# JoinPlan end to end
# ---------------------------------------------------------------------------

def _same(got, st, want, wst):
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for k in COUNTS:
        assert getattr(st, k) == getattr(wst, k), k


@pytest.mark.parametrize("name", FILTERS)
def test_plan_matches_reference(plans, name):
    """Staged (every backend pairing) and fused (both MBR lanes) equal the
    reference's staged numpy plan, pairs, order and counts."""
    rplan, tplan = plans[name]
    want, wst = rplan.execute("linestring")
    assert len(want) > 0
    pre = (tplan.approx_r, tplan.approx_s)
    runs = [{"filter_backend": fb, "refine_backend": rb} for fb, rb in (
        ("torch", "torch"), ("numpy", "numpy"), ("torch", "device64"),
        ("sequential", "sequential"))]
    runs += [{"pipeline_mode": "fused"},
             {"pipeline_mode": "fused", "mbr_backend": "torch"}]
    for kw in runs:
        with fused.record_chains() as chains:
            got, st = JoinPlan(tplan.R, tplan.S, filter=name, n_order=N_ORDER,
                               r_kind="line", device="cpu", **kw).build(
                prebuilt=pre).execute("linestring")
        _same(got, st, want, wst)
        assert st.predicate == "linestring"
        assert len(chains) == (kw.get("pipeline_mode") == "fused")


def test_plan_errors(lz):
    """The reference's two errors: ``linestring`` without the chains as
    R, and another predicate on a line plan; chains are never S."""
    (_, L), (_, S) = lz["t8"], lz["t10"]
    with pytest.raises(ValueError, match="r_kind='line'"):
        JoinPlan(S, S, n_order=6, device="cpu").execute("linestring")
    plan = JoinPlan(L, S, n_order=6, device="cpu", r_kind="line")
    for predicate in ("intersects", "within", "selection"):
        with pytest.raises(ValueError, match="polygon approximations"):
            plan.execute(predicate)
    with pytest.raises(ValueError, match="s_kind"):
        JoinPlan(S, L, device="cpu", s_kind="line")
    with pytest.raises(ValueError, match="unknown kind"):
        get_filter("april").build(L, n_order=6, kind="curve")


# ---------------------------------------------------------------------------
# property: stores with F inside A
# ---------------------------------------------------------------------------

@st.composite
def a_and_f_lists(draw, max_id=2**12, max_len=10):
    """Half-open uint64 A intervals and F intervals cut from inside them."""
    pts = sorted(draw(st.lists(st.integers(0, max_id), max_size=2 * max_len,
                               unique=True)))
    pts = pts[: len(pts) // 2 * 2]
    a = np.asarray(pts, np.uint64).reshape(-1, 2)
    f = []
    for s, e in a.tolist():
        if e - s >= 1 and draw(st.booleans()):
            lo = draw(st.integers(s, e - 1))
            f.append((lo, draw(st.integers(lo + 1, e))))
    return a, np.asarray(f, np.uint64).reshape(-1, 2)


@st.composite
def april_stores(draw, rows):
    lists = [draw(a_and_f_lists()) for _ in range(rows)]
    off = lambda k: np.r_[0, np.cumsum([len(x[k]) for x in lists])]
    cat = lambda k: np.concatenate([x[k] for x in lists]).reshape(-1, 2)
    return state.april_store_from_arrays(6, (0.0, 0.0, 1.0), off(0), cat(0),
                                         off(1), cat(1))


@given(st.lists(st.lists(st.integers(0, 2**12), max_size=10, unique=True),
                min_size=1, max_size=3), april_stores(2))
@settings(max_examples=40, deadline=None)
def test_linestring_property_f_inside_a(cells, ss):
    """With F inside A every backend, and the fused lane, equal the
    reference's per-pair linestring verdict, empty cell sets included."""
    ids = [np.asarray(sorted(c), np.uint64) for c in cells]
    off = np.r_[0, np.cumsum([len(i) for i in ids])].astype(np.int64)
    flat = np.concatenate(ids)
    li, si = (g.ravel() for g in np.meshgrid(np.arange(len(ids)),
                                             np.arange(len(ss)),
                                             indexing="ij"))
    want = np.asarray([rjoin.linestring_verdict_pair(
        ss.a_list(j), ss.f_list(j), ids[i]) for i, j in zip(li, si)],
        np.int8)
    lists = (tjoin.IntervalLists.from_unit_cells(off, flat),
             tjoin.IntervalLists.from_intervals(ss.a_off, ss.a_ints),
             tjoin.IntervalLists.from_intervals(ss.f_off, ss.f_ints))
    for backend in ("numpy", "torch", "sequential"):
        got = tjoin.linestring_trichotomy_rows(*lists, li, si,
                                               backend=backend, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
    lane = tjoin.fused_status_rows(lists[0], None, *lists[1:], li, si,
                                   predicate="linestring", backend="torch",
                                   device="cpu")
    np.testing.assert_array_equal(lane.numpy(), want)
