"""The port's ``within`` and ``selection`` joins and its staged float64
device refine (``refine_backend="device64"``) held to the JAX package
exactly: the within oracle and the per-pair joins, the containment join on
the host and on the device, the staged within trichotomy of every filter,
the float64 within core against ``_within_impl_jnp`` (verdicts equal on
every row neither side flags uncertain, and equal to the numpy refine after
the host re-check), the batched within refine of every backend, and
``JoinPlan`` end to end against the reference's staged numpy plan, staged
and fused, pairs, order and counts; plus a hypothesis property over stores
with F inside A. Small sizes, on the CPU (``device="cpu"``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import ra as rra  # noqa: E402
from repro.core import geometry as rgeometry  # noqa: E402
from repro.core import join as rjoin  # noqa: E402
from repro.core import ri as rri  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import refine as rrefine  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402

from repro_torch import JoinPlan, make_dataset, state  # noqa: E402
from repro_torch.baselines import ra  # noqa: E402
from repro_torch.core import geometry, ri  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.datagen.fixtures import (  # noqa: E402
    CSHAPE, CSHAPE_INNER, SNAPPED_HOST, SNAPPED_TRI)
from repro_torch.spatial import refine  # noqa: E402
from repro_torch.spatial.filters import get_filter  # noqa: E402

FILTERS = ("april", "april-c", "ri", "ra", "5cch", "none")
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
#: RA grids capped small, so that the stores build fast
BUILD_OPTS = {"ra": {"max_cells": 256}}


@pytest.fixture(scope="module")
def wz():
    """Water bodies (T2) x zip codes (T10), 160 x 24: the reference's
    datasets and the port's."""
    return (r_make_dataset("T2", seed=1, count=160),
            r_make_dataset("T10", seed=2, count=24),
            make_dataset("T2", seed=1, count=160),
            make_dataset("T10", seed=2, count=24))


@pytest.fixture(scope="module")
def plans(wz):
    """Each filter's reference and port plans at n_order 8, built once."""
    R0, S0, R, S = wz
    out = {}
    for name in FILTERS:
        bo = BUILD_OPTS.get(name, {})
        out[name] = (RJoinPlan(R0, S0, filter=name, n_order=8,
                               build_opts=bo).build(),
                     JoinPlan(R, S, filter=name, n_order=8, device="cpu",
                              build_opts=bo).build())
    return out


@pytest.fixture(scope="module")
def within_pairs(plans):
    return plans["april"][0].candidates("within")


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


# ---------------------------------------------------------------------------
# the oracle and the per-pair and batched containment joins
# ---------------------------------------------------------------------------

def test_polygon_within_matches_reference(wz, within_pairs):
    R0, S0, _, _ = wz
    rings = [(R0.verts[i], R0.nverts[i], S0.verts[j], S0.nverts[j])
             for i, j in within_pairs]
    sq = np.array([[0., 0.], [10., 0.], [10., 10.], [0., 10.]])
    top = np.array([[6., 10.], [7., 8.5], [5., 8.5]])
    rings += [(CSHAPE_INNER, 3, CSHAPE, 8),
              (CSHAPE_INNER + np.array([0.0, 2.5]), 3, CSHAPE, 8),
              (top, 3, sq, 4), (sq, 4, top, 3), (SNAPPED_TRI, 3,
                                                 SNAPPED_HOST, 8)]
    got = [geometry.polygon_within(*r) for r in rings]
    assert got == [rgeometry.polygon_within(*r) for r in rings]
    assert got[-5:-1] == [True, False, True, False] and 0 < sum(got[:-5])


def _containment_lists(seed, rows):
    """Paired X and F lists of ``rows`` rows, as the reference's
    IntervalLists and the port's: F random (a fifth of its rows empty), X
    cut from F's intervals (a third of the rows), or cut and then widened
    or shifted past them, or random (a fifth of its rows empty)."""
    rng = np.random.default_rng(seed)
    X, F = [], []
    for r in range(rows):
        n = 0 if rng.random() < 0.2 else int(rng.integers(1, 9))
        pts = np.sort(rng.choice(4000, 2 * n, replace=False)).reshape(-1, 2)
        f = pts + np.array([0, 1])
        kind = rng.integers(0, 4)
        if kind < 3 and n:
            x = []
            for s, e in f[rng.random(n) < 0.7]:
                lo = int(rng.integers(s, e))
                x.append((lo, int(rng.integers(lo + 1, e + 1))))
            x = np.asarray(x, np.int64).reshape(-1, 2)
            if kind == 1 and len(x):
                x[-1, 1] += int(rng.integers(1, 3))     # past its F end
            if kind == 2 and len(x):
                x[0] -= int(rng.integers(1, 3))         # before its F start
                x[0] = np.maximum(x[0], 0)
        else:
            m = 0 if rng.random() < 0.2 else int(rng.integers(1, 6))
            x = np.sort(rng.choice(4000, 2 * m,
                                   replace=False)).reshape(-1, 2) + [0, 1]
        X.append(np.asarray(x, np.uint64).reshape(-1, 2))
        F.append(np.asarray(f, np.uint64).reshape(-1, 2))
    out = []
    for lists in (X, F):
        off = np.r_[0, np.cumsum([len(x) for x in lists])]
        ints = np.concatenate(lists).reshape(-1, 2)
        out.append((rjoin.IntervalLists.from_intervals(off, ints),
                    tjoin.IntervalLists.from_intervals(off, ints), lists))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_containment_matches_reference(seed):
    """The per-pair joins and verdict, the host containment rows and the
    device containment rows equal the reference's, on rows with empty X
    and empty F lists, paired as drawn and shuffled."""
    rows = 96
    (rX, tX, X), (rF, tF, F) = _containment_lists(seed, rows)
    own = np.arange(rows)
    shuffled = np.random.default_rng(seed).permutation(rows)
    for xi, fi in ((own, own), (own, shuffled)):
        want = rjoin.contain_rows_np(rX, xi, rF, fi)
        np.testing.assert_array_equal(
            tjoin.contain_rows_np(tX, xi, tF, fi), want)
        np.testing.assert_array_equal(
            tjoin.contain_rows(tX, xi, tF, fi, device="cpu").numpy(), want)
        rows_t = (torch.from_numpy(xi), torch.from_numpy(fi))
        np.testing.assert_array_equal(
            tjoin.contain_rows(tX, xi, tF, fi, device="cpu",
                               rows=rows_t).numpy(), want)
        pair = [rjoin.containment_join_pair(X[i], F[j])
                for i, j in zip(xi, fi)]
        assert [tjoin.containment_join_pair(X[i], F[j])
                for i, j in zip(xi, fi)] == pair
        # the batched rows test nonempty lists only
        live = [len(X[i]) > 0 and len(F[j]) > 0 for i, j in zip(xi, fi)]
        np.testing.assert_array_equal(want, np.logical_and(pair, live))
        verdicts = [rjoin.within_verdict_pair(X[i], None, F[j], F[j])
                    for i, j in zip(xi, fi)]
        assert [tjoin.within_verdict_pair(X[i], None, F[j], F[j])
                for i, j in zip(xi, fi)] == verdicts
    assert want.any() and not want.all()
    assert {0, 1, 2} <= set(verdicts)
    # an empty store on either side
    empty = tjoin.IntervalLists.from_intervals(np.zeros(rows + 1, np.int64),
                                               np.zeros((0, 2), np.uint64))
    for a, b in ((tX, empty), (empty, tF)):
        assert not tjoin.contain_rows(a, own, b, own, device="cpu").any()
        assert not tjoin.contain_rows_np(a, own, b, own).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_rows_match_reference(seed):
    """The host overlap rows equal the reference's with either side the
    smaller one (the port expands the side with fewer intervals), paired
    as drawn and shuffled, and with an empty store on either side."""
    rows = 96
    (rX, tX, _), (rF, tF, _) = _containment_lists(seed, rows)
    own = np.arange(rows)
    shuffled = np.random.default_rng(seed).permutation(rows)
    seen = []
    for xi, yi in ((own, own), (own, shuffled), (own[:7], shuffled[:7])):
        for (ra_, ta), (rb, tb) in (((rX, tX), (rF, tF)),
                                    ((rF, tF), (rX, tX))):
            want = rjoin.overlap_rows_np(ra_, xi, rb, yi)
            np.testing.assert_array_equal(
                tjoin.overlap_rows_np(ta, xi, tb, yi), want)
            seen.append(want)
    assert np.concatenate(seen).any() and not np.concatenate(seen).all()
    empty = tjoin.IntervalLists.from_intervals(np.zeros(rows + 1, np.int64),
                                               np.zeros((0, 2), np.uint64))
    for a, b in ((tX, empty), (empty, tF)):
        assert not tjoin.overlap_rows_np(a, own, b, own).any()


@pytest.mark.parametrize("pipeline_mode", ["staged", "fused"])
@pytest.mark.parametrize("predicate", ["within", "selection"])
def test_record_joins_replays_the_run(wz, plans, predicate, pipeline_mode):
    """``record_joins`` notes every interval-join call of a run, and the
    plain versions replayed on what it noted give the run's own verdicts:
    the fused chain's status lane under its valid lane."""
    from repro_torch.kernels.interval_join import (april_trichotomy_plain,
                                                   interval_overlap_plain)
    from repro_torch.spatial import fused
    _, _, R, S = wz
    _, tplan = plans["april"]
    plan = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                    filter_backend="torch", pipeline_mode=pipeline_mode
                    ).build(prebuilt=(tplan.approx_r, tplan.approx_s))
    with tjoin.record_joins() as joins, fused.record_chains() as chains:
        plan.execute(predicate)
    plain = {"april_trichotomy": april_trichotomy_plain,
             "interval_overlap": interval_overlap_plain}
    assert joins
    outs = [plain[name](*args) for name, args in joins]
    if pipeline_mode == "fused":
        (cs,) = chains
        ((name, args),) = joins
        assert args[-2] is cs.ri_dev and args[-1] is cs.si_dev
        if predicate == "selection":
            lane = torch.where(cs.valid, outs[0], tjoin.TRUE_NEG) \
                if cs.valid is not None else outs[0]
            assert torch.equal(cs.status, lane)
        else:   # the lane is INDECISIVE or TRUE_HIT where AA overlaps
            aa = outs[0] if cs.valid is None else outs[0] & cs.valid
            assert torch.equal(cs.status != tjoin.TRUE_NEG, aa)
    else:
        assert not chains
        names = [name for name, _ in joins]
        assert names == (["interval_overlap"] if predicate == "within"
                         else ["interval_overlap"] * 3)


# ---------------------------------------------------------------------------
# the staged within trichotomy and every filter's within verdicts
# ---------------------------------------------------------------------------

def _lists(plan):
    """A(r), A(s) and F(s) of an APRIL plan's stores."""
    return [plan.filter._lists(a, k) for a, k in
            ((plan.approx_r, "A"), (plan.approx_s, "A"),
             (plan.approx_s, "F"))]


@pytest.mark.parametrize("backend", ["numpy", "torch", "sequential"])
def test_within_trichotomy_matches_reference(plans, within_pairs, backend):
    rplan, tplan = plans["april"]
    ri_, si_ = within_pairs[:, 0], within_pairs[:, 1]
    want = rjoin.within_trichotomy_rows(*_lists(rplan), ri_, si_,
                                        backend="numpy")
    got = tjoin.within_trichotomy_rows(*_lists(tplan), ri_, si_,
                                       backend=backend, device="cpu")
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert {0, 1, 2} <= set(want.tolist())
    # the fused lane over the same frame
    lane = tjoin.fused_status_rows(_lists(tplan)[0], None,
                                   *_lists(tplan)[1:], ri_, si_,
                                   predicate="within", backend="torch",
                                   device="cpu")
    np.testing.assert_array_equal(lane.numpy(), want)
    assert len(tjoin.within_trichotomy_rows(
        *_lists(tplan), ri_[:0], si_[:0], backend=backend,
        device="cpu")) == 0


@pytest.mark.parametrize("name", FILTERS)
@pytest.mark.parametrize("predicate", ["within", "selection"])
def test_filter_verdicts_match_reference(plans, name, predicate):
    """Every filter's batched verdicts on every backend, and its per-pair
    verdicts, equal the reference filter's batched and per-pair ones."""
    rplan, tplan = plans[name]
    pairs = rplan.candidates(predicate)
    rf = r_get_filter(name)
    want = rf.verdicts(rplan.approx_r, rplan.approx_s, pairs,
                       predicate=predicate, backend="numpy")
    np.testing.assert_array_equal(
        rf.verdicts_seq(rplan.approx_r, rplan.approx_s, pairs,
                        predicate=predicate), want)
    for backend in ("numpy", "torch", "sequential"):
        got = tplan.filter.verdicts(tplan.approx_r, tplan.approx_s, pairs,
                                    predicate=predicate, backend=backend,
                                    device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
        lane = tplan.filter.status_lane(
            tplan.approx_r, tplan.approx_s, pairs[:, 0], pairs[:, 1],
            predicate=predicate, backend=backend, device="cpu")
        np.testing.assert_array_equal(lane.numpy(), want, err_msg=backend)


def test_ri_and_ra_within_batches_match_reference(plans, within_pairs):
    """The RI and RA within batches, and their per-pair forms, equal the
    reference's functions."""
    for name, batch, rbatch, pair, rpair in (
            ("ri", ri.ri_within_batch, rri.ri_within_batch,
             ri.ri_within_verdict_pair, rri.ri_within_verdict_pair),
            ("ra", ra.ra_within_batch, rra.ra_within_batch,
             ra.ra_within_verdict_pair, rra.ra_within_verdict_pair)):
        rplan, tplan = plans[name]
        want = rbatch(rplan.approx_r.store, rplan.approx_s.store,
                      within_pairs)
        np.testing.assert_array_equal(
            batch(tplan.approx_r.store, tplan.approx_s.store, within_pairs),
            want, err_msg=name)
        got = [pair(tplan.approx_r.store, i, tplan.approx_s.store, j)
               for i, j in within_pairs[:40]]
        assert got == [rpair(rplan.approx_r.store, i, rplan.approx_s.store,
                             j) for i, j in within_pairs[:40]], name
        assert got == want[:40].tolist()
        assert len(batch(tplan.approx_r.store, tplan.approx_s.store,
                         within_pairs[:0])) == 0


def test_ri_within_of_an_empty_object():
    """An RI object without intervals (outside the extent) is within
    anything (TRUE_HIT), in the batch and per pair, as in the reference."""
    R0, R = _ds([np.array([[2.0, 2.0], [2.1, 2.0], [2.0, 2.1]])])
    S0, S = _ds([np.array([[0.1, 0.1], [0.3, 0.1], [0.3, 0.3]])])
    rs = [r_get_filter("ri").build(D, n_order=4, side=s)
          for D, s in ((R0, "r"), (S0, "s"))]
    ts = [get_filter("ri").build(D, n_order=4, side=s)
          for D, s in ((R, "r"), (S, "s"))]
    pairs = np.zeros((1, 2), np.int64)
    assert len(rs[0].store.ints) == 0
    want = rri.ri_within_batch(rs[0].store, rs[1].store, pairs)
    assert want[0] == tjoin.TRUE_HIT
    np.testing.assert_array_equal(
        ri.ri_within_batch(ts[0].store, ts[1].store, pairs), want)
    assert ri.ri_within_verdict_pair(ts[0].store, 0, ts[1].store, 0) \
        == rri.ri_within_verdict_pair(rs[0].store, 0, rs[1].store, 0)


# ---------------------------------------------------------------------------
# the float64 within core and the batched within refine
# ---------------------------------------------------------------------------

_SQ = np.array([[0., 0.], [4., 0.], [4., 4.], [0., 4.]])
#: the fuzz-found snapped-vertex pair whose compiled within verdict sits
#: inside the FMA guard band (``tests/test_refine_batched.py``)
_FMA_A = np.array([
    [0.46821126201099456, 0.33001897689418036],
    [0.4595537937791133, 0.3350787644582686],
    [0.4592356227004228, 0.3329649341949457],
    [0.4596606610281497, 0.33099007529253766],
    [0.45616671890794774, 0.33252371036844647],
    [0.45623553878792783, 0.33048644467627664],
    [0.45969407452675615, 0.32471573049690555],
    [0.4609399563810834, 0.3250079025220754],
    [0.4717620978321982, 0.3274392233419345],
    [0.4626992907961244, 0.324031668283713],
    [0.46705223951997354, 0.32491571012657894],
    [0.46662147259952713, 0.3273967831499829]])
_FMA_B = np.array([
    [0.4752340142333326, 0.3327771686923501],
    [0.47062455687358307, 0.33128636458924227],
    [0.468976987931185, 0.3401287235421079],
    [0.4621100503439218, 0.33613973562982113],
    [0.458980197448991, 0.3379977083450747],
    [0.45152906086282973, 0.33208269891216996],
    [0.4627947747182639, 0.3206307916141646],
    [0.4686857145345563, 0.32272521209315136],
    [0.46794202990619516, 0.325202662712839],
    [0.46984918890693217, 0.32449819535518454]])


def _fixture(name, wz=None):
    """(R0, S0, R, S, pairs): reference datasets, the port's copies and the
    rows to refine."""
    if name == "t2t10":
        R0, S0, R, S = wz
        pairs = RJoinPlan(R0, S0, filter="none").candidates("within")
        return R0, S0, R, S, pairs
    if name == "touchy":
        rings = [_SQ + np.array([4.0, 0.0]), _SQ + np.array([4.0, 4.0]),
                 np.array([[2., 4.], [3., 3.], [1., 3.]]),
                 np.array([[1., 1.], [3., 1.], [2., 3.]]), _SQ,
                 _SQ + np.array([10., 10.]),
                 np.array([[-1., -1.], [5., -1.], [5., 5.], [-1., 5.]])]
        (R0, R), (S0, S) = _ds(rings, "r"), _ds([_SQ] * len(rings), "s")
        return R0, S0, R, S, np.stack([np.arange(len(rings))] * 2, axis=1)
    a, b = {"cshape": (CSHAPE_INNER, CSHAPE),
            "snapped": (SNAPPED_TRI, SNAPPED_HOST),
            "fma": (_FMA_A, _FMA_B)}[name]
    # the second r ring: the C-shape's inner polygon poked into the cavity,
    # else the first ring in the other orientation
    second = a + np.array([0.0, 2.5]) if name == "cshape" else a[::-1]
    (R0, R), (S0, S) = _ds([a, second], "r"), _ds([b], "s")
    return R0, S0, R, S, np.array([[0, 0], [1, 0]], np.int64)


FIXTURES = ["t2t10", "touchy", "cshape", "snapped", "fma"]


@pytest.mark.parametrize("name", FIXTURES)
def test_within_core_matches_reference(wz, name):
    R0, S0, R, S, pairs = _fixture(name, wz)
    ri_, si_ = pairs[:, 0], pairs[:, 1]
    args = (R.verts[ri_], R.nverts[ri_], S.verts[si_], S.nverts[si_])
    with jax.enable_x64(True):
        wv, wu = (np.asarray(x) for x in jax.jit(rrefine._within_impl_jnp)(
            *(jnp.asarray(a) for a in args)))
    gv, gu = (x.numpy() for x in refine._within_impl(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args)))
    sure = ~wu & ~gu
    np.testing.assert_array_equal(gv[sure], wv[sure])
    want = rrefine.refine_within_pairs(R0, S0, pairs, backend="numpy")
    got = gv.copy()
    if gu.any():
        got[gu] = refine.refine_within_pairs(R, S, pairs[gu],
                                             backend="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        want, rrefine.refine_within_pairs_seq(R0, S0, pairs))
    if name == "fma":
        assert gu[0]            # the borderline sign is flagged
    if name == "touchy":
        assert want[2] and want[4]      # boundary contact counts as within


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("backend", ["numpy", "torch", "sequential",
                                     "device64"])
def test_refine_matches_reference(wz, name, backend):
    """``refine_within_pairs`` on every backend, and ``refine_pairs`` with
    ``device64``, equal the reference's numpy and sequential refines."""
    R0, S0, R, S, pairs = _fixture(name, wz)
    want = rrefine.refine_within_pairs(R0, S0, pairs, backend="numpy")
    np.testing.assert_array_equal(
        want, rrefine.refine_within_pairs_seq(R0, S0, pairs))
    np.testing.assert_array_equal(
        refine.refine_within_pairs(R, S, pairs, backend=backend,
                                   device="cpu"), want)
    np.testing.assert_array_equal(
        refine.refine(R, S, pairs, predicate="within", backend=backend,
                      device="cpu"), want)
    want_i = rrefine.refine_pairs(R0, S0, pairs, backend="numpy")
    np.testing.assert_array_equal(
        want_i, rrefine.refine_pairs_seq(R0, S0, pairs))
    for predicate in ("intersects", "selection"):
        np.testing.assert_array_equal(
            refine.refine(R, S, pairs, predicate=predicate, backend=backend,
                          device="cpu"), want_i)
    if name == "t2t10":
        assert want.any() and not want.all()


def test_device64_needs_a_device(wz):
    """``device64`` runs where it is told; with no device it asks for the
    card and raises when there is none, never falling back to the CPU."""
    _, _, R, S = wz
    pairs = np.zeros((1, 2), np.int64)
    assert refine.refine_pairs(R, S, pairs[:0], backend="device64",
                               device="cpu").shape == (0,)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device64 runs there")
    for fn in (refine.refine_pairs, refine.refine_within_pairs):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(R, S, pairs, backend="device64")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JoinPlan(R, S, refine_backend="device64")


# ---------------------------------------------------------------------------
# JoinPlan end to end
# ---------------------------------------------------------------------------

def _same(got, st, want, wst):
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    for k in COUNTS:
        assert getattr(st, k) == getattr(wst, k), k


@pytest.mark.parametrize("name", FILTERS)
@pytest.mark.parametrize("predicate", ["within", "selection"])
def test_plan_matches_reference(wz, plans, name, predicate):
    """Staged on every pairing of filter and refine backends, and fused
    with both MBR lanes: the reference's staged numpy pairs, order and
    counts."""
    _, _, R, S = wz
    rplan, tplan = plans[name]
    want, wst = rplan.execute(predicate)
    assert wst.predicate == predicate and len(want) > 0
    pre = (tplan.approx_r, tplan.approx_s)
    runs = [{"filter_backend": fb, "refine_backend": rb} for fb, rb in (
        ("numpy", "numpy"), ("torch", "torch"), ("sequential", "sequential"),
        ("torch", "device64"), ("numpy", "sequential"),
        ("sequential", "device64"))]
    runs += [{"pipeline_mode": "fused"},
             {"pipeline_mode": "fused", "mbr_backend": "torch"}]
    for kw in runs:
        got, st = JoinPlan(R, S, filter=name, n_order=8, device="cpu",
                           **kw).build(prebuilt=pre).execute(predicate)
        _same(got, st, want, wst)
        assert st.predicate == predicate


def test_device64_intersects_plan_matches_reference(plans):
    rplan, tplan = plans["april"]
    want, wst = rplan.execute("intersects")
    got, st = JoinPlan(tplan.R, tplan.S, n_order=8, device="cpu",
                       refine_backend="device64").build(
        prebuilt=(tplan.approx_r, tplan.approx_s)).execute("intersects")
    _same(got, st, want, wst)
    assert st.refine_backend == "device64" and wst.n_indecisive > 0


def test_linestring_still_raises(wz):
    """``linestring`` on a polygon plan raises the reference's ValueError;
    its candidates are the reference's, and with the rings as open chains
    (``r_kind="line"``) the join returns the reference's pairs."""
    R0, S0, R, S = wz
    plan = JoinPlan(R, S, n_order=6, device="cpu")
    with pytest.raises(ValueError, match="r_kind='line'"):
        plan.execute("linestring")
    np.testing.assert_array_equal(
        plan.candidates("linestring"),
        RJoinPlan(R0, S0, n_order=6).candidates("linestring"))
    want, _ = RJoinPlan(R0, S0, n_order=6, r_kind="line").build().execute(
        "linestring")
    got, _ = JoinPlan(R, S, n_order=6, device="cpu", r_kind="line").build(
    ).execute("linestring")
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


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


@given(april_stores(3), april_stores(3))
@settings(max_examples=40, deadline=None)
def test_within_property_f_inside_a(sr, ss):
    """With F inside A every backend, and the fused lane, equal the
    reference's per-pair within verdict, empty lists included."""
    ri_, si_ = (g.ravel() for g in np.meshgrid(np.arange(len(sr)),
                                               np.arange(len(ss)),
                                               indexing="ij"))
    want = np.asarray([rjoin.within_verdict_pair(
        sr.a_list(i), sr.f_list(i), ss.a_list(j), ss.f_list(j))
        for i, j in zip(ri_, si_)], np.int8)
    lists = [tjoin.IntervalLists.from_intervals(o, x) for o, x in
             ((sr.a_off, sr.a_ints), (ss.a_off, ss.a_ints),
              (ss.f_off, ss.f_ints))]
    for backend in ("numpy", "torch", "sequential"):
        got = tjoin.within_trichotomy_rows(*lists, ri_, si_, backend=backend,
                                           device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
    lane = tjoin.fused_status_rows(lists[0], None, *lists[1:], ri_, si_,
                                   predicate="within", backend="torch",
                                   device="cpu")
    np.testing.assert_array_equal(lane.numpy(), want)
