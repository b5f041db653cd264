"""The port's host filters (``none``, ``5cch``, ``ra``, ``april-c``) held to
the JAX package: the same stores as the reference's numpy build, the same
verdicts as its batched and per-pair filters, and the same result pairs,
order and ``JoinStats`` counts as its staged numpy plan, in both pipeline
modes, on T1 x T2 and on the empty and one-live-pair frames."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.mbr_join import mbr_join as r_mbr_join  # noqa: E402

from repro_torch import JoinPlan, make_dataset, state  # noqa: E402
from repro_torch.core.join import INDECISIVE  # noqa: E402
from repro_torch.spatial.filters import (  # noqa: E402
    available_filters, get_filter)

HOST_FILTERS = ("none", "5cch", "ra", "april-c")
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
#: the arrays of each filter's store, compared byte for byte
STORE_FIELDS = {"none": (), "5cch": ("pent", "hull_off", "hull_pts"),
                "ra": ("k", "origin", "shape"),
                "april-c": ()}


@pytest.fixture(scope="module")
def t1t2():
    """T1 x T2 (80 x 160): the reference datasets and the port's copies."""
    return (r_make_dataset("T1", seed=0, count=80),
            r_make_dataset("T2", seed=1, count=160),
            make_dataset("T1", seed=0, count=80),
            make_dataset("T2", seed=1, count=160))


@pytest.fixture(scope="module")
def built(t1t2):
    """Each host filter's approximations, the reference's and the port's,
    at n_order 8."""
    R0, S0, R, S = t1t2
    out = {}
    for name in HOST_FILTERS:
        rf, f = r_get_filter(name), get_filter(name)
        out[name] = ((rf.build(R0, n_order=8, side="r"),
                      rf.build(S0, n_order=8, side="s")),
                     (f.build(R, n_order=8, side="r"),
                      f.build(S, n_order=8, side="s")))
    return out


def test_registry_holds_every_filter():
    assert available_filters() == ("5cch", "april", "april-c", "none", "ra",
                                   "ri")
    for name in available_filters():
        assert get_filter(name).name == name
    with pytest.raises(ValueError, match="unknown intermediate filter"):
        get_filter("mbr")


@pytest.mark.parametrize("name", HOST_FILTERS)
def test_stores_are_identical(built, name):
    (ref_r, ref_s), (got_r, got_s) = built[name]
    for ref, got in ((ref_r, got_r), (ref_s, got_s)):
        assert got.filter == name and got.n_order == ref.n_order
        assert got.size_bytes() == ref.size_bytes() and len(got) == len(ref)
        if name == "none":
            assert got.store is None
        for k in STORE_FIELDS[name]:
            a, b = getattr(got.store, k), getattr(ref.store, k)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        if name == "ra":
            assert got.store.omega == ref.store.omega
            assert all(a.tobytes() == b.tobytes() for a, b in
                       zip(got.store.cells, ref.store.cells))
        if name == "april-c":
            assert got.store.a_bufs == ref.store.a_bufs
            assert got.store.f_bufs == ref.store.f_bufs


@pytest.mark.parametrize("backend", ["numpy", "torch", "sequential"])
@pytest.mark.parametrize("name", HOST_FILTERS)
def test_verdicts_match_reference(t1t2, built, name, backend):
    """The port's verdicts equal the reference's batched numpy verdicts and
    its per-pair reference, row for row, on every backend."""
    R0, S0, _, _ = t1t2
    (ref_r, ref_s), (got_r, got_s) = built[name]
    pairs = r_mbr_join(R0.mbrs, S0.mbrs)
    rf = r_get_filter(name)
    want = rf.verdicts(ref_r, ref_s, pairs, backend="numpy")
    np.testing.assert_array_equal(
        want, rf.verdicts(ref_r, ref_s, pairs, backend="sequential"))
    got = get_filter(name).verdicts(got_r, got_s, pairs, backend=backend,
                                    device="cpu")
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    empty = get_filter(name).verdicts(got_r, got_s, pairs[:0],
                                      backend=backend, device="cpu")
    assert empty.shape == (0,) and empty.dtype == np.int8


@pytest.mark.parametrize("name", HOST_FILTERS)
def test_status_lanes(t1t2, built, name):
    R0, S0, _, _ = t1t2
    (ref_r, ref_s), (got_r, got_s) = built[name]
    pairs = r_mbr_join(R0.mbrs, S0.mbrs)
    want = r_get_filter(name).verdicts(ref_r, ref_s, pairs)
    f = get_filter(name)
    for backend in ("torch", "numpy"):
        lane = f.status_lane(got_r, got_s, pairs[:, 0], pairs[:, 1],
                             backend=backend, device="cpu")
        assert lane.dtype == torch.int8 and lane.device.type == "cpu"
        np.testing.assert_array_equal(lane.numpy(), want)
    empty = f.status_lane(got_r, got_s, pairs[:0, 0], pairs[:0, 1],
                          backend="torch", device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.int8
    if name == "none":
        assert (want == INDECISIVE).all()


def test_april_c_degenerate_order(t1t2, built):
    """A join order without FA leaves its hits INDECISIVE, as in the
    reference's batched filter."""
    R0, S0, _, _ = t1t2
    (ref_r, ref_s), (got_r, got_s) = built["april-c"]
    pairs = r_mbr_join(R0.mbrs, S0.mbrs)
    order = ("AA", "AF")
    want = r_get_filter("april-c").verdicts(ref_r, ref_s, pairs, order=order)
    for backend in ("numpy", "torch"):
        got = get_filter("april-c").verdicts(got_r, got_s, pairs,
                                             backend=backend, device="cpu",
                                             order=order)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="AA"):
        get_filter("april-c").verdicts(got_r, got_s, pairs, order=("AF",))


@pytest.mark.parametrize("mode,mbr_backend", [("staged", "numpy"),
                                              ("staged", "torch"),
                                              ("fused", "numpy"),
                                              ("fused", "torch")])
@pytest.mark.parametrize("name", HOST_FILTERS)
def test_plan_matches_reference_staged(t1t2, built, name, mode,
                                       mbr_backend):
    R0, S0, R, S = t1t2
    ref, rst = RJoinPlan(R0, S0, filter=name, n_order=8).build().execute(
        "intersects")
    plan = JoinPlan(R, S, filter=name, n_order=8, device="cpu",
                    pipeline_mode=mode, mbr_backend=mbr_backend)
    got, st = plan.build(prebuilt=built[name][1]).execute("intersects")
    assert len(ref) > 100
    np.testing.assert_array_equal(got, ref)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k
    assert st.approx_bytes == rst.approx_bytes and st.method == name


def _one(square, name):
    return (PolygonDataset(name=name, verts=square[None],
                           nverts=np.asarray([4], np.int64)),
            state.dataset_from_arrays(name, square[None], [4]))


@pytest.mark.parametrize("mbr_backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", HOST_FILTERS + ("ri",))
def test_fused_empty_and_one_pair_frames(name, mbr_backend):
    """An empty candidate frame and a one-live-pair frame go through the
    fused chain as through the reference's staged plan."""
    sq = np.array([[0.1, 0.1], [0.2, 0.1], [0.2, 0.2], [0.1, 0.2]])
    a0, a = _one(sq, "a")
    for other in (sq + 0.05, sq + 0.6):
        b0, b = _one(other, "b")
        ref, rst = RJoinPlan(a0, b0, filter=name, n_order=6).build() \
            .execute("intersects")
        got, st = JoinPlan(a, b, filter=name, n_order=6, device="cpu",
                           pipeline_mode="fused",
                           mbr_backend=mbr_backend).build().execute(
            "intersects")
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == np.int64 and got.shape[1:] == (2,)
        for k in COUNTS:
            assert getattr(st, k) == getattr(rst, k), k
    assert st.n_candidates == 0 and len(got) == 0
