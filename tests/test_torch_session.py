"""The port's session surface held to the JAX package's: raw stores adopted
through ``JoinPlan.build(prebuilt=...)``, ``JoinStats.row()``, the
deprecated ``backend=`` alias, the direct filter registry calls and the
backend tuples."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.spatial as r_spatial  # noqa: E402
import repro.spatial.filters as r_filters  # noqa: E402
from repro.spatial.filters.base import (  # noqa: E402
    BUILD_BACKENDS as R_BUILD_BACKENDS)
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import JoinStats as RJoinStats  # noqa: E402

import repro_torch.spatial as spatial  # noqa: E402
from repro_torch import JoinPlan, JoinStats, make_dataset  # noqa: E402
from repro_torch.spatial import filters  # noqa: E402

FILTERS = ("none", "april", "april-c", "ri", "ra", "5cch")


@pytest.fixture(scope="module")
def datasets():
    return (r_make_dataset("T1", seed=0, count=80),
            r_make_dataset("T2", seed=1, count=160),
            make_dataset("T1", seed=0, count=80),
            make_dataset("T2", seed=1, count=160))


@pytest.mark.parametrize("name", FILTERS)
def test_raw_prebuilt_stores_give_reference_pairs(datasets, name):
    """Raw stores (not Approximations) adopted as ``prebuilt`` are wrapped
    with the plan's filter, order, extent and kind, and the join returns
    the reference's pairs, order and counts for the same raw stores."""
    R0, S0, R, S = datasets
    filt = filters.get_filter(name)
    raw_r = filt.build(R, n_order=8, side="r").store
    raw_s = filt.build(S, n_order=8, side="s").store
    ref = RJoinPlan(R0, S0, filter=name, n_order=8)
    want, wst = ref.build().execute("intersects")
    plan = JoinPlan(R, S, filter=name, n_order=8, device="cpu").build(
        prebuilt=(raw_r, raw_s))
    if raw_r is not None:
        assert plan.approx_r.store is raw_r and plan.approx_s.store is raw_s
    for approx, kind in ((plan.approx_r, "polygon"),
                         (plan.approx_s, "polygon")):
        assert isinstance(approx, filters.Approximation)
        assert (approx.filter, approx.kind, approx.n_order) == (name, kind, 8)
    got, st = plan.execute("intersects")
    assert len(want) > 100
    np.testing.assert_array_equal(got, want)
    for k in ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive"):
        assert getattr(st, k) == getattr(wst, k), k
    # an Approximation passes through as it is
    again = JoinPlan(R, S, filter=name, n_order=8, device="cpu").build(
        prebuilt=(plan.approx_r, None))
    assert again.approx_r is plan.approx_r


_FIELDS = dict(method="april", n_candidates=742279, n_true_hits=493842,
               n_true_negs=204605, n_indecisive=43832, n_results=514768,
               t_mbr=0.4664, t_filter=0.0025, t_refine=0.8651,
               t_sync=0.014, filter_backend="cuda", refine_backend="cuda",
               mbr_backend="torch")


@pytest.mark.parametrize("mode", ["staged", "fused", "tiled"])
def test_row_matches_reference(mode):
    kw = dict(_FIELDS)
    if mode == "staged":
        kw.update(t_sync=0.0, method="ri", n_candidates=0, n_true_hits=0,
                  n_true_negs=0, n_indecisive=0)
    else:
        kw["pipeline_mode"] = "fused"
    if mode == "tiled":
        kw.update(tiles=7, t_partition=1.25, method="5cch")
    got, want = JoinStats(**kw).row(), RJoinStats(**kw).row()
    assert got == want
    assert ("sync=" in got) == (mode != "staged")
    assert ("tiles=7" in got) == (mode == "tiled")


def test_row_of_an_executed_join(datasets):
    """The row of a real run has the reference's layout; only the times
    differ."""
    R0, S0, R, S = datasets
    _, st = JoinPlan(R, S, n_order=8, device="cpu").execute("intersects")
    _, rst = RJoinPlan(R0, S0, n_order=8).execute("intersects")
    times = ("t_mbr", "t_filter", "t_refine", "t_sync")
    for k in times:
        setattr(st, k, getattr(rst, k))
    st.filter_backend = st.refine_backend = "numpy"
    assert st.row() == rst.row()


def test_backend_alias(datasets):
    _, _, R, S = datasets
    with pytest.warns(DeprecationWarning, match="2026-12-01"):
        plan = JoinPlan(R, S, device="cpu", backend="numpy")
    assert plan.backend == plan.filter_backend == "numpy"
    with pytest.warns(DeprecationWarning):
        plan = JoinPlan(R, S, device="cpu", backend="sequential",
                        filter_backend="sequential")
    assert plan.backend == "sequential"
    with pytest.raises(ValueError, match="not both"):
        JoinPlan(R, S, device="cpu", backend="numpy",
                 filter_backend="torch")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = JoinPlan(R, S, device="cpu")
    # the port's device default stands when neither name is given
    assert plan.backend == plan.filter_backend == "torch"
    with pytest.warns(DeprecationWarning):
        _, st = JoinPlan(R, S, n_order=7, device="cpu",
                         backend="numpy").execute("intersects")
    assert st.backend == st.filter_backend == "numpy"


def test_register_filter_directly_and_unregister(datasets):
    """``register_filter(name, cls)`` and ``unregister_filter`` change the
    port's registry only: the reference's stays as it was."""
    _, _, R, S = datasets
    before_ref = r_filters.available_filters()
    before = filters.available_filters()

    class Everything(filters.get_filter("none").__class__):
        pass

    try:
        assert filters.register_filter("probe", Everything) is Everything
        assert Everything.name == "probe"
        assert "probe" in filters.available_filters()
        assert spatial.available_filters() == filters.available_filters()
        assert r_filters.available_filters() == before_ref
        _, st = JoinPlan(R, S, filter="probe", n_order=7,
                         device="cpu").execute("intersects")
        assert st.method == "probe" and st.n_indecisive == st.n_candidates
    finally:
        filters.unregister_filter("probe")
    assert filters.available_filters() == before
    filters.unregister_filter("probe")         # a missing name is no error
    with pytest.raises(ValueError, match="unknown intermediate filter"):
        filters.get_filter("probe")

    @filters.register_filter("probe-decorated")
    class Decorated(Everything):
        pass

    try:
        assert Decorated.name == "probe-decorated"
        assert isinstance(filters.get_filter("probe-decorated"), Decorated)
    finally:
        filters.unregister_filter("probe-decorated")
    assert filters.available_filters() == before
    assert r_filters.available_filters() == before_ref


def test_backend_tuples():
    for mod in (filters, spatial):
        assert mod.BACKENDS is mod.FILTER_BACKENDS
        assert mod.BUILD_BACKENDS == ("numpy", "torch", "sequential")
    assert filters.BACKENDS == filters.FILTER_BACKENDS
    assert r_filters.BACKENDS == r_filters.FILTER_BACKENDS
    # the port's device construction is named "torch" where the
    # reference's is "jnp"; the other two names are shared
    assert ({b for b in R_BUILD_BACKENDS if b != "jnp"}
            == {b for b in filters.BUILD_BACKENDS if b != "torch"})
    assert r_spatial.FILTER_BACKENDS == r_filters.FILTER_BACKENDS
