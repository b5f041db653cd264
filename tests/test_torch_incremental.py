"""Incremental store maintenance in the port held to the JAX package: the
CSR row splices, ``IntervalLists`` splices (whose device copies, row keys
and host keys must then equal a rebuilt list's), every filter's
``patch_insert`` / ``patch_delete`` (the patched store equals the
reference's patched store and a fresh port rebuild, array for array, and
joins as the reference's does), the warm ``MBRIndex`` and
``JoinPlan(mbr_index=...)`` staged and fused. Small sizes, on the CPU
(``device="cpu"``); tolerance zero throughout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import join as rjoin  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.datagen.synthetic import PolygonDataset as RPolygonDataset  # noqa: E402,E501
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.mbr_join import MBRIndex as RMBRIndex  # noqa: E402

from repro_torch import JoinPlan, PolygonDataset, make_dataset  # noqa: E402
from repro_torch import make_linestrings  # noqa: E402
from repro_torch.core import join  # noqa: E402
from repro_torch.core.ri import RIDeviceStore  # noqa: E402
from repro_torch.spatial import fused  # noqa: E402
from repro_torch.spatial.filters import get_filter  # noqa: E402
from repro_torch.spatial.mbr_join import MBRIndex  # noqa: E402

N_ORDER = 7
FILTERS = ("april", "april-c", "ri", "ra", "5cch", "none")
#: RA grids capped small, so that the stores build fast
BUILD_OPTS = {"ra": {"max_cells": 128}}


def _subset(ds, ids, cls):
    return cls(name=ds.name, verts=ds.verts[ids], nverts=ds.nverts[ids])


def _assert_same(got, want, path="store"):
    """Two stores (or store fields) equal: arrays in dtype, shape and
    bytes, VByte buffer lists and RA grid lists element for element, and
    the extent by its numbers."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif hasattr(want, "side"):
        assert (got.x0, got.y0, got.side) == (want.x0, want.y0,
                                              want.side), path
    elif hasattr(want, "__dict__"):
        assert sorted(vars(got)) == sorted(vars(want)), path
        for k, v in vars(want).items():
            _assert_same(getattr(got, k), v, f"{path}.{k}")
    else:
        assert got == want, path


def _lists_same(got: join.IntervalLists, want: join.IntervalLists):
    """Host arrays, host keys, device copies and device row keys equal."""
    for k in ("off", "starts", "lasts"):
        _assert_same(getattr(got, k), getattr(want, k), k)
    _assert_same(got.host_keys(), want.host_keys(), "host_keys")
    for a, b in zip(got.to("cpu"), want.to("cpu")):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got.last_keys("cpu"), want.last_keys("cpu"))


# ---------------------------------------------------------------------------
# CSR splice primitives and IntervalLists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,width", [(np.int32, None), (np.uint64, 2)])
def test_csr_row_splices_match_reference(dtype, width):
    rng = np.random.default_rng(0)
    shape = (lambda n: (n,)) if width is None else (lambda n: (n, width))
    rows = [rng.integers(0, 50, size=shape(n)).astype(dtype)
            for n in (3, 0, 4, 2, 5)]
    off = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    data = np.concatenate(rows)
    for i in range(len(rows)):
        _assert_same(join.csr_delete_row(off, data, i),
                     rjoin.csr_delete_row(off, data, i))
    new = rng.integers(0, 9, size=shape(3)).astype(dtype)
    got = join.csr_append_row(off, data, new)
    _assert_same(got, rjoin.csr_append_row(off, data, new))
    _assert_same(got[1], np.concatenate(rows + [new]))


def test_interval_lists_splice_drops_every_derived_copy():
    """A spliced list equals the reference's spliced list and one built
    afresh from the patched rows: ``to()``, ``last_keys`` and
    ``host_keys`` too, though all three were cached before the splice."""
    rng = np.random.default_rng(1)
    rows = [np.sort(rng.choice(99, size=rng.integers(0, 6), replace=False)
                    ).astype(np.int32) for _ in range(6)]
    off = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    starts = np.concatenate(rows)
    il = join.IntervalLists(off, starts.copy(), starts + 2)
    ref = rjoin.IntervalLists(off=off, starts=starts.copy(),
                              lasts=starts + 2)
    il.to("cpu"), il.last_keys("cpu"), il.host_keys()
    new = np.array([4, 40], np.int32)
    for lists in (il, ref):
        lists.delete_row(1)
        lists.append_row(new, new + 2)
        lists.delete_row(3)
    kept = rows[:1] + rows[2:4] + rows[5:] + [new]
    fresh_off = np.cumsum([0] + [len(r) for r in kept]).astype(np.int64)
    fresh_starts = np.concatenate(kept)
    fresh = join.IntervalLists(fresh_off, fresh_starts, fresh_starts + 2)
    for k in ("off", "starts", "lasts"):
        _assert_same(getattr(il, k), getattr(ref, k), k)
    _lists_same(il, fresh)


def test_adaptive_order_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(200):
        a = np.sort(rng.random((2, 2)), axis=0).T.ravel()[[0, 2, 1, 3]]
        b = np.sort(rng.random((2, 2)), axis=0).T.ravel()[[0, 2, 1, 3]]
        nf = rng.integers(0, 3, 2)
        assert join.adaptive_order(a, b, *nf) == \
            rjoin.adaptive_order(a, b, *nf)
    box = np.array([0.0, 0.0, 1.0, 1.0])
    assert join.adaptive_order(box, box, 1, 2) == ("AF", "FA", "AA")


# ---------------------------------------------------------------------------
# Every filter's patched store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layers():
    """T1 80 as the patched side, T2 24 as queries, T8 chains 60: the
    reference's datasets and the port's."""
    return {"polygon": (r_make_dataset("T1", seed=41, count=80),
                        make_dataset("T1", seed=41, count=80)),
            "line": (r_make_linestrings("T8", seed=43, count=60),
                     make_linestrings("T8", seed=43, count=60)),
            "queries": (r_make_dataset("T2", seed=42, count=24),
                        make_dataset("T2", seed=42, count=24))}


def _patched(filt, D, cls, kind):
    """``filt``'s store of ``D`` without its last object, patched: the last
    object inserted, ids 5 and then 11 deleted (objects 5 and 12), one
    more insert (object 0 again). Returns (approx, the dataset it now
    describes)."""
    n = len(D)
    ids = np.arange(n)
    opts = BUILD_OPTS.get(filt.name, {})
    approx = filt.build(_subset(D, ids[:-1], cls), n_order=N_ORDER,
                        kind=kind, **opts)
    filt.patch_insert(approx, _subset(D, ids[-1:], cls))
    filt.patch_delete(approx, 5)
    filt.patch_delete(approx, 11)
    filt.patch_insert(approx, _subset(D, ids[:1], cls))
    return approx, _subset(D, np.r_[np.delete(np.delete(ids, 5), 11), 0],
                           cls)


@pytest.mark.parametrize("method,kind", [(m, "polygon") for m in FILTERS]
                         + [("april", "line")])
def test_patched_store_equals_reference_and_rebuild(layers, method, kind):
    (R0, R), (Q0, Q) = layers[kind], layers["queries"]
    got, D = _patched(get_filter(method), R, PolygonDataset, kind)
    want, D0 = _patched(r_get_filter(method), R0, RPolygonDataset, kind)
    _assert_same(got.store, want.store)
    fresh = get_filter(method).build(D, n_order=N_ORDER, kind=kind,
                                     **BUILD_OPTS.get(method, {}))
    _assert_same(got.store, fresh.store)
    predicate = "linestring" if kind == "line" else "intersects"
    kw = {"r_kind": "line"} if kind == "line" else {}
    res, st = JoinPlan(D, Q, filter=method, n_order=N_ORDER, device="cpu",
                       **kw).build(prebuilt=(got, None)).execute(predicate)
    ref, rst = RJoinPlan(D0, Q0, filter=method, n_order=N_ORDER,
                         **kw).build(prebuilt=(want, None)).execute(
        predicate)
    assert len(ref) > 0
    np.testing.assert_array_equal(res, ref)
    assert st.n_indecisive == rst.n_indecisive


@pytest.mark.parametrize("method", ["april", "ri", "april-c", "ra"])
def test_patch_rebuilds_device_caches(layers, method):
    """Caches filled by a join before the patch (APRIL's interval lists
    with their device copies and row keys, RI's device store, RA's
    pyramids) are spliced or dropped: after the patch a join through the
    store uploads copies equal to a fresh store's and returns the
    reference's pairs."""
    (R0, R), (Q0, Q) = layers["polygon"], layers["queries"]
    filt, opts = get_filter(method), BUILD_OPTS.get(method, {})
    approx = filt.build(R, n_order=N_ORDER, **opts)
    for p in ("intersects", "within"):
        JoinPlan(R, Q, filter=method, n_order=N_ORDER, device="cpu",
                 pipeline_mode="fused").build(
            prebuilt=(approx, None)).execute(p)
    filt.patch_delete(approx, 3)
    filt.patch_insert(approx, _subset(Q, [2], PolygonDataset))
    keep = _subset(R, np.delete(np.arange(len(R)), 3), PolygonDataset)
    V = max(keep.verts.shape[1], Q.verts.shape[1])
    pad = [np.pad(v, ((0, 0), (0, V - v.shape[1]), (0, 0)))
           for v in (keep.verts, Q.verts[2:3])]
    D = PolygonDataset(name=R.name, verts=np.concatenate(pad),
                       nverts=np.append(keep.nverts, Q.nverts[2]))
    assert "device_store" not in approx.meta and "pyramid" not in approx.meta
    fresh = filt.build(D, n_order=N_ORDER, **opts)
    _assert_same(approx.store, fresh.store)
    D0 = RPolygonDataset(name=D.name, verts=D.verts, nverts=D.nverts)
    want = RJoinPlan(D0, Q0, filter=method, n_order=N_ORDER,
                     build_opts=opts).execute("within")[0]
    got = JoinPlan(D, Q, filter=method, n_order=N_ORDER, device="cpu",
                   pipeline_mode="fused").build(
        prebuilt=(approx, None)).execute("within")[0]
    np.testing.assert_array_equal(got, want)
    if method == "april":
        for kind in ("A", "F"):
            _lists_same(approx.meta["interval_lists"][kind],
                        filt._lists(fresh, kind))
    if method == "ri":
        a, b = approx.meta["device_store"], RIDeviceStore(fresh.store)
        for x, y in zip(a.to("cpu"), b.to("cpu")):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_patch_validation(layers):
    """The reference's errors (``test_patch_validation``)."""
    _, R = layers["polygon"]
    filt = get_filter("april")
    approx = filt.build(R, n_order=N_ORDER)
    with pytest.raises(ValueError, match="1-object"):
        filt.patch_insert(approx, R)
    with pytest.raises(IndexError, match="out of range"):
        filt.patch_delete(approx, len(R))
    with pytest.raises(ValueError, match="1-object"):
        get_filter("none").patch_insert(approx, R)


# ---------------------------------------------------------------------------
# The warm MBR index
# ---------------------------------------------------------------------------

def _index_ops(index, extra_mbr):
    index.insert(extra_mbr)
    index.delete(4)
    index.delete(len(index.mbrs) - 1)
    index.insert(extra_mbr * 0.5 + 0.25)
    index.delete(0)


def test_mbr_index_matches_reference_after_patches(layers):
    (R0, R), (Q0, Q) = layers["polygon"], layers["queries"]
    got, want = MBRIndex(R.mbrs), RMBRIndex(R0.mbrs)
    _index_ops(got, Q.mbrs[0])
    _index_ops(want, Q0.mbrs[0])
    for k in ("mbrs", "lo", "_obj", "_buck"):
        _assert_same(getattr(got, k), getattr(want, k), k)
    assert (got.k, tuple(got.extent), got.n_entries) == \
        (want.k, tuple(want.extent), want.n_entries)
    fresh = MBRIndex(got.mbrs, grid=got.k, extent=got.extent)
    for k in ("_obj", "_buck", "lo"):
        _assert_same(getattr(got, k), getattr(fresh, k), k)
    want_pairs = want.probe(Q0.mbrs, backend="numpy")
    assert len(want_pairs) > 0
    for backend in ("numpy", "torch", "sequential"):
        pairs = got.probe(Q.mbrs, backend=backend, device="cpu")
        if backend == "sequential":
            key = np.lexsort
            pairs = pairs[key(pairs.T[::-1])]
            np.testing.assert_array_equal(
                pairs, want_pairs[key(want_pairs.T[::-1])])
        else:
            np.testing.assert_array_equal(pairs, want_pairs)
    assert got.stats == {**want.stats, "probes": 3}
    with pytest.raises(ValueError, match="'torch'"):
        got.probe(Q.mbrs, backend="jnp")
    with pytest.raises(IndexError, match="out of range"):
        got.delete(len(got.mbrs))
    # queries far outside the index extent: the reference's pairs
    np.testing.assert_array_equal(got.probe(Q.mbrs + 0.3),
                                  want.probe(Q0.mbrs + 0.3))


@pytest.mark.parametrize("mode,mbr_backend", [
    ("staged", "numpy"), ("staged", "torch"), ("fused", "numpy"),
    ("fused", "torch")])
def test_join_plan_mbr_index_equals_reference(layers, mode, mbr_backend):
    """``JoinPlan(mbr_index=...)`` returns the reference's staged pairs
    and counts. The fused chain takes the index's pre-filtered frame even
    with ``mbr_backend="torch"``, as the reference's does: its frame is
    the candidate set (no ``valid`` lane), and the index is probed."""
    (R0, R), (Q0, Q) = layers["polygon"], layers["queries"]
    for predicate in ("intersects", "within"):
        want, wst = RJoinPlan(R0, Q0, n_order=N_ORDER,
                              mbr_index=RMBRIndex(R0.mbrs)).execute(
            predicate)
        index = MBRIndex(R.mbrs)
        with fused.record_chains() as chains:
            got, st = JoinPlan(R, Q, n_order=N_ORDER, device="cpu",
                               mbr_index=index, pipeline_mode=mode,
                               mbr_backend=mbr_backend).execute(predicate)
        np.testing.assert_array_equal(got, want)
        assert (st.n_candidates, st.n_indecisive) == (wst.n_candidates,
                                                      wst.n_indecisive)
        assert index.stats["probes"] == 1
        if mode == "fused":
            (cs,) = chains
            assert cs.valid is None and len(cs) == st.n_candidates
