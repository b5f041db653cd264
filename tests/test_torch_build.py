"""The port's construction paths held to the JAX package's: every filter's
``numpy``, ``torch`` and ``sequential`` build, for polygons and for open
chains, gives the reference's ``numpy`` and ``sequential`` stores exactly
(on the reference's own fixtures, ``tests/test_construction_batched.py``);
APRIL's per-polygon methods give the reference's lists and PiP counts; the
device twins (Hilbert, the gap-head PiP, the box clip) equal the
reference's jnp functions; and a ``build_backend="torch"`` join returns the
reference's pairs. On the CPU the ``torch`` build runs on
``device="cpu"``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import april as r_april  # noqa: E402
from repro.core import geometry as r_geometry  # noqa: E402
from repro.core import hilbert as r_hilbert  # noqa: E402
from repro.core import intervalize as r_intervalize  # noqa: E402
from repro.core import rasterize as r_rasterize  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import get_filter as r_get_filter  # noqa: E402

from repro_torch import JoinPlan, make_dataset, make_linestrings  # noqa: E402
from repro_torch.baselines import fivec_ch, ra  # noqa: E402
from repro_torch.core import (april, build_april_polygon, geometry,  # noqa: E402
                              hilbert, intervalize, rasterize, ri)
from repro_torch.core.rasterize import Extent  # noqa: E402
from repro_torch.spatial import BUILD_BACKENDS, get_filter  # noqa: E402

N_ORDER = 6
FILTERS = ("april", "april-c", "ri", "ra", "5cch")
BUILD_OPTS = {"ra": {"max_cells": 96}}
#: crosses the left extent boundary (the reference's regression triangle)
TRI = np.array([[-0.5, 0.2], [0.3, 0.2], [0.3, 0.6]])
#: covers a small partition extent without touching it
COVER = np.array([[0., 0.], [1., 0.], [1., 1.], [0., 1.]])
METHODS = ("batched", "pips", "neighbors", "scanline", "floodfill")


@pytest.fixture(scope="module")
def data():
    """(reference, port) copies of the reference's construction fixtures:
    50 T1 polygons (seed 31) and 40 chains (seed 32)."""
    return {"polygon": (r_make_dataset("T1", seed=31, count=50),
                        make_dataset("T1", seed=31, count=50)),
            "line": (r_make_linestrings(seed=32, count=40),
                     make_linestrings(seed=32, count=40))}


@pytest.fixture(scope="module")
def ref_stores(data):
    """The reference's numpy and sequential stores, built once per
    (filter, kind)."""
    cache = {}

    def get(name, kind):
        if (name, kind) not in cache:
            D0 = data[kind][0]
            cache[name, kind] = tuple(
                r_get_filter(name).build(D0, n_order=N_ORDER, kind=kind,
                                         build_backend=bb,
                                         **BUILD_OPTS.get(name, {})).store
                for bb in ("numpy", "sequential"))
        return cache[name, kind]
    return get


def _store_fields(s):
    """(name, value) of every array (or VByte buffer list) of a store."""
    if hasattr(s, "a_bufs"):
        return [("a_bufs", s.a_bufs), ("f_bufs", s.f_bufs)]
    if hasattr(s, "a_off"):
        return [(k, getattr(s, k)) for k in ("a_off", "a_ints", "f_off",
                                             "f_ints")]
    if hasattr(s, "ids"):
        return [("off", s.off), ("ids", s.ids)]
    if hasattr(s, "bit_off"):
        return [(k, getattr(s, k)) for k in ("off", "ints", "bit_off",
                                             "bits")]
    if hasattr(s, "cells"):
        return ([(k, getattr(s, k)) for k in ("k", "origin", "shape")]
                + [(f"grid {i}", g) for i, g in enumerate(s.cells)])
    return [(k, getattr(s, k)) for k in ("pent", "hull_off", "hull_pts")]


def _assert_same_store(got, want):
    g, w = _store_fields(got), _store_fields(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if isinstance(a, list):
            assert a == b, k
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


# ---------------------------------------------------------------------------
# stores: every filter x kind x build backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BUILD_BACKENDS)
@pytest.mark.parametrize("kind", ["polygon", "line"])
@pytest.mark.parametrize("name", FILTERS)
def test_stores_match_reference(data, ref_stores, name, kind, backend):
    want_np, want_seq = ref_stores(name, kind)
    got = get_filter(name).build(data[kind][1], n_order=N_ORDER, kind=kind,
                                 build_backend=backend, device="cpu",
                                 **BUILD_OPTS.get(name, {}))
    assert got.kind == kind and len(got) == len(data[kind][1])
    _assert_same_store(got.store, want_np)
    _assert_same_store(got.store, want_seq)


# ---------------------------------------------------------------------------
# APRIL's construction methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_april_methods_match_reference(data, method):
    """Polygon by polygon, each method's (A, F) lists and its PiP count
    equal the reference's ``build_april_polygon``; the filter's build with
    that method equals the reference's on every backend."""
    R0, R = data["polygon"]
    for i in range(len(R)):
        r_intervalize.PIP_COUNTER["count"] = 0
        intervalize.PIP_COUNTER["count"] = 0
        wa, wf = r_april.build_april_polygon(R0.verts[i], int(R0.nverts[i]),
                                             N_ORDER, method=method)
        ga, gf = build_april_polygon(R.verts[i], int(R.nverts[i]), N_ORDER,
                                     method=method)
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gf, wf)
        assert ga.dtype == wa.dtype == np.uint64
        assert (intervalize.PIP_COUNTER["count"]
                == r_intervalize.PIP_COUNTER["count"]), i
    want = r_get_filter("april").build(R0, n_order=N_ORDER, method=method)
    for backend in BUILD_BACKENDS:
        got = get_filter("april").build(R, n_order=N_ORDER, method=method,
                                        build_backend=backend, device="cpu")
        _assert_same_store(got.store, want.store)
        assert got.meta["build_opts"] == want.meta["build_opts"]


def test_pip_counts_of_the_batched_build_match_reference(data):
    """The dataset-level build counts one PiP a gap head, as the
    reference's does, on the host and on the device."""
    R0, R = data["polygon"]
    r_intervalize.PIP_COUNTER["count"] = 0
    r_april.build_april(R0, N_ORDER)
    for backend in ("numpy", "torch"):
        intervalize.PIP_COUNTER["count"] = 0
        april.build_april(R, N_ORDER, backend=backend, device="cpu")
        assert (intervalize.PIP_COUNTER["count"]
                == r_intervalize.PIP_COUNTER["count"] > 0)


def test_onestep_covering_and_missing_polygons():
    """A polygon covering a partition extent is the whole grid for every
    one-step method; one outside it is empty."""
    ext = Extent(0.4, 0.4, 0.1)
    r_ext = r_rasterize.Extent(0.4, 0.4, 0.1)
    for method in ("batched", "pips", "neighbors"):
        a, f = intervalize.onestep(COVER, 4, 5, ext, method=method)
        assert a.tolist() == [[0, 4 ** 5]] and f.tolist() == [[0, 4 ** 5]]
    far = np.array([[1.2, 1.2], [1.4, 1.2], [1.3, 1.4]])
    for method in METHODS:
        got = build_april_polygon(far, 3, 5, ext, method=method)
        want = r_april.build_april_polygon(far, 3, 5, r_ext, method=method)
        for g, w in zip(got, want):
            assert len(g) == len(w) == 0
    with pytest.raises(ValueError, match="unknown construction method"):
        build_april_polygon(COVER, 4, 5, ext, method="raster")


# ---------------------------------------------------------------------------
# the device twins against the reference's jnp functions
# ---------------------------------------------------------------------------

def test_hilbert_twins_match_jnp():
    rng = np.random.default_rng(0)
    x, y = rng.integers(0, 2 ** 16, (2, 256))
    d = hilbert.xy2d_torch(16, torch.from_numpy(x), torch.from_numpy(y))
    with jax.enable_x64(True):
        dj = np.asarray(r_hilbert.xy2d_jnp(16, jnp.asarray(x),
                                           jnp.asarray(y)))
        xj, yj = r_hilbert.d2xy_jnp(16, jnp.asarray(dj))
    assert d.dtype == torch.int64
    np.testing.assert_array_equal(d.numpy(), dj.astype(np.int64))
    np.testing.assert_array_equal(d.numpy(), hilbert.xy2d(16, x, y))
    gx, gy = hilbert.d2xy_torch(16, d)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(gx.numpy(), x)
    np.testing.assert_array_equal(gy.numpy(), y)


def _probe_points(R, rng, M=256):
    """M points near a random polygon's vertices, with their polygon."""
    pid = rng.integers(0, len(R), M)
    pts = R.verts[pid, 0] + rng.normal(0.0, 0.02, (M, 2))
    return pts, pid


def test_pip_twin_matches_jnp(data):
    R0, R = data["polygon"]
    pts, pid = _probe_points(R, np.random.default_rng(5))
    starts, ends, mask = r_geometry.polygon_edges(R0.verts, R0.nverts)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(r_geometry._pip_rows_jnp_impl)(
            jnp.asarray(pts), jnp.asarray(starts), jnp.asarray(ends),
            jnp.asarray(mask), jnp.asarray(pid)))
    got = geometry.points_in_polygon_rows_torch(pts, pid, R.verts, R.nverts,
                                                device="cpu")
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, geometry.points_in_polygon_rows(pts, pid, R.verts, R.nverts))
    # tiny chunks split the rows across many vertex buckets
    np.testing.assert_array_equal(geometry.points_in_polygon_rows_torch(
        pts, pid, R.verts, R.nverts, device="cpu", chunk_elems=64), want)


def test_clip_twin_matches_jnp(data):
    """The four half-plane passes give the reference's vertices and counts
    (padding included); the areas equal the host batched clip's and the
    per-cell clip's."""
    R0, R = data["polygon"]
    rng = np.random.default_rng(7)
    pts, pid = _probe_points(R, rng)
    h = rng.uniform(0.001, 0.05, (len(pid), 1))
    lo = pts - rng.uniform(0.0, 0.03, pts.shape)
    boxes = np.concatenate([lo, lo + h], axis=1)
    V, nv = R.verts[pid], R.nverts[pid]
    with jax.enable_x64(True):
        wp, wc = jax.jit(r_geometry._box_clip_areas_jnp_impl)(
            jnp.asarray(V), jnp.asarray(nv), jnp.asarray(boxes))
    gp, gc = geometry._box_clip_torch(torch.as_tensor(V), torch.as_tensor(nv),
                                      torch.as_tensor(boxes))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert 0 < (gc.numpy() >= 3).sum() < len(pid)
    got = geometry.box_clip_areas_torch(V, nv, boxes, device="cpu")
    want = r_geometry.box_clip_areas(R0.verts[pid], R0.nverts[pid], boxes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(geometry.box_clip_areas(V, nv, boxes), want)
    per_row = [geometry.polygon_area(ring) if len(ring) >= 3 else 0.0
               for ring in (geometry.clip_polygon_to_box(R.polygon(p),
                                                         tuple(b))
                            for p, b in zip(pid, boxes))]
    np.testing.assert_array_equal(want, per_row)
    for backend in ("numpy", "torch"):
        np.testing.assert_array_equal(geometry.box_clip_areas_rows(
            R.verts, R.nverts, pid, boxes, backend=backend, device="cpu"),
            want)


def test_coverage_fractions_torch_match_reference(data):
    R0, R = data["polygon"]
    p_off, cells = rasterize.dda_partial_cells_multi(R.verts, R.nverts, 8)
    pid = np.repeat(np.arange(len(R)), np.diff(p_off))
    want = r_rasterize.coverage_fractions_multi(R0.verts, R0.nverts, pid,
                                                cells, 8)
    got = rasterize.coverage_fractions_multi(R.verts, R.nverts, pid, cells,
                                             8, backend="torch",
                                             device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)
    # the per-polygon path of the sequential build, row for row
    for p in range(3):
        sel = pid == p
        one = rasterize.coverage_fractions(R.verts[p], int(R.nverts[p]),
                                           cells[sel], 8)
        np.testing.assert_array_equal(one, r_rasterize.coverage_fractions(
            R0.verts[p], int(R0.nverts[p]), cells[sel], 8))
        np.testing.assert_array_equal(one, want[sel])


# ---------------------------------------------------------------------------
# the per-polygon rasterization helpers
# ---------------------------------------------------------------------------

_SHAPES = {"tri": (TRI, 3, (0.0, 0.0, 1.0)),
           "tri-partition": (TRI, 3, (0.25, 0.25, 0.5)),
           "cover": (COVER, 4, (0.4, 0.4, 0.1))}


@pytest.mark.parametrize("shape", sorted(_SHAPES))
def test_rasterize_helpers_match_reference(shape):
    v, n, ext = _SHAPES[shape]
    ext, r_ext = Extent(*ext), r_rasterize.Extent(*ext)
    order = 5
    partial = rasterize.dda_partial_cells(v, n, order, ext)
    np.testing.assert_array_equal(
        partial, r_rasterize.dda_partial_cells(v, n, order, r_ext))
    np.testing.assert_array_equal(
        rasterize.dda_partial_cells(v, n, order, ext, closed=False),
        r_rasterize.dda_partial_cells(v, n, order, r_ext, closed=False))
    full = rasterize.scanline_full_cells(v, n, partial, order, ext)
    np.testing.assert_array_equal(full, r_rasterize.scanline_full_cells(
        v, n, partial, order, r_ext))
    flood = rasterize.floodfill_classify(v, n, partial, order, ext)
    np.testing.assert_array_equal(flood, r_rasterize.floodfill_classify(
        v, n, partial, order, r_ext))
    oracle = rasterize.classify_window_oracle(v, n, order, ext)
    want = r_rasterize.classify_window_oracle(v, n, order, r_ext)
    for k in ("partial", "full"):
        np.testing.assert_array_equal(oracle[k], want[k])
    assert set(map(tuple, flood)) == set(map(tuple, full))
    assert set(map(tuple, partial)) == set(map(tuple, oracle["partial"]))
    frac = rasterize.coverage_fractions(v, n, partial, order, ext)
    np.testing.assert_array_equal(frac, r_rasterize.coverage_fractions(
        v, n, partial, order, r_ext))
    for cells in (partial, full, partial[:0]):
        ids = rasterize.cells_to_hilbert(cells, order)
        np.testing.assert_array_equal(
            ids, r_rasterize.cells_to_hilbert(cells, order))
        assert ids.dtype == np.uint64
        np.testing.assert_array_equal(
            intervalize.ids_in_intervals(intervalize.intervals_from_ids(ids)),
            ids)
    a, f = intervalize.april_from_cells(partial, full, order)
    wa, wf = r_intervalize.april_from_cells(partial, full, order)
    np.testing.assert_array_equal(a, wa)
    np.testing.assert_array_equal(f, wf)


# ---------------------------------------------------------------------------
# names, devices and the builders reached directly
# ---------------------------------------------------------------------------

def test_build_backend_names_and_devices(data):
    _, R = data["polygon"]
    filt = get_filter("april")
    with pytest.raises(ValueError, match="build_backend='torch'"):
        filt.build(R, n_order=N_ORDER, build_backend="jnp")
    with pytest.raises(ValueError, match="unknown build_backend"):
        filt.build(R, n_order=N_ORDER, build_backend="cuda")
    for build in (lambda: april.build_april(R, N_ORDER, backend="jnp"),
                  lambda: ri.build_ri(R, N_ORDER, backend="jnp"),
                  lambda: ra.build_ra(R, backend="jnp"),
                  lambda: fivec_ch.build_5cch(R, backend="jnp")):
        with pytest.raises(ValueError, match="'torch'"):
            build()
    assert BUILD_BACKENDS == ("numpy", "torch", "sequential")
    builds = {"april": lambda d: april.build_april(R, N_ORDER,
                                                   backend="torch", device=d),
              "ri": lambda d: ri.build_ri(R, N_ORDER, backend="torch",
                                          device=d),
              "ra": lambda d: ra.build_ra(R, 96, backend="torch", device=d),
              "5cch": lambda d: fivec_ch.build_5cch(R, backend="torch",
                                                    device=d)}
    for name, build in builds.items():
        if torch.cuda.is_available():
            _assert_same_store(build(None), build("cpu"))
        else:
            # device=None means the card; without one nothing falls back
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build(None)
    with pytest.raises(ValueError, match="clip backend"):
        geometry.box_clip_areas_rows(R.verts, R.nverts, [0], [[0, 0, 1, 1]],
                                     backend="sequential")


@pytest.mark.parametrize("name", ["april", "ri", "ra"])
def test_torch_build_join_matches_reference(name):
    """``JoinPlan(..., build_opts={"build_backend": "torch"})`` builds on
    the plan's device and returns the reference's staged numpy pairs, in
    order, with its counts."""
    R0, S0 = (r_make_dataset("T1", seed=0, count=80),
              r_make_dataset("T2", seed=1, count=160))
    R, S = make_dataset("T1", seed=0, count=80), make_dataset("T2", seed=1,
                                                              count=160)
    opts = dict(BUILD_OPTS.get(name, {}))
    want, wst = RJoinPlan(R0, S0, filter=name, n_order=8,
                          build_opts=opts).build().execute("intersects")
    plan = JoinPlan(R, S, filter=name, n_order=8, device="cpu",
                    build_opts={"build_backend": "torch", **opts})
    got, st = plan.build().execute("intersects")
    assert len(want) > 100
    np.testing.assert_array_equal(got, want)
    for k in ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive"):
        assert getattr(st, k) == getattr(wst, k), k
    assert st.approx_bytes == wst.approx_bytes
