"""The port's last public helpers held to the JAX package on the CPU: the
raw-store filter wrappers (``april_filter_batch``, ``within_filter_batch``,
``linestring_filter_batch``), ``batch_overlap_np``, ``refine_pair``, the
boundary fixtures and the names the ``core``, ``baselines`` and
``datagen`` packages export. Stores are those of
``tests/test_torch_filters.py``: T1 x T2 at 80 x 160, seeds 0 and 1,
``n_order`` 8, plus T8 chains (seed 3) for the linestring filter."""
import importlib
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.baselines  # noqa: E402
import repro.core  # noqa: E402
import repro.datagen  # noqa: E402
from repro.core import join as rjoin  # noqa: E402
from repro.core.april import build_april as r_build_april  # noqa: E402
from repro.datagen import fixtures as rfixtures  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.spatial import refine as rrefine  # noqa: E402
from repro.spatial.filters.april_filter import (  # noqa: E402
    build_line_cells as r_build_line_cells)
from repro.spatial.mbr_join import mbr_join  # noqa: E402

from repro_torch import make_dataset, make_linestrings, state  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.core.april import build_april, build_line_cells  # noqa: E402
from repro_torch.datagen import fixtures  # noqa: E402
from repro_torch.spatial import refine  # noqa: E402

FULL = ("AA", "AF", "FA")
#: the port's backends that run on the CPU, with the device they are given
#: (no backend on a CPU device is ``"torch"``)
CPU_BACKENDS = (("numpy", None), ("torch", "cpu"), (None, "cpu"))


@pytest.fixture(scope="module")
def stores():
    """APRIL stores of T1 x T2 (80 x 160) and the line cells of 400 T8
    chains at ``n_order`` 8, each built by the reference and by the port,
    with the candidate pairs of the MBR join: (ref, port, pairs) by
    name."""
    out = {}
    R0, R = (r_make_dataset("T1", seed=0, count=80),
             make_dataset("T1", seed=0, count=80))
    S0, S = (r_make_dataset("T2", seed=1, count=160),
             make_dataset("T2", seed=1, count=160))
    L0, L = (r_make_linestrings("T8", seed=3, count=400),
             make_linestrings("T8", seed=3, count=400))
    out["r"] = (r_build_april(R0, n_order=8), build_april(R, n_order=8))
    out["s"] = (r_build_april(S0, n_order=8), build_april(S, n_order=8))
    out["line"] = (r_build_line_cells(L0, n_order=8),
                   build_line_cells(L, n_order=8))
    out["rs_pairs"] = mbr_join(R0.mbrs, S0.mbrs)
    out["ls_pairs"] = mbr_join(L0.mbrs, S0.mbrs)
    return out


def _call(name, ref_or_port, st_, pairs, **kw):
    """One wrapper of the reference (``ref_or_port`` 0) or the port (1)
    on the stores of the fixture."""
    k = ref_or_port
    lib = (rjoin, tjoin)[k]
    if name == "april":
        return lib.april_filter_batch(st_["r"][k], st_["s"][k], pairs, **kw)
    if name == "within":
        return lib.within_filter_batch(st_["r"][k], st_["s"][k], pairs, **kw)
    line = st_["line"][k]
    return lib.linestring_filter_batch(st_["s"][k], line.off, line.ids,
                                       pairs, **kw)


@pytest.mark.parametrize("order", [FULL, ("AA",), ("AF", "FA")],
                         ids=lambda o: "-".join(o))
@pytest.mark.parametrize("backend,device", CPU_BACKENDS)
def test_april_filter_batch_matches_reference(stores, order, backend,
                                              device):
    pairs = stores["rs_pairs"]
    if "AA" not in order:
        for k in (0, 1):
            kw = {"backend": "numpy"} if k == 0 else \
                {"backend": backend, "device": device}
            with pytest.raises(ValueError, match="order must include 'AA'"):
                _call("april", k, stores, pairs, order=order, **kw)
        return
    want = _call("april", 0, stores, pairs, order=order, backend="numpy")
    assert len(want) > 200
    assert set(np.unique(want)) == ({0, 2} if order == ("AA",)
                                    else {0, 1, 2})
    got = _call("april", 1, stores, pairs, order=order, backend=backend,
                device=device)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["within", "linestring"])
@pytest.mark.parametrize("backend,device", CPU_BACKENDS)
def test_within_and_linestring_filter_batch_match_reference(
        stores, name, backend, device):
    pairs = stores["rs_pairs" if name == "within" else "ls_pairs"]
    want = _call(name, 0, stores, pairs, backend="numpy")
    assert len(want) > 100 and len(np.unique(want)) >= 2
    got = _call(name, 1, stores, pairs, backend=backend, device=device)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["april", "within", "linestring"])
def test_wrappers_on_empty_pairs_and_reference_names(stores, name):
    """Empty pairs give an empty int8 result; the reference's device
    backend names raise ``ValueError``; ``cuda`` on the CPU raises, and
    with no device named it, and no backend, mean the card, never the
    CPU."""
    for backend, device in CPU_BACKENDS + (("sequential", None),):
        got = _call(name, 1, stores, np.zeros((0, 2), np.int64),
                    backend=backend, device=device)
        assert got.shape == (0,) and got.dtype == np.int8
    pairs = stores["ls_pairs" if name == "linestring" else "rs_pairs"][:4]
    for ref_name in ("jnp", "pallas"):
        with pytest.raises(ValueError, match="reference's name"):
            _call(name, 1, stores, pairs, backend=ref_name)
    with pytest.raises(ValueError, match="CUDA device"):
        _call(name, 1, stores, pairs, backend="cuda", device="cpu")
    if not torch.cuda.is_available():
        for backend in ("cuda", "torch", None):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                _call(name, 1, stores, pairs, backend=backend)


def test_store_lists_follow_row_splices(stores):
    """The lists a wrapper caches on a store are rebuilt once a row splice
    replaces the store's arrays: an appended copy of row 0 of R gives row
    0's verdicts."""
    ref, port = stores["r"]
    pairs = stores["rs_pairs"]
    p0 = pairs[pairs[:, 0] == 0]
    store = state.april_store_from_arrays(
        port.n_order, port.extent, port.a_off, port.a_ints, port.f_off,
        port.f_ints)
    want = rjoin.april_filter_batch(ref, stores["s"][0], p0)
    np.testing.assert_array_equal(tjoin.april_filter_batch(
        store, stores["s"][1], p0, backend="numpy"), want)
    store.a_off, store.a_ints = tjoin.csr_append_row(
        store.a_off, store.a_ints, port.a_list(0))
    store.f_off, store.f_ints = tjoin.csr_append_row(
        store.f_off, store.f_ints, port.f_list(0))
    moved = np.stack([np.full(len(p0), len(port)), p0[:, 1]], axis=1)
    np.testing.assert_array_equal(tjoin.april_filter_batch(
        store, stores["s"][1], moved, backend="numpy"), want)


# ---------------------------------------------------------------------------
# property: stores with F inside A
# ---------------------------------------------------------------------------

@st.composite
def a_and_f_lists(draw, max_id=2**12, max_len=8):
    """Half-open uint64 A intervals and F intervals cut from inside them."""
    pts = sorted(draw(st.lists(st.integers(0, max_id), max_size=2 * max_len,
                               unique=True)))
    pts = pts[: len(pts) // 2 * 2]
    a = np.asarray(pts, np.uint64).reshape(-1, 2)
    f = []
    for s, e in a.tolist():
        if draw(st.booleans()):
            lo = draw(st.integers(s, e - 1))
            f.append((lo, draw(st.integers(lo + 1, e))))
    return a, np.asarray(f, np.uint64).reshape(-1, 2)


@st.composite
def store_pair(draw, rows=3):
    """The same drawn store as the reference's AprilStore and the port's."""
    lists = [draw(a_and_f_lists()) for _ in range(rows)]
    off = lambda k: np.r_[0, np.cumsum([len(x[k]) for x in lists])]
    cat = lambda k: np.concatenate([x[k] for x in lists]).reshape(-1, 2)
    args = (6, (0.0, 0.0, 1.0), off(0), cat(0), off(1), cat(1))
    return (repro.core.AprilStore(*args),
            state.april_store_from_arrays(*args))


@given(store_pair(), store_pair(), st.permutations(list(FULL)))
@settings(max_examples=30, deadline=None)
def test_filter_batch_property_f_inside_a(sr, ss, order):
    """With F inside A, the port's wrappers equal the reference's numpy
    wrappers for every join order, empty and single-interval lists
    included."""
    order = tuple(order)
    pairs = np.stack([g.ravel() for g in np.meshgrid(
        np.arange(3), np.arange(3), indexing="ij")], axis=1)
    want = rjoin.april_filter_batch(sr[0], ss[0], pairs, order=order)
    want_w = rjoin.within_filter_batch(sr[0], ss[0], pairs)
    for backend, device in CPU_BACKENDS:
        np.testing.assert_array_equal(tjoin.april_filter_batch(
            sr[1], ss[1], pairs, order=order, backend=backend,
            device=device), want, err_msg=backend)
        np.testing.assert_array_equal(tjoin.within_filter_batch(
            sr[1], ss[1], pairs, backend=backend, device=device), want_w,
            err_msg=backend)


# ---------------------------------------------------------------------------
# batch_overlap_np, refine_pair, fixtures, exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [("A", "A"), ("A", "F"), ("F", "A")])
def test_batch_overlap_np_matches_reference(stores, kinds):
    pairs = stores["rs_pairs"]
    (r0, r1), (s0, s1) = stores["r"], stores["s"]
    xs, xl, nx = rjoin.pack_lists(r0, pairs[:, 0], kinds[0])
    ys, yl, ny = rjoin.pack_lists(s0, pairs[:, 1], kinds[1])
    want = rjoin.batch_overlap_np(xs, xl, nx, ys, yl, ny)
    packed = (tjoin.pack_lists(r1, pairs[:, 0], kinds[0])
              + tjoin.pack_lists(s1, pairs[:, 1], kinds[1]))
    got = tjoin.batch_overlap_np(*packed)
    assert got.dtype == bool and want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    empty = (tjoin.pack_lists(r1, pairs[:0, 0], kinds[0])
             + tjoin.pack_lists(s1, pairs[:0, 1], kinds[1]))
    got = tjoin.batch_overlap_np(*empty)
    assert got.shape == (0,) and got.dtype == bool


def _rings(rings):
    """The reference's dataset and the port's over the given rings."""
    V = max(len(v) for v in rings)
    verts = np.zeros((len(rings), V, 2))
    nv = np.asarray([len(v) for v in rings], np.int64)
    for i, v in enumerate(rings):
        verts[i, : len(v)] = v
    return (PolygonDataset(name="fixture", verts=verts, nverts=nv),
            state.dataset_from_arrays("fixture", verts, nv))


def test_refine_pair_matches_reference():
    """On every pair of the four boundary fixtures (the touching pairs
    must read True) and on 300 T1 x T10 candidates."""
    D0, D = _rings([fixtures.SNAPPED_TRI, fixtures.SNAPPED_HOST,
                    fixtures.CSHAPE, fixtures.CSHAPE_INNER])
    for i in range(4):
        for j in range(4):
            want = rrefine.refine_pair(D0, i, D0, j)
            assert refine.refine_pair(D, i, D, j) == want, (i, j)
    assert refine.refine_pair(D, 0, D, 1) and refine.refine_pair(D, 3, D, 2)
    R0, R = (r_make_dataset("T1", seed=0, count=300),
             make_dataset("T1", seed=0, count=300))
    Z0, Z = (r_make_dataset("T10", seed=2, count=60),
             make_dataset("T10", seed=2, count=60))
    pairs = mbr_join(R0.mbrs, Z0.mbrs)[:300]
    assert len(pairs) == 300
    want = [rrefine.refine_pair(R0, i, Z0, j) for i, j in pairs]
    got = [refine.refine_pair(R, i, Z, j) for i, j in pairs]
    assert got == want and 0 < sum(want) < len(want)


def test_fixtures_equal_the_reference():
    for name in rfixtures.__all__:
        want, got = getattr(rfixtures, name), getattr(fixtures, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name
    assert fixtures.__all__ == rfixtures.__all__


@pytest.mark.parametrize("ref_pkg", [repro.core, repro.baselines,
                                     repro.datagen],
                         ids=lambda m: m.__name__)
def test_packages_export_what_the_reference_exports(ref_pkg):
    """Every public name and every submodule of the reference package
    exists in the port's package of the same name."""
    port = importlib.import_module(
        ref_pkg.__name__.replace("repro", "repro_torch", 1))
    names = {n for n in dir(ref_pkg) if not n.startswith("_")}
    subs = {m.name for m in pkgutil.iter_modules(ref_pkg.__path__)}
    assert subs
    for sub in sorted(subs):
        importlib.import_module(f"{port.__name__}.{sub}")
    missing = sorted(n for n in names | subs if not hasattr(port, n))
    assert not missing, missing


# ---------------------------------------------------------------------------
# the kernels behind the wrappers, on the card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["april", "within", "linestring"])
def test_cuda_wrappers_equal_torch(stores, cuda_device, name):
    pairs = stores["ls_pairs" if name == "linestring" else "rs_pairs"]
    orders = [FULL, ("AA",)] if name == "april" else [None]
    for order in orders:
        kw = {} if order is None else {"order": order}
        got = _call(name, 1, stores, pairs, backend="cuda",
                    device=cuda_device, **kw)
        want = _call(name, 1, stores, pairs, backend="torch",
                     device=cuda_device, **kw)
        np.testing.assert_array_equal(got, want)
