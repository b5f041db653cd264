"""The port's APRIL trichotomy (``repro_torch.core.join`` and the plain
versions of its interval-join kernels) held to the JAX package exactly:
the Pallas kernels in interpret mode on packed arrays, the staged drivers
on T1 x T2 stores, and a hypothesis property over stores with F inside A.
The CUDA kernels themselves run only on the card (``cuda`` marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import join as rjoin  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.kernels.interval_join.ops import (  # noqa: E402
    batch_april_trichotomy, batch_interval_overlap)
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402

from repro_torch import state  # noqa: E402
from repro_torch.core import join as tjoin  # noqa: E402
from repro_torch.kernels.interval_join import (  # noqa: E402
    CSRLists, april_trichotomy, april_trichotomy_plain, interval_overlap,
    interval_overlap_plain)
from repro_torch.kernels.interval_join.cases import (  # noqa: E402
    CASES, SPECIAL_WIDTHS, U32_TOP, WINDOW_SPANS, draw_pair_rows)

ORDERS = [("AA", "AF", "FA"), ("FA", "AA", "AF"), ("AF", "FA", "AA"),
          ("AA", "AF"), ("AA", "FA"), ("AA",)]


def _random_csr(rng, rows, max_w):
    """Sorted disjoint biased-int32 inclusive-last lists, empty rows
    included, in a narrow id range so that lists of different rows meet."""
    cnt = rng.integers(0, max_w + 1, rows)
    cnt[rng.random(rows) < 0.15] = 0
    starts, lasts = [], []
    for c in cnt:
        p = np.sort(rng.choice(40 * max_w + 64, size=2 * c, replace=False))
        starts.append(p[0::2])
        lasts.append(p[1::2] - 1)
    off = np.zeros(rows + 1, np.int64)
    off[1:] = np.cumsum(cnt)
    base = np.int64(-2**31 + 7)          # small u32 ids, biased
    cat = lambda xs: (np.concatenate(xs) + base).astype(np.int32)
    return off, cat(starts), cat(lasts)


def _both(off, s, l):
    """The same lists as the reference's IntervalLists and the port's."""
    return (rjoin.IntervalLists(off, s, l),
            tjoin.IntervalLists(off, s, l))


@pytest.mark.parametrize("rows,wa,wf,seed", [
    (24, 5, 3, 0), (40, 17, 9, 1), (16, 70, 40, 2), (8, 300, 120, 3)])
def test_plain_trichotomy_and_overlap_match_pallas(rows, wa, wf, seed):
    """On packed arrays the Pallas kernels (interpret mode) and the port's
    plain versions over the same CSR lists agree row for row, for A and F
    drawn independently (F not inside A) and lists wider than 256."""
    rng = np.random.default_rng(seed)
    sides = [_both(*_random_csr(rng, rows, w)) for w in (wa, wf, wa, wf)]
    n = 3 * rows
    ri = rng.integers(0, rows, n)
    si = rng.integers(0, rows, n)
    (xa_r, xa_t), (xf_r, xf_t), (ya_r, ya_t), (yf_r, yf_t) = sides

    packed = []
    for L, idx in ((xa_r, ri), (xf_r, ri), (ya_r, si), (yf_r, si)):
        w = max(1, int(L.counts(idx).max()))
        packed.extend(L.pack(idx, w))
    want = batch_april_trichotomy(*packed, interpret=True)
    lists = [L.to("cpu") for L in (xa_t, xf_t, ya_t, yf_t)]
    rows_t = torch.from_numpy(ri), torch.from_numpy(si)
    got = april_trichotomy_plain(*lists, *rows_t)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert {0, 1} <= set(np.unique(want).tolist())

    xs, xl, nx = xa_r.pack(ri, max(1, int(xa_r.counts(ri).max())))
    ys, yl, ny = ya_r.pack(si, max(1, int(ya_r.counts(si).max())))
    want_ov = np.asarray(batch_interval_overlap(xs, xl, nx, ys, yl, ny,
                                                interpret=True))
    got_ov = interval_overlap_plain(lists[0], lists[2], *rows_t)
    np.testing.assert_array_equal(got_ov.numpy(), want_ov)


# ---------------------------------------------------------------------------
# the window tiling's edges (kernels.interval_join.cases, also the card sweep)
# ---------------------------------------------------------------------------

def _drawn(seed, rows, **kw):
    """Rows drawn by ``draw_pair_rows`` as the reference's IntervalLists
    and the port's CPU lists, and the pair rows (n, n)."""
    d = draw_pair_rows(seed, rows, **kw)
    ref = {k: rjoin.IntervalLists(*d[k]) for k in ("xa", "xf", "ya", "yf")}
    port = {k: tjoin.IntervalLists(*d[k]).to("cpu") for k in ref}
    return d, ref, port, np.arange(rows)


def _pallas_equals_plain(ref, port, ri, si):
    """The Pallas kernels (interpret mode) and the plain versions agree row
    for row: the trichotomy, and the overlap of each join B1 runs."""
    packed = []
    for k, idx in (("xa", ri), ("xf", ri), ("ya", si), ("yf", si)):
        packed.extend(ref[k].pack(idx, max(1, int(ref[k].counts(idx).max()))))
    rows_t = torch.from_numpy(ri), torch.from_numpy(si)
    want = batch_april_trichotomy(*packed, interpret=True)
    got = april_trichotomy_plain(port["xa"], port["xf"], port["ya"],
                                 port["yf"], *rows_t)
    np.testing.assert_array_equal(got.numpy(), want)
    for x, y in (("xa", "ya"), ("xa", "yf"), ("xf", "ya")):
        xs, xl, nx = ref[x].pack(ri, max(1, int(ref[x].counts(ri).max())))
        ys, yl, ny = ref[y].pack(si, max(1, int(ref[y].counts(si).max())))
        want_ov = np.asarray(batch_interval_overlap(xs, xl, nx, ys, yl, ny,
                                                    interpret=True))
        got_ov = interval_overlap_plain(port[x], port[y], *rows_t)
        np.testing.assert_array_equal(got_ov.numpy(), want_ov,
                                      err_msg=f"{x} x {y}")
    return want


@pytest.mark.parametrize("case", CASES)
def test_tiling_edge_cases_match_pallas(case):
    """Rows drawn at the window tiling's edges, one case at a time, paired
    as drawn and shuffled: the plain versions equal the Pallas kernels."""
    rows = 48
    d, ref, port, own = _drawn(31 + CASES.index(case), rows, cases=(case,))
    shuffled = np.random.default_rng(3).permutation(rows)
    verdicts = np.concatenate([_pallas_equals_plain(ref, port, own, own),
                               _pallas_equals_plain(ref, port, own, shuffled)])
    if case == "gaps":
        assert not verdicts[:rows].any()         # gaps never overlap
    if case == "touching":
        assert verdicts[:rows].all()             # they meet at one id


@pytest.mark.parametrize("span", WINDOW_SPANS)
def test_group_boundary_widths_match_pallas(span):
    """Lists of W - 1, W, W + 1 and 2W + 1 intervals for a span W of one,
    two or four windows, every case."""
    widths = (span - 1, span, span + 1, 2 * span + 1)
    d, ref, port, own = _drawn(41 + span, 56, widths=widths)
    _pallas_equals_plain(ref, port, own, own)
    w = np.diff(d["xa"][0])
    assert set(widths) <= set(w.tolist()) | {0}


def test_tiling_cases_cover_the_edges():
    """The drawn rows hold what the card sweep relies on: every special
    width on both sides, ends at INT32_MIN and INT32_MAX, y starts equal to
    x lasts, empty rows, and F outside A only where drawn so."""
    d = draw_pair_rows(17, 7 * 200)
    for k in ("xa", "ya"):
        w = set(np.diff(d[k][0]).tolist())
        assert set(SPECIAL_WIDTHS) <= w, k
        assert (d[k][1] == np.iinfo(np.int32).min).any(), k
        assert (d[k][2] == np.iinfo(np.int32).max).any(), k
    assert U32_TOP - 2**31 == np.iinfo(np.int32).max
    touch = 0
    for n in np.nonzero(d["case"] == CASES.index("touching"))[0]:
        sl = lambda k, i: slice(d[k][0][n], d[k][0][n + 1])
        xs, xl = d["xa"][1][sl("xa", n)], d["xa"][2][sl("xa", n)]
        ys, yl = d["ya"][1][sl("ya", n)], d["ya"][2][sl("ya", n)]
        touch += bool(np.isin(ys, xl).any() or np.isin(xs, yl).any())
    assert touch == (d["case"] == CASES.index("touching")).sum()
    ref = {k: rjoin.IntervalLists(*d[k]) for k in ("xa", "xf", "ya", "yf")}
    outside = 0
    for a, f in (("xa", "xf"), ("ya", "yf")):
        for n in range(len(d["case"])):
            fs = ref[f].starts[ref[f].off[n]:ref[f].off[n + 1]]
            fl = ref[f].lasts[ref[f].off[n]:ref[f].off[n + 1]]
            as_ = ref[a].starts[ref[a].off[n]:ref[a].off[n + 1]]
            al = ref[a].lasts[ref[a].off[n]:ref[a].off[n + 1]]
            k = np.searchsorted(al, fs)
            inside = (k < len(al)) & (as_[np.minimum(k, len(al) - 1)] <= fs) \
                & (fl <= al[np.minimum(k, len(al) - 1)]) if len(al) else \
                np.zeros(len(fs), bool)
            if d["case"][n] != CASES.index("f_outside_a"):
                assert inside.all(), (a, n)
            outside += not inside.all()
    assert outside > 100
    assert (np.diff(d["xa"][0]) == 0).any()
    assert (np.diff(d["yf"][0]) == 0).any()


def test_wrappers_run_plain_versions_on_cpu():
    """On CPU tensors the wrappers return the plain versions' result and
    launch nothing."""
    rng = np.random.default_rng(11)
    L = [tjoin.IntervalLists(*_random_csr(rng, 12, 6)).to("cpu")
         for _ in range(4)]
    ri = torch.from_numpy(rng.integers(0, 12, 50))
    si = torch.from_numpy(rng.integers(0, 12, 50))
    before = (april_trichotomy.launches, interval_overlap.launches)
    assert torch.equal(april_trichotomy(*L, ri, si),
                       april_trichotomy_plain(*L, ri, si))
    assert torch.equal(interval_overlap(L[0], L[2], ri, si),
                       interval_overlap_plain(L[0], L[2], ri, si))
    assert (april_trichotomy.launches, interval_overlap.launches) == before
    with pytest.raises(IndexError):
        april_trichotomy(*L, ri + 12, si)
    with pytest.raises(ValueError):
        interval_overlap(L[0], L[2], ri.to(torch.int32), si)


def test_empty_store_uses_a_sentinel():
    """A store without intervals uploads one sentinel slot, and every row
    of it is TRUE_NEG (empty A) or has a false F join (empty F)."""
    empty = tjoin.IntervalLists.from_intervals(np.zeros(4, np.int64),
                                               np.zeros((0, 2), np.uint64))
    dev = empty.to("cpu")
    assert dev.starts.numel() == 1 and dev.off.tolist() == [0, 0, 0, 0]
    assert empty.to("cpu") is dev
    rng = np.random.default_rng(5)
    full = tjoin.IntervalLists(*_random_csr(rng, 3, 4))
    ri = np.repeat(np.arange(3), 3)
    si = np.tile(np.arange(3), 3)
    for backend in ("numpy", "torch", "sequential"):
        got = tjoin.april_trichotomy_rows(full, empty, full, empty, ri, si,
                                          backend=backend, device="cpu")
        want = np.where(tjoin.overlap_rows_np(full, ri, full, si),
                        tjoin.INDECISIVE, tjoin.TRUE_NEG)
        np.testing.assert_array_equal(got, want, err_msg=backend)
        got = tjoin.april_trichotomy_rows(empty, full, full, full, ri, si,
                                          backend=backend, device="cpu")
        np.testing.assert_array_equal(got, np.zeros(9, np.int8))


# ---------------------------------------------------------------------------
# staged drivers on real stores carried across with state.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t1t2():
    R = r_make_dataset("T1", seed=0, count=80)
    S = r_make_dataset("T2", seed=1, count=160)
    plan = RJoinPlan(R, S, filter="april", n_order=8).build()
    pairs = plan.candidates("intersects")
    carried = []
    for a in (plan.approx_r, plan.approx_s):
        st_ = a.store
        carried.append(state.april_store_from_arrays(
            st_.n_order, st_.extent, st_.a_off, st_.a_ints, st_.f_off,
            st_.f_ints))

    def lists(store, lib):
        return (lib.IntervalLists.from_intervals(store.a_off, store.a_ints),
                lib.IntervalLists.from_intervals(store.f_off, store.f_ints))
    ref = (*lists(plan.approx_r.store, rjoin),
           *lists(plan.approx_s.store, rjoin))
    port = (*lists(carried[0], tjoin), *lists(carried[1], tjoin))
    return pairs, ref, port


@pytest.mark.parametrize("order", ORDERS, ids=lambda o: "-".join(o))
def test_trichotomy_rows_match_reference(t1t2, order):
    pairs, ref, port = t1t2
    ri, si = pairs[:, 0], pairs[:, 1]
    want = rjoin.april_trichotomy_rows(*ref, ri, si, backend="numpy",
                                       order=order)
    assert len(want) > 200
    assert set(np.unique(want)) == ({0, 2} if order == ("AA",)
                                    else {0, 1, 2})
    for backend in ("torch", "numpy"):
        got = tjoin.april_trichotomy_rows(*port, ri, si, backend=backend,
                                          order=order, device="cpu")
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want, err_msg=backend)


def test_trichotomy_rows_match_pallas_and_sequential(t1t2):
    """The reference's Pallas path (interpret mode off the TPU) and the
    per-pair loops of both packages give the port's verdicts."""
    pairs, ref, port = t1t2
    ri, si = pairs[:400, 0], pairs[:400, 1]
    want = rjoin.april_trichotomy_rows(*ref, ri, si, backend="pallas")
    got = tjoin.april_trichotomy_rows(*port, ri, si, backend="torch",
                                      device="cpu")
    np.testing.assert_array_equal(got, want)
    seq = tjoin.april_trichotomy_rows(*port, ri, si, backend="sequential")
    np.testing.assert_array_equal(seq, want)


def test_backend_and_device_checks(t1t2):
    pairs, _, port = t1t2
    ri, si = pairs[:4, 0], pairs[:4, 1]
    with pytest.raises(ValueError, match="CUDA device"):
        tjoin.april_trichotomy_rows(*port, ri, si, backend="cuda",
                                    device="cpu")
    with pytest.raises(ValueError, match="filter backend"):
        tjoin.april_trichotomy_rows(*port, ri, si, backend="pallas")
    with pytest.raises(ValueError, match="AA"):
        tjoin.april_trichotomy_rows(*port, ri, si, backend="torch",
                                    order=("AF", "FA"), device="cpu")


# ---------------------------------------------------------------------------
# property: stores with F inside A, any join order
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


@given(april_stores(3), april_stores(3), st.permutations(["AA", "AF", "FA"]))
@settings(max_examples=40, deadline=None)
def test_trichotomy_property_f_inside_a(sr, ss, order):
    """With F inside A every backend equals the reference's per-pair
    Algorithm 2 for every order, empty and single-interval lists
    included."""
    order = tuple(order)
    ri, si = (g.ravel() for g in np.meshgrid(np.arange(len(sr)),
                                             np.arange(len(ss)),
                                             indexing="ij"))
    want = np.asarray([rjoin.april_verdict_pair(
        sr.a_list(i), sr.f_list(i), ss.a_list(j), ss.f_list(j), order=order)
        for i, j in zip(ri, si)], np.int8)
    lists = [tjoin.IntervalLists.from_intervals(o, x) for o, x in
             ((sr.a_off, sr.a_ints), (sr.f_off, sr.f_ints),
              (ss.a_off, ss.a_ints), (ss.f_off, ss.f_ints))]
    for backend in ("torch", "numpy", "sequential"):
        got = tjoin.april_trichotomy_rows(*lists, ri, si, backend=backend,
                                          order=order, device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
    # the kernel's plain version evaluates all three joins AA-first
    t = [L.to("cpu") for L in lists]
    fused = april_trichotomy_plain(*t, torch.from_numpy(ri),
                                   torch.from_numpy(si))
    np.testing.assert_array_equal(fused.numpy(), want)


# ---------------------------------------------------------------------------
# the CUDA kernels, on the card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_equal_plain_versions_at_tiling_edges(cuda_device, case):
    """The kernels equal the plain versions on the rows the CPU tests hold
    to the Pallas kernels."""
    d = draw_pair_rows(31 + CASES.index(case), 480, cases=(case,))
    L = {k: CSRLists(*(torch.from_numpy(a).to(cuda_device) for a in d[k]))
         for k in ("xa", "xf", "ya", "yf")}
    own = torch.arange(480, device=cuda_device)
    tri = (L["xa"], L["xf"], L["ya"], L["yf"])
    assert torch.equal(april_trichotomy(*tri, own, own),
                       april_trichotomy_plain(*tri, own, own))
    for x, y in (("xa", "ya"), ("xa", "yf"), ("xf", "ya")):
        assert torch.equal(
            interval_overlap(L[x], L[y], own, own),
            interval_overlap_plain(L[x], L[y], own, own))


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions(cuda_device):
    rng = np.random.default_rng(21)
    L = [tjoin.IntervalLists(*_random_csr(rng, 64, w)).to(cuda_device)
         for w in (300, 40, 120, 30)]
    ri = torch.from_numpy(rng.integers(0, 64, 4096)).to(cuda_device)
    si = torch.from_numpy(rng.integers(0, 64, 4096)).to(cuda_device)
    n0 = april_trichotomy.launches
    got = april_trichotomy(*L, ri, si)
    assert april_trichotomy.launches == n0 + 1
    assert torch.equal(got, april_trichotomy_plain(*L, ri, si))
    assert torch.equal(interval_overlap(L[0], L[2], ri, si),
                       interval_overlap_plain(L[0], L[2], ri, si))
    assert isinstance(L[0], CSRLists)
