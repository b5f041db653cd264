"""The port's RI filter held to the JAX package: the ALIGNEDAND plain
version against the Pallas kernel in interpret mode and its jnp oracle,
bit for bit; the RI store against the reference's numpy build, array for
array; the RI verdicts of every backend against the reference's batched
and per-pair filters, row for row; and the RI join in both pipeline modes
against the reference's staged numpy plan, pairs, order and counts. The
CUDA kernel itself runs only on the card (``cuda`` marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import rasterize as r_rasterize  # noqa: E402
from repro.core import ri as rri  # noqa: E402
from repro.core.intervalize import intervals_from_ids as r_ids  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.kernels.ri_and.ops import (batch_aligned_and,  # noqa: E402
                                      pack_bits_u32 as r_pack_bits_u32,
                                      xor_mask_words as r_xor_mask_words)
from repro.kernels.ri_and.ref import aligned_and_ref  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial.mbr_join import mbr_join as r_mbr_join  # noqa: E402

from repro_torch import JoinPlan, make_dataset  # noqa: E402
from repro_torch.core import geometry, rasterize, ri  # noqa: E402
from repro_torch.core.intervalize import intervals_from_ids  # noqa: E402
from repro_torch.kernels.ri_and import (  # noqa: E402
    aligned_and_plain, pack_bits_u32, pack_stream_words, ri_fragments_plain,
    ri_trichotomy, ri_trichotomy_plain, xor_mask_words)
from repro_torch.kernels.ri_and import cases as ri_cases  # noqa: E402
from repro_torch.kernels.ri_and.ref import MASK_WORDS, _unbiased  # noqa: E402
from repro_torch.spatial import fused  # noqa: E402
from repro_torch.spatial.filters import Approximation, get_filter  # noqa: E402

COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# ALIGNEDAND (B5's plain version)
# ---------------------------------------------------------------------------

def test_bit_packing_matches_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 32, 33, 1000):
        bits = (rng.random(n) < 0.4).astype(np.uint8)
        W = (n + 31) // 32 + 1
        np.testing.assert_array_equal(pack_bits_u32(bits, W),
                                      r_pack_bits_u32(bits, W))
        np.testing.assert_array_equal(pack_stream_words(bits),
                                      r_pack_bits_u32(bits, W))
    for W in (1, 3, 7):
        np.testing.assert_array_equal(xor_mask_words(W), r_xor_mask_words(W))
    np.testing.assert_array_equal(np.asarray(MASK_WORDS, np.uint32),
                                  r_xor_mask_words(3))


@pytest.mark.parametrize("xor", [0, 1])
@pytest.mark.parametrize("B,W,density", [(8, 2, 0.05), (24, 6, 0.08),
                                         (5, 16, 0.02), (12, 4, 0.5)])
def test_aligned_and_matches_pallas(B, W, density, xor):
    """The reference's kernel sweep: per-fragment words concatenated into
    one stream (global offset ``b*32*W + off``; the sweep keeps ``off +
    n_bits < 32*W``, so the kernel's circular roll never wraps)."""
    rng = np.random.default_rng(B + W)
    xw = np.zeros((B, W), np.uint32)
    yw = np.zeros((B, W), np.uint32)
    meta = np.zeros((B, 4), np.int32)
    for b in range(B):
        xw[b] = r_pack_bits_u32(
            (rng.random(32 * W) < density).astype(np.uint8), W)
        yw[b] = r_pack_bits_u32(
            (rng.random(32 * W) < density).astype(np.uint8), W)
        max_off = max(1, 32 * (W - 2))
        meta[b] = (int(rng.integers(0, max_off)),
                   int(rng.integers(0, max_off)),
                   int(rng.integers(1, 64)), xor)
    mask = r_xor_mask_words(W)
    want = np.asarray(batch_aligned_and(xw, yw, meta, mask, interpret=True))
    oracle = np.asarray(aligned_and_ref(jnp.asarray(xw), jnp.asarray(yw),
                                        meta, jnp.asarray(mask)))
    np.testing.assert_array_equal(want, oracle)
    base = 32 * W * np.arange(B)
    pad = np.zeros(1, np.uint32)
    got = aligned_and_plain(
        _t(np.concatenate([xw.ravel(), pad])), _t(base + meta[:, 0]),
        _t(np.concatenate([yw.ravel(), pad])), _t(base + meta[:, 1]),
        _t(meta[:, 2].astype(np.int64)), _t(meta[:, 3] != 0))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_aligned_and_long_runs_and_stream_end():
    """Runs of many words, at every bit phase, up to the stream's last bit
    (the funnel shift reads the pad word), against a bit-level oracle."""
    rng = np.random.default_rng(11)
    n = 3000
    xb = (rng.random(n) < 0.01).astype(np.uint8)
    yb = (rng.random(n) < 0.01).astype(np.uint8)
    F = 400
    nb = rng.integers(1, 700, F)
    xo = rng.integers(0, n - nb + 1)
    yo = rng.integers(0, n - nb + 1)
    nb[:3] = n - xo[:3]                    # runs that end at the last bit
    yo[:3] = n - nb[:3]
    mask = np.tile(np.asarray(rri.XOR_MASK, np.uint8), 1000)
    for xor in (False, True):
        want = np.asarray([
            bool(np.any(xb[a: a + k] & (yb[c: c + k] ^ (mask[:k] if xor
                                                           else 0))))
            for a, c, k in zip(xo, yo, nb)])
        got = aligned_and_plain(_t(pack_stream_words(xb)), _t(xo),
                                _t(pack_stream_words(yb)), _t(yo), _t(nb),
                                xor)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < F


# ---------------------------------------------------------------------------
# rows at the kernel's merge's edges (ri_and.cases, also the card sweep)
# ---------------------------------------------------------------------------

def _ref_store(side, encoding):
    """A drawn side as the reference's RIStore (order 16)."""
    return rri.RIStore(16, r_rasterize.GLOBAL_EXTENT, encoding, side["off"],
                       side["ints"], side["bit_off"], side["bits"])


def _drawn_ri(seed, rows, xor_y, cases=ri_cases.CASES):
    """Drawn rows as the reference's stores (one encoding when ``xor_y``)
    and the port's CPU store tensors."""
    d = ri_cases.draw_ri_rows(seed, rows, xor_y, cases=cases)
    ref = (_ref_store(d["x"], "R"), _ref_store(d["y"], "R" if xor_y else "S"))
    port = (ri_cases.store_tensors(d["x"]), ri_cases.store_tensors(d["y"]))
    return d, ref, port


@pytest.mark.parametrize("xor_y", [False, True])
@pytest.mark.parametrize("case", ri_cases.CASES)
def test_ri_tiling_edge_cases_match_reference(case, xor_y):
    """Rows drawn at the merge's edges, one case at a time, paired as drawn
    and shuffled: the wrapper on CPU tensors (the plain version)
    equals the reference's per-pair Algorithm 1 and, as drawn, the verdicts
    the codes were made to give."""
    rows = 24
    d, (rx, ry), (x, y) = _drawn_ri(61 + ri_cases.CASES.index(case), rows,
                                    xor_y, cases=(case,))
    own = np.arange(rows)
    shuffled = np.random.default_rng(4).permutation(rows)
    for si in (own, shuffled):
        want = np.asarray([rri.ri_verdict_pair(rx, i, ry, int(j))
                           for i, j in zip(own, si)], np.int8)
        got = ri_trichotomy(x, y, _t(own), _t(si), xor_y)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ri_trichotomy(x, y, _t(own), _t(own), xor_y).numpy(), d["verdict"])


def _case_fragments(x, y, rows):
    """The fragments of pair rows (n, n) and their word-aligned runs."""
    b, gx, gy, lo, hi = ri_fragments_plain(x, y, rows, rows)
    x_bit = x.bit_off[gx] + 3 * (lo - _unbiased(x.starts[gx]))
    y_bit = y.bit_off[gy] + 3 * (lo - _unbiased(y.starts[gy]))
    return b, gx, gy, lo, hi, x_bit, y_bit


@pytest.mark.parametrize("xor_y", [False, True])
def test_ri_case_fragments_match_pallas(xor_y):
    """Every fragment of the drawn rows (each case's first rows), ANDed by
    the plain ALIGNEDAND over the packed streams, equals the reference's
    Pallas kernel in interpret mode over its per-fragment words."""
    rows = 2 * len(ri_cases.CASES)
    d, (rx, ry), (x, y) = _drawn_ri(71, rows, xor_y)
    b, gx, gy, lo, hi, x_bit, y_bit = _case_fragments(x, y, torch.arange(rows))
    got = aligned_and_plain(x.words, x_bit, y.words, y_bit, 3 * (hi - lo),
                            xor_y)
    want = rri._fragment_hits_pallas(rx, ry, gx.numpy(), gy.numpy(),
                                     lo.numpy().astype(np.uint64),
                                     hi.numpy().astype(np.uint64), xor_y,
                                     interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)
    assert int((3 * (hi - lo)).max()) == 3 * ri_cases.LONG_CELLS


def test_ri_cases_cover_the_edges():
    """The drawn rows hold what the card sweep relies on: the widths at the
    strided skip's edges on both sides, fragment starts at every bit phase
    on both sides with runs of about one, two and three words, a 165-word
    fragment whose only hit is in its last word, a hit only in the last
    fragment of merges up to 2 x 5 strides - 1 fragments, lists the skip
    cuts by a stride or more, and runs at id 0 and 2^32 - 1."""
    G = ri_cases.STRIDE
    rows = 40 * len(ri_cases.CASES)
    d, _, (x, y) = _drawn_ri(17, rows, True)
    case = d["case"]
    for k in ("x", "y"):
        w = set(np.diff(d[k]["off"]).tolist())
        assert {G - 1, G, G + 1, 2 * G} <= w, k
        assert d[k]["ints"][:, 0].min() == 0, k
        assert d[k]["ints"][:, 1].max() == 2**32, k
    b, gx, gy, lo, hi, x_bit, y_bit = _case_fragments(x, y,
                                                      torch.arange(rows))
    nbits = 3 * (hi - lo)
    hits = aligned_and_plain(x.words, x_bit, y.words, y_bit, nbits, True)
    # phases: every bit phase of a fragment's start in each stream
    ph = case[b.numpy()] == ri_cases.CASES.index("phases")
    assert set(nbits[ph].tolist()) == {3 * c for c in ri_cases.FRAGMENT_CELLS}
    for bit in (x_bit, y_bit):
        assert set((bit[ph] % 32).tolist()) == set(range(32))
    # long: 165-word fragments, hit only in the last word or not at all
    lg = nbits == 3 * ri_cases.LONG_CELLS
    assert bool(((nbits[lg] + 31) // 32 == 165).all()) and int(lg.sum()) >= 2
    for f in np.nonzero(lg.numpy())[0]:
        upto = aligned_and_plain(x.words, x_bit[f:f + 1], y.words,
                                 y_bit[f:f + 1], torch.tensor([32 * 164]),
                                 True)
        assert not upto.any()
    assert hits[lg].any() and not hits[lg].all()
    # last_fragment: a TRUE_HIT row hits in its last fragment only
    lf = np.nonzero(case == ri_cases.CASES.index("last_fragment"))[0]
    longest = 0
    for r in lf:
        sel = np.nonzero(b.numpy() == r)[0]
        h = hits[sel].numpy()
        if d["verdict"][r] == 1:
            assert h[-1] and not h[:-1].any(), r
            longest = max(longest, len(sel))
    assert longest == 2 * 5 * G - 1
    # far: lists whose first intervals all end before the other list starts
    fr = np.nonzero(case == ri_cases.CASES.index("far"))[0]
    cut = 0
    for r in fr:
        xs, xl = (d["x"]["ints"][d["x"]["off"][r]:d["x"]["off"][r + 1], i]
                  for i in (0, 1))
        ys, yl = (d["y"]["ints"][d["y"]["off"][r]:d["y"]["off"][r + 1], i]
                  for i in (0, 1))
        cut += int(((xl <= ys[0]).sum() >= G) or ((yl <= xs[0]).sum() >= G))
    assert cut > len(fr) // 2
    assert set(np.unique(d["verdict"])) == {0, 1, 2}


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t1t2():
    """T1 x T2 (80 x 160): the reference datasets and the port's copies."""
    return (r_make_dataset("T1", seed=0, count=80),
            r_make_dataset("T2", seed=1, count=160),
            make_dataset("T1", seed=0, count=80),
            make_dataset("T2", seed=1, count=160))


@pytest.mark.parametrize("n_order", [8, 9])
@pytest.mark.parametrize("encoding", ["R", "S"])
def test_build_ri_is_store_identical(t1t2, n_order, encoding):
    R0, S0, R, S = t1t2
    for ref_ds, ds in ((R0, R), (S0, S)):
        want = rri.build_ri(ref_ds, n_order, encoding=encoding,
                            backend="numpy")
        got = ri.build_ri(ds, n_order, encoding=encoding)
        for k in ("off", "ints", "bit_off", "bits"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        assert got.encoding == encoding
        assert got.size_bytes() == want.size_bytes()
        # each object's intervals are the runs of its own cell ids
        for i in range(0, len(ds), 17):
            cells = [np.arange(s, e) for s, e in got.intervals(i)]
            ids = (np.concatenate(cells) if cells
                   else np.zeros(0, np.uint64)).astype(np.uint64)
            np.testing.assert_array_equal(intervals_from_ids(ids),
                                          r_ids(ids))
            np.testing.assert_array_equal(intervals_from_ids(ids),
                                          got.intervals(i))


def test_coverage_fractions_match_the_per_cell_clip(t1t2):
    """The batched coverage pass that labels Partial cells equals the
    reference's and the per-cell Sutherland–Hodgman clip, cell for cell."""
    R0, _, R, _ = t1t2
    p_off, cells = rasterize.dda_partial_cells_multi(R.verts[:24],
                                                     R.nverts[:24], 8)
    pid = np.repeat(np.arange(24), np.diff(p_off))
    got = rasterize.coverage_fractions_multi(R.verts, R.nverts, pid, cells, 8)
    want = r_rasterize.coverage_fractions_multi(R0.verts, R0.nverts, pid,
                                                cells, 8, backend="numpy")
    np.testing.assert_array_equal(got, want)
    h = rasterize.GLOBAL_EXTENT.cell_size(8)
    per_cell = []
    for p, (cx, cy) in zip(pid, cells):
        ring = geometry.clip_polygon_to_box(
            R.verts[p, : R.nverts[p]],
            (cx * h, cy * h, (cx + 1) * h, (cy + 1) * h))
        per_cell.append(geometry.polygon_area(ring) / (h * h)
                        if len(ring) >= 3 else 0.0)
    np.testing.assert_array_equal(got, np.clip(per_cell, 0.0, 1.0))
    assert 0 < (got > 0.5).sum() < len(got)


def test_build_ri_device_store(t1t2):
    _, _, R, _ = t1t2
    store = ri.build_ri(R, 8)
    X = ri.RIDeviceStore(store)
    x = X.to("cpu")
    assert X.to("cpu") is x
    assert [t.dtype for t in x] == [torch.int64, torch.int32, torch.int32,
                                    torch.int64, torch.uint32]
    np.testing.assert_array_equal(x.words.numpy(),
                                  r_pack_bits_u32(store.bits,
                                                  x.words.numel()))
    assert x.words[-1] == 0 and x.words.numel() == len(store.bits) // 32 + 2
    # the sequential build (ROADMAP A7, ported) equals the reference's
    R0 = t1t2[0]
    seq = ri.build_ri(R, 8, backend="sequential")
    want = rri.build_ri(R0, 8, backend="sequential")
    for k in ("off", "ints", "bit_off", "bits"):
        a, b = getattr(seq, k), getattr(want, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        np.testing.assert_array_equal(a, getattr(store, k))
    # ends as biased int32 inclusive lasts, APRIL's device layout
    np.testing.assert_array_equal(
        x.starts.numpy().view(np.uint32) ^ np.uint32(1 << 31),
        store.ints[:, 0])
    np.testing.assert_array_equal(
        x.lasts.numpy().view(np.uint32) ^ np.uint32(1 << 31),
        store.ints[:, 1] - 1)


# ---------------------------------------------------------------------------
# the verdicts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stores(t1t2):
    """Reference and port RI stores at n_order 9: R, S and an S-encoded R."""
    R0, S0, R, S = t1t2
    ref = {"R": rri.build_ri(R0, 9, encoding="R"),
           "S": rri.build_ri(S0, 9, encoding="S")}
    got = {"R": ri.build_ri(R, 9, encoding="R"),
           "S": ri.build_ri(S, 9, encoding="S")}
    frames = {"RxS": (r_mbr_join(R0.mbrs, S0.mbrs), "R", "S"),
              "RxR": (r_mbr_join(R0.mbrs, R0.mbrs), "R", "R")}
    return ref, got, frames


@pytest.mark.parametrize("frame", ["RxS", "RxR", "empty", "one"])
@pytest.mark.parametrize("backend", ["numpy", "torch", "sequential"])
def test_ri_trichotomy_rows_match_reference(stores, frame, backend):
    """Every backend equals the reference's batched numpy filter and its
    per-pair reference row for row; R x R shares one encoding, so Y is
    re-encoded by the XOR mask."""
    ref, got, frames = stores
    pairs, xs, ys = frames["RxS" if frame in ("empty", "one") else frame]
    if frame == "empty":
        pairs = pairs[:0]
    elif frame == "one":
        pairs = pairs[7:8]
    want = rri.ri_filter_batch(ref[xs], ref[ys], pairs, backend="numpy")
    seq = np.asarray([rri.ri_verdict_pair(ref[xs], int(i), ref[ys], int(j))
                      for i, j in pairs], np.int8).reshape(len(pairs))
    np.testing.assert_array_equal(want, seq)
    out = ri.ri_trichotomy_rows(got[xs], got[ys], pairs[:, 0], pairs[:, 1],
                                backend=backend, device="cpu")
    assert out.dtype == np.int8 and out.shape == (len(pairs),)
    np.testing.assert_array_equal(out, want)
    if frame in ("RxS", "RxR"):
        assert set(np.unique(want)) == {0, 1, 2}


def test_ri_wrapper_and_fragments_on_the_cpu(stores):
    """The wrapper runs the plain version for CPU tensors; the fragments
    of the plain version are the reference's, in its order."""
    ref, got, frames = stores
    pairs, _, _ = frames["RxS"]
    X, Y = (ri.RIDeviceStore(got[k]).to("cpu") for k in ("R", "S"))
    rows = (_t(pairs[:, 0]), _t(pairs[:, 1]))
    want = ri_trichotomy_plain(X, Y, *rows, False)
    np.testing.assert_array_equal(ri_trichotomy(X, Y, *rows, False).numpy(),
                                  want.numpy())
    b, gx, gy, lo, hi = ri_fragments_plain(X, Y, *rows)
    rb, _, rgx, rgy, rlo, rhi = rri._pair_fragments(ref["R"], ref["S"],
                                                    pairs)
    for a, c in ((b, rb), (gx, rgx), (gy, rgy), (lo, rlo), (hi, rhi)):
        np.testing.assert_array_equal(a.numpy(), c.astype(np.int64))
    with pytest.raises(IndexError, match="si"):
        ri_trichotomy(X, Y, rows[0][:1], _t(np.array([len(got["S"])])),
                      False)
    with pytest.raises(TypeError, match="words"):
        ri_trichotomy(X._replace(words=X.words.to(torch.int32)), Y, *rows,
                      False)
    with pytest.raises(ValueError, match="contiguous 1-D int64"):
        ri_trichotomy(X, Y, rows[0].to(torch.int32), rows[1], False)


def test_ri_status_lane(stores):
    ref, got, frames = stores
    pairs, _, _ = frames["RxS"]
    f = get_filter("ri")
    ar = Approximation("ri", got["R"], 9)
    as_ = Approximation("ri", got["S"], 9)
    want = rri.ri_filter_batch(ref["R"], ref["S"], pairs)
    for backend in ("torch", "numpy", "sequential"):
        lane = f.status_lane(ar, as_, pairs[:, 0], pairs[:, 1],
                             backend=backend, device="cpu")
        assert lane.dtype == torch.int8
        np.testing.assert_array_equal(lane.numpy(), want)
    empty = f.status_lane(ar, as_, pairs[:0, 0], pairs[:0, 1],
                          backend="torch", device="cpu")
    assert empty.shape == (0,) and empty.dtype == torch.int8
    with pytest.raises(IndexError, match="ri"):
        f.status_lane(ar, as_, np.array([len(got["R"])]), np.array([0]),
                      backend="torch", device="cpu")
    assert ar.meta["device_store"].to("cpu") is ar.meta["device_store"].to(
        "cpu")


# ---------------------------------------------------------------------------
# the join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,mbr_backend", [("staged", "numpy"),
                                              ("fused", "numpy"),
                                              ("fused", "torch")])
@pytest.mark.parametrize("filter_backend", ["torch", "numpy"])
def test_ri_join_matches_reference_staged(t1t2, mode, mbr_backend,
                                          filter_backend):
    R0, S0, R, S = t1t2
    ref, rst = RJoinPlan(R0, S0, filter="ri", n_order=8).build().execute(
        "intersects")
    plan = JoinPlan(R, S, filter="ri", n_order=8, device="cpu",
                    pipeline_mode=mode, mbr_backend=mbr_backend,
                    filter_backend=filter_backend).build()
    with ri.record_frames() as frames:
        got, st = plan.execute("intersects")
    assert len(ref) > 100
    np.testing.assert_array_equal(got, ref)
    for k in COUNTS:
        assert getattr(st, k) == getattr(rst, k), k
    assert st.approx_bytes == rst.approx_bytes
    assert len(frames) == (filter_backend == "torch")
    assert plan.approx_r.store.encoding == "R"
    assert plan.approx_s.store.encoding == "S"


def _order16_datasets():
    """Small rings at order 16 (cells of side 2^-16): stars around a point
    of the left half (Hilbert ids under 2^31), two of the right half (ids
    above 2^31) and the bottom-right corner, whose last cell (65535, 0)
    has id 2^32 - 1, with a square over that cell so an interval ends at
    2^32, and an L with a square in its notch. Reference datasets and the
    port's copies."""
    from repro.datagen.synthetic import PolygonDataset
    from repro_torch import state
    h = 2.0 ** -16
    rng = np.random.default_rng(16)
    centers = [(0.25, 0.3), (0.75, 0.6), (0.5 + 3 * h, 0.5 + 3 * h),
               (1 - 3 * h, 3 * h)]
    sides = ([], [])
    for cx, cy in centers:
        for side in sides:
            for _ in range(2):
                c = np.array([cx, cy]) + rng.uniform(-2, 2, 2) * h
                ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
                r = rng.uniform(1, 4) * h
                ring = c + r * np.stack([np.cos(ang), np.sin(ang)], 1)
                side.append(np.clip(ring, 1e-7, 1 - 1e-7))
    sides[0].append(np.array([[1 - 3 * h, 1e-7], [1 - 1e-7, 1e-7],
                              [1 - 1e-7, 3 * h], [1 - 3 * h, 3 * h]]))
    # an L and a square in its notch: MBRs overlap, no cell is shared
    o = np.array([0.625, 0.125])
    sides[0].append(o + h * np.array([[0, 0], [10, 0], [10, 2], [2, 2],
                                      [2, 10], [0, 10]]))
    sides[1].append(o + h * np.array([[6, 6], [9, 6], [9, 9], [6, 9]]))
    out = []
    for name, rings in zip(("R16", "S16"), sides):
        V = max(len(v) for v in rings)
        verts = np.zeros((len(rings), V, 2))
        nv = np.array([len(v) for v in rings], np.int64)
        for i, v in enumerate(rings):
            verts[i, : len(v)] = v
            verts[i, len(v):] = v[0]
        out.append((PolygonDataset(name=name, verts=verts, nverts=nv),
                    state.dataset_from_arrays(name, verts, nv)))
    return out


def test_ri_at_order_16_matches_reference():
    """At order 16 Hilbert ids use all 32 bits: the device store's biased
    int32 ends hold intervals above 2^31 and one that ends at 2^32. The
    torch backend's verdicts equal the reference's numpy filter, and the
    join staged and fused its staged numpy plan: pairs, order and
    counts."""
    (R0, R), (S0, S) = _order16_datasets()
    ref_r = rri.build_ri(R0, 16, encoding="R")
    ref_s = rri.build_ri(S0, 16, encoding="S")
    got_r = ri.build_ri(R, 16, encoding="R")
    got_s = ri.build_ri(S, 16, encoding="S")
    for a, b in ((got_r, ref_r), (got_s, ref_s)):
        for k in ("off", "ints", "bit_off", "bits"):
            assert getattr(a, k).tobytes() == getattr(b, k).tobytes(), k
    ends = np.concatenate([ref_r.ints[:, 1], ref_s.ints[:, 1]])
    assert ends.max() == 2 ** 32
    assert (np.concatenate([ref_r.ints[:, 0], ref_s.ints[:, 0]])
            > 2 ** 31).any()
    pairs = r_mbr_join(R0.mbrs, S0.mbrs)
    want = rri.ri_filter_batch(ref_r, ref_s, pairs, backend="numpy")
    assert set(np.unique(want)) == {0, 1, 2}
    got = ri.ri_trichotomy_rows(got_r, got_s, pairs[:, 0], pairs[:, 1],
                                backend="torch", device="cpu")
    np.testing.assert_array_equal(got, want)
    ref, rst = RJoinPlan(R0, S0, filter="ri", n_order=16).build().execute(
        "intersects")
    assert len(ref) > 0
    for mode in ("staged", "fused"):
        res, st = JoinPlan(R, S, filter="ri", n_order=16, device="cpu",
                           pipeline_mode=mode,
                           filter_backend="torch").build().execute(
            "intersects")
        np.testing.assert_array_equal(res, ref)
        for k in COUNTS:
            assert getattr(st, k) == getattr(rst, k), (mode, k)


def test_ri_fused_chain_records_its_frame(t1t2):
    """The fused status lane is the plain RI verdicts of the chain's own
    device frame under its valid lane."""
    _, _, R, S = t1t2
    plan = JoinPlan(R, S, filter="ri", n_order=8, device="cpu",
                    pipeline_mode="fused", mbr_backend="torch").build()
    with fused.record_chains() as chains, ri.record_frames() as frames:
        plan.execute("intersects")
    (cs,), ((x, y, rows_r, rows_s, xor_y),) = chains, frames
    assert rows_r is cs.ri_dev and rows_s is cs.si_dev and not xor_y
    want = ri_trichotomy_plain(x, y, rows_r, rows_s, xor_y)
    assert torch.equal(cs.status, torch.where(cs.valid, want, 0).to(
        torch.int8))


# ---------------------------------------------------------------------------
# the kernel, on the card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ri_kernel_equals_plain_version(stores, cuda_device):
    _, got, frames = stores
    rng = np.random.default_rng(2)
    for key in ("RxS", "RxR"):
        pairs, xs, ys = frames[key]
        for bits in (None, 0.02):
            sx, sy = got[xs], got[ys]
            if bits is not None:        # sparse random codes: long scans
                sx = ri.RIStore(sx.n_order, sx.extent, sx.encoding, sx.off,
                                sx.ints, sx.bit_off,
                                (rng.random(len(sx.bits)) < bits)
                                .astype(np.uint8))
            X, Y = (ri.RIDeviceStore(s).to(cuda_device) for s in (sx, sy))
            rows = (_t(pairs[:, 0]).to(cuda_device),
                    _t(pairs[:, 1]).to(cuda_device))
            xor_y = xs == ys
            k = ri_trichotomy(X, Y, *rows, xor_y)
            p = ri_trichotomy_plain(X, Y, *rows, xor_y)
            torch.cuda.synchronize()
            assert torch.equal(k, p), (key, bits)


@pytest.mark.cuda
def test_ri_kernel_at_tiling_edges_equals_plain_version(cuda_device):
    """Every case of ``ri_and.cases``, re-encoding off and on, paired as
    drawn and shuffled."""
    rows = 64 * len(ri_cases.CASES)
    for xor_y in (False, True):
        d = ri_cases.draw_ri_rows(5, rows, xor_y)
        x, y = (ri_cases.store_tensors(d[k], cuda_device) for k in "xy")
        own = torch.arange(rows, device=cuda_device)
        shuffled = torch.from_numpy(np.random.default_rng(5).permutation(
            rows)).to(cuda_device)
        for si in (own, shuffled):
            k = ri_trichotomy(x, y, own, si, xor_y)
            p = ri_trichotomy_plain(x, y, own, si, xor_y)
            torch.cuda.synchronize()
            assert torch.equal(k, p), xor_y
        assert np.array_equal(ri_trichotomy(x, y, own, own, xor_y).cpu()
                              .numpy(), d["verdict"])


@pytest.mark.cuda
def test_ri_kernel_at_order_16_equals_plain_version(cuda_device):
    """The kernel reads the biased int32 ends at order 16, where intervals
    lie above 2^31 and one ends at 2^32, as its plain version does."""
    (R0, R), (S0, S) = _order16_datasets()
    X, Y = (ri.RIDeviceStore(ri.build_ri(d, 16, encoding=e)).to(cuda_device)
            for d, e in ((R, "R"), (S, "S")))
    pairs = r_mbr_join(R0.mbrs, S0.mbrs)
    rows = (_t(pairs[:, 0]).to(cuda_device), _t(pairs[:, 1]).to(cuda_device))
    for xor_y in (False, True):
        k = ri_trichotomy(X, Y, *rows, xor_y)
        p = ri_trichotomy_plain(X, Y, *rows, xor_y)
        torch.cuda.synchronize()
        assert torch.equal(k, p), xor_y
