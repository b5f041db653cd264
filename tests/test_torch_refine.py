"""The port's refinement (``repro_torch.spatial.refine`` and the plain
version of its edge-sweep kernel) held to the JAX package: the sweep's
float32 lanes against the Pallas kernel in interpret mode on general-position
rows, and final verdicts against the reference's Pallas path and per-pair
oracle on T1 x T10, the boundary-touch fixtures and a snapped-vertex fuzz.
The CUDA kernel itself runs only on the card (``cuda`` marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import geometry as rgeometry  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen.synthetic import PolygonDataset  # noqa: E402
from repro.kernels.refine.ops import batch_edges_intersect  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import refine as rrefine  # noqa: E402

from repro_torch import state  # noqa: E402
from repro_torch.core import geometry  # noqa: E402
from repro_torch.datagen.fixtures import (  # noqa: E402
    CSHAPE, CSHAPE_INNER, SNAPPED_HOST, SNAPPED_TRI)
from repro_torch.kernels.refine import (  # noqa: E402
    edges_intersect, edges_intersect_csr, edges_intersect_csr_plain,
    edges_intersect_plain, pack_edges)
from repro_torch.spatial import refine  # noqa: E402

#: pairs that go through the reference's Pallas path in interpret mode
PALLAS_PAIRS = 64


def _carry(D):
    return state.dataset_from_arrays(D.name, D.verts, D.nverts)


def _ds(verts_list):
    """A reference dataset and the port's copy of it over the given rings."""
    V = max(len(v) for v in verts_list)
    verts = np.zeros((len(verts_list), V, 2))
    nv = np.zeros(len(verts_list), np.int64)
    for i, v in enumerate(verts_list):
        verts[i, : len(v)] = v
        nv[i] = len(v)
    return (PolygonDataset(name="fixture", verts=verts, nverts=nv),
            state.dataset_from_arrays("fixture", verts, nv))


def _diag(n):
    return np.stack([np.arange(n), np.arange(n)], axis=1)


# ---------------------------------------------------------------------------
# the sweep's lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Ea,Eb,seed", [(5, 7, 9, 0), (12, 30, 24, 1),
                                          (3, 140, 5, 2), (9, 1, 200, 3)])
def test_plain_sweep_lanes_match_pallas(B, Ea, Eb, seed):
    """General-position random rows, ragged masks: (hit, unc) of the plain
    version equal the Pallas kernel's bit for bit."""
    rng = np.random.default_rng(seed)
    a0, a1 = rng.uniform(0.2, 0.8, (2, B, Ea, 2))
    b0, b1 = rng.uniform(0.2, 0.8, (2, B, Eb, 2))
    am = rng.random((B, Ea)) < 0.8
    bm = rng.random((B, Eb)) < 0.8
    b0[0] = b1[0] = 5.0                     # a row that cannot cross
    want_h, want_u = (np.asarray(x) for x in batch_edges_intersect(
        a0, a1, am, b0, b1, bm, interpret=True))
    got_h, got_u = edges_intersect_plain(*(torch.from_numpy(x) for x in
                                           (a0, a1, am, b0, b1, bm)))
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert not want_h[0] and want_h.any()


@pytest.mark.parametrize("B,Ea,Eb,seed", [(5, 7, 9, 4), (12, 30, 24, 5),
                                          (3, 140, 5, 6), (9, 1, 200, 7)])
def test_csr_sweep_lanes_match_pallas(B, Ea, Eb, seed):
    """The ragged plain version over padded rows packed into CSR (rows
    with no kept edge on one side or both among them) equals the Pallas
    kernel's lanes on the padded rows bit for bit, and the padded wrapper,
    which packs and calls it, too."""
    rng = np.random.default_rng(seed)
    a0, a1 = rng.uniform(0.2, 0.8, (2, B, Ea, 2))
    b0, b1 = rng.uniform(0.2, 0.8, (2, B, Eb, 2))
    am = rng.random((B, Ea)) < 0.7
    bm = rng.random((B, Eb)) < 0.7
    am[1 % B] = False
    bm[2 % B] = False
    am[0] = bm[0] = False
    want_h, want_u = (np.asarray(x) for x in batch_edges_intersect(
        a0, a1, am, b0, b1, bm, interpret=True))
    t = [torch.from_numpy(x) for x in (a0, a1, am, b0, b1, bm)]
    csr = pack_edges(*t[:3]) + pack_edges(*t[3:])
    assert csr[2].tolist() == [0] + np.cumsum(am.sum(1)).tolist()
    got_h, got_u = edges_intersect_csr_plain(*csr)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert not (got_h[0] or got_u[0] or got_h[1 % B] or got_h[2 % B])
    wh, wu = edges_intersect(*t)
    assert torch.equal(wh, got_h) and torch.equal(wu, got_u)


def test_sweep_guard_band_flags_touching_edges():
    """Edges that meet at a shared vertex or lie on one line trip the band
    (``unc``) instead of counting as a definite crossing."""
    a0 = torch.tensor([[[0.0, 0.0]], [[0.0, 0.0]], [[0.0, 0.0]]])
    a1 = torch.tensor([[[1.0, 1.0]], [[1.0, 0.0]], [[1.0, 1.0]]])
    b0 = torch.tensor([[[1.0, 1.0]], [[0.5, 0.0]], [[0.0, 1.0]]])
    b1 = torch.tensor([[[2.0, 0.0]], [[2.0, 0.0]], [[1.0, 0.0]]])
    m = torch.ones(3, 1, dtype=torch.bool)
    hit, unc = edges_intersect(a0, a1, m, b0, b1, m)
    assert hit.tolist() == [False, False, True]
    assert unc.tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# final verdicts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def t1t10():
    R = r_make_dataset("T1", seed=31, count=80)
    S = r_make_dataset("T10", seed=32, count=50)
    pairs = RJoinPlan(R, S, filter="none").candidates("intersects")
    return R, S, _carry(R), _carry(S), pairs


def test_refine_matches_reference_and_oracle(t1t10):
    R, S, Rt, St, pairs = t1t10
    want = rrefine.refine_pairs_seq(R, S, pairs)
    assert want.sum() > 0 and (~want).sum() > 0
    for backend in ("torch", "numpy", "sequential"):
        got = refine.refine_pairs(Rt, St, pairs, backend=backend,
                                  device="cpu")
        np.testing.assert_array_equal(got, want, err_msg=backend)
    np.testing.assert_array_equal(
        refine.refine_pairs_seq(Rt, St, pairs), want)
    head = pairs[:PALLAS_PAIRS]
    np.testing.assert_array_equal(
        refine.refine_pairs(Rt, St, head, backend="torch", device="cpu"),
        rrefine.refine_pairs(R, S, head, backend="pallas"))


def test_refine_without_cmbr_pruning(t1t10):
    R, S, Rt, St, pairs = t1t10
    np.testing.assert_array_equal(
        refine.refine_pairs(Rt, St, pairs, use_cmbr=False, backend="torch",
                            device="cpu"),
        rrefine.refine_pairs(R, S, pairs, use_cmbr=False, backend="numpy"))


def test_record_sweeps_collects_each_bucket(t1t10):
    """A refine call over several vertex-count buckets makes one sweep
    call: the one recorded CSR input covers every pair once, replays to
    sweep lanes whose definite hits the join reports, and recording ends
    with the block."""
    R, S, Rt, St, pairs = t1t10
    nvr, nvs = Rt.nverts[pairs[:, 0]], St.nverts[pairs[:, 1]]
    assert len(refine._buckets(nvr, nvs)) > 1
    with refine.record_sweeps() as log:
        got = refine.refine_pairs(Rt, St, pairs, backend="torch",
                                  device="cpu")
    assert len(log) == 1
    a0, a1, a_off, b0, b1, b_off = log[0]
    assert a_off.numel() == b_off.numel() == len(pairs) + 1
    assert int(a_off[-1]) == len(a0) == len(a1)
    assert int(b_off[-1]) == len(b0) == len(b1)
    hit, unc = edges_intersect_csr_plain(*log[0])
    assert 0 < int((hit & ~unc).sum()) <= int(got.sum())
    refine.refine_pairs(Rt, St, pairs[:4], backend="torch", device="cpu")
    assert len(log) == 1


def test_touchy_geometry():
    """Shared-vertex, collinear-shared-edge, on-edge and containment
    contacts."""
    sq = np.array([[0., 0.], [4., 0.], [4., 4.], [0., 4.]])
    R, Rt = _ds([
        sq + np.array([4.0, 0.0]), sq + np.array([4.0, 4.0]),
        np.array([[2., 4.], [3., 3.], [1., 3.]]),
        np.array([[1., 1.], [3., 1.], [2., 3.]]),
        sq, sq + np.array([10., 10.]),
        np.array([[-1., -1.], [5., -1.], [5., 5.], [-1., 5.]])])
    S, St = _ds([sq] * 7)
    pairs = _diag(7)
    want = rrefine.refine_pairs_seq(R, S, pairs)
    np.testing.assert_array_equal(
        want, [True, True, True, True, True, False, True])
    np.testing.assert_array_equal(
        rrefine.refine_pairs(R, S, pairs, backend="pallas"), want)
    for backend in ("torch", "numpy", "sequential"):
        np.testing.assert_array_equal(
            refine.refine_pairs(Rt, St, pairs, backend=backend,
                                device="cpu"), want, err_msg=backend)


@pytest.mark.parametrize("fixture", ["snapped", "cshape"])
def test_regression_fixtures(fixture):
    """The snapped-vertex triangle touching its host's diagonal, and a
    triangle touching the inside of a C-shaped ring."""
    a, b = ((SNAPPED_TRI, SNAPPED_HOST) if fixture == "snapped"
            else (CSHAPE_INNER, CSHAPE))
    (R, Rt), (S, St) = _ds([a]), _ds([b])
    pairs = _diag(1)
    assert rgeometry.polygons_intersect(a, len(a), b, len(b))
    assert geometry.polygons_intersect(a, len(a), b, len(b))
    want = rrefine.refine_pairs(R, S, pairs, backend="pallas")
    np.testing.assert_array_equal(want, [True])
    for backend in ("torch", "numpy", "sequential"):
        np.testing.assert_array_equal(
            refine.refine_pairs(Rt, St, pairs, backend=backend,
                                device="cpu"), want, err_msg=backend)


@pytest.mark.parametrize("seed", [19, 20])
def test_snapped_vertex_fuzz(seed):
    """Tiny near-touching rings at O(1) coordinates, half of them with a
    vertex snapped onto an edge: the float32 sweep must send the borderline
    pairs to the float64 re-check."""
    rng = np.random.default_rng(seed)

    def star(c, r, nv):
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)

    polys_r, polys_s = [], []
    for i in range(24):
        c = rng.uniform(0.3, 0.7, 2)
        r1, r2 = rng.uniform(2e-5, 8e-5, 2)
        ps = star(c, r1, 8)
        pr = star(c + rng.uniform(-1, 1, 2) * (r1 + r2) * 0.8, r2, 7)
        if i % 2 == 0:
            pr[0] = ps[0] + rng.uniform(0, 1) * (ps[1] - ps[0])
        polys_r.append(pr)
        polys_s.append(ps)
    (R, Rt), (S, St) = _ds(polys_r), _ds(polys_s)
    pairs = _diag(len(polys_r))
    want = rrefine.refine_pairs_seq(R, S, pairs)
    np.testing.assert_array_equal(
        rrefine.refine_pairs(R, S, pairs, backend="pallas"), want)
    np.testing.assert_array_equal(
        refine.refine_pairs(Rt, St, pairs, backend="torch", device="cpu"),
        want)


def test_refine_backend_checks(t1t10):
    R, S, Rt, St, pairs = t1t10
    with pytest.raises(ValueError, match="CUDA device"):
        refine.refine_pairs(Rt, St, pairs, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="refine backend"):
        refine.refine_pairs(Rt, St, pairs, backend="pallas")
    # linestring refines the r rings as open chains, as the reference does
    np.testing.assert_array_equal(
        refine.refine(Rt, St, pairs, predicate="linestring", device="cpu"),
        rrefine.refine(R, S, pairs, predicate="linestring",
                       backend="numpy"))
    assert refine.refine_pairs(Rt, St, np.zeros((0, 2), np.int64),
                               backend="torch", device="cpu").shape == (0,)


# ---------------------------------------------------------------------------
# the CUDA kernel, on the card only
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sweep_equals_plain_version(cuda_device, t1t10):
    R, S, Rt, St, pairs = t1t10
    a0, a1, am = geometry.polygon_edges(Rt.verts[pairs[:, 0]],
                                        Rt.nverts[pairs[:, 0]])
    b0, b1, bm = geometry.polygon_edges(St.verts[pairs[:, 1]],
                                        St.nverts[pairs[:, 1]])
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
         for x in (a0, a1, am, b0, b1, bm)]
    n0 = edges_intersect_csr.launches
    kh, ku = edges_intersect(*t)
    assert edges_intersect_csr.launches == n0 + 1
    ph, pu = edges_intersect_plain(*t)
    assert torch.equal(kh, ph) and torch.equal(ku, pu)
    # rows over the warp's couple limit go to the whole block; rows with
    # no kept edge give False/False
    rng = np.random.default_rng(8)
    big = [torch.from_numpy(x).to(cuda_device) for x in (
        *rng.uniform(0.2, 0.8, (2, 6, 300, 2)), rng.random((6, 300)) < 0.9,
        *rng.uniform(0.2, 0.8, (2, 6, 200, 2)), rng.random((6, 200)) < 0.9)]
    big[2][1] = False
    csr = pack_edges(*big[:3]) + pack_edges(*big[3:])
    kh, ku = edges_intersect_csr(*csr)
    ph, pu = edges_intersect_csr_plain(*csr)
    assert torch.equal(kh, ph) and torch.equal(ku, pu)
    assert not (kh[1] or ku[1])
    np.testing.assert_array_equal(
        refine.refine_pairs(Rt, St, pairs, backend="cuda",
                            device=cuda_device),
        rrefine.refine_pairs_seq(R, S, pairs))
