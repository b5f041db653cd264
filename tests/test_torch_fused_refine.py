"""The fused refine kernel (B7, ``csrc/fused_refine.cu``) against its plain
version, the eager chunk loop of ``refine.fused_refine_lanes``.

The card cases hold the kernel's (res, unc) lanes to the eager cores' bit
for bit, for the intersects, within and line cores, on the fused tests'
inputs, the boundary fixtures, random stars, the benchmark's slivers, rings
wide enough for the block path and prefixes of 0, 1 and N rows; and run a
fused join with no host sync before its gather. The CPU cases hold the
dispatch and the counters. No JAX here: the card machine has none.
"""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import make_dataset, make_linestrings, state
from repro_torch.datagen import fixtures
from repro_torch.kernels.compact import compact_mask_plain
from repro_torch.kernels.fused_refine import fused_refine_rows
from repro_torch.spatial import JoinPlan, fused
from repro_torch.spatial import refine as RF
from repro_torch.spatial.mbr_join import mbr_join

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("intersects", "within", "linestring")


def _ds(rings, name):
    V = max(len(v) for v in rings)
    verts = np.zeros((len(rings), V, 2))
    for i, v in enumerate(rings):
        verts[i, :len(v)] = v
    return state.dataset_from_arrays(name, verts, [len(v) for v in rings])


def _star(rng, nv=None, r=None):
    """A random star ring in [0.01, 0.99]^2 (the fused tests' draw)."""
    nv = nv or int(rng.integers(4, 17))
    cx, cy = rng.uniform(0.2, 0.8, 2)
    r = r or rng.uniform(0.01, 0.2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv)) + np.linspace(0, 1e-4, nv)
    rad = r * (1 + 0.5 * rng.uniform(-1, 1, nv))
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], axis=1)
    return np.clip(pts, 0.01, 0.99)


def _all_pairs(R, S):
    return np.stack(np.meshgrid(np.arange(len(R.nverts)),
                                np.arange(len(S.nverts)), indexing="ij"),
                    axis=-1).reshape(-1, 2)


def _touchy():
    sq = np.array([[0., 0.], [4., 0.], [4., 4.], [0., 4.]])
    R = [sq + [4.0, 0.0], sq + [4.0, 4.0], [[2., 4.], [3., 3.], [1., 3.]],
         [[1., 1.], [3., 1.], [2., 3.]], sq, sq + [10., 10.],
         [[-1., -1.], [5., -1.], [5., 5.], [-1., 5.]]]
    R = _ds([np.asarray(v, float) for v in R], "r")
    return R, _ds([sq] * 7, "s"), np.stack([np.arange(7)] * 2, axis=1)


def _slivers():
    """T2 x T10 with the benchmark's ``mirror`` and ``enclose`` slivers in
    the T10 layer, as ``joinbench/datagen.py`` builds them."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from joinbench import datagen
    config = {"r_count": 300, "s_count": 40, "tiles": 1,
              "layers": {"r": {"dataset": "T2", "data_seed": 1},
                         "s": {"dataset": "T10", "data_seed": 2}},
              "slivers": [{"kind": k, "from": "r", "into": "s", "count": 6,
                           "gap": 1e-12} for k in ("mirror", "enclose")]}
    made = datagen.layers(config, 7)
    R = state.dataset_from_arrays("r", *made["r"])
    S = state.dataset_from_arrays("s", *made["s"])
    return R, S, mbr_join(R.mbrs, S.mbrs)


def _borderline():
    """Triangles with a vertex a few ulps to either side of a slanted edge
    of another (or on its line), pointing away from it or into it: their
    orientations fall inside the guard band, so the ``unc`` lane is set."""
    rng = np.random.default_rng(8)
    R, S = [], []
    for off in (-3e-15, -1e-16, 0.0, 1e-16, 3e-15, 1e-13):
        for side in (1.0, -1.0):
            tri = _star(rng, nv=3, r=0.15)
            a, b = tri[0], tri[1]
            n = np.array([b[1] - a[1], a[0] - b[0]])
            n /= np.hypot(*n)
            if np.dot(tri[2] - a, n) > 0:     # n points out of the triangle
                n = -n
            v = 0.5 * (a + b) + off * n
            d = side * 0.1 * n
            R.append(np.stack([v, v + d + 0.05 * (b - a),
                               v + d - 0.05 * (b - a)]))
            S.append(tri)
    R, S = _ds(R, "r"), _ds(S, "s")
    return R, S, np.stack([np.arange(len(R.nverts))] * 2, axis=1)


def _inputs(name):
    """(R, S, pairs) of one case."""
    if name == "t1t2":
        R = make_dataset("T1", seed=0, count=80)
        S = make_dataset("T2", seed=1, count=160)
        return R, S, mbr_join(R.mbrs, S.mbrs)
    if name == "t2t10":
        R = make_dataset("T2", seed=1, count=400)
        S = make_dataset("T10", seed=2, count=30)
        return R, S, mbr_join(R.mbrs, S.mbrs)
    if name == "touchy":
        return _touchy()
    if name == "fixtures":
        rings = [fixtures.SNAPPED_TRI, fixtures.SNAPPED_HOST,
                 fixtures.CSHAPE, fixtures.CSHAPE_INNER]
        R, S = _ds(rings, "r"), _ds(rings, "s")
        return R, S, _all_pairs(R, S)
    if name == "stars":
        rng = np.random.default_rng(5)
        R = _ds([_star(rng) for _ in range(40)], "r")
        S = _ds([_star(rng) for _ in range(40)], "s")
        return R, S, _all_pairs(R, S)
    if name == "slivers":
        return _slivers()
    if name == "borderline":
        return _borderline()
    if name == "wide":
        # rings of some 220 and 380 vertices (the block path, wider than
        # a warp's stage of 160) and of 700 (wider than the block's 640)
        rng = np.random.default_rng(6)
        T3 = make_dataset("T3", seed=4, count=6)
        T9 = make_dataset("T9", seed=5, count=2)
        big = [_star(rng, nv=700, r=0.3) for _ in range(2)]
        small = [_star(rng, nv=12, r=0.05) for _ in range(4)]
        rings = ([T3.verts[i, :T3.nverts[i]] for i in range(6)]
                 + [T9.verts[i, :T9.nverts[i]] for i in range(2)] + big
                 + small)
        R, S = _ds(rings, "r"), _ds(rings[::-1], "s")
        return R, S, _all_pairs(R, S)
    raise KeyError(name)


CASES = ("t1t2", "t2t10", "touchy", "fixtures", "stars", "slivers",
         "borderline", "wide")


def _line_layer(R, name):
    """A case's R as open chains (the line core's R side)."""
    if name == "t1t2":
        return make_linestrings("T8", seed=3, count=300)
    return R


def _masks(n):
    rng = np.random.default_rng(n)
    return {"none": np.zeros(n, bool), "one": np.eye(1, n, n // 2,
                                                     dtype=bool)[0],
            "all": np.ones(n, bool), "some": rng.random(n) < 0.5}


# ---------------------------------------------------------------------------
# the CPU: dispatch and counters
# ---------------------------------------------------------------------------

def _raise(*args, **kwargs):
    raise AssertionError("the kernel was reached")


@pytest.mark.parametrize("kernel", [False, True])
def test_cpu_runs_the_plain_version(monkeypatch, kernel):
    """On the CPU ``fused_refine_lanes`` runs its plain version whatever
    ``kernel`` says, and never reaches the kernel."""
    R, S, pairs = _inputs("t1t2")
    mask = torch.from_numpy(_masks(len(pairs))["some"])
    perm, count = compact_mask_plain(mask)
    ri, si = (torch.from_numpy(pairs[:, c].copy()) for c in (0, 1))
    want = RF.fused_refine_lanes(R, S, ri, si, perm, count, "cpu")
    monkeypatch.setattr(RF, "fused_refine_rows", _raise)
    n0 = fused_refine_rows.launches
    got = RF.fused_refine_lanes(R, S, ri, si, perm, count, "cpu",
                                kernel=kernel)
    assert fused_refine_rows.launches == n0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("predicate", ["intersects", "within"])
def test_torch_backend_never_reaches_the_kernel(monkeypatch, predicate):
    """``refine_lanes(kernel=False)`` (the ``torch`` refine backend) runs
    the eager chunks, counts them, and launches no kernel."""
    monkeypatch.setattr(RF, "fused_refine_rows", _raise)
    R = make_dataset("T2", seed=1, count=200)
    S = make_dataset("T10", seed=2, count=20)
    got, st = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                       pipeline_mode="fused", refine_backend="torch") \
        .build().execute(predicate)
    want, _ = JoinPlan(R, S, filter="april", n_order=8, device="cpu") \
        .build().execute(predicate)
    np.testing.assert_array_equal(got, want)
    assert st.extra["refine_kernel_launches"] == 0
    assert st.extra["refine_chunks"] >= 1
    assert st.extra["refine_chunk_rows"] > 1


def test_kernel_refuses_other_tensors():
    R, S, pairs = _inputs("touchy")
    perm, count = compact_mask_plain(torch.ones(len(pairs), dtype=torch.bool))
    ri, si = (torch.from_numpy(pairs[:, c].copy()) for c in (0, 1))
    g = RF.device_geometry(R, "cpu"), RF.device_geometry(S, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_refine_rows("intersects", *g, ri, si, perm, count)
    with pytest.raises(ValueError, match="unknown core"):
        fused_refine_rows("selection", *g, ri, si, perm, count)
    with pytest.raises(ValueError, match="no fused refine core"):
        RF.fused_refine_lanes(R, S, ri, si, perm, count, "cpu", "touches",
                              kernel=True)


def _dead_chunk_pct(stats):
    import importlib.util
    path = ROOT / "joinbench" / "metrics" / "refine_dead_chunk_pct.py"
    spec = importlib.util.spec_from_file_location("dead_chunks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(stats=[{"extra": x} for x in stats]))


def _counting_core(walk):
    """``fused_refine_lanes``' plain version, its own counts left out and
    counted as the kernel path counts instead: one launch, chunks of one
    row, and the rows walked (the live rows, or every row of the frame) as
    a tensor count."""
    core = RF.fused_refine_lanes

    def lanes(R, S, ri, si, perm, count, device, predicate, kernel=False):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(RF.JOIN_STAGES, "count", lambda *a, **k: None)
            res, unc = core(R, S, ri, si, perm, count, device, predicate)
        rows = count if walk == "live" else torch.tensor(perm.numel())
        RF.JOIN_STAGES.count("refine_kernel_launches", 1)
        RF.JOIN_STAGES.count("refine_chunks", rows.reshape(1).to(torch.int64))
        RF.JOIN_STAGES.count("refine_chunk_rows", 1)
        return res, unc
    return lanes


@pytest.mark.parametrize("walk,pct", [("live", 0.0), ("all", 100.0)])
def test_kernel_counts_read_no_dead_chunk(monkeypatch, walk, pct):
    """A refine that counts its rows on the device, as the kernel does:
    the count comes back in the chain's gather, and the dead-chunk reader
    gives 0 when it walked the live rows alone and 100 when it walked
    every row of the frame."""
    monkeypatch.setattr(RF, "fused_refine_lanes", _counting_core(walk))
    R = make_dataset("T2", seed=1, count=200)
    S = make_dataset("T10", seed=2, count=20)
    got, st = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                       pipeline_mode="fused").build().execute("within")
    want, _ = JoinPlan(R, S, filter="april", n_order=8, device="cpu") \
        .build().execute("within")
    np.testing.assert_array_equal(got, want)
    x = st.extra
    assert x["refine_kernel_launches"] == 1 and x["refine_chunk_rows"] == 1
    assert x["refine_chunks_live"] == st.n_indecisive > 0
    assert x["refine_chunks"] == (st.n_indecisive if walk == "live"
                                  else x["n_frame"])
    assert type(x["refine_chunks"]) is int
    assert _dead_chunk_pct([x]) == pct


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_gather_brings_back_lanes_and_counts(n):
    """``to_host`` packs int8 and bool lanes and int64 counts into one
    copy and gives each back with its own dtype and values."""
    rng = np.random.default_rng(n)
    status = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int8))
    hit = torch.from_numpy(rng.random(n) < 0.5)
    walked = torch.tensor([2**40 + n, -7], dtype=torch.int64)
    got = fused.to_host(status, hit, walked, hit)
    assert [g.dtype for g in got] == [np.int8, bool, np.int64, bool]
    np.testing.assert_array_equal(got[0], status.numpy())
    np.testing.assert_array_equal(got[1], hit.numpy())
    np.testing.assert_array_equal(got[2], [2**40 + n, -7])
    np.testing.assert_array_equal(got[3], hit.numpy())


# ---------------------------------------------------------------------------
# the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(R, S, pairs, mask, dev, predicate, kernel):
    perm, count = compact_mask_plain(torch.from_numpy(mask).to(dev))
    ri, si = (torch.from_numpy(pairs[:, c].copy()).to(dev) for c in (0, 1))
    res, unc = RF.fused_refine_lanes(R, S, ri, si, perm, count, dev,
                                     predicate, kernel=kernel)
    return res.cpu(), unc.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("predicate", KINDS)
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_eager_cores(cuda_device, name, predicate):
    """(res, unc) of one launch equal the eager cores' on the card and on
    the CPU bit for bit, for prefixes of none, one, some and all rows."""
    R, S, pairs = _inputs(name)
    if predicate == "linestring":
        R = _line_layer(R, name)
        if name == "t1t2":
            pairs = mbr_join(R.mbrs, S.mbrs)
    assert len(pairs)
    for label, mask in _masks(len(pairs)).items():
        n0 = fused_refine_rows.launches
        got = _lanes(R, S, pairs, mask, cuda_device, predicate, True)
        assert fused_refine_rows.launches == n0 + 1
        torch.cuda.synchronize()
        eager = _lanes(R, S, pairs, mask, cuda_device, predicate, False)
        host = _lanes(R, S, pairs, mask, "cpu", predicate, False)
        for a, b, lane in ((got, eager, "card"), (got, host, "cpu")):
            assert torch.equal(a[0], b[0]), (label, lane, "res")
            assert torch.equal(a[1], b[1]), (label, lane, "unc")
        k = int(mask.sum())
        assert not got[0][k:].any() and not got[1][k:].any()
        if name == "borderline" and label == "all":
            assert got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("predicate", KINDS)
def test_kernel_counts_the_rows_it_refined(cuda_device, predicate):
    """The kernel's own count of the rows it refined is the live prefix,
    ``count``, whatever the frame's length."""
    R, S, pairs = _inputs("t2t10")
    if predicate == "linestring":
        R = _line_layer(R, "t2t10")
    kind = {"linestring": "line"}.get(predicate, predicate)
    g = (RF.device_geometry(R, cuda_device,
                            kind="line" if kind == "line" else "polygon"),
         RF.device_geometry(S, cuda_device))
    ri, si = (torch.from_numpy(pairs[:, c].copy()).to(cuda_device)
              for c in (0, 1))
    for label, mask in _masks(len(pairs)).items():
        perm, count = compact_mask_plain(torch.from_numpy(mask)
                                         .to(cuda_device))
        _, _, refined = fused_refine_rows(kind, *g, ri, si, perm, count)
        assert refined.device.type == "cuda" and refined.shape == (1,)
        assert int(refined) == int(mask.sum()), label


@pytest.mark.cuda
@pytest.mark.parametrize("predicate", KINDS)
def test_kernel_on_one_row_frames(cuda_device, predicate):
    """A frame of one row, live or not, for each fixture pair."""
    R, S, pairs = _inputs("fixtures")
    if predicate == "linestring":
        R = _line_layer(R, "fixtures")
    for p in pairs:
        for live in (False, True):
            mask = np.asarray([live])
            got = _lanes(R, S, p[None], mask, cuda_device, predicate, True)
            want = _lanes(R, S, p[None], mask, "cpu", predicate, False)
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1]), (p, live)


@pytest.mark.cuda
@pytest.mark.parametrize("predicate", ["intersects", "within", "selection"])
def test_fused_join_makes_no_sync_and_one_launch(cuda_device, predicate):
    """A fused ``cuda`` join: one kernel launch, ``refine_kernel_launches``
    1, no dead chunk read, the staged numpy pairs; its stages once more
    under ``set_sync_debug_mode("error")`` write the same lanes."""
    R = make_dataset("T2", seed=1, count=1200)
    S = make_dataset("T10", seed=2, count=90)
    plan = JoinPlan(R, S, filter="april", n_order=9, device=cuda_device,
                    pipeline_mode="fused", filter_backend="cuda",
                    refine_backend="cuda").build()
    n0 = fused_refine_rows.launches
    with fused.record_chains() as chains:
        got, st = plan.execute(predicate)
    assert fused_refine_rows.launches == n0 + 1
    assert st.extra["refine_kernel_launches"] == 1
    assert st.extra["refine_chunk_rows"] == 1
    assert st.extra["refine_chunks"] == st.extra["refine_chunks_live"] > 0
    assert _dead_chunk_pct([st.extra]) == 0.0
    want, _ = JoinPlan(R, S, filter="april", n_order=9, device="cpu") \
        .build().execute(predicate)
    np.testing.assert_array_equal(got, want)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fused.build_stage_plan(plan, predicate).run()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    (cs,) = chains
    assert torch.equal(again.hit, cs.hit) and torch.equal(again.unc, cs.unc)
