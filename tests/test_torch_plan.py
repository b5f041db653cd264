"""The port's staged join end to end (``repro_torch.JoinPlan``) held to the
JAX package's staged numpy plan: the same datasets and APRIL stores byte
for byte, the same result pairs in the same order, the same ``JoinStats``
counts; plus its device rules and the rule that it imports neither JAX nor
anything of the reference package."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hilbert as rhilbert  # noqa: E402
from repro.core.april import build_april as r_build_april  # noqa: E402
from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial.filters import get_filter as r_get_filter  # noqa: E402
from repro.spatial.mbr_join import MBRIndex as RMBRIndex  # noqa: E402
from repro.spatial.mbr_join import mbr_join as r_mbr_join  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import JoinPlan, JoinStats, make_dataset  # noqa: E402
from repro_torch.spatial import get_filter  # noqa: E402
from repro_torch.core import hilbert  # noqa: E402
from repro_torch.core.april import build_april  # noqa: E402
from repro_torch.spatial.mbr_join import MBRIndex, mbr_join  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
COUNTS = {"intersects": ("n_candidates", "n_true_hits", "n_true_negs",
                         "n_indecisive", "n_results")}


@pytest.mark.parametrize("name,seed,count", [("T1", 0, 80), ("T2", 1, 160),
                                             ("T3", 4, 12), ("O5", 9, 40)])
def test_datasets_and_stores_are_byte_identical(name, seed, count):
    ref = r_make_dataset(name, seed=seed, count=count)
    got = make_dataset(name, seed=seed, count=count)
    for k in ("verts", "nverts", "mbrs"):
        a, b = getattr(got, k), getattr(ref, k)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    s_ref = r_build_april(ref, 7)
    s_got = build_april(got, 7)
    for k in ("a_off", "a_ints", "f_off", "f_ints"):
        a, b = getattr(s_got, k), getattr(s_ref, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    assert s_got.size_bytes() == s_ref.size_bytes()


def test_hilbert_and_candidates_match():
    rng = np.random.default_rng(3)
    x, y = rng.integers(0, 2**9, (2, 500))
    d = hilbert.xy2d(9, x, y)
    np.testing.assert_array_equal(d, rhilbert.xy2d(9, x, y))
    np.testing.assert_array_equal(np.stack(hilbert.d2xy(9, d)),
                                  np.stack(rhilbert.d2xy(9, d)))
    np.testing.assert_array_equal(hilbert.u32_to_biased_i32(d),
                                  rhilbert.u32_to_biased_i32(d))
    R = make_dataset("T1", seed=5, count=60)
    S = make_dataset("T2", seed=6, count=120)
    for grid in (None, 1, 16):
        got = mbr_join(R.mbrs, S.mbrs, grid=grid)
        np.testing.assert_array_equal(got, r_mbr_join(R.mbrs, S.mbrs,
                                                      grid=grid))
        seq = mbr_join(R.mbrs, S.mbrs, grid=grid, backend="sequential")
        assert set(map(tuple, seq.tolist())) == set(map(tuple, got.tolist()))


@pytest.fixture(scope="module")
def datasets():
    return (r_make_dataset("T1", seed=0, count=80),
            r_make_dataset("T2", seed=1, count=160),
            make_dataset("T1", seed=0, count=80),
            make_dataset("T2", seed=1, count=160))


@pytest.mark.parametrize("order", [("AA", "AF", "FA"), ("AA", "AF")],
                         ids=["default", "degenerate"])
@pytest.mark.parametrize("backends", [("torch", "torch"), ("numpy", "numpy"),
                                      ("torch", "numpy")],
                         ids=lambda b: "-".join(b))
def test_join_matches_reference(datasets, order, backends):
    """Pairs, their order and the JoinStats counts equal the reference's
    staged numpy plan; the degenerate order takes the overlap-kernel path."""
    R0, S0, R, S = datasets
    ref, rst = RJoinPlan(R0, S0, filter="april", n_order=8,
                         filter_opts={"order": order}).build().execute(
        "intersects")
    fb, rb = backends
    got, st = JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                       filter_backend=fb, refine_backend=rb,
                       filter_opts={"order": order}).build().execute(
        "intersects")
    assert got.dtype == ref.dtype == np.int64 and len(ref) > 100
    np.testing.assert_array_equal(got, ref)
    for k in COUNTS["intersects"]:
        assert getattr(st, k) == getattr(rst, k), k
    assert st.approx_bytes == rst.approx_bytes
    assert st.filter_backend == fb and st.refine_backend == rb
    assert set(st.to_dict()) == set(rst.to_dict())
    json.dumps(st.to_dict())
    assert JoinStats.from_dict(st.to_dict()).to_dict() == st.to_dict()


def test_sequential_backends_and_prebuilt(datasets):
    _, _, R, S = datasets
    plan = JoinPlan(R, S, n_order=7, device="cpu").build()
    want, _ = plan.execute("intersects")
    seq = JoinPlan(R, S, n_order=7, device="cpu",
                   filter_backend="sequential", refine_backend="sequential",
                   mbr_backend="sequential").build(
        prebuilt=(plan.approx_r, plan.approx_s))
    got, st = seq.execute("intersects")
    assert seq.approx_r is plan.approx_r
    assert set(map(tuple, got.tolist())) == set(map(tuple, want.tolist()))
    assert st.mbr_backend == "sequential"


def test_default_device_needs_a_gpu(datasets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: JoinPlan() runs there")
    _, _, R, S = datasets
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JoinPlan(R, S)


def test_cuda_backends_need_a_cuda_device(datasets):
    _, _, R, S = datasets
    for kw in ({"filter_backend": "cuda"}, {"refine_backend": "cuda"}):
        with pytest.raises(ValueError, match="CUDA device"):
            JoinPlan(R, S, device="cpu", **kw)
    plan = JoinPlan(R, S, device="cpu")
    assert (plan.filter_backend, plan.refine_backend) == ("torch", "torch")
    with pytest.raises(ValueError, match="filter backend"):
        JoinPlan(R, S, device="cpu", filter_backend="pallas")


@pytest.mark.parametrize("kw,match", [
    ({"filter": "ri", "build_opts": {"build_backend": "sequential"}},
     "ROADMAP A7"),
    ({"plan_mode": "adaptive"}, "ROADMAP A8"),
    ({"r_kind": "line"}, "ROADMAP A1"),
    ({"mbr_index": "the warm index of R"}, "ROADMAP A8"),
    ({"filter": "ri", "r_kind": "line"}, "ROADMAP A1"),
    ({"filter": "5cch", "plan_mode": "adaptive"}, "ROADMAP A8"),
])
def test_uncovered_knobs_raise(datasets, kw, match):
    """Knobs still to port raise, naming their ROADMAP item. The line
    knobs (``r_kind="line"``, ROADMAP A1-A3) are ported: those cases run
    the linestring join of T1's rings as open chains against T2 and
    return the reference's pairs, order and counts. The sequential RI
    build (ROADMAP A7) is ported: its stores equal the reference's, bit
    for bit, and so do the join's pairs. ``plan_mode="adaptive"`` and
    ``mbr_index`` (ROADMAP A8, the service half) are ported: the adaptive
    plans return the reference's pairs and ``stats.extra["plan"]``, and a
    plan probing the warm ``MBRIndex`` of R the reference's pairs, order
    and counts."""
    R0, S0, R, S = datasets
    if "plan_mode" in kw or "mbr_index" in kw:
        if "mbr_index" in kw:
            kw, rkw = ({"mbr_index": MBRIndex(R.mbrs)},
                       {"mbr_index": RMBRIndex(R0.mbrs)})
        else:
            rkw = kw
        want, wst = RJoinPlan(R0, S0, n_order=7, **rkw).execute("intersects")
        got, st = JoinPlan(R, S, device="cpu", n_order=7, **kw).execute(
            "intersects")
        assert len(want) > 0 and st.n_indecisive == wst.n_indecisive
        np.testing.assert_array_equal(got, want)
        assert st.extra.get("plan") == wst.extra.get("plan")
        return
    if "build_opts" in kw:
        ref = RJoinPlan(R0, S0, n_order=7, **kw).build()
        plan = JoinPlan(R, S, device="cpu", n_order=7, **kw).build()
        for got, want in ((plan.approx_r, ref.approx_r),
                          (plan.approx_s, ref.approx_s)):
            for k in ("off", "ints", "bit_off", "bits"):
                a, b = getattr(got.store, k), getattr(want.store, k)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
        want, _ = ref.execute("intersects")
        got, _ = plan.execute("intersects")
        assert len(want) > 0
        np.testing.assert_array_equal(got, want)
        return
    if kw.get("r_kind") == "line":
        want, wst = RJoinPlan(R0, S0, n_order=7, **kw).build().execute(
            "linestring")
        got, st = JoinPlan(R, S, device="cpu", n_order=7, **kw).build(
        ).execute("linestring")
        assert len(want) > 0 and st.n_indecisive == wst.n_indecisive
        np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(NotImplementedError, match=match):
        JoinPlan(R, S, device="cpu", **kw).build()


@pytest.mark.parametrize("name", ["ri", "5cch", "ra", "april-c"])
def test_filter_builds_of_lines_raise(datasets, name):
    """Each filter's own line build, reached without JoinPlan, equals the
    reference's (line builds no longer raise: ROADMAP A1-A3 is ported),
    and a kind the reference does not know raises."""
    R0, _, R, _ = datasets
    got = get_filter(name).build(R, n_order=6, kind="line").store
    want = r_get_filter(name).build(R0, n_order=6, kind="line").store
    arrays = {"ri": ("off", "ints", "bit_off", "bits"),
              "5cch": ("pent", "hull_off", "hull_pts"),
              "ra": ("k", "origin", "shape"), "april-c": ("off", "ids")}
    for k in arrays[name]:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    if name == "ra":
        for a, b in zip(got.cells, want.cells, strict=True):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown kind"):
        get_filter(name).build(R, n_order=6, kind="curve")


@pytest.mark.parametrize("predicate", ["within", "linestring", "selection"])
def test_uncovered_predicates_raise(datasets, predicate):
    """Every predicate is ported and returns the reference's pairs:
    ``within`` and ``selection`` on the polygon plan, ``linestring`` on a
    line plan (T1's rings as open chains), where the polygon plan raises
    the reference's ValueError."""
    R0, S0, R, S = datasets
    plan = JoinPlan(R, S, n_order=6, device="cpu")
    kw = {}
    if predicate == "linestring":
        with pytest.raises(ValueError, match="r_kind='line'"):
            plan.execute(predicate)
        kw = {"r_kind": "line"}
        plan = JoinPlan(R, S, n_order=6, device="cpu", **kw)
    want, _ = RJoinPlan(R0, S0, n_order=6, **kw).build().execute(predicate)
    got, st = plan.execute(predicate)
    assert st.predicate == predicate and len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=300, check=True).stdout.split()
    assert int(out[0]) >= 20 and out[1] == "[]", out
    assert repro_torch.__name__ == "repro_torch"
