"""The yardstick on the CPU at small sizes: the frozen generator equals
the port's, the plain reference equals the port's plain torch backends,
the float32 control fails the comparison, and a run whose timed path is
broken underneath comes out not correct."""
import numpy as np
import pytest
import torch

from joinbench import control, datagen, harness, reference
from repro_torch.core.rasterize import Extent
from repro_torch.datagen.synthetic import PolygonDataset, make_dataset
from repro_torch.spatial import JoinPlan
from repro_torch.spatial import fused
from repro_torch.spatial import refine as RF

#: each configuration cut to a CPU test's size: T1 300 x T2 500 and
#: T2 500 x T10 40 over the two tiles, n_order 10 (the cells of 9 on one
#: tile), the kernels' plain versions, slivers of each kind kept
SMALL = {
    "tiger-t1-t2": {"r_count": 300, "s_count": 500, "slivers": [
        {"kind": "mirror", "from": "r", "into": "s", "count": 3,
         "gap": 1e-12}]},
    "tiger-t2-t10": {"r_count": 500, "s_count": 40, "slivers": [
        {"kind": "enclose", "from": "r", "into": "s", "count": 3,
         "gap": 1e-12},
        {"kind": "mirror", "from": "r", "into": "s", "count": 3,
         "gap": 1e-12}]},
}
CPU = {"n_order": 10, "filter_backend": "torch", "refine_backend": "torch"}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEED = 2**31 + 12345


def _small(cell):
    spec = harness.cell(cell)
    return {**spec["config_data"], **SMALL[spec["config"]], **CPU}


@pytest.mark.parametrize("name,seed,count", [("T1", 0, 300), ("T2", 1, 500),
                                             ("T10", 2, 40)])
def test_frozen_generator_equals_the_ports(name, seed, count):
    verts, nverts = datagen.make_layer(name, seed, count)
    d = make_dataset(name, seed=seed, count=count)
    assert np.array_equal(verts, d.verts)
    assert np.array_equal(nverts, d.nverts)


def test_seed_permutes_the_same_rings():
    conf = _small("t1xt2-intersects")
    a, b = datagen.layers(conf, 1), datagen.layers(conf, SEED)
    for side in ("r", "s"):
        assert not np.array_equal(a[side][1], b[side][1])
        key = [np.sort(x[side][0].reshape(len(x[side][1]), -1), axis=0)
               for x in (a, b)]
        assert np.array_equal(*key)
    again = datagen.layers(conf, SEED)
    assert np.array_equal(again["s"][0], b["s"][0])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("g", [0, 1])
def test_reference_equals_the_port(cell, mode, g):
    """On the configuration's rings (geometry 0) and on others (1)."""
    conf = control.geometry(_small(cell), g)
    pred = harness.cell(cell)["traffic_data"]["predicate"]
    L = datagen.layers(conf, 7)
    R, S = PolygonDataset("R", *L["r"]), PolygonDataset("S", *L["s"])
    plan = JoinPlan(R, S, filter="april", n_order=conf["n_order"],
                    extent=Extent(*conf["extent"]), device="cpu",
                    pipeline_mode=mode,
                    build_opts={"build_backend": "torch"}).build()
    got, stats = plan.execute(pred)
    cand, keep = reference.candidates_and_answers(*L["r"], *L["s"], pred)
    assert stats.n_candidates == len(cand)
    want = reference.pair_keys(cand[keep], len(L["s"][1]))
    assert len(want) > 0
    assert harness.mismatch(reference.pair_keys(got, len(L["s"][1])),
                            want) == 0


def test_tiles_and_geometries_differ():
    """The second tile lies beside the first, and geometry 1 draws other
    rings than 0."""
    conf = _small("t1xt2-intersects")
    one = datagen.layers({**conf, "tiles": 1, "extent": [0.0, 0.0, 1.0],
                          "slivers": []}, 3)
    two = datagen.layers({**conf, "slivers": []}, 3)
    assert one["r"][0][..., 0].max() < 1.0 < two["r"][0][..., 0].max() < 2.0
    g1 = datagen.layers(control.geometry(conf, 1), 3)
    assert not np.array_equal(np.sort(g1["r"][0].ravel()),
                              np.sort(two["r"][0].ravel()))


def test_reference_on_touching_and_nested_rings():
    sq = np.array([[0.2, 0.2], [0.4, 0.2], [0.4, 0.4], [0.2, 0.4]])
    rings = [sq, sq + [0.2, 0.0],            # share an edge
             sq * 0.5 + 0.2,                  # inside sq, touching it
             sq * 0.25 + 0.22,                # strictly inside sq
             sq + [0.2 + 1e-9, 0.0]]          # 1e-9 apart from sq
    verts = np.stack(rings)
    nv = np.full(len(rings), 4)
    vr, nr = verts[1:], nv[1:]
    vs, ns = verts[:1], nv[:1]
    inter = reference.join(vr, nr, vs, ns, "intersects")
    assert sorted(inter[:, 0].tolist()) == [0, 1, 2]
    within = reference.join(vr, nr, vs, ns, "within")
    assert sorted(within[:, 0].tolist()) == [1, 2]
    f32 = reference.join(vr, nr, vs, ns, "intersects", dtype=torch.float32)
    assert sorted(f32[:, 0].tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("ctl", list(control.CONTROLS))
def test_float32_control_fails_the_comparison(cell, ctl):
    """Each control (the reference in float32, throughout or in the exact
    test alone, in the program's place) reads the slivers of the
    predicate's kind as mismatches, above the limit 0."""
    conf = _small(cell)
    got = control.reading(cell, SEED, device="cpu", config_overrides=conf)
    pred = harness.cell(cell)["traffic_data"]["predicate"]
    kind = "enclose" if pred == "within" else "mirror"
    slivers = sum(s["count"] for s in conf["slivers"] if s["kind"] == kind)
    assert got[ctl] >= slivers > harness.LIMITS["mismatched_pairs"]


def test_sound_run_is_correct():
    out = harness.run_cell("t1xt2-intersects", SEED, 0.2, False,
                           device="cpu",
                           config_overrides=_small("t1xt2-intersects"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"]["mismatched_pairs"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"join_s", "setup_s"}


def _pass_through(cs, R, S, dev, predicate, kernel):
    """The refine stage returning its candidates unchanged: every
    INDECISIVE row counted a hit."""
    cs.hit = cs.status != 0
    cs.unc = torch.zeros_like(cs.hit)
    return cs


def _half_frame(ri, si, dev, _device_frame=fused.device_frame):
    """Half of the frame's rows left out."""
    n = len(ri) // 2
    return _device_frame(ri[:n], si[:n], dev)


def _altered(*args, _core=RF.fused_refine_lanes, **kwargs):
    """One refined verdict flipped where the refine produces it."""
    res, unc = _core(*args, **kwargs)
    res = res.clone()
    res[0] = ~res[0]
    return res, unc


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("module,attr,fault", [
    (fused, "refine_lanes", _pass_through),
    (fused, "device_frame", _half_frame),
    (RF, "fused_refine_lanes", _altered)],
    ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, module, attr,
                                          fault):
    monkeypatch.setattr(module, attr, fault)
    out = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                           config_overrides=_small(cell))
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert out["checks"]["mismatched_pairs"]["value"] > 0
