"""The yardstick on the CPU at small sizes: the frozen generators equal
the port's, the plain reference equals the port's plain torch backends,
the float32 control fails the comparison, and a run whose timed path is
broken underneath comes out not correct. Each configuration is cut to
its ``cpu_test`` key; ``LINE`` is a configuration of open chains held
here as a cell spec, with no file under ``configs/`` or ``traffic/``."""
import numpy as np
import pytest
import torch

from joinbench import control, datagen, harness, reference
from repro_torch.core.rasterize import Extent
from repro_torch.datagen.synthetic import (PolygonDataset, make_dataset,
                                           make_linestrings)
from repro_torch.spatial import JoinPlan
from repro_torch.spatial import fused
from repro_torch.spatial import refine as RF

#: the CPU test's backends and grid: n_order 10 over the two tiles (the
#: cells of 9 on one tile), the kernels' plain versions
CPU = {"n_order": 10, "filter_backend": "torch", "refine_backend": "torch"}
#: T8 chains against T2 water, fused with APRIL: the linestring join
#: (APRIL-C, B4 twice, the refine's line core) as a spec of ``run_cell``
LINE = {
    "name": "t8xt2-small", "config": "t8-t2-small", "traffic": "linestring",
    "chips": 1,
    "config_data": {
        "name": "t8-t2-small", "r_count": 24000, "s_count": 24000,
        "tiles": 2,
        "layers": {"r": {"dataset": "T8", "kind": "line", "data_seed": 3,
                         "avg_vertices": 20, "step": 0.004},
                   "s": {"dataset": "T2", "data_seed": 1}},
        "slivers": [{"kind": "graze", "from": "s", "into": "r",
                     "count": 24, "gap": 1e-12}],
        "n_order": 13, "extent": [0.0, 0.0, 2.0], "filter": "april",
        "pipeline_mode": "fused", "mbr_backend": "numpy",
        "build_backend": "torch", "filter_backend": "cuda",
        "refine_backend": "cuda",
        "cpu_test": {"r_count": 400, "s_count": 500, "slivers": [
            {"kind": "graze", "from": "s", "into": "r", "count": 3,
             "gap": 1e-12}]}},
    "traffic_data": {"name": "linestring", "predicate": "linestring"},
}
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
#: the cells and the line configuration, by name
SPECS = {**{c: harness.cell(c) for c in CELLS}, LINE["name"]: LINE}
SEED = 2**31 + 12345


def _small(cell):
    conf = SPECS[cell]["config_data"]
    return {**conf, **conf["cpu_test"], **CPU}


@pytest.mark.parametrize("name,seed,count", [("T1", 0, 300), ("T2", 1, 500),
                                             ("T10", 2, 40)])
def test_frozen_generator_equals_the_ports(name, seed, count):
    verts, nverts = datagen.make_layer(name, seed, count)
    d = make_dataset(name, seed=seed, count=count)
    assert np.array_equal(verts, d.verts)
    assert np.array_equal(nverts, d.nverts)


@pytest.mark.parametrize("seed,count,vertices,step", [
    (3, 400, 20, 0.004), (SEED, 60, 5, 0.01)])
def test_frozen_chain_generator_equals_the_ports(seed, count, vertices,
                                                 step):
    verts, nverts = datagen.make_chains("T8", seed, count, vertices, step)
    d = make_linestrings("T8", seed=seed, count=count,
                         avg_vertices=vertices, step=step)
    assert np.array_equal(verts, d.verts)
    assert np.array_equal(nverts, d.nverts)


def test_chain_layer_tiles_the_ports_chains():
    """Tile t of a line layer is the port's chains at the data seed plus
    ``TILE_SEED_STEP * t``, shifted by t along x."""
    spec = LINE["config_data"]["layers"]["r"]
    verts, nverts = datagen._tiled(spec, 200, 2)
    for t in range(2):
        d = make_linestrings("T8", seed=3 + datagen.TILE_SEED_STEP * t,
                             count=100)
        v, n = verts[100 * t:100 * (t + 1)], nverts[100 * t:100 * (t + 1)]
        assert np.array_equal(n, d.nverts)
        V = d.verts.shape[1]
        valid = np.arange(V)[None, :] < n[:, None]
        assert np.array_equal(v[:, :V][valid], d.verts[valid] + [t, 0.0])
        assert not v[:, :V][~valid].any() and not v[:, V:].any()


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


@pytest.mark.parametrize("cell", list(SPECS))
@pytest.mark.parametrize("mode", ["fused", "staged"])
@pytest.mark.parametrize("g", [0, 1])
def test_reference_equals_the_port(cell, mode, g):
    """On the configuration's rings (geometry 0) and on others (1)."""
    conf = control.geometry(_small(cell), g)
    pred = SPECS[cell]["traffic_data"]["predicate"]
    L = datagen.layers(conf, 7)
    R, S = PolygonDataset("R", *L["r"]), PolygonDataset("S", *L["s"])
    plan = JoinPlan(R, S, filter="april", n_order=conf["n_order"],
                    extent=Extent(*conf["extent"]), device="cpu",
                    r_kind=conf["layers"]["r"].get("kind", "polygon"),
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


def test_reference_on_hand_made_chains():
    """Chains against one square: one crossing it, one touching it at an
    endpoint, one wholly inside, one 1e-9 apart."""
    sq = np.array([[[0.2, 0.2], [0.4, 0.2], [0.4, 0.4], [0.2, 0.4]]])
    chains = np.array([
        [[0.1, 0.3], [0.3, 0.3], [0.5, 0.3]],          # crosses
        [[0.5, 0.5], [0.45, 0.45], [0.4, 0.4]],        # ends on a corner
        [[0.25, 0.25], [0.3, 0.35], [0.35, 0.25]],     # wholly inside
        [[0.4 + 1e-9, 0.1], [0.4 + 1e-9, 0.3],         # 1e-9 right of it
         [0.4 + 1e-9, 0.45]]])
    nc = np.full(len(chains), 3)
    got = reference.join(chains, nc, sq, np.array([4]), "linestring")
    assert sorted(got[:, 0].tolist()) == [0, 1, 2]
    f32 = reference.join(chains, nc, sq, np.array([4]), "linestring",
                         dtype=torch.float32)
    assert sorted(f32[:, 0].tolist()) == [0, 1, 2, 3]


def test_graze_slivers_read_apart_in_float64_and_touching_in_float32():
    """Each graze chain meets no ring of its source layer in float64 and
    touches one in float32."""
    layer = datagen._tiled({"dataset": "T2", "data_seed": 1}, 500, 2)
    vc, nc = datagen.slivers(layer, "graze", 5, 1e-12, [1, 0],
                             (0.0, 0.0, 2.0, 1.0))
    assert (nc == 3).all()
    f64, f32 = (reference.pair_keys(reference.join(
        vc, nc, *layer[:2], "linestring", dtype=dt), len(layer[1]))
        for dt in (torch.float64, torch.float32))
    extra = np.setdiff1d(f32, f64)
    assert np.array_equal(np.unique(extra // len(layer[1])), np.arange(5))
    assert len(np.setdiff1d(f64, f32)) == 0


@pytest.mark.parametrize("cell", list(SPECS))
@pytest.mark.parametrize("ctl", list(control.CONTROLS))
def test_float32_control_fails_the_comparison(cell, ctl):
    """Each control (the reference in float32, throughout or in the exact
    test alone, in the program's place) reads the slivers of the
    predicate's kind as mismatches, above the limit 0."""
    conf = _small(cell)
    got = control.reading(SPECS[cell], SEED, device="cpu",
                          config_overrides=conf)
    pred = SPECS[cell]["traffic_data"]["predicate"]
    # selection is intersects with the query rings as S
    pred = {"selection": "intersects"}.get(pred, pred)
    slivers = sum(s["count"] for s in conf["slivers"]
                  if datagen.SLIVER_PREDICATE[s["kind"]] == pred)
    assert got[ctl] >= slivers > harness.LIMITS["mismatched_pairs"]


def test_sound_run_is_correct():
    out = harness.run_cell("t1xt2-intersects", SEED, 0.2, False,
                           device="cpu",
                           config_overrides=_small("t1xt2-intersects"))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"]["mismatched_pairs"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"join_s", "setup_s"}


def test_sound_line_run_is_correct():
    """The line configuration, given as a spec, runs correct."""
    out = harness.run_cell(LINE, SEED, 0.2, False, device="cpu",
                           config_overrides=_small(LINE["name"]))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["checks"]["mismatched_pairs"] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"join_s", "setup_s"}


def test_line_store_lengths():
    """A line plan's stores give the chains' C lists and the rings' A and
    F lists."""
    conf = _small(LINE["name"])
    plan = harness._plan(conf, datagen.layers(conf, 5), torch.device("cpu"))
    plan.build()
    r, s = (harness._lens(a.store) for a in (plan.approx_r, plan.approx_s))
    assert set(r) == {"C"} and set(s) == {"A", "F"}
    assert len(r["C"]) == conf["r_count"] + 3 and r["C"].min() >= 1
    assert len(s["A"]) == conf["s_count"]


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


@pytest.mark.parametrize("cell", list(SPECS))
@pytest.mark.parametrize("module,attr,fault", [
    (fused, "refine_lanes", _pass_through),
    (fused, "device_frame", _half_frame),
    (RF, "fused_refine_lanes", _altered)],
    ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, module, attr,
                                          fault):
    monkeypatch.setattr(module, attr, fault)
    out = harness.run_cell(SPECS[cell], SEED, 0.2, False, device="cpu",
                           config_overrides=_small(cell))
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert out["checks"]["mismatched_pairs"]["value"] > 0
