"""The port's adaptive planner held to the JAX package's: ``choose_plan``
gives the reference's ``PlanChoice``, ``est`` key for key, for every
predicate it prices, the skip rule, ``fuse_above`` and non-default
options; the same errors; ``ProfileCache`` keys, ``static_configs`` and
``measured_work``; ``JoinPlan(plan_mode="adaptive")`` returns the
reference's pairs with the same ``stats.extra["plan"]``, and ``JoinStats``
carries the plan through JSON. Small sizes, on the CPU (``device="cpu"``);
everything is integer or deterministic float64 numpy, so the tolerance is
zero."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import JoinStats as RJoinStats  # noqa: E402
from repro.spatial import planner as rplanner  # noqa: E402
from repro.spatial.mbr_join import mbr_join as r_mbr_join  # noqa: E402

from repro_torch import JoinPlan, JoinStats, make_dataset  # noqa: E402
from repro_torch import make_linestrings  # noqa: E402
from repro_torch.spatial import planner  # noqa: E402
from repro_torch.spatial import (PlanChoice, ProfileCache,  # noqa: E402
                                 check_plan_mode, choose_plan)
from repro_torch.spatial.mbr_join import mbr_inside, mbr_join  # noqa: E402


@pytest.fixture(scope="module")
def data():
    """T1 200 x T2 48 (``intersects``, ``selection``), T1 200 x T10 24
    (``within``), T8 chains 120 x T10 24 (``linestring``): the
    reference's datasets and the port's."""
    return {"polygon": (r_make_dataset("T1", seed=61, count=200),
                        make_dataset("T1", seed=61, count=200)),
            "line": (r_make_linestrings("T8", seed=63, count=120),
                     make_linestrings("T8", seed=63, count=120)),
            "s": (r_make_dataset("T2", seed=62, count=48),
                  make_dataset("T2", seed=62, count=48)),
            "zip": (r_make_dataset("T10", seed=65, count=24),
                    make_dataset("T10", seed=65, count=24))}


def _sides(data, predicate):
    """((R0, R), (S0, S), r_kind) of a predicate's join."""
    kind = "line" if predicate == "linestring" else "polygon"
    s = "zip" if predicate in ("within", "linestring") else "s"
    return data[kind], data[s], kind


def _pairs(R, S, predicate):
    pairs = mbr_join(R.mbrs, S.mbrs)
    if predicate == "within":
        pairs = pairs[mbr_inside(R.mbrs[pairs[:, 0]], S.mbrs[pairs[:, 1]])]
    return pairs


def _both(data, predicate, n_order=7, **opts):
    """(the port's choice, the reference's) for the same inputs."""
    (R0, R), (S0, S), kind = _sides(data, predicate)
    pairs = _pairs(R, S, predicate)
    if predicate != "within":
        np.testing.assert_array_equal(pairs, r_mbr_join(R0.mbrs, S0.mbrs))
    got = choose_plan(R, S, pairs, predicate=predicate, n_order=n_order,
                      r_kind=kind, **opts)
    want = rplanner.choose_plan(R0, S0, pairs, predicate=predicate,
                                n_order=n_order, r_kind=kind, **opts)
    return got, want, len(pairs)


@pytest.mark.parametrize("predicate", ["intersects", "selection", "within",
                                       "linestring"])
def test_choice_equals_reference(data, predicate):
    got, want, n = _both(data, predicate)
    assert n >= 32 and want.est["costs"]
    assert got.to_dict() == want.to_dict()
    assert got.est.keys() == want.est.keys()
    for k in want.est:
        assert got.est[k] == want.est[k], k
    assert got.key() == want.key()


@pytest.mark.parametrize("opts", [
    {"skip_filter_below": 10_000},
    {"fuse_above": 16},
    {"methods": ("april", "april-c"), "n_orders": [5, 8], "seed": 3,
     "sample_size": 20},
    {"orders": rplanner.ORDER_CHOICES[2:], "amortize_build": 16.0,
     "c_refine": 0.5, "c_build": 4.0, "c_decode": 1.0, "probe_budget": 1.0},
], ids=["skip-rule", "fuse-above", "methods-orders-seed", "costs-budget"])
def test_choice_options_equal_reference(data, opts):
    for predicate in ("intersects", "within"):
        got, want, _ = _both(data, predicate, n_order=8, **opts)
        assert got.to_dict() == want.to_dict(), predicate
    if "fuse_above" in opts:
        assert got.pipeline_mode == "fused" or got.method == "none"
    if "skip_filter_below" in opts:
        assert got.skip_filter and got.est["skip_rule"]
        assert got.est["plan_work"] == 0.0


def test_tiny_candidate_set_skips_filter():
    R = make_dataset("T1", seed=63, count=4)
    S = make_dataset("T2", seed=64, count=4)
    R0 = r_make_dataset("T1", seed=63, count=4)
    S0 = r_make_dataset("T2", seed=64, count=4)
    pairs = mbr_join(R.mbrs, S.mbrs)
    got = choose_plan(R, S, pairs, n_order=7)
    assert got.method == "none" and got.skip_filter
    assert got.to_dict() == rplanner.choose_plan(R0, S0, pairs,
                                                 n_order=7).to_dict()


def test_bad_options_raise_reference_errors(data):
    (R0, R), (S0, S) = data["polygon"], data["s"]
    pairs = mbr_join(R.mbrs, S.mbrs)
    for mod, (r, s) in ((planner, (R, S)), (rplanner, (R0, S0))):
        with pytest.raises(TypeError, match="unknown plan option"):
            mod.choose_plan(r, s, pairs, not_an_option=1)
        with pytest.raises(ValueError, match="cannot cost"):
            mod.choose_plan(r, s, pairs, methods=("april", "5cch"))
        with pytest.raises(ValueError, match="plan_mode"):
            mod.check_plan_mode("bogus")
    with pytest.raises(ValueError, match="plan_mode"):
        JoinPlan(R, S, plan_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="plan_choice"):
        JoinPlan(R, S, plan_mode="static", plan_choice=PlanChoice(),
                 device="cpu")
    with pytest.raises(ValueError, match="adaptive"):
        JoinPlan(R, S, plan_mode="static", device="cpu").plan()
    check_plan_mode("adaptive")
    assert planner.PLAN_MODES == rplanner.PLAN_MODES
    assert planner.PLAN_DEFAULTS == rplanner.PLAN_DEFAULTS


def test_profile_cache_configs_and_work_equal_reference(data):
    (R0, R), (S0, S) = data["polygon"], data["s"]
    got, want = ProfileCache(0.5), rplanner.ProfileCache(0.5)
    for args in ((("intersects", 120, 48, 0)), ("within", 3, 7, 19),
                 ("selection", 1000, 10, 4000)):
        assert got.key(*args) == want.key(*args)
    got.put(got.key("within", 3, 7, 19), PlanChoice())
    assert got.get(got.key("within", 3, 7, 19)) is not None
    assert got.get(("x",)) is None and got.stats == {"hits": 1,
                                                     "misses": 1}
    for predicate in ("intersects", "within"):
        cfgs = planner.static_configs(predicate, planner.PLANNER_METHODS,
                                      [6, 8], planner.ORDER_CHOICES, 7)
        ref = rplanner.static_configs(predicate, rplanner.PLANNER_METHODS,
                                      [6, 8], rplanner.ORDER_CHOICES, 7)
        assert [c.to_dict() for c in cfgs] == [c.to_dict() for c in ref]
    pairs = mbr_join(R.mbrs, S.mbrs)
    bank, rbank = {}, {}
    for cfg in planner.static_configs("intersects", planner.PLANNER_METHODS,
                                      [7], planner.ORDER_CHOICES[:2], 7):
        rcfg = rplanner.PlanChoice.from_dict(cfg.to_dict())
        assert planner.measured_work(R, S, pairs, cfg, store_bank=bank) == \
            rplanner.measured_work(R0, S0, pairs, rcfg, store_bank=rbank)


@pytest.mark.parametrize("predicate,mode", [
    ("intersects", "staged"), ("selection", "fused"), ("within", "staged"),
    ("linestring", "staged")])
def test_adaptive_execute_equals_reference(data, predicate, mode):
    """The reference plans alike; it then executes staged, since its fused
    chain cannot run in this image (ROADMAP C1)."""
    (R0, R), (S0, S), kind = _sides(data, predicate)
    opts = {"fuse_above": 16} if mode == "fused" else {}
    plan = JoinPlan(R, S, n_order=7, plan_mode="adaptive", plan_opts=opts,
                    r_kind=kind, device="cpu")
    got, st = plan.execute(predicate)
    ref = RJoinPlan(R0, S0, n_order=7, plan_mode="adaptive", plan_opts=opts,
                    r_kind=kind)
    ref.plan(predicate)
    ref.pipeline_mode = "staged"
    want, wst = ref.execute(predicate)
    np.testing.assert_array_equal(got, want)
    assert st.extra["plan"] == wst.extra["plan"]
    assert st.plan_mode == "adaptive" and st.extra["t_plan"] >= 0.0
    choice = PlanChoice.from_dict(st.extra["plan"])
    assert (plan.filter.name, plan.n_order, plan.pipeline_mode) == \
        (choice.method, choice.n_order, choice.pipeline_mode)
    if mode == "fused":
        assert st.pipeline_mode == "fused" or choice.method == "none"
    if choice.method in ("april", "april-c") and predicate in (
            "intersects", "selection"):
        assert tuple(plan.filter_opts["order"]) == choice.order
    # an injected choice skips the sampling and executes the same plan
    again, st2 = JoinPlan(R, S, n_order=7, plan_mode="adaptive",
                          plan_choice=choice, r_kind=kind,
                          device="cpu").execute(predicate)
    np.testing.assert_array_equal(again, want)
    assert st2.extra["plan"] == st.extra["plan"]


def test_join_stats_round_trip_preserves_plan(data):
    (R0, R), (S0, S) = data["polygon"], data["s"]
    _, st = JoinPlan(R, S, n_order=7, plan_mode="adaptive",
                     device="cpu").execute("intersects")
    back = JoinStats.from_dict(json.loads(json.dumps(st.to_dict())))
    assert back.plan_mode == "adaptive"
    assert back.extra["plan"] == st.extra["plan"]
    assert back.to_dict() == st.to_dict()
    rback = RJoinStats.from_dict(json.loads(json.dumps(st.to_dict())))
    assert rback.extra["plan"] == st.extra["plan"]
    _, st2 = JoinPlan(R, S, n_order=7, device="cpu").execute("intersects")
    assert st2.plan_mode == "static" and "plan" not in st2.extra
    c = PlanChoice(method="april-c", n_order=11,
                   order=planner.ORDER_CHOICES[2], pipeline_mode="fused",
                   predicate="within", est={"total": 12.5})
    assert PlanChoice.from_dict(json.loads(json.dumps(
        c.to_dict()))).to_dict() == c.to_dict()


@pytest.mark.parametrize("plan_mode", ["static", "adaptive"])
def test_pipeline_shims_equal_reference(data, plan_mode):
    """The four function-style shims return the reference's pairs (and
    per-query hits) with its plan; ``use_jnp=True`` names ``"cuda"``."""
    from repro.spatial import pipeline as rpipeline
    from repro_torch.spatial import pipeline
    (R0, R), (S0, S), (Z0, Z), (L0, L) = (
        data["polygon"], data["s"], data["zip"], data["line"])
    calls = (("spatial_intersection_join", (R, S), (R0, S0)),
             ("spatial_within_join", (R, Z), (R0, Z0)),
             ("polygon_linestring_join", (Z, L), (Z0, L0)),
             ("selection_queries", (R, S), (R0, S0)))
    for name, args, rargs in calls:
        got, st = getattr(pipeline, name)(*args, n_order=7, device="cpu",
                                          plan_mode=plan_mode)
        want, wst = getattr(rpipeline, name)(*rargs, n_order=7,
                                             plan_mode=plan_mode)
        if name == "selection_queries":
            assert len(got) == len(want) == len(S)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            assert len(want) > 0
            np.testing.assert_array_equal(got, want)
        assert st.extra.get("plan") == wst.extra.get("plan"), name
    with pytest.raises(ValueError, match="'cuda'"):
        pipeline.spatial_intersection_join(R, S, use_jnp=True, device="cpu")
