"""The port's stage clock, the fused chain's spans under ``torch.profiler``
and its counters, on the CPU."""
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.geometry import BUILD_STAGES
from repro_torch.datagen.synthetic import make_dataset
from repro_torch.device import StageClock
from repro_torch.spatial import JoinPlan
from repro_torch.spatial import refine as RF
from repro_torch.spatial.fused import JOIN_STAGES

#: each span of a fused join and the span that encloses it
PARENTS = {
    "join.upload": None, "join.mbr": None,
    "join.mbr.candidates": "join.mbr", "join.mbr.upload": "join.mbr",
    "join.filter": None, "join.refine": None,
    "join.refine.compact": "join.refine",
    "join.refine.chunks": "join.refine", "join.sync": None,
    "join.sync.gather": "join.sync", "join.sync.recheck": "join.sync",
    "join.collect": None}
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
NEW_EXTRA = ("refine_chunks", "refine_chunk_rows", "refine_chunks_live",
             "build_stages")


@pytest.fixture(scope="module")
def plan():
    R = make_dataset("T1", seed=0, count=300)
    S = make_dataset("T2", seed=1, count=500)
    return JoinPlan(R, S, filter="april", n_order=9, device="cpu",
                    pipeline_mode="fused",
                    build_opts={"build_backend": "torch"}).build()


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _parent(span, spans):
    """The innermost span of ``spans`` on ``span``'s thread that holds it."""
    s, e = span["ts"], span["ts"] + span["dur"]
    holders = [o for o in spans if o is not span and o["tid"] == span["tid"]
               and o["ts"] <= s and e <= o["ts"] + o["dur"]]
    return max(holders, key=lambda o: o["ts"])["name"] if holders else None


def test_fused_join_spans_under_the_profiler(plan, tmp_path, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan.execute("intersects")
    spans = [e for e in _annotations(prof, tmp_path)
             if e["name"].startswith("join.")]
    assert {e["name"] for e in spans} == set(PARENTS)
    for e in spans:
        assert _parent(e, spans) == PARENTS[e["name"]], e["name"]
    # with the profiler off, a join opens no span
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    plan.execute("intersects")
    assert opened == []


def test_build_spans_under_the_profiler(tmp_path):
    R = make_dataset("T2", seed=4, count=60)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        JoinPlan(R, R, filter="april", n_order=7, device="cpu",
                 build_opts={"build_backend": "torch"}).build()
    names = {e["name"] for e in _annotations(prof, tmp_path)}
    assert {"build.dda", "build.pip", "build.pack"} <= names


def test_stage_opens_no_span_with_neither_record_nor_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    clock = StageClock("t")
    with clock.stage("a"):
        pass
    clock.count("n", 3)
    with clock.record() as rec:
        with clock.stage("a"):
            pass
    assert opened == [] and set(rec) == {"a"}


def test_record_blocks_nest():
    clock = StageClock("t")
    with clock.record() as outer:
        with clock.stage("a"):
            pass
        with clock.record() as inner:
            with clock.stage("b"):
                clock.count("n", 2)
            clock.count("n")
        clock.count("n", 10)
    assert set(inner) == {"b", "n"} and inner["n"] == 3
    assert set(outer) == {"a", "b", "n"} and outer["n"] == 13
    assert outer["b"] == inner["b"] > 0


def test_records_stay_on_their_thread():
    """Each thread's record gets its own counts alone, with more threads
    than cores and a short switch interval."""
    clock = StageClock("t")
    n_threads, n = 16, 2000
    got, start = {}, threading.Barrier(n_threads + 1, timeout=60)

    def work(i):
        with clock.record() as rec:
            start.wait()
            for _ in range(n):
                with clock.stage("s"):
                    clock.count("n", i)
            got[i] = rec

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with clock.record() as main:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            start.wait()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert main == {}
    assert {i: rec["n"] for i, rec in got.items()} == \
        {i: i * n for i in range(n_threads)}


def test_chunk_counters(plan, monkeypatch):
    _, base = plan.execute("intersects")
    assert base.extra["refine_chunks"] == 1
    Va = RF.device_geometry(plan.R, "cpu")["verts"].shape[1]
    Vb = RF.device_geometry(plan.S, "cpu")["verts"].shape[1]
    monkeypatch.setattr(RF, "_FUSED_CHUNK_BYTES",
                        Va * Vb * RF._BYTES_PER_COUPLE * 150)
    res, st = plan.execute("intersects")
    C, N = 150, st.extra["n_frame"]
    assert st.extra["refine_chunk_rows"] == RF._chunk_rows(Va, Vb) == C
    assert st.n_indecisive > C and N > 4 * C
    assert st.extra["refine_chunks"] == -(-N // C)
    assert st.extra["refine_chunks_live"] == -(-st.n_indecisive // C)
    assert st.extra["refine_chunks_live"] < st.extra["refine_chunks"]
    got, _ = JoinPlan(plan.R, plan.S, filter="april", n_order=9,
                      device="cpu").build(
        (plan.approx_r, plan.approx_s)).execute("intersects")
    np.testing.assert_array_equal(res, got)


def test_recording_changes_no_result(plan, tmp_path):
    want, wst = plan.execute("intersects")
    with JOIN_STAGES.record() as rec, BUILD_STAGES.record():
        got, st = plan.execute("intersects")
    np.testing.assert_array_equal(got, want)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, tst = plan.execute("intersects")
    np.testing.assert_array_equal(traced, want)
    for s in (st, tst):
        assert [getattr(s, k) for k in COUNTS] == \
            [getattr(wst, k) for k in COUNTS]
        assert s.extra["n_frame"] == wst.extra["n_frame"]
        assert s.extra["n_escalated"] == wst.extra["n_escalated"]
        assert s.extra["refine_chunks"] == wst.extra["refine_chunks"]
    assert rec["refine_chunks"] == st.extra["refine_chunks"]
    assert rec["sync"] == st.t_sync and rec["refine"] == st.t_refine


def test_build_stages_add_up_to_the_build(plan):
    _, st = plan.execute("intersects")
    stages = st.extra["build_stages"]
    assert set(stages) == {"dda", "pip", "pack"}
    assert 0 < sum(stages.values()) <= st.t_build
    # an outer record (as around a build of the smoke script) sees them too
    R = make_dataset("T2", seed=4, count=60)
    with BUILD_STAGES.record() as outer:
        p2 = JoinPlan(R, R, filter="april", n_order=7, device="cpu",
                      pipeline_mode="fused").build()
    _, st2 = p2.execute("intersects")
    assert outer == st2.extra["build_stages"]
    assert sum(outer.values()) <= st2.t_build


def test_staged_mode_gains_no_counters(plan):
    got, st = JoinPlan(plan.R, plan.S, filter="april", n_order=9,
                       device="cpu").build(
        (plan.approx_r, plan.approx_s)).execute("intersects")
    assert not set(NEW_EXTRA) & set(st.extra)
    want, wst = plan.execute("intersects")
    np.testing.assert_array_equal(got, want)
    assert [getattr(st, k) for k in COUNTS] == \
        [getattr(wst, k) for k in COUNTS]
