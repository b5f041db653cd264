"""The span reduction on a trace written by hand, and the readers of the
program's counters on hand-made and on real ``JoinStats``."""
import numpy as np
import pytest

from joinbench import harness, spans, trace
from joinbench.test_joinbench_roofline import EVENTS as PLAIN_EVENTS

MAIN, WORKER = 1, 2


def _span(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "ph": "X", "pid": 7, "tid": tid}


def _launch(corr, ts, tid=MAIN):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 0.5, "ph": "X", "pid": 7, "tid": tid,
            "args": {"correlation": corr}}


def _device(cat, corr, ts, dur):
    ev = {"cat": cat, "name": f"op{corr}", "ts": ts, "dur": dur, "ph": "X",
          "pid": 0, "tid": 9}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


#: two joins, 100-130 and 134-140 (µs), on thread MAIN; a worker thread
#: runs a filter span of its own
EVENTS = [
    _span(trace.SPAN, 100, 30),
    _span("join.mbr", 101, 9),
    _span("join.mbr.candidates", 101, 5),
    _span("join.refine", 110, 10),
    _span("join.refine.chunks", 112, 7),
    _span("join.sync", 120, 8),
    _span(trace.SPAN, 134, 6),
    _span("join.refine", 135, 4),
    _span("join.filter", 102, 2, tid=WORKER),
    # launched in join.refine before its chunks, run while the host syncs
    _launch(1, 111), _device("kernel", 1, 121, 3),
    # launched in the chunks
    _launch(2, 113), _device("kernel", 2, 124, 2),
    # a copy launched in the candidates
    _launch(3, 102), _device("gpu_memcpy", 3, 103, 1),
    # launched in the join span but in no program span
    _launch(4, 129), _device("kernel", 4, 129, 1),
    # the second join's refine
    _launch(5, 136), _device("gpu_memset", 5, 137, 1),
    # the worker's launch, its kernel inside the busy 124-126
    _launch(6, 103, tid=WORKER), _device("kernel", 6, 125, 1),
    # outside the window, and a kernel with no launch
    _launch(7, 50), _device("kernel", 7, 50, 10),
    _device("kernel", None, 139, 0.5),
]


def test_kernels_count_to_the_span_that_launched_them():
    got = spans.reduce(EVENTS)
    sp = got["spans"]
    # a kernel launched in join.refine runs while the host is in join.sync
    assert sp["join.refine"]["device_s"] == pytest.approx(4e-6)
    assert sp["join.refine"]["launches"] == 2
    assert sp["join.sync"]["device_s"] == 0.0
    assert sp["join.sync"]["launches"] == 0
    # nested spans give the time to the innermost
    assert sp["join.refine.chunks"]["device_s"] == pytest.approx(2e-6)
    assert sp["join.mbr.candidates"]["launches"] == 1
    assert sp["join.mbr"]["launches"] == 0
    assert sp["join.filter"]["device_s"] == pytest.approx(1e-6)
    assert spans.span_total(got, "join.refine", "device_s") == \
        pytest.approx(6e-6)
    assert spans.span_total(got, "join.refine", "launches") == 3
    assert got["unattributed_s"] == pytest.approx(1.5e-6)


def test_host_seconds_and_parents():
    sp = spans.reduce(EVENTS)["spans"]
    assert sp["join.refine"]["host_s"] == pytest.approx(14e-6)
    assert sp["join.mbr"]["host_s"] == pytest.approx(9e-6)
    assert {k: v["parents"] for k, v in sp.items()} == {
        "join.mbr": [trace.SPAN], "join.mbr.candidates": ["join.mbr"],
        "join.refine": [trace.SPAN], "join.refine.chunks": ["join.refine"],
        "join.sync": [trace.SPAN], "join.filter": [""]}


def test_idle_gaps_are_named_by_the_innermost_span():
    got = spans.reduce(EVENTS)
    # busy: 103-104, 121-126, 129-130, 137-138, 139-139.5 of the window
    # 100-140
    assert got["idle_by_span"] == pytest.approx({
        trace.SPAN: 3.5e-6, "join.mbr.candidates": 4e-6, "join.mbr": 4e-6,
        "join.refine": 6e-6, "join.refine.chunks": 7e-6, "join.sync": 3e-6,
        spans.OUTSIDE: 4e-6})
    assert got["spans"]["join.refine"]["idle_s"] == pytest.approx(6e-6)
    # the worker's span is not on the joins' thread
    assert got["spans"]["join.filter"]["idle_s"] == 0.0
    stats = [{k: 0.0 for k in trace.STAGES}] * 2
    plain = trace.reduce(EVENTS, stats)
    assert sum(got["idle_by_span"].values()) == pytest.approx(
        plain["window_s"] - plain["busy_s"])


def test_a_trace_without_program_spans():
    """The parent's trace: every device second unattributed, every gap in
    the join spans or between them."""
    got = spans.reduce(PLAIN_EVENTS)
    assert got["spans"] == {}
    assert got["unattributed_s"] == pytest.approx(7e-6)
    assert got["idle_by_span"] == pytest.approx({trace.SPAN: 14e-6,
                                                 spans.OUTSIDE: 2e-6})
    with pytest.raises(RuntimeError, match="no join spans"):
        spans.reduce(PLAIN_EVENTS[3:])


NEW = ("refine_dead_chunk_pct", "build_dda_s", "build_pip_s",
       "build_pack_s")


def _stats(**extra):
    return {"n_candidates": 4, "extra": extra}


def _chunks(walked, live, n_frame, rows, **extra):
    return _stats(refine_chunks=walked, refine_chunks_live=live,
                  n_frame=n_frame, refine_chunk_rows=rows, **extra)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_without_the_counters(name):
    reader = harness.load_metric(name)
    assert reader.read(harness.Context()) is None
    parent = harness.Context(stats=[_stats(n_frame=9, n_escalated=0)])
    assert reader.read(parent) is None


@pytest.mark.parametrize("name,want", [
    ("refine_dead_chunk_pct", 100.0), ("build_dda_s", 1.5),
    ("build_pip_s", 2.5), ("build_pack_s", 0.5)])
def test_new_readers_read_the_counters(name, want):
    stages = {"dda": 1.5, "pip": 2.5, "pack": 0.5}
    ctx = harness.Context(stats=[
        _chunks(10, 1, 80, 8, build_stages=stages),
        _chunks(10, 3, 75, 8, build_stages={})])
    assert harness.load_metric(name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("joins,want", [
    # every chunk walked: 100, however many the filter leaves live
    ([(10, 1, 80, 8)], 100.0),
    ([(10, 9, 80, 8)], 100.0),
    # the dead chunks skipped
    ([(1, 1, 80, 8), (3, 3, 75, 8)], 0.0),
    # half of them skipped: (6 - 2) of (10 - 2)
    ([(6, 2, 80, 8)], 50.0),
    # no dead chunk to walk, and a join with an empty frame (no refine)
    ([(10, 10, 80, 8), (0, 0, 0, 0)], 0.0),
])
def test_dead_chunk_share(joins, want):
    ctx = harness.Context(stats=[_chunks(*j) for j in joins])
    got = harness.load_metric("refine_dead_chunk_pct").read(ctx)
    assert got == pytest.approx(want)


def _cpu_plan():
    from repro_torch.datagen.synthetic import make_dataset
    from repro_torch.spatial import JoinPlan

    R = make_dataset("T1", seed=0, count=120)
    S = make_dataset("T2", seed=1, count=200)
    return JoinPlan(R, S, filter="april", n_order=8, device="cpu",
                    pipeline_mode="fused",
                    build_opts={"build_backend": "torch"}).build()


def test_new_readers_read_a_fused_join_on_the_cpu():
    plan = _cpu_plan()
    _, st = plan.execute("intersects")
    ctx = harness.Context(stats=[st.to_dict()])
    got = {m: harness.load_metric(m).read(ctx) for m in NEW}
    assert got["refine_dead_chunk_pct"] == 0.0      # one chunk, live
    for s in ("dda", "pip", "pack"):
        assert got[f"build_{s}_s"] > 0
    assert sum(got[f"build_{s}_s"] for s in ("dda", "pip", "pack")) \
        <= plan._t_build
    assert np.isfinite(list(got.values())).all()


def test_dead_chunk_share_of_a_fused_join_in_many_chunks(monkeypatch):
    """A refine that walks every chunk of a frame of many reads 100."""
    from repro_torch.spatial import refine as RF

    plan = _cpu_plan()
    Va = RF.device_geometry(plan.R, "cpu")["verts"].shape[1]
    Vb = RF.device_geometry(plan.S, "cpu")["verts"].shape[1]
    monkeypatch.setattr(RF, "_FUSED_CHUNK_BYTES",
                        Va * Vb * RF._BYTES_PER_COUPLE * 20)
    _, st = plan.execute("intersects")
    x = st.extra
    assert x["refine_chunk_rows"] == 20
    assert x["refine_chunks"] == -(-x["n_frame"] // 20)
    assert x["refine_chunks"] > x["refine_chunks_live"] > 0
    ctx = harness.Context(stats=[st.to_dict()])
    assert harness.load_metric("refine_dead_chunk_pct").read(ctx) == 100.0
