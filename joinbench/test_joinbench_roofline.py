"""The byte counts, hand counted, and the trace reduction on a trace
written by hand."""
import numpy as np
import pytest

from joinbench import harness, roofline, trace

R_LENS = {"A": np.array([2, 5, 1]), "F": np.array([1, 0, 3])}
S_LENS = {"A": np.array([4, 7]), "F": np.array([2, 2])}


def test_b1_bytes_hand_counted():
    # rows (0,1), (2,1), (0,1): R objects {0, 2}, S objects {1}
    # R lists: A 2 + 1, F 1 + 3 -> 7 intervals; S: A 7, F 2 -> 9
    # 16 intervals x 8 bytes + 3 rows x (8 + 8 + 1) bytes = 128 + 51
    got = roofline.b1_bytes(3, np.array([0, 2]), np.array([1]), R_LENS,
                            S_LENS)
    assert got == 179


def test_b4_bytes_hand_counted():
    # the A lists only: R 2 + 1, S 7 -> 10 x 8 + 3 x 17
    got = roofline.b4_bytes(3, np.array([0, 2]), np.array([1]), R_LENS,
                            S_LENS)
    assert got == 131


def test_c_bytes_hand_counted():
    # chains 0 and 2 name C lists of 3 and 6 intervals; S object 1: A 7,
    # F 2 -> 18 x 8 + 3 x 17
    got = roofline.c_bytes(3, np.array([0, 2]), np.array([1]),
                           {"C": np.array([3, 1, 6])}, S_LENS)
    assert got == 195


def test_share_pct():
    assert roofline.share_pct(3.35e9, 0.01) == pytest.approx(10.0)


def _ev(cat, name, ts, dur, ph="X"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": ph}


STATS = [{"t_mbr": 4e-6, "t_filter": 1e-6, "t_refine": 3e-6, "t_sync": 1e-6},
         {"t_mbr": 4e-6, "t_filter": 1e-6, "t_refine": 3e-6, "t_sync": 1e-6}]
EVENTS = [
    _ev("user_annotation", trace.SPAN, 100, 10),
    _ev("user_annotation", trace.SPAN, 112, 10),
    _ev("gpu_user_annotation", trace.SPAN, 100, 22),
    # join 1: idle while the host hashes MBRs (100-104), B1 at 104-106,
    # two streams overlapping 106-109, idle 109-110 (sync), 110-112
    # between joins; join 2 only a copy at 117-118
    _ev("kernel", "void april_trichotomy_kernel<8>(int const*, int)", 104, 2),
    _ev("kernel", "(anonymous namespace)::refine_core(double)", 106, 3),
    _ev("kernel", "elementwise_kernel", 107, 1),
    _ev("gpu_memcpy", "Memcpy DtoH", 117, 1),
    _ev("kernel", "outside_the_window", 10, 5),
    _ev("cpu_op", "aten::add", 104, 2),
]


def test_trace_reduce():
    got = trace.reduce(EVENTS, STATS)
    assert got["joins"] == 2
    assert got["window_s"] == pytest.approx(22e-6)
    assert got["busy_s"] == pytest.approx(6e-6)
    k = got["kernels"]
    assert k["april_trichotomy_kernel"] == {"seconds": pytest.approx(2e-6),
                                            "launches": 1}
    assert k["refine_core"]["launches"] == 1
    assert k["gpu_memcpy"]["launches"] == 1
    assert "outside_the_window" not in k
    idle = got["idle_by_stage"]
    # join 1: mbr 100-104, after sync 109-110; between 110-112; join 2:
    # mbr 112-116, filter 116-117, refine 118-120, sync 120-121, after
    # sync 121-122
    assert idle == pytest.approx({"mbr": 8e-6, "filter": 1e-6,
                                  "refine": 2e-6, "sync": 1e-6,
                                  "after sync": 2e-6,
                                  "between joins": 2e-6})
    assert sum(idle.values()) == pytest.approx(got["window_s"]
                                               - got["busy_s"])


def test_trace_reduce_needs_every_join_span():
    with pytest.raises(RuntimeError, match="join spans"):
        trace.reduce(EVENTS[1:], STATS)


@pytest.mark.parametrize("metric", ["b1_roofline", "b4_roofline"])
def test_roofline_reader_fails_without_its_kernel(metric):
    ctx = harness.Context(trace={
        "kernels": {}, "busy_s": 1.0, "window_s": 2.0})
    with pytest.raises(RuntimeError, match="shows no"):
        harness.load_metric(metric).read(ctx)


def test_readers_return_nothing_without_a_trace():
    ctx = harness.Context()
    for m in ("b1_roofline", "b4_roofline", "device_idle_pct"):
        assert harness.load_metric(m).read(ctx) is None


def test_b1_reader_reads_the_trace():
    ctx = harness.Context(
        trace={"kernels": {"april_trichotomy_kernel": {
            "seconds": 179 * 2 / roofline.HBM_BYTES_PER_S * 4,
            "launches": 2}}, "busy_s": 1.0, "window_s": 2.0},
        frame={"n_rows": 3, "r_objects": np.array([0, 2]),
               "s_objects": np.array([1])},
        lists={"r": R_LENS, "s": S_LENS})
    assert harness.load_metric("b1_roofline").read(ctx) == \
        pytest.approx(25.0)
    assert harness.load_metric("device_idle_pct").read(ctx) == \
        pytest.approx(50.0)
