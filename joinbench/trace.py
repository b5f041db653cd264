"""A profiled stretch of whole joins, reduced to what the metrics read.

``profile(fn, n)`` runs ``fn`` ``n`` times under ``torch.profiler``, each
call inside a ``joinbench.join`` span of the benchmark's own, writes the
Chrome trace to a temporary directory (under ``TMPDIR``), and reduces it
with :func:`reduce`: the device's busy time as the union of its kernel,
memcpy and memset intervals (overlapping streams counted once), the
device seconds and launches of each kernel name, and the idle gaps, each
split by the stage of its join that the host was in (the join's
``JoinStats`` stage times laid end to end from its span's start).
"""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

__all__ = ["SPAN", "kernel_name", "profile", "reduce"]

SPAN = "joinbench.join"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("t_mbr", "t_filter", "t_refine", "t_sync")


def kernel_name(event: dict) -> str:
    """A device event's name without its argument list or template
    arguments ("void f<int>(...)" -> "f"); copies and sets by category."""
    if event.get("cat") != "kernel":
        return event.get("cat", "")
    name = event["name"].replace("(anonymous namespace)::", "")
    return name.split("(")[0].removeprefix("void ").split("<")[0][:100]


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _segments(spans, stats):
    """(start, end, name) pieces of the traced stretch: each join's stages
    laid end to end from its span's start, what the span holds past them
    ("after sync"), and the time between spans ("between joins")."""
    out, prev = [], spans[0][0]
    for (s, e), st in zip(spans, stats):
        if s > prev:
            out.append((prev, s, "between joins"))
        at = s
        for k in STAGES:
            end = min(at + st[k] * 1e6, e)
            out.append((at, end, k[2:]))
            at = end
        if at < e:
            out.append((at, e, "after sync"))
        prev = e
    return out


def reduce(events: list, stats: list) -> dict:
    """The traced stretch of ``events`` (Chrome trace events, times in µs)
    whose ``SPAN`` spans line up with ``stats`` (one ``JoinStats`` dict a
    join). Seconds throughout."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("name") == SPAN and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    if len(spans) != len(stats):
        raise RuntimeError(f"the trace holds {len(spans)} join spans, not "
                           f"{len(stats)}")
    w0, w1 = spans[0][0], spans[-1][1]
    kernels: dict[str, list] = {}
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        s0, s1 = max(s, w0), min(s + d, w1)
        if s1 <= s0:
            continue
        intervals.append((s0, s1))
        acc = kernels.setdefault(kernel_name(e), [0.0, 0])
        acc[0] += (s1 - s0) * 1e-6
        acc[1] += 1
    busy = _union(intervals)
    idle: dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    pieces = _segments(spans, stats)
    for g0, g1 in zip(edges[::2], edges[1::2]):
        for s0, s1, name in pieces:
            d = min(g1, s1) - max(g0, s0)
            if d > 0:
                idle[name] = idle.get(name, 0.0) + d * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernels": {k: {"seconds": v[0], "launches": v[1]}
                    for k, v in kernels.items()},
        "idle_by_stage": idle,
        "joins": len(spans),
    }


def profile(fn, n: int) -> tuple[list, dict]:
    """(the ``n`` values of ``fn()``, the reduced trace). ``fn`` returns
    (anything, a ``JoinStats``-like object with ``to_dict``). The trace
    starts on a step that runs one small device op, so that the first
    record of the joins' step is not lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, \
        schedule

    out, traces = [], []

    def keep(prof) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            with open(path) as f:
                traces.append(json.load(f)["traceEvents"])

    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                  on_trace_ready=keep) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            with torch.profiler.record_function(SPAN):
                out.append(fn())
            torch.cuda.synchronize()
        prof.step()
    if len(traces) != 1:
        raise RuntimeError(f"the profiler gave {len(traces)} traces, not 1")
    stats = [st.to_dict() for _, st in out]
    return out, reduce(traces[0], stats)
