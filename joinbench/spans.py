"""The program's own spans in a profiled stretch of whole joins.

The port opens a span in the profiler's trace for each stage of its fused
chain and of its builds (``StageClock``: ``join.*``, ``build.*``), on the
profiler's clock beside the device's kernels. :func:`reduce` ties each
kernel, copy and set to the span that launched it, through the
``correlation`` id its launch call (``cuda_runtime`` or ``cuda_driver``)
shares with it, and names each idle gap of the device by the span the
host was in:

* ``spans``: for each program span name, ``host_s`` (the sum of its
  durations), ``device_s`` and ``launches`` (the device operations whose
  launch call ran while it was the innermost open span on its thread),
  ``idle_s`` (the device idle while it was the innermost open span on the
  joins' thread) and ``parents`` (the names of the spans that enclosed
  it);
* ``unattributed_s``: device seconds in the window whose launch lies in
  no program span;
* ``idle_by_span``: each idle gap split by the innermost span open on the
  joins' thread, the benchmark's ``joinbench.join`` included, and
  ``between joins``.

The window and the busy time are ``trace.reduce``'s, over the same
events. No run of the benchmark reads this module yet: ``trace.profile``
keeps only its own reduction of the events.
"""
from __future__ import annotations

import bisect

from joinbench import trace

__all__ = ["PROGRAM", "OUTSIDE", "reduce", "span_total"]

#: name prefixes of the program's spans
PROGRAM = ("join.", "build.")
#: the name of the host's time outside every span
OUTSIDE = "between joins"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _nest(spans: list) -> tuple[list, list]:
    """(pieces, parents) of one thread's properly nested ``(start, end,
    name)`` spans: the pieces ``(start, end, name)`` of the time they
    cover, each named by the innermost span open there, and each span's
    ``(name, parent name or None)``."""
    pieces, parents, stack = [], [], []
    at = None

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            if end > at:
                pieces.append((at, end, name))
                at = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if at is None:
            at = s
        close_until(s)
        if stack and s > at:
            pieces.append((at, s, stack[-1][1]))
        at = max(at, s)
        parents.append((name, stack[-1][1] if stack else None))
        stack.append((e, name))
    if stack:
        close_until(float("inf"))
    return pieces, parents


def _named(pieces: list, w0: float, w1: float) -> list:
    """``pieces`` cut to [w0, w1], the gaps between them named
    ``OUTSIDE``."""
    out, at = [], w0
    for s, e, name in pieces:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > at:
            out.append((at, s, OUTSIDE))
        out.append((s, e, name))
        at = e
    if at < w1:
        out.append((at, w1, OUTSIDE))
    return out


def reduce(events: list) -> dict:
    """``spans``, ``unattributed_s`` and ``idle_by_span`` of the stretch of
    ``events`` (Chrome trace events, times in µs) that the benchmark's
    ``trace.SPAN`` spans cover. Seconds throughout."""
    annotations = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and (e.get("name") == trace.SPAN
                        or e.get("name", "").startswith(PROGRAM))]
    joins = [e for e in annotations if e["name"] == trace.SPAN]
    if not joins:
        raise RuntimeError("the trace holds no join spans")
    w0 = min(float(e["ts"]) for e in joins)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in joins)
    by_thread: dict[tuple, list] = {}
    for e in annotations:
        s = float(e["ts"])
        by_thread.setdefault(_thread(e), []).append(
            (s, s + float(e["dur"]), e["name"]))
    timelines, spans = {}, {}
    for th, sp in by_thread.items():
        pieces, parents = _nest(sp)
        timelines[th] = _named(pieces, w0, w1)
        for name, parent in parents:
            if name.startswith(PROGRAM):
                acc = spans.setdefault(name, {
                    "host_s": 0.0, "device_s": 0.0, "launches": 0,
                    "idle_s": 0.0, "parents": set()})
                acc["parents"].add(parent)
        for s, e, name in sp:
            if name.startswith(PROGRAM):
                spans[name]["host_s"] += max(0.0, min(e, w1) - max(s, w0)) \
                    * 1e-6
    starts = {th: [p[0] for p in tl] for th, tl in timelines.items()}

    def innermost(th, t):
        tl = timelines.get(th)
        if not tl:
            return None
        i = bisect.bisect_right(starts[th], t) - 1
        return tl[i][2] if i >= 0 and t < tl[i][1] else None

    owner = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X":
            corr = e.get("args", {}).get("correlation")
            name = innermost(_thread(e), float(e["ts"]))
            if corr is not None and name is not None \
                    and name.startswith(PROGRAM):
                owner[corr] = name
    unattributed, intervals = 0.0, []
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or e.get("ph") != "X":
            continue
        s = float(e["ts"])
        s0, s1 = max(s, w0), min(s + float(e.get("dur", 0.0)), w1)
        if s1 <= s0:
            continue
        intervals.append((s0, s1))
        name = owner.get(e.get("args", {}).get("correlation"))
        if name is None:
            unattributed += (s1 - s0) * 1e-6
        else:
            spans[name]["device_s"] += (s1 - s0) * 1e-6
            spans[name]["launches"] += 1
    busy = trace._union(intervals)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    idle: dict[str, float] = {}
    th = _thread(joins[0])
    tl = timelines[th]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        i = max(0, bisect.bisect_right(starts[th], g0) - 1)
        while i < len(tl) and tl[i][0] < g1:
            s0, s1, name = tl[i]
            d = min(g1, s1) - max(g0, s0)
            if d > 0:
                idle[name] = idle.get(name, 0.0) + d * 1e-6
            i += 1
    for name, acc in spans.items():
        acc["idle_s"] = idle.get(name, 0.0)
        acc["parents"] = sorted(p or "" for p in acc["parents"])
    return {"spans": spans, "unattributed_s": unattributed,
            "idle_by_span": idle}


def span_total(reduced: dict, name: str, key: str) -> float:
    """The sum of ``key`` over span ``name`` and its children."""
    return sum(v[key] for n, v in reduced["spans"].items()
               if n == name or n.startswith(name + "."))
