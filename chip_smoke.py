#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; imports nothing of JAX or of the
reference package. Phases, any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (``build/kernels/``);
3. hold the filter kernels against their plain PyTorch versions on the
   card, exactly: the trichotomy kernel, and the overlap kernel's AA join,
   on the first 65,536 candidate rows of the T1 x T2 join and on every
   row with a list wider than 256 intervals; the overlap kernel's AF and
   FA joins on every AA survivor;
4. the main path, ``JoinPlan(R, S, filter="april", n_order=12)
   .build().execute("intersects")`` on the card with both backends
   ``"cuda"``, once with the default join order and once with the
   degenerate order ("AA", "AF") that routes the filter through the
   overlap kernel; launch counts are reset before and read after each run,
   and each run's pairs and their order must equal the port's own numpy
   backends, and a sample of candidates must agree with the float64
   per-pair oracle; the edge sweep's inputs are recorded in both runs
   (``refine.record_sweeps``) and the kernel is held exactly against its
   plain version on every recorded bucket;
5. each main path once more under ``torch.profiler``: device time per
   kernel and the device busy share of the host wall time;
6. each kernel timed at the main path's shapes with CUDA events beside
   its plain version, printed as one JSON ``kernels`` line.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per (a edge, b edge) couple of the sweep: 4 x 7 for
#: the orientations, 4 sign tests, 11 scale, 7 mag, 3 tol, 8 near0, 16 boxes
SWEEP_OPS_PER_COUPLE = 77
#: first candidate rows held against the plain versions in phase 3
COMPARE_ROWS = 65536
#: timed calls per kernel and plain version in phase 6
REPS = 5


def _ms(fn) -> float:
    """Mean device milliseconds of ``fn`` over ``REPS`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device events
    of its Chrome trace: microseconds per kernel name and per copy kind,
    and the device busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = e["cat"]
            if key == "kernel":     # the name without its argument list
                key = e["name"].replace("(anonymous namespace)::", "")
                key = key.split("(")[0][:100]
            by_name[key] = by_name.get(key, 0.0) + float(e.get("dur", 0.0))
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_busy_share": busy / wall_us, "top_device_us": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--r-count", type=int, default=3600)
    ap.add_argument("--s-count", type=int, default=12000)
    ap.add_argument("--n-order", type=int, default=12)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np
    from repro_torch import JoinPlan, make_dataset
    from repro_torch.core import geometry
    from repro_torch.kernels import _build
    from repro_torch.kernels.interval_join import (
        april_trichotomy, april_trichotomy_plain, interval_overlap,
        interval_overlap_plain)
    from repro_torch.kernels.refine import edges_intersect, edges_intersect_plain
    from repro_torch.spatial import refine as refine_mod

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    # 2. build every kernel from source
    t0 = time.perf_counter()
    per_lib = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"{json.dumps({k: round(v, 1) for k, v in per_lib.items()})}",
          flush=True)

    # 3. kernels against their plain versions on the card, exactly
    t0 = time.perf_counter()
    R = make_dataset("T1", seed=0, count=args.r_count)
    S = make_dataset("T2", seed=1, count=args.s_count)
    plan = JoinPlan(R, S, filter="april", n_order=args.n_order).build()
    cands = plan.candidates("intersects")
    print(f"host: datasets + APRIL build + candidates "
          f"{time.perf_counter() - t0:.1f} s, {len(cands)} candidates",
          flush=True)
    lists = {k: plan.filter._lists(a, kind).to(dev)
             for k, a, kind in (("xa", plan.approx_r, "A"),
                                ("xf", plan.approx_r, "F"),
                                ("ya", plan.approx_s, "A"),
                                ("yf", plan.approx_s, "F"))}
    ri_all = torch.from_numpy(cands[:, 0].copy()).to(dev)
    si_all = torch.from_numpy(cands[:, 1].copy()).to(dev)
    # the first candidate rows, and every row with a list wider than the
    # 256 intervals the TPU kernel's VMEM tile took
    width = np.maximum.reduce([
        plan.filter._lists(a, kind).counts(cands[:, c])
        for a, c in ((plan.approx_r, 0), (plan.approx_s, 1))
        for kind in ("A", "F")])
    wide = np.nonzero(width > 256)[0]
    sel = torch.from_numpy(np.union1d(np.arange(min(COMPARE_ROWS,
                                                    len(cands))), wide))
    ri, si = ri_all[sel.to(dev)], si_all[sel.to(dev)]
    print(f"compare rows: {len(ri)}, of them {len(wide)} with a list wider "
          f"than 256 (widest {int(width.max())}); tolerance: exact",
          flush=True)
    tri = (lists["xa"], lists["xf"], lists["ya"], lists["yf"])
    got = april_trichotomy(*tri, ri, si)
    want = april_trichotomy_plain(*tri, ri, si)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("april_trichotomy kernel != plain version")
    # the overlap kernel on each list pairing a join order gives it: AA
    # over the compared rows, AF and FA over every AA survivor
    aa = interval_overlap_plain(lists["xa"], lists["ya"], ri_all, si_all)
    ri_aa, si_aa = ri_all[aa], si_all[aa]
    for x, y, rows in (("xa", "ya", (ri, si)), ("xa", "yf", (ri_aa, si_aa)),
                       ("xf", "ya", (ri_aa, si_aa))):
        got = interval_overlap(lists[x], lists[y], *rows)
        want = interval_overlap_plain(lists[x], lists[y], *rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"interval_overlap kernel != plain version "
                                 f"on {x} x {y}")
    print(f"phase 3 ok: trichotomy and overlap kernels == plain versions; "
          f"{len(ri_aa)} AA survivors", flush=True)

    # 4. the main path, default order then the degenerate order; the edge
    # sweep's inputs are recorded from the path itself
    launches, results, stats, sweeps = {}, {}, {}, {}
    for label, opts in (("default", {}),
                        ("degenerate", {"order": ("AA", "AF")})):
        for fn in (april_trichotomy, interval_overlap, edges_intersect):
            fn.launches = 0
        t0 = time.perf_counter()
        run = JoinPlan(R, S, filter="april", n_order=args.n_order,
                       filter_opts=opts).build(
            prebuilt=(plan.approx_r, plan.approx_s))
        with refine_mod.record_sweeps() as sweeps[label]:
            res, st = run.execute("intersects")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = {fn.__name__: fn.launches for fn in
                           (april_trichotomy, interval_overlap,
                            edges_intersect)}
        print(f"main path [{label}] {wall:.2f} s launches "
              f"{json.dumps(launches[label])}", flush=True)
        print(json.dumps(st.to_dict()), flush=True)
        t0 = time.perf_counter()
        ref, rst = JoinPlan(R, S, filter="april", n_order=args.n_order,
                            filter_opts=opts, filter_backend="numpy",
                            refine_backend="numpy").build(
            prebuilt=(plan.approx_r, plan.approx_s)).execute("intersects")
        print(f"numpy reference [{label}] {time.perf_counter() - t0:.2f} s",
              flush=True)
        if res.shape != ref.shape or not np.array_equal(res, ref):
            raise AssertionError(f"[{label}] cuda pairs != numpy pairs")
        for k in ("n_candidates", "n_true_hits", "n_true_negs",
                  "n_indecisive", "n_results"):
            if getattr(st, k) != getattr(rst, k):
                raise AssertionError(f"[{label}] {k} differs")
        results[label] = res
        stats[label] = st
    need = {"default": ("april_trichotomy", "edges_intersect"),
            "degenerate": ("interval_overlap", "edges_intersect")}
    for label, names in need.items():
        for name in names:
            if launches[label][name] <= 0:
                raise AssertionError(f"[{label}] {name} never launched")
    by_pair = [r[np.lexsort(r.T[::-1])] for r in results.values()]
    if not np.array_equal(*by_pair):
        raise AssertionError("the two join orders give different pair sets")
    res = results["default"]
    if res.ndim != 2 or res.shape[1] != 2 or res.dtype != np.int64 \
            or len(res) == 0:
        raise AssertionError(f"bad result array {res.dtype} {res.shape}")
    rng = np.random.default_rng(0)
    sample = cands[rng.choice(len(cands), size=min(512, len(cands)),
                              replace=False)]
    in_res = set(map(tuple, res.tolist()))
    for i, j in sample:
        exact = geometry.polygons_intersect(R.verts[i], R.nverts[i],
                                            S.verts[j], S.nverts[j])
        if exact != ((int(i), int(j)) in in_res):
            raise AssertionError(f"pair ({i}, {j}) disagrees with the "
                                 "float64 oracle")
    # the edge sweep kernel against its plain version on every bucket the
    # two main path runs gave it
    n_diff = 0
    for t in sweeps["default"] + sweeps["degenerate"]:
        kh, ku = edges_intersect(*t)
        ph, pu = edges_intersect_plain(*t)
        n_diff += int((kh != ph).sum()) + int((ku != pu).sum())
    torch.cuda.synchronize()
    if n_diff:
        raise AssertionError(f"edges_intersect kernel != plain version on "
                             f"{n_diff} lanes")
    print(f"phase 4 ok: pairs and order == numpy path; {len(sample)} "
          "sampled candidates == float64 oracle; edge sweep kernel == plain "
          f"version on {len(sweeps['default'])} + "
          f"{len(sweeps['degenerate'])} recorded buckets", flush=True)

    # 5. where the device time of each main path goes
    for label, opts in (("default", {}),
                        ("degenerate", {"order": ("AA", "AF")})):
        run = JoinPlan(R, S, filter="april", n_order=args.n_order,
                       filter_opts=opts).build(
            prebuilt=(plan.approx_r, plan.approx_s))
        prof = _profile(lambda: run.execute("intersects"))
        print(f"profile [{label}]: {json.dumps(prof)}", flush=True)

    # 6. kernels at the main path's shapes, beside their plain versions
    rows = ri_all.numel()
    tri_bytes = _nbytes(*(t for L in tri for t in L), ri_all, si_all) + rows
    ov_bytes = _nbytes(*lists["xa"], *lists["ya"], ri_all, si_all) + rows
    k_tri = april_trichotomy(*tri, ri_all, si_all)
    p_tri = april_trichotomy_plain(*tri, ri_all, si_all)
    k_ov = interval_overlap(lists["xa"], lists["ya"], ri_all, si_all)
    p_ov = interval_overlap_plain(lists["xa"], lists["ya"], ri_all, si_all)
    sw = sweeps["default"]
    sweep_err = 0
    for t in sw:
        kh, ku = edges_intersect(*t)
        ph, pu = edges_intersect_plain(*t)
        sweep_err = max(sweep_err, int((kh != ph).sum() > 0),
                        int((ku != pu).sum() > 0))
    # the couples of edges the CMBR masks keep, and the kernel's bytes:
    # float32 endpoints and a mask byte per edge, two verdict bytes per row
    couples = sum(int((t[2].sum(1) * t[5].sum(1)).sum()) for t in sw)
    sweep_bytes = sum(t[0].shape[0] * ((t[0].shape[1] + t[3].shape[1]) * 17
                                       + 2) for t in sw)
    timings = {
        "april_trichotomy": (
            _ms(lambda: april_trichotomy(*tri, ri_all, si_all)),
            _ms(lambda: april_trichotomy_plain(*tri, ri_all, si_all))),
        "interval_overlap": (
            _ms(lambda: interval_overlap(lists["xa"], lists["ya"], ri_all,
                                         si_all)),
            _ms(lambda: interval_overlap_plain(lists["xa"], lists["ya"],
                                               ri_all, si_all))),
        "edges_intersect": (
            _ms(lambda: [edges_intersect(*t) for t in sw]),
            _ms(lambda: [edges_intersect_plain(*t) for t in sw])),
    }
    bounds = {
        "april_trichotomy": (tri_bytes, 0),
        "interval_overlap": (ov_bytes, 0),
        "edges_intersect": (sweep_bytes, couples * SWEEP_OPS_PER_COUPLE),
    }
    errs = {
        "april_trichotomy": int((k_tri.int() - p_tri.int()).abs().max()),
        "interval_overlap": int((k_ov.int() - p_ov.int()).abs().max()),
        "edges_intersect": sweep_err,
    }
    meta = {
        "april_trichotomy": ("src/repro_torch/csrc/interval_join.cu",
                             "src/repro/kernels/interval_join/"
                             "interval_join.py:118", "default"),
        "interval_overlap": ("src/repro_torch/csrc/interval_join.cu",
                             "src/repro/kernels/interval_join/"
                             "interval_join.py:56", "degenerate"),
        "edges_intersect": ("src/repro_torch/csrc/refine.cu",
                            "src/repro/kernels/refine/refine.py:85",
                            "default"),
    }
    kernels = []
    for name, (source, replaces, run_label) in meta.items():
        nbytes, ops = bounds[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        ms, plain_ms = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[run_label][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    if any(k["max_abs_err"] for k in kernels):
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the main path's shapes")
    print(f"shapes: {rows} candidate rows, "
          f"{stats['default'].n_indecisive} INDECISIVE rows, "
          f"{couples} edge couples kept by the CMBR masks; reps {REPS}; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
