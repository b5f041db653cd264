"""One run of one cell of the port's join benchmark.

``BENCHMARK.json`` at the checkout root names the cells. A cell names a
configuration (``configs/<name>.json``: the two layers, the filter, the
grid order and the pipeline mode) and a traffic mix
(``traffic/<name>.json``: the predicate the window's joins answer), and
each metric is read by ``metrics/<name>.py``, whose ``read(ctx)`` returns
the number or ``None`` when the run has nothing to read. A later cell,
configuration or metric is a new file and a new entry; no file here needs
an edit.

A run: set-up (CUDA, the layers from the seed, the plan's APRIL builds
with the torch backend, one warm-up join), then whole-layer joins back to
back on the resident layers until ``seconds`` are up (``--trace 1``: then
a profiled stretch of a few more), then the plain reference
(``reference.py``) once the program's state is freed, which every join's
pairs must equal.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import datagen, reference

__all__ = ["HERE", "ROOT", "FORBIDDEN", "LIMITS", "TRACED_JOINS", "Context",
           "load_benchmark", "cell", "resolve", "metric_names",
           "load_metric",
           "forbidden_modules", "run_cell", "mismatch", "result_line",
           "check_lines"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the result's compared numbers: name -> limit (an exact comparison)
LIMITS = {"mismatched_pairs": 0}
#: joins profiled after the window of a ``--trace 1`` run
TRACED_JOINS = 2


@dataclass
class Context:
    """What a metric's reader may read of a run. Times in seconds."""
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    joins: int = 0
    peak_window_bytes: int = 0
    phases: dict = field(default_factory=dict)   # host seconds by phase
    join_walls: list = field(default_factory=list)   # seconds, window
    stats: list = field(default_factory=list)   # JoinStats dicts, window
    trace: dict | None = None                    # trace.reduce of a stretch
    frame: dict | None = None      # n_rows, r_objects, s_objects
    lists: dict | None = None      # side -> "A"/"F" (rings) or "C"
    #                                (chains) -> interval counts


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _data(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None) -> dict:
    """The workload entry ``name`` with its configuration and traffic."""
    bench = bench or load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    return {**work, "config_data": config,
            "traffic_data": _data("traffic", work["traffic"])}


def metric_names(name: str, trace: bool, bench: dict | None = None
                 ) -> list[dict]:
    """The metrics a run of cell ``name`` reports: with ``trace`` its
    per-layer metrics, else its end-to-end ones."""
    bench = bench or load_benchmark()
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in moved]


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"joinbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> list[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    JAX's or the JAX package's, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules if names is None
                                          else names)}
    return sorted(tops & set(FORBIDDEN))


def _plan(config: dict, layers: dict, device):
    from repro_torch.core.rasterize import Extent
    from repro_torch.datagen.synthetic import PolygonDataset
    from repro_torch.spatial import JoinPlan

    R = PolygonDataset(config["layers"]["r"]["dataset"], *layers["r"])
    S = PolygonDataset(config["layers"]["s"]["dataset"], *layers["s"])
    return JoinPlan(R, S, filter=config["filter"], n_order=config["n_order"],
                    extent=Extent(*config["extent"]),
                    r_kind=config["layers"]["r"].get("kind", "polygon"),
                    filter_backend=config["filter_backend"],
                    refine_backend=config["refine_backend"],
                    mbr_backend=config["mbr_backend"],
                    pipeline_mode=config["pipeline_mode"],
                    build_opts={"build_backend": config["build_backend"]},
                    device=device)


def _lens(store) -> dict:
    """Per-object interval counts of a store: a chain's unit-cell list
    ``"C"`` (``LineCellStore``), or a ring's ``"A"`` and ``"F"`` lists."""
    if hasattr(store, "a_off"):
        return {"A": np.diff(store.a_off), "F": np.diff(store.f_off)}
    return {"C": np.diff(store.off)}


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve(name_or_spec, bench: dict | None = None) -> dict:
    """A cell spec: the dict :func:`cell` returns for a workload's name,
    or such a dict itself (a configuration run before it is a cell)."""
    if isinstance(name_or_spec, dict):
        return name_or_spec
    return cell(name_or_spec, bench)


def run_cell(name_or_spec, seed: int, seconds: float, trace: bool, *,
             t0: float | None = None, device="cuda",
             config_overrides: dict | None = None,
             bench: dict | None = None) -> dict:
    """Run a cell once, named or given as a spec (see :func:`resolve`);
    returns the result (see :func:`result_line`) with ``checks`` last.
    ``t0`` is the process's start on ``time.perf_counter``'s clock.
    ``device`` and ``config_overrides`` let the CPU tests run a cell at a
    small size."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    bench = bench or load_benchmark()
    spec = resolve(name_or_spec, bench)
    name = spec["name"]
    config = {**spec["config_data"], **(config_overrides or {})}
    predicate = spec["traffic_data"]["predicate"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
    ctx = Context()

    # -- set-up: data from the seed, builds, one warm-up join ---------------
    ctx.phases["start"] = time.perf_counter() - t0
    layers = datagen.layers(config, seed)
    plan = _plan(config, layers, dev)
    tb = time.perf_counter()
    ctx.phases["data"] = tb - t0 - ctx.phases["start"]
    plan.build()
    _sync(dev)
    ctx.build_s = time.perf_counter() - tb
    plan.execute(predicate)
    _sync(dev)
    ctx.setup_s = time.perf_counter() - t0
    ctx.phases["warm_join"] = ctx.setup_s - (tb - t0) - ctx.build_s

    # -- the window ---------------------------------------------------------
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    results = []
    tw = time.perf_counter()
    deadline = tw + seconds
    now = tw
    while now < deadline:
        res, st = plan.execute(predicate)
        results.append(res)
        ctx.stats.append(st.to_dict())
        t = time.perf_counter()
        ctx.join_walls.append(t - now)
        now = t
    ctx.window_s = now - tw
    ctx.joins = len(results)
    if cuda:
        ctx.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
    tt = time.perf_counter()
    if trace:
        from . import trace as tr
        traced, ctx.trace = tr.profile(lambda: plan.execute(predicate),
                                       TRACED_JOINS)
        results += [res for res, _ in traced]
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
    ctx.lists = {"r": _lens(plan.approx_r.store),
                 "s": _lens(plan.approx_s.store)}

    ctx.phases["traced"] = time.perf_counter() - tt

    # -- the reference, once the program's state is freed -------------------
    tr0 = time.perf_counter()
    del plan
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    (vr, nr), (vs, ns) = layers["r"], layers["s"]
    cand, keep = reference.candidates_and_answers(vr, nr, vs, ns, predicate,
                                                  device=dev)
    want = reference.pair_keys(cand[keep], len(ns))
    ctx.frame = {"n_rows": len(cand), "r_objects": np.unique(cand[:, 0]),
                 "s_objects": np.unique(cand[:, 1])}
    bad, last = [], None
    for res in results:
        # a join that returned the same array as the last one compared
        # has the same mismatches
        if last is None or not np.array_equal(res, last[0]):
            last = (res, mismatch(reference.pair_keys(res, len(ns)), want))
        bad.append(last[1])
    ctx.phases["reference"] = time.perf_counter() - tr0

    metrics = {}
    for m in metric_names(name, trace, bench):
        v = load_metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": sum(bad) <= LIMITS["mismatched_pairs"],
           "attempted": len(results), "failed": sum(b > 0 for b in bad),
           "metrics": metrics, "device": _device(dev, peak, ctx, trace)}
    if trace:
        out["breakdown"] = _breakdown(ctx.trace)
    stages = {k: float(np.mean([st[k] for st in ctx.stats]))
              for k in ("t_mbr", "t_filter", "t_refine", "t_sync")}
    out["phases"] = dict(ctx.phases, build=ctx.build_s, window=ctx.window_s,
                         joins=ctx.join_walls, stages=stages)
    out["checks"] = {"mismatched_pairs": {
        "value": int(sum(bad)), "limit": LIMITS["mismatched_pairs"]}}
    return out


def mismatch(got: np.ndarray, want: np.ndarray) -> int:
    """Pairs in one set and not the other, plus repeated pairs."""
    uniq = np.unique(got)
    return len(np.setxor1d(uniq, want, assume_unique=True)) \
        + len(got) - len(uniq)


def _device(dev, peak: int, ctx: Context, trace: bool) -> dict:
    import torch
    cuda = dev.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        out["busy_s"] = ctx.trace["busy_s"]
        out["window_s"] = ctx.trace["window_s"]
    return out


def _breakdown(tr: dict) -> dict:
    ops = sorted(((k, v["seconds"]) for k, v in tr["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr["idle_by_stage"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in ops],
            "idle_gaps": [[f"host in {k}", v] for k, v in gaps]}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def check_lines(out: dict) -> list[str]:
    """The compared numbers beside their limits, one line each."""
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in out["checks"].items()]


def result_line(out: dict) -> str:
    """The run's last line of standard output: one JSON object."""
    return json.dumps(out)
