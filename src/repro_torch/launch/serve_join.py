"""Online spatial-join serving launcher.

  PYTHONPATH=src python -m repro_torch.launch.serve_join --queries 200
  PYTHONPATH=src python -m repro_torch.launch.serve_join --device cpu \\
      --queries 40 --mutate-every 10 --plan-mode adaptive

Stands up a long-lived :class:`~repro_torch.spatial.service.JoinService`
(warm stores behind the LRU store cache, a warm MBR bucket index, the
micro-batching worker) on ``--device`` (default ``cuda``) and drives a
seeded traffic trace into it: a mix of ``selection`` / ``window`` /
``intersects`` / ``within`` queries whose polygons come from a second
synthetic layer over the same map, with an ``insert`` and a ``delete``
every ``--mutate-every`` requests, which the stores take as incremental
patches. Prints a JSON report: queries/s, p50/p99 latency with the summed
per-stage times (``t_mbr``/``t_filter``/``t_refine``/``t_sync``), cache
hits and evictions and the service counters (``replans`` with
``--plan-mode adaptive``). ``--ckpt-dir`` persists the stores and the
mutation log every ``--ckpt-every`` requests and resumes from the latest
step on restart. The trace is drawn as the reference package's launcher
draws it, so the same seed gives the same requests.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..datagen import make_dataset
from ..runtime.checkpoint import CheckpointManager
from ..spatial import JoinService
from ..spatial.filters import available_filters

__all__ = ["make_trace", "run_serve", "main"]

_PREDICATE_MIX = ("selection", "selection", "window", "intersects", "within")


def make_trace(rng: np.random.Generator, queries, n_requests: int):
    """Seeded request trace: (predicate, query payload) tuples."""
    trace = []
    for _ in range(n_requests):
        pred = _PREDICATE_MIX[rng.integers(len(_PREDICATE_MIX))]
        if pred == "window":
            c = rng.uniform(0.1, 0.9, 2)
            w = rng.uniform(0.02, 0.2, 2)
            payload = (c[0] - w[0], c[1] - w[1], c[0] + w[0], c[1] + w[1])
        else:
            qi = int(rng.integers(len(queries)))
            payload = queries.verts[qi, : queries.nverts[qi]]
        trace.append((pred, payload))
    return trace


def run_serve(dataset: str = "T1", count: int | None = 300,
              query_layer: str = "T2", n_queries: int = 60,
              n_requests: int = 100, method: str = "april",
              n_order: int = 8, filter_backend: str | None = None,
              mbr_backend: str = "numpy", refine_backend: str | None = None,
              pipeline_mode: str = "staged", plan_mode: str = "static",
              window_ms: float = 2.0, cache_mb: float = 256.0,
              mutate_every: int = 25, ckpt_dir: str | None = None,
              ckpt_every: int = 50, seed: int = 0,
              background: bool = True, device=None) -> dict:
    """Drive ``n_requests`` trace requests through a warm service on
    ``device`` (``None`` -> ``"cuda"``); returns the report dict
    (queries/s, latency, cache and service stats, ``results_total``).
    Without ``background`` the caller's thread drains every 8 pending
    requests, so the batches do not depend on timing."""
    rng = np.random.default_rng(seed)
    D = make_dataset(dataset, seed=seed, count=count)
    Q = make_dataset(query_layer, seed=seed + 1, count=n_queries)
    opts = dict(window_s=window_ms / 1e3,
                cache_bytes=int(cache_mb * (1 << 20)),
                filter_backend=filter_backend, mbr_backend=mbr_backend,
                refine_backend=refine_backend, pipeline_mode=pipeline_mode,
                plan_mode=plan_mode, device=device)

    svc = None
    mgr = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, async_save=False)
        svc = JoinService.restore_checkpoint(mgr, **opts)
    if svc is None:
        svc = JoinService(method=method, n_order=n_order, **opts)
        svc.register_dataset(dataset, D)

    trace = make_trace(rng, Q, n_requests)
    if background:
        svc.start()
    t0 = time.perf_counter()
    tickets = []
    step = 0
    for i, (pred, payload) in enumerate(trace):
        tickets.append(svc.submit(dataset, pred, payload))
        if mutate_every and (i + 1) % mutate_every == 0:
            # grow and shrink: the dataset size stays about constant
            qi = int(rng.integers(len(Q)))
            svc.insert(dataset, Q.verts[qi, : Q.nverts[qi]])
            svc.delete(dataset, int(rng.integers(len(svc.dataset(dataset)))))
        if mgr is not None and (i + 1) % ckpt_every == 0:
            step += 1
            svc.save_checkpoint(mgr, step)
        if not background and len(svc._pending) >= 8:
            svc.drain()
    if background:
        svc.stop()
    else:
        svc.drain()
    for t in tickets:
        t.wait(timeout=60.0)
    elapsed = time.perf_counter() - t0
    if mgr is not None:
        step += 1
        svc.save_checkpoint(mgr, step)

    return {
        "dataset": dataset, "method": method, "n_order": n_order,
        "pipeline_mode": pipeline_mode, "plan_mode": plan_mode,
        "device": str(svc.device), "n_requests": n_requests,
        "elapsed_s": elapsed,
        "queries_per_s": n_requests / max(elapsed, 1e-9),
        "latency": svc.latency_stats(),
        "cache": dict(svc.cache.stats),
        "service": dict(svc.stats),
        "results_total": int(sum(len(t.pairs) for t in tickets)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="T1")
    ap.add_argument("--count", type=int, default=300)
    ap.add_argument("--query-layer", default="T2")
    ap.add_argument("--n-queries", type=int, default=60)
    ap.add_argument("--queries", type=int, default=100,
                    help="requests in the simulated traffic trace")
    ap.add_argument("--method", default="april",
                    choices=available_filters())
    ap.add_argument("--n-order", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where every batch runs: cuda (default) or cpu")
    ap.add_argument("--filter-backend", default=None,
                    help="filter stage path (default: cuda on the card, "
                         "torch on the CPU)")
    ap.add_argument("--mbr-backend", default="numpy",
                    help="candidate generation path")
    ap.add_argument("--refine-backend", default=None,
                    help="refinement path (default as --filter-backend)")
    ap.add_argument("--pipeline-mode", default="staged",
                    help="staged (default) or fused: each micro-batched "
                         "group as one device-resident chain")
    ap.add_argument("--plan-mode", default="static",
                    help="static (default) or adaptive: the planner picks "
                         "each group's filter and granularity, replanning "
                         "once mutation drift passes the threshold")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="micro-batch accumulation window")
    ap.add_argument("--cache-mb", type=float, default=256.0,
                    help="store-cache byte budget (MiB)")
    ap.add_argument("--mutate-every", type=int, default=25,
                    help="insert+delete every N requests (0 disables)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    report = run_serve(
        dataset=args.dataset, count=args.count,
        query_layer=args.query_layer, n_queries=args.n_queries,
        n_requests=args.queries, method=args.method, n_order=args.n_order,
        filter_backend=args.filter_backend, mbr_backend=args.mbr_backend,
        refine_backend=args.refine_backend,
        pipeline_mode=args.pipeline_mode, plan_mode=args.plan_mode,
        window_ms=args.window_ms, cache_mb=args.cache_mb,
        mutate_every=args.mutate_every, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed, device=args.device)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
