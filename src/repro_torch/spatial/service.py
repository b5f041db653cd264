"""`JoinService`: the online spatial-join server.

The paper's approximations are built once and amortized across many
joins; this module runs that contract as a long-lived server. Per
registered dataset it owns:

* the polygon arrays (``insert`` / ``delete`` replace them with patched
  ones),
* a warm :class:`~repro_torch.spatial.mbr_join.MBRIndex` (the R side's
  bucket table of the grid-hash join, built once, probed per batch),
* warm :class:`~repro_torch.spatial.filters.base.Approximation` stores
  behind a byte-budgeted LRU :class:`~repro_torch.spatial.store_cache.
  StoreCache`; their device copies (the interval lists on the card, RI's
  device store) ride along in ``meta`` and are reused across requests.

In front sits a micro-batching queue: ``selection`` / ``window`` /
``intersects`` / ``within`` requests are grouped by (dataset, predicate,
method, n_order), and each group runs as one batched
:class:`~repro_torch.spatial.plan.JoinPlan` pass: the query polygons of
every request of the group become one S-side dataset, and the result
pairs scatter back per request. Batching changes execution, not verdicts:
each ticket holds what a one-request run over the dataset as it stood at
the drain returns.

A mutation appends to the dataset's log and patches the arrays and the
MBR index at once; cached stores replay the log suffix they have not seen
on their next use, through the filter's ``patch_insert`` /
``patch_delete`` (row splices: a patched store equals a fresh rebuild,
and a splice drops the device copies made from the old rows).
``save_checkpoint`` persists host copies of the datasets and the interval
stores (APRIL, RI) with each store's position in the log through
:class:`~repro_torch.runtime.checkpoint.CheckpointManager`, in the
reference package's format; a restore re-creates the stores, replays what
they missed, and uploads the device copies again on first use.

Every batched pass runs on ``device`` (``None`` -> ``"cuda"``), on that
device's default stream whichever thread drains: the worker thread's
kernels and the device copies any earlier drain uploaded share one
stream, so a copy is complete before a kernel reads it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.april import AprilStore
from ..core.rasterize import Extent, GLOBAL_EXTENT
from ..core.ri import RIStore
from ..datagen.synthetic import PolygonDataset
from ..device import resolve_device
from .filters import Approximation, get_filter
from .fused import check_pipeline_mode
from .mbr_join import MBRIndex
from .plan import JoinPlan
from .planner import PlanChoice, check_plan_mode
from .store_cache import DEFAULT_BUDGET, StoreCache

__all__ = ["JoinService", "JoinTicket", "SERVICE_PREDICATES"]

#: request predicates; ``window`` is a rectangle query run as
#: ``selection`` with the rectangle's 4-corner polygon
SERVICE_PREDICATES = ("selection", "window", "intersects", "within")


def _pad_verts(verts: np.ndarray, vmax: int) -> np.ndarray:
    """Zero-pad [P, V, 2] along V (padding is masked by ``nverts``
    everywhere downstream)."""
    if verts.shape[1] == vmax:
        return verts
    pad = np.zeros((verts.shape[0], vmax - verts.shape[1], 2), np.float64)
    return np.concatenate([verts, pad], axis=1)


def _one_polygon_dataset(verts: np.ndarray) -> PolygonDataset:
    verts = np.asarray(verts, np.float64).reshape(-1, 2)
    return PolygonDataset(name="_patch", verts=verts[None],
                          nverts=np.array([len(verts)], np.int64))


@dataclass
class JoinTicket:
    """Handle returned by :meth:`JoinService.submit`, resolved at a drain.

    ``pairs`` is [K, 2] int64, (data object id, local query index) for the
    request's query polygons; ``stats`` is the executed group's
    ``JoinStats.to_dict()`` (shared by every request of the micro-batch);
    ``latency`` is the seconds from submit to resolution. ``error`` is set
    when the drain that held the request failed; :meth:`wait` then raises.
    """
    dataset_id: str
    predicate: str
    pairs: np.ndarray | None = None
    stats: dict | None = None
    latency: float | None = None
    error: BaseException | None = None
    done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> "JoinTicket":
        if not self.done.wait(timeout):
            raise TimeoutError("join request not resolved "
                               f"(dataset={self.dataset_id!r})")
        if self.error is not None:
            raise RuntimeError(
                f"join request failed (dataset={self.dataset_id!r}, "
                f"predicate={self.predicate!r})") from self.error
        return self


@dataclass
class _Request:
    ticket: JoinTicket
    exec_predicate: str
    method: str
    n_order: int
    verts: np.ndarray        # [Q, V, 2]
    nverts: np.ndarray       # [Q]
    t_submit: float = 0.0


class _DatasetHandle:
    """One registered dataset: its arrays, a warm MBR index and the
    mutation log cached stores sync against."""

    def __init__(self, dataset: PolygonDataset, extent: Extent):
        self.dataset = dataset
        self.extent = extent
        self.log: list[tuple] = []      # ("insert", verts[V,2]) | ("delete", id)
        self._index: MBRIndex | None = None

    @property
    def seq(self) -> int:
        return len(self.log)

    @property
    def index(self) -> MBRIndex:
        if self._index is None:
            self._index = MBRIndex(self.dataset.mbrs)
        return self._index

    def insert(self, verts: np.ndarray) -> int:
        verts = np.asarray(verts, np.float64).reshape(-1, 2)
        ds = self.dataset
        vmax = max(ds.verts.shape[1], len(verts))
        row = _pad_verts(verts[None], vmax)
        self.dataset = PolygonDataset(
            name=ds.name, verts=np.concatenate(
                [_pad_verts(ds.verts, vmax), row]),
            nverts=np.append(ds.nverts, len(verts)))
        new_id = len(self.dataset) - 1
        if self._index is not None:
            self._index.insert(self.dataset.mbrs[new_id])
        self.log.append(("insert", verts))
        return new_id

    def delete(self, obj_id: int) -> None:
        ds = self.dataset
        if not 0 <= obj_id < len(ds):
            raise IndexError(f"delete: object id {obj_id} out of range "
                             f"[0, {len(ds)})")
        self.dataset = PolygonDataset(
            name=ds.name, verts=np.delete(ds.verts, obj_id, axis=0),
            nverts=np.delete(ds.nverts, obj_id))
        if self._index is not None:
            self._index.delete(obj_id)
        self.log.append(("delete", int(obj_id)))


class JoinService:
    """Long-lived spatial-join server over warm stores.

    ``window_s`` is the micro-batch accumulation window of the background
    worker (:meth:`start`); without a worker, :meth:`drain` runs
    everything pending synchronously. The backend knobs are
    :class:`~repro_torch.spatial.plan.JoinPlan`'s and apply to every
    batched pass: ``device`` (``None`` -> ``"cuda"``; raises without a
    GPU), ``filter_backend`` and ``refine_backend`` (``None``: what
    ``JoinPlan`` picks for the device, ``"cuda"`` on the card and
    ``"torch"`` on the CPU), ``mbr_backend``, ``pipeline_mode``.

    ``plan_mode="adaptive"`` replaces the static method and n_order of
    each request group with the planner's pick, made on the group's query
    batch and cached per (dataset, predicate, method, n_order) group key.
    A cached choice is dropped once the mutations applied since planning
    reach ``replan_after``; build cost is amortized in the cost model
    (warm stores serve many batches), which ``plan_opts`` can override.
    ``stats["replans"]`` counts planner runs.

    Locks: ``_exec_lock`` (reentrant) serializes store, index and dataset
    access between the worker and mutating callers; ``_lock`` guards the
    queue, stats, latencies and the worker's lifecycle. ``_exec_lock`` is
    always taken outside ``_lock``, never while holding it.
    """

    def __init__(self, *, cache_bytes: int = DEFAULT_BUDGET,
                 window_s: float = 0.002, method: str = "april",
                 n_order: int = 10, filter_backend: str | None = None,
                 refine_backend: str | None = None,
                 mbr_backend: str = "numpy", pipeline_mode: str = "staged",
                 plan_mode: str = "static", plan_opts: dict | None = None,
                 replan_after: int = 16, device=None):
        check_pipeline_mode(pipeline_mode)
        check_plan_mode(plan_mode)
        self.device = resolve_device(device)
        self.cache = StoreCache(cache_bytes)
        self.window_s = float(window_s)
        self.method = method
        self.n_order = int(n_order)
        self.filter_backend = filter_backend
        self.refine_backend = refine_backend
        self.mbr_backend = mbr_backend
        self.pipeline_mode = pipeline_mode
        self.plan_mode = plan_mode
        self.plan_opts = dict(plan_opts or {})
        self.replan_after = int(replan_after)
        # group key -> (PlanChoice, mutation seq at planning time); guarded
        # by _lock (planning itself is serialized by _exec_lock)
        self._plans: dict[tuple, tuple[PlanChoice, int]] = {}
        self.datasets: dict[str, _DatasetHandle] = {}
        self._pending: list[_Request] = []
        self._lock = threading.Lock()
        self._exec_lock = threading.RLock()
        self._have_work = threading.Event()
        self._worker: threading.Thread | None = None
        self._worker_error: BaseException | None = None
        self._stop = threading.Event()
        self._latencies: list[float] = []
        # per-stage time breakdown summed over the executed groups
        self._stage_times: dict[str, float] = {}
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "inserts": 0, "deletes": 0, "replans": 0}

    # -- datasets and mutations ---------------------------------------------

    def register_dataset(self, dataset_id: str, dataset: PolygonDataset,
                         extent: Extent = GLOBAL_EXTENT) -> None:
        with self._exec_lock:
            if dataset_id in self.datasets:
                raise ValueError(
                    f"dataset {dataset_id!r} already registered")
            self.datasets[dataset_id] = _DatasetHandle(dataset, extent)

    def dataset(self, dataset_id: str) -> PolygonDataset:
        return self._handle(dataset_id).dataset

    def _handle(self, dataset_id: str) -> _DatasetHandle:
        with self._exec_lock:
            try:
                return self.datasets[dataset_id]
            except KeyError:
                raise KeyError(
                    f"unknown dataset {dataset_id!r}; registered: "
                    f"{sorted(self.datasets)}") from None

    def insert(self, dataset_id: str, verts: np.ndarray) -> int:
        """Add one polygon; returns its object id. Warm stores are patched
        lazily (each replays the log suffix it has not seen on its next
        use); nothing is rebuilt."""
        with self._exec_lock:
            new_id = self._handle(dataset_id).insert(verts)
        with self._lock:
            self.stats["inserts"] += 1
        return new_id

    def delete(self, dataset_id: str, obj_id: int) -> None:
        """Remove one polygon; later ids shift down by one (the numbering
        of a rebuild)."""
        with self._exec_lock:
            self._handle(dataset_id).delete(obj_id)
        with self._lock:
            self.stats["deletes"] += 1

    # -- warm store access --------------------------------------------------

    def warm_store(self, dataset_id: str, method: str | None = None,
                   n_order: int | None = None) -> Approximation:
        """The cached Approximation for (dataset, method, n_order): built
        on a miss (the host build), brought up to date with the mutation
        log on a hit."""
        method = method or self.method
        n_order = self.n_order if n_order is None else int(n_order)
        with self._exec_lock:
            handle = self._handle(dataset_id)
            key = (dataset_id, method, n_order)
            approx = self.cache.get(key)
            filt = get_filter(method)
            if approx is None:
                approx = filt.build(handle.dataset, n_order=n_order,
                                    extent=handle.extent, kind="polygon",
                                    side="r")
                approx.meta["mutation_seq"] = handle.seq
                self.cache.put(key, approx)
                return approx
            seq = approx.meta.get("mutation_seq", 0)
            if seq < handle.seq:
                for op in handle.log[seq:]:
                    if op[0] == "insert":
                        filt.patch_insert(approx,
                                          _one_polygon_dataset(op[1]))
                    else:
                        filt.patch_delete(approx, op[1])
                approx.meta["mutation_seq"] = handle.seq
                self.cache.resize(key)
            return approx

    # -- the request queue --------------------------------------------------

    def submit(self, dataset_id: str, predicate: str, query,
               nverts: np.ndarray | None = None, *,
               method: str | None = None,
               n_order: int | None = None) -> JoinTicket:
        """Enqueue one query; returns a :class:`JoinTicket`.

        ``query``: a polygon [V, 2] (``selection`` / ``intersects`` /
        ``within``), a rectangle ``(x0, y0, x1, y1)`` (``window``), or a
        padded batch [Q, V, 2] with ``nverts`` [Q]. Raises the error of a
        background worker that failed.
        """
        if predicate not in SERVICE_PREDICATES:
            raise ValueError(f"unknown predicate {predicate!r}; expected "
                             f"one of {SERVICE_PREDICATES}")
        self._handle(dataset_id)
        with self._lock:
            failed = self._worker_error
        if failed is not None:
            raise RuntimeError("the service's worker failed") from failed
        if predicate == "window":
            x0, y0, x1, y1 = (float(v) for v in np.asarray(query).ravel())
            query = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        query = np.asarray(query, np.float64)
        if query.ndim == 2:
            query = query[None]
        if nverts is None:
            nverts = np.full(len(query), query.shape[1], np.int64)
        exec_predicate = {"window": "selection"}.get(predicate, predicate)
        ticket = JoinTicket(dataset_id=dataset_id, predicate=predicate)
        req = _Request(ticket=ticket, exec_predicate=exec_predicate,
                       method=method or self.method,
                       n_order=self.n_order if n_order is None
                       else int(n_order),
                       verts=query, nverts=np.asarray(nverts, np.int64),
                       t_submit=time.perf_counter())
        with self._lock:
            self._pending.append(req)
            self.stats["requests"] += 1
        self._have_work.set()
        return ticket

    def drain(self) -> int:
        """Run everything pending: one batched JoinPlan pass per (dataset,
        predicate, method, n_order) group. Returns the number of requests
        resolved. If a group raises, every request of the drain it leaves
        unresolved fails with that error (its ticket's ``wait`` raises),
        and the error propagates."""
        with self._lock:
            batch, self._pending = self._pending, []
            self._have_work.clear()
        if not batch:
            return 0
        groups: dict[tuple, list[_Request]] = {}
        for req in batch:
            key = (req.ticket.dataset_id, req.exec_predicate, req.method,
                   req.n_order)
            groups.setdefault(key, []).append(req)
        try:
            for (did, predicate, method, n_order), reqs in groups.items():
                self._run_group(did, predicate, method, n_order, reqs)
        except BaseException as exc:
            for req in batch:
                if not req.ticket.done.is_set():
                    req.ticket.error = exc
                    req.ticket.done.set()
            raise
        with self._lock:
            self.stats["batches"] += len(groups)
            self.stats["batched_requests"] += len(batch)
        return len(batch)

    def _plan_for(self, handle, dataset_id: str, predicate: str,
                  method: str, n_order: int, queries) -> PlanChoice:
        """The group's cached PlanChoice, made again once the mutations
        since planning reach ``replan_after``. Callers hold
        ``_exec_lock``. Build cost is amortized 16x by default
        (``plan_opts`` overrides): warm stores serve many batches."""
        pkey = (dataset_id, predicate, method, n_order)
        with self._lock:
            cached = self._plans.get(pkey)
        if cached is not None and handle.seq - cached[1] < self.replan_after:
            return cached[0]
        opts = {"amortize_build": 16.0}
        opts.update(self.plan_opts)
        probe = JoinPlan(handle.dataset, queries, filter="april",
                         n_order=n_order, extent=handle.extent,
                         mbr_backend=self.mbr_backend,
                         mbr_index=handle.index, plan_mode="adaptive",
                         plan_opts=opts, device=self.device)
        choice = probe.plan(predicate)
        with self._lock:
            self._plans[pkey] = (choice, handle.seq)
            self.stats["replans"] += 1
        return choice

    def _stream(self):
        """The device's default stream as the current one (nothing on the
        CPU): every group's uploads and kernels share it."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.default_stream(self.device))

    def _run_group(self, dataset_id: str, predicate: str, method: str,
                   n_order: int, reqs: list[_Request]) -> None:
        with self._exec_lock, self._stream():
            handle = self._handle(dataset_id)
            vmax = max(r.verts.shape[1] for r in reqs)
            q_verts = np.concatenate(
                [_pad_verts(r.verts, vmax) for r in reqs])
            q_nverts = np.concatenate([r.nverts for r in reqs])
            queries = PolygonDataset(name="_queries", verts=q_verts,
                                     nverts=q_nverts)
            knobs = dict(extent=handle.extent,
                         filter_backend=self.filter_backend,
                         refine_backend=self.refine_backend,
                         mbr_backend=self.mbr_backend,
                         mbr_index=handle.index, device=self.device)
            if self.plan_mode == "adaptive":
                # the planner's pick overrides the request's method and
                # n_order; its warm store lands in the same LRU, so several
                # chosen configs stay resident side by side
                choice = self._plan_for(handle, dataset_id, predicate,
                                        method, n_order, queries)
                approx = self.warm_store(dataset_id, choice.method,
                                         choice.n_order)
                plan = JoinPlan(handle.dataset, queries,
                                filter=choice.method,
                                n_order=choice.n_order,
                                pipeline_mode=self.pipeline_mode,
                                plan_mode="adaptive", plan_choice=choice,
                                **knobs)
            else:
                approx = self.warm_store(dataset_id, method, n_order)
                plan = JoinPlan(handle.dataset, queries, filter=method,
                                n_order=n_order,
                                pipeline_mode=self.pipeline_mode, **knobs)
            plan.build(prebuilt=(approx, None))
            pairs, stats = plan.execute(predicate)
            stats.extra["batched_requests"] = len(reqs)
            stats.extra["cache"] = dict(self.cache.stats)
        with self._lock:
            for key, dt in stats.stage_times().items():
                self._stage_times[key] = self._stage_times.get(key, 0.0) + dt
        envelope = stats.to_dict()
        # scatter: each request owns a contiguous run of query indices
        offs = np.cumsum([0] + [len(r.nverts) for r in reqs])
        order = np.argsort(pairs[:, 1], kind="stable")
        pairs = pairs[order]
        bounds = np.searchsorted(pairs[:, 1], offs)
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            mine = pairs[bounds[i]: bounds[i + 1]].copy()
            mine[:, 1] -= offs[i]
            t = req.ticket
            t.pairs, t.stats = mine, envelope
            t.latency = now - req.t_submit
            with self._lock:
                self._latencies.append(t.latency)
            t.done.set()

    # -- background micro-batching worker -----------------------------------

    def start(self) -> None:
        """Run the micro-batch loop in a daemon thread: wait for the first
        pending request, accumulate for ``window_s``, drain. A drain that
        raises stops the loop; :meth:`stop` (and any later :meth:`submit`)
        raises its error."""

        def loop():
            while not self._stop.is_set():
                if not self._have_work.wait(timeout=0.05):
                    continue
                time.sleep(self.window_s)
                try:
                    self.drain()
                except BaseException as exc:  # noqa: BLE001 - kept, raised by stop()
                    with self._lock:
                        self._worker_error = exc
                    return

        with self._lock:
            if self._worker is not None:
                return
            self._stop.clear()
            self._worker = threading.Thread(target=loop, daemon=True)
            self._worker.start()

    def stop(self) -> None:
        """Stop the worker, then drain what is left; raises the worker's
        error if it failed."""
        with self._lock:
            worker, self._worker = self._worker, None
        if worker is None:
            return
        self._stop.set()
        # joined outside _lock: the worker's drain() takes _lock itself
        worker.join()
        with self._lock:
            failed = self._worker_error
            if failed is not None:
                pending, self._pending = self._pending, []
        if failed is None:
            self.drain()
            return
        for req in pending:
            req.ticket.error = failed
            req.ticket.done.set()
        raise RuntimeError("the service's worker failed") from failed

    # -- accounting ---------------------------------------------------------

    def latency_stats(self) -> dict:
        """p50/p99 submit-to-resolution latency over resolved requests,
        plus the per-stage time breakdown (``t_mbr``/``t_filter``/
        ``t_refine``/``t_sync``) summed over the executed batches."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            stages = dict(self._stage_times)
        if len(lat) == 0:
            return {"n": 0, "p50_s": 0.0, "p99_s": 0.0, "mean_s": 0.0,
                    "stage_times": stages}
        return {"n": int(len(lat)),
                "p50_s": float(np.percentile(lat, 50)),
                "p99_s": float(np.percentile(lat, 99)),
                "mean_s": float(lat.mean()),
                "stage_times": stages}

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, manager, step: int) -> None:
        """Persist datasets, the interval stores (APRIL, RI) and the
        mutation log through a
        :class:`~repro_torch.runtime.checkpoint.CheckpointManager`, host
        copies only. Stores that are not flat arrays (RA grids, APRIL-C
        buffers, 5C+CH) are rebuilt on first use after a restore; each
        persisted store records the log position it is synced to, so a
        restore replays exactly the mutations it missed."""
        tree: dict = {}
        extra: dict = {"datasets": {}, "stores": [],
                       "service": {"method": self.method,
                                   "n_order": self.n_order}}
        with self._exec_lock:
            for did, h in self.datasets.items():
                tree[f"ds/{did}/verts"] = h.dataset.verts
                tree[f"ds/{did}/nverts"] = h.dataset.nverts
                extra["datasets"][did] = {
                    "name": h.dataset.name,
                    "extent": [h.extent.x0, h.extent.y0, h.extent.side],
                    "log": [["insert", v.tolist()] if op == "insert"
                            else ["delete", v] for op, v in h.log],
                }
            for (did, method, n_order), approx in self.cache.items():
                store = approx.store
                if isinstance(store, AprilStore):
                    leaves = {"a_off": store.a_off, "a_ints": store.a_ints,
                              "f_off": store.f_off, "f_ints": store.f_ints}
                elif isinstance(store, RIStore):
                    leaves = {"off": store.off, "ints": store.ints,
                              "bit_off": store.bit_off, "bits": store.bits}
                else:
                    continue
                rec = {"dataset_id": did, "method": method,
                       "n_order": n_order,
                       "seq": int(approx.meta.get("mutation_seq", 0)),
                       "build_opts": dict(approx.meta.get("build_opts", {}))}
                if isinstance(store, RIStore):
                    rec["encoding"] = store.encoding
                extra["stores"].append(rec)
                for name, arr in leaves.items():
                    tree[f"store/{did}/{method}/{n_order}/{name}"] = arr
        manager.save(step, tree, extra=extra, block=True)

    @classmethod
    def restore_checkpoint(cls, manager, step: int | None = None,
                           **service_opts) -> "JoinService | None":
        """A service rebuilt from a checkpoint written by
        :meth:`save_checkpoint` (by this package or the reference's);
        ``None`` when no step exists. ``service_opts`` are the
        constructor's knobs (``device``, backends, budget, ...)."""
        res = manager.restore(step)
        if res is None:
            return None
        _, flat, extra = res
        svc = cls(method=extra["service"]["method"],
                  n_order=extra["service"]["n_order"], **service_opts)
        for did, meta in extra["datasets"].items():
            ds = PolygonDataset(name=meta["name"],
                                verts=flat[f"ds/{did}/verts"],
                                nverts=flat[f"ds/{did}/nverts"])
            svc.register_dataset(did, ds, extent=Extent(*meta["extent"]))
            h = svc.datasets[did]
            h.log = [("insert", np.asarray(v, np.float64)) if op == "insert"
                     else ("delete", int(v))
                     for op, v in meta["log"]]
        for rec in extra["stores"]:
            did, method, n_order = (rec["dataset_id"], rec["method"],
                                    rec["n_order"])
            h = svc.datasets[did]
            pre = f"store/{did}/{method}/{n_order}"
            if method == "ri":
                store = RIStore(n_order=n_order, extent=h.extent,
                                encoding=rec["encoding"],
                                off=flat[f"{pre}/off"],
                                ints=flat[f"{pre}/ints"],
                                bit_off=flat[f"{pre}/bit_off"],
                                bits=flat[f"{pre}/bits"])
            else:
                store = AprilStore(n_order=n_order, extent=h.extent,
                                   a_off=flat[f"{pre}/a_off"],
                                   a_ints=flat[f"{pre}/a_ints"],
                                   f_off=flat[f"{pre}/f_off"],
                                   f_ints=flat[f"{pre}/f_ints"])
            approx = Approximation(
                filter=method, store=store, n_order=n_order, extent=h.extent,
                kind="polygon",
                meta={"build_opts": rec["build_opts"],
                      "mutation_seq": rec["seq"]})
            svc.cache.put((did, method, n_order), approx)
        return svc
