"""`JoinPlan`: the session API of the spatial join, static plans in both
pipeline modes.

    plan = JoinPlan(R, S, filter="april", n_order=12)     # device="cuda"
    plan.build()                                          # APRIL stores
    hits, stats = plan.execute("intersects")    # "within", "selection"
    JoinPlan(L, S, r_kind="line").build().execute("linestring")

Execution runs the paper's stages dataset-batched: grid-hash MBR
candidates (``mbr_backend``; for ``within`` only the rows whose r MBR lies
inside the s MBR) -> the filter's trichotomy (``filter_backend``) -> exact
refinement of the INDECISIVE rows (``refine_backend``). ``selection`` is
``intersects`` with the query polygons as S: result rows are (data index,
query index). ``linestring`` (§4.3.3) joins open chains, built with
``r_kind="line"`` as R, to the polygons of S. With
``pipeline_mode="staged"`` each stage's survivors come back to the host;
with ``"fused"`` the stages chain on the device and meet the host once, at
the end (``spatial/fused.py``). Results are ``concat(pairs[TRUE_HIT],
indecisive[refined])``, in the reference package's order. On a CUDA device
both backends default to ``"cuda"`` (the hand-written kernels); on the CPU
to ``"torch"`` (their plain PyTorch versions). Backends and modes change
execution, never results. ``plan_mode="adaptive"`` lets the sample-based
planner (``spatial/planner.py``) pick the filter, order, join order and
pipeline mode; a warm ``mbr_index`` replaces the per-call MBR join of the
R side with a probe of its bucket table.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, fields

import numpy as np

from ..core.geometry import BUILD_STAGES
from ..core.join import INDECISIVE, TRUE_HIT, TRUE_NEG, check_filter_backend
from ..core.rasterize import Extent, GLOBAL_EXTENT
from ..device import check_backend_device, resolve_device
from . import refine
from .filters import Approximation, IntermediateFilter, get_filter
from .filters.base import check_predicate
from .fused import check_pipeline_mode, execute_fused
from .mbr_join import check_mbr_backend, mbr_inside, mbr_join
from .planner import PLAN_MODES, PlanChoice, check_plan_mode, choose_plan

__all__ = ["JoinStats", "JoinPlan", "PLAN_MODES"]


@dataclass
class JoinStats:
    method: str
    predicate: str = "intersects"
    backend: str = "numpy"             # alias of filter_backend
    filter_backend: str = "numpy"
    refine_backend: str = "numpy"
    mbr_backend: str = "numpy"
    n_candidates: int = 0
    n_true_hits: int = 0
    n_true_negs: int = 0
    n_indecisive: int = 0
    n_results: int = 0
    pipeline_mode: str = "staged"
    plan_mode: str = "static"
    tiles: int = 0
    t_mbr: float = 0.0
    t_filter: float = 0.0
    t_refine: float = 0.0
    t_sync: float = 0.0
    t_build: float = 0.0
    t_partition: float = 0.0
    approx_bytes: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def t_total(self) -> float:
        return self.t_mbr + self.t_filter + self.t_refine + self.t_sync

    def stage_times(self) -> dict:
        """Per-stage time breakdown, JSON-safe; round-trips through
        to_dict/from_dict. In fused mode the stage times are dispatch only
        and ``t_sync`` holds the final gather and the host re-check."""
        return {"t_mbr": float(self.t_mbr), "t_filter": float(self.t_filter),
                "t_refine": float(self.t_refine),
                "t_sync": float(self.t_sync),
                "t_partition": float(self.t_partition),
                "t_total": float(self.t_total)}

    def rates(self) -> tuple[float, float, float]:
        """(TRUE_HIT, TRUE_NEG, INDECISIVE) shares of the candidates."""
        n = max(1, self.n_candidates)
        return (self.n_true_hits / n, self.n_true_negs / n,
                self.n_indecisive / n)

    def row(self) -> str:
        """One printable line: verdict shares, stage times and backends."""
        h, g, i = self.rates()
        sync = (f"sync={self.t_sync:.3f}s "
                if self.pipeline_mode == "fused" else "")
        if self.tiles:
            sync += f"tiles={self.tiles} part={self.t_partition:.3f}s "
        return (f"{self.method:8s} hits={h:6.2%} negs={g:6.2%} indec={i:6.2%} "
                f"mbr={self.t_mbr:.3f}s[{self.mbr_backend}] "
                f"filter={self.t_filter:.3f}s[{self.filter_backend}] "
                f"refine={self.t_refine:.3f}s[{self.refine_backend}] "
                f"{sync}total={self.t_total:.3f}s results={self.n_results}")

    def to_dict(self) -> dict:
        """JSON-safe dict of every field plus ``t_total``."""
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (np.integer, np.floating)):
                v = v.item()
            out[f.name] = dict(v) if f.name == "extra" else v
        out["t_total"] = self.t_total
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "JoinStats":
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class JoinPlan:
    """A reusable two-dataset join session over one intermediate filter.

    ``device`` (``None`` -> ``"cuda"``; raises without a GPU) is where the
    filter and refinement run. ``filter_backend`` is ``"numpy" | "torch" |
    "cuda" | "sequential"``, ``refine_backend`` the same or ``"device64"``
    (the float64 device cores); ``"cuda"`` needs a CUDA device.
    ``mbr_backend`` is ``"numpy" | "torch" | "sequential"``
    (``"torch"`` tests the candidate rows on the device, the reference's
    ``"jnp"``); ``pipeline_mode`` is ``"staged" | "fused"``;
    ``build_opts`` go to ``filter.build`` (e.g. ``build_backend``:
    ``"numpy" | "torch" | "sequential"``, where ``"torch"`` runs the
    build's device passes on the plan's ``device``; ``max_cells`` for RA;
    ``method`` for APRIL) and ``filter_opts`` (e.g. ``order``) to every
    ``filter.verdicts`` call. ``backend`` is the deprecated alias of
    ``filter_backend``. ``mbr_index`` (an :class:`~repro_torch.spatial.
    mbr_join.MBRIndex` over R) is probed instead of the MBR join, in both
    modes, with the same pair set. ``plan_mode`` is ``"static"`` (the knobs
    above, verbatim) or ``"adaptive"``: the planner runs on the first
    :meth:`execute` (or an explicit :meth:`plan`) and its choice of filter,
    ``n_order``, join order and pipeline mode is adopted; ``plan_opts``
    tune it (``planner.PLAN_DEFAULTS``) and ``plan_choice`` injects a
    choice made elsewhere instead of sampling.
    """

    def __init__(self, R, S, *, filter: str | IntermediateFilter = "april",
                 filter_backend: str | None = None,
                 backend: str | None = None,
                 refine_backend: str | None = None,
                 mbr_backend: str = "numpy", n_order: int = 10,
                 extent: Extent = GLOBAL_EXTENT, r_kind: str = "polygon",
                 s_kind: str = "polygon", mbr_grid: int | None = None,
                 mbr_index=None, pipeline_mode: str = "staged",
                 plan_mode: str = "static", plan_opts: dict | None = None,
                 plan_choice: PlanChoice | None = None,
                 build_opts: dict | None = None,
                 filter_opts: dict | None = None, device=None):
        if (filter_backend is not None and backend is not None
                and filter_backend != backend):
            raise ValueError("pass filter_backend or its alias backend, "
                             f"not both ({filter_backend!r} vs {backend!r})")
        if backend is not None:
            warnings.warn(
                "JoinPlan(backend=...) is a deprecated alias; "
                "pass filter_backend=... instead (alias removed after "
                "2026-12-01)",
                DeprecationWarning, stacklevel=2)
        check_pipeline_mode(pipeline_mode)
        check_plan_mode(plan_mode)
        if plan_choice is not None and plan_mode != "adaptive":
            raise ValueError("plan_choice requires plan_mode='adaptive' "
                             f"(got plan_mode={plan_mode!r})")
        if s_kind != "polygon":
            raise ValueError("the chains of a linestring join are the R "
                             "side (r_kind='line'); s_kind must be "
                             "'polygon'")
        self.device = resolve_device(device)
        default = "cuda" if self.device.type == "cuda" else "torch"
        filter_backend = filter_backend or backend or default
        refine_backend = refine_backend or default
        check_filter_backend(filter_backend)
        refine.check_refine_backend(refine_backend)
        check_mbr_backend(mbr_backend)
        check_backend_device(filter_backend, self.device)
        check_backend_device(refine_backend, self.device)
        self.R = R
        self.S = S
        self.filter = get_filter(filter)
        self.filter_backend = filter_backend
        self.backend = filter_backend      # historical alias
        self.refine_backend = refine_backend
        self.mbr_backend = mbr_backend
        self.n_order = n_order
        self.extent = extent
        self.r_kind = r_kind
        self.s_kind = s_kind
        self.mbr_grid = mbr_grid
        self.mbr_index = mbr_index
        self.pipeline_mode = pipeline_mode
        self.plan_mode = plan_mode
        self.plan_opts = dict(plan_opts or {})
        self.plan_choice: PlanChoice | None = None
        self.build_opts = dict(build_opts or {})
        self.filter_opts = dict(filter_opts or {})
        self.approx_r: Approximation | None = None
        self.approx_s: Approximation | None = None
        self._t_build = 0.0
        self._build_stages: dict = {}
        self._t_plan = 0.0
        self.last_stats: JoinStats | None = None
        if plan_choice is not None:
            self._apply_choice(plan_choice)

    def _wrap(self, store, kind: str) -> Approximation:
        """An adopted side: an Approximation as it is, a raw store wrapped
        with this plan's filter, order, extent and ``kind``."""
        if isinstance(store, Approximation):
            return store
        return Approximation(filter=self.filter.name, store=store,
                             n_order=self.n_order, extent=self.extent,
                             kind=kind)

    def build(self, prebuilt: tuple | None = None) -> "JoinPlan":
        """Build (or adopt) both approximations; idempotent. ``prebuilt``
        may supply an (approx_r, approx_s) tuple (raw stores are wrapped),
        ``None`` entries meaning "build this side". The ``torch`` build
        runs on the plan's device unless ``build_opts`` name another. Its
        seconds add to ``t_build``, and those of its stages
        (``BUILD_STAGES``) to the ``build_stages`` a fused execution
        reports."""
        pre_r = pre_s = None
        if prebuilt is not None:
            pre_r, pre_s = prebuilt
        opts = dict(self.build_opts)
        if opts.get("build_backend") == "torch":
            opts.setdefault("device", self.device)
        t0 = time.perf_counter()
        with BUILD_STAGES.record() as stages:
            if self.approx_r is None:
                self.approx_r = (self._wrap(pre_r, self.r_kind)
                                 if pre_r is not None else self.filter.build(
                                     self.R, n_order=self.n_order,
                                     extent=self.extent, kind=self.r_kind,
                                     side="r", **opts))
            if self.approx_s is None:
                self.approx_s = (self._wrap(pre_s, self.s_kind)
                                 if pre_s is not None else self.filter.build(
                                     self.S, n_order=self.n_order,
                                     extent=self.extent, kind=self.s_kind,
                                     side="s", **opts))
        self._t_build += time.perf_counter() - t0
        for k, v in stages.items():
            self._build_stages[k] = self._build_stages.get(k, 0.0) + v
        return self

    # -- adaptive planning ---------------------------------------------------

    def _apply_choice(self, choice: PlanChoice) -> None:
        """Adopt a planner choice: its filter, order, join order and
        pipeline mode. Built approximations are dropped when the store
        shape changes (a store of the chosen config can still be adopted
        through :meth:`build`'s ``prebuilt``)."""
        if (choice.method != self.filter.name
                or int(choice.n_order) != self.n_order):
            self.approx_r = self.approx_s = None
        self.filter = get_filter(choice.method)
        self.n_order = int(choice.n_order)
        self.pipeline_mode = choice.pipeline_mode
        if (choice.method in ("april", "april-c")
                and choice.predicate in ("intersects", "selection")):
            self.filter_opts["order"] = tuple(choice.order)
        else:
            self.filter_opts.pop("order", None)
        self.plan_choice = choice

    def plan(self, predicate: str = "intersects",
             pairs: np.ndarray | None = None) -> PlanChoice:
        """Run the sample-based planner for ``predicate`` and adopt its
        choice (``plan_mode="adaptive"`` only). The first :meth:`execute`
        calls it; call it again to replan. ``pairs`` may supply the
        candidates when the caller has them (they must equal
        :meth:`candidates`). Deterministic for fixed inputs and
        ``plan_opts["seed"]``."""
        if self.plan_mode != "adaptive":
            raise ValueError("plan() requires JoinPlan(plan_mode="
                             f"'adaptive'), got {self.plan_mode!r}")
        t0 = time.perf_counter()
        if pairs is None:
            pairs = self.candidates(predicate)
        choice = choose_plan(self.R, self.S, pairs, predicate=predicate,
                             n_order=self.n_order, extent=self.extent,
                             r_kind=self.r_kind, **self.plan_opts)
        self._t_plan = time.perf_counter() - t0
        self._apply_choice(choice)
        return choice

    def candidates(self, predicate: str = "intersects") -> np.ndarray:
        """Candidate pairs of the grid-hash MBR join, [N, 2] int64, or of a
        probe of the warm ``mbr_index`` over R (the same pair set). For
        ``within`` only the pairs whose r MBR lies inside the s MBR:
        containment implies intersection, so the stricter test runs on the
        hash join's rows."""
        check_predicate(predicate)
        if self.mbr_index is not None:
            pairs = self.mbr_index.probe(self.S.mbrs,
                                         backend=self.mbr_backend,
                                         device=self.device)
        else:
            pairs = mbr_join(self.R.mbrs, self.S.mbrs, grid=self.mbr_grid,
                             backend=self.mbr_backend, device=self.device)
        if predicate == "within":
            pairs = pairs[mbr_inside(self.R.mbrs[pairs[:, 0]],
                                     self.S.mbrs[pairs[:, 1]])]
        return pairs

    def execute(self, predicate: str = "intersects",
                ) -> tuple[np.ndarray, JoinStats]:
        """Run MBR -> filter -> refine; returns (result pairs [K,2], stats).
        ``linestring`` needs the chains as R (``r_kind="line"``), and a
        line plan runs no other predicate."""
        check_predicate(predicate)
        if predicate == "linestring" and self.r_kind != "line":
            raise ValueError("predicate 'linestring' needs JoinPlan(..., "
                             "r_kind='line') with the chains as R")
        if predicate != "linestring" and self.r_kind == "line":
            raise ValueError(
                f"predicate {predicate!r} needs polygon approximations, but "
                "this plan was built with r_kind='line'")
        if self.plan_mode == "adaptive" and self.plan_choice is None:
            self.plan(predicate)
        if self.approx_r is None or self.approx_s is None:
            self.build()
        stats = JoinStats(method=self.filter.name, predicate=predicate,
                          backend=self.filter_backend,
                          filter_backend=self.filter_backend,
                          refine_backend=self.refine_backend,
                          mbr_backend=self.mbr_backend,
                          pipeline_mode=self.pipeline_mode,
                          plan_mode=self.plan_mode)
        if self.plan_choice is not None:
            stats.extra["plan"] = self.plan_choice.to_dict()
            stats.extra["t_plan"] = self._t_plan
        stats.t_build = self._t_build
        stats.approx_bytes = (self.approx_r.size_bytes()
                              + self.approx_s.size_bytes())
        if self.pipeline_mode == "fused":
            stats.extra["build_stages"] = dict(self._build_stages)
            results, stats = execute_fused(self, predicate, stats)
            self.last_stats = stats
            return results, stats

        t0 = time.perf_counter()
        pairs = self.candidates(predicate)
        stats.t_mbr = time.perf_counter() - t0
        stats.n_candidates = len(pairs)
        if len(pairs) == 0:
            self.last_stats = stats
            return np.zeros((0, 2), np.int64), stats

        t0 = time.perf_counter()
        verdicts = self.filter.verdicts(
            self.approx_r, self.approx_s, pairs, predicate=predicate,
            backend=self.filter_backend, device=self.device,
            **self.filter_opts)
        stats.t_filter = time.perf_counter() - t0
        stats.n_true_hits = int(np.sum(verdicts == TRUE_HIT))
        stats.n_true_negs = int(np.sum(verdicts == TRUE_NEG))
        stats.n_indecisive = int(np.sum(verdicts == INDECISIVE))

        t0 = time.perf_counter()
        indec = pairs[verdicts == INDECISIVE]
        ref = refine.refine(self.R, self.S, indec, predicate=predicate,
                            backend=self.refine_backend, device=self.device)
        stats.t_refine = time.perf_counter() - t0

        results = np.concatenate([pairs[verdicts == TRUE_HIT], indec[ref]],
                                 axis=0)
        stats.n_results = len(results)
        self.last_stats = stats
        return results, stats
