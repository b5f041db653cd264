"""Cost-based adaptive query planner: ``JoinPlan(plan_mode="adaptive")``.

The join has five filter methods, a granularity (``n_order``), four
AA/AF/FA join orders and two pipeline modes; ``choose_plan`` chooses
among them. It samples a small slice of the MBR candidate pairs, runs the
cheap trichotomy on probe APRIL stores built over just the sampled
objects, and estimates in machine-independent work units what every
static configuration would cost on the full candidate set. The argmin is
the :class:`PlanChoice` that ``JoinPlan(plan_mode="adaptive")`` executes.

Cost model (work unit = one interval comparison of the two-pointer merge
join, paper Algorithm 2):

* **filter** — per-pair early-exit comparisons under the candidate join
  order, averaged over the sample and scaled to the candidate count; an
  AA miss or an AF/FA hit stops the pair, as in
  :func:`repro_torch.core.join.april_verdict_pair`.
* **refine** — ``C_REFINE`` per vertex product, charged to the pairs the
  sample says stay INDECISIVE; the ``none`` config charges every
  candidate.
* **build** — ``C_BUILD`` per interval constructed, extrapolated from the
  probe store's mean intervals per sampled object; ``amortize_build``
  divides it for build-once, query-many deployments (the join service
  replans with amortization > 1).
* **decode** — APRIL-C only: ``C_DECODE`` per A-interval of the batch
  plus, at the AA-survivor rate, per F-interval.

Sampling is seeded (``numpy.random.default_rng(seed)``), so planning is a
pure function of its inputs and equals the reference package's choice
key for key. Below ``skip_filter_below`` candidates the planner returns
the ``none`` config without building probe stores. Planning is bounded:
the sample is ``min(sample_size, n_cand // 16)`` (floor 8), the requested
granularity is always probed, and each other one only while the probe
work plus its predicted cost (x4 per +2 orders) stays within
``probe_budget`` of the cheapest full-join estimate so far;
``est["n_orders"]`` records what was probed. Probe builds and counting
twins are host numpy, through the port's own filter registry.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.join import INDECISIVE, TRUE_HIT, TRUE_NEG
from ..core.rasterize import Extent, GLOBAL_EXTENT
from ..datagen.synthetic import PolygonDataset

__all__ = [
    "PLAN_MODES", "PLANNER_METHODS", "ORDER_CHOICES", "PLAN_DEFAULTS",
    "PlanChoice", "ProfileCache", "check_plan_mode", "choose_plan",
    "static_configs", "measured_work",
]

#: ``JoinPlan(plan_mode=...)``: ``static`` executes the constructor knobs
#: verbatim; ``adaptive`` runs :func:`choose_plan` on the first execute.
PLAN_MODES = ("static", "adaptive")

#: methods the cost model can price. The exotic filters (ri/ra/5cch) stay
#: static-only: their work is not interval-comparison shaped.
PLANNER_METHODS = ("none", "april", "april-c")

#: the Table-7 join-order sweep (paper §7.2.2); the first is the default.
ORDER_CHOICES = (("AA", "AF", "FA"), ("AA", "FA", "AF"),
                 ("AF", "FA", "AA"), ("FA", "AF", "AA"))

PLAN_DEFAULTS: dict = {
    "sample_size": 64,        # candidate pairs profiled
    "seed": 0,                # rng seed -> deterministic planning
    "methods": PLANNER_METHODS,
    "n_orders": None,         # default: {n-2, n, n+2} clamped to [4, 14]
    "orders": ORDER_CHOICES,
    "skip_filter_below": 32,  # candidates below this -> straight to refine
    "fuse_above": 1024,       # candidates above this -> pipeline_mode fused
    "c_refine": 1.0,          # work units per refinement vertex product
    "c_build": 2.0,           # work units per interval constructed
    "c_decode": 0.25,         # work units per interval decoded (APRIL-C)
    "amortize_build": 1.0,    # divide build cost (store reuse across joins)
    "probe_budget": 0.15,     # cap plan_work at this fraction of the join
}

#: APRIL-C construction overhead over plain APRIL (delta+varint encode).
_COMPRESS_BUILD_FACTOR = 1.25


def check_plan_mode(mode: str) -> None:
    if mode not in PLAN_MODES:
        raise ValueError(f"unknown plan_mode {mode!r}; "
                         f"expected one of {PLAN_MODES}")


@dataclass
class PlanChoice:
    """One executable configuration: what the planner picked (or one point
    of the static sweep). JSON-safe via :meth:`to_dict`/:meth:`from_dict`
    so it rides inside ``JoinStats.extra`` and the service envelope."""

    method: str = "april"
    n_order: int = 10
    order: tuple = ORDER_CHOICES[0]
    pipeline_mode: str = "staged"
    skip_filter: bool = False
    predicate: str = "intersects"
    #: planner evidence: sample size/seed, per-config cost table, rates,
    #: the chosen total, and the planning work itself (``plan_work``).
    est: dict = field(default_factory=dict)

    def key(self) -> str:
        """Stable id of the config point (the cost-table key)."""
        if self.method == "none":
            return "none"
        return f"{self.method}/n{self.n_order}/{'-'.join(self.order)}"

    def to_dict(self) -> dict:
        return {"method": self.method, "n_order": int(self.n_order),
                "order": list(self.order),
                "pipeline_mode": self.pipeline_mode,
                "skip_filter": bool(self.skip_filter),
                "predicate": self.predicate, "est": dict(self.est)}

    @classmethod
    def from_dict(cls, d: dict) -> "PlanChoice":
        return cls(method=d["method"], n_order=int(d["n_order"]),
                   order=tuple(d["order"]),
                   pipeline_mode=d.get("pipeline_mode", "staged"),
                   skip_filter=bool(d.get("skip_filter", False)),
                   predicate=d.get("predicate", "intersects"),
                   est=dict(d.get("est", {})))


class ProfileCache:
    """Shares planner choices between partitions of similar candidate
    density (per-partition adaptive planning, as the reference's launcher
    and tiled join do it).

    Per-partition adaptive planning re-samples and re-probes every
    partition, but partitions with the same workload *shape* — similar
    candidate volume and candidate density (candidates per MBR
    cross-pair) — land on the same :class:`PlanChoice` anyway. The cache
    keys a partition by ``predicate`` plus the **quantized log2** of its
    candidate count and density (``density_tol_log2`` buckets, default one
    octave): the first partition in a bucket pays for
    :func:`choose_plan`, the rest adopt its choice via
    ``JoinPlan._apply_choice`` without building probe stores.

    Reused choices are heuristic, not argmin-exact, for the adopting
    partition — verdicts are unaffected (plans change execution, never
    results; the exact refinement stage decides every pair). Single-thread
    use only; the join service's replan cache is separate.
    """

    def __init__(self, density_tol_log2: float = 1.0):
        self.density_tol_log2 = float(density_tol_log2)
        self._cache: dict[tuple, PlanChoice] = {}
        self.stats = {"hits": 0, "misses": 0}

    def key(self, predicate: str, n_r: int, n_s: int,
            n_cand: int) -> tuple:
        """Quantized workload-shape bucket of one partition."""
        tol = max(self.density_tol_log2, 1e-9)
        size = round(np.log2(n_cand + 1.0) / tol)
        dens = n_cand / max(1.0, float(n_r) * float(n_s))
        return (predicate, size, round(np.log2(dens + 1e-12) / tol))

    def get(self, key: tuple) -> PlanChoice | None:
        choice = self._cache.get(key)
        self.stats["hits" if choice is not None else "misses"] += 1
        return choice

    def put(self, key: tuple, choice: PlanChoice) -> None:
        self._cache[key] = choice

    def __len__(self) -> int:
        return len(self._cache)


# ---------------------------------------------------------------------------
# Work counters (machine-independent; shared by the planner and tests)
# ---------------------------------------------------------------------------

def _count_join(X, Y) -> tuple[int, bool]:
    """(comparisons, overlap?) of the early-exit two-pointer merge join —
    the counting twin of :func:`repro_torch.core.join.interval_join_pair`."""
    i = j = n = 0
    nx, ny = len(X), len(Y)
    while i < nx and j < ny:
        n += 1
        if X[i][0] < Y[j][1] and Y[j][0] < X[i][1]:
            return n, True
        if X[i][1] <= Y[j][1]:
            i += 1
        else:
            j += 1
    return n, False


def _count_containment(X, F) -> tuple[int, bool]:
    """Counting twin of :func:`repro_torch.core.join.containment_join_pair`."""
    j = n = 0
    nf = len(F)
    ok = bool(len(X))
    for xs, xe in X:
        while j < nf and F[j][1] < xe:
            n += 1
            j += 1
        n += 1
        if j >= nf or not (F[j][0] <= xs and xe <= F[j][1]):
            ok = False
            break
    return n, ok


def _cells_as_intervals(ids: np.ndarray) -> np.ndarray:
    ids = np.asarray(ids, np.uint64)
    if not len(ids):
        return np.zeros((0, 2), np.uint64)
    return np.stack([ids, ids + np.uint64(1)], axis=1)


def _store_ints(store) -> int:
    """Interval (or partial-cell) count a store holds — the build-work and
    decode-work base quantity."""
    if hasattr(store, "a_ints"):
        return len(store.a_ints) + len(store.f_ints)
    return len(store.ids)        # LineCellStore


def _lists(store, i: int, kind: str):
    """(A, F) interval lists of object ``i``; line stores expose their
    partial cells as unit intervals in the A slot (no Full list)."""
    if kind == "line":
        cells = _cells_as_intervals(store.ids[store.off[i]:store.off[i + 1]])
        return cells, cells[:0]
    return store.a_list(i), store.f_list(i)


def _pair_record(Ar, Fr, As_, Fs, refine_unit: float,
                 predicate: str) -> dict:
    """Profile one pair: per-join comparison counts, hit flags, verdict,
    and list lengths — everything any join order's work simulation needs."""
    rec = {"refine": refine_unit,
           "lens": (len(Ar), len(Fr), len(As_), len(Fs))}
    if predicate == "linestring":
        # R is the line side: its cells sit in Ar; polygon lists are As/Fs.
        rec["aa"], aa_hit = _count_join(As_, Ar)
        rec["af"], af_hit = (_count_join(Fs, Ar) if aa_hit else (0, False))
        rec["aa_hit"], rec["af_hit"] = aa_hit, af_hit
        rec["verdict"] = (TRUE_NEG if not aa_hit
                          else TRUE_HIT if af_hit else INDECISIVE)
        return rec
    if predicate == "within":
        rec["aa"], aa_hit = _count_join(Ar, As_)
        rec["cont"], cont = (_count_containment(Ar, Fs) if aa_hit
                             else (0, False))
        rec["aa_hit"] = aa_hit
        rec["verdict"] = (TRUE_NEG if not aa_hit
                          else TRUE_HIT if cont else INDECISIVE)
        return rec
    rec["aa"], rec["aa_hit"] = _count_join(Ar, As_)
    rec["af"], rec["af_hit"] = _count_join(Ar, Fs)
    rec["fa"], rec["fa_hit"] = _count_join(Fr, As_)
    if not rec["aa_hit"]:
        rec["verdict"] = TRUE_NEG
    elif rec["af_hit"] or rec["fa_hit"]:
        rec["verdict"] = TRUE_HIT
    else:
        rec["verdict"] = INDECISIVE
    return rec


def _order_work(rec: dict, order: tuple, predicate: str) -> int:
    """Early-exit comparisons one pair costs under ``order`` — the
    simulation twin of :func:`repro_torch.core.join.april_verdict_pair`."""
    if predicate == "within":
        return rec["aa"] + rec.get("cont", 0)
    if predicate == "linestring":
        return rec["aa"] + (rec["af"] if rec["aa_hit"] else 0)
    w = 0
    for step in order:
        k = step.lower()
        w += rec[k]
        if step == "AA" and not rec["aa_hit"]:
            break
        if step != "AA" and rec[k + "_hit"]:
            break
    return w


def _record_work(rec: dict, predicate: str) -> int:
    """Comparisons spent *profiling* the pair (all joins computed)."""
    if predicate == "within":
        return rec["aa"] + rec.get("cont", 0)
    if predicate == "linestring":
        return rec["aa"] + rec["af"]
    return rec["aa"] + rec["af"] + rec["fa"]


# ---------------------------------------------------------------------------
# Sample profiling
# ---------------------------------------------------------------------------

def _subset(ds_, idx: np.ndarray):
    """Sub-dataset of the unique sampled objects (probe-store input)."""
    return PolygonDataset(name=f"{ds_.name}#probe", verts=ds_.verts[idx],
                          nverts=ds_.nverts[idx])


def _profile(R, S, sample: np.ndarray, n: int, predicate: str,
             extent: Extent, r_kind: str) -> dict:
    """Build probe APRIL stores over the unique sampled objects at
    granularity ``n`` and record per-pair join work."""
    from .filters import get_filter
    ur = np.unique(sample[:, 0])
    us = np.unique(sample[:, 1])
    filt = get_filter("april")
    ax_r = filt.build(_subset(R, ur), n_order=n, extent=extent, kind=r_kind)
    ax_s = filt.build(_subset(S, us), n_order=n, extent=extent,
                      kind="polygon")
    loc_r = {int(g): k for k, g in enumerate(ur)}
    loc_s = {int(g): k for k, g in enumerate(us)}
    recs = []
    for gi, gj in sample:
        Ar, Fr = _lists(ax_r.store, loc_r[int(gi)], r_kind)
        As_, Fs = _lists(ax_s.store, loc_s[int(gj)], "polygon")
        recs.append(_pair_record(
            Ar, Fr, As_, Fs,
            float(R.nverts[gi]) * float(S.nverts[gj]), predicate))
    ints_r = _store_ints(ax_r.store)
    ints_s = _store_ints(ax_s.store)
    return {
        "recs": recs,
        "mean_ints_r": ints_r / max(1, len(ur)),
        "mean_ints_s": ints_s / max(1, len(us)),
        "probe_work": (sum(_record_work(r, predicate) for r in recs)
                       + ints_r + ints_s),
    }


# ---------------------------------------------------------------------------
# Cost model + chooser
# ---------------------------------------------------------------------------

def static_configs(predicate: str, methods: tuple, n_orders: list,
                   orders: tuple, n_order_req: int) -> list:
    """The static configuration space the planner prices (and the sweep
    space of a join-order sweep). Join orders only vary for
    the three-join predicates; within/linestring have a fixed order."""
    cfgs = []
    if "none" in methods:
        cfgs.append(PlanChoice(method="none", n_order=n_order_req,
                               order=ORDER_CHOICES[0], skip_filter=True,
                               predicate=predicate))
    sweep = orders if predicate in ("intersects", "selection") \
        else (ORDER_CHOICES[0],)
    for meth in methods:
        if meth == "none":
            continue
        for n in n_orders:
            for order in sweep:
                cfgs.append(PlanChoice(method=meth, n_order=int(n),
                                       order=tuple(order),
                                       predicate=predicate))
    return cfgs


def _config_cost(cfg: PlanChoice, profiles: dict, n_cand: int,
                 len_r: int, len_s: int, mean_refine_all: float,
                 o: dict) -> dict:
    if cfg.method == "none":
        refine = o["c_refine"] * n_cand * mean_refine_all
        return {"build": 0.0, "filter": 0.0, "decode": 0.0,
                "refine": refine, "total": refine}
    prof = profiles[cfg.n_order]
    recs = prof["recs"]
    m = max(1, len(recs))
    filter_w = n_cand * sum(
        _order_work(r, cfg.order, cfg.predicate) for r in recs) / m
    refine_w = o["c_refine"] * n_cand * sum(
        r["refine"] for r in recs if r["verdict"] == INDECISIVE) / m
    build_w = o["c_build"] * (prof["mean_ints_r"] * len_r
                              + prof["mean_ints_s"] * len_s)
    build_w /= max(1e-9, o["amortize_build"])
    decode_w = 0.0
    if cfg.method == "april-c":
        build_w *= _COMPRESS_BUILD_FACTOR
        mean_a = sum(r["lens"][0] + r["lens"][2] for r in recs) / m
        mean_f = sum(r["lens"][1] + r["lens"][3] for r in recs) / m
        aa_rate = sum(1 for r in recs if r["aa_hit"]) / m
        decode_w = o["c_decode"] * n_cand * (mean_a + aa_rate * mean_f)
    total = build_w + filter_w + refine_w + decode_w
    return {"build": build_w, "filter": filter_w, "refine": refine_w,
            "decode": decode_w, "total": total}


def _rates(recs: list) -> dict:
    m = max(1, len(recs))
    return {"hit": sum(1 for r in recs if r["verdict"] == TRUE_HIT) / m,
            "neg": sum(1 for r in recs if r["verdict"] == TRUE_NEG) / m,
            "indec": sum(
                1 for r in recs if r["verdict"] == INDECISIVE) / m}


def choose_plan(R, S, pairs: np.ndarray, *, predicate: str = "intersects",
                n_order: int = 10, extent: Extent = GLOBAL_EXTENT,
                r_kind: str = "polygon", **opts) -> PlanChoice:
    """Pick the cheapest configuration for this workload (module docstring
    has the cost model). Deterministic: seeded sampling, stable-key
    tiebreak on equal costs."""
    unknown = set(opts) - set(PLAN_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown plan option(s) {sorted(unknown)}; "
                        f"expected a subset of {sorted(PLAN_DEFAULTS)}")
    o = dict(PLAN_DEFAULTS)
    o.update(opts)
    methods = tuple(o["methods"])
    bad = set(methods) - set(PLANNER_METHODS)
    if bad:
        raise ValueError(f"planner cannot cost method(s) {sorted(bad)}; "
                         f"supported: {PLANNER_METHODS}")
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    n_cand = len(pairs)

    if n_cand < o["skip_filter_below"]:
        # Too few candidates to amortize ANY preprocessing: straight to
        # refinement, no probe builds, no sampling.
        return PlanChoice(
            method="none", n_order=n_order, order=ORDER_CHOICES[0],
            pipeline_mode="staged", skip_filter=True, predicate=predicate,
            est={"n_candidates": n_cand, "sample_size": 0,
                 "seed": o["seed"], "skip_rule": True, "costs": {},
                 "total": 0.0, "plan_work": 0.0})

    rng = np.random.default_rng(o["seed"])
    # probe at most 1/16th of the candidates (floor 8): on small workloads
    # a full-size sample would cost a sizeable fraction of the join itself
    m = min(int(o["sample_size"]), max(8, n_cand // 16), n_cand)
    sample = pairs[np.sort(rng.choice(n_cand, size=m, replace=False))]

    n_orders = o["n_orders"]
    if n_orders is None:
        n_orders = sorted({max(4, n_order - 2), n_order,
                           min(14, n_order + 2)})
    n_orders = [int(n) for n in n_orders]

    profiles: dict = {}
    plan_work = 0.0

    def _est_ref() -> float:
        # cheapest full-join estimate over the granularities probed so
        # far — the yardstick the probe budget is measured against
        mra = (sum(r["refine"] for r in profiles[probe_seq[0]]["recs"])
               / max(1, m))
        best = None
        for cfg in static_configs(predicate, methods, sorted(profiles),
                                  o["orders"], n_order):
            c = _config_cost(cfg, profiles, n_cand, len(R), len(S), mra, o)
            best = c["total"] if best is None else min(best, c["total"])
        return best if best is not None else 0.0

    # The requested granularity is always probed; alternates (cheapest
    # first) only while planning stays within probe_budget of the
    # predicted join cost. A finer/coarser probe's cost is predicted at
    # x4 per +2 orders — the F-interval area scaling.
    probe_seq = ([n_order] if n_order in n_orders else []) \
        + sorted(n for n in n_orders if n != n_order)
    for n in probe_seq:
        if profiles:
            base = min(profiles, key=lambda p: abs(p - n))
            predicted = profiles[base]["probe_work"] * 4.0 ** ((n - base) / 2)
            if plan_work + predicted > o["probe_budget"] * _est_ref():
                continue
        profiles[n] = _profile(R, S, sample, n, predicate, extent, r_kind)
        plan_work += profiles[n]["probe_work"]

    n_orders = sorted(profiles)
    any_recs = profiles[n_orders[0]]["recs"]
    mean_refine_all = sum(r["refine"] for r in any_recs) / max(1, m)

    costs = {}
    parts = {}
    for cfg in static_configs(predicate, methods, n_orders, o["orders"],
                              n_order):
        c = _config_cost(cfg, profiles, n_cand, len(R), len(S),
                         mean_refine_all, o)
        costs[cfg.key()] = c["total"]
        parts[cfg.key()] = (cfg, c)
    best_key = min(costs, key=lambda k: (costs[k], k))
    best, best_cost = parts[best_key]

    pipeline_mode = ("fused" if best.method != "none"
                     and n_cand >= o["fuse_above"] else "staged")
    est = {
        "n_candidates": n_cand, "sample_size": m, "seed": o["seed"],
        "n_orders": list(n_orders),
        "rates": _rates(profiles[best.n_order]["recs"])
        if best.method != "none" else _rates(any_recs),
        "costs": {k: round(v, 3) for k, v in costs.items()},
        "best_static": best_key, "total": best_cost["total"],
        "components": {k: round(v, 3) for k, v in best_cost.items()},
        "plan_work": plan_work,
    }
    return PlanChoice(method=best.method, n_order=best.n_order,
                      order=tuple(best.order), pipeline_mode=pipeline_mode,
                      skip_filter=best.method == "none",
                      predicate=predicate, est=est)


# ---------------------------------------------------------------------------
# Ground truth: the work a config actually performs
# ---------------------------------------------------------------------------

def measured_work(R, S, pairs: np.ndarray, cfg: PlanChoice, *,
                  extent: Extent = GLOBAL_EXTENT, r_kind: str = "polygon",
                  store_bank: dict | None = None, **opts) -> dict:
    """Deterministic work units a static config spends on the FULL
    candidate set: early-exit interval comparisons, build work per
    interval constructed, refinement work per vertex product, and — for
    APRIL-C — the exact unique-object decode quantity (A-intervals of the
    batch plus F-intervals of the AA survivors). Shares the cost-model
    constants with :func:`choose_plan` so estimated and measured totals
    are commensurable; ``store_bank`` caches full builds across configs
    keyed by ``(r_kind, n_order)``."""
    from .filters import get_filter
    o = dict(PLAN_DEFAULTS)
    o.update(opts)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    predicate = cfg.predicate
    if cfg.method == "none" or cfg.skip_filter:
        refine = o["c_refine"] * float(np.sum(
            R.nverts[pairs[:, 0]].astype(np.float64)
            * S.nverts[pairs[:, 1]]))
        return {"build": 0.0, "filter": 0.0, "decode": 0.0,
                "refine": refine, "total": refine}

    key = (r_kind, cfg.n_order)
    if store_bank is not None and key in store_bank:
        ax_r, ax_s = store_bank[key]
    else:
        filt = get_filter("april")
        ax_r = filt.build(R, n_order=cfg.n_order, extent=extent,
                          kind=r_kind)
        ax_s = filt.build(S, n_order=cfg.n_order, extent=extent,
                          kind="polygon")
        if store_bank is not None:
            store_bank[key] = (ax_r, ax_s)

    build_w = o["c_build"] * (_store_ints(ax_r.store)
                              + _store_ints(ax_s.store))
    build_w /= max(1e-9, o["amortize_build"])
    if cfg.method == "april-c":
        build_w *= _COMPRESS_BUILD_FACTOR

    filter_w = 0
    refine_w = 0.0
    aa_survivors: set[tuple[str, int]] = set()
    for gi, gj in pairs:
        Ar, Fr = _lists(ax_r.store, int(gi), r_kind)
        As_, Fs = _lists(ax_s.store, int(gj), "polygon")
        rec = _pair_record(Ar, Fr, As_, Fs,
                           float(R.nverts[gi]) * float(S.nverts[gj]),
                           predicate)
        filter_w += _order_work(rec, cfg.order, predicate)
        if rec["verdict"] == INDECISIVE:
            refine_w += o["c_refine"] * rec["refine"]
        if rec["aa_hit"]:
            aa_survivors.add(("r", int(gi)))
            aa_survivors.add(("s", int(gj)))

    decode_w = 0.0
    if cfg.method == "april-c":
        stores = {"r": (ax_r.store, r_kind), "s": (ax_s.store, "polygon")}
        for side, uniq in (("r", np.unique(pairs[:, 0])),
                           ("s", np.unique(pairs[:, 1]))):
            store, kind = stores[side]
            for g in uniq:
                A, F = _lists(store, int(g), kind)
                decode_w += len(A)
                if (side, int(g)) in aa_survivors:
                    decode_w += len(F)
        decode_w *= o["c_decode"]

    total = build_w + filter_w + refine_w + decode_w
    return {"build": build_w, "filter": float(filter_w),
            "decode": decode_w, "refine": refine_w, "total": total}
