"""Function-style entry points over the `JoinPlan` session API, kept for
the reference package's call sites:

    spatial_intersection_join(R, S, method="april")   # intersects
    spatial_within_join(R, S)                         # r within s
    polygon_linestring_join(S, L)                     # (line, poly) pairs
    selection_queries(data, queries)                  # per-query hits
    tiled_spatial_join(r_chunks, s_chunks)            # out-of-core, tiled

New code should use ``JoinPlan(R, S, filter=...).build().execute(p)``.
Every shim forwards the backend knobs, ``pipeline_mode``, ``plan_mode``
and ``device`` (``None`` -> ``"cuda"``) to ``JoinPlan``; the filter and
refine backends default to what ``JoinPlan`` picks for the device. The
reference's ``use_jnp=True`` has no counterpart: the device filter path
is ``filter_backend="cuda"``.
"""
from __future__ import annotations

import numpy as np

from ..core.april import AprilStore
from ..core.compress import compress_april
from .plan import JoinPlan, JoinStats

__all__ = ["JoinStats", "spatial_intersection_join", "spatial_within_join",
           "polygon_linestring_join", "selection_queries",
           "tiled_spatial_join"]


def _plan(R, S, method, n_order, *, filter_backend=None,
          refine_backend=None, mbr_backend="numpy", mbr_grid=None,
          max_ra_cells=None, order=None, r_kind="polygon",
          pipeline_mode="staged", plan_mode="static", device=None):
    build_opts = {}
    filter_opts = {}
    if method == "ra" and max_ra_cells is not None:
        build_opts["max_cells"] = max_ra_cells
    if order is not None and method in ("april", "april-c"):
        filter_opts["order"] = order
    return JoinPlan(R, S, filter=method, filter_backend=filter_backend,
                    refine_backend=refine_backend, mbr_backend=mbr_backend,
                    n_order=n_order, mbr_grid=mbr_grid, r_kind=r_kind,
                    pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                    build_opts=build_opts, filter_opts=filter_opts,
                    device=device)


def _adopt(method: str, store):
    """Adapt a raw prebuilt store: APRIL-C call sites pass raw
    AprilStores, compressed here."""
    if store is not None and method == "april-c" \
            and isinstance(store, AprilStore):
        return compress_april(store)
    return store


def spatial_intersection_join(
    R, S, method: str = "april", n_order: int = 10,
    order: tuple[str, ...] = ("AA", "AF", "FA"),
    use_jnp: bool = False, max_ra_cells: int = 750,
    prebuilt: tuple | None = None, mbr_grid: int | None = None,
    refine_backend: str | None = None, mbr_backend: str = "numpy",
    filter_backend: str | None = None, pipeline_mode: str = "staged",
    plan_mode: str = "static", device=None,
) -> tuple[np.ndarray, JoinStats]:
    """The full intersects join; returns (pairs [K, 2], stats).
    ``plan_mode="adaptive"`` lets the planner override method and
    order."""
    if use_jnp:
        raise ValueError("use_jnp=True is the reference's device filter "
                         "switch; the port's is filter_backend='cuda'")
    plan = _plan(R, S, method, n_order, filter_backend=filter_backend,
                 refine_backend=refine_backend, mbr_backend=mbr_backend,
                 mbr_grid=mbr_grid, max_ra_cells=max_ra_cells, order=order,
                 pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                 device=device)
    if prebuilt is not None:
        pr, ps = prebuilt
        plan.build(prebuilt=(_adopt(method, pr), _adopt(method, ps)))
    return plan.execute("intersects")


def tiled_spatial_join(
    r_chunks, s_chunks, predicate: str = "intersects",
    method: str = "april", n_order: int = 10,
    tile_budget: int | None = None, balance: str = "cost",
    ckpt_dir: str | None = None, resume: bool = True,
    filter_backend: str | None = None, refine_backend: str | None = None,
    mbr_backend: str = "numpy", pipeline_mode: str = "staged",
    plan_mode: str = "static", device=None, **scaleout_opts,
) -> tuple[np.ndarray, JoinStats]:
    """The out-of-core tiled join with the knob names of the shims above,
    plus the partitioner's ``tile_budget`` (resident bytes a tile) and
    ``balance``, and ``ckpt_dir`` / ``resume`` (a rerun continues at the
    first unfinished tile). Inputs are chunk iterators or in-memory
    datasets; result pairs are global ids, the pair set of the in-memory
    shims. Forwards to :func:`~repro_torch.spatial.scaleout.tiled_join`."""
    from .scaleout import SCALEOUT_DEFAULTS, tiled_join
    if tile_budget is not None:
        scaleout_opts["tile_budget"] = tile_budget
    scaleout_opts.setdefault("tile_budget", SCALEOUT_DEFAULTS["tile_budget"])
    return tiled_join(r_chunks, s_chunks, predicate=predicate,
                      method=method, n_order=n_order,
                      filter_backend=filter_backend,
                      refine_backend=refine_backend,
                      mbr_backend=mbr_backend, pipeline_mode=pipeline_mode,
                      plan_mode=plan_mode, ckpt_dir=ckpt_dir, resume=resume,
                      balance=balance, device=device, **scaleout_opts)


def spatial_within_join(
    R, S, method: str = "april", n_order: int = 10,
    prebuilt: tuple | None = None, refine_backend: str | None = None,
    mbr_backend: str = "numpy", filter_backend: str | None = None,
    pipeline_mode: str = "staged", plan_mode: str = "static", device=None,
) -> tuple[np.ndarray, JoinStats]:
    """The within join (§4.3.2): pairs (r, s) with r within s."""
    plan = _plan(R, S, method, n_order, filter_backend=filter_backend,
                 refine_backend=refine_backend, mbr_backend=mbr_backend,
                 pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                 device=device)
    if prebuilt is not None:
        plan.build(prebuilt=tuple(_adopt(method, p) for p in prebuilt))
    return plan.execute("within")


def polygon_linestring_join(
    S, L, method: str = "april", n_order: int = 10,
    prebuilt=None, refine_backend: str | None = None,
    mbr_backend: str = "numpy", filter_backend: str | None = None,
    pipeline_mode: str = "staged", plan_mode: str = "static", device=None,
) -> tuple[np.ndarray, JoinStats]:
    """The polygon x linestring join (§4.3.3): pairs are (line, poly).
    ``prebuilt`` is the polygon side's store."""
    plan = _plan(L, S, method, n_order, r_kind="line",
                 filter_backend=filter_backend,
                 refine_backend=refine_backend, mbr_backend=mbr_backend,
                 pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                 device=device)
    if prebuilt is not None:
        plan.build(prebuilt=(None, _adopt(method, prebuilt)))
    return plan.execute("linestring")


def selection_queries(
    data, queries, method: str = "april", n_order: int = 10, prebuilt=None,
    refine_backend: str | None = None, mbr_backend: str = "numpy",
    filter_backend: str | None = None, pipeline_mode: str = "staged",
    plan_mode: str = "static", device=None,
) -> tuple[list[np.ndarray], JoinStats]:
    """Polygonal range queries (§4.3.1): per query polygon, the data
    polygons intersecting it. ``prebuilt`` is the data side's store."""
    plan = _plan(data, queries, method, n_order,
                 filter_backend=filter_backend,
                 refine_backend=refine_backend, mbr_backend=mbr_backend,
                 pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                 device=device)
    if prebuilt is not None:
        plan.build(prebuilt=(_adopt(method, prebuilt), None))
    pairs, stats = plan.execute("selection")
    results = [pairs[pairs[:, 1] == q, 0] for q in range(len(queries))]
    return results, stats
