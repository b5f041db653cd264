"""Intervalization: from raster cells to A- and F-interval lists.

* :func:`onestep_multi` — one-step intervalization of many polygons: gaps
  in each polygon's sorted Partial-cell sequence are classified Full/Empty
  by ONE vectorized PiP pass over all gap-head cells (on the host, or on a
  device with ``backend="torch"``).
* :func:`onestep` — the same for one polygon, with ``method`` ``batched``
  (one PiP pass), ``pips`` (one PiP a gap, sequential) or ``neighbors``
  (Algorithm 3's CheckNeighbors: inherit Full/Empty from a resolved
  4-neighbour with a smaller Hilbert id, else one PiP).
* :func:`april_from_cells` — the full-rasterization path: labeled
  Partial/Full cell sets merged into intervals.

Every method also classifies each polygon's virtual leading gap
``[0, first_partial)`` and trailing gap ``[last_partial+1, 4^N)``, which
keeps corner-covering polygons exact. ``PIP_COUNTER`` counts the PiP tests
(construction builds may run on threads, so the increment takes a lock).
Intervals are half-open ``[start, end)`` over Hilbert ids, uint64.
"""
from __future__ import annotations

import bisect
import threading

import numpy as np
import torch

from . import geometry, rasterize
from .geometry import build_device
from .hilbert import d2xy, d2xy_torch, xy2d
from .rasterize import Extent, GLOBAL_EXTENT

__all__ = [
    "intervals_from_ids", "april_from_cells", "onestep", "onestep_multi",
    "ids_in_intervals", "runs_from_sorted", "PIP_COUNTER",
]

#: PiP tests made by the constructions, reset and read by callers
PIP_COUNTER = {"count": 0}
_PIP_LOCK = threading.Lock()


def _count_pips(n: int) -> None:
    with _PIP_LOCK:
        PIP_COUNTER["count"] += n


def intervals_from_ids(ids: np.ndarray) -> np.ndarray:
    """Merge a sorted unique id array into [I,2] half-open intervals."""
    ids = np.asarray(ids, dtype=np.uint64)
    if len(ids) == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    brk = np.nonzero(np.diff(ids) != 1)[0]
    starts = np.concatenate([ids[:1], ids[brk + 1]])
    ends = np.concatenate([ids[brk], ids[-1:]]) + np.uint64(1)
    return np.stack([starts, ends], axis=1)


def runs_from_sorted(pid: np.ndarray, ids: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Maximal consecutive-id runs of a flat (polygon, id) sequence sorted
    by (pid, id): returns (run_start, run_end, run_poly), half-open ends."""
    if len(ids) == 0:
        z = np.zeros(0, np.uint64)
        return z, z.copy(), np.zeros(0, np.int64)
    newpoly = np.r_[True, pid[1:] != pid[:-1]]
    brk = newpoly | np.r_[True, ids[1:] != ids[:-1] + np.uint64(1)]
    run_start = ids[brk]
    run_end = ids[np.r_[brk[1:], True]] + np.uint64(1)
    return run_start, run_end, pid[brk]


def ids_in_intervals(intervals: np.ndarray) -> np.ndarray:
    """Expand [I,2] intervals back to a sorted id array (test helper)."""
    if len(intervals) == 0:
        return np.zeros((0,), dtype=np.uint64)
    out = [np.arange(s, e, dtype=np.uint64) for s, e in intervals]
    return np.concatenate(out) if out else np.zeros((0,), dtype=np.uint64)


def april_from_cells(partial_cells: np.ndarray, full_cells: np.ndarray,
                     n_order: int) -> tuple[np.ndarray, np.ndarray]:
    """(A-list, F-list) from labeled cell-coordinate sets (full-raster path)."""
    p_ids = rasterize.cells_to_hilbert(np.asarray(partial_cells, np.int64), n_order)
    f_ids = rasterize.cells_to_hilbert(np.asarray(full_cells, np.int64), n_order)
    a_ids = np.union1d(p_ids, f_ids)
    return intervals_from_ids(a_ids), intervals_from_ids(f_ids)


def onestep(
    verts: np.ndarray, n: int, n_order: int,
    extent: Extent = GLOBAL_EXTENT, method: str = "batched",
) -> tuple[np.ndarray, np.ndarray]:
    """One-step intervalization of one polygon (paper Alg. 3, or its batched
    variant: one PiP pass over every gap head).

    Returns (A-list [Ia,2], F-list [If,2]) uint64 half-open intervals.
    """
    v = np.asarray(verts, np.float64)
    cells = rasterize.dda_partial_cells(v, n, n_order, extent)
    p = rasterize.cells_to_hilbert(cells, n_order)
    if len(p) == 0:
        # The boundary misses the grid entirely: the single virtual gap
        # [0, 4^N) is the whole raster area — one PiP decides Full/Empty
        # (a §5.2 partition fully covered by a large polygon).
        n_cells_total = np.uint64(1) << np.uint64(2 * n_order)
        if int(n) >= 3 and bool(_classify_gaps_batched(
                v, n, n_order, extent, np.array([0], np.uint64))[0]):
            whole = np.array([[0, n_cells_total]], np.uint64)
            return whole, whole.copy()
        return np.zeros((0, 2), np.uint64), np.zeros((0, 2), np.uint64)

    # Partial runs and the R+1 gaps around them (incl. virtual lead/trail).
    brk = np.nonzero(np.diff(p) != 1)[0]
    run_start = np.concatenate([p[:1], p[brk + 1]])            # [R]
    run_end = np.concatenate([p[brk], p[-1:]]) + np.uint64(1)  # [R]
    n_cells_total = np.uint64(1) << np.uint64(2 * n_order)
    gap_start = np.concatenate([[np.uint64(0)], run_end])      # [R+1]
    gap_end = np.concatenate([run_start, [n_cells_total]])     # [R+1]
    nonzero = gap_end > gap_start                              # [R+1]

    gap_full = np.zeros(len(gap_start), dtype=bool)
    idx = np.nonzero(nonzero)[0]
    if len(idx):
        if method == "batched":
            gap_full[idx] = _classify_gaps_batched(
                v, n, n_order, extent, gap_start[idx])
        elif method == "pips":
            gap_full[idx] = _classify_gaps_pips(
                v, n, n_order, extent, gap_start[idx])
        elif method == "neighbors":
            gap_full[idx] = _classify_gaps_neighbors(
                v, n, n_order, extent, p, gap_start[idx], gap_end[idx])
        else:
            raise ValueError(f"unknown method {method!r}")

    return _assemble(run_start, run_end, gap_start, gap_end, gap_full)


def _assemble(run_start, run_end, gap_start, gap_end, gap_full):
    """Interleave gap/run blocks: G0 R0 G1 R1 ... R_{R-1} G_R; A-intervals
    break exactly at non-Full gaps; F-intervals are the Full gaps."""
    R = len(run_start)
    f_sel = gap_full & (gap_end > gap_start)
    f_list = np.stack([gap_start[f_sel], gap_end[f_sel]], axis=1).astype(np.uint64)

    n_blocks = 2 * R + 1
    b_start = np.empty(n_blocks, dtype=np.uint64)
    b_end = np.empty(n_blocks, dtype=np.uint64)
    b_in_a = np.empty(n_blocks, dtype=bool)
    b_start[0::2] = gap_start; b_end[0::2] = gap_end; b_in_a[0::2] = f_sel
    b_start[1::2] = run_start; b_end[1::2] = run_end; b_in_a[1::2] = True

    # zero-length gaps break nothing: drop them before merging runs
    zero_len = b_end == b_start
    keep = ~zero_len
    bs, be, ba = b_start[keep], b_end[keep], b_in_a[keep]
    if len(bs) == 0:
        return np.zeros((0, 2), np.uint64), f_list
    joined = (bs[1:] == be[:-1]) & ba[1:] & ba[:-1]
    seg_break = ~joined
    starts_mask = ba & np.concatenate([[True], seg_break])
    ends_mask = ba & np.concatenate([seg_break, [True]])
    a_list = np.stack([bs[starts_mask], be[ends_mask]], axis=1).astype(np.uint64)
    return a_list, f_list


def onestep_multi(
    verts: np.ndarray, nverts: np.ndarray, n_order: int,
    extent: Extent = GLOBAL_EXTENT, backend: str = "numpy", device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-step intervalization of MANY polygons in one pass.

    One multi-polygon DDA traversal, then ONE vectorized PiP pass over the
    gap heads of all polygons. Returns CSR ``(a_off [P+1], a_ints
    [sum_Ia,2], f_off [P+1], f_ints [sum_If,2])``, interval-identical to
    per-polygon ``onestep(method='batched')`` calls. ``backend="torch"``
    maps the gap heads to cell centers and runs their PiP on ``device``
    (:func:`~repro_torch.core.geometry.points_in_polygon_rows_torch`).
    """
    dev = build_device(backend, device)
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P = len(nverts)
    stage = geometry.BUILD_STAGES.stage
    with stage("dda"):
        p_off, cells = rasterize.dda_partial_cells_multi(
            verts, nverts, n_order, extent)
    with stage("pack"):
        gs, ge, gp, goff, run_start, run_end, roff = _gaps(P, n_order, p_off,
                                                           cells)
    gap_full = np.zeros(len(gs), bool)
    idx = np.nonzero((ge > gs) & (nverts[gp] >= 3))[0]
    if len(idx):
        _count_pips(len(idx))
        with stage("pip"):
            gap_full[idx] = _gap_heads_inside(verts, nverts, n_order, extent,
                                              gs[idx], gp[idx], dev)
    with stage("pack"):
        return _assemble_all(P, roff, goff, run_start, run_end, gs, ge,
                             gap_full)


def _gaps(P, n_order, p_off, cells):
    """Each polygon's sorted Partial runs and the R_p + 1 gaps around them:
    (gap starts, ends, polygons, offsets, run starts, ends, offsets)."""
    n_cells_total = np.uint64(1) << np.uint64(2 * n_order)
    n_partial = np.diff(p_off)
    pid = np.repeat(np.arange(P), n_partial)
    ids = xy2d(n_order, cells[:, 0], cells[:, 1])
    order = np.argsort(pid.astype(np.uint64) * n_cells_total + ids)
    ids = ids[order]                       # sorted Hilbert ids per polygon

    run_start, run_end, run_poly = runs_from_sorted(pid, ids)
    roff = np.zeros(P + 1, np.int64)
    roff[1:] = np.cumsum(np.bincount(run_poly, minlength=P))

    # R_p + 1 gaps per polygon, interleaved with its runs (virtual lead and
    # trail gaps included; a polygon with no Partial cells keeps its single
    # whole-grid gap)
    goff = roff + np.arange(P + 1)
    total_g = goff[-1]
    gp = np.repeat(np.arange(P), np.diff(goff))
    gs = np.empty(total_g, np.uint64)
    ge = np.empty(total_g, np.uint64)
    first = np.zeros(total_g, bool)
    first[goff[:-1]] = True
    last = np.zeros(total_g, bool)
    last[goff[1:] - 1] = True
    gs[first] = np.uint64(0)
    gs[~first] = run_end
    ge[last] = n_cells_total
    ge[~last] = run_start

    return gs, ge, gp, goff, run_start, run_end, roff


def _gap_heads_inside(verts, nverts, n_order, extent, heads, poly, dev):
    """Whether each gap head's cell center lies in its polygon: on the
    host, or with ``dev`` the ids mapped to centers and tested there."""
    if dev is None:
        return geometry.points_in_polygon_rows(
            _gap_head_centers(heads, n_order, extent), poly, verts, nverts)
    hx, hy = d2xy_torch(n_order, torch.as_tensor(heads.astype(np.int64),
                                                 device=dev))
    h = extent.cell_size(n_order)
    centers = torch.stack([extent.x0 + (hx.to(torch.float64) + 0.5) * h,
                           extent.y0 + (hy.to(torch.float64) + 0.5) * h],
                          dim=-1)
    return geometry.points_in_polygon_rows_torch(centers, poly, verts,
                                                 nverts, device=dev)


def _assemble_all(P, roff, goff, run_start, run_end, gs, ge, gap_full):
    """The CSR lists of every polygon from its runs and classified gaps."""
    a_chunks, f_chunks = [], []
    a_off = np.zeros(P + 1, np.int64)
    f_off = np.zeros(P + 1, np.int64)
    for p in range(P):
        r0, r1 = roff[p], roff[p + 1]
        g0, g1 = goff[p], goff[p + 1]
        a, f = _assemble(run_start[r0:r1], run_end[r0:r1],
                         gs[g0:g1], ge[g0:g1], gap_full[g0:g1])
        a_chunks.append(a)
        f_chunks.append(f)
        a_off[p + 1] = a_off[p] + len(a)
        f_off[p + 1] = f_off[p] + len(f)
    cat = lambda ch: (np.concatenate(ch, axis=0) if ch
                      else np.zeros((0, 2), np.uint64))
    return a_off, cat(a_chunks), f_off, cat(f_chunks)


def _gap_head_centers(gap_start, n_order, extent):
    hx, hy = d2xy(n_order, np.asarray(gap_start, np.uint64))
    return rasterize.cell_centers(hx, hy, n_order, extent)


def _classify_gaps_batched(v, n, n_order, extent, gap_start) -> np.ndarray:
    """ALL gap heads tested in one vectorized PiP pass."""
    centers = _gap_head_centers(gap_start, n_order, extent)
    _count_pips(len(gap_start))
    return geometry.points_in_polygon(centers, v[: int(n)])


def _classify_gaps_pips(v, n, n_order, extent, gap_start) -> np.ndarray:
    """One PiP per gap, sequential — OneStep (PiPs) of Table 11."""
    centers = _gap_head_centers(gap_start, n_order, extent)
    out = np.zeros(len(gap_start), dtype=bool)
    poly = v[: int(n)]
    _count_pips(len(gap_start))
    for i in range(len(gap_start)):          # deliberate sequential loop
        out[i] = bool(geometry.points_in_polygon(centers[i: i + 1], poly)[0])
    return out


def _classify_gaps_neighbors(v, n, n_order, extent, p, gap_start, gap_end) -> np.ndarray:
    """Faithful Alg. 3 CheckNeighbors: inspect 4-adjacent cells of the gap
    head with SMALLER Hilbert id; inherit Full/Empty from a resolved gap, else
    fall back to one PiP test. Sequential by construction."""
    poly = v[: int(n)]
    G = 1 << n_order
    n_gaps = len(gap_start)
    out = np.zeros(n_gaps, dtype=bool)
    f_starts: list[int] = []; f_ends: list[int] = []
    e_starts: list[int] = []; e_ends: list[int] = []
    p_list = p.tolist()

    def in_intervals(idv: int, starts: list[int], ends: list[int]) -> bool:
        k = bisect.bisect_right(starts, idv) - 1
        return k >= 0 and idv < ends[k]

    for g in range(n_gaps):
        head = int(gap_start[g])
        hx, hy = d2xy(n_order, np.array([head], dtype=np.uint64))
        hx, hy = int(hx[0]), int(hy[0])
        decided = None
        for nx_, ny_ in ((hx + 1, hy), (hx - 1, hy), (hx, hy + 1), (hx, hy - 1)):
            if not (0 <= nx_ < G and 0 <= ny_ < G):
                continue
            nid = int(xy2d(n_order, np.array([nx_]), np.array([ny_]))[0])
            if nid >= head:
                continue  # not yet visited in Hilbert order
            k = bisect.bisect_left(p_list, nid)
            if k < len(p_list) and p_list[k] == nid:
                continue  # partial neighbor is uninformative
            if in_intervals(nid, f_starts, f_ends):
                decided = True
                break
            if in_intervals(nid, e_starts, e_ends):
                decided = False
                break
        if decided is None:
            c = rasterize.cell_centers(np.array([hx]), np.array([hy]), n_order, extent)
            _count_pips(1)
            decided = bool(geometry.points_in_polygon(c, poly)[0])
        out[g] = decided
        if decided:
            f_starts.append(int(gap_start[g])); f_ends.append(int(gap_end[g]))
        else:
            e_starts.append(int(gap_start[g])); e_ends.append(int(gap_end[g]))
    return out
