"""One-step intervalization of many polygons (host, numpy).

Gaps in each polygon's sorted Partial-cell sequence are classified
Full/Empty by ONE vectorized PiP pass over all gap-head cells, including
each polygon's virtual leading gap ``[0, first_partial)`` and trailing gap
``[last_partial+1, 4^N)``, which keeps corner-covering polygons exact.
Intervals are half-open ``[start, end)`` over Hilbert ids, uint64.
"""
from __future__ import annotations

import numpy as np

from . import geometry, rasterize
from .hilbert import d2xy, xy2d
from .rasterize import Extent, GLOBAL_EXTENT

__all__ = ["intervals_from_ids", "runs_from_sorted", "onestep_multi"]


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
    extent: Extent = GLOBAL_EXTENT,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-step intervalization of MANY polygons in one pass.

    One multi-polygon DDA traversal, then ONE vectorized PiP pass over the
    gap heads of all polygons. Returns CSR ``(a_off [P+1], a_ints
    [sum_Ia,2], f_off [P+1], f_ints [sum_If,2])``.
    """
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P = len(nverts)
    n_cells_total = np.uint64(1) << np.uint64(2 * n_order)

    p_off, cells = rasterize.dda_partial_cells_multi(
        verts, nverts, n_order, extent)
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

    gap_full = np.zeros(total_g, bool)
    idx = np.nonzero((ge > gs) & (nverts[gp] >= 3))[0]
    if len(idx):
        hx, hy = d2xy(n_order, gs[idx])
        centers = rasterize.cell_centers(hx, hy, n_order, extent)
        gap_full[idx] = geometry.points_in_polygon_rows(
            centers, gp[idx], verts, nverts)

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
