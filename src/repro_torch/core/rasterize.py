"""Polygon rasterization onto the global 2^N x 2^N grid (host, numpy).

The multi-polygon Amanatides-Woo traversal that one-step intervalization
needs: every cell crossed by a polygon boundary (the Partial cells) of a
whole dataset in one vectorized pass, or every cell an open chain crosses
(the line stores). RI construction adds the scanline
parity fill of the Full cells and the exact coverage fraction of every
Partial cell, both dataset-batched (the clip pass also on a device,
``backend="torch"``). The per-polygon paths of the sequential builds and
of APRIL's other construction methods sit beside them:
:func:`dda_partial_cells`, :func:`scanline_full_cells`, the flood fill
:func:`floodfill_classify`, the per-cell clip :func:`coverage_fractions`,
and the brute-force oracle :func:`classify_window_oracle`. A raster
``extent`` is the square (x0, y0, side) covered by the grid.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from . import geometry
from .hilbert import xy2d

__all__ = [
    "Extent", "GLOBAL_EXTENT", "cells_of_points", "cell_centers",
    "clip_segments_to_grid", "dda_traverse", "dda_partial_cells",
    "dda_partial_cells_multi", "scanline_full_cells",
    "scanline_full_cells_multi", "floodfill_classify", "coverage_fractions",
    "coverage_fractions_multi", "classify_window_oracle", "cells_to_hilbert",
    "size_buckets",
]


@dataclass(frozen=True)
class Extent:
    """Square raster area: origin (x0, y0) and side length."""
    x0: float
    y0: float
    side: float

    def cell_size(self, n_order: int) -> float:
        return self.side / (1 << n_order)


GLOBAL_EXTENT = Extent(0.0, 0.0, 1.0)

size_buckets = geometry.size_buckets


def _grid_coords(points: np.ndarray, n_order: int, extent: Extent) -> np.ndarray:
    """Continuous coords -> grid coords in [0, 2^n_order)."""
    g = (np.asarray(points, np.float64) - np.array([extent.x0, extent.y0])) \
        / extent.cell_size(n_order)
    return g


def cells_of_points(points: np.ndarray, n_order: int,
                    extent: Extent) -> np.ndarray:
    """Cell (cx, cy) of each point, clipped into the grid. [..., 2] int64."""
    g = np.floor(_grid_coords(points, n_order, extent)).astype(np.int64)
    return np.clip(g, 0, (1 << n_order) - 1)


def cell_centers(cx: np.ndarray, cy: np.ndarray, n_order: int,
                 extent: Extent) -> np.ndarray:
    h = extent.cell_size(n_order)
    return np.stack([extent.x0 + (np.asarray(cx, np.float64) + 0.5) * h,
                     extent.y0 + (np.asarray(cy, np.float64) + 0.5) * h], axis=-1)


def clip_segments_to_grid(a: np.ndarray, b: np.ndarray, G) -> tuple:
    """Liang–Barsky clip of segments a->b (grid coords) to the square
    [0, G]^2. Returns (a_c [E,2], b_c [E,2], keep [E]); segments fully
    outside are dropped. Fully-inside segments pass through bit-unchanged.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    E = len(a)
    d = b - a
    Gf = np.broadcast_to(np.asarray(G, np.float64), (E,))
    t0 = np.zeros(E)
    t1 = np.ones(E)
    keep = np.ones(E, bool)
    for axis in (0, 1):
        da = d[:, axis]
        pa = a[:, axis]
        for p, q in ((-da, pa), (da, Gf - pa)):
            par = p == 0
            keep &= ~(par & (q < 0))
            with np.errstate(divide="ignore", invalid="ignore"):
                r = q / np.where(par, 1.0, p)
            t0 = np.where(~par & (p < 0), np.maximum(t0, r), t0)
            t1 = np.where(~par & (p > 0), np.minimum(t1, r), t1)
    keep &= t0 <= t1
    a_c = np.where((t0 > 0)[:, None], a + t0[:, None] * d, a)
    b_c = np.where((t1 < 1)[:, None], a + t1[:, None] * d, b)
    return a_c, b_c, keep


def dda_traverse(a: np.ndarray, b: np.ndarray, G,
                 chunk_elems: int = 1 << 22) -> tuple:
    """Amanatides-Woo traversal of in-grid segments, vectorized over edges.

    a, b: [E,2] grid coords already clipped into [0, G]^2. Returns
    (edge_of_cell [T], cells [T,2] int64) — the start cell of every edge
    plus one cell per grid-line crossing, in traversal order.
    """
    E = len(a)
    if E == 0:
        return np.zeros(0, np.int64), np.zeros((0, 2), np.int64)
    Gi = np.broadcast_to(np.asarray(G, np.int64), (E,))
    hi = (Gi - 1)[:, None]
    ca = np.clip(np.floor(a).astype(np.int64), 0, hi)        # [E,2]
    cb = np.clip(np.floor(b).astype(np.int64), 0, hi)
    sx = np.sign(cb[:, 0] - ca[:, 0]).astype(np.int64)
    sy = np.sign(cb[:, 1] - ca[:, 1]).astype(np.int64)
    nx = np.abs(cb[:, 0] - ca[:, 0])                         # [E]
    ny = np.abs(cb[:, 1] - ca[:, 1])

    eids = [np.arange(E)]
    cxs = [ca[:, 0]]
    cys = [ca[:, 1]]
    work = np.nonzero(nx + ny > 0)[0]
    for sub in size_buckets(nx[work] + ny[work], chunk_elems):
        e = work[sub]
        Kx = int(nx[e].max())
        Ky = int(ny[e].max())
        dx = b[e, 0] - a[e, 0]
        dy = b[e, 1] - a[e, 1]

        # t-parameters of successive x-line crossings, in traversal order.
        kx = np.arange(1, Kx + 1)[None, :]                   # [1,Kx]
        xlines = ca[e, 0][:, None] + np.where(sx[e, None] >= 0, kx, -kx) \
            + np.where(sx[e, None] >= 0, 0, 1)               # crossing coordinate
        with np.errstate(divide="ignore", invalid="ignore"):
            tx = (xlines - a[e, 0][:, None]) \
                / np.where(dx[:, None] == 0, 1.0, dx[:, None])
        tx = np.where(kx <= nx[e, None], tx, np.inf)

        ky = np.arange(1, Ky + 1)[None, :]
        ylines = ca[e, 1][:, None] + np.where(sy[e, None] >= 0, ky, -ky) \
            + np.where(sy[e, None] >= 0, 0, 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ty = (ylines - a[e, 1][:, None]) \
                / np.where(dy[:, None] == 0, 1.0, dy[:, None])
        ty = np.where(ky <= ny[e, None], ty, np.inf)

        # Merge crossings by t; steps in x get label 0, steps in y label 1.
        t_all = np.concatenate([tx, ty], axis=1)             # [e, Kx+Ky]
        step_is_y = np.concatenate(
            [np.zeros_like(tx, dtype=bool), np.ones_like(ty, dtype=bool)],
            axis=1)
        order = np.argsort(t_all, axis=1, kind="stable")
        t_sorted = np.take_along_axis(t_all, order, axis=1)
        isy = np.take_along_axis(step_is_y, order, axis=1)
        valid = np.isfinite(t_sorted)

        stepx = np.where(valid & ~isy, sx[e, None], 0)
        stepy = np.where(valid & isy, sy[e, None], 0)
        cx = ca[e, 0][:, None] + np.cumsum(stepx, axis=1)    # cells after steps
        cy = ca[e, 1][:, None] + np.cumsum(stepy, axis=1)
        erep = np.broadcast_to(e[:, None], valid.shape)[valid]
        eids.append(erep)
        cxs.append(np.clip(cx[valid], 0, Gi[erep] - 1))
        cys.append(np.clip(cy[valid], 0, Gi[erep] - 1))
    eid = np.concatenate(eids)
    cells = np.stack([np.concatenate(cxs), np.concatenate(cys)], axis=1)
    return eid, cells.astype(np.int64)


def dda_partial_cells(
    verts: np.ndarray, n: int, n_order: int, extent: Extent = GLOBAL_EXTENT,
    closed: bool = True,
) -> np.ndarray:
    """All boundary (Partial) cells of one polygon, vectorized over edges.

    Returns unique cell coordinates [K, 2] int64 (cx, cy), sorted lexico-
    graphically. ``closed=False`` treats the vertices as an open chain
    (linestrings §4.3.3). Edges are clipped to the extent before traversal
    (dropped when fully outside — NOT clamped into the border row/column),
    so geometry crossing the raster-area boundary yields exactly the cells
    its in-extent boundary touches.
    """
    v = np.asarray(verts, np.float64)[: int(n)]
    G = 1 << n_order
    if closed:
        a = _grid_coords(v, n_order, extent)                 # [E,2]
        b = np.roll(a, -1, axis=0)
    else:
        g = _grid_coords(v, n_order, extent)
        a, b = g[:-1], g[1:]
    a_c, b_c, keep = clip_segments_to_grid(a, b, float(G))
    _, cells = dda_traverse(a_c[keep], b_c[keep], G)
    if len(cells) == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return np.unique(cells, axis=0)


def dda_partial_cells_multi(
    verts: np.ndarray, nverts: np.ndarray, n_order: int,
    extent: Extent = GLOBAL_EXTENT, closed: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Partial cells of MANY closed rings, or with ``closed=False`` of many
    open chains (linestrings, §4.3.3: edge i runs vertex i -> i + 1 for
    i < nverts - 1, and no edge joins the last vertex to the first), in one
    traversal.

    verts: padded [P,V,2]; nverts: [P]. Returns CSR ``(off [P+1],
    cells [T,2])`` with each object's unique cells sorted by (cx, cy).
    Edges are clipped to the extent before traversal (dropped when fully
    outside, not clamped into the border row/column).
    """
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P, V, _ = verts.shape
    G = 1 << n_order
    g = _grid_coords(verts.reshape(-1, 2), n_order, extent).reshape(P, V, 2)
    idx = np.arange(V)[None, :]
    if closed:
        edge_valid = idx < nverts[:, None]
        nxt = np.where(edge_valid,
                       (idx + 1) % np.maximum(nverts[:, None], 1), 0)
    else:
        edge_valid = idx < nverts[:, None] - 1
        nxt = np.where(edge_valid, np.minimum(idx + 1, V - 1), 0)
    pe, ve = np.nonzero(edge_valid)
    a = g[pe, ve]
    b = g[pe, nxt[pe, ve]]
    a_c, b_c, keep = clip_segments_to_grid(a, b, float(G))
    pe = pe[keep]
    eid, cells = dda_traverse(a_c[keep], b_c[keep], G)
    if len(cells) == 0:
        return np.zeros(P + 1, np.int64), np.zeros((0, 2), np.int64)
    pid = pe[eid]
    G2 = np.uint64(G) * np.uint64(G)
    key = (pid.astype(np.uint64) * G2
           + cells[:, 0].astype(np.uint64) * np.uint64(G)
           + cells[:, 1].astype(np.uint64))
    uk = np.unique(key)
    pid_u = (uk // G2).astype(np.int64)
    rem = uk % G2
    out = np.stack([(rem // np.uint64(G)).astype(np.int64),
                    (rem % np.uint64(G)).astype(np.int64)], axis=1)
    off = np.zeros(P + 1, np.int64)
    off[1:] = np.cumsum(np.bincount(pid_u, minlength=P))
    return off, out


def _all_grid_cells(n_order: int) -> np.ndarray:
    """Every cell of the grid, sorted by (cx, cy): the Full set of a
    polygon that covers the whole extent without touching it."""
    G = 1 << n_order
    xs = np.arange(G)
    CX, CY = np.meshgrid(xs, xs, indexing="ij")
    return np.stack([CX.ravel(), CY.ravel()], axis=1).astype(np.int64)


def _grid_covered(verts: np.ndarray, n_order: int, extent: Extent) -> bool:
    """With no Partial cells the grid is entirely inside or entirely outside
    the polygon; one PiP at the (0,0) cell center decides (§5.2 partitions
    fully covered by a large polygon)."""
    v = np.asarray(verts, np.float64)
    if len(v) < 3:
        return False
    c = cell_centers(np.array([0]), np.array([0]), n_order, extent)
    return bool(geometry.points_in_polygon(c, v)[0])


def _window(verts: np.ndarray, n_order: int, extent: Extent) -> tuple:
    """MBR window clipped into the grid: (x_lo, y_lo, x_hi, y_hi) cells.
    For in-extent polygons this equals the Partial-cell bounding box; for
    geometry crossing the extent it covers the whole in-grid part (whose
    Full cells may lie outside the Partial bbox)."""
    v = np.asarray(verts, np.float64)
    lo = cells_of_points(v.min(axis=0)[None, :], n_order, extent)[0]
    hi = cells_of_points(v.max(axis=0)[None, :], n_order, extent)[0]
    return int(lo[0]), int(lo[1]), int(hi[0]), int(hi[1])


def scanline_full_cells(
    verts: np.ndarray, n: int, partial: np.ndarray,
    n_order: int, extent: Extent = GLOBAL_EXTENT,
) -> np.ndarray:
    """Full cells via per-row parity fill at cell-center height (§6.1).

    ``partial``: [K,2] boundary cells from :func:`dda_partial_cells`.
    Returns [F,2] int64 Full cells. Vectorized over (rows x edges).
    """
    v = np.asarray(verts, np.float64)[: int(n)]
    if len(partial) == 0:
        if _grid_covered(v, n_order, extent):
            return _all_grid_cells(n_order)
        return np.zeros((0, 2), dtype=np.int64)
    h = extent.cell_size(n_order)
    x_lo, y_lo, x_hi, y_hi = _window(v, n_order, extent)
    rows = np.arange(y_lo, y_hi + 1)
    ycent = extent.y0 + (rows + 0.5) * h                     # [R]

    x0, y0 = v[:, 0][None, :], v[:, 1][None, :]              # [1,E]
    x1 = np.roll(v[:, 0], -1)[None, :]
    y1 = np.roll(v[:, 1], -1)[None, :]
    yc = ycent[:, None]                                       # [R,1]
    cond = (y0 <= yc) != (y1 <= yc)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (yc - y0) / np.where(y1 == y0, 1.0, y1 - y0)
    xint = np.where(cond, x0 + t * (x1 - x0), np.inf)        # [R,E]
    xint_sorted = np.sort(xint, axis=1)

    # Parity of crossings left of each cell center => inside/outside.
    cols = np.arange(x_lo, x_hi + 1)
    xcent = extent.x0 + (cols + 0.5) * h                     # [C]
    # counts[r, c] = # crossings with xint < xcent[c]  (broadcast [R,C,E])
    counts = np.sum(xint_sorted[:, None, :] < xcent[None, :, None], axis=2)
    inside = (counts % 2) == 1                               # [R,C]

    pmask = np.zeros((y_hi - y_lo + 1, x_hi - x_lo + 1), dtype=bool)
    pmask[partial[:, 1] - y_lo, partial[:, 0] - x_lo] = True
    fullmask = inside & ~pmask
    ry, cx = np.nonzero(fullmask)
    return np.stack([cx + x_lo, ry + y_lo], axis=1).astype(np.int64)


def floodfill_classify(
    verts: np.ndarray, n: int, partial: np.ndarray,
    n_order: int, extent: Extent = GLOBAL_EXTENT,
) -> np.ndarray:
    """Flood-fill Full-cell detection (§6.1, host BFS; oracle/benchmark path).

    Iterates the MBR window; each unlabeled region costs ONE PiP test, then a
    BFS labels the region Full or Empty, stopping at Partial cells.
    """
    v = np.asarray(verts, np.float64)[: int(n)]
    if len(partial) == 0:
        if _grid_covered(v, n_order, extent):
            return _all_grid_cells(n_order)
        return np.zeros((0, 2), dtype=np.int64)
    x_lo, y_lo, x_hi, y_hi = _window(v, n_order, extent)
    H, W = y_hi - y_lo + 1, x_hi - x_lo + 1
    # 0 unknown, 1 partial, 2 full, 3 empty
    lab = np.zeros((H, W), dtype=np.int8)
    lab[partial[:, 1] - y_lo, partial[:, 0] - x_lo] = 1

    def pip(cx, cy) -> bool:
        c = cell_centers(np.array([cx]), np.array([cy]), n_order, extent)
        return bool(geometry.points_in_polygon(c, v)[0])

    for yy in range(H):
        for xx in range(W):
            if lab[yy, xx] != 0:
                continue
            mark = 2 if pip(xx + x_lo, yy + y_lo) else 3
            q = deque([(yy, xx)])
            lab[yy, xx] = mark
            while q:
                cy_, cx_ = q.popleft()
                for ny_, nx_ in ((cy_ + 1, cx_), (cy_ - 1, cx_), (cy_, cx_ + 1), (cy_, cx_ - 1)):
                    if 0 <= ny_ < H and 0 <= nx_ < W and lab[ny_, nx_] == 0:
                        lab[ny_, nx_] = mark
                        q.append((ny_, nx_))
    ry, cx = np.nonzero(lab == 2)
    return np.stack([cx + x_lo, ry + y_lo], axis=1).astype(np.int64)


def coverage_fractions(
    verts: np.ndarray, n: int, cells: np.ndarray,
    n_order: int, extent: Extent = GLOBAL_EXTENT,
) -> np.ndarray:
    """Exact coverage fraction of each cell by the polygon (RA/RI labeling).

    cells: [K,2]. Returns [K] float64 in [0,1]. Host-side, per-cell clipping —
    deliberately the expensive path the paper attributes to RA/RI.
    """
    v = np.asarray(verts, np.float64)[: int(n)]
    h = extent.cell_size(n_order)
    out = np.zeros(len(cells), dtype=np.float64)
    cell_area = h * h
    for i, (cx, cy) in enumerate(np.asarray(cells, np.int64)):
        box = (extent.x0 + cx * h, extent.y0 + cy * h,
               extent.x0 + (cx + 1) * h, extent.y0 + (cy + 1) * h)
        clipped = geometry.clip_polygon_to_box(v, box)
        if len(clipped) >= 3:
            out[i] = geometry.polygon_area(clipped) / cell_area
    return np.clip(out, 0.0, 1.0)


def coverage_fractions_multi(
    verts: np.ndarray, nverts: np.ndarray, poly_of_cell: np.ndarray,
    cells: np.ndarray, n_order: int, extent: Extent = GLOBAL_EXTENT,
    backend: str = "numpy", device=None,
) -> np.ndarray:
    """Exact coverage fraction of each (cell, own-polygon) row, in [0, 1],
    by one padded Sutherland–Hodgman pass; row-identical to
    :func:`coverage_fractions` over the same polygon.

    verts [P,V,2] padded, nverts [P]; poly_of_cell [K]; cells [K,2].
    ``backend``: ``"numpy"`` (host) or ``"torch"`` (the clip pass on
    ``device``).
    """
    cells = np.asarray(cells, np.int64)
    h = extent.cell_size(n_order)
    boxes = np.stack([
        extent.x0 + cells[:, 0] * h, extent.y0 + cells[:, 1] * h,
        extent.x0 + (cells[:, 0] + 1) * h, extent.y0 + (cells[:, 1] + 1) * h,
    ], axis=1)
    areas = geometry.box_clip_areas_rows(verts, nverts, poly_of_cell, boxes,
                                         backend=backend, device=device)
    return np.clip(areas / (h * h), 0.0, 1.0)


def scanline_full_cells_multi(
    verts: np.ndarray, nverts: np.ndarray,
    p_off: np.ndarray, p_cells: np.ndarray,
    n_order: int, extent: Extent = GLOBAL_EXTENT,
    chunk_elems: int = 1 << 22,
) -> tuple[np.ndarray, np.ndarray]:
    """Full cells of MANY polygons: parity fill at cell-center height over
    flat (polygon-row x edge) pairs, bucketed by (vertex, column) count
    classes.

    ``p_off``/``p_cells``: Partial-cell CSR from
    :func:`dda_partial_cells_multi`. Returns CSR ``(off [P+1], cells [T,2])``
    sorted by (cx, cy) per polygon.
    """
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P = len(nverts)
    G = 1 << n_order
    h = extent.cell_size(n_order)
    G2 = np.uint64(G) * np.uint64(G)
    n_partial = np.diff(p_off)
    pkeys = (np.repeat(np.arange(P), n_partial).astype(np.uint64) * G2
             + p_cells[:, 0].astype(np.uint64) * np.uint64(G)
             + p_cells[:, 1].astype(np.uint64))    # sorted by CSR convention

    out_pid = []
    out_cx = []
    out_cy = []

    # polygons whose boundary misses the grid entirely: covered or empty
    no_part = np.nonzero((n_partial == 0) & (nverts >= 3))[0]
    if len(no_part):
        centers = cell_centers(np.zeros(len(no_part)), np.zeros(len(no_part)),
                               n_order, extent)
        inside = geometry.points_in_polygon_rows(centers, no_part, verts,
                                                 nverts)
        if inside.any():
            allc = _all_grid_cells(n_order)
            for p in no_part[inside]:
                out_pid.append(np.full(len(allc), p, np.int64))
                out_cx.append(allc[:, 0])
                out_cy.append(allc[:, 1])

    # windows (clipped MBR) of the polygons that do have partial cells
    mbrs = geometry.polygon_mbrs(verts, nverts)
    has = np.nonzero(n_partial > 0)[0]
    if len(has):
        lo = cells_of_points(mbrs[has, :2], n_order, extent)
        hi = cells_of_points(mbrs[has, 2:], n_order, extent)
        wx0, wy0 = lo[:, 0], lo[:, 1]
        ncols = hi[:, 0] - lo[:, 0] + 1
        nrows = hi[:, 1] - lo[:, 1] + 1
        starts, ends, emask = geometry.polygon_edges(verts, nverts)

        # flat rows: (polygon, grid row) pairs
        row_poly = np.repeat(has, nrows)                       # [Rtot]
        roff = np.concatenate([[0], np.cumsum(nrows)])
        row_y = (np.arange(roff[-1]) - np.repeat(roff[:-1], nrows)
                 + np.repeat(wy0, nrows))
        row_ncols = np.repeat(ncols, nrows)
        row_wx0 = np.repeat(wx0, nrows)
        nv_row = nverts[row_poly]

        # bucket rows by (vertex class, column class), chunk by working set
        clsv = np.ceil(np.log2(np.maximum(nv_row, 1).astype(np.float64)))
        clsc = np.ceil(np.log2(np.maximum(row_ncols, 1).astype(np.float64)))
        bkey = (clsv * 64 + clsc).astype(np.int64)
        for kb in np.unique(bkey):
            sel_all = np.nonzero(bkey == kb)[0]
            Vb = int(nv_row[sel_all].max())
            Cb = int(row_ncols[sel_all].max())
            step = max(1, int(chunk_elems // max(1, Vb * Cb)))
            for i0 in range(0, len(sel_all), step):
                sel = sel_all[i0: i0 + step]
                p = row_poly[sel]
                yc = (extent.y0 + (row_y[sel] + 0.5) * h)[:, None]   # [m,1]
                x0e, y0e = starts[p, :Vb, 0], starts[p, :Vb, 1]
                x1e, y1e = ends[p, :Vb, 0], ends[p, :Vb, 1]
                cond = ((y0e <= yc) != (y1e <= yc)) & emask[p, :Vb]
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = (yc - y0e) / np.where(y1e == y0e, 1.0, y1e - y0e)
                xint = np.where(cond, x0e + t * (x1e - x0e), np.inf)  # [m,Vb]
                cols = np.arange(Cb)[None, :]
                xcent = extent.x0 + (row_wx0[sel][:, None] + cols + 0.5) * h
                counts = np.sum(xint[:, None, :] < xcent[:, :, None], axis=2)
                inside = ((counts % 2) == 1) \
                    & (cols < row_ncols[sel][:, None])                # [m,Cb]
                m_idx, c_idx = np.nonzero(inside)
                pid = p[m_idx]
                cx = row_wx0[sel][m_idx] + c_idx
                cy = row_y[sel][m_idx]
                key = (pid.astype(np.uint64) * G2
                       + cx.astype(np.uint64) * np.uint64(G)
                       + cy.astype(np.uint64))
                # drop Partial cells: in-polygon but boundary-crossed
                j = np.searchsorted(pkeys, key)
                is_part = (j < len(pkeys)) & (pkeys[np.minimum(
                    j, max(len(pkeys) - 1, 0))] == key)
                keep = ~is_part
                out_pid.append(pid[keep])
                out_cx.append(cx[keep])
                out_cy.append(cy[keep])

    if not out_pid:
        return np.zeros(P + 1, np.int64), np.zeros((0, 2), np.int64)
    pid = np.concatenate(out_pid)
    cx = np.concatenate(out_cx)
    cy = np.concatenate(out_cy)
    key = (pid.astype(np.uint64) * G2 + cx.astype(np.uint64) * np.uint64(G)
           + cy.astype(np.uint64))
    order = np.argsort(key)
    pid = pid[order]
    cells = np.stack([cx[order], cy[order]], axis=1).astype(np.int64)
    off = np.zeros(P + 1, np.int64)
    off[1:] = np.cumsum(np.bincount(pid, minlength=P))
    return off, cells


def classify_window_oracle(
    verts: np.ndarray, n: int, n_order: int, extent: Extent = GLOBAL_EXTENT,
) -> dict[str, np.ndarray]:
    """Brute-force oracle: classify every MBR-window cell as partial/full.

    partial := boundary crosses the cell (any edge intersects the cell box or
    a polygon vertex lies inside it); full := not partial and center inside.
    Returns {'partial': [Kp,2], 'full': [Kf,2]} int64 cell coords.
    """
    v = np.asarray(verts, np.float64)[: int(n)]
    G = 1 << n_order
    h = extent.cell_size(n_order)
    mbr_lo = cells_of_points(v.min(axis=0)[None, :], n_order, extent)[0]
    mbr_hi = cells_of_points(v.max(axis=0)[None, :], n_order, extent)[0]
    xs = np.arange(mbr_lo[0], mbr_hi[0] + 1)
    ys = np.arange(mbr_lo[1], mbr_hi[1] + 1)
    CX, CY = np.meshgrid(xs, ys, indexing="ij")
    cx, cy = CX.ravel(), CY.ravel()
    # cell boxes
    bx0 = extent.x0 + cx * h; by0 = extent.y0 + cy * h
    bx1 = bx0 + h; by1 = by0 + h
    # vertex-in-cell
    vin = np.zeros(len(cx), dtype=bool)
    for p in v:
        vin |= (bx0 <= p[0]) & (p[0] < bx1) & (by0 <= p[1]) & (p[1] < by1)
    # edge-box intersection: any of the 4 box sides intersects the edge, or
    # edge endpoint inside box (covered by vin since endpoints are vertices).
    a0 = v; a1 = np.roll(v, -1, axis=0)
    partial = vin.copy()
    corners = np.stack([
        np.stack([bx0, by0], axis=1), np.stack([bx1, by0], axis=1),
        np.stack([bx1, by1], axis=1), np.stack([bx0, by1], axis=1),
    ], axis=1)  # [K,4,2]
    sides = np.stack([
        np.stack([corners[:, 0], corners[:, 1]], axis=1),
        np.stack([corners[:, 1], corners[:, 2]], axis=1),
        np.stack([corners[:, 2], corners[:, 3]], axis=1),
        np.stack([corners[:, 3], corners[:, 0]], axis=1),
    ], axis=1)  # [K,4,2,2]
    for e in range(len(v)):
        hit = geometry.segments_intersect(
            a0[e][None, None, :], a1[e][None, None, :],
            sides[:, :, 0, :], sides[:, :, 1, :])
        partial |= hit.any(axis=1)
    centers = cell_centers(cx, cy, n_order, extent)
    inside = geometry.points_in_polygon(centers, v)
    full = inside & ~partial
    sel_p = np.stack([cx[partial], cy[partial]], axis=1).astype(np.int64)
    sel_f = np.stack([cx[full], cy[full]], axis=1).astype(np.int64)
    return {"partial": sel_p, "full": sel_f}


def cells_to_hilbert(cells: np.ndarray, n_order: int) -> np.ndarray:
    """Sorted unique Hilbert ids (uint64) of cell coords [K,2]."""
    if len(cells) == 0:
        return np.zeros((0,), dtype=np.uint64)
    d = xy2d(n_order, cells[:, 0], cells[:, 1])
    return np.unique(d)
