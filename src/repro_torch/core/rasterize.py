"""Polygon rasterization onto the global 2^N x 2^N grid (host, numpy).

The multi-polygon Amanatides-Woo traversal that one-step intervalization
needs: every cell crossed by a polygon boundary (the Partial cells) of a
whole dataset in one vectorized pass. A raster ``extent`` is the square
(x0, y0, side) covered by the grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import geometry

__all__ = [
    "Extent", "GLOBAL_EXTENT", "cell_centers", "clip_segments_to_grid",
    "dda_traverse", "dda_partial_cells_multi", "size_buckets",
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


def dda_partial_cells_multi(
    verts: np.ndarray, nverts: np.ndarray, n_order: int,
    extent: Extent = GLOBAL_EXTENT,
) -> tuple[np.ndarray, np.ndarray]:
    """Partial cells of MANY closed rings in one traversal.

    verts: padded [P,V,2]; nverts: [P]. Returns CSR ``(off [P+1],
    cells [T,2])`` with each polygon's unique cells sorted by (cx, cy).
    Edges are clipped to the extent before traversal (dropped when fully
    outside, not clamped into the border row/column).
    """
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P, V, _ = verts.shape
    G = 1 << n_order
    g = _grid_coords(verts.reshape(-1, 2), n_order, extent).reshape(P, V, 2)
    idx = np.arange(V)[None, :]
    edge_valid = idx < nverts[:, None]
    nxt = np.where(edge_valid, (idx + 1) % np.maximum(nverts[:, None], 1), 0)
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
