"""RA — the raster approximation of Zimbrao & de Souza (paper §2).

Per-object grid over the MBR with at most K cells; cell side quantized to
``omega * 2^k`` with coordinates at multiples of the side, so any two RA
grids are hierarchically aligned and differ by a power-of-two scale. Cells
carry one of four classes: Empty / Weak (<=50%) / Strong (>50%) / Full,
assigned from exact coverage fractions. Pair filtering re-scales the finer
grid (2x2 combination) onto the coarser one and applies Table 1.

Combination caveat (faithful to the information RA stores): classes, not
fractions, are stored, so a combined 2x2 class uses coverage lower bounds;
Full (resp. Empty) requires all four children Full (resp. Empty). With
that, Table 1 verdicts stay conservative and the filter never contradicts
the geometry. Construction: ``numpy`` clips every (object x window-cell)
row on the host, ``torch`` runs that clip on a device, ``sequential`` is
the per-object reference loop; the line builds rasterize on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import geometry, rasterize
from ..core.geometry import build_device
from ..core.join import INDECISIVE, TRUE_HIT, TRUE_NEG
from ..core.rasterize import Extent, clip_segments_to_grid, dda_traverse

__all__ = ["RAStore", "build_ra", "build_ra_lines", "ra_verdict_pair",
           "ra_filter_batch", "ra_within_verdict_pair", "ra_within_batch"]

EMPTY, WEAK, STRONG, FULL = 0, 1, 2, 3
_MID = np.array([0.0, 0.25, 0.75, 1.0])

# Table 1: does a shared cell certify intersection? yes=1 / no=-1 / maybe=0
_TABLE = np.zeros((4, 4), np.int8)
_TABLE[EMPTY, :] = -1; _TABLE[:, EMPTY] = -1
_TABLE[FULL, WEAK:] = 1; _TABLE[WEAK:, FULL] = 1
_TABLE[STRONG, STRONG] = 1
_TABLE[WEAK, WEAK] = 0; _TABLE[WEAK, STRONG] = 0; _TABLE[STRONG, WEAK] = 0


@dataclass
class RAStore:
    omega: float                 # unit cell side
    k: np.ndarray                # [P] scale exponent: cell side = omega * 2^k
    origin: np.ndarray           # [P,2] grid origin (multiple of side)
    shape: np.ndarray            # [P,2] (nx, ny) cells
    cells: list[np.ndarray]      # per object: [ny, nx] int8 class grid

    def __len__(self):
        return len(self.cells)

    def size_bytes(self) -> int:
        # 2 bits/cell packed (4 classes) + per-object header
        return sum((c.size + 3) // 4 for c in self.cells) + 24 * len(self.cells)


def _fit_grid(mbr, max_cells: int, omega: float):
    """Smallest aligned grid scale with cell count <= max_cells:
    (k, side, ox, oy, nx, ny)."""
    k = 0
    while True:
        side = omega * (1 << k)
        nx = int(np.floor(mbr[2] / side)) - int(np.floor(mbr[0] / side)) + 1
        ny = int(np.floor(mbr[3] / side)) - int(np.floor(mbr[1] / side)) + 1
        if nx * ny <= max_cells or side > 1.0:
            break
        k += 1
    ox = np.floor(mbr[0] / side) * side
    oy = np.floor(mbr[1] / side) * side
    return k, side, ox, oy, nx, ny


def _fit_grid_multi(mbrs: np.ndarray, max_cells: int, omega: float):
    """The smallest aligned grid scale of every object with at most
    ``max_cells`` cells: escalate the scale of the not-yet-fitting subset.
    Returns (k [P], side [P], ox [P], oy [P], nx [P], ny [P])."""
    mbrs = np.asarray(mbrs, np.float64)
    P = len(mbrs)
    k = np.zeros(P, np.int64)
    nx = np.zeros(P, np.int64)
    ny = np.zeros(P, np.int64)
    todo = np.arange(P)
    while len(todo):
        side = omega * np.exp2(k[todo])
        cnx = (np.floor(mbrs[todo, 2] / side).astype(np.int64)
               - np.floor(mbrs[todo, 0] / side).astype(np.int64) + 1)
        cny = (np.floor(mbrs[todo, 3] / side).astype(np.int64)
               - np.floor(mbrs[todo, 1] / side).astype(np.int64) + 1)
        done = (cnx * cny <= max_cells) | (side > 1.0)
        fin = todo[done]
        nx[fin] = cnx[done]
        ny[fin] = cny[done]
        todo = todo[~done]
        k[todo] += 1
    side = omega * np.exp2(k)
    ox = np.floor(mbrs[:, 0] / side) * side
    oy = np.floor(mbrs[:, 1] / side) * side
    return k, side, ox, oy, nx, ny


def _grids_from_classes(cls_flat, coff, nx, ny):
    return [cls_flat[coff[i]: coff[i + 1]].reshape(ny[i], nx[i])
            for i in range(len(nx))]


def build_ra(dataset, max_cells: int = 750, omega: float = 1.0 / (1 << 16),
             backend: str = "numpy", device=None) -> RAStore:
    """Build the RA store. ``numpy`` and ``torch`` evaluate the coverage
    fractions of ALL (object x window-cell) rows in one padded
    Sutherland–Hodgman pass per object slice (on ``device`` for
    ``torch``); ``sequential`` is the per-object reference loop with
    per-cell clipping."""
    dev = build_device(backend, device)
    P = len(dataset)
    if backend == "sequential":
        ks = np.zeros(P, np.int64)
        origins = np.zeros((P, 2))
        shapes = np.zeros((P, 2), np.int64)
        grids: list[np.ndarray] = []
        for i in range(P):
            v = dataset.polygon(i)
            k, side, ox, oy, nx, ny = _fit_grid(dataset.mbrs[i], max_cells,
                                                omega)
            # coverage fractions for all cells in the window
            cxs = np.arange(nx); cys = np.arange(ny)
            CX, CY = np.meshgrid(cxs, cys, indexing="xy")
            cells = np.stack([CX.ravel(), CY.ravel()], axis=1)
            ext = Extent(ox, oy, side)  # one-cell extent trick: order 0/cell
            frac = rasterize.coverage_fractions(v, len(v), cells, 0, ext)
            grid = np.full(nx * ny, EMPTY, np.int8)
            grid[(frac > 0) & (frac <= 0.5)] = WEAK
            grid[(frac > 0.5) & (frac < 1.0 - 1e-12)] = STRONG
            grid[frac >= 1.0 - 1e-12] = FULL
            ks[i] = k
            origins[i] = (ox, oy)
            shapes[i] = (nx, ny)
            grids.append(grid.reshape(ny, nx))
        return RAStore(omega=omega, k=ks, origin=origins, shape=shapes,
                       cells=grids)

    stage = geometry.BUILD_STAGES.stage
    with stage("fit"):
        k, side, ox, oy, nx, ny = _fit_grid_multi(dataset.mbrs, max_cells,
                                                  omega)
    ncell = nx * ny
    coff = np.concatenate([[0], np.cumsum(ncell)])
    cls = np.full(coff[-1], EMPTY, np.int8)
    # object slices bound the flat (object x window-cell) transients — the
    # per-object memory profile stays O(chunk), not O(dataset)
    cells_per_chunk = 1 << 22
    p0 = 0
    while p0 < P:
        with stage("pack"):
            p1 = int(np.searchsorted(coff, coff[p0] + cells_per_chunk,
                                     "right"))
            p1 = max(p1 - 1, p0 + 1)
            pid = np.repeat(np.arange(p0, p1), ncell[p0:p1])
            t = (np.arange(coff[p1] - coff[p0])
                 - (coff[p0:p1] - coff[p0])[pid - p0])
            cx = t % nx[pid]
            cy = t // nx[pid]
            sp = side[pid]
            boxes = np.stack([ox[pid] + cx * sp, oy[pid] + cy * sp,
                              ox[pid] + (cx + 1) * sp,
                              oy[pid] + (cy + 1) * sp], axis=1)
        with stage("clip"):
            areas = geometry.box_clip_areas_rows(
                dataset.verts, dataset.nverts, pid, boxes, backend=backend,
                device=dev)
        with stage("pack"):
            frac = np.clip(areas / (sp * sp), 0.0, 1.0)
            seg = cls[coff[p0]: coff[p1]]
            seg[(frac > 0) & (frac <= 0.5)] = WEAK
            seg[(frac > 0.5) & (frac < 1.0 - 1e-12)] = STRONG
            seg[frac >= 1.0 - 1e-12] = FULL
        p0 = p1
    with stage("pack"):
        return RAStore(omega=omega, k=k, origin=np.stack([ox, oy], axis=1),
                       shape=np.stack([nx, ny], axis=1),
                       cells=_grids_from_classes(cls, coff, nx, ny))


def build_ra_lines(dataset, max_cells: int = 750,
                   omega: float = 1.0 / (1 << 16),
                   backend: str = "numpy", device=None) -> RAStore:
    """RA store for open linestrings: the cells a chain crosses are Weak (a
    line has no area, so never Strong or Full), the rest Empty; Table 1
    still applies (Weak x Full certifies a hit, Weak x Weak or Strong stays
    INDECISIVE). One clipped traversal over every chain's edges, each in
    its own object's grid frame (the grid bound G = 2^n of the power-of-two
    grid that covers the object's window), for ``numpy`` and ``torch``
    (no device pass: a chain has no coverage to clip); ``sequential``
    rasterizes chain by chain."""
    build_device(backend, device)
    P = len(dataset)
    if backend == "sequential":
        ks = np.zeros(P, np.int64)
        origins = np.zeros((P, 2))
        shapes = np.zeros((P, 2), np.int64)
        grids: list[np.ndarray] = []
        for i in range(P):
            v = dataset.polygon(i)
            k, side, ox, oy, nx, ny = _fit_grid(dataset.mbrs[i], max_cells,
                                                omega)
            # rasterize the chain on a power-of-two grid covering the window
            n_ord = max(1, int(np.ceil(np.log2(max(nx, ny)))))
            ext = Extent(ox, oy, side * (1 << n_ord))
            cells = rasterize.dda_partial_cells(v, len(v), n_ord, ext,
                                                closed=False)
            grid = np.full((ny, nx), EMPTY, np.int8)
            if len(cells):
                keep = (cells[:, 0] < nx) & (cells[:, 1] < ny)
                grid[cells[keep, 1], cells[keep, 0]] = WEAK
            ks[i] = k
            origins[i] = (ox, oy)
            shapes[i] = (nx, ny)
            grids.append(grid)
        return RAStore(omega=omega, k=ks, origin=origins, shape=shapes,
                       cells=grids)

    k, side, ox, oy, nx, ny = _fit_grid_multi(dataset.mbrs, max_cells, omega)
    n_ord = np.maximum(
        1, np.ceil(np.log2(np.maximum(nx, ny).astype(np.float64)))
    ).astype(np.int64)
    G = np.int64(1) << n_ord
    # the cell size of Extent(ox, oy, side * G) at order n_ord, as the
    # per-object rasterization computes it
    h = (side * G) / G
    verts = np.asarray(dataset.verts, np.float64)
    nverts = np.asarray(dataset.nverts, np.int64)
    V = verts.shape[1]
    edge_valid = np.arange(V)[None, :] < nverts[:, None] - 1
    pe, ve = np.nonzero(edge_valid)
    org = np.stack([ox, oy], axis=1)
    a = (verts[pe, ve] - org[pe]) / h[pe, None]
    b = (verts[pe, np.minimum(ve + 1, V - 1)] - org[pe]) / h[pe, None]
    a_c, b_c, keep = clip_segments_to_grid(a, b, G[pe].astype(np.float64))
    pe = pe[keep]
    eid, cells = dda_traverse(a_c[keep], b_c[keep], G[pe])
    pid = pe[eid]
    coff = np.concatenate([[0], np.cumsum(nx * ny)])
    cls = np.full(coff[-1], EMPTY, np.int8)
    inb = (cells[:, 0] < nx[pid]) & (cells[:, 1] < ny[pid])
    cls[coff[:-1][pid[inb]] + cells[inb, 1] * nx[pid[inb]]
        + cells[inb, 0]] = WEAK
    return RAStore(omega=omega, k=k, origin=org,
                   shape=np.stack([nx, ny], axis=1),
                   cells=_grids_from_classes(cls, coff, nx, ny))


def _upscale_to(store: RAStore, i: int, k_to: int):
    """Combine 2x2 blocks until object i's grid reaches scale k_to.
    Returns (origin, grid) at scale k_to with sound class combination."""
    grid = store.cells[i]
    k = int(store.k[i])
    ox, oy = store.origin[i]
    side = store.omega * (1 << k)
    while k < k_to:
        ny, nx = grid.shape
        # align origin to the parent grid
        gx = int(np.floor(round(ox / side)))  # integer cell coords at scale k
        gy = int(np.floor(round(oy / side)))
        pad_l = gx & 1
        pad_b = gy & 1
        pad_r = (nx + pad_l) & 1
        pad_t = (ny + pad_b) & 1
        g = np.pad(grid, ((pad_b, pad_t), (pad_l, pad_r)), constant_values=EMPTY)
        # coverage LOWER bounds per class keep the combination sound: a
        # parent may be labeled STRONG only when its true coverage provably
        # exceeds 50% (Table 1's strong-strong => hit rule demands it).
        lo_tab = np.array([0.0, 0.0, 0.5, 1.0])   # EMPTY WEAK STRONG FULL
        lo = (lo_tab[g[0::2, 0::2]] + lo_tab[g[1::2, 0::2]]
              + lo_tab[g[0::2, 1::2]] + lo_tab[g[1::2, 1::2]]) / 4.0
        allfull = ((g[0::2, 0::2] == FULL) & (g[1::2, 0::2] == FULL)
                   & (g[0::2, 1::2] == FULL) & (g[1::2, 1::2] == FULL))
        allempty = ((g[0::2, 0::2] == EMPTY) & (g[1::2, 0::2] == EMPTY)
                    & (g[0::2, 1::2] == EMPTY) & (g[1::2, 1::2] == EMPTY))
        out = np.where(lo > 0.5, STRONG, WEAK).astype(np.int8)
        out[allfull] = FULL
        out[allempty] = EMPTY
        grid = out
        ox = (gx - pad_l) * side
        oy = (gy - pad_b) * side
        k += 1
        side *= 2
    return (ox, oy), grid


# ---------------------------------------------------------------------------
# Batched RA filtering: per-object pyramids are memoized, the
# per-pair overlay + Table-1 lookup is one padded vectorized gather.
# ---------------------------------------------------------------------------

def _upscaled(store: RAStore, i: int, k: int, cache: dict | None):
    """Memoized :func:`_upscale_to`: (int origin x/y at scale k, flat grid,
    nx, ny)."""
    key = (i, k)
    if cache is not None and key in cache:
        return cache[key]
    (ox, oy), grid = _upscale_to(store, i, k)
    side = store.omega * (1 << k)
    entry = (int(round(ox / side)), int(round(oy / side)),
             np.ascontiguousarray(grid).ravel(), grid.shape[1], grid.shape[0])
    if cache is not None:
        cache[key] = entry
    return entry


def _pair_grids(store_r, store_s, pairs, cache_r, cache_s):
    """Upscale both sides of every pair to the pair's coarser scale and
    return flat-concatenated grids plus per-pair geometry arrays.

    Per-pair work is a vectorized gather over the *unique* (object, scale)
    combinations of the batch — Python touches each combination once (and
    the ``cache`` dict memoizes pyramids across batches and predicates), so
    a T1xT2-scale batch costs O(unique objects), not O(pairs).
    """
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    kk = np.maximum(store_r.k[pairs[:, 0]], store_s.k[pairs[:, 1]]).astype(np.int64)

    def side_arrays(store, idx, cache):
        # composite (object, scale) keys; scales are bounded (cell side
        # stops growing past 1.0, well under 2^32)
        keys = (idx.astype(np.int64) << 32) | kk
        ukeys, inv = np.unique(keys, return_inverse=True)
        ents = [_upscaled(store, int(key >> 32), int(key & 0xFFFFFFFF), cache)
                for key in ukeys]
        lens = np.asarray([len(e[2]) for e in ents], np.int64)
        ubase = np.zeros(len(ents), np.int64)
        np.cumsum(lens[:-1], out=ubase[1:])
        flat_all = (np.concatenate([e[2] for e in ents]) if ents
                    else np.zeros(0, np.int8))
        ux0 = np.asarray([e[0] for e in ents], np.int64)
        uy0 = np.asarray([e[1] for e in ents], np.int64)
        unx = np.asarray([e[3] for e in ents], np.int64)
        uny = np.asarray([e[4] for e in ents], np.int64)
        return (flat_all, ux0[inv], uy0[inv], ubase[inv], unx[inv], uny[inv])

    r = side_arrays(store_r, pairs[:, 0], cache_r)
    s = side_arrays(store_s, pairs[:, 1], cache_s)
    return kk, r, s


def ra_filter_batch(store_r: RAStore, store_s: RAStore, pairs: np.ndarray,
                    cache_r: dict | None = None, cache_s: dict | None = None,
                    chunk_elems: int = 1 << 24) -> np.ndarray:
    """Vectorized RA intersection filter; verdict-identical to
    :func:`ra_verdict_pair` per pair."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8)
    _, (fr, rx0, ry0, rb, rnx, rny), (fs, sx0, sy0, sb, snx, sny) = \
        _pair_grids(store_r, store_s, pairs, cache_r, cache_s)
    x0 = np.maximum(rx0, sx0); y0 = np.maximum(ry0, sy0)
    x1 = np.minimum(rx0 + rnx, sx0 + snx)
    y1 = np.minimum(ry0 + rny, sy0 + sny)
    ww = np.maximum(x1 - x0, 0); wh = np.maximum(y1 - y0, 0)
    out = np.full(N, TRUE_NEG, np.int8)
    live = np.nonzero((ww > 0) & (wh > 0))[0]
    i0 = 0
    while i0 < len(live):
        Hm = int(wh[live[i0:]].max()); Wm = int(ww[live[i0:]].max())
        rows = max(1, int(chunk_elems // max(1, Hm * Wm)))
        sel = live[i0: i0 + rows]
        Hm = int(wh[sel].max()); Wm = int(ww[sel].max())
        yy = np.arange(Hm)[None, :, None]
        xx = np.arange(Wm)[None, None, :]
        valid = (yy < wh[sel, None, None]) & (xx < ww[sel, None, None])

        def gather(flat, bs, gx0, gy0, nx):
            idx = (bs[sel, None, None]
                   + (y0[sel, None, None] - gy0[sel, None, None] + yy) * nx[sel, None, None]
                   + (x0[sel, None, None] - gx0[sel, None, None] + xx))
            return np.where(valid,
                            flat[np.clip(idx, 0, max(len(flat) - 1, 0))], EMPTY)

        cr = gather(fr, rb, rx0, ry0, rnx)
        cs = gather(fs, sb, sx0, sy0, snx)
        t = _TABLE[cr, cs]
        hit = np.any((t == 1) & valid, axis=(1, 2))
        maybe = np.any((t == 0) & valid, axis=(1, 2))
        out[sel] = np.where(hit, TRUE_HIT,
                            np.where(maybe, INDECISIVE, TRUE_NEG))
        i0 += len(sel)
    return out


def ra_within_verdict_pair(store_r: RAStore, i: int, store_s: RAStore,
                           j: int) -> int:
    """RA within filter (r within s?), the per-pair reference.

    Sound rules at the pair's coarser scale k: any non-Empty r cell that is
    Empty in s (or outside s's grid) kills the pair; r Full requires s Full;
    r Strong against s Weak kills only when s is at its native scale (an
    upscaled Weak is not a <=50% upper bound). TRUE_HIT iff every non-Empty
    r cell is Full in s.
    """
    k = max(int(store_r.k[i]), int(store_s.k[j]))
    (oxr, oyr), gr = _upscale_to(store_r, i, k)
    (oxs, oys), gs = _upscale_to(store_s, j, k)
    side = store_r.omega * (1 << k)
    rx0 = int(round(oxr / side)); ry0 = int(round(oyr / side))
    sx0 = int(round(oxs / side)); sy0 = int(round(oys / side))
    s_native = k == int(store_s.k[j])
    all_full = True
    nonempty = False
    for y in range(gr.shape[0]):
        for x in range(gr.shape[1]):
            cr = gr[y, x]
            if cr == EMPTY:
                continue
            nonempty = True
            gx = rx0 + x - sx0
            gy = ry0 + y - sy0
            if gx < 0 or gy < 0 or gx >= gs.shape[1] or gy >= gs.shape[0]:
                return TRUE_NEG
            cs = gs[gy, gx]
            if cs == EMPTY:
                return TRUE_NEG
            if cr == FULL and cs != FULL:
                return TRUE_NEG
            if s_native and cr == STRONG and cs == WEAK:
                return TRUE_NEG
            if cs != FULL:
                all_full = False
    if not nonempty:
        return TRUE_HIT
    return TRUE_HIT if all_full else INDECISIVE


def ra_within_batch(store_r: RAStore, store_s: RAStore, pairs: np.ndarray,
                    cache_r: dict | None = None, cache_s: dict | None = None,
                    chunk_elems: int = 1 << 24) -> np.ndarray:
    """Vectorized RA within filter over pairs [N,2]; verdict-identical to
    :func:`ra_within_verdict_pair` per pair. ``cache_r``/``cache_s``
    memoize the upscale pyramids, as for :func:`ra_filter_batch`."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8)
    kk, (fr, rx0, ry0, rb, rnx, rny), (fs, sx0, sy0, sb, snx, sny) = \
        _pair_grids(store_r, store_s, pairs, cache_r, cache_s)
    s_native = kk == store_s.k[pairs[:, 1]].astype(np.int64)
    out = np.empty(N, np.int8)
    i0 = 0
    order = np.arange(N)
    while i0 < N:
        Hm = int(rny[order[i0:]].max()); Wm = int(rnx[order[i0:]].max())
        rows = max(1, int(chunk_elems // max(1, Hm * Wm)))
        sel = order[i0: i0 + rows]
        Hm = int(rny[sel].max()); Wm = int(rnx[sel].max())
        yy = np.arange(Hm)[None, :, None]
        xx = np.arange(Wm)[None, None, :]
        valid = (yy < rny[sel, None, None]) & (xx < rnx[sel, None, None])
        idx_r = rb[sel, None, None] + yy * rnx[sel, None, None] + xx
        cr = np.where(valid, fr[np.clip(idx_r, 0, max(len(fr) - 1, 0))], EMPTY)
        gx = rx0[sel, None, None] + xx - sx0[sel, None, None]
        gy = ry0[sel, None, None] + yy - sy0[sel, None, None]
        inside = ((gx >= 0) & (gy >= 0) & (gx < snx[sel, None, None])
                  & (gy < sny[sel, None, None]))
        idx_s = sb[sel, None, None] + gy * snx[sel, None, None] + gx
        cs = np.where(valid & inside,
                      fs[np.clip(idx_s, 0, max(len(fs) - 1, 0))], EMPTY)
        ne = valid & (cr != EMPTY)
        neg_cell = ne & ((~inside) | (cs == EMPTY)
                         | ((cr == FULL) & (cs != FULL))
                         | (s_native[sel, None, None]
                            & (cr == STRONG) & (cs == WEAK)))
        notfull = ne & (cs != FULL)
        neg = np.any(neg_cell, axis=(1, 2))
        any_ne = np.any(ne, axis=(1, 2))
        nf = np.any(notfull, axis=(1, 2))
        out[sel] = np.where(neg, TRUE_NEG,
                            np.where(~any_ne | ~nf, TRUE_HIT, INDECISIVE))
        i0 += len(sel)
    return out


def ra_verdict_pair(store_r: RAStore, i: int, store_s: RAStore, j: int) -> int:
    """Re-scale to the coarser grid, overlay, and apply Table 1."""
    k = max(int(store_r.k[i]), int(store_s.k[j]))
    (oxr, oyr), gr = _upscale_to(store_r, i, k)
    (oxs, oys), gs = _upscale_to(store_s, j, k)
    side = store_r.omega * (1 << k)
    # integer cell coordinates of each grid origin (aligned by construction)
    rx0 = int(round(oxr / side)); ry0 = int(round(oyr / side))
    sx0 = int(round(oxs / side)); sy0 = int(round(oys / side))
    x0 = max(rx0, sx0); y0 = max(ry0, sy0)
    x1 = min(rx0 + gr.shape[1], sx0 + gs.shape[1])
    y1 = min(ry0 + gr.shape[0], sy0 + gs.shape[0])
    if x0 >= x1 or y0 >= y1:
        return TRUE_NEG
    sub_r = gr[y0 - ry0: y1 - ry0, x0 - rx0: x1 - rx0]
    sub_s = gs[y0 - sy0: y1 - sy0, x0 - sx0: x1 - sx0]
    t = _TABLE[sub_r, sub_s]
    if bool((t == 1).any()):
        return TRUE_HIT
    if bool((t == 0).any()):
        return INDECISIVE
    return TRUE_NEG
