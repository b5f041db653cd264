"""Exact geometry predicates (host, numpy, float64).

Used for approximation construction (PiP labeling) and as the correctness
oracle of refinement. Polygons are stored padded: ``verts`` has shape
[P, V, 2] and ``nverts`` [P]; vertices at index >= nverts[p] are ignored.
Rings are implicitly closed (edge from vertex nverts-1 back to vertex 0).
Vertex order may be CW or CCW.

Construction has three backends (``BUILD_BACKENDS``): ``numpy`` (the
batched host build), ``torch`` (its two per-cell passes, the gap-head PiP
and the box clip, on a device: the reference's ``jnp``) and
``sequential`` (the per-object reference loop). The device twins
(:func:`points_in_polygon_rows_torch`, :func:`box_clip_areas_torch`) write
every product and sum as separate float64 operations, so they round as
numpy does; the clip's shoelace stays on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import StageClock, resolve_device

__all__ = [
    "BUILD_BACKENDS", "BUILD_STAGES", "check_build_backend", "build_device",
    "size_buckets", "polygon_edges", "polygon_mbrs", "points_in_polygon",
    "points_on_polygon_boundary", "points_in_polygon_closed",
    "points_in_polygons_batch", "points_in_polygon_rows",
    "points_in_polygon_rows_torch",
    "representative_points", "segments_intersect", "polygons_intersect",
    "polygon_within", "polygon_area", "clip_polygon_to_box", "box_clip_areas",
    "box_clip_areas_torch", "box_clip_areas_rows",
]

#: construction backends: the batched host build, its device passes, and
#: the per-object reference loop every batched build is store-identical to
BUILD_BACKENDS = ("numpy", "torch", "sequential")
#: host seconds of the batched builds' stages (``dda``, ``scanline``,
#: ``pip`` or ``clip``, ``pack``; RA ``fit``, 5C+CH ``pentagon`` and
#: ``hull``; ``probe``, the scale-out planner's probe builds, holds the
#: stages of those builds), summed inside a ``BUILD_STAGES.record()`` block;
#: the ``build.*`` spans of a profiler's trace
BUILD_STAGES = StageClock("build")


def check_build_backend(backend: str) -> None:
    if backend == "jnp":
        raise ValueError("build_backend 'jnp' is the reference's name; the "
                         "port's device construction is build_backend="
                         "'torch'")
    if backend not in BUILD_BACKENDS:
        raise ValueError(f"unknown build_backend {backend!r}; "
                         f"expected one of {BUILD_BACKENDS}")


def build_device(backend: str, device=None) -> torch.device | None:
    """Check ``backend``; the device the ``torch`` build runs on (``None``
    -> ``"cuda"``, which raises without a GPU), ``None`` for the host
    builds."""
    check_build_backend(backend)
    return resolve_device(device) if backend == "torch" else None


def size_buckets(sizes: np.ndarray, chunk_elems: int = 1 << 22):
    """Yield index chunks grouped by power-of-two size class (padding waste
    <= 2x), each chunk's padded element count bounded by ``chunk_elems``.
    Zero-size rows are skipped."""
    sizes = np.asarray(sizes, np.int64)
    nz = np.nonzero(sizes > 0)[0]
    if len(nz) == 0:
        return
    cls = np.ceil(np.log2(sizes[nz].astype(np.float64))).astype(np.int64)
    for c in np.unique(cls):
        sel = nz[cls == c]
        L = int(sizes[sel].max())
        rows = max(1, int(chunk_elems // max(1, L)))
        for r0 in range(0, len(sel), rows):
            yield sel[r0: r0 + rows]


def polygon_edges(verts: np.ndarray, nverts: np.ndarray):
    """Return (starts [P,V,2], ends [P,V,2], mask [P,V]) of polygon edges.

    Edge i runs from vertex i to vertex (i+1) mod nverts. Padded slots are
    masked out and their coordinates degenerate to the first vertex.
    """
    verts = np.asarray(verts, dtype=np.float64)
    nverts = np.asarray(nverts, dtype=np.int64)
    P, V, _ = verts.shape
    idx = np.arange(V)[None, :]                       # [1,V]
    valid = idx < nverts[:, None]                     # [P,V]
    nxt = (idx + 1) % np.maximum(nverts[:, None], 1)  # wrap within ring
    nxt = np.where(valid, nxt, 0)
    starts = np.where(valid[..., None], verts, verts[:, :1, :])
    ends = np.take_along_axis(verts, nxt[..., None].repeat(2, axis=-1), axis=1)
    ends = np.where(valid[..., None], ends, verts[:, :1, :])
    return starts, ends, valid


def polygon_mbrs(verts: np.ndarray, nverts: np.ndarray) -> np.ndarray:
    """[P,4] = (xmin, ymin, xmax, ymax) per polygon, ignoring padding."""
    verts = np.asarray(verts, dtype=np.float64)
    nverts = np.asarray(nverts, dtype=np.int64)
    P, V, _ = verts.shape
    valid = (np.arange(V)[None, :] < nverts[:, None])[..., None]
    lo = np.where(valid, verts, np.inf).min(axis=1)
    hi = np.where(valid, verts, -np.inf).max(axis=1)
    return np.concatenate([lo, hi], axis=1)


def points_in_polygon(points: np.ndarray, verts: np.ndarray,
                      n: int | None = None) -> np.ndarray:
    """Crossing-number test for many points against ONE polygon.

    points: [M,2]; verts: [V,2] (optionally padded, pass n). Returns [M] bool.
    """
    points = np.asarray(points, dtype=np.float64)
    verts = np.asarray(verts, dtype=np.float64)
    if n is not None:
        verts = verts[: int(n)]
    x, y = points[:, 0][:, None], points[:, 1][:, None]       # [M,1]
    x0, y0 = verts[:, 0][None, :], verts[:, 1][None, :]       # [1,V]
    x1, y1 = np.roll(verts[:, 0], -1)[None, :], np.roll(verts[:, 1], -1)[None, :]
    cond = (y0 <= y) != (y1 <= y)                             # [M,V]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (y - y0) / np.where(y1 == y0, 1.0, y1 - y0)
    xint = x0 + t * (x1 - x0)
    crossings = np.sum(cond & (xint > x), axis=1)
    return (crossings % 2) == 1


def points_on_polygon_boundary(
    points: np.ndarray, verts: np.ndarray, n: int | None = None
) -> np.ndarray:
    """Exact on-boundary test: point collinear with an edge and inside its
    bounding box. points: [M,2]; verts: [V,2]. Returns [M] bool."""
    points = np.asarray(points, dtype=np.float64)
    verts = np.asarray(verts, dtype=np.float64)
    if n is not None:
        verts = verts[: int(n)]
    x, y = points[:, 0][:, None], points[:, 1][:, None]       # [M,1]
    x0, y0 = verts[:, 0][None, :], verts[:, 1][None, :]       # [1,V]
    x1, y1 = np.roll(verts[:, 0], -1)[None, :], np.roll(verts[:, 1], -1)[None, :]
    d = _orient(x0, y0, x1, y1, x, y)
    on = ((d == 0)
          & (np.minimum(x0, x1) <= x) & (x <= np.maximum(x0, x1))
          & (np.minimum(y0, y1) <= y) & (y <= np.maximum(y0, y1)))
    return on.any(axis=1)


def points_in_polygon_closed(
    points: np.ndarray, verts: np.ndarray, n: int | None = None
) -> np.ndarray:
    """Closed-region PiP: inside by crossing parity OR exactly on the
    boundary (touching counts)."""
    return (points_in_polygon(points, verts, n)
            | points_on_polygon_boundary(points, verts, n))


def representative_points(verts: np.ndarray, nverts: np.ndarray) -> np.ndarray:
    """One guaranteed-interior point per simple polygon. [P,V,2]/[P] -> [P,2].

    O'Rourke's diagonal construction: let b be the extreme vertex along a
    generic direction with ring neighbours a and c. If no other vertex lies
    in the closed triangle (a,b,c), its centroid is interior; otherwise the
    midpoint of b and the in-triangle vertex farthest from line (a,c) is the
    midpoint of a polygon diagonal, hence interior. Degenerate rings fall
    back to vertex b.
    """
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P, V, _ = verts.shape
    if P == 0:
        return np.zeros((0, 2), np.float64)
    idx = np.arange(V)[None, :]
    valid = idx < nverts[:, None]
    rows = np.arange(P)
    key = np.where(valid,
                   verts[..., 0] + 0.5609840165894135 * verts[..., 1], np.inf)
    b = np.argmin(key, axis=1)
    n = np.maximum(nverts, 1)
    a = (b - 1) % n
    c = (b + 1) % n
    pa, pb, pc = verts[rows, a], verts[rows, b], verts[rows, c]
    s = _orient(pa[:, 0], pa[:, 1], pb[:, 0], pb[:, 1], pc[:, 0], pc[:, 1])
    sgn = np.where(s >= 0, 1.0, -1.0)[:, None]
    wx, wy = verts[..., 0], verts[..., 1]

    def tri(p, q):
        return _orient(p[:, None, 0], p[:, None, 1],
                       q[:, None, 0], q[:, None, 1], wx, wy)

    in_tri = ((sgn * tri(pa, pb) >= 0) & (sgn * tri(pb, pc) >= 0)
              & (sgn * tri(pc, pa) >= 0) & valid
              & (idx != a[:, None]) & (idx != b[:, None]) & (idx != c[:, None]))
    dist = np.where(in_tri, np.abs(tri(pa, pc)), -1.0)
    q = np.argmax(dist, axis=1)
    pq = verts[rows, q]
    has_q = dist[rows, q] > 0
    rep = np.where(has_q[:, None], (pb + pq) / 2.0, (pa + pb + pc) / 3.0)
    ok = (nverts >= 3) & (s != 0)
    # self-check: near-degenerate rings can defeat the construction
    ok &= points_in_polygons_batch(rep[:, None, :], verts, nverts)[:, 0]
    return np.where(ok[:, None], rep, pb)


def points_in_polygons_batch(
    points: np.ndarray, verts: np.ndarray, nverts: np.ndarray
) -> np.ndarray:
    """PiP for per-polygon points. points: [P,M,2]; polygons padded [P,V,2].
    Returns [P,M] bool."""
    points = np.asarray(points, dtype=np.float64)
    starts, ends, mask = polygon_edges(verts, nverts)
    x, y = points[..., 0][:, :, None], points[..., 1][:, :, None]   # [P,M,1]
    x0, y0 = starts[..., 0][:, None, :], starts[..., 1][:, None, :]  # [P,1,V]
    x1, y1 = ends[..., 0][:, None, :], ends[..., 1][:, None, :]
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (y - y0) / np.where(y1 == y0, 1.0, y1 - y0)
    xint = x0 + t * (x1 - x0)
    cross = cond & (xint > x) & mask[:, None, :]
    return (np.sum(cross, axis=2) % 2) == 1


def points_in_polygon_rows(
    points: np.ndarray, poly_of_point: np.ndarray,
    verts: np.ndarray, nverts: np.ndarray, chunk_elems: int = 1 << 22,
) -> np.ndarray:
    """Crossing-number test where every point tests against its OWN polygon.

    points: [M,2]; poly_of_point: [M] indices into the padded polygon arrays.
    Returns [M] bool; row-identical to :func:`points_in_polygon`.
    """
    points = np.asarray(points, dtype=np.float64)
    poly_of_point = np.asarray(poly_of_point, np.int64)
    starts, ends, mask = polygon_edges(verts, nverts)
    M = len(points)
    V = starts.shape[1]
    out = np.zeros(M, dtype=bool)
    step = max(1, int(chunk_elems // max(1, V)))
    for i0 in range(0, M, step):
        sl = slice(i0, min(M, i0 + step))
        p = poly_of_point[sl]
        x = points[sl, 0][:, None]
        y = points[sl, 1][:, None]
        x0, y0 = starts[p, :, 0], starts[p, :, 1]
        x1, y1 = ends[p, :, 0], ends[p, :, 1]
        cond = (y0 <= y) != (y1 <= y)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (y - y0) / np.where(y1 == y0, 1.0, y1 - y0)
        xint = x0 + t * (x1 - x0)
        cross = cond & (xint > x) & mask[p]
        out[sl] = (np.sum(cross, axis=1) % 2) == 1
    return out


def _pip_rows_torch(points, starts, ends, mask, poly_of_point):
    """The crossing test of :func:`points_in_polygon_rows` on tensors, each
    row against its own polygon's gathered edges."""
    x = points[:, 0, None]
    y = points[:, 1, None]
    x0, y0 = starts[poly_of_point, :, 0], starts[poly_of_point, :, 1]
    x1, y1 = ends[poly_of_point, :, 0], ends[poly_of_point, :, 1]
    cond = (y0 <= y) != (y1 <= y)
    t = (y - y0) / torch.where(y1 == y0, 1.0, y1 - y0)
    # a separate multiply and add, as numpy rounds them (no fused FMA)
    step = t * (x1 - x0)
    xint = x0 + step
    cross = cond & (xint > x) & mask[poly_of_point]
    return (cross.sum(dim=1) % 2) == 1


def points_in_polygon_rows_torch(points, poly_of_point, verts, nverts,
                                 device=None,
                                 chunk_elems: int = 1 << 22) -> np.ndarray:
    """Device twin of :func:`points_in_polygon_rows` (float64; the crossing
    test is exact comparisons, so the rows are identical). ``points`` is
    [M,2] on the host or already on ``device``; ``poly_of_point`` [M] host
    indices. Rows are chunked by :func:`size_buckets` over their polygon's
    vertex count, so each chunk gathers only that many edges. Returns [M]
    bool on the host."""
    dev = resolve_device(device)
    poly_of_point = np.asarray(poly_of_point, np.int64)
    nverts = np.asarray(nverts, np.int64)
    M = len(poly_of_point)
    out = np.zeros(M, dtype=bool)
    if M == 0:
        return out
    starts, ends, mask = polygon_edges(verts, nverts)
    starts = torch.as_tensor(starts, device=dev)
    ends = torch.as_tensor(ends, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    points = torch.as_tensor(points, dtype=torch.float64, device=dev)
    poly = torch.as_tensor(poly_of_point, device=dev)
    for sel in size_buckets(nverts[poly_of_point], chunk_elems):
        Vb = int(nverts[poly_of_point[sel]].max())
        rows = torch.as_tensor(sel, device=dev)
        got = _pip_rows_torch(points[rows], starts[:, :Vb], ends[:, :Vb],
                              mask[:, :Vb], poly[rows])
        out[sel] = got.cpu().numpy()
    return out


def _orient(ax, ay, bx, by, cx, cy):
    """Signed orientation of triangle (a,b,c): >0 ccw, <0 cw, 0 collinear."""
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def segments_intersect(a0, a1, b0, b1) -> np.ndarray:
    """Proper/improper segment intersection test, broadcastable.

    a0,a1,b0,b1: [...,2]. Returns bool array of the broadcast shape.
    Handles collinear-overlap via on-segment checks.
    """
    a0 = np.asarray(a0, np.float64); a1 = np.asarray(a1, np.float64)
    b0 = np.asarray(b0, np.float64); b1 = np.asarray(b1, np.float64)
    d1 = _orient(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a0[..., 0], a0[..., 1])
    d2 = _orient(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a1[..., 0], a1[..., 1])
    d3 = _orient(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b0[..., 0], b0[..., 1])
    d4 = _orient(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b1[..., 0], b1[..., 1])
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) \
        & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)

    def on_seg(px, py, qx, qy, rx, ry):
        # r collinear with pq assumed; is r within the pq bounding box?
        return (
            (np.minimum(px, qx) <= rx) & (rx <= np.maximum(px, qx))
            & (np.minimum(py, qy) <= ry) & (ry <= np.maximum(py, qy))
        )

    touch = (
        ((d1 == 0) & on_seg(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a0[..., 0], a0[..., 1]))
        | ((d2 == 0) & on_seg(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1], a1[..., 0], a1[..., 1]))
        | ((d3 == 0) & on_seg(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b0[..., 0], b0[..., 1]))
        | ((d4 == 0) & on_seg(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1], b1[..., 0], b1[..., 1]))
    )
    return proper | touch


def polygons_intersect(
    verts_a: np.ndarray, na: int, verts_b: np.ndarray, nb: int
) -> bool:
    """Exact polygon-polygon intersection (the refinement oracle).

    True iff boundaries cross, or one polygon contains the other.
    """
    va = np.asarray(verts_a, np.float64)[: int(na)]
    vb = np.asarray(verts_b, np.float64)[: int(nb)]
    a0 = va; a1 = np.roll(va, -1, axis=0)
    b0 = vb; b1 = np.roll(vb, -1, axis=0)
    hit = segments_intersect(
        a0[:, None, :], a1[:, None, :], b0[None, :, :], b1[None, :, :]
    )
    if bool(hit.any()):
        return True
    # containment: representative interior points, closed-region classified
    # (a raw vertex can sit numerically on the other boundary)
    ra = representative_points(va[None], np.asarray([len(va)]))[0]
    rb = representative_points(vb[None], np.asarray([len(vb)]))[0]
    if bool(points_in_polygon_closed(ra[None], vb)[0]):
        return True
    if bool(points_in_polygon_closed(rb[None], va)[0]):
        return True
    return False


def polygon_within(verts_a: np.ndarray, na: int, verts_b: np.ndarray,
                   nb: int) -> bool:
    """Exact 'a within b' (a's area a subset of b's), the within oracle.
    Boundary contact counts as within (closed-region semantics): every
    vertex of a lies in the closed b, and no edge pair crosses properly."""
    va = np.asarray(verts_a, np.float64)[: int(na)]
    vb = np.asarray(verts_b, np.float64)[: int(nb)]
    if not points_in_polygon_closed(va, vb).all():
        return False
    a0 = va; a1 = np.roll(va, -1, axis=0)
    b0 = vb; b1 = np.roll(vb, -1, axis=0)
    d1 = _orient(b0[None, :, 0], b0[None, :, 1], b1[None, :, 0], b1[None, :, 1], a0[:, None, 0], a0[:, None, 1])
    d2 = _orient(b0[None, :, 0], b0[None, :, 1], b1[None, :, 0], b1[None, :, 1], a1[:, None, 0], a1[:, None, 1])
    d3 = _orient(a0[:, None, 0], a0[:, None, 1], a1[:, None, 0], a1[:, None, 1], b0[None, :, 0], b0[None, :, 1])
    d4 = _orient(a0[:, None, 0], a0[:, None, 1], a1[:, None, 0], a1[:, None, 1], b1[None, :, 0], b1[None, :, 1])
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) \
        & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)
    return not bool(proper.any())


# ---------------------------------------------------------------------------
# Box clipping for coverage fractions (RI and RA construction)
# ---------------------------------------------------------------------------

def polygon_area(verts: np.ndarray, n: int | None = None) -> float:
    """Shoelace area (absolute)."""
    v = np.asarray(verts, np.float64)
    if n is not None:
        v = v[: int(n)]
    x, y = v[:, 0], v[:, 1]
    return float(abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)) / 2.0)


def clip_polygon_to_box(verts: np.ndarray,
                        box: tuple[float, float, float, float]) -> np.ndarray:
    """Sutherland–Hodgman clip of a polygon to an axis-aligned box, one
    cell at a time: the per-cell reference of :func:`box_clip_areas_rows`.
    Returns the clipped ring [K,2] (possibly empty)."""
    xmin, ymin, xmax, ymax = box

    def clip_half(poly, inside, intersect):
        out = []
        k = len(poly)
        for i in range(k):
            cur, nxt = poly[i], poly[(i + 1) % k]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def ix_x(c, n, x):
        t = (x - c[0]) / (n[0] - c[0])
        return (x, c[1] + t * (n[1] - c[1]))

    def ix_y(c, n, y):
        t = (y - c[1]) / (n[1] - c[1])
        return (c[0] + t * (n[0] - c[0]), y)

    # y-planes first, the order the batched pass shares across a grid row
    poly = [tuple(p) for p in np.asarray(verts, np.float64)]
    poly = clip_half(poly, lambda p: p[1] >= ymin,
                     lambda c, n: ix_y(c, n, ymin))
    if poly:
        poly = clip_half(poly, lambda p: p[1] <= ymax,
                         lambda c, n: ix_y(c, n, ymax))
    if poly:
        poly = clip_half(poly, lambda p: p[0] >= xmin,
                         lambda c, n: ix_x(c, n, xmin))
    if poly:
        poly = clip_half(poly, lambda p: p[0] <= xmax,
                         lambda c, n: ix_x(c, n, xmax))
    return np.asarray(poly, np.float64).reshape(-1, 2)


# clip sequence: (coordinate axis, box column, keep-greater-or-equal);
# y-planes first, as in clip_polygon_to_box
_CLIP_PASSES = ((1, 1, True), (1, 3, False), (0, 0, True), (0, 2, False))


def _clip_halfplane_batch(pts, cnt, axis, bound, keep_ge):
    """One half-plane Sutherland–Hodgman pass over K padded rings.

    pts [K,V,2], cnt [K], bound [K] (per-row clip line). Returns
    (out [K,Vout,2], new_cnt [K]); each input vertex emits at most itself
    plus one intersection, and Vout is sized to the largest emission.
    """
    K, V, _ = pts.shape
    if V == 0:
        return np.zeros((K, 1, 2), np.float64), np.zeros(K, np.int64)
    idx = np.arange(V)[None, :]
    valid = idx < cnt[:, None]
    rows = np.broadcast_to(np.arange(K)[:, None], (K, V))
    # ring successor: roll, then rewrite each ring's wrap slot (cnt-1 -> 0)
    nxt_pts = np.roll(pts, -1, axis=1)
    nxt_pts[np.arange(K), np.maximum(cnt - 1, 0)] = pts[:, 0]
    c = pts[..., axis]
    n_ = nxt_pts[..., axis]
    b = bound[:, None]
    cin = (c >= b) if keep_ge else (c <= b)
    nin = (n_ >= b) if keep_ge else (n_ <= b)
    emit_cur = cin & valid
    emit_ix = (cin != nin) & valid
    n_emit = np.add(emit_cur, emit_ix, dtype=np.int32)
    pos = np.cumsum(n_emit, axis=1, dtype=np.int32) - n_emit  # excl. prefix
    new_cnt = n_emit.sum(axis=1).astype(np.int64)
    Vout = max(1, int(new_cnt.max()) if K else 1)
    out = np.zeros((K, Vout, 2), np.float64)
    out[rows[emit_cur], pos[emit_cur]] = pts[emit_cur]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (b - c) / np.where(n_ == c, 1.0, n_ - c)
    ix = np.empty((K, V, 2), np.float64)
    ix[..., axis] = np.broadcast_to(b, (K, V))
    ix[..., 1 - axis] = pts[..., 1 - axis] + t * (nxt_pts[..., 1 - axis]
                                                 - pts[..., 1 - axis])
    pos_ix = pos + emit_cur
    out[rows[emit_ix], pos_ix[emit_ix]] = ix[emit_ix]
    return out, new_cnt


def _ring_areas(pts, cnt):
    """Absolute shoelace area of K padded rings (padding contributes 0)."""
    K, V, _ = pts.shape
    idx = np.arange(V)[None, :]
    valid = idx < cnt[:, None]
    nxt_pts = np.roll(pts, -1, axis=1)
    nxt_pts[np.arange(K), np.maximum(cnt - 1, 0)] = pts[:, 0]
    terms = pts[..., 0] * nxt_pts[..., 1] - nxt_pts[..., 0] * pts[..., 1]
    return np.abs(np.where(valid, terms, 0.0).sum(axis=1)) / 2.0


def box_clip_areas(verts, nverts, boxes) -> np.ndarray:
    """Area of (ring ∩ axis-aligned box) for K independent rows at once.

    verts [K,V,2] padded rings, nverts [K], boxes [K,4] (xmin,ymin,xmax,ymax).
    Returns [K] float64 absolute areas; rows whose clipped ring degenerates
    (< 3 vertices) report 0, as the per-cell clip does.
    """
    pts = np.asarray(verts, np.float64)
    cnt = np.asarray(nverts, np.int64)
    boxes = np.asarray(boxes, np.float64)
    for axis, col, keep_ge in _CLIP_PASSES:
        pts, cnt = _clip_halfplane_batch(pts, cnt, axis, boxes[:, col], keep_ge)
    return np.where(cnt >= 3, _ring_areas(pts, cnt), 0.0)


def _clip_halfplane_torch(pts, cnt, axis, bound, keep_ge):
    """One half-plane pass of :func:`_clip_halfplane_batch` on tensors, at
    the static output width 2V: each input vertex emits at most itself and
    one intersection. Masked writes land in a dump column (2V) that is cut
    off, so the pass reads nothing back to size its output."""
    K, V = pts.shape[0], pts.shape[1]
    dev = pts.device
    idx = torch.arange(V, device=dev)[None, :]
    valid = idx < cnt[:, None]
    rows = torch.arange(K, device=dev)[:, None].expand(K, V)
    nxt = torch.where(valid, (idx + 1) % cnt[:, None].clamp(min=1), 0)
    nxt_pts = torch.gather(pts, 1, nxt[..., None].expand(K, V, 2))
    c = pts[..., axis]
    n_ = nxt_pts[..., axis]
    b = bound[:, None]
    cin = (c >= b) if keep_ge else (c <= b)
    nin = (n_ >= b) if keep_ge else (n_ <= b)
    emit_cur = cin & valid
    emit_ix = (cin != nin) & valid
    n_emit = emit_cur.to(torch.int64) + emit_ix.to(torch.int64)
    pos = torch.cumsum(n_emit, dim=1) - n_emit          # exclusive prefix
    dump = 2 * V
    out = pts.new_zeros((K, 2 * V + 1, 2))
    out[rows, torch.where(emit_cur, pos, dump)] = pts
    t = (b - c) / torch.where(n_ == c, 1.0, n_ - c)
    o = 1 - axis
    # a separate multiply and add, as numpy rounds them (no fused FMA)
    step = t * (nxt_pts[..., o] - pts[..., o])
    other = pts[..., o] + step
    bb = b.expand(K, V)
    ix = (torch.stack([bb, other], -1) if axis == 0
          else torch.stack([other, bb], -1))
    out[rows, torch.where(emit_ix, pos + emit_cur.to(torch.int64), dump)] = ix
    return out[:, : 2 * V], n_emit.sum(dim=1)


def _box_clip_torch(pts, cnt, boxes):
    """The four half-plane passes of :func:`box_clip_areas` on tensors:
    (clipped rings [K,16V,2], vertex counts [K])."""
    for axis, col, keep_ge in _CLIP_PASSES:
        pts, cnt = _clip_halfplane_torch(pts, cnt, axis, boxes[:, col],
                                         keep_ge)
    return pts, cnt


def box_clip_areas_torch(verts, nverts, boxes, device=None) -> np.ndarray:
    """Device twin of :func:`box_clip_areas` (float64): the four half-plane
    passes run on ``device`` (inputs on the host or already there); the
    shoelace runs on the host through :func:`_ring_areas` over the rings
    trimmed to their widest, the reduction order of the reference's device
    twin. Vertices round as numpy's, so areas can differ from the banded
    numpy driver's only in the summation order of the shoelace; a class
    flip needs a fraction within ulps of a threshold."""
    dev = resolve_device(device)
    pts = torch.as_tensor(verts, dtype=torch.float64, device=dev)
    cnt = torch.as_tensor(nverts, dtype=torch.int64, device=dev)
    boxes = torch.as_tensor(boxes, dtype=torch.float64, device=dev)
    pts, cnt = _box_clip_torch(pts, cnt, boxes)
    cnt = cnt.cpu().numpy()
    W = max(1, int(cnt.max()) if len(cnt) else 1)
    pts = pts[:, :W].cpu().numpy()
    return np.where(cnt >= 3, _ring_areas(pts, cnt), 0.0)


def box_clip_areas_rows(verts, nverts, poly_of_row, boxes,
                        backend: str = "numpy", device=None,
                        chunk_elems: int = 1 << 22) -> np.ndarray:
    """Row-bucketed driver over the batched clip: row k clips polygon
    ``poly_of_row[k]`` (padded [P,V,2]/[P]) to ``boxes[k]``.

    ``numpy``: all cells of one grid row of one polygon share (ymin,
    ymax), so the two y-plane passes run once per unique band and only the
    two x-plane passes run per cell, in the pass order of
    :func:`clip_polygon_to_box`. ``torch``: the generic per-row pass of
    :func:`box_clip_areas_torch` on ``device`` (the same pass order, so
    the same vertices), in chunks of at most ``1 << 18`` padded elements
    for its static doubling widths. Buckets by power-of-two vertex-count
    class bound padding waste; chunks bound the padded working set below
    ``chunk_elems``.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown clip backend {backend!r}; expected "
                         "'numpy' or 'torch'")
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    poly_of_row = np.asarray(poly_of_row, np.int64)
    boxes = np.asarray(boxes, np.float64)
    K = len(poly_of_row)
    out = np.zeros(K, np.float64)
    if K == 0:
        return out

    if backend == "torch":
        dev = resolve_device(device)
        verts_d = torch.as_tensor(verts, device=dev)
        poly_d = torch.as_tensor(poly_of_row, device=dev)
        boxes_d = torch.as_tensor(boxes, device=dev)
        nv = nverts[poly_of_row]
        nv_d = torch.as_tensor(nv, device=dev)
        for sel in size_buckets(nv, min(chunk_elems, 1 << 18)):
            Vb = int(nv[sel].max())
            rows = torch.as_tensor(sel, device=dev)
            out[sel] = box_clip_areas_torch(verts_d[:, :Vb][poly_d[rows]],
                                            nv_d[rows], boxes_d[rows],
                                            device=dev)
        return out

    # unique (polygon, ymin, ymax) bands
    bandkey = np.stack([poly_of_row.astype(np.float64),
                        boxes[:, 1], boxes[:, 3]], axis=1)
    uniq, band_of_row = np.unique(bandkey, axis=0, return_inverse=True)
    band_of_row = band_of_row.ravel()
    band_poly = uniq[:, 0].astype(np.int64)
    B = len(uniq)

    # y-passes once per band, bucketed by polygon vertex class
    nvb = nverts[band_poly]
    chunks = []                       # (band sel, pts, cnt)
    for sel in size_buckets(nvb, chunk_elems):
        Vb = int(nvb[sel].max())
        pts = verts[:, :Vb][band_poly[sel]]
        cnt = nvb[sel]
        for axis, col, keep_ge in _CLIP_PASSES[:2]:
            bound = uniq[sel, 1] if col == 1 else uniq[sel, 2]
            pts, cnt = _clip_halfplane_batch(pts, cnt, axis, bound, keep_ge)
        chunks.append((sel, pts, cnt))

    # the padded band-ring store
    band_cnt = np.zeros(B, np.int64)
    for sel, _, cnt in chunks:
        band_cnt[sel] = cnt
    W = max(1, int(band_cnt.max()))
    band_pts = np.zeros((B, W, 2), np.float64)
    for sel, pts, _ in chunks:
        band_pts[sel, : pts.shape[1]] = pts[:, :W]

    # x-passes per cell row, bucketed by band-ring size class (rows whose
    # band clipped away entirely are skipped by the bucketing and stay 0)
    cntr = band_cnt[band_of_row]
    for sel in size_buckets(cntr, chunk_elems):
        Wb = int(cntr[sel].max())
        pts = band_pts[:, :Wb][band_of_row[sel]]
        cnt = cntr[sel]
        for axis, col, keep_ge in _CLIP_PASSES[2:]:
            pts, cnt = _clip_halfplane_batch(pts, cnt, axis,
                                             boxes[sel, col], keep_ge)
        out[sel] = np.where(cnt >= 3, _ring_areas(pts, cnt), 0.0)
    return out
