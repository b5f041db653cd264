"""5C+CH intermediate filter (Brinkhoff et al.).

Conservative approximations applied in sequence: the minimum-bounding
5-corner convex polygon (realized as a 5-direction DOP: the intersection of
half-planes at five fixed orientations, whose corners are materialized),
then the exact convex hull. Both are conservative-only: they certify TRUE
negatives (approximations disjoint) but never true hits. Host numpy; the
batched filter runs the separating-axis tests as padded einsum passes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.geometry import BUILD_STAGES, build_device
from ..core.join import INDECISIVE, TRUE_NEG

__all__ = ["FiveCCH", "build_5cch", "build_5cch_lines",
           "fivecch_verdict_pair", "fivecch_within_verdict_pair",
           "fivecch_filter_batch", "convex_hull"]

# 5 fixed outward normals (72-degree steps)
_ANG = np.pi / 2 + 2 * np.pi * np.arange(5) / 5
_DIRS = np.stack([np.cos(_ANG), np.sin(_ANG)], axis=1)   # [5,2]

# Precompute corner solve matrices for adjacent direction pairs
_CORNER_INV = []
for _k in range(5):
    A = np.stack([_DIRS[_k], _DIRS[(_k + 1) % 5]])
    _CORNER_INV.append(np.linalg.inv(A))


@dataclass
class FiveCCH:
    pent: np.ndarray             # [P,5,2] pentagon corners (CCW)
    hull_off: np.ndarray         # [P+1]
    hull_pts: np.ndarray         # [sum_H, 2]

    def __len__(self):
        return len(self.pent)

    def hull(self, i: int) -> np.ndarray:
        return self.hull_pts[self.hull_off[i]: self.hull_off[i + 1]]

    def size_bytes(self) -> int:
        # 5 corner points per 5C + hull points, float32 pairs
        return 4 * 2 * 5 * len(self.pent) + 4 * 2 * len(self.hull_pts)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain. points [N,2] -> hull [H,2] CCW."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def half(ps):
        out = []
        for p in ps:
            while len(out) >= 2:
                u = out[-1] - out[-2]
                w = p - out[-2]
                if u[0] * w[1] - u[1] * w[0] <= 0:
                    out.pop()
                else:
                    break
            out.append(p)
        return out

    lower = half(list(pts))
    upper = half(list(pts[::-1]))
    return np.asarray(lower[:-1] + upper[:-1])


def _corners_from_support(m: np.ndarray) -> np.ndarray:
    """Solve the 5 adjacent-direction 2x2 systems for support values
    ``m [..., 5]``; explicit elementwise arithmetic so the batched and
    per-object builds are bit-identical. Returns [..., 5, 2]."""
    m1 = np.roll(m, -1, axis=-1)
    inv = np.stack(_CORNER_INV)              # [5,2,2]
    x = inv[:, 0, 0] * m + inv[:, 0, 1] * m1
    y = inv[:, 1, 0] * m + inv[:, 1, 1] * m1
    return np.stack([x, y], axis=-1)


def _pentagon(verts: np.ndarray) -> np.ndarray:
    """Corners of the 5-direction DOP enclosing ``verts``."""
    m = (verts @ _DIRS.T).max(axis=0)        # [5] support values
    return _corners_from_support(m)


def _pentagons_multi(verts: np.ndarray, nverts: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_pentagon` over the padded dataset: masked support
    values, then all corner solves as one einsum. [P,5,2]."""
    verts = np.asarray(verts, np.float64)
    nverts = np.asarray(nverts, np.int64)
    P, V, _ = verts.shape
    valid = np.arange(V)[None, :] < nverts[:, None]
    sup = np.where(valid[..., None], verts @ _DIRS.T, -np.inf).max(axis=1)
    return _corners_from_support(sup)


def build_5cch(dataset, backend: str = "numpy", device=None) -> FiveCCH:
    """Build the 5C+CH store. ``numpy`` and ``torch`` (no device pass, as
    the reference's ``jnp``) vectorize the pentagon (5-DOP) stage over the
    whole dataset; ``sequential`` is the per-object reference. The
    convex-hull stage is a monotone chain per object either way (cheap
    relative to rasterizing filters)."""
    build_device(backend, device)
    P = len(dataset)
    stage = BUILD_STAGES.stage
    if backend == "sequential":
        pent = np.zeros((P, 5, 2))
        for i in range(P):
            pent[i] = _pentagon(dataset.polygon(i))
    else:
        with stage("pentagon"):
            pent = _pentagons_multi(dataset.verts, dataset.nverts)
    off = [0]
    hulls = []
    with stage("hull"):
        for i in range(P):
            h = convex_hull(dataset.polygon(i))
            hulls.append(h)
            off.append(off[-1] + len(h))
    return FiveCCH(pent=pent,
                   hull_off=np.asarray(off, np.int64),
                   hull_pts=(np.concatenate(hulls, axis=0) if hulls
                             else np.zeros((0, 2))))


def build_5cch_lines(dataset, backend: str = "numpy",
                     device=None) -> FiveCCH:
    """5C+CH store for open linestrings: the pentagon and hull of a chain's
    vertices enclose the chain, so disjointness stays conservative (a
    2-vertex chain's hull is its two points, and only the pentagon test
    applies to it)."""
    return build_5cch(dataset, backend=backend, device=device)


def convex_disjoint(ha: np.ndarray, hb: np.ndarray) -> bool:
    """Separating-axis test for two convex polygons (CCW or CW)."""
    for h0, h1 in ((ha, hb), (hb, ha)):
        edges = np.roll(h0, -1, axis=0) - h0
        normals = np.stack([-edges[:, 1], edges[:, 0]], axis=1)
        p0 = h0 @ normals.T
        p1 = h1 @ normals.T
        sep = (p1.max(axis=0) < p0.min(axis=0)) | (p1.min(axis=0) > p0.max(axis=0))
        if bool(sep.any()):
            return True
    return False


def fivecch_verdict_pair(store_r: FiveCCH, i: int, store_s: FiveCCH, j: int) -> int:
    """5C stage first (cheap), then CH stage; TRUE_NEG or INDECISIVE only."""
    if convex_disjoint(store_r.pent[i], store_s.pent[j]):
        return TRUE_NEG
    ha, hb = store_r.hull(i), store_s.hull(j)
    if len(ha) >= 3 and len(hb) >= 3 and convex_disjoint(ha, hb):
        return TRUE_NEG
    return INDECISIVE


def fivecch_within_verdict_pair(store_r: FiveCCH, i: int, store_s: FiveCCH,
                                j: int) -> int:
    """Within filter: conservative approximations can only certify TRUE_NEG
    (disjoint approximations => r is not within s); never a hit."""
    return fivecch_verdict_pair(store_r, i, store_s, j)


# ---------------------------------------------------------------------------
# Batched 5C+CH filtering: the separating-axis test runs as one padded
# einsum pass over the whole candidate batch.
# ---------------------------------------------------------------------------

def _sat_disjoint_batch(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Vectorized separating-axis test: A, B [N, V, 2] (padded convex rings;
    padding must repeat a real vertex so extra edges are zero-length and the
    wrap-around edge stays the true closing edge). Returns [N] bool."""
    out = np.zeros(len(A), bool)
    for h0, h1 in ((A, B), (B, A)):
        edges = np.roll(h0, -1, axis=1) - h0
        normals = np.stack([-edges[..., 1], edges[..., 0]], axis=-1)  # [N,V,2]
        p0 = np.einsum("npc,nec->npe", h0, normals)
        p1 = np.einsum("npc,nec->npe", h1, normals)
        sep = ((p1.max(axis=1) < p0.min(axis=1))
               | (p1.min(axis=1) > p0.max(axis=1)))
        out |= sep.any(axis=1)
    return out


def _pad_hulls(store: FiveCCH, idx: np.ndarray):
    """Gather hulls ``idx`` into a padded [B, H, 2] array (repeat-last-vertex
    padding) plus the real vertex counts [B]."""
    idx = np.asarray(idx, np.int64)
    lo = store.hull_off[idx]
    counts = (store.hull_off[idx + 1] - lo).astype(np.int64)
    B = len(idx)
    H = int(max(1, counts.max() if B else 1))
    col = np.arange(H)[None, :]
    src = lo[:, None] + np.minimum(col, np.maximum(counts[:, None] - 1, 0))
    return store.hull_pts[src], counts


def fivecch_filter_batch(store_r: FiveCCH, store_s: FiveCCH,
                         pairs: np.ndarray) -> np.ndarray:
    """Vectorized 5C+CH filter; verdict-identical to
    :func:`fivecch_verdict_pair` per pair (TRUE_NEG / INDECISIVE only)."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8)
    neg = _sat_disjoint_batch(store_r.pent[pairs[:, 0]],
                              store_s.pent[pairs[:, 1]])
    live = np.nonzero(~neg)[0]
    if len(live):
        ha, na = _pad_hulls(store_r, pairs[live, 0])
        hb, nb = _pad_hulls(store_s, pairs[live, 1])
        ok = (na >= 3) & (nb >= 3)      # degenerate hulls skip the CH stage
        hull_neg = _sat_disjoint_batch(ha, hb) & ok
        neg[live] |= hull_neg
    return np.where(neg, TRUE_NEG, INDECISIVE).astype(np.int8)
