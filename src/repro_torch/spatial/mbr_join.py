"""Candidate generation: the partitioned grid-hash MBR join.

MBRs are hashed into a uniform grid over the joint data extent, co-bucketed
pairs are cross-tested, and a qualifying pair is emitted only from the
bucket holding the bottom-left corner of the pair's common MBR (reference-
point duplicate elimination). Bucketing and the co-bucket rows
(:func:`candidate_rows`) are host numpy work. The pair test over those rows
runs per backend:

* ``numpy`` — on the host; it emits candidates in the same order as the
  reference package's, which fixes the order of the join's results;
* ``torch`` — a float64 mask on a torch device (:func:`pair_mask_lane`),
  the counterpart of the reference's ``"jnp"`` backend; the fused chain
  keeps it on the device as its ``valid`` lane, the staged path reads it
  back;
* ``sequential`` — the per-object / per-bucket reference walk with the
  identical pair set.

:class:`MBRIndex` keeps one side's sorted bucket table warm across
probes (the join service's registered datasets), patched in place by
``insert`` and ``delete``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, upload

__all__ = ["MBR_BACKENDS", "mbr_join", "mbr_intersect_mask",
           "adaptive_grid", "joint_extent", "check_mbr_backend",
           "candidate_rows", "pair_mask_lane", "mbr_inside", "MBRIndex"]

MBR_BACKENDS = ("numpy", "torch", "sequential")

#: bucket-entry budget per object for the adaptive grid
_ENTRY_BUDGET = 8
_MAX_GRID = 1024


def check_mbr_backend(backend: str) -> None:
    if backend == "jnp":
        raise ValueError("mbr_backend 'jnp' is the reference's name; the "
                         "port's device pair-mask lane is mbr_backend='torch'")
    if backend not in MBR_BACKENDS:
        raise ValueError(f"unknown mbr backend {backend!r}; "
                         f"expected one of {MBR_BACKENDS}")


def mbr_intersect_mask(mr: np.ndarray, ms: np.ndarray) -> np.ndarray:
    """Pairwise MBR intersection for [N,4] x [M,4] -> [N,M] bool."""
    return ((mr[:, None, 0] <= ms[None, :, 2]) & (ms[None, :, 0] <= mr[:, None, 2])
            & (mr[:, None, 1] <= ms[None, :, 3]) & (ms[None, :, 1] <= mr[:, None, 3]))


def joint_extent(mbrs_r: np.ndarray, mbrs_s: np.ndarray
                 ) -> tuple[float, float, float]:
    """(x0, y0, span) of the square window covering both datasets' MBRs."""
    allm = np.concatenate([mbrs_r.reshape(-1, 4), mbrs_s.reshape(-1, 4)])
    if len(allm) == 0:
        return 0.0, 0.0, 1.0
    x0 = float(allm[:, 0].min())
    y0 = float(allm[:, 1].min())
    span = max(float(allm[:, 2].max()) - x0, float(allm[:, 3].max()) - y0)
    return x0, y0, max(span, np.finfo(np.float64).tiny)


def adaptive_grid(mbrs_r: np.ndarray, mbrs_s: np.ndarray,
                  extent: tuple[float, float, float] | None = None) -> int:
    """The finest power-of-two grid ``k`` (up to 1024) whose bucket
    expansion stays within ``_ENTRY_BUDGET`` entries per object."""
    mbrs_r = np.asarray(mbrs_r, np.float64).reshape(-1, 4)
    mbrs_s = np.asarray(mbrs_s, np.float64).reshape(-1, 4)
    n = len(mbrs_r) + len(mbrs_s)
    if n == 0:
        return 1
    span = (extent or joint_extent(mbrs_r, mbrs_s))[2]
    allm = np.concatenate([mbrs_r, mbrs_s])
    w = (allm[:, 2] - allm[:, 0]) / span
    h = (allm[:, 3] - allm[:, 1]) / span
    ks = 2 ** np.arange(0, int(np.log2(_MAX_GRID)) + 1)
    entries = ((w[:, None] * ks + 1.0) * (h[:, None] * ks + 1.0)).sum(axis=0)
    ok = np.nonzero(entries <= _ENTRY_BUDGET * n)[0]
    return int(ks[ok[-1]]) if len(ok) else 1


def _resolve_grid(grid, mbrs_r, mbrs_s, extent) -> int:
    if grid is None:
        return adaptive_grid(mbrs_r, mbrs_s, extent)
    if int(grid) < 1:
        raise ValueError(f"mbr grid must be >= 1 or None (adaptive), "
                         f"got {grid!r}")
    return int(grid)


def bucket_ranges(mbrs: np.ndarray, k: int,
                  extent: tuple[float, float, float]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive cell range [x0,x1] x [y0,y1] per MBR on the k x k grid,
    normalized by the joint data ``extent``."""
    x0, y0, span = extent
    scaled = (mbrs.reshape(-1, 4) - [x0, y0, x0, y0]) / span * k
    lo = np.clip(np.floor(scaled[:, :2]).astype(np.int64), 0, k - 1)
    hi = np.clip(np.floor(scaled[:, 2:]).astype(np.int64), 0, k - 1)
    return lo, hi


def expand_buckets(lo: np.ndarray, hi: np.ndarray, k: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Flat (object, bucket) table for inclusive cell ranges; row-major
    bucket ids ``x * k + y``."""
    lo = lo.reshape(-1, 2)
    hi = hi.reshape(-1, 2)
    nx = hi[:, 0] - lo[:, 0] + 1
    ny = hi[:, 1] - lo[:, 1] + 1
    cnt = nx * ny
    total = int(cnt.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z
    obj = np.repeat(np.arange(len(lo), dtype=np.int64), cnt)
    start = np.cumsum(cnt) - cnt
    off = np.arange(total, dtype=np.int64) - start[obj]
    oy = off % ny[obj]
    ox = off // ny[obj]
    return obj, (lo[obj, 0] + ox) * k + (lo[obj, 1] + oy)


def _cross_rows(obj_r, buck_r, obj_s, buck_s):
    """Cartesian co-bucket rows of two bucket-sorted (object, bucket)
    tables: ``(ri, si, own)`` with ``own`` the shared bucket id."""
    ur, start_r, cnt_r = np.unique(buck_r, return_index=True,
                                   return_counts=True)
    us, start_s, cnt_s = np.unique(buck_s, return_index=True,
                                   return_counts=True)
    common, ir, is_ = np.intersect1d(ur, us, assume_unique=True,
                                     return_indices=True)
    cr = cnt_r[ir]
    cs = cnt_s[is_]
    m = cr * cs
    total = int(m.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    grp = np.repeat(np.arange(len(common), dtype=np.int64), m)
    off = np.arange(total, dtype=np.int64) - (np.cumsum(m) - m)[grp]
    a = off // cs[grp]
    b = off % cs[grp]
    ri = obj_r[start_r[ir][grp] + a]
    si = obj_s[start_s[is_][grp] + b]
    return ri, si, common[grp]


def mbr_inside(mr: np.ndarray, ms: np.ndarray) -> np.ndarray:
    """[N] bool: does MBR ``mr[n]`` lie inside MBR ``ms[n]`` (closed)? The
    ``within`` predicate's candidate test."""
    return ((mr[:, 0] >= ms[:, 0]) & (mr[:, 1] >= ms[:, 1])
            & (mr[:, 2] <= ms[:, 2]) & (mr[:, 3] <= ms[:, 3]))


def _pad_rows_pow2(xs: list[np.ndarray], multiple: int = 1
                   ) -> tuple[list[np.ndarray], int]:
    """Zero-pad equal-length arrays (axis 0) to the next power of two, then
    up to a multiple of ``multiple`` (the ranks a frame is split over);
    returns (padded arrays, original length)."""
    n = len(xs[0])
    p2 = 1 << int(np.ceil(np.log2(max(n, 1))))
    pad = max(multiple, ((p2 + multiple - 1) // multiple) * multiple)
    return [x if len(x) == pad else
            np.concatenate([x, np.zeros((pad - n,) + x.shape[1:], x.dtype)])
            for x in xs], n


def _prepare(mbrs_r, mbrs_s, grid: int | None):
    """Shared host preamble of the entry points: coerce, resolve the joint
    extent and grid. Returns (mbrs_r, mbrs_s, k, extent), ``k = 0``
    signalling an empty join (an invalid explicit grid raises even then)."""
    mbrs_r = np.asarray(mbrs_r, np.float64).reshape(-1, 4)
    mbrs_s = np.asarray(mbrs_s, np.float64).reshape(-1, 4)
    extent = joint_extent(mbrs_r, mbrs_s)
    k = _resolve_grid(grid, mbrs_r, mbrs_s, extent)
    if len(mbrs_r) == 0 or len(mbrs_s) == 0:
        return mbrs_r, mbrs_s, 0, extent
    return mbrs_r, mbrs_s, k, extent


def candidate_rows(mbrs_r, mbrs_s, k: int, extent):
    """Co-bucket cross-product rows of the grid-hash join.

    Returns ``(ri, si, own_x, own_y, lo_r, lo_s)``: for every bucket shared
    by both sides, the cartesian rows of its R x S members, with the shared
    bucket's cell. A row is a join result iff the MBRs intersect and
    ``max(lo_r[ri], lo_s[si]) == (own_x, own_y)`` (reference-point
    ownership on integer low cells).
    """
    lo_r, hi_r = bucket_ranges(mbrs_r, k, extent)
    lo_s, hi_s = bucket_ranges(mbrs_s, k, extent)
    obj_r, buck_r = expand_buckets(lo_r, hi_r, k)
    obj_s, buck_s = expand_buckets(lo_s, hi_s, k)
    order_r = np.argsort(buck_r, kind="stable")
    order_s = np.argsort(buck_s, kind="stable")
    ri, si, own = _cross_rows(obj_r[order_r], buck_r[order_r],
                              obj_s[order_s], buck_s[order_s])
    if len(ri) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, lo_r, lo_s
    return ri, si, own // k, own % k, lo_r, lo_s


def _pair_mask(mbrs_r, mbrs_s, lo_r, lo_s, ri, si, own_x, own_y):
    """Intersection + reference-point ownership mask over candidate rows."""
    a = mbrs_r[ri]
    b = mbrs_s[si]
    hit = ((a[:, 0] <= b[:, 2]) & (b[:, 0] <= a[:, 2])
           & (a[:, 1] <= b[:, 3]) & (b[:, 1] <= a[:, 3]))
    owner = ((np.maximum(lo_r[ri, 0], lo_s[si, 0]) == own_x)
             & (np.maximum(lo_r[ri, 1], lo_s[si, 1]) == own_y))
    return hit & owner


def pair_mask_lane(mbrs_r, mbrs_s, lo_r, lo_s, ri, si, own_x, own_y,
                   device) -> torch.Tensor:
    """The pair test of :func:`_pair_mask` as a [N] bool lane on
    ``device``, in float64 (float32 would merge nearby MBR borders).
    ``ri``/``si`` are the co-bucket frame's int64 rows already on
    ``device`` (the fused chain uploads its frame once); the other operands
    are uploaded here without a host sync and nothing is read back, so the
    chain takes the lane as its ``valid`` lane. Eager PyTorch compiles
    nothing per shape, so no row padding is needed."""
    dev = torch.device(device)
    mr, ms = (upload(np.asarray(m, np.float64), dev)
              for m in (mbrs_r, mbrs_s))
    lor, los = (upload(np.asarray(lo, np.int64), dev) for lo in (lo_r, lo_s))
    ox, oy = (upload(np.asarray(x, np.int64), dev) for x in (own_x, own_y))
    a = mr[ri]
    b = ms[si]
    hit = ((a[:, 0] <= b[:, 2]) & (b[:, 0] <= a[:, 2])
           & (a[:, 1] <= b[:, 3]) & (b[:, 1] <= a[:, 3]))
    owner = ((torch.maximum(lor[ri, 0], los[si, 0]) == ox)
             & (torch.maximum(lor[ri, 1], los[si, 1]) == oy))
    return hit & owner


def _mbr_join_sequential(mbrs_r, mbrs_s, k, extent) -> np.ndarray:
    """Per-object expansion loop, per-bucket cross test: the reference
    walk every batched path must match as a pair set."""
    lo_r, hi_r = bucket_ranges(mbrs_r, k, extent)
    lo_s, hi_s = bucket_ranges(mbrs_s, k, extent)

    def expand(lo, hi):
        obj, bx, by = [], [], []
        for i in range(len(lo)):
            xs = np.arange(lo[i, 0], hi[i, 0] + 1)
            ys = np.arange(lo[i, 1], hi[i, 1] + 1)
            X, Y = np.meshgrid(xs, ys, indexing="ij")
            obj.append(np.full(X.size, i, np.int64))
            bx.append(X.ravel()); by.append(Y.ravel())
        if not obj:
            z = np.zeros(0, np.int64)
            return z, z
        return (np.concatenate(obj),
                np.concatenate(bx) * k + np.concatenate(by))

    obj_r, buck_r = expand(lo_r, hi_r)
    obj_s, buck_s = expand(lo_s, hi_s)
    order_r = np.argsort(buck_r, kind="stable")
    order_s = np.argsort(buck_s, kind="stable")
    obj_r, buck_r = obj_r[order_r], buck_r[order_r]
    obj_s, buck_s = obj_s[order_s], buck_s[order_s]

    pairs = []
    ur, idx_r = np.unique(buck_r, return_index=True)
    us, idx_s = np.unique(buck_s, return_index=True)
    common, ir, is_ = np.intersect1d(ur, us, return_indices=True)
    bounds_r = np.append(idx_r, len(buck_r))
    bounds_s = np.append(idx_s, len(buck_s))
    for c, a, b in zip(common, ir, is_):
        rs = obj_r[bounds_r[a]: bounds_r[a + 1]]
        ss = obj_s[bounds_s[b]: bounds_s[b + 1]]
        hit = mbr_intersect_mask(mbrs_r[rs], mbrs_s[ss])
        bx = np.maximum(lo_r[rs, None, 0], lo_s[None, ss, 0])
        by = np.maximum(lo_r[rs, None, 1], lo_s[None, ss, 1])
        owner = (bx * k + by) == c
        ii, jj = np.nonzero(hit & owner)
        if len(ii):
            pairs.append(np.stack([rs[ii], ss[jj]], axis=1))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(pairs, axis=0)


def mbr_join(mbrs_r: np.ndarray, mbrs_s: np.ndarray,
             grid: int | None = None, backend: str = "numpy",
             device=None) -> np.ndarray:
    """All (r, s) index pairs with intersecting MBRs. Returns [N,2] int64.

    ``grid=None`` picks the granularity adaptively; the pair set is the
    same for every grid and backend, and the order the same for ``numpy``
    and ``torch``. ``device`` (``None`` -> ``"cuda"``) matters to the
    ``torch`` backend, whose lane is read back here.
    """
    check_mbr_backend(backend)
    dev = resolve_device(device) if backend == "torch" else None
    mbrs_r, mbrs_s, k, extent = _prepare(mbrs_r, mbrs_s, grid)
    if k == 0:
        return np.zeros((0, 2), np.int64)
    if backend == "sequential":
        return _mbr_join_sequential(mbrs_r, mbrs_s, k, extent)
    ri, si, own_x, own_y, lo_r, lo_s = candidate_rows(mbrs_r, mbrs_s, k,
                                                      extent)
    if len(ri) == 0:
        return np.zeros((0, 2), np.int64)
    if backend == "torch":
        keep = pair_mask_lane(mbrs_r, mbrs_s, lo_r, lo_s, upload(ri, dev),
                              upload(si, dev), own_x, own_y,
                              dev).cpu().numpy()
    else:
        keep = _pair_mask(mbrs_r, mbrs_s, lo_r, lo_s, ri, si, own_x, own_y)
    return np.stack([ri[keep], si[keep]], axis=1)


class MBRIndex:
    """Grid-hash bucket table over one dataset's MBRs, built once and
    probed by many query batches (the join service's registered datasets).

    A probe reuses the sorted (object, bucket) table instead of expanding
    and sorting the indexed side per join. The pair set is grid and extent
    invariant (``floor`` and ``clip`` are monotone, so the reference-point
    ownership cell lies in both objects' clipped cell ranges even where a
    query MBR leaves the index extent), so ``probe(q)`` equals
    ``mbr_join(self.mbrs, q)`` as a set for any grid. ``insert`` and
    ``delete`` splice only the affected buckets' entries
    (``stats["entries_touched"]``); with the grid and extent pinned at
    construction, a patched index is array for array the one built afresh
    over the patched MBRs with the same ``grid`` and ``extent``.
    """

    def __init__(self, mbrs: np.ndarray, grid: int | None = None,
                 extent: tuple[float, float, float] | None = None):
        self.mbrs = np.asarray(mbrs, np.float64).reshape(-1, 4).copy()
        self.extent = extent or joint_extent(self.mbrs, self.mbrs)
        self.k = _resolve_grid(grid, self.mbrs, self.mbrs, self.extent)
        self.lo, hi = bucket_ranges(self.mbrs, self.k, self.extent)
        obj, buck = expand_buckets(self.lo, hi, self.k)
        order = np.argsort(buck, kind="stable")
        self._obj, self._buck = obj[order], buck[order]
        self.stats = {"inserts": 0, "deletes": 0, "probes": 0,
                      "entries_touched": 0}

    @property
    def n_entries(self) -> int:
        return len(self._buck)

    def probe(self, mbrs_q: np.ndarray, backend: str = "numpy",
              device=None) -> np.ndarray:
        """All (indexed, query) pairs with intersecting MBRs, [N, 2] int64,
        the pair set of ``mbr_join(self.mbrs, mbrs_q, backend=backend)``;
        ``numpy`` and ``torch`` (the pair test as a lane on ``device``,
        ``None`` -> ``"cuda"``, read back) in the same order."""
        check_mbr_backend(backend)
        dev = resolve_device(device) if backend == "torch" else None
        self.stats["probes"] += 1
        mbrs_q = np.asarray(mbrs_q, np.float64).reshape(-1, 4)
        if len(self.mbrs) == 0 or len(mbrs_q) == 0:
            return np.zeros((0, 2), np.int64)
        if backend == "sequential":
            return _mbr_join_sequential(self.mbrs, mbrs_q, self.k,
                                        self.extent)
        lo_q, hi_q = bucket_ranges(mbrs_q, self.k, self.extent)
        obj_q, buck_q = expand_buckets(lo_q, hi_q, self.k)
        order = np.argsort(buck_q, kind="stable")
        ri, si, own = _cross_rows(self._obj, self._buck, obj_q[order],
                                  buck_q[order])
        if len(ri) == 0:
            return np.zeros((0, 2), np.int64)
        own_x, own_y = own // self.k, own % self.k
        if backend == "torch":
            keep = pair_mask_lane(self.mbrs, mbrs_q, self.lo, lo_q,
                                  upload(ri, dev), upload(si, dev), own_x,
                                  own_y, dev).cpu().numpy()
        else:
            keep = _pair_mask(self.mbrs, mbrs_q, self.lo, lo_q, ri, si,
                              own_x, own_y)
        return np.stack([ri[keep], si[keep]], axis=1)

    def insert(self, mbr: np.ndarray) -> int:
        """Add one MBR; returns its id. Only the new object's buckets gain
        entries, each at the end of its bucket's run (the object-ascending
        order of a fresh build)."""
        mbr = np.asarray(mbr, np.float64).reshape(1, 4)
        new_id = len(self.mbrs)
        self.mbrs = np.concatenate([self.mbrs, mbr])
        lo, hi = bucket_ranges(mbr, self.k, self.extent)
        self.lo = np.concatenate([self.lo, lo])
        _, buck = expand_buckets(lo, hi, self.k)
        pos = np.searchsorted(self._buck, buck, side="right")
        self._obj = np.insert(self._obj, pos, new_id)
        self._buck = np.insert(self._buck, pos, buck)
        self.stats["inserts"] += 1
        self.stats["entries_touched"] += len(buck)
        return new_id

    def delete(self, idx: int) -> None:
        """Remove the MBR at ``idx``; later ids shift down by one (the
        numbering a fresh build over the remaining MBRs would use)."""
        if not 0 <= idx < len(self.mbrs):
            raise IndexError(f"MBRIndex.delete: id {idx} out of range "
                             f"[0, {len(self.mbrs)})")
        keep = self._obj != idx
        self.stats["entries_touched"] += int((~keep).sum())
        self._obj = self._obj[keep] - (self._obj[keep] > idx)
        self._buck = self._buck[keep]
        self.mbrs = np.delete(self.mbrs, idx, axis=0)
        self.lo = np.delete(self.lo, idx, axis=0)
        self.stats["deletes"] += 1
