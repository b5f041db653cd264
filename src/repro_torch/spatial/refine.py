"""Refinement: exact polygon intersection for the INDECISIVE candidate
pairs, batched over power-of-two buckets of the per-pair Er x Es tile size
(padding waste <= 2x, working set bounded per chunk).

Backends (``refine_backend`` on ``JoinPlan``):

* ``sequential`` — the per-pair float64 reference over the
  :mod:`~repro_torch.core.geometry` oracle;
* ``numpy`` — the vectorized host pass with CMBR edge pruning and
  branch-free containment by representative points;
* ``torch`` / ``cuda`` — the edge x edge sweep runs in float32 with a
  relative guard band, through the sweep's plain PyTorch version on any
  device (``torch``) or the CUDA kernel (``cuda``). Definite crossings come
  from the sweep; rows with none get the host closed-PiP of the
  representative points against the unpruned rings; rows that tripped the
  band are re-checked on the host in float64. Every backend is
  verdict-identical to ``sequential``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import geometry
from ..core.geometry import polygon_edges, segments_intersect, size_buckets
from ..device import check_backend_device, resolve_device
from ..kernels.refine import edges_intersect, edges_intersect_plain

__all__ = ["REFINE_BACKENDS", "check_refine_backend", "record_sweeps",
           "refine", "refine_pairs", "refine_pairs_seq"]

REFINE_BACKENDS = ("numpy", "torch", "cuda", "sequential")

#: bound on the padded [N, Er, Es] orientation working set per bucket chunk
_CHUNK_ELEMS = 1 << 20


def check_refine_backend(backend: str) -> None:
    if backend not in REFINE_BACKENDS:
        raise ValueError(f"unknown refine backend {backend!r}; "
                         f"expected one of {REFINE_BACKENDS}")


def refine_pairs_seq(R, S, pairs: np.ndarray) -> np.ndarray:
    """Per-pair float64 reference for exact polygon intersection."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    return np.asarray([
        geometry.polygons_intersect(R.verts[i], R.nverts[i],
                                    S.verts[j], S.nverts[j])
        for i, j in pairs], bool)


# ---------------------------------------------------------------------------
# numpy batched core
# ---------------------------------------------------------------------------

def _cmbr_mask(mr: np.ndarray, ms: np.ndarray, e0, e1):
    """Edges overlapping the pair's common MBR (inclusive — exact pruning:
    every crossing or touch point lies in both MBRs)."""
    cm = np.stack([np.maximum(mr[:, 0], ms[:, 0]),
                   np.maximum(mr[:, 1], ms[:, 1]),
                   np.minimum(mr[:, 2], ms[:, 2]),
                   np.minimum(mr[:, 3], ms[:, 3])], axis=1)     # [N,4]
    lo = np.minimum(e0, e1)                                     # [N,V,2]
    hi = np.maximum(e0, e1)
    return ((lo[..., 0] <= cm[:, None, 2]) & (hi[..., 0] >= cm[:, None, 0])
            & (lo[..., 1] <= cm[:, None, 3]) & (hi[..., 1] >= cm[:, None, 1]))


def _pip_batch_np(points, pmask, b0, b1, bm):
    """Closed-region PiP of per-pair point sets [N,M,2] (pmask [N,M])
    against per-pair polygons; masked points report True."""
    x = points[..., 0][:, :, None]                              # [N,M,1]
    y = points[..., 1][:, :, None]
    x0, y0 = b0[..., 0][:, None, :], b0[..., 1][:, None, :]     # [N,1,V]
    x1, y1 = b1[..., 0][:, None, :], b1[..., 1][:, None, :]
    m = bm[:, None, :]
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (y - y0) / np.where(y1 == y0, 1.0, y1 - y0)
    xint = x0 + t * (x1 - x0)
    inside = (np.sum(cond & (xint > x) & m, axis=2) % 2) == 1
    d = (x1 - x0) * (y - y0) - (y1 - y0) * (x - x0)
    onb = ((d == 0)
           & (np.minimum(x0, x1) <= x) & (x <= np.maximum(x0, x1))
           & (np.minimum(y0, y1) <= y) & (y <= np.maximum(y0, y1)) & m)
    return inside | onb.any(axis=2) | ~pmask


def _reps(D, idx: np.ndarray) -> np.ndarray:
    """Representative interior points for the selected polygons, [K,2]."""
    ui, inv = np.unique(np.asarray(idx, np.int64), return_inverse=True)
    return geometry.representative_points(D.verts[ui], D.nverts[ui])[inv]


def _compact_edges(e0, e1, mask):
    """Left-pack the masked-in edges of each row: [N,V,2] -> [N,K,2] with
    K = max kept per row; skipped when it would save under a quarter."""
    K = max(1, int(mask.sum(axis=1).max()))
    if K >= mask.shape[1] * 3 // 4:
        return e0, e1, mask
    order = np.argsort(~mask, axis=1, kind="stable")
    take = order[:, :K]
    return (np.take_along_axis(e0, take[..., None], axis=1),
            np.take_along_axis(e1, take[..., None], axis=1),
            np.take_along_axis(mask, take, axis=1))


def _sweep_pruned(a0, a1, am, b0, b1, bm, mr, ms, use_cmbr: bool):
    """Any segment crossing per row, with CMBR pruning and compaction."""
    if not use_cmbr:
        hit = segments_intersect(a0[:, :, None, :], a1[:, :, None, :],
                                 b0[:, None, :, :], b1[:, None, :, :])
        return (hit & am[:, :, None] & bm[:, None, :]).any(axis=(1, 2))
    ams = am & _cmbr_mask(mr, ms, a0, a1)
    bms = bm & _cmbr_mask(mr, ms, b0, b1)
    crossed = np.zeros(len(a0), bool)
    live = ams.any(axis=1) & bms.any(axis=1)
    if live.any():
        a0c, a1c, amc = _compact_edges(a0[live], a1[live], ams[live])
        b0c, b1c, bmc = _compact_edges(b0[live], b1[live], bms[live])
        hit = segments_intersect(a0c[:, :, None, :], a1c[:, :, None, :],
                                 b0c[:, None, :, :], b1c[:, None, :, :])
        crossed[live] = (hit & amc[:, :, None]
                         & bmc[:, None, :]).any(axis=(1, 2))
    return crossed


def _intersects_batch_np(vr, nr, vs, ns, rep_r, rep_s, mr, ms,
                         use_cmbr: bool) -> np.ndarray:
    a0, a1, am = polygon_edges(vr, nr)
    b0, b1, bm = polygon_edges(vs, ns)
    crossed = _sweep_pruned(a0, a1, am, b0, b1, bm, mr, ms, use_cmbr)
    # containment (no crossing): representative point of either side in
    # the closed other; PiP parity needs the full (unpruned) edge set
    ones = np.ones((len(vr), 1), bool)
    in_s = _pip_batch_np(rep_r[:, None, :], ones, b0, b1, bm)[:, 0]
    in_r = _pip_batch_np(rep_s[:, None, :], ones, a0, a1, am)[:, 0]
    return crossed | in_s | in_r


# ---------------------------------------------------------------------------
# float32 device sweep + float64 host escalation
# ---------------------------------------------------------------------------

_SWEEP_LOG: list | None = None


@contextlib.contextmanager
def record_sweeps():
    """Collect the device inputs ``(a0, a1, am, b0, b1, bm)`` of every edge
    sweep run inside the block, one tuple per bucket in launch order, so
    that the sweep kernel can be replayed on exactly what a join gave it."""
    global _SWEEP_LOG
    prev, _SWEEP_LOG = _SWEEP_LOG, []
    try:
        yield _SWEEP_LOG
    finally:
        _SWEEP_LOG = prev


def _sweep(backend: str, dev: torch.device, a0, a1, am, b0, b1, bm):
    """(hit, unc) numpy lanes of the float32 sweep on ``dev``."""
    t = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (a0, a1, am, b0, b1, bm))
    if _SWEEP_LOG is not None:
        _SWEEP_LOG.append(t)
    fn = edges_intersect_plain if backend == "torch" else edges_intersect
    hit, unc = fn(*t)
    return hit.cpu().numpy(), unc.cpu().numpy()


def _refine_device_intersects(backend, dev, R, S, p, vr, nr, vs, ns,
                              rep_r, rep_s, use_cmbr) -> np.ndarray:
    a0, a1, am = polygon_edges(vr, nr)
    b0, b1, bm = polygon_edges(vs, ns)
    ams, bms = am, bm
    if use_cmbr:
        ams = am & _cmbr_mask(R.mbrs[p[:, 0]], S.mbrs[p[:, 1]], a0, a1)
        bms = bm & _cmbr_mask(R.mbrs[p[:, 0]], S.mbrs[p[:, 1]], b0, b1)
    hit, unc = _sweep(backend, dev, a0, a1, ams, b0, b1, bms)
    out = hit & ~unc
    # no definite crossing: containment via host closed-PiP of the reps
    rest = ~hit & ~unc
    if rest.any():
        ones = np.ones((int(rest.sum()), 1), bool)
        in_s = _pip_batch_np(rep_r[rest][:, None, :], ones,
                             b0[rest], b1[rest], bm[rest])[:, 0]
        in_r = _pip_batch_np(rep_s[rest][:, None, :], ones,
                             a0[rest], a1[rest], am[rest])[:, 0]
        out[rest] = in_s | in_r
    # guard band tripped: full float64 re-check on host
    if unc.any():
        out[unc] = refine_pairs(R, S, p[unc], use_cmbr=use_cmbr,
                                backend="numpy")
    return out


# ---------------------------------------------------------------------------
# Bucketed public driver
# ---------------------------------------------------------------------------

def _bucketed(nvr: np.ndarray, nvs: np.ndarray, fn) -> np.ndarray:
    """Run ``fn(sel, Va, Vb) -> bool[len(sel)]`` over power-of-two buckets
    of the per-pair Er x Es tile size."""
    out = np.zeros(len(nvr), bool)
    sizes = np.maximum(nvr, 1) * np.maximum(nvs, 1)
    for sel in size_buckets(sizes, _CHUNK_ELEMS):
        Va = int(nvr[sel].max())
        Vb = int(nvs[sel].max())
        out[sel] = fn(sel, Va, Vb)
    return out


def refine_pairs(R, S, pairs: np.ndarray, use_cmbr: bool = True,
                 backend: str = "numpy", device=None) -> np.ndarray:
    """Exact intersection for candidate pairs [N,2] -> [N] bool, batched
    over vertex-count buckets on the selected backend. ``device``
    (``None`` -> ``"cuda"``) matters to the ``torch`` and ``cuda``
    backends."""
    check_refine_backend(backend)
    dev = None
    if backend in ("torch", "cuda"):
        dev = resolve_device(device)
        check_backend_device(backend, dev)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    if backend == "sequential":
        return refine_pairs_seq(R, S, pairs)
    nvr = R.nverts[pairs[:, 0]]
    nvs = S.nverts[pairs[:, 1]]
    rep_r = _reps(R, pairs[:, 0])
    rep_s = _reps(S, pairs[:, 1])

    def run(sel, Va, Vb):
        p = pairs[sel]
        vr = R.verts[:, :Va][p[:, 0]]
        vs = S.verts[:, :Vb][p[:, 1]]
        nr, ns = nvr[sel], nvs[sel]
        if dev is not None:
            return _refine_device_intersects(
                backend, dev, R, S, p, vr, nr, vs, ns, rep_r[sel],
                rep_s[sel], use_cmbr)
        return _intersects_batch_np(vr, nr, vs, ns, rep_r[sel], rep_s[sel],
                                    R.mbrs[p[:, 0]], S.mbrs[p[:, 1]],
                                    use_cmbr)

    return _bucketed(nvr, nvs, run)


def refine(R, S, pairs: np.ndarray, predicate: str = "intersects",
           backend: str = "numpy", device=None) -> np.ndarray:
    """Predicate dispatcher. Only ``intersects`` is ported; ``within``,
    ``linestring`` and ``selection`` are ROADMAP A1-A3 work."""
    if predicate in ("within", "linestring", "selection"):
        raise NotImplementedError(
            f"refinement for predicate {predicate!r} is not ported yet: "
            "ROADMAP A1-A3 (within, linestring and selection predicates)")
    if predicate != "intersects":
        raise ValueError(f"unknown predicate {predicate!r}")
    return refine_pairs(R, S, pairs, backend=backend, device=device)
