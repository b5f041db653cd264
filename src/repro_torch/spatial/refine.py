"""Refinement: exact ``intersects`` (and ``selection``), ``within`` or
``linestring`` (an open chain against a polygon) for the INDECISIVE
candidate pairs, batched over power-of-two buckets of the per-pair Er x Es
tile size (padding waste <= 2x, working set bounded per chunk).

Backends (``refine_backend`` on ``JoinPlan``):

* ``sequential`` — the per-pair float64 reference over the
  :mod:`~repro_torch.core.geometry` oracles;
* ``numpy`` — the vectorized host pass: for ``intersects`` CMBR edge
  pruning and branch-free containment by representative points; for
  ``within`` the staged MBR vertex test, closed PiP of every vertex and a
  proper-crossing sweep; for ``linestring`` a CMBR-pruned sweep of the
  chain's edges (no closing edge) and the closed PiP of its first vertex;
* ``torch`` / ``cuda`` — the edge x edge sweep runs in float32 with a
  relative guard band, through the sweep's plain PyTorch version on any
  device (``torch``) or the CUDA kernel (``cuda``), once per refine call:
  the kept edges of every bucket's rows go up as one ragged CSR (CMBR-kept
  for ``intersects``, every edge for ``within``). For ``intersects``,
  definite crossings come from the sweep, rows with none get the host
  closed-PiP of the representative points against the unpruned rings, and
  rows that tripped the band are re-checked on the host in float64, per
  bucket. For ``within`` a definite crossing means "not within"; the other
  rows take the host pass. For ``linestring`` every chain edge meets every
  ring edge, unpruned: a definite crossing is a hit, rows with none get the
  host closed-PiP of the chain's first vertex, and rows that tripped the
  band take the host pass, unpruned;
* ``device64`` — the float64 device cores (twins of the reference's jnp
  cores, its ``refine_backend="jnp"``) on each bucket's rings, gathered
  from :func:`device_geometry` and run in chunks; ``(res, unc)`` come back
  once per bucket and the ``unc`` rows are re-checked on the host in
  float64.

Every backend is verdict-identical to ``sequential``.

The fused chain refines on the device instead (:func:`fused_refine_lanes`):
float64 cores over a front-packed INDECISIVE prefix, with a guard band
whose ``unc`` rows escalate to the host once, at the end of the chain. With
the ``cuda`` backend on the card they are one launch of the hand-written
kernel (``kernels.fused_refine``, B7); otherwise the float64 PyTorch twins
of the reference's jnp cores, in chunks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.geometry import polygon_edges, segments_intersect, size_buckets
from ..device import (InputLog, StageClock, check_backend_device,
                      resolve_device, upload)
from ..kernels.fused_refine import fused_refine_rows
from ..kernels.refine import edges_intersect_csr, edges_intersect_csr_plain

__all__ = ["REFINE_BACKENDS", "check_refine_backend", "record_sweeps",
           "refine", "refine_pair", "refine_pairs", "refine_pairs_seq",
           "refine_within_pairs", "refine_within_pairs_seq",
           "refine_line_poly_pairs", "refine_line_poly_pairs_seq",
           "device_geometry", "fused_refine_lanes", "iter_pair_chunks",
           "JOIN_STAGES"]

REFINE_BACKENDS = ("numpy", "torch", "cuda", "device64", "sequential")

#: bound on the padded [N, Er, Es] orientation working set per bucket chunk
_CHUNK_ELEMS = 1 << 20


def check_refine_backend(backend: str) -> None:
    if backend in ("jnp", "pallas"):
        port = "device64" if backend == "jnp" else "cuda"
        raise ValueError(f"unknown refine backend {backend!r}, the "
                         f"reference's name; the port's is refine_backend="
                         f"{port!r}")
    if backend not in REFINE_BACKENDS:
        raise ValueError(f"unknown refine backend {backend!r}; "
                         f"expected one of {REFINE_BACKENDS}")


def refine_pair(R, i: int, S, j: int) -> bool:
    """Exact float64 intersection of polygon ``R[i]`` and ``S[j]``: the
    one-pair oracle."""
    return geometry.polygons_intersect(R.verts[i], R.nverts[i],
                                       S.verts[j], S.nverts[j])


def refine_pairs_seq(R, S, pairs: np.ndarray) -> np.ndarray:
    """Per-pair float64 reference for exact polygon intersection."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    return np.asarray([refine_pair(R, i, S, j) for i, j in pairs], bool)


def refine_within_pairs_seq(R, S, pairs: np.ndarray) -> np.ndarray:
    """Per-pair float64 reference for exact 'r within s'."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    return np.asarray([
        geometry.polygon_within(R.verts[i], R.nverts[i],
                                S.verts[j], S.nverts[j])
        for i, j in pairs], bool)


def refine_line_poly_pairs_seq(L, S, pairs: np.ndarray) -> np.ndarray:
    """Per-pair float64 reference for linestring x polygon intersection:
    an edge of the open chain meets an edge of the ring, or the chain's
    first vertex lies in the closed polygon."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    out = np.zeros(len(pairs), bool)
    for k, (li, pj) in enumerate(pairs):
        line = L.verts[li, : L.nverts[li]]
        poly = S.verts[pj, : S.nverts[pj]]
        crossed = bool(segments_intersect(
            line[:-1, None, :], line[1:, None, :],
            poly[None, :, :], np.roll(poly, -1, axis=0)[None, :, :]).any())
        out[k] = crossed or bool(
            geometry.points_in_polygon_closed(line[:1], poly)[0])
    return out


# ---------------------------------------------------------------------------
# numpy batched cores
# ---------------------------------------------------------------------------

def _chain_edges(verts: np.ndarray, nverts: np.ndarray):
    """Open-chain edges: (starts [N, V-1, 2], ends, mask). Edge i runs
    vertex i -> i + 1; the ring-closing edge of ``polygon_edges`` is
    absent."""
    mask = np.arange(verts.shape[1] - 1)[None, :] < (nverts[:, None] - 1)
    return verts[:, :-1], verts[:, 1:], mask


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


def _proper_cross_np(a0, a1, am, b0, b1, bm) -> np.ndarray:
    """Any *proper* (transversal, all orientations nonzero) edge crossing
    per row."""
    d1 = geometry._orient(b0[:, None, :, 0], b0[:, None, :, 1],
                          b1[:, None, :, 0], b1[:, None, :, 1],
                          a0[:, :, None, 0], a0[:, :, None, 1])
    d2 = geometry._orient(b0[:, None, :, 0], b0[:, None, :, 1],
                          b1[:, None, :, 0], b1[:, None, :, 1],
                          a1[:, :, None, 0], a1[:, :, None, 1])
    d3 = geometry._orient(a0[:, :, None, 0], a0[:, :, None, 1],
                          a1[:, :, None, 0], a1[:, :, None, 1],
                          b0[:, None, :, 0], b0[:, None, :, 1])
    d4 = geometry._orient(a0[:, :, None, 0], a0[:, :, None, 1],
                          a1[:, :, None, 0], a1[:, :, None, 1],
                          b1[:, None, :, 0], b1[:, None, :, 1])
    proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
              & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0))
    return (proper & am[:, :, None] & bm[:, None, :]).any(axis=(1, 2))


def _line_batch_np(vl, nl, vs, ns, mr, ms, use_cmbr: bool) -> np.ndarray:
    """Batched linestring x polygon: a (CMBR-pruned, with ``use_cmbr``)
    sweep of the chain's edges against the ring's, or the chain's first
    vertex in the closed polygon (PiP against the unpruned ring)."""
    a0, a1, am = _chain_edges(vl, nl)
    b0, b1, bm = polygon_edges(vs, ns)
    head_in = _pip_batch_np(vl[:, :1], np.ones((len(vl), 1), bool),
                            b0, b1, bm)[:, 0]
    crossed = _sweep_pruned(a0, a1, am, b0, b1, bm, mr, ms, use_cmbr)
    return crossed | head_in


def _within_batch_np(vr, nr, vs, ns, mr, ms, use_cmbr: bool) -> np.ndarray:
    """Staged 'r within s': exact MBR vertex test -> closed PiP of the
    surviving rows' vertices -> proper-crossing sweep of the all-inside
    rows only. Each stage is exact, so the staging changes no verdict."""
    N = len(vr)
    out = np.zeros(N, bool)
    pmask = np.arange(vr.shape[1])[None, :] < nr[:, None]
    x, y = vr[..., 0], vr[..., 1]
    inmbr = (((x >= ms[:, None, 0]) & (x <= ms[:, None, 2])
              & (y >= ms[:, None, 1]) & (y <= ms[:, None, 3])) | ~pmask)
    cand = inmbr.all(axis=1)          # a vertex outside MBR(s) decides False
    if not cand.any():
        return out
    b0, b1, bm = polygon_edges(vs[cand], ns[cand])
    all_in = _pip_batch_np(vr[cand], pmask[cand], b0, b1, bm).all(axis=1)
    if not all_in.any():
        return out
    keep = np.nonzero(cand)[0][all_in]
    a0, a1, am = polygon_edges(vr[keep], nr[keep])
    b0, b1, bm = b0[all_in], b1[all_in], bm[all_in]
    if use_cmbr:
        a0, a1, am = _compact_edges(
            a0, a1, am & _cmbr_mask(mr[keep], ms[keep], a0, a1))
        b0, b1, bm = _compact_edges(
            b0, b1, bm & _cmbr_mask(mr[keep], ms[keep], b0, b1))
    out[keep] = ~_proper_cross_np(a0, a1, am, b0, b1, bm)
    return out


# ---------------------------------------------------------------------------
# float32 device sweep + float64 host escalation
# ---------------------------------------------------------------------------

_SWEEPS = InputLog()


def record_sweeps():
    """Collect the device inputs ``(a0, a1, a_off, b0, b1, b_off)`` of
    every edge sweep run inside the block, one CSR tuple per sweep call
    (one per staged refine call), so that the sweep kernel can be replayed
    on exactly what a join gave it."""
    return _SWEEPS.record()


def _sweep(backend: str, dev: torch.device, csr):
    """(hit, unc) numpy lanes of the float32 sweep on ``dev`` over ragged
    CSR edges, one upload and one call."""
    t = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in csr)
    _SWEEPS.add(t)
    fn = edges_intersect_csr_plain if backend == "torch" else \
        edges_intersect_csr
    hit, unc = fn(*t)
    return hit.cpu().numpy(), unc.cpu().numpy()


def _bucket_rings(R, S, p, Va, Vb):
    """The rows' rings cut to the bucket's widths, and their counts."""
    return (R.verts[:, :Va][p[:, 0]], R.nverts[p[:, 0]],
            S.verts[:, :Vb][p[:, 1]], S.nverts[p[:, 1]])


def _kept_edges(R, S, p, Va, Vb, use_cmbr: bool, chain: bool = False):
    """The edges of one bucket's rows that the sweep needs, float32, row
    after row, a side at a time: ((a0, a1, a counts), (b0, b1, b counts))
    with the CMBR masks applied when ``use_cmbr``. With ``chain`` the R
    side is open chains, with no closing edge."""
    vr, nr, vs, ns = _bucket_rings(R, S, p, Va, Vb)
    a0, a1, am = (_chain_edges if chain else polygon_edges)(vr, nr)
    b0, b1, bm = polygon_edges(vs, ns)
    if use_cmbr:
        am = am & _cmbr_mask(R.mbrs[p[:, 0]], S.mbrs[p[:, 1]], a0, a1)
        bm = bm & _cmbr_mask(R.mbrs[p[:, 0]], S.mbrs[p[:, 1]], b0, b1)
    return tuple((p0[m].astype(np.float32), p1[m].astype(np.float32),
                  m.sum(axis=1)) for p0, p1, m in ((a0, a1, am),
                                                  (b0, b1, bm)))


def _csr(pieces):
    """Per-bucket kept edges concatenated into one ragged CSR (a0, a1,
    a_off, b0, b1, b_off), the buckets' rows in turn."""
    out = []
    for side in zip(*pieces):
        p0, p1, counts = (np.concatenate(x) for x in zip(*side))
        out += [p0, p1, np.concatenate([[0], np.cumsum(counts)])]
    return tuple(out)


def _refine_device_intersects(backend, dev, R, S, pairs, buckets, rep_r,
                              rep_s, use_cmbr) -> np.ndarray:
    """The staged float32 sweep over every bucket's rows in one call, then
    per bucket the host closed-PiP of the rows without a crossing and the
    float64 re-check of the rows that tripped the band."""
    pieces = [_kept_edges(R, S, pairs[sel], Va, Vb, use_cmbr)
              for sel, Va, Vb in buckets]
    hit, unc = _sweep(backend, dev, _csr(pieces))
    out = np.zeros(len(pairs), bool)
    pos = 0
    for sel, Va, Vb in buckets:
        h, u = hit[pos:pos + len(sel)], unc[pos:pos + len(sel)]
        pos += len(sel)
        p = pairs[sel]
        res = h & ~u
        # no definite crossing: containment via host closed-PiP of the
        # reps against the unpruned rings
        rest = ~h & ~u
        if rest.any():
            vr, nr, vs, ns = _bucket_rings(R, S, p[rest], Va, Vb)
            a0, a1, am = polygon_edges(vr, nr)
            b0, b1, bm = polygon_edges(vs, ns)
            ones = np.ones((int(rest.sum()), 1), bool)
            in_s = _pip_batch_np(rep_r[sel][rest][:, None, :], ones,
                                 b0, b1, bm)[:, 0]
            in_r = _pip_batch_np(rep_s[sel][rest][:, None, :], ones,
                                 a0, a1, am)[:, 0]
            res[rest] = in_s | in_r
        # guard band tripped: full float64 re-check on host
        if u.any():
            res[u] = refine_pairs(R, S, p[u], use_cmbr=use_cmbr,
                                  backend="numpy")
        out[sel] = res
    return out


def _refine_device_within(backend, dev, R, S, pairs,
                          buckets) -> np.ndarray:
    """The staged float32 sweep over the unpruned rings of every bucket's
    rows in one call: a definite crossing means "not within"; per bucket,
    the other rows (no crossing, or a tripped band) take the host pass."""
    pieces = [_kept_edges(R, S, pairs[sel], Va, Vb, use_cmbr=False)
              for sel, Va, Vb in buckets]
    hit, unc = _sweep(backend, dev, _csr(pieces))
    out = np.zeros(len(pairs), bool)
    pos = 0
    for sel, Va, Vb in buckets:
        h, u = hit[pos:pos + len(sel)], unc[pos:pos + len(sel)]
        pos += len(sel)
        p = pairs[sel]
        res = np.zeros(len(sel), bool)
        todo = ~h | u
        if todo.any():
            vr, nr, vs, ns = _bucket_rings(R, S, p[todo], Va, Vb)
            res[todo] = _within_batch_np(vr, nr, vs, ns, R.mbrs[p[todo, 0]],
                                         S.mbrs[p[todo, 1]], True)
        out[sel] = res
    return out


def _refine_device_line(backend, dev, L, S, pairs, buckets) -> np.ndarray:
    """The staged float32 sweep of every bucket's chain edges against its
    ring edges, unpruned, in one call; per bucket, a definite crossing is a
    hit, the rows with none get the host closed-PiP of the chain's first
    vertex, and the rows that tripped the band take the host pass,
    unpruned."""
    pieces = [_kept_edges(L, S, pairs[sel], Va, Vb, use_cmbr=False,
                          chain=True)
              for sel, Va, Vb in buckets]
    hit, unc = _sweep(backend, dev, _csr(pieces))
    out = np.zeros(len(pairs), bool)
    pos = 0
    for sel, Va, Vb in buckets:
        h, u = hit[pos:pos + len(sel)], unc[pos:pos + len(sel)]
        pos += len(sel)
        p = pairs[sel]
        res = h & ~u
        rest = ~h & ~u
        if rest.any():
            vl, _, vs, ns = _bucket_rings(L, S, p[rest], Va, Vb)
            b0, b1, bm = polygon_edges(vs, ns)
            res[rest] = _pip_batch_np(vl[:, :1],
                                      np.ones((int(rest.sum()), 1), bool),
                                      b0, b1, bm)[:, 0]
        if u.any():
            vl, nl, vs, ns = _bucket_rings(L, S, p[u], Va, Vb)
            res[u] = _line_batch_np(vl, nl, vs, ns, L.mbrs[p[u, 0]],
                                    S.mbrs[p[u, 1]], False)
        out[sel] = res
    return out


def _refine_device64(kind, dev, R, S, pairs, buckets, rep_r, rep_s,
                     use_cmbr) -> np.ndarray:
    """The float64 device cores over each bucket's rings, gathered from
    :func:`device_geometry` on ``dev`` and run in chunks bounded by
    ``_FUSED_CHUNK_BYTES``; ``(res, unc)`` come back once per bucket and
    the ``unc`` rows are re-checked on the host in float64."""
    geom_r = device_geometry(R, dev, kind="line" if kind == "line"
                             else "polygon")
    geom_s = device_geometry(S, dev)
    out = np.zeros(len(pairs), bool)
    for sel, Va, Vb in buckets:
        p = pairs[sel]
        ri = upload(np.ascontiguousarray(p[:, 0]), dev)
        si = upload(np.ascontiguousarray(p[:, 1]), dev)
        C = _chunk_rows(Va, Vb)
        lanes = [torch.stack(_core_lanes(kind, geom_r, geom_s,
                                         ri[c0:c0 + C], si[c0:c0 + C], Va,
                                         Vb))
                 for c0 in range(0, len(p), C)]
        res, unc = torch.cat(lanes, dim=1).cpu().numpy()
        if unc.any():    # borderline signs: re-run on the host in float64
            vr, nr, vs, ns = _bucket_rings(R, S, p[unc], Va, Vb)
            mr, ms = R.mbrs[p[unc, 0]], S.mbrs[p[unc, 1]]
            if kind == "within":
                res[unc] = _within_batch_np(vr, nr, vs, ns, mr, ms, True)
            elif kind == "line":
                res[unc] = _line_batch_np(vr, nr, vs, ns, mr, ms, True)
            else:
                res[unc] = _intersects_batch_np(
                    vr, nr, vs, ns, rep_r[sel][unc], rep_s[sel][unc], mr, ms,
                    use_cmbr)
        out[sel] = res
    return out


# ---------------------------------------------------------------------------
# Bucketed public drivers
# ---------------------------------------------------------------------------

def _buckets(nvr: np.ndarray, nvs: np.ndarray):
    """[(sel, Va, Vb)]: power-of-two buckets of the per-pair Er x Es tile
    size, each with its widest rings."""
    sizes = np.maximum(nvr, 1) * np.maximum(nvs, 1)
    return [(sel, int(nvr[sel].max()), int(nvs[sel].max()))
            for sel in size_buckets(sizes, _CHUNK_ELEMS)]


def _device_of(backend: str, device):
    """The device a backend runs on: ``None`` for the host backends, else
    ``device`` resolved (``None`` -> ``"cuda"``, which raises without a
    GPU) and checked against the backend."""
    if backend not in ("torch", "cuda", "device64"):
        return None
    dev = resolve_device(device)
    check_backend_device(backend, dev)
    return dev


def iter_pair_chunks(R, S, pairs: np.ndarray):
    """(sel, p, vr, nr, vs, ns) for each chunk of ``pairs`` in the
    power-of-two buckets of the per-pair Er x Es tile size: the bucketing
    of the bucketed refines here, shared with ``spatial/distributed.py``."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    nvr = R.nverts[pairs[:, 0]]
    nvs = S.nverts[pairs[:, 1]]
    for sel, Va, Vb in _buckets(nvr, nvs):
        p = pairs[sel]
        yield (sel, p, R.verts[:, :Va][p[:, 0]], nvr[sel],
               S.verts[:, :Vb][p[:, 1]], nvs[sel])


def refine_pairs(R, S, pairs: np.ndarray, use_cmbr: bool = True,
                 backend: str = "numpy", device=None) -> np.ndarray:
    """Exact intersection for candidate pairs [N,2] -> [N] bool, batched
    over vertex-count buckets on the selected backend: ``numpy`` runs each
    bucket on the host; ``torch`` and ``cuda`` run every bucket's float32
    sweep in one call on ``device`` (``None`` -> ``"cuda"``) and the
    rest per bucket on the host; ``device64`` runs the float64 device
    core per bucket on ``device``."""
    check_refine_backend(backend)
    dev = _device_of(backend, device)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    if backend == "sequential":
        return refine_pairs_seq(R, S, pairs)
    nvr = R.nverts[pairs[:, 0]]
    nvs = S.nverts[pairs[:, 1]]
    rep_r = _reps(R, pairs[:, 0])
    rep_s = _reps(S, pairs[:, 1])
    buckets = _buckets(nvr, nvs)
    if backend == "device64":
        return _refine_device64("intersects", dev, R, S, pairs, buckets,
                                rep_r, rep_s, use_cmbr)
    if dev is not None:
        return _refine_device_intersects(backend, dev, R, S, pairs, buckets,
                                         rep_r, rep_s, use_cmbr)
    out = np.zeros(len(pairs), bool)
    for sel, Va, Vb in buckets:
        p = pairs[sel]
        vr, nr, vs, ns = _bucket_rings(R, S, p, Va, Vb)
        out[sel] = _intersects_batch_np(vr, nr, vs, ns, rep_r[sel],
                                        rep_s[sel], R.mbrs[p[:, 0]],
                                        S.mbrs[p[:, 1]], use_cmbr)
    return out


def refine_within_pairs(R, S, pairs: np.ndarray, backend: str = "numpy",
                        device=None) -> np.ndarray:
    """Exact 'r within s' for candidate pairs [N,2] -> [N] bool, batched
    over vertex-count buckets on the selected backend (as
    :func:`refine_pairs`)."""
    check_refine_backend(backend)
    dev = _device_of(backend, device)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    if backend == "sequential":
        return refine_within_pairs_seq(R, S, pairs)
    buckets = _buckets(R.nverts[pairs[:, 0]], S.nverts[pairs[:, 1]])
    if backend == "device64":
        return _refine_device64("within", dev, R, S, pairs, buckets, None,
                                None, True)
    if dev is not None:
        return _refine_device_within(backend, dev, R, S, pairs, buckets)
    out = np.zeros(len(pairs), bool)
    for sel, Va, Vb in buckets:
        p = pairs[sel]
        vr, nr, vs, ns = _bucket_rings(R, S, p, Va, Vb)
        out[sel] = _within_batch_np(vr, nr, vs, ns, R.mbrs[p[:, 0]],
                                    S.mbrs[p[:, 1]], True)
    return out


def refine_line_poly_pairs(L, S, pairs: np.ndarray, backend: str = "numpy",
                           device=None) -> np.ndarray:
    """Exact linestring x polygon intersection for (chain, polygon) pairs
    [N,2] -> [N] bool, batched over vertex-count buckets on the selected
    backend: ``numpy`` runs each bucket on the host, CMBR-pruned;
    ``torch`` and ``cuda`` run every bucket's float32 sweep, unpruned, in
    one call on ``device`` (``None`` -> ``"cuda"``) and the rest per
    bucket on the host; ``device64`` runs the float64 device core per
    bucket on ``device``."""
    check_refine_backend(backend)
    dev = _device_of(backend, device)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return np.zeros(0, bool)
    if backend == "sequential":
        return refine_line_poly_pairs_seq(L, S, pairs)
    buckets = _buckets(L.nverts[pairs[:, 0]], S.nverts[pairs[:, 1]])
    if backend == "device64":
        return _refine_device64("line", dev, L, S, pairs, buckets, None,
                                None, True)
    if dev is not None:
        return _refine_device_line(backend, dev, L, S, pairs, buckets)
    out = np.zeros(len(pairs), bool)
    for sel, Va, Vb in buckets:
        p = pairs[sel]
        vl, nl, vs, ns = _bucket_rings(L, S, p, Va, Vb)
        out[sel] = _line_batch_np(vl, nl, vs, ns, L.mbrs[p[:, 0]],
                                  S.mbrs[p[:, 1]], True)
    return out


def refine(R, S, pairs: np.ndarray, predicate: str = "intersects",
           backend: str = "numpy", device=None) -> np.ndarray:
    """Predicate dispatcher: ``intersects`` and ``selection`` (the query
    polygons as S) refine by intersection, ``within`` by containment,
    ``linestring`` (the chains as R) by chain x polygon intersection."""
    if predicate == "within":
        return refine_within_pairs(R, S, pairs, backend=backend,
                                   device=device)
    if predicate == "linestring":
        return refine_line_poly_pairs(R, S, pairs, backend=backend,
                                      device=device)
    if predicate not in ("intersects", "selection"):
        raise ValueError(f"unknown predicate {predicate!r}; expected one of "
                         "('intersects', 'within', 'linestring', "
                         "'selection')")
    return refine_pairs(R, S, pairs, backend=backend, device=device)


# ---------------------------------------------------------------------------
# float64 device cores of the fused chain and the staged ``device64``
# backend (twins of the reference's jnp cores). Every product and sum is
# its own eager op, so nothing contracts into an FMA and the signs are
# those of strict IEEE numpy; the guard band stays all the same, so a sign
# the reference's compiled cores may flip is flagged ``unc`` and re-checked
# on the host in float64.
# ---------------------------------------------------------------------------

#: relative guard half-width of the float64 sign tests
_EPS_GUARD = 2.0 ** -44


def _orient_unc(ax, ay, bx, by, cx, cy):
    """(orientation, borderline). Borderline flags magnitudes within the
    guard band of zero; when either product is exactly zero the sign is
    exact under any rounding, so axis-aligned geometry is exempt."""
    p1 = (bx - ax) * (cy - ay)
    p2 = (by - ay) * (cx - ax)
    d = p1 - p2
    unc = ((d.abs() <= _EPS_GUARD * (p1.abs() + p2.abs()))
           & (p1 != 0) & (p2 != 0))
    return d, unc


def _edges(verts, nverts):
    """(starts, ends, valid) of padded rings [N, V, 2] on their device;
    padded slots degenerate to the first vertex and are masked out."""
    V = verts.shape[1]
    idx = torch.arange(V, device=verts.device)[None, :]
    valid = idx < nverts[:, None]
    nxt = torch.where(valid, (idx + 1) % torch.clamp(nverts[:, None], min=1),
                      0)
    starts = torch.where(valid[..., None], verts, verts[:, :1, :])
    ends = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    ends = torch.where(valid[..., None], ends, verts[:, :1, :])
    return starts, ends, valid


def _quad_orients(a0, a1, b0, b1):
    d1, u1 = _orient_unc(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1],
                         a0[..., 0], a0[..., 1])
    d2, u2 = _orient_unc(b0[..., 0], b0[..., 1], b1[..., 0], b1[..., 1],
                         a1[..., 0], a1[..., 1])
    d3, u3 = _orient_unc(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1],
                         b0[..., 0], b0[..., 1])
    d4, u4 = _orient_unc(a0[..., 0], a0[..., 1], a1[..., 0], a1[..., 1],
                         b1[..., 0], b1[..., 1])
    return (d1, d2, d3, d4), (u1 | u2 | u3 | u4)


def _on_seg(p0, p1, r):
    return ((torch.minimum(p0[..., 0], p1[..., 0]) <= r[..., 0])
            & (r[..., 0] <= torch.maximum(p0[..., 0], p1[..., 0]))
            & (torch.minimum(p0[..., 1], p1[..., 1]) <= r[..., 1])
            & (r[..., 1] <= torch.maximum(p0[..., 1], p1[..., 1])))


def _segments_intersect(a0, a1, b0, b1):
    """(hit, borderline) of broadcastable segment pairs."""
    (d1, d2, d3, d4), unc = _quad_orients(a0, a1, b0, b1)
    proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
              & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0))
    touch = (((d1 == 0) & _on_seg(b0, b1, a0))
             | ((d2 == 0) & _on_seg(b0, b1, a1))
             | ((d3 == 0) & _on_seg(a0, a1, b0))
             | ((d4 == 0) & _on_seg(a0, a1, b1)))
    return proper | touch, unc


def _pip_batch(points, pmask, b0, b1, bm):
    """(inside_or_on [N, M], borderline [N, M]): closed-region PiP of
    per-row point sets against per-row rings, with the guard band."""
    x = points[..., 0][:, :, None]
    y = points[..., 1][:, :, None]
    x0, y0 = b0[..., 0][:, None, :], b0[..., 1][:, None, :]
    x1, y1 = b1[..., 0][:, None, :], b1[..., 1][:, None, :]
    m = bm[:, None, :]
    cond = (y0 <= y) != (y1 <= y)
    step = ((y - y0) / torch.where(y1 == y0, 1.0, y1 - y0)) * (x1 - x0)
    xint = x0 + step
    # step == 0 exactly (vertical edges) makes the add exact
    near = (((xint - x).abs()
             <= _EPS_GUARD * (x0.abs() + step.abs() + x.abs()))
            & (step != 0))
    inside = ((cond & (xint > x) & m).sum(dim=2) % 2) == 1
    d, du = _orient_unc(x0, y0, x1, y1, x, y)
    inbox = ((torch.minimum(x0, x1) <= x) & (x <= torch.maximum(x0, x1))
             & (torch.minimum(y0, y1) <= y) & (y <= torch.maximum(y0, y1))
             & m)
    onb = (d == 0) & inbox
    unc = ((cond & near & m) | (du & inbox)).any(dim=2) & pmask
    return inside | onb.any(dim=2) | ~pmask, unc


def _intersects_impl(vr, nr, vs, ns, rep_r, rep_s):
    """(verdicts [N], uncertain [N]) of batched ``intersects`` on the rows'
    device: an edge crossing or touch, or a representative point of either
    side in the closed other. Uncertain rows had a borderline sign that a
    True did not outweigh, and must be re-checked on the host."""
    a0, a1, am = _edges(vr, nr)
    b0, b1, bm = _edges(vs, ns)
    hit, hunc = _segments_intersect(a0[:, :, None, :], a1[:, :, None, :],
                                    b0[:, None, :, :], b1[:, None, :, :])
    pair_mask = am[:, :, None] & bm[:, None, :]
    crossed = (hit & pair_mask).any(dim=2).any(dim=1)
    ones = torch.ones((vr.shape[0], 1), dtype=torch.bool, device=vr.device)
    in_s, u1 = _pip_batch(rep_r[:, None, :], ones, b0, b1, bm)
    in_r, u2 = _pip_batch(rep_s[:, None, :], ones, a0, a1, am)
    unc = (hunc & pair_mask).any(dim=2).any(dim=1) | u1[:, 0] | u2[:, 0]
    # a True reached through a non-borderline element holds on the host too
    definite_true = ((hit & ~hunc & pair_mask).any(dim=2).any(dim=1)
                     | (in_s[:, 0] & ~u1[:, 0]) | (in_r[:, 0] & ~u2[:, 0]))
    return crossed | in_s[:, 0] | in_r[:, 0], unc & ~definite_true


def _line_impl(vl, nl, vs, ns):
    """(verdicts [N], uncertain [N]) of batched linestring x polygon on the
    rows' device: a chain edge crossing or touching a ring edge, or the
    chain's first vertex in the closed polygon. A True reached through a
    non-borderline element is definite; other rows with a borderline sign
    are uncertain and must be re-checked on the host."""
    mask = torch.arange(vl.shape[1] - 1, device=vl.device)[None, :] \
        < (nl[:, None] - 1)
    a0, a1 = vl[:, :-1], vl[:, 1:]
    b0, b1, bm = _edges(vs, ns)
    hit, hunc = _segments_intersect(a0[:, :, None, :], a1[:, :, None, :],
                                    b0[:, None, :, :], b1[:, None, :, :])
    pair_mask = mask[:, :, None] & bm[:, None, :]
    crossed = (hit & pair_mask).any(dim=2).any(dim=1)
    ones = torch.ones((vl.shape[0], 1), dtype=torch.bool, device=vl.device)
    head_in, hu = _pip_batch(vl[:, :1], ones, b0, b1, bm)
    unc = (hunc & pair_mask).any(dim=2).any(dim=1) | hu[:, 0]
    definite_true = ((hit & ~hunc & pair_mask).any(dim=2).any(dim=1)
                     | (head_in[:, 0] & ~hu[:, 0]))
    return crossed | head_in[:, 0], unc & ~definite_true


def _within_impl(vr, nr, vs, ns):
    """(verdicts [N], uncertain [N]) of batched 'r within s' on the rows'
    device: every vertex of r in the closed s and no proper crossing.
    Uncertain rows had a borderline PiP sign, or a borderline orientation
    in a row whose vertices all read inside, and must be re-checked on the
    host."""
    a0, a1, am = _edges(vr, nr)
    b0, b1, bm = _edges(vs, ns)
    pmask = torch.arange(vr.shape[1], device=vr.device)[None, :] \
        < nr[:, None]
    in_b, pip_unc = _pip_batch(vr, pmask, b0, b1, bm)
    all_in = in_b.all(dim=1)
    (d1, d2, d3, d4), ounc = _quad_orients(
        a0[:, :, None, :], a1[:, :, None, :],
        b0[:, None, :, :], b1[:, None, :, :])
    proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
              & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0))
    pair_mask = am[:, :, None] & bm[:, None, :]
    proper = (proper & pair_mask).any(dim=2).any(dim=1)
    # a certainly-not-all-inside row is False whatever the sweep says
    unc = pip_unc.any(dim=1) | (
        all_in & (ounc & pair_mask).any(dim=2).any(dim=1))
    return all_in & ~proper, unc


def device_geometry(D, device, kind: str = "polygon") -> dict:
    """float64 device copies of a dataset's rings (``kind="polygon"``) or
    open chains (``kind="line"``), cut to the widest, and their vertex
    counts (int64); for rings also one representative interior point per
    object. Uploaded once per device and kind and cached on the dataset,
    keyed on the identity of its ``verts`` array (a patched dataset swaps
    the array, which invalidates the copy)."""
    dev = torch.device(device)
    cache = D.__dict__.setdefault("_device_geom", {})
    key = (str(dev), kind)
    hit = cache.get(key)
    if hit is not None and hit[0] == id(D.verts):
        return hit[1]
    nverts = np.asarray(D.nverts, np.int64)
    V = max(1, int(nverts.max(initial=1)))
    verts = np.ascontiguousarray(np.asarray(D.verts, np.float64)[:, :V])
    geom = {"verts": torch.from_numpy(verts).to(dev),
            "nverts": torch.from_numpy(nverts).to(dev)}
    if kind != "line":
        reps = geometry.representative_points(D.verts, D.nverts)
        geom["reps"] = torch.from_numpy(
            np.ascontiguousarray(reps, np.float64)).to(dev)
    cache[key] = (id(D.verts), geom)
    return geom


#: device bytes budgeted for one chunk's [C, Va, Vb] temporaries in the
#: fused refine
_FUSED_CHUNK_BYTES = 2 << 30
#: the fused chain's stages, spans ``join.*`` under a profiler: ``upload``
#: (the copies made before the chain), ``mbr`` (children ``candidates``,
#: ``upload``), ``filter``, ``refine`` (``compact``, then ``kernel`` or
#: ``chunks``), ``sync`` (``gather``, ``recheck``) and ``collect`` (the
#: counts and pairs after the sync); and its counts ``refine_chunks``
#: (on the kernel path a device tensor), ``refine_chunk_rows`` and
#: ``refine_kernel_launches``. It lives here,
#: below ``fused.py``, because ``fused_refine_lanes`` times its refine in
#: it; ``fused.execute_fused`` records each join's into ``JoinStats``.
JOIN_STAGES = StageClock("join")

#: bytes of eager temporaries per (a edge, b edge) couple, counted from the
#: float64 and bool [C, Va, Vb] tensors alive at once in _segments_intersect
_BYTES_PER_COUPLE = 160


def _chunk_rows(Va: int, Vb: int) -> int:
    """Rows a chunk of [C, Va, Vb] core temporaries may hold."""
    return max(1, _FUSED_CHUNK_BYTES // (Va * Vb * _BYTES_PER_COUPLE))


def _core_lanes(kind, geom_r, geom_s, rr, ss, Va, Vb):
    """(verdicts, uncertain) of the float64 core of ``kind`` over rows
    (rr[n], ss[n]) of the device geometries, their rings cut to Va and Vb
    vertices."""
    args = (geom_r["verts"][rr, :Va], geom_r["nverts"][rr],
            geom_s["verts"][ss, :Vb], geom_s["nverts"][ss])
    if kind == "within":
        return _within_impl(*args)
    if kind == "line":
        return _line_impl(*args)
    return _intersects_impl(*args, geom_r["reps"][rr], geom_s["reps"][ss])


def fused_refine_lanes(R, S, ri_dev, si_dev, perm, count, device,
                       predicate: str = "intersects", kernel: bool = False):
    """Device (res, unc) lanes [N] over a front-packed INDECISIVE prefix.

    ``perm``/``count`` come from ``compact_mask`` over the INDECISIVE lane
    of the frame ``ri_dev``/``si_dev``; the lanes are in the packed order
    (scatter them back through ``perm``), rows past ``count`` False.
    ``predicate`` picks the core: ``intersects`` and ``selection`` refine
    by intersection, ``within`` by containment, ``linestring`` (R the
    chains) by chain x polygon intersection. ``count`` stays on the device.

    With ``kernel`` on a CUDA device the lanes come from one launch of the
    B7 kernel (``kernels.fused_refine``), which reads ``count`` on the card
    and walks only the live rows, each over its own rings: the stage
    ``refine.kernel`` of ``JOIN_STAGES``, which counts the wrapper's
    launches (``refine_kernel_launches``) and chunks of one row, its unit
    (``refine_chunk_rows`` 1), as many as the kernel counted on the card
    (``refine_chunks``, a device tensor that the chain's gather reads).
    Otherwise (the CPU, or the ``torch`` backend) the plain version:
    the eager cores over chunks of the whole frame, rows padded to the
    widest ring and masked past ``count``, as the reference's ``take``
    does; the reference also skips the dead chunks, which needs the count
    on the host. Chunking is row-wise, so the chunk size changes no
    verdict. The loop is the stage ``refine.chunks``, which counts the
    chunks it walks (``refine_chunks``) and their rows
    (``refine_chunk_rows``). Both give the same lanes bit for bit.
    """
    kind = {"intersects": "intersects", "selection": "intersects",
            "within": "within", "linestring": "line"}.get(predicate)
    if kind is None:
        raise ValueError(f"no fused refine core for predicate {predicate!r}")
    dev = torch.device(device)
    geom_r = device_geometry(R, dev, kind="line" if kind == "line"
                             else "polygon")
    geom_s = device_geometry(S, dev)
    N = perm.numel()
    if kernel and dev.type != "cpu":
        n0 = fused_refine_rows.launches
        with JOIN_STAGES.stage("refine.kernel"):
            res, unc, refined = fused_refine_rows(kind, geom_r, geom_s,
                                                  ri_dev, si_dev, perm, count)
        JOIN_STAGES.count("refine_kernel_launches",
                          fused_refine_rows.launches - n0)
        JOIN_STAGES.count("refine_chunks", refined)
        JOIN_STAGES.count("refine_chunk_rows", 1)
        return res, unc
    res = torch.zeros(N, dtype=torch.bool, device=dev)
    unc = torch.zeros(N, dtype=torch.bool, device=dev)
    Va, Vb = geom_r["verts"].shape[1], geom_s["verts"].shape[1]
    C = _chunk_rows(Va, Vb)
    with JOIN_STAGES.stage("refine.chunks"):
        for c0 in range(0, N, C):
            idx = perm[c0:c0 + C].to(torch.int64)
            take = torch.arange(c0, c0 + idx.numel(), device=dev) < count
            v, u = _core_lanes(kind, geom_r, geom_s, ri_dev[idx],
                               si_dev[idx], Va, Vb)
            res[c0:c0 + idx.numel()] = v & take
            unc[c0:c0 + idx.numel()] = u & take
            JOIN_STAGES.count("refine_chunks")
    JOIN_STAGES.count("refine_chunk_rows", C)
    return res, unc
