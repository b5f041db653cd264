"""The plain reference of the spatial join: PyTorch only, no kernel.

It works out a join's answer from the rings alone: every (r, s) pair whose
MBRs meet (for ``within``, whose r MBR lies inside the s MBR), by brute
force in blocks of R rows, then the exact predicate of each such pair,
edge against edge, in blocks of pairs. Closed-region semantics:

* ``intersects`` (and ``selection``, with the query rings as S): the
  closed rings share a point. Some edge pair meets (crossing or touching),
  or else one ring holds the other, which a vertex of either shows once
  the boundaries are known to be apart.
* ``within``: every vertex of r lies in the closed s, and no edge of r
  crosses an edge of s properly.
* ``linestring``: r is an open chain (its n vertices make n - 1 edges,
  none closing it) and s a ring. Some edge of the chain crosses or
  touches an edge of the ring, or the chain's first vertex lies in the
  closed ring. MBR candidates as for ``intersects``.

``dtype`` is the precision of every coordinate and sign test: float64 is
the reference, float32 the control one precision below it, either
throughout or in the exact test alone (``mbr_dtype`` float64). Each product
and sum is its own operation, so the float64 signs are those of strict
IEEE arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PREDICATES", "mbr_candidates", "exact", "candidates_and_answers",
           "join", "pair_keys"]

PREDICATES = ("intersects", "selection", "within", "linestring")

#: (pair, edge, edge) couples held at once by a block of the exact test
COUPLES_PER_BLOCK = 1 << 24
#: R rows against all of S at once in the brute-force MBR test
MBR_ROWS_PER_BLOCK = 1024


def _mbrs(verts: torch.Tensor, nverts: torch.Tensor) -> torch.Tensor:
    valid = (torch.arange(verts.shape[1], device=verts.device)[None, :]
             < nverts[:, None])[..., None]
    lo = torch.where(valid, verts, torch.inf).amin(dim=1)
    hi = torch.where(valid, verts, -torch.inf).amax(dim=1)
    return torch.cat([lo, hi], dim=1)


def mbr_candidates(vr, nr, vs, ns, predicate: str) -> torch.Tensor:
    """[K, 2] int64 (r, s) pairs whose closed MBRs meet, or for ``within``
    whose r MBR lies inside the s MBR; in r-major order."""
    mr, ms = _mbrs(vr, nr), _mbrs(vs, ns)
    out = []
    for r0 in range(0, len(mr), MBR_ROWS_PER_BLOCK):
        a = mr[r0:r0 + MBR_ROWS_PER_BLOCK, None, :]
        b = ms[None, :, :]
        if predicate == "within":
            keep = ((a[..., 0] >= b[..., 0]) & (a[..., 1] >= b[..., 1])
                    & (a[..., 2] <= b[..., 2]) & (a[..., 3] <= b[..., 3]))
        else:
            keep = ((a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
                    & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3]))
        ij = keep.nonzero()
        ij[:, 0] += r0
        out.append(ij)
    return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.int64,
                                                  device=vr.device)


def _orient(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _inbox(px, py, qx, qy, rx, ry):
    """r within the box of segment pq (closed)."""
    return ((torch.minimum(px, qx) <= rx) & (rx <= torch.maximum(px, qx))
            & (torch.minimum(py, qy) <= ry) & (ry <= torch.maximum(py, qy)))


def _ring(verts, nverts):
    """(starts, ends, valid) [B, V] of padded closed rings."""
    V = verts.shape[1]
    idx = torch.arange(V, device=verts.device)[None, :]
    valid = idx < nverts[:, None]
    nxt = torch.where(valid, (idx + 1) % nverts[:, None], 0)
    ends = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    return verts, ends, valid


def _chain(verts, nverts):
    """(starts, ends, valid) [B, V - 1] of padded open chains."""
    idx = torch.arange(verts.shape[1] - 1, device=verts.device)[None, :]
    return verts[:, :-1], verts[:, 1:], idx < nverts[:, None] - 1


def _crossing_parity(px, py, b0, b1, bm):
    """[B, M] bool: an odd number of ring edges crosses the ray to +x from
    each point (px, py) [B, M]."""
    x, y = px[:, :, None], py[:, :, None]
    x0, y0 = b0[..., 0][:, None, :], b0[..., 1][:, None, :]
    x1, y1 = b1[..., 0][:, None, :], b1[..., 1][:, None, :]
    cond = (y0 <= y) != (y1 <= y)
    t = (y - y0) / torch.where(y1 == y0, torch.ones_like(y1), y1 - y0)
    xint = x0 + t * (x1 - x0)
    return ((cond & (xint > x) & bm[:, None, :]).sum(dim=2) % 2) == 1


def _on_boundary(px, py, b0, b1, bm):
    x, y = px[:, :, None], py[:, :, None]
    x0, y0 = b0[..., 0][:, None, :], b0[..., 1][:, None, :]
    x1, y1 = b1[..., 0][:, None, :], b1[..., 1][:, None, :]
    on = (_orient(x0, y0, x1, y1, x, y) == 0) & _inbox(x0, y0, x1, y1, x, y)
    return (on & bm[:, None, :]).any(dim=2)


def _edge_tests(a0, a1, am, b0, b1, bm):
    """(meet [B], proper [B]): some valid edge pair meets (crossing or
    touching), and some crosses properly."""
    A0x, A0y = a0[..., 0][:, :, None], a0[..., 1][:, :, None]
    A1x, A1y = a1[..., 0][:, :, None], a1[..., 1][:, :, None]
    B0x, B0y = b0[..., 0][:, None, :], b0[..., 1][:, None, :]
    B1x, B1y = b1[..., 0][:, None, :], b1[..., 1][:, None, :]
    d1 = _orient(B0x, B0y, B1x, B1y, A0x, A0y)
    d2 = _orient(B0x, B0y, B1x, B1y, A1x, A1y)
    d3 = _orient(A0x, A0y, A1x, A1y, B0x, B0y)
    d4 = _orient(A0x, A0y, A1x, A1y, B1x, B1y)
    mask = am[:, :, None] & bm[:, None, :]
    proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
              & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0)) & mask

    touch = (((d1 == 0) & _inbox(B0x, B0y, B1x, B1y, A0x, A0y))
             | ((d2 == 0) & _inbox(B0x, B0y, B1x, B1y, A1x, A1y))
             | ((d3 == 0) & _inbox(A0x, A0y, A1x, A1y, B0x, B0y))
             | ((d4 == 0) & _inbox(A0x, A0y, A1x, A1y, B1x, B1y))) & mask
    proper_any = proper.flatten(1).any(dim=1)
    return proper_any | touch.flatten(1).any(dim=1), proper_any


def _exact_block(vr, nr, vs, ns, predicate):
    a0, a1, am = (_chain if predicate == "linestring" else _ring)(vr, nr)
    b0, b1, bm = _ring(vs, ns)
    meet, proper = _edge_tests(a0, a1, am, b0, b1, bm)
    if predicate == "linestring":
        hx, hy = vr[:, :1, 0], vr[:, :1, 1]
        head_in = (_crossing_parity(hx, hy, b0, b1, bm)
                   | _on_boundary(hx, hy, b0, b1, bm))[:, 0]
        return meet | head_in
    if predicate == "within":
        px, py = vr[..., 0], vr[..., 1]
        inside = (_crossing_parity(px, py, b0, b1, bm)
                  | _on_boundary(px, py, b0, b1, bm) | ~am)
        return inside.all(dim=1) & ~proper
    r_in_s = _crossing_parity(vr[:, :1, 0], vr[:, :1, 1], b0, b1, bm)[:, 0]
    s_in_r = _crossing_parity(vs[:, :1, 0], vs[:, :1, 1], a0, a1, am)[:, 0]
    return meet | r_in_s | s_in_r


def exact(vr, nr, vs, ns, pairs: torch.Tensor, predicate: str
          ) -> torch.Tensor:
    """[K] bool: the exact predicate of each (r, s) row of ``pairs``.
    Rows are taken in order of their vertex counts, so that a block pads
    little, and each block is cut to its own widest rings."""
    if predicate not in PREDICATES:
        raise ValueError(f"no reference for predicate {predicate!r}")
    out = torch.zeros(len(pairs), dtype=torch.bool, device=pairs.device)
    if len(pairs) == 0:
        return out
    ri, si = pairs[:, 0], pairs[:, 1]
    wr, ws = nr[ri], ns[si]
    order = torch.argsort(wr * (int(ns.max()) + 1) + ws)
    wr_o, ws_o = wr[order].tolist(), ws[order].tolist()
    start = 0
    while start < len(order):
        # grow the block while its padded couples fit the budget
        stop, va, vb = start, 0, 0
        while stop < len(order):
            nxt = min(stop + 1024, len(order))
            va2 = max(va, max(wr_o[stop:nxt]))
            vb2 = max(vb, max(ws_o[stop:nxt]))
            if (nxt - start) * va2 * vb2 > COUPLES_PER_BLOCK and stop > start:
                break
            stop, va, vb = nxt, va2, vb2
        rows = order[start:stop]
        r, s = ri[rows], si[rows]
        out[rows] = _exact_block(vr[r, :va], nr[r], vs[s, :vb], ns[s],
                                 predicate)
        start = stop
    return out


def candidates_and_answers(verts_r, nverts_r, verts_s, nverts_s,
                           predicate: str, *, device="cpu",
                           dtype=torch.float64, mbr_dtype=None):
    """(candidates [K, 2] int64, answers [K] bool) on the host: the MBR
    candidates of ``predicate`` in r-major order and the exact predicate of
    each, computed on ``device`` in ``dtype`` (the MBRs in ``mbr_dtype``,
    by default ``dtype``)."""
    dev = torch.device(device)

    def up(verts, nverts, dt):
        return (torch.as_tensor(np.asarray(verts), device=dev).to(dt),
                torch.as_tensor(np.asarray(nverts, np.int64), device=dev))

    pairs = mbr_candidates(*up(verts_r, nverts_r, mbr_dtype or dtype),
                           *up(verts_s, nverts_s, mbr_dtype or dtype),
                           predicate)
    keep = exact(*up(verts_r, nverts_r, dtype), *up(verts_s, nverts_s, dtype),
                 pairs, predicate)
    return pairs.cpu().numpy(), keep.cpu().numpy()


def join(verts_r, nverts_r, verts_s, nverts_s, predicate: str, *,
         device="cpu", dtype=torch.float64, mbr_dtype=None) -> np.ndarray:
    """[K, 2] int64 (r, s) result pairs of ``predicate``."""
    cand, keep = candidates_and_answers(verts_r, nverts_r, verts_s, nverts_s,
                                        predicate, device=device, dtype=dtype,
                                        mbr_dtype=mbr_dtype)
    return cand[keep]


def pair_keys(pairs: np.ndarray, n_s: int) -> np.ndarray:
    """Sorted int64 keys ``r * n_s + s`` of [K, 2] pairs."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    return np.sort(pairs[:, 0] * n_s + pairs[:, 1])
