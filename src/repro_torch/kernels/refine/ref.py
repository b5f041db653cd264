"""Plain PyTorch versions of the edge x edge orientation sweep.

Per pair row: the four orientations of every (a edge, b edge) couple in
float32, a relative guard band ``tol = eps * scale * (scale + mag)``, and
two lanes: ``hit`` = some proper crossing whose four orientations all clear
the band, ``unc`` = some near-zero orientation whose band-inflated boxes
overlap (the caller re-checks those rows in float64). Each operation is a
separate, correctly rounded float32 step, so the CUDA kernel, which builds
without multiply-add contraction, gives the same lanes bit for bit.

:func:`edges_intersect_csr_plain` takes each row's kept edges as ragged
CSR, as the kernel does; :func:`edges_intersect_plain` takes padded edges
with masks, the reference's signature. Both run every couple through the
same :func:`_couple_lanes`.
"""
from __future__ import annotations

import bisect

import torch

__all__ = ["edges_intersect_plain", "edges_intersect_csr_plain", "EPS"]

#: relative guard band of the float32 sweep
EPS = 1e-5

#: couples a chunk of the ragged plain version expands at once
_CHUNK_COUPLES = 1 << 22


def _orient(px, py, qx, qy, rx, ry):
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def _couple_lanes(A0x, A0y, A1x, A1y, B0x, B0y, B1x, B1y, eps):
    """(hit, unc) of broadcastable float32 couples, before any mask."""
    d1 = _orient(B0x, B0y, B1x, B1y, A0x, A0y)
    d2 = _orient(B0x, B0y, B1x, B1y, A1x, A1y)
    d3 = _orient(A0x, A0y, A1x, A1y, B0x, B0y)
    d4 = _orient(A0x, A0y, A1x, A1y, B1x, B1y)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
    # scale^2: float32 rounding of the products; scale * mag: the
    # float64 -> float32 cast of coordinates far from the origin
    scale = ((A1x - A0x).abs() + (A1y - A0y).abs()
             + (B1x - B0x).abs() + (B1y - B0y).abs())
    mag = (torch.maximum(A0x.abs(), A0y.abs())
           + torch.maximum(B0x.abs(), B0y.abs()))
    eps_t = torch.tensor(eps, dtype=torch.float32, device=A0x.device)
    tol = eps_t * scale * (scale + mag)
    near0 = ((d1.abs() <= tol) | (d2.abs() <= tol)
             | (d3.abs() <= tol) | (d4.abs() <= tol))
    boxes = ((torch.minimum(A0x, A1x) <= torch.maximum(B0x, B1x) + tol)
             & (torch.minimum(B0x, B1x) <= torch.maximum(A0x, A1x) + tol)
             & (torch.minimum(A0y, A1y) <= torch.maximum(B0y, B1y) + tol)
             & (torch.minimum(B0y, B1y) <= torch.maximum(A0y, A1y) + tol))
    return proper & ~near0, near0 & boxes


def edges_intersect_plain(a0, a1, am, b0, b1, bm, eps: float = EPS):
    """(hit [B], unc [B]) bool. a0/a1: [B, Ea, 2] floats; am [B, Ea] bool
    edge mask; b0/b1/bm likewise with Eb. Coordinates are cast to float32."""
    f32 = torch.float32
    a0, a1, b0, b1 = (t.to(f32) for t in (a0, a1, b0, b1))
    hit, unc = _couple_lanes(
        a0[:, :, None, 0], a0[:, :, None, 1], a1[:, :, None, 0],
        a1[:, :, None, 1], b0[:, None, :, 0], b0[:, None, :, 1],
        b1[:, None, :, 0], b1[:, None, :, 1], eps)
    valid = am[:, :, None] & bm[:, None, :]
    return ((hit & valid).flatten(1).any(dim=1),
            (unc & valid).flatten(1).any(dim=1))


def edges_intersect_csr_plain(a0, a1, a_off, b0, b1, b_off,
                              eps: float = EPS):
    """(hit [B], unc [B]) bool of B rows whose kept edges are ragged CSR:
    row n's a edges are ``a0/a1[a_off[n]:a_off[n + 1]]`` ([Ka, 2] floats),
    its b edges likewise; a row with no edge on either side is False/False.
    Coordinates are cast to float32. The couples are expanded row by row
    in chunks of about ``_CHUNK_COUPLES``."""
    f32 = torch.float32
    a0, a1, b0, b1 = (t.to(f32) for t in (a0, a1, b0, b1))
    dev = a0.device
    B = a_off.numel() - 1
    hit = torch.zeros(B, dtype=torch.bool, device=dev)
    unc = torch.zeros(B, dtype=torch.bool, device=dev)
    na = a_off[1:] - a_off[:-1]
    nb = b_off[1:] - b_off[:-1]
    couples = na * nb
    ends = torch.cumsum(couples, 0).tolist()
    r0 = 0
    while r0 < B:
        done = ends[r0 - 1] if r0 else 0
        # the rows whose couples end within the chunk, one row at least
        r1 = max(r0 + 1, bisect.bisect_right(ends, done + _CHUNK_COUPLES,
                                             r0))
        rows = torch.arange(r0, r1, device=dev)
        n = couples[r0:r1]
        rep = torch.repeat_interleave(rows, n)
        k = torch.arange(rep.numel(), device=dev) \
            - (torch.cumsum(n, 0) - n)[rep - r0]
        i = a_off[rep] + k // nb[rep]
        j = b_off[rep] + k % nb[rep]
        h, u = _couple_lanes(a0[i, 0], a0[i, 1], a1[i, 0], a1[i, 1],
                             b0[j, 0], b0[j, 1], b1[j, 0], b1[j, 1], eps)
        hit[rep[h]] = True
        unc[rep[u]] = True
        r0 = r1
    return hit, unc

