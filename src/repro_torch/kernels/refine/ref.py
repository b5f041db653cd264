"""Plain PyTorch version of the edge x edge orientation sweep.

Per pair row: the four orientations of every (a edge, b edge) couple in
float32, a relative guard band ``tol = eps * scale * (scale + mag)``, and
two lanes: ``hit`` = some proper crossing whose four orientations all clear
the band, ``unc`` = some near-zero orientation whose band-inflated boxes
overlap (the caller re-checks those rows in float64). Each operation is a
separate, correctly rounded float32 step, so the CUDA kernel, which builds
without multiply-add contraction, gives the same lanes bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["edges_intersect_plain", "EPS"]

#: relative guard band of the float32 sweep
EPS = 1e-5


def _orient(px, py, qx, qy, rx, ry):
    return (qx - px) * (ry - py) - (qy - py) * (rx - px)


def edges_intersect_plain(a0, a1, am, b0, b1, bm, eps: float = EPS):
    """(hit [B], unc [B]) bool. a0/a1: [B, Ea, 2] floats; am [B, Ea] bool
    edge mask; b0/b1/bm likewise with Eb. Coordinates are cast to float32."""
    f32 = torch.float32
    a0, a1, b0, b1 = (t.to(f32) for t in (a0, a1, b0, b1))
    A0x, A0y = a0[:, :, None, 0], a0[:, :, None, 1]
    A1x, A1y = a1[:, :, None, 0], a1[:, :, None, 1]
    B0x, B0y = b0[:, None, :, 0], b0[:, None, :, 1]
    B1x, B1y = b1[:, None, :, 0], b1[:, None, :, 1]

    d1 = _orient(B0x, B0y, B1x, B1y, A0x, A0y)
    d2 = _orient(B0x, B0y, B1x, B1y, A1x, A1y)
    d3 = _orient(A0x, A0y, A1x, A1y, B0x, B0y)
    d4 = _orient(A0x, A0y, A1x, A1y, B1x, B1y)

    valid = am[:, :, None] & bm[:, None, :]
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
    # scale^2: float32 rounding of the products; scale * mag: the
    # float64 -> float32 cast of coordinates far from the origin
    scale = ((A1x - A0x).abs() + (A1y - A0y).abs()
             + (B1x - B0x).abs() + (B1y - B0y).abs())
    mag = (torch.maximum(A0x.abs(), A0y.abs())
           + torch.maximum(B0x.abs(), B0y.abs()))
    eps_t = torch.tensor(eps, dtype=f32, device=a0.device)
    tol = eps_t * scale * (scale + mag)
    near0 = ((d1.abs() <= tol) | (d2.abs() <= tol)
             | (d3.abs() <= tol) | (d4.abs() <= tol))
    boxes = ((torch.minimum(A0x, A1x) <= torch.maximum(B0x, B1x) + tol)
             & (torch.minimum(B0x, B1x) <= torch.maximum(A0x, A1x) + tol)
             & (torch.minimum(A0y, A1y) <= torch.maximum(B0y, B1y) + tol)
             & (torch.minimum(B0y, B1y) <= torch.maximum(A0y, A1y) + tol))
    hit = (proper & ~near0 & valid).flatten(1).any(dim=1)
    unc = (near0 & boxes & valid).flatten(1).any(dim=1)
    return hit, unc
