"""Vectorized Hilbert-curve cell ordering (numpy on the host, torch on a
device).

The cells of the global ``2^N x 2^N`` grid are ordered along the Hilbert
curve so that sets of intersected cells compress into few intervals. Ids
stay uint64 on the host; the device interval arrays hold them as *biased
int32* (XOR with 2^31), an order-preserving bijection:
``u32 ids  a < b  <=>  biased(a) < biased(b)``. The tensor twins compute in
int64 (torch's uint32 arithmetic is incomplete); ids stay below 2^32 for
``n_order <= 16``, and the wrap of ``s - 1 - x`` keeps the low bits the
unsigned versions keep.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["xy2d", "d2xy", "xy2d_torch", "d2xy_torch", "u32_to_biased_i32",
           "biased_i32_to_u32"]


def xy2d(n_order: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Hilbert index of cells (x, y) on a 2^n_order grid. Vectorized.

    x, y: integer arrays (any shape) in [0, 2^n_order). Returns uint64 for
    headroom on host (values fit uint32 for n_order <= 16).
    """
    x = np.asarray(x, dtype=np.uint64).copy()
    y = np.asarray(y, dtype=np.uint64).copy()
    d = np.zeros_like(x, dtype=np.uint64)
    s = np.uint64(1) << np.uint64(n_order - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # rotate quadrant
        flip = ry == 0
        swapmask = flip & (rx == 1)
        x_f = np.where(swapmask, s - np.uint64(1) - x, x)
        y_f = np.where(swapmask, s - np.uint64(1) - y, y)
        x, y = np.where(flip, y_f, x_f), np.where(flip, x_f, y_f)
        s >>= np.uint64(1)
    return d


def d2xy(n_order: int, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`xy2d`. d: integer array. Returns (x, y) uint64."""
    d = np.asarray(d, dtype=np.uint64)
    t = d.copy()
    x = np.zeros_like(d, dtype=np.uint64)
    y = np.zeros_like(d, dtype=np.uint64)
    s = np.uint64(1)
    side = np.uint64(1) << np.uint64(n_order)
    while s < side:
        rx = (t // np.uint64(2)) & np.uint64(1)
        ry = (t ^ rx) & np.uint64(1)
        # rotate
        flip = ry == 0
        swapmask = flip & (rx == 1)
        x_f = np.where(swapmask, s - np.uint64(1) - x, x)
        y_f = np.where(swapmask, s - np.uint64(1) - y, y)
        x, y = np.where(flip, y_f, x_f), np.where(flip, x_f, y_f)
        x += s * rx
        y += s * ry
        t //= np.uint64(4)
        s <<= np.uint64(1)
    return x, y


def xy2d_torch(n_order: int, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Tensor twin of :func:`xy2d` on ``x``'s device; returns int64."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    d = torch.zeros_like(x)
    for k in range(n_order - 1, -1, -1):
        s = 1 << k
        rx = ((x & s) > 0).to(torch.int64)
        ry = ((y & s) > 0).to(torch.int64)
        d = d + (s * s) * ((3 * rx) ^ ry)
        flip = ry == 0
        swapmask = flip & (rx == 1)
        x_f = torch.where(swapmask, s - 1 - x, x)
        y_f = torch.where(swapmask, s - 1 - y, y)
        x, y = torch.where(flip, y_f, x_f), torch.where(flip, x_f, y_f)
    return d


def d2xy_torch(n_order: int,
               d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin of :func:`d2xy`: int64 ids -> (x, y) int64."""
    t = d.to(torch.int64)
    x = torch.zeros_like(t)
    y = torch.zeros_like(t)
    for k in range(n_order):
        s = 1 << k
        rx = (t >> 1) & 1
        ry = (t ^ rx) & 1
        flip = ry == 0
        swapmask = flip & (rx == 1)
        x_f = torch.where(swapmask, s - 1 - x, x)
        y_f = torch.where(swapmask, s - 1 - y, y)
        x, y = torch.where(flip, y_f, x_f), torch.where(flip, x_f, y_f)
        x = x + s * rx
        y = y + s * ry
        t = t >> 2
    return x, y


def u32_to_biased_i32(u: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 -> int32 (XOR 2^31). Host-side."""
    u = np.ascontiguousarray(np.asarray(u).astype(np.uint32))
    return (u ^ np.uint32(0x80000000)).view(np.int32)


def biased_i32_to_u32(i: np.ndarray) -> np.ndarray:
    """Inverse of :func:`u32_to_biased_i32`."""
    return (np.asarray(i, dtype=np.int32).view(np.uint32) ^ np.uint32(0x80000000))
