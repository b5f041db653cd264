"""Wrappers of the edge-sweep kernel (``csrc/refine.cu``).

:func:`edges_intersect_csr` takes each row's kept edges as ragged CSR,
the kernel's own layout: on the CPU it runs the plain PyTorch version
(``ref.py``); on a CUDA device it casts the endpoints to contiguous float32
and launches the kernel once over every row on the current stream, or
raises. Kernel launches are counted in ``edges_intersect_csr.launches``.
:func:`edges_intersect` takes padded edges with masks, the reference's
signature: it packs the masked-in edges into CSR on their device and calls
:func:`edges_intersect_csr`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import load
from .ref import EPS, edges_intersect_csr_plain

__all__ = ["edges_intersect", "edges_intersect_csr", "pack_edges"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = load("refine")
    fn = lib.edges_intersect_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 6 + [ctypes.c_float, ctypes.c_int64]
                       + [_P] * 3)
        fn.restype = ctypes.c_int
    return lib


def _check_side(name: str, p0, p1, off, dev) -> None:
    if p0.dim() != 2 or p0.shape[-1] != 2 or p1.shape != p0.shape:
        raise ValueError(f"{name}: edge endpoints must be [K, 2], got "
                         f"{tuple(p0.shape)} and {tuple(p1.shape)}")
    if not (p0.is_floating_point() and p1.is_floating_point()):
        raise TypeError(f"{name}: edge endpoints must be floating point")
    if off.dtype != torch.int64 or off.dim() != 1 or off.numel() < 1 \
            or not off.is_contiguous():
        raise ValueError(f"{name}: offsets must be contiguous 1-D int64 "
                         f"[B+1], got {off.dtype} {tuple(off.shape)}")
    for t in (p0, p1, off):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device}, expected {dev}")


def edges_intersect_csr(a0, a1, a_off, b0, b1, b_off, eps: float = EPS):
    """(hit [B], unc [B]) bool lanes of the float32 edge sweep with a
    relative guard band over B rows of ragged edges: row n's a edges are
    ``a0/a1[a_off[n]:a_off[n + 1]]`` ([Ka, 2] floats), its b edges
    likewise. The offsets run from 0 to Ka (Kb) without decreasing; on a
    CUDA device they are not read back to check. See
    ``ref.edges_intersect_csr_plain``."""
    dev = a0.device
    _check_side("a", a0, a1, a_off, dev)
    _check_side("b", b0, b1, b_off, dev)
    if b_off.numel() != a_off.numel():
        raise ValueError("a and b sides must have the same number of rows")
    if dev.type == "cpu":
        return edges_intersect_csr_plain(a0, a1, a_off, b0, b1, b_off, eps)
    if dev.type != "cuda":
        raise ValueError(f"edges_intersect_csr: tensors must be on the CPU "
                         f"(plain version) or a CUDA device, got {dev}")
    B = a_off.numel() - 1
    a0, a1, b0, b1 = (p.to(torch.float32).contiguous()
                      for p in (a0, a1, b0, b1))
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    unc = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return hit, unc
    rc = _lib().edges_intersect_launch(
        a0.data_ptr(), a1.data_ptr(), a_off.data_ptr(), b0.data_ptr(),
        b1.data_ptr(), b_off.data_ptr(), float(np.float32(eps)), B,
        hit.data_ptr(), unc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edges_intersect: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    edges_intersect_csr.launches += 1
    return hit, unc


edges_intersect_csr.launches = 0


def pack_edges(p0, p1, m):
    """Padded edges [B, E, 2] with a mask [B, E] as ragged CSR on their
    device: (kept p0 [K, 2], kept p1 [K, 2], offsets [B+1] int64), rows in
    order and, within a row, edges in order."""
    if p0.dim() != 3 or p0.shape[-1] != 2 or p1.shape != p0.shape:
        raise ValueError(f"edge endpoints must be [B, E, 2], got "
                         f"{tuple(p0.shape)} and {tuple(p1.shape)}")
    if m.dtype != torch.bool or tuple(m.shape) != tuple(p0.shape[:2]):
        raise ValueError(f"mask must be bool [B, E], got {m.dtype} "
                         f"{tuple(m.shape)}")
    if not p0.device == p1.device == m.device:
        raise ValueError(f"tensors on {p0.device}, {p1.device}, {m.device}")
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=m.device),
                     torch.cumsum(m.sum(dim=1), 0)])
    return p0[m], p1[m], off


def edges_intersect(a0, a1, am, b0, b1, bm, eps: float = EPS):
    """(hit [B], unc [B]) bool lanes of the float32 edge sweep over padded
    edges a0/a1 [B, Ea, 2] with mask am [B, Ea], b likewise: the masked-in
    edges packed into CSR (:func:`pack_edges`) and run by
    :func:`edges_intersect_csr`."""
    if b0.dim() != 3 or a0.dim() != 3 or b0.shape[0] != a0.shape[0]:
        raise ValueError("a and b sides must be [B, E, 2] with the same "
                         "number of rows")
    return edges_intersect_csr(*pack_edges(a0, a1, am),
                               *pack_edges(b0, b1, bm), eps)
