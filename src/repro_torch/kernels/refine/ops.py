"""Wrapper of the edge-sweep kernel (``csrc/refine.cu``).

On the CPU it runs the plain PyTorch version (``ref.py``); on a CUDA
device it casts the [B, E, 2] coordinates to contiguous float32 and
launches the kernel on the current stream, or raises. Kernel launches are
counted in ``edges_intersect.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import load
from .ref import EPS, edges_intersect_plain

__all__ = ["edges_intersect"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = load("refine")
    fn = lib.edges_intersect_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 3 + [ctypes.c_int32] + [_P] * 3
                       + [ctypes.c_int32, ctypes.c_float, ctypes.c_int64,
                          _P, _P, _P])
        fn.restype = ctypes.c_int
    return lib


def _check_side(name: str, p0, p1, m, dev) -> None:
    if p0.dim() != 3 or p0.shape[-1] != 2 or p1.shape != p0.shape:
        raise ValueError(f"{name}: edge endpoints must be [B, E, 2], got "
                         f"{tuple(p0.shape)} and {tuple(p1.shape)}")
    if not (p0.is_floating_point() and p1.is_floating_point()):
        raise TypeError(f"{name}: edge endpoints must be floating point")
    if m.dtype != torch.bool or tuple(m.shape) != tuple(p0.shape[:2]):
        raise ValueError(f"{name}: mask must be bool [B, E], got "
                         f"{m.dtype} {tuple(m.shape)}")
    for t in (p0, p1, m):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device}, expected {dev}")


def edges_intersect(a0, a1, am, b0, b1, bm, eps: float = EPS):
    """(hit [B], unc [B]) bool lanes of the float32 edge sweep with a
    relative guard band; see ``ref.edges_intersect_plain``."""
    dev = a0.device
    _check_side("a", a0, a1, am, dev)
    _check_side("b", b0, b1, bm, dev)
    if b0.shape[0] != a0.shape[0]:
        raise ValueError("a and b sides must have the same number of rows")
    if dev.type == "cpu":
        return edges_intersect_plain(a0, a1, am, b0, b1, bm, eps)
    if dev.type != "cuda":
        raise ValueError(f"edges_intersect: tensors must be on the CPU "
                         f"(plain version) or a CUDA device, got {dev}")
    B, Ea, _ = a0.shape
    Eb = b0.shape[1]
    if Ea * Eb >= 2**31:
        raise ValueError(f"edges_intersect: Ea * Eb = {Ea * Eb} edge "
                         "couples per row exceed the kernel's int32 index")
    a0, a1, b0, b1 = (p.to(torch.float32).contiguous()
                      for p in (a0, a1, b0, b1))
    am, bm = am.contiguous(), bm.contiguous()
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    unc = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return hit, unc
    rc = _lib().edges_intersect_launch(
        a0.data_ptr(), a1.data_ptr(), am.data_ptr(), Ea, b0.data_ptr(),
        b1.data_ptr(), bm.data_ptr(), Eb, float(np.float32(eps)), B,
        hit.data_ptr(), unc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edges_intersect: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    edges_intersect.launches += 1
    return hit, unc


edges_intersect.launches = 0
