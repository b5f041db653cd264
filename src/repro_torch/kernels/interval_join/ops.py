"""Wrappers of the interval-join kernels (``csrc/interval_join.cu``).

A wrapper checks its tensors, then dispatches on their device: on the CPU
it runs the plain PyTorch version (``ref.py``); on a CUDA device it
launches the kernel on the current stream, or raises. There is no fallback
from one to the other. Each wrapper counts its kernel launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .ref import (CSRLists, april_trichotomy_plain,
                  interval_overlap_plain)

__all__ = ["april_trichotomy", "interval_overlap"]

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = load("interval_join")
    if lib.april_trichotomy_launch.argtypes is None:
        lib.april_trichotomy_launch.argtypes = (
            [_P] * 12 + [_P, _P, ctypes.c_int64, _P, _P])
        lib.april_trichotomy_launch.restype = ctypes.c_int
        lib.interval_overlap_launch.argtypes = (
            [_P] * 6 + [_P, _P, ctypes.c_int64, _P, _P])
        lib.interval_overlap_launch.restype = ctypes.c_int
    return lib


def _check_lists(name: str, L: CSRLists, dev: torch.device) -> None:
    off, s, l = L
    if off.dtype != torch.int64 or s.dtype != torch.int32 \
            or l.dtype != torch.int32:
        raise TypeError(f"{name}: off must be int64 and starts/lasts int32, "
                        f"got {off.dtype}/{s.dtype}/{l.dtype}")
    if off.dim() != 1 or s.dim() != 1 or s.shape != l.shape \
            or off.numel() < 1:
        raise ValueError(f"{name}: expected 1-D off [P+1] and equal-length "
                         f"1-D starts/lasts, got {tuple(off.shape)}, "
                         f"{tuple(s.shape)}, {tuple(l.shape)}")
    for t in L:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device}, rows on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_rows(idx: torch.Tensor, L: CSRLists, name: str) -> None:
    """Row indices are contiguous 1-D int64 in [0, P). On the CPU the range
    raises ``IndexError``; on a CUDA device it is a device-side assert, so
    the check reads nothing back to the host (the callers range-check their
    host frames in numpy before upload)."""
    if idx.dtype != torch.int64 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: row indices must be contiguous 1-D int64")
    if idx.numel():
        lo, hi = torch.aminmax(idx)
        n = L.off.numel() - 1
        if idx.device.type == "cuda":
            torch._assert_async((lo >= 0) & (hi < n))
        elif int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"{name}: row index out of range [0, {n})")


def _cuda_device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU (plain "
                         f"version) or a CUDA device, got {dev}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {rc})")


def april_trichotomy(xa: CSRLists, xf: CSRLists, ya: CSRLists,
                     yf: CSRLists, ri: torch.Tensor,
                     si: torch.Tensor) -> torch.Tensor:
    """[N] int8 APRIL verdicts (0 TRUE_NEG / 1 TRUE_HIT / 2 INDECISIVE) of
    pair rows (ri[n], si[n]): A(r) x A(s) empty -> 0, else A(r) x F(s) or
    F(r) x A(s) overlapping -> 1, else 2."""
    dev = ri.device
    for name, L in (("xa", xa), ("xf", xf), ("ya", ya), ("yf", yf)):
        _check_lists(name, L, dev)
    _check_rows(ri, xa, "ri")
    _check_rows(si, ya, "si")
    if xf.off.numel() != xa.off.numel() or yf.off.numel() != ya.off.numel():
        raise ValueError("A and F lists of one side must have equal rows")
    if ri.shape != si.shape:
        raise ValueError("ri and si must have the same length")
    if dev.type == "cpu":
        return april_trichotomy_plain(xa, xf, ya, yf, ri, si)
    _cuda_device(dev, "april_trichotomy")
    n = ri.numel()
    out = torch.empty(n, dtype=torch.int8, device=dev)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for L in (xa, xf, ya, yf) for t in L]
    rc = _lib().april_trichotomy_launch(
        *ptrs, ri.data_ptr(), si.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "april_trichotomy")
    april_trichotomy.launches += 1
    return out


april_trichotomy.launches = 0


def interval_overlap(x: CSRLists, y: CSRLists, xi: torch.Tensor,
                     yi: torch.Tensor) -> torch.Tensor:
    """[N] bool: does list ``xi[n]`` of X overlap list ``yi[n]`` of Y?"""
    dev = xi.device
    _check_lists("x", x, dev)
    _check_lists("y", y, dev)
    _check_rows(xi, x, "xi")
    _check_rows(yi, y, "yi")
    if xi.shape != yi.shape:
        raise ValueError("xi and yi must have the same length")
    if dev.type == "cpu":
        return interval_overlap_plain(x, y, xi, yi)
    _cuda_device(dev, "interval_overlap")
    n = xi.numel()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for L in (x, y) for t in L]
    rc = _lib().interval_overlap_launch(
        *ptrs, xi.data_ptr(), yi.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "interval_overlap")
    interval_overlap.launches += 1
    return out


interval_overlap.launches = 0
