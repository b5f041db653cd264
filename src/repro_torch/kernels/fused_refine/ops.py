"""Wrapper of the fused refine kernel (``csrc/fused_refine.cu``, B7).

:func:`fused_refine_rows` takes the compaction's ``perm``/``count`` over a
pair frame ``ri``/``si`` and the cached device geometry of both layers
(``spatial.refine.device_geometry``), checks them, and makes one launch on
the current stream of a persistent grid (the card's resident blocks, from
the occupancy query, cached per device). ``count`` stays on the device:
the kernel reads it, so nothing is read back and nothing waits; the rows
it refined come back as a device count too. It takes CUDA tensors only;
the plain version, for the CPU and the ``torch`` backend, is the eager
chunk loop of ``spatial.refine.fused_refine_lanes``.
Kernel launches are counted in ``fused_refine_rows.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load

__all__ = ["KINDS", "fused_refine_rows"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64

#: the cores the kernel serves, by their number in the kernel
KINDS = {"intersects": 0, "within": 1, "line": 2}
#: rows a block takes at a time (one a warp)
ROWS_PER_BLOCK = 4

#: device index -> the most blocks resident at once
_MAX_BLOCKS: dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    lib = load("fused_refine")
    if lib.fused_refine_launch.argtypes is None:
        lib.fused_refine_max_blocks.argtypes = [ctypes.c_int]
        lib.fused_refine_max_blocks.restype = ctypes.c_int
        lib.fused_refine_launch.argtypes = (
            [ctypes.c_int] + [_P, _P, _P, _I64] * 2 + [_P] * 4
            + [_I64, ctypes.c_int, _P, _P, _P, _P])
        lib.fused_refine_launch.restype = ctypes.c_int
    return lib


def _max_blocks(lib: ctypes.CDLL, dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _MAX_BLOCKS:
        with torch.cuda.device(idx):
            m = lib.fused_refine_max_blocks(idx)
        if m <= 0:
            raise RuntimeError(f"fused_refine: no resident grid on cuda:{idx}"
                               f" (occupancy query gave {m})")
        _MAX_BLOCKS[idx] = m
    return _MAX_BLOCKS[idx]


def _check(name: str, t: torch.Tensor, dtype, dim: int, dev) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"fused_refine: {name} must be contiguous {dtype} "
                         f"of {dim} dimensions, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != dev:
        raise ValueError(f"fused_refine: {name} on {t.device}, expected "
                         f"{dev}")
    if t.data_ptr() % 16 and dtype == torch.float64:
        raise ValueError(f"fused_refine: {name} must be 16-byte aligned")


def _geometry(side: str, geom: dict, reps: bool, dev) -> list:
    verts, nverts = geom["verts"], geom["nverts"]
    _check(f"{side} verts", verts, torch.float64, 3, dev)
    _check(f"{side} nverts", nverts, torch.int64, 1, dev)
    if verts.shape[-1] != 2 or nverts.numel() != verts.shape[0]:
        raise ValueError(f"fused_refine: {side} verts must be [P, V, 2] "
                         f"with nverts [P], got {tuple(verts.shape)} and "
                         f"{tuple(nverts.shape)}")
    rep_ptr = None
    if reps:
        rp = geom.get("reps")
        if rp is None:
            raise ValueError(f"fused_refine: intersects needs the {side} "
                             f"representative points")
        _check(f"{side} reps", rp, torch.float64, 2, dev)
        if tuple(rp.shape) != (verts.shape[0], 2):
            raise ValueError(f"fused_refine: {side} reps must be [P, 2], "
                             f"got {tuple(rp.shape)}")
        rep_ptr = rp.data_ptr()
    return [verts.data_ptr(), nverts.data_ptr(), rep_ptr, verts.shape[1]]


def fused_refine_rows(kind: str, geom_r: dict, geom_s: dict,
                      ri: torch.Tensor, si: torch.Tensor, perm: torch.Tensor,
                      count: torch.Tensor):
    """(res [N], unc [N], refined [1]): the bool lanes of the float64 core
    ``kind`` (``intersects``, ``within`` or ``line``) over the packed rows:
    row n < ``count`` is the pair (``ri[perm[n]]``, ``si[perm[n]]``) of the
    geometries ``geom_r`` (chains for ``line``) and ``geom_s``, rows past
    ``count`` are False/False. ``ri``/``si`` [N] int64, ``perm`` [N]
    int32, ``count`` [] int32, all on one CUDA device. The lanes equal
    the eager cores' (``spatial.refine._intersects_impl``,
    ``_within_impl``, ``_line_impl``) bit for bit. ``refined`` is an int64
    count on the device, kept by the kernel: the rows it refined,
    ``min(count, N)`` when it walks the live rows alone."""
    if kind not in KINDS:
        raise ValueError(f"fused_refine: unknown core {kind!r}; expected one "
                         f"of {tuple(KINDS)}")
    dev = perm.device
    if dev.type != "cuda":
        raise ValueError(f"fused_refine: the kernel takes CUDA tensors, got "
                         f"{dev}; the plain version is refine."
                         f"fused_refine_lanes(..., kernel=False)")
    _check("perm", perm, torch.int32, 1, dev)
    _check("count", count, torch.int32, 0, dev)
    N = perm.numel()
    for name, t in (("ri", ri), ("si", si)):
        _check(name, t, torch.int64, 1, dev)
        if t.numel() != N:
            raise ValueError(f"fused_refine: {name} has {t.numel()} rows, "
                             f"perm {N}")
    r = _geometry("R", geom_r, kind == "intersects", dev)
    s = _geometry("S", geom_s, kind == "intersects", dev)
    res = torch.empty(N, dtype=torch.bool, device=dev)
    unc = torch.empty(N, dtype=torch.bool, device=dev)
    refined = torch.zeros(1, dtype=torch.int64, device=dev)
    if N == 0:
        return res, unc, refined
    lib = _lib()
    grid = min(_max_blocks(lib, dev), -(-N // ROWS_PER_BLOCK))
    rc = lib.fused_refine_launch(
        KINDS[kind], *r, *s, ri.data_ptr(), si.data_ptr(), perm.data_ptr(),
        count.data_ptr(), N, grid, res.data_ptr(), unc.data_ptr(),
        refined.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_refine: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    fused_refine_rows.launches += 1
    return res, unc, refined


fused_refine_rows.launches = 0
