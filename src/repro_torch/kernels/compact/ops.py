"""Wrapper of the compaction kernel (``csrc/compact.cu``).

On the CPU it runs the plain PyTorch version (``ref.py``); on a CUDA
device it makes one cooperative launch of the kernel on the current stream,
or raises. Nothing is read back to the host: ``count`` stays on the device
and the kernel writes it. Kernel launches are counted in
``compact_mask.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .ref import compact_mask_plain

__all__ = ["compact_mask", "MAX_ROWS", "TILE"]

_P = ctypes.c_void_p

#: the kernel indexes rows with int32
MAX_ROWS = 2**31 - 1
#: rows a block takes at a time: a block owns whole tiles
TILE = 1024

#: device index -> the most blocks resident at once (a cooperative grid)
_MAX_BLOCKS: dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    lib = load("compact")
    if lib.compact_mask_launch.argtypes is None:
        lib.compact_mask_max_blocks.argtypes = [ctypes.c_int]
        lib.compact_mask_max_blocks.restype = ctypes.c_int
        lib.compact_mask_launch.argtypes = [_P, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int, _P,
                                            _P, _P, _P]
        lib.compact_mask_launch.restype = ctypes.c_int
    return lib


def _max_blocks(lib: ctypes.CDLL, dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _MAX_BLOCKS:
        with torch.cuda.device(idx):
            m = lib.compact_mask_max_blocks(idx)
        if m <= 0:
            raise RuntimeError(f"compact_mask: no resident grid on cuda:{idx} "
                               f"(occupancy query gave {m})")
        _MAX_BLOCKS[idx] = m
    return _MAX_BLOCKS[idx]


def compact_mask(mask: torch.Tensor):
    """Stable front-pack of a bool lane: (perm [N] int32, count [] int32),
    both on ``mask``'s device; see ``ref.compact_mask_plain``."""
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"compact_mask: expected a 1-D bool lane, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    n = mask.numel()
    if n > MAX_ROWS:
        raise ValueError(f"compact_mask: {n} rows exceed the kernel's int32 "
                         f"row index ({MAX_ROWS})")
    dev = mask.device
    if dev.type == "cpu":
        return compact_mask_plain(mask)
    if dev.type != "cuda":
        raise ValueError(f"compact_mask: the lane must be on the CPU (plain "
                         f"version) or a CUDA device, got {dev}")
    mask = mask.contiguous()
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return perm, torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    lib = _lib()
    # whole tiles a block, over at most half the resident grid: two tiles a
    # block beat one at the main path's 742,279 rows (PERF.md)
    tiles = -(-n // TILE)
    per_block = -(-tiles // max(1, _max_blocks(lib, dev) // 2))
    grid = -(-tiles // per_block)
    sums = torch.empty(grid, dtype=torch.int32, device=dev)
    rc = lib.compact_mask_launch(mask.data_ptr(), n, per_block * TILE, grid,
                                 sums.data_ptr(), perm.data_ptr(),
                                 count.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compact_mask: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    compact_mask.launches += 1
    return perm, count


compact_mask.launches = 0
