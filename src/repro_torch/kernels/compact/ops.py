"""Wrapper of the compaction kernel (``csrc/compact.cu``).

On the CPU it runs the plain PyTorch version (``ref.py``); on a CUDA
device it launches the kernel's three passes on the current stream, or
raises. Nothing is read back to the host: ``count`` stays on the device.
Kernel launches are counted in ``compact_mask.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from .ref import compact_mask_plain

__all__ = ["compact_mask", "MAX_ROWS"]

_P = ctypes.c_void_p

#: the kernel indexes rows with int32
MAX_ROWS = 2**31 - 1


def _lib() -> ctypes.CDLL:
    lib = load("compact")
    if lib.compact_mask_launch.argtypes is None:
        lib.compact_mask_blocks.argtypes = [ctypes.c_int64]
        lib.compact_mask_blocks.restype = ctypes.c_int64
        lib.compact_mask_launch.argtypes = [_P, ctypes.c_int64, _P, _P, _P,
                                            _P]
        lib.compact_mask_launch.restype = ctypes.c_int
    return lib


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
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return perm, count
    lib = _lib()
    sums = torch.empty(lib.compact_mask_blocks(n), dtype=torch.int32,
                       device=dev)
    rc = lib.compact_mask_launch(mask.data_ptr(), n, sums.data_ptr(),
                                 perm.data_ptr(), count.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"compact_mask: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    compact_mask.launches += 1
    return perm, count


compact_mask.launches = 0
