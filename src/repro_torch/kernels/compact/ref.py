"""Plain PyTorch version of the compaction kernel: the cumsum branch of the
reference's ``compact_mask`` (``src/repro/kernels/compact/ops.py``)."""
from __future__ import annotations

import torch

__all__ = ["compact_mask_plain"]


def compact_mask_plain(mask: torch.Tensor):
    """(perm [N] int32, count [] int32) on ``mask``'s device.

    ``perm[:count]`` are the True indices ascending, ``perm[count:]`` the
    False indices ascending; ``count`` stays a device scalar. The scatter
    destinations are the exclusive prefix sum of the mask for a True row
    and ``count + i - excl`` for a False one, a permutation of [0, N).
    """
    n = mask.numel()
    dev = mask.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    m = mask.to(torch.int32)
    c = torch.cumsum(m, 0, dtype=torch.int32)
    excl = c - m
    k = c[-1]
    i = torch.arange(n, dtype=torch.int32, device=dev)
    dest = torch.where(m > 0, excl, k + (i - excl))
    perm = torch.zeros(n, dtype=torch.int32, device=dev)
    perm.scatter_(0, dest.to(torch.int64), i)
    return perm, k.clone()
