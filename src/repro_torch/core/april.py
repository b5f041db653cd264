"""APRIL approximation store: per-polygon A- and F-interval lists.

Host storage is CSR-style: one flat [sum_I, 2] uint64 half-open interval
array plus [P+1] offsets, per list kind. The filter join reads them as
biased int32 with inclusive lasts (``core.join.IntervalLists``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import intervalize
from .rasterize import Extent, GLOBAL_EXTENT

__all__ = ["AprilStore", "build_april"]


@dataclass
class AprilStore:
    """APRIL approximations for one dataset."""
    n_order: int
    extent: Extent
    a_off: np.ndarray    # [P+1] int64
    a_ints: np.ndarray   # [sum_Ia, 2] uint64
    f_off: np.ndarray    # [P+1] int64
    f_ints: np.ndarray   # [sum_If, 2] uint64

    def __len__(self) -> int:
        return len(self.a_off) - 1

    def a_list(self, i: int) -> np.ndarray:
        return self.a_ints[self.a_off[i]: self.a_off[i + 1]]

    def f_list(self, i: int) -> np.ndarray:
        return self.f_ints[self.f_off[i]: self.f_off[i + 1]]

    def size_bytes(self) -> int:
        """Uncompressed size: every endpoint is a 32-bit unsigned int, plus
        the offset tables."""
        return 4 * 2 * (len(self.a_ints) + len(self.f_ints)) \
            + 8 * (len(self.a_off) + len(self.f_off))


def build_april(dataset, n_order: int,
                extent: Extent = GLOBAL_EXTENT) -> AprilStore:
    """Build the APRIL store of a PolygonDataset with the dataset-level
    batched one-step construction (one multi-polygon DDA + one PiP pass
    over all gap heads)."""
    a_off, a_ints, f_off, f_ints = intervalize.onestep_multi(
        dataset.verts, dataset.nverts, n_order, extent)
    return AprilStore(n_order=n_order, extent=extent, a_off=a_off,
                      a_ints=a_ints, f_off=f_off, f_ints=f_ints)
