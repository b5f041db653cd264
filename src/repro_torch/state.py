"""Carry state across from plain arrays into the port's objects.

Datasets and APRIL stores built elsewhere (the reference package, a file,
another process) arrive as numpy arrays; these constructors wrap them so
the port joins exactly the same geometry and interval lists.
"""
from __future__ import annotations

import numpy as np

from .core.april import AprilStore
from .core.rasterize import Extent
from .datagen.synthetic import PolygonDataset

__all__ = ["dataset_from_arrays", "april_store_from_arrays"]


def dataset_from_arrays(name: str, verts, nverts) -> PolygonDataset:
    """A PolygonDataset over padded ``verts`` [P, V, 2] and ``nverts`` [P]."""
    return PolygonDataset(name=name,
                          verts=np.array(verts, np.float64, copy=True),
                          nverts=np.array(nverts, np.int64, copy=True))


def april_store_from_arrays(n_order: int, extent, a_off, a_ints, f_off,
                            f_ints) -> AprilStore:
    """An AprilStore over CSR interval arrays (offsets int64, half-open
    uint64 intervals). ``extent`` is anything with ``x0``, ``y0`` and
    ``side``, or an ``(x0, y0, side)`` tuple."""
    if not hasattr(extent, "side"):
        extent = Extent(*extent)
    a_ints = np.array(a_ints, np.uint64, copy=True).reshape(-1, 2)
    f_ints = np.array(f_ints, np.uint64, copy=True).reshape(-1, 2)
    a_off = np.array(a_off, np.int64, copy=True)
    f_off = np.array(f_off, np.int64, copy=True)
    if len(a_off) != len(f_off) or a_off[-1] != len(a_ints) \
            or f_off[-1] != len(f_ints):
        raise ValueError("inconsistent CSR offsets for the A/F lists")
    return AprilStore(n_order=int(n_order),
                      extent=Extent(float(extent.x0), float(extent.y0),
                                    float(extent.side)),
                      a_off=a_off, a_ints=a_ints, f_off=f_off, f_ints=f_ints)
