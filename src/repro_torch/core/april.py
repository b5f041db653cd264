"""APRIL approximation stores: per-polygon A- and F-interval lists, and
for open chains (linestrings, §4.3.3) the sorted cell ids of each chain.

Host storage is CSR-style: one flat [sum_I, 2] uint64 half-open interval
array plus [P+1] offsets, per list kind. The filter join reads them as
biased int32 with inclusive lasts (``core.join.IntervalLists``), a
chain's cells as unit intervals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import intervalize, rasterize
from .geometry import build_device
from .hilbert import xy2d
from .rasterize import Extent, GLOBAL_EXTENT

__all__ = ["AprilStore", "build_april", "build_april_polygon",
           "LineCellStore", "build_line_cells"]


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


def build_april_polygon(
    verts: np.ndarray, n: int, n_order: int,
    extent: Extent = GLOBAL_EXTENT, method: str = "batched",
) -> tuple[np.ndarray, np.ndarray]:
    """(A-list, F-list) of one polygon. ``method``: ``batched``, ``pips``
    or ``neighbors`` (one-step, §6.2), ``scanline`` or ``floodfill``
    (full rasterization, §6.1)."""
    if method in ("batched", "pips", "neighbors"):
        return intervalize.onestep(verts, n, n_order, extent, method=method)
    partial = rasterize.dda_partial_cells(verts, n, n_order, extent)
    if method == "scanline":
        full = rasterize.scanline_full_cells(verts, n, partial, n_order,
                                             extent)
    elif method == "floodfill":
        full = rasterize.floodfill_classify(verts, n, partial, n_order,
                                            extent)
    else:
        raise ValueError(f"unknown construction method {method!r}")
    return intervalize.april_from_cells(partial, full, n_order)


def build_april(dataset, n_order: int, extent: Extent = GLOBAL_EXTENT,
                method: str = "batched", backend: str = "numpy",
                device=None) -> AprilStore:
    """Build the APRIL store of a PolygonDataset.

    ``backend``: ``numpy`` and ``torch`` run the dataset-level batched
    one-step construction (one multi-polygon DDA + one PiP pass over all
    gap heads, on ``device`` for ``torch``); ``sequential`` keeps the
    per-polygon reference loop. A ``method`` other than ``batched`` is
    per-polygon by nature and always takes the loop.
    """
    dev = build_device(backend, device)
    if method == "batched" and backend != "sequential":
        a_off, a_ints, f_off, f_ints = intervalize.onestep_multi(
            dataset.verts, dataset.nverts, n_order, extent, backend=backend,
            device=dev)
        return AprilStore(n_order=n_order, extent=extent, a_off=a_off,
                          a_ints=a_ints, f_off=f_off, f_ints=f_ints)
    a_off = [0]
    f_off = [0]
    a_chunks = []
    f_chunks = []
    for i in range(len(dataset)):
        a, f = build_april_polygon(dataset.verts[i], int(dataset.nverts[i]),
                                   n_order, extent, method)
        a_chunks.append(a)
        f_chunks.append(f)
        a_off.append(a_off[-1] + len(a))
        f_off.append(f_off[-1] + len(f))
    cat = lambda chunks: (np.concatenate(chunks, axis=0)
                          if chunks else np.zeros((0, 2), np.uint64))
    return AprilStore(n_order=n_order, extent=extent,
                      a_off=np.asarray(a_off, np.int64), a_ints=cat(a_chunks),
                      f_off=np.asarray(f_off, np.int64), f_ints=cat(f_chunks))


@dataclass
class LineCellStore:
    """CSR store of the sorted Partial cell ids of each linestring
    (§4.3.3): an open chain's approximation is its cell-id set, joined as
    unit intervals."""
    n_order: int
    off: np.ndarray     # [P+1] int64
    ids: np.ndarray     # [sum_K] uint64, sorted per row

    def __len__(self) -> int:
        return len(self.off) - 1

    def cell_ids(self, i: int) -> np.ndarray:
        return self.ids[self.off[i]: self.off[i + 1]]

    def size_bytes(self) -> int:
        return 4 * len(self.ids) + 8 * len(self.off)


def build_line_cells(dataset, n_order: int,
                     extent: Extent = GLOBAL_EXTENT, backend: str = "numpy",
                     device=None) -> LineCellStore:
    """Every chain's cells in one open-chain traversal of the whole
    dataset, Hilbert-keyed and sorted per chain (``numpy``, and ``torch``,
    which has no device pass here, as the reference's ``jnp``);
    ``sequential`` traverses chain by chain."""
    build_device(backend, device)
    if backend == "sequential":
        off = [0]
        chunks = []
        for i in range(len(dataset)):
            cells = rasterize.dda_partial_cells(
                dataset.verts[i], int(dataset.nverts[i]), n_order, extent,
                closed=False)
            ids = np.sort(rasterize.cells_to_hilbert(cells, n_order))
            chunks.append(ids)
            off.append(off[-1] + len(ids))
        ids = np.concatenate(chunks) if chunks else np.zeros(0, np.uint64)
        return LineCellStore(n_order=n_order, off=np.asarray(off, np.int64),
                             ids=ids)
    P = len(dataset)
    off, cells = rasterize.dda_partial_cells_multi(
        dataset.verts, dataset.nverts, n_order, extent, closed=False)
    ids = xy2d(n_order, cells[:, 0], cells[:, 1])
    pid = np.repeat(np.arange(P), np.diff(off))
    shift = np.uint64(1) << np.uint64(2 * n_order)
    order = np.argsort(pid.astype(np.uint64) * shift + ids)
    return LineCellStore(n_order=n_order, off=off, ids=ids[order])
