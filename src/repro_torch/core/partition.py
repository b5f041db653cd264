"""Space partitioning for APRIL (paper §5.2) and the tiled scale-out.

The map is divided into ``parts_per_dim ** 2`` disjoint tiles shared by
every dataset (layer). A partition's raster area is the square hull of the
MBRs of every object meeting its tile (it may exceed the tile); each
partition gets its own order-N grid and Hilbert curve, which raises the
effective resolution without widening the interval integers.

Duplicate results are avoided by the reference-point rule: a candidate
pair belongs to the partition holding the bottom-left corner of the
intersection of its two MBRs. On the uniform grid that is
:func:`reference_partitions` (cell arithmetic); the scale-out's skew
split gives a non-uniform disjoint rect cover, whose rule is
:func:`owner_tiles`.

Partitions are the unit of work of the partitioned launcher
(``launch/spatial_join.py``) and the packing unit of the out-of-core tiled
join (``spatial/scaleout.py``): :func:`quadrants` splits a hot
partition's tile 2x2, :func:`tile_hits` assigns object MBRs to the
children and :func:`square_extent` gives each child its raster area.

Every function here takes ``[N, 4]`` float64 boxes (or tile rects) and
returns vectorized masks or indices; no assignment loops over objects.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .april import AprilStore, build_april
from .rasterize import Extent

__all__ = ["Partition", "Partitioning", "partition_space",
           "reference_partition", "reference_partitions", "quadrants",
           "tile_hits", "owner_tiles", "square_extent"]


def _parallel_map(fn, items, parallel: bool, max_workers: int | None = None):
    """Order-preserving map, on threads when ``parallel``: the host builds
    are numpy with no shared mutable state, and their vectorized passes
    release the GIL."""
    if not parallel or len(items) <= 1:
        return [fn(x) for x in items]
    workers = max_workers or min(len(items), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


@dataclass
class Partition:
    tile: tuple[float, float, float, float]   # xmin, ymin, xmax, ymax
    extent: Extent                            # square raster area
    obj_idx: dict[str, np.ndarray]            # dataset name -> object indices


@dataclass
class Partitioning:
    parts_per_dim: int
    partitions: list[Partition]

    def __len__(self) -> int:
        return len(self.partitions)

    def build_april(self, dataset, n_order: int, method: str = "batched",
                    parallel: bool = True, max_workers: int | None = None,
                    ) -> list[AprilStore | None]:
        """Per-partition APRIL stores of ``dataset`` (``None`` where it has
        no object), built on threads unless ``parallel=False``."""
        def one(part):
            idx = part.obj_idx.get(dataset.name, np.zeros(0, np.int64))
            if len(idx) == 0:
                return None
            return build_april(_subset(dataset, idx), n_order, part.extent,
                               method)
        return _parallel_map(one, self.partitions, parallel, max_workers)

    def build_approx(self, filt, dataset, n_order: int, side: str = "r",
                     parallel: bool = True, max_workers: int | None = None,
                     **build_opts) -> list:
        """Per-partition approximations through any registered filter
        (``None`` where the dataset has no object), each over its
        partition's raster extent, built on threads unless
        ``parallel=False``. ``build_opts`` go to ``filt.build``; the
        ``"torch"`` build backend (the device passes, on ``device``)
        builds the partitions one at a time."""
        if build_opts.get("build_backend") == "torch":
            parallel = False

        def one(part):
            idx = part.obj_idx.get(dataset.name, np.zeros(0, np.int64))
            if len(idx) == 0:
                return None
            return filt.build(_subset(dataset, idx), n_order=n_order,
                              extent=part.extent, side=side, **build_opts)
        return _parallel_map(one, self.partitions, parallel, max_workers)


def _subset(dataset, idx):
    from ..datagen.synthetic import PolygonDataset
    return PolygonDataset(
        name=dataset.name, verts=dataset.verts[idx], nverts=dataset.nverts[idx])


def partition_space(datasets, parts_per_dim: int) -> Partitioning:
    """A ``parts_per_dim`` x ``parts_per_dim`` tiling of [0, 1]^2, every
    object of every dataset assigned to each tile its MBR meets."""
    k = parts_per_dim
    tiles = []
    for ty in range(k):
        for tx in range(k):
            tiles.append((tx / k, ty / k, (tx + 1) / k, (ty + 1) / k))

    parts = []
    for tile in tiles:
        xmin, ymin, xmax, ymax = tile
        obj_idx = {}
        lo_x, lo_y, hi_x, hi_y = np.inf, np.inf, -np.inf, -np.inf
        any_obj = False
        for ds in datasets:
            m = ds.mbrs
            hit = ((m[:, 0] < xmax) & (m[:, 2] > xmin)
                   & (m[:, 1] < ymax) & (m[:, 3] > ymin))
            idx = np.nonzero(hit)[0].astype(np.int64)
            obj_idx[ds.name] = idx
            if len(idx):
                any_obj = True
                lo_x = min(lo_x, float(m[idx, 0].min()))
                lo_y = min(lo_y, float(m[idx, 1].min()))
                hi_x = max(hi_x, float(m[idx, 2].max()))
                hi_y = max(hi_y, float(m[idx, 3].max()))
        if not any_obj:
            lo_x, lo_y, hi_x, hi_y = tile
        side = max(hi_x - lo_x, hi_y - lo_y) * (1 + 1e-9)
        parts.append(Partition(
            tile=tile, extent=Extent(lo_x, lo_y, side), obj_idx=obj_idx))
    return Partitioning(parts_per_dim=k, partitions=parts)


def quadrants(tile: tuple[float, float, float, float]
              ) -> list[tuple[float, float, float, float]]:
    """A tile rect's 2x2 quadrants, bottom-left, bottom-right, top-left,
    top-right: a fixed order, so repeated splits are deterministic."""
    xmin, ymin, xmax, ymax = tile
    xm, ym = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    return [(xmin, ymin, xm, ym), (xm, ymin, xmax, ym),
            (xmin, ym, xm, ymax), (xm, ym, xmax, ymax)]


def tile_hits(mbrs: np.ndarray,
              tile: tuple[float, float, float, float]) -> np.ndarray:
    """[N] bool: does each MBR meet the tile's open interior? The
    assignment rule of :func:`partition_space`, for the streaming
    partitioner (objects replicate into every tile they meet; the
    reference-point rule removes the duplicate results)."""
    m = np.asarray(mbrs, np.float64).reshape(-1, 4)
    xmin, ymin, xmax, ymax = tile
    return ((m[:, 0] < xmax) & (m[:, 2] > xmin)
            & (m[:, 1] < ymax) & (m[:, 3] > ymin))


def square_extent(mbrs: np.ndarray,
                  tile: tuple[float, float, float, float]) -> Extent:
    """The square raster hull of a partition's member MBRs (§5.2); an
    empty partition takes its tile rect."""
    m = np.asarray(mbrs, np.float64).reshape(-1, 4)
    if len(m) == 0:
        lo_x, lo_y, hi_x, hi_y = tile
    else:
        lo_x, lo_y = float(m[:, 0].min()), float(m[:, 1].min())
        hi_x, hi_y = float(m[:, 2].max()), float(m[:, 3].max())
    side = max(hi_x - lo_x, hi_y - lo_y) * (1 + 1e-9)
    return Extent(lo_x, lo_y, side)


def owner_tiles(tiles: np.ndarray, mbrs_r: np.ndarray,
                mbrs_s: np.ndarray) -> np.ndarray:
    """Reference-point ownership over any disjoint rect cover ``tiles``
    ([T, 4]): a pair belongs to the tile holding its reference point,
    half-open ``[min, max)`` membership, closed on the map's top and right
    edges so that points there stay owned. Returns the owning tile of each
    pair, ``-1`` where the cover has a hole."""
    tiles = np.asarray(tiles, np.float64).reshape(-1, 4)
    mbrs_r = np.asarray(mbrs_r, np.float64).reshape(-1, 4)
    mbrs_s = np.asarray(mbrs_s, np.float64).reshape(-1, 4)
    rx = np.maximum(mbrs_r[:, 0], mbrs_s[:, 0])
    ry = np.maximum(mbrs_r[:, 1], mbrs_s[:, 1])
    hi_x = tiles[:, 2].max()
    hi_y = tiles[:, 3].max()
    own = np.full(len(rx), -1, np.int64)
    for t in range(len(tiles)):
        xmin, ymin, xmax, ymax = tiles[t]
        in_x = (rx >= xmin) & ((rx < xmax) | (xmax >= hi_x) & (rx <= xmax))
        in_y = (ry >= ymin) & ((ry < ymax) | (ymax >= hi_y) & (ry <= ymax))
        own[in_x & in_y & (own < 0)] = t
    return own


def reference_partition(parts_per_dim: int, mbr_r: np.ndarray,
                        mbr_s: np.ndarray) -> int:
    """The partition owning one candidate pair (reference-point rule)."""
    return int(reference_partitions(
        parts_per_dim, np.asarray(mbr_r, np.float64)[None],
        np.asarray(mbr_s, np.float64)[None])[0])


def reference_partitions(parts_per_dim: int, mbrs_r: np.ndarray,
                         mbrs_s: np.ndarray) -> np.ndarray:
    """The owning partition of each pair of paired [N, 4] MBR arrays."""
    k = parts_per_dim
    rx = np.maximum(mbrs_r[:, 0], mbrs_s[:, 0])
    ry = np.maximum(mbrs_r[:, 1], mbrs_s[:, 1])
    tx = np.minimum((rx * k).astype(np.int64), k - 1)
    ty = np.minimum((ry * k).astype(np.int64), k - 1)
    return ty * k + tx
