"""Reproducible synthetic polygon and linestring datasets.

Seeded star-shaped rings in the unit square whose statistics mirror the
paper's TIGER/OSM layers (cardinality ratios, vertex counts, MBR areas),
and seeded random-walk chains (roads or rivers, the linestring joins of
§4.3.3). For a given ``(name, seed, count)`` the arrays are bit-identical
to the reference package's generators; so are the chunk streams of
:func:`iter_dataset_chunks` (the out-of-core join's source) for a given
``(name, seed, count, chunk_size)``.
"""
from __future__ import annotations

import zlib
from collections.abc import Iterator
from dataclasses import dataclass, field

import numpy as np

from ..core import geometry

__all__ = ["PolygonDataset", "make_dataset", "make_linestrings",
           "iter_dataset_chunks", "make_chunked_dataset", "DATASET_SPECS"]


@dataclass
class PolygonDataset:
    """Padded polygon collection."""
    name: str
    verts: np.ndarray        # [P, Vmax, 2] float64
    nverts: np.ndarray       # [P] int64
    mbrs: np.ndarray = field(init=False)  # [P, 4]

    def __post_init__(self):
        self.mbrs = geometry.polygon_mbrs(self.verts, self.nverts)

    def __len__(self) -> int:
        return len(self.nverts)

    def polygon(self, i: int) -> np.ndarray:
        return self.verts[i, : self.nverts[i]]


# name -> (count, avg_vertices, avg_radius, radius_jitter)
DATASET_SPECS: dict[str, tuple[int, int, float, float]] = {
    "T1":  (1200, 24, 0.0045, 0.5),    # landmarks: medium-small
    "T2":  (4000, 30, 0.0022, 0.5),    # water: many small simple
    "T3":  (64, 220, 0.085, 0.35),     # counties: few large complex
    "T9":  (12, 380, 0.28, 0.25),      # states: very few, huge
    "T10": (300, 90, 0.030, 0.4),      # zip codes
    "O5":  (1500, 40, 0.0065, 0.5),    # OSM lakes-like
    "O6":  (2500, 36, 0.0050, 0.5),    # OSM parks-like
}


def _star_polygon(rng: np.random.Generator, center, radius, nv, jitter):
    """Simple star-shaped ring: sorted angles + jittered radii."""
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, size=nv))
    # Avoid near-duplicate angles (degenerate edges)
    angles += np.linspace(0, 1e-4, nv)
    radii = radius * (1.0 + jitter * rng.uniform(-1.0, 1.0, size=nv))
    radii = np.maximum(radii, 0.15 * radius)
    pts = np.stack([
        center[0] + radii * np.cos(angles),
        center[1] + radii * np.sin(angles),
    ], axis=1)
    return np.clip(pts, 1e-6, 1.0 - 1e-6)


def make_dataset(
    name: str, seed: int = 0, count: int | None = None,
    avg_vertices: int | None = None, avg_radius: float | None = None,
    map_seed: int = 0,
) -> PolygonDataset:
    """Build a seeded dataset. ``name`` picks a spec from DATASET_SPECS
    (unknown names get default medium stats); overrides are optional.
    ``map_seed`` fixes the shared cluster centers, so layers built over the
    same map co-locate."""
    spec = DATASET_SPECS.get(name, (1000, 30, 0.005, 0.5))
    cnt = count if count is not None else spec[0]
    nv_avg = avg_vertices if avg_vertices is not None else spec[1]
    rad = avg_radius if avg_radius is not None else spec[2]
    jitter = spec[3]
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))

    nvs = np.clip(
        rng.poisson(nv_avg, size=cnt), 4, None
    ).astype(np.int64)
    vmax = int(nvs.max())
    verts = np.zeros((cnt, vmax, 2), dtype=np.float64)
    map_rng = np.random.default_rng(map_seed)
    n_clusters = 16
    cl_centers = map_rng.uniform(0.1, 0.9, size=(n_clusters, 2))
    cl_idx = rng.integers(0, n_clusters, size=cnt)
    for i in range(cnt):
        r = rad * np.exp(rng.normal(0.0, 0.45))
        spread = max(0.008, 2.5 * rad)
        c = np.clip(cl_centers[cl_idx[i]] + rng.normal(0, spread, 2),
                    r + 1e-4, 1 - r - 1e-4)
        pts = _star_polygon(rng, c, r, int(nvs[i]), jitter)
        verts[i, : nvs[i]] = pts
    return PolygonDataset(name=name, verts=verts, nverts=nvs)


def _star_polygons_chunk(rng: np.random.Generator, centers: np.ndarray,
                         radii: np.ndarray, nvs: np.ndarray,
                         jitter: float) -> np.ndarray:
    """A whole chunk of star polygons in one vectorized pass: sorted
    jittered angles and jittered radii, padding slots zeroed. The batched
    twin of :func:`_star_polygon` (same construction, its own draws)."""
    n, vmax = len(nvs), int(nvs.max())
    mask = np.arange(vmax)[None, :] < nvs[:, None]
    angles = rng.uniform(0.0, 2 * np.pi, size=(n, vmax))
    # padding sorts to the row tail (inf), then the mask drops it
    angles = np.sort(np.where(mask, angles, np.inf), axis=1)
    angles = np.where(mask, angles, 0.0)
    angles += np.linspace(0, 1e-4, vmax)[None, :]   # no degenerate edges
    rad = radii[:, None] * (1.0 + jitter * rng.uniform(-1.0, 1.0,
                                                       size=(n, vmax)))
    rad = np.maximum(rad, 0.15 * radii[:, None])
    pts = centers[:, None, :] + np.stack(
        [rad * np.cos(angles), rad * np.sin(angles)], axis=-1)
    pts = np.clip(pts, 1e-6, 1.0 - 1e-6)
    return np.where(mask[..., None], pts, 0.0)


def iter_dataset_chunks(
    name: str, seed: int = 0, count: int | None = None,
    chunk_size: int = 65536, avg_vertices: int | None = None,
    avg_radius: float | None = None, map_seed: int = 0,
) -> Iterator[PolygonDataset]:
    """Stream a dataset as chunks of ``chunk_size`` polygons, the source of
    the out-of-core tiled join. Chunk ``ci`` comes from one vectorized pass
    over an rng seeded on ``(name, seed, ci)``: deterministic, independent
    of the other chunks, and O(chunk) host memory whatever ``count`` is.
    Its statistics follow :data:`DATASET_SPECS` as :func:`make_dataset`'s
    do, but the stream is its own seeded draw, not a re-chunking of
    :func:`make_dataset`."""
    spec = DATASET_SPECS.get(name, (1000, 30, 0.005, 0.5))
    cnt = count if count is not None else spec[0]
    nv_avg = avg_vertices if avg_vertices is not None else spec[1]
    rad = avg_radius if avg_radius is not None else spec[2]
    jitter = spec[3]
    map_rng = np.random.default_rng(map_seed)
    n_clusters = 16
    cl_centers = map_rng.uniform(0.1, 0.9, size=(n_clusters, 2))

    for ci, start in enumerate(range(0, cnt, chunk_size)):
        m = min(chunk_size, cnt - start)
        rng = np.random.default_rng(
            zlib.crc32(f"{name}:{seed}:chunk:{ci}".encode()))
        nvs = np.clip(rng.poisson(nv_avg, size=m), 4, None).astype(np.int64)
        radii = rad * np.exp(rng.normal(0.0, 0.45, size=m))
        spread = max(0.008, 2.5 * rad)
        cl_idx = rng.integers(0, n_clusters, size=m)
        centers = cl_centers[cl_idx] + rng.normal(0, spread, size=(m, 2))
        centers = np.clip(centers, radii[:, None] + 1e-4,
                          1.0 - radii[:, None] - 1e-4)
        verts = _star_polygons_chunk(rng, centers, radii, nvs, jitter)
        yield PolygonDataset(name=name, verts=verts, nverts=nvs)


def make_chunked_dataset(
    name: str, seed: int = 0, count: int | None = None,
    chunk_size: int = 65536, avg_vertices: int | None = None,
    avg_radius: float | None = None, map_seed: int = 0,
) -> PolygonDataset:
    """:func:`iter_dataset_chunks` concatenated into one dataset, padded to
    the widest chunk. Object ``i`` here has the global id ``i`` the tiled
    join gives it (chunk start plus index in the chunk), so this is the
    in-memory reference of a tiled run."""
    chunks = list(iter_dataset_chunks(
        name, seed=seed, count=count, chunk_size=chunk_size,
        avg_vertices=avg_vertices, avg_radius=avg_radius,
        map_seed=map_seed))
    vmax = max(int(c.verts.shape[1]) for c in chunks)
    verts = np.concatenate([
        np.pad(c.verts, ((0, 0), (0, vmax - c.verts.shape[1]), (0, 0)))
        for c in chunks], axis=0)
    nvs = np.concatenate([c.nverts for c in chunks])
    return PolygonDataset(name=name, verts=verts, nverts=nvs)


def make_linestrings(
    name: str = "T8", seed: int = 0, count: int = 2000, avg_vertices: int = 20,
    step: float = 0.004,
) -> PolygonDataset:
    """Random-walk linestrings (roads or rivers). They reuse the
    PolygonDataset storage, but are open chains: the last vertex does not
    join the first. Vertex counts are clipped at 2, and each step is
    clamped into the unit square."""
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    nvs = np.clip(rng.poisson(avg_vertices, size=count), 2,
                  None).astype(np.int64)
    vmax = int(nvs.max())
    verts = np.zeros((count, vmax, 2), dtype=np.float64)
    for i in range(count):
        start = rng.uniform(0.05, 0.95, size=2)
        heading = rng.uniform(0, 2 * np.pi)
        pts = [start]
        for _ in range(int(nvs[i]) - 1):
            heading += rng.normal(0, 0.6)
            nxt = pts[-1] + step * np.array([np.cos(heading), np.sin(heading)])
            pts.append(np.clip(nxt, 1e-6, 1 - 1e-6))
        verts[i, : nvs[i]] = np.asarray(pts)
    return PolygonDataset(name=name, verts=verts, nverts=nvs)
