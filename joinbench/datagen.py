"""The benchmark's own copy of the seeded polygon and chain generators.

A frozen copy of the program's ``make_dataset`` (star-shaped rings around
16 shared cluster centres, statistics after the paper's TIGER layers), so
that the data a cell joins stays the same whatever a later change does to
the program's generator. For a given ``(name, seed, count)`` the arrays
are bit-identical to the program's and the reference package's. A layer
whose ``kind`` is ``"line"`` holds open chains instead (roads, rivers):
``make_chains``, a frozen copy of the program's ``make_linestrings``,
bit-identical to it for a given ``(name, seed, count, avg_vertices,
step)``, with the layer's ``avg_vertices`` and ``step`` (by default the
program's 20 and 0.004).

``layers(config, seed)`` makes a cell's two layers: the geometry comes from
the configuration's own data seeds, and ``--seed`` draws the order in which
each layer's objects are numbered. Every seed thus joins the same polygons
(the same candidates, vertex counts and refine work) under other ids, in
another order.

A configuration's map is ``tiles`` unit squares side by side along x, each
drawn with its own cluster centres and data seeds at the configuration's
count per square: more tiles are more area at the same density. Chains
are tiled alike: tile ``t`` is drawn from the data seed plus
``TILE_SEED_STEP * t`` and shifted by ``t`` along x.

A configuration may add slivers: rings made from some rings of one layer
and put into the other, whose answer against their source turns on a
distance ``gap`` far below float32's resolution and far above float64's,
as the boundaries of two layers digitised apart nearly meet (a lake's
shore and a zip code's edge). Each is an MBR candidate of its source in
float64, so the exact test decides it:

* ``mirror``: the source turned half a turn about a point ``gap`` outside
  one of its convex vertices that is extreme in neither axis. The two meet
  nowhere in float64, and share that vertex in float32 (``intersects``).
* ``enclose``: the source grown about its centre by ``ENCLOSE_GROWTH``,
  with one such vertex set ``gap`` inside the source's own. Its MBR holds
  the source's, but that vertex of the source lies outside it in float64,
  and on its boundary in float32 (``within``).
* ``graze``: a chain, put into a line layer, made from a ring of a
  polygon layer: the ``mirror`` image of the source, opened into the
  three-vertex chain of that vertex's image and its two neighbours, so
  its two edges are as long as the source's edges about the vertex. It
  passes ``gap`` beside the source's vertex in float64 and touches it in
  float32 (``linestring``, the chain as R and the source as S).

A sliver is kept only where the plain reference, in float64 and in
float32, reads it so; the next ring is tried otherwise.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["DATASET_SPECS", "ENCLOSE_GROWTH", "TILE_SEED_STEP",
           "SLIVER_PREDICATE", "CHAIN_DEFAULTS", "make_layer", "make_chains",
           "slivers", "layers"]

#: how much an ``enclose`` sliver is grown about its source's centre
ENCLOSE_GROWTH = 0.02
#: tile ``t`` of a layer with data seed ``d`` is drawn from seed
#: ``d + TILE_SEED_STEP * t`` and cluster centres ``t``
TILE_SEED_STEP = 100
#: the predicate each sliver kind turns on
SLIVER_PREDICATE = {"mirror": "intersects", "enclose": "within",
                    "graze": "linestring"}
#: a line layer's chain parameters where it gives none: the program's
#: ``make_linestrings`` defaults
CHAIN_DEFAULTS = {"avg_vertices": 20, "step": 0.004}

# name -> (count, avg_vertices, avg_radius, radius_jitter)
DATASET_SPECS: dict[str, tuple[int, int, float, float]] = {
    "T1": (1200, 24, 0.0045, 0.5),     # landmarks: medium-small
    "T2": (4000, 30, 0.0022, 0.5),     # water: many small simple
    "T3": (64, 220, 0.085, 0.35),      # counties: few large complex
    "T9": (12, 380, 0.28, 0.25),       # states: very few, huge
    "T10": (300, 90, 0.030, 0.4),      # zip codes
    "O5": (1500, 40, 0.0065, 0.5),     # OSM lakes-like
    "O6": (2500, 36, 0.0050, 0.5),     # OSM parks-like
}


def _star_polygon(rng, center, radius, nv, jitter):
    """Simple star-shaped ring: sorted angles + jittered radii."""
    angles = np.sort(rng.uniform(0.0, 2 * np.pi, size=nv))
    angles += np.linspace(0, 1e-4, nv)
    radii = radius * (1.0 + jitter * rng.uniform(-1.0, 1.0, size=nv))
    radii = np.maximum(radii, 0.15 * radius)
    pts = np.stack([
        center[0] + radii * np.cos(angles),
        center[1] + radii * np.sin(angles),
    ], axis=1)
    return np.clip(pts, 1e-6, 1.0 - 1e-6)


def _rings(name: str, seed, count: int, map_seed: int = 0):
    """(verts [P, Vmax, 2] float64, nverts [P] int64, centres [P, 2]) of
    ``count`` rings of the dataset ``name``, drawn from ``seed``."""
    _, nv_avg, rad, jitter = DATASET_SPECS[name]
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    nvs = np.clip(rng.poisson(nv_avg, size=count), 4, None).astype(np.int64)
    verts = np.zeros((count, int(nvs.max()), 2), dtype=np.float64)
    centres = np.zeros((count, 2), dtype=np.float64)
    cl_centers = np.random.default_rng(map_seed).uniform(0.1, 0.9,
                                                         size=(16, 2))
    cl_idx = rng.integers(0, 16, size=count)
    for i in range(count):
        r = rad * np.exp(rng.normal(0.0, 0.45))
        spread = max(0.008, 2.5 * rad)
        c = np.clip(cl_centers[cl_idx[i]] + rng.normal(0, spread, 2),
                    r + 1e-4, 1 - r - 1e-4)
        verts[i, : nvs[i]] = _star_polygon(rng, c, r, int(nvs[i]), jitter)
        centres[i] = c
    return verts, nvs, centres


def make_layer(name: str, seed, count: int, map_seed: int = 0):
    """(verts [P, Vmax, 2] float64, nverts [P] int64) of ``count`` rings of
    the dataset ``name``, drawn from ``seed``."""
    verts, nvs, _ = _rings(name, seed, count, map_seed)
    return verts, nvs


def make_chains(name: str, seed, count: int, avg_vertices: int = 20,
                step: float = 0.004):
    """(verts [P, Vmax, 2] float64, nverts [P] int64) of ``count``
    random-walk open chains, drawn from ``seed``: at least 2 vertices
    each, every step clamped into the unit square."""
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    nvs = np.clip(rng.poisson(avg_vertices, size=count), 2,
                  None).astype(np.int64)
    verts = np.zeros((count, int(nvs.max()), 2), dtype=np.float64)
    for i in range(count):
        start = rng.uniform(0.05, 0.95, size=2)
        heading = rng.uniform(0, 2 * np.pi)
        pts = [start]
        for _ in range(int(nvs[i]) - 1):
            heading += rng.normal(0, 0.6)
            nxt = pts[-1] + step * np.array([np.cos(heading),
                                             np.sin(heading)])
            pts.append(np.clip(nxt, 1e-6, 1 - 1e-6))
        verts[i, : nvs[i]] = np.asarray(pts)
    return verts, nvs


def _draw(spec: dict, seed, count: int, map_seed: int):
    """One tile of a layer: (verts, nverts, centres) of rings, or (verts,
    nverts) of chains where the layer's ``kind`` is ``"line"``."""
    kind = spec.get("kind", "polygon")
    if kind not in ("polygon", "line"):
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "line":
        return make_chains(spec["dataset"], seed, count,
                           **{k: spec.get(k, v)
                              for k, v in CHAIN_DEFAULTS.items()})
    return _rings(spec["dataset"], seed, count, map_seed)


def _concat(parts):
    """Padded ring sets (verts, nverts, ...) as one, padded to the
    widest."""
    V = max(p[0].shape[1] for p in parts)
    return tuple(
        [np.concatenate([np.pad(p[0], ((0, 0), (0, V - p[0].shape[1]),
                                       (0, 0))) for p in parts])]
        + [np.concatenate([p[j] for p in parts])
           for j in range(1, len(parts[0]))])


def _tiled(spec: dict, count: int, tiles: int):
    """A layer of ``count`` objects over ``tiles`` unit squares along x."""
    if count % tiles:
        raise ValueError(f"{count} objects do not split over {tiles} tiles")
    parts = []
    for t in range(tiles):
        v, n, *c = _draw(spec, spec["data_seed"] + TILE_SEED_STEP * t,
                         count // tiles, map_seed=t)
        if t:
            v = np.where(np.arange(v.shape[1])[None, :, None]
                         < n[:, None, None], v + [t, 0.0], 0.0)
            c = [x + [t, 0.0] for x in c]
        parts.append((v, n, *c))
    return _concat(parts)


def _answers(a, b, predicate: str, dtype) -> tuple[bool, bool]:
    """(an MBR candidate, the exact predicate) of ``a`` as R and ``b`` as S
    ([V, 2] each: rings, or under ``linestring`` a chain and a ring) by
    the plain reference in ``dtype``."""
    import torch

    from . import reference

    def up(ring):
        return (torch.as_tensor(ring[None], dtype=dtype),
                torch.tensor([len(ring)]))

    va, na = up(a)
    vb, nb = up(b)
    cand = reference.mbr_candidates(va, na, vb, nb, predicate)
    if len(cand) == 0:
        return False, False
    return True, bool(reference.exact(va, na, vb, nb, cand, predicate)[0])


def _sliver(ring, centre, k: int, kind: str, gap: float):
    u = ring[k] - centre
    u = u / np.hypot(*u)
    if kind == "mirror":
        return 2.0 * (ring[k] + gap * u) - ring
    if kind == "graze":
        return _sliver(ring, centre, k, "mirror", gap)[
            np.arange(k - 1, k + 2) % len(ring)]
    grown = centre + (1.0 + ENCLOSE_GROWTH) * (ring - centre)
    grown[k] = ring[k] - gap * u
    return grown


def _inner_convex(ring) -> np.ndarray:
    """Indices of the convex vertices of a counter-clockwise ring that are
    extreme in neither axis."""
    prev, nxt = np.roll(ring, 1, axis=0), np.roll(ring, -1, axis=0)
    turn = ((ring[:, 0] - prev[:, 0]) * (nxt[:, 1] - ring[:, 1])
            - (ring[:, 1] - prev[:, 1]) * (nxt[:, 0] - ring[:, 0]))
    margin = 1e-3 * (ring.max(axis=0) - ring.min(axis=0))
    inner = ((ring > ring.min(axis=0) + margin)
             & (ring < ring.max(axis=0) - margin)).all(axis=1)
    return np.flatnonzero(inner & (turn > 0))


def slivers(layer, kind: str, count: int, gap: float, seed, bounds):
    """(verts [count, V, 2], nverts [count]) sliver copies of ``count``
    rings of ``layer`` (verts, nverts, centres), drawn from ``seed``, each
    inside ``bounds`` (x0, y0, x1, y1) and read by the reference in
    float64 and float32 as its kind says."""
    import torch

    if kind not in SLIVER_PREDICATE:
        raise ValueError(f"unknown sliver kind {kind!r}")
    predicate = SLIVER_PREDICATE[kind]
    verts, nverts, centres = layer
    rng = np.random.default_rng(seed)
    width = 3 if kind == "graze" else verts.shape[1]
    out_v = np.zeros((count, width, 2), np.float64)
    out_n = np.zeros(count, np.int64)
    k = 0
    for i in rng.permutation(len(nverts)):
        if k == count:
            break
        ring = verts[i, : nverts[i]]
        ks = _inner_convex(ring)
        if len(ks) == 0:
            continue
        sl = _sliver(ring, centres[i], int(ks[rng.integers(len(ks))]), kind,
                     gap)
        if ((sl.min(axis=0) <= np.array(bounds[:2]) + 1e-6).any()
                or (sl.max(axis=0) >= np.array(bounds[2:]) - 1e-6).any()):
            continue
        # (candidate, answer), the source as R and the sliver as S; a
        # graze chain is R, its source S
        pair = (sl, ring) if kind == "graze" else (ring, sl)
        if (_answers(*pair, predicate, torch.float64) != (True, False)
                or _answers(*pair, predicate, torch.float32)
                != (True, True)):
            continue
        out_v[k, : len(sl)] = sl
        out_n[k] = len(sl)
        k += 1
    if k < count:
        raise ValueError(f"only {k} of {count} {kind} slivers fit")
    return out_v, out_n


def layers(config: dict, seed: int):
    """{"r": (verts, nverts), "s": (verts, nverts)} of a configuration, each
    layer's objects in an order drawn from ``seed``."""
    tiles = config.get("tiles", 1)
    made = {side: _tiled(spec, config[f"{side}_count"], tiles)
            for side, spec in config["layers"].items()}
    bounds = (0.0, 0.0, float(tiles), 1.0)
    added = {side: [] for side in made}
    for j, sl in enumerate(config.get("slivers", [])):
        seed_j = [config["layers"][sl["from"]]["data_seed"], j]
        added[sl["into"]].append(slivers(made[sl["from"]], sl["kind"],
                                         sl["count"], sl["gap"], seed_j,
                                         bounds))
    rng = np.random.default_rng(seed % (1 << 64))
    out = {}
    for side in ("r", "s"):
        verts, nverts = _concat([made[side][:2]] + added[side])
        perm = rng.permutation(len(nverts))
        out[side] = (np.ascontiguousarray(verts[perm]), nverts[perm])
    return out
