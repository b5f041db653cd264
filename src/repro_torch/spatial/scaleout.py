"""The out-of-core tiled join: datasets that do not fit in one host's
memory, joined in four streaming phases.

1. **Streaming partition and spill.** Each side arrives as an iterator of
   chunks (:func:`repro_torch.datagen.iter_dataset_chunks`, or any
   sequence of :class:`~repro_torch.datagen.PolygonDataset`). Every chunk
   is assigned to the uniform grid partitions its MBRs meet
   (:func:`~repro_torch.core.partition.tile_hits`) and appended to a
   per-partition spill on disk, so host memory stays O(chunk). Per
   partition the pass gathers what the cost model needs: object counts,
   the MBR hull (the raster extent), a D x D rect-coverage histogram of
   the MBRs, and a deterministic bottom-k hash sample of objects.
2. **Cost estimation** (:func:`estimate_partition`), in the adaptive
   planner's work units: probe APRIL stores over the samples (host numpy
   builds) give interval counts, the histograms the expected candidate
   count, sampled pair records the filter comparisons, the INDECISIVE rate
   and the refinement vertex products. ``cost = c_build * intervals +
   candidates * filter_cmp + c_refine * candidates * indec_rate *
   vertex_product``. These floats decide splits and packing.
3. **Skew split and tile packing** (:func:`plan_scaleout`). A partition
   whose cost exceeds ``split_factor`` times the median splits into its
   2x2 quadrants (only its own objects are spilled again), down to
   ``max_split_depth``; a split also shrinks the children's raster extents,
   so they filter at a finer resolution. The partitions then pack
   first-fit-decreasing by estimated resident bytes into tiles bounded by
   ``tile_budget``: a tile is the unit of residency. ``balance="static"``
   splits nothing and packs in partition order. All of it is
   deterministic.
4. **Streaming join** (:func:`tiled_join`). Tiles run in order; within a
   tile each partition loads its spill, builds its approximations and runs
   a ``JoinPlan`` (staged or fused, on ``device``), under the adaptive
   planner with ``plan_mode="adaptive"`` (choices shared between
   partitions of similar density through a ``ProfileCache``), and through
   :func:`~repro_torch.spatial.distributed.distributed_fused_join` when a
   mesh is given. Duplicates across partitions drop by the reference-point
   rule over the final tile cover
   (:func:`~repro_torch.core.partition.owner_tiles`); local ids map back
   to global ids from the spill. After each tile the completed-tile
   manifest checkpoints through
   :class:`~repro_torch.runtime.checkpoint.CheckpointManager` (the
   reference package's format): a killed run restarts at the first
   unfinished tile, guarded by a fingerprint of the plan and the
   configuration.

Results are those of the in-memory ``JoinPlan`` for every filter and
predicate: partitioning, splitting, packing and resuming change execution
only.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from ..core.geometry import BUILD_STAGES
from ..core.partition import owner_tiles, quadrants, square_extent, tile_hits
from ..core.rasterize import Extent
from ..datagen.synthetic import PolygonDataset
from ..device import resolve_device
from .plan import JoinPlan, JoinStats
from .planner import (ORDER_CHOICES, PLAN_DEFAULTS, PlanChoice,
                      ProfileCache, _lists, _order_work, _pair_record,
                      _store_ints)

__all__ = ["SCALEOUT_DEFAULTS", "BALANCE_MODES", "TilePartition", "TilePlan",
           "check_balance", "estimate_partition", "plan_scaleout",
           "tiled_join"]

#: ``balance="cost"`` splits skewed partitions and packs tiles
#: first-fit-decreasing by estimated bytes; ``"static"`` keeps the uniform
#: grid and packs in partition order (the comparison baseline).
BALANCE_MODES = ("cost", "static")

SCALEOUT_DEFAULTS: dict = {
    "parts_per_dim": 2,       # base uniform grid (parts_per_dim^2 tiles)
    "tile_budget": 64 << 20,  # resident bytes per tile
    "balance": "cost",        # cost | static
    "split_factor": 4.0,      # split while cost > factor * median
    "max_split_depth": 2,     # quadtree depth below the base grid
    "min_split_objs": 64,     # don't split partitions smaller than this
    "sample_size": 32,        # bottom-k objects probed per side
    "max_probe_pairs": 64,    # sampled pair records per partition
    "density_grid": 8,        # D of the D x D MBR-density histogram
    "seed": 0,                # salts the bottom-k hash sample
}

_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


def check_balance(balance: str) -> None:
    if balance not in BALANCE_MODES:
        raise ValueError(f"unknown balance {balance!r}; "
                         f"expected one of {BALANCE_MODES}")


def _as_chunks(src, chunk_size: int = 65536):
    """Normalize a chunk source: a PolygonDataset slices into chunk views;
    any iterable of datasets streams through unchanged."""
    if isinstance(src, PolygonDataset):
        def gen():
            for start in range(0, len(src), chunk_size):
                sl = slice(start, start + chunk_size)
                yield PolygonDataset(name=src.name, verts=src.verts[sl],
                                     nverts=src.nverts[sl])
        return gen()
    return iter(src)


# ---------------------------------------------------------------------------
# Phase 1: streaming partition + spill
# ---------------------------------------------------------------------------

class _SideSpill:
    """On-disk chunk store of one partition's objects on one side.

    ``append`` writes one npz per incoming chunk slice (global ids, padded
    vertices, vertex counts, MBRs); ``load`` concatenates them padded to
    the partition-wide Vmax. Host memory during the spill pass stays
    O(chunk); a ``load`` materializes one partition-side only — bounded by
    the tile budget the packer enforced.
    """

    def __init__(self, root: str, side: str, pid: int):
        self.dir = os.path.join(root, side, f"part_{pid}")
        os.makedirs(self.dir, exist_ok=True)
        self.n = 0
        self.n_chunks = 0
        self.vmax = 0

    def append(self, gid, verts, nverts, mbrs) -> None:
        np.savez(os.path.join(self.dir, f"chunk_{self.n_chunks:06d}.npz"),
                 gid=gid, verts=verts, nverts=nverts, mbrs=mbrs)
        self.n += len(gid)
        self.n_chunks += 1
        self.vmax = max(self.vmax, int(verts.shape[1]))

    def iter_chunks(self):
        for ci in range(self.n_chunks):
            with np.load(os.path.join(self.dir,
                                      f"chunk_{ci:06d}.npz")) as z:
                yield {k: z[k] for k in ("gid", "verts", "nverts", "mbrs")}

    def load(self):
        """(gid [N], verts [N,Vmax,2], nverts [N], mbrs [N,4]) or Nones."""
        if self.n == 0:
            return (np.zeros(0, np.int64), np.zeros((0, 0, 2)),
                    np.zeros(0, np.int64), np.zeros((0, 4)))
        gids, verts, nvs, mbrs = [], [], [], []
        for ch in self.iter_chunks():
            v = ch["verts"]
            if v.shape[1] < self.vmax:
                v = np.pad(v, ((0, 0), (0, self.vmax - v.shape[1]), (0, 0)))
            gids.append(ch["gid"])
            verts.append(v)
            nvs.append(ch["nverts"])
            mbrs.append(ch["mbrs"])
        return (np.concatenate(gids), np.concatenate(verts, axis=0),
                np.concatenate(nvs), np.concatenate(mbrs, axis=0))

    def remove(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class _SideStats:
    """Streaming per-(partition, side) statistics: count, MBR hull, the
    D x D rect-coverage histogram (difference-array adds, cumsum on
    finalize), and a deterministic bottom-k hash sample of objects."""

    def __init__(self, tile, k: int, D: int, salt: int):
        self.tile = tile
        self.D = D
        self.k = k
        self.salt = np.uint64(salt)
        self.n = 0
        self.vmax = 0
        self.lo = np.array([np.inf, np.inf])
        self.hi = np.array([-np.inf, -np.inf])
        self._diff = np.zeros((D + 1, D + 1))
        self.sample: list[tuple] = []   # (key, verts_row, nv, mbr)

    def update(self, gid, verts, nverts, mbrs) -> None:
        self.n += len(gid)
        self.vmax = max(self.vmax, int(verts.shape[1]))
        self.lo = np.minimum(self.lo, mbrs[:, :2].min(axis=0))
        self.hi = np.maximum(self.hi, mbrs[:, 2:].max(axis=0))
        xmin, ymin, xmax, ymax = self.tile
        D = self.D
        sx = max(xmax - xmin, 1e-12) / D
        sy = max(ymax - ymin, 1e-12) / D
        x0 = np.clip(((mbrs[:, 0] - xmin) / sx).astype(np.int64), 0, D - 1)
        x1 = np.clip(((mbrs[:, 2] - xmin) / sx).astype(np.int64), 0, D - 1)
        y0 = np.clip(((mbrs[:, 1] - ymin) / sy).astype(np.int64), 0, D - 1)
        y1 = np.clip(((mbrs[:, 3] - ymin) / sy).astype(np.int64), 0, D - 1)
        np.add.at(self._diff, (x0, y0), 1.0)
        np.add.at(self._diff, (x1 + 1, y0), -1.0)
        np.add.at(self._diff, (x0, y1 + 1), -1.0)
        np.add.at(self._diff, (x1 + 1, y1 + 1), 1.0)
        # bottom-k hash sample: chunk-order independent, no rng state
        keys = ((gid.astype(np.uint64) + np.uint64(1)) * _HASH_MULT
                ^ self.salt)
        take = np.argsort(keys, kind="stable")[: self.k]
        merged = self.sample + [
            (int(keys[i]), verts[i], int(nverts[i]), mbrs[i]) for i in take]
        merged.sort(key=lambda t: t[0])
        self.sample = merged[: self.k]

    @property
    def hist(self) -> np.ndarray:
        return np.cumsum(np.cumsum(self._diff, axis=0),
                         axis=1)[: self.D, : self.D]

    def sample_dataset(self, name: str) -> PolygonDataset | None:
        if not self.sample:
            return None
        vmax = max(v.shape[0] for _, v, _, _ in self.sample)
        verts = np.zeros((len(self.sample), vmax, 2))
        nvs = np.zeros(len(self.sample), np.int64)
        for i, (_, v, nv, _) in enumerate(self.sample):
            verts[i, : v.shape[0]] = v
            nvs[i] = nv
        return PolygonDataset(name=name, verts=verts, nverts=nvs)


@dataclass
class TilePartition:
    """One partition of the (possibly skew-split) cover: its tile rect,
    raster extent (the square hull of its member MBRs), per-side object
    counts, split depth, and the cost-model estimate (work units +
    resident bytes)."""
    pid: int
    tile: tuple
    extent: Extent | None
    n_r: int = 0
    n_s: int = 0
    depth: int = 0
    est: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"pid": self.pid, "tile": [float(v) for v in self.tile],
                "n_r": self.n_r, "n_s": self.n_s, "depth": self.depth,
                "est": {k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in self.est.items()}}


@dataclass
class TilePlan:
    """The partitioner's output: the final partition cover and its packing
    into memory-budgeted tiles. ``tiles[t]`` lists indices into ``parts``;
    :meth:`cover` is the [P,4] rect array the reference-point ownership
    rule (:func:`~repro.core.partition.owner_tiles`) dedups against."""
    parts: list[TilePartition]
    tiles: list[list[int]]
    tile_budget: int
    balance: str
    est: dict = field(default_factory=dict)

    def cover(self) -> np.ndarray:
        return np.asarray([p.tile for p in self.parts], np.float64)

    def to_dict(self) -> dict:
        return {"balance": self.balance,
                "tile_budget": int(self.tile_budget),
                "parts": [p.to_dict() for p in self.parts],
                "tiles": [list(t) for t in self.tiles],
                "est": dict(self.est)}


# ---------------------------------------------------------------------------
# Phase 2: the cost model (the planner's work units over the statistics)
# ---------------------------------------------------------------------------

def estimate_partition(st_r: _SideStats, st_s: _SideStats, extent: Extent,
                       n_order: int, predicate: str, r_kind: str,
                       max_probe_pairs: int = 64) -> dict:
    """Price one partition in the adaptive planner's work units.

    Probe APRIL stores over the bottom-k samples give
    ``mean_ints_{r,s}`` (interval-count statistics → build cost and
    merge-join comparison bounds); the MBR-density histograms give
    ``est_cand`` (the co-bucket candidate quantity of the grid-hash
    join); sampled pair records (the planner's counting twins) give the mean early-exit filter comparisons, the INDECISIVE
    rate, and the mean refinement vertex product. Returns the est dict
    (work-unit components, total ``cost``, and resident ``bytes``).
    """
    from .filters import get_filter

    o = PLAN_DEFAULTS
    est_cand = float((st_r.hist * st_s.hist).sum())
    ds_r = st_r.sample_dataset("probe_r")
    ds_s = st_s.sample_dataset("probe_s")
    mean_ints_r = mean_ints_s = 0.0
    mean_cmp = 0.0
    indec_rate = 0.0
    mean_vp = 0.0
    if ds_r is not None and ds_s is not None:
        filt = get_filter("april")
        with BUILD_STAGES.stage("probe"):
            ax_r = filt.build(ds_r, n_order=n_order, extent=extent,
                              kind=r_kind)
            ax_s = filt.build(ds_s, n_order=n_order, extent=extent)
        mean_ints_r = _store_ints(ax_r.store) / len(ds_r)
        mean_ints_s = _store_ints(ax_s.store) / len(ds_s)
        mr = np.asarray([m for _, _, _, m in st_r.sample])
        ms = np.asarray([m for _, _, _, m in st_s.sample])
        cand = [(i, j) for i in range(len(mr)) for j in range(len(ms))
                if (mr[i, 0] < ms[j, 2] and mr[i, 2] > ms[j, 0]
                    and mr[i, 1] < ms[j, 3] and mr[i, 3] > ms[j, 1])]
        cand = cand[:max_probe_pairs]
        if cand:
            recs = []
            for i, j in cand:
                Ar, Fr = _lists(ax_r.store, i, r_kind)
                As_, Fs = _lists(ax_s.store, j, "polygon")
                recs.append(_pair_record(
                    Ar, Fr, As_, Fs,
                    float(ds_r.nverts[i]) * float(ds_s.nverts[j]),
                    predicate))
            m = len(recs)
            mean_cmp = sum(_order_work(r, ORDER_CHOICES[0], predicate)
                           for r in recs) / m
            from ..core.join import INDECISIVE
            indec = [r for r in recs if r["verdict"] == INDECISIVE]
            indec_rate = len(indec) / m
            mean_vp = (sum(r["refine"] for r in indec) / len(indec)
                       if indec else 0.0)

    build_w = o["c_build"] * (mean_ints_r * st_r.n + mean_ints_s * st_s.n)
    filter_w = est_cand * mean_cmp
    refine_w = o["c_refine"] * est_cand * indec_rate * mean_vp
    size = (st_r.n * st_r.vmax * 16 + st_s.n * st_s.vmax * 16
            + 8 * (mean_ints_r * st_r.n + mean_ints_s * st_s.n)
            + 32 * est_cand)
    return {"est_cand": est_cand, "mean_ints_r": mean_ints_r,
            "mean_ints_s": mean_ints_s, "mean_cmp": mean_cmp,
            "indec_rate": indec_rate, "mean_vp": mean_vp,
            "build": build_w, "filter": filter_w, "refine": refine_w,
            "cost": build_w + filter_w + refine_w, "bytes": float(size)}


# ---------------------------------------------------------------------------
# Phase 3: skew split + tile packing
# ---------------------------------------------------------------------------

class _SpillStore:
    """All partition spills + statistics of one scale-out run."""

    def __init__(self, root: str, D: int, k: int, seed: int):
        self.root = root
        self.D = D
        self.k = k
        self.seed = seed
        self.spills: dict[tuple[str, int], _SideSpill] = {}
        self.stats: dict[tuple[str, int], _SideStats] = {}

    def side(self, side: str, pid: int, tile) -> tuple[_SideSpill,
                                                       _SideStats]:
        key = (side, pid)
        if key not in self.spills:
            self.spills[key] = _SideSpill(self.root, side, pid)
            salt = zlib.crc32(f"{pid}:{side}:{self.seed}".encode())
            self.stats[key] = _SideStats(tile, self.k, self.D, salt)
        return self.spills[key], self.stats[key]

    def add(self, side: str, pid: int, tile, gid, verts, nverts,
            mbrs) -> None:
        hit = tile_hits(mbrs, tile)
        if not hit.any():
            return
        spill, st = self.side(side, pid, tile)
        spill.append(gid[hit], verts[hit], nverts[hit], mbrs[hit])
        st.update(gid[hit], verts[hit], nverts[hit], mbrs[hit])

    def drop(self, pid: int) -> None:
        for side in ("r", "s"):
            sp = self.spills.pop((side, pid), None)
            if sp is not None:
                sp.remove()
            self.stats.pop((side, pid), None)


def _spill_side(store: _SpillStore, side: str, chunks, parts) -> int:
    """Stream one side's chunks into every base partition spill; returns
    the total object count (global ids are chunk offsets + local index)."""
    offset = 0
    for chunk in chunks:
        gid = offset + np.arange(len(chunk), dtype=np.int64)
        for p in parts:
            store.add(side, p.pid, p.tile, gid, chunk.verts, chunk.nverts,
                      chunk.mbrs)
        offset += len(chunk)
    return offset


def _finish_partition(store: _SpillStore, part: TilePartition,
                      n_order: int, predicate: str, r_kind: str,
                      max_probe_pairs: int) -> None:
    """Fill a partition's extent + cost estimate from its side stats."""
    st_r = store.stats.get(("r", part.pid))
    st_s = store.stats.get(("s", part.pid))
    part.n_r = st_r.n if st_r else 0
    part.n_s = st_s.n if st_s else 0
    boxes = []
    for st in (st_r, st_s):
        if st is not None and st.n:
            boxes.append(np.concatenate([st.lo, st.hi]))
    part.extent = square_extent(
        np.asarray(boxes).reshape(-1, 4), part.tile)
    if st_r is None or st_s is None or not (st_r.n and st_s.n):
        part.est = {"cost": 0.0, "bytes": 0.0, "est_cand": 0.0}
        return
    part.est = estimate_partition(st_r, st_s, part.extent, n_order,
                                  predicate, r_kind, max_probe_pairs)


def _split_partition(store: _SpillStore, part: TilePartition,
                     next_pid: int, n_order: int, predicate: str,
                     r_kind: str, max_probe_pairs: int
                     ) -> list[TilePartition]:
    """Re-spill one hot partition into its 2x2 quadrant children (reads the
    parent spill chunk-by-chunk — O(chunk) host memory) and price them."""
    children = [TilePartition(pid=next_pid + q, tile=rect, extent=None,
                              depth=part.depth + 1)
                for q, rect in enumerate(quadrants(part.tile))]
    for side in ("r", "s"):
        parent = store.spills.get((side, part.pid))
        if parent is None:
            continue
        for ch in parent.iter_chunks():
            for c in children:
                store.add(side, c.pid, c.tile, ch["gid"], ch["verts"],
                          ch["nverts"], ch["mbrs"])
    store.drop(part.pid)
    for c in children:
        _finish_partition(store, c, n_order, predicate, r_kind,
                          max_probe_pairs)
    return children


def plan_scaleout(r_chunks, s_chunks, *, spill_dir: str,
                  n_order: int = 8, predicate: str = "intersects",
                  r_kind: str = "polygon", **opts
                  ) -> tuple[TilePlan, _SpillStore, tuple[int, int]]:
    """Phases 1-3: spill both streams, price the partitions, split skew,
    pack tiles. Returns (plan, spill store, (n_r_total, n_s_total)).
    Deterministic for fixed inputs and options. Host memory stays
    O(chunk) + O(samples).
    """
    unknown = set(opts) - set(SCALEOUT_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown scaleout option(s) {sorted(unknown)}; "
                        f"expected a subset of {sorted(SCALEOUT_DEFAULTS)}")
    o = dict(SCALEOUT_DEFAULTS)
    o.update(opts)
    check_balance(o["balance"])
    k = int(o["parts_per_dim"])
    store = _SpillStore(spill_dir, int(o["density_grid"]),
                        int(o["sample_size"]), int(o["seed"]))
    parts = []
    pid = 0
    for ty in range(k):
        for tx in range(k):
            parts.append(TilePartition(
                pid=pid, tile=(tx / k, ty / k, (tx + 1) / k, (ty + 1) / k),
                extent=None))
            pid += 1
    n_r = _spill_side(store, "r", _as_chunks(r_chunks), parts)
    n_s = _spill_side(store, "s", _as_chunks(s_chunks), parts)
    for p in parts:
        _finish_partition(store, p, n_order, predicate, r_kind,
                          int(o["max_probe_pairs"]))

    n_splits = 0
    if o["balance"] == "cost":
        base_costs = sorted(p.est["cost"] for p in parts)
        median = base_costs[len(base_costs) // 2] if base_costs else 0.0
        threshold = float(o["split_factor"]) * max(median, 1e-9)
        work = list(parts)
        final: list[TilePartition] = []
        while work:
            p = work.pop(0)
            if (median > 0 and p.est["cost"] > threshold
                    and p.n_r + p.n_s >= int(o["min_split_objs"])
                    and p.depth < int(o["max_split_depth"])):
                children = _split_partition(
                    store, p, pid, n_order, predicate, r_kind,
                    int(o["max_probe_pairs"]))
                pid += len(children)
                n_splits += 1
                work = children + work      # children may split again
            else:
                final.append(p)
        parts = sorted(final, key=lambda p: p.pid)

    # pack partitions into memory-budgeted tiles
    budget = int(o["tile_budget"])
    idx = list(range(len(parts)))
    if o["balance"] == "cost":
        idx.sort(key=lambda i: (-parts[i].est["bytes"], parts[i].pid))
    tiles: list[list[int]] = []
    loads: list[float] = []
    for i in idx:
        b = parts[i].est["bytes"]
        placed = False
        if o["balance"] == "cost":
            for t in range(len(tiles)):
                if loads[t] + b <= budget:
                    tiles[t].append(i)
                    loads[t] += b
                    placed = True
                    break
        elif tiles and loads[-1] + b <= budget:
            tiles[-1].append(i)       # static: order-preserving fill
            loads[-1] += b
            placed = True
        if not placed:
            tiles.append([i])         # oversized partitions ride alone
            loads.append(b)
    for t in tiles:
        t.sort()
    plan = TilePlan(parts=parts, tiles=tiles, tile_budget=budget,
                    balance=o["balance"],
                    est={"n_splits": n_splits,
                         "total_cost": round(sum(p.est["cost"]
                                                 for p in parts), 3),
                         "total_bytes": round(sum(p.est["bytes"]
                                                  for p in parts), 1),
                         "tile_loads": [round(x, 1) for x in loads]})
    return plan, store, (n_r, n_s)


# ---------------------------------------------------------------------------
# Phase 4: the streaming join
# ---------------------------------------------------------------------------

def _fingerprint(plan: TilePlan, n_r: int, n_s: int, predicate: str,
                 method: str, n_order: int, r_kind: str) -> int:
    """Identity of a run's work plan: a resumed checkpoint is honored only
    when the tile plan AND the join configuration both match."""
    doc = {"plan": plan.to_dict(), "n_r": n_r, "n_s": n_s,
           "predicate": predicate, "method": method, "n_order": n_order,
           "r_kind": r_kind}
    return zlib.crc32(json.dumps(doc, sort_keys=True).encode())


_COUNT_KEYS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
               "n_results")
_TIME_KEYS = ("t_mbr", "t_filter", "t_refine", "t_sync", "t_build")


def _execute_partition(Rp, Sp, part: TilePartition, *, predicate, method,
                       n_order, filter_backend, refine_backend, mbr_backend,
                       pipeline_mode, plan_mode, plan_opts, profile_cache,
                       mesh, r_kind, device, totals: dict) -> np.ndarray:
    """Join one partition's local datasets on ``device``; returns LOCAL
    result pairs (ownership not yet applied) and adds its counts and times
    to ``totals``. With a mesh, an APRIL or ``none`` fused ``intersects``
    plan runs through the rank-sharded chain."""
    plan_kw = dict(filter=method, n_order=n_order, extent=part.extent,
                   filter_backend=filter_backend,
                   refine_backend=refine_backend, mbr_backend=mbr_backend,
                   r_kind=r_kind, device=device)
    choice = None
    if plan_mode == "adaptive":
        jp = JoinPlan(Rp, Sp, plan_mode="adaptive",
                      plan_opts=dict(plan_opts or {}), **plan_kw)
        cand = jp.candidates(predicate)
        key = None
        if profile_cache is not None:
            key = profile_cache.key(predicate, len(Rp), len(Sp), len(cand))
            choice = profile_cache.get(key)
        if choice is None:
            choice = jp.plan(predicate, pairs=cand)
            if profile_cache is not None:
                profile_cache.put(key, choice)
        else:
            jp._apply_choice(choice)
    else:
        jp = JoinPlan(Rp, Sp, pipeline_mode=pipeline_mode, **plan_kw)

    if (mesh is not None and predicate == "intersects"
            and jp.pipeline_mode == "fused"
            and jp.filter.name in ("april", "none")):
        from .distributed import distributed_fused_join
        t0 = time.perf_counter()
        if jp.filter.name == "none" or (
                choice is not None and choice.skip_filter):
            # no interval lists: every valid row refines
            ar = as_ = None
            choice = choice or PlanChoice(method="none", n_order=n_order)
        else:
            jp.build()
            ar, as_ = jp.approx_r, jp.approx_s
        pairs, counts = distributed_fused_join(Rp, Sp, ar, as_, mesh=mesh,
                                               plan=choice)
        totals["t_filter"] += time.perf_counter() - t0
        totals["t_build"] += jp._t_build
        totals["n_candidates"] += int(counts.get("mbr_pairs", 0))
        totals["n_true_hits"] += int(counts.get("true_hit", 0))
        totals["n_true_negs"] += int(counts.get("true_neg", 0))
        totals["n_indecisive"] += int(counts.get("indecisive", 0))
        return pairs

    pairs, st = jp.execute(predicate)
    for kk in _COUNT_KEYS:
        totals[kk] += getattr(st, kk)
    for kk in _TIME_KEYS:
        totals[kk] += getattr(st, kk)
    return pairs


def tiled_join(r_chunks, s_chunks, *, predicate: str = "intersects",
               method: str = "april", n_order: int = 8,
               filter_backend: str | None = None,
               refine_backend: str | None = None,
               mbr_backend: str = "numpy", pipeline_mode: str = "staged",
               plan_mode: str = "static", plan_opts: dict | None = None,
               r_kind: str = "polygon", mesh=None,
               spill_dir: str | None = None, ckpt_dir: str | None = None,
               resume: bool = True, stop_after_tiles: int | None = None,
               profile_cache: ProfileCache | None = None, device=None,
               **opts) -> tuple[np.ndarray, JoinStats]:
    """The out-of-core tiled join (the module docstring has the protocol).
    ``r_chunks``/``s_chunks`` stream in as chunk iterators (or in-memory
    datasets, chunked here); result pairs are GLOBAL ids, the pair set of
    the in-memory ``JoinPlan``. Each partition's ``JoinPlan`` runs on
    ``device`` (``None`` -> ``"cuda"``, which raises without a GPU); the
    filter and refine backends default to the device's own (``cuda`` on
    the card, ``torch`` on the CPU), as ``JoinPlan``'s do. A ``mesh``
    (``distributed.make_join_mesh``) sends APRIL and ``none`` fused
    ``intersects`` plans through the rank-sharded chain on its device;
    under a process group every rank runs every tile, and rank 0 alone
    writes the checkpoint.

    ``**opts`` are the :data:`SCALEOUT_DEFAULTS` partitioner knobs
    (``tile_budget``, ``balance``, ``split_factor``, ...). ``ckpt_dir``
    keeps the completed-tile manifest: every finished tile checkpoints,
    and a rerun with ``resume=True`` (the default) starts at the first
    unfinished tile, unless the plan or the configuration changed (the
    fingerprint). ``stop_after_tiles`` ends a run after N tiles (the
    kill-and-resume hook); its stats carry ``extra["interrupted"]``.

    Returns ``(pairs [K,2] int64, JoinStats)``, the stats with
    ``t_partition`` (spill, statistics, split and pack seconds), ``tiles``
    and ``extra["tile_plan"]``.
    """
    dev = resolve_device(device)
    default = "cuda" if dev.type == "cuda" else "torch"
    filter_backend = filter_backend or default
    refine_backend = refine_backend or default
    own_spill = spill_dir is None
    if own_spill:
        spill_dir = tempfile.mkdtemp(prefix="scaleout_spill_")
    try:
        t0 = time.perf_counter()
        plan, store, (n_r, n_s) = plan_scaleout(
            r_chunks, s_chunks, spill_dir=spill_dir, n_order=n_order,
            predicate=predicate, r_kind=r_kind, **opts)
        t_partition = time.perf_counter() - t0

        fp = _fingerprint(plan, n_r, n_s, predicate, method, n_order,
                          r_kind)
        mgr = None
        done: dict[int, np.ndarray] = {}
        tile_counts: dict[str, dict] = {}
        if ckpt_dir is not None:
            from ..runtime.checkpoint import CheckpointManager
            mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
            restored = mgr.restore() if resume else None
            if restored is not None:
                _, flat, extra = restored
                if extra.get("fingerprint") == fp:
                    done = {int(k.split("_")[1]): v for k, v in flat.items()
                            if k.startswith("tile_")}
                    tile_counts = dict(extra.get("tile_counts", {}))
            if mesh is not None:
                mesh.barrier()      # every rank restored before rank 0 saves
                if mesh.rank != 0:
                    mgr = None
        totals = {kk: 0 for kk in _COUNT_KEYS}
        totals.update({kk: 0.0 for kk in _TIME_KEYS})
        for ti_key, c in tile_counts.items():
            if int(ti_key) in done:
                for kk, v in c.items():
                    totals[kk] += v
        cover = plan.cover()
        n_resumed = len(done)
        interrupted = False

        for ti, tile in enumerate(plan.tiles):
            if ti in done:
                continue
            if stop_after_tiles is not None and \
                    len(done) - n_resumed >= stop_after_tiles:
                interrupted = True
                break
            before = dict(totals)
            tile_pairs = []
            for part_i in tile:
                part = plan.parts[part_i]
                if part.n_r == 0 or part.n_s == 0:
                    continue
                gid_r, verts_r, nv_r, mbrs_r = \
                    store.spills[("r", part.pid)].load()
                gid_s, verts_s, nv_s, mbrs_s = \
                    store.spills[("s", part.pid)].load()
                Rp = PolygonDataset(name="r", verts=verts_r, nverts=nv_r)
                Sp = PolygonDataset(name="s", verts=verts_s, nverts=nv_s)
                local = _execute_partition(
                    Rp, Sp, part, predicate=predicate, method=method,
                    n_order=n_order, filter_backend=filter_backend,
                    refine_backend=refine_backend, mbr_backend=mbr_backend,
                    pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                    plan_opts=plan_opts, profile_cache=profile_cache,
                    mesh=mesh, r_kind=r_kind, device=dev, totals=totals)
                if len(local) == 0:
                    continue
                own = owner_tiles(cover, mbrs_r[local[:, 0]],
                                  mbrs_s[local[:, 1]]) == part_i
                local = local[own]
                tile_pairs.append(np.stack(
                    [gid_r[local[:, 0]], gid_s[local[:, 1]]], axis=1))
            done[ti] = (np.concatenate(tile_pairs, axis=0) if tile_pairs
                        else np.zeros((0, 2), np.int64))
            tile_counts[str(ti)] = {
                kk: totals[kk] - before[kk]
                for kk in (*_COUNT_KEYS, *_TIME_KEYS)}
            if mgr is not None:
                mgr.save(len(done),
                         {f"tile_{k}": v for k, v in done.items()},
                         extra={"fingerprint": fp,
                                "tile_counts": tile_counts,
                                "tile_plan": plan.to_dict()})

        pairs = (np.concatenate([done[t] for t in sorted(done)], axis=0)
                 if done else np.zeros((0, 2), np.int64))
        stats = JoinStats(method=method, predicate=predicate,
                          filter_backend=filter_backend,
                          backend=filter_backend,
                          refine_backend=refine_backend,
                          mbr_backend=mbr_backend,
                          pipeline_mode=pipeline_mode, plan_mode=plan_mode,
                          tiles=len(plan.tiles), t_partition=t_partition)
        for kk in _COUNT_KEYS:
            setattr(stats, kk, int(totals[kk]))
        for kk in _TIME_KEYS:
            setattr(stats, kk, float(totals[kk]))
        stats.n_results = int(len(pairs))
        stats.extra["tile_plan"] = plan.est | {
            "balance": plan.balance, "n_parts": len(plan.parts),
            "n_tiles": len(plan.tiles)}
        stats.extra["resumed_tiles"] = n_resumed
        if interrupted:
            stats.extra["interrupted"] = True
        if profile_cache is not None:
            stats.extra["profile_cache"] = dict(profile_cache.stats)
        return pairs, stats
    finally:
        if own_spill:
            shutil.rmtree(spill_dir, ignore_errors=True)
