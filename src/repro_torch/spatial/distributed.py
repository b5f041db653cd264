"""Rank-sharded stages of the partitioned spatial join, over
``torch.distributed``.

The join is partition-parallel (paper §5.2): the launcher
(``launch/spatial_join.py``) and the tiled join (``spatial/scaleout.py``)
call these stages once per partition, with its own approximations and
candidate frame. Within a call the padded rows of the frame split into
``mesh.size`` contiguous shards, one a rank (a :class:`JoinMesh`: a
device, a process group, a rank); each rank runs its shard on its device,
brings its lanes to the host once, and the lanes are ``all_gather``ed
there, so every rank returns the same arrays. Counts are ``all_reduce``d.
Collectives work on host tensors (the ``gloo`` backend: NCCL refuses two
ranks on one GPU, and the lanes reach the host once anyway). A mesh of
one rank calls no collective.

* :func:`distributed_mbr_join` — the grid-hash MBR join: the host builds
  the co-bucket rows, each rank tests its shard's intersection and
  reference-point ownership as a float64 device lane.
* :func:`distributed_filter` — any registered filter. Filters with
  ``supports_mesh`` (APRIL) on a device backend shard the candidate rows
  (:func:`sharded_trichotomy`): each rank runs one trichotomy launch (B1)
  over its rows on the cached CSR interval lists. The others run their
  batched ``verdicts``. :func:`pack_pair_batch`, :func:`bucket_pairs` and
  :func:`distributed_april_filter` keep the reference's packed batches
  (power-of-two width buckets, padded lists) and its filter over them;
  no join path takes them, since B1 reads CSR and needs no padding.
* :func:`distributed_refine` — the float64 device cores over the
  vertex-count buckets of the INDECISIVE pairs, guard-band rows re-checked
  on the host.
* :func:`distributed_fused_join` — the ``intersects`` chain of one shard:
  MBR mask lane, the trichotomy's status lane under it, the compaction
  (B3) of the INDECISIVE rows, the float64 refine lanes over the packed
  frame (the fused ``JoinPlan``'s pieces: rows past the device-side
  count are masked), then one gather. The reference's step instead
  refines every row in frame order, branch-free.

Every stage returns what the reference's returns, in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core import join
from ..core.join import INDECISIVE, TRUE_HIT, TRUE_NEG, pack_lists
from ..device import check_backend_device, resolve_device, upload
from ..kernels.interval_join import CSRLists
from . import refine as RF
from .filters import Approximation, get_filter
from .fused import (_CHAINS, CandidateSet, device_frame, mask_status,
                    refine_lanes, to_host)
from .mbr_join import _pad_rows_pow2, _prepare, candidate_rows, pair_mask_lane

__all__ = [
    "JoinMesh", "make_join_mesh", "PackedPairs", "pack_pair_batch",
    "bucket_pairs", "distributed_april_filter", "sharded_trichotomy",
    "distributed_filter",
    "distributed_mbr_join", "distributed_refine", "distributed_fused_join",
    "ShardFrame", "shard_frame", "fused_shard_lanes",
]

I32_MAX = np.int32(np.iinfo(np.int32).max)

#: the device filter backends a shard runs on
_DEVICE_BACKENDS = ("torch", "cuda")


# ---------------------------------------------------------------------------
# The mesh: a device and the ranks of a process group
# ---------------------------------------------------------------------------

@dataclass
class JoinMesh:
    """Where a sharded stage runs: this rank's ``device``, the process
    ``group`` (``None`` for a world of one), this process's ``rank`` in it
    and the group's ``size``."""
    device: torch.device
    group: object | None
    rank: int
    size: int

    @property
    def backend(self) -> str:
        """The device's own filter backend: ``cuda`` (the kernels) on a
        CUDA device, ``torch`` (their plain versions) elsewhere."""
        return "cuda" if self.device.type == "cuda" else "torch"

    def shard(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` padded rows (``n`` a
        multiple of ``size``)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        """Wait for every rank (nothing to wait for in a world of one)."""
        if self.size > 1:
            dist.barrier(group=self.group)

    def all_sum(self, counts) -> np.ndarray:
        """int64 ``counts`` summed over the ranks."""
        counts = np.array(counts, np.int64)
        if self.size == 1:
            return counts
        t = torch.from_numpy(counts)
        dist.all_reduce(t, group=self.group)
        return t.numpy()

    def shard_pairs(self, pairs: np.ndarray) -> tuple[np.ndarray,
                                                      np.ndarray]:
        """This rank's share of ``pairs`` [N, 2] (N > 0) padded to a
        multiple of the rank count, and which of its rows are real. Pad
        rows repeat the first pair, so that they stay within its lists and
        ring widths."""
        B = max(self.size, -(-len(pairs) // self.size) * self.size)
        padded = np.concatenate([pairs, np.repeat(pairs[:1], B - len(pairs),
                                                  axis=0)])
        sh = self.shard(B)
        return np.ascontiguousarray(padded[sh]), np.arange(B)[sh] < len(pairs)

    def all_gather(self, *lanes: np.ndarray) -> tuple[np.ndarray, ...]:
        """One-byte host lanes (bool or int8) of this rank's shard,
        concatenated over the ranks in rank order."""
        if self.size == 1:
            return lanes
        t = torch.from_numpy(np.stack([np.ascontiguousarray(x).view(np.uint8)
                                       for x in lanes]))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        full = torch.cat(parts, dim=1).numpy()
        return tuple(row.view(x.dtype) for row, x in zip(full, lanes))


def make_join_mesh(n_devices: int | None = None, *, device=None,
                   group=None) -> JoinMesh:
    """The mesh of this process: ``device`` (``None`` -> ``"cuda"``, which
    raises without a GPU), ``group`` (default: the default process group
    when one is initialised, else none) and this process's rank in it.
    ``n_devices``, when given, must equal the group's size: a rank runs
    one device."""
    dev = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is not None:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    else:
        rank, size = 0, 1
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} rank(s); a rank runs one device")
    return JoinMesh(device=dev, group=group, rank=rank, size=size)


def _mesh_backend(mesh: JoinMesh, backend: str | None) -> str:
    backend = backend or mesh.backend
    join.check_filter_backend(backend)
    if backend not in _DEVICE_BACKENDS:
        raise ValueError(f"a sharded stage runs on a device backend "
                         f"{_DEVICE_BACKENDS}, got {backend!r}")
    check_backend_device(backend, mesh.device)
    return backend


# ---------------------------------------------------------------------------
# Packed filter batches
# ---------------------------------------------------------------------------

@dataclass
class PackedPairs:
    """A padded batch of N candidate pairs (biased int32, inclusive
    lasts, pad slots I32_MAX)."""
    ra_s: np.ndarray; ra_l: np.ndarray; ra_n: np.ndarray   # A(r)  # noqa: E702
    rf_s: np.ndarray; rf_l: np.ndarray; rf_n: np.ndarray   # F(r)  # noqa: E702
    sa_s: np.ndarray; sa_l: np.ndarray; sa_n: np.ndarray   # A(s)  # noqa: E702
    sf_s: np.ndarray; sf_l: np.ndarray; sf_n: np.ndarray   # F(s)  # noqa: E702
    pair_idx: np.ndarray                                   # [B, 2] pair ids
    valid: np.ndarray                                      # [B] bool

    def __len__(self):
        return len(self.valid)

    def arrays(self) -> dict:
        return {k: getattr(self, k) for k in (
            "ra_s", "ra_l", "ra_n", "rf_s", "rf_l", "rf_n",
            "sa_s", "sa_l", "sa_n", "sf_s", "sf_l", "sf_n")}


def pack_pair_batch(store_r, store_s, pairs: np.ndarray,
                    pad_batch_to: int = 1,
                    pad_width_to: int = 8) -> PackedPairs:
    """A ``[N, 2]`` candidate batch packed into :class:`PackedPairs`: rows
    padded to a multiple of ``pad_batch_to`` (the rank count, so that the
    shards are equal), list widths to a multiple of ``pad_width_to``. One
    vectorized gather per list kind."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    B = len(pairs)
    Bp = max(pad_batch_to,
             ((B + pad_batch_to - 1) // pad_batch_to) * pad_batch_to)

    def pad_rows(x, fill):
        if len(x) == Bp:
            return x
        pad = np.full((Bp - len(x),) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, pad], axis=0)

    def mk(store, idx, kind):
        s, l, n = pack_lists(store, idx, kind, pad_to=pad_width_to)
        w = ((s.shape[1] + pad_width_to - 1) // pad_width_to) * pad_width_to
        if s.shape[1] < w:
            extra = np.full((s.shape[0], w - s.shape[1]), I32_MAX, np.int32)
            s = np.concatenate([s, extra], axis=1)
            l = np.concatenate([l, extra], axis=1)
        return pad_rows(s, I32_MAX), pad_rows(l, I32_MAX), pad_rows(n, 0)

    ra = mk(store_r, pairs[:, 0], "A")
    rf = mk(store_r, pairs[:, 0], "F")
    sa = mk(store_s, pairs[:, 1], "A")
    sf = mk(store_s, pairs[:, 1], "F")
    valid = pad_rows(np.ones(B, bool), False)
    pidx = pad_rows(pairs, -1)
    return PackedPairs(*ra, *rf, *sa, *sf, pair_idx=pidx, valid=valid)


def bucket_pairs(store_r, store_s, pairs: np.ndarray, n_devices: int = 1,
                 max_width: int = 512) -> list[PackedPairs]:
    """A ``[N, 2]`` batch split into power-of-two buckets of A-list width
    (at least 8, capped at ``max_width``), each packed with
    :func:`pack_pair_batch`: the bucket bounds a batch's padding."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if len(pairs) == 0:
        return []
    wa = store_r.a_off[pairs[:, 0] + 1] - store_r.a_off[pairs[:, 0]]
    wb = store_s.a_off[pairs[:, 1] + 1] - store_s.a_off[pairs[:, 1]]
    width = np.minimum(np.maximum(np.maximum(wa, wb), 1), max_width)
    bucket = np.maximum(
        np.left_shift(1, np.ceil(np.log2(width)).astype(np.int64)), 8)
    return [
        pack_pair_batch(store_r, store_s, pairs[bucket == bw],
                        pad_batch_to=n_devices, pad_width_to=int(bw))
        for bw in np.unique(bucket)
    ]


def _csr_lists(s: np.ndarray, l: np.ndarray, n: np.ndarray,
               dev: torch.device) -> CSRLists:
    """Padded rows [B, W] as CSR lists on ``dev``: the slots under
    ``arange(W) < n`` in row order, offsets from ``n``, and one I32_MAX
    slot past the last offset (no row reaches it). Pad slots never enter
    the kernel: two I32_MAX pads would overlap each other."""
    st, lt = upload(s, dev), upload(l, dev)
    n64 = upload(n, dev).to(torch.int64)
    off = torch.zeros(len(n) + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(n64, 0)
    mask = torch.arange(s.shape[1], device=dev)[None, :] < n64[:, None]
    tail = torch.full((1,), int(I32_MAX), dtype=torch.int32, device=dev)
    return CSRLists(off, torch.cat([st[mask], tail]),
                    torch.cat([lt[mask], tail]))


def distributed_april_filter(packed: PackedPairs,
                             mesh: JoinMesh | None = None,
                             backend: str | None = None):
    """The APRIL ``intersects`` trichotomy of one packed batch, sharded
    over the ranks of ``mesh`` (``None``: this process on the card). Each
    rank uploads its shard, turns the padded lists into CSR on its device
    and runs the trichotomy kernel (``backend="cuda"``) or its plain
    version (``"torch"``; default the device's own) over its rows. Returns
    (verdicts [B] int8, pad rows -1; counts of the valid rows)."""
    mesh = mesh or make_join_mesh()
    backend = _mesh_backend(mesh, backend)
    dev = mesh.device
    sh = mesh.shard(len(packed))
    lists = [_csr_lists(getattr(packed, f"{k}_s")[sh],
                        getattr(packed, f"{k}_l")[sh],
                        getattr(packed, f"{k}_n")[sh], dev)
             for k in ("ra", "rf", "sa", "sf")]
    rows = torch.arange(sh.stop - sh.start, device=dev)
    verd = join._interval_join("april_trichotomy", backend, *lists, rows,
                               rows)
    verd = torch.where(upload(packed.valid[sh], dev), verd, -1)
    (verd,) = to_host(verd.to(torch.int8))
    counts = mesh.all_sum([np.sum(verd == c)
                           for c in (TRUE_NEG, TRUE_HIT, INDECISIVE)])
    (verd,) = mesh.all_gather(verd)
    return verd, {"true_neg": int(counts[0]), "true_hit": int(counts[1]),
                  "indecisive": int(counts[2])}


_VERDICT_NAMES = ("true_neg", "true_hit", "indecisive")


def sharded_trichotomy(approx_r, approx_s, pairs: np.ndarray,
                       mesh: JoinMesh, backend: str | None = None):
    """APRIL's ``intersects`` trichotomy of ``pairs`` [N, 2] with the rows
    sharded over the ranks of ``mesh``: each rank runs one trichotomy
    launch (``backend="cuda"``) or its plain version (``"torch"``; default
    the device's own) over its share of the rows, on the CSR interval
    lists ``approx_r``/``approx_s`` cache (``join.fused_status_rows``),
    and the verdict lanes are gathered in batch order. Returns (verdicts
    [N] int8, counts)."""
    backend = _mesh_backend(mesh, backend)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8), dict.fromkeys(_VERDICT_NAMES, 0)
    rows, real = mesh.shard_pairs(pairs)
    lists = get_filter("april")._lists
    (verd,) = to_host(join.fused_status_rows(
        lists(approx_r, "A"), lists(approx_r, "F"), lists(approx_s, "A"),
        lists(approx_s, "F"), rows[:, 0], rows[:, 1], predicate="intersects",
        backend=backend, device=mesh.device))
    counts = mesh.all_sum([np.sum(real & (verd == c))
                           for c in (TRUE_NEG, TRUE_HIT, INDECISIVE)])
    (verd,) = mesh.all_gather(verd)
    return verd[:N], dict(zip(_VERDICT_NAMES, map(int, counts)))


def distributed_filter(filt, approx_r, approx_s, pairs: np.ndarray,
                       mesh: JoinMesh | None = None, backend: str = "numpy",
                       predicate: str = "intersects",
                       filter_backend: str | None = None):
    """A candidate batch through any registered filter; returns (verdicts
    [N] int8, counts). Filters with ``supports_mesh`` on a device backend
    (``"torch"`` or ``"cuda"``, the reference's ``"jnp"`` and
    ``"pallas"``) run the ``intersects`` trichotomy sharded over the mesh
    (``verdicts_mesh``); every other filter, backend or predicate runs the
    filter's batched ``verdicts`` on the mesh's device (for RI on
    ``"cuda"``, the RI kernel). ``filter_backend`` is the knob's name,
    ``backend`` its older alias."""
    filt = get_filter(filt)
    backend = filter_backend or backend
    join.check_filter_backend(backend)
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    if (filt.supports_mesh and backend in _DEVICE_BACKENDS
            and predicate == "intersects"):
        return filt.verdicts_mesh(approx_r, approx_s, pairs, mesh=mesh,
                                  backend=backend)
    device = None
    if backend in _DEVICE_BACKENDS:
        device = (mesh or make_join_mesh()).device
    verd = filt.verdicts(approx_r, approx_s, pairs, predicate=predicate,
                         backend=backend, device=device)
    counts = {"true_neg": int(np.sum(verd == TRUE_NEG)),
              "true_hit": int(np.sum(verd == TRUE_HIT)),
              "indecisive": int(np.sum(verd == INDECISIVE))}
    return verd, counts


# ---------------------------------------------------------------------------
# Candidate generation: the co-bucket rows sharded, the mask a device lane
# ---------------------------------------------------------------------------

def distributed_mbr_join(mbrs_r: np.ndarray, mbrs_s: np.ndarray,
                         grid: int | None = None,
                         mesh: JoinMesh | None = None):
    """The grid-hash MBR join with its O(candidates) rows sharded: the
    host expands the buckets and builds the co-bucket rows; each rank
    tests its shard's intersection and reference-point ownership as a
    float64 lane on its device (``pair_mask_lane``). Returns (pairs [K, 2]
    int64, in the order of ``mbr_join``'s numpy backend; counts
    ``mbr_candidates`` (co-bucket rows) and ``mbr_pairs``)."""
    mbrs_r, mbrs_s, k, extent = _prepare(mbrs_r, mbrs_s, grid)
    empty = (np.zeros((0, 2), np.int64),
             {"mbr_candidates": 0, "mbr_pairs": 0})
    if k == 0:
        return empty
    ri, si, own_x, own_y, lo_r, lo_s = candidate_rows(mbrs_r, mbrs_s, k,
                                                      extent)
    if len(ri) == 0:
        return empty
    mesh = mesh or make_join_mesh()
    dev = mesh.device
    (pri, psi, pox, poy, valid), n = _pad_rows_pow2(
        [ri, si, own_x, own_y, np.ones(len(ri), bool)], multiple=mesh.size)
    sh = mesh.shard(len(pri))
    keep = pair_mask_lane(mbrs_r, mbrs_s, lo_r, lo_s, upload(pri[sh], dev),
                          upload(psi[sh], dev), pox[sh], poy[sh], dev)
    (keep,) = to_host(keep & upload(valid[sh], dev))
    count = mesh.all_sum([keep.sum()])
    (keep,) = mesh.all_gather(keep)
    keep = keep[:n]
    pairs = np.stack([ri[keep], si[keep]], axis=1)
    return pairs, {"mbr_candidates": int(n), "mbr_pairs": int(count[0])}


# ---------------------------------------------------------------------------
# Refinement: the float64 device cores over the shard, per bucket chunk
# ---------------------------------------------------------------------------

_CORE_KINDS = {"intersects": "intersects", "selection": "intersects",
               "within": "within", "linestring": "line"}


def distributed_refine(R, S, pairs: np.ndarray,
                       predicate: str = "intersects",
                       mesh: JoinMesh | None = None):
    """Exact refinement of candidate pairs sharded over the ranks of
    ``mesh``. For each chunk of :func:`~repro_torch.spatial.refine.
    iter_pair_chunks` (power-of-two buckets of the Er x Es tile size), the
    chunk's rows pad to a multiple of the rank count and each rank runs
    the predicate's float64 device core (the ``device64`` route) over its
    shard; rows whose signs fell in the guard band are re-checked on the
    host (numpy float64), so the verdicts equal the host backends'.
    Returns (results [N] bool, counts ``refined_true``)."""
    kind = _CORE_KINDS.get(predicate)
    if kind is None:
        raise ValueError(f"unknown predicate {predicate!r}; expected one of "
                         f"{tuple(_CORE_KINDS)}")
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, bool), {"refined_true": 0}
    mesh = mesh or make_join_mesh()
    dev = mesh.device
    geom_r = RF.device_geometry(R, dev, kind="line" if kind == "line"
                                else "polygon")
    geom_s = RF.device_geometry(S, dev)
    out = np.zeros(N, bool)
    n_true = 0
    for sel, p, vr, _, vs, _ in RF.iter_pair_chunks(R, S, pairs):
        Va, Vb = vr.shape[1], vs.shape[1]
        rows, real = mesh.shard_pairs(p)
        rr, ss = upload(rows[:, 0].copy(), dev), upload(rows[:, 1].copy(), dev)
        C = RF._chunk_rows(Va, Vb)
        lanes = [torch.stack(RF._core_lanes(kind, geom_r, geom_s,
                                            rr[c0:c0 + C], ss[c0:c0 + C],
                                            Va, Vb))
                 for c0 in range(0, len(rows), C)]
        res, unc = to_host(*torch.cat(lanes, dim=1))
        res &= real
        unc &= real
        if unc.any():    # guard-band rows: the float64 host re-check
            res[unc] = RF.refine(R, S, rows[unc], predicate=predicate,
                                 backend="numpy")
        n_true += int(mesh.all_sum([res.sum()])[0])
        (res,) = mesh.all_gather(res)
        out[sel] = res[:len(p)]
    return out, {"refined_true": n_true}


# ---------------------------------------------------------------------------
# The fused intersects chain of one shard
# ---------------------------------------------------------------------------

@dataclass
class ShardFrame:
    """The host half of :func:`distributed_fused_join`: the co-bucket
    rows padded to a power of two and a multiple of the rank count, with
    the MBR tables the mask lane tests them against; ``n`` real rows."""
    mbrs_r: np.ndarray
    mbrs_s: np.ndarray
    lo_r: np.ndarray
    lo_s: np.ndarray
    ri: np.ndarray
    si: np.ndarray
    own_x: np.ndarray
    own_y: np.ndarray
    rows: np.ndarray          # [Bp] bool, the real rows
    n: int

    @property
    def pairs(self) -> np.ndarray:
        return np.stack([self.ri, self.si], axis=1)


def shard_frame(R, S, grid: int | None = None,
                mesh: JoinMesh | None = None) -> ShardFrame | None:
    """The padded co-bucket frame of ``R`` x ``S`` for ``mesh``'s rank
    count, or ``None`` when the MBR join has no row."""
    mbrs_r, mbrs_s, k, extent = _prepare(R.mbrs, S.mbrs, grid)
    if k == 0:
        return None
    ri, si, own_x, own_y, lo_r, lo_s = candidate_rows(mbrs_r, mbrs_s, k,
                                                      extent)
    if len(ri) == 0:
        return None
    size = mesh.size if mesh is not None else 1
    (pri, psi, pox, poy, rows), n = _pad_rows_pow2(
        [ri, si, own_x, own_y, np.ones(len(ri), bool)], multiple=size)
    return ShardFrame(mbrs_r, mbrs_s, lo_r, lo_s, pri, psi, pox, poy, rows,
                      n)


def _as_april(approx):
    """An APRIL Approximation (a raw store is wrapped)."""
    if approx is None or isinstance(approx, Approximation):
        return approx
    return Approximation(filter="april", store=approx)


def fused_shard_lanes(R, S, approx_r, approx_s, frame: ShardFrame,
                      mesh: JoinMesh, with_filter: bool = True,
                      backend: str | None = None) -> CandidateSet:
    """The device stages of this rank's shard of ``frame``, with no host
    read: the MBR mask lane (``valid``), the trichotomy's status lane
    under it (every valid row INDECISIVE when not ``with_filter``), the
    compaction of the INDECISIVE rows (the scan kernel on ``cuda``) and
    the float64 refine lanes over the packed prefix, scattered back to
    ``hit`` and ``unc``. The interval lists and geometry must already be
    on the device (``distributed_fused_join`` uploads them)."""
    backend = _mesh_backend(mesh, backend)
    dev = mesh.device
    sh = mesh.shard(len(frame.ri))
    cs = device_frame(frame.ri[sh], frame.si[sh], dev)
    cs.valid = pair_mask_lane(frame.mbrs_r, frame.mbrs_s, frame.lo_r,
                              frame.lo_s, cs.ri_dev, cs.si_dev,
                              frame.own_x[sh], frame.own_y[sh], dev) \
        & upload(frame.rows[sh], dev)
    if with_filter:
        lists = get_filter("april")._lists
        lane = join.fused_status_rows(
            lists(approx_r, "A"), lists(approx_r, "F"), lists(approx_s, "A"),
            lists(approx_s, "F"), cs.ri, cs.si, predicate="intersects",
            rows=(cs.ri_dev, cs.si_dev), backend=backend, device=dev)
    else:
        lane = torch.full((len(cs),), INDECISIVE, dtype=torch.int8,
                          device=dev)
    mask_status(cs, lane)
    return refine_lanes(cs, R, S, dev, "intersects",
                        kernel=backend == "cuda")


def distributed_fused_join(R, S, approx_r, approx_s,
                           grid: int | None = None,
                           mesh: JoinMesh | None = None,
                           plan=None, backend: str | None = None):
    """The ``intersects`` join of polygon layers ``R`` x ``S`` as one
    device chain a shard (:func:`fused_shard_lanes`): MBR mask lane ->
    the trichotomy (B1 on ``cuda``) under it -> compaction of the
    INDECISIVE rows (B3) -> float64 refine lanes -> one gather a rank,
    then the guard-band rows of the shard re-checked on the host and the
    hit lanes ``all_gather``ed. ``approx_r``/``approx_s`` are APRIL
    approximations. ``plan`` (a ``PlanChoice``) that skips the filter
    (``skip_filter`` or ``method == "none"``) marks every valid row
    INDECISIVE and launches no trichotomy; the approximations may then be
    ``None``. Its join order changes nothing: the kernel evaluates all
    three joins. ``backend`` is ``"cuda"`` or ``"torch"`` (default the
    mesh device's own). Returns (pairs [K, 2] int64 in frame order;
    counts ``mbr_pairs``, ``true_neg``, ``true_hit``, ``indecisive``)."""
    empty = np.zeros((0, 2), np.int64)
    zero = {"mbr_pairs": 0, "true_neg": 0, "true_hit": 0, "indecisive": 0}
    mesh = mesh or make_join_mesh()
    backend = _mesh_backend(mesh, backend)
    frame = shard_frame(R, S, grid, mesh)
    if frame is None:
        return empty, zero
    dev = mesh.device
    with_filter = not (plan is not None
                       and (plan.skip_filter or plan.method == "none"))
    approx_r, approx_s = _as_april(approx_r), _as_april(approx_s)
    if with_filter:
        get_filter("april").to_device(approx_r, approx_s, dev)
    RF.device_geometry(R, dev)
    RF.device_geometry(S, dev)
    cs = fused_shard_lanes(R, S, approx_r, approx_s, frame, mesh,
                           with_filter=with_filter, backend=backend)
    _CHAINS.add(cs)
    status, hit, unc, valid = to_host(cs.status, cs.hit, cs.unc, cs.valid)
    if unc.any():          # the float64 host re-check of guard-band rows
        own = np.stack([cs.ri, cs.si], axis=1)
        hit[unc] = RF.refine(R, S, own[unc], predicate="intersects",
                             backend="numpy")
    counts = mesh.all_sum([valid.sum(), (valid & (status == TRUE_NEG)).sum(),
                           (status == TRUE_HIT).sum(),
                           (valid & (status == INDECISIVE)).sum()])
    (hit,) = mesh.all_gather(hit)
    pairs = frame.pairs[:frame.n][hit[:frame.n]]
    return pairs, {"mbr_pairs": int(counts[0]), "true_neg": int(counts[1]),
                   "true_hit": int(counts[2]), "indecisive": int(counts[3])}
