"""Interval joins: the APRIL intermediate filter (paper §4.2, Algorithm 2).

* **Faithful sequential merge joins** (:func:`interval_join_pair`,
  :func:`containment_join_pair`, :func:`april_verdict_pair`,
  :func:`within_verdict_pair`, :func:`linestring_verdict_pair`) — the
  paper's two-pointer loops with early exit, the per-pair reference.
* **Batched staged trichotomies** (:func:`april_trichotomy_rows`,
  :func:`within_trichotomy_rows`, :func:`linestring_trichotomy_rows`) over
  :class:`IntervalLists`, a dataset side's lists CSR-packed in biased int32
  with inclusive lasts (a chain's cell ids as unit intervals), uploaded
  to a device once and cached. The within join's containment test runs on
  the host (:func:`contain_rows_np`) or on the device
  (:func:`contain_rows`), a row-keyed ``torch.searchsorted`` with no
  kernel of its own, as in the reference.
* **Raw-store wrappers** (:func:`april_filter_batch`,
  :func:`within_filter_batch`, :func:`linestring_filter_batch`) run the
  staged trichotomies on AprilStores and candidate pairs [N, 2], the
  stores' lists cached on the stores; :func:`batch_overlap_np` is the
  per-row host reference of the padded layout of :func:`pack_lists`.

Backends of the filter stage (``filter_backend`` on ``JoinPlan``):

* ``numpy`` — one flat row-keyed ``searchsorted`` pass on the host;
* ``torch`` — the same staged evaluation through the kernels' plain
  PyTorch versions, on whatever device the caller names;
* ``cuda`` — the fused trichotomy kernel over every row, or, for a join
  ``order`` that omits a hit join, the staged evaluation through the
  interval-overlap kernel;
* ``sequential`` — the per-pair reference loop.

The fused chain's filter stage (:func:`fused_status_rows`) writes the
verdicts of every frame row straight into a device int8 lane, with no host
read.

Verdicts follow the paper's trichotomy: TRUE_NEG (AA-join empty), TRUE_HIT
(``intersects``: the AF- or FA-join finds an overlap; ``within``: every
interval of A(r) lies inside one of F(s); ``linestring``: a cell of the
chain lies in F(s)) or INDECISIVE (forwarded to refinement).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import InputLog, check_backend_device, resolve_device, upload
from ..kernels.interval_join import (CSRLists, april_trichotomy,
                                     april_trichotomy_plain, interval_overlap,
                                     interval_overlap_plain)
from ..kernels.interval_join.ref import INDECISIVE, TRUE_HIT, TRUE_NEG
from .hilbert import u32_to_biased_i32

__all__ = [
    "TRUE_NEG", "TRUE_HIT", "INDECISIVE", "FILTER_BACKENDS",
    "check_filter_backend", "IntervalLists", "interval_join_pair",
    "containment_join_pair", "april_verdict_pair", "within_verdict_pair",
    "linestring_verdict_pair", "overlap_rows_np", "contain_rows_np",
    "contain_rows", "april_trichotomy_rows", "within_trichotomy_rows",
    "linestring_trichotomy_rows", "fused_status_rows", "record_joins",
    "csr_delete_row", "csr_append_row", "adaptive_order",
    "pack_csr_intervals", "pack_lists", "batch_overlap_np",
    "april_filter_batch", "within_filter_batch", "linestring_filter_batch",
]

I32_MAX = np.int32(np.iinfo(np.int32).max)

FILTER_BACKENDS = ("numpy", "torch", "cuda", "sequential")


#: the reference's device filter backends and the port's names for them
_REFERENCE_NAMES = {"jnp": "torch", "pallas": "cuda"}


def check_filter_backend(backend: str) -> None:
    if backend in _REFERENCE_NAMES:
        raise ValueError(f"unknown filter backend {backend!r}, the "
                         f"reference's name; the port's is filter_backend="
                         f"{_REFERENCE_NAMES[backend]!r}")
    if backend not in FILTER_BACKENDS:
        raise ValueError(f"unknown filter backend {backend!r}; "
                         f"expected one of {FILTER_BACKENDS}")


# ---------------------------------------------------------------------------
# CSR row splices (incremental store maintenance)
# ---------------------------------------------------------------------------

def csr_delete_row(off: np.ndarray, data: np.ndarray, i: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Splice row ``i`` out of a CSR (offsets [P+1], flat data) pair: the
    flat segment ``data[off[i]:off[i+1]]`` goes and later offsets shift
    down; no other row is recomputed. Any flat axis-0 layout works
    (interval tables [T, 2], cell ids [T], ...)."""
    off = np.asarray(off, np.int64)
    lo, hi = int(off[i]), int(off[i + 1])
    new_off = np.concatenate([off[:i + 1], off[i + 2:] - (hi - lo)])
    new_data = np.concatenate([data[:lo], data[hi:]], axis=0)
    return new_off, new_data


def csr_append_row(off: np.ndarray, data: np.ndarray, row: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Append one row (flat payload ``row``) to a CSR pair; existing rows
    are untouched."""
    off = np.asarray(off, np.int64)
    new_off = np.append(off, off[-1] + len(row))
    new_data = np.concatenate([data, row], axis=0)
    return new_off, new_data


# ---------------------------------------------------------------------------
# Faithful sequential joins (paper Algorithm 2, host reference)
# ---------------------------------------------------------------------------

def interval_join_pair(X: np.ndarray, Y: np.ndarray) -> bool:
    """Two-pointer merge join over sorted disjoint half-open intervals.
    Returns True iff any pair overlaps (paper Alg. 2 `IntervalJoin`)."""
    i = j = 0
    nx, ny = len(X), len(Y)
    while i < nx and j < ny:
        xs, xe = X[i]
        ys, ye = Y[j]
        if xs < ye and ys < xe:
            return True
        if xe <= ye:
            i += 1
        else:
            j += 1
    return False


def containment_join_pair(X: np.ndarray, F: np.ndarray) -> bool:
    """True iff EVERY interval of X lies inside some interval of F (the
    within join's variant of the AF-join, §4.3.2)."""
    j = 0
    nf = len(F)
    for xs, xe in X:
        while j < nf and F[j][1] < xe:
            j += 1
        if j >= nf or not (F[j][0] <= xs and xe <= F[j][1]):
            return False
    return True


def april_verdict_pair(
    Ar: np.ndarray, Fr: np.ndarray, As: np.ndarray, Fs: np.ndarray,
    order: tuple[str, ...] = ("AA", "AF", "FA"),
) -> int:
    """APRIL intermediate filter for one candidate pair (Algorithm 2).

    ``order`` permutes the three joins; semantics are order-invariant on
    stores with F ⊆ A, early exits differ.
    """
    lists = {"AA": (Ar, As), "AF": (Ar, Fs), "FA": (Fr, As)}
    aa_overlap = None
    for step in order:
        X, Y = lists[step]
        hit = interval_join_pair(X, Y)
        if step == "AA":
            aa_overlap = hit
            if not hit:
                return TRUE_NEG
        elif hit:
            return TRUE_HIT
    if aa_overlap is None:
        raise ValueError("order must include 'AA'")
    return INDECISIVE


def adaptive_order(mbr_r, mbr_s, nf_r: int, nf_s: int) -> tuple[str, ...]:
    """A per-pair join order from statistics known before any interval
    work (the paper's §9 future-work item): where the common MBR covers
    most of the smaller object the pair is likely a TRUE_HIT, so a hit join
    runs first (AF or FA, the side with the longer F list); otherwise AA
    stays first, the paper's default."""
    ix = max(0.0, min(mbr_r[2], mbr_s[2]) - max(mbr_r[0], mbr_s[0]))
    iy = max(0.0, min(mbr_r[3], mbr_s[3]) - max(mbr_r[1], mbr_s[1]))
    inter = ix * iy
    area_r = max(1e-30, (mbr_r[2] - mbr_r[0]) * (mbr_r[3] - mbr_r[1]))
    area_s = max(1e-30, (mbr_s[2] - mbr_s[0]) * (mbr_s[3] - mbr_s[1]))
    cover = inter / min(area_r, area_s)
    if cover > 0.6 and (nf_r or nf_s):
        return ("AF", "FA", "AA") if nf_s >= nf_r else ("FA", "AF", "AA")
    return ("AA", "AF", "FA")


def within_verdict_pair(Ar, Fr, As, Fs) -> int:
    """Within-join filter for one pair (§4.3.2): is r within s? A(r) and
    A(s) disjoint -> TRUE_NEG; every A(r) interval inside an F(s) interval
    -> TRUE_HIT; else INDECISIVE. ``Fr`` is unused."""
    if not interval_join_pair(Ar, As):
        return TRUE_NEG
    if len(Ar) and containment_join_pair(Ar, Fs):
        return TRUE_HIT
    return INDECISIVE


def linestring_verdict_pair(Ap, Fp, cell_ids: np.ndarray) -> int:
    """Polygon x linestring filter for one pair (§4.3.3): the chain is its
    sorted Partial cell ids, joined as unit intervals. No cell in A(p) ->
    TRUE_NEG; a cell in F(p) -> TRUE_HIT; else INDECISIVE."""
    ids = np.asarray(cell_ids)
    cells = np.stack([ids, ids + ids.dtype.type(1)], axis=1) if len(ids) \
        else np.zeros((0, 2), np.uint64)
    if not interval_join_pair(Ap, cells):
        return TRUE_NEG
    if interval_join_pair(Fp, cells):
        return TRUE_HIT
    return INDECISIVE


# ---------------------------------------------------------------------------
# Padded packing (the partitioned launcher's filter batches)
# ---------------------------------------------------------------------------

def pack_csr_intervals(off: np.ndarray, ints: np.ndarray, idx: np.ndarray,
                       pad_to: int | None = None):
    """Rows ``idx`` of the CSR interval lists ``ints[off[i]:off[i+1]]``
    packed into padded biased-int32 arrays: (starts [B, I], lasts [B, I],
    counts [B] int32), I the widest row (at least ``pad_to``), lasts
    inclusive (end - 1), padding slots I32_MAX. One vectorized gather."""
    idx = np.asarray(idx, np.int64)
    lo = off[idx]
    counts = (off[idx + 1] - lo).astype(np.int32)
    B = len(idx)
    width = int(max(1, counts.max() if B else 1))
    if pad_to is not None:
        width = max(width, pad_to)
    starts = np.full((B, width), I32_MAX, np.int32)
    lasts = np.full((B, width), I32_MAX, np.int32)
    if len(ints) and B:
        col = np.arange(width)[None, :]
        mask = col < counts[:, None]
        src = (lo[:, None] + col)[mask]
        starts[mask] = u32_to_biased_i32(ints[src, 0])
        lasts[mask] = u32_to_biased_i32(ints[src, 1] - np.uint64(1))
    return starts, lasts, counts


def pack_lists(store, idx: np.ndarray, kind: str, pad_to: int | None = None):
    """The A (``kind="A"``) or F lists of an APRIL store's rows ``idx``,
    packed by :func:`pack_csr_intervals`."""
    off = store.a_off if kind == "A" else store.f_off
    ints = store.a_ints if kind == "A" else store.f_ints
    return pack_csr_intervals(off, ints, idx, pad_to=pad_to)


def batch_overlap_np(xs, xl, nx, ys, yl, ny) -> np.ndarray:
    """[B] bool: does padded row b of X overlap row b of Y? Rows as
    :func:`pack_csr_intervals` gives them (inclusive lasts, the first
    ``nx[b]`` / ``ny[b]`` slots valid). Overlap iff some (i, j) has
    ys[j] <= xl[i] and xs[i] <= yl[j]: per x interval, a binary search of
    the y lasts for the first j with yl[j] >= xs[i]. A host loop over the
    rows, the per-row reference of the padded layout."""
    B = xs.shape[0]
    out = np.zeros(B, dtype=bool)
    for b in range(B):
        nyb = int(ny[b])
        nxb = int(nx[b])
        if nyb == 0 or nxb == 0:
            continue
        j = np.searchsorted(yl[b, :nyb], xs[b, :nxb], side="left")
        ok = j < nyb
        jj = np.minimum(j, nyb - 1)
        out[b] = bool(np.any(ok & (ys[b, jj] <= xl[b, :nxb])))
    return out


# ---------------------------------------------------------------------------
# Interval lists, host and device
# ---------------------------------------------------------------------------

class IntervalLists:
    """One dataset side's interval lists, CSR-packed for the filter join.

    Endpoints are biased int32 with inclusive lasts (``end - 1``). Built
    once per approximation; :meth:`to` uploads the flat arrays to a device
    once and caches them there, so per-batch work never re-packs on the
    host.
    """

    __slots__ = ("off", "starts", "lasts", "_device", "_keys", "_host_keys")

    def __init__(self, off: np.ndarray, starts: np.ndarray,
                 lasts: np.ndarray):
        self.off = np.ascontiguousarray(off, np.int64)
        self.starts = np.ascontiguousarray(starts, np.int32)
        self.lasts = np.ascontiguousarray(lasts, np.int32)
        self._device: dict[str, CSRLists] = {}
        self._keys: dict[str, torch.Tensor] = {}
        self._host_keys: np.ndarray | None = None

    @classmethod
    def from_intervals(cls, off: np.ndarray, ints: np.ndarray):
        """From a CSR uint64 half-open interval table (AprilStore layout)."""
        if len(ints):
            starts = u32_to_biased_i32(ints[:, 0])
            lasts = u32_to_biased_i32(ints[:, 1] - np.uint64(1))
        else:
            starts = np.zeros(0, np.int32)
            lasts = np.zeros(0, np.int32)
        return cls(off, starts, lasts)

    @classmethod
    def from_unit_cells(cls, off: np.ndarray, ids: np.ndarray):
        """From CSR sorted cell ids (a line store), each the unit interval
        [id, id + 1): start and inclusive last are both the id, biased."""
        b = u32_to_biased_i32(ids) if len(ids) else np.zeros(0, np.int32)
        return cls(off, b, b.copy())

    def __len__(self) -> int:
        return len(self.off) - 1

    def counts(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        return (self.off[idx + 1] - self.off[idx]).astype(np.int64)

    def to(self, device) -> CSRLists:
        """The lists as tensors on ``device``: off int64, starts and lasts
        int32, uploaded once and cached per device."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._device:
            # a sentinel slot keeps an empty store's pointers valid
            s = self.starts if len(self.starts) else np.full(1, I32_MAX,
                                                             np.int32)
            l = self.lasts if len(self.lasts) else np.full(1, I32_MAX,
                                                           np.int32)
            self._device[key] = CSRLists(
                *(torch.from_numpy(a).to(dev) for a in (self.off, s, l)))
        return self._device[key]

    def host_keys(self) -> np.ndarray:
        """[T] uint64, built once and cached: each interval's inclusive
        last keyed by its row (:func:`_rowkey`), ascending over the whole
        store (rows in order, lists sorted), so one ``searchsorted`` finds
        the first interval of any row that ends at or after a value."""
        if self._host_keys is None:
            row = np.repeat(np.arange(len(self)), self.counts(
                np.arange(len(self))))
            self._host_keys = _rowkey(row, self.lasts)
        return self._host_keys

    def last_keys(self, device) -> torch.Tensor:
        """:meth:`host_keys` as int64 on ``device``, uploaded once and
        cached."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._keys:
            self._keys[key] = torch.from_numpy(
                self.host_keys().astype(np.int64)).to(dev)
        return self._keys[key]

    def drop_device(self) -> None:
        """Forget the device copies (:meth:`to`, :meth:`last_keys`); they
        are uploaded again on next use."""
        self._device = {}
        self._keys = {}

    # -- incremental maintenance (row splices) ------------------------------

    def delete_row(self, i: int) -> None:
        """Splice row ``i`` out in place; only this row's endpoints move.
        Every derived copy goes with it: the device lists and row keys of
        each device and the host row keys, rebuilt from the patched arrays
        on next use."""
        old_off = self.off
        _, self.lasts = csr_delete_row(old_off, self.lasts, i)
        self.off, self.starts = csr_delete_row(old_off, self.starts, i)
        self._drop_derived()

    def append_row(self, starts: np.ndarray, lasts: np.ndarray) -> None:
        """Append one row's biased-int32 endpoints in place, dropping the
        derived copies as :meth:`delete_row` does."""
        old_off = self.off
        _, self.lasts = csr_append_row(old_off, self.lasts,
                                       np.asarray(lasts, np.int32))
        self.off, self.starts = csr_append_row(old_off, self.starts,
                                               np.asarray(starts, np.int32))
        self._drop_derived()

    def _drop_derived(self) -> None:
        self.drop_device()
        self._host_keys = None


# ---------------------------------------------------------------------------
# Batched overlap rows
# ---------------------------------------------------------------------------

_KEY_SHIFT = np.uint64(33)
_KEY_BIAS = np.int64(1) << np.int64(31)


def _flat_rows(L: IntervalLists, idx: np.ndarray):
    """Expand rows ``idx`` of ``L`` into flat (row-of-entry [T],
    global-interval [T]) arrays."""
    idx = np.asarray(idx, np.int64)
    lo = L.off[idx]
    cnt = (L.off[idx + 1] - lo).astype(np.int64)
    b_of = np.repeat(np.arange(len(idx)), cnt)
    pos = np.arange(len(b_of)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return b_of, lo[b_of] + pos


def _rowkey(b_of: np.ndarray, vals_i32: np.ndarray) -> np.ndarray:
    return ((b_of.astype(np.uint64) << _KEY_SHIFT)
            + (vals_i32.astype(np.int64) + _KEY_BIAS).astype(np.uint64))


def _first_ending(L: IntervalLists, rows: np.ndarray, vals: np.ndarray):
    """(j, ok): for each entry, the first interval j of row ``rows[k]`` of
    ``L`` whose inclusive last is at or after ``vals[k]``, one
    ``searchsorted`` over the store's row keys; ``ok`` is False where the
    row has none (``j`` is then clamped into the store)."""
    j = np.searchsorted(L.host_keys(), _rowkey(rows, vals), side="left")
    ok = j < L.off[rows + 1]
    return np.minimum(j, len(L.starts) - 1), ok


def overlap_rows_np(X: IntervalLists, xi: np.ndarray,
                    Y: IntervalLists, yi: np.ndarray) -> np.ndarray:
    """[N] bool: does X[xi[n]] overlap Y[yi[n]]? One flat vectorized pass
    over the side with fewer intervals in the frame (the test is
    symmetric): per interval, the first interval of the other side's row
    with ``last >= start`` (:func:`_first_ending`), then ``its start <=
    last``."""
    xi = np.asarray(xi, np.int64)
    yi = np.asarray(yi, np.int64)
    out = np.zeros(len(xi), bool)
    if X.counts(xi).sum() > Y.counts(yi).sum():
        X, xi, Y, yi = Y, yi, X, xi
    if len(xi) == 0 or len(Y.starts) == 0:
        return out
    bx, gx = _flat_rows(X, xi)
    j, ok = _first_ending(Y, yi[bx], X.starts[gx])
    hit = ok & (Y.starts[j] <= X.lasts[gx])
    out[bx[hit]] = True
    return out


def contain_rows_np(X: IntervalLists, xi: np.ndarray,
                    F: IntervalLists, fi: np.ndarray) -> np.ndarray:
    """[N] bool: is every interval of X[xi[n]] inside some interval of
    F[fi[n]]? (the within join's AF test, §4.3.2). Per X interval, the
    first F interval of the row ending at or after its last
    (:func:`_first_ending`) must hold it. False for an empty X or F list;
    the trichotomy drivers consult it only on AA survivors."""
    xi = np.asarray(xi, np.int64)
    fi = np.asarray(fi, np.int64)
    out = (X.counts(xi) > 0) & (F.counts(fi) > 0)
    if len(xi) == 0 or len(F.starts) == 0:
        return out
    bx, gx = _flat_rows(X, xi)
    j, ok = _first_ending(F, fi[bx], X.lasts[gx])
    inside = ok & (F.starts[j] <= X.starts[gx]) & (X.lasts[gx] <= F.lasts[j])
    out[bx[~inside]] = False
    return out


def _check_frame(idx: np.ndarray, L: IntervalLists, name: str) -> None:
    """Host row indices into ``L`` range-checked in numpy (no device read)."""
    if len(idx) and (idx.min() < 0 or idx.max() >= len(L)):
        raise IndexError(f"{name}: row index out of range [0, {len(L)})")


def _rows(idx: np.ndarray, L: IntervalLists, dev: torch.device,
          name: str) -> torch.Tensor:
    """Host row indices into ``L``, range-checked and uploaded without a
    sync."""
    idx = np.ascontiguousarray(idx, np.int64)
    _check_frame(idx, L, name)
    return upload(idx, dev)


_JOINS = InputLog()


def record_joins():
    """Collect the device inputs of every interval-join call the staged
    and fused drivers make inside the block, one ``(kernel, args)`` item a
    call: ``("april_trichotomy", (xa, xf, ya, yf, ri, si))`` or
    ``("interval_overlap", (x, y, xi, yi))``, whether the call went to the
    kernel or to its plain version, so that the kernels can be replayed on
    exactly what a join gave them."""
    return _JOINS.record()


def _interval_join(name: str, backend: str, *args) -> torch.Tensor:
    """One call of the trichotomy or overlap kernel (``cuda``) or of its
    plain version (other backends) on device tensors, noted in
    :func:`record_joins`."""
    _JOINS.add((name, args))
    if name == "april_trichotomy":
        fn = april_trichotomy if backend == "cuda" else april_trichotomy_plain
    else:
        fn = interval_overlap if backend == "cuda" else interval_overlap_plain
    return fn(*args)


def _overlap_fn(backend: str, dev: torch.device):
    """Host-in, host-out overlap rows for one backend."""
    if backend == "numpy":
        return overlap_rows_np

    def overlap(X, xi, Y, yi):
        got = _interval_join("interval_overlap", backend, X.to(dev),
                             Y.to(dev), _rows(xi, X, dev, "xi"),
                             _rows(yi, Y, dev, "yi"))
        return got.cpu().numpy()
    return overlap


def contain_rows(X: IntervalLists, xi: np.ndarray, F: IntervalLists,
                 fi: np.ndarray, *, device=None, rows=None) -> torch.Tensor:
    """Device bool [N]: :func:`contain_rows_np` of rows (xi[n], fi[n]) on
    ``device`` (``None`` -> ``"cuda"``), with no host read.

    Each X interval of every row is expanded on the device (their number
    comes from the host offsets), and one ``torch.searchsorted`` of its
    row-keyed inclusive last over F's store keys (:meth:`IntervalLists.
    last_keys`) finds the first F interval of row fi[n] ending at or after
    it. ``rows`` are the int64 copies of (xi, fi) already on ``device``;
    for the call to stay free of host syncs they and the lists must be
    there already (``IntervalLists.to``, ``last_keys``).
    """
    dev = resolve_device(device)
    xi = np.asarray(xi, np.int64)
    fi = np.asarray(fi, np.int64)
    if rows is None:
        rows = (_rows(xi, X, dev, "xi"), _rows(fi, F, dev, "fi"))
    else:
        _check_frame(xi, X, "xi")
        _check_frame(fi, F, "fi")
    xi_d, fi_d = rows
    N = len(xi)
    x, f = X.to(dev), F.to(dev)
    cx = x.off[xi_d + 1] - x.off[xi_d]
    out = (cx > 0) & (f.off[fi_d + 1] > f.off[fi_d])
    T = int(X.counts(xi).sum())
    if N == 0 or T == 0 or len(F.starts) == 0:
        return out
    bx = torch.repeat_interleave(torch.arange(N, device=dev), cx,
                                 output_size=T)
    first = torch.cumsum(cx, 0) - cx
    gx = x.off[xi_d][bx] + torch.arange(T, device=dev) - first[bx]
    xs, xl = x.starts[gx], x.lasts[gx]
    frow = fi_d[bx]
    q = (frow << int(_KEY_SHIFT)) + (xl.to(torch.int64) + int(_KEY_BIAS))
    j = torch.searchsorted(F.last_keys(dev), q, side="left")
    ok = j < f.off[frow + 1]
    jj = torch.clamp(j, max=len(F.starts) - 1)
    inside = ok & (f.starts[jj] <= xs) & (xl <= f.lasts[jj])
    bad = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, bx, (~inside).to(torch.int32))
    return out & (bad == 0)


def _contain_fn(backend: str, dev: torch.device):
    """Host-in, host-out containment rows for one backend."""
    if backend == "numpy":
        return contain_rows_np

    def contain(X, xi, F, fi):
        return contain_rows(X, xi, F, fi, device=dev).cpu().numpy()
    return contain


# ---------------------------------------------------------------------------
# Staged trichotomy driver
# ---------------------------------------------------------------------------

def _lists_np(L: IntervalLists, i: int) -> np.ndarray:
    """Row ``i`` as half-open int64 intervals for the per-pair reference."""
    lo, hi = L.off[i], L.off[i + 1]
    return np.stack([L.starts[lo:hi].astype(np.int64),
                     L.lasts[lo:hi].astype(np.int64) + 1], axis=1)


def april_trichotomy_rows(
    Xa: IntervalLists, Xf: IntervalLists, Ya: IntervalLists,
    Yf: IntervalLists, ri: np.ndarray, si: np.ndarray, *,
    backend: str = "numpy", order: tuple[str, ...] = ("AA", "AF", "FA"),
    device=None,
) -> np.ndarray:
    """APRIL trichotomy (Algorithm 2) over rows (ri[n], si[n]) -> [N] int8.

    The AA-join runs over the whole batch; AF/FA evaluate only the AA
    survivors, in ``order`` (semantics are order-invariant; an order that
    omits a hit join leaves its survivors INDECISIVE, like the per-pair
    reference). The ``cuda`` backend evaluates a full order in one fused
    kernel launch over every row. ``device`` (``None`` -> ``"cuda"``)
    matters to the ``torch`` and ``cuda`` backends.
    """
    check_filter_backend(backend)
    if "AA" not in order:
        raise ValueError("order must include 'AA'")
    ri = np.asarray(ri, np.int64)
    si = np.asarray(si, np.int64)
    N = len(ri)
    if backend == "sequential":
        return np.asarray([
            april_verdict_pair(_lists_np(Xa, r), _lists_np(Xf, r),
                               _lists_np(Ya, s), _lists_np(Yf, s),
                               order=order)
            for r, s in zip(ri, si)], np.int8).reshape(N)
    dev = None
    if backend != "numpy":
        dev = resolve_device(device)
        check_backend_device(backend, dev)
    if N == 0:
        return np.zeros(0, np.int8)
    if backend == "cuda" and set(order) == {"AA", "AF", "FA"}:
        got = _interval_join("april_trichotomy", backend, Xa.to(dev),
                             Xf.to(dev), Ya.to(dev), Yf.to(dev),
                             _rows(ri, Xa, dev, "ri"),
                             _rows(si, Ya, dev, "si"))
        return got.cpu().numpy()
    overlap = _overlap_fn(backend, dev)
    aa = overlap(Xa, ri, Ya, si)
    verdicts = np.where(aa, INDECISIVE, TRUE_NEG).astype(np.int8)
    sel = np.nonzero(aa)[0]
    for step in [s for s in order if s != "AA"]:
        if len(sel) == 0:
            break
        if step == "AF":
            hit = overlap(Xa, ri[sel], Yf, si[sel])
        else:
            hit = overlap(Xf, ri[sel], Ya, si[sel])
        verdicts[sel[hit]] = TRUE_HIT
        sel = sel[~hit]
    return verdicts


def within_trichotomy_rows(
    Xa: IntervalLists, Ya: IntervalLists, Yf: IntervalLists,
    ri: np.ndarray, si: np.ndarray, *, backend: str = "numpy", device=None,
) -> np.ndarray:
    """Within trichotomy (§4.3.2) over rows (ri[n], si[n]) -> [N] int8: the
    AA-join over the whole batch, then the containment of A(r) in F(s) on
    the compacted AA survivors only. ``torch`` and ``cuda`` run the AA-join
    through the interval-overlap kernel's plain version or the kernel and
    the containment on ``device`` (``None`` -> ``"cuda"``); ``numpy`` runs
    both on the host; ``sequential`` is the per-pair reference."""
    check_filter_backend(backend)
    ri = np.asarray(ri, np.int64)
    si = np.asarray(si, np.int64)
    N = len(ri)
    if backend == "sequential":
        return np.asarray([
            within_verdict_pair(_lists_np(Xa, r), None, _lists_np(Ya, s),
                                _lists_np(Yf, s))
            for r, s in zip(ri, si)], np.int8).reshape(N)
    dev = None
    if backend != "numpy":
        dev = resolve_device(device)
        check_backend_device(backend, dev)
    if N == 0:
        return np.zeros(0, np.int8)
    aa = _overlap_fn(backend, dev)(Xa, ri, Ya, si)
    verdicts = np.where(aa, INDECISIVE, TRUE_NEG).astype(np.int8)
    sel = np.nonzero(aa)[0]
    if len(sel):
        cont = _contain_fn(backend, dev)(Xa, ri[sel], Yf, si[sel])
        verdicts[sel[cont]] = TRUE_HIT
    return verdicts


def linestring_trichotomy_rows(
    C: IntervalLists, Ya: IntervalLists, Yf: IntervalLists,
    li: np.ndarray, si: np.ndarray, *, backend: str = "numpy", device=None,
) -> np.ndarray:
    """Polygon x linestring trichotomy (§4.3.3) over rows (li[n], si[n]) ->
    [N] int8: the chain's unit intervals ``C`` against A(s) over the whole
    batch, then against F(s) on the compacted survivors only. ``torch`` and
    ``cuda`` run both joins through the interval-overlap kernel's plain
    version or the kernel on ``device`` (``None`` -> ``"cuda"``), two
    calls; ``numpy`` runs them on the host; ``sequential`` is the per-pair
    reference."""
    check_filter_backend(backend)
    li = np.asarray(li, np.int64)
    si = np.asarray(si, np.int64)
    N = len(li)
    if backend == "sequential":
        return np.asarray([
            linestring_verdict_pair(
                _lists_np(Ya, s), _lists_np(Yf, s),
                C.starts[C.off[r]:C.off[r + 1]].astype(np.int64))
            for r, s in zip(li, si)], np.int8).reshape(N)
    dev = None
    if backend != "numpy":
        dev = resolve_device(device)
        check_backend_device(backend, dev)
    if N == 0:
        return np.zeros(0, np.int8)
    overlap = _overlap_fn(backend, dev)
    aa = overlap(C, li, Ya, si)
    verdicts = np.where(aa, INDECISIVE, TRUE_NEG).astype(np.int8)
    sel = np.nonzero(aa)[0]
    if len(sel):
        fhit = overlap(C, li[sel], Yf, si[sel])
        verdicts[sel[fhit]] = TRUE_HIT
    return verdicts


def fused_status_rows(Xa: IntervalLists, Xf: IntervalLists | None,
                      Ya: IntervalLists, Yf: IntervalLists, ri: np.ndarray,
                      si: np.ndarray, *, predicate: str = "intersects",
                      rows=None, backend: str = "cuda",
                      device=None) -> torch.Tensor:
    """Device int8 status lane [N] over every row of the fused chain's pair
    frame, computed on ``device`` with no host read.

    ``intersects`` (and ``selection``) with ``backend="cuda"`` is one
    trichotomy kernel launch straight into the lane: the kernel evaluates
    the full AA/AF/FA trichotomy of every row with no width cap, so the
    reference's per-width buckets and power-of-two padding are not needed.
    ``within`` (``Xf`` unused) is one interval-overlap kernel launch for
    the AA-join over every row, the containment of A(r) in F(s) over every
    row (:func:`contain_rows`), and the verdict select. ``linestring``
    (``Xa`` the chain's unit intervals, ``Xf`` unused) is two
    interval-overlap launches over every row, the chain against A(s) and
    against F(s), and the verdict select. Other backends run
    the kernels' plain versions on ``device``. Rows with an empty A list
    on either side read TRUE_NEG, as in the staged drivers. The frame is
    range-checked on the host; ``rows`` are its int64 copies already on
    ``device`` (the chain uploads the frame once), else it is uploaded
    here. The lists (and, for ``within``, F(s)'s ``last_keys``) must
    already be on ``device`` for the call to stay free of host syncs.
    """
    check_filter_backend(backend)
    if predicate not in ("intersects", "selection", "within", "linestring"):
        raise ValueError(f"no fused status lane for predicate {predicate!r}")
    dev = resolve_device(device)
    check_backend_device(backend, dev)
    if rows is None:
        rows = (_rows(ri, Xa, dev, "ri"), _rows(si, Ya, dev, "si"))
    else:
        _check_frame(np.asarray(ri), Xa, "ri")
        _check_frame(np.asarray(si), Ya, "si")
    if predicate == "within":
        aa = _interval_join("interval_overlap", backend, Xa.to(dev),
                            Ya.to(dev), *rows)
        cont = contain_rows(Xa, ri, Yf, si, device=dev, rows=rows)
        return torch.where(aa, torch.where(cont, TRUE_HIT, INDECISIVE),
                           TRUE_NEG).to(torch.int8)
    if predicate == "linestring":
        aa = _interval_join("interval_overlap", backend, Xa.to(dev),
                            Ya.to(dev), *rows)
        fhit = _interval_join("interval_overlap", backend, Xa.to(dev),
                              Yf.to(dev), *rows)
        return torch.where(aa, torch.where(fhit, TRUE_HIT, INDECISIVE),
                           TRUE_NEG).to(torch.int8)
    return _interval_join("april_trichotomy", backend, Xa.to(dev),
                          Xf.to(dev), Ya.to(dev), Yf.to(dev), *rows)


# ---------------------------------------------------------------------------
# Raw-store wrappers
# ---------------------------------------------------------------------------

def _store_lists(store, kind: str) -> IntervalLists:
    """One list kind (``"A"`` or ``"F"``) of an AprilStore as
    :class:`IntervalLists`, cached on the store so that repeated wrapper
    calls pay the biased-int32 conversion (and each device upload) once.
    An entry is kept with the offset and interval arrays it was built from
    and rebuilt when the store holds other ones: the row splices of
    incremental maintenance replace both arrays."""
    off, ints = ((store.a_off, store.a_ints) if kind == "A"
                 else (store.f_off, store.f_ints))
    try:
        cache = store._interval_lists_cache
    except AttributeError:
        cache = store._interval_lists_cache = {}
    hit = cache.get(kind)
    if hit is None or hit[0] is not off or hit[1] is not ints:
        hit = cache[kind] = (off, ints,
                             IntervalLists.from_intervals(off, ints))
    return hit[2]


def _wrapper_backend(backend: str | None, device) -> str:
    """A raw-store wrapper's backend: ``None`` follows ``device`` as
    :class:`JoinPlan` does (``"cuda"`` on a CUDA device, ``"torch"``
    otherwise; ``device=None`` is the card and raises without one)."""
    if backend is not None:
        return backend
    return "cuda" if resolve_device(device).type == "cuda" else "torch"


def _pairs(pairs) -> np.ndarray:
    """Candidate pairs as [N, 2] int64; empty ones give an empty int8
    result through the rows functions, after their backend checks."""
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def within_filter_batch(store_r, store_s, pairs: np.ndarray, *,
                        backend: str | None = None,
                        device=None) -> np.ndarray:
    """APRIL within filter (§4.3.2) over candidate pairs [N, 2] of raw
    AprilStores -> [N] int8, verdict-identical to
    :func:`within_verdict_pair` applied per pair: AA disjoint -> TRUE_NEG;
    every A(r) interval inside an F(s) interval -> TRUE_HIT; else
    INDECISIVE. A thin wrapper over :func:`within_trichotomy_rows`:
    ``"cuda"`` launches the interval-overlap kernel for the AA-join,
    ``"torch"`` runs its plain version, both on ``device`` (``None`` ->
    ``"cuda"``); ``"numpy"`` runs on the host. ``backend=None`` is
    ``"cuda"`` on a CUDA device and ``"torch"`` on any other."""
    pairs = _pairs(pairs)
    return within_trichotomy_rows(
        _store_lists(store_r, "A"), _store_lists(store_s, "A"),
        _store_lists(store_s, "F"), pairs[:, 0], pairs[:, 1],
        backend=_wrapper_backend(backend, device), device=device)


def linestring_filter_batch(store_s, line_off: np.ndarray,
                            line_ids: np.ndarray, pairs: np.ndarray, *,
                            backend: str | None = None,
                            device=None) -> np.ndarray:
    """Polygon x linestring filter (§4.3.3) -> [N] int8. ``pairs`` rows are
    (line index, polygon index); the chains are a CSR array of sorted cell
    ids (``line_off``, ``line_ids``, a ``LineCellStore``'s ``off`` and
    ``ids``), each a unit interval. Verdict-identical to
    :func:`linestring_verdict_pair`; a thin wrapper over
    :func:`linestring_trichotomy_rows`, whose two joins the ``"cuda"``
    backend launches the interval-overlap kernel for (backends and
    ``device`` as in :func:`within_filter_batch`)."""
    pairs = _pairs(pairs)
    return linestring_trichotomy_rows(
        IntervalLists.from_unit_cells(line_off, line_ids),
        _store_lists(store_s, "A"), _store_lists(store_s, "F"),
        pairs[:, 0], pairs[:, 1], backend=_wrapper_backend(backend, device),
        device=device)


def april_filter_batch(store_r, store_s, pairs: np.ndarray,
                       order: tuple[str, ...] = ("AA", "AF", "FA"), *,
                       backend: str | None = None,
                       device=None) -> np.ndarray:
    """APRIL filter (Algorithm 2) over candidate pairs [[r, s], ...] of raw
    AprilStores -> [N] int8; a thin wrapper over
    :func:`april_trichotomy_rows`. ``"cuda"`` evaluates a full ``order``
    in one launch of the fused trichotomy kernel and a partial one through
    the interval-overlap kernel, ``"torch"`` runs the plain versions, both
    on ``device`` (``None`` -> ``"cuda"``); ``"numpy"`` runs on the host.
    ``backend=None`` follows ``device`` as in
    :func:`within_filter_batch`."""
    pairs = _pairs(pairs)
    return april_trichotomy_rows(
        _store_lists(store_r, "A"), _store_lists(store_r, "F"),
        _store_lists(store_s, "A"), _store_lists(store_s, "F"),
        pairs[:, 0], pairs[:, 1], backend=_wrapper_backend(backend, device),
        order=order, device=device)
