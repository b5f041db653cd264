"""Interval joins: the APRIL intermediate filter (paper §4.2, Algorithm 2).

* **Faithful sequential merge joins** (:func:`interval_join_pair`,
  :func:`april_verdict_pair`) — the paper's two-pointer loops with early
  exit, the per-pair reference.
* **Batched staged trichotomy** (:func:`april_trichotomy_rows`) over
  :class:`IntervalLists`, a dataset side's lists CSR-packed in biased
  int32 with inclusive lasts, uploaded to a device once and cached.

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
(AF- or FA-join finds an overlap) or INDECISIVE (forwarded to refinement).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import check_backend_device, resolve_device, upload
from ..kernels.interval_join import (CSRLists, april_trichotomy,
                                     april_trichotomy_plain, interval_overlap,
                                     interval_overlap_plain)
from ..kernels.interval_join.ref import INDECISIVE, TRUE_HIT, TRUE_NEG
from .hilbert import u32_to_biased_i32

__all__ = [
    "TRUE_NEG", "TRUE_HIT", "INDECISIVE", "FILTER_BACKENDS",
    "check_filter_backend", "IntervalLists", "interval_join_pair",
    "april_verdict_pair", "overlap_rows_np", "april_trichotomy_rows",
    "fused_status_rows",
]

I32_MAX = np.int32(np.iinfo(np.int32).max)

FILTER_BACKENDS = ("numpy", "torch", "cuda", "sequential")


def check_filter_backend(backend: str) -> None:
    if backend not in FILTER_BACKENDS:
        raise ValueError(f"unknown filter backend {backend!r}; "
                         f"expected one of {FILTER_BACKENDS}")


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

    __slots__ = ("off", "starts", "lasts", "_device")

    def __init__(self, off: np.ndarray, starts: np.ndarray,
                 lasts: np.ndarray):
        self.off = np.ascontiguousarray(off, np.int64)
        self.starts = np.ascontiguousarray(starts, np.int32)
        self.lasts = np.ascontiguousarray(lasts, np.int32)
        self._device: dict[str, CSRLists] = {}

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


# ---------------------------------------------------------------------------
# Batched overlap rows
# ---------------------------------------------------------------------------

_KEY_SHIFT = np.uint64(33)
_KEY_BIAS = np.int64(1) << np.int64(31)


def _flat_rows(L: IntervalLists, idx: np.ndarray):
    """Expand rows ``idx`` of ``L`` into flat (row-of-entry [T],
    global-interval [T], counts [B]) arrays."""
    idx = np.asarray(idx, np.int64)
    lo = L.off[idx]
    cnt = (L.off[idx + 1] - lo).astype(np.int64)
    b_of = np.repeat(np.arange(len(idx)), cnt)
    pos = np.arange(len(b_of)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return b_of, lo[b_of] + pos, cnt


def _rowkey(b_of: np.ndarray, vals_i32: np.ndarray) -> np.ndarray:
    return ((b_of.astype(np.uint64) << _KEY_SHIFT)
            + (vals_i32.astype(np.int64) + _KEY_BIAS).astype(np.uint64))


def overlap_rows_np(X: IntervalLists, xi: np.ndarray,
                    Y: IntervalLists, yi: np.ndarray) -> np.ndarray:
    """[N] bool: does X[xi[n]] overlap Y[yi[n]]? One flat vectorized pass:
    per x interval, binary-search the row-keyed flat y-lasts for the first
    y with ``yl >= xs``, then test ``ys <= xl``."""
    xi = np.asarray(xi, np.int64)
    N = len(xi)
    out = np.zeros(N, bool)
    if N == 0:
        return out
    bx, gx, _ = _flat_rows(X, xi)
    by, gy, cy = _flat_rows(Y, yi)
    if len(bx) == 0 or len(by) == 0:
        return out
    ykeys = _rowkey(by, Y.lasts[gy])
    yend = np.cumsum(cy)
    j = np.searchsorted(ykeys, _rowkey(bx, X.starts[gx]), side="left")
    ok = j < yend[bx]
    jj = np.minimum(j, len(gy) - 1)
    hit = ok & (Y.starts[gy[jj]] <= X.lasts[gx])
    out[bx[hit]] = True
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


def _overlap_fn(backend: str, dev: torch.device):
    """Host-in, host-out overlap rows for one backend."""
    if backend == "numpy":
        return overlap_rows_np
    fn = interval_overlap_plain if backend == "torch" else interval_overlap

    def overlap(X, xi, Y, yi):
        got = fn(X.to(dev), Y.to(dev), _rows(xi, X, dev, "xi"),
                 _rows(yi, Y, dev, "yi"))
        return got.cpu().numpy()
    return overlap


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
        got = april_trichotomy(Xa.to(dev), Xf.to(dev), Ya.to(dev),
                               Yf.to(dev), _rows(ri, Xa, dev, "ri"),
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


def fused_status_rows(Xa: IntervalLists, Xf: IntervalLists,
                      Ya: IntervalLists, Yf: IntervalLists, ri: np.ndarray,
                      si: np.ndarray, *, rows=None, backend: str = "cuda",
                      device=None) -> torch.Tensor:
    """Device int8 status lane [N] over every row of the fused chain's pair
    frame (``intersects``), computed on ``device`` with no host read.

    ``backend="cuda"`` is one trichotomy kernel launch straight into the
    lane: the kernel evaluates the full AA/AF/FA trichotomy of every row
    with no width cap, so the reference's per-width buckets and power-of-two
    padding are not needed. Other backends run the kernel's plain version
    on ``device``. Rows with an empty A list on either side read TRUE_NEG,
    as in the staged drivers. The frame is range-checked on the host;
    ``rows`` are its int64 copies already on ``device`` (the chain uploads
    the frame once), else it is uploaded here. The lists must already be on
    ``device`` (``IntervalLists.to``) for the call to stay free of host
    syncs.
    """
    check_filter_backend(backend)
    dev = resolve_device(device)
    check_backend_device(backend, dev)
    if rows is None:
        rows = (_rows(ri, Xa, dev, "ri"), _rows(si, Ya, dev, "si"))
    else:
        _check_frame(np.asarray(ri), Xa, "ri")
        _check_frame(np.asarray(si), Ya, "si")
    fn = april_trichotomy if backend == "cuda" else april_trichotomy_plain
    return fn(Xa.to(dev), Xf.to(dev), Ya.to(dev), Yf.to(dev), *rows)
