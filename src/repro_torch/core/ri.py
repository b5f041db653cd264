"""RI — Raster Intervals with 3-bit cell-type codes (paper §3).

Each object is a sorted list of Hilbert intervals; each interval carries a
bitstring concatenating the 3-bit codes (Table 2) of its cells:

              input R    input S
    full       011        101
    strong     101        011
    weak       100        010

A non-zero AND of two cell codes (one R-coded, one S-coded) certifies
intersection in that cell; XOR with mask 110 turns an R code into the S
code of the same class, so one store can take either side of a join.

Host representation: per-dataset flat *bit* arrays (np.uint8 0/1) plus
per-interval bit offsets (:class:`RIStore`). Construction labels the
Partial cells Weak or Strong by exact coverage fractions: dataset-batched
on the host (``numpy``), with the coverage clip on a device (``torch``),
or polygon by polygon (``sequential``, the reference loop).

The within filter (§3.4) runs on the host, as in the reference:
:func:`ri_within_batch` batched, :func:`ri_within_verdict_pair` per pair.

The filter (Algorithm 1) has four backends, all verdict-identical
(:func:`ri_trichotomy_rows`): ``numpy`` expands the candidates into
overlapping-interval fragments on the host and ANDs their code runs bit
by bit (:func:`ri_filter_batch`); ``sequential`` is the per-pair merge
(:func:`ri_verdict_pair`); ``torch`` and ``cuda`` run over
:class:`RIDeviceStore`, the store uploaded once with its code stream
packed into uint32 words, through the ALIGNEDAND kernel's plain PyTorch
version or the kernel itself (``kernels/ri_and``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import InputLog, check_backend_device, resolve_device, upload
from ..kernels.ri_and import (RIStoreTensors, pack_stream_words,
                              ri_trichotomy, ri_trichotomy_plain)
from . import rasterize
from .april import build_line_cells
from .geometry import BUILD_STAGES, build_device
from .hilbert import u32_to_biased_i32, xy2d
from .intervalize import intervals_from_ids, runs_from_sorted
from .join import (INDECISIVE, TRUE_HIT, TRUE_NEG, _check_frame,
                   check_filter_backend)
from .rasterize import Extent, GLOBAL_EXTENT

__all__ = [
    "RIStore", "RIDeviceStore", "build_ri", "build_ri_lines",
    "ri_verdict_pair", "ri_filter_batch", "ri_within_verdict_pair",
    "ri_within_batch", "ri_trichotomy_rows", "ri_status_rows",
    "record_frames", "CODE_R", "CODE_S", "XOR_MASK", "FULL", "STRONG",
    "WEAK",
]

FULL, STRONG, WEAK = 0, 1, 2
CODE_R = {FULL: (0, 1, 1), STRONG: (1, 0, 1), WEAK: (1, 0, 0)}
CODE_S = {FULL: (1, 0, 1), STRONG: (0, 1, 1), WEAK: (0, 1, 0)}
XOR_MASK = (1, 1, 0)

@dataclass
class RIStore:
    """RI approximations for one dataset (single encoding, R or S)."""
    n_order: int
    extent: Extent
    encoding: str              # 'R' or 'S'
    off: np.ndarray            # [P+1] interval offsets
    ints: np.ndarray           # [sum_I, 2] uint64
    bit_off: np.ndarray        # [sum_I + 1] int64: bit offset of each interval
    bits: np.ndarray           # [total_bits] uint8 in {0,1}

    def __len__(self) -> int:
        return len(self.off) - 1

    def intervals(self, i: int) -> np.ndarray:
        return self.ints[self.off[i]: self.off[i + 1]]

    def interval_bits(self, i: int, k: int) -> np.ndarray:
        """Bit code of the k-th interval of polygon i."""
        g = self.off[i] + k
        return self.bits[self.bit_off[g]: self.bit_off[g + 1]]

    def size_bytes(self) -> int:
        """Endpoints as uint32 pairs + ceil(bits/8) code bytes per interval
        (paper §3.2) + the offset table."""
        code_bytes = int(((np.diff(self.bit_off) + 7) // 8).sum())
        return 4 * 2 * len(self.ints) + code_bytes + 8 * len(self.off)


# class id -> 3-bit code row, per encoding
_CODE_LUT = {
    enc: np.asarray([tab[FULL], tab[STRONG], tab[WEAK]], np.uint8)
    for enc, tab in (("R", CODE_R), ("S", CODE_S))
}


def _classify_cells(verts, n, n_order, extent):
    """Cell ids + classes for one polygon: DDA partials get Weak/Strong via
    coverage fraction; interior cells are Full."""
    partial = rasterize.dda_partial_cells(verts, n, n_order, extent)
    full = rasterize.scanline_full_cells(verts, n, partial, n_order, extent)
    p_ids = rasterize.cells_to_hilbert(partial, n_order)
    f_ids = rasterize.cells_to_hilbert(full, n_order)
    # coverage only for partial cells (full are 1.0 by construction)
    # recover cell coords in id order for fraction computation
    if len(partial):
        order = np.argsort(xy2d(n_order, partial[:, 0], partial[:, 1]))
        pcells = partial[order]
        frac = rasterize.coverage_fractions(verts, n, pcells, n_order, extent)
        p_cls = np.where(frac > 0.5, STRONG, WEAK).astype(np.int8)
    else:
        p_cls = np.zeros((0,), np.int8)
    ids = np.concatenate([p_ids, f_ids])
    cls = np.concatenate([p_cls, np.full(len(f_ids), FULL, np.int8)])
    order = np.argsort(ids)
    return ids[order], cls[order]


def _pack_store(objects, n_order: int, extent: Extent, encoding: str) -> RIStore:
    """Assemble an RIStore from per-object (sorted ids, classes) pairs."""
    lut = _CODE_LUT[encoding]
    off = [0]
    bit_off_chunks = [np.zeros(1, np.int64)]
    int_chunks = []; bit_chunks = []
    base = 0
    for ids, cls in objects:
        ints = intervals_from_ids(ids)
        int_chunks.append(ints)
        off.append(off[-1] + len(ints))
        # concatenated 3-bit codes in Hilbert order; per-interval offsets are
        # the running 3x cell counts (cells tile the intervals consecutively)
        lens = 3 * (ints[:, 1] - ints[:, 0]).astype(np.int64)
        bit_off_chunks.append(base + np.cumsum(lens))
        base += int(lens.sum())
        bit_chunks.append(lut[cls].reshape(-1))
    ints = (np.concatenate(int_chunks, axis=0)
            if int_chunks else np.zeros((0, 2), np.uint64))
    bits = (np.concatenate(bit_chunks) if bit_chunks
            else np.zeros((0,), np.uint8))
    return RIStore(
        n_order=n_order, extent=extent, encoding=encoding,
        off=np.asarray(off, np.int64), ints=ints,
        bit_off=np.concatenate(bit_off_chunks), bits=bits,
    )


def _sort_ids_by_poly(pid, ids, cls, n_order, P):
    """Sort flat (polygon, id) cell rows into per-polygon Hilbert order;
    returns (off [P+1], ids, cls)."""
    n_cells_total = np.uint64(1) << np.uint64(2 * n_order)
    order = np.argsort(pid.astype(np.uint64) * n_cells_total + ids)
    off = np.zeros(P + 1, np.int64)
    off[1:] = np.cumsum(np.bincount(pid, minlength=P))
    return off, ids[order], cls[order]


def _classify_cells_multi(verts, nverts, n_order, extent, backend="numpy",
                          device=None):
    """Every polygon's cells with their classes: one multi-polygon DDA for
    the Partial cells, one scanline pass for the Full cells and one padded
    coverage pass that labels each Partial cell Strong (> 50 %) or Weak.
    Returns (off [P+1], ids, cls), flat and per-polygon Hilbert-sorted."""
    P = len(nverts)
    stage = BUILD_STAGES.stage
    with stage("dda"):
        p_off, p_cells = rasterize.dda_partial_cells_multi(
            verts, nverts, n_order, extent)
    with stage("scanline"):
        f_off, f_cells = rasterize.scanline_full_cells_multi(
            verts, nverts, p_off, p_cells, n_order, extent)
    pid_p = np.repeat(np.arange(P), np.diff(p_off))
    pid_f = np.repeat(np.arange(P), np.diff(f_off))
    with stage("clip"):
        frac = rasterize.coverage_fractions_multi(
            verts, nverts, pid_p, p_cells, n_order, extent, backend=backend,
            device=device)
    with stage("pack"):
        p_cls = np.where(frac > 0.5, STRONG, WEAK).astype(np.int8)
        ids = np.concatenate([
            xy2d(n_order, p_cells[:, 0], p_cells[:, 1]),
            xy2d(n_order, f_cells[:, 0], f_cells[:, 1])])
        cls = np.concatenate([p_cls, np.full(len(pid_f), FULL, np.int8)])
        pid = np.concatenate([pid_p, pid_f])
        return _sort_ids_by_poly(pid, ids, cls, n_order, P)


def _pack_store_flat(off, ids, cls, n_order, extent, encoding) -> RIStore:
    """An RIStore over flat per-polygon-sorted cells: maximal id runs are
    the intervals, the concatenated codes in Hilbert order the bits."""
    P = len(off) - 1
    pid = np.repeat(np.arange(P), np.diff(off))
    starts, ends, int_poly = runs_from_sorted(pid, ids)
    store_off = np.zeros(P + 1, np.int64)
    store_off[1:] = np.cumsum(np.bincount(int_poly, minlength=P))
    lens = 3 * (ends - starts).astype(np.int64)
    bit_off = np.zeros(len(starts) + 1, np.int64)
    bit_off[1:] = np.cumsum(lens)
    return RIStore(
        n_order=n_order, extent=extent, encoding=encoding,
        off=store_off, ints=np.stack([starts, ends], axis=1).astype(np.uint64),
        bit_off=bit_off, bits=_CODE_LUT[encoding][cls].reshape(-1),
    )


def build_ri(dataset, n_order: int, extent: Extent = GLOBAL_EXTENT,
             encoding: str = "R", backend: str = "numpy",
             device=None) -> RIStore:
    """Build the RI store. ``backend``: ``numpy`` and ``torch`` run the
    batched dataset-level construction (``torch`` clips the Partial cells
    for their coverage fractions on ``device``); ``sequential`` is the
    per-polygon reference the batched builds are store-identical to."""
    dev = build_device(backend, device)
    if backend == "sequential":
        return _pack_store(
            (_classify_cells(dataset.verts[i], int(dataset.nverts[i]),
                             n_order, extent)
             for i in range(len(dataset))),
            n_order, extent, encoding)
    off, ids, cls = _classify_cells_multi(dataset.verts, dataset.nverts,
                                          n_order, extent, backend=backend,
                                          device=dev)
    with BUILD_STAGES.stage("pack"):
        return _pack_store_flat(off, ids, cls, n_order, extent, encoding)


def build_ri_lines(dataset, n_order: int, extent: Extent = GLOBAL_EXTENT,
                   encoding: str = "R", backend: str = "numpy",
                   device=None) -> RIStore:
    """RI store for open linestrings: every cell a chain crosses is Weak (a
    line has no interior, so its own side never certifies a hit, but Weak
    against a Full polygon cell still ANDs non-zero, §3.3). ``numpy`` and
    ``torch`` (no device pass: a chain has no coverage to clip) run the
    batched traversal; ``sequential`` traverses and packs chain by
    chain."""
    build_device(backend, device)
    if backend == "sequential":
        lines = build_line_cells(dataset, n_order, extent,
                                 backend="sequential")
        return _pack_store(
            ((lines.cell_ids(i), np.full(len(lines.cell_ids(i)), WEAK,
                                         np.int8))
             for i in range(len(lines))), n_order, extent, encoding)
    lines = build_line_cells(dataset, n_order, extent)
    return _pack_store_flat(lines.off, lines.ids,
                            np.full(len(lines.ids), WEAK, np.int8), n_order,
                            extent, encoding)


def ri_within_verdict_pair(store_x: RIStore, i: int, store_y: RIStore,
                           j: int) -> int:
    """RI within-join filter (§3.4) for one pair: is x within y?

    TRUE_NEG as soon as (i) a cell of x is empty in y, or (ii) some shared
    cell is Full in x but not Full in y, or Strong in x and Weak in y (x's
    area in that cell must exceed y's). TRUE_HIT iff every cell of x is
    Full in y (or x has no interval). Else INDECISIVE. Works on the decoded
    3-bit classes.
    """
    X = store_x.intervals(i)
    Y = store_y.intervals(j)
    if len(X) == 0:
        return TRUE_HIT
    dec_x = _DECODE[store_x.encoding]
    dec_y = _DECODE[store_y.encoding]
    all_full_in_y = True
    b = 0
    for a in range(len(X)):
        xs, xe = X[a]
        cell = xs
        while cell < xe:
            # advance y's cursor to the interval that could contain `cell`
            while b < len(Y) and Y[b][1] <= cell:
                b += 1
            if b >= len(Y) or cell < Y[b][0]:
                return TRUE_NEG          # x-cell empty in y
            ys, ye = Y[b]
            hi = min(xe, ye)
            # classes over the shared run [cell, hi)
            for c in range(int(cell), int(hi)):
                cx = _cell_class(store_x, i, a, c - int(xs), dec_x)
                cy = _cell_class(store_y, j, b, c - int(ys), dec_y)
                if (cx == FULL and cy != FULL) or (cx == STRONG and cy == WEAK):
                    return TRUE_NEG
                if cy != FULL:
                    all_full_in_y = False
            cell = hi
    return TRUE_HIT if all_full_in_y else INDECISIVE


# class decoding tables: 3-bit tuple -> class id, per encoding
_DECODE = {
    "R": {v: k for k, v in CODE_R.items()},
    "S": {v: k for k, v in CODE_S.items()},
}

# 3-bit code (b0*4 + b1*2 + b2) -> class id, per encoding; -1 = invalid
_DECODE_ARR = {}
for _enc, _tab in (("R", CODE_R), ("S", CODE_S)):
    _arr = np.full(8, -1, np.int8)
    for _cls, (_b0, _b1, _b2) in _tab.items():
        _arr[4 * _b0 + 2 * _b1 + _b2] = _cls
    _DECODE_ARR[_enc] = _arr

_U64_MAX = np.uint64(np.iinfo(np.uint64).max)


def _cell_class(store: RIStore, i: int, k: int, off: int, table) -> int:
    bits = store.interval_bits(i, k)[3 * off: 3 * off + 3]
    return table[tuple(int(b) for b in bits)]


def _pad_intervals(store: RIStore, idx: np.ndarray):
    """Padded per-pair interval endpoints: (starts [B,W], ends [B,W],
    counts [B], first_global [B]). Padding slots hold uint64 max."""
    idx = np.asarray(idx, np.int64)
    lo = store.off[idx]
    counts = (store.off[idx + 1] - lo).astype(np.int64)
    B = len(idx)
    W = int(max(1, counts.max() if B else 1))
    starts = np.full((B, W), _U64_MAX, np.uint64)
    ends = np.full((B, W), _U64_MAX, np.uint64)
    if len(store.ints) and B:
        col = np.arange(W)[None, :]
        mask = col < counts[:, None]
        src = (lo[:, None] + col)[mask]
        starts[mask] = store.ints[src, 0]
        ends[mask] = store.ints[src, 1]
    return starts, ends, counts, lo


def ri_within_batch(store_x: RIStore, store_y: RIStore,
                    pairs: np.ndarray) -> np.ndarray:
    """Vectorized RI within filter (§3.4) over pairs [N,2] on the host;
    verdict-identical to :func:`ri_within_verdict_pair` per pair."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8)
    cx = store_x.off[pairs[:, 0] + 1] - store_x.off[pairs[:, 0]]
    b, ax, gx, gy, lo, hi = _pair_fragments(store_x, store_y, pairs)

    # coverage: every x interval fully covered by (disjoint) y intervals
    Wx = int(ax.max()) + 1 if len(ax) else 1
    covered = np.zeros(N * Wx, np.int64)
    np.add.at(covered, b * Wx + ax, (hi - lo).astype(np.int64))
    xs_p, xe_p, cx_p, _ = _pad_intervals(store_x, pairs[:, 0])
    Wpad = xs_p.shape[1]           # >= Wx: ax < interval count <= Wpad
    xlen = np.where(np.arange(Wpad)[None, :] < cx_p[:, None],
                    (xe_p - xs_p).astype(np.int64), 0)
    uncovered = np.any(xlen[:, :Wx] > covered.reshape(N, Wx), axis=1)
    # x intervals with no fragments at all (columns beyond Wx) are uncovered
    uncovered |= np.any(xlen[:, Wx:] > 0, axis=1)

    # per-cell class comparison over the shared runs
    ncell = (hi - lo).astype(np.int64)
    C = int(ncell.sum())
    viol_pair = np.zeros(N, bool)
    notfull_pair = np.zeros(N, bool)
    if C:
        f_of_c = np.repeat(np.arange(len(ncell)), ncell)
        coff = np.arange(C) - np.repeat(np.cumsum(ncell) - ncell, ncell)
        cell_x = (lo[f_of_c] - store_x.ints[gx[f_of_c], 0]).astype(np.int64) + coff
        cell_y = (lo[f_of_c] - store_y.ints[gy[f_of_c], 0]).astype(np.int64) + coff

        def classes(store, g, celloff):
            o = store.bit_off[g[f_of_c]] + 3 * celloff
            code = (store.bits[o].astype(np.int8) * 4
                    + store.bits[o + 1].astype(np.int8) * 2
                    + store.bits[o + 2].astype(np.int8))
            return _DECODE_ARR[store.encoding][code]

        cls_x = classes(store_x, gx, cell_x)
        cls_y = classes(store_y, gy, cell_y)
        viol = ((cls_x == FULL) & (cls_y != FULL)) \
            | ((cls_x == STRONG) & (cls_y == WEAK))
        bc = b[f_of_c]
        np.logical_or.at(viol_pair, bc, viol)
        np.logical_or.at(notfull_pair, bc, cls_y != FULL)

    neg = uncovered | viol_pair
    out = np.where(neg, TRUE_NEG,
                   np.where(notfull_pair, INDECISIVE, TRUE_HIT)).astype(np.int8)
    out[cx == 0] = TRUE_HIT
    return out


# ---------------------------------------------------------------------------
# The per-pair reference (Algorithm 1)
# ---------------------------------------------------------------------------

def _aligned_and(xbits, xs, ybits, ys, lo, hi, xor_y: bool) -> bool:
    """ALIGNEDAND: AND the 3-bit codes of cells [lo, hi) taken from both
    intervals' bitstrings; optionally XOR-converts y's encoding first."""
    xo = 3 * int(lo - xs)
    yo = 3 * int(lo - ys)
    ln = 3 * int(hi - lo)
    xf = xbits[xo: xo + ln]
    yf = ybits[yo: yo + ln].copy()
    if xor_y:
        yf ^= np.tile(np.asarray(XOR_MASK, np.uint8), int(hi - lo))
    return bool(np.any(xf & yf))


def ri_verdict_pair(store_x: RIStore, i: int, store_y: RIStore, j: int) -> int:
    """RI-join (paper Algorithm 1) for one candidate pair."""
    X = store_x.intervals(i)
    Y = store_y.intervals(j)
    xor_y = store_x.encoding == store_y.encoding
    ovl = False
    a = b = 0
    while a < len(X) and b < len(Y):
        xs, xe = X[a]
        ys, ye = Y[b]
        if xs < ye and ys < xe:
            lo, hi = max(xs, ys), min(xe, ye)
            if _aligned_and(store_x.interval_bits(i, a), xs,
                            store_y.interval_bits(j, b), ys, lo, hi, xor_y):
                return TRUE_HIT
            ovl = True
        if xe <= ye:
            a += 1
        else:
            b += 1
    return INDECISIVE if ovl else TRUE_NEG


# ---------------------------------------------------------------------------
# The batched host filter: fragment expansion + a numpy bit pass
# ---------------------------------------------------------------------------

_MASK3 = np.asarray(XOR_MASK, np.uint8)


def _flat_intervals(store: RIStore, idx: np.ndarray):
    """Per-pair flattened interval lists: (row-of-slot [T], local-pos [T],
    global-interval [T], segment offsets [B+1])."""
    idx = np.asarray(idx, np.int64)
    lo = store.off[idx]
    counts = (store.off[idx + 1] - lo).astype(np.int64)
    T = int(counts.sum())
    b_of = np.repeat(np.arange(len(idx)), counts)
    seg = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(T) - np.repeat(seg[:-1], counts)
    return b_of, pos, lo[b_of] + pos, seg


def _pair_fragments(store_x: RIStore, store_y: RIStore, pairs: np.ndarray):
    """All overlapping interval pairs ("fragments") of the candidate batch.

    Returns (b, ax, gx, gy, lo, hi): pair row, local x-interval index, global
    interval ids into each store, and the shared cell run [lo, hi). Per
    x-interval, the overlapping y-intervals form a contiguous run (Y lists
    are sorted and disjoint), found with two flat searchsorted passes over
    row-keyed endpoints (the row index in the high bits keeps each pair's
    segment separate; Hilbert ids use at most 2*N <= 32 bits).
    """
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    bx_of, posx, gx_flat, _ = _flat_intervals(store_x, pairs[:, 0])
    by_of, posy, gy_flat, yseg = _flat_intervals(store_y, pairs[:, 1])
    if len(gx_flat) == 0 or len(gy_flat) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(np.uint64), z.astype(np.uint64)
    SHIFT = np.uint64(33)
    xkey_b = bx_of.astype(np.uint64) << SHIFT
    ykey = (by_of.astype(np.uint64) << SHIFT)
    ys_keys = ykey + store_y.ints[gy_flat, 0]
    ye_keys = ykey + store_y.ints[gy_flat, 1]
    xs_flat = store_x.ints[gx_flat, 0]
    xe_flat = store_x.ints[gx_flat, 1]
    seg0 = yseg[:-1][bx_of]
    # first y with ye > xs ; one past last y with ys < xe
    lo_idx = np.searchsorted(ye_keys, xkey_b + xs_flat, side="right") - seg0
    hi_idx = np.searchsorted(ys_keys, xkey_b + xe_flat, side="left") - seg0
    n_frag = np.maximum(hi_idx - lo_idx, 0)
    total = int(n_frag.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, z, z.astype(np.uint64), z.astype(np.uint64)
    rep = np.repeat(np.arange(len(n_frag)), n_frag)
    k = np.arange(total) - np.repeat(np.cumsum(n_frag) - n_frag, n_frag)
    b = bx_of[rep]
    ax = posx[rep]
    gx = gx_flat[rep]
    gy = store_y.off[pairs[b, 1]] + np.repeat(lo_idx, n_frag) + k
    lo = np.maximum(store_x.ints[gx, 0], store_y.ints[gy, 0])
    hi = np.minimum(store_x.ints[gx, 1], store_y.ints[gy, 1])
    return b, ax, gx, gy, lo, hi


def _fragment_hits_np(store_x: RIStore, store_y: RIStore, gx, gy, lo, hi,
                      xor_y: bool, chunk_elems: int = 1 << 24) -> np.ndarray:
    """ALIGNEDAND over all fragments, numpy bit-level path -> [F] bool."""
    F = len(gx)
    nbits = (3 * (hi - lo)).astype(np.int64)
    xo = store_x.bit_off[gx] + 3 * (lo - store_x.ints[gx, 0]).astype(np.int64)
    yo = store_y.bit_off[gy] + 3 * (lo - store_y.ints[gy, 0]).astype(np.int64)
    hits = np.zeros(F, bool)
    bx = store_x.bits
    by = store_y.bits
    # power-of-two size buckets bound padding waste to 2x; rows per chunk
    # bound the padded working set
    for sel in rasterize.size_buckets(nbits, chunk_elems):
        L = int(nbits[sel].max())
        pos = np.arange(L)
        keep = pos[None, :] < nbits[sel, None]
        xi = np.clip(xo[sel, None] + pos[None, :], 0, max(len(bx) - 1, 0))
        yi = np.clip(yo[sel, None] + pos[None, :], 0, max(len(by) - 1, 0))
        xv = bx[xi]
        yv = by[yi]
        if xor_y:
            yv = yv ^ _MASK3[pos % 3][None, :]
        hits[sel] = np.any((xv & yv) & keep, axis=1)
    return hits


def ri_filter_batch(store_x: RIStore, store_y: RIStore,
                    pairs: np.ndarray) -> np.ndarray:
    """Vectorized RI intersection filter (Algorithm 1) over pairs [N,2] on
    the host; verdict-identical to :func:`ri_verdict_pair` per pair:
    TRUE_HIT if any shared cell run ANDs non-zero, INDECISIVE if interval
    ranges overlap without a code hit, TRUE_NEG otherwise."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.int8)
    xor_y = store_x.encoding == store_y.encoding
    b, ax, gx, gy, lo, hi = _pair_fragments(store_x, store_y, pairs)
    ovl_pair = np.zeros(N, bool)
    ovl_pair[b] = True
    hit_pair = np.zeros(N, bool)
    # batch-level short-circuit: AND the k-th fragment of every undecided
    # pair per round, so a pair decided by an early fragment never pays for
    # its remaining ones; after a few rounds the survivors are flushed
    if len(b):
        first = np.r_[True, b[1:] != b[:-1]]
        seg = np.nonzero(first)[0]
        rank = np.arange(len(b)) - np.repeat(seg, np.diff(np.r_[seg, len(b)]))
        todo = np.arange(len(b))
        r = 0
        while len(todo):
            todo = todo[~hit_pair[b[todo]]]
            if len(todo) == 0:
                break
            if r < 4:
                m = rank[todo] == r
                cur = todo[m]
                todo = todo[~m]
            else:               # flush the tail in one pass
                cur = todo
                todo = todo[:0]
            if len(cur):
                hits = _fragment_hits_np(store_x, store_y, gx[cur], gy[cur],
                                         lo[cur], hi[cur], xor_y)
                np.logical_or.at(hit_pair, b[cur], hits)
            r += 1
    return np.where(hit_pair, TRUE_HIT,
                    np.where(ovl_pair, INDECISIVE, TRUE_NEG)).astype(np.int8)


# ---------------------------------------------------------------------------
# The device store and the device filter
# ---------------------------------------------------------------------------

class RIDeviceStore:
    """One RI store laid out for the ALIGNEDAND kernel: CSR interval starts
    and inclusive lasts as biased int32 (APRIL's device lists' layout,
    :func:`~repro_torch.core.hilbert.u32_to_biased_i32`), so every order up
    to 16 fits, int64 bit offsets, and the whole code stream packed
    LSB-first into uint32 words plus one zero pad word. :meth:`to`
    uploads the arrays to a device once and caches them there."""

    __slots__ = ("store", "off", "starts", "lasts", "bit_off", "words",
                 "_device")

    def __init__(self, store: RIStore):
        self.store = store
        self.off = np.ascontiguousarray(store.off, np.int64)
        self.starts = u32_to_biased_i32(store.ints[:, 0])
        self.lasts = u32_to_biased_i32(store.ints[:, 1] - np.uint64(1))
        self.bit_off = np.ascontiguousarray(store.bit_off, np.int64)
        self.words = pack_stream_words(store.bits)
        self._device: dict[str, RIStoreTensors] = {}

    @property
    def encoding(self) -> str:
        return self.store.encoding

    def __len__(self) -> int:
        return len(self.off) - 1

    def to(self, device) -> RIStoreTensors:
        dev = torch.device(device)
        key = str(dev)
        if key not in self._device:
            self._device[key] = RIStoreTensors(
                *(torch.from_numpy(a).to(dev) for a in (
                    self.off, self.starts, self.lasts, self.bit_off,
                    self.words)))
        return self._device[key]

    def drop_device(self) -> None:
        """Forget the device copies; :meth:`to` uploads them again."""
        self._device = {}


def _device_store(s) -> RIDeviceStore:
    return s if isinstance(s, RIDeviceStore) else RIDeviceStore(s)


_FRAMES = InputLog()


def record_frames():
    """Collect the device inputs ``(x, y, ri, si, xor_y)`` of every device
    RI filter call run inside the block, one tuple per call, so that the
    ALIGNEDAND kernel can be replayed on exactly what a join gave it."""
    return _FRAMES.record()


def _run(backend, X: RIDeviceStore, Y: RIDeviceStore, rows, dev):
    x, y = X.to(dev), Y.to(dev)
    xor_y = X.encoding == Y.encoding
    _FRAMES.add((x, y, rows[0], rows[1], xor_y))
    fn = ri_trichotomy if backend == "cuda" else ri_trichotomy_plain
    return fn(x, y, rows[0], rows[1], xor_y)


def ri_trichotomy_rows(store_x, store_y, ri: np.ndarray, si: np.ndarray, *,
                       backend: str = "numpy", device=None) -> np.ndarray:
    """RI verdicts (Algorithm 1) of rows (ri[n], si[n]) -> [N] int8.

    ``store_x``/``store_y`` are RIStores; the ``torch`` and ``cuda``
    backends also take their :class:`RIDeviceStore` (pass those to reuse
    their device copies). ``numpy`` is the host
    fragment pass, ``sequential`` the per-pair merge, ``torch`` the
    kernel's plain version on ``device`` and ``cuda`` one kernel launch
    over every row (``device`` ``None`` -> ``"cuda"``).
    """
    check_filter_backend(backend)
    ri = np.ascontiguousarray(ri, np.int64)
    si = np.ascontiguousarray(si, np.int64)
    N = len(ri)
    if backend == "numpy":
        return ri_filter_batch(store_x, store_y, np.stack([ri, si], axis=1))
    if backend == "sequential":
        return np.asarray([ri_verdict_pair(store_x, int(r), store_y, int(s))
                           for r, s in zip(ri, si)], np.int8).reshape(N)
    dev = resolve_device(device)
    check_backend_device(backend, dev)
    if N == 0:
        return np.zeros(0, np.int8)
    X, Y = _device_store(store_x), _device_store(store_y)
    _check_frame(ri, X, "ri")
    _check_frame(si, Y, "si")
    rows = (upload(ri, dev), upload(si, dev))
    return _run(backend, X, Y, rows, dev).cpu().numpy()


def ri_status_rows(X: RIDeviceStore, Y: RIDeviceStore, ri: np.ndarray,
                   si: np.ndarray, *, rows=None, backend: str = "cuda",
                   device=None) -> torch.Tensor:
    """Device int8 status lane [N] of the RI filter over every row of the
    fused chain's pair frame, computed on ``device`` with no host read:
    ``backend="cuda"`` is one kernel launch straight into the lane, the
    others run its plain version. The frame is range-checked on the host;
    ``rows`` are its int64 copies already on ``device``, else it is
    uploaded here. Call ``X.to(device)`` and ``Y.to(device)`` first for
    the call to stay free of host syncs."""
    check_filter_backend(backend)
    dev = resolve_device(device)
    check_backend_device(backend, dev)
    ri = np.asarray(ri, np.int64)
    si = np.asarray(si, np.int64)
    _check_frame(ri, X, "ri")
    _check_frame(si, Y, "si")
    if rows is None:
        rows = (upload(np.ascontiguousarray(ri), dev),
                upload(np.ascontiguousarray(si), dev))
    if len(ri) == 0:
        return torch.zeros(0, dtype=torch.int8, device=dev)
    return _run(backend, X, Y, rows, dev)
