"""RI pair rows drawn at the edges of the RI kernel's merge, from a seeded
numpy generator.

The kernel (``csrc/ri_and.cu``) merges a pair row's interval lists two
pointers at a time and drops 8 intervals of a list at once where the 8th
still ends before the other list's current interval starts (the strided
skip); it ANDs every overlapping pair's shared cell run ("fragment") word
by word and stops at the first hit. So the list widths that end one or two
strides exactly, one short or one over, the fragments' bit phases in the
code streams, the fragments about one, two and three words long, the
longest fragment of the T1 x T2 frame, a hit in the last fragment of a long
merge, lists far apart along the curve and the ends of the order-16 id
range are where a fault would show.

:func:`draw_ri_rows` draws an X and a Y RI store whose pair row ``n`` joins
object ``n`` of X with object ``n`` of Y. Each side is a dict of numpy
arrays as an RI store holds them: ``off`` [P+1] int64, ``ints`` [I, 2]
uint64 half-open cell runs [start, end) of Hilbert ids (order 16: ids up
to 2^32 - 1), ``bit_off`` [I+1] int64 and ``bits`` [3 * cells] uint8, the
3-bit code of every cell of every run, in order. The codes are made so
that the verdict is known: X's code of a cell and Y's code after the
re-encoding (``xor_y``: the stored Y bits are XORed with the mask (1, 1, 0)
from each run's start, as when both stores share an encoding) never share
a bit, except at planted cells, one a TRUE_HIT row. ``verdict`` gives each
row's verdict by that construction (0 TRUE_NEG, 1 TRUE_HIT, 2 INDECISIVE).
The CPU tests hold the plain version to the reference on these rows;
``chip_smoke.py`` holds the CUDA kernel to the plain version and to the
construction on more of them.
"""
from __future__ import annotations

import numpy as np
import torch

from .ref import RIStoreTensors, pack_stream_words

__all__ = ["STRIDE", "WIDTHS", "FRAGMENT_CELLS", "LONG_CELLS", "CASES",
           "U32_TOP", "draw_ri_rows", "store_tensors"]

#: intervals the kernel's strided skip drops at once
STRIDE = 8
#: list widths at the strided skip's edges
WIDTHS = (0, 1, STRIDE - 1, STRIDE, STRIDE + 1, 2 * STRIDE)
#: fragment lengths in cells: 30, 33, 63, 66, 96 and 99 bits
FRAGMENT_CELLS = (10, 11, 21, 22, 32, 33)
#: cells of the longest fragment of the T1 x T2 frame: 5,268 bits, 165 words
LONG_CELLS = 1756
#: how a pair row is drawn: "widths" random lists of :data:`WIDTHS`
#: intervals over overlapping ranges; "phases" one long run on one side and
#: six runs of :data:`FRAGMENT_CELLS` cells inside it on the other;
#: "long" one fragment of :data:`LONG_CELLS` cells; "last_fragment"
#: interleaved lists of up to 5 strides, each run overlapping two of the
#: other side (about 2w - 1 fragments), the hit if any in the last one;
#: "far" a long list whose other side starts near its end (the skip drops
#: the rest a stride at a time), or past it; "int32_min" / "int32_max" lists pinned to id 0 /
#: 2^32 - 1 (biased INT32_MIN / INT32_MAX); "empty" an empty list on one
#: side or both
CASES = ("widths", "phases", "long", "last_fragment", "far", "int32_min",
         "int32_max", "empty")
U32_TOP = 2**32 - 1

_BASE = 1 << 20       # where the lists of cases away from the limits lie
#: the re-encoding mask's bits of one 3-bit cell code, bit t = stream bit t
_MASK_CODE = 0b011


def _runs(rng, w, lo, gap=8, length=12):
    """``w[n]`` sorted disjoint runs (inclusive ``(row, start, last)``) for
    each row n, the first starting at ``lo[n]`` or just after: gaps of 1 to
    ``gap - 1`` cells between runs, runs of 1 to ``length + 1`` cells."""
    row = np.repeat(np.arange(len(w)), w)
    g = rng.integers(2, gap + 1, len(row))
    span = rng.integers(0, length + 1, len(row))
    end = np.cumsum(g + span)
    before = np.concatenate([[0], end])[np.cumsum(w) - w]
    lasts = lo[row] - 2 + end - before[row]
    return row, lasts - span, lasts


def _first_last(L, n):
    """(has, first start, last last) of each of ``n`` rows of list L."""
    row, s, l = L
    c = np.bincount(row, minlength=n)
    off = np.concatenate([[0], np.cumsum(c)])
    has = c > 0
    idx = np.minimum(off[:-1], max(len(s) - 1, 0))
    first = np.where(has, s[idx] if len(s) else 0, 0)
    last = np.where(has, l[np.maximum(off[1:] - 1, 0)] if len(l) else 0, 0)
    return has, first, last, off


def _shift(L, d):
    row, s, l = L
    return row, s + d[row], l + d[row]


def _swap(rng, n, X, Y):
    """X and Y exchanged on about half of the rows."""
    sw = rng.random(n) < 0.5
    pick = lambda A, B: tuple(np.concatenate([a[~sw[A[0]]], b[sw[B[0]]]])
                              for a, b in zip(A, B))
    out = []
    for A, B in ((X, Y), (Y, X)):
        row, s, l = pick(A, B)
        o = np.lexsort((s, row))
        out.append((row[o], s[o], l[o]))
    return out


def _widths(rng, n):
    """Lists of :data:`WIDTHS` intervals, Y laid across X's range or just
    beside it."""
    wx, wy = np.asarray(WIDTHS)[rng.integers(len(WIDTHS), size=(2, n))]
    X = _runs(rng, wx, _BASE + rng.integers(0, 64, n))
    Y = _runs(rng, wy, np.zeros(n, np.int64))
    hx, x0, x1, _ = _first_last(X, n)
    hy, y0, y1, _ = _first_last(Y, n)
    lo, hi = x0 - y1 - 2, x1 - y0 + 2
    d = np.where(hx & hy, lo + (rng.random(n) * (hi - lo + 1)).astype(
        np.int64), _BASE)
    return X, _shift(Y, d)


def _case(rng, name, n):
    """(X, Y, plant) of ``n`` rows of ``name``: X and Y as (row, start,
    last) inclusive runs, ``plant`` [n] 0 none, 1 a random shared cell, 2
    the last shared cell at its code's last bit."""
    plant = rng.integers(0, 2, n)
    base = _BASE + rng.integers(0, 1 << 16, n)
    if name in ("widths", "int32_min", "int32_max", "empty"):
        X, Y = _widths(rng, n)
        if name == "empty":
            which = rng.integers(0, 3, n)      # X, Y or both empty
            X, Y = (tuple(a[~np.isin(which, k)[L[0]]] for a in L)
                    for L, k in ((X, (0, 2)), (Y, (1, 2))))
        elif name != "widths":
            hx, x0, x1, ox = _first_last(X, n)
            hy, y0, y1, oy = _first_last(Y, n)
            big = np.int64(U32_TOP) * 4
            if name == "int32_min":
                m = np.minimum(np.where(hx, x0, big), np.where(hy, y0, big))
                d = rng.integers(0, 4, n) - m
            else:
                m = np.maximum(np.where(hx, x1, -big), np.where(hy, y1, -big))
                d = U32_TOP - rng.integers(0, 4, n) - m
            d = np.where(hx | hy, d, 0)
            X, Y = _shift(X, d), _shift(Y, d)
            pin = rng.integers(0, 3, n)        # X, Y or both reach the limit
            for k, (L, has, off) in enumerate(((X, hx, ox), (Y, hy, oy))):
                r = np.nonzero(has & ((pin == k) | (pin == 2)))[0]
                if name == "int32_min":
                    L[1][off[r]] = 0
                else:
                    L[2][off[r + 1] - 1] = U32_TOP
    elif name == "phases":
        # six runs of about one to three words inside one run of 400 cells
        cells = np.asarray(FRAGMENT_CELLS)[rng.integers(len(FRAGMENT_CELLS),
                                                        size=6 * n)]
        row = np.repeat(np.arange(n), 6)
        gap = rng.integers(2, 6, 6 * n)
        end = np.cumsum((gap + cells).reshape(n, 6), axis=1).ravel()
        s = base[row] + 8 + end - cells
        X = (np.arange(n), base, base + 399)
        Y = (row, s, s + cells - 1)
        X, Y = _swap(rng, n, X, Y)
        plant = rng.integers(0, 3, n)
    elif name == "long":
        pad = rng.integers(0, 41, (2, n))
        X = (np.arange(n), base, base + LONG_CELLS + pad[0] + pad[1] - 1)
        Y = (np.arange(n), base + pad[0], base + pad[0] + LONG_CELLS - 1)
        X, Y = _swap(rng, n, X, Y)
        plant = np.where(plant > 0, 2, 0)
    elif name == "last_fragment":
        # x_i = [10i, 10i + 6], y_i = [10i + 4, 10i + 12]: y_i meets x_i and
        # x_(i+1)
        w = np.asarray((STRIDE - 1, STRIDE, STRIDE + 1, 2 * STRIDE, 5 * STRIDE))[
            rng.integers(0, 5, n)]
        row = np.repeat(np.arange(n), w)
        i = np.arange(len(row)) - (np.cumsum(w) - w)[row]
        X = (row, base[row] + 10 * i, base[row] + 10 * i + 6)
        Y = (row, base[row] + 10 * i + 4, base[row] + 10 * i + 12)
        X, Y = _swap(rng, n, X, Y)
        plant = np.where(rng.random(n) < 2 / 3, 2, 0)
    elif name == "far":
        wx = np.asarray((2 * STRIDE + 1, 5 * STRIDE))[rng.integers(0, 2, n)]
        wy = np.asarray((1, STRIDE, STRIDE + 1))[rng.integers(0, 3, n)]
        X = _runs(rng, wx, base)
        _, _, _, ox = _first_last(X, n)
        # Y from X's last but one start (meets X's last two runs at most),
        # or past X's end
        past = rng.random(n) < 0.25
        lo = np.where(past, X[2][ox[1:] - 1] + 2, X[1][ox[1:] - 2])
        Y = _runs(rng, wy, lo)
        X, Y = _swap(rng, n, X, Y)
    else:
        raise ValueError(f"unknown case {name!r}")
    return X, Y, plant


def _mix(a):
    """splitmix64's finaliser over a uint64 array."""
    a = (a ^ (a >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    a = (a ^ (a >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return a ^ (a >> np.uint64(31))


def _cells(L):
    """Every cell of list L: (row, cell id) keys ``row << 33 | cell``."""
    row, s, l = L
    c = l - s + 1
    r = np.repeat(row, c)
    cell = np.repeat(s, c) + (np.arange(c.sum()) - np.repeat(np.cumsum(c) - c,
                                                            c))
    return (r.astype(np.int64) << 33) | cell


def draw_ri_rows(seed: int, rows: int, xor_y: bool, cases=CASES):
    """X and Y RI stores of ``rows`` pair rows drawn by ``cases`` in turn:
    a dict of ``x`` and ``y`` (each ``off``, ``ints``, ``bit_off``,
    ``bits``), ``case`` [rows] (the index in ``cases`` of each row) and
    ``verdict`` [rows] int8 by construction; Y's stored codes are
    re-encoded when ``xor_y``."""
    rng = np.random.default_rng(seed)
    case = np.arange(rows) % len(cases)
    sides = {"x": [], "y": []}
    plant = np.zeros(rows, np.int64)
    for c, name in enumerate(cases):
        ids = np.nonzero(case == c)[0]
        X, Y, p = _case(rng, name, len(ids))
        plant[ids] = p
        for k, (row, s, l) in (("x", X), ("y", Y)):
            sides[k].append((ids[row], s, l))
    out, keys = {}, {}
    for k, parts in sides.items():
        row, s, l = (np.concatenate([p[i] for p in parts]) for i in range(3))
        o = np.lexsort((s, row))
        row, s, l = row[o], s[o], l[o]
        if len(s) and not (s.min() >= 0 and l.max() <= U32_TOP
                           and np.all(l >= s) and np.all(
                               (row[1:] != row[:-1]) | (s[1:] > l[:-1] + 1))):
            raise AssertionError(f"{k}: a drawn list is not sorted, disjoint "
                                 "and maximal")
        keys[k] = _cells((row, s, l))
        off = np.zeros(rows + 1, np.int64)
        off[1:] = np.cumsum(np.bincount(row, minlength=rows))
        ints = np.stack([s, l + 1], axis=1).astype(np.uint64)
        bit_off = np.zeros(len(s) + 1, np.int64)
        bit_off[1:] = 3 * np.cumsum(l - s + 1)
        out[k] = {"off": off, "ints": ints, "bit_off": bit_off}
    # codes: X's and Y's (after re-encoding) share no bit, but at the plants
    salt = np.uint64(seed * 0x9E3779B97F4A7C15 % 2**64)
    code = lambda key, side: (_mix(key.astype(np.uint64) * np.uint64(2)
                                   + np.uint64(side) + salt)
                              & np.uint64(7)).astype(np.uint8)
    xcode = code(keys["x"], 0)
    ycode = code(keys["y"], 1) & ~code(keys["y"], 0) & np.uint8(7)
    shared = np.intersect1d(keys["x"], keys["y"])
    srow = shared >> 33
    has = np.bincount(srow, minlength=rows) > 0
    first = np.searchsorted(srow, np.arange(rows))
    n_shared = np.bincount(srow, minlength=rows)
    hit = has & (plant > 0)
    r = np.nonzero(hit)[0]
    pick = np.where(plant[r] == 2, n_shared[r] - 1,
                    (rng.random(len(r)) * n_shared[r]).astype(np.int64))
    cell = shared[first[r] + pick]
    bit = np.where(plant[r] == 2, 2, rng.integers(0, 3, len(r))).astype(
        np.uint8)
    xcode[np.searchsorted(keys["x"], cell)] |= np.uint8(1) << bit
    ycode[np.searchsorted(keys["y"], cell)] |= np.uint8(1) << bit
    if xor_y:
        ycode ^= np.uint8(_MASK_CODE)
    for k, cd in (("x", xcode), ("y", ycode)):
        out[k]["bits"] = ((cd[:, None] >> np.arange(3, dtype=np.uint8))
                          & 1).astype(np.uint8).ravel()
    out["case"] = case
    out["verdict"] = np.where(hit, 1, np.where(has, 2, 0)).astype(np.int8)
    return out


def store_tensors(side: dict, device="cpu") -> RIStoreTensors:
    """A drawn side as the kernel's store tensors: biased int32 starts and
    inclusive lasts, the code stream packed into uint32 words."""
    s = side["ints"][:, 0].astype(np.int64)
    l = side["ints"][:, 1].astype(np.int64) - 1
    arrays = (side["off"], (s - 2**31).astype(np.int32),
              (l - 2**31).astype(np.int32), side["bit_off"],
              pack_stream_words(side["bits"]))
    return RIStoreTensors(*(torch.from_numpy(np.ascontiguousarray(a))
                            .to(device) for a in arrays))
