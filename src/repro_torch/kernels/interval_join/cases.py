"""Interval lists drawn at the edges of the interval-join kernels' window
tiling, from a seeded numpy generator.

The kernels (``csrc/interval_join.cu``) join a pair row's lists by windows
of G = 8 intervals, so the widths that end one, two or four windows
exactly, one short or one over, the intervals whose ends touch, and the ends at the
limits of the biased int32 range are where a tiling fault would show.
:func:`draw_pair_rows` draws APRIL stores (A and F lists of both sides)
whose pair row ``n`` joins row ``n`` of the X side with row ``n`` of the Y
side; the CPU tests hold the plain versions to the reference's Pallas
kernels on them, and ``chip_smoke.py`` holds the CUDA kernels to the plain
versions on 65,536 such rows.

Lists are CSR, as :class:`~repro_torch.kernels.interval_join.ref.CSRLists`
holds them: ``off`` int64, ``starts`` and ``lasts`` biased int32 (id -
2^31), inclusive lasts, each row sorted and disjoint (a start at least two
ids past the previous last, as APRIL's maximal runs are).
"""
from __future__ import annotations

import numpy as np

__all__ = ["WINDOW_SPANS", "SPECIAL_WIDTHS", "CASES", "U32_TOP", "draw_pair_rows"]

#: the intervals of one, two and four of the kernels' windows (G = 8)
WINDOW_SPANS = (8, 16, 32)
#: list widths the tiling makes special: empty, one, W - 1, W, W + 1 and
#: 2W + 1 for every span W, and lists wider than 256 (the TPU kernel's cap)
#: and than 543 (the widest A(r) list of the T1 x T2 frame at order 12)
SPECIAL_WIDTHS = tuple(sorted({0, 1, 300, 600, *(
    w for g in WINDOW_SPANS for w in (g - 1, g, g + 1, 2 * g + 1))}))
#: how a pair row's lists are drawn: "random" two lists over overlapping
#: ranges; "gaps" one list the gaps of the other (no overlap, every end one
#: id from the other list's); "touching" the gaps with one of them widened
#: by one id, so that a y start equals an x last or a y last an x start;
#: "int32_min" / "int32_max" lists pinned to id 0 / 2^32 - 1 (biased
#: INT32_MIN / INT32_MAX); "empty" an empty A or F list on one side or
#: both; "f_outside_a" F drawn apart from A (every other case draws F
#: inside A)
CASES = ("random", "gaps", "touching", "int32_min", "int32_max", "empty",
         "f_outside_a")
U32_TOP = 2**32 - 1

_BASE = 1 << 20           # where the lists of cases away from the limits lie


class _Lists:
    """The lists of a batch of rows: ``row`` [T] (the batch row of each
    interval, ascending), ``s`` and ``l`` [T] (unbiased int64 ids), ``n``
    rows."""

    def __init__(self, row, s, l, n):
        self.row, self.s, self.l, self.n = row, s, l, n

    def counts(self):
        return np.bincount(self.row, minlength=self.n)

    def ends(self):
        """(has, first start, last last) a row; 0 where a row is empty."""
        c = self.counts()
        off = np.concatenate([[0], np.cumsum(c)])
        has = c > 0
        first = np.where(has, self.s[np.minimum(off[:-1], len(self.s) - 1)]
                         if len(self.s) else 0, 0)
        last = np.where(has, self.l[np.maximum(off[1:] - 1, 0)]
                        if len(self.l) else 0, 0)
        return has, first, last, off

    def keep(self, mask):
        """The intervals where ``mask`` [T] is set."""
        return _Lists(self.row[mask], self.s[mask], self.l[mask], self.n)

    def shifted(self, d):
        """Every row moved by ``d`` [n] ids."""
        return _Lists(self.row, self.s + d[self.row], self.l + d[self.row],
                      self.n)


def _pick(take_b, A: _Lists, B: _Lists) -> _Lists:
    """Row n from ``B`` where ``take_b[n]``, else from ``A``."""
    a, b = ~take_b[A.row], take_b[B.row]
    row = np.concatenate([A.row[a], B.row[b]])
    order = np.argsort(row, kind="stable")
    return _Lists(row[order], np.concatenate([A.s[a], B.s[b]])[order],
                  np.concatenate([A.l[a], B.l[b]])[order], A.n)


def _runs(rng, w, lo) -> _Lists:
    """``w[n]`` sorted disjoint inclusive intervals for each row n, the
    first starting at ``lo[n]`` or just after: gaps of 2 to ``gap`` ids and
    lengths of 0 to ``length`` ids, both drawn per row."""
    n = len(w)
    gap = np.array((2, 3, 8, 40))[rng.integers(4, size=n)]
    length = np.array((0, 2, 12, 60))[rng.integers(4, size=n)]
    row = np.repeat(np.arange(n), w)
    g = rng.integers(2, gap[row] + 1)
    span = rng.integers(0, length[row] + 1)
    total = np.cumsum(g + span)
    before = np.concatenate([[0], total])[np.cumsum(w) - w]
    lasts = lo[row] - 2 + total - before[row]
    return _Lists(row, lasts - span, lasts, n)


def _gaps(A: _Lists) -> _Lists:
    """The ids between consecutive intervals of each row, as intervals."""
    nxt = np.nonzero(A.row[1:] == A.row[:-1])[0]
    return _Lists(A.row[nxt], A.l[nxt] + 1, A.s[nxt + 1] - 1, A.n)


def _inside(rng, A: _Lists) -> _Lists:
    """F inside A: a sub-interval of about half of A's intervals."""
    A = A.keep(rng.random(len(A.s)) < 0.5)
    a = A.s + (rng.random(len(A.s)) * (A.l - A.s + 1)).astype(np.int64)
    b = a + (rng.random(len(A.s)) * (A.l - a + 1)).astype(np.int64)
    return _Lists(A.row, a, b, A.n)


def _one(lo, hi) -> _Lists:
    """One interval [lo[n], hi[n]] a row."""
    n = len(lo)
    return _Lists(np.arange(n), lo, hi, n)


def _draw_batch(rng, case: str, n: int, widths):
    """(xa, xf, ya, yf) of ``n`` pair rows of ``case``."""
    widths = np.asarray(widths, np.int64)
    wx, wy = widths[rng.integers(len(widths), size=(2, n))]
    xa = _runs(rng, wx, _BASE + rng.integers(0, 64, n))
    if case in ("gaps", "touching"):
        # rows of fewer than two intervals have no gaps: two intervals that
        # touch, or not
        e = _BASE + rng.integers(0, 64, n)
        gap = 0 if case == "touching" else 1
        narrow = wx < 2
        xa = _pick(narrow, xa, _one(e - 5, e))
        ya = _pick(narrow, _gaps(xa), _one(e + gap, e + gap + 3))
        if case == "touching":
            # widen one gap of each wide row by an id at one end: a y start
            # == an x last, or a y last == an x start
            _, _, _, off = ya.ends()
            c = ya.counts()
            k = off[:-1] + (rng.random(n) * c).astype(np.int64)
            low = rng.random(n) < 0.5
            w = np.nonzero(~narrow)[0]
            ya.s[k[w[low[w]]]] -= 1
            ya.l[k[w[~low[w]]]] += 1
        swap = rng.random(n) < 0.5
        xa, ya = _pick(swap, xa, ya), _pick(swap, ya, xa)
    else:
        ya = _runs(rng, wy, np.zeros(n, np.int64))
        hx, x0, x1, _ = xa.ends()
        hy, y0, y1, _ = ya.ends()
        both = hx & hy
        # a shift that lays Y's range across X's, or just beside it
        lo, hi = x0 - y1 - 2, x1 - y0 + 2
        d = np.where(both, lo + (rng.random(n) * (hi - lo + 1)).astype(
            np.int64), _BASE)
        ya = ya.shifted(d)
    if case in ("int32_min", "int32_max"):
        # both lists moved to a few ids from the limit, then X, Y or both
        # widened to reach it
        pin = rng.integers(0, 3, n)
        hx, x0, x1, ox = xa.ends()
        hy, y0, y1, oy = ya.ends()
        big = np.int64(U32_TOP) * 4
        if case == "int32_min":
            m = np.minimum(np.where(hx, x0, big), np.where(hy, y0, big))
            d = rng.integers(0, 4, n) - m
        else:
            m = np.maximum(np.where(hx, x1, -big), np.where(hy, y1, -big))
            d = U32_TOP - rng.integers(0, 4, n) - m
        d = np.where(hx | hy, d, 0)
        xa, ya = xa.shifted(d), ya.shifted(d)
        for k, (L, has, off) in enumerate(((xa, hx, ox), (ya, hy, oy))):
            r = np.nonzero(has & ((pin == k) | (pin == 2)))[0]
            if case == "int32_min":
                L.s[off[r]] = 0
            else:
                L.l[off[r + 1] - 1] = U32_TOP
    if case == "f_outside_a":
        xf, yf = (_runs(rng, widths[rng.integers(len(widths), size=n)],
                        np.where(h, first, _BASE))
                  for h, first, _, _ in (xa.ends(), ya.ends()))
    else:
        xf, yf = _inside(rng, xa), _inside(rng, ya)
    if case == "empty":
        which = rng.integers(0, 6, n)   # A or F of X, of Y, or both
        drop = lambda L, rows: L.keep(~np.isin(which, rows)[L.row])
        xa, ya = drop(xa, (0, 2)), drop(ya, (1, 2))
        xf, yf = drop(xf, (0, 2, 3, 5)), drop(yf, (1, 2, 4, 5))
    return xa, xf, ya, yf


def draw_pair_rows(seed: int, rows: int, cases=CASES,
                   widths=SPECIAL_WIDTHS):
    """APRIL stores of ``rows`` pair rows drawn by ``cases`` in turn, list
    widths drawn from ``widths``: a dict of four CSR triples (off, starts,
    lasts) ``xa``, ``xf``, ``ya``, ``yf``, and ``case`` [rows], the index in
    ``cases`` of each row. Each case's rows are drawn together, in a few
    numpy calls."""
    rng = np.random.default_rng(seed)
    case = np.arange(rows) % len(cases)
    batches = [(np.nonzero(case == c)[0], _draw_batch(
        rng, name, int((case == c).sum()), widths))
        for c, name in enumerate(cases)]
    out = {}
    for i, k in enumerate(("xa", "xf", "ya", "yf")):
        row = np.concatenate([ids[b[i].row] for ids, b in batches])
        order = np.argsort(row, kind="stable")
        s, l = (np.concatenate([getattr(b[i], a) for _, b in batches])[order]
                for a in ("s", "l"))
        off = np.zeros(rows + 1, np.int64)
        off[1:] = np.cumsum(np.bincount(row, minlength=rows))
        first = np.zeros(len(s), bool)
        first[off[:-1][off[:-1] < off[1:]]] = True
        if len(s) and not (s.min() >= 0 and l.max() <= U32_TOP
                           and np.all(l >= s)
                           and np.all(first[1:] | (s[1:] > l[:-1]))):
            raise AssertionError(f"{k}: a drawn list is not sorted and "
                                 "disjoint")
        out[k] = (off, (s - 2**31).astype(np.int32),
                  (l - 2**31).astype(np.int32))
    out["case"] = case
    return out
