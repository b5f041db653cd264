"""Lanes drawn at the edges of the compaction kernel's tiling.

The kernel (``csrc/compact.cu``) gives each block of a co-resident grid a
contiguous range of whole 1024-row tiles and sweeps a range 256 rows at a
time, so the lengths that end a tile exactly, one short or one over, the
set rows at a lane's two ends and the runs that flip on every row are where
a fault of the pack would show; a lane of more tiles than the resident grid
has blocks (132 SMs x 6 on an H100) makes every block take several tiles.
:func:`lanes` gives them as numpy bool arrays, by name;
the CPU tests hold the plain version to the reference's Pallas scan on the
small ones, and ``chip_smoke.py`` holds the CUDA kernel to the plain version
and the stable-argsort oracle on all of them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LENGTHS", "PATTERNS", "LONG_ROWS", "lanes"]

#: lane lengths: empty, one row, and a tile one short, exact and one over
LENGTHS = (0, 1, 1023, 1024, 1025)
#: how a lane's rows are set
PATTERNS = ("all", "none", "first", "last", "alternating")
#: a lane longer than one sweep of the resident grid: 8,193 tiles and 17 rows
LONG_ROWS = 2**23 + 17


def _lane(pattern: str, n: int) -> np.ndarray:
    m = np.zeros(n, bool)
    if pattern == "all":
        m[:] = True
    elif pattern == "first":
        m[:1] = True
    elif pattern == "last":
        m[n - 1:] = True
    elif pattern == "alternating":
        m[::2] = True
    elif pattern != "none":
        raise ValueError(f"unknown lane pattern {pattern!r}")
    return m


def lanes(long: bool = False) -> dict[str, np.ndarray]:
    """Every pattern at every length of :data:`LENGTHS` (``"<pattern>
    n=<n>"``), each distinct lane once (at n 0 and 1 patterns coincide);
    with ``long``, also :data:`LONG_ROWS`-row lanes alternating and drawn
    at random (a third set, seed 5), which only the card sweeps."""
    out: dict[str, np.ndarray] = {}
    for n in LENGTHS:
        for p in PATTERNS:
            m = _lane(p, n)
            if not any(len(v) == n and np.array_equal(v, m)
                       for v in out.values()):
                out[f"{p} n={n}"] = m
    if long:
        out[f"alternating n={LONG_ROWS}"] = _lane("alternating", LONG_ROWS)
        out[f"random n={LONG_ROWS}"] = \
            np.random.default_rng(5).random(LONG_ROWS) < 1 / 3
    return out
