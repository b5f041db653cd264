"""The least bytes the filter kernels must move, and their roofline share.

The counts follow what a kernel's inputs need, whatever implements it:
each interval list that the frame's rows name is read once, at 8 bytes an
interval (its start and inclusive last, int32 each); each row's two frame
indices are read once (int64, as the frame holds them); and one verdict
byte is written a row. Offsets and any list read twice are left out, so
the count is a lower bound and the share an upper one.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "b1_bytes", "b4_bytes", "c_bytes", "share_pct"]

#: published HBM3 bandwidth of one H100 SXM (NVIDIA's data sheet), at the
#: card's full power limit of 700 W
HBM_BYTES_PER_S = 3.35e12
INTERVAL_BYTES = 8
ROW_ID_BYTES = 8
VERDICT_BYTES = 1


def _lists(lens: np.ndarray, objects: np.ndarray) -> int:
    return INTERVAL_BYTES * int(np.asarray(lens, np.int64)[objects].sum())


def _rows(n_rows: int) -> int:
    return int(n_rows) * (2 * ROW_ID_BYTES + VERDICT_BYTES)


def b1_bytes(n_rows: int, r_objects, s_objects, r_lens: dict,
             s_lens: dict) -> int:
    """Bytes of one APRIL trichotomy (B1, ``april_trichotomy_kernel``) over
    ``n_rows`` frame rows naming the R objects ``r_objects`` and the S
    objects ``s_objects`` (each once): the A and F lists of both sides.
    ``r_lens`` and ``s_lens`` map ``"A"`` and ``"F"`` to per-object
    interval counts."""
    return (_lists(r_lens["A"], r_objects) + _lists(r_lens["F"], r_objects)
            + _lists(s_lens["A"], s_objects) + _lists(s_lens["F"], s_objects)
            + _rows(n_rows))


def b4_bytes(n_rows: int, r_objects, s_objects, r_lens: dict,
             s_lens: dict) -> int:
    """Bytes of one AA interval-overlap join (B4,
    ``interval_overlap_kernel``), the ``within`` lane's: the A lists of
    both sides."""
    return (_lists(r_lens["A"], r_objects) + _lists(s_lens["A"], s_objects)
            + _rows(n_rows))


def c_bytes(n_rows: int, r_objects, s_objects, r_lens: dict,
            s_lens: dict) -> int:
    """Bytes of APRIL-C's chain joins (``linestring``: B4 twice over the
    frame, C x A(s) and C x F(s)): each named chain's unit-cell list
    (``r_lens["C"]``) once, and the A and F lists of the S side once
    each."""
    return (_lists(r_lens["C"], r_objects) + _lists(s_lens["A"], s_objects)
            + _lists(s_lens["F"], s_objects) + _rows(n_rows))


def share_pct(nbytes: int, seconds: float) -> float:
    """The byte bound's time as a percentage of ``seconds`` measured."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
