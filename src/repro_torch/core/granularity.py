"""Mixed-granularity APRIL joins (paper §5.3).

A layer of large polygons may be approximated at a lower Hilbert order
L < N, which cuts its interval counts. Joining an order-N list with an
order-L list scales the finer list down (paper Eq. 1):

    a' = [a_start >> 2(N-L),  ((a_end - 1) >> 2(N-L)) + 1)      (half-open)

Scaling is sound for A-lists only (a Full interval at order N need not be
Full at order L), so the filter runs two joins: the scaled AA join, and
the join of the scaled A list with the coarse side's F list. Host numpy.
"""
from __future__ import annotations

import numpy as np

from .join import INDECISIVE, TRUE_HIT, TRUE_NEG, interval_join_pair

__all__ = ["scale_intervals", "mixed_order_verdict_pair"]


def scale_intervals(ints: np.ndarray, n_from: int, n_to: int) -> np.ndarray:
    """Half-open uint64 intervals scaled from order ``n_from`` down to
    ``n_to`` (Eq. 1), the ones that now touch or overlap merged."""
    if n_from < n_to:
        raise ValueError(f"scale_intervals scales down only: order "
                         f"{n_from} -> {n_to}")
    if n_from == n_to or len(ints) == 0:
        return np.asarray(ints, np.uint64)
    sh = np.uint64(2 * (n_from - n_to))
    one = np.uint64(1)
    starts = ints[:, 0] >> sh
    ends = ((ints[:, 1] - one) >> sh) + one
    merged_s = [starts[0]]
    merged_e = [ends[0]]
    for s, e in zip(starts[1:], ends[1:]):
        if s <= merged_e[-1]:
            merged_e[-1] = max(merged_e[-1], e)
        else:
            merged_s.append(s)
            merged_e.append(e)
    return np.stack([np.asarray(merged_s, np.uint64),
                     np.asarray(merged_e, np.uint64)], axis=1)


def mixed_order_verdict_pair(
    a_fine: np.ndarray, f_fine: np.ndarray, n_fine: int,
    a_coarse: np.ndarray, f_coarse: np.ndarray, n_coarse: int,
) -> int:
    """The APRIL verdict of a pair across orders: the fine side's A list
    scaled down; only the coarse side's F list takes part (§5.3).
    ``f_fine`` is unused, as in the paper."""
    a_scaled = scale_intervals(a_fine, n_fine, n_coarse)
    if not interval_join_pair(a_scaled, a_coarse):
        return TRUE_NEG
    if interval_join_pair(a_scaled, f_coarse):
        return TRUE_HIT
    return INDECISIVE
