"""Quickstart: build APRIL approximations and run a spatial intersection
join end to end with the `JoinPlan` session API, comparing intermediate
filters, on the card (the hand-written CUDA kernels) or on the CPU (their
plain PyTorch versions).

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse
import hashlib

import numpy as np

from repro_torch.core.april import build_april_polygon
from repro_torch.core.join import (INDECISIVE, TRUE_HIT, TRUE_NEG,
                                   april_verdict_pair)
from repro_torch.datagen import make_dataset
from repro_torch.spatial import JoinPlan, available_filters

METHODS = ("none", "april", "ri")


def _sorted(pairs: np.ndarray) -> np.ndarray:
    """The result pairs in (r, s) order: the filters agree on the set, not
    on the order the refinement returns it in."""
    return pairs[np.lexsort(pairs.T[::-1])]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the joins run: cuda (default) or cpu")
    ap.add_argument("--count-r", type=int, default=300)
    ap.add_argument("--count-s", type=int, default=500)
    ap.add_argument("--n-order", type=int, default=9)
    args = ap.parse_args(argv)

    # --- one pair, by hand -------------------------------------------------
    sq1 = np.array([[0.20, 0.20], [0.60, 0.20], [0.60, 0.60], [0.20, 0.60]])
    sq2 = sq1 + 0.25
    a1, f1 = build_april_polygon(sq1, 4, n_order=8)
    a2, f2 = build_april_polygon(sq2, 4, n_order=8)
    verdict = april_verdict_pair(a1, f1, a2, f2)
    names = {TRUE_NEG: "true negative", TRUE_HIT: "TRUE HIT",
             INDECISIVE: "indecisive"}
    print(f"squares overlap -> APRIL verdict: {names[verdict]}")
    print(f"A-list has {len(a1)} intervals, F-list {len(f1)} "
          f"(8x8..256x256 Hilbert grid)")

    # --- full pipeline on synthetic landmark/water layers ------------------
    print(f"registered intermediate filters: {available_filters()}")
    R = make_dataset("T1", count=args.count_r)
    S = make_dataset("T2", count=args.count_s)
    results = {}
    for method in METHODS:
        plan = JoinPlan(R, S, filter=method, n_order=args.n_order,
                        device=args.device)
        plan.build()                       # preprocessing, reusable
        results[method], stats = plan.execute("intersects")
        print(stats.row())
        digest = hashlib.sha1(_sorted(results[method]).tobytes())
        print(f"{method} pairs: {len(results[method])} "
              f"sha1 {digest.hexdigest()[:16]}")
    first = _sorted(results[METHODS[0]])
    if any(not np.array_equal(_sorted(r), first) for r in results.values()):
        raise AssertionError("the filters returned different join results")
    print("all methods return the SAME join result; the filters just "
          "refine far fewer pairs.")
    return results


if __name__ == "__main__":
    main()
