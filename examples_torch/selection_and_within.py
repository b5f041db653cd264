"""Beyond intersection joins (§4.3) with the `JoinPlan` session API:
polygonal selection queries, within joins, and polygon x linestring joins,
for any registered intermediate filter, with approximations built once and
reused across predicates, on the card or on the CPU.

    PYTHONPATH=src python examples_torch/selection_and_within.py
    PYTHONPATH=src python examples_torch/selection_and_within.py --device cpu
"""
import argparse

from repro_torch.datagen import make_dataset, make_linestrings
from repro_torch.spatial import JoinPlan, selection_queries


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the joins run: cuda (default) or cpu")
    ap.add_argument("--count", type=int, default=400,
                    help="landmarks (T1) and water bodies (T2)")
    ap.add_argument("--roads", type=int, default=300,
                    help="linestrings (T8)")
    ap.add_argument("--counties", type=int, default=10, help="T3 polygons")
    ap.add_argument("--n-order", type=int, default=9)
    args = ap.parse_args(argv)
    dev, n_order = args.device, args.n_order
    out = {}

    data = make_dataset("T1", count=args.count)
    counties = make_dataset("T3", count=args.counties)

    # selection via the grouping wrapper (returns one array per query)
    results, st = selection_queries(data, counties, method="april",
                                    n_order=n_order, device=dev)
    out["selection"] = results
    print("selection:", st.row())
    print(f"  e.g. query 0 returned {len(results[0])} landmark polygons")

    small = make_dataset("T2", count=args.count)
    plan = JoinPlan(small, counties, filter="ri", n_order=n_order,
                    device=dev)
    plan.build()
    out["within"], st = plan.execute("within")
    print("within:   ", st.row())
    # the same built approximations serve another predicate for free
    out["intersects"], st = plan.execute("intersects")
    print("intersect:", st.row())

    roads = make_linestrings(count=args.roads)
    lplan = JoinPlan(roads, counties, filter="april", n_order=n_order,
                     r_kind="line", device=dev)
    out["linestring"], st = lplan.build().execute("linestring")
    print("linestring:", st.row())
    return out


if __name__ == "__main__":
    main()
