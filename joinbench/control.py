"""The control of the comparison that decides ``correct``.

The plain reference, computed one precision below the float64 that the
configurations state, stands in the program's place: its pairs are
compared with the float64 reference's as a run compares the program's,
at the cell's own size. Two controls, each of which must come out above
the limit of ``mismatched_pairs`` (0) on every seed:

* ``all32``: the whole reference in float32, MBRs and exact test;
* ``exact32``: the MBR candidates in float64, and only the exact test in
  float32, as a program whose filter and refine ran in float32 would.

The benchmark's own runs do not run it.

    python3 joinbench/control.py --workload t1xt2-intersects \
        --seeds 11,12,13 [--geometry 1] [--program 3] [--device cuda]

prints one JSON line a seed. ``--geometry g`` draws other rings: every
layer's data seed moved by ``g``, where the benchmark's runs keep 0.
``--program s`` also runs the program on the same layers for ``s``
seconds, as a run of the cell does, and gives its ``mismatched_pairs``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: control name -> (dtype of the exact test, dtype of the MBRs)
CONTROLS = {"all32": ("float32", "float32"), "exact32": ("float32",
                                                         "float64")}


def geometry(config: dict, g: int) -> dict:
    """``config`` with every layer's data seed moved by ``g``."""
    if g == 0:
        return config
    return {**config, "layers": {
        side: {**spec, "data_seed": spec["data_seed"] + g}
        for side, spec in config["layers"].items()}}


def reading(name_or_spec, seed: int, device="cuda",
            config_overrides: dict | None = None, g: int = 0) -> dict:
    """The controls' ``mismatched_pairs`` on a cell, named or given as a
    spec (``harness.resolve``), at ``seed``, on the rings of geometry
    ``g``."""
    import torch
    from joinbench import datagen, harness, reference

    spec = harness.resolve(name_or_spec)
    name = spec["name"]
    config = geometry({**spec["config_data"], **(config_overrides or {})}, g)
    predicate = spec["traffic_data"]["predicate"]
    (vr, nr), (vs, ns) = datagen.layers(config, seed).values()
    t0 = time.perf_counter()
    want = reference.pair_keys(reference.join(
        vr, nr, vs, ns, predicate, device=device), len(ns))
    out = {"workload": name, "seed": seed, "geometry": g, "pairs": len(want)}
    for ctl, (dt, mbr_dt) in CONTROLS.items():
        got = reference.join(vr, nr, vs, ns, predicate, device=device,
                             dtype=getattr(torch, dt),
                             mbr_dtype=getattr(torch, mbr_dt))
        out[ctl] = harness.mismatch(reference.pair_keys(got, len(ns)), want)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--geometry", type=int, default=0)
    ap.add_argument("--program", type=float, default=0.0,
                    help="seconds of the program's window; 0: not run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from joinbench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        out = reading(args.workload, seed, args.device, g=args.geometry)
        if args.program:
            conf = geometry(harness.cell(args.workload)["config_data"],
                            args.geometry)
            run = harness.run_cell(args.workload, seed, args.program, False,
                                   device=args.device,
                                   config_overrides=conf)
            out["program"] = run["checks"]["mismatched_pairs"]["value"]
            out["program_joins"] = run["attempted"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
