"""Run one cell of the port's join benchmark once.

    python3 joinbench/run.py --workload t1xt2-intersects --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout holding ``BENCHMARK.json``, ``joinbench/`` and
the port (``src/repro_torch``), on a machine with a CUDA card. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last); the compared numbers beside their limits are also the
last lines of standard error. Without a card, with fewer cards than the
cell asks for, or with JAX or the JAX package loaded, it prints no result
and exits with a code other than 0.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel cache of the run at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from joinbench import harness

    spec = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    print(f"host seconds by phase: {out['phases']}", file=sys.stderr)
    for line in harness.check_lines(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
