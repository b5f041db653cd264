"""Render the dry-run and roofline tables from dry-run JSONs (the
reference's ``launch/report.py``; the same output from the same cells).

    PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun
"""
from __future__ import annotations

import json
import os
import sys

from .mesh import PRODUCTION_SHAPES


def load(dir_: str) -> list[dict]:
    out = []
    for fn in sorted(os.listdir(dir_)):
        if fn.endswith(".json"):
            with open(os.path.join(dir_, fn)) as f:
                out.append(json.load(f))
    return out


def fmt_t(x: float) -> str:
    return f"{x * 1e3:.2f}ms" if x < 10 else f"{x:.2f}s"


def mesh_label(shape) -> str:
    return "x".join(str(v) for v in shape)


def roofline_table(cells: list[dict], mesh: str = "16x16") -> str:
    rows = ["| arch | shape | t_comp | t_mem | t_coll | bottleneck | "
            "MODEL/HLO | roofline frac | mem/chip |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("mesh") != mesh:
            continue
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skipped: {c['skipped'][:40]}… | — | — | — |")
            continue
        rows.append(
            f"| {c['arch']} | {c['shape']} | {fmt_t(c['t_compute'])} | "
            f"{fmt_t(c['t_memory'])} | {fmt_t(c['t_collective'])} | "
            f"{c['bottleneck']} | {c['useful_flops_ratio']:.2f} | "
            f"{c['roofline_fraction']:.3f} | "
            f"{c['memory_per_chip_bytes'] / 2**30:.1f}GiB |")
    return "\n".join(rows)


def dryrun_table(cells: list[dict]) -> str:
    rows = ["| arch | shape | mesh | compile | FLOPs/chip | bytes/chip | "
            "coll bytes/chip | collectives |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if "skipped" in c:
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                        f"skip | — | — | — | {c['skipped'][:45]} |")
            continue
        coll = ",".join(f"{k.split('-')[-1][:4]}:{v / 2**20:.0f}M"
                        for k, v in sorted(c.get("coll_breakdown", {}).items()))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{c.get('compile_seconds', 0):.0f}s | "
            f"{c['flops_per_chip']:.2e} | {c['bytes_per_chip']:.2e} | "
            f"{c['coll_bytes_per_chip']:.2e} | {coll} |")
    return "\n".join(rows)


def main():
    d = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    cells = load(d)
    single = mesh_label(PRODUCTION_SHAPES[False][0])
    multi = mesh_label(PRODUCTION_SHAPES[True][0])
    print("## Dry-run (all cells)\n")
    print(dryrun_table(cells))
    print(f"\n## Roofline — single pod ({single})\n")
    print(roofline_table(cells, single))
    print(f"\n## Roofline — multi-pod ({multi})\n")
    print(roofline_table(cells, multi))


if __name__ == "__main__":
    main()
