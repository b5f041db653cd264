"""Roofline terms of a dry-run cell (the reference's
``launch/roofline.py``), on the H100's published rates.

    compute term    = FLOPs_per_rank / peak FLOP/s
    memory term     = bytes_per_rank / HBM bandwidth
    collective term = collective_bytes_per_rank / NVLink bandwidth

The dry run (``launch/dryrun.py``) counts a rank's FLOPs, the bytes its
ops read and write, and the bytes its collectives leave on it, by kind.
Hardware model: one H100 SXM: 989 TFLOP/s bf16 dense (the dry run's
default dtype) or 67 TFLOP/s f32 (no TF32), 3.35 TB/s HBM3, and NVLink 4
at 450 GB/s a direction for the collective term. A 16-wide model axis
spans two 8-card NVLink domains, so on the production mesh some of its
traffic crosses the slower inter-node network and the collective term
is a floor.

``shape_bytes`` and ``collective_bytes`` read the reference's HLO text
(kept so either package's cells parse alike); the port's own cells count
collectives as they run.
"""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import ClassVar

PEAK_FLOPS_F32 = 67e12       # FLOP/s per card, f32 on the CUDA cores
PEAK_FLOPS_BF16 = 989e12     # FLOP/s per card, bf16 dense tensor cores
PEAK_FLOPS = PEAK_FLOPS_BF16  # the dry run's default dtype, as the reference's
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s per card, NVLink 4, one direction

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2fnuz": 1, "f8e4m3b11fnuz": 1,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\][^ ]*))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")


def shape_bytes(text: str) -> int:
    """Total bytes of all tensor shapes appearing in ``text``."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-chip bytes moved by each collective kind (output-shape sized)."""
    out: dict[str, int] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_txt, kind = m.group(1), m.group(2)
        out[kind] = out.get(kind, 0) + shape_bytes(shape_txt)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops_global: float = 0.0
    memory_per_chip_bytes: float = 0.0
    compile_seconds: float = 0.0
    #: the peak of the cell's dtype (not a field: ``to_dict`` keeps the
    #: reference's keys); an f32 cell sets ``PEAK_FLOPS_F32``
    peak_flops: ClassVar[float] = PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs): remat, redundant and
        dispatch work."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (max of the terms)."""
        t_useful = (self.model_flops_global / self.chips) / self.peak_flops
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_step if t_step else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape_name: str, shapes: dict) -> float:
    """MODEL_FLOPS: 6·N·D for training (N = active params), 2·N·D for a
    forward/prefill pass, 2·N per decoded token."""
    seq, batch, mode = shapes[shape_name]
    n_active = cfg.active_param_count()
    if mode == "train":
        return 6.0 * n_active * seq * batch
    if mode == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch     # decode: one token per sequence
