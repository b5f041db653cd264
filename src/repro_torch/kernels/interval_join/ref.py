"""Plain PyTorch versions of the interval-join kernels.

Lists are CSR: ``off`` [P+1] int64 row offsets into flat ``starts`` and
``lasts`` [T] int32 endpoints (biased, inclusive last), each row sorted and
disjoint. Pair row ``n`` joins list ``xi[n]`` of X with list ``yi[n]`` of Y.
The overlap is one flat row-keyed ``searchsorted`` pass: per x interval,
the first y interval of the same row whose last is >= the x start decides
(no padding, no per-row loop). Runs on any device; the CPU tests and the
on-card comparison in ``chip_smoke.py`` use it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CSRLists", "interval_overlap_plain", "april_trichotomy_plain",
           "TRUE_NEG", "TRUE_HIT", "INDECISIVE"]

TRUE_NEG, TRUE_HIT, INDECISIVE = 0, 1, 2

_KEY_SHIFT = 33
_KEY_BIAS = 1 << 31


class CSRLists(NamedTuple):
    """One dataset side's interval lists as tensors on one device."""
    off: torch.Tensor      # [P+1] int64
    starts: torch.Tensor   # [T] int32, biased
    lasts: torch.Tensor    # [T] int32, biased, inclusive


def _flat_rows(L: CSRLists, idx: torch.Tensor):
    """Expand rows ``idx`` of ``L`` into flat (row-of-entry [T],
    global-interval [T], counts [B])."""
    lo = L.off[idx]
    cnt = L.off[idx + 1] - lo
    b_of = torch.repeat_interleave(
        torch.arange(idx.numel(), device=idx.device), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(b_of.numel(), device=idx.device) - start[b_of]
    return b_of, lo[b_of] + pos, cnt


def _rowkey(b_of: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Row index in the high bits, the unbiased endpoint in the low 32."""
    return (b_of << _KEY_SHIFT) + (vals.to(torch.int64) + _KEY_BIAS)


def interval_overlap_plain(x: CSRLists, y: CSRLists, xi: torch.Tensor,
                           yi: torch.Tensor) -> torch.Tensor:
    """[N] bool: does list ``xi[n]`` of X overlap list ``yi[n]`` of Y?"""
    n = xi.numel()
    out = torch.zeros(n, dtype=torch.bool, device=xi.device)
    if n == 0:
        return out
    bx, gx, _ = _flat_rows(x, xi)
    by, gy, cy = _flat_rows(y, yi)
    if bx.numel() == 0 or by.numel() == 0:
        return out
    ykeys = _rowkey(by, y.lasts[gy])
    yend = torch.cumsum(cy, 0)
    j = torch.searchsorted(ykeys, _rowkey(bx, x.starts[gx]))
    ok = j < yend[bx]
    jj = torch.clamp(j, max=gy.numel() - 1)
    hit = ok & (y.starts[gy[jj]] <= x.lasts[gx])
    out[bx[hit]] = True
    return out


def april_trichotomy_plain(xa: CSRLists, xf: CSRLists, ya: CSRLists,
                           yf: CSRLists, ri: torch.Tensor,
                           si: torch.Tensor) -> torch.Tensor:
    """[N] int8 APRIL verdicts: AA empty -> TRUE_NEG, else AF or FA hit ->
    TRUE_HIT, else INDECISIVE."""
    aa = interval_overlap_plain(xa, ya, ri, si)
    af = interval_overlap_plain(xa, yf, ri, si)
    fa = interval_overlap_plain(xf, ya, ri, si)
    hit = torch.where(af | fa, TRUE_HIT, INDECISIVE)
    return torch.where(aa, hit, TRUE_NEG).to(torch.int8)
