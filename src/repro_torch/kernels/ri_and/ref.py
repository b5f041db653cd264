"""Plain PyTorch versions of the RI filter's ALIGNEDAND kernel.

An RI store side is :class:`RIStoreTensors`: CSR interval lists (``off``
[P+1] int64 row offsets into ``starts`` and inclusive ``lasts``, biased
int32 as APRIL's device lists hold them, so Hilbert ids up to order 16 fit;
every difference is taken after unbiasing into int64), the bit
offset of every interval's code run (``bit_off`` [I+1] int64), and the
whole 3-bit cell-code stream packed LSB-first into uint32 ``words`` (stream
bit ``t`` is bit ``t % 32`` of word ``t // 32``), with one zero pad word at
the end so that reading word ``i + 1`` of the last word stays in bounds.

:func:`aligned_and_plain` is ALIGNEDAND (paper §3.3) over fragments of two
word streams: align each stream at its bit offset (a funnel shift of
words ``i`` and ``i + 1``), XOR Y with the period-3-word re-encoding mask
when asked, keep the first ``n_bits`` bits and test ``x & y`` for any set
bit. :func:`ri_trichotomy_plain` is the whole RI filter (Algorithm 1) over
pair rows: the overlapping interval pairs ("fragments") of each row come
from one flat row-keyed ``torch.searchsorted`` pass, their code runs go
through :func:`aligned_and_plain` in power-of-two word-count buckets, and
a scatter-any gives each row its verdict. Runs on any device; the CPU
tests and the on-card comparison in ``chip_smoke.py`` use it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..interval_join.ref import _flat_rows

__all__ = ["RIStoreTensors", "pack_bits_u32", "xor_mask_words",
           "pack_stream_words", "aligned_and_plain", "ri_fragments_plain",
           "ri_trichotomy_plain", "TRUE_NEG", "TRUE_HIT", "INDECISIVE"]

TRUE_NEG, TRUE_HIT, INDECISIVE = 0, 1, 2

#: the re-encoding mask (1, 1, 0) repeated from phase 0, one period of
#: lcm(3, 32) = 96 bits as three uint32 words
MASK_WORDS = (0xDB6DB6DB, 0xB6DB6DB6, 0x6DB6DB6D)

_KEY_SHIFT = 33
_KEY_BIAS = 1 << 31
_U32 = 0xFFFFFFFF
#: bound on the [fragments, words] working set of one bucket chunk
_CHUNK_ELEMS = 1 << 22


class RIStoreTensors(NamedTuple):
    """One RI store side as tensors on one device."""
    off: torch.Tensor      # [P+1] int64
    starts: torch.Tensor   # [I] int32, biased interval starts
    lasts: torch.Tensor    # [I] int32, biased inclusive interval lasts
    bit_off: torch.Tensor  # [I+1] int64
    words: torch.Tensor    # [ceil(bits/32) + 1] uint32, last word zero


def pack_bits_u32(bits: np.ndarray, W: int) -> np.ndarray:
    """[n] 0/1 -> [W] uint32 words, LSB-first within each word."""
    out = np.zeros(W, np.uint32)
    n = min(len(bits), 32 * W)
    idx = np.arange(n)
    np.add.at(out, idx // 32,
              (bits[:n].astype(np.uint32) << (idx % 32).astype(np.uint32)))
    return out


def xor_mask_words(W: int, pattern=(1, 1, 0)) -> np.ndarray:
    """Repeating 3-bit XOR mask (phase 0) packed into W uint32 words."""
    bits = np.tile(np.asarray(pattern, np.uint8), (32 * W + 2) // 3)[: 32 * W]
    return pack_bits_u32(bits, W)


def pack_stream_words(bits: np.ndarray) -> np.ndarray:
    """A whole 0/1 bit stream as uint32 words, LSB-first, plus one zero pad
    word: equal to ``pack_bits_u32(bits, ceil(len/32) + 1)``."""
    nw = (len(bits) + 31) // 32 + 1
    raw = np.packbits(np.asarray(bits, np.uint8), bitorder="little")
    buf = np.zeros(4 * nw, np.uint8)
    buf[: len(raw)] = raw
    return buf.view("<u4").astype(np.uint32)


def _unbiased(ids: torch.Tensor) -> torch.Tensor:
    """Biased int32 Hilbert ids as their int64 values in [0, 2^32)."""
    return ids.to(torch.int64) + _KEY_BIAS


def _aligned_words(w64: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """The 32 stream bits starting at ``bit`` (any shape) as int64 in
    [0, 2^32): the funnel shift of words ``bit // 32`` and ``bit // 32 + 1``
    of the int64 copy ``w64`` of a word stream."""
    i = bit >> 5
    sh = bit & 31
    lo = w64[i]
    hi = w64[i + 1]
    # hi's low ``sh`` bits move to the top; nothing is shifted past bit 31
    return (lo >> sh) | ((hi & ((1 << sh) - 1)) << (32 - sh))


def _words64(words: torch.Tensor) -> torch.Tensor:
    """A uint32 word stream as int64 values in [0, 2^32)."""
    return words.view(torch.int32).to(torch.int64) & _U32


def aligned_and_plain(x_words: torch.Tensor, x_bit: torch.Tensor,
                      y_words: torch.Tensor, y_bit: torch.Tensor,
                      n_bits: torch.Tensor, xor_y) -> torch.Tensor:
    """[F] bool ALIGNEDAND of F fragments: does the ``n_bits[f]``-bit run of
    X at stream bit ``x_bit[f]`` AND the run of Y at ``y_bit[f]`` (XORed
    with the re-encoding mask, phase 0 at the run's start, where
    ``xor_y[f]``) have a bit set? ``x_words``/``y_words`` are uint32
    streams whose last word is a zero pad word; ``xor_y`` is a bool or a
    [F] bool tensor. Every fragment is padded to the widest one's words."""
    F = x_bit.numel()
    dev = x_bit.device
    if F == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    L = int((int(n_bits.max()) + 31) // 32)
    if L == 0:
        return torch.zeros(F, dtype=torch.bool, device=dev)
    k = torch.arange(L, device=dev)
    nw = (n_bits + 31) // 32
    live = k[None, :] < nw[:, None]
    # dead slots read the run's first word, which is always in range
    off = torch.where(live, 32 * k[None, :], 0)
    x = _aligned_words(_words64(x_words), x_bit[:, None] + off)
    y = _aligned_words(_words64(y_words), y_bit[:, None] + off)
    mask = torch.tensor(MASK_WORDS, dtype=torch.int64, device=dev)[k % 3]
    xor = torch.as_tensor(xor_y, dtype=torch.bool, device=dev)
    y = torch.where(xor.reshape(-1, 1), y ^ mask[None, :], y)
    rem = torch.clamp(n_bits[:, None] - 32 * k[None, :], 0, 32)
    keep = (torch.ones_like(rem) << rem) - 1
    return ((x & y & keep) != 0).any(dim=1)


def ri_fragments_plain(x: RIStoreTensors, y: RIStoreTensors,
                       ri: torch.Tensor, si: torch.Tensor):
    """Every overlapping interval pair of the pair rows (ri[n], si[n]):
    (row [F], global x interval [F], global y interval [F], shared run
    start [F], end [F]), in row order and, within a row, in the order the
    two-pointer merge meets them. Per x interval the overlapping y
    intervals are a contiguous run of its row's sorted disjoint list,
    found with two row-keyed searches."""
    dev = ri.device
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    bx, gx, _ = _flat_rows(x, ri)
    by, gy, cy = _flat_rows(y, si)
    ystart = torch.cumsum(cy, 0) - cy
    if bx.numel() == 0 or by.numel() == 0:
        return (empty,) * 5
    # row index in the high bits, the unbiased id (< 2^32) in the low 33
    ykey = by << _KEY_SHIFT
    ys_keys = ykey + _unbiased(y.starts[gy])
    yl_keys = ykey + _unbiased(y.lasts[gy])
    xkey = bx << _KEY_SHIFT
    xs = _unbiased(x.starts[gx])
    xl = _unbiased(x.lasts[gx])
    seg0 = ystart[bx]
    # first y with last >= x start; one past the last y with start <= x last
    lo_idx = torch.searchsorted(yl_keys, xkey + xs) - seg0
    hi_idx = torch.searchsorted(ys_keys, xkey + xl, right=True) - seg0
    n_frag = torch.clamp(hi_idx - lo_idx, min=0)
    rep = torch.repeat_interleave(
        torch.arange(n_frag.numel(), device=dev), n_frag)
    if rep.numel() == 0:
        return (empty,) * 5
    k = torch.arange(rep.numel(), device=dev) \
        - (torch.cumsum(n_frag, 0) - n_frag)[rep]
    b = bx[rep]
    gxf = gx[rep]
    gyf = y.off[si[b]] + lo_idx[rep] + k
    lo = torch.maximum(_unbiased(x.starts[gxf]), _unbiased(y.starts[gyf]))
    hi = torch.minimum(_unbiased(x.lasts[gxf]), _unbiased(y.lasts[gyf])) + 1
    return b, gxf, gyf, lo, hi


def _word_buckets(nw: torch.Tensor):
    """Index chunks of fragments grouped by power-of-two word-count class,
    each chunk's padded [rows, words] bounded by ``_CHUNK_ELEMS``."""
    cls = torch.ceil(torch.log2(nw.clamp(min=1).to(torch.float64)))
    for c in torch.unique(cls).tolist():
        sel = torch.nonzero(cls == c).flatten()
        rows = max(1, _CHUNK_ELEMS // (1 << int(c)))
        for r0 in range(0, sel.numel(), rows):
            yield sel[r0: r0 + rows]


def ri_trichotomy_plain(x: RIStoreTensors, y: RIStoreTensors,
                        ri: torch.Tensor, si: torch.Tensor,
                        xor_y: bool) -> torch.Tensor:
    """[N] int8 RI verdicts of pair rows (ri[n], si[n]): TRUE_HIT if some
    shared cell run ANDs non-zero, INDECISIVE if interval ranges overlap
    without a code hit, TRUE_NEG otherwise."""
    n = ri.numel()
    dev = ri.device
    b, gx, gy, lo, hi = ri_fragments_plain(x, y, ri, si)
    ovl = torch.zeros(n, dtype=torch.bool, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    ovl[b] = True
    n_bits = 3 * (hi - lo)
    x_bit = x.bit_off[gx] + 3 * (lo - _unbiased(x.starts[gx]))
    y_bit = y.bit_off[gy] + 3 * (lo - _unbiased(y.starts[gy]))
    for sel in _word_buckets((n_bits + 31) // 32):
        got = aligned_and_plain(x.words, x_bit[sel], y.words, y_bit[sel],
                                n_bits[sel], xor_y)
        hit[b[sel[got]]] = True
    out = torch.where(ovl, INDECISIVE, TRUE_NEG)
    return torch.where(hit, TRUE_HIT, out).to(torch.int8)
