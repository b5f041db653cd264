"""APRIL-C: delta + Variable-Byte compression of interval lists (§5.1).

An interval list is a strictly-increasing flat integer sequence
``s0, e0, s1, e1, ...`` (disjoint sorted intervals), so gaps are positive
and delta + VByte compresses well. The decoder supports *streaming*
consumption: :class:`DecompressingCursor` yields one value at a time, so a
merge join can stop after the first overlap without decompressing the rest
(join-while-decompress).

The batched filter decodes on the host, in bounds: the objects of a batch
stage, in one vectorized :func:`vbyte_decode_many` pass, into CSR lists
that the interval-join kernels take.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .join import INDECISIVE, TRUE_HIT, TRUE_NEG

__all__ = [
    "vbyte_encode", "vbyte_decode", "vbyte_decode_many",
    "compress_intervals",
    "decompress_intervals", "DecompressingCursor", "interval_join_compressed",
    "april_verdict_compressed", "CompressedAprilStore", "compress_april",
]


def vbyte_encode(values: np.ndarray) -> bytes:
    """Delta + VByte encode a strictly increasing uint64 sequence."""
    v = np.asarray(values, np.uint64)
    if len(v) == 0:
        return b""
    deltas = np.empty_like(v)
    deltas[0] = v[0]
    deltas[1:] = v[1:] - v[:-1]
    out = bytearray()
    for d in deltas.tolist():
        while True:
            b = d & 0x7F
            d >>= 7
            if d:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def vbyte_decode(buf: bytes, count: int) -> np.ndarray:
    """Inverse of :func:`vbyte_encode`."""
    out = np.empty(count, np.uint64)
    acc = 0
    pos = 0
    for i in range(count):
        val = 0
        shift = 0
        while True:
            b = buf[pos]; pos += 1
            val |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        acc += val
        out[i] = acc
    return out


def vbyte_decode_many(bufs: list[tuple[bytes, int]]
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Decode many delta+VByte buffers in one vectorized pass.

    ``bufs`` is a list of (buffer, count) pairs (the
    :class:`CompressedAprilStore` per-object entries). Returns
    (values [sum_counts] uint64, offsets [len(bufs)+1] int64). The decode is
    flat numpy end to end — continuation-bit grouping, 7-bit shifts, one
    ``add.reduceat`` per varint, and a segmented prefix sum to undo the
    deltas — so decoding B objects costs O(total bytes), not B Python loops
    (the bound the batched APRIL-C path relies on).
    """
    counts = np.fromiter((c for _, c in bufs), np.int64, len(bufs))
    off = np.zeros(len(bufs) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    total = int(off[-1])
    if total == 0:
        return np.zeros(0, np.uint64), off
    raw = np.frombuffer(b"".join(b for b, _ in bufs), np.uint8)
    payload = (raw & 0x7F).astype(np.uint64)
    cont = raw >= 0x80
    # byte-group boundaries: a varint ends at every byte with a clear
    # continuation bit (varints never span buffers — each buffer is whole)
    ends = np.nonzero(~cont)[0]
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    shift = (np.arange(len(raw), dtype=np.uint64)
             - np.repeat(starts, ends - starts + 1).astype(np.uint64))
    deltas = np.add.reduceat(payload << (np.uint64(7) * shift), starts)
    # segmented prefix sum: absolute values restart at each buffer boundary
    cs = np.cumsum(deltas)
    seg0 = cs[off[:-1].clip(0, total - 1)] - deltas[off[:-1].clip(0, total - 1)]
    return cs - np.repeat(seg0, counts), off


def compress_intervals(ints: np.ndarray) -> tuple[bytes, int]:
    """Compress an [I,2] interval list; returns (buffer, count=2I)."""
    flat = np.asarray(ints, np.uint64).reshape(-1)
    return vbyte_encode(flat), len(flat)


def decompress_intervals(buf: bytes, count: int) -> np.ndarray:
    return vbyte_decode(buf, count).reshape(-1, 2)


class DecompressingCursor:
    """Streams intervals out of a compressed buffer one at a time."""

    def __init__(self, buf: bytes, count: int):
        self.buf = buf
        self.count = count          # number of flat values (2 * intervals)
        self.pos = 0
        self.emitted = 0
        self.acc = 0

    def _next_value(self) -> int:
        val = 0
        shift = 0
        while True:
            b = self.buf[self.pos]; self.pos += 1
            val |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        self.acc += val
        self.emitted += 1
        return self.acc

    def next_interval(self):
        """Next (start, end) or None when exhausted."""
        if self.emitted >= self.count:
            return None
        return self._next_value(), self._next_value()


def interval_join_compressed(bx: tuple[bytes, int], by: tuple[bytes, int]) -> bool:
    """Merge join directly over two compressed lists; decompresses only as far
    as needed to find the first overlap (§5.1)."""
    cx = DecompressingCursor(*bx)
    cy = DecompressingCursor(*by)
    x = cx.next_interval()
    y = cy.next_interval()
    while x is not None and y is not None:
        if x[0] < y[1] and y[0] < x[1]:
            return True
        if x[1] <= y[1]:
            x = cx.next_interval()
        else:
            y = cy.next_interval()
    return False


def april_verdict_compressed(ar, fr, as_, fs) -> int:
    """APRIL filter over compressed (buf, count) lists — APRIL-C."""
    if not interval_join_compressed(ar, as_):
        return TRUE_NEG
    if interval_join_compressed(ar, fs):
        return TRUE_HIT
    if interval_join_compressed(fr, as_):
        return TRUE_HIT
    return INDECISIVE


@dataclass
class CompressedAprilStore:
    """APRIL-C approximations for one dataset: per-object VByte buffers.

    The streaming per-pair join (:func:`april_verdict_compressed`) consumes
    the buffers directly; the batched path decodes the objects of a
    candidate batch on the host first (:meth:`decompress_lists`).
    """
    n_order: int
    extent: object
    a_bufs: list          # per object: (bytes, count)
    f_bufs: list

    def __len__(self) -> int:
        return len(self.a_bufs)

    def a_list(self, i: int) -> np.ndarray:
        return decompress_intervals(*self.a_bufs[i])

    def f_list(self, i: int) -> np.ndarray:
        return decompress_intervals(*self.f_bufs[i])

    def size_bytes(self) -> int:
        return (sum(len(b) for b, _ in self.a_bufs)
                + sum(len(b) for b, _ in self.f_bufs))

    def decompress_lists(self, idx: np.ndarray, kind: str = "A"
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Decode one list kind of objects ``idx`` into CSR form
        (offsets [B+1] int64, intervals [T, 2] uint64), rows renumbered
        0..B-1 — one vectorized :func:`vbyte_decode_many` pass. This is the
        batched path's *bounded* decode: the APRIL-C filter calls it for
        exactly the objects a batch stage touches (A lists for the batch,
        F lists for the AA survivors only)."""
        bufs = self.a_bufs if kind == "A" else self.f_bufs
        idx = np.asarray(idx, np.int64)
        vals, voff = vbyte_decode_many([bufs[int(i)] for i in idx])
        return voff // 2, vals.reshape(-1, 2)


def compress_april(store) -> CompressedAprilStore:
    """Compress an AprilStore into per-object VByte buffers (§5.1)."""
    a_bufs = [compress_intervals(store.a_list(i)) for i in range(len(store))]
    f_bufs = [compress_intervals(store.f_list(i)) for i in range(len(store))]
    return CompressedAprilStore(n_order=store.n_order, extent=store.extent,
                                a_bufs=a_bufs, f_bufs=f_bufs)
