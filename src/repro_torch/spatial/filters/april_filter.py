"""The APRIL intermediate filter (paper §4) and its compressed variant
APRIL-C (§5.1) for the ``intersects``, ``selection``, ``within`` and
``linestring`` predicates.

The batched path runs the staged trichotomies of ``core.join`` over
:class:`~repro_torch.core.join.IntervalLists`, wrapped once per
Approximation (cached in ``meta``) and uploaded to the device once. The
fused chain's status lane is computed on the device by
``core.join.fused_status_rows``. A line side (``kind="line"``, open
chains) is a :class:`LineCellStore`: each chain's sorted Partial cell ids,
joined as unit intervals against A(s) and F(s) (§4.3.3); both filters
build it alike, uncompressed.

APRIL-C stores each object's lists as delta + VByte buffers. Its batched
path decodes in bounds on the host (A lists for the batch's objects, F
lists only for the AA survivors of each stage) and joins the decoded lists
through the same overlap and containment backends (the interval-overlap
kernel with ``cuda``); its fused status lane is those verdicts, uploaded
once.
"""
from __future__ import annotations

import numpy as np

from ...core import compress, join
from ...core.april import LineCellStore, build_april, build_line_cells
from ...core.rasterize import Extent, GLOBAL_EXTENT
from ...device import check_backend_device, resolve_device
from .base import (Approximation, IntermediateFilter, check_predicate,
                   register_filter)

__all__ = ["LineCellStore", "build_line_cells", "AprilFilter",
           "AprilCompressedFilter"]

_DEFAULT_ORDER = ("AA", "AF", "FA")


@register_filter("april")
class AprilFilter(IntermediateFilter):

    supports_mesh = True

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", method: str = "batched",
              build_backend: str = "numpy", device=None,
              **opts) -> Approximation:
        self._check_kind(kind)
        self._check_build_backend(build_backend)
        if opts:
            raise TypeError(f"unexpected build options {sorted(opts)}")
        if kind == "line":
            store = build_line_cells(dataset, n_order, extent,
                                     backend=build_backend, device=device)
        else:
            store = build_april(dataset, n_order, extent, method,
                                backend=build_backend, device=device)
        return Approximation(filter=self.name, store=store, n_order=n_order,
                             extent=extent, kind=kind,
                             meta={"build_opts": {"method": method}})

    # -- incremental maintenance: row splices of the CSR interval lists ----
    def _store_append(self, approx, one) -> None:
        store, o = approx.store, one.store
        cache = approx.meta.get("interval_lists", {})
        if isinstance(store, LineCellStore):
            store.off, store.ids = join.csr_append_row(store.off, store.ids,
                                                       o.ids)
            if "line" in cache:
                row = join.IntervalLists.from_unit_cells(o.off, o.ids)
                cache["line"].append_row(row.starts, row.lasts)
            return
        store.a_off, store.a_ints = join.csr_append_row(
            store.a_off, store.a_ints, o.a_ints)
        store.f_off, store.f_ints = join.csr_append_row(
            store.f_off, store.f_ints, o.f_ints)
        # the cached lists are spliced in place, not rebuilt: the biased
        # int32 conversion is elementwise, so a patched list equals one
        # wrapped afresh from the patched store; the splice drops the
        # list's device copies and row keys, uploaded again on next use
        for kind, off, ints in (("A", o.a_off, o.a_ints),
                                ("F", o.f_off, o.f_ints)):
            if kind in cache:
                row = join.IntervalLists.from_intervals(off, ints)
                cache[kind].append_row(row.starts, row.lasts)

    def _store_delete(self, approx, idx: int) -> None:
        store = approx.store
        cache = approx.meta.get("interval_lists", {})
        if isinstance(store, LineCellStore):
            store.off, store.ids = join.csr_delete_row(store.off, store.ids,
                                                       idx)
            kinds = ("line",)
        else:
            store.a_off, store.a_ints = join.csr_delete_row(
                store.a_off, store.a_ints, idx)
            store.f_off, store.f_ints = join.csr_delete_row(
                store.f_off, store.f_ints, idx)
            kinds = ("A", "F")
        for kind in kinds:
            if kind in cache:
                cache[kind].delete_row(idx)

    @staticmethod
    def _lists(approx, kind: str) -> join.IntervalLists:
        """The device-ready lists of one kind: ``"A"``, ``"F"``, or
        ``"line"`` (a line store's cells as unit intervals)."""
        cache = approx.meta.setdefault("interval_lists", {})
        if kind not in cache:
            store = approx.store
            if kind == "line":
                cache[kind] = join.IntervalLists.from_unit_cells(store.off,
                                                                 store.ids)
            else:
                off = store.a_off if kind == "A" else store.f_off
                ints = store.a_ints if kind == "A" else store.f_ints
                cache[kind] = join.IntervalLists.from_intervals(off, ints)
        return cache[kind]

    def verdicts(self, approx_r, approx_s, pairs, *,
                 predicate: str = "intersects", backend: str = "numpy",
                 device=None, order: tuple[str, ...] = _DEFAULT_ORDER,
                 **opts) -> np.ndarray:
        check_predicate(predicate)
        join.check_filter_backend(backend)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        if backend == "sequential":
            return self.verdicts_seq(approx_r, approx_s, pairs,
                                     predicate=predicate, order=order)
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        if predicate == "linestring":
            return join.linestring_trichotomy_rows(
                self._lists(approx_r, "line"), self._lists(approx_s, "A"),
                self._lists(approx_s, "F"), pairs[:, 0], pairs[:, 1],
                backend=backend, device=device)
        if predicate == "within":
            return join.within_trichotomy_rows(
                self._lists(approx_r, "A"), self._lists(approx_s, "A"),
                self._lists(approx_s, "F"), pairs[:, 0], pairs[:, 1],
                backend=backend, device=device)
        return join.april_trichotomy_rows(
            self._lists(approx_r, "A"), self._lists(approx_r, "F"),
            self._lists(approx_s, "A"), self._lists(approx_s, "F"),
            pairs[:, 0], pairs[:, 1], backend=backend, order=order,
            device=device)

    def to_device(self, approx_r, approx_s, device) -> None:
        for approx in (approx_r, approx_s):
            for kind in (("line",) if approx.kind == "line" else ("A", "F")):
                self._lists(approx, kind).to(device)
        # the within lane's containment searches F(s) by its row keys
        self._lists(approx_s, "F").last_keys(device)

    def status_lane(self, approx_r, approx_s, ri, si, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None,
                    order: tuple[str, ...] = _DEFAULT_ORDER, **opts):
        """The trichotomy of every frame row on the device, through
        ``join.fused_status_rows`` (over ``rows``, the frame's device copies,
        when given). The sequential backend, and for ``intersects`` and
        ``selection`` a join order other than the full three-join set
        (which leaves AA survivors INDECISIVE), keep the uploaded host
        lane, so fused == staged row for row. ``within`` and
        ``linestring`` ignore ``order``, as their staged verdicts do."""
        check_predicate(predicate)
        join.check_filter_backend(backend)
        if backend == "sequential" or (
                predicate in ("intersects", "selection")
                and set(order) != set(_DEFAULT_ORDER)):
            return super().status_lane(approx_r, approx_s, ri, si,
                                       predicate=predicate, backend=backend,
                                       device=device, order=order, **opts)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        if predicate == "linestring":
            xa, xf = self._lists(approx_r, "line"), None
        else:
            xa, xf = self._lists(approx_r, "A"), self._lists(approx_r, "F")
        return join.fused_status_rows(
            xa, xf, self._lists(approx_s, "A"), self._lists(approx_s, "F"),
            ri, si, predicate=predicate, rows=rows, backend=backend,
            device=device)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate,
                     order: tuple[str, ...] = _DEFAULT_ORDER) -> int:
        sr, ss = approx_r.store, approx_s.store
        if predicate == "linestring":
            return join.linestring_verdict_pair(ss.a_list(j), ss.f_list(j),
                                                sr.cell_ids(i))
        if predicate == "within":
            return join.within_verdict_pair(sr.a_list(i), sr.f_list(i),
                                            ss.a_list(j), ss.f_list(j))
        return join.april_verdict_pair(sr.a_list(i), sr.f_list(i),
                                       ss.a_list(j), ss.f_list(j),
                                       order=order)

    def verdicts_mesh(self, approx_r, approx_s, pairs, *, mesh=None,
                      backend: str | None = None, **opts):
        """The ``intersects`` trichotomy of ``pairs`` with the rows sharded
        over the ranks of ``mesh`` (``None``: a mesh of this process on
        the card), one trichotomy launch a rank (``backend`` ``"cuda"``)
        or its plain version (``"torch"``; default the mesh device's own)
        over the cached CSR lists (``distributed.sharded_trichotomy``).
        Returns (verdicts [N] int8 in batch order, counts)."""
        from ..distributed import make_join_mesh, sharded_trichotomy
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        return sharded_trichotomy(approx_r, approx_s, pairs,
                                  mesh or make_join_mesh(), backend=backend)


@register_filter("april-c")
class AprilCompressedFilter(AprilFilter):

    supports_mesh = False
    # its lists are compressed: no packed batch, no sharded path
    verdicts_mesh = IntermediateFilter.verdicts_mesh

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", method: str = "batched",
              build_backend: str = "numpy", device=None,
              **opts) -> Approximation:
        approx = super().build(dataset, n_order=n_order, extent=extent,
                               kind=kind, side=side, method=method,
                               build_backend=build_backend, device=device,
                               **opts)
        # a line side has no interval lists to compress: it keeps the
        # uncompressed cell-id store
        if kind != "line":
            approx.store = compress.compress_april(approx.store)
        return approx

    # VByte buffers are per-object lists, so a splice is a list operation;
    # a line side is APRIL's uncompressed cell store and takes its path
    def _store_append(self, approx, one) -> None:
        store = approx.store
        if isinstance(store, compress.CompressedAprilStore):
            store.a_bufs.append(one.store.a_bufs[0])
            store.f_bufs.append(one.store.f_bufs[0])
            self._drop_derived(approx)
        else:
            super()._store_append(approx, one)

    def _store_delete(self, approx, idx: int) -> None:
        store = approx.store
        if isinstance(store, compress.CompressedAprilStore):
            del store.a_bufs[idx]
            del store.f_bufs[idx]
            self._drop_derived(approx)
        else:
            super()._store_delete(approx, idx)

    @staticmethod
    def _decode(approx, col: np.ndarray, kind: str):
        """(IntervalLists, rows) of one list kind, decoded for the unique
        objects of ``col`` only."""
        uniq, rows = np.unique(col, return_inverse=True)
        off, ints = approx.store.decompress_lists(uniq, kind)
        return join.IntervalLists.from_intervals(off, ints), rows.ravel()

    def verdicts(self, approx_r, approx_s, pairs, *,
                 predicate: str = "intersects", backend: str = "numpy",
                 device=None, order: tuple[str, ...] = _DEFAULT_ORDER,
                 **opts) -> np.ndarray:
        self._check(predicate, backend)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        if backend == "sequential":
            return self.verdicts_seq(approx_r, approx_s, pairs,
                                     predicate=predicate, order=order)
        if predicate in ("intersects", "selection") and "AA" not in order:
            raise ValueError("order must include 'AA'")
        dev = None
        if backend != "numpy":
            dev = resolve_device(device)
            check_backend_device(backend, dev)
        e = self._empty(pairs)
        if e is not None:
            return e
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        ri, si = pairs[:, 0], pairs[:, 1]
        overlap = join._overlap_fn(backend, dev)
        if predicate == "linestring":
            # the line side is an uncompressed cell-id store
            Xa, xa_rows = self._lists(approx_r, "line"), ri
        else:
            Xa, xa_rows = self._decode(approx_r, ri, "A")
        Ya, ya_rows = self._decode(approx_s, si, "A")
        aa = overlap(Xa, xa_rows, Ya, ya_rows)
        verdicts = np.where(aa, join.INDECISIVE,
                            join.TRUE_NEG).astype(np.int8)
        sel = np.nonzero(aa)[0]
        if predicate == "linestring":
            if len(sel):
                Yf, yf_rows = self._decode(approx_s, si[sel], "F")
                fhit = overlap(Xa, xa_rows[sel], Yf, yf_rows)
                verdicts[sel[fhit]] = join.TRUE_HIT
            return verdicts
        if predicate == "within":
            if len(sel):
                Yf, yf_rows = self._decode(approx_s, si[sel], "F")
                cont = join._contain_fn(backend, dev)(Xa, xa_rows[sel], Yf,
                                                     yf_rows)
                verdicts[sel[cont]] = join.TRUE_HIT
            return verdicts
        # a degenerate order leaves AA survivors INDECISIVE
        for step in [s for s in order if s != "AA"]:
            if len(sel) == 0:
                break
            if step == "AF":
                Yf, yf_rows = self._decode(approx_s, si[sel], "F")
                hit = overlap(Xa, xa_rows[sel], Yf, yf_rows)
            else:
                Xf, xf_rows = self._decode(approx_r, ri[sel], "F")
                hit = overlap(Xf, xf_rows, Ya, ya_rows[sel])
            verdicts[sel[hit]] = join.TRUE_HIT
            sel = sel[~hit]
        return verdicts

    def to_device(self, approx_r, approx_s, device) -> None:
        """Nothing stays on the device: lists are decoded per batch."""

    def status_lane(self, approx_r, approx_s, ri, si, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None,
                    order: tuple[str, ...] = _DEFAULT_ORDER, **opts):
        # the bounded decode is survivor-driven host work, so the lane is
        # the uploaded host verdicts
        return IntermediateFilter.status_lane(
            self, approx_r, approx_s, ri, si, predicate=predicate,
            backend=backend, device=device, order=order, **opts)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate,
                     order: tuple[str, ...] = _DEFAULT_ORDER) -> int:
        if predicate in ("within", "linestring"):
            return super()._verdict_one(approx_r, approx_s, i, j,
                                        predicate=predicate, order=order)
        # the streaming join-while-decompress (§5.1)
        sr, ss = approx_r.store, approx_s.store
        return compress.april_verdict_compressed(
            sr.a_bufs[i], sr.f_bufs[i], ss.a_bufs[j], ss.f_bufs[j])
