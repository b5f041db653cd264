"""RI (Raster Intervals) intermediate filter (paper §3) for the
``intersects``, ``selection``, ``within`` and ``linestring`` predicates.

Each side is built in its own encoding (R for ``side="r"``, S for
``side="s"``, ``encoding=`` overrides), so the usual join skips the XOR
re-encoding; same-encoding pairs stay correct through the XOR mask. The
batched backends run ``core.ri.ri_trichotomy_rows``: ``numpy`` expands
the candidates into fragments on the host, ``torch`` and ``cuda`` run the
ALIGNEDAND kernel's plain version or the kernel over the store's device
form (:class:`~repro_torch.core.ri.RIDeviceStore`, built once per
Approximation and cached in ``meta``). The fused chain's status lane is
the same kernel launched over the chain's device frame, with no host read.
The within filter (§3.4) runs on the host whatever the backend
(``core.ri.ri_within_batch``), as in the reference, and its fused lane is
those verdicts, uploaded once. ``linestring`` shares Algorithm 1 with
``intersects``: a line store's cells are all Weak, so a non-zero AND
still certifies the hit.
"""
from __future__ import annotations

import numpy as np

from ...core import ri
from ...core.join import csr_append_row, csr_delete_row
from ...core.rasterize import Extent, GLOBAL_EXTENT
from .base import Approximation, IntermediateFilter, register_filter

__all__ = ["RIFilter"]


@register_filter("ri")
class RIFilter(IntermediateFilter):

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", encoding: str | None = None,
              build_backend: str = "numpy", device=None,
              **opts) -> Approximation:
        self._check_build_backend(build_backend)
        self._check_kind(kind)
        if opts:
            raise TypeError(f"unexpected build options {sorted(opts)}")
        enc = encoding or ("R" if side == "r" else "S")
        build = ri.build_ri_lines if kind == "line" else ri.build_ri
        store = build(dataset, n_order, extent, enc, backend=build_backend,
                      device=device)
        return Approximation(filter=self.name, store=store, n_order=n_order,
                             extent=extent, kind=kind,
                             meta={"build_opts": {"encoding": enc}})

    # -- incremental maintenance: interval-row splice, bit-segment rebase --
    # Unlike the reference, whose RI filter keeps no device form, a splice
    # drops the cached RIDeviceStore: its packed words and device copies
    # would keep joining the store as it was before the patch.
    def _store_append(self, approx, one) -> None:
        store, o = approx.store, one.store
        # the bit offsets are absolute: the appended object's segment is
        # rebased past the existing code stream
        store.bit_off = np.concatenate(
            [store.bit_off, o.bit_off[1:] + store.bit_off[-1]])
        store.bits = np.concatenate([store.bits, o.bits])
        store.off, store.ints = csr_append_row(store.off, store.ints, o.ints)
        self._drop_derived(approx)

    def _store_delete(self, approx, idx: int) -> None:
        store = approx.store
        lo, hi = int(store.off[idx]), int(store.off[idx + 1])
        b_lo, b_hi = int(store.bit_off[lo]), int(store.bit_off[hi])
        store.bits = np.concatenate([store.bits[:b_lo], store.bits[b_hi:]])
        store.bit_off = np.concatenate(
            [store.bit_off[:lo], store.bit_off[hi:] - (b_hi - b_lo)])
        store.off, store.ints = csr_delete_row(store.off, store.ints, idx)
        self._drop_derived(approx)

    @staticmethod
    def _device(approx) -> ri.RIDeviceStore:
        """The store's device form, built once and cached in ``meta``."""
        if "device_store" not in approx.meta:
            approx.meta["device_store"] = ri.RIDeviceStore(approx.store)
        return approx.meta["device_store"]

    def verdicts(self, approx_r, approx_s, pairs, *,
                 predicate: str = "intersects", backend: str = "numpy",
                 device=None, **opts) -> np.ndarray:
        self._check(predicate, backend)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        if backend == "sequential":
            return self.verdicts_seq(approx_r, approx_s, pairs,
                                     predicate=predicate)
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        if predicate == "within":
            return ri.ri_within_batch(approx_r.store, approx_s.store, pairs)
        stores = ((approx_r.store, approx_s.store) if backend == "numpy"
                  else (self._device(approx_r), self._device(approx_s)))
        return ri.ri_trichotomy_rows(*stores, pairs[:, 0], pairs[:, 1],
                                     backend=backend, device=device)

    def to_device(self, approx_r, approx_s, device) -> None:
        for approx in (approx_r, approx_s):
            self._device(approx).to(device)

    def status_lane(self, approx_r, approx_s, ri_rows, si_rows, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None, **opts):
        """The RI verdicts of every frame row on the device
        (``core.ri.ri_status_rows``, over ``rows`` when given); the numpy
        and sequential backends, and ``within``, keep the uploaded host
        lane."""
        self._check(predicate, backend)
        if backend in ("numpy", "sequential") or predicate == "within":
            return super().status_lane(approx_r, approx_s, ri_rows, si_rows,
                                       predicate=predicate, backend=backend,
                                       device=device, **opts)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        return ri.ri_status_rows(self._device(approx_r),
                                 self._device(approx_s), ri_rows, si_rows,
                                 rows=rows, backend=backend, device=device)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate) -> int:
        if predicate == "within":
            return ri.ri_within_verdict_pair(approx_r.store, i,
                                             approx_s.store, j)
        return ri.ri_verdict_pair(approx_r.store, i, approx_s.store, j)
