"""5C+CH (Brinkhoff) intermediate filter (§2).

Conservative-only: certifies TRUE negatives, never hits, for every
predicate (disjoint approximations rule out intersection and containment
alike), so the batched verdicts are the same for all. The batched path
runs the separating-axis tests as padded einsum passes over the whole
candidate batch on the host, whatever the backend; the fused chain's
status lane is those verdicts, uploaded once per batch.
"""
from __future__ import annotations

import numpy as np

from ...baselines import fivec_ch
from ...core.join import csr_append_row, csr_delete_row
from ...core.rasterize import Extent, GLOBAL_EXTENT
from .base import Approximation, IntermediateFilter, register_filter

__all__ = ["FiveCCHFilter"]


@register_filter("5cch")
class FiveCCHFilter(IntermediateFilter):

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", build_backend: str = "numpy", device=None,
              **opts) -> Approximation:
        self._check_build_backend(build_backend)
        self._check_kind(kind)
        if opts:
            raise TypeError(f"unexpected build options {sorted(opts)}")
        # n_order is unused: 5C+CH is raster-free
        build = (fivec_ch.build_5cch_lines if kind == "line"
                 else fivec_ch.build_5cch)
        store = build(dataset, backend=build_backend, device=device)
        return Approximation(filter=self.name, store=store,
                             n_order=None, extent=extent, kind=kind)

    # -- incremental maintenance: pentagon row and hull CSR splice ---------
    def _store_append(self, approx, one) -> None:
        store, o = approx.store, one.store
        store.pent = np.concatenate([store.pent, o.pent])
        store.hull_off, store.hull_pts = csr_append_row(
            store.hull_off, store.hull_pts, o.hull_pts)

    def _store_delete(self, approx, idx: int) -> None:
        store = approx.store
        store.pent = np.delete(store.pent, idx, axis=0)
        store.hull_off, store.hull_pts = csr_delete_row(
            store.hull_off, store.hull_pts, idx)

    def verdicts(self, approx_r, approx_s, pairs, *,
                 predicate: str = "intersects", backend: str = "numpy",
                 device=None, **opts) -> np.ndarray:
        self._check(predicate, backend)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        if backend == "sequential":
            return self.verdicts_seq(approx_r, approx_s, pairs,
                                     predicate=predicate)
        e = self._empty(pairs)
        if e is not None:
            return e
        return fivec_ch.fivecch_filter_batch(approx_r.store, approx_s.store,
                                             pairs)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate) -> int:
        if predicate == "within":
            return fivec_ch.fivecch_within_verdict_pair(approx_r.store, i,
                                                        approx_s.store, j)
        return fivec_ch.fivecch_verdict_pair(approx_r.store, i,
                                             approx_s.store, j)
