"""RA (Zimbrao & de Souza raster approximation) intermediate filter (§2).

The batched path memoizes per-object upscale pyramids in the
Approximation's ``meta`` (they survive across calls and predicates) and
evaluates the overlay and Table-1 lookup (or, for ``within``, the
containment rules of ``ra_within_batch``) of every candidate pair as one
padded vectorized gather on the host, whatever the backend; the fused
chain's status lane is those verdicts, uploaded once per batch.
"""
from __future__ import annotations

import numpy as np

from ...baselines import ra
from ...core.rasterize import Extent, GLOBAL_EXTENT
from .base import Approximation, IntermediateFilter, register_filter

__all__ = ["RAFilter"]


@register_filter("ra")
class RAFilter(IntermediateFilter):

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", max_cells: int = 750,
              build_backend: str = "numpy", device=None,
              **opts) -> Approximation:
        self._check_build_backend(build_backend)
        self._check_kind(kind)
        if opts:
            raise TypeError(f"unexpected build options {sorted(opts)}")
        # n_order is unused: RA grids are per object, sized by max_cells
        build = ra.build_ra_lines if kind == "line" else ra.build_ra
        store = build(dataset, max_cells=max_cells, backend=build_backend,
                      device=device)
        return Approximation(filter=self.name, store=store,
                             n_order=None, extent=extent, kind=kind,
                             meta={"build_opts": {"max_cells": max_cells}})

    # -- incremental maintenance: per-object grid rows ----------------------
    # RA grids are fit per object from its own MBR, so one object's (k,
    # origin, shape, cells) rows splice independently; the index-keyed
    # pyramid memo goes with _drop_derived.
    def _store_append(self, approx, one) -> None:
        store, o = approx.store, one.store
        store.k = np.concatenate([store.k, o.k])
        store.origin = np.concatenate([store.origin, o.origin])
        store.shape = np.concatenate([store.shape, o.shape])
        store.cells.append(o.cells[0])
        self._drop_derived(approx)

    def _store_delete(self, approx, idx: int) -> None:
        store = approx.store
        store.k = np.delete(store.k, idx)
        store.origin = np.delete(store.origin, idx, axis=0)
        store.shape = np.delete(store.shape, idx, axis=0)
        del store.cells[idx]
        self._drop_derived(approx)

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
        cache_r = approx_r.meta.setdefault("pyramid", {})
        cache_s = approx_s.meta.setdefault("pyramid", {})
        batch = ra.ra_within_batch if predicate == "within" else \
            ra.ra_filter_batch
        return batch(approx_r.store, approx_s.store, pairs, cache_r=cache_r,
                     cache_s=cache_s)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate) -> int:
        if predicate == "within":
            return ra.ra_within_verdict_pair(approx_r.store, i,
                                             approx_s.store, j)
        return ra.ra_verdict_pair(approx_r.store, i, approx_s.store, j)
