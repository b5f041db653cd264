"""The APRIL intermediate filter (paper §4) for the ``intersects``
predicate.

The batched path runs the staged trichotomy of ``core.join`` over
:class:`~repro_torch.core.join.IntervalLists`, wrapped once per
Approximation (cached in ``meta``) and uploaded to the device once. The
fused chain's status lane is computed on the device by
``core.join.fused_status_rows``.
"""
from __future__ import annotations

import numpy as np

from ...core import join
from ...core.april import build_april
from ...core.rasterize import Extent, GLOBAL_EXTENT
from .base import (Approximation, IntermediateFilter, check_predicate,
                   register_filter)

__all__ = ["AprilFilter"]

_DEFAULT_ORDER = ("AA", "AF", "FA")


@register_filter("april")
class AprilFilter(IntermediateFilter):

    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", method: str = "batched",
              build_backend: str = "numpy", **opts) -> Approximation:
        if kind != "polygon":
            raise NotImplementedError(
                "line approximations are not ported yet: ROADMAP A1-A3 "
                "(the linestring predicate)")
        if method != "batched" or build_backend != "numpy":
            raise NotImplementedError(
                f"APRIL construction method={method!r}, build_backend="
                f"{build_backend!r} is not ported yet (only the batched "
                "numpy build): ROADMAP A7 (device construction)")
        if opts:
            raise TypeError(f"unexpected build options {sorted(opts)}")
        store = build_april(dataset, n_order, extent)
        return Approximation(filter=self.name, store=store, n_order=n_order,
                             extent=extent, kind=kind,
                             meta={"build_opts": {"method": method}})

    @staticmethod
    def _lists(approx, kind: str) -> join.IntervalLists:
        cache = approx.meta.setdefault("interval_lists", {})
        if kind not in cache:
            store = approx.store
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
        return join.april_trichotomy_rows(
            self._lists(approx_r, "A"), self._lists(approx_r, "F"),
            self._lists(approx_s, "A"), self._lists(approx_s, "F"),
            pairs[:, 0], pairs[:, 1], backend=backend, order=order,
            device=device)

    def to_device(self, approx_r, approx_s, device) -> None:
        for approx in (approx_r, approx_s):
            for kind in ("A", "F"):
                self._lists(approx, kind).to(device)

    def status_lane(self, approx_r, approx_s, ri, si, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None,
                    order: tuple[str, ...] = _DEFAULT_ORDER, **opts):
        """The trichotomy of every frame row on the device, through
        ``join.fused_status_rows`` (over ``rows``, the frame's device copies,
        when given). The sequential backend and a join order other than the
        full three-join set (which leaves AA survivors INDECISIVE) keep the
        uploaded host lane, so fused == staged row for row."""
        check_predicate(predicate)
        join.check_filter_backend(backend)
        if backend == "sequential" or set(order) != set(_DEFAULT_ORDER):
            return super().status_lane(approx_r, approx_s, ri, si,
                                       predicate=predicate, backend=backend,
                                       device=device, order=order, **opts)
        if opts:
            raise TypeError(f"unexpected filter options {sorted(opts)}")
        return join.fused_status_rows(
            self._lists(approx_r, "A"), self._lists(approx_r, "F"),
            self._lists(approx_s, "A"), self._lists(approx_s, "F"), ri, si,
            rows=rows, backend=backend, device=device)

    def _verdict_one(self, approx_r, approx_s, i, j, *, predicate,
                     order: tuple[str, ...] = _DEFAULT_ORDER) -> int:
        sr, ss = approx_r.store, approx_s.store
        return join.april_verdict_pair(sr.a_list(i), sr.f_list(i),
                                       ss.a_list(j), ss.f_list(j),
                                       order=order)
