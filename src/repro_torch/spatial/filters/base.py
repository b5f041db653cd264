"""The `IntermediateFilter` protocol and the port's own filter registry.

* :class:`Approximation` — a built, reusable, sizeable store for one
  dataset.
* :class:`IntermediateFilter` — ``build`` produces an Approximation;
  ``verdicts`` classifies a candidate batch into the paper's trichotomy
  (TRUE_NEG / TRUE_HIT / INDECISIVE); ``verdicts_seq`` is the per-pair
  reference the batched path must equal; ``status_lane`` is the fused
  chain's device int8 lane of the same verdicts; ``verdicts_mesh`` (where
  ``supports_mesh``) shards the ``intersects`` verdicts over the ranks of
  a ``JoinMesh``.
* ``patch_insert`` / ``patch_delete`` — incremental maintenance: one
  object's row spliced into or out of a built store in place, which then
  equals a fresh rebuild over the patched dataset, host arrays and the
  device copies made from them alike.
* a name-based registry backing ``none / april / april-c / ri / ra /
  5cch``. It is separate from the reference package's, so registering a
  filter here changes nothing there.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np
import torch

from ...core.geometry import BUILD_BACKENDS, check_build_backend
from ...core.join import FILTER_BACKENDS, INDECISIVE, check_filter_backend
from ...core.rasterize import Extent, GLOBAL_EXTENT
from ...device import resolve_device, upload

__all__ = ["PREDICATES", "KINDS", "BACKENDS", "FILTER_BACKENDS",
           "BUILD_BACKENDS", "Approximation", "IntermediateFilter",
           "register_filter", "unregister_filter", "get_filter",
           "available_filters", "check_predicate", "release_device"]

PREDICATES = ("intersects", "within", "linestring", "selection")
BACKENDS = FILTER_BACKENDS   # historical alias
#: what a dataset side holds: closed rings, or open chains (linestrings)
KINDS = ("polygon", "line")


def check_predicate(predicate: str) -> None:
    """``selection`` (polygonal range queries, §4.3.1) is the
    ``intersects`` test with the query polygons as the S side;
    ``linestring`` (§4.3.3) expects the R side built with
    ``kind="line"``."""
    if predicate not in PREDICATES:
        raise ValueError(f"unknown predicate {predicate!r}; "
                         f"expected one of {PREDICATES}")


@dataclass
class Approximation:
    """A built intermediate-filter store for one dataset; ``meta`` holds
    reusable caches (e.g. device-ready interval lists)."""
    filter: str
    store: object
    n_order: int | None = None
    extent: Extent | None = None
    kind: str = "polygon"
    meta: dict = field(default_factory=dict)

    def size_bytes(self) -> int:
        return int(self.store.size_bytes()) if self.store is not None else 0

    def __len__(self) -> int:
        return len(self.store) if self.store is not None else 0


class IntermediateFilter(abc.ABC):
    """One intermediate filter method."""

    name: str = "?"
    #: filters with a rank-sharded path (``verdicts_mesh``, see
    #: ``spatial/distributed.py``)
    supports_mesh: bool = False

    @abc.abstractmethod
    def build(self, dataset, *, n_order: int = 10,
              extent: Extent = GLOBAL_EXTENT, kind: str = "polygon",
              side: str = "r", **opts) -> Approximation:
        """Build the approximation store for ``dataset``. Every built-in
        filter but ``none`` takes ``build_backend`` (one of
        ``BUILD_BACKENDS``: the batched ``numpy`` build, its device passes
        with ``torch`` on ``device``, or the ``sequential`` per-object
        reference) and ``device`` (``None`` -> ``"cuda"``)."""

    @abc.abstractmethod
    def verdicts(self, approx_r: Approximation, approx_s: Approximation,
                 pairs: np.ndarray, *, predicate: str = "intersects",
                 backend: str = "numpy", device=None, **opts) -> np.ndarray:
        """Batched verdicts [N] int8 for candidate ``pairs`` [N, 2]."""

    def verdicts_seq(self, approx_r: Approximation, approx_s: Approximation,
                     pairs: np.ndarray, *, predicate: str = "intersects",
                     **opts) -> np.ndarray:
        """Per-pair reference loop over :meth:`_verdict_one`."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        check_predicate(predicate)
        return np.asarray(
            [self._verdict_one(approx_r, approx_s, int(i), int(j),
                               predicate=predicate, **opts)
             for i, j in pairs], np.int8).reshape(len(pairs))

    def _verdict_one(self, approx_r, approx_s, i: int, j: int, *,
                     predicate: str, **opts) -> int:
        raise NotImplementedError

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _check_build_backend(build_backend: str) -> None:
        check_build_backend(build_backend)

    @staticmethod
    def _check_kind(kind: str) -> None:
        """``polygon`` (closed rings) or ``line`` (open chains, §4.3.3)."""
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of "
                             f"{KINDS}")

    @staticmethod
    def _check(predicate: str, backend: str) -> None:
        check_predicate(predicate)
        check_filter_backend(backend)

    @staticmethod
    def _empty(pairs: np.ndarray) -> np.ndarray | None:
        pairs = np.asarray(pairs)
        if pairs.size == 0:
            return np.zeros(0, np.int8)
        return None

    @staticmethod
    def _all_indecisive(pairs: np.ndarray) -> np.ndarray:
        n = len(np.asarray(pairs).reshape(-1, 2))
        return np.full(n, INDECISIVE, np.int8)

    # -- incremental maintenance ---------------------------------------------

    def patch_insert(self, approx: Approximation, dataset_one) -> None:
        """Append the approximation of ``dataset_one``'s single object to
        ``approx`` in place (the new object gets id ``len(approx)``). The
        one-object store comes from this filter's own :meth:`build` under
        the ``build_opts`` recorded in ``approx.meta`` at build time;
        construction is independent per object, so the patched store
        equals a fresh rebuild over the extended dataset."""
        if len(dataset_one) != 1:
            raise ValueError(f"patch_insert expects a 1-object dataset, "
                             f"got {len(dataset_one)}")
        opts = dict(approx.meta.get("build_opts", {}))
        one = self.build(
            dataset_one,
            n_order=approx.n_order if approx.n_order is not None else 10,
            extent=approx.extent if approx.extent is not None
            else GLOBAL_EXTENT, kind=approx.kind, **opts)
        self._store_append(approx, one)

    def patch_delete(self, approx: Approximation, idx: int) -> None:
        """Splice object ``idx`` out of ``approx`` in place; later ids
        shift down by one (the numbering a fresh rebuild would use)."""
        if not 0 <= int(idx) < len(approx):
            raise IndexError(f"patch_delete: id {idx} out of range "
                             f"[0, {len(approx)})")
        self._store_delete(approx, int(idx))

    def _store_append(self, approx: Approximation,
                      one: Approximation) -> None:
        raise NotImplementedError(
            f"filter {self.name!r} has no incremental maintenance path")

    def _store_delete(self, approx: Approximation, idx: int) -> None:
        raise NotImplementedError(
            f"filter {self.name!r} has no incremental maintenance path")

    @staticmethod
    def _drop_derived(approx: Approximation) -> None:
        """Drop the per-object caches a row splice invalidates: the
        device-ready interval lists, RA's pyramids and RI's device store
        (whose device copies would otherwise keep joining the store as it
        was before the patch)."""
        for key in ("interval_lists", "pyramid", "device_store"):
            approx.meta.pop(key, None)

    def to_device(self, approx_r: Approximation, approx_s: Approximation,
                  device) -> None:
        """Upload whatever :meth:`status_lane` reads on ``device`` and cache
        it, so that the fused chain itself makes no blocking upload. The
        default has nothing to upload."""

    def status_lane(self, approx_r: Approximation, approx_s: Approximation,
                    ri: np.ndarray, si: np.ndarray, *,
                    predicate: str = "intersects", backend: str = "numpy",
                    device=None, rows=None, **opts) -> torch.Tensor:
        """Device int8 status lane [N] over the fused chain's pair frame.

        ``ri``/``si`` are the host-known candidate frame and ``rows`` its
        copies on ``device``, when the caller has them. The default
        computes the batched host :meth:`verdicts` and uploads them (it
        needs no ``rows``); filters whose stores live on the device override
        it with a lane computed there. Verdicts are row-identical to
        :meth:`verdicts`.
        """
        dev = resolve_device(device)
        ri = np.asarray(ri, np.int64)
        si = np.asarray(si, np.int64)
        if len(ri) == 0:
            return torch.zeros(0, dtype=torch.int8, device=dev)
        verd = self.verdicts(approx_r, approx_s, np.stack([ri, si], axis=1),
                             predicate=predicate, backend=backend,
                             device=dev, **opts)
        return upload(np.asarray(verd, np.int8), dev)

    def verdicts_mesh(self, approx_r: Approximation,
                      approx_s: Approximation, pairs: np.ndarray, *,
                      mesh=None, **opts) -> tuple[np.ndarray, dict]:
        """(verdicts [N] int8, counts) of the ``intersects`` trichotomy,
        sharded over the ranks of ``mesh``; only filters with
        ``supports_mesh`` have it."""
        raise NotImplementedError(
            f"filter {self.name!r} has no rank-sharded path")


def release_device(approx: Approximation) -> None:
    """Free the device copies ``approx`` caches (the interval lists' and
    RI's device store's) and keep every host array; a later join uploads
    them again. What an evicted store cache entry goes through."""
    for lists in approx.meta.get("interval_lists", {}).values():
        lists.drop_device()
    store = approx.meta.get("device_store")
    if store is not None:
        store.drop_device()


_REGISTRY: dict[str, type[IntermediateFilter]] = {}


def register_filter(name: str, cls: type[IntermediateFilter] | None = None):
    """Register a filter class under ``name``: ``register_filter(name,
    cls)``, or as a class decorator ``@register_filter(name)``."""
    def _do(c):
        c.name = name
        _REGISTRY[name] = c
        return c
    return _do(cls) if cls is not None else _do


def unregister_filter(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_filter(name: str | IntermediateFilter) -> IntermediateFilter:
    """Look up a registered filter by name; instances pass through."""
    if isinstance(name, IntermediateFilter):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]()
    raise ValueError(f"unknown intermediate filter {name!r}; "
                     f"available: {sorted(_REGISTRY)}")


def available_filters() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
