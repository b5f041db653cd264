"""LRU cache of warm approximation stores for the join service.

The paper's contract is *build once, query forever*: approximations are
preprocessing artifacts amortized across many joins. :class:`StoreCache`
holds built :class:`~repro_torch.spatial.filters.base.Approximation`\\ s,
keyed by ``(dataset_id, filter_method, n_order)`` under a byte budget;
their device copies (interval lists on the card, RI's device store) ride
along in ``meta`` and are reused across requests. Least-recently-used
stores are evicted when the budget is exceeded; :attr:`stats` counts hits,
misses, evictions and resident bytes.

The budget counts ``approx.size_bytes()``, the host store's size, as the
reference package's cache does, so hits and evictions equal the
reference's on the same trace. An evicted entry releases its device copies
(``filters.base.release_device``): they are what a warm entry holds on the
card, and a store evicted while some caller still holds it uploads them
again on its next join.

The cache is thread-safe: the service's micro-batch worker and mutating
caller threads use it concurrently, so every method holds ``self._lock``
(reentrant: ``put`` and ``pop`` call ``_drop`` under it).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from .filters import Approximation
from .filters.base import release_device

__all__ = ["StoreCache", "DEFAULT_BUDGET"]

#: default byte budget: plenty for the synthetic datasets, small enough
#: that a launcher flag can force eviction traffic
DEFAULT_BUDGET = 256 << 20


class StoreCache:
    """Byte-budgeted LRU of built approximation stores.

    Keys are ``(dataset_id, filter_method, n_order)`` tuples; values are
    :class:`Approximation`. ``get`` refreshes recency; ``put`` evicts from
    the LRU end until the new entry fits. A single store larger than the
    whole budget is still admitted (the service must be able to run) but
    evicts everything else.
    """

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET):
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._entries: OrderedDict[tuple, Approximation] = OrderedDict()
        self._bytes: dict[tuple, int] = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "resident_bytes": 0, "puts": 0}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: tuple) -> Approximation | None:
        with self._lock:
            approx = self._entries.get(key)
            if approx is None:
                self.stats["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return approx

    def put(self, key: tuple, approx: Approximation) -> None:
        with self._lock:
            if key in self._entries:
                self._drop(key)
            size = approx.size_bytes()
            while self._entries and \
                    self.stats["resident_bytes"] + size > self.budget_bytes:
                old_key, old = self._entries.popitem(last=False)
                self.stats["resident_bytes"] -= self._bytes.pop(old_key)
                self.stats["evictions"] += 1
                release_device(old)
            self._entries[key] = approx
            self._bytes[key] = size
            self.stats["resident_bytes"] += size
            self.stats["puts"] += 1

    def resize(self, key: tuple) -> None:
        """Re-measure one entry after an in-place store patch."""
        with self._lock:
            if key in self._entries:
                size = self._entries[key].size_bytes()
                self.stats["resident_bytes"] += size - self._bytes[key]
                self._bytes[key] = size

    def pop(self, key: tuple) -> Approximation | None:
        """Remove and return an entry (its device copies stay with it)."""
        with self._lock:
            approx = self._entries.get(key)
            if approx is not None:
                self._drop(key)
            return approx

    def _drop(self, key: tuple) -> None:
        with self._lock:
            del self._entries[key]
            self.stats["resident_bytes"] -= self._bytes.pop(key)

    def items(self):
        """(key, approx) pairs, least-recently-used first."""
        with self._lock:
            return list(self._entries.items())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self.stats["resident_bytes"] = 0
