"""Straggler mitigation for the partitioned spatial join.

``StragglerMonitor`` keeps an exponential moving average of step wall
times and flags a step that takes more than ``threshold`` times the
average. ``WorkQueue`` leases join partitions to workers with a deadline:
a lease that expires returns its partition to the queue, so a healthy
worker runs it again. A partition's result depends on nothing but its
inputs, so running one twice is safe.
"""
from __future__ import annotations

import time

__all__ = ["StragglerMonitor", "WorkQueue"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ema: float = 0.9):
        self.threshold = threshold
        self.ema_coef = ema
        self.mean = None
        self.flagged: list[tuple[int, float]] = []
        self._t0 = None
        self.step_idx = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Record a step; returns True if it was a straggler."""
        dt = time.perf_counter() - self._t0
        slow = self.mean is not None and dt > self.threshold * self.mean
        self.mean = dt if self.mean is None else \
            self.ema_coef * self.mean + (1 - self.ema_coef) * dt
        if slow:
            self.flagged.append((self.step_idx, dt))
        self.step_idx += 1
        return slow


class WorkQueue:
    """Partitions leased with a deadline; an expired lease goes back to
    the end of the queue."""

    def __init__(self, items, lease_seconds: float = 60.0):
        self.pending = list(items)
        self.leases: dict[object, float] = {}
        self.done: set = set()
        self.lease_seconds = lease_seconds

    def acquire(self):
        """The next pending item, leased until ``lease_seconds`` from now,
        or ``None`` when nothing is pending."""
        now = time.time()
        expired = [k for k, t in self.leases.items() if t < now]
        for k in expired:
            del self.leases[k]
            self.pending.append(k)
        if not self.pending:
            return None
        item = self.pending.pop(0)
        self.leases[item] = now + self.lease_seconds
        return item

    def complete(self, item):
        self.leases.pop(item, None)
        self.done.add(item)

    @property
    def finished(self) -> bool:
        return not self.pending and not self.leases
