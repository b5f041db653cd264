"""Elastic re-meshing, and straggler mitigation for the partitioned
spatial join.

``remesh_tree`` lays a host (numpy) tree onto a NEW mesh: the core of an
elastic restart. After a node is lost the launcher builds a smaller mesh
from the survivors (``make_mesh_from_devices``), restores the latest
checkpoint (its arrays are global, so the dead mesh's layout does not
matter) and takes each rank's shards under the new mesh's specs.

``StragglerMonitor`` keeps an exponential moving average of step wall
times and flags a step that takes more than ``threshold`` times the
average. ``WorkQueue`` leases join partitions to workers with a deadline:
a lease that expires returns its partition to the queue, so a healthy
worker runs it again. A partition's result depends on nothing but its
inputs, so running one twice is safe.
"""
from __future__ import annotations

import time

import numpy as np
import torch


__all__ = ["remesh_tree", "make_mesh_from_devices", "StragglerMonitor",
           "WorkQueue"]


def make_mesh_from_devices(ranks, n_model: int,
                           axis_names=("data", "model"), *, device=None):
    """The largest (data, model) mesh the surviving ``ranks`` (rank ids of
    the default process group) can form, computing on ``device``
    (``None`` -> the card). Every rank of the default group calls it,
    since it makes the mesh's process groups."""
    from ..launch.mesh import Mesh
    ranks = sorted(int(r) for r in ranks)
    n_model = min(n_model, len(ranks))
    n_data = len(ranks) // n_model
    grid = np.asarray(ranks[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, axis_names, device=device)


def remesh_tree(host_tree, mesh, spec_tree):
    """This rank's shards, on ``mesh.device``, of a tree of global host
    arrays (numpy or tensors; nested dicts and lists) under a tree of
    specs of the same structure."""
    from ..models.sharding import local_shard
    if isinstance(host_tree, dict):
        return {k: remesh_tree(v, mesh, spec_tree[k])
                for k, v in host_tree.items()}
    if isinstance(host_tree, list):
        return [remesh_tree(v, mesh, s) for v, s in zip(host_tree, spec_tree)]
    t = host_tree if isinstance(host_tree, torch.Tensor) else \
        torch.from_numpy(np.array(host_tree))
    return local_shard(t, mesh, spec_tree).to(mesh.device).clone()


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
