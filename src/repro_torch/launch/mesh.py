"""Meshes of ranks for the sharded LM step (the reference's
``launch/mesh.py``).

A :class:`Mesh` is the port's twin of ``jax.sharding.Mesh``: a grid of
``torch.distributed`` ranks with named axes, ``("data", "model")`` or
``("pod", "data", "model")``. Each process holds one rank and computes
on one device (``mesh.device``); several ranks may share a card. The
collectives the sharded step needs run over the ranks that differ from
this one along some axes only (:meth:`Mesh.group`), and every call adds
the bytes it leaves on this rank to ``mesh.tally`` by the reference's
HLO kind (``all-reduce``, ``all-gather``, ``reduce-scatter``), which is
what the dry run reports.

The process groups use whatever backend the default group has. The card
runs the port's ranks over ``gloo`` (NCCL refuses two ranks on one
card), which takes all three kinds on CUDA tensors (torch 2.11), so the
tensors stay on the device.

A mesh without a process group of its size (``make_production_mesh``
outside a dry run) is abstract: it has the shape, the names and a rank's
coordinates, which is all the sharding rules need, and its collectives
raise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Mesh", "make_production_mesh", "make_dev_mesh"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class Mesh:
    """``ranks``: an int array of the mesh's shape (rank ids of the default
    process group); ``axis_names``: one name per dim; ``device``: where
    this rank computes; ``rank``: this process's rank (default: the
    default group's, else 0)."""

    def __init__(self, ranks, axis_names, *, device=None, rank=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.shape} ranks for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.device = resolve_device(device)
        live = dist.is_available() and dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if live else 0
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)
        self.coords = (dict(zip(self.axis_names, (int(c) for c in where[0])))
                       if len(where) else None)
        self.tally: dict[str, int] = {}
        self._groups: dict[tuple, object] = {}
        self.abstract = self.size > 1 and not (
            live and int(self.ranks.max()) < dist.get_world_size())
        if live and not self.abstract:
            self._make_groups()

    # ------------------------------------------------------------- groups
    def _subsets(self):
        """The axis subsets that get process groups: each axis, the data
        axes together, and all axes."""
        names = self.axis_names
        data = tuple(a for a in ("pod", "data") if a in names)
        out = [(a,) for a in names]
        for s in (data, names):
            if s and s not in out:
                out.append(s)
        return out

    def _make_groups(self):
        """One process group per subset and per coordinate of the other
        axes; every rank of the default group makes every group, in the
        same order, and keeps those it belongs to."""
        for axes in self._subsets():
            idx = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(self.ranks.ndim) if i not in idx]
            moved = np.moveaxis(self.ranks, idx + rest,
                                list(range(self.ranks.ndim)))
            n = int(np.prod([self.ranks.shape[i] for i in idx]))
            blocks = moved.reshape(n, -1).T
            for members in blocks:
                members = [int(r) for r in members]
                g = dist.new_group(members) if len(members) > 1 else None
                if self.rank in members:
                    self._groups[axes] = g

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the first major), the
        chunk it holds of a dimension sharded over them."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        key = self._key(axes)
        if self.axis_size(key) == 1:
            return None
        if self.abstract:
            raise RuntimeError(f"mesh {self.shape} has no process group of "
                               f"its size: it only carries shapes")
        return self._groups[key]

    # -------------------------------------------------------- collectives
    def _count(self, kind, t):
        self.tally[kind] = self.tally.get(kind, 0) + t.numel() * \
            t.element_size()

    def all_reduce(self, t, axes, op="sum"):
        """The sum (or max) of ``t`` over the ranks along ``axes``."""
        g = self.group(axes)
        if g is None:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=g)
        self._count("all-reduce", out)
        return out

    def all_gather(self, t, axes, dim):
        """The ranks' ``t`` along ``axes`` concatenated on ``dim``."""
        g = self.group(axes)
        if g is None:
            return t
        n = self.axis_size(axes)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=g)
        self._count("all-gather", out)
        return out.movedim(0, dim)

    def reduce_scatter(self, t, axes, dim):
        """This rank's chunk on ``dim`` of the sum of ``t`` over ``axes``."""
        g = self.group(axes)
        if g is None:
            return t
        n = self.axis_size(axes)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=g)
        self._count("reduce-scatter", out)
        return out.movedim(0, dim)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def _grid(shape) -> np.ndarray:
    return np.arange(int(np.prod(shape))).reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: 16 x 16 ("data", "model"), or
    2 x 16 x 16 ("pod", "data", "model") with ``multi_pod``, computing on
    ``device`` (``None`` -> the card, which raises without one; the dry
    run passes ``"meta"``). Abstract unless the default process group has
    its 256 or 512 ranks (the dry run's fake group)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return Mesh(_grid(shape), axes, device=device)


def make_dev_mesh(n_data: int, n_model: int, *, device=None):
    """A (data, model) mesh over the first ``n_data * n_model`` ranks of the
    default process group, computing on ``device`` (``None`` -> the card,
    which raises without one). The group's backend is the caller's:
    several ranks on one card need ``gloo``."""
    if not (dist.is_available() and dist.is_initialized()) and \
            n_data * n_model > 1:
        raise RuntimeError("make_dev_mesh needs an initialised default "
                           "process group of at least "
                           f"{n_data * n_model} ranks")
    return Mesh(_grid((n_data, n_model)), ("data", "model"),
                device=resolve_device(device))
