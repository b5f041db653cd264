"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a missing GPU raises instead of carrying on on the
host. The ``"cuda"`` backends launch hand-written kernels and need a CUDA
device; the ``"torch"`` backends run the kernels' plain PyTorch versions on
whatever device they are given.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

__all__ = ["resolve_device", "check_backend_device", "upload", "InputLog",
           "StageClock"]


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device`` (``None`` -> ``"cuda"``); raises
    ``RuntimeError`` when CUDA is asked for and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the host")
    return dev


def check_backend_device(backend: str, dev: torch.device) -> None:
    """A ``"cuda"`` backend on a non-CUDA device raises ``ValueError``."""
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend 'cuda' launches CUDA kernels and needs a CUDA device, "
            f"got device={str(dev)!r}; use backend 'torch' on the CPU")


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``dev`` without a host sync: on a CUDA device it
    is staged in pinned memory and copied with ``non_blocking=True`` (the
    caching host allocator keeps the staging buffer alive until the copy
    has run); on the CPU the tensor shares ``a``'s memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class InputLog:
    """Where a module notes the inputs it gave a kernel, so that the kernel
    can be replayed on exactly what a join gave it. ``add`` does nothing
    unless a ``record()`` block is open; inside one, each ``add`` appends
    its item to the list the block yields, from whichever thread it comes
    (a service's worker thread included)."""

    def __init__(self) -> None:
        self._items: list | None = None
        self._lock = threading.Lock()

    def add(self, item) -> None:
        with self._lock:
            if self._items is not None:
                self._items.append(item)

    @contextlib.contextmanager
    def record(self):
        with self._lock:
            prev, self._items = self._items, []
            items = self._items
        try:
            yield items
        finally:
            with self._lock:
                self._items = prev


class StageClock:
    """Where a module adds up the host seconds of its named stages, so that
    a caller can see where a build's time goes. ``stage`` does nothing
    unless a ``record()`` block is open; inside one, each ``stage(name)``
    block adds its wall seconds to ``name`` in the dict the block yields.
    A device pass that reads its result back is timed to its end."""

    def __init__(self) -> None:
        self._secs: dict | None = None

    @contextlib.contextmanager
    def stage(self, name: str):
        secs = self._secs
        if secs is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0

    @contextlib.contextmanager
    def record(self):
        prev, self._secs = self._secs, {}
        try:
            yield self._secs
        finally:
            self._secs = prev
