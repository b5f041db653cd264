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


def _profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording on this process."""
    return torch._C._autograd._profiler_enabled()


class _OpenRecords(threading.local):
    """The record dicts open on one thread, outermost first."""

    def __init__(self) -> None:
        self.stack: list[dict] = []


class StageClock:
    """Where a module adds up the host seconds of its named stages and its
    counts, so that a caller can see where a join's or a build's time
    goes.

    Inside a ``record()`` block, each ``stage(name)`` block adds its wall
    seconds to ``name``, and each ``count(name, n)`` adds ``n`` to
    ``name``, in the dict the block yields (``n`` may be a count kept on
    the device, a tensor, which the caller reads back with its own copy).
    Blocks nest, and every block open on the thread receives them; a block
    sees only its own thread's stages and counts. While a
    ``torch.profiler`` session records, a stage is also the span
    ``f"{prefix}.{name}"`` of the profiler's trace, on its clock beside the
    device's kernels; a dotted name is a child of the
    stage that encloses it (``stage("refine.chunks")`` inside
    ``stage("refine")``). With neither on, a stage does nothing. A device
    pass that reads its result back is timed to its end; one that does not
    is timed to its dispatch."""

    def __init__(self, prefix: str) -> None:
        self.prefix = prefix
        self._open = _OpenRecords()
        self._lock = threading.Lock()

    def stage(self, name: str):
        if not self._open.stack and not _profiling():
            return contextlib.nullcontext()
        return self._timed(name)

    def count(self, name: str, n: int = 1) -> None:
        if self._open.stack:
            self._add(self._open.stack, name, n)

    @contextlib.contextmanager
    def record(self):
        rec: dict = {}
        stack = self._open.stack
        stack.append(rec)
        try:
            yield rec
        finally:
            stack.pop()

    @contextlib.contextmanager
    def _timed(self, name: str):
        records = list(self._open.stack)
        span = (torch.profiler.record_function(f"{self.prefix}.{name}")
                if _profiling() else contextlib.nullcontext())
        with span:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._add(records, name, time.perf_counter() - t0)

    def _add(self, records: list, name: str, v) -> None:
        with self._lock:
            for rec in records:
                rec[name] = rec.get(name, 0) + v
