"""Fault-tolerant checkpointing: host npy leaves plus a manifest, an atomic
directory commit, optional background save, crc32 integrity, keep-last-K
garbage collection.

Format (the reference package's, so that either package restores what the
other saved):

    <dir>/step_<N>.tmp/...          (in-flight write, never read)
    <dir>/step_<N>/manifest.json    {step, leaves: {name: {file, shape,
                                     dtype, crc32}}, time, extra}
    <dir>/step_<N>/<leaf>.npy
    <dir>/LATEST                    (text file, committed last)

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
torch tensors or scalars; ``None`` holds no leaf. Leaves are named by their
key path, ``/``-joined (dict keys in sorted order, sequence indices), the
names the reference's pytree flattening gives. Tensors are copied to the
host when the tree is flattened; restore returns host numpy arrays
(:meth:`CheckpointManager.restore`), or, into the structure of a like
tree (:meth:`CheckpointManager.restore_tree`, :func:`flat_to_tree`), a
tensor on the like leaf's device where that leaf is a tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib

import numpy as np
import torch

__all__ = ["CheckpointManager", "tree_to_flat", "flat_to_tree"]


def _leaves(tree, path=()):
    """(key path, leaf) of every leaf of ``tree``, in flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _host(leaf) -> np.ndarray:
    """A host snapshot of ``leaf``: a tensor is copied (``.cpu()`` of a
    CPU tensor shares its storage, and an in-place update after ``save``
    returns must not reach the file); a numpy leaf is taken as it is."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.numpy().copy() if t.device.type == "cpu" else \
            t.cpu().numpy()
    return np.asarray(leaf)


def tree_to_flat(tree) -> dict[str, np.ndarray]:
    """{leaf name: host numpy array} of every leaf of ``tree``."""
    return {_path_str(p): _host(leaf) for p, leaf in _leaves(tree)}


def flat_to_tree(flat: dict, like):
    """``like``'s structure with every leaf taken from ``flat`` by name,
    its shape checked; a tensor leaf of ``like`` becomes a tensor on its
    device, any other leaf a numpy array."""

    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k], path + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            out = [build(v, path + (i,)) for i, v in enumerate(node)]
            return type(node)(out) if isinstance(node, tuple) else out
        key = _path_str(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        shape = tuple(node.shape) if hasattr(node, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        if isinstance(node, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(node.device)
        return arr

    return build(like, ())


class CheckpointManager:
    """Saves and restores trees of arrays under ``directory``, keeping the
    last ``keep`` steps (0 keeps all). ``async_save`` writes in a
    background thread after the host copy is taken."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None,
             block: bool = False):
        """Snapshot to the host, then write (in the background unless
        ``block`` or ``async_save=False``). ``extra`` is any JSON-safe dict,
        stored in the manifest."""
        flat = tree_to_flat(tree)   # the device -> host copy happens here
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra or {}))
            self._thread.start()
        else:
            self._write(step, flat, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": {}}
        for name, arr in flat.items():
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                       # atomic commit
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, d,
                                                    "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.dir, f"step_{s}",
                                           "manifest.json")):
                return s
        steps = self.all_steps()   # fall back: scan (LATEST lost or corrupt)
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, verify: bool = True):
        """(step, {leaf name: numpy array}, extra), or ``None`` when no
        step exists; with ``verify`` a leaf whose crc32 differs from the
        manifest's raises ``IOError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for name, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(f"checksum mismatch in {name} @ step {step}")
            flat[name] = arr
        return manifest["step"], flat, manifest.get("extra", {})

    def restore_tree(self, like, step: int | None = None):
        """(step, tree shaped like ``like``, extra), or ``None``."""
        res = self.restore(step)
        if res is None:
            return None
        step, flat, extra = res
        return step, flat_to_tree(flat, like), extra
