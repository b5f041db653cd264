"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` at the checkout root, and
loads with ``ctypes``. Nothing is built at import time: the first call to
:func:`load` builds its library if it is stale; :func:`build_all` builds
several at once, one ``nvcc`` process per source, all started together,
then waits for all of them. A library's file name carries a hash of its
source and flags, so an edited source rebuilds and an unchanged one is
reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build_all", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

#: library name -> (source file, extra nvcc flags). The edge sweep and the
#: fused refine are built without multiply-add contraction so that their
#: lanes equal the plain PyTorch versions bit for bit.
SOURCES = {
    "interval_join": ("interval_join.cu", []),
    "refine": ("refine.cu", ["-fmad=false"]),
    "fused_refine": ("fused_refine.cu", ["-fmad=false"]),
    "compact": ("compact.cu", []),
    "ri_and": ("ri_and.cu", []),
    "april_attention": ("april_attention.cu", []),
    "april_attention_tc": ("april_attention_tc.cu", []),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    src, flags = SOURCES[name]
    h = hashlib.sha1((CSRC / src).read_bytes())
    h.update(" ".join(_ARCH + _COMMON + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every stale library of ``names`` (default: all) in
    parallel; returns seconds per library built (empty when all were
    current)."""
    todo = [n for n in (names or SOURCES) if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        src, flags = SOURCES[name]
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_ARCH, *_COMMON, *flags, "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        if log.strip():
            print(f"[nvcc {name}]\n{log.rstrip()}", flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
