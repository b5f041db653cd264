"""Wrapper of the RI ALIGNEDAND kernel (``csrc/ri_and.cu``).

The wrapper checks its tensors, then dispatches on their device: on the
CPU it runs the plain PyTorch version (``ref.py``); on a CUDA device it
launches the kernel on the current stream, or raises. There is no fallback
from one to the other. Kernel launches are counted in
``ri_trichotomy.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import load
from ..interval_join.ops import _check_rows, _cuda_device, _raise_on
from .ref import RIStoreTensors, ri_trichotomy_plain

__all__ = ["ri_trichotomy"]

_P = ctypes.c_void_p

_DTYPES = (("off", torch.int64), ("starts", torch.int32),
           ("lasts", torch.int32), ("bit_off", torch.int64),
           ("words", torch.uint32))


def _lib() -> ctypes.CDLL:
    lib = load("ri_and")
    if lib.ri_trichotomy_launch.argtypes is None:
        lib.ri_trichotomy_launch.argtypes = (
            [_P] * 10 + [ctypes.c_int, _P, _P, ctypes.c_int64, _P, _P])
        lib.ri_trichotomy_launch.restype = ctypes.c_int
    return lib


def _check_store(name: str, st: RIStoreTensors, dev: torch.device) -> None:
    for field, dtype in _DTYPES:
        t = getattr(st, field)
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"{name}.{field}: expected 1-D {dtype}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}.{field}: on {t.device}, rows on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}.{field}: must be contiguous")
    n_int = st.starts.numel()
    if st.off.numel() < 1 or st.lasts.numel() != n_int \
            or st.bit_off.numel() != n_int + 1 or st.words.numel() < 1:
        raise ValueError(
            f"{name}: expected off [P+1], starts/lasts [I], bit_off [I+1] and "
            f"at least the pad word, got {st.off.numel()}, {n_int}, "
            f"{st.lasts.numel()}, {st.bit_off.numel()}, {st.words.numel()}")


def ri_trichotomy(x: RIStoreTensors, y: RIStoreTensors, ri: torch.Tensor,
                  si: torch.Tensor, xor_y: bool) -> torch.Tensor:
    """[N] int8 RI verdicts (0 TRUE_NEG / 1 TRUE_HIT / 2 INDECISIVE) of pair
    rows (ri[n], si[n]) of stores X and Y; ``xor_y`` re-encodes Y's codes
    (the two stores share an encoding)."""
    dev = ri.device
    _check_store("x", x, dev)
    _check_store("y", y, dev)
    _check_rows(ri, x, "ri")
    _check_rows(si, y, "si")
    if ri.shape != si.shape:
        raise ValueError("ri and si must have the same length")
    if dev.type == "cpu":
        return ri_trichotomy_plain(x, y, ri, si, bool(xor_y))
    _cuda_device(dev, "ri_trichotomy")
    n = ri.numel()
    out = torch.empty(n, dtype=torch.int8, device=dev)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for st in (x, y) for t in st]
    rc = _lib().ri_trichotomy_launch(
        *ptrs, int(bool(xor_y)), ri.data_ptr(), si.data_ptr(), n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "ri_trichotomy")
    ri_trichotomy.launches += 1
    return out


ri_trichotomy.launches = 0
