"""Wrapper of the APRIL block-sparse attention kernels and the interval
tables that steer them.

:func:`build_block_intervals` is the APRIL A/F classification of the
(q block x kv block) raster of the mask. :func:`april_attention_blocks`
takes a table and checks its tensors, then dispatches on their device: on
the CPU it runs the plain PyTorch version (``ref.py``) at any dtype, head
width and block size the reference takes; on a CUDA device it launches, on
the current stream, the kernel of the tensors' dtype, or raises: bf16 runs
on the tensor cores (``csrc/april_attention_tc.cu``, wgmma fed by TMA),
f32 on the CUDA cores (``csrc/april_attention.cu``, register-tiled, K and
V by cp.async), and only at the head widths and q blocks they are built
for. There is no fallback from one to another. Kernel launches are
counted in ``april_attention_blocks.launches``, one a call.
:func:`april_attention` builds the table for a mask and runs it the same
way, checking q, k and v once. :func:`kernel_attrs` reads either kernel's
registers, spills and shared memory.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ...device import upload
from .._build import load
from ..interval_join.ops import _cuda_device, _raise_on
from .ref import MASK_KINDS, april_attention_plain

__all__ = ["build_block_intervals", "april_attention_blocks",
           "april_attention", "kernel_attrs", "HEAD_DIMS", "BLOCK_QS",
           "KV_CHUNK", "KV_TILES"]

_P = ctypes.c_void_p

#: head widths and q-block heights the kernels are built for, and the
#: tensor-core kernel's smallest kv tile (on the card block_kv must be a
#: multiple of it); the plain version takes any of them
HEAD_DIMS = (32, 64, 128, 256)
BLOCK_QS = (64, 128)
KV_CHUNK = 32
#: the tensor-core kernel's kv tiles: 128 keys where D <= 128 and block_kv
#: is a multiple of 128, else 64 where it is a multiple of 64, else 32
KV_TILES = (128, 64, 32)
_DTYPES = (torch.float32, torch.bfloat16)
#: both kernels' launch: q, k, v, table, out; BH, Sq, Skv, D; block_q,
#: block_kv; scale, has_softcap, softcap, mask_kind, window; stream
_LAUNCH_ARGS = ([_P] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_int] * 2
                + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, _P])


def build_block_intervals(Sq: int, Skv: int, block_q: int, block_kv: int,
                          mask_kind: str, window: int = 0) -> np.ndarray:
    """[nq, 4] int32 rows (a_lo, f_lo, f_hi, a_hi) in kv-block units.

    Exactly the APRIL construction on the (q_block x kv_block) raster:
    a 'cell' (block) is Full iff every (q, k) position it covers is allowed,
    Partial iff some are, Empty otherwise. For causal/local masks the three
    classes form contiguous runs per row, so one A- and one F-interval
    suffice (the general case would carry lists, as in the paper).
    """
    nq = Sq // block_q
    nk = Skv // block_kv
    out = np.zeros((nq, 4), np.int32)
    for qi in range(nq):
        q_lo = qi * block_q
        q_hi = q_lo + block_q - 1         # inclusive
        if mask_kind == "causal":
            lo_pos, hi_pos = 0, q_hi
            full_lo_pos, full_hi_pos = 0, q_lo  # kpos <= q_lo - 1 + 1
        elif mask_kind == "local":
            lo_pos = max(0, q_lo - window + 1)
            hi_pos = q_hi
            full_lo_pos = max(0, q_hi - window + 1)
            full_hi_pos = q_lo
        else:  # full attention
            lo_pos, hi_pos = 0, Skv - 1
            full_lo_pos, full_hi_pos = 0, Skv
        a_lo = lo_pos // block_kv
        a_hi = min(nk, hi_pos // block_kv + 1)
        # Full blocks: fully contained in [full_lo_pos, full_hi_pos)
        f_lo = (full_lo_pos + block_kv - 1) // block_kv
        f_hi = max(f_lo, full_hi_pos // block_kv)
        f_lo = max(f_lo, a_lo)
        f_hi = min(f_hi, a_hi)
        if f_hi <= f_lo:
            f_lo = f_hi = a_lo            # empty F-run
        out[qi] = (a_lo, f_lo, f_hi, a_hi)
    return out


@lru_cache(maxsize=64)
def _intervals(Sq, Skv, block_q, block_kv, mask_kind, window) -> np.ndarray:
    """The table of one shape key, built once; callers do not write it."""
    return build_block_intervals(Sq, Skv, block_q, block_kv, mask_kind,
                                 window)


def _launcher(dtype: torch.dtype):
    """The launch function of ``dtype``'s kernel, its ctypes bound."""
    if dtype == torch.bfloat16:
        fn = load("april_attention_tc").april_attention_tc_launch
    else:
        fn = load("april_attention").april_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _LAUNCH_ARGS
        fn.restype = ctypes.c_int
    return fn


def kernel_attrs(dtype: torch.dtype = torch.bfloat16) -> dict:
    """Registers a thread, local (spill) bytes a thread and dynamic shared
    memory bytes of every instance of ``dtype``'s kernel, as
    ``cudaFuncGetAttributes`` reads them on the card: the tensor-core
    (bf16) kernel's keyed by (D, block_q, kv tile keys), the CUDA-core (f32)
    kernel's by (D, block_q)."""
    if dtype not in _DTYPES:
        raise TypeError(f"kernel_attrs: float32 or bfloat16, got {dtype}")
    tc = dtype == torch.bfloat16
    fn = (load("april_attention_tc").april_attention_tc_attrs if tc
          else load("april_attention").april_attention_attrs)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int64, ctypes.c_int]
                       + [ctypes.c_int] * tc + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    # kv tiles of 128 keys are not built at D 256: no room for them
    keys = ([(D, bq, kt) for D in HEAD_DIMS for bq in BLOCK_QS
             for kt in KV_TILES if kt < 128 or D <= 128] if tc
            else [(D, bq) for D in HEAD_DIMS for bq in BLOCK_QS])
    out = {}
    for key in keys:
        buf = (ctypes.c_int * 3)()
        _raise_on(fn(*key, buf), "kernel_attrs")
        out[key] = dict(zip(("regs", "spill_bytes", "smem_bytes"), buf))
    return out


def _check_qkv(q, k, v, block_q, block_kv, mask_kind) -> None:
    """What every device takes: [BH, S, D] tensors of one dtype on one
    device, blocks that divide S, a known mask. The kernels' own limits
    are :func:`_check_kernel_shapes`, for CUDA tensors."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name}: expected [BH, S, D], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, q is "
                            f"{q.dtype} on {q.device}")
    if not q.is_floating_point():
        raise TypeError(f"q, k, v: a floating dtype, got {q.dtype}")
    BH, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"k and v must be [BH, Skv, D] with q's BH and D: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    Skv = k.shape[1]
    if block_q <= 0 or block_kv <= 0 or Sq % block_q or Skv % block_kv:
        raise ValueError(f"Sq {Sq} and Skv {Skv} must be multiples of "
                         f"block_q {block_q} and block_kv {block_kv}")
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"mask_kind: one of {MASK_KINDS}, got {mask_kind!r}")


def _check_kernel_shapes(q, block_q, block_kv) -> None:
    """The CUDA kernels' limits: the dtypes, head widths and q blocks they
    are built for, kv blocks in whole 32-key tiles."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q, k, v: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    D = q.shape[2]
    if D not in HEAD_DIMS or block_q not in BLOCK_QS or block_kv % KV_CHUNK:
        raise ValueError(f"the kernels take D in {HEAD_DIMS}, block_q in "
                         f"{BLOCK_QS} and block_kv a multiple of {KV_CHUNK}; "
                         f"got D {D}, block_q {block_q}, block_kv {block_kv}")


def _check_table(q, intervals, block_q) -> None:
    Sq = q.shape[1]
    if intervals.dtype != torch.int32 \
            or tuple(intervals.shape) != (Sq // block_q, 4) \
            or not intervals.is_contiguous():
        raise ValueError(f"intervals: contiguous [{Sq // block_q}, 4] int32, "
                         f"got {intervals.dtype} {tuple(intervals.shape)}")
    if intervals.device != q.device:
        raise ValueError(f"intervals: on {intervals.device}, q on {q.device}")


def april_attention_blocks(q, k, v, intervals, *, scale=None, block_q=128,
                           block_kv=128, mask_kind="causal", window=0,
                           softcap=None) -> torch.Tensor:
    """[BH, Sq, D] in q's dtype: attention of q [BH, Sq, D] over k/v [BH,
    Skv, D] (float32 or bfloat16) that visits, for q block ``qi``, the kv
    blocks ``[a_lo, a_hi)`` of row ``qi`` of ``intervals`` ([nq, 4] int32,
    (a_lo, f_lo, f_hi, a_hi)) and masks those outside ``[f_lo, f_hi)``."""
    _check_qkv(q, k, v, block_q, block_kv, mask_kind)
    _check_table(q, intervals, block_q)
    return _run(q, k, v, intervals, scale, block_q, block_kv, mask_kind,
                window, softcap)


def _run(q, k, v, intervals, scale, block_q, block_kv, mask_kind, window,
         softcap) -> torch.Tensor:
    """:func:`april_attention_blocks` on checked tensors."""
    scale = float(scale) if scale is not None else 1.0 / q.shape[2] ** 0.5
    softcap = None if softcap is None else float(softcap)
    dev = q.device
    if dev.type == "cpu":
        return april_attention_plain(
            q, k, v, intervals, scale=scale, block_q=block_q,
            block_kv=block_kv, mask_kind=mask_kind, window=window,
            softcap=softcap)
    _cuda_device(dev, "april_attention")
    _check_kernel_shapes(q, block_q, block_kv)
    BH, Sq, D = q.shape
    # the kernels read 16-byte vectors, and TMA (bf16) wants 16-byte
    # aligned bases and row pitches
    if any(t.data_ptr() % 16 for t in (q, k, v)) \
            or D * q.element_size() % 16:
        raise ValueError("q, k, v: the kernels read 16-byte aligned rows; "
                         "pass tensors that start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _launcher(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), intervals.data_ptr(),
        out.data_ptr(), BH, Sq, k.shape[1], D, block_q, block_kv, scale,
        int(softcap is not None), 0.0 if softcap is None else softcap,
        MASK_KINDS.index(mask_kind), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "april_attention")
    april_attention_blocks.launches += 1
    return out


april_attention_blocks.launches = 0


def april_attention(q, k, v, *, scale=None, block_q=128, block_kv=128,
                    mask_kind="causal", window=0, softcap=None):
    """Block-interval attention. q: [BH, Sq, D]; k/v: [BH, Skv, D]. Builds
    the mask's interval table, uploads it to q's device without a host
    sync, and runs it as :func:`april_attention_blocks` does."""
    _check_qkv(q, k, v, block_q, block_kv, mask_kind)
    Sq, Skv = q.shape[1], k.shape[1]
    iv = upload(_intervals(Sq, Skv, block_q, block_kv, mask_kind, window),
                q.device)
    return _run(q, k, v, iv, scale, block_q, block_kv, mask_kind, window,
                softcap)
