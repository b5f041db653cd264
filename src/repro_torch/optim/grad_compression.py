"""Int8 error-feedback gradient compression (1-bit-Adam-family trick), the
reference's ``optim/grad_compression.py``.

Data-parallel gradient all-reduces dominate the interconnect's traffic at
scale. Quantizing gradients to int8 with a *shared* per-tensor scale and
error feedback (the residual carried to the next step) cuts the payloads
2-4x with no convergence loss in practice.

Protocol over a ``torch.distributed`` process group (the reference's
``shard_map`` axis):
  1. s = all_reduce_max(max|g + residual|) / 127   (one scalar all-reduce)
  2. q = clip(round((g + residual) / s))           (int8 payload)
  3. residual' = (g + residual) - q * s            (error feedback, local)
  4. sum = all_reduce_sum(q as int32) * s

The shared scale makes the reduction exact over the quantized values;
summing payloads quantized with per-rank scales is not. ``torch.round``
rounds half to even, as ``jnp.round`` does, so ``q`` equals the
reference's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_tree",
           "compressed_psum_ef"]


def quantize_int8(g, scale=None):
    """(int8 q, f32 scale): ``scale`` defaults to max|g| / 127."""
    scale = scale if scale is not None else \
        torch.clamp_min(g.abs().max(), 1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, torch.as_tensor(scale).to(torch.float32)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _pick(tree, i):
    """Item ``i`` of every tuple at a leaf of ``tree`` (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def ef_compress_tree(grads, residuals):
    """Local error-feedback compress (no collective): returns (quantized
    tree, scales, new residuals)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = quantize_int8(gf)
        return q, s, gf - dequantize_int8(q, s)

    out = tree_map(one, grads, residuals)
    return tuple(_pick(out, i) for i in range(3))


def compressed_psum_ef(grads, residuals, group=None):
    """Shared-scale int8 all-reduce with error feedback over the process
    ``group`` (``None``: the default group). Returns (summed f32 tree, new
    residuals)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        local_max = torch.clamp_min(gf.abs().max(), 1e-30)
        dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
        s = local_max / 127.0
        q = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
        new_r = gf - q.to(torch.float32) * s
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.to(torch.float32) * s, new_r

    out = tree_map(one, grads, residuals)
    return _pick(out, 0), _pick(out, 1)
