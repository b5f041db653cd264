"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10_000,
                    min_ratio=0.1):
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``min_ratio``
    of it at ``total``. ``step``: a tensor or a Python int; returns an f32
    tensor of its shape (on its device), with the reference's f32
    arithmetic."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp_max(t / warmup, 1.0)
    prog = torch.clamp((t - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup, warm, cos)
