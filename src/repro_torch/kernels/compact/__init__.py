"""Stable front-pack of a bool lane (the fused chain's stage boundary):
CUDA kernel, wrapper and plain PyTorch version."""
from .ops import compact_mask  # noqa: F401
from .ref import compact_mask_plain  # noqa: F401
