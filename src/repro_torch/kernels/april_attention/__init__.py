"""APRIL block-sparse flash attention (the mask's Full/Partial/Empty
blocks as APRIL's A/F intervals): CUDA kernel, wrapper and plain PyTorch
version."""
from .ops import (april_attention, april_attention_blocks,  # noqa: F401
                  build_block_intervals)
from .ref import (TEST_GRID, TEST_TOL, april_attention_plain,  # noqa: F401
                  april_attention_ref, dense_mask)
