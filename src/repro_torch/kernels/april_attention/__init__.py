"""APRIL block-sparse flash attention (the mask's Full/Partial/Empty
blocks as APRIL's A/F intervals): CUDA kernels (bf16 on the tensor cores,
f32 on the CUDA cores), wrapper and plain PyTorch version."""
from .ops import (april_attention, april_attention_blocks,  # noqa: F401
                  build_block_intervals, kernel_attrs)
from .ref import (ROW_REL_TOL, TEST_GRID, TEST_TOL,  # noqa: F401
                  april_attention_plain, april_attention_ref, dense_mask,
                  row_rel_err)
