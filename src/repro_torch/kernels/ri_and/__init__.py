"""The RI filter's ALIGNEDAND: CUDA kernel, wrapper and plain PyTorch
version."""
from .ops import ri_trichotomy  # noqa: F401
from .ref import (RIStoreTensors, aligned_and_plain,  # noqa: F401
                  pack_bits_u32, pack_stream_words, ri_fragments_plain,
                  ri_trichotomy_plain, xor_mask_words)
