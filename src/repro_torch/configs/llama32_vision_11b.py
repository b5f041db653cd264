"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40 decoder layers with a cross-attention layer every 5th position; the
vision tower is a STUB per the assignment: input_specs() provides
precomputed patch embeddings [B, n_patch_tokens, d_model].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=128256,
    block_pattern=("attn", "attn", "attn", "xattn", "attn"),
    rope_theta=500000.0, act="swiglu", n_patch_tokens=1600,
)

SMOKE_CONFIG = ModelConfig(
    name="llama-3.2-vision-11b-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512,
    block_pattern=("attn", "attn", "attn", "xattn", "attn"),
    act="swiglu", n_patch_tokens=16,
)
