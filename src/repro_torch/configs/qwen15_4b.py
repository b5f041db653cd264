"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_head=128,
    d_ff=6912, vocab=151936, block_pattern=("attn",),
    qkv_bias=True, act="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512, block_pattern=("attn",), qkv_bias=True, act="swiglu",
)
