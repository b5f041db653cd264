"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=19200, vocab=32256, block_pattern=("attn",),
    rope_theta=100000.0, act="swiglu",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, block_pattern=("attn",), act="swiglu",
)
