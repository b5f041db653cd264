"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2
[arXiv:2402.19427; hf].

26 layers follow Griffin's (R, R, A) blocks: eight scanned (R, R, A)
cycles plus an unscanned (R, R) tail — exactly the released model's layout
(18 recurrent : 8 local-attention layers).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    block_pattern=("rglru", "rglru", "local"), local_window=2048,
    act="geglu", tie_embeddings=True, supports_long_context=True,
)

# n_layers=5 = one scanned cycle + a 2-layer tail: exercises the tail path
SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
    d_ff=128, vocab=512, block_pattern=("rglru", "rglru", "local"),
    local_window=16, act="geglu", tie_embeddings=True,
    supports_long_context=True,
)
