"""gemma2-2b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab=256000,
    block_pattern=("local", "attn"), local_window=4096,
    attn_softcap=50.0, logit_softcap=30.0, act="geglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma2-2b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, block_pattern=("local", "attn"), local_window=16,
    attn_softcap=50.0, logit_softcap=30.0, act="geglu", tie_embeddings=True,
)
