"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_head=64,
    d_ff=1536, vocab=49152, block_pattern=("attn",), act="swiglu",
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-135m-smoke", family="dense",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_head=16,
    d_ff=96, vocab=512, block_pattern=("attn",), act="swiglu",
    tie_embeddings=True,
)
