"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, block_pattern=("attn",), act="swiglu",
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab=512, block_pattern=("attn",), act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    tie_embeddings=True,
)
