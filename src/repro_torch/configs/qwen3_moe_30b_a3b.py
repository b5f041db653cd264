"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936, block_pattern=("attn",), act="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=64, vocab=512, block_pattern=("attn",), act="swiglu",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
)
