"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

The audio conv frontend is a STUB per the assignment: input_specs() feeds
precomputed frame embeddings [B, 1500, d_model] to the encoder; every
decoder layer cross-attends the encoder output.
"""
from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab=51865, block_pattern=("xattn",), act="gelu",
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-small-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=128, vocab=512, block_pattern=("xattn",), act="gelu",
    encoder=EncoderConfig(n_layers=2, n_frames=32),
)
