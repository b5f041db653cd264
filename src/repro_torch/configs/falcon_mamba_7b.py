"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free
[arXiv:2410.05355; unverified]."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_head=64,
    d_ff=0, vocab=65024, block_pattern=("ssm",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,
)

SMOKE_CONFIG = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_head=16,
    d_ff=0, vocab=512, block_pattern=("ssm",),
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    supports_long_context=True,
)
