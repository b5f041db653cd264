"""The language-model stack of the port, in PyTorch: the transformer, SSM
and MoE blocks of the 10 configurations, the model assembly and the serving
steps. A model is an ``nn.Module`` with one submodule per layer
(``models/model.py``); ``models/convert.py`` carries the reference's
parameter trees across.
"""
from .config import ModelConfig, MoEConfig, SSMConfig, EncoderConfig  # noqa: F401
from .model import init_model, forward_logits  # noqa: F401
