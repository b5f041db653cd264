"""Architecture registry: the 10 model configurations, each with a
full-width ``CONFIG`` and a reduced ``SMOKE_CONFIG``, selectable via
``--arch <id>``."""
from __future__ import annotations

from . import (deepseek_coder_33b, falcon_mamba_7b, gemma2_2b,
               granite_moe_1b_a400m, llama32_vision_11b, qwen3_moe_30b_a3b,
               qwen15_4b, recurrentgemma_2b, smollm_135m, whisper_small)
from .shapes import SHAPES, input_specs, shape_skip_reason  # noqa: F401

ARCHS = {
    "deepseek-coder-33b": deepseek_coder_33b,
    "gemma2-2b": gemma2_2b,
    "qwen1.5-4b": qwen15_4b,
    "smollm-135m": smollm_135m,
    "recurrentgemma-2b": recurrentgemma_2b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "falcon-mamba-7b": falcon_mamba_7b,
    "whisper-small": whisper_small,
}


def get_config(arch: str, smoke: bool = False):
    mod = ARCHS[arch]
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
