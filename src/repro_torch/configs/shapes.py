"""Assigned input shapes and abstract input specs: tensors on the ``meta``
device, which carry shape and dtype and allocate nothing."""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import build_caches

# name -> (seq_len, global_batch, mode)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

META = torch.device("meta")


def shape_skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    """Why a (arch, shape) cell is skipped, or None if it runs."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: 500k context is quadratic "
                "(run only for SSM/hybrid per assignment)")
    return None


def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: str, dtype=torch.bfloat16) -> dict:
    """Abstract model inputs for one (arch, shape) cell, on ``meta``.

    train: {'tokens', 'labels'} (+ 'frames'/'patches' stubs);
    prefill: {'tokens'} (+ ctx stubs);
    decode: {'tokens' [B,1], 'pos' scalar, 'caches' tree} (+ ctx stubs).
    """
    seq, batch, mode = SHAPES[shape]
    out: dict = {}
    if mode in ("train", "prefill"):
        out["tokens"] = _spec((batch, seq), torch.int32)
        if mode == "train":
            out["labels"] = _spec((batch, seq), torch.int32)
    else:
        out["tokens"] = _spec((batch, 1), torch.int32)
        out["pos"] = _spec((), torch.int32)
        out["caches"] = build_caches(cfg, batch, seq, dtype=dtype,
                                     device=META)
    # modality frontends are stubs: precomputed embeddings
    if cfg.encoder is not None:
        out["frames"] = _spec((batch, cfg.encoder.n_frames, cfg.d_model),
                              dtype)
    elif cfg.n_patch_tokens:
        out["patches"] = _spec((batch, cfg.n_patch_tokens, cfg.d_model),
                               dtype)
    return out
