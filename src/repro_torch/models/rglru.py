"""RG-LRU recurrent block (the reference's ``models/rglru.py``, Griffin /
recurrentgemma-2b).

Block = gated dual branch: GeLU(gate) ⊙ (conv1d -> RG-LRU), projected back.
RG-LRU: r_t = σ(W_r x), i_t = σ(W_i x), a_t = a^{c·r_t} with a = σ(Λ),
h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t). Diagonal recurrence:
a log-depth scan over the sequence, O(1) carry for decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _init, gelu
from .ssm import _causal_conv, linear_scan

C_COEF = 8.0


def rglru_init(gen, cfg: ModelConfig):
    d = cfg.d_model
    dr = cfg.d_model           # recurrent width = d_model
    dev = gen.device
    return {
        "in_x": _init(gen, (d, dr)),
        "in_g": _init(gen, (d, dr)),
        "conv_w": _init(gen, (4, dr), scale=0.2),
        "conv_b": torch.zeros((dr,), dtype=torch.float32, device=dev),
        "w_r": _init(gen, (dr, dr)),
        "w_i": _init(gen, (dr, dr)),
        "lam": torch.full((dr,), 2.0, dtype=torch.float32, device=dev),
        "out": _init(gen, (dr, d)),
    }


def rglru_block(p, x, cfg: ModelConfig, state=None, split=None):
    """x: [B, S, D]; state: None or {h: [B,DR] f32, conv: [B,3,DR]}.

    split: a ``parallel._Sharding`` whose ``model`` axis splits the DR
    channels, ``p`` and ``state`` holding this rank's shards under
    ``param_specs`` / ``cache_specs`` (the gates read every channel);
    None runs the whole block."""
    if split is not None:
        x = split.copy(x)
    g = gelu(x @ p["in_g"].to(x.dtype))
    xr = x @ p["in_x"].to(x.dtype)
    conv_state = state["conv"] if state is not None else None
    xr, new_conv = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)

    xr_all = xr if split is None else split.gather_sum(xr, 2)
    r = torch.sigmoid((xr_all @ p["w_r"].to(x.dtype)).float())
    i = torch.sigmoid((xr_all @ p["w_i"].to(x.dtype)).float())
    log_a = -C_COEF * F.softplus(p["lam"]) * r          # log a_t  [B,S,DR]
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * xr.float()

    if state is None:
        h = linear_scan(a, gated)
        new_h = None
    else:
        h = a[:, 0] * state["h"] + gated[:, 0]
        new_h = h
        h = h[:, None, :]
    y = (h.to(x.dtype) * g) @ p["out"].to(x.dtype)
    if split is not None:
        y = split.reduce(y)
    new_state = None if state is None else {"h": new_h, "conv": new_conv}
    return y, new_state


def rglru_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead=()):
    """Zero decode state; ``lead`` prefixes every shape (stacked layers)."""
    dr = cfg.d_model
    return {"h": torch.zeros(lead + (batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(lead + (batch, 3, dr), dtype=dtype,
                                device=device)}
