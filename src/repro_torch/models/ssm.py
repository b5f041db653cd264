"""Mamba-1 selective SSM block (the reference's ``models/ssm.py``,
falcon-mamba-7b architecture).

Recurrence h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ; y_t = C_t h_t + D x.
The full-sequence path is a log-depth scan of the diagonal recurrence
(``linear_scan``, the counterpart of ``jax.lax.associative_scan``); decode
keeps (conv window, state) as explicit carry, O(1) per token.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _init


def ssm_init(gen, cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dt_rank = max(1, int(np.ceil(d / 16)))
    dev = gen.device
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    return {
        "in_proj": _init(gen, (d, 2 * di)),
        "conv_w": _init(gen, (s.d_conv, di), scale=0.2),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": _init(gen, (di, dt_rank + 2 * s.d_state)),
        "dt_proj": _init(gen, (dt_rank, di), scale=0.1),
        "dt_bias": torch.full((di,), -4.0, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _init(gen, (di, d)),
    }


def linear_scan(a, u):
    """h_t = a_t * h_{t-1} + u_t along dim 1 from h_{-1} = 0, for every t:
    the inclusive scan of the combine (a1, u1), (a2, u2) -> (a1 a2,
    u1 a2 + u2), in log2(S) doubling steps (Hillis-Steele)."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        u = torch.cat([u[:, :shift], u[:, :-shift] * a[:, shift:]
                       + u[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return u


def _causal_conv(x, w, b, state=None):
    """x: [B, S, DI]; w: [K, DI] depthwise causal conv.
    state: [B, K-1, DI] previous inputs for decode. Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(K))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return y, new_state


def ssm_block(p, x, cfg: ModelConfig, state=None, split=None):
    """x: [B, S, D]. state: None (full sequence) or dict {h: [B,DI,N],
    conv: [B,K-1,DI]}. Returns (y [B,S,D], new_state).

    split: a ``parallel._Sharding`` whose ``model`` axis splits the DI
    channels, ``p`` and ``state`` holding this rank's shards under
    ``param_specs`` / ``cache_specs``; None runs the whole block."""
    s = cfg.ssm
    N = s.d_state
    dt_rank = p["dt_proj"].shape[0]

    if split is None:
        xz = x @ p["in_proj"].to(x.dtype)               # [B,S,2DI]
        xi, z = torch.chunk(xz, 2, dim=-1)
    else:
        # in_proj's [xi | z] columns are split as one block: gather them
        # and take this rank's channels of each half
        w = split.gather_sum(p["in_proj"], 1).to(x.dtype)
        DI, c = w.shape[1] // 2, p["conv_b"].shape[0]
        lo = split.r * c
        x = split.copy(x)
        xi = x @ w[:, lo: lo + c]
        z = x @ w[:, DI + lo: DI + lo + c]
    conv_state = state["conv"] if state is not None else None
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    xi = F.silu(xi)

    proj = xi @ p["x_proj"].to(x.dtype)                 # [B,S,dt_rank+2N]
    if split is not None:                 # x_proj's rows are split
        proj = split.copy(split.reduce(proj))
    dt = proj[..., :dt_rank] @ p["dt_proj"].to(x.dtype) \
        + p["dt_bias"].to(x.dtype)
    dt = F.softplus(dt.float())                         # [B,S,DI]
    Bm = proj[..., dt_rank: dt_rank + N].float()        # [B,S,N]
    Cm = proj[..., dt_rank + N:].float()                # [B,S,N]

    A = -torch.exp(p["A_log"])                          # [DI,N]
    decay = torch.exp(dt[..., None] * A[None, None])    # [B,S,DI,N]
    drive = (dt * xi.float())[..., None] * Bm[:, :, None, :]

    if state is None:
        h = linear_scan(decay, drive)                   # [B,S,DI,N]
        y = torch.einsum("bsdn,bsn->bsd", h, Cm)
        new_h = None
    else:
        h = decay[:, 0] * state["h"] + drive[:, 0]      # [B,DI,N] f32
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        new_h = h
    y = y + xi.float() * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"].to(x.dtype)
    if split is not None:
        out = split.reduce(out)
    new_state = None if state is None else {"h": new_h, "conv": new_conv}
    return out, new_state


def ssm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, lead=()):
    """Zero decode state; ``lead`` prefixes every shape (stacked layers)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"h": torch.zeros(lead + (batch, di, s.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, s.d_conv - 1, di), dtype=dtype,
                                device=device)}
