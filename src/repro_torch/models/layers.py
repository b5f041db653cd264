"""Transformer building blocks on tensors (the reference's ``models/layers.py``).

Conventions, as in the reference:
  * a block's parameters are a mapping of tensors (an ``nn.ParameterDict``
    in the model, or a plain dict), in the reference's layout: matrices are
    ``[in, out]`` and a projection is ``x @ w``;
  * activations are [B, S, D]; attention folds heads internally;
  * init functions draw from an explicit ``torch.Generator`` on the device
    the tensors are made on.

Attention is plain PyTorch ops that mirror the reference's einsums line for
line (no fused attention): scale folded into Q, scores in f32, optional tanh
softcap before the mask, masked scores set to ``NEG_INF``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking


def _init(gen: torch.Generator, shape, scale=None, dtype=torch.float32):
    if gen.device.type == "meta":       # shapes only (``init_model``)
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def gelu(x):
    """The reference's ``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------- norms/rope

def rmsnorm_init(d, device=None):
    return {"w": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["w"]
    return out.to(x.dtype)


def rope(x, pos, theta):
    """x: [B, S, H, Dh]; pos: [S] (shared) or [B, S] (per-slot decode).
    Rotates the two halves of each head."""
    B, S, H, Dh = x.shape
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    pos = torch.as_tensor(pos, device=x.device).to(torch.float32)
    if pos.ndim == 1:
        pos = pos[None, :]                                # [1, S]
    angles = pos[..., None] * freqs                       # [B', S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

def attention_init(gen, cfg: ModelConfig, cross: bool = False):
    d, dh = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _init(gen, (d, H * dh)),
        "wk": _init(gen, (d, KV * dh)),
        "wv": _init(gen, (d, KV * dh)),
        "wo": _init(gen, (H * dh, d), scale=1.0 / np.sqrt(H * dh)),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((n * dh,), dtype=torch.float32,
                                  device=gen.device)
    return p


def scalar(value, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a product with it
    equals the reference's product with ``jnp.asarray(value, dtype)``, and
    nothing is copied to the device."""
    return float(torch.tensor(value, dtype=dtype))


def attention(p, x, cfg: ModelConfig, *, kind: str, pos_offset=0,
              cache=None, ctx=None, mask_mode="causal"):
    """Self- or cross-attention.

    kind: 'attn' (full) | 'local' (sliding window) — mask choice.
    cache: optional dict {k, v, pos} for decode; k/v are [B, KV, C, dh] with
    C = context capacity (ring buffer of size `local_window` for local
    layers). ctx: [B, T, D] cross-attention context (kind ignored, bidir).
    Returns (out [B, S, D], new_cache); the new cache holds new tensors.
    """
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    src = ctx if ctx is not None else x
    q = x @ p["wq"].to(x.dtype)
    k = src @ p["wk"].to(x.dtype)
    v = src @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, k.shape[1], KV, dh)
    v = v.reshape(B, v.shape[1], KV, dh)

    is_cross = ctx is not None
    pos_vec = pos_offset if isinstance(pos_offset, int) \
        else torch.as_tensor(pos_offset, device=dev)
    per_slot = not isinstance(pos_vec, int) and pos_vec.ndim == 1  # [B]
    ar_s = torch.arange(S, device=dev)
    if not is_cross:
        qpos = pos_vec[:, None] + ar_s[None, :] if per_slot \
            else pos_vec + ar_s
        q = rope(q, qpos, cfg.rope_theta)
        k = rope(k, qpos, cfg.rope_theta)

    # chunked/banded path (A-interval restriction; training & prefill only)
    qc = cfg.attn_q_chunk
    if (qc and cache is None and not is_cross and mask_mode == "causal"
            and S > qc and S % qc == 0):
        out = _chunked_attention(q, k, v, cfg, kind, qc, x.dtype)
        return out @ p["wo"].to(x.dtype), None

    new_cache = None
    if cache is not None and not is_cross:
        # decode (S == 1): write k/v at each slot's own position
        C = cache["k"].shape[2]
        cur = torch.broadcast_to(torch.as_tensor(cache["pos"], device=dev),
                                 (B,))
        slot = torch.remainder(cur, C) if kind == "local" \
            else torch.clamp(cur, 0, C - 1)
        idx = (torch.arange(B, device=dev)[:, None],
               torch.arange(KV, device=dev)[None, :], slot[:, None].long())
        k_c = cache["k"].index_put(idx, k[:, 0].to(cache["k"].dtype))
        v_c = cache["v"].index_put(idx, v[:, 0].to(cache["v"].dtype))
        new_cache = {"k": k_c, "v": v_c, "pos": cache["pos"] + S}
        k = k_c.transpose(1, 2)
        v = v_c.transpose(1, 2)
        Tk = C
    else:
        Tk = k.shape[1]

    # heads: group queries over kv heads (GQA: query head h reads kv head
    # h // (H // KV)); scale folded into Q
    group = H // KV
    q = q.reshape(B, S, KV, group, dh) * scalar(1.0 / np.sqrt(dh), q.dtype)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)

    if is_cross or mask_mode == "bidir":
        mask = torch.ones((1, S, Tk), dtype=torch.bool, device=dev)
    elif cache is not None:
        # decode: key slot t holds absolute position (ring-aware), per slot
        tpos = torch.arange(Tk, device=dev)[None, :]          # [1, Tk]
        cur = torch.broadcast_to(torch.as_tensor(cache["pos"], device=dev),
                                 (B,))[:, None]
        if kind == "local":
            # ring buffer: slot t holds position p with p % C == t, the
            # latest such p <= cur
            abs_pos = cur - torch.remainder(cur - tpos, Tk)
            mask = (abs_pos >= 0) & (abs_pos > cur - cfg.local_window)
        else:
            mask = tpos <= cur
        mask = mask[:, None, :]                               # [B, 1(S), Tk]
    else:
        qp = (pos_vec[:, None, None] + ar_s[None, :, None]) if per_slot \
            else (pos_vec + ar_s)[None, :, None]
        kp = torch.arange(Tk, device=dev)[None, None, :]
        mask = kp <= qp
        if kind == "local":
            mask = mask & (kp > qp - cfg.local_window)        # [B', S, Tk]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    out = out.reshape(B, S, H * dh)
    return out @ p["wo"].to(x.dtype), new_cache


def _chunked_attention(q, k, v, cfg: ModelConfig, kind: str, q_chunk: int,
                       dtype):
    """Query-chunked causal/local attention with static K/V band slicing:
    per query chunk only the KV range the mask can reach is read — [0,
    chunk_end) for causal, the sliding-window band for local."""
    B, S, KV, dh = k.shape[0], k.shape[1], cfg.n_kv_heads, cfg.head_dim
    H = cfg.n_heads
    dev = q.device
    q = q.reshape(B, S, KV, H // KV, dh) * scalar(1.0 / np.sqrt(dh),
                                                   q.dtype)
    outs = []
    for ci in range(S // q_chunk):
        lo_q = ci * q_chunk
        hi_q = lo_q + q_chunk
        lo_k = max(0, hi_q - cfg.local_window - q_chunk + 1) \
            if kind == "local" else 0
        s = torch.einsum("bskgh,btkh->bkgst", q[:, lo_q:hi_q],
                         k[:, lo_k:hi_q]).float()
        if cfg.attn_softcap is not None:
            s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
        qp = lo_q + torch.arange(q_chunk, device=dev)[:, None]
        kp = lo_k + torch.arange(hi_q - lo_k, device=dev)[None, :]
        mask = kp <= qp
        if kind == "local":
            mask &= kp > qp - cfg.local_window
        s = torch.where(mask[None, None, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1).to(dtype)
        outs.append(torch.einsum("bkgst,btkh->bskgh", pr, v[:, lo_k:hi_q]))
    return torch.cat(outs, dim=1).reshape(B, S, H * dh)


# ----------------------------------------------------------------- MLP

def mlp_init(gen, cfg: ModelConfig, d_ff=None):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    w1 = _init(gen, (d, f))
    if cfg.act in ("swiglu", "geglu"):
        w3 = _init(gen, (d, f))
        return {"w1": w1, "w3": w3,
                "w2": _init(gen, (f, d), scale=1.0 / np.sqrt(f))}
    return {"w1": w1, "w2": _init(gen, (f, d), scale=1.0 / np.sqrt(f))}


def mlp(p, x, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    elif cfg.act == "geglu":
        h = gelu(x @ p["w1"].to(x.dtype)) * (x @ p["w3"].to(x.dtype))
    else:  # 'gelu'
        h = gelu(x @ p["w1"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)
