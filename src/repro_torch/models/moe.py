"""Capacity-based top-k Mixture-of-Experts layer (the reference's
``models/moe.py``, GShard/Switch style).

Dispatch is sort-based: token->expert assignments are stably argsorted by
expert id, each assignment's rank within its expert comes from
``searchsorted`` over the sorted ids, tokens are scattered into an [E, C, D]
buffer (``index_add_``), the experts run as one batched einsum, and results
are gathered back with a gate-weighted combine. Assignments beyond capacity
C go to a sink row and are dropped; the router adds Switch's
load-balancing auxiliary loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _init


def moe_init(gen, cfg: ModelConfig):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    return {
        "router": _init(gen, (d, E), scale=0.02),
        "w1": _init(gen, (E, d, f)),
        "w3": _init(gen, (E, d, f)),
        "w2": _init(gen, (E, f, d), scale=1.0 / np.sqrt(f)),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(np.ceil(n_tokens * m.top_k * m.capacity_factor / m.num_experts))
    return max(8, ((c + 7) // 8) * 8)   # sublane-aligned


def _group_add(n_rows: int, idx, vals):
    """Per group g, rows ``idx[g]`` of a zero [G, n_rows, D] buffer summed
    from ``vals[g]`` (one ``index_add_`` over the flattened groups)."""
    G, N, D = vals.shape
    base = torch.arange(G, device=vals.device)[:, None] * n_rows
    out = torch.zeros((G * n_rows, D), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (idx + base).reshape(-1), vals.reshape(G * N, D))
    return out.reshape(G, n_rows, D)


def moe_mlp(p, x, cfg: ModelConfig):
    """x: [B, S, D] -> ([B, S, D], aux_loss scalar).

    With ``dispatch_groups = G > 1`` tokens are ranked and scattered within
    G independent groups: the dispatch buffer becomes [G, E, C/G, D].
    """
    buf, route, aux = moe_dispatch(p, x, cfg)
    y = moe_experts(buf, p["w1"], p["w3"], p["w2"])
    return moe_combine(y, route, x.shape), aux


def moe_dispatch(p, x, cfg: ModelConfig):
    """The router, its aux loss and the scatter of ``x`` [B, S, D] into
    the [G, E, C, D] expert buffer: (buf, route, aux), ``route`` being
    what ``moe_combine`` needs."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    G = max(1, m.dispatch_groups)
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} dispatch groups")
    Tl = T // G
    C = moe_capacity(cfg, Tl)
    dev = x.device

    xg = x.reshape(G, Tl, D)
    logits = xg.float() @ p["router"].float()                      # [G,Tl,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1, sorted=True)  # [G,Tl,K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # aux load-balancing loss (Switch): E * sum_e f_e * p_e  (global)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones((T * K,), dtype=torch.float32, device=dev)) / (T * K)
    aux = m.router_aux_weight * E * torch.sum(me * ce)

    # per group: sort assignments by expert; rank within (group, expert)
    flat_e = gate_idx.reshape(G, Tl * K)
    flat_t = torch.arange(Tl, device=dev).repeat_interleave(K)[None] \
        .expand(G, Tl * K)
    flat_g = gate_vals.reshape(G, Tl * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sg = torch.gather(flat_g, 1, order)
    first = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, E).contiguous(),
        side="left")                                               # [G,E]
    rank = torch.arange(Tl * K, device=dev)[None] - torch.gather(first, 1, se)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)   # overflow -> sink row

    gathered = torch.gather(xg, 1, st[..., None].expand(G, Tl * K, D))
    gathered = gathered * keep[..., None].to(x.dtype)
    buf = _group_add(E * C + 1, slot, gathered)[:, :-1].reshape(G, E, C, D)
    return buf, (slot, st, sg, keep), aux


def moe_experts(buf, w1, w3, w2):
    """The swiglu experts over the buffer [G, E, C, D] (the weights'
    leading dimension is E's)."""
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, w1.to(buf.dtype))) \
        * torch.einsum("gecd,edf->gecf", buf, w3.to(buf.dtype))
    return torch.einsum("gecf,efd->gecd", h, w2.to(buf.dtype))


def moe_combine(y, route, shape):
    """Each kept assignment's expert output, weighted by its gate, summed
    back to its token: [B, S, D] of ``shape``."""
    slot, st, sg, keep = route
    G, E, C, D = y.shape
    Tl = shape[0] * shape[1] // G
    yf = y.reshape(G, E * C, D)
    contrib = torch.gather(
        yf, 1, torch.clamp_max(slot, E * C - 1)[..., None].expand(
            G, slot.shape[1], D))
    contrib = contrib * (sg * keep.float())[..., None].to(y.dtype)
    out = _group_add(Tl, st, contrib)
    return out.reshape(shape)
