"""Serving steps: prefill (full forward) and single-token decode with
stacked KV caches / recurrent states (the reference's ``models/serve.py``).

The steps run eagerly under ``torch.no_grad``; their batch entries
(numpy arrays, ints or tensors) are moved to the step's device.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ModelConfig
from .model import build_caches, forward_logits, run_encoder, set_cache_pos


def _ctx(params, cfg: ModelConfig, batch, dev):
    if cfg.encoder is not None:
        return run_encoder(params, torch.as_tensor(batch["frames"], device=dev),
                           cfg)
    if cfg.n_patch_tokens:
        return torch.as_tensor(batch["patches"], device=dev)
    return None


def make_prefill_step(cfg: ModelConfig, *, device=None):
    """prefill_step(params, batch) -> last-position logits [B, V] (f32).

    batch: {'tokens': [B, S], optional 'frames'/'patches' ctx}. ``device``
    (``None`` -> the card) is where the batch goes; params must live there.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch):
        ctx = _ctx(params, cfg, batch, dev)
        logits, _, _ = forward_logits(
            params, torch.as_tensor(batch["tokens"], device=dev), cfg,
            ctx=ctx)
        return logits[:, -1, :]
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, device=None):
    """decode_step(params, caches, batch) -> (logits [B, V], new_caches).

    batch: {'tokens': [B, 1], 'pos': scalar or [B] int (current KV length
    per slot), optional 'frames'/'patches' ctx}. The whisper encoder reruns
    at every step, as in the reference.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def decode_step(params, caches, batch):
        ctx = _ctx(params, cfg, batch, dev)
        pos = torch.as_tensor(batch["pos"], device=dev).to(torch.int32)
        caches = set_cache_pos(caches, pos)
        logits, new_caches, _ = forward_logits(
            params, torch.as_tensor(batch["tokens"], device=dev), cfg,
            ctx=ctx, caches=caches, pos_offset=pos)
        return logits[:, 0, :], new_caches
    return decode_step


def greedy_generate(params, cfg: ModelConfig, prompt, steps: int,
                    ctx_capacity: int | None = None, batch_extra=None, *,
                    device=None):
    """Host-loop greedy decoding: prefill via repeated decode for
    simplicity. prompt: [B, S0] ints; returns [B, steps] int64 on
    ``device`` (``None`` -> the card)."""
    dev = resolve_device(device)
    toks = torch.as_tensor(prompt, device=dev).long()
    B, S0 = toks.shape
    cap = ctx_capacity or (S0 + steps)
    caches = build_caches(cfg, B, cap, dtype=torch.float32, device=dev)
    decode = make_decode_step(cfg, device=dev)
    out = []
    for t in range(S0 + steps - 1):
        batch = {"tokens": toks[:, t: t + 1], "pos": t}
        if batch_extra:
            batch.update(batch_extra)
        logits, caches = decode(params, caches, batch)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        if t >= S0 - 1:
            out.append(nxt)
            toks = torch.cat([toks, nxt], dim=1)
    return torch.cat(out, dim=1) if out else \
        torch.zeros((B, 0), dtype=torch.long, device=dev)
