"""Model assembly: embedding -> layers -> head (the reference's
``models/model.py``).

The model is an ``nn.Module`` with one submodule per layer, in layer order
(``model.layers[l]``); the reference scans over parameters stacked per
pattern position, and layer ``c * period + i`` here is its cycle ``c`` of
``cycle/p{i}``, the layers past the last full cycle its ``tail/t{i}``.
Each layer is an ``nn.ModuleDict`` of ``nn.ParameterDict`` blocks keyed as
the reference's per-layer tree (``ln1``, ``attn``, ``mlp`` ...), so the
block functions take it as they take a dict.

Decode caches keep the reference's tree: ``{'cycle': {'p{i}': stacked
[n_cycles, ...]}, 'tail': {'t{i}': ...}}``.

Modes:
  prefill: full-sequence forward (no cache)
  decode:  one token, stacked KV caches / recurrent states
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..tree import tree_map, tree_stack
from .config import ModelConfig
from .layers import _init, attention_init, mlp_init, rmsnorm, \
    rmsnorm_init, scalar
from .moe import moe_init
from .parallel import _Gather, _Scatter, _Sharding, attention_block, \
    embed, mlp_block, moe_block, recurrent_block, rows, seq_parallel
from .rglru import rglru_block, rglru_init, rglru_state_init
from .ssm import ssm_block, ssm_init, ssm_state_init


# ----------------------------------------------------------------- trees

def _module(tree):
    """A nested dict of tensors as an ``nn.ParameterDict`` (a block) or an
    ``nn.ModuleDict`` of blocks (a layer)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: _module(v) for k, v in tree.items()})


def module_tree(mod):
    """The nested dict of tensors a ``_module`` was made from."""
    if isinstance(mod, nn.ParameterDict):
        return {k: v.data for k, v in mod.items()}
    return {k: module_tree(v) for k, v in mod.items()}


class LMModel(nn.Module):
    """The parameters of one model configuration.

    ``tree``: ``embed`` [V, D], ``final_norm``, ``lm_head`` [D, V] (untied
    only), ``layers`` (one per-layer tree a layer, in order) and, with an
    encoder, ``encoder`` {``layers``, ``final_norm``}. Matrices keep the
    reference's ``[in, out]`` layout."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_norm = _module(tree["final_norm"])
        self.lm_head = (nn.Parameter(tree["lm_head"])
                        if "lm_head" in tree else None)
        self.layers = nn.ModuleList(_module(t) for t in tree["layers"])
        self.kinds = tuple(cfg.layer_kinds())
        self.encoder = None
        if "encoder" in tree:
            self.encoder = nn.ModuleDict({
                "layers": nn.ModuleList(
                    _module(t) for t in tree["encoder"]["layers"]),
                "final_norm": _module(tree["encoder"]["final_norm"])})

    def forward(self, tokens, **kw):
        return forward_logits(self, tokens, self.cfg, **kw)


# ----------------------------------------------------------------- layers

_WHOLE = _Sharding()      # a model on one device

def _layer_init(gen, cfg: ModelConfig, kind: str):
    dev = gen.device
    p = {"ln1": rmsnorm_init(cfg.d_model, dev)}
    if kind in ("attn", "local", "xattn"):
        p["attn"] = attention_init(gen, cfg)
        if kind == "xattn":
            p["lnx"] = rmsnorm_init(cfg.d_model, dev)
            p["xattn"] = attention_init(gen, cfg, cross=True)
    elif kind == "rglru":
        p["rglru"] = rglru_init(gen, cfg)
    elif kind == "ssm":
        p["ssm"] = ssm_init(gen, cfg)
        return p
    else:
        raise ValueError(kind)
    p["ln2"] = rmsnorm_init(cfg.d_model, dev)
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def _apply_layer(p, x, cfg: ModelConfig, kind: str, *, sh=_WHOLE, pre="",
                 ctx=None, cache=None, pos_offset=0, mask_mode="causal"):
    """Returns (x, new_cache, aux). ``sh``: the model's ``_Sharding``
    (``models/parallel.py``), ``pre`` the layer's parameter-name prefix;
    on a mesh ``cache`` is this rank's shards of the layer's decode cache
    (its ``pos`` for the whole batch)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = cache
    if kind in ("attn", "local", "xattn"):
        kv = None
        if cache is not None:
            kv = dict(cache["kv"], pos=rows(cache["kv"]["pos"], x.shape[0],
                                            sh))
        h, nc = attention_block(p["attn"], pre + "attn.",
                                rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, sh,
                                kind=("attn" if kind == "xattn" else kind),
                                mask_mode=mask_mode, cache=kv,
                                pos_offset=pos_offset)
        x = x + h
        if kind == "xattn":
            x = x + attention_block(p["xattn"], pre + "xattn.",
                                    rmsnorm(p["lnx"], x, cfg.norm_eps), cfg,
                                    sh, kind="attn", ctx=ctx)[0]
        if cache is not None:
            new_cache = dict(cache, kv=dict(
                nc, pos=cache["kv"]["pos"] + x.shape[1]))
    elif kind in ("rglru", "ssm"):
        block, init = ((rglru_block, rglru_state_init) if kind == "rglru"
                       else (ssm_block, ssm_state_init))
        h, ns = recurrent_block(block, init, p[kind], pre + kind + ".",
                                rmsnorm(p["ln1"], x, cfg.norm_eps), cfg, sh,
                                state=None if cache is None
                                else cache["state"])
        x = x + h
        if cache is not None:
            new_cache = dict(cache, state=ns)
        if kind == "ssm":
            return x, new_cache, aux
    else:
        raise ValueError(kind)
    xn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        h, aux = moe_block(p["moe"], pre + "moe.", xn, cfg, sh)
    else:
        h = mlp_block(p["mlp"], pre + "mlp.", xn, cfg, sh)
    return x + h, new_cache, aux


def _cast_layer(tree, dtype):
    """The reference's dtype rule: a layer's weights of 2 or more dims take
    the compute dtype; norms, biases and other 1-D vectors stay f32."""
    return tree_map(lambda a: a.to(dtype) if a.ndim >= 2 else a, tree)


def init_model(seed: int, cfg: ModelConfig, dtype=torch.float32, *,
               device=None):
    """Randomly initialised model, with the reference's shapes, scales and
    dtype rule: every tensor drawn in a fixed order from one
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` -> the
    card). On ``"meta"`` the tensors have shapes and dtypes only."""
    dev = resolve_device(device)
    gen = (SimpleNamespace(device=dev) if dev.type == "meta" else
           torch.Generator(device=dev).manual_seed(int(seed)))
    tree = {"embed": _init(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                           dtype=dtype),
            "final_norm": rmsnorm_init(cfg.d_model, gen.device)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = _init(gen, (cfg.d_model, cfg.vocab), scale=0.02,
                                dtype=dtype)
    tree["layers"] = [_cast_layer(_layer_init(gen, cfg, kind), dtype)
                      for kind in cfg.layer_kinds()]
    if cfg.encoder is not None:
        tree["encoder"] = {
            "layers": [_cast_layer(_layer_init(gen, cfg, "attn"), dtype)
                       for _ in range(cfg.encoder.n_layers)],
            "final_norm": rmsnorm_init(cfg.d_model, gen.device)}
    return LMModel(cfg, tree)


def _sinusoid(S, D):
    pos = np.arange(S)[:, None]
    dim = np.arange(0, D, 2)[None, :] / D
    ang = pos / (10000 ** dim)
    out = np.zeros((S, D), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out)


def _remat(fn, remat_policy, *args):
    """``fn(*args)``, its activations rematerialised in the backward pass
    under ``remat_policy``: ``None`` keeps them all, otherwise it is the
    ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` (what to save;
    ``models.train.REMAT_POLICIES`` maps the reference's names to them)."""
    if remat_policy is None:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=remat_policy)


def run_encoder(params, frames, cfg: ModelConfig, remat_policy=None,
                unroll=False):
    """Whisper-style encoder over precomputed frame embeddings [B, T, D]
    (on a sharded model, this rank's rows).

    ``remat_policy`` rematerialises each encoder layer (see ``_remat``).
    ``unroll`` is the reference's switch from a scan to a Python loop; the
    port always loops in Python, so it changes nothing."""
    sh = _Sharding.of(params)
    frames = torch.as_tensor(frames, device=params.embed.device)
    x = frames + _sinusoid(frames.shape[1], cfg.d_model).to(
        device=frames.device, dtype=frames.dtype)

    def enc_layer(x, j):
        return _apply_layer(params.encoder["layers"][j], x, cfg, "attn",
                            sh=sh, pre=f"encoder.layers.{j}.",
                            mask_mode="bidir")[0]

    for j in range(len(params.encoder["layers"])):
        x = _remat(enc_layer, remat_policy, x, j)
    return rmsnorm(params.encoder["final_norm"], x, cfg.norm_eps)


# ----------------------------------------------------------------- caches

def _one_layer_cache(cfg: ModelConfig, kind: str, batch: int, ctx_len: int,
                     dtype, device, lead=()):
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    if kind in ("attn", "xattn", "local"):
        w = min(ctx_len, cfg.local_window) if kind == "local" else ctx_len
        return {"kv": {
            "k": torch.zeros(lead + (batch, KV, w, dh), dtype=dtype,
                             device=device),
            "v": torch.zeros(lead + (batch, KV, w, dh), dtype=dtype,
                             device=device),
            "pos": torch.zeros(lead + (batch,), dtype=torch.int32,
                               device=device)}}
    if kind == "rglru":
        return {"state": rglru_state_init(cfg, batch, dtype, device, lead)}
    if kind == "ssm":
        return {"state": ssm_state_init(cfg, batch, dtype, device, lead)}
    raise ValueError(kind)


def build_caches(cfg: ModelConfig, batch: int, ctx_len: int,
                 dtype=torch.bfloat16, *, device=None):
    """Decode caches: {'cycle': stacked per pattern position, 'tail': ...}
    on ``device`` (``None`` -> the card; ``"meta"`` allocates nothing)."""
    dev = resolve_device(device)
    lead = (cfg.n_cycles,)
    cycle = {f"p{pi}": _one_layer_cache(cfg, kind, batch, ctx_len, dtype,
                                        dev, lead)
             for pi, kind in enumerate(cfg.block_pattern)}
    tail = {f"t{i}": _one_layer_cache(cfg, kind, batch, ctx_len, dtype, dev)
            for i, kind in enumerate(cfg.tail_kinds)}
    return {"cycle": cycle, "tail": tail}


def set_cache_pos(caches, pos):
    """Mark all kv caches as holding ``pos`` tokens (decode position)."""
    def setp(tree):
        if isinstance(tree, dict) and "pos" in tree:
            old = tree["pos"]
            new = torch.as_tensor(pos, device=old.device).to(torch.int32)
            return dict(tree, pos=torch.broadcast_to(new, old.shape))
        if isinstance(tree, dict):
            return {k: setp(v) for k, v in tree.items()}
        return tree
    return setp(caches)


# ----------------------------------------------------------------- forward

def forward_logits(params, tokens, cfg: ModelConfig, *, ctx=None,
                   caches=None, pos_offset=0, remat_policy=None,
                   activation_hook=None, unroll=False):
    """tokens: [B, S] -> (logits [B, S, V] f32, new_caches, aux).

    params: an ``LMModel``. caches: stacked decode caches (S must be 1).
    ctx: cross-attn context (VLM patches / whisper encoder output).
    remat_policy: rematerialise each cycle of ``pattern_period`` layers in
    the backward pass, as the reference's scan body (see ``_remat``); the
    tail layers never are. A callable activation_hook(x, where) is called
    on the embeddings (``"embed"``), after every layer (``"layer"``),
    after the final norm (``"final"``) and on the logits (``"logits"``);
    its ``sequence_parallel`` flag (``sharding.make_activation_hook``)
    splits a sharded model's activations between layers over the sequence.
    ``unroll`` is the reference's switch from its cycle scan to a Python
    loop; the port always loops in Python, so it changes nothing.

    A sharded model (``sharding.distribute_model``) takes this rank's rows
    of ``tokens`` and ``ctx`` and its shards of the caches
    (``sharding.cache_specs``; their ``pos`` and ``pos_offset`` for the
    whole batch), and returns its block of the logits: its rows, and the
    vocabulary split over ``model`` when the embedding (or head) is.
    """
    sh = _Sharding.of(params)
    hook = activation_hook if callable(activation_hook) else \
        (lambda x, where: x)
    emb = params.embed
    dev = emb.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    B, S = tokens.shape
    if not isinstance(pos_offset, int):
        pos_offset = rows(torch.as_tensor(pos_offset, device=dev), B, sh)
    x = embed(emb, tokens, sh) * scalar(np.sqrt(cfg.d_model), emb.dtype)
    sp = seq_parallel(activation_hook, sh, S)

    def boundary(x):      # a sequence-parallel layout: this rank's chunk
        return _Scatter.apply(x, sh.mesh, "model", 1) if sp else x

    def whole(x):
        return _Gather.apply(x, sh.mesh, "model", 1) if sp else x

    x = boundary(hook(x, "embed"))
    if ctx is not None:
        ctx = torch.as_tensor(ctx, device=dev)

    period, n_cyc = cfg.pattern_period, cfg.n_cycles

    def layers(x, lo, hi):
        """Layers lo..hi-1: (x, their summed aux, their new caches)."""
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        new = []
        for li in range(lo, hi):
            c, pi = divmod(li, period)
            cache = None
            if caches is not None:
                cache = (tree_map(lambda a: a[c], caches["cycle"][f"p{pi}"])
                         if c < n_cyc
                         else caches["tail"][f"t{li - n_cyc * period}"])
            x, nc, a = _apply_layer(params.layers[li], whole(x), cfg,
                                    params.kinds[li], sh=sh,
                                    pre=f"layers.{li}.", ctx=ctx,
                                    cache=cache, pos_offset=pos_offset)
            aux = aux + a
            new.append(nc)
            x = boundary(hook(x, "layer"))
        return x, aux, new

    cycle_aux, cycle_caches = [], []
    for c in range(n_cyc):
        x, aux, new = _remat(layers, remat_policy, x, c * period,
                             (c + 1) * period)
        cycle_aux.append(aux)
        cycle_caches.append(new)
    x, aux_tail, tail_caches = layers(x, n_cyc * period, cfg.n_layers)

    new_caches = None
    if caches is not None:
        new_caches = {
            "cycle": {f"p{pi}": tree_stack([new[pi] for new in cycle_caches])
                      for pi in range(period)},
            "tail": {f"t{i}": nc for i, nc in enumerate(tail_caches)}}
    x = rmsnorm(params.final_norm, whole(x), cfg.norm_eps)
    x = hook(x, "final")
    head = emb.T if cfg.tie_embeddings else params.lm_head
    if sh.vocab_split:
        x = sh.copy(x)
    logits = (x @ head.to(x.dtype)).float()
    if cfg.logit_softcap is not None:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    logits = hook(logits, "logits")
    aux = (torch.stack(cycle_aux).sum() if cycle_aux
           else torch.zeros((), dtype=torch.float32, device=dev)) + aux_tail
    return logits, new_caches, aux
