"""Training step: loss, grads, AdamW (the reference's ``models/train.py``).

Loss is next-token cross-entropy over the logits; MoE architectures add
the router's load-balancing aux loss. Gradients come from autograd in
place of ``jax.value_and_grad``; the reference's ``jax.checkpoint``
policies become ``torch.utils.checkpoint`` contexts (``REMAT_POLICIES``),
which change what the backward pass keeps and recomputes, not the
numbers. The step runs eagerly on one device; the sharded step is ROADMAP
A11c.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import resolve_device
from ..optim.adamw import adamw_update
from .config import ModelConfig
from .model import forward_logits, run_encoder

_aten = torch.ops.aten

#: the reference's remat policy names -> the ``context_fn`` of
#: ``torch.utils.checkpoint.checkpoint`` (``None``: no checkpointing).
#: "dots" saves the matmul outputs (what ``x @ w`` and ``einsum`` run as)
#: and recomputes the rest; "nothing" saves only the cycle's inputs;
#: "everything" saves all, which is no checkpointing
REMAT_POLICIES = {
    None: None,
    "none": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              [_aten.mm.default, _aten.bmm.default,
                               _aten.addmm.default]),
    "nothing": noop_context_fn,
    "everything": None,
}


def loss_fn(params, batch, cfg: ModelConfig, *, remat_policy=None,
            activation_hook=None, unroll=False):
    """(loss, {"xent", "aux"}) of ``batch`` ({"tokens", "labels"} [B, S],
    optional "frames" / "patches" context) under the model ``params``, on
    its device. ``remat_policy`` is a ``REMAT_POLICIES`` value. A label
    below 0 is padding: it is masked out of the mean."""
    dev = params.embed.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    ctx = None
    if cfg.encoder is not None:
        ctx = run_encoder(params, batch["frames"], cfg,
                          remat_policy=remat_policy, unroll=unroll)
    elif cfg.n_patch_tokens:
        ctx = torch.as_tensor(batch["patches"], device=dev)
    logits, _, aux = forward_logits(
        params, batch["tokens"], cfg, ctx=ctx, remat_policy=remat_policy,
        activation_hook=activation_hook, unroll=unroll)
    logp = torch.log_softmax(logits, dim=-1)
    # the reference's take_along_axis wraps a label of -1 to the last
    # class and the mask zeroes it; gather needs an index in range
    ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    xent = -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return xent + aux, {"xent": xent, "aux": aux}


def make_train_step(cfg: ModelConfig, *, lr=3e-4, remat_policy="dots",
                    activation_hook=None, unroll=False, grad_shardings=None,
                    microbatch: int | None = None, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    params: an ``LMModel`` on ``device`` (``None`` -> the card), where the
    batch's entries (numpy arrays or tensors) are moved; opt_state:
    ``optim.adamw_init(dict(params.named_parameters()))``. The parameters
    and moments are updated in place (``optim.adamw``). metrics: {"xent", "aux", "loss", "grad_norm"}
    as 0-d tensors on the device.

    remat_policy: a key of ``REMAT_POLICIES`` (another raises
    ``KeyError``). microbatch: gradient accumulation over N strided batch
    splits (``a[i::N]``, as the reference), which divides the activation
    footprint about N times. grad_shardings (the reference's ZeRO-1 layout)
    belongs to the sharded step, ROADMAP A11c.
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings belongs to the sharded train step, which is not "
            "ported yet (ROADMAP A11c)")
    policy = REMAT_POLICIES[remat_policy]
    dev = resolve_device(device)

    def grad_fn(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = loss_fn(params, batch, cfg, remat_policy=policy,
                                activation_hook=activation_hook,
                                unroll=unroll)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        n_mb = microbatch or 1
        if n_mb > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            metrics = grads = None
            for i in range(n_mb):
                l, m, g = grad_fn(params, {k: v[i::n_mb]
                                           for k, v in batch.items()})
                loss = loss + l
                metrics = m if metrics is None else \
                    {k: metrics[k] + m[k] for k in metrics}
                if grads is None:
                    grads = g
                else:
                    for k in grads:
                        grads[k].add_(g[k])
                del g
            inv = 1.0 / n_mb
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            for v in grads.values():
                v.mul_(inv)
        else:
            loss, metrics, grads = grad_fn(params, batch)
        metrics = dict(metrics, loss=loss, grad_norm=_global_norm(grads))
        _, new_opt = adamw_update(dict(params.named_parameters()), grads,
                                  opt_state, lr=lr)
        return params, new_opt, metrics

    return train_step


def _global_norm(tree):
    """The f32 root of the summed squares of every leaf (a dict or list)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                          for l in leaves))
