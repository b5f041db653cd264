"""Training step: loss, grads, AdamW (the reference's ``models/train.py``).

Loss is next-token cross-entropy over the logits; MoE architectures add
the router's load-balancing aux loss. Gradients come from autograd in
place of ``jax.value_and_grad``; the reference's ``jax.checkpoint``
policies become ``torch.utils.checkpoint`` contexts (``REMAT_POLICIES``),
which change what the backward pass keeps and recomputes, not the
numbers. The step runs eagerly. A model laid onto a mesh
(``sharding.distribute_model``) runs the same forward on each rank's
shards and rows, its collectives those of ``models/parallel.py``; the
step then sums
the gradients over the data axes (a reduce-scatter to the ZeRO-1 layout
with ``grad_shardings``, else an all-reduce), updates each rank's slice
of the moments and the parameters, and gathers the parameters back over
the data axes.
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
from .parallel import _chunk, _Sharding, full_shapes, log_likelihood
from .sharding import data_axes, opt_state_specs

_aten = torch.ops.aten

#: the reference's remat policy names -> the ``context_fn`` of
#: ``torch.utils.checkpoint.checkpoint`` (``None``: no checkpointing).
#: "dots" is the reference's ``dots_with_no_batch_dims_saveable``: it
#: saves the outputs of the matmuls without batch dimensions (``x @ w``
#: runs as ``mm``) and recomputes the rest, the batched ones included
#: (attention's scores and output, the experts' ``einsum``s, which run as
#: ``bmm``); "nothing" saves only the cycle's inputs; "everything" saves
#: all, which is no checkpointing
REMAT_POLICIES = {
    None: None,
    "none": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              [_aten.mm.default, _aten.addmm.default]),
    "nothing": noop_context_fn,
    "everything": None,
}


def loss_fn(params, batch, cfg: ModelConfig, *, remat_policy=None,
            activation_hook=None, unroll=False):
    """(loss, {"xent", "aux"}) of ``batch`` ({"tokens", "labels"} [B, S],
    optional "frames" / "patches" context) under the model ``params``, on
    its device. ``remat_policy`` is a ``REMAT_POLICIES`` value. A label
    below 0 is padding: it is masked out of the mean.

    On a sharded model ``batch`` is this rank's rows; the loss and the
    metrics are the global ones, and the loss's gradient is this rank's
    share (its rows' summed cross-entropy over the global count of
    labels, plus the aux loss over the data ranks), which the data ranks
    sum to the single-device gradient."""
    sh = _Sharding.of(params)
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
    # the reference's take_along_axis wraps a label of -1 to the last
    # class and the mask zeroes it; gather needs an index in range
    ll = log_likelihood(logits, labels, sh)
    mask = (labels >= 0).to(torch.float32)
    count = sh.data_sum(torch.sum(mask))
    xent = -torch.sum(ll * mask) / torch.clamp_min(count, 1.0)
    piece = xent + aux / sh.n_data
    if sh.n_data == 1:
        return piece, {"xent": xent, "aux": aux}
    # the global value, this rank's share of the gradient
    loss = piece + (sh.data_sum(piece.detach()) - piece).detach()
    return loss, {"xent": sh.data_sum(xent.detach()), "aux": aux.detach()}


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
    footprint about N times.

    A sharded model (``sharding.distribute_model``) takes this rank's rows
    of the batch (``sharding.shard_batch``) and its shards of the moments
    (``runtime.elastic.remesh_tree`` of a global state under
    ``opt_state_specs``, or ``sharding.opt_state_zeros``).
    grad_shardings: the ZeRO-1 layout of the gradients
    (``named_sharding_tree(mesh, opt_state_specs(...)["m"])``): they are
    reduce-scattered over the data axes to it, where without it they are
    all-reduced; either way each rank updates its slice of the moments
    and parameters, and the parameters are gathered back over the data
    axes. The numbers are the same.
    """
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
        if getattr(params, "mesh", None) is not None:
            return params, *_sharded_update(params, grads, opt_state, lr,
                                            grad_shardings, metrics, loss)
        metrics = dict(metrics, loss=loss, grad_norm=_global_norm(grads))
        _, new_opt = adamw_update(dict(params.named_parameters()), grads,
                                  opt_state, lr=lr)
        return params, new_opt, metrics

    return train_step


def _zero1_dims(params, grad_shardings) -> dict:
    """{name: the dimension a moment splits over the data axes, or None}
    under ``grad_shardings`` or, without it, ``opt_state_specs``."""
    mesh = params.mesh
    if grad_shardings is not None:
        specs = {k: v.spec for k, v in grad_shardings.items()}
        if any(v.mesh is not mesh for v in grad_shardings.values()):
            raise ValueError("grad_shardings are on another mesh than the "
                             "model")
    else:
        specs = opt_state_specs(full_shapes(params), mesh)["m"]
    daxes = set(data_axes(mesh))
    out = {}
    for k, spec in specs.items():
        dims = [i for i, e in enumerate(spec) if e is not None and
                daxes & set((e,) if isinstance(e, str) else e)]
        out[k] = dims[0] if dims else None
    return out


@torch.no_grad()
def _sharded_update(params, grads, opt_state, lr, grad_shardings, metrics,
                    loss):
    """AdamW on a sharded model: the gradients summed over the data axes
    (reduce-scattered to each moment's data slice under ZeRO-1, else
    all-reduced and sliced), each rank's slices of the parameters and
    moments updated, the parameters gathered back over the data axes.
    Returns (new opt state, metrics with the global ``grad_norm``)."""
    mesh = params.mesh
    daxes = data_axes(mesh)
    dims = _zero1_dims(params, grad_shardings)
    plist = dict(params.named_parameters())
    pieces, slices, sq = {}, {}, {}
    for k, g in grads.items():
        d = dims[k]           # None on one data rank: ZeRO-1 needs two
        if d is not None and grad_shardings is not None:
            g = mesh.reduce_scatter(g, daxes, d)
        else:
            g = mesh.all_reduce(g, daxes)
            if d is not None:
                g = _chunk(g, mesh, daxes, d)
        pieces[k] = g
        slices[k] = plist[k] if d is None else _chunk(plist[k], mesh, daxes, d)
        # the mesh axes this piece of the gradient is split over
        axes = tuple(a for a in mesh.axis_names if
                     (a == "model" and "model" in params.specs[k]) or
                     (a in daxes and d is not None))
        sq[axes] = sq.get(axes, 0.0) + torch.sum(g.to(torch.float32) ** 2)
    norm2 = sum(mesh.all_reduce(v, axes) for axes, v in sq.items())
    _, new_opt = adamw_update(slices, pieces, opt_state, lr=lr)
    for k, d in dims.items():
        if d is not None:
            plist[k].copy_(mesh.all_gather(slices[k], daxes, d))
    metrics = dict(metrics, loss=loss, grad_norm=torch.sqrt(norm2))
    return new_opt, metrics


def _global_norm(tree):
    """The f32 root of the summed squares of every leaf (a dict or list)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(l.to(torch.float32) ** 2)
                          for l in leaves))
