"""Sharding rules: parameter, optimizer and cache specs, and the activation
hook (the reference's ``models/sharding.py``): data parallelism over
``data`` (and ``pod``), tensor and expert parallelism over ``model``,
sequence parallelism at layer boundaries, ZeRO-1 optimizer state over
``data``.

A spec is the port's twin of a ``PartitionSpec``: a tuple with one entry
per dimension, ``None`` (replicated), an axis name, or a tuple of axis
names (the dimension split over their product, the first axis major).
The rules are the reference's table, keyed on the port's parameter names
(``layers.3.attn.wq``): the port keeps one submodule a layer, so no spec
has the reference's leading stacked dimension. ``_sanitize`` drops an
axis that does not divide its dimension, so every placement is even.

:func:`distribute_model` lays a model onto a mesh under its specs: each
rank keeps its shard of every parameter, and the model carries the mesh
and the specs, from which ``forward_logits`` and ``loss_fn`` take the
collectives of ``models/parallel.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["param_specs", "opt_state_specs", "cache_specs",
           "make_activation_hook", "data_axes", "named_sharding_tree",
           "NamedSharding", "ActivationHook", "local_shard",
           "distribute_model", "shard_batch", "opt_state_zeros"]


def data_axes(mesh) -> tuple:
    """The data-parallel axes: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _data_entry(mesh):
    d = data_axes(mesh)
    return d if len(d) > 1 else (d[0] if d else None)


# (name-suffix match, spec) -- first match wins
def _rules():
    M = "model"
    return [
        (("embed",), (M, None)),
        (("lm_head",), (None, M)),
        (("attn", "wq"), (None, M)), (("attn", "wk"), (None, M)),
        (("attn", "wv"), (None, M)), (("attn", "wo"), (M, None)),
        (("attn", "bq"), (M,)), (("attn", "bk"), (M,)), (("attn", "bv"), (M,)),
        (("xattn", "wq"), (None, M)), (("xattn", "wk"), (None, M)),
        (("xattn", "wv"), (None, M)), (("xattn", "wo"), (M, None)),
        (("mlp", "w1"), (None, M)), (("mlp", "w3"), (None, M)),
        (("mlp", "w2"), (M, None)),
        (("moe", "router"), (None, None)),
        (("moe", "w1"), (M, None, None)), (("moe", "w3"), (M, None, None)),
        (("moe", "w2"), (M, None, None)),
        (("ssm", "in_proj"), (None, M)), (("ssm", "conv_w"), (None, M)),
        (("ssm", "conv_b"), (M,)), (("ssm", "x_proj"), (M, None)),
        (("ssm", "dt_proj"), (None, M)), (("ssm", "dt_bias"), (M,)),
        (("ssm", "A_log"), (M, None)), (("ssm", "D"), (M,)),
        (("ssm", "out_proj"), (M, None)),
        (("rglru", "in_x"), (None, M)), (("rglru", "in_g"), (None, M)),
        (("rglru", "conv_w"), (None, M)), (("rglru", "conv_b"), (M,)),
        (("rglru", "w_r"), (None, M)), (("rglru", "w_i"), (None, M)),
        (("rglru", "lam"), (M,)), (("rglru", "out"), (M, None)),
    ]


def _axis_size(mesh, axis) -> int:
    if mesh is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return int(mesh.shape[axis])


def _sanitize(spec, shape, mesh) -> tuple:
    """``spec`` padded to ``len(shape)`` entries, each axis that does not
    divide its dimension replaced by ``None``."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(ax if ax is None or dim % _axis_size(mesh, ax) == 0
                 else None for dim, ax in zip(shape, parts))


def _spec_for_name(name: str, shape, mesh=None) -> tuple:
    names = tuple(name.split("."))
    for suffix, spec in _rules():
        if names[-len(suffix):] == suffix:
            return _sanitize(spec, shape, mesh)
    return (None,) * len(shape)       # norms, scalars: replicated


def _shapes(params) -> dict:
    """{name: shape} of a model (``named_parameters``) or of a dict of
    tensors or shapes."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_specs(params, mesh=None) -> dict:
    """{parameter name: spec} of a model (or {name: tensor or shape})."""
    return {k: _spec_for_name(k, s, mesh) for k, s in _shapes(params).items()}


def opt_state_specs(params, mesh) -> dict:
    """ZeRO-1 specs of AdamW's state ({"m", "v": by parameter name,
    "step"}): each moment also split over the data axes on its first
    dimension that is free and divisible."""
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes) if daxes else 1
    entry = _data_entry(mesh)

    def zero1(name, shape):
        parts = list(_spec_for_name(name, shape, mesh))
        for i, (dim, cur) in enumerate(zip(shape, parts)):
            if cur is None and dim % dsize == 0 and dim >= dsize > 1:
                parts[i] = entry
                break
        return tuple(parts)

    moments = {k: zero1(k, s) for k, s in _shapes(params).items()}
    return {"m": moments, "v": dict(moments), "step": ()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def cache_specs(caches, mesh) -> dict:
    """Decode caches (``build_caches``' tree): KV caches [(n,) B, KV, C, dh]
    batch over data, heads over model (head_dim when the kv heads do not
    divide it); recurrent states batch over data, width over model."""
    d = _data_entry(mesh)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        stacked = "cycle" in path
        lead = (None,) if stacked else ()
        last = path[-1]
        if last in ("k", "v"):
            if shape[1 + int(stacked)] % _axis_size(mesh, "model") == 0:
                s = lead + (d, "model", None, None)
            else:
                s = lead + (d, None, None, "model")
        elif last == "h":
            s = lead + ((d, "model", None) if len(shape) == 3 + int(stacked)
                        else (d, "model"))
        elif last == "conv":
            s = lead + (d, None, "model")
        else:
            return (None,) * len(shape)
        return _sanitize(s, shape, mesh)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return spec(path, node)
    return walk(caches, ())


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the twin of ``jax.sharding.NamedSharding``."""
    mesh: object
    spec: tuple


def named_sharding_tree(mesh, spec_tree):
    """Every spec (a tuple leaf) of ``spec_tree`` on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: named_sharding_tree(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, spec_tree)


def local_shard(a, mesh, spec):
    """This rank's block of the global array ``a`` (a tensor or numpy
    array) under ``spec``: each sharded dimension narrowed to the chunk
    of the rank's index over its axes."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = mesh.axis_size(e)
        size = a.shape[dim] // n
        i = mesh.axis_index(e)
        a = a.narrow(dim, i * size, size) if isinstance(a, torch.Tensor) \
            else np.take(a, np.arange(i * size, (i + 1) * size), axis=dim)
    return a


class ActivationHook:
    """Layer-boundary layouts of the sharded forward, a flag the stack
    reads (``forward_logits``): batch over the data axes; with
    ``sequence_parallel`` (training and prefill, not decode), the
    sequence over ``model`` at the embeddings and after every layer, which
    cuts what a cycle saves for the backward (the reference's ``(data,
    "model", None)``); the logits split over the vocabulary on
    ``model``. The reference's hook is a function ``hook(x, where)`` that
    constrains each boundary; the port's collectives are the stack's own,
    so this one is not called."""

    def __init__(self, mesh, *, sequence_parallel=True, decode=False):
        self.mesh = mesh
        self.sequence_parallel = bool(sequence_parallel and not decode)


def make_activation_hook(mesh, *, sequence_parallel: bool = True,
                         decode: bool = False) -> ActivationHook:
    return ActivationHook(mesh, sequence_parallel=sequence_parallel,
                          decode=decode)


def distribute_model(model, mesh, specs=None):
    """A copy of ``model`` (an ``LMModel`` holding global parameters, or
    already sharded on another mesh: it is gathered first) whose
    parameters are this rank's shards under ``specs`` (default
    ``param_specs(model, mesh)``), on ``mesh.device``; it carries
    ``.mesh`` and ``.specs``."""
    from ..tree import tree_from_paths
    from .model import LMModel
    from .parallel import gather_params
    full = gather_params(model) if getattr(model, "mesh", None) is not None \
        else dict(model.named_parameters())
    specs = specs or param_specs(full, mesh)
    tree = tree_from_paths({k: local_shard(v.detach(), mesh, specs[k])
                            .to(mesh.device).clone()
                            for k, v in full.items()}, ".")
    out = LMModel(model.cfg, tree)
    out.mesh, out.specs = mesh, specs
    return out


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch: dim 0 split over the data axes
    (replicated over ``model``), on ``mesh.device``."""
    d = _data_entry(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        n = _axis_size(mesh, d) if d else 1
        if t.ndim == 0 or n == 1:
            out[k] = t.to(mesh.device)
            continue
        if t.shape[0] % n:
            raise ValueError(f"batch entry {k!r} of {t.shape[0]} rows does "
                             f"not split over {n} data ranks")
        out[k] = local_shard(t, mesh, (d,)).to(mesh.device)
    return out


def opt_state_zeros(params, mesh, specs: dict) -> dict:
    """A fresh AdamW state of this rank's shards (f32 zeros of the local
    moment shapes under ``specs``, on ``mesh.device``), without making the
    global moments first; ``params`` gives the global shapes."""
    shapes = _shapes(params)
    zeros = {n: torch.zeros(tuple(d // (mesh.axis_size(e) if e else 1)
                                  for d, e in zip(s, specs["m"][n])),
                            dtype=torch.float32, device=mesh.device)
             for n, s in shapes.items()}
    return {"m": zeros, "v": {n: torch.zeros_like(t) for n, t in
                              zeros.items()},
            "step": torch.zeros((), dtype=torch.int32)}
