"""Carry parameters between the reference's tree and the port's model.

The reference keeps a model as nested dicts of arrays: ``embed``,
``final_norm``, ``lm_head`` (untied only), ``cycle/p{i}`` (each leaf
stacked over the ``n_cycles`` cycles of pattern position ``i``),
``tail/t{i}`` (the layers past the last full cycle) and, with an encoder,
``encoder`` {``layers`` stacked over its layers, ``final_norm``}. The port
keeps one submodule per layer in layer order (``LMModel``): layer ``c *
period + i`` is ``cycle/p{i}[c]``. Both keep matrices in the ``[in, out]``
layout, so nothing is transposed and the round trip is exact.

AdamW's state crosses the same way: the reference's moments ``m`` and
``v`` are trees of its parameter layout; the port's are keyed by the
model's ``named_parameters()`` names (``layers.3.attn.wq``), and are
restacked as the weights are.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..tree import tree_from_paths, tree_map, tree_stack
from .config import ModelConfig
from .model import LMModel, module_tree


def _tensor(a, dev, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=dev, dtype=dtype if t.is_floating_point() else None)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy().copy()


def _port_tree(cfg: ModelConfig, tree: dict, dev, dtype) -> dict:
    """The reference's tree of ``cfg`` as the port's (one tree a layer)."""
    t = tree_map(lambda a: _tensor(a, dev, dtype), tree)
    period = cfg.pattern_period
    layers = []
    for li in range(cfg.n_layers):
        c, pi = divmod(li, period)
        layers.append(tree_map(lambda a: a[c].clone(), t["cycle"][f"p{pi}"])
                      if c < cfg.n_cycles
                      else t["tail"][f"t{li - cfg.n_cycles * period}"])
    port = {"embed": t["embed"], "final_norm": t["final_norm"],
            "layers": layers}
    if "lm_head" in t:
        port["lm_head"] = t["lm_head"]
    if "encoder" in t:
        enc = t["encoder"]
        port["encoder"] = {
            "layers": [tree_map(lambda a: a[j].clone(), enc["layers"])
                       for j in range(cfg.encoder.n_layers)],
            "final_norm": enc["final_norm"]}
    return port


def _reference_tree(cfg: ModelConfig, port: dict) -> dict:
    """The port's tree of ``cfg`` as the reference's, in numpy arrays:
    the inverse of ``_port_tree``."""
    period, n_cyc = cfg.pattern_period, cfg.n_cycles
    layers = port["layers"]
    out = {"embed": port["embed"], "final_norm": port["final_norm"],
           "cycle": {f"p{pi}": tree_stack(layers[pi: n_cyc * period: period])
                     for pi in range(period)}}
    if "lm_head" in port:
        out["lm_head"] = port["lm_head"]
    if cfg.tail_kinds:
        out["tail"] = {f"t{i}": layers[n_cyc * period + i]
                       for i in range(len(cfg.tail_kinds))}
    if "encoder" in port:
        out["encoder"] = {
            "layers": tree_stack(port["encoder"]["layers"]),
            "final_norm": port["encoder"]["final_norm"]}
    return tree_map(_array, out)


def _named(tree, prefix="") -> dict:
    """A port tree's leaves by ``named_parameters()`` name (dotted path)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in enumerate(tree) if isinstance(tree, list) else tree.items():
        out.update(_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_reference_params(cfg: ModelConfig, tree: dict, *, device=None,
                          dtype=None) -> LMModel:
    """The port's model holding the reference's parameter ``tree`` (nested
    dicts of numpy arrays, ``init_model``'s layout) on ``device`` (``None``
    -> the card). ``dtype`` casts every floating leaf; ``None`` keeps each
    leaf's own dtype."""
    return LMModel(cfg, _port_tree(cfg, tree, resolve_device(device), dtype))


def _model_tree(model: LMModel) -> dict:
    """The port tree of ``model``'s parameter values."""
    port = {"embed": model.embed.data,
            "final_norm": module_tree(model.final_norm),
            "layers": [module_tree(m) for m in model.layers]}
    if model.lm_head is not None:
        port["lm_head"] = model.lm_head.data
    if model.encoder is not None:
        port["encoder"] = {
            "layers": [module_tree(m) for m in model.encoder["layers"]],
            "final_norm": module_tree(model.encoder["final_norm"])}
    return port


def to_reference_params(model: LMModel) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) of the
    port's ``model``: the inverse of ``load_reference_params``."""
    return _reference_tree(model.cfg, _model_tree(model))


def load_reference_opt_state(cfg: ModelConfig, opt: dict, *,
                             device=None) -> dict:
    """The port's AdamW state (``optim.adamw``: the moments by parameter
    name, on ``device``, ``None`` -> the card; the step on the host) of the
    reference's ``opt`` ({"m", "v": trees of the reference's parameter
    layout, "step"}), restacked as ``load_reference_params`` restacks the
    weights."""
    dev = resolve_device(device)
    out = {k: _named(_port_tree(cfg, opt[k], dev, None)) for k in ("m", "v")}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])),
                               dtype=torch.int32)
    return out


def to_reference_opt_state(cfg: ModelConfig, opt: dict) -> dict:
    """The reference's AdamW state (numpy arrays) of the port's ``opt``:
    the inverse of ``load_reference_opt_state``."""
    out = {k: _reference_tree(cfg, tree_from_paths(opt[k], "."))
           for k in ("m", "v")}
    out["step"] = np.asarray(int(opt["step"]), np.int32)
    return out
