"""Carry parameters between the reference's tree and the port's model.

The reference keeps a model as nested dicts of arrays: ``embed``,
``final_norm``, ``lm_head`` (untied only), ``cycle/p{i}`` (each leaf
stacked over the ``n_cycles`` cycles of pattern position ``i``),
``tail/t{i}`` (the layers past the last full cycle) and, with an encoder,
``encoder`` {``layers`` stacked over its layers, ``final_norm``}. The port
keeps one submodule per layer in layer order (``LMModel``): layer ``c *
period + i`` is ``cycle/p{i}[c]``. Both keep matrices in the ``[in, out]``
layout, so nothing is transposed and the round trip is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig
from .model import LMModel, module_tree, tree_map, tree_stack


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


def load_reference_params(cfg: ModelConfig, tree: dict, *, device=None,
                          dtype=None) -> LMModel:
    """The port's model holding the reference's parameter ``tree`` (nested
    dicts of numpy arrays, ``init_model``'s layout) on ``device`` (``None``
    -> the card). ``dtype`` casts every floating leaf; ``None`` keeps each
    leaf's own dtype."""
    dev = resolve_device(device)
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
    return LMModel(cfg, port)


def to_reference_params(model: LMModel) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) of the
    port's ``model``: the inverse of ``load_reference_params``."""
    cfg = model.cfg
    period, n_cyc = cfg.pattern_period, cfg.n_cycles
    layers = [module_tree(m) for m in model.layers]
    out = {"embed": model.embed.data,
           "final_norm": module_tree(model.final_norm),
           "cycle": {f"p{pi}": tree_stack(layers[pi: n_cyc * period: period])
                     for pi in range(period)}}
    if model.lm_head is not None:
        out["lm_head"] = model.lm_head.data
    if cfg.tail_kinds:
        out["tail"] = {f"t{i}": layers[n_cyc * period + i]
                       for i in range(len(cfg.tail_kinds))}
    if model.encoder is not None:
        out["encoder"] = {
            "layers": tree_stack([module_tree(m)
                                  for m in model.encoder["layers"]]),
            "final_norm": module_tree(model.encoder["final_norm"])}
    return tree_map(_array, out)
