"""AdamW with f32 moments, over the port's parameters (the reference's
``optim/adamw.py``).

``params`` is a tree of tensors (a model's: ``dict(named_parameters())``);
the state's ``m`` and ``v`` have its structure and are f32 whatever the
parameters' dtype, and ``step`` is an int32 0-d tensor kept on the host,
so the bias corrections are Python floats and a step reads nothing back
from the card. The update
runs in f32 and is cast back to each parameter's dtype. Parameters and
moments are updated in place (the f32 state of a 2.6 B-parameter model
fills half the card) and returned in the reference's signature.
"""
from __future__ import annotations

import numpy as np
import torch

from ..tree import tree_map


def adamw_init(params):
    """{"m", "v": f32 zeros shaped as each parameter, "step": 0}."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """One AdamW step: returns (params, new state). ``grads`` has the
    structure of ``params``; ``lr`` is a float or a 0-d tensor."""
    step = int(state["step"]) + 1
    # the reference's f32 bias corrections, 1 - b ** step
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)

    def upd(p, g, m, v):
        gf = g.float()
        pf = p.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
        delta.add_(weight_decay * pf)
        p.copy_(pf - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"],
                    "step": torch.tensor(step, dtype=torch.int32)}
