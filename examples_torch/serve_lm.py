"""Serve a small model with batched greedy decoding (KV caches / recurrent
states), the decode step of the serving path, on the card (default) or on
the CPU. The weights are the port's own seeded draw.

    PYTHONPATH=src python examples_torch/serve_lm.py --arch recurrentgemma-2b
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.models.serve import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = init_model(0, cfg, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = torch.as_tensor(rng.normal(
            size=(args.batch, cfg.encoder.n_frames, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=dev)
    elif cfg.n_patch_tokens:
        extra["patches"] = torch.as_tensor(rng.normal(
            size=(args.batch, cfg.n_patch_tokens, cfg.d_model)) * 0.02,
            dtype=torch.float32, device=dev)
    out = greedy_generate(params, cfg, prompt, steps=args.steps,
                          batch_extra=extra or None, device=dev)
    print(f"{args.arch} (smoke config) generated {out.shape[1]} tokens "
          f"for {args.batch} sequences:")
    print(out.cpu().numpy())
    return out


if __name__ == "__main__":
    main()
