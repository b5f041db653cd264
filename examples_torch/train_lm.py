"""Train a ~135M-param assigned architecture (smollm-135m) for a few
hundred steps on synthetic data with checkpoint auto-resume, on the card
(default) or on the CPU.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 300 --full
    PYTHONPATH=src python examples_torch/train_lm.py --device cpu

The default runs the reduced smoke config; ``--full`` runs the complete
135M model. Checkpoints go under the temporary directory (``--ckpt-dir``
to choose), so a second run resumes where the first stopped.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: lm_ckpt_torch "
                         "under the temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "lm_ckpt_torch")
    _, _, losses = train_loop(
        args.arch, smoke=not args.full, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=ckpt, ckpt_every=25, lr=3e-3, log_every=10,
        device=args.device)
    if losses:
        print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'check lr'})")
    else:
        print(f"already trained to step {args.steps} (checkpoint {ckpt})")
    return losses


if __name__ == "__main__":
    main()
