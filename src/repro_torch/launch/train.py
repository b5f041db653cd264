"""Training launcher: end-to-end driver with fault tolerance (the
reference's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 [--device cpu]

Features:
  * synthetic-corpus data pipeline with a deterministic, checkpointable
    cursor (restart-safe: the same batch sequence after resume, and the
    reference's batches token for token);
  * CheckpointManager auto-resume (params + optimizer + data cursor) in
    the reference's tree layout, so a checkpoint crosses between the two
    packages in both directions;
  * --fail-at-step N injects a crash to demonstrate restart;
  * straggler detection via StragglerMonitor;
  * mesh-sharded training (``mesh=``, or ``--mesh DxM`` under ``torchrun``
    with gloo ranks): parameters under ``param_specs``, AdamW's state under
    ``opt_state_specs`` (ZeRO-1), each rank's rows of every batch. The
    checkpoints stay global host arrays (gathered, written by the mesh's
    first rank), so a run resumes on a mesh of another size.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.convert import (load_reference_opt_state,
                              load_reference_params, to_reference_opt_state,
                              to_reference_params)
from ..models.model import LMModel, init_model
from ..models.parallel import gather_params, gather_tree
from ..models.sharding import (distribute_model, make_activation_hook,
                               opt_state_specs, opt_state_zeros,
                               param_specs, shard_batch)
from ..models.train import make_train_step
from ..optim.adamw import adamw_init
from ..runtime.checkpoint import CheckpointManager
from ..runtime.elastic import StragglerMonitor, remesh_tree
from ..tree import tree_from_paths


class SyntheticCorpus:
    """Deterministic token stream with a restorable cursor. Batches are
    host tensors (int32 tokens and labels, f32 frames or patches)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.cursor = 0

    def next_batch(self, cfg=None):
        rng = np.random.default_rng((self.seed, self.cursor))
        # learnable structure: noisy affine next-token rule (a model that
        # trains must drive the loss well below log(vocab))
        B, S, V = self.batch, self.seq, self.vocab
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = rng.random((B, S)) < 0.1
        rand = rng.integers(0, V, (B, S))
        for t in range(S):
            nxt = (toks[:, t] * 31 + 17) % V
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        self.cursor += 1
        out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
               "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
        if cfg is not None and cfg.encoder is not None:
            fr = rng.normal(size=(self.batch, cfg.encoder.n_frames,
                                  cfg.d_model)) * 0.02
            out["frames"] = torch.from_numpy(fr.astype(np.float32))
        elif cfg is not None and cfg.n_patch_tokens:
            pt = rng.normal(size=(self.batch, cfg.n_patch_tokens,
                                  cfg.d_model)) * 0.02
            out["patches"] = torch.from_numpy(pt.astype(np.float32))
        return out

    def state(self):
        return {"cursor": np.asarray(self.cursor)}

    def load_state(self, st):
        self.cursor = int(st["cursor"])


def _restore(mgr, cfg, params, dev):
    """(step, params, opt, data state) of the newest checkpoint, or
    ``None``; a parameter whose shape differs from ``params``' raises."""
    restored = mgr.restore()
    if restored is None:
        return None
    step, flat, _ = restored
    tree = tree_from_paths(flat, "/")
    new = load_reference_params(cfg, tree["params"], device=dev)
    want = {k: tuple(p.shape) for k, p in params.named_parameters()}
    got = {k: tuple(p.shape) for k, p in new.named_parameters()}
    if got != want:
        raise ValueError(f"checkpoint at step {step} does not hold "
                         f"{cfg.name}'s parameters")
    return (step, new, load_reference_opt_state(cfg, tree["opt"], device=dev),
            tree["data"])


def train_loop(arch: str, *, smoke=True, steps=20, batch=4, seq=64,
               ckpt_dir=None, ckpt_every=10, fail_at_step=None, lr=1e-3,
               mesh=None, log_every=5, remat="dots", device=None):
    """Train ``arch`` for ``steps`` steps on ``device`` (``None`` -> the
    card) from ``init_model(0, ...)``'s f32 weights, or from the newest
    checkpoint under ``ckpt_dir``. Returns (params, opt, losses of the
    steps this call ran).

    ``mesh`` (``launch.mesh``; every rank of it calls ``train_loop``)
    shards the model and the optimizer state and splits each batch over
    the data axes; it computes on ``mesh.device``, and the returned
    params and opt are this rank's shards."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == int(mesh.ranks.flat[0])
    cfg = get_config(arch, smoke=smoke)
    data = SyntheticCorpus(cfg.vocab, batch, seq)

    params = init_model(0, cfg, dtype=torch.float32, device=dev)
    opt = None if mesh is not None else \
        adamw_init(dict(params.named_parameters()))
    start_step = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None:
        restored = _restore(mgr, cfg, params, dev)
        if restored is not None:
            start_step, params, opt, data_state = restored
            data.load_state(data_state)
            if writer:
                print(f"[resume] restored checkpoint at step {start_step}")

    hook = None
    if mesh is not None:
        hook = make_activation_hook(mesh, sequence_parallel=False)
        ospecs = opt_state_specs(params, mesh)
        opt = opt_state_zeros(params, mesh, ospecs) if opt is None else \
            {k: remesh_tree(opt[k], mesh, ospecs[k]) for k in ("m", "v")} \
            | {"step": opt["step"]}
        params = distribute_model(params, mesh, param_specs(params, mesh))

    def state():
        """The global tree of the checkpoint (a collective on a mesh)."""
        if mesh is None:
            model, o = params, opt
        else:
            model = LMModel(cfg, tree_from_paths(gather_params(params), "."))
            o = {k: gather_tree(opt[k], ospecs[k], mesh) for k in ("m", "v")}
            o["step"] = opt["step"]
        return {"params": to_reference_params(model),
                "opt": to_reference_opt_state(cfg, o), "data": data.state()}

    step_fn = make_train_step(cfg, lr=lr, remat_policy=remat,
                              activation_hook=hook, device=dev)
    mon = StragglerMonitor()
    losses = []
    try:
        for step in range(start_step, steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            b = data.next_batch(cfg)
            if mesh is not None:
                b = shard_batch(b, mesh)
            mon.start()
            params, opt, metrics = step_fn(params, opt, b)
            loss = float(metrics["loss"])   # the sync that ends the step
            slow = mon.stop()
            losses.append(loss)
            if writer and (step % log_every == 0 or slow):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"{'[straggler]' if slow else ''}")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                tree = state()
                if writer:
                    mgr.save(step + 1, tree)
    finally:
        # flush any in-flight async checkpoint, even on a crash: the last
        # committed checkpoint must be durable before the process exits
        if mgr is not None:
            mgr.wait()
    if mgr is not None:
        tree = state()
        if writer:
            mgr.save(steps, tree, block=True)
        mgr.wait()
    return params, opt, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh over the ranks of torchrun "
                         "(gloo; RANK / WORLD_SIZE / MASTER_ADDR from it)")
    args = ap.parse_args()
    mesh = None
    if args.mesh:
        import torch.distributed as dist
        from .mesh import make_dev_mesh
        dist.init_process_group("gloo")
        n_data, n_model = (int(v) for v in args.mesh.split("x"))
        mesh = make_dev_mesh(n_data, n_model, device=args.device)
    t0 = time.time()
    _, _, losses = train_loop(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        fail_at_step=args.fail_at_step, lr=args.lr, device=args.device,
        mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(f"done in {time.time() - t0:.1f}s on "
              f"{resolve_device(args.device)}"
              f"{f', mesh {args.mesh}' if mesh else ''}; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
