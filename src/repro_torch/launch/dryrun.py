"""Dry run: the figures of every (architecture x input shape x mesh) cell
of the sharded LM step, with nothing allocated (the reference's
``launch/dryrun.py``), for the roofline of ``launch/roofline.py``.

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's cost and memory analyses, with unrolled probes
because XLA counts a loop body once. The port runs eagerly, so it runs
the cell: a fake process group of the mesh's size (torch's ``fake``
backend: collectives return at once), the model, the optimizer state and
the inputs on the ``meta`` device (shapes and dtypes, no memory), and one
sharded step (``models.parallel``) as rank 0 of the mesh. Every layer
runs, so nothing needs correcting. The cell's figures, per rank:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step (the
  matmuls and attention products, the recomputed ones included);
* bytes: the summed input and output bytes of every op the step
  dispatches (views and collectives excluded), each op reading and
  writing once;
* collective bytes by kind: the mesh's own tally of the bytes each
  collective leaves on the rank (``Mesh.tally``);
* memory: the shards of the parameters, their gradients and AdamW's
  moments under the spec trees, plus the bytes the forward leaves alive
  for the backward (what the remat policy saves); a decode cell, the
  parameters and the shards of its caches under ``cache_specs``.

A train cell runs ``make_train_step``, a prefill cell the forward to the
last position's logits, a decode cell ``make_decode_step`` on its caches.

A join cell (``--arch april_join``) reckons B1, the APRIL trichotomy
kernel, on the reference's packed batch (rows split over the data axes):
its bytes read once and written once, as ``PERF.md`` bounds the kernel,
two compares a step of each of its three interval merges, and the
all-reduce of the three verdict counts. Nothing is launched.

One JSON per cell under ``--out``, with the reference's keys, so
``launch/report.py`` renders the port's cells as the reference's. Run
it as its own process: it owns the default process group.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch april_join
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, get_config, input_specs, \
    shape_skip_reason
from ..models.model import forward_logits, init_model, run_encoder
from ..models.serve import make_decode_step
from ..models.sharding import (cache_specs, data_axes, distribute_model,
                               make_activation_hook, named_sharding_tree,
                               opt_state_specs, opt_state_zeros, param_specs,
                               shard_batch)
from ..models.train import REMAT_POLICIES, loss_fn, make_train_step
from ..runtime.elastic import remesh_tree
from .mesh import PRODUCTION_SHAPES, Mesh
from .report import mesh_label
from .roofline import PEAK_FLOPS_F32, RooflineReport, model_flops

JOIN_SHAPES = {  # paper-system cells: (n_pairs, intervals_per_list)
    "join_256k": (262144, 64),
    "join_1m": (1048576, 32),
}

META = torch.device("meta")

#: the reference's flags that tune XLA's compiled program only
XLA_ONLY = {
    "q_chunk": "--q-chunk re-tiles the attention XLA compiles (the "
               "reference's hill-climb of its buffers); the port's dry run "
               "runs the configuration as it trains",
    "moe_groups": "--moe-groups splits the MoE dispatch so GSPMD can shard "
                  "its buffer; the port's sharded MoE gathers the data "
                  "group's tokens and splits the experts by hand",
}


# ------------------------------------------------------------- the world

def fake_world(size: int) -> None:
    """A default process group of ``size`` fake ranks (this process is
    rank 0); an existing group of another size is torn down."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def cell_mesh(multi_pod: bool = False, mesh_shape=None) -> Mesh:
    """Rank 0's view of the production mesh (or of ``mesh_shape``, a
    (data, model) pair), in a fake world of its size, on ``meta``."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    if mesh_shape is not None:
        shape, axes = tuple(mesh_shape), ("data", "model")
    fake_world(int(np.prod(shape)))
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                device=META)


# ---------------------------------------------------------------- meters

class _Bytes(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs (views and
    collectives excluded)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace == "aten":
            for t in _tensors((args, kwargs, out)):
                self.total += t.numel() * t.element_size()
        return out


class _Alive(TorchDispatchMode):
    """Records every storage an op makes; ``alive()`` is the bytes of
    those still referenced (a storage counted once)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            s = t.untyped_storage()
            self.made.append((StorageWeakRef(s), s._cdata, s.nbytes()))
        return out

    def alive(self) -> int:
        gc.collect()
        return sum({cdata: n for ref, cdata, n in self.made
                    if not ref.expired()}.values())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------- model cells

def run_model_cell(cfg, shape, mesh: Mesh, *, sequence_parallel=True,
                   remat="dots", zero1_grads=False, sp_prefill=False,
                   replicate_params=False, microbatch=None,
                   dtype=torch.bfloat16, arch=None, shape_name="cell"):
    """The figures of one cell: ``shape`` is (seq, global batch, mode).
    Returns the cell's dict (``RooflineReport.to_dict()`` plus the
    reference's extra keys)."""
    seq, batch, mode = shape
    name = shape_name if shape_name in SHAPES and \
        SHAPES[shape_name] == tuple(shape) else "cell"
    shapes = dict(SHAPES, cell=tuple(shape))
    t0 = time.time()
    model = init_model(0, cfg, dtype=dtype, device=META)
    specs = param_specs(model, mesh)
    if replicate_params:
        specs = {k: (None,) * len(s) for k, s in specs.items()}
    full = dict(model.named_parameters())
    params = distribute_model(model, mesh, specs)
    del model
    sp_on = (mode == "train" and sequence_parallel) or \
        (mode == "prefill" and sp_prefill)
    hook = make_activation_hook(mesh, sequence_parallel=sp_on,
                                decode=(mode == "decode"))
    local = _local_inputs(_cell_inputs(cfg, shape, shape_name, dtype), mesh)
    p_bytes = _nbytes(params.parameters())
    mem = {"params": p_bytes}

    if mode == "train":
        policy = REMAT_POLICIES[remat]
        ospecs = opt_state_specs(full, mesh)
        opt = opt_state_zeros(full, mesh, ospecs)
        mem["grads"] = p_bytes
        mem["moments"] = _nbytes(list(opt["m"].values())
                                 + list(opt["v"].values()))
        with _Alive() as kept:
            loss, _ = loss_fn(params, local, cfg, remat_policy=policy,
                              activation_hook=hook)
        mem["saved_for_backward"] = kept.alive()
        del loss, kept
        step = make_train_step(
            cfg, remat_policy=remat, activation_hook=hook,
            grad_shardings=(named_sharding_tree(mesh, ospecs["m"])
                            if zero1_grads else None),
            microbatch=microbatch, device=META)

        def run():
            return step(params, opt, local)
    elif mode == "prefill":
        def run():
            with torch.no_grad():
                ctx = local.get("patches")
                if cfg.encoder is not None:
                    ctx = run_encoder(params, local["frames"], cfg)
                return forward_logits(params, local["tokens"], cfg, ctx=ctx,
                                      activation_hook=hook)[0][:, -1]
    else:
        caches = local.pop("caches")
        mem["caches"] = sum(_nbytes([t]) for t in _tensors(caches))
        step = make_decode_step(cfg, device=META)

        def run():
            return step(params, caches, local)
    mesh.tally.clear()
    flop = FlopCounterMode(display=False)
    counted = _Bytes()
    t1 = time.time()
    with flop, counted:
        run()
    run_s = time.time() - t1
    coll = dict(mesh.tally)
    rep = RooflineReport(
        arch=arch or cfg.name, shape=shape_name,
        mesh=mesh_label(mesh.shape.values()),
        chips=mesh.size, flops_per_chip=float(flop.get_total_flops()),
        bytes_per_chip=float(counted.total),
        coll_bytes_per_chip=float(sum(coll.values())), coll_breakdown=coll,
        model_flops_global=model_flops(cfg, name, shapes),
        memory_per_chip_bytes=float(sum(mem.values())),
        compile_seconds=run_s)
    if dtype == torch.float32:
        rep.peak_flops = PEAK_FLOPS_F32
    out = rep.to_dict()
    out["memory_detail"] = mem
    out["hlo_collective_ops"] = dict(coll)
    out["raw_scan_metrics"] = {"flops": out["flops_per_chip"],
                               "bytes": out["bytes_per_chip"], "coll": coll}
    out["lower_seconds"] = time.time() - t0 - run_s
    out["dtype"] = str(dtype).replace("torch.", "")
    return out


def _local_inputs(inputs: dict, mesh: Mesh) -> dict:
    """This rank's block of a cell's inputs: the batch rows split over the
    data axes where they divide (a batch of 1 stays whole, as the
    reference's ``_batch_sharding`` leaves it), the decode caches under
    ``cache_specs``."""
    out = {}
    n = mesh.axis_size(data_axes(mesh))
    for k, v in inputs.items():
        if k == "caches":
            out[k] = remesh_tree(v, mesh, cache_specs(v, mesh))
        elif v.ndim and v.shape[0] % n == 0:
            out.update(shard_batch({k: v}, mesh))
        else:
            out[k] = v
    return out


def _cell_inputs(cfg, shape, shape_name, dtype) -> dict:
    seq, batch, mode = shape
    if shape_name in SHAPES and SHAPES[shape_name] == tuple(shape):
        specs = input_specs(cfg, shape_name, dtype=dtype)
    else:
        specs = {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                       device=META)}
        if mode == "train":
            specs["labels"] = torch.empty_like(specs["tokens"])
        if cfg.encoder is not None:
            specs["frames"] = torch.empty(
                (batch, cfg.encoder.n_frames, cfg.d_model), dtype=dtype,
                device=META)
        elif cfg.n_patch_tokens:
            specs["patches"] = torch.empty(
                (batch, cfg.n_patch_tokens, cfg.d_model), dtype=dtype,
                device=META)
    return specs


# ------------------------------------------------------------ join cells

def run_join_cell(shape_name: str, mesh: Mesh) -> dict:
    """B1's figures on one rank for a packed batch of ``JOIN_SHAPES``: the
    rows split over the data axes (replicated over ``model``, as the
    reference lays them), each row's 8 interval lists of ``I`` int32
    starts or ends and 4 int32 counts read once, its int32 verdict
    written once, and the three verdict counts all-reduced over every
    rank. Operations: each of the three merges (AA, AF, FA) steps at most
    2 I times, two compares a step."""
    B, I = JOIN_SHAPES[shape_name]
    rows = B // mesh.axis_size(data_axes(mesh))
    read = rows * (8 * I + 4) * 4
    written = rows * 4
    counts = 3 * 4
    coll = {"all-reduce": counts}
    rep = RooflineReport(
        arch="april_join", shape=shape_name,
        mesh=mesh_label(mesh.shape.values()),
        chips=mesh.size, flops_per_chip=float(rows * 3 * 2 * I * 2),
        bytes_per_chip=float(read + written),
        coll_bytes_per_chip=float(counts), coll_breakdown=coll,
        model_flops_global=0.0,
        memory_per_chip_bytes=float(read + written + counts))
    rep.peak_flops = PEAK_FLOPS_F32
    out = rep.to_dict()
    out["memory_detail"] = {"argument_size_in_bytes": read,
                            "output_size_in_bytes": written + counts}
    out["hlo_collective_ops"] = dict(coll)
    out["raw_scan_metrics"] = {"flops": out["flops_per_chip"],
                               "bytes": out["bytes_per_chip"], "coll": coll}
    out["lower_seconds"] = 0.0
    return out


# -------------------------------------------------------------------- CLI

def run_cell(arch, shape_name, multi_pod, out_dir, tag="", mesh_shape=None,
             **kw):
    """One cell's JSON under ``out_dir`` (kept if it is there already)."""
    mesh_tag = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}{tag}.json")
    if os.path.exists(path):
        print(f"[skip-done] {path}")
        with open(path) as f:
            return json.load(f)
    for k, why in XLA_ONLY.items():
        if kw.pop(k, None) is not None:
            raise ValueError(why)
    mesh = cell_mesh(multi_pod, mesh_shape)
    if arch == "april_join":
        res = run_join_cell(shape_name, mesh)
    else:
        cfg = get_config(arch)
        reason = shape_skip_reason(cfg, shape_name)
        if reason:
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "skipped": reason}
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"[skip] {arch} {shape_name} {mesh_tag}: {reason}")
            return res
        res = run_model_cell(cfg, SHAPES[shape_name], mesh, arch=arch,
                             shape_name=shape_name, **kw)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(f"[ok] {arch} {shape_name} {mesh_tag}: "
          f"flops/chip={res.get('flops_per_chip', 0):.3e} "
          f"coll/chip={res.get('coll_bytes_per_chip', 0):.3e} "
          f"mem/chip={res.get('memory_per_chip_bytes', 0) / 2**30:.2f}GiB "
          f"bottleneck={res.get('bottleneck')} "
          f"run={res.get('compile_seconds', 0):.1f}s")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel activation sharding")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--q-chunk", type=int, default=None,
                    help="the reference's XLA knob: raises here")
    ap.add_argument("--zero1-grads", action="store_true",
                    help="reduce-scatter grads to the ZeRO-1 layout")
    ap.add_argument("--sp-prefill", action="store_true",
                    help="sequence-parallel activations in prefill too")
    ap.add_argument("--replicate-params", action="store_true",
                    help="replicated weights (no model-axis split)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="gradient-accumulation splits per train step")
    ap.add_argument("--moe-groups", type=int, default=None,
                    help="the reference's XLA knob: raises here")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="the cell's parameter and activation dtype")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (variants)")
    args = ap.parse_args()
    for k, why in XLA_ONLY.items():
        if getattr(args, k) is not None:
            ap.error(why)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.arch == "april_join":
        cells = [("april_join", s) for s in
                 ([args.shape] if args.shape else list(JOIN_SHAPES))]
    elif args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                kw = {} if arch == "april_join" else dict(
                    sequence_parallel=not args.no_sp, remat=args.remat,
                    zero1_grads=args.zero1_grads, sp_prefill=args.sp_prefill,
                    replicate_params=args.replicate_params,
                    microbatch=args.microbatch,
                    dtype=getattr(torch, args.dtype))
                run_cell(arch, shape_name, mp, args.out, tag=args.tag, **kw)
            except Exception as e:
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"[FAIL] {arch} {shape_name} "
                      f"{'multi' if mp else 'single'}: {e}")
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
