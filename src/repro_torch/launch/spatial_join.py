"""Partitioned spatial-join launcher.

  PYTHONPATH=src python -m repro_torch.launch.spatial_join --r T1 --s T2 \\
      --n-order 8 --parts 2 --method ri --ckpt-dir /tmp/join_ckpt
  PYTHONPATH=src python -m repro_torch.launch.spatial_join --device cpu \\
      --count-r 150 --count-s 200 --n-order 7
  PYTHONPATH=src torchrun --nproc-per-node 2 \\
      -m repro_torch.launch.spatial_join --device cpu --count-r 150 \\
      --count-s 200 --n-order 7

Partition the map (paper §5.2) -> per-partition approximations through
any registered filter (none / april / april-c / ri / ra / 5cch) -> the
MBR join of each partition -> filter verdicts, sharded over the ranks of
the process group for APRIL on a device backend, batched on ``--device``
for the others -> refinement of the INDECISIVE rows. Every partition's
result is checkpointed, so a killed run resumes at partition granularity;
the ``WorkQueue`` leases partitions and takes back a stalled one.

``--device`` is ``cuda`` (default: the kernels) or ``cpu`` (their plain
versions). The filter backend defaults to the device's own (``cuda`` on
the card, ``torch`` on the CPU). The reference's ``jnp`` names are the
port's ``torch`` (filter: the plain versions, sharded; mbr: the device
mask lane, sharded), ``device64`` (refine: the float64 device cores,
sharded) and ``torch`` (build: the device passes); ``jnp`` and ``pallas``
raise ``ValueError`` naming them. Under ``torchrun`` (or any initialised
process group) every rank runs every partition and the sharded stages
split each partition's rows over the ranks, collectives on the host
(``gloo``); rank 0 alone saves checkpoints and prints.

``--plan-mode adaptive`` plans each partition, sharing choices between
partitions of similar candidate density through a ``ProfileCache``.
``--tile-budget BYTES`` runs the out-of-core tiled join instead: the
datasets stream in as generated chunks, the cost-balanced partitioner
packs them into tiles of that many resident bytes (``--balance static``
keeps the uniform grid), and every finished tile checkpoints to
``--ckpt-dir``; ``--resume`` continues a killed run at the first
unfinished tile.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import partition as partition_mod
from ..core.geometry import check_build_backend
from ..core.join import INDECISIVE, TRUE_HIT, check_filter_backend
from ..datagen import PolygonDataset, make_dataset
from ..runtime.checkpoint import CheckpointManager
from ..runtime.elastic import WorkQueue
from ..spatial import refine
from ..spatial.distributed import (distributed_filter, distributed_fused_join,
                                   distributed_mbr_join, distributed_refine,
                                   make_join_mesh)
from ..spatial.filters import get_filter
from ..spatial.fused import check_pipeline_mode
from ..spatial.mbr_join import check_mbr_backend, mbr_join
from ..spatial.plan import JoinPlan
from ..spatial.planner import ProfileCache, check_plan_mode

__all__ = ["join_partition", "run_join", "run_tiled_join", "rank_device",
           "main"]


def _owned(parting, pidx, R, S, ridx, sidx, local_pairs):
    """Partition ``pidx``'s local pairs that it owns by the reference-point
    rule, as global ids."""
    if len(local_pairs) == 0:
        return np.zeros((0, 2), np.int64)
    own = partition_mod.reference_partitions(
        parting.parts_per_dim, R.mbrs[ridx[local_pairs[:, 0]]],
        S.mbrs[sidx[local_pairs[:, 1]]]) == pidx
    local_pairs = local_pairs[own]
    return np.stack([ridx[local_pairs[:, 0]], sidx[local_pairs[:, 1]]],
                    axis=1)


def _device_backend(backend: str) -> str | None:
    """The sharded chain's backend for a launcher filter backend: the
    device ones as they are, the host ones the mesh device's own."""
    return backend if backend in ("torch", "cuda") else None


def join_partition(R, S, approx_r, approx_s, parting, pidx, mesh, filt,
                   backend: str = "cuda", refine_backend: str = "numpy",
                   mbr_backend: str = "numpy", pipeline_mode: str = "staged",
                   plan_mode: str = "static", n_order: int = 8,
                   profile_cache=None):
    """Filter and refine every candidate pair partition ``pidx`` owns;
    returns (global pairs [K, 2], counts).

    ``mbr_backend="torch"`` generates the partition's candidates sharded
    over the mesh (the device mask lane); other values run the host
    grid-hash join. ``refine_backend="device64"`` refines the INDECISIVE
    rows sharded over the mesh (the float64 device cores); other backends
    run ``refine.refine_pairs`` on the mesh's device (``cuda``: the edge
    sweep kernel). ``pipeline_mode="fused"`` (APRIL only) runs the
    partition's whole chain through
    :func:`~repro_torch.spatial.distributed.distributed_fused_join`, the
    ownership rule applied to its pairs; its counts cover the partition's
    whole candidate frame.

    ``plan_mode="adaptive"`` plans each partition on its own candidates:
    an APRIL or ``none`` choice runs the sharded fused chain with that
    plan (a skip-filter plan launches no filter kernel), other choices the
    partition's ``JoinPlan``. Prebuilt stores are reused when the choice
    matches their filter and order, built for the partition otherwise. A
    ``profile_cache`` shares choices between partitions of similar
    candidate density."""
    part = parting.partitions[pidx]
    ridx = part.obj_idx[R.name]
    sidx = part.obj_idx[S.name]
    ar, as_ = approx_r[pidx], approx_s[pidx]
    if len(ridx) == 0 or len(sidx) == 0:
        return np.zeros((0, 2), np.int64), {}
    dev = mesh.device

    def local(D, idx):
        return PolygonDataset(name=D.name, verts=D.verts[idx],
                              nverts=D.nverts[idx])

    if plan_mode == "adaptive":
        Rp, Sp = local(R, ridx), local(S, sidx)
        probe = JoinPlan(Rp, Sp, filter="april", n_order=n_order,
                         filter_backend=backend,
                         refine_backend=refine_backend, device=dev,
                         plan_mode="adaptive")
        choice = key = None
        if profile_cache is not None:
            cand = probe.candidates("intersects")
            key = profile_cache.key("intersects", len(Rp), len(Sp),
                                    len(cand))
            choice = profile_cache.get(key)
            if choice is not None:
                probe._apply_choice(choice)
            else:
                choice = probe.plan("intersects", pairs=cand)
                profile_cache.put(key, choice)
        else:
            choice = probe.plan("intersects")
        if choice.method in ("april", "none"):
            if choice.skip_filter or choice.method == "none":
                ar2 = as2 = None
            elif (filt.name == "april" and choice.n_order == n_order
                    and ar is not None and as_ is not None):
                ar2, as2 = ar, as_
            else:
                april = get_filter("april")
                ar2 = april.build(Rp, n_order=choice.n_order, side="r")
                as2 = april.build(Sp, n_order=choice.n_order, side="s")
            local_pairs, counts = distributed_fused_join(
                Rp, Sp, ar2, as2, mesh=mesh, plan=choice,
                backend=_device_backend(backend))
        else:
            local_pairs, st = probe.execute("intersects")
            counts = {"true_neg": st.n_true_negs,
                      "true_hit": st.n_true_hits,
                      "indecisive": st.n_indecisive}
        counts = dict(counts)
        counts["plan"] = choice.key()
        return _owned(parting, pidx, R, S, ridx, sidx, local_pairs), counts

    if filt.name != "none" and (ar is None or as_ is None):
        return np.zeros((0, 2), np.int64), {}

    if pipeline_mode == "fused":
        if filt.name != "april":
            raise ValueError("pipeline_mode='fused' in the partitioned "
                             "launcher needs --method april (the sharded "
                             f"fused chain), got {filt.name!r}")
        local_pairs, counts = distributed_fused_join(
            local(R, ridx), local(S, sidx), ar, as_, mesh=mesh,
            backend=_device_backend(backend))
        return _owned(parting, pidx, R, S, ridx, sidx, local_pairs), counts

    if mbr_backend == "torch":
        local_pairs, _ = distributed_mbr_join(R.mbrs[ridx], S.mbrs[sidx],
                                              mesh=mesh)
    else:
        local_pairs = mbr_join(R.mbrs[ridx], S.mbrs[sidx],
                               backend=mbr_backend)
    if len(local_pairs) == 0:
        return np.zeros((0, 2), np.int64), {}
    # ownership: the reference point must fall inside this partition's tile
    own = partition_mod.reference_partitions(
        parting.parts_per_dim, R.mbrs[ridx[local_pairs[:, 0]]],
        S.mbrs[sidx[local_pairs[:, 1]]]) == pidx
    local_pairs = local_pairs[own]
    if len(local_pairs) == 0:
        return np.zeros((0, 2), np.int64), {}

    verd, counts = distributed_filter(filt, ar, as_, local_pairs, mesh=mesh,
                                      backend=backend)
    results = []
    hits = local_pairs[verd == TRUE_HIT]
    indec = local_pairs[verd == INDECISIVE]
    if len(indec):
        glob = np.stack([ridx[indec[:, 0]], sidx[indec[:, 1]]], axis=1)
        if refine_backend == "device64":
            ref, rcounts = distributed_refine(R, S, glob, mesh=mesh)
            counts = {**counts, **rcounts}
        else:
            ref = refine.refine_pairs(R, S, glob, backend=refine_backend,
                                      device=dev)
            counts = {**counts, "refined_true": int(ref.sum())}
        results.append(glob[ref])
    if len(hits):
        results.append(np.stack([ridx[hits[:, 0]], sidx[hits[:, 1]]], axis=1))
    out = (np.concatenate(results, axis=0) if results
           else np.zeros((0, 2), np.int64))
    return out, counts


def _check_backends(backend, refine_backend, mbr_backend, build_backend,
                    pipeline_mode, plan_mode) -> None:
    check_pipeline_mode(pipeline_mode)
    check_plan_mode(plan_mode)
    check_filter_backend(backend)
    refine.check_refine_backend(refine_backend)
    check_mbr_backend(mbr_backend)
    check_build_backend(build_backend)


def run_join(r_name="T1", s_name="T2", n_order=8, parts=2, ckpt_dir=None,
             seed=0, count_r=None, count_s=None, mesh=None, method="april",
             backend=None, refine_backend="numpy", mbr_backend="numpy",
             build_backend="numpy", pipeline_mode="staged",
             plan_mode="static", device=None):
    """The partitioned join of ``make_dataset(r_name, seed)`` x
    ``make_dataset(s_name, seed + 1)``; returns (global pairs, totals).
    ``mesh`` (default ``make_join_mesh(device=device)``: this rank of the
    default process group, if one is initialised) says where the sharded
    stages run; ``device`` (``None`` -> ``"cuda"``) is used when no mesh
    is given. ``backend`` is the filter backend (default the device's
    own). Prints one summary line (rank 0)."""
    mesh = mesh or make_join_mesh(device=device)
    backend = backend or mesh.backend
    _check_backends(backend, refine_backend, mbr_backend, build_backend,
                    pipeline_mode, plan_mode)
    filt = get_filter(method)
    R = make_dataset(r_name, seed=seed, count=count_r)
    S = make_dataset(s_name, seed=seed + 1, count=count_s)
    profile_cache = ProfileCache() if plan_mode == "adaptive" else None

    t0 = time.perf_counter()
    parting = partition_mod.partition_space([R, S], parts_per_dim=parts)
    if plan_mode == "adaptive":
        # no global prebuild: each partition's planner picks its filter
        # and order and builds (or skips) its stores itself
        approx_r = [None] * len(parting)
        approx_s = [None] * len(parting)
    else:
        opts = {"build_backend": build_backend}
        if build_backend == "torch":
            opts["device"] = mesh.device
        approx_r = parting.build_approx(filt, R, n_order, side="r", **opts)
        approx_s = parting.build_approx(filt, S, n_order, side="s", **opts)
    t_build = time.perf_counter() - t0

    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    done: dict[int, np.ndarray] = {}
    if mgr is not None:
        restored = mgr.restore()
        if restored is not None:
            _, flat, _ = restored
            done = {int(k.split("_")[1]): v for k, v in flat.items()
                    if k.startswith("part_")}
            if mesh.rank == 0:
                print(f"[resume] {len(done)} partitions already joined")
        mesh.barrier()          # every rank restored before rank 0 saves
        if mesh.rank != 0:
            mgr = None

    queue = WorkQueue([p for p in range(len(parting)) if p not in done],
                      lease_seconds=600)
    totals = {"true_neg": 0, "true_hit": 0, "indecisive": 0,
              "refined_true": 0}
    t0 = time.perf_counter()
    while not queue.finished:
        p = queue.acquire()
        if p is None:
            break
        res, counts = join_partition(R, S, approx_r, approx_s, parting, p,
                                     mesh, filt, backend=backend,
                                     refine_backend=refine_backend,
                                     mbr_backend=mbr_backend,
                                     pipeline_mode=pipeline_mode,
                                     plan_mode=plan_mode, n_order=n_order,
                                     profile_cache=profile_cache)
        done[p] = res
        for k in totals:
            totals[k] += counts.get(k, 0)
        queue.complete(p)
        if mgr is not None:
            mgr.save(len(done), {f"part_{k}": v for k, v in done.items()})
    t_join = time.perf_counter() - t0
    if mgr is not None:
        mgr.wait()

    results = np.concatenate([v for v in done.values() if len(v)], axis=0) \
        if any(len(v) for v in done.values()) else np.zeros((0, 2), np.int64)
    if mesh.rank == 0:
        cache_note = (f"  plan cache {profile_cache.stats}"
                      if profile_cache is not None else "")
        print(f"build {t_build:.2f}s  join {t_join:.2f}s  "
              f"results {len(results)}  filter counts {totals}{cache_note}")
    return results, totals


def run_tiled_join(r_name="T1", s_name="T2", *, tile_budget: int,
                   n_order=8, balance="cost", ckpt_dir=None, resume=True,
                   seed=0, count_r=None, count_s=None, chunk_size=65536,
                   mesh=None, method="april", backend=None,
                   refine_backend=None, mbr_backend="numpy",
                   pipeline_mode="staged", plan_mode="static", device=None):
    """The out-of-core tiled run: both datasets stream in as generated
    chunks (never whole), the cost-balanced partitioner packs them into
    ``tile_budget``-byte tiles and
    :func:`~repro_torch.spatial.scaleout.tiled_join` joins tile after tile
    on ``device`` (``None`` -> ``"cuda"``; a mesh's device when one is
    given), checkpointing every finished tile to ``ckpt_dir``.
    ``backend`` and ``refine_backend`` default to the device's own. Prints
    the tiles, the partition and build seconds and the stats row (rank
    0)."""
    from ..datagen import iter_dataset_chunks
    from ..spatial.scaleout import tiled_join

    check_pipeline_mode(pipeline_mode)
    check_plan_mode(plan_mode)
    if mesh is not None:
        device = mesh.device
    profile_cache = ProfileCache() if plan_mode == "adaptive" else None
    pairs, stats = tiled_join(
        iter_dataset_chunks(r_name, seed=seed, count=count_r,
                            chunk_size=chunk_size),
        iter_dataset_chunks(s_name, seed=seed + 1, count=count_s,
                            chunk_size=chunk_size),
        method=method, n_order=n_order, filter_backend=backend,
        refine_backend=refine_backend, mbr_backend=mbr_backend,
        pipeline_mode=pipeline_mode, plan_mode=plan_mode, mesh=mesh,
        ckpt_dir=ckpt_dir, resume=resume, profile_cache=profile_cache,
        device=device, tile_budget=tile_budget, balance=balance, seed=seed)
    if mesh is None or mesh.rank == 0:
        resumed = stats.extra.get("resumed_tiles", 0)
        print(f"tiles {stats.tiles} ({resumed} resumed)  "
              f"partition {stats.t_partition:.2f}s  "
              f"build {stats.t_build:.2f}s  results {len(pairs)}")
        print(stats.row())
    return pairs, stats


def rank_device(device: str) -> str:
    """The device this rank runs on: under ``torchrun`` (``WORLD_SIZE`` >
    1) a bare ``cuda`` is ``cuda:<LOCAL_RANK>``, so that each rank runs
    its shard on its own card; any other device as given."""
    if device == "cuda" and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", default="T1")
    ap.add_argument("--s", default="T2")
    ap.add_argument("--n-order", type=int, default=8)
    ap.add_argument("--parts", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--count-r", type=int, default=None)
    ap.add_argument("--count-s", type=int, default=None)
    ap.add_argument("--method", default="april",
                    help="intermediate filter: none/april/april-c/ri/ra/5cch")
    ap.add_argument("--device", default="cuda",
                    help="where the join runs: cuda (default) or cpu")
    ap.add_argument("--filter-backend", default=None,
                    help="numpy/torch/cuda/sequential (torch and cuda shard "
                         "APRIL over the ranks; default: --backend, else "
                         "cuda on the card and torch on the CPU)")
    ap.add_argument("--backend", default=None,
                    help="older alias of --filter-backend")
    ap.add_argument("--refine-backend", default=None,
                    help="numpy/torch/cuda/device64/sequential (device64 "
                         "refines sharded over the ranks; default numpy, "
                         "the tiled join the device's own)")
    ap.add_argument("--mbr-backend", default="numpy",
                    help="numpy/torch/sequential (torch generates the "
                         "candidates sharded over the ranks)")
    ap.add_argument("--build-backend", default="numpy",
                    help="numpy/torch/sequential, for every partition's "
                         "build (torch: the device passes)")
    ap.add_argument("--pipeline-mode", default="staged",
                    help="staged (default) or fused (each partition's "
                         "chain sharded on the device; APRIL only)")
    ap.add_argument("--plan-mode", default="static",
                    help="static (default) or adaptive (a plan for each "
                         "partition)")
    ap.add_argument("--tile-budget", type=int, default=None,
                    help="resident bytes a tile; runs the out-of-core "
                         "tiled join")
    ap.add_argument("--balance", default="cost",
                    help="tiled join: cost (skew split and cost-balanced "
                         "packing, default) or static (uniform grid)")
    ap.add_argument("--resume", action="store_true",
                    help="tiled join: resume from the --ckpt-dir "
                         "manifest at the first unfinished tile")
    ap.add_argument("--chunk-size", type=int, default=65536,
                    help="tiled join: generated objects a chunk")
    args = ap.parse_args()
    own_group = False
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and not dist.is_initialized()):
        # torchrun's environment: the ranks meet through gloo on the host
        dist.init_process_group("gloo")
        own_group = True
    try:
        device = rank_device(args.device)
        mesh = make_join_mesh(device=device)
        if mesh.device.type == "cuda" and mesh.device.index is not None:
            # the kernels launch on the current device's stream
            torch.cuda.set_device(mesh.device)
        backend = args.filter_backend or args.backend
        if args.tile_budget is not None:
            run_tiled_join(args.r, args.s, tile_budget=args.tile_budget,
                           n_order=args.n_order, balance=args.balance,
                           ckpt_dir=args.ckpt_dir, resume=args.resume,
                           count_r=args.count_r, count_s=args.count_s,
                           chunk_size=args.chunk_size, method=args.method,
                           backend=backend,
                           refine_backend=args.refine_backend,
                           mbr_backend=args.mbr_backend,
                           pipeline_mode=args.pipeline_mode,
                           plan_mode=args.plan_mode,
                           mesh=mesh if mesh.size > 1 else None,
                           device=device)
        else:
            run_join(args.r, args.s, n_order=args.n_order,
                     parts=args.parts, ckpt_dir=args.ckpt_dir,
                     count_r=args.count_r, count_s=args.count_s,
                     method=args.method, backend=backend,
                     refine_backend=args.refine_backend or "numpy",
                     mbr_backend=args.mbr_backend,
                     build_backend=args.build_backend,
                     pipeline_mode=args.pipeline_mode,
                     plan_mode=args.plan_mode, mesh=mesh)
        if own_group:
            dist.barrier()  # no rank tears the group down under another
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
