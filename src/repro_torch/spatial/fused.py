"""The fused device-resident chain: ``JoinPlan(pipeline_mode="fused")``.

MBR -> intermediate filter -> refinement run as one chain of stages that
consume and produce a :class:`CandidateSet`: a host-known pair frame plus
device lanes over it. The filter writes the status lane on the device,
the filter -> refine boundary compacts the INDECISIVE rows on the device
(``kernels.compact``), and refinement runs float64 cores on the packed
prefix. Nothing returns to the host until the single gather of
:func:`to_host` at the end of the chain, which also drives the one
permitted host round trip: the float64 re-check of the rows the device
refinement flagged uncertain.

Contract with the staged mode: identical result pairs in identical order,
and identical ``JoinStats`` counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.join import INDECISIVE, TRUE_HIT, TRUE_NEG
from ..device import InputLog, upload
from ..kernels.compact import compact_mask, compact_mask_plain
from . import refine as RF
from .refine import JOIN_STAGES
from .mbr_join import _prepare, candidate_rows, mbr_inside, pair_mask_lane

__all__ = ["PIPELINE_MODES", "check_pipeline_mode", "to_host",
           "CandidateSet", "Stage", "StagePlan", "device_frame",
           "mask_status", "refine_lanes", "build_stage_plan",
           "execute_fused", "record_chains", "JOIN_STAGES"]

#: execution modes of JoinPlan: 'staged' materializes each stage's
#: survivors on the host, 'fused' keeps the chain on the device with one
#: gather at its end
PIPELINE_MODES = ("staged", "fused")


def check_pipeline_mode(mode: str) -> None:
    if mode not in PIPELINE_MODES:
        raise ValueError(f"unknown pipeline_mode {mode!r}; "
                         f"expected one of {PIPELINE_MODES}")


def to_host(*lanes: torch.Tensor) -> tuple[np.ndarray, ...]:
    """The chain's one device -> host copy: the int8/bool lanes, a byte a
    row, and int64 tensors (counts kept on the device), by their bytes,
    are packed into one uint8 tensor, copied once and split again.
    Returns flat numpy arrays of the lanes' own dtypes."""
    parts = [t.reshape(-1).view(torch.uint8) if t.dtype == torch.int64
             else t.reshape(-1).to(torch.uint8) for t in lanes]
    packed = torch.cat(parts).cpu().numpy()
    out, at = [], 0
    for t, p in zip(lanes, parts):
        row, at = packed[at:at + p.numel()], at + p.numel()
        out.append(row.view(np.int64) if t.dtype == torch.int64
                   else row.astype(np.int8) if t.dtype == torch.int8
                   else row.astype(bool))
    return tuple(out)


_CHAINS = InputLog()


def record_chains():
    """Collect the :class:`CandidateSet` of every fused execution run inside
    the block, as its stages left it before the gather, one per execution:
    the device frame ``ri_dev``/``si_dev`` the status lane was computed on,
    the ``valid`` and ``status`` lanes, and so the INDECISIVE lane
    (``status == INDECISIVE``) the compaction was given. The kernels can
    then be replayed on exactly what a join gave them."""
    return _CHAINS.record()


# ---------------------------------------------------------------------------
# The stage contract
# ---------------------------------------------------------------------------

@dataclass
class CandidateSet:
    """The currency of the fused chain.

    The pair frame ``(ri, si)`` is host-known: it comes out of grid-hash
    preprocessing over host MBR tables, so holding it costs no device
    sync. It is uploaded once, as ``ri_dev``/``si_dev``, and every stage
    reads those copies. Everything data-dependent lives in device lanes
    over that frame: ``valid`` (MBR test and ownership; ``None`` means the
    frame is pre-filtered on the host), ``status`` (the int8 trichotomy,
    invalid rows TRUE_NEG), ``hit`` / ``unc`` (refined verdicts and
    borderline flags). No stage materializes a lane.
    """
    ri: np.ndarray                        # [N] int64 host frame, R indices
    si: np.ndarray                        # [N] int64 host frame, S indices
    ri_dev: torch.Tensor | None = None    # [N] device int64 copy of ri
    si_dev: torch.Tensor | None = None    # [N] device int64 copy of si
    valid: torch.Tensor | None = None     # [N] device bool
    status: torch.Tensor | None = None    # [N] device int8
    hit: torch.Tensor | None = None       # [N] device bool
    unc: torch.Tensor | None = None       # [N] device bool

    def __len__(self) -> int:
        return len(self.ri)


@dataclass
class Stage:
    """One link of the chain; ``name`` keys the JoinStats time field
    (``t_mbr`` / ``t_filter`` / ``t_refine``)."""
    name: str
    fn: Callable


class StagePlan:
    """An ordered CandidateSet -> CandidateSet chain, dispatched back to
    back with no host sync in between, each stage a ``JOIN_STAGES`` stage.
    Stage times are host times of the dispatch: device work surfaces in
    the final gather (``t_sync``) unless the queue of pending launches
    fills and the dispatch waits for it."""

    def __init__(self, stages: list[Stage]):
        self.stages = list(stages)

    def run(self, cs: CandidateSet | None = None,
            stats=None) -> CandidateSet:
        with JOIN_STAGES.record() as secs:
            for st in self.stages:
                with JOIN_STAGES.stage(st.name):
                    cs = st.fn(cs)
        if stats is not None:
            for st in self.stages:
                name = "t_" + st.name
                setattr(stats, name,
                        getattr(stats, name, 0.0) + secs[st.name])
        return cs


def _empty_cs() -> CandidateSet:
    z = np.zeros(0, np.int64)
    return CandidateSet(ri=z, si=z)


# ---------------------------------------------------------------------------
# Stage builders
# ---------------------------------------------------------------------------

def device_frame(ri, si, dev: torch.device) -> CandidateSet:
    """A pair frame ``(ri, si)`` and its one upload to ``dev``."""
    ri = np.ascontiguousarray(ri, np.int64)
    si = np.ascontiguousarray(si, np.int64)
    return CandidateSet(ri=ri, si=si, ri_dev=upload(ri, dev),
                        si_dev=upload(si, dev))


def mask_status(cs: CandidateSet, lane: torch.Tensor) -> CandidateSet:
    """``cs.status``: the filter's ``lane`` with the rows ``cs.valid``
    rejects (when there is a ``valid`` lane) set to TRUE_NEG."""
    cs.status = (lane if cs.valid is None
                 else torch.where(cs.valid, lane, TRUE_NEG))
    return cs


def refine_lanes(cs: CandidateSet, R, S, dev: torch.device,
                 predicate: str, kernel: bool) -> CandidateSet:
    """The filter -> refine boundary and the refinement of ``cs``: the
    INDECISIVE rows of ``cs.status`` compacted on the device (the scan
    kernel when ``kernel``, else its plain version), the predicate's
    float64 core over the packed prefix (``refine.fused_refine_lanes``: the
    B7 kernel when ``kernel``, else its plain version), scattered back to
    ``cs.hit`` (TRUE_HIT rows included) and ``cs.unc``."""
    compact = compact_mask if kernel else compact_mask_plain
    with JOIN_STAGES.stage("refine.compact"):
        perm, count = compact(cs.status == INDECISIVE)
    res, unc = RF.fused_refine_lanes(R, S, cs.ri_dev, cs.si_dev, perm, count,
                                     dev, predicate, kernel=kernel)
    perm = perm.to(torch.int64)
    N = len(cs)
    hit_ref = torch.zeros(N, dtype=torch.bool, device=dev)
    cs.hit = (cs.status == TRUE_HIT) | hit_ref.scatter_(0, perm, res)
    cs.unc = torch.zeros(N, dtype=torch.bool,
                         device=dev).scatter_(0, perm, unc)
    return cs


def build_stage_plan(plan, predicate: str) -> StagePlan:
    """The three-stage fused chain of one ``JoinPlan`` execution.

    * ``mbr`` — host grid-hash preprocessing producing the pair frame,
      uploaded once; a warm ``mbr_index`` or a host backend gives a frame
      pre-filtered on the host (``JoinPlan.candidates``); otherwise, with
      ``mbr_backend="torch"``, the intersection and ownership test stays a
      device ``valid`` lane (for ``within`` with the MBR containment test
      of ``JoinPlan.candidates``, made on the host MBR tables and
      uploaded, folded in).
    * ``filter`` — the filter's ``status_lane`` over the frame, with
      invalid rows set to TRUE_NEG.
    * ``refine`` — on-device compaction of the INDECISIVE lane
      (``compact_mask``) and float64 refinement of the packed prefix
      (``refine.fused_refine_lanes``, the predicate's core: intersection,
      containment, or for ``linestring`` chain x polygon intersection),
      scattered back to frame lanes.

    The ``"cuda"`` backends launch the kernels (the trichotomy kernel for
    the status lane, the scan kernel for the compaction, the fused refine
    kernel for the refinement); the others run their plain versions on the
    plan's device.
    """
    dev = plan.device
    stage = JOIN_STAGES.stage

    def mbr_stage(_):
        if plan.mbr_index is not None or plan.mbr_backend != "torch":
            with stage("mbr.candidates"):
                pairs = plan.candidates(predicate)
            if len(pairs) == 0:
                return _empty_cs()
            with stage("mbr.upload"):
                return device_frame(pairs[:, 0], pairs[:, 1], dev)
        with stage("mbr.candidates"):
            mbrs_r, mbrs_s, k, extent = _prepare(plan.R.mbrs, plan.S.mbrs,
                                                 plan.mbr_grid)
            if k == 0:
                return _empty_cs()
            ri, si, own_x, own_y, lo_r, lo_s = candidate_rows(
                mbrs_r, mbrs_s, k, extent)
        if len(ri) == 0:
            return _empty_cs()
        with stage("mbr.upload"):
            cs = device_frame(ri, si, dev)
        cs.valid = pair_mask_lane(mbrs_r, mbrs_s, lo_r, lo_s, cs.ri_dev,
                                  cs.si_dev, own_x, own_y, dev)
        if predicate == "within":
            cs.valid &= upload(mbr_inside(mbrs_r[ri], mbrs_s[si]), dev)
        return cs

    def filter_stage(cs):
        if len(cs) == 0:
            return cs
        lane = plan.filter.status_lane(
            plan.approx_r, plan.approx_s, cs.ri, cs.si, predicate=predicate,
            backend=plan.filter_backend, device=dev,
            rows=(cs.ri_dev, cs.si_dev), **plan.filter_opts)
        return mask_status(cs, lane)

    def refine_stage(cs):
        if len(cs) == 0:
            return cs
        return refine_lanes(cs, plan.R, plan.S, dev, predicate,
                            kernel=plan.refine_backend == "cuda")

    return StagePlan([Stage("mbr", mbr_stage),
                      Stage("filter", filter_stage),
                      Stage("refine", refine_stage)])


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


def execute_fused(plan, predicate: str, stats):
    """Run the fused chain; returns (result pairs [K, 2] int64, stats).

    Result rows reproduce the staged order exactly: TRUE_HIT pairs in
    frame order, then refined-true INDECISIVE pairs in frame order.
    Device copies the chain reads (interval lists, geometry) are uploaded
    before it starts. ``stats.t_sync`` times the final gather plus the
    float64 host re-check of the uncertain rows (their number is
    ``stats.extra["n_escalated"]``, the frame's ``stats.extra["n_frame"]``);
    the stage times are dispatch only. ``stats.extra`` also gets the
    chain's counts: ``refine_kernel_launches`` (launches of the fused
    refine kernel: 1 a join with the ``cuda`` refine backend, else 0),
    ``refine_chunks`` (the chunks the refine walked) of
    ``refine_chunk_rows`` rows and ``refine_chunks_live`` (those that hold
    an INDECISIVE row, from the gathered status lane). The kernel's unit is
    the row, and it counts the rows it refined on the card; that count
    comes back in the gather.
    """
    stage = JOIN_STAGES.stage
    n_packed = 0
    with JOIN_STAGES.record() as rec:
        with stage("upload"):
            plan.filter.to_device(plan.approx_r, plan.approx_s, plan.device)
            RF.device_geometry(plan.R, plan.device, kind=plan.r_kind)
            RF.device_geometry(plan.S, plan.device)
        cs = build_stage_plan(plan, predicate).run(stats=stats)
        _CHAINS.add(cs)
        with stage("sync"):
            stats.extra.update(n_frame=len(cs), n_escalated=0)
            if len(cs):
                frame = np.stack([cs.ri, cs.si], axis=1)
                walked = rec.get("refine_chunks")
                on_card = torch.is_tensor(walked)
                lanes = (cs.status, cs.hit, cs.unc)
                if cs.valid is not None:
                    lanes += (cs.valid,)
                with stage("sync.gather"):
                    got = to_host(*lanes, *((walked,) if on_card else ()))
                status_h, hit_h, unc_h = got[:3]
                valid_h = (got[3] if cs.valid is not None
                           else np.ones(len(cs), bool))
                if on_card:
                    rec["refine_chunks"] = int(got[-1][0])
                with stage("sync.recheck"):
                    if unc_h.any():
                        hit_h[unc_h] = RF.refine(plan.R, plan.S,
                                                 frame[unc_h],
                                                 predicate=predicate,
                                                 backend="numpy")
                stats.extra["n_escalated"] = int(unc_h.sum())
        if len(cs):
            with stage("collect"):
                indec = status_h == INDECISIVE
                n_packed = int(indec.sum())
                stats.n_candidates = int(valid_h.sum())
                stats.n_true_hits = int(np.sum((status_h == TRUE_HIT)
                                               & valid_h))
                stats.n_true_negs = int(np.sum((status_h == TRUE_NEG)
                                               & valid_h))
                stats.n_indecisive = int(np.sum(indec & valid_h))
                results = np.concatenate([frame[status_h == TRUE_HIT],
                                          frame[indec & hit_h]], axis=0)
                stats.n_results = len(results)
    stats.t_sync = rec["sync"]
    C = rec.get("refine_chunk_rows", 0)
    stats.extra.update(
        refine_kernel_launches=rec.get("refine_kernel_launches", 0),
        refine_chunks=rec.get("refine_chunks", 0), refine_chunk_rows=C,
        refine_chunks_live=-(-n_packed // C) if C else 0)
    if len(cs) == 0:
        return np.zeros((0, 2), np.int64), stats
    return results, stats
