#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; imports nothing of JAX or of the
reference package. Phases, any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (``build/kernels/``),
   one ``nvcc`` a source, all started together beside phase 3's host
   set-up: the join kernels are waited for before phase 3 launches one,
   the attention kernels (phase 9's alone) before phase 9;
3. hold the filter kernels against their plain PyTorch versions on the
   card, exactly: the trichotomy kernel, and the overlap kernel's AA join,
   on the first 65,536 candidate rows of the T1 x T2 join and on every
   row with a list wider than 256 intervals; the overlap kernel's AF and
   FA joins on every AA survivor; both kernels on 65,536 pair rows
   drawn at the window tiling's edges (``interval_join.cases``: widths 0,
   1, W - 1, W, W + 1, 2W + 1 for W 8, 16 and 32, 300 and 600, touching
   ends, lists at INT32_MIN and INT32_MAX, empty lists, F inside and
   outside A), paired as drawn and shuffled, and with an empty F store on
   either side; the compaction (scan) kernel, one cooperative launch a
   call, against its plain version and the stable-argsort oracle,
   ``perm`` and ``count`` exactly, on lanes of 0, 1, 257 and 4096 rows,
   all-true and all-false lanes, a random lane longer than 2^21, the
   lanes at its tiling's edges (``compact.cases``: 0, 1, 1023, 1024 and
   1025 rows set all, none, first, last or alternating, and 2^23 + 17
   rows, more tiles than one sweep of the resident grid) and the main
   path's INDECISIVE lane;
4. the main path, ``JoinPlan(R, S, filter="april", n_order=12)
   .build().execute("intersects")`` on the card with both backends
   ``"cuda"``: staged, once with the default join order and once with the
   degenerate order ("AA", "AF") that routes the filter through the
   overlap kernel; then fused (``pipeline_mode="fused"``) with
   ``mbr_backend`` ``"numpy"`` and ``"torch"``, and each fused chain's
   stages once more under ``torch.cuda.set_sync_debug_mode("error")``.
   Launch counts are reset before and read after each run. The staged
   runs' pairs and their order must equal the port's own numpy backends,
   the fused runs' the staged default run's, with the same ``JoinStats``
   counts; a sample of candidates must agree with the float64 per-pair
   oracle. The kernels' inputs are recorded from the runs themselves: the
   edge sweep's ragged CSR input in the staged runs
   (``refine.record_sweeps``; each staged run must make exactly one sweep
   launch, over every bucket's rows), each fused run's device frame and
   lanes (``fused.record_chains``). The sweep kernel is held exactly
   against its plain version on each recorded call; the trichotomy kernel
   on each fused run's whole frame
   (the status lane the run wrote must equal the plain version under its
   ``valid`` lane), the compaction kernel against its plain version
   and the argsort oracle on each fused run's INDECISIVE lane, and the
   fused refine kernel (B7) against the eager float64 cores on each fused
   run's chain, both lanes bit for bit, its own count of the rows it
   refined equal to the live prefix; each fused run makes one B7 launch
   (in every run of the script, one a compaction);
5. the RI path, ``JoinPlan(R, S, filter="ri", n_order=12)`` on the same
   datasets: the RI build (host set-up, timed on its own line) and the
   port's numpy RI verdicts of every candidate; the ALIGNEDAND kernel
   (``ri_trichotomy``) held exactly against its plain version on a random
   code-stream sweep (the stores' code bits replaced by random bits of
   three densities, re-encoding off and on, over the candidate frame and
   65,536 random rows) and on pair rows drawn at its merge's edges
   (``ri_and.cases``: lists of S - 1, S, S + 1 and 2S intervals for the
   skip's stride S = 8, fragments at every bit phase about one, two and
   three words long, 165-word fragments hit only in their last word, a hit
   only in the last fragment of a merge, lists the skip cuts by strides,
   ends at INT32_MIN and INT32_MAX, empty lists; re-encoding off and on,
   paired as drawn and shuffled; as drawn also against the verdicts the
   codes were made to give); then the join staged, fused with
   ``mbr_backend``
   ``"numpy"`` and fused with ``"torch"``, launch counts reset before and
   read after each run. The staged run's verdicts, replayed by the kernel
   on the frame it recorded (``ri.record_frames``), equal the plain
   version and the numpy verdicts row for row, and its result set equals
   the APRIL run's, and it makes one edge sweep launch, which equals its
   plain version on the call it recorded; the fused runs give the staged
   pairs, order and counts, their stages pass
   ``set_sync_debug_mode("error")``, and the kernel equals its plain
   version on each recorded frame;
6. the host filters ``none``, ``5cch``, ``ra`` and ``april-c`` at a third
   of the main path's counts, the ``DATASET_SPECS`` counts (T1 1200 x T2
   4000, ``n_order=12``), staged (one edge sweep launch each) and fused:
   each one's staged and fused pairs, order and counts equal, and equal
   as sets the APRIL result at
   that size;
7. the staged APRIL runs, the fused APRIL run and the staged RI run once
   more under ``torch.profiler``: device time per kernel and the device
   busy share of the host wall time (the RI kernel must show launches,
   the fused run one launch of the one compaction kernel);
8. each kernel timed at the main path's shapes with CUDA events beside
   its plain version and, for the scan, the library calls that compute the
   same function (a stable ``torch.argsort`` and a sum, ``library_ms``)
   and the scan alone (``torch.cumsum``, printed beside it), the kernel
   and the library calls also on the device alone (``device_ms``,
   ``library_device_ms``); the RI kernel on the staged run's frame on the
   device alone, on its TRUE_NEG, TRUE_HIT and INDECISIVE rows apart
   (printed), and on the fused torch-MBR run's frame; the edge
   sweep on the one call of the default staged run, also on the device
   alone, its byte bound from the CSR (16 bytes a kept edge, 16 a row of
   offsets, 2 a row of lanes); the interval joins on the device alone
   (``device_ms``): the trichotomy kernel over the main frame, and over
   the fused torch-MBR run's frame with its own byte bound; the overlap
   kernel over the main frame (AA), and as the degenerate order launches
   it (AA over the frame, AF over the AA survivors) with the bound of both
   launches; after the frames' list widths (mean, p99 and max of nx + ny
   a join, read on the card); B7 on the fused numpy-MBR run's chain,
   beside the eager cores (``plain_ms``) and its float64 bound (every
   couple walked, at 34 TFLOP/s; phases 10 and 11 add its within,
   selection and linestring rows);
10. (run after phase 8, before phase 9) the ``within`` and ``selection``
   joins and the staged float64 device refine: APRIL within, water bodies
   T2 (phase 4's S and its store, through ``JoinPlan.build(prebuilt=...)``)
   x zip codes T10 (``DATASET_SPECS``' ratio, 900 at the default counts),
   staged with ``"cuda"`` and fused with ``mbr_backend`` ``"numpy"``,
   both first and under ``torch.profiler`` (each trace must show its one
   launch of B4, or of B3), then staged with ``refine_backend=
   "device64"`` and fused with ``mbr_backend`` ``"torch"``, each run's
   pairs, order and counts equal to the port's staged numpy run; APRIL
   selection (the zip codes as query polygons)
   staged and fused, likewise; APRIL intersects at T1 x T2 with
   ``"device64"``, equal to phase 4's default run; the ``ri``, ``ra``,
   ``5cch``, ``april-c`` and ``none`` within joins at a ninth of the
   counts (``WITHIN_HOST_SCALE``), staged and fused, each giving APRIL's
   within result set. Launch counts are reset before and read after each
   run: B4 once in each APRIL within run, B2 once a staged ``cuda`` refine
   call, B3 once a fused run, B1 in ``selection``. Every run records the
   inputs its kernels were given (``join.record_joins()``,
   ``refine.record_sweeps()``, ``fused.record_chains()``), and each kernel
   is then held exactly to its plain version on every one of them: B1 and
   B4 on every interval-join call (the whole frame of a fused run, the
   decoded lists of APRIL-C), B2 on every sweep, B3 on every fused chain's
   INDECISIVE lane; each fused APRIL run's status lane must equal the plain
   lane over its frame, and its stages pass
   ``set_sync_debug_mode("error")``. Each run prints its candidates,
   verdict mix, result pairs and stage times, beside the card's name and
   power limit; the within kernels are timed on the device alone and
   their rows of the ``kernels`` line gain the within launches;
11. (run after phase 10, before phase 9) the ``linestring`` joins
   (polygon x linestring, §4.3.3): roads or rivers, the T8 chains
   (``make_linestrings("T8", seed=3, count=12000)`` at the default
   counts), x water bodies T2 (phase 4's S, its APRIL store and phase 5's
   RI store reused through ``JoinPlan.build(prebuilt=...)``, so only the
   line stores are built, each timed on its own line), ``r_kind="line"``:
   APRIL staged with ``"cuda"`` and fused with ``mbr_backend``
   ``"numpy"``, both first and under ``torch.profiler`` (the traces must
   name B4, and B3 once), staged with ``refine_backend="device64"`` and
   fused with ``mbr_backend`` ``"torch"``, each run's pairs, order and
   counts equal to the port's staged numpy run, and 512 sampled
   candidates equal to the float64 per-pair oracle; RI (every line cell
   Weak) staged and fused, equal to its staged numpy run, whose set is
   APRIL's; ``ra``, ``5cch``, ``april-c`` and ``none`` at a ninth of the
   counts (``WITHIN_HOST_SCALE``), staged and fused, each giving APRIL's
   result set. Launch counts are reset before and read after each run:
   B4 twice in each APRIL run (C x A(s) over the frame, C x F(s) over its
   survivors, or over every row when fused), B2 once a staged ``cuda``
   refine call (every chain edge x every ring edge, no closing edge), B3
   once a fused run, B5 once in each RI run. Every run records its
   kernels' inputs, and B4, B2, B3 and B5 are held exactly to their plain
   versions on all of them; each fused APRIL and RI run's status lane
   equals the plain lane under its ``valid`` lane and its stages pass
   ``set_sync_debug_mode("error")``. Each run prints its candidates,
   verdict mix, result pairs and stage times beside the card's name and
   power limit; the kernels are timed on the device alone and their rows
   of the ``kernels`` line gain the linestring launches, device times and
   bounds;
12. (run after phase 11, before phase 9) the construction paths: every
   filter's ``build_backend="torch"`` build (the batched build with its
   gap-head PiP or box clip pass on the card) at full size, APRIL and RI
   of T1 x T2 (3600 x 12000 at the default counts, ``n_order`` 12), APRIL
   of the zip codes (T10, 900) and RA and 5C+CH at phase 6's counts, each
   store identical (every array's dtype, shape and bytes) to the numpy
   store its phase built; the seconds of each build stage (``dda``,
   ``scanline``, the device pass ``pip`` or ``clip``, ``pack``; RA ``fit``,
   5C+CH ``pentagon`` and ``hull``; ``geometry.BUILD_STAGES``) for the
   numpy build (recorded in phases 3, 5, 6 and 10) and the torch build,
   beside the card's name and power limit; the device busy share of two
   torch builds under ``torch.profiler`` (RI's and APRIL's of phase 6's
   T1); the ``intersects`` join of the plan whose APRIL stores the
   torch build made, its pairs, order and counts equal to phase 4's
   default run, with B1 and B2 launched; then, on a prefix
   (``CONSTRUCTION_PREFIX``: T1 polygons, T8 chains of phase 11), every
   filter's ``torch`` and ``sequential`` builds, polygon and line, and
   APRIL's per-polygon methods ``pips``, ``neighbors`` (on the first
   ``NEIGHBORS_PREFIX`` polygons), ``scanline`` and ``floodfill``, each
   identical to the numpy build of the same prefix.
   No kernel runs in the builds: they hold nothing against a plain
   version;
13. (run after phase 12, before phase 9) the online join service
   (``JoinService``) with water bodies T2 (phase 4's S) registered at the
   main path's order and queries drawn from the landmarks T1 (phase 4's
   R) by ``launch.serve_join.make_trace`` (the reference's predicate mix:
   selection, window, intersects, within), drained every 16 requests
   (``SERVICE_GROUP``), with an insert and a delete every 25
   (``SERVICE_MUTATE``). APRIL staged (``cuda`` backends, its first drain
   profiled) and fused services take the same 256 requests; every ticket
   must equal a one-request run (filter ``none``, numpy backends) over the
   dataset as it stood at its drain, and the fused tickets the staged
   ones, pairs and order. RI staged and fused services (seeded with
   copies of phase 5's T2 store) take the first 32. Then the patched
   stores must equal fresh torch builds over the mutated dataset, every
   array in dtype, shape and bytes, and so must the device copies the
   last drain used (the interval lists and their row keys, RI's device
   store), and the MBR index a fresh index. An adaptive service
   (``plan_mode="adaptive"``, replanning after 4 mutations) takes the
   first 192 requests and must replan on drift, with the static pair
   sets; a checkpoint of the staged service restores into a new one,
   which must answer 64 requests alike; under a budget of one store,
   warming a second dataset's store must evict and lower
   ``torch.cuda.memory_allocated``; ``run_serve`` drives 500 requests
   through the background worker (figures, not gates). Launch counts are
   reset before and read after each trace, and every recorded B1, B4, B2,
   B3 and B5 input is replayed against its plain version, exactly;
14. (run after phase 13, before phase 9) the scale-out path: the
   partitioned launcher (``launch.spatial_join.run_join``, 2 x 2
   partitions) at phase 6's counts (T1 1200, T2 4000), fused (profiled
   first), with the sharded stages (``cuda`` filter, ``torch`` MBR lane,
   ``device64`` refine) and a checkpoint, rerun to resume every
   partition, staged ``cuda``, adaptive and RI with the torch build, each
   with phase 6's pair set; the sharded fused chain of partition 0 once
   more under ``set_sync_debug_mode("error")``;
   two gloo ranks on the one card (child processes of this script, a
   ``FileStore``) run the four sharded stages on partition 0, each rank's
   outputs equal to its world-of-one outputs; the out-of-core tiled join
   (``scaleout.tiled_join``) over chunk streams of 400 at a ninth of the
   main counts (``WITHIN_HOST_SCALE``: T1 400, T2 1333; a budget a sixth
   of the plan's estimated bytes, so at least 4 tiles and a skew split),
   staged and fused, each
   with the pair set of the in-memory staged ``cuda`` ``JoinPlan`` over
   ``make_chunked_dataset``, then static balance, and a run stopped after
   2 tiles and resumed, arrays equal to a clean run.
   Launch counts are reset before and read after each run and every
   recorded B1, B4, B2, B3 and B5 input is replayed against its plain
   version, exactly;
15. (run after phase 14, before phase 9) the LM serving path
   (``repro_torch.models``, ``launch.serve``), f32, plain PyTorch ops:
   no kernel of the port runs, so the ``kernels`` line gains no row.
   gemma2-2b at full width (``CONFIG``: 26 layers, d 2304, 8 heads over 4
   kv heads, local 4096 and global layers, softcaps 50 and 30, vocab
   256,000), its weights drawn from a seed on the card once and copied to
   the CPU: request 0's
   prefill logits (``make_prefill_step``) and first ``LM_DECODE_CHECKED``
   decode logits on the CPU, then on the card after the model is moved
   there, within ``LM_TOL``; 8 requests (prompts of 4-9 tokens, 12 new,
   the reference launcher's defaults, ``LM_POOLS``) through a
   ``ServePool`` of 4 slots at ctx 64, every request served (none
   evicted) with the tokens of its isolated greedy decoding on the card,
   a differing token allowed only where the isolated run's top-2 logit
   gap is below ``LM_TIE_GAP`` (that request's comparison stops there;
   the count is printed), and ``greedy_generate`` equal to request 0's
   isolated decoding; recurrentgemma-2b at full width, 5 requests through
   2 slots (``tests/test_serve_pool.py``'s), likewise, so slot reuse
   leaks no recurrent state; decode reproducing the full-sequence
   forward (B 2, S 12, ``LM_TOL``) at full width for granite-moe (its
   capacity factor raised, as the reference's test does), falcon-mamba,
   whisper-small and llama-3.2-vision, weights drawn on the card, each
   freed before the next (deepseek-coder-33b and qwen3-moe exceed the
   card in f32: the reason is printed); all 10 smoke configs, decode
   against forward on the card and the card against the CPU. Printed,
   not gated: tokens/s and ms a step of each pool, one profiled pool
   step's device busy share, peak device memory a model, the phase's
   seconds, beside the card's name and power limit;
16. (run after phase 15, before phase 9, in a child process of this
   script, as phase 9: late in a long process the profiler records no
   device events, and a fresh context has the whole card) LM training
   (``models.train``, ``optim``, ``launch.train``), f32 without TF32,
   plain PyTorch ops and autograd: no kernel of the port runs (a profiled
   step's trace must name none), so the ``kernels`` line gains no row.
   (a) all 10 smoke configs: one ``make_train_step(remat_policy="dots")``
   step on the card and one on the CPU from the same weights and batch,
   the loss and ``grad_norm`` within ``TRAIN_REL_TOL`` (relative), the
   parameters within 2.5 lr, the first moments (``m`` = 0.1 g) leaf by
   leaf within ``TRAIN_M_TOL`` of each leaf's largest; (b) gemma2-2b at
   full width, weights drawn on the card, ``SyntheticCorpus`` batches of
   ``TRAIN_SHAPE`` (2 x 512, cut from ``train_4k``'s 256 x 4096): the
   first step's forward and backward under the remat policies ``none``,
   ``dots`` and ``nothing`` agree within ``TRAIN_REL_TOL``, and the
   memory the forward leaves allocated for the backward falls from
   ``none`` to ``dots`` to ``nothing`` (that and the peak of each
   printed), then 8 steps at lr 3e-4 with every loss finite and the last
   below the first, one profiled step, and the first step again in two
   strided microbatches equal to it (loss and ``grad_norm`` within
   ``TRAIN_REL_TOL``, parameters within 2.5 lr, ``m`` as in (a)); (c) granite-moe-1b-a400m (the MoE backward and its
   aux loss) and recurrentgemma-2b (the doubling scan's backward) at full
   width, 3 steps each, finite losses, one profiled step; (d) the
   launcher, ``train_loop("smollm-135m", smoke=False, steps=12, batch=4,
   seq=256, ckpt_every=4)``, uninterrupted, then crashed at step 9 with
   a checkpoint directory (it must raise), then resumed from the step-8
   checkpoint: the resumed run takes steps 8-11, and its losses equal the
   uninterrupted run's last 4 within ``TRAIN_RESUME_TOL``. Printed, not gated: ms a step, tokens/s, model
   FLOPs a step (6 N T plus the attention products) over the step time
   as a share of the f32 peak, peak device memory, the busy share of a
   profiled step, the phase's seconds, beside the card's name and power
   limit;
17. (run after phase 16, before phase 9, in gloo ranks that are child
   processes of this script on ``cuda:0``) the sharded LM step
   (``models.sharding``, ``models.parallel``, ``launch.mesh``,
   ``runtime.elastic``, ``launch.dryrun``), f32 without TF32, plain PyTorch
   ops and hand-written collectives: no kernel of the port runs, so the
   ``kernels`` line gains no row. (a) gemma2-2b at full width cut to 4
   layers (two local/global cycles), ``TRAIN_SHAPE`` batch, lr 1e-3: one
   single-card step, then 2 ranks as a 1 x 2 mesh (tensor parallel); the
   loss within 1e-4, ``grad_norm`` within ``TRAIN_REL_TOL`` and every
   gathered parameter within 5e-3 of the single step's (the reference's
   ``tests/test_model_distributed.py`` bounds), and every gathered first
   moment, leaf by leaf, within ``TRAIN_M_TOL`` of its largest entry
   (``_m_err``: one step moves each weight by about lr whatever its
   gradient, so only the moments see a misrouted gradient shard); (b)
   gemma2-2b at full depth on the 1 x 2 mesh, 3 steps: finite losses, the
   first within ``TRAIN_REL_TOL`` of phase 16's first single-card step on
   the same weights and batch; (c) smollm-135m at full width on 2 x 1 and on
   2 x 2 (4 ranks) against the single-card step under (a)'s bounds, then
   ``train_loop(mesh=...)`` on 2 x 2 crashed at step 3 and resumed from its
   step-2 checkpoint on the 2 x 1 mesh the two survivors form
   (``make_mesh_from_devices``), the losses within ``TRAIN_RESUME_TOL`` of
   phase 16's uninterrupted single-card run of the same launcher (the
   survivors form a new gloo group in the same processes); (d) beside (c),
   in a process of its own, the dry run of gemma2-2b ``train_4k`` on the
   production mesh (16 x 16, bf16, sequence parallel) and of (b)'s cell (2 x
   512 on 1 x 2, f32). Printed, not gated: ms a step, tokens/s, collective
   bytes a step and rank by kind, peak device memory a rank, each dry-run
   cell's three terms beside (b)'s measured step, the phase's seconds,
   beside the card's name and power limit;
18. (run after phase 11, before phase 12; it builds nothing) the
   raw-store filter wrappers of ``core.join`` with ``backend="cuda"`` on
   the stores and candidate rows of earlier phases: ``april_filter_batch``
   over phase 4's T1 x T2 stores and every candidate row (the full order:
   one trichotomy launch; ``("AA", "AF")``: two overlap launches),
   ``within_filter_batch`` over phase 10's T2 x T10 stores and within
   candidates (one overlap launch), ``linestring_filter_batch`` over phase
   11's chains x T2 (two), each's launches counted and its verdicts held
   bit for bit to the staged rows function's plain versions on the lists
   the joins used; then ``examples_torch/quickstart.py`` in a child
   process on the card (T1 300 x T2 500, ``n_order`` 9), whose ``none``,
   ``april`` and ``ri`` joins must give the same pairs; the phase's seconds
   beside its budget (``HELPERS_BUDGET_S``) and the card;
9. (in a child process of this script, after phases 10, 11 and 12: late in
   a long process the card machine's profiler records no device events) the
   APRIL block-sparse attention kernels (``april_attention``, the LM
   bridge; no join runs it: bf16 on the tensor cores, f32 on the CUDA
   cores): on the test grid (``TEST_GRID``: the reference's cases from
   ``tests/test_kernels.py``, BH 2, S 256, D 64, blocks 64, f32 and bf16,
   causal, local 96, local 64 with softcap 30 and full, causal at D 32
   with blocks 128/64 and 64/128; then f32 and bf16 at D 256 and D 128,
   blocks 128, and bf16 with kv blocks of 96) against the plain version and
   the dense oracle, at 2e-5 in f32 and 2e-2 in bf16, atol and rtol, as the
   reference's tests state, and bf16 also on the row error; both kernels'
   registers, spills and shared memory a instance (``kernel_attrs``; no
   f32 instance may spill); every f32 instance on ``F32_INSTANCE_CASES``
   at 2e-5; then at full width, bf16, blocks 128, against the
   plain version with the launch count reset before and read after each
   call:
   qwen1.5-4b's causal layer in f32 for the CUDA-core kernel (20 heads, S
   4096, D 128), then in bf16 gemma2-2b's local layer (8 heads over 4 kv
   heads repeated, S 32768, D 256, window 4096, softcap 50), its global
   layer (causal, softcap 50, S 8192) and the qwen layer. Each
   head's q is drawn at a logit std from ``ATTN_TEMPS`` (1 to 12), so hot
   heads reach the softcap's range. bf16 outputs are gated on the row
   error (``row_rel_err``, at most ``ROW_REL_TOL``), and wrong versions
   of the plain function (one kv block dropped, the softcap off, the
   window one key longer) must read above that gate. Each layer is timed
   beside one PyTorch call for the same function (``library_ms``):
   ``scaled_dot_product_attention`` for qwen, compiled ``flex_attention``
   with the softcap as ``score_mod`` for gemma2-2b; the gemma2-2b local
   call and the qwen f32 call run once more under ``torch.profiler``,
   whose trace must name the tensor-core kernel, or the CUDA-core kernel,
   once; each layer's kernel and library call are also timed on the
   device alone (``_device_ms``).

Every kernel's row of the JSON ``kernels`` line carries ``tol``: 0 for the
exact kernels, which must have ``max_abs_err <= tol``; the attention
kernel's row carries its row error ``rel_err``, which must be at most
``tol`` (``ROW_REL_TOL``), and ``kernel``, the name of the kernel that
ran.

Each phase prints its seconds. The last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet) for the roofline bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: the non-tensor float64 peak, B7's bound
F64_OPS_PER_S = 34e12
#: float64 operations of B7: per (a edge, b edge) couple, four guarded
#: orientations; per (point, edge) term of a point-in-polygon test
REFINE_OPS_PER_COUPLE = 44
REFINE_OPS_PER_PIP = 15
#: the bf16 tensor-core peak, the least time the attention could take
BF16_OPS_PER_S = 989e12
#: float32 operations per (a edge, b edge) couple of the sweep: 4 x 7 for
#: the orientations, 4 sign tests, 11 scale, 7 mag, 3 tol, 8 near0, 16 boxes
SWEEP_OPS_PER_COUPLE = 77
#: first candidate rows held against the plain versions in phase 3
COMPARE_ROWS = 65536
#: timed calls per kernel and plain version in phase 8
REPS = 5
#: the port's own kernels, by the names the profiler's trace gives them
PORT_KERNELS = ("april_trichotomy_kernel", "interval_overlap_kernel",
                "edges_intersect_kernel", "compact_mask_kernel",
                "ri_trichotomy_kernel", "april_attention_kernel",
                "april_attention_tc_kernel", "fused_refine_kernel")
#: profiler sessions taken before a kernel that a trace must name counts
#: as absent (``_profile_showing``)
PROFILE_TRIES = 5
#: pair rows and seed of the interval joins' sweep at the window tiling's
#: edges (``kernels.interval_join.cases``)
JOIN_SWEEP_ROWS = 65536
JOIN_SWEEP_SEED = 17
#: random rows and code-bit densities of the RI kernel's stream sweep
RI_SWEEP_ROWS = 65536
RI_SWEEP_DENSITIES = (0.002, 0.05, 0.5)
#: pair rows and seed of the RI kernel's sweep at its merge's edges
#: (``kernels.ri_and.cases``), each re-encoding
RI_CASE_ROWS = 16384
RI_CASE_SEED = 19
#: the host filters run at the main path's counts over this (DATASET_SPECS
#: has T1 1200 and T2 4000, a third of the smoke's 3600 x 12000)
HOST_SCALE = 3
#: phase 10's host filters and phase 14's tiled join run at a further
#: third of that (T2 1333 x T10 100 at the default counts): RI's build of
#: the zip codes alone took about 52 s at 4000 x 300 on the card
#: machine's host
WITHIN_HOST_SCALE = 3 * HOST_SCALE
#: phase 12's prefix (T1 polygons, T8 chains) for the sequential builds and
#: APRIL's per-polygon methods, which are Python loops; APRIL's
#: ``neighbors`` (a neighbour walk a gap, about 0.2 s a T1 polygon at
#: order 12 on the card machine's host) runs on the first of them only.
#: Cut from (60, 400) and 20 to make room for phase 13
CONSTRUCTION_PREFIX = (30, 200)
NEIGHBORS_PREFIX = 10
#: phase 13, the join service: requests of the APRIL trace (staged and
#: fused services), of the RI trace, of the adaptive trace (a prefix of
#: the APRIL trace) and of the checkpoint round trip; requests a drain
#: takes; an insert and a delete every SERVICE_MUTATE requests; the
#: requests run_serve drives through the background worker. These
#: traces and phase 14's runs are sized for the script's 1200 s limit on
#: the slowest card machine seen (PERF.md, "Findings")
SERVICE_REQUESTS = 256
SERVICE_RI_REQUESTS = 32
SERVICE_ADAPTIVE_REQUESTS = 192
SERVICE_CKPT_REQUESTS = 64
SERVICE_GROUP = 16
SERVICE_MUTATE = 25
SERVICE_REPLAN_AFTER = 4
SERVE_REQUESTS = 500
SERVICE_SEED = 29
#: phase 14, the scale-out path: the launcher's partitions a side; the
#: tiled join's chunk size, its budget a share of the plan's estimated
#: bytes, the tiles it must give and its split settings; the seconds the
#: two rank processes may take
SCALEOUT_PARTS = 2
SCALEOUT_CHUNK = 400
SCALEOUT_BUDGET_SHARE = 6
SCALEOUT_MIN_TILES = 4
SCALEOUT_SPLIT = {"split_factor": 1.0, "min_split_objs": 32}
SCALEOUT_RANK_TIMEOUT = 300
#: phase 15, the LM serving path: (requests, slots, context, new tokens a
#: request) of each full-width pool: the reference launcher's defaults
#: for gemma2-2b (prompts of 4-9 tokens), ``tests/test_serve_pool.py``'s
#: for recurrentgemma-2b (prompts of 6)
LM_POOLS = {"gemma2-2b": (8, 4, 64, 12), "recurrentgemma-2b": (5, 2, 32, 6)}
#: a pool's token may differ from its request's isolated decoding only at
#: a step where the isolated run's top-2 logit gap is below this (f32: the
#: batch size changes the matmuls' summation order)
LM_TIE_GAP = 1e-3
#: f32 logits, absolute and relative: the card against the port's CPU run,
#: and decode against the full-sequence forward (the bound of the
#: reference's ``tests/test_arch_smoke.py``)
LM_TOL = 2e-3
#: gemma2-2b's decode steps held to the CPU run, after its prefill
LM_DECODE_CHECKED = 4
#: decode against forward: batch and sequence, and the configs run at full
#: width; the two whose f32 weights exceed the card run at smoke width
LM_DECODE_SHAPE = (2, 12)
LM_FULL_DECODE = ("granite-moe-1b-a400m", "falcon-mamba-7b",
                  "whisper-small", "llama-3.2-vision-11b")
LM_SMOKE_ONLY = ("deepseek-coder-33b", "qwen3-moe-30b-a3b")
#: phase 16, LM training (f32, no TF32): batch and sequence of the
#: full-width steps, cut from the ``train_4k`` cell's 256 x 4096 to fit one
#: card and the script's time; gemma2-2b's steps and learning rate; the
#: steps of each model of the full-width backward check; the launcher's
#: full-width run, the step its crash is injected at and its resume bound
#: (``tests/test_fault_tolerance.py::test_crash_resume_equivalence``'s)
TRAIN_SHAPE = (2, 512)
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
TRAIN_BACKWARD = {"granite-moe-1b-a400m": 3, "recurrentgemma-2b": 3}
TRAIN_LAUNCH = dict(smoke=False, steps=12, batch=4, seq=256, ckpt_every=4)
TRAIN_FAIL_AT = 9
TRAIN_RESUME_TOL = dict(rtol=1e-4, atol=1e-5)
#: relative bound on a step's loss and ``grad_norm``: the card against the
#: port's CPU run, a microbatched step and each remat policy against the
#: plain one (f32: summation order only; at most 1.5e-7 measured on the
#: H100)
TRAIN_REL_TOL = 1e-5
#: bound on a first-moment leaf's max abs difference, relative to the
#: leaf's largest entry: the card against the CPU, and a microbatched
#: step against one batch (a flipped sign gives 2, a lost 1/N scale or a
#: lost microbatch about 1)
TRAIN_M_TOL = 1e-4
#: the smoke configs' card-against-CPU step: learning rate and batch shape
TRAIN_SMOKE_LR = 1e-3
TRAIN_SMOKE_SHAPE = (2, 16)
#: phase 17, the sharded step (gloo ranks on the one card): gemma2-2b's
#: depth in the equality check (two local/global cycles), the learning
#: rate, the loss and parameter bounds of the reference's
#: ``tests/test_model_distributed.py``, the full-depth steps, the
#: launcher's run (crash at step 3, checkpoints every 2), a rank's time
#: limit
SHARDED_LAYERS = 4
SHARDED_LR = 1e-3
SHARDED_LOSS_TOL = 1e-4
SHARDED_PARAM_TOL = 5e-3
SHARDED_STEPS = 3
SHARDED_LAUNCH = dict(smoke=False, steps=4, batch=4, seq=256, ckpt_every=2)
SHARDED_FAIL_AT = 3
SHARDED_RANK_TIMEOUT = 400
#: phase 18, the raw-store wrappers and the quickstart example: the
#: phase's budget (printed beside its seconds) and the example's time limit
HELPERS_BUDGET_S = 40
QUICKSTART_TIMEOUT = 300
COUNTS = ("n_candidates", "n_true_hits", "n_true_negs", "n_indecisive",
          "n_results")
#: logit std of each head of the full-width draws (q is drawn at these
#: multiples of a unit normal, cycling over the heads): cool heads spread
#: their softmax over thousands of keys, hot ones reach the softcap's range
ATTN_TEMPS = (1.0, 1.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0)
#: full-width attention layers from the repo's configurations: (label,
#: dtype, query heads, kv heads, S, D, mask_kind, window, softcap, seed);
#: blocks 128 x 128. bf16 runs on the tensor cores; the qwen layer in f32
#: times the CUDA-core kernel. The two profiled layers come first: after
#: ``torch.compile`` has built a yardstick, a profiler session in this
#: process can record no device event at all
ATTN_SHAPES = (
    ("qwen1.5-4b causal f32", "float32", 20, 20, 4096, 128, "causal", 0,
     None, 23),
    ("gemma2-2b local", "bfloat16", 8, 4, 32768, 256, "local", 4096, 50.0,
     21),
    ("gemma2-2b global", "bfloat16", 8, 4, 8192, 256, "causal", 0, 50.0,
     22),
    ("qwen1.5-4b causal", "bfloat16", 20, 20, 4096, 128, "causal", 0, None,
     23),
)


#: the f32 attention kernel's small cases, run at every instance (head
#: width x q block): (S, block_kv, mask_kind, window, softcap)
F32_INSTANCE_CASES = ((512, 64, "causal", 0, None),
                      (384, 96, "local", 100, 30.0))


def _ms(fn) -> float:
    """Mean device milliseconds of ``fn`` over ``REPS`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _device_ms(fn) -> float:
    """Mean device milliseconds of one ``fn`` call over ``REPS`` calls, each
    enqueued behind a sleep kernel, so that the events around it time the
    device and not the host's enqueue (the host work of a call is in
    ``_ms``)."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(REPS):
        torch.cuda._sleep(20_000_000)       # about 10 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / REPS


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device events
    of its Chrome trace: microseconds per kernel name and per copy kind,
    the device busy share of the host wall time, and the port's own
    kernels' microseconds and launches.

    A profiler session that starts tracing and recording at once loses
    its first device record late in this script (a memcpy, or the kernel
    itself when it came first). So the trace starts on a warm-up step that
    runs one small device op, and ``fn`` runs alone in the one active step
    after it, whose trace is read. Such a session still loses records now
    and then (all of them, or the kernel alone), which
    ``_profile_showing`` takes again."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traces = []

    def keep(prof) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            trace = str(Path(tmp) / "trace.json")
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                traces.append(json.load(f)["traceEvents"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=keep) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    if len(traces) != 1:
        raise AssertionError(f"the profiler gave {len(traces)} traces, not 1")
    events = traces[0]
    by_name: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = e["cat"]
            if key == "kernel":     # the name without its argument list
                key = e["name"].replace("(anonymous namespace)::", "")
                key = key.split("(")[0][:100]
            by_name[key] = by_name.get(key, 0.0) + float(e.get("dur", 0.0))
            calls[key] = calls.get(key, 0) + 1
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    ours: dict[str, list] = {}
    for key, us in by_name.items():
        # a template kernel's trace name carries "void " and its arguments
        base = key.removeprefix("void ").split("<")[0]
        if base in PORT_KERNELS:
            acc = ours.setdefault(base, [0.0, 0])
            acc[0] += us
            acc[1] += calls[key]
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_busy_share": busy / wall_us, "top_device_us": top,
            "port_kernels_us_and_launches": ours}


def _profile_showing(label, fn, kernel, launches=None) -> dict:
    """``_profile(fn)``, printed, until its trace names ``kernel`` (as
    many as ``launches`` times, when given): a trace without it is taken
    again, ``PROFILE_TRIES`` sessions in all, since a session can lose
    device records; a trace can lose launches but never add them, so a
    count other than ``launches`` fails at once."""
    for attempt in range(1, PROFILE_TRIES + 1):
        prof = _profile(fn)
        print(f"profile [{label}]: {json.dumps(prof)}", flush=True)
        seen = prof["port_kernels_us_and_launches"].get(kernel, [0.0, 0])[1]
        if seen and launches not in (None, seen):
            raise AssertionError(f"[{label}] the profile shows {seen} "
                                 f"{kernel} launches, not {launches}")
        if seen:
            return prof
        print(f"profile [{label}]: session {attempt} of {PROFILE_TRIES} "
              f"shows no {kernel} launch", flush=True)
    raise AssertionError(f"[{label}] the profile shows no {kernel} launch "
                         f"in {PROFILE_TRIES} sessions")


def _reset(wrappers) -> None:
    for fn in wrappers:
        fn.launches = 0


def _launched(label, wrappers) -> dict:
    """The launch counts of ``wrappers`` by name, read after a run. A fused
    chain with the ``cuda`` refine compacts its INDECISIVE rows once (B3)
    and refines them in one launch (B7), so the two counts must match."""
    got = {fn.__name__: fn.launches for fn in wrappers}
    b3, b7 = got.get("compact_mask", 0), got.get("fused_refine_rows", 0)
    if b3 != b7:
        raise AssertionError(f"[{label}] {b7} fused_refine launches for {b3} "
                             f"compactions, not one a fused cuda chain")
    return got


def _same_run(label, res, st, want, want_st) -> None:
    """Pairs, their order and the five JoinStats counts equal."""
    if res.shape != want.shape or not np.array_equal(res, want):
        raise AssertionError(f"[{label}] pairs or their order differ")
    for k in COUNTS:
        if getattr(st, k) != getattr(want_st, k):
            raise AssertionError(f"[{label}] {k} differs")


def _pair_set(res) -> set:
    return set(map(tuple, res.tolist()))


def _sync_checked(run, label, status, predicate="intersects") -> None:
    """The fused chain's stages once more, where any host sync before the
    gather raises; they must write the same status lane."""
    import torch
    from repro_torch.spatial import fused
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fused.build_stage_plan(run, predicate).run()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    if not torch.equal(again.status, status):
        raise AssertionError(f"[{label}] the sync-checked chain wrote "
                             "another status lane")


def _one_sweep(label, launches, sweeps) -> None:
    """A staged run's refine made one edge sweep call, through the kernel,
    over a CSR input it recorded."""
    n = launches["edges_intersect_csr"]
    if n != 1 or len(sweeps) != 1:
        raise AssertionError(f"[{label}] {n} edge sweep launches over "
                             f"{len(sweeps)} recorded calls, not 1 and 1")


def _ri_bound_bytes(x, y, ri, si, xor_y) -> int:
    """Bytes the RI filter must move over rows (ri, si), each input read
    once: the row indices and the verdicts; the offset entries that bound
    the interval lists of the objects the rows name; the start and end of
    each of those intervals; and, of the fragments up to each row's first
    hit (the merge stops there), each interval's bit offset and the code
    words they cover on both sides."""
    import torch
    from repro_torch.kernels.ri_and.ref import (_unbiased, _word_buckets,
                                                aligned_and_plain,
                                                ri_fragments_plain)
    n = ri.numel()
    dev = ri.device
    ux, uy = torch.unique(ri), torch.unique(si)
    n_off = sum(torch.unique(torch.cat([u, u + 1])).numel()
                for u in (ux, uy))
    n_int = int((x.off[ux + 1] - x.off[ux]).sum()
                + (y.off[uy + 1] - y.off[uy]).sum())
    b, gx, gy, lo, hi = ri_fragments_plain(x, y, ri, si)
    n_bits = 3 * (hi - lo)
    x_bit = x.bit_off[gx] + 3 * (lo - _unbiased(x.starts[gx]))
    y_bit = y.bit_off[gy] + 3 * (lo - _unbiased(y.starts[gy]))
    hit = torch.zeros(b.numel(), dtype=torch.bool, device=dev)
    for sel in _word_buckets((n_bits + 31) // 32):
        hit[sel] = aligned_and_plain(x.words, x_bit[sel], y.words, y_bit[sel],
                                     n_bits[sel], xor_y)
    f = torch.arange(b.numel(), device=dev)
    first = torch.full((n,), b.numel(), dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, b[hit], f[hit], "amin")
    need = f <= first[b]
    n_bit_off = sum(torch.unique(g[need]).numel() for g in (gx, gy))
    words = 0
    for st, bit in ((x, x_bit[need]), (y, y_bit[need])):
        # the union of the word ranges [bit / 32, (bit + n_bits - 1) / 32]
        diff = torch.zeros(st.words.numel() + 1, dtype=torch.int32,
                           device=dev)
        ones = torch.ones(bit.numel(), dtype=torch.int32, device=dev)
        diff.index_add_(0, bit >> 5, ones)
        diff.index_add_(0, ((bit + n_bits[need] - 1) >> 5) + 1, -ones)
        words += int((torch.cumsum(diff, 0) > 0).sum())
    return (n * (16 + 1) + 8 * (n_off + n_int + n_bit_off) + 4 * words)


def _ri_sweep(X, Y, rows_list, dev) -> int:
    """The RI kernel against its plain version, exactly, with the stores'
    code streams replaced by random bits of each density, re-encoding off
    and on; returns the rows compared."""
    import torch
    from repro_torch.kernels.ri_and import (pack_stream_words, ri_trichotomy,
                                            ri_trichotomy_plain)
    rng = np.random.default_rng(13)
    n = 0
    for dens in RI_SWEEP_DENSITIES:
        xr, yr = (st._replace(words=torch.from_numpy(pack_stream_words(
            (rng.random(int(st.bit_off[-1])) < dens).astype(np.uint8)))
            .to(dev)) for st in (X, Y))
        for xor_y in (False, True):
            for rows in rows_list:
                got = ri_trichotomy(xr, yr, *rows, xor_y)
                want = ri_trichotomy_plain(xr, yr, *rows, xor_y)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"ri_trichotomy kernel != plain version on random "
                        f"codes of density {dens}, xor_y={xor_y}")
                n += rows[0].numel()
    return n


def _ri_case_sweep(dev) -> str:
    """The RI kernel against its plain version, exactly, on the pair rows
    ``kernels.ri_and.cases`` draws at the merge's edges
    (``RI_CASE_ROWS``, re-encoding off and on, paired as drawn and
    shuffled), and as drawn against the verdicts the codes were made to
    give. Returns a printable line."""
    import torch
    from repro_torch.kernels.ri_and import ri_trichotomy, ri_trichotomy_plain
    from repro_torch.kernels.ri_and.cases import (CASES, draw_ri_rows,
                                                  store_tensors)
    n = RI_CASE_ROWS
    own = torch.arange(n, device=dev)
    shuffled = torch.from_numpy(np.random.default_rng(RI_CASE_SEED)
                                .permutation(n)).to(dev)
    mix, t_draw = {}, 0.0
    for xor_y in (False, True):
        t0 = time.perf_counter()
        d = draw_ri_rows(RI_CASE_SEED, n, xor_y)
        t_draw += time.perf_counter() - t0
        x, y = (store_tensors(d[k], dev) for k in "xy")
        for pairing, si in (("own", own), ("shuffled", shuffled)):
            got = ri_trichotomy(x, y, own, si, xor_y)
            want = ri_trichotomy_plain(x, y, own, si, xor_y)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero().flatten()[:8].tolist()
                raise AssertionError(
                    f"ri_trichotomy kernel != plain version on the edge "
                    f"cases, xor_y={xor_y}, {pairing} pairs: rows {bad}")
            if pairing == "own" and not np.array_equal(got.cpu().numpy(),
                                                       d["verdict"]):
                raise AssertionError(f"ri_trichotomy kernel != the drawn "
                                     f"verdicts, xor_y={xor_y}")
            mix[f"xor_y {xor_y}, {pairing}"] = torch.bincount(
                want.long(), minlength=3).tolist()
    return (f"RI edge-case sweep: {n} pair rows drawn twice in {t_draw:.1f} "
            f"s from cases {list(CASES)} (seed {RI_CASE_SEED}); ri_trichotomy "
            f"kernel == plain version, as drawn == the drawn verdicts; "
            f"tolerance: exact; TRUE_NEG/TRUE_HIT/INDECISIVE "
            f"{json.dumps(mix)}")


def _interval_join_sweep(dev) -> list:
    """B1 and B4 against their plain versions, exactly, on the lists that
    ``kernels.interval_join.cases`` draws at the window tiling's edges
    (``JOIN_SWEEP_ROWS`` pair rows, paired as drawn and shuffled); then
    with an empty F store (its sentinel slot) on either side. Returns
    printable lines."""
    import torch
    from repro_torch.core.join import IntervalLists
    from repro_torch.kernels.interval_join import (
        CSRLists, april_trichotomy, april_trichotomy_plain, interval_overlap,
        interval_overlap_plain)
    from repro_torch.kernels.interval_join.cases import (CASES,
                                                         SPECIAL_WIDTHS,
                                                         draw_pair_rows)
    t0 = time.perf_counter()
    drawn = draw_pair_rows(JOIN_SWEEP_SEED, JOIN_SWEEP_ROWS)
    t_draw = time.perf_counter() - t0
    L = {k: CSRLists(*(torch.from_numpy(a).to(dev) for a in drawn[k]))
         for k in ("xa", "xf", "ya", "yf")}
    n = JOIN_SWEEP_ROWS
    own = torch.arange(n, device=dev)
    shuffled = torch.from_numpy(np.random.default_rng(JOIN_SWEEP_SEED)
                                .permutation(n)).to(dev)
    empty = IntervalLists.from_intervals(
        np.zeros(n + 1, np.int64), np.zeros((0, 2), np.uint64)).to(dev)
    sets = {"drawn": (L["xa"], L["xf"], L["ya"], L["yf"]),
            "empty F(s) store": (L["xa"], L["xf"], L["ya"], empty),
            "empty F(r) store": (L["xa"], empty, L["ya"], L["yf"])}
    mix = {}
    for label, tri in sets.items():
        for pairing, rows in (("own", (own, own)), ("shuffled",
                                                    (own, shuffled))):
            want = april_trichotomy_plain(*tri, *rows)
            joins = {"AA": (tri[0], tri[2]), "AF": (tri[0], tri[3]),
                     "FA": (tri[1], tri[2])}
            for name, (x, y) in joins.items():
                if not torch.equal(interval_overlap(x, y, *rows),
                                   interval_overlap_plain(x, y, *rows)):
                    raise AssertionError(f"interval_overlap kernel != plain "
                                         f"version on the {name} join of the "
                                         f"{label} sweep, {pairing} pairs")
            if not torch.equal(april_trichotomy(*tri, *rows), want):
                raise AssertionError(f"april_trichotomy kernel != plain "
                                     f"version on the {label} sweep, "
                                     f"{pairing} pairs")
            mix[f"{label}, {pairing}"] = torch.bincount(
                want.long(), minlength=3).tolist()
    widths = {k: np.bincount(np.diff(drawn[k][0]).clip(max=601),
                             minlength=602)
              for k in ("xa", "ya")}
    present = [w for w in SPECIAL_WIDTHS if widths["xa"][w] and
               widths["ya"][w]]
    if present != list(SPECIAL_WIDTHS):
        raise AssertionError(f"the sweep lacks widths: {present}")
    for v in ("int32_min", "int32_max"):
        lim = np.iinfo(np.int32).min if v == "int32_min" \
            else np.iinfo(np.int32).max
        if not all((drawn[k][1 if v == "int32_min" else 2] == lim).any()
                   for k in ("xa", "ya")):
            raise AssertionError(f"the sweep has no list at {v}")
    return [f"interval-join sweep: {n} pair rows drawn in {t_draw:.1f} s "
            f"from cases {list(CASES)} (seed {JOIN_SWEEP_SEED}), widths "
            f"{list(SPECIAL_WIDTHS)} on both sides, ends at INT32_MIN and "
            f"INT32_MAX; april_trichotomy and interval_overlap (AA, AF, FA) "
            f"kernels == plain versions; tolerance: exact; verdicts "
            f"TRUE_NEG/TRUE_HIT/INDECISIVE {json.dumps(mix)}"]


def _width_stats(x, y, xi, yi) -> dict:
    """Mean, p99 and max of nx + ny over rows (xi, yi), read on the card."""
    import torch
    w = (x.off[xi + 1] - x.off[xi] + y.off[yi + 1] - y.off[yi]).double()
    return {"mean": float(w.mean()), "p99": float(torch.quantile(w, 0.99)),
            "max": int(w.max())}


def _interval_join_times(tri, frame, survivors, torch_frame) -> dict:
    """B1 and B4 on the device alone (``_device_ms``), each beside the byte
    bound of the same work: B1 over the main path's frame and over the
    fused torch-MBR run's; B4's AA join over the main frame, and the
    degenerate order's two launches (AA over the frame, AF over the AA
    survivors) timed together, their bound the sum of the two launches'.
    Prints the frames' list widths; returns, by kernel, the keys its row
    of the ``kernels`` line gains."""
    from repro_torch.kernels.interval_join import (april_trichotomy,
                                                   interval_overlap)
    xa, xf, ya, yf = tri
    widths = {f"{name} {join}": _width_stats(x, y, *rows)
              for name, rows in (("main", frame), ("torch-MBR", torch_frame))
              for join, (x, y) in (("AA", (xa, ya)), ("AF", (xa, yf)),
                                   ("FA", (xf, ya)))}
    print(f"interval-join frames: {frame[0].numel()} main rows, "
          f"{torch_frame[0].numel()} torch-MBR rows; nx + ny per join "
          f"(read on the card) {json.dumps(widths)}", flush=True)

    def bound_ms(lists, rows) -> float:
        """Each list and row index read once, one byte written a row."""
        nbytes = _nbytes(*(t for L in lists for t in L), *rows) \
            + rows[0].numel()
        return nbytes / HBM_BYTES_PER_S * 1e3

    return {
        "april_trichotomy": {
            "device_ms": _device_ms(lambda: april_trichotomy(*tri, *frame)),
            "device_ms_torch_mbr_frame": _device_ms(
                lambda: april_trichotomy(*tri, *torch_frame)),
            "bound_ms_torch_mbr_frame": bound_ms(tri, torch_frame)},
        "interval_overlap": {
            "device_ms": _device_ms(lambda: interval_overlap(xa, ya, *frame)),
            "device_ms_degenerate_order": _device_ms(lambda: (
                interval_overlap(xa, ya, *frame),
                interval_overlap(xa, yf, *survivors))),
            "bound_ms_degenerate_order": bound_ms((xa, ya), frame)
            + bound_ms((xa, yf), survivors)},
    }


def _compact_checked(label, m) -> int:
    """The compaction kernel against its plain version and the stable
    argsort oracle on lane ``m``, perm and count exactly; returns the
    count."""
    import torch
    from repro_torch.kernels.compact import compact_mask, compact_mask_plain
    kp, kc = compact_mask(m)
    pp, pc = compact_mask_plain(m)
    op = torch.argsort((~m).to(torch.uint8), stable=True).to(torch.int32)
    torch.cuda.synchronize()
    if not (torch.equal(kp, pp) and torch.equal(kp, op)
            and int(kc) == int(pc) == int(m.sum())):
        raise AssertionError(f"[{label}] compact_mask kernel != plain "
                             "version or argsort oracle on the run's "
                             "INDECISIVE lane")
    return int(kc)


def _refine_checked(label, R, S, cs, predicate) -> dict:
    """B7 on a fused run's recorded chain: the INDECISIVE lane the run's
    compaction was given, compacted again by B3, then the kernel's (res,
    unc) lanes against its plain version (the eager cores,
    ``fused_refine_lanes(kernel=False)``) on the card, bit for bit, and
    its own count of the rows it refined against ``count``. Returns the
    call's arguments and plain version, for timing, with the rows, couples,
    operations and bytes of its bound (every couple walked, each row's
    rings read once)."""
    import torch
    from repro_torch.core.join import INDECISIVE
    from repro_torch.kernels.compact import compact_mask
    from repro_torch.kernels.fused_refine import fused_refine_rows
    from repro_torch.spatial import refine as RF
    dev = cs.ri_dev.device
    kind = {"selection": "intersects", "linestring": "line"}.get(predicate,
                                                                 predicate)
    perm, count = compact_mask(cs.status == INDECISIVE)
    geom_r = RF.device_geometry(R, dev, kind="line" if kind == "line"
                                else "polygon")
    geom_s = RF.device_geometry(S, dev)
    args = (kind, geom_r, geom_s, cs.ri_dev, cs.si_dev, perm, count)
    res, unc, refined = fused_refine_rows(*args)

    def plain():
        return RF.fused_refine_lanes(R, S, cs.ri_dev, cs.si_dev, perm, count,
                                     dev, predicate, kernel=False)

    want_res, want_unc = plain()
    torch.cuda.synchronize()
    n = int(count)
    diff = int((res != want_res).sum()) + int((unc != want_unc).sum())
    if diff:
        raise AssertionError(f"[{label}] fused_refine kernel != the eager "
                             f"cores on {diff} lanes of the run's {n} "
                             f"INDECISIVE rows")
    if int(refined) != n:
        raise AssertionError(f"[{label}] fused_refine counted {int(refined)} "
                             f"rows refined, not the {n} live")
    idx = perm[:n].to(torch.int64)
    na = geom_r["nverts"][cs.ri_dev[idx]].to(torch.float64)
    nb = geom_s["nverts"][cs.si_dev[idx]].to(torch.float64)
    couples = int((((na - 1) if kind == "line" else na) * nb).sum())
    pip = int({"intersects": na + nb, "within": na * nb,
               "line": nb}[kind].sum())
    ops = REFINE_OPS_PER_COUPLE * couples + REFINE_OPS_PER_PIP * pip
    # both rings, perm, ri and si, both nverts, the reps, two lane bytes
    nbytes = int(16 * (na + nb).sum()) + n * (
        4 + 16 + 16 + 2 + (32 if kind == "intersects" else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F64_OPS_PER_S
    print(f"[{label}] fused_refine kernel == eager cores (res and unc) on "
          f"all {len(cs)} rows, {n} live ({int(res.sum())} res, "
          f"{int(unc.sum())} unc), its count of rows refined == {n}; "
          f"tolerance: exact", flush=True)
    return {"args": args, "plain": plain, "rows": n, "frame": len(cs),
            "couples": couples, "ops": ops, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": diff}


def _refine_times(prefix, chk) -> dict:
    """B7 at a run's chain (``_refine_checked``): CUDA events a wrapper
    call, on the device alone, its plain version, beside its bound; keys
    prefixed with ``prefix``."""
    from repro_torch.kernels.fused_refine import fused_refine_rows
    args = chk["args"]
    return {f"{prefix}_rows": chk["rows"],
            f"{prefix}_frame_rows": chk["frame"],
            f"{prefix}_couples": chk["couples"],
            f"{prefix}_ms": _ms(lambda: fused_refine_rows(*args)),
            f"{prefix}_device_ms": _device_ms(
                lambda: fused_refine_rows(*args)),
            f"{prefix}_plain_ms": _ms(chk["plain"]),
            f"{prefix}_bound_ms": chk["bound_ms"],
            f"{prefix}_bound_by": chk["bound_by"]}


def _replayed(label, joins, sweeps, chains, frames=()) -> str:
    """B1 and B4 on every call a run's interval joins made, B2 on every
    sweep its refine made, B3 on the INDECISIVE lane of every fused chain
    it ran and B5 on every RI frame its filter ran, each against its plain
    version (B3 also against the argsort oracle), exactly, on the inputs
    the run recorded. Returns a printable summary."""
    import torch
    from repro_torch.core.join import INDECISIVE
    from repro_torch.kernels.interval_join import (april_trichotomy,
                                                   april_trichotomy_plain,
                                                   interval_overlap,
                                                   interval_overlap_plain)
    from repro_torch.kernels.refine import (edges_intersect_csr,
                                            edges_intersect_csr_plain)
    from repro_torch.kernels.ri_and import ri_trichotomy, ri_trichotomy_plain
    pairs = {"april_trichotomy": (april_trichotomy, april_trichotomy_plain),
             "interval_overlap": (interval_overlap, interval_overlap_plain)}
    rows = {name: [] for name in pairs}
    for name, args in joins:
        kernel, plain = pairs[name]
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[{label}] {name} kernel != plain version "
                                 f"on the run's call over "
                                 f"{args[-1].numel()} rows")
        rows[name].append(args[-1].numel())
    swept = []
    for sw in sweeps:
        kh, ku = edges_intersect_csr(*sw)
        ph, pu = edges_intersect_csr_plain(*sw)
        torch.cuda.synchronize()
        if not (torch.equal(kh, ph) and torch.equal(ku, pu)):
            raise AssertionError(f"[{label}] edges_intersect kernel != plain "
                                 f"version on the run's sweep")
        swept.append(sw[2].numel() - 1)
    lanes = [(len(cs), _compact_checked(label, cs.status == INDECISIVE))
             for cs in chains if cs.status is not None]
    ri_rows = []
    for fr in frames:
        got, want = ri_trichotomy(*fr), ri_trichotomy_plain(*fr)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[{label}] ri_trichotomy kernel != plain "
                                 f"version on the run's frame of "
                                 f"{fr[2].numel()} rows")
        ri_rows.append(fr[2].numel())
    return (f"replayed on the run's recorded inputs, tolerance exact: "
            f"april_trichotomy == plain on calls of {rows['april_trichotomy']}"
            f" rows, interval_overlap == plain on calls of "
            f"{rows['interval_overlap']} rows, edges_intersect == plain on "
            f"sweeps of {swept} rows, compact_mask == plain == oracle on "
            f"lanes of (rows, INDECISIVE) {lanes}, ri_trichotomy == plain "
            f"on frames of {ri_rows} rows")


class _Runs:
    """The joins of one phase on the card, each through ``run``: launch
    counts reset before and read after (kept in ``launches`` by label),
    the inputs of its kernels recorded and, with ``replay``, every kernel
    held to its plain version on them; its counts and stage times
    printed."""

    def __init__(self, args, dev, smi, wrappers):
        self.args, self.dev, self.smi = args, dev, smi
        self.wrappers = wrappers
        self.launches, self.refined = {}, {}

    def run(self, label, predicate, R_, S_, pre_, replay=True, **opts):
        """One join; returns (plan, pairs, stats, recorded inputs: the
        interval joins, sweeps, fused chains and RI frames)."""
        import torch
        from repro_torch import JoinPlan
        from repro_torch.core import join
        from repro_torch.core import ri as ri_mod
        from repro_torch.spatial import fused
        from repro_torch.spatial import refine as refine_mod
        _reset(self.wrappers)
        t0 = time.perf_counter()
        p = JoinPlan(R_, S_, filter=opts.pop("filter", "april"),
                     n_order=self.args.n_order, **opts).build(prebuilt=pre_)
        with refine_mod.record_sweeps() as sweeps, \
                fused.record_chains() as chains, \
                join.record_joins() as joins, \
                ri_mod.record_frames() as frames:
            res, st = p.execute(predicate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.launches[label] = _launched(label, self.wrappers)
        print(f"[{label}] {wall:.2f} s; launches "
              f"{json.dumps(self.launches[label])}; candidates "
              f"{st.n_candidates}, TRUE_HIT/TRUE_NEG/INDECISIVE "
              f"{st.n_true_hits}/{st.n_true_negs}/{st.n_indecisive}, "
              f"{st.n_results} result pairs; {json.dumps(st.stage_times())}; "
              f"{json.dumps(st.extra)} (card {self.smi})", flush=True)
        rec = (joins, sweeps, chains, frames)
        if replay and any(rec):
            print(f"[{label}] {_replayed(label, *rec)}", flush=True)
        return p, res, st, rec

    def profiled(self, label, kernel, *a, launches=1, **kw):
        """``run`` under the profiler, taken again until its trace shows
        the ``launches`` of ``kernel`` the run makes; the replay follows,
        outside the trace."""
        box = []
        prof = _profile_showing(label, lambda: box.append(self.run(
            label, *a, replay=False, **kw)), kernel, launches=launches)
        print(f"profile [{label}] (card {self.smi}): device busy "
              f"{prof['device_busy_us'] / 1e3:.2f} ms of "
              f"{prof['wall_us'] / 1e6:.2f} s "
              f"({100 * prof['device_busy_share']:.2f} %)", flush=True)
        print(f"[{label}] {_replayed(label, *box[-1][3])}", flush=True)
        return box[-1]

    def need(self, label, **want):
        """Launch counts: an int must match, ``True`` means at least one."""
        for name, n in want.items():
            got = self.launches[label][name]
            if (n is True and got < 1) or (n is not True and got != n):
                raise AssertionError(f"[{label}] {got} {name} launches, "
                                     f"expected {'>= 1' if n is True else n}")

    def fused_checked(self, label, p, rec, predicate):
        """A fused run's chain: its stages again under
        ``set_sync_debug_mode("error")``, the status lane it wrote against
        the filter's plain lane over its frame, under its valid lane, and
        B7 against its plain version on the chain (``_refine_checked``,
        kept in ``refined`` by label). Returns the chain."""
        import torch
        from repro_torch.core.join import TRUE_NEG
        (cs,) = rec[2]
        _sync_checked(p, label, cs.status, predicate)
        lane = p.filter.status_lane(p.approx_r, p.approx_s, cs.ri, cs.si,
                                    predicate=predicate, backend="torch",
                                    device=self.dev,
                                    rows=(cs.ri_dev, cs.si_dev))
        if cs.valid is not None:
            lane = torch.where(cs.valid, lane, TRUE_NEG)
        torch.cuda.synchronize()
        if not torch.equal(cs.status, lane):
            raise AssertionError(f"[{label}] the status lane != the plain "
                                 f"{predicate} lane")
        print(f"[{label}] stages passed set_sync_debug_mode('error'); status "
              f"lane == the plain lane over all {len(cs)} frame rows; "
              f"tolerance: exact", flush=True)
        self.refined[label] = _refine_checked(label, p.R, p.S, cs, predicate)
        return cs

    def by(self, label_prefix, name):
        """Launches of ``name`` in every run whose label starts with
        ``label_prefix``."""
        return {k: v[name] for k, v in self.launches.items()
                if k.startswith(label_prefix)}


def _within_phase(args, dev, R, S, plan, want_default, want_default_st,
                  wrappers, builds) -> dict:
    """Phase 10: the ``within`` and ``selection`` joins and the staged
    ``device64`` refine on the card. Returns, by kernel, the keys its row
    of the ``kernels`` line gains; the zip codes, their APRIL store and its
    build's seconds and stages go into ``builds``."""
    import torch
    from repro_torch import JoinPlan, make_dataset
    from repro_torch.core.geometry import BUILD_STAGES
    from repro_torch.core.join import INDECISIVE
    from repro_torch.datagen.synthetic import DATASET_SPECS
    from repro_torch.kernels.compact import compact_mask
    from repro_torch.kernels.interval_join import interval_overlap
    from repro_torch.kernels.refine import edges_intersect_csr
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 10 card: {smi}", flush=True)
    t0 = time.perf_counter()
    # zip codes (T10) to water bodies (T2) as DATASET_SPECS has them
    zips = DATASET_SPECS["T10"][0] * args.s_count // DATASET_SPECS["T2"][0]
    Z = make_dataset("T10", seed=2, count=zips)
    t1 = time.perf_counter()
    with BUILD_STAGES.record() as stages:
        base = JoinPlan(S, Z, filter="april", n_order=args.n_order).build(
            prebuilt=(plan.approx_s, None))
    builds["april T10"] = (time.perf_counter() - t1, stages)
    builds["Z"], builds["z_store"] = Z, base.approx_s.store
    builds["z_approx"] = base.approx_s
    pre = (base.approx_r, base.approx_s)
    print(f"host: T10 x {len(Z)} APRIL build {time.perf_counter() - t0:.1f} "
          f"s (T2 x {len(S)} store reused from phase 4)", flush=True)
    runs = _Runs(args, dev, smi, wrappers)
    run, profiled, need = runs.run, runs.profiled, runs.need
    fused_checked, launches = runs.fused_checked, runs.launches

    # APRIL within, T2 x T10: the profiled runs first, while this process's
    # profiler still records device events (see _attention_in_fresh_process),
    # then numpy, staged device64 and fused with the torch MBR lane
    _, res, st, rec = profiled("within-staged", "interval_overlap_kernel",
                               "within", S, Z, pre)
    (sw,) = rec[1]
    fused_numpy = profiled("within-fused-numpy", "compact_mask_kernel",
                           "within", S, Z, pre, pipeline_mode="fused")
    _, want, want_st, _ = run("within-numpy", "within", S, Z, pre,
                              filter_backend="numpy", refine_backend="numpy")
    _same_run("within-staged", res, st, want, want_st)
    need("within-staged", interval_overlap=True,
         edges_intersect_csr=int(st.n_indecisive > 0))
    _, res, st, _ = run("within-device64", "within", S, Z, pre,
                        refine_backend="device64")
    _same_run("within-device64", res, st, want, want_st)
    need("within-device64", interval_overlap=True, edges_intersect_csr=0)
    for mb in ("numpy", "torch"):
        label = f"within-fused-{mb}"
        if mb == "numpy":
            p, res, st, rec = fused_numpy
        else:
            p, res, st, rec = run(label, "within", S, Z, pre,
                                  pipeline_mode="fused", mbr_backend="torch")
        _same_run(label, res, st, want, want_st)
        need(label, interval_overlap=1, compact_mask=1,
             fused_refine_rows=1, edges_intersect_csr=0)
        cs = fused_checked(label, p, rec, "within")
        if mb == "numpy":
            # the within AA call and the INDECISIVE lane, timed below
            (aa_args,) = [a for name, a in rec[0]
                          if name == "interval_overlap"]
            ind = cs.status == INDECISIVE
        del cs, rec
    del fused_numpy
    print("[within] staged cuda, staged device64 and fused (numpy and torch "
          "MBR) == numpy pairs, order and counts", flush=True)

    # APRIL selection, T2 x T10: the zip codes as query polygons
    _, want_q, want_q_st, _ = run("selection-numpy", "selection", S, Z, pre,
                                  filter_backend="numpy",
                                  refine_backend="numpy")
    for label, opts in (("selection-staged", {}),
                        ("selection-fused", {"pipeline_mode": "fused"})):
        p, res, st, rec = run(label, "selection", S, Z, pre, **opts)
        _same_run(label, res, st, want_q, want_q_st)
        if "fused" in label:
            need(label, april_trichotomy=1, compact_mask=1,
                 fused_refine_rows=1, edges_intersect_csr=0)
            fused_checked(label, p, rec, "selection")
        else:
            need(label, april_trichotomy=True,
                 edges_intersect_csr=int(st.n_indecisive > 0))
        del rec
    print(f"[selection] staged and fused == numpy pairs, order and counts "
          f"({len(want_q)} pairs)", flush=True)

    # APRIL intersects, T1 x T2, staged with the float64 device refine
    _, res, st, _ = run("intersects-device64", "intersects", R, S,
                        (plan.approx_r, plan.approx_s),
                        refine_backend="device64")
    _same_run("intersects-device64", res, st, want_default, want_default_st)
    need("intersects-device64", april_trichotomy=True, edges_intersect_csr=0)
    print(f"[intersects-device64] == the phase 4 default run: {len(res)} "
          f"pairs, order and counts", flush=True)

    # every filter's within join at a ninth of the main counts
    t0 = time.perf_counter()
    W2 = make_dataset("T2", seed=1, count=args.s_count // WITHIN_HOST_SCALE)
    Z2 = make_dataset("T10", seed=2, count=zips // WITHIN_HOST_SCALE)
    april2 = JoinPlan(W2, Z2, filter="april", n_order=args.n_order).build()
    want_set = _pair_set(april2.execute("within")[0])
    print(f"host filters: APRIL within at {len(W2)} x {len(Z2)} "
          f"{time.perf_counter() - t0:.1f} s, {len(want_set)} pairs",
          flush=True)
    for name in ("ri", "ra", "5cch", "april-c", "none"):
        t0 = time.perf_counter()
        host = JoinPlan(W2, Z2, filter=name, n_order=args.n_order).build()
        t_build = time.perf_counter() - t0
        got = {}
        for mode in ("staged", "fused"):
            label = f"{name}-within-{mode}"
            _, res, st, _ = run(label, "within", W2, Z2,
                                (host.approx_r, host.approx_s),
                                filter=name, pipeline_mode=mode)
            if mode == "fused":
                need(label, compact_mask=1, edges_intersect_csr=0)
            else:
                need(label, edges_intersect_csr=int(st.n_indecisive > 0),
                     **({"interval_overlap": True} if name == "april-c"
                        else {}))
            got[mode] = (res, st)
        _same_run(f"{name}-within-fused", *got["fused"], *got["staged"])
        if _pair_set(got["staged"][0]) != want_set:
            raise AssertionError(f"[{name}-within] result set != the APRIL "
                                 "run's")
        print(f"[{name}-within] build {t_build:.2f} s; staged == fused "
              f"pairs, order and counts; set == APRIL's ({len(want_set)} "
              f"pairs)", flush=True)

    # the within path's kernel work on the device alone, beside its bounds
    xa, ya, *rows = aa_args
    aa_bytes = _nbytes(*xa, *ya, *rows) + rows[0].numel()
    sw_couples = int((torch.diff(sw[2]) * torch.diff(sw[5])).sum())
    sw_rows = sw[2].numel() - 1
    t_bytes = (16 * (sw[0].shape[0] + sw[3].shape[0]) + 18 * sw_rows) \
        / HBM_BYTES_PER_S
    t_ops = sw_couples * SWEEP_OPS_PER_COUPLE / F32_OPS_PER_S

    by = runs.by
    extra = {
        "interval_overlap": {
            "launches_within": by("within", "interval_overlap"),
            "within_frame_rows": rows[0].numel(),
            "within_aa_device_ms": _device_ms(
                lambda: interval_overlap(xa, ya, *rows)),
            "within_aa_bound_ms": aa_bytes / HBM_BYTES_PER_S * 1e3},
        "edges_intersect": {
            "launches_within": by("within", "edges_intersect_csr"),
            "within_sweep_rows": sw_rows,
            "within_sweep_device_ms": _device_ms(
                lambda: edges_intersect_csr(*sw)),
            "within_sweep_bound_ms": max(t_bytes, t_ops) * 1e3,
            "within_sweep_bound_by": "bytes" if t_bytes >= t_ops
            else "operations"},
        "exclusive_scan": {
            "launches_within": by("within", "compact_mask"),
            "within_device_ms": _device_ms(lambda: compact_mask(ind))},
        "april_trichotomy": {
            "launches_selection": by("selection", "april_trichotomy")},
        "fused_refine": {
            "launches_within": by("within", "fused_refine_rows"),
            "launches_selection": by("selection", "fused_refine_rows"),
            **_refine_times("within", runs.refined["within-fused-numpy"]),
            **_refine_times("selection", runs.refined["selection-fused"])},
    }
    print(f"within kernels on the device alone (card {smi}): "
          f"{json.dumps(extra)}", flush=True)
    print(f"phase 10 ok: within and selection, device64 "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return extra


def _linestring_phase(args, dev, S, plan, ri_s, wrappers, builds) -> dict:
    """Phase 11: the linestring joins (polygon x linestring, §4.3.3) on the
    card. Returns, by kernel, the keys its row of the ``kernels`` line
    gains; the chains go into ``builds``."""
    import torch
    from repro_torch import JoinPlan, make_dataset, make_linestrings
    from repro_torch.core.join import INDECISIVE
    from repro_torch.kernels.compact import compact_mask
    from repro_torch.kernels.interval_join import interval_overlap
    from repro_torch.kernels.refine import edges_intersect_csr
    from repro_torch.kernels.ri_and import ri_trichotomy
    from repro_torch.spatial import refine as refine_mod
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 11 card: {smi}", flush=True)
    # roads or rivers (the T8 chains) against water bodies (T2, phase 4's
    # S); only the line stores are built, the polygon stores are reused
    t0 = time.perf_counter()
    L = make_linestrings("T8", seed=3, count=args.s_count)
    builds["chains"] = L
    print(f"host: T8 x {len(L)} chains {time.perf_counter() - t0:.1f} s, "
          f"{int(L.nverts.sum())} vertices", flush=True)
    line = {"r_kind": "line"}
    t0 = time.perf_counter()
    base = JoinPlan(L, S, filter="april", n_order=args.n_order,
                    **line).build(prebuilt=(None, plan.approx_s))
    print(f"host: T8 line cell store {time.perf_counter() - t0:.1f} s, "
          f"{len(base.approx_r.store.ids)} cells (T2 x {len(S)} APRIL "
          f"store reused from phase 4)", flush=True)
    t0 = time.perf_counter()
    ri_base = JoinPlan(L, S, filter="ri", n_order=args.n_order,
                       **line).build(prebuilt=(None, ri_s))
    print(f"host: T8 RI line store {time.perf_counter() - t0:.1f} s, "
          f"{len(ri_base.approx_r.store.ints)} intervals, all Weak (T2 RI "
          f"store reused from phase 5)", flush=True)
    pre = (base.approx_r, base.approx_s)
    ri_pre = (ri_base.approx_r, ri_base.approx_s)
    runs = _Runs(args, dev, smi, wrappers)
    run, need = runs.run, runs.need

    # APRIL: the profiled runs first, while this process's profiler may
    # still record device events (see _attention_in_fresh_process)
    _, res, st, staged_rec = runs.profiled(
        "line-staged", "interval_overlap_kernel", "linestring", L, S, pre,
        launches=None, **line)
    fused_numpy = runs.profiled("line-fused-numpy", "compact_mask_kernel",
                                "linestring", L, S, pre, launches=1,
                                pipeline_mode="fused", **line)
    _, want, want_st, _ = run("line-numpy", "linestring", L, S, pre,
                              filter_backend="numpy", refine_backend="numpy",
                              **line)
    _same_run("line-staged", res, st, want, want_st)
    # B4 on the whole frame (C x A(s)), then on its survivors (C x F(s))
    n_ov = 1 + int(want_st.n_true_hits + want_st.n_indecisive > 0)
    need("line-staged", interval_overlap=n_ov,
         edges_intersect_csr=int(st.n_indecisive > 0))
    cands = base.candidates("linestring")
    builds["line_approx"], builds["line_cands"] = base.approx_r, cands
    rng = np.random.default_rng(0)
    sample = cands[rng.choice(len(cands), size=min(512, len(cands)),
                              replace=False)]
    exact = refine_mod.refine_line_poly_pairs_seq(L, S, sample)
    in_res = _pair_set(want)
    bad = [p for p, e in zip(map(tuple, sample.tolist()), exact)
           if e != (p in in_res)]
    if bad:
        raise AssertionError(f"[line] pairs {bad[:8]} disagree with the "
                             "float64 oracle")
    _, res, st, _ = run("line-device64", "linestring", L, S, pre,
                        refine_backend="device64", **line)
    _same_run("line-device64", res, st, want, want_st)
    need("line-device64", interval_overlap=n_ov, edges_intersect_csr=0)
    for mb in ("numpy", "torch"):
        label = f"line-fused-{mb}"
        if mb == "numpy":
            p, res, st, rec = fused_numpy
        else:
            p, res, st, rec = run(label, "linestring", L, S, pre,
                                  pipeline_mode="fused", mbr_backend="torch",
                                  **line)
        _same_run(label, res, st, want, want_st)
        need(label, interval_overlap=2, compact_mask=1, fused_refine_rows=1,
             edges_intersect_csr=0)
        cs = runs.fused_checked(label, p, rec, "linestring")
        if mb == "numpy":
            # the fused run's two B4 calls and its INDECISIVE lane, timed
            # below
            fused_joins = [a for name, a in rec[0]
                           if name == "interval_overlap"]
            ind = cs.status == INDECISIVE
        del cs, rec
    del fused_numpy
    print(f"[line] staged cuda, staged device64 and fused (numpy and torch "
          f"MBR) == numpy pairs, order and counts ({len(want)} pairs); "
          f"{len(sample)} sampled candidates == float64 oracle", flush=True)

    # RI: every line cell Weak, Algorithm 1 as for intersects
    _, ri_want, ri_want_st, _ = run("line-ri-numpy", "linestring", L, S,
                                    ri_pre, filter="ri",
                                    filter_backend="numpy",
                                    refine_backend="numpy", **line)
    if _pair_set(ri_want) != in_res:
        raise AssertionError("[line-ri-numpy] result set != the APRIL run's")
    for label, opts in (("line-ri-staged", {}),
                        ("line-ri-fused", {"pipeline_mode": "fused"})):
        p, res, st, rec = run(label, "linestring", L, S, ri_pre, filter="ri",
                              **opts, **line)
        _same_run(label, res, st, ri_want, ri_want_st)
        if opts:
            need(label, ri_trichotomy=1, compact_mask=1,
                 edges_intersect_csr=0)
            runs.fused_checked(label, p, rec, "linestring")
        else:
            need(label, ri_trichotomy=1,
                 edges_intersect_csr=int(st.n_indecisive > 0))
            (ri_frame,) = rec[3]
        del rec
    print(f"[line-ri] staged and fused == RI numpy pairs, order and counts; "
          f"set == APRIL's", flush=True)

    # the host filters at a ninth of the counts
    t0 = time.perf_counter()
    n_host = args.s_count // WITHIN_HOST_SCALE
    L2 = make_linestrings("T8", seed=3, count=n_host)
    S2 = make_dataset("T2", seed=1, count=n_host)
    _, res2, _, _ = run("line-april-ninth", "linestring", L2, S2, None,
                        **line)
    want_set = _pair_set(res2)
    print(f"host filters: APRIL linestring at {len(L2)} x {len(S2)} "
          f"{time.perf_counter() - t0:.1f} s, {len(want_set)} pairs",
          flush=True)
    for name in ("ra", "5cch", "april-c", "none"):
        t0 = time.perf_counter()
        host = JoinPlan(L2, S2, filter=name, n_order=args.n_order,
                        **line).build()
        t_build = time.perf_counter() - t0
        got = {}
        for mode in ("staged", "fused"):
            label = f"line-{name}-{mode}"
            _, res, st, _ = run(label, "linestring", L2, S2,
                                (host.approx_r, host.approx_s), filter=name,
                                pipeline_mode=mode, **line)
            if mode == "fused":
                need(label, compact_mask=1, edges_intersect_csr=0)
            else:
                need(label, edges_intersect_csr=int(st.n_indecisive > 0),
                     **({"interval_overlap": True} if name == "april-c"
                        else {}))
            got[mode] = (res, st)
        _same_run(f"line-{name}-fused", *got["fused"], *got["staged"])
        if _pair_set(got["staged"][0]) != want_set:
            raise AssertionError(f"[line-{name}] result set != the APRIL "
                                 "run's")
        print(f"[line-{name}] build {t_build:.2f} s; staged == fused pairs, "
              f"order and counts; set == APRIL's ({len(want_set)} pairs)",
              flush=True)

    # the linestring path's kernel work on the device alone, beside its
    # bounds: B4 the staged run's two launches and the fused run's two,
    # B2 the staged sweep (every chain edge x every ring edge), B5 the
    # staged RI frame, B3 the fused INDECISIVE lane
    staged_joins = [a for name, a in staged_rec[0]
                    if name == "interval_overlap"]

    def ov_bound_ms(calls) -> float:
        """Each list and row index read once, one byte written a row."""
        return sum(_nbytes(*x, *y, xi, yi) + xi.numel()
                   for x, y, xi, yi in calls) / HBM_BYTES_PER_S * 1e3

    def by(name) -> dict:
        """The linestring runs that launched ``name``, and how often."""
        return {k: v for k, v in runs.by("line", name).items() if v}

    extra = {
        "interval_overlap": {
            "launches_linestring": by("interval_overlap"),
            "linestring_frame_rows": staged_joins[0][2].numel(),
            "linestring_staged_device_ms": _device_ms(
                lambda: [interval_overlap(*a) for a in staged_joins]),
            "linestring_staged_bound_ms": ov_bound_ms(staged_joins),
            "linestring_fused_device_ms": _device_ms(
                lambda: [interval_overlap(*a) for a in fused_joins]),
            "linestring_fused_bound_ms": ov_bound_ms(fused_joins)},
        "exclusive_scan": {
            "launches_linestring": by("compact_mask"),
            "linestring_device_ms": _device_ms(lambda: compact_mask(ind))},
        "fused_refine": {
            "launches_linestring": by("fused_refine_rows"),
            **_refine_times("linestring",
                            runs.refined["line-fused-numpy"])},
        "ri_trichotomy": {
            "launches_linestring": by("ri_trichotomy"),
            "linestring_frame_rows": ri_frame[2].numel(),
            "linestring_device_ms": _device_ms(
                lambda: ri_trichotomy(*ri_frame)),
            "linestring_bound_ms": _ri_bound_bytes(*ri_frame)
            / HBM_BYTES_PER_S * 1e3},
        "edges_intersect": {
            "launches_linestring": by("edges_intersect_csr")},
    }
    if staged_rec[1]:
        (sw,) = staged_rec[1]
        couples = int((torch.diff(sw[2]) * torch.diff(sw[5])).sum())
        rows = sw[2].numel() - 1
        t_bytes = (16 * (sw[0].shape[0] + sw[3].shape[0]) + 18 * rows) \
            / HBM_BYTES_PER_S
        t_ops = couples * SWEEP_OPS_PER_COUPLE / F32_OPS_PER_S
        extra["edges_intersect"].update({
            "linestring_sweep_rows": rows,
            "linestring_sweep_couples": couples,
            "linestring_sweep_device_ms": _device_ms(
                lambda: edges_intersect_csr(*sw)),
            "linestring_sweep_bound_ms": max(t_bytes, t_ops) * 1e3,
            "linestring_sweep_bound_by": "bytes" if t_bytes >= t_ops
            else "operations"})
    print(f"linestring kernels on the device alone (card {smi}): "
          f"{json.dumps(extra)}", flush=True)
    print(f"phase 11 ok: linestring joins "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return extra


def _helpers_phase(args, dev, plan, cands, builds) -> dict:
    """Phase 18: the raw-store filter wrappers and the quickstart example
    on the card, on the stores and candidate rows of earlier phases (it
    builds none): ``april_filter_batch`` over phase 4's T1 x T2 stores and
    candidates (the full order in one trichotomy launch, ``("AA", "AF")``
    in two overlap launches), ``within_filter_batch`` over phase 10's T2 x
    T10 stores (one overlap launch) and ``linestring_filter_batch`` over
    phase 11's chains x T2 (two), each with ``backend="cuda"`` and its
    launches counted, held bit for bit to the staged rows function's plain
    versions (``backend="torch"``) on the lists the joins used; then
    ``examples_torch/quickstart.py`` in a child process, whose three
    filters must give the same pairs. Returns, by kernel, the keys its row
    of the ``kernels`` line gains."""
    from repro_torch import JoinPlan
    from repro_torch.core import join
    from repro_torch.kernels.interval_join import (april_trichotomy,
                                                   interval_overlap)
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 18 card: {smi}", flush=True)
    wrappers = (april_trichotomy, interval_overlap)
    lists = plan.filter._lists
    S, Z = plan.S, builds["Z"]
    r_ap, s_ap, z_ap = plan.approx_r, plan.approx_s, builds["z_approx"]
    line_ap, line_cands = builds["line_approx"], builds["line_cands"]
    w_cands = JoinPlan(S, Z, filter="april",
                       n_order=args.n_order).candidates("within")
    line = line_ap.store
    cases = (
        ("april_filter_batch", cands,
         lambda p, **kw: join.april_filter_batch(
             r_ap.store, s_ap.store, p, **kw),
         lambda p: join.april_trichotomy_rows(
             lists(r_ap, "A"), lists(r_ap, "F"), lists(s_ap, "A"),
             lists(s_ap, "F"), p[:, 0], p[:, 1], backend="torch",
             device=dev), {"april_trichotomy": 1, "interval_overlap": 0}),
        ("april_filter_batch AA-AF", cands,
         lambda p, **kw: join.april_filter_batch(
             r_ap.store, s_ap.store, p, ("AA", "AF"), **kw),
         lambda p: join.april_trichotomy_rows(
             lists(r_ap, "A"), lists(r_ap, "F"), lists(s_ap, "A"),
             lists(s_ap, "F"), p[:, 0], p[:, 1], backend="torch",
             order=("AA", "AF"), device=dev),
         {"april_trichotomy": 0, "interval_overlap": 2}),
        ("within_filter_batch", w_cands,
         lambda p, **kw: join.within_filter_batch(
             s_ap.store, z_ap.store, p, **kw),
         lambda p: join.within_trichotomy_rows(
             lists(s_ap, "A"), lists(z_ap, "A"), lists(z_ap, "F"),
             p[:, 0], p[:, 1], backend="torch", device=dev),
         {"april_trichotomy": 0, "interval_overlap": 1}),
        ("linestring_filter_batch", line_cands,
         lambda p, **kw: join.linestring_filter_batch(
             s_ap.store, line.off, line.ids, p, **kw),
         lambda p: join.linestring_trichotomy_rows(
             lists(line_ap, "line"), lists(s_ap, "A"), lists(s_ap, "F"),
             p[:, 0], p[:, 1], backend="torch", device=dev),
         {"april_trichotomy": 0, "interval_overlap": 2}),
    )
    launches, rows = {}, {}
    for label, pairs, wrapper, plain, need in cases:
        _reset(wrappers)
        t0 = time.perf_counter()
        got = wrapper(pairs, backend="cuda", device=dev)
        first = time.perf_counter() - t0
        launches[label] = {fn.__name__: fn.launches for fn in wrappers}
        t0 = time.perf_counter()
        wrapper(pairs, backend="cuda", device=dev)
        again = time.perf_counter() - t0
        want = plain(pairs)
        counts = np.bincount(want, minlength=3).tolist()
        print(f"[{label}] {len(pairs)} rows; launches "
              f"{json.dumps(launches[label])}; first call {first:.3f} s "
              f"(with any list conversion and upload), again {again:.3f} s; "
              f"TRUE_NEG/TRUE_HIT/INDECISIVE {counts} (card {smi})",
              flush=True)
        if launches[label] != need:
            raise AssertionError(f"[{label}] launches {launches[label]}, "
                                 f"not {need}")
        if got.dtype != np.int8 or not np.array_equal(got, want):
            raise AssertionError(f"[{label}] backend='cuda' != the rows "
                                 "function's plain versions")
        if label == "april_filter_batch" and 0 in counts:
            raise AssertionError(f"[{label}] a verdict class is empty")
        rows[label] = len(pairs)
    t_wrappers = time.perf_counter() - t_phase

    # the quickstart example in a child process, on the card
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(root / "src"), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable,
                           str(root / "examples_torch" / "quickstart.py")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=QUICKSTART_TIMEOUT)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"examples_torch/quickstart.py exited "
                             f"{proc.returncode}")
    digests = {m: (int(n), h) for m, n, h in re.findall(
        r"^(\S+) pairs: (\d+) sha1 (\w+)$", proc.stdout, re.M)}
    if sorted(digests) != ["april", "none", "ri"] \
            or len(set(digests.values())) != 1 \
            or digests["april"][0] == 0:
        raise AssertionError(f"the quickstart's filters gave different "
                             f"pairs: {digests}")
    t_quick = time.perf_counter() - t0
    secs = time.perf_counter() - t_phase
    print(f"phase 18 ok: raw-store wrappers == rows functions, launches "
          f"{json.dumps(launches)} ({t_wrappers:.1f} s); quickstart on the "
          f"card, three filters == {digests['april'][0]} pairs "
          f"({t_quick:.1f} s); {secs:.1f} s of a {HELPERS_BUDGET_S} s "
          f"budget (card {smi})", flush=True)

    def by(name) -> dict:
        """The wrapper calls that launched kernel ``name``: how often, and
        the candidate rows each was given."""
        calls = [k for k, v in launches.items() if v[name]]
        return {"launches_helpers": {k: launches[k][name] for k in calls},
                "helpers_rows": {k: rows[k] for k in calls}}
    return {name: by(name) for name in ("april_trichotomy",
                                        "interval_overlap")}


def _store_arrays(store) -> list:
    """(name, value) of every array, or VByte buffer list, of a store."""
    if hasattr(store, "a_bufs"):
        return [("a_bufs", store.a_bufs), ("f_bufs", store.f_bufs)]
    names = next(n for n in (("a_off", "a_ints", "f_off", "f_ints"),
                             ("off", "ints", "bit_off", "bits"),
                             ("off", "ids"), ("k", "origin", "shape"),
                             ("pent", "hull_off", "hull_pts"))
                 if all(hasattr(store, k) for k in n))
    out = [(k, getattr(store, k)) for k in names]
    if hasattr(store, "cells"):
        out += [(f"grid {i}", g) for i, g in enumerate(store.cells)]
    return out


def _same_store(label, got, want) -> None:
    """Two stores identical: every array's dtype, shape and bytes."""
    g, w = _store_arrays(got), _store_arrays(want)
    if [k for k, _ in g] != [k for k, _ in w]:
        raise AssertionError(f"[{label}] different store kinds")
    for (k, a), (_, b) in zip(g, w):
        same = (a == b if isinstance(a, list) else
                a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
        if not same:
            raise AssertionError(f"[{label}] store array {k} differs")


def _construction_phase(args, dev, R, S, plan, ri_r, ri_s, want_default,
                        want_default_st, builds, wrappers) -> None:
    """Phase 12: the construction paths. Every filter's ``torch`` build
    (the batched build with its PiP or clip pass on the card) at full size,
    each store identical to the numpy store an earlier phase built and the
    seconds of each stage beside it; the ``sequential`` builds and APRIL's
    per-polygon methods on a prefix, against the numpy build of the same
    prefix; one join through the ``torch``-built stores."""
    import torch
    from repro_torch import JoinPlan, PolygonDataset
    from repro_torch.core import april
    from repro_torch.core.geometry import BUILD_STAGES
    from repro_torch.spatial import get_filter
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 12 card: {smi}", flush=True)
    torch_opts = {"build_backend": "torch"}

    # the device busy share of two torch builds of phase 6's T1, profiled
    # first, while this process's profiler still records device events:
    # RI's (the clip pass) and APRIL's (the PiP pass)
    R2, Z = builds["R2"], builds["Z"]
    for label, fn in (
            (f"RI T1 x {len(R2)}", lambda: get_filter("ri").build(
                R2, n_order=args.n_order, device=dev, **torch_opts)),
            (f"APRIL T1 x {len(R2)}", lambda: april.build_april(
                R2, args.n_order, backend="torch", device=dev))):
        prof = _profile(fn)
        busy = (f"{prof['device_busy_us'] / 1e3:.2f} ms of "
                f"{prof['wall_us'] / 1e6:.2f} s "
                f"({100 * prof['device_busy_share']:.2f} %)"
                if prof["device_busy_us"] > 0 else
                "not measured: the trace holds no device event")
        print(f"profile [torch build, {label}] (card {smi}): device busy "
              f"{busy}; top {json.dumps(prof['top_device_us'])}",
              flush=True)

    # full size: each torch build against the numpy store of its phase,
    # the stage seconds of both; the APRIL build is the end-to-end plan's
    def timed(fn):
        with BUILD_STAGES.record() as stages:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0, stages

    def report(label, t_np, st_np, t_torch, st_torch):
        share = {k: round(v / t_torch, 3) for k, v in st_torch.items()}
        print(f"[construction {label}] numpy {t_np:.2f} s "
              f"{json.dumps({k: round(v, 3) for k, v in st_np.items()})}; "
              f"torch {t_torch:.2f} s "
              f"{json.dumps({k: round(v, 3) for k, v in st_torch.items()})} "
              f"(shares {json.dumps(share)}); stores identical "
              f"(card {smi})", flush=True)

    e2e, t, st = timed(lambda: JoinPlan(
        R, S, filter="april", n_order=args.n_order,
        build_opts=torch_opts).build())
    _same_store("april T1", e2e.approx_r.store, plan.approx_r.store)
    _same_store("april T2", e2e.approx_s.store, plan.approx_s.store)
    report(f"APRIL T1 x {len(R)} + T2 x {len(S)}", *builds["april"], t, st)
    ri_t, t, st = timed(lambda: JoinPlan(
        R, S, filter="ri", n_order=args.n_order,
        build_opts=torch_opts).build())
    _same_store("ri T1", ri_t.approx_r.store, ri_r.store)
    _same_store("ri T2", ri_t.approx_s.store, ri_s.store)
    report(f"RI T1 x {len(R)} + T2 x {len(S)}", *builds["ri"], t, st)
    del ri_t
    z_store, t, st = timed(lambda: april.build_april(
        Z, args.n_order, backend="torch", device=dev))
    _same_store("april T10", z_store, builds["z_store"])
    report(f"APRIL T10 x {len(Z)}", *builds["april T10"], t, st)
    S2 = builds["S2"]
    for name in ("ra", "5cch"):
        host, t, st = timed(lambda: JoinPlan(
            R2, S2, filter=name, n_order=args.n_order,
            build_opts=torch_opts).build())
        want_r, want_s = builds[f"{name} stores"]
        _same_store(f"{name} T1", host.approx_r.store, want_r.store)
        _same_store(f"{name} T2", host.approx_s.store, want_s.store)
        report(f"{name} T1 x {len(R2)} + T2 x {len(S2)}", *builds[name], t,
               st)

    # the join through the torch-built stores: the main path's launches
    _reset(wrappers)
    t0 = time.perf_counter()
    res, st = e2e.execute("intersects")
    torch.cuda.synchronize()
    launched = _launched("construction-e2e", wrappers)
    _same_run("construction-e2e", res, st, want_default, want_default_st)
    for name in ("april_trichotomy", "edges_intersect_csr"):
        if launched[name] <= 0:
            raise AssertionError(f"[construction-e2e] {name} never launched")
    print(f"[construction-e2e] JoinPlan(build_opts={torch_opts}) "
          f"intersects {time.perf_counter() - t0:.2f} s: {len(res)} pairs, "
          f"order and counts == phase 4's default run; launches "
          f"{json.dumps(launched)} (card {smi})", flush=True)
    del e2e

    # a prefix: the sequential builds, the torch builds and APRIL's
    # per-polygon methods, each against the numpy build of the prefix
    n_poly, n_chain = CONSTRUCTION_PREFIX
    L = builds["chains"]
    prefix = {"polygon": PolygonDataset("T1 prefix", R.verts[:n_poly],
                                        R.nverts[:n_poly]),
              "line": PolygonDataset("T8 prefix", L.verts[:n_chain],
                                     L.nverts[:n_chain])}
    secs = {}
    for name in ("april", "april-c", "ri", "ra", "5cch"):
        filt = get_filter(name)
        for kind, D in prefix.items():
            want = filt.build(D, n_order=args.n_order, kind=kind).store
            for backend in ("torch", "sequential"):
                t0 = time.perf_counter()
                got = filt.build(D, n_order=args.n_order, kind=kind,
                                 build_backend=backend, device=dev).store
                secs[f"{name} {kind} {backend}"] = round(
                    time.perf_counter() - t0, 3)
                _same_store(f"{name} {kind} {backend}", got, want)
    few = PolygonDataset("T1 prefix", R.verts[:NEIGHBORS_PREFIX],
                         R.nverts[:NEIGHBORS_PREFIX])
    for method in ("pips", "neighbors", "scanline", "floodfill"):
        D = few if method == "neighbors" else prefix["polygon"]
        want = plan.filter.build(D, n_order=args.n_order).store
        t0 = time.perf_counter()
        got = get_filter("april").build(D, n_order=args.n_order,
                                        method=method).store
        secs[f"april method {method}"] = round(time.perf_counter() - t0, 3)
        _same_store(f"april {method}", got, want)
    print(f"[construction prefix] T1 x {n_poly}, T8 x {n_chain}: every "
          f"filter's torch and sequential builds (polygon and line) and "
          f"APRIL's methods pips, scanline and floodfill (neighbors on T1 x "
          f"{NEIGHBORS_PREFIX}) == the numpy build of the prefix; seconds "
          f"{json.dumps(secs)}", flush=True)
    print(f"phase 12 ok: construction paths "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)


def _copied(approx):
    """A copy of a built store's approximation, synced to the start of a
    service's mutation log: each service patches its own stores."""
    import copy
    from repro_torch.spatial.filters import Approximation
    return Approximation(filter=approx.filter,
                         store=copy.deepcopy(approx.store),
                         n_order=approx.n_order, extent=approx.extent,
                         kind=approx.kind,
                         meta={"build_opts": dict(approx.meta["build_opts"]),
                               "mutation_seq": 0})


def _drive_service(svc, did, trace, Q, mutate_seed, first=None):
    """The trace through ``svc``, drained every ``SERVICE_GROUP`` requests,
    with an insert (a polygon of ``Q``) and a delete every
    ``SERVICE_MUTATE`` requests. Returns (tickets, the dataset each
    ticket's drain ran on). ``first`` runs the first drain in its place
    (the profiled drain)."""
    rng = np.random.default_rng(mutate_seed)
    tickets, drained_on, pending = [], [], 0
    for i, (pred, payload) in enumerate(trace):
        tickets.append(svc.submit(did, pred, payload))
        pending += 1
        if (i + 1) % SERVICE_MUTATE == 0:
            qi = int(rng.integers(len(Q)))
            svc.insert(did, Q.verts[qi, : Q.nverts[qi]])
            svc.delete(did, int(rng.integers(len(svc.dataset(did)))))
        if pending == SERVICE_GROUP or i == len(trace) - 1:
            drained_on += [svc.dataset(did)] * pending
            if first is not None and len(drained_on) == pending:
                first(svc.drain)
            else:
                svc.drain()
            pending = 0
    return [t.wait(0) for t in tickets], drained_on


def _per_request(trace, drained_on, dev) -> list:
    """Each request alone: a one-request ``JoinPlan`` (filter ``none``,
    numpy backends: every candidate refined on the host) over the dataset
    as it stood at the request's drain; its pair set."""
    from repro_torch import JoinPlan, PolygonDataset
    out = []
    for (pred, payload), D in zip(trace, drained_on):
        if pred == "window":
            x0, y0, x1, y1 = payload
            payload = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
            pred = "selection"
        q = np.asarray(payload, np.float64)
        one = PolygonDataset("one", q[None], np.array([len(q)]))
        res, _ = JoinPlan(D, one, filter="none", filter_backend="numpy",
                          refine_backend="numpy", device=dev).execute(pred)
        out.append(_pair_set(res))
    return out


def _service_phase(args, dev, R, S, plan, ri_s, wrappers) -> dict:
    """Phase 13: the online join service on the card. Returns, by kernel,
    the keys its row of the ``kernels`` line gains: the launches of each
    service trace."""
    import torch
    from repro_torch.core.join import IntervalLists
    from repro_torch.core import join as join_mod
    from repro_torch.core import ri as ri_mod
    from repro_torch.core.ri import RIDeviceStore
    from repro_torch.launch.serve_join import make_trace, run_serve
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.spatial import JoinService, MBRIndex, fused, get_filter
    from repro_torch.spatial import refine as refine_mod
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 13 card: {smi}", flush=True)
    did = "water"
    trace = make_trace(np.random.default_rng(SERVICE_SEED), R,
                       SERVICE_REQUESTS)
    counter = {"april_trichotomy": "april_trichotomy",
               "interval_overlap": "interval_overlap",
               "edges_intersect": "edges_intersect_csr",
               "exclusive_scan": "compact_mask",
               "ri_trichotomy": "ri_trichotomy"}
    launches, tickets, extra = {}, {}, {}

    def service(method, **opts):
        svc = JoinService(method=method, n_order=args.n_order, device=dev,
                          **opts)
        svc.register_dataset(did, S)
        return svc

    def run(label, svc, trace_, need, first=None):
        """One service trace: counts reset before and read after, every
        kernel input recorded and replayed, every ticket held to its
        one-request run (or, fused, to the staged tickets)."""
        _reset(wrappers)
        t0 = time.perf_counter()
        with refine_mod.record_sweeps() as sweeps, \
                fused.record_chains() as chains, \
                join_mod.record_joins() as joins, \
                ri_mod.record_frames() as frames:
            got, drained_on = _drive_service(svc, did, trace_, R,
                                             SERVICE_SEED, first)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = _launched(label, wrappers)
        for name in need:
            if launches[label][name] <= 0:
                raise AssertionError(f"[{label}] {name} never launched")
        lat = svc.latency_stats()
        # a group's tickets share its stats: t_build is the group's
        # query-side build (the data side is the warm store)
        groups = {id(t.stats): t.stats for t in got}.values()
        t_build = sum(st["t_build"] for st in groups)
        print(f"[{label}] {len(got)} requests in {wall:.2f} s "
              f"({len(got) / wall:.1f} queries/s), p50 "
              f"{lat['p50_s'] * 1e3:.2f} ms, p99 {lat['p99_s'] * 1e3:.2f} "
              f"ms; query-side builds {t_build:.2f} s; stage seconds "
              f"{json.dumps(lat['stage_times'])}; "
              f"service {json.dumps(svc.stats)}; cache "
              f"{json.dumps(svc.cache.stats)}; launches "
              f"{json.dumps(launches[label])} (card {smi})", flush=True)
        print(f"[{label}] {_replayed(label, joins, sweeps, chains, frames)}",
              flush=True)
        del joins, sweeps, chains, frames
        tickets[label] = got
        return got, drained_on

    def same_as(label, got, want, exact):
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            if exact and not np.array_equal(a.pairs, b.pairs):
                raise AssertionError(f"[{label}] ticket {i}: pairs or their "
                                     "order differ from the staged ticket")
            if not exact and _pair_set(a.pairs) != b:
                raise AssertionError(f"[{label}] ticket {i} != its "
                                     "one-request run")

    # 1. APRIL micro-batched: staged (the first drain profiled) and fused,
    # each against the one-request runs and the fused against the staged
    busy = {}

    def profiled(drain):
        prof = _profile(drain)
        busy["drain"] = (
            f"{prof['device_busy_us'] / 1e3:.2f} ms of "
            f"{prof['wall_us'] / 1e3:.2f} ms "
            f"({100 * prof['device_busy_share']:.2f} %); top "
            f"{json.dumps(prof['top_device_us'])}"
            if prof["device_busy_us"] > 0 else
            "not measured: the trace holds no device event")

    staged = service("april", filter_backend="cuda", refine_backend="cuda")
    staged.cache.put((did, "april", args.n_order), _copied(plan.approx_s))
    got, drained_on = run("service-april-staged", staged, trace,
                          ("april_trichotomy", "interval_overlap",
                           "edges_intersect_csr"), first=profiled)
    print(f"profile [service, one staged drain of {SERVICE_GROUP} "
          f"requests] (card {smi}): device busy {busy['drain']}",
          flush=True)
    t0 = time.perf_counter()
    want = _per_request(trace, drained_on, dev)
    same_as("service-april-staged", got, want, exact=False)
    n_pairs = sum(len(t.pairs) for t in got)
    print(f"[service-april-staged] every ticket == its one-request run "
          f"over the dataset at its drain ({len(want)} runs, "
          f"{time.perf_counter() - t0:.1f} s; {n_pairs} pairs; card {smi})",
          flush=True)
    fused_svc = service("april", pipeline_mode="fused")
    fused_svc.cache.put((did, "april", args.n_order), _copied(plan.approx_s))
    got_f, _ = run("service-april-fused", fused_svc, trace,
                   ("april_trichotomy", "interval_overlap", "compact_mask"))
    same_as("service-april-fused", got_f, got, exact=True)
    print("[service-april-fused] every ticket == the staged ticket: pairs "
          "and order", flush=True)

    # 2. the patched stores against fresh builds, host and device copies
    D = staged.dataset(did)
    t0 = time.perf_counter()
    fresh = get_filter("april").build(D, n_order=args.n_order,
                                      build_backend="torch", device=dev)
    t_fresh = time.perf_counter() - t0
    for label, svc in (("staged", staged), ("fused", fused_svc)):
        approx = svc.cache.get((did, "april", args.n_order))
        if approx.meta["mutation_seq"] != svc.datasets[did].seq:
            raise AssertionError(f"[{label}] the store is not synced")
        _same_store(f"service {label} APRIL", approx.store, fresh.store)
        for kind in ("A", "F"):
            lists = approx.meta["interval_lists"][kind]
            want_l = IntervalLists.from_intervals(
                *((fresh.store.a_off, fresh.store.a_ints) if kind == "A"
                  else (fresh.store.f_off, fresh.store.f_ints)))
            pairs_ = list(zip(lists.to(dev), want_l.to(dev))) + [
                (lists.last_keys(dev), want_l.last_keys(dev))]
            for a, b in pairs_:
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"[service {label}] the device "
                                         f"copy of the {kind} lists != a "
                                         "fresh build's")
        idx = svc.datasets[did].index
        again = MBRIndex(D.mbrs, grid=idx.k, extent=idx.extent)
        for k in ("mbrs", "lo", "_obj", "_buck"):
            if not np.array_equal(getattr(idx, k), getattr(again, k)):
                raise AssertionError(f"[service {label}] the MBR index's "
                                     f"{k} != a fresh index's")
    print(f"[service-april] after {staged.stats['inserts']} inserts and "
          f"{staged.stats['deletes']} deletes both services' stores == a "
          f"fresh build of the {len(D)} polygons (torch build "
          f"{t_fresh:.1f} s): every array's dtype, shape and bytes, the "
          f"lists' device copies and row keys; MBR index == a fresh index "
          f"(grid {staged.datasets[did].index.k}); tolerance: exact "
          f"(card {smi})", flush=True)

    # 1 and 2 for RI, the services seeded with copies of phase 5's RI store
    # of T2 (encoding S), as a restore would seed them
    ri_trace = trace[:SERVICE_RI_REQUESTS]
    ri_staged = service("ri", filter_backend="cuda", refine_backend="cuda")
    ri_fused = service("ri", pipeline_mode="fused")
    for svc in (ri_staged, ri_fused):
        svc.cache.put((did, "ri", args.n_order), _copied(ri_s))
    got_r, drained_r = run("service-ri-staged", ri_staged, ri_trace,
                           ("ri_trichotomy", "edges_intersect_csr"))
    same_as("service-ri-staged", got_r,
            want[:SERVICE_RI_REQUESTS], exact=False)
    got_rf, _ = run("service-ri-fused", ri_fused, ri_trace,
                    ("ri_trichotomy", "compact_mask"))
    same_as("service-ri-fused", got_rf, got_r, exact=True)
    D_r = ri_staged.dataset(did)
    t0 = time.perf_counter()
    fresh_r = get_filter("ri").build(D_r, n_order=args.n_order,
                                     encoding=ri_s.store.encoding,
                                     build_backend="torch", device=dev)
    t_fresh = time.perf_counter() - t0
    want_dev = RIDeviceStore(fresh_r.store).to(dev)
    for label, svc in (("staged", ri_staged), ("fused", ri_fused)):
        approx = svc.cache.get((did, "ri", args.n_order))
        _same_store(f"service {label} RI", approx.store, fresh_r.store)
        for a, b in zip(approx.meta["device_store"].to(dev), want_dev):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[service {label}] the RI device "
                                     "store != a fresh build's")
    print(f"[service-ri] tickets == the one-request runs (staged) and the "
          f"staged tickets (fused); after {ri_staged.stats['inserts']} "
          f"inserts and deletes both stores == a fresh RI build (torch "
          f"{t_fresh:.1f} s), host arrays and RIDeviceStore tensors; "
          f"tolerance: exact (card {smi})", flush=True)
    del ri_staged, ri_fused, fresh_r, want_dev

    # 4. adaptive: the planner picks each group's filter, order and mode,
    # replanning once the drift reaches SERVICE_REPLAN_AFTER mutations
    ad_trace = trace[:SERVICE_ADAPTIVE_REQUESTS]
    adaptive = service("april", plan_mode="adaptive",
                       replan_after=SERVICE_REPLAN_AFTER)
    got_a, _ = run("service-adaptive", adaptive, ad_trace, ())
    same_as("service-adaptive", got_a, want[:SERVICE_ADAPTIVE_REQUESTS],
            exact=False)
    picks = {}
    for t in got_a:
        c = t.stats["extra"]["plan"]
        key = (f"{t.predicate}: {c['method']}/n{c['n_order']}/"
               f"{'-'.join(c['order'])} {c['pipeline_mode']}")
        picks[key] = picks.get(key, 0) + 1
    n_keys = len(adaptive._plans)
    if adaptive.stats["replans"] < 2 or adaptive.stats["replans"] <= n_keys:
        raise AssertionError(f"[service-adaptive] {adaptive.stats['replans']}"
                             f" replans over {n_keys} group keys: no replan "
                             "on drift")
    print(f"[service-adaptive] {adaptive.stats['replans']} replans over "
          f"{n_keys} group keys (replan_after {SERVICE_REPLAN_AFTER}); "
          f"tickets == the static runs' pair sets; choices by request "
          f"{json.dumps(picks)} (card {smi})", flush=True)
    del adaptive

    # 5. checkpoint round trip, then 6. eviction under a small budget
    ck_trace = make_trace(np.random.default_rng(SERVICE_SEED + 1), R,
                          SERVICE_CKPT_REQUESTS)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, async_save=False)
        t0 = time.perf_counter()
        staged.save_checkpoint(mgr, step=1)
        t_save = time.perf_counter() - t0
        size = staged.cache.get((did, "april", args.n_order)).size_bytes()
        restored = JoinService.restore_checkpoint(
            mgr, device=dev, filter_backend="cuda", refine_backend="cuda",
            cache_bytes=size + 1)
    answers = []
    for svc in (staged, restored):
        ts = [svc.submit(did, p, q) for p, q in ck_trace]
        svc.drain()
        answers.append([t.wait(0).pairs for t in ts])
    for i, (a, b) in enumerate(zip(*answers)):
        if _pair_set(a) != _pair_set(b):
            raise AssertionError(f"[service-checkpoint] request {i}: the "
                                 "restored service answers otherwise")
    print(f"[service-checkpoint] saved in {t_save:.2f} s, restored; "
          f"{len(ck_trace)} requests give the same pairs on both services "
          f"({sum(len(a) for a in answers[0])} pairs; card {smi})",
          flush=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    restored.register_dataset("landmarks", R)
    restored.warm_store("landmarks")
    after = torch.cuda.memory_allocated()
    if restored.cache.stats["evictions"] != 1 or not after < before:
        raise AssertionError(f"[service-eviction] evictions "
                             f"{restored.cache.stats['evictions']}, device "
                             f"memory {before} -> {after} bytes")
    print(f"[service-eviction] budget {size + 1} bytes (the water store's "
          f"size + 1): warming the landmarks' store evicted it; "
          f"torch.cuda.memory_allocated {before} -> {after} bytes "
          f"(card {smi})", flush=True)
    del restored

    # 7. the background worker: the staged service, whose device copies
    # this thread's drains uploaded, answers the checkpoint requests again
    # from the worker's thread; the record blocks opened here must hold
    # the worker's kernel inputs, which are replayed
    _reset(wrappers)
    with refine_mod.record_sweeps() as sweeps, \
            fused.record_chains() as chains, \
            join_mod.record_joins() as joins, \
            ri_mod.record_frames() as frames:
        staged.start()
        ts = [staged.submit(did, p, q) for p, q in ck_trace]
        staged.stop()
    torch.cuda.synchronize()
    launches["service-worker"] = {fn.__name__: fn.launches
                                  for fn in wrappers}
    if not (joins and sweeps) or \
            launches["service-worker"]["april_trichotomy"] <= 0:
        raise AssertionError("[service-worker] the worker's kernel inputs "
                             "were not recorded here, or B1 never ran")
    for i, (t, a) in enumerate(zip(ts, answers[0], strict=True)):
        if _pair_set(t.wait(0).pairs) != _pair_set(a):
            raise AssertionError(f"[service-worker] request {i} != the "
                                 "synchronous drain's answer")
    print(f"[service-worker] {len(ts)} requests drained by the worker "
          f"thread ({staged.stats['batches']} batches so far) == the "
          f"synchronous drains' answers; launches "
          f"{json.dumps(launches['service-worker'])}; "
          f"{_replayed('service-worker', joins, sweeps, chains, frames)} "
          f"(card {smi})", flush=True)
    del staged, fused_svc, joins, sweeps, chains, frames

    # 8. run_serve with the background worker
    t0 = time.perf_counter()
    report = run_serve(dataset="T2", count=len(S), query_layer="T1",
                       n_queries=len(R), n_requests=SERVE_REQUESTS,
                       method="april", n_order=args.n_order,
                       mutate_every=SERVICE_MUTATE, seed=1, device=dev)
    lat = report["latency"]
    print(f"[run_serve] {report['n_requests']} requests through the "
          f"background worker in {report['elapsed_s']:.2f} s (with its cold "
          f"build {time.perf_counter() - t0:.1f} s): "
          f"{report['queries_per_s']:.1f} queries/s, p50 "
          f"{lat['p50_s'] * 1e3:.2f} ms, p99 {lat['p99_s'] * 1e3:.2f} ms; "
          f"stage seconds {json.dumps(lat['stage_times'])}; cache "
          f"{json.dumps(report['cache'])}; service "
          f"{json.dumps(report['service'])}; {report['results_total']} "
          f"pairs (card {smi})", flush=True)
    if report["service"]["batched_requests"] != SERVE_REQUESTS:
        raise AssertionError("[run_serve] not every request was served")

    for name, wrapper in counter.items():
        extra[name] = {"launches_service": {
            label: n[wrapper] for label, n in launches.items()}}
    print(f"phase 13 ok: the join service "
          f"({time.perf_counter() - t_phase:.1f} s; card {smi})", flush=True)
    return extra


def _scaleout_rank_child(rank: int, tmp: str) -> None:
    """One rank of phase 14's two-rank check, in a child process on
    ``cuda:0``: the four sharded stages on the partition the parent saved
    in ``tmp``, first in a world of one, then as rank ``rank`` of two gloo
    ranks over a ``FileStore``; writes whether each output equals the
    world-of-one output, with its seconds, to ``rank_<rank>.json``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.join import INDECISIVE
    from repro_torch.spatial import Approximation
    from repro_torch.spatial import distributed as D
    from repro_torch.state import april_store_from_arrays, dataset_from_arrays
    z = np.load(Path(tmp) / "partition.npz")
    Rp = dataset_from_arrays("r", z["r_verts"], z["r_nverts"])
    Sp = dataset_from_arrays("s", z["s_verts"], z["s_nverts"])
    ar, as_ = (Approximation(filter="april", store=april_store_from_arrays(
        int(z["n_order"]), tuple(z[f"{k}_extent"]), z[f"{k}_a_off"],
        z[f"{k}_a_ints"], z[f"{k}_f_off"], z[f"{k}_f_ints"]),
        n_order=int(z["n_order"])) for k in "rs")
    dev = torch.device("cuda")

    def stages(mesh):
        """The four stages' outputs and seconds."""
        out, secs = {}, {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return out[name][0]

        pairs = timed("mbr", lambda: D.distributed_mbr_join(
            Rp.mbrs, Sp.mbrs, mesh=mesh))
        verd = timed("filter", lambda: D.distributed_filter(
            "april", ar, as_, pairs, mesh=mesh, backend="cuda"))
        timed("refine", lambda: D.distributed_refine(
            Rp, Sp, pairs[verd == INDECISIVE], mesh=mesh))
        timed("fused", lambda: D.distributed_fused_join(Rp, Sp, ar, as_,
                                                        mesh=mesh))
        return out, secs

    one, t_one = stages(D.make_join_mesh(device=dev))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / "store"), 2), rank=rank, world_size=2)
    mesh = D.make_join_mesh(2, device=dev)
    two, t_two = stages(mesh)
    dist.barrier()          # no rank tears the group down under another
    dist.destroy_process_group()
    same = {k: bool(np.array_equal(one[k][0], two[k][0])
                    and one[k][1] == two[k][1]) for k in one}
    Path(tmp, f"rank_{rank}.json").write_text(json.dumps({
        "rank": mesh.rank, "size": mesh.size, "same": same,
        "seconds_one": t_one, "seconds_two": t_two,
        "counts": {k: v[1] for k, v in two.items()},
        "pairs": len(two["fused"][0])}))


def _two_ranks(Rp, Sp, ar, as_, smi) -> list:
    """Phase 14's two ranks on the one card: the partition and its APRIL
    stores saved, two child processes of this script run as gloo ranks
    (``_scaleout_rank_child``); each rank's four sharded stages must equal
    its world-of-one outputs. Returns the ranks' reports."""
    with tempfile.TemporaryDirectory() as tmp:
        arrays = {"n_order": ar.n_order}
        for k, D_, a in (("r", Rp, ar), ("s", Sp, as_)):
            st = a.store
            arrays.update({f"{k}_verts": D_.verts, f"{k}_nverts": D_.nverts,
                           f"{k}_a_off": st.a_off, f"{k}_a_ints": st.a_ints,
                           f"{k}_f_off": st.f_off, f"{k}_f_ints": st.f_ints,
                           f"{k}_extent": np.asarray(
                               [st.extent.x0, st.extent.y0,
                                st.extent.side])})
        np.savez(Path(tmp) / "partition.npz", **arrays)
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; "
                "chip_smoke._scaleout_rank_child(int(sys.argv[2]), "
                "sys.argv[3])")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", code,
             str(Path(__file__).resolve().parent), str(r), tmp])
            for r in range(2)]
        try:
            rcs = [p.wait(timeout=SCALEOUT_RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0, 0]:
            raise AssertionError(f"[two ranks] the rank processes exited "
                                 f"with {rcs}")
        reports = [json.loads((Path(tmp) / f"rank_{r}.json").read_text())
                   for r in range(2)]
    for rep in reports:
        if rep["size"] != 2 or not all(rep["same"].values()):
            raise AssertionError(f"[two ranks] rank {rep['rank']} != the "
                                 f"world of one: {rep['same']}")
    print(f"[two ranks] two gloo ranks on cuda:0 (a FileStore), "
          f"{len(Rp)} x {len(Sp)} objects of partition 0: each rank's "
          f"sharded MBR join, filter, refine and fused join == its world-of-"
          f"one outputs, pairs and counts ({reports[0]['pairs']} fused "
          f"pairs; counts {json.dumps(reports[0]['counts'])}); seconds a "
          f"stage of each rank, world of one then two ranks: "
          f"{json.dumps([[r['seconds_one'], r['seconds_two']] for r in reports])}; "
          f"{time.perf_counter() - t0:.1f} s with the processes' start "
          f"(card {smi})", flush=True)
    return reports


def _scaleout_phase(args, dev, want, wrappers) -> dict:
    """Phase 14: the scale-out path on the card (the partitioned launcher,
    the sharded stages on two ranks, the out-of-core tiled join), at phase
    6's counts; ``want`` is phase 6's pair set. Returns,
    by kernel, the keys its row of the ``kernels`` line gains: the launches
    of each run."""
    import torch
    from repro_torch.core import join as join_mod
    from repro_torch.core import partition as part_mod
    from repro_torch.core import ri as ri_mod
    from repro_torch.datagen import (PolygonDataset, iter_dataset_chunks,
                                     make_chunked_dataset, make_dataset)
    from repro_torch import JoinPlan
    from repro_torch.launch.spatial_join import run_join
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.spatial import distributed as D
    from repro_torch.spatial import fused, get_filter
    from repro_torch.core.geometry import BUILD_STAGES
    from repro_torch.spatial import refine as refine_mod
    from repro_torch.spatial.planner import _store_ints
    from repro_torch.spatial.scaleout import plan_scaleout, tiled_join
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 14 card: {smi}", flush=True)
    counter = {"april_trichotomy": "april_trichotomy",
               "interval_overlap": "interval_overlap",
               "edges_intersect": "edges_intersect_csr",
               "exclusive_scan": "compact_mask",
               "ri_trichotomy": "ri_trichotomy"}
    launches, recorded = {}, {}
    mesh = D.make_join_mesh(device=dev)

    def run(label, fn, need=(), replay=True):
        """One run: launch counts reset before and read after, every kernel
        input recorded (and, with ``replay``, replayed)."""
        _reset(wrappers)
        t0 = time.perf_counter()
        with refine_mod.record_sweeps() as sweeps, \
                fused.record_chains() as chains, \
                join_mod.record_joins() as joins, \
                ri_mod.record_frames() as frames:
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = _launched(label, wrappers)
        for name in need:
            if launches[label][name] <= 0:
                raise AssertionError(f"[{label}] {name} never launched")
        recorded[label] = (joins, sweeps, chains, frames)
        print(f"[{label}] {wall:.2f} s; launches "
              f"{json.dumps(launches[label])} (card {smi})", flush=True)
        if replay:
            print(f"[{label}] {_replayed(label, joins, sweeps, chains, frames)}",
                  flush=True)
        return out

    def same_set(label, res, want_set):
        if _pair_set(res) != want_set:
            raise AssertionError(f"[{label}] pair set != the reference's "
                                 f"({len(_pair_set(res))} != "
                                 f"{len(want_set)})")

    # the launcher at phase 6's counts, a third of phase 4's, for the
    # script's time limit
    size = dict(r_name="T1", s_name="T2", n_order=args.n_order,
                parts=SCALEOUT_PARTS, seed=0,
                count_r=args.r_count // HOST_SCALE,
                count_s=args.s_count // HOST_SCALE, mesh=mesh)
    # 1. the partitioned launcher; the fused run is profiled first (a
    # process some minutes old records no device events)
    box = []
    prof = _profile_showing("launcher-fused", lambda: box.append(run(
        "launcher-fused", lambda: run_join(pipeline_mode="fused", **size),
        need=("april_trichotomy", "compact_mask"), replay=False)),
        "compact_mask_kernel")
    print(f"profile [launcher-fused] (card {smi}): device busy "
          f"{prof['device_busy_us'] / 1e3:.2f} ms of "
          f"{prof['wall_us'] / 1e6:.2f} s "
          f"({100 * prof['device_busy_share']:.2f} %)", flush=True)
    print(f"[launcher-fused] {_replayed('launcher-fused', *recorded['launcher-fused'])}",
          flush=True)
    same_set("launcher-fused", box[-1][0], want)
    del box
    with tempfile.TemporaryDirectory() as ck:
        res, totals = run("launcher-sharded", lambda: run_join(
            backend="cuda", mbr_backend="torch", refine_backend="device64",
            ckpt_dir=ck, **size), need=("april_trichotomy",))
        same_set("launcher-sharded", res, want)
        step, flat, _ = CheckpointManager(ck).restore()
        if sorted(flat) != [f"part_{p}" for p in range(SCALEOUT_PARTS ** 2)]:
            raise AssertionError(f"[launcher-sharded] checkpoint holds "
                                 f"{sorted(flat)}")
        res2, _ = run("launcher-resumed", lambda: run_join(
            backend="cuda", mbr_backend="torch", refine_backend="device64",
            ckpt_dir=ck, **size))
        if any(launches["launcher-resumed"].values()):
            raise AssertionError("[launcher-resumed] a partition ran again")
        same_set("launcher-resumed", res2, want)
    res, _ = run("launcher-staged", lambda: run_join(
        backend="cuda", refine_backend="cuda", **size),
        need=("april_trichotomy", "edges_intersect_csr"))
    same_set("launcher-staged", res, want)
    res, totals = run("launcher-adaptive", lambda: run_join(
        plan_mode="adaptive", **size))
    same_set("launcher-adaptive", res, want)
    res, _ = run("launcher-ri", lambda: run_join(
        method="ri", backend="cuda", refine_backend="cuda",
        build_backend="torch", **size),
        need=("ri_trichotomy", "edges_intersect_csr"))
    same_set("launcher-ri", res, want)
    print(f"[launcher] at {size['count_r']} x {size['count_s']}: fused, "
          f"sharded (and resumed), staged, adaptive and RI: {len(want)} "
          f"pairs == phase 6's set (card {smi})", flush=True)

    # 2. the sharded stages of partition 0 of the launcher's run: its fused
    # chain under set_sync_debug_mode("error"), then two ranks on the card
    R = make_dataset("T1", seed=0, count=size["count_r"])
    S = make_dataset("T2", seed=1, count=size["count_s"])
    parting = part_mod.partition_space([R, S], SCALEOUT_PARTS)
    p0 = parting.partitions[0]
    Rp = PolygonDataset("r", R.verts[p0.obj_idx["T1"]],
                        R.nverts[p0.obj_idx["T1"]])
    Sp = PolygonDataset("s", S.verts[p0.obj_idx["T2"]],
                        S.nverts[p0.obj_idx["T2"]])
    april = get_filter("april")
    ar = april.build(Rp, n_order=args.n_order, extent=p0.extent, side="r")
    as_ = april.build(Sp, n_order=args.n_order, extent=p0.extent, side="s")
    with fused.record_chains() as chains:
        D.distributed_fused_join(Rp, Sp, ar, as_, mesh=mesh)
    frame = D.shard_frame(Rp, Sp, None, mesh)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cs = D.fused_shard_lanes(Rp, Sp, ar, as_, frame, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    (want_cs,) = chains
    if not (torch.equal(cs.status, want_cs.status)
            and torch.equal(cs.hit, want_cs.hit)):
        raise AssertionError("[sync-checked] the sharded chain wrote other "
                             "lanes")
    print(f"[sync-checked] partition 0 ({len(Rp)} x {len(Sp)}, "
          f"{len(frame.ri)} frame rows): the sharded fused chain's device "
          f"stages passed set_sync_debug_mode('error'), status and hit "
          f"lanes == the unchecked run's", flush=True)
    del chains, want_cs, cs
    _two_ranks(Rp, Sp, ar, as_, smi)

    # 3. the out-of-core tiled join over the chunk streams
    def chunks(n_r, n_s):
        return (iter_dataset_chunks("T1", seed=0, count=n_r,
                                    chunk_size=SCALEOUT_CHUNK),
                iter_dataset_chunks("T2", seed=1, count=n_s,
                                    chunk_size=SCALEOUT_CHUNK))

    def budget(n_r, n_s, **opts):
        """A tile budget a sixth of the plan's estimated bytes."""
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            plan, _, _ = plan_scaleout(*chunks(n_r, n_s), spill_dir=tmp,
                                       n_order=args.n_order, **opts)
            t_plan = time.perf_counter() - t0
        b = int(plan.est["total_bytes"] // SCALEOUT_BUDGET_SHARE)
        # the partitions' intervals as the probes estimate them: a
        # partition rasterises its objects at n_order over its own extent
        ints = sum(p.est.get("mean_ints_r", 0.0) * p.n_r
                   + p.est.get("mean_ints_s", 0.0) * p.n_s
                   for p in plan.parts)
        print(f"[tiled-plan] {n_r} x {n_s}: estimated "
              f"{plan.est['total_bytes']} bytes over {len(plan.parts)} "
              f"partitions, {plan.est['n_splits']} splits, {ints:.0f} "
              f"intervals; budget {b} bytes ({t_plan:.1f} s)", flush=True)
        return b

    def in_memory(n_r, n_s):
        t0 = time.perf_counter()
        Rm = make_chunked_dataset("T1", seed=0, count=n_r,
                                  chunk_size=SCALEOUT_CHUNK)
        Sm = make_chunked_dataset("T2", seed=1, count=n_s,
                                  chunk_size=SCALEOUT_CHUNK)
        jp = JoinPlan(Rm, Sm, filter="april", n_order=args.n_order,
                      device=dev).build()
        res, st = jp.execute("intersects")
        ints = _store_ints(jp.approx_r.store) + _store_ints(jp.approx_s.store)
        print(f"[tiled-reference] in-memory staged cuda JoinPlan over "
              f"make_chunked_dataset {n_r} x {n_s}: {len(res)} pairs, "
              f"{st.n_candidates} candidates, {ints} intervals, t_build "
              f"{st.t_build:.2f} s ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return _pair_set(res), st

    def tiled(label, n_r, n_s, need=(), **kw):
        with BUILD_STAGES.record() as stages:
            res, st = run(label, lambda: tiled_join(
                *chunks(n_r, n_s), n_order=args.n_order, device=dev, **kw),
                need=need)
        tp = st.extra["tile_plan"]
        # t_partition holds the probe builds, t_build the partitions'
        print(f"[{label}] tiles {st.tiles} ({st.extra['resumed_tiles']} "
              f"resumed), n_splits {tp['n_splits']}, t_partition "
              f"{st.t_partition:.2f} s (probe builds "
              f"{stages.get('probe', 0.0):.2f} s), t_build "
              f"{st.t_build:.2f} s (partition builds); build stages of "
              f"both {json.dumps(stages)}; "
              f"{json.dumps(st.stage_times())}; candidates "
              f"{st.n_candidates}, TRUE_HIT/TRUE_NEG/INDECISIVE "
              f"{st.n_true_hits}/{st.n_true_negs}/{st.n_indecisive}, "
              f"{st.n_results} result pairs (card {smi})", flush=True)
        return res, st

    n_r = args.r_count // WITHIN_HOST_SCALE
    n_s = args.s_count // WITHIN_HOST_SCALE
    b = budget(n_r, n_s, **SCALEOUT_SPLIT)
    want_t, _ = in_memory(n_r, n_s)
    runs = {}
    for mode in ("staged", "fused"):
        label = f"tiled-{mode}"
        res, st = tiled(label, n_r, n_s, need=(
            ("april_trichotomy", "edges_intersect_csr") if mode == "staged"
            else ("april_trichotomy", "compact_mask")),
            pipeline_mode=mode, tile_budget=b, **SCALEOUT_SPLIT)
        tp = st.extra["tile_plan"]
        if st.tiles < SCALEOUT_MIN_TILES or tp["n_splits"] < 1 \
                or tp["total_bytes"] < 4 * b:
            raise AssertionError(f"[{label}] {st.tiles} tiles, "
                                 f"{tp['n_splits']} splits, "
                                 f"{tp['total_bytes']} bytes for a budget "
                                 f"of {b}")
        same_set(label, res, want_t)
        # the tiled counts add up each partition's candidates, replicated
        # objects' pairs included, so only the results match the
        # in-memory plan's; staged and fused must agree on all of them
        if st.n_results != len(want_t):
            raise AssertionError(f"[{label}] {st.n_results} results, not "
                                 f"{len(want_t)}")
        runs[mode] = st
    for k in COUNTS:
        if getattr(runs["staged"], k) != getattr(runs["fused"], k):
            raise AssertionError(f"[tiled] staged and fused {k} differ")
    # static balance, then a static run stopped after 2 tiles and resumed
    b = budget(n_r, n_s, balance="static")
    clean, st = tiled("tiled-static", n_r, n_s, balance="static",
                      tile_budget=b)
    same_set("tiled-static", clean, want_t)
    if st.extra["tile_plan"]["n_splits"] != 0:
        raise AssertionError("[tiled-static] a static plan split")
    with tempfile.TemporaryDirectory() as ck:
        part, st = tiled("tiled-stopped", n_r, n_s, balance="static",
                         tile_budget=b, ckpt_dir=ck, stop_after_tiles=2)
        if not st.extra.get("interrupted") or st.tiles <= 2:
            raise AssertionError("[tiled-stopped] the run did not stop "
                                 "after 2 of more tiles")
        res, st = tiled("tiled-resumed", n_r, n_s, balance="static",
                        tile_budget=b, ckpt_dir=ck)
    if st.extra["resumed_tiles"] != 2 or not np.array_equal(res, clean):
        raise AssertionError(f"[tiled-resumed] {st.extra['resumed_tiles']} "
                             "tiles resumed, or arrays != the clean run's")
    print(f"[tiled] staged and fused == the in-memory set "
          f"({len(want_t)} pairs) and each other's counts; static, stopped "
          f"and resumed at {n_r} x {n_s} == its in-memory set "
          f"({len(want_t)} pairs), resumed arrays == the static run's "
          f"(card {smi})", flush=True)

    extra = {name: {"launches_scaleout": {
        label: n[wrapper] for label, n in launches.items()}}
        for name, wrapper in counter.items()}
    print(f"phase 14 ok: the scale-out path "
          f"({time.perf_counter() - t_phase:.1f} s; card {smi})", flush=True)
    return extra


def _lm_inputs(cfg, B, S, seed):
    """Tokens [B, S] and the stub context (whisper frames or VLM patches)
    of one decode-against-forward check, drawn as the reference's
    ``tests/test_arch_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.02
                           ).astype(np.float32)
    elif cfg.n_patch_tokens:
        extra["patches"] = (rng.normal(size=(B, cfg.n_patch_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    return toks, extra


def _lm_forward_and_decode(model, cfg, toks, extra):
    """Full-sequence logits [B, S, V] and per-token decode logits [B, S, V]
    of ``toks`` on the model's device (caches of capacity S)."""
    import torch
    from repro_torch.models.model import (build_caches, forward_logits,
                                          run_encoder, set_cache_pos)
    dev = model.embed.device
    B, S = toks.shape
    with torch.no_grad():
        ctx = None
        if "frames" in extra:
            ctx = run_encoder(model, torch.from_numpy(extra["frames"]).to(dev),
                              cfg)
        elif "patches" in extra:
            ctx = torch.from_numpy(extra["patches"]).to(dev)
        full, _, _ = forward_logits(model, toks, cfg, ctx=ctx)
        caches = build_caches(cfg, B, S, dtype=torch.float32, device=dev)
        outs = []
        for t in range(S):
            caches = set_cache_pos(caches, t)
            logits, caches, _ = forward_logits(
                model, toks[:, t: t + 1], cfg, ctx=ctx, caches=caches,
                pos_offset=torch.tensor(t, dtype=torch.int32, device=dev))
            outs.append(logits[:, 0])
    return full, torch.stack(outs, dim=1)


def _n_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _lm_err(label, got, want) -> float:
    """Max abs difference of two logit tensors; fails beyond ``LM_TOL``
    (absolute and relative, as ``assert_allclose``)."""
    import torch
    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=LM_TOL, rtol=LM_TOL):
        raise AssertionError(f"[{label}] logits differ by {err} beyond "
                             f"atol = rtol = {LM_TOL}")
    return err


def _lm_isolated(decode, model, cfg, prompt, steps, cap, dev):
    """Greedy decoding of one request alone (batch 1), as
    ``greedy_generate`` decodes it: its tokens and, at each generated
    step, the gap between its two largest logits."""
    import torch
    from repro_torch.models.model import build_caches
    caches = build_caches(cfg, 1, cap, dtype=torch.float32, device=dev)
    toks, out, gaps = [int(t) for t in prompt], [], []
    for t in range(len(prompt) + steps - 1):
        logits, caches = decode(model, caches, {"tokens": [[toks[t]]],
                                                "pos": t})
        if t >= len(prompt) - 1:
            top = torch.topk(logits[0], 2).values.tolist()
            out.append(int(torch.argmax(logits[0])))
            gaps.append(top[0] - top[1])
            toks.append(out[-1])
    return out, gaps


def _lm_pool(label, model, cfg, prompts, slots, ctx, max_new, dev, smi):
    """Serve ``prompts`` through a ``ServePool`` on the card: every request
    must be served (none evicted) with the tokens of its isolated greedy
    decoding, a differing token allowed only where the isolated run's
    top-2 logit gap is below ``LM_TIE_GAP`` (the request's comparison
    stops there). Returns the isolated runs' tokens."""
    import torch
    from repro_torch.launch.serve import Request, ServePool
    from repro_torch.models.serve import make_decode_step
    pool = ServePool(cfg, model, slots, ctx, device=dev)
    steps = []
    decode = pool.decode

    def counted(*a):
        steps.append(1)
        return decode(*a)
    pool.decode = counted
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = pool.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"[{label}] served {len(done)} of {len(reqs)} "
                             "requests: a request was evicted or timed out")
    isolated, ties = [], 0
    step = make_decode_step(cfg, device=dev)
    t1 = time.perf_counter()
    for r in reqs:
        want, gaps = _lm_isolated(step, model, cfg, r.prompt, max_new, ctx,
                                  dev)
        isolated.append(want)
        for i, w in enumerate(want):
            if r.out[i] != w:
                if gaps[i] >= LM_TIE_GAP:
                    raise AssertionError(
                        f"[{label}] request {r.rid} token {i}: pool "
                        f"{r.out[i]} != isolated {w} at a top-2 gap of "
                        f"{gaps[i]}")
                ties += 1
                break
    t_iso = time.perf_counter() - t1
    # one more pool step under the profiler (a figure, not a gate: late in
    # this process a session may record no device event)
    pool.decode = decode
    pool._refill([Request(rid=i, prompt=p, max_new=max_new)
                  for i, p in enumerate(prompts[:slots])])
    pool.step()
    prof = _profile(pool.step)
    top = dict(list(prof["top_device_us"].items())[:3])
    n_tok = sum(len(r.out) for r in reqs)
    print(f"[{label}] pool of {slots} slots, ctx {ctx}: {len(done)}/"
          f"{len(reqs)} requests served, none evicted, {n_tok} tokens in "
          f"{dt:.3f} s ({n_tok / dt:.1f} tokens/s), {len(steps)} pool steps "
          f"({dt / len(steps) * 1e3:.2f} ms a step); each request == its "
          f"isolated greedy decoding ({t_iso:.2f} s), {ties} comparison(s) "
          f"stopped at a top-2 gap below {LM_TIE_GAP}; one profiled pool "
          f"step: device busy {prof['device_busy_us']:.0f} us of "
          f"{prof['wall_us']:.0f} us ({prof['device_busy_share']:.4f}), top "
          f"{json.dumps(top)} (card {smi})", flush=True)
    return isolated


def _lm_phase(dev) -> None:
    """Phase 15: the LM serving path on the card (``repro_torch.models``,
    ``launch.serve``), f32, plain PyTorch ops: no kernel of the port runs
    here, so the ``kernels`` line gains no row."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.model import build_caches, init_model
    from repro_torch.models.serve import (greedy_generate, make_decode_step,
                                          make_prefill_step)
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"phase 15 card: {smi}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 15 compares f32 logits: TF32 matmuls "
                             "must stay off")
    cpu = torch.device("cpu")
    peaks = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak(label):
        peaks[label] = torch.cuda.max_memory_allocated()

    # (a) gemma2-2b at full width: weights drawn on the card once and
    # copied to the CPU (a CPU draw took 19-26 s), the CPU run of request
    # 0's prefill and first decode steps, then the card
    free()
    t0 = time.perf_counter()
    cfg = get_config("gemma2-2b")
    n_req, slots, ctx, max_new = LM_POOLS["gemma2-2b"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 10))
               for _ in range(n_req)]
    model = init_model(0, cfg, device=dev).to(cpu)
    t_draw = time.perf_counter() - t0
    p0 = prompts[0][None]

    def first_logits(device):
        prefill = make_prefill_step(cfg, device=device)(model, {"tokens": p0})
        decode = make_decode_step(cfg, device=device)
        caches = build_caches(cfg, 1, ctx, dtype=torch.float32,
                              device=device)
        steps = []
        for t in range(LM_DECODE_CHECKED):
            logits, caches = decode(model, caches, {"tokens": p0[:, t:t + 1],
                                                    "pos": t})
            steps.append(logits)
        return prefill, torch.cat(steps)

    t1 = time.perf_counter()
    want_prefill, want_steps = first_logits(cpu)
    t_cpu = time.perf_counter() - t1
    model.to(dev)
    got_prefill, got_steps = first_logits(dev)
    errs = {"prefill": _lm_err("gemma2-2b prefill, card vs CPU", got_prefill,
                               want_prefill),
            "decode": _lm_err("gemma2-2b decode, card vs CPU", got_steps,
                              want_steps)}
    print(f"[gemma2-2b] full width ({_n_params(model) / 1e9:.3f} B "
          f"parameters, f32): weights drawn on the card and copied to the "
          f"CPU {t_draw:.1f} s, CPU "
          f"prefill + {LM_DECODE_CHECKED} decode steps {t_cpu:.1f} s; card "
          f"vs CPU max abs err {json.dumps(errs)} (tol {LM_TOL})",
          flush=True)
    isolated = _lm_pool("gemma2-2b", model, cfg, prompts, slots, ctx, max_new,
                        dev, smi)
    got = greedy_generate(model, cfg, p0, steps=max_new, ctx_capacity=ctx,
                          device=dev)
    if got[0].tolist() != isolated[0]:
        raise AssertionError("[gemma2-2b] greedy_generate != the isolated "
                             "decoding of request 0")
    peak("gemma2-2b")
    del model
    free()

    # (b) recurrentgemma-2b at full width: slot reuse must not leak state
    cfg = get_config("recurrentgemma-2b")
    n_req, slots, ctx, max_new = LM_POOLS["recurrentgemma-2b"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 6) for _ in range(n_req)]
    model = init_model(0, cfg, device=dev)
    print(f"[recurrentgemma-2b] full width ({_n_params(model) / 1e9:.3f} "
          f"B parameters, f32), weights drawn on the card", flush=True)
    _lm_pool("recurrentgemma-2b", model, cfg, prompts, slots, ctx, max_new,
             dev, smi)
    peak("recurrentgemma-2b")
    del model
    free()

    # (c) decode reproduces the full-sequence forward at full width
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    B, S = LM_DECODE_SHAPE
    for arch in ARCHS:
        cfg = get_config(arch)
        need = cfg.param_count() * 4
        if arch not in LM_FULL_DECODE:
            if arch in LM_SMOKE_ONLY and need <= card_bytes:
                raise AssertionError(f"{arch} fits the card; run it at full "
                                     "width")
            if arch in LM_SMOKE_ONLY:
                print(f"[{arch}] smoke width only: its f32 weights "
                      f"(about {need / 1e9:.0f} GB) exceed the card's "
                      f"{card_bytes / 1e9:.0f} GB", flush=True)
            continue
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=64.0))
        t0 = time.perf_counter()
        model = init_model(2, cfg, device=dev)
        toks, extra = _lm_inputs(cfg, B, S, seed=2)
        full, dec = _lm_forward_and_decode(model, cfg, toks, extra)
        if not bool(torch.isfinite(full).all()):
            raise AssertionError(f"[{arch}] non-finite logits")
        err = _lm_err(f"{arch} decode vs forward", dec, full)
        torch.cuda.synchronize()
        peak(arch)
        print(f"[{arch}] full width ({_n_params(model) / 1e9:.3f} B "
              f"parameters, f32), B {B} S {S}: decode == forward, max abs "
              f"err {err} (tol {LM_TOL}), {time.perf_counter() - t0:.1f} s",
              flush=True)
        del model, full, dec
        free()

    # (d) every smoke config: decode vs forward on the card, card vs CPU
    smoke = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=64.0))
        model = init_model(2, cfg, device=cpu)
        toks, extra = _lm_inputs(cfg, *LM_DECODE_SHAPE, seed=2)
        want_full, want_dec = _lm_forward_and_decode(model, cfg, toks, extra)
        model.to(dev)
        full, dec = _lm_forward_and_decode(model, cfg, toks, extra)
        smoke[arch] = {
            "decode_vs_forward": _lm_err(f"{arch} smoke decode vs forward",
                                         dec, full),
            "card_vs_cpu": max(_lm_err(f"{arch} smoke forward, card vs CPU",
                                       full, want_full),
                               _lm_err(f"{arch} smoke decode, card vs CPU",
                                       dec, want_dec))}
        del model
    print(f"[smoke configs] max abs err on the card (tol {LM_TOL}): "
          f"{json.dumps(smoke)}", flush=True)
    print(f"phase 15 peak device memory by model (GB): "
          f"{json.dumps({k: round(v / 1e9, 3) for k, v in peaks.items()})}",
          flush=True)
    print(f"phase 15 ok: the LM serving path "
          f"({time.perf_counter() - t_phase:.1f} s; card {smi})", flush=True)


def _train_flops(model, cfg, B, S) -> float:
    """Model FLOPs of one training step of B x S tokens: 6 N T over the
    parameters a token uses (an MoE layer's top_k of its experts), plus
    the attention products (Q K^T and P V over the full S x S the port
    computes, forward and backward: 3 x 4 B S^2 H dh a layer)."""
    n = float(_n_params(model))
    if cfg.moe is not None:
        experts = sum(p.numel() for name, p in model.named_parameters()
                      if ".moe.w" in name)
        n -= experts * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "local",
                                                      "xattn"))
    return 6 * n * B * S + 3 * attn * 4 * B * S * S * cfg.n_heads \
        * cfg.head_dim


def _params_on_host(model) -> dict:
    return {n: p.detach().cpu() for n, p in model.named_parameters()}


def _max_param_diff(model, want: dict) -> float:
    """Max abs difference of ``model``'s parameters from ``want`` (host
    tensors by name), leaf by leaf on the model's device."""
    dev = model.embed.device
    return max(float((p.detach() - want[n].to(dev)).abs().max())
               for n, p in model.named_parameters())


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _m_err(m: dict, want: dict) -> float:
    """The largest, over the first-moment leaves ``m`` (tensors by
    parameter name), of a leaf's max abs difference from ``want``'s (host
    tensors) over the largest entry of ``want``'s leaf."""
    worst = 0.0
    for n, t in m.items():
        w = want[n].to(t.device)
        diff, scale = float((t - w).abs().max()), float(w.abs().max())
        worst = max(worst, diff / scale if scale else
                    (0.0 if diff == 0 else float("inf")))
    return worst


def _train_phase(first_out: str | None = None) -> None:
    """Phase 16: LM training on the card (``models.train``, ``optim``,
    ``launch.train``), f32, plain PyTorch ops and autograd: no kernel of
    the port runs here, so the ``kernels`` line gains no row.
    ``first_out`` receives what phase 17 is held to: gemma2-2b's first
    full-width step (its loss and ``grad_norm``) and the uninterrupted
    launcher run's losses (a run's first steps do not depend on its
    length: the learning rate is constant)."""
    import gc
    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.train import SyntheticCorpus, train_loop
    from repro_torch.models.model import init_model
    from repro_torch.models.train import (REMAT_POLICIES, _global_norm,
                                          loss_fn, make_train_step)
    from repro_torch.optim import adamw_init
    t_phase = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    free_b, total_b = torch.cuda.mem_get_info()
    print(f"phase 16 card: {smi}; {free_b / 1e9:.1f} of {total_b / 1e9:.1f} "
          f"GB free", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 16 compares f32 steps: TF32 matmuls "
                             "must stay off")

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) every smoke config: one step on the card against the port's CPU
    t0 = time.perf_counter()
    smoke = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        batch = SyntheticCorpus(cfg.vocab, *TRAIN_SMOKE_SHAPE,
                                seed=1).next_batch(cfg)
        out = {}
        for d in (cpu, dev):
            model = init_model(1, cfg, device=cpu).to(d)
            step = make_train_step(cfg, lr=TRAIN_SMOKE_LR,
                                   remat_policy="dots", device=d)
            model, opt, metrics = step(
                model, adamw_init(dict(model.named_parameters())), batch)
            out[d.type] = (model, opt,
                           {k: float(v) for k, v in metrics.items()})
        (m_cpu, opt_cpu, want), (m_dev, opt_dev, got) = out["cpu"], \
            out["cuda"]
        err = {k: _rel(got[k], want[k]) for k in ("loss", "grad_norm")}
        err["params"] = _max_param_diff(m_dev, _params_on_host(m_cpu))
        err["m"] = _m_err(opt_dev["m"], opt_cpu["m"])
        if max(err["loss"], err["grad_norm"]) > TRAIN_REL_TOL or \
                err["params"] > 2.5 * TRAIN_SMOKE_LR or \
                err["m"] > TRAIN_M_TOL:
            raise AssertionError(f"[{arch} smoke] a train step on the card "
                                 f"differs from the CPU's: {err}")
        smoke[arch] = err
    print(f"[smoke configs] one train step (dots, lr {TRAIN_SMOKE_LR}), "
          f"card vs CPU: loss and grad_norm relative, params max abs, m "
          f"relative to each leaf's largest (bounds {TRAIN_REL_TOL}, "
          f"{2.5 * TRAIN_SMOKE_LR}, {TRAIN_M_TOL}): "
          f"{json.dumps(smoke)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # (b) gemma2-2b at full width
    free()
    arch = "gemma2-2b"
    cfg = get_config(arch)
    B, S = TRAIN_SHAPE
    data = SyntheticCorpus(cfg.vocab, B, S, seed=0)
    batches = [data.next_batch(cfg) for _ in range(TRAIN_STEPS + 1)]
    model, t_init = timed(lambda: init_model(0, cfg, device=dev))
    n_par = _n_params(model)
    flops = _train_flops(model, cfg, B, S)
    policies = {}
    for name in ("none", "dots", "nothing"):
        free()
        kept = []

        def fwd_bwd():
            base = torch.cuda.memory_allocated()
            loss, _ = loss_fn(model, batches[0], cfg,
                              remat_policy=REMAT_POLICIES[name])
            # what the forward leaves allocated for the backward
            kept.append(torch.cuda.memory_allocated() - base)
            grads = torch.autograd.grad(loss, list(model.parameters()),
                                        allow_unused=True,
                                        materialize_grads=True)
            return float(loss.detach()), float(_global_norm(grads))
        (loss, gnorm), dt = timed(fwd_bwd)
        policies[name] = {"loss": loss, "grad_norm": gnorm, "s": dt,
                          "kept_for_backward_gb": kept[0] / 1e9,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    kept = [policies[k]["kept_for_backward_gb"]
            for k in ("nothing", "dots", "none")]
    if not kept[0] < kept[1] < kept[2]:
        raise AssertionError(f"[{arch}] the memory kept for the backward "
                             f"does not fall from none to dots to nothing: "
                             f"{kept} GB")
    for name, p in policies.items():
        err = max(_rel(p["loss"], policies["none"]["loss"]),
                  _rel(p["grad_norm"], policies["none"]["grad_norm"]))
        if err > TRAIN_REL_TOL:
            raise AssertionError(f"[{arch}] remat policy {name!r} changes "
                                 f"the first step by {err} (relative)")
        p["rel_err"] = err
    print(f"[{arch} train] full width ({n_par / 1e9:.3f} B parameters, f32, "
          f"drawn on the card in {t_init:.2f} s), B {B} x S {S}: first "
          f"step's forward and backward by remat policy (loss, grad_norm, "
          f"seconds, device GB the forward leaves for the backward, peak "
          f"device GB, relative error against none): "
          f"{json.dumps(policies)} (card {smi})", flush=True)

    free()
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, lr=TRAIN_LR, remat_policy="dots", device=dev)
    losses, secs = [], []
    for i in range(TRAIN_STEPS):
        # the model and the moments are updated in place; the returned
        # state carries the step count
        (model, opt, metrics), dt = timed(
            lambda: step(model, opt, batches[i]))
        losses.append(float(metrics["loss"]))
        secs.append(dt)
        if i == 0:
            first = _params_on_host(model)
            first_m = {n: t.cpu() for n, t in opt["m"].items()}
            first_metrics = {k: float(v) for k, v in metrics.items()}
    peak_run = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{arch}] losses over {TRAIN_STEPS} steps are "
                             f"not finite or do not fall: {losses}")
    prof = _profile(lambda: step(model, opt, batches[TRAIN_STEPS]))
    if prof["port_kernels_us_and_launches"]:
        raise AssertionError(f"[{arch}] a train step launched a kernel of "
                             f"the port: {prof['port_kernels_us_and_launches']}")
    step_s = float(np.mean(secs[1:]))
    top = dict(list(prof["top_device_us"].items())[:4])
    print(f"[{arch} train] {TRAIN_STEPS} steps (dots, lr {TRAIN_LR}), "
          f"losses {json.dumps(losses)}; step 1 {secs[0] * 1e3:.1f} ms, "
          f"steps 2-{TRAIN_STEPS} {step_s * 1e3:.1f} ms a step "
          f"({B * S / step_s:.1f} tokens/s), {flops / 1e12:.2f} model "
          f"TFLOP a step, {flops / step_s / 1e12:.2f} TFLOP/s "
          f"({flops / step_s / F32_OPS_PER_S:.4f} of the f32 peak); peak "
          f"device memory {peak_run:.2f} GB; one profiled step: device busy "
          f"{prof['device_busy_us']:.0f} us of {prof['wall_us']:.0f} us "
          f"({prof['device_busy_share']:.4f}; "
          f"{prof['device_busy_us'] / 1e6 / step_s:.4f} of an unprofiled "
          f"step), top {json.dumps(top)} (card {smi})", flush=True)
    del model, opt
    free()

    # the first step again from the same weights, in two strided
    # microbatches
    model = init_model(0, cfg, device=dev)
    step2 = make_train_step(cfg, lr=TRAIN_LR, remat_policy="dots",
                            microbatch=2, device=dev)
    model, opt, metrics = step2(
        model, adamw_init(dict(model.named_parameters())), batches[0])
    err = {k: _rel(metrics[k], first_metrics[k])
           for k in ("loss", "grad_norm")}
    err["params"] = _max_param_diff(model, first)
    err["m"] = _m_err(opt["m"], first_m)
    if max(err["loss"], err["grad_norm"]) > TRAIN_REL_TOL or \
            err["params"] > 2.5 * TRAIN_LR or err["m"] > TRAIN_M_TOL:
        raise AssertionError(f"[{arch}] microbatch=2 differs from one "
                             f"batch: {err}")
    print(f"[{arch} train] microbatch=2 == one batch: loss and grad_norm "
          f"relative {err['loss']}, {err['grad_norm']}, params max abs "
          f"{err['params']}, m relative to each leaf's largest {err['m']} "
          f"(bounds {TRAIN_REL_TOL}, {2.5 * TRAIN_LR}, {TRAIN_M_TOL}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del model, opt, first, first_m
    free()

    # (c) the MoE and recurrent backward at full width
    for arch, n_steps in TRAIN_BACKWARD.items():
        cfg = get_config(arch)
        data = SyntheticCorpus(cfg.vocab, B, S, seed=0)
        model = init_model(0, cfg, device=dev)
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(cfg, lr=TRAIN_LR, remat_policy="dots",
                               device=dev)
        losses, secs = [], []
        for _ in range(n_steps):
            batch = data.next_batch(cfg)
            (model, opt, metrics), dt = timed(
                lambda: step(model, opt, batch))
            losses.append(float(metrics["loss"]))
            secs.append(dt)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[{arch}] non-finite losses: {losses}")
        prof = _profile(lambda: step(model, opt, batch))
        step_s = float(np.mean(secs[1:]))
        flops = _train_flops(model, cfg, B, S)
        top = dict(list(prof["top_device_us"].items())[:4])
        print(f"[{arch} train] full width ({_n_params(model) / 1e9:.3f} B "
              f"parameters, f32), B {B} x S {S}, {n_steps} steps: losses "
              f"{json.dumps(losses)}; step 1 {secs[0] * 1e3:.1f} ms, then "
              f"{step_s * 1e3:.1f} ms a step ({B * S / step_s:.1f} "
              f"tokens/s, {flops / step_s / 1e12:.2f} model TFLOP/s, "
              f"{flops / step_s / F32_OPS_PER_S:.4f} of the f32 peak); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB; one profiled step: device busy "
              f"{prof['device_busy_us']:.0f} us of {prof['wall_us']:.0f} us "
              f"({prof['device_busy_share']:.4f}; "
              f"{prof['device_busy_us'] / 1e6 / step_s:.4f} of an unprofiled "
              f"step), top {json.dumps(top)} (card {smi})", flush=True)
        del model, opt
        free()

    # (d) the launcher at full width: a crash, a resume, the same losses
    t0 = time.perf_counter()
    _, _, want = train_loop("smollm-135m", device="cuda", **TRAIN_LAUNCH)
    t_run = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as ck:
        try:
            train_loop("smollm-135m", ckpt_dir=ck, fail_at_step=TRAIN_FAIL_AT,
                       device="cuda", **TRAIN_LAUNCH)
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        else:
            raise AssertionError("the launcher ran past its injected crash")
        _, opt, resumed = train_loop("smollm-135m", ckpt_dir=ck,
                                     device="cuda", **TRAIN_LAUNCH)
    # the resume starts at the last checkpoint before the crash
    every = TRAIN_LAUNCH["ckpt_every"]
    last = TRAIN_FAIL_AT // every * every
    if len(resumed) != TRAIN_LAUNCH["steps"] - last:
        raise AssertionError(f"[smollm-135m launcher] the resumed run took "
                             f"{len(resumed)} steps, not the "
                             f"{TRAIN_LAUNCH['steps'] - last} after its "
                             f"step-{last} checkpoint")
    if int(opt["step"]) != TRAIN_LAUNCH["steps"] or not np.allclose(
            resumed, want[last:], **TRAIN_RESUME_TOL):
        raise AssertionError(f"[smollm-135m launcher] resumed losses "
                             f"{resumed} != the uninterrupted run's "
                             f"{want[last:]}")
    print(f"[smollm-135m launcher] full width, {TRAIN_LAUNCH}: "
          f"uninterrupted {t_run:.1f} s, losses {json.dumps(want)}; crash "
          f"at step {TRAIN_FAIL_AT}, resumed from step {last}: max abs "
          f"difference {float(np.max(np.abs(np.subtract(resumed, want[last:]))))}"
          f" (bound {TRAIN_RESUME_TOL}) (card {smi})", flush=True)
    if first_out:
        Path(first_out).write_text(json.dumps({
            "gemma2-2b": first_metrics,
            "launcher": {"run": TRAIN_LAUNCH, "losses": want}}))
    print(f"phase 16 ok: LM training ({time.perf_counter() - t_phase:.1f} "
          f"s; card {smi})", flush=True)


def _train_in_fresh_process(out: str) -> None:
    """Phase 16 in a child process of this script; fails if the child
    fails. As for phase 9: the profiler of a process some minutes old
    records no device event, and a fresh context has the whole card."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[1] + '/src'); "
            "import chip_smoke; chip_smoke._train_phase(sys.argv[2])")
    subprocess.run([sys.executable, "-c", code,
                    str(Path(__file__).resolve().parent), out], check=True)


# ----------------------------------------------------------------- phase 17

def _sharded_setup(part: str, rank: int, world: int, tmp: str):
    """A child of phase 17: rank ``rank`` of ``world`` gloo ranks over a
    ``FileStore`` in ``tmp``, computing on ``cuda:0``; ``_sharded_done``
    ends it."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(Path(tmp) / f"{part}.store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=SHARDED_RANK_TIMEOUT))
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("phase 17 compares f32 steps: TF32 matmuls "
                             "must stay off")
    return torch.device("cuda")


def _sharded_done(tmp: str, name: str, report) -> None:
    """A phase-17 child's report written, then the group torn down once
    every rank is done."""
    import torch.distributed as dist
    Path(tmp, name).write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def _sharded_step(cfg, model, mesh, batch, lr):
    """One sharded step of ``model`` (global weights on the card) on
    ``mesh``: (this rank's sharded model, the first moments gathered,
    metrics as floats, the step's collective bytes by kind)."""
    from repro_torch.models.parallel import gather_tree
    from repro_torch.models.sharding import (
        distribute_model, make_activation_hook, named_sharding_tree,
        opt_state_specs, opt_state_zeros, shard_batch)
    from repro_torch.models.train import make_train_step
    ospecs = opt_state_specs(model, mesh)
    opt = opt_state_zeros(model, mesh, ospecs)
    sharded = distribute_model(model, mesh)
    step = make_train_step(
        cfg, lr=lr, device=mesh.device,
        activation_hook=make_activation_hook(mesh, sequence_parallel=False),
        grad_shardings=named_sharding_tree(mesh, ospecs["m"]))
    mesh.tally.clear()
    sharded, opt, m = step(sharded, opt, shard_batch(batch, mesh))
    tally = dict(mesh.tally)
    return sharded, gather_tree(opt["m"], ospecs["m"], mesh), \
        {k: float(v) for k, v in m.items()}, tally


def _single_step(cfg, dev, batch, lr):
    """gemma2-2b's (or any config's) single-card step from
    ``init_model(0, cfg)``: (metrics, the new parameters and the first
    moments by name)."""
    from repro_torch.models.model import init_model
    from repro_torch.models.train import make_train_step
    from repro_torch.optim import adamw_init
    model = init_model(0, cfg, device=dev)
    model, opt, m = make_train_step(cfg, lr=lr, device=dev)(
        model, adamw_init(dict(model.named_parameters())), batch)
    return {k: float(v) for k, v in m.items()}, \
        {k: p.detach() for k, p in model.named_parameters()}, opt["m"]


def _held(label, got, want, params, want_params, m, want_m):
    """The sharded step's loss, ``grad_norm``, gathered parameters and
    gathered first moments against the single-card step's, under phase
    17's bounds. After one AdamW step every weight moves by about lr
    whatever its gradient, so only the moments (0.1 g) see a gradient
    shard on the wrong rank or slice: each leaf's max abs difference over
    its largest entry (``_m_err``) within ``TRAIN_M_TOL``."""
    err = {"loss": abs(got["loss"] - want["loss"]),
           "grad_norm": _rel(got["grad_norm"], want["grad_norm"]),
           "params": max(float((params[k] - p).abs().max())
                         for k, p in want_params.items()),
           "m": _m_err(m, want_m)}
    if sorted(m) != sorted(want_m) or err["loss"] > SHARDED_LOSS_TOL or \
            err["grad_norm"] > TRAIN_REL_TOL or \
            err["params"] > SHARDED_PARAM_TOL or err["m"] > TRAIN_M_TOL:
        raise AssertionError(f"[{label}] the sharded step differs from the "
                             f"single-card step: {err}")
    return err


def _sharded_tp_child(rank: int, tmp: str, first: str) -> None:
    """Phase 17 (a) and (b), rank ``rank`` of 2 on a 1 x 2 mesh."""
    import dataclasses
    import gc
    import torch
    dev = _sharded_setup("tp", rank, 2, tmp)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import SyntheticCorpus
    from repro_torch.models.model import init_model
    from repro_torch.models.parallel import gather_params
    from repro_torch.models.sharding import (
        distribute_model, make_activation_hook, opt_state_specs,
        opt_state_zeros, shard_batch)
    from repro_torch.models.train import make_train_step
    report = {}
    B, S = TRAIN_SHAPE
    full_cfg = get_config("gemma2-2b")
    data = SyntheticCorpus(full_cfg.vocab, B, S, seed=0)
    batches = [data.next_batch(full_cfg) for _ in range(SHARDED_STEPS)]
    mesh = make_dev_mesh(1, 2, device=dev)

    # (a) 4 layers, the sharded step against the single-card step
    cfg = dataclasses.replace(full_cfg, n_layers=SHARDED_LAYERS)
    if rank == 0:
        want, want_params, want_m = _single_step(cfg, dev, batches[0],
                                                 SHARDED_LR)
    model = init_model(0, cfg, device=dev)
    sharded, m, got, tally = _sharded_step(cfg, model, mesh, batches[0],
                                           SHARDED_LR)
    del model
    params = gather_params(sharded)
    if rank == 0:
        report["a"] = {"single": want, "sharded": got, "tally": tally,
                       "err": _held("gemma2-2b 4 layers, 1 x 2", got, want,
                                    params, want_params, m, want_m)}
        del want_params, want_m
    del sharded, m, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full depth, 3 steps
    torch.cuda.reset_peak_memory_stats()
    cfg = full_cfg
    model = init_model(0, cfg, device=dev)
    ospecs = opt_state_specs(model, mesh)
    opt = opt_state_zeros(model, mesh, ospecs)
    sharded = distribute_model(model, mesh)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    step = make_train_step(
        cfg, lr=SHARDED_LR, device=dev,
        activation_hook=make_activation_hook(mesh, sequence_parallel=False))
    losses, secs, tallies = [], [], []
    for b in batches:
        mesh.tally.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded, opt, m = step(sharded, opt, shard_batch(b, mesh))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        tallies.append(dict(mesh.tally))
    want = json.loads(Path(first).read_text())["gemma2-2b"]
    if not all(np.isfinite(losses)) or \
            _rel(losses[0], want["loss"]) > TRAIN_REL_TOL:
        raise AssertionError(f"[gemma2-2b 1 x 2] losses {losses}; the first "
                             f"against phase 16's single-card {want['loss']}")
    report["b"] = {"losses": losses, "seconds": secs, "tally": tallies[-1],
                   "first_rel_err": _rel(losses[0], want["loss"]),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    _sharded_done(tmp, f"tp_{rank}.json", report)


def _sharded_dp_child(rank: int, tmp: str, first: str) -> None:
    """Phase 17 (c), rank ``rank`` of 4: the step on 2 x 1 (the first two
    ranks; rank 2 meanwhile takes smollm-135m's single-card step, the
    reference) and on 2 x 2, held by rank 0 to the single-card step, then
    the launcher on 2 x 2, crashed at step ``SHARDED_FAIL_AT``; ranks 2
    and 3 then leave, and the two survivors form a new group and resume
    the launcher on the 2 x 1 mesh ``make_mesh_from_devices`` makes of
    them, held to phase 16's uninterrupted single-card run of the same
    launcher (``first``)."""
    import torch
    import torch.distributed as dist
    dev = _sharded_setup("dp", rank, 4, tmp)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.train import SyntheticCorpus, train_loop
    from repro_torch.models.model import init_model
    from repro_torch.models.parallel import gather_params
    from repro_torch.runtime.elastic import make_mesh_from_devices
    cfg = get_config("smollm-135m")
    batch = SyntheticCorpus(cfg.vocab, *TRAIN_SHAPE, seed=0).next_batch(cfg)
    report, secs, held = {}, {}, {}
    ck = str(Path(tmp) / "ck")
    single = Path(tmp, "dp_single.pt")
    meshes = (("2x1", make_mesh_from_devices(range(2), 1, device=dev)),
              ("2x2", make_dev_mesh(2, 2, device=dev)))
    if rank == 2:
        t0 = time.perf_counter()
        torch.save(_single_step(cfg, dev, batch, SHARDED_LR),
                   single.with_suffix(".tmp"))
        os.replace(single.with_suffix(".tmp"), single)
        secs["single"] = time.perf_counter() - t0
    for label, mesh in meshes:
        if mesh.coords is None:
            continue
        t0 = time.perf_counter()
        sharded, m, got, tally = _sharded_step(
            cfg, init_model(0, cfg, device=dev), mesh, batch, SHARDED_LR)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        params = gather_params(sharded)
        if rank == 0:
            held[label] = (got, tally, params, m)
    if rank == 0:
        # rank 2 saved the reference before it took part in the 2 x 2 step
        want, want_params, want_m = torch.load(single, map_location=dev)
        for label, (got, tally, params, m) in held.items():
            report[label] = {"sharded": got, "tally": tally,
                             "err": _held(f"smollm-135m {label}", got, want,
                                          params, want_params, m, want_m)}
        del held, want_params, want_m
    t0 = time.perf_counter()
    try:
        train_loop("smollm-135m", ckpt_dir=ck, mesh=mesh,
                   fail_at_step=SHARDED_FAIL_AT, **SHARDED_LAUNCH)
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    else:
        raise AssertionError("the sharded launcher ran past its crash")
    torch.cuda.synchronize()
    secs["crashed launcher"] = time.perf_counter() - t0
    report["seconds"] = secs
    _sharded_done(tmp, f"dp_{rank}.json", report)
    if rank >= 2:
        return
    # the survivors' elastic restart
    _sharded_setup("resume", rank, 2, tmp)
    mesh = make_mesh_from_devices(range(2), 1, device=dev)
    t0 = time.perf_counter()
    _, opt, resumed = train_loop("smollm-135m", ckpt_dir=ck, mesh=mesh,
                                 **SHARDED_LAUNCH)
    secs = time.perf_counter() - t0
    last = SHARDED_FAIL_AT // SHARDED_LAUNCH["ckpt_every"] * \
        SHARDED_LAUNCH["ckpt_every"]
    if int(opt["step"]) != SHARDED_LAUNCH["steps"] or \
            len(resumed) != SHARDED_LAUNCH["steps"] - last:
        raise AssertionError(f"[launcher 2 x 1] resumed {len(resumed)} steps "
                             f"to step {int(opt['step'])}")
    run = json.loads(Path(first).read_text())["launcher"]
    if {k: v for k, v in run["run"].items() if k not in ("steps",
                                                         "ckpt_every")} \
            != {k: v for k, v in SHARDED_LAUNCH.items()
                if k not in ("steps", "ckpt_every")}:
        raise AssertionError(f"phase 16's launcher run {run['run']} is not "
                             f"{SHARDED_LAUNCH}'s")
    want = run["losses"][:SHARDED_LAUNCH["steps"]]
    if not np.allclose(resumed, want[last:], **TRAIN_RESUME_TOL):
        raise AssertionError(f"[launcher 2 x 1] resumed losses {resumed} != "
                             f"the uninterrupted run's {want[last:]}")
    _sharded_done(tmp, f"resume_{rank}.json", {
        "mesh": mesh.shape, "resumed": resumed, "want": want,
        "from_step": last, "seconds": secs})


def _dryrun_child(tmp: str) -> None:
    """Phase 17 (d): the dry run of gemma2-2b ``train_4k`` on the
    production mesh (bf16 and sequence parallel, the reference's
    defaults) and of the phase's own cell (2 x 512 on 1 x 2, f32, as (b)
    ran it)."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    cfg = get_config("gemma2-2b")
    cells = {
        "train_4k 16x16": dryrun.run_model_cell(
            cfg, SHAPES["train_4k"], dryrun.cell_mesh(), arch="gemma2-2b",
            shape_name="train_4k"),
        "2x512 1x2": dryrun.run_model_cell(
            cfg, (TRAIN_SHAPE[1], TRAIN_SHAPE[0], "train"),
            dryrun.cell_mesh(mesh_shape=(1, 2)), arch="gemma2-2b",
            sequence_parallel=False, dtype=torch.float32)}
    Path(tmp, "dryrun.json").write_text(json.dumps(cells))


def _rank_group(fn: str, world: int, tmp: str, *extra) -> list:
    """``world`` child processes of this script running ``fn(rank, tmp,
    *extra)``; fails if any fails or outlives ``SHARDED_RANK_TIMEOUT``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            f"import chip_smoke; chip_smoke.{fn}(int(sys.argv[2]), "
            "*sys.argv[3:])")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(Path(__file__).resolve().parent), str(r),
                               tmp, *extra]) for r in range(world)]
    try:
        rcs = [p.wait(timeout=SHARDED_RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"[{fn}] the rank processes exited with {rcs}")
    return rcs


def _sharded_phase(first: str) -> None:
    """Phase 17: the sharded LM step, the elastic restart and the dry run
    (``models.sharding``, ``models.parallel``, ``launch.mesh``,
    ``runtime.elastic``, ``launch.dryrun``), gloo ranks as child processes
    of this script on ``cuda:0``, f32 without TF32: no kernel of the port
    runs, so the ``kernels`` line gains no row."""
    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    B, S = TRAIN_SHAPE
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _rank_group("_sharded_tp_child", 2, tmp, first)
        t_tp = time.perf_counter() - t0
        tp = [json.loads(Path(tmp, f"tp_{r}.json").read_text())
              for r in range(2)]
        # (d) needs no card: the dry run runs beside (c)'s ranks
        t0 = time.perf_counter()
        dry = subprocess.Popen([
            sys.executable, "-c", "import sys; sys.path.insert(0, "
            "sys.argv[1]); import chip_smoke; chip_smoke._dryrun_child("
            "sys.argv[2])", str(Path(__file__).resolve().parent), tmp])
        try:
            _rank_group("_sharded_dp_child", 4, tmp, first)
            t_dp = time.perf_counter() - t0
            rc = dry.wait(timeout=SHARDED_RANK_TIMEOUT)
        finally:
            if dry.poll() is None:
                dry.kill()
                dry.wait()
        t_dry = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"[dry run] the child exited with {rc}")
        dp = json.loads(Path(tmp, "dp_0.json").read_text())
        resume = json.loads(Path(tmp, "resume_0.json").read_text())
        cells = json.loads(Path(tmp, "dryrun.json").read_text())
    a, b = tp[0]["a"], tp[0]["b"]
    print(f"[sharded a] gemma2-2b full width cut to {SHARDED_LAYERS} layers, "
          f"B {B} x S {S}, lr {SHARDED_LR}, 2 gloo ranks on cuda:0 as a "
          f"1 x 2 mesh (tensor parallel) against one card: loss abs "
          f"{a['err']['loss']}, grad_norm relative {a['err']['grad_norm']}, "
          f"parameters max abs {a['err']['params']}, first moments "
          f"relative to each leaf's largest {a['err']['m']} (bounds "
          f"{SHARDED_LOSS_TOL}, {TRAIN_REL_TOL}, {SHARDED_PARAM_TOL}, "
          f"{TRAIN_M_TOL}); "
          f"collective bytes a rank {json.dumps(a['tally'])}", flush=True)
    step_s = float(np.mean(b["seconds"][1:]))
    print(f"[sharded b] gemma2-2b full depth on 1 x 2, {SHARDED_STEPS} "
          f"steps: losses {json.dumps(b['losses'])} (the first against "
          f"phase 16's single-card step: relative {b['first_rel_err']}); "
          f"seconds a step {json.dumps(b['seconds'])}, steps 2-"
          f"{SHARDED_STEPS} {step_s * 1e3:.1f} ms a step "
          f"({B * S / step_s:.1f} tokens/s); collective bytes a step and "
          f"rank {json.dumps(b['tally'])}; peak device memory a rank "
          f"{json.dumps([r['b']['peak_gb'] for r in tp])} GB (card {smi})",
          flush=True)
    print(f"[sharded c] smollm-135m full width, B {B} x S {S}, against one "
          f"card: 2 x 1 {json.dumps(dp['2x1']['err'])}, 2 x 2 "
          f"{json.dumps(dp['2x2']['err'])}; "
          f"collective bytes a rank 2 x 1 {json.dumps(dp['2x1']['tally'])}, "
          f"2 x 2 {json.dumps(dp['2x2']['tally'])}; the launcher "
          f"({SHARDED_LAUNCH}) on 2 x 2 crashed at step {SHARDED_FAIL_AT}, "
          f"resumed from step {resume['from_step']} on "
          f"{json.dumps(resume['mesh'])} from the survivors in "
          f"{resume['seconds']:.1f} s (seconds of the 4-rank group's parts "
          f"{json.dumps(dp['seconds'])}): losses "
          f"{json.dumps(resume['resumed'])}"
          f" against the uninterrupted single-card run's "
          f"{json.dumps(resume['want'][resume['from_step']:])} (bound "
          f"{TRAIN_RESUME_TOL})", flush=True)
    for name, c in cells.items():
        print(f"[sharded d] dry run gemma2-2b {name} ({c['dtype']}, "
              f"{c['chips']} ranks): t_compute {c['t_compute'] * 1e3:.2f} "
              f"ms, t_memory {c['t_memory'] * 1e3:.2f} ms, t_collective "
              f"{c['t_collective'] * 1e3:.2f} ms ({c['bottleneck']}); FLOPs "
              f"{c['flops_per_chip']:.4e}, bytes {c['bytes_per_chip']:.4e}, "
              f"collective bytes {json.dumps(c['coll_breakdown'])}, memory "
              f"{c['memory_per_chip_bytes'] / 1e9:.2f} GB a rank; beside "
              f"(b)'s measured {step_s * 1e3:.1f} ms a step", flush=True)
    print(f"phase 17 ok: the sharded LM step "
          f"({time.perf_counter() - t_phase:.1f} s: (a)+(b) {t_tp:.1f}, (c) "
          f"{t_dp:.1f}, (d) beside it {t_dry:.1f}; card {smi})", flush=True)


def _attention_child(out: str) -> None:
    """Phase 9 in this process, its rows of the ``kernels`` line written to
    the JSON file ``out``: the body of :func:`_attention_in_fresh_process`'s
    child."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    Path(out).write_text(json.dumps(_attention_phase(torch.device("cuda"))))


def _attention_in_fresh_process() -> list:
    """Phase 9 in a child process of this script; returns its rows of the
    ``kernels`` line, and fails if the child fails.

    On the card's machine the ``torch.profiler`` sessions of a process
    that has run for some minutes come to record no device event at all
    (every session of phase 9's, after phase 10 ran in the same process),
    and phase 9 requires its traces to show the kernels' launches; a
    fresh process records them. The child inherits this process's
    environment (the compile caches) and the kernels it built."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "attention.json"
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "import chip_smoke; chip_smoke._attention_child(sys.argv[2])")
        subprocess.run([sys.executable, "-c", code,
                        str(Path(__file__).resolve().parent), str(out)],
                       check=True)
        return json.loads(out.read_text())


def _allowed_positions(S: int, kind: str, window: int) -> int:
    """(q, k) positions of one head that the dense mask allows, Sq = Skv =
    S."""
    q = np.arange(S, dtype=np.int64)
    if kind == "causal":
        return int((q + 1).sum())
    if kind == "local":
        return int(np.minimum(q + 1, window).sum())
    return S * S


def _drop_one_block(iv):
    """The table with the first visited kv block of the middle q block
    left out: a wrong table, for the gate's control."""
    bad = iv.clone()
    qi = bad.shape[0] // 2
    a_lo = int(bad[qi, 0]) + 1
    f_lo = max(int(bad[qi, 1]), a_lo)
    bad[qi, :3] = bad.new_tensor([a_lo, f_lo, max(int(bad[qi, 2]), f_lo)])
    return bad


def _library(q, k, v, kind, window, cap, scale):
    """One PyTorch call for the attention, a yardstick only: the port
    never calls it. ``scaled_dot_product_attention`` without a softcap;
    with one, compiled ``flex_attention`` with the softcap as its
    ``score_mod`` and the mask as its block mask. Returns (name, fn)."""
    import torch
    import torch.nn.functional as F
    if cap is None and kind == "causal":
        return ("scaled_dot_product_attention",
                lambda: F.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=True)[0])
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def mask_mod(b, h, qi, ki):
        allowed = ki <= qi
        if kind == "local":
            allowed = allowed & (ki > qi - window)
        return allowed

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    S = q.shape[1]
    block_mask = create_block_mask(mask_mod, None, None, S, S,
                                   device=q.device, BLOCK_SIZE=128)
    flex = torch.compile(flex_attention, dynamic=False)
    return ("flex_attention", lambda: flex(
        q[None], k[None], v[None], score_mod=score_mod,
        block_mask=block_mask, scale=scale)[0])


def _attention_phase(dev) -> list:
    """Phase 9: the attention kernels on the test grid and at full width;
    returns their rows of the ``kernels`` line: the tensor-core kernel's
    at the gemma2-2b local layer, the CUDA-core kernel's at the f32 qwen
    layer."""
    import torch
    from repro_torch.kernels.april_attention import (
        ROW_REL_TOL, TEST_GRID, TEST_TOL, april_attention,
        april_attention_blocks, april_attention_plain, april_attention_ref,
        build_block_intervals, kernel_attrs, row_rel_err)
    from repro_torch.kernels.april_attention.ops import BLOCK_QS, HEAD_DIMS
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 plain version must run without TF32")
    t_phase = time.perf_counter()
    worst, worst_rel = {}, 0.0
    for (dtype, BH, S, D, bq, bkv, kind, window, cap, seed) in TEST_GRID:
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.normal(size=(BH, S, D)).astype(
            np.float32)).to(dev, getattr(torch, dtype)) for _ in range(3))
        kw = dict(block_q=bq, block_kv=bkv, mask_kind=kind, window=window,
                  softcap=cap)
        iv = torch.from_numpy(build_block_intervals(S, S, bq, bkv, kind,
                                                    window)).to(dev)
        got = april_attention(q, k, v, **kw)
        plain = april_attention_plain(q, k, v, iv, scale=1.0 / D ** 0.5,
                                      **kw)
        dense = april_attention_ref(q, k, v, mask_kind=kind, window=window,
                                    softcap=cap)
        torch.cuda.synchronize()
        tol = TEST_TOL[dtype]
        case = f"{dtype} S {S} D {D} blocks {bq}/{bkv} {kind} {window} " \
               f"softcap {cap}"
        for name, want in (("plain version", plain), ("dense oracle", dense)):
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"april_attention kernel != {name} on "
                                     f"{case}")
        if dtype == "bfloat16":
            rel = row_rel_err(got, plain)
            if rel > ROW_REL_TOL:
                raise AssertionError(f"april_attention kernel != plain "
                                     f"version on {case}: row error {rel}")
            worst_rel = max(worst_rel, rel)
        err = float((got.float() - plain.float()).abs().max())
        worst[dtype] = max(worst.get(dtype, 0.0), err)
    print(f"april_attention kernel == plain version and dense oracle on its "
          f"{len(TEST_GRID)}-case test grid; max |kernel - plain| "
          f"{json.dumps(worst)}, tolerances {json.dumps(TEST_TOL)}; bf16 "
          f"row error {worst_rel} (gate {ROW_REL_TOL})", flush=True)
    attrs = {f"D {D} block_q {bq} kv tile {kt}": a
             for (D, bq, kt), a in kernel_attrs(torch.bfloat16).items()}
    print(f"april_attention_tc_kernel instances (registers a thread, local "
          f"spill bytes a thread, dynamic shared memory bytes): "
          f"{json.dumps(attrs)}", flush=True)
    attrs32 = {f"D {D} block_q {bq}": a
               for (D, bq), a in kernel_attrs(torch.float32).items()}
    print(f"april_attention_kernel (f32) instances (registers a thread, "
          f"local spill bytes a thread, dynamic shared memory bytes): "
          f"{json.dumps(attrs32)}", flush=True)
    spills = [k for k, a in attrs32.items() if a["spill_bytes"]]
    if spills:
        raise AssertionError(f"f32 attention instances spill: {spills}")
    # every f32 instance, its tiles straddling kv blocks of 96 keys
    worst32 = 0.0
    for D in HEAD_DIMS:
        for bq in BLOCK_QS:
            for S, bkv, kind, window, cap in F32_INSTANCE_CASES:
                rng = np.random.default_rng(D + bq + S)
                q, k, v = (torch.from_numpy(rng.normal(size=(2, S, D))
                                            .astype(np.float32)).to(dev)
                           for _ in range(3))
                kw = dict(block_q=bq, block_kv=bkv, mask_kind=kind,
                          window=window, softcap=cap)
                iv = torch.from_numpy(build_block_intervals(
                    S, S, bq, bkv, kind, window)).to(dev)
                err = float((april_attention(q, k, v, **kw)
                             - april_attention_plain(
                                 q, k, v, iv, scale=1.0 / D ** 0.5, **kw))
                            .abs().max())
                if err > TEST_TOL["float32"]:
                    raise AssertionError(f"april_attention_kernel (f32) != "
                                         f"plain version at D {D}, block_q "
                                         f"{bq}, {kind} {window}: {err}")
                worst32 = max(worst32, err)
    print(f"april_attention_kernel (f32) == plain version on all "
          f"{len(attrs32)} instances x {len(F32_INSTANCE_CASES)} cases; max "
          f"|kernel - plain| {worst32}", flush=True)

    gen = torch.Generator(device=dev)
    rows = []
    for (label, dtype, heads, kv_heads, S, D, kind, window, cap,
         seed) in ATTN_SHAPES:
        gen.manual_seed(seed)
        temps = torch.tensor(ATTN_TEMPS, device=dev).repeat(
            -(-heads // len(ATTN_TEMPS)))[:heads]
        q = (torch.randn((heads, S, D), generator=gen, device=dev)
             * temps[:, None, None]).to(getattr(torch, dtype))
        k, v = (torch.randn((kv_heads, S, D), generator=gen, device=dev)
                .to(getattr(torch, dtype))
                .repeat_interleave(heads // kv_heads, 0) for _ in range(2))
        kw = dict(block_q=128, block_kv=128, mask_kind=kind, window=window,
                  softcap=cap)
        iv = torch.from_numpy(build_block_intervals(S, S, 128, 128, kind,
                                                    window)).to(dev)
        scale = 1.0 / D ** 0.5
        april_attention_blocks.launches = 0
        got = april_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        launches = april_attention_blocks.launches
        if launches != 1:
            raise AssertionError(f"[{label}] {launches} kernel launches, "
                                 "not 1")
        plain = april_attention_plain(q, k, v, iv, scale=scale, **kw)
        rel = row_rel_err(got, plain)
        err = float((got.float() - plain.float()).abs().max())
        if rel > ROW_REL_TOL or (dtype == "float32" and err > TEST_TOL[dtype]):
            raise AssertionError(f"[{label}] april_attention kernel != plain "
                                 f"version: row error {rel}, max abs {err}")
        # wrong versions the gate must refuse
        controls = {"one kv block dropped": (_drop_one_block(iv), kw)}
        if cap is not None:
            controls["softcap off"] = (iv, {**kw, "softcap": None})
        if kind == "local":
            controls["window one key longer"] = (
                torch.from_numpy(build_block_intervals(
                    S, S, 128, 128, kind, window + 1)).to(dev),
                {**kw, "window": window + 1})
        readings = {}
        for name, (c_iv, c_kw) in controls.items():
            readings[name] = row_rel_err(april_attention_plain(
                q, k, v, c_iv, scale=scale, **c_kw), plain)
            if readings[name] <= ROW_REL_TOL:
                raise AssertionError(f"[{label}] the gate passes a wrong "
                                     f"version ({name}): row error "
                                     f"{readings[name]}")
        del plain
        ms = _ms(lambda: april_attention(q, k, v, **kw))
        plain_ms = _ms(lambda: april_attention_plain(q, k, v, iv, scale=scale,
                                                     **kw))
        if label in ("gemma2-2b local", "qwen1.5-4b causal f32"):
            _profile_showing(label, lambda: april_attention(q, k, v, **kw),
                             "april_attention_tc_kernel"
                             if dtype == "bfloat16"
                             else "april_attention_kernel", launches=1)
        t0 = time.perf_counter()
        lib_name, lib = _library(q, k, v, kind, window, cap, scale)
        lib_out = lib()
        torch.cuda.synchronize()
        lib_first_s = time.perf_counter() - t0
        lib_rel = row_rel_err(lib_out, got)
        del lib_out
        if lib_rel > ROW_REL_TOL:
            raise AssertionError(f"[{label}] {lib_name} is not the same "
                                 f"function: row error {lib_rel}")
        library_ms = _ms(lib)
        device = {"kernel": _device_ms(lambda: april_attention(q, k, v,
                                                               **kw)),
                  lib_name: _device_ms(lib)}
        n_allowed = heads * _allowed_positions(S, kind, window)
        t_bytes = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S * 1e3
        # f32 products run on the CUDA cores: TF32 would break f32
        peak = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
        t_ops = 4 * D * n_allowed / peak * 1e3
        tc = dtype == "bfloat16"
        row = {"name": "april_attention" if tc else "april_attention_f32",
               "route": "cuda",
               "kernel": ("april_attention_tc_kernel" if tc
                          else "april_attention_kernel"),
               "source": ("src/repro_torch/csrc/april_attention_tc.cu" if tc
                          else "src/repro_torch/csrc/april_attention.cu"),
               "replaces": "src/repro/kernels/april_attention/"
                           "april_attention.py:102",
               "launches": launches, "max_abs_err": err, "rel_err": rel,
               "tol": ROW_REL_TOL, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms, "device_ms": device["kernel"]}
        if not tc:      # f32 is held to its allclose tolerance
            del row["rel_err"]
            row["tol"] = TEST_TOL[dtype]
        visited = heads * int((iv[:, 3] - iv[:, 0]).sum())
        print(f"[{label}] BH {heads} ({kv_heads} kv heads), S {S}, D {D}, "
              f"{kind} {window}, softcap {cap}, logit std {ATTN_TEMPS}: "
              f"{visited} visited (q block, kv block) pairs, {n_allowed} "
              f"allowed positions, bytes bound {t_bytes} ms, operations "
              f"bound {t_ops} ms (4 D a position over the {dtype} peak; "
              f"tanh not counted); row error of the wrong controls "
              f"{json.dumps(readings)}; library {lib_name}, row error "
              f"{lib_rel} against the kernel, first call {lib_first_s:.1f} "
              f"s; device ms of one call {json.dumps(device)}: "
              f"{json.dumps(row)}", flush=True)
        if label in ("gemma2-2b local", "qwen1.5-4b causal f32"):
            rows.append(row)
        del q, k, v, got
    print(f"phase 9 ok: attention kernels "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--r-count", type=int, default=3600)
    ap.add_argument("--s-count", type=int, default=12000)
    ap.add_argument("--n-order", type=int, default=12)
    args = ap.parse_args()

    # torch.compile (phase 9's flex_attention yardstick) caches under the
    # checkout's build/ and compiles in this process, with no worker pool
    build = Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import JoinPlan, make_dataset
    from repro_torch.core import geometry
    from repro_torch.core.join import INDECISIVE, TRUE_HIT, TRUE_NEG
    from repro_torch.kernels import _build
    from repro_torch.kernels.compact import compact_mask, compact_mask_plain
    from repro_torch.kernels.compact import cases as compact_cases
    from repro_torch.kernels.fused_refine import fused_refine_rows
    from repro_torch.kernels.interval_join import (
        april_trichotomy, april_trichotomy_plain, interval_overlap,
        interval_overlap_plain)
    from repro_torch.kernels.refine import (edges_intersect_csr,
                                            edges_intersect_csr_plain)
    from repro_torch.kernels.ri_and import ri_trichotomy, ri_trichotomy_plain
    from repro_torch.core import ri as ri_mod
    from repro_torch.spatial import fused
    from repro_torch.spatial import refine as refine_mod

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    # 2. build every kernel from source, one nvcc a source, all started
    # together beside the host's set-up: the join kernels are waited for
    # before phase 3 launches one, the attention kernels before phase 9
    t_kernels = time.perf_counter()
    attention_libs = ("april_attention", "april_attention_tc")
    builds_pool = ThreadPoolExecutor(2)
    join_build = builds_pool.submit(_build.build_all, [
        n for n in _build.SOURCES if n not in attention_libs])
    attention_build = builds_pool.submit(_build.build_all, attention_libs)
    builds_pool.shutdown(wait=False)

    # 3. kernels against their plain versions on the card, exactly
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    R = make_dataset("T1", seed=0, count=args.r_count)
    S = make_dataset("T2", seed=1, count=args.s_count)
    # the numpy builds' seconds and stages (and some of their stores), for
    # phase 12's torch builds
    builds = {}
    with geometry.BUILD_STAGES.record() as stages:
        t1 = time.perf_counter()
        plan = JoinPlan(R, S, filter="april", n_order=args.n_order).build()
        builds["april"] = (time.perf_counter() - t1, stages)
    cands = plan.candidates("intersects")
    print(f"host: datasets + APRIL build + candidates "
          f"{time.perf_counter() - t0:.1f} s, {len(cands)} candidates",
          flush=True)
    per_lib = join_build.result()
    print(f"build: the join kernels done "
          f"{time.perf_counter() - t_kernels:.1f} s after the start "
          f"{json.dumps({k: round(v, 1) for k, v in per_lib.items()})}",
          flush=True)
    lists = {k: plan.filter._lists(a, kind).to(dev)
             for k, a, kind in (("xa", plan.approx_r, "A"),
                                ("xf", plan.approx_r, "F"),
                                ("ya", plan.approx_s, "A"),
                                ("yf", plan.approx_s, "F"))}
    ri_all = torch.from_numpy(cands[:, 0].copy()).to(dev)
    si_all = torch.from_numpy(cands[:, 1].copy()).to(dev)
    # the first candidate rows, and every row with a list wider than the
    # 256 intervals the TPU kernel's VMEM tile took
    width = np.maximum.reduce([
        plan.filter._lists(a, kind).counts(cands[:, c])
        for a, c in ((plan.approx_r, 0), (plan.approx_s, 1))
        for kind in ("A", "F")])
    wide = np.nonzero(width > 256)[0]
    sel = torch.from_numpy(np.union1d(np.arange(min(COMPARE_ROWS,
                                                    len(cands))), wide))
    ri, si = ri_all[sel.to(dev)], si_all[sel.to(dev)]
    print(f"compare rows: {len(ri)}, of them {len(wide)} with a list wider "
          f"than 256 (widest {int(width.max())}); tolerance: exact",
          flush=True)
    tri = (lists["xa"], lists["xf"], lists["ya"], lists["yf"])
    got = april_trichotomy(*tri, ri, si)
    want = april_trichotomy_plain(*tri, ri, si)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("april_trichotomy kernel != plain version")
    # the overlap kernel on each list pairing a join order gives it: AA
    # over the compared rows, AF and FA over every AA survivor
    aa = interval_overlap_plain(lists["xa"], lists["ya"], ri_all, si_all)
    ri_aa, si_aa = ri_all[aa], si_all[aa]
    for x, y, rows in (("xa", "ya", (ri, si)), ("xa", "yf", (ri_aa, si_aa)),
                       ("xf", "ya", (ri_aa, si_aa))):
        got = interval_overlap(lists[x], lists[y], *rows)
        want = interval_overlap_plain(lists[x], lists[y], *rows)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"interval_overlap kernel != plain version "
                                 f"on {x} x {y}")
    for line in _interval_join_sweep(dev):
        print(line, flush=True)
    # the compaction kernel against its plain version and the stable
    # argsort oracle, perm and count exactly
    rng = np.random.default_rng(7)
    indec_mask = april_trichotomy(*tri, ri_all, si_all) == INDECISIVE
    lanes = {"n=0": np.zeros(0, bool), "n=1": np.ones(1, bool),
             "n=257": rng.random(257) < 0.5, "n=4096": rng.random(4096) < 0.3,
             "all-true": np.ones(5000, bool),
             "all-false": np.zeros(5000, bool),
             "random n=2^21+4097": rng.random((1 << 21) + 4097) < 0.37,
             **compact_cases.lanes(long=True)}
    lanes = {k: torch.from_numpy(v).to(dev) for k, v in lanes.items()}
    lanes["main path INDECISIVE"] = indec_mask
    for name, m in lanes.items():
        kp, kc = compact_mask(m)
        pp, pc = compact_mask_plain(m)
        op = torch.argsort((~m).to(torch.uint8), stable=True).to(torch.int32)
        torch.cuda.synchronize()
        if not (torch.equal(kp, pp) and torch.equal(kp, op)
                and int(kc) == int(pc) == int(m.sum())):
            raise AssertionError(f"compact_mask kernel != plain version or "
                                 f"argsort oracle on lane {name}")
    print(f"compact_mask kernel == plain version == argsort oracle (perm and "
          f"count) on {len(lanes)} lanes: "
          f"{json.dumps({k: m.numel() for k, m in lanes.items()})}",
          flush=True)
    print(f"phase 3 ok: trichotomy, overlap and compaction kernels == plain "
          f"versions; {len(ri_aa)} AA survivors "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # 4. the main path, default order then the degenerate order; the edge
    # sweep's inputs are recorded from the path itself
    t_phase = time.perf_counter()
    wrappers = (april_trichotomy, interval_overlap, edges_intersect_csr,
                compact_mask, fused_refine_rows)
    launches, results, stats, sweeps, refined = {}, {}, {}, {}, {}
    for label, opts in (("default", {}),
                        ("degenerate", {"order": ("AA", "AF")})):
        _reset(wrappers)
        t0 = time.perf_counter()
        run = JoinPlan(R, S, filter="april", n_order=args.n_order,
                       filter_opts=opts).build(
            prebuilt=(plan.approx_r, plan.approx_s))
        with refine_mod.record_sweeps() as sweeps[label]:
            res, st = run.execute("intersects")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = _launched(label, wrappers)
        print(f"main path [{label}] {wall:.2f} s launches "
              f"{json.dumps(launches[label])}", flush=True)
        print(json.dumps(st.to_dict()), flush=True)
        t0 = time.perf_counter()
        ref, rst = JoinPlan(R, S, filter="april", n_order=args.n_order,
                            filter_opts=opts, filter_backend="numpy",
                            refine_backend="numpy").build(
            prebuilt=(plan.approx_r, plan.approx_s)).execute("intersects")
        print(f"numpy reference [{label}] {time.perf_counter() - t0:.2f} s",
              flush=True)
        _same_run(label, res, st, ref, rst)
        results[label] = res
        stats[label] = st
    # the fused chain, both MBR backends, each run's frame and lanes recorded
    for mb in ("numpy", "torch"):
        label = f"fused-{mb}"
        _reset(wrappers)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = JoinPlan(R, S, filter="april", n_order=args.n_order,
                       pipeline_mode="fused", mbr_backend=mb).build(
            prebuilt=(plan.approx_r, plan.approx_s))
        with fused.record_chains() as chains:
            res, st = run.execute("intersects")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = _launched(label, wrappers)
        print(f"main path [{label}] {wall:.2f} s; launches "
              f"{json.dumps(launches[label])}; t_mbr {st.t_mbr:.4f} s, "
              f"t_filter {st.t_filter:.4f} s, t_refine {st.t_refine:.4f} s, "
              f"t_sync {st.t_sync:.4f} s; {st.extra['n_frame']} frame rows; "
              f"escalated unc rows {st.extra['n_escalated']}; peak device "
              f"memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB",
              flush=True)
        print(json.dumps(st.to_dict()), flush=True)
        _same_run(label, res, st, results["default"], stats["default"])
        if launches[label]["edges_intersect_csr"] != 0:
            raise AssertionError(f"[{label}] the fused chain ran the float32 "
                                 "edge sweep")
        stats[label] = st
        (cs,) = chains
        _sync_checked(run, label, cs.status)
        if launches[label]["fused_refine_rows"] != 1:
            raise AssertionError(f"[{label}] "
                                 f"{launches[label]['fused_refine_rows']} "
                                 f"fused_refine launches, not 1")
        # B7 on the chain the run recorded, against the eager cores
        refined[label] = _refine_checked(label, R, S, cs, "intersects")
        # B1 on the run's whole device frame, and B3 on the INDECISIVE lane
        # the run's compaction was given, against their plain versions
        got = april_trichotomy(*tri, cs.ri_dev, cs.si_dev)
        want = april_trichotomy_plain(*tri, cs.ri_dev, cs.si_dev)
        wrote = want if cs.valid is None else torch.where(cs.valid, want,
                                                          TRUE_NEG)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[{label}] april_trichotomy kernel != plain "
                                 "version on the run's frame")
        if not torch.equal(cs.status, wrote):
            raise AssertionError(f"[{label}] the run's status lane != the "
                                 "plain trichotomy under its valid lane")
        n_set = _compact_checked(label, cs.status == INDECISIVE)
        print(f"[{label}] chain stages passed set_sync_debug_mode('error'); "
              f"recorded inputs: trichotomy kernel == plain version on all "
              f"{len(cs)} frame rows ({int((got == INDECISIVE).sum())} "
              f"INDECISIVE before the valid lane), status lane == plain; "
              f"compaction kernel == plain == oracle on the {len(cs)}-row "
              f"INDECISIVE lane ({n_set} set)", flush=True)
        if mb == "torch":
            torch_frame = (cs.ri_dev, cs.si_dev)
        del cs, chains, got, want, wrote
    need = {"default": ("april_trichotomy", "edges_intersect_csr"),
            "degenerate": ("interval_overlap", "edges_intersect_csr"),
            "fused-numpy": ("april_trichotomy", "compact_mask",
                            "fused_refine_rows"),
            "fused-torch": ("april_trichotomy", "compact_mask",
                            "fused_refine_rows")}
    for label, names in need.items():
        for name in names:
            if launches[label][name] <= 0:
                raise AssertionError(f"[{label}] {name} never launched")
    for label in ("default", "degenerate"):
        _one_sweep(label, launches[label], sweeps[label])
    by_pair = [r[np.lexsort(r.T[::-1])] for r in results.values()]
    if not np.array_equal(*by_pair):
        raise AssertionError("the two join orders give different pair sets")
    res = results["default"]
    if res.ndim != 2 or res.shape[1] != 2 or res.dtype != np.int64 \
            or len(res) == 0:
        raise AssertionError(f"bad result array {res.dtype} {res.shape}")
    rng = np.random.default_rng(0)
    sample = cands[rng.choice(len(cands), size=min(512, len(cands)),
                              replace=False)]
    in_res = set(map(tuple, res.tolist()))
    for i, j in sample:
        exact = geometry.polygons_intersect(R.verts[i], R.nverts[i],
                                            S.verts[j], S.nverts[j])
        if exact != ((int(i), int(j)) in in_res):
            raise AssertionError(f"pair ({i}, {j}) disagrees with the "
                                 "float64 oracle")
    # the edge sweep kernel against its plain version on the one call each
    # of the two main path runs gave it
    n_diff = 0
    for t in sweeps["default"] + sweeps["degenerate"]:
        kh, ku = edges_intersect_csr(*t)
        ph, pu = edges_intersect_csr_plain(*t)
        n_diff += int((kh != ph).sum()) + int((ku != pu).sum())
    torch.cuda.synchronize()
    if n_diff:
        raise AssertionError(f"edges_intersect kernel != plain version on "
                             f"{n_diff} lanes")
    rows_swept = [t[2].numel() - 1 for t in sweeps["default"]
                  + sweeps["degenerate"]]
    print(f"phase 4 ok: staged pairs and order == numpy path, fused == "
          f"staged; {len(sample)} sampled candidates == float64 oracle; edge "
          f"sweep kernel == plain version on the one recorded call of each "
          f"staged run ({rows_swept} rows) "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # 5. the RI path: set-up, the kernel on random code streams, then the
    # join staged and fused, each run's frame recorded
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    with geometry.BUILD_STAGES.record() as stages:
        ri_plan = JoinPlan(R, S, filter="ri", n_order=args.n_order).build()
    builds["ri"] = (time.perf_counter() - t0, stages)
    ri_r, ri_s = ri_plan.approx_r, ri_plan.approx_s
    print(f"host: RI build {time.perf_counter() - t0:.1f} s, "
          f"{len(ri_r.store.ints) + len(ri_s.store.ints)} intervals, "
          f"{len(ri_r.store.bits) + len(ri_s.store.bits)} code bits",
          flush=True)
    t0 = time.perf_counter()
    ri_numpy = ri_plan.filter.verdicts(ri_r, ri_s, cands, backend="numpy")
    print(f"host: numpy RI verdicts of {len(cands)} candidates "
          f"{time.perf_counter() - t0:.1f} s, TRUE_NEG/TRUE_HIT/INDECISIVE "
          f"{np.bincount(ri_numpy, minlength=3).tolist()}", flush=True)
    ri_x = ri_plan.filter._device(ri_r).to(dev)
    ri_y = ri_plan.filter._device(ri_s).to(dev)
    rng = np.random.default_rng(11)
    rand_rows = tuple(torch.from_numpy(rng.integers(0, n, RI_SWEEP_ROWS))
                      .to(dev) for n in (len(R), len(S)))
    n_swept = _ri_sweep(ri_x, ri_y, [(ri_all, si_all), rand_rows], dev)
    print(f"ri_trichotomy kernel == plain version on {n_swept} rows of "
          f"random code streams (densities {list(RI_SWEEP_DENSITIES)}, "
          f"xor_y off and on); tolerance: exact", flush=True)
    print(_ri_case_sweep(dev), flush=True)
    wrappers += (ri_trichotomy,)
    for label, opts in (("ri-staged", {}),
                        ("ri-fused-numpy", {"pipeline_mode": "fused"}),
                        ("ri-fused-torch", {"pipeline_mode": "fused",
                                            "mbr_backend": "torch"})):
        _reset(wrappers)
        t0 = time.perf_counter()
        run = JoinPlan(R, S, filter="ri", n_order=args.n_order,
                       **opts).build(prebuilt=(ri_r, ri_s))
        with ri_mod.record_frames() as frames, \
                fused.record_chains() as chains, \
                refine_mod.record_sweeps() as ri_sweeps:
            res, st = run.execute("intersects")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = _launched(label, wrappers)
        print(f"main path [{label}] {wall:.2f} s; launches "
              f"{json.dumps(launches[label])}; t_mbr {st.t_mbr:.4f} s, "
              f"t_filter {st.t_filter:.4f} s, t_refine {st.t_refine:.4f} s, "
              f"t_sync {st.t_sync:.4f} s", flush=True)
        print(json.dumps(st.to_dict()), flush=True)
        ((x, y, fr, fs, xor_y),) = frames
        got = ri_trichotomy(x, y, fr, fs, xor_y)
        want = ri_trichotomy_plain(x, y, fr, fs, xor_y)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[{label}] ri_trichotomy kernel != plain "
                                 "version on the run's frame")
        if label == "ri-staged":
            if not np.array_equal(got.cpu().numpy(), ri_numpy):
                raise AssertionError("[ri-staged] verdicts != the numpy RI "
                                     "verdicts")
            counts = np.bincount(ri_numpy, minlength=3)
            if (st.n_true_negs, st.n_true_hits, st.n_indecisive) \
                    != tuple(counts.tolist()):
                raise AssertionError("[ri-staged] counts != numpy verdicts")
            if _pair_set(res) != _pair_set(results["default"]):
                raise AssertionError("[ri-staged] result set != the APRIL "
                                     "run's")
            results[label], stats[label] = res, st
            ri_frame = (x, y, fr, fs, xor_y)
            detail = "verdicts == numpy RI verdicts; set == APRIL's"
        else:
            _same_run(label, res, st, results["ri-staged"],
                      stats["ri-staged"])
            (cs,) = chains
            wrote = want if cs.valid is None else torch.where(
                cs.valid, want, TRUE_NEG)
            if fr is not cs.ri_dev or not torch.equal(cs.status, wrote):
                raise AssertionError(f"[{label}] the status lane != the "
                                     "plain RI verdicts of the run's frame")
            _sync_checked(run, label, cs.status)
            detail = ("== staged pairs, order and counts; stages passed "
                      "set_sync_debug_mode('error')")
            if label == "ri-fused-torch":
                ri_torch_frame = (x, y, fr, fs, xor_y)
            del cs
        if launches[label]["ri_trichotomy"] <= 0:
            raise AssertionError(f"[{label}] ri_trichotomy never launched")
        if label == "ri-staged":
            _one_sweep(label, launches[label], ri_sweeps)
            kh, ku = edges_intersect_csr(*ri_sweeps[0])
            ph, pu = edges_intersect_csr_plain(*ri_sweeps[0])
            torch.cuda.synchronize()
            if not (torch.equal(kh, ph) and torch.equal(ku, pu)):
                raise AssertionError(f"[{label}] edges_intersect kernel != "
                                     "plain version on the run's sweep")
        elif launches[label]["compact_mask"] <= 0:
            raise AssertionError(f"[{label}] compact_mask never launched")
        print(f"[{label}] ri_trichotomy kernel == plain version on the "
              f"recorded {fr.numel()}-row frame; {detail}", flush=True)
        del frames, chains, ri_sweeps, got, want
    print(f"phase 5 ok: RI path ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # 6. the host filters at the DATASET_SPECS counts, staged and fused
    t_phase = time.perf_counter()
    R2 = make_dataset("T1", seed=0, count=args.r_count // HOST_SCALE)
    S2 = make_dataset("T2", seed=1, count=args.s_count // HOST_SCALE)
    want_set = _pair_set(JoinPlan(R2, S2, filter="april",
                                  n_order=args.n_order).build().execute(
        "intersects")[0])
    for name in ("none", "5cch", "ra", "april-c"):
        t0 = time.perf_counter()
        with geometry.BUILD_STAGES.record() as stages:
            host_plan = JoinPlan(R2, S2, filter=name,
                                 n_order=args.n_order).build()
        t_build = time.perf_counter() - t0
        builds[name] = (t_build, stages)
        builds[f"{name} stores"] = (host_plan.approx_r, host_plan.approx_s)
        runs = {}
        for mode in ("staged", "fused"):
            label = f"{name}-{mode}"
            _reset(wrappers)
            t0 = time.perf_counter()
            res, st = JoinPlan(R2, S2, filter=name, n_order=args.n_order,
                               pipeline_mode=mode).build(
                prebuilt=(host_plan.approx_r, host_plan.approx_s)).execute(
                "intersects")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[label] = _launched(label, wrappers)
            print(f"[{label}] {wall:.2f} s; launches "
                  f"{json.dumps(launches[label])}; "
                  f"{json.dumps(st.to_dict())}", flush=True)
            need = ["compact_mask"] if mode == "fused" else \
                ["interval_overlap"] if name == "april-c" else []
            for k in need:
                if launches[label][k] <= 0:
                    raise AssertionError(f"[{label}] {k} never launched")
            n_sweeps = launches[label]["edges_intersect_csr"]
            if n_sweeps != (mode == "staged"):
                raise AssertionError(f"[{label}] {n_sweeps} edge sweep "
                                     "launches, not one a staged refine")
            runs[mode] = (res, st)
        _same_run(f"{name}-fused", *runs["fused"], *runs["staged"])
        if _pair_set(runs["staged"][0]) != want_set:
            raise AssertionError(f"[{name}] result set != the APRIL run's")
        print(f"[{name}] build {t_build:.2f} s; staged == fused pairs, order "
              f"and counts; set == APRIL's ({len(want_set)} pairs)",
              flush=True)
    builds["R2"], builds["S2"] = R2, S2
    builds["want_small"] = want_set
    print(f"phase 6 ok: host filters at {len(R2)} x {len(S2)} "
          f"({time.perf_counter() - t_phase:.1f} s)", flush=True)

    # 7. where the device time of each main path goes
    t_phase = time.perf_counter()
    for label, filt, opts in (
            ("default", "april", {}),
            ("degenerate", "april", {"filter_opts": {"order": ("AA",
                                                               "AF")}}),
            ("fused-numpy", "april", {"pipeline_mode": "fused"}),
            ("ri-staged", "ri", {})):
        pre = (ri_r, ri_s) if filt == "ri" else (plan.approx_r,
                                                 plan.approx_s)
        run = JoinPlan(R, S, filter=filt, n_order=args.n_order,
                       **opts).build(prebuilt=pre)
        if filt == "ri":
            _profile_showing(label, lambda: run.execute("intersects"),
                             "ri_trichotomy_kernel")
        elif label == "fused-numpy":
            _profile_showing(label, lambda: run.execute("intersects"),
                             "compact_mask_kernel", launches=1)
        else:
            prof = _profile(lambda: run.execute("intersects"))
            print(f"profile [{label}]: {json.dumps(prof)}", flush=True)
    print(f"phase 7 ok: profiles ({time.perf_counter() - t_phase:.1f} s)",
          flush=True)

    # 8. kernels at the main path's shapes, beside their plain versions
    t_phase = time.perf_counter()
    rows = ri_all.numel()
    tri_bytes = _nbytes(*(t for L in tri for t in L), ri_all, si_all) + rows
    ov_bytes = _nbytes(*lists["xa"], *lists["ya"], ri_all, si_all) + rows
    k_tri = april_trichotomy(*tri, ri_all, si_all)
    p_tri = april_trichotomy_plain(*tri, ri_all, si_all)
    k_ov = interval_overlap(lists["xa"], lists["ya"], ri_all, si_all)
    p_ov = interval_overlap_plain(lists["xa"], lists["ya"], ri_all, si_all)
    (sw,) = sweeps["default"]
    kh, ku = edges_intersect_csr(*sw)
    ph, pu = edges_intersect_csr_plain(*sw)
    sweep_err = max(int((kh != ph).sum() > 0), int((ku != pu).sum() > 0))
    # the couples of the edges the CMBR masks keep, and the kernel's bytes
    # from the CSR: 16 per kept edge (two float32 endpoints), 16 per row of
    # offsets (one int64 a side), 2 per row of lanes
    sw_rows = sw[2].numel() - 1
    couples = int((torch.diff(sw[2]) * torch.diff(sw[5])).sum())
    sweep_bytes = 16 * (sw[0].shape[0] + sw[3].shape[0]) + 18 * sw_rows
    timings = {
        "april_trichotomy": (
            _ms(lambda: april_trichotomy(*tri, ri_all, si_all)),
            _ms(lambda: april_trichotomy_plain(*tri, ri_all, si_all))),
        "interval_overlap": (
            _ms(lambda: interval_overlap(lists["xa"], lists["ya"], ri_all,
                                         si_all)),
            _ms(lambda: interval_overlap_plain(lists["xa"], lists["ya"],
                                               ri_all, si_all))),
        "edges_intersect": (
            _ms(lambda: edges_intersect_csr(*sw)),
            _ms(lambda: edges_intersect_csr_plain(*sw))),
        "exclusive_scan": (
            _ms(lambda: compact_mask(indec_mask)),
            _ms(lambda: compact_mask_plain(indec_mask))),
        "ri_trichotomy": (
            _ms(lambda: ri_trichotomy(*ri_frame)),
            _ms(lambda: ri_trichotomy_plain(*ri_frame))),
    }
    # B7 on the fused numpy-MBR run's chain, the eager cores beside it
    b7 = refined["fused-numpy"]
    timings["fused_refine"] = (_ms(lambda: fused_refine_rows(*b7["args"])),
                               _ms(b7["plain"]))
    # the library calls that compute the scan's function (perm and count),
    # and the scan alone, which does no permutation and no scatter
    not_mask = (~indec_mask).to(torch.uint8)
    library = {"exclusive_scan": _ms(lambda: (
        torch.argsort(not_mask, stable=True), indec_mask.sum()))}
    mask32 = indec_mask.to(torch.int32)
    cumsum_ms = _ms(lambda: torch.cumsum(mask32, 0, dtype=torch.int32))
    print(f"exclusive_scan library: stable argsort + sum (perm and count) "
          f"{library['exclusive_scan']} ms; torch.cumsum (the scan alone) "
          f"{cumsum_ms} ms", flush=True)
    k_perm, k_count = compact_mask(indec_mask)
    p_perm, p_count = compact_mask_plain(indec_mask)
    # B5 on the frame, stores and encoding flag the ri-staged run gave it
    k_ri = ri_trichotomy(*ri_frame)
    p_ri = ri_trichotomy_plain(*ri_frame)
    bounds = {
        "april_trichotomy": (tri_bytes, 0),
        "interval_overlap": (ov_bytes, 0),
        "edges_intersect": (sweep_bytes, couples * SWEEP_OPS_PER_COUPLE),
        # a bool read and an int32 written per row, and the int32 count
        "exclusive_scan": (rows * 5 + 4, 0),
        "ri_trichotomy": (_ri_bound_bytes(*ri_frame), 0),
        "fused_refine": (b7["bytes"], b7["ops"]),
    }
    # B7's operations are float64
    peak = {"fused_refine": F64_OPS_PER_S}
    errs = {
        "april_trichotomy": int((k_tri.int() - p_tri.int()).abs().max()),
        "interval_overlap": int((k_ov.int() - p_ov.int()).abs().max()),
        "edges_intersect": sweep_err,
        "exclusive_scan": max(int((k_perm - p_perm).abs().max()),
                              abs(int(k_count) - int(p_count))),
        "ri_trichotomy": int((k_ri.int() - p_ri.int()).abs().max()),
        "fused_refine": b7["max_abs_err"],
    }
    meta = {
        "april_trichotomy": ("src/repro_torch/csrc/interval_join.cu",
                             "src/repro/kernels/interval_join/"
                             "interval_join.py:118", "default"),
        "interval_overlap": ("src/repro_torch/csrc/interval_join.cu",
                             "src/repro/kernels/interval_join/"
                             "interval_join.py:56", "degenerate"),
        "edges_intersect": ("src/repro_torch/csrc/refine.cu",
                            "src/repro/kernels/refine/refine.py:85",
                            "default"),
        "exclusive_scan": ("src/repro_torch/csrc/compact.cu",
                           "src/repro/kernels/compact/compact.py:47",
                           "fused-numpy"),
        "ri_trichotomy": ("src/repro_torch/csrc/ri_and.cu",
                          "src/repro/kernels/ri_and/ri_and.py:69",
                          "ri-staged"),
        "fused_refine": ("src/repro_torch/csrc/fused_refine.cu",
                         "none: the reference's fused refine is jnp "
                         "(src/repro/spatial/refine.py _intersects_impl_jnp)",
                         "fused-numpy"),
    }
    counter = {"exclusive_scan": "compact_mask",
               "edges_intersect": "edges_intersect_csr",
               "fused_refine": "fused_refine_rows"}
    sweep_device_ms = _device_ms(lambda: edges_intersect_csr(*sw))
    extra = {"edges_intersect": {"device_ms": sweep_device_ms},
             **_interval_join_times(tri, (ri_all, si_all), (ri_aa, si_aa),
                                    torch_frame),
             "exclusive_scan": {
                 "device_ms": _device_ms(lambda: compact_mask(indec_mask)),
                 "library_device_ms": _device_ms(lambda: (
                     torch.argsort(not_mask, stable=True),
                     indec_mask.sum()))},
             "ri_trichotomy": {
                 "device_ms": _device_ms(lambda: ri_trichotomy(*ri_frame)),
                 "ms_torch_mbr_frame": _ms(lambda: ri_trichotomy(
                     *ri_torch_frame)),
                 "device_ms_torch_mbr_frame": _device_ms(
                     lambda: ri_trichotomy(*ri_torch_frame))},
             "fused_refine": {
                 "device_ms": _device_ms(
                     lambda: fused_refine_rows(*b7["args"])),
                 "rows": b7["rows"], "frame_rows": b7["frame"],
                 "couples": b7["couples"]}}
    # B5 by the staged frame's verdict class: full merges without overlap,
    # merges to the first hit, full merges that AND every fragment
    by_class = {}
    for c, name in ((TRUE_NEG, "TRUE_NEG"), (TRUE_HIT, "TRUE_HIT"),
                    (INDECISIVE, "INDECISIVE")):
        sel = (p_ri == c).nonzero().flatten()
        fr_c, fs_c = ri_frame[2][sel], ri_frame[3][sel]
        by_class[name] = {"rows": sel.numel(), "device_ms": _device_ms(
            lambda: ri_trichotomy(ri_frame[0], ri_frame[1], fr_c, fs_c,
                                  ri_frame[4]))}
    print(f"ri_trichotomy by verdict class of the ri-staged frame (device "
          f"ms of one call over that class's rows alone): "
          f"{json.dumps(by_class)}; whole frame "
          f"{extra['ri_trichotomy']['device_ms']}", flush=True)
    kernels = []
    for name, (source, replaces, run_label) in meta.items():
        nbytes, ops = bounds[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak.get(name, F32_OPS_PER_S) * 1e3
        ms, plain_ms = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[run_label][counter.get(name, name)],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library.get(name), "tol": 0})
        kernels[-1].update(extra.get(name, {}))
    print(f"shapes: {rows} candidate rows (the scan's and the RI kernel's "
          f"frame), {stats['default'].n_indecisive} INDECISIVE rows, "
          f"{couples} edge couples kept by the CMBR masks over "
          f"{sw[0].shape[0]} + {sw[3].shape[0]} kept edges of {sw_rows} "
          f"sweep rows, edge sweep device ms {sweep_device_ms}; reps {REPS}; "
          f"phase 8 {time.perf_counter() - t_phase:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 10. the within and selection joins and the staged device64 refine
    within = _within_phase(args, dev, R, S, plan, results["default"],
                           stats["default"], wrappers, builds)
    for k in kernels:
        k.update(within.get(k["name"], {}))

    # 11. the linestring joins
    line = _linestring_phase(args, dev, S, plan, ri_s, wrappers, builds)
    for k in kernels:
        k.update(line.get(k["name"], {}))

    # 18. the raw-store wrappers and the quickstart example
    helpers = _helpers_phase(args, dev, plan, cands, builds)
    for k in kernels:
        k.update(helpers.get(k["name"], {}))

    # 12. the construction paths
    _construction_phase(args, dev, R, S, plan, ri_r, ri_s,
                        results["default"], stats["default"], builds,
                        wrappers)

    # 13. the online join service
    service = _service_phase(args, dev, R, S, plan, ri_s, wrappers)
    for k in kernels:
        k.update(service.get(k["name"], {}))

    # 14. the scale-out path
    scaleout = _scaleout_phase(args, dev, builds["want_small"], wrappers)
    for k in kernels:
        k.update(scaleout.get(k["name"], {}))

    # 15. the LM serving path
    _lm_phase(dev)

    # 16. LM training, in a fresh process; 17. the sharded step, in gloo
    # ranks on the card, held to phase 16's first step
    with tempfile.TemporaryDirectory() as tmp:
        first = str(Path(tmp) / "first_step.json")
        _train_in_fresh_process(first)
        _sharded_phase(first)

    # 9. the attention kernel, which no join runs, in a fresh process
    per_lib = attention_build.result()
    print(f"build: the attention kernels done "
          f"{json.dumps({k: round(v, 1) for k, v in per_lib.items()})} s "
          f"after the start, beside phases 3 on", flush=True)
    kernels.extend(_attention_in_fresh_process())
    bad = [k["name"] for k in kernels
           if not k.get("rel_err", k["max_abs_err"]) <= k["tol"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions "
                             f"beyond their tolerance: {bad}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
