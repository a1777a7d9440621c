#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

1. Environment: torch and CUDA versions, the card, its power limit.
2. Build the five CUDA kernels from ``src/repro_torch/csrc`` (in parallel);
   print each rmsnorm instance's registers and fail if any spills.
3. Hold each kernel against its plain PyTorch version at the serving shapes
   and beyond (rmsnorm at the zoo's widths and ragged ones, 1 to 8192 rows,
   strided and misaligned rows, NaN and inf rows beside finite ones; flash
   at Lq 2048 and a ragged 2000; decode at kv_len 0, 1, chunk - 1, chunk,
   chunk + 1, 2047, 2048 with one split and many), in bf16 and fp32, with
   the cache past ``kv_len`` poisoned with 1e9, inf and nan; time the
   kernel, the plain version and one library call (the yardstick, which the
   port never calls) at the serving shapes, at Lq 2048, at kv 2048 and at
   rmsnorm's [8192, 3072] and [64, 256] (bf16, and fp32 as the data plane
   of phase 7 runs them), and compute the card's bound for
   the same work; time rmsnorm's launch floor (an empty kernel on the same
   grid) and its wrapper's host time a call.  Flash and decode are also
   held and timed at the serving shapes of phases 10 to 12 (granite: Hq 16,
   Hkv 8, d 64; deepseek: Hq 16, Hkv 16, d 128; jamba: Hq 32, Hkv 8, d 128;
   nemotron: Hq 48, Hkv 8, d 128; qwen: Hq 64, Hkv 8, d 128; internvl2: Hq
   14, Hkv 2, d 64, Lq 384 after its 256 patches; seamless's self-attention:
   Hq 16, Hkv 16, d 64; Lq 128 over a cache of 160), and rmsnorm at their
   widths, 1024, 2048, 4096, xlstm's 768, internvl2's 896, gemma2's 4608
   and qwen's 8192.  Flash is held and timed with gemma2's softcap 50 and
   4096-key window (Hq 32, Hkv 16, d 128) at a 4500-row prompt (batch 1),
   at its serving prompt and at decode steps of one query row (kv_len 1 to
   4352, the window past q_offset) and at phase 13's training shape (B4,
   Lq = kv = 512), and non-causal at seamless's encoder (1024 frames) and
   cross-attention (Lq 128 and 1 against them); rmsnorm is timed at phase
   13's [2048, 768] and [2048, 4608] too.  Times print in microseconds.
4. Serve llama3.2-3b at full width (28 layers, d 3072, vocab 128256, bf16,
   random weights from seed 0) through ``repro_torch.launch.serve.serve`` on
   ``cuda``, with every launch count zeroed just before and read just after.
5. Rerun prefill + 4 decode steps on the same weights and prompts with the
   switch set to ``"plain"``, and compare the last-position logits; and
   hold both bf16 paths against the plain path in fp32.
6. Profile 8 decode steps of the kernel path: wall time a step, device
   kernel time a step, the device's busy share, the top kernels and host
   ops, and rmsnorm's device time and wrapper host time a step; and the
   step's bound (every weight read once, and the cache).
7. The data plane, SWIRL's own main path: ``repro_torch.swirl.trace(...)
   .optimize().lower("torch", fuse=...).compile(fns).run(...)`` on the
   reference benchmark's 12-step rmsnorm pipeline at (64, 256) and at
   [8192, 3072] fp32, and on the 1000 Genomes instance (9 locations on
   the card, float32 payloads of 65536), interpreted and fused (each
   straight-line run of steps one CUDA graph).  Fused stores must match
   the interpreted ones (rtol 1e-5, atol 1e-6), each rmsnorm step its plain
   version (fp32 2e-5); no fallbacks and 12 fused steps; 3 rmsnorm wrapper
   launches an interpreted run and 3 rmsnorm kernels in a profiled fused
   replay; a host sync in a body falls back; a second fused run leaves
   the first store as it was.  At P-full, with the launch counts set to 0
   just before and read just after, one interpreted run launches rmsnorm 3
   times and a fresh fused executable's first run (warm-up and capture) 6.
   Prints ms a run, fused / interpreted and the roofline fraction beside
   the card's name and power limit.
8. Trace, schedule and certify on the card: phase 7's P-ref, P-full and G,
   interpreted and fused, lowered with ``trace=True``.  Stores must equal
   the untraced run's (rtol 1e-5, atol 1e-6) and span schemas the port's
   own CPU schema of the same plan; at P-full interpreted the exec spans
   must sum to at least 0.9x the device time ``torch.profiler`` reports for
   one untraced run; a profiled traced run may copy no more from the
   device to the host than an untraced one; each run's Chrome trace is
   written under ``build/traces/`` and validated; at P-full one traced
   interpreted run and a fresh traced fused executable's first run, each
   from launch counts of 0, launch rmsnorm 3 and 6 times.  G with
   ``placement="auto"`` under the ``two-rack`` network runs on the card
   with a store equal to the same scheduled plan on the CPU, and a small
   1000 Genomes instance runs the whole chain ``trace -> optimize(certify
   =True) -> schedule -> certify -> lower(trace=True, fuse=True) -> run``.
   Prints traced / untraced ms a run per cell, ``Plan.profile(result)
   .summary()`` for G, the cost model's median |duration ratio - 1| before
   and after ``CostModel.from_profile``, the schedule's bytes saved, comms
   and ms a run against the hand placement, and ``optimize(certify=True)``'s
   states and host ms.
9. Training on the card through ``repro_torch.launch.train.Trainer`` (what
   ``train`` runs; it lowers each iteration to the ``inprocess`` backend,
   whose thread pool fires both pods' steps at once): T-full, llama3.2-3b at full width with 8 of its 28
   layers (bf16, remat), 2 pods with int8 gradsync, global batch 4 x 512,
   one warm iteration and 3 timed.  Loss and grad norm must be finite and
   every param leaf must change; from launch counts of 0, one iteration
   must launch rmsnorm 2 x (17 + 16) = 66 times (forward and remat
   recompute), flash 2 x (8 + 8) = 32 and decode 0.  One fwdbwd on the
   kernel path is held against the plain path (loss 1e-2 relative, each
   grad leaf 5e-2 by relative L2, every leaf nonzero and finite) and both
   against the plain path in fp32 (the kernel path's whole gradient at most
   1.25x as far).  Prints ms an iteration, tokens/s, peak memory (beside
   the torch backend's, which ran one step at a time), each step's ms, device
   ops, busy share and device time by kernel family from one profiled
   iteration and the share of 989 TFLOP/s bf16 the counted operations reach.  Then the
   smoke config (fp32, head_dim 64) writes a checkpoint through the
   trainer's ``ckpt`` step on the card; it must read back into CPU tensors
   bit for bit, a CPU model's loss at it must match the card's, and a new
   trainer must resume from it for one step.

10. MoE on the card: serve granite-moe-1b-a400m (24 layers, d 1024, 32
   experts top-8) and deepseek-moe-16b (28 layers, d 2048, 64 routed experts
   top-6 and 2 shared, layer 0 dense) at full width through ``serve`` on
   ``cuda`` (bf16, random weights from seed 0, phase 4's batch, prompt and
   length), each model freed before the next is made, with exact launch
   counts for the whole ``serve`` call and, from counts of 0, for one
   prefill and each decode step.  Prefill + 4 decode steps are rerun on the
   plain path: free (its own routing, printed) and with routing forced to
   the kernel path's (:class:`RouteTape`), where the logits must agree
   within MOE_REL_L2_TOL, the plain path's own top-k with the kernel path's
   on ROUTE_AGREE of the choices of every MoE layer, and the kernel path
   must be at most F32_RATIO times as far from the plain path in fp32 as
   the plain bf16 path.  Decode is profiled as in phase 6 beside the step's
   bound (every weight read once).  Then granite-moe trains at full width
   and depth through ``Trainer`` (phase 9's pods, batch and sequence): one
   iteration from counts of 0 must launch rmsnorm 2 x (49 + 48), flash
   2 x (24 + 24) and decode 0, give a finite loss and grad norm and aux > 0
   and change every leaf (the fp32 routers included); one fwdbwd is held as
   in phase 9 with routing forced.

11. The recurrent archs on the card: serve xlstm-125m (12 layers, d 768,
   mLSTM and sLSTM, whole) and jamba-v0.1-52b at full width with its depth
   cut from 32 layers to 8 (7 mamba, 1 attention without RoPE, 4 MoE FFNs)
   through ``serve`` on ``cuda`` (bf16, seed 0, phase 4's batch, prompt and
   length), each model freed before the next, with exact launch counts for
   the whole ``serve`` call and, from counts of 0, for one prefill and each
   decode step (xlstm 13 / 0 / 0 both; jamba 17 / 1 / 0 and 17 / 0 / 1).
   Prefill + 4 decode steps are rerun on the plain path (jamba's routing
   forced, as in phase 10) and in fp32: logits within REC_REL_L2_TOL and
   the kernel path at most F32_RATIO times as far from fp32.  Each mixer
   runs under ``set_sync_debug_mode("error")``; decode is held against a
   cache-free forward over the same tokens on the kernel path in fp32 (and
   printed in bf16); a prefill and each mixer at the prefill's rows are timed beside
   their device time, and decode is profiled beside its bound.  Then mamba
   (d 4096), mLSTM (4 heads of 192) and sLSTM (d 768), one layer each in
   fp32 from a carried state, must match the same mixer on the CPU within
   fp32 TOL by relative L2 (and read beyond it with TF32 planted), and TF32
   must still be off.

12. The other families on the card, in a child process of this one
   (``chip_smoke.py --families OUT``) started right after the build, so that
   its profiles stay apart from the later phases' and gemma2's 54.5 GB
   find the card free: serve gemma2-27b (46 layers, local and
   global attention, softcaps, post norms) and nemotron-4-15b (32 layers,
   LayerNorm, relu_sq) whole, qwen1.5-110b at full width with its depth cut
   from 80 layers to 8, internvl2-1b (24 layers, 256 patches before the
   prompt) and seamless-m4t-medium (12 encoder layers over 1024 frames, 12
   decoder layers with cross-attention) whole, through ``serve`` on
   ``cuda`` (bf16, seed 0, phase 4's batch, prompt and length), each model
   freed before the next, with exact launch counts for the whole ``serve``
   call and, from counts of 0, for one prefill and each decode step.
   Prefill + 4 decode steps are rerun on the plain path and in fp32:
   logits within FAMILY_REL_L2_TOL and the kernel path at most F32_RATIO
   times as far from fp32; decode is held against a cache-free forward on
   the kernel path in fp32 (DECODE_F32_REL_L2_TOL); a warm prefill is timed
   beside its device time, and decode profiled beside its bound, as in
   phase 11 (the same code serves both).  The child's failure fails the run.

13. Training xlstm-125m and gemma2-27b on the card, in a second child
   process (``chip_smoke.py --training OUT``) started after phase 12's, so
   that gemma2 finds the card free: TR-xlstm, xlstm-125m whole (12 layers,
   d 768, mLSTM and sLSTM) at 2 pods, and TR-gemma2, gemma2-27b at full
   width with 2 of its 46 layers (one local, one global) at 1 pod (2 do not
   fit), through ``Trainer`` on ``cuda`` with phase 9's batch, sequence,
   bf16, remat and int8 gradsync.  The first iteration must give a finite
   loss and grad norm, change every leaf and keep each leaf's dtype, the
   fp32 gates (the mLSTM's input and forget gates, the sLSTM's biases) fp32,
   and, from launch counts of 0, launch rmsnorm 2 x (13 + 12) = 50,
   flash 0 and decode 0 (xlstm), and 1 x (9 + 8) = 17, 1 x (2 + 2) = 4 and
   0 (gemma2, flash with its softcap 50 and window 4096 under
   ``KernelWithPlainGrad``; the window does not bite at 512 tokens).  One
   fwdbwd is held as in phase 9.  Prints what phase 9 prints, and the
   sLSTM loop's device ops.  Then each recurrent mixer's backward at full
   width in fp32 (mamba at jamba's d 4096, the mLSTM's 4 heads of 192, the
   sLSTM at d 768; one layer each at phase 11b's rows, the loss a fixed
   random projection of the output): every weight's grad and the input's
   within fp32 TOL of the CPU's by relative L2, and beyond it with TF32
   planted.  The child's failure fails the run.

14. Distribution on the card, in a third child process (``chip_smoke.py
   --distribution OUT``) started after phase 13's: a one-rank NCCL group
   from an in-process ``HashStore`` (no network), ``make_mesh((1, 1),
   ("data", "model"))`` on cuda, destroyed before the child exits (NCCL
   takes one rank a GPU, so one card shows only the 1 x 1 mesh).  D-llama
   (llama3.2-3b at full width, 2 of 28 layers) and D-granite
   (granite-moe-1b-a400m at full width, 4 of 24 layers), fp32 with remat,
   batch 4 x 512: the weights placed as DTensors by ``distribute_params(
   param_specs(...))``, one fwdbwd with ``set_hints`` and one without on
   plain tensors, each from launch counts of 0.  The counts must equal each
   other and one pod's training iteration's; H1 (``layers.sdpa_on_shards``)
   must be taken, and H2 (``moe.apply_moe_sharded``) for granite; loss and
   aux within 1e-5 and every grad within 1e-4 (the embedding's also 1e-5 by
   relative L2); every param and grad a cuda DTensor with the specs'
   placements; one AdamW update with ``zero1_specs`` moments equal to the
   unsharded one.  Prints each mode's ms, device ops, busy share and peak GB.
   The child's failure fails the run.

15. The dry-run and the roofline on the card, in a fourth child process
   (``chip_smoke.py --dryrun OUT``) started after phase 14's.  (a) The
   dry-run on the card's own torch (``launch.dryrun.run_cell``, meta
   DTensors over a ``"fake"`` group of 256 or 512 ranks on a cuda mesh;
   nothing is allocated): llama3.2-3b x {train_4k, prefill_32k, decode_32k}
   x pod1, train_4k also with ``--variant opt``, granite-moe-1b-a400m x
   train_4k x pod1, jamba-v0.1-52b x long_500k x pod2 must come back ok,
   llama3.2-3b x long_500k skipped with the reference's reason; llama's
   train_4k global count within 15 % of the reference's unrolled compile
   (3.0368e16) and the opt variant's within 1 % of the baseline's.  Prints
   each cell's counted and analytic FLOPs a device, link bytes by op, the
   dominant term, bound s, MFU bound and seconds.  (b) Two one-card cells on
   the kernel path beside their roofline (``roofline.roofline`` on the
   card's SKU, model = data = chips = 1, the analytic FLOPs and bytes):
   R-decode, llama3.2-3b whole, one decode step at batch 4 (phase 6's
   profile: its device ms, beside phase 6's own bound), and R-train,
   llama3.2-3b at full width, 2 of 28 layers, one ``make_train_step`` step
   (fwdbwd and AdamW) at batch 4 x 512, median of 3 after a warm one.
   Launches exact from 0 (R-decode 57/0/28, R-train 9/4/0); neither may
   measure under 0.95 x its bound; R-train's FLOPs counted on the plain path
   on the card must equal the dry-run's count of the same cell on a 1 x 1
   fake mesh of meta tensors.  The child's failure fails the run.

16. The threaded backend on the card, in a fifth child process
   (``chip_smoke.py --threaded OUT``) started after phase 15's: SWIRL plans
   lowered with ``lower("threaded", timeout_s=60)``, one host thread per
   location, payloads fp32 tensors on ``cuda`` and phase 7's bodies.  (a)
   P-ref and P-full: each store held against the ``torch`` backend's
   interpreted store of the same feed (rtol 1e-5, atol 1e-6), each rmsnorm
   step against its plain version (fp32 2e-5), and, from launch counts of
   0, exactly 3 rmsnorm launches a run.  (b) P-split: the same pipeline
   re-placed with odd steps on l0 and even ones on l1, so that every datum
   crosses a thread; the same checks, one message a COMM, and each datum on
   the receiving location the very tensor its step returned.  (c) G on its
   9 location threads, equal to the ``torch`` backend's store, and bit for
   bit the same with the channels dropping 10 % of the messages (seed 0),
   whose drops and resends must both be counted; the card's busy share of
   a run.  (d) S-serve: the reference's serving workload (ingest -> work_a
   || work_b -> merge on three locations; rmsnorm, rmsnorm, phase 7's mix,
   a sum) on [512, 3072] fp32 requests, 100 instances per instance through
   the whole pipeline and through ``run_many(max_concurrent=8)``: stores
   equal, exactly 200 rmsnorm launches in ``run_many``.  (e) P-full and G
   traced: stores equal to the untraced ones, span schemas equal to the
   CPU's, and at P-full the exec spans at least 0.9x an untraced run's
   device time.  (f) A step that raises after a launch fails its run with
   the reference's ``RuntimeError("location l0 failed: ...")``, and the next
   run of the same executable succeeds.  Prints ms a run beside ``torch``
   interpreted, the busy share, instances/s, traced / untraced, the threads
   a run starts (one per location and per ``Par`` branch) and what a host
   thread costs to start and join.  The child's failure fails the run.

17. The multiprocess backend on the card, in a sixth child process
   (``chip_smoke.py --multiprocess OUT``) started after phase 16's: SWIRL
   plans lowered with ``lower("multiprocess", start_method="spawn")``, one
   OS process per location, payloads fp32 tensors on ``cuda`` in every
   worker, the step bodies module-level functions (they pickle) that add a
   report of their own process, launches and clock to the coordinator's
   merged store.  (a) P-split at (64, 256) and [8192, 3072]: the store bit
   for bit the ``threaded`` backend's of the same plan and bodies, each
   rmsnorm step within 2e-5 of its plain version, exactly 3 rmsnorm
   launches inside the workers a run, worker PIDs distinct and none this
   process's, no worker left after a run.  (b) G on its 9 worker processes,
   likewise; the card's busy share of a run (CUDA events in each body).
   (c) A worker killed at a P-split step raises ``WorkerFailedError`` naming
   its location and step; the same kill with ``recover="spare"`` completes
   with the clean store under the renaming.  (d) A ``fork`` run whose
   payloads are CUDA tensors, from this process with CUDA initialised,
   fails as a ``WorkerFailedError`` naming its location and step within its
   ``timeout_s``.  Prints ms a run (median of 3; each run starts its fleet)
   split into the fleet's start, the steps and the teardown, beside
   ``threaded`` and ``torch`` interpreted, and messages and bytes on the
   wire.  The child's failure fails the run.

18. The gateway on the card, in a seventh child process (``chip_smoke.py
   --gateway OUT``): a ``WorkflowService`` on ``threaded`` behind a
   ``Gateway`` on 127.0.0.1 serves the serving shape of
   ``examples/serve_batched.py`` (its sink answering a number), each step
   making its request's [512, 3072] fp32 tensor on ``cuda`` from the
   request's seed and running rmsnorm.  8 ``GatewayClient`` threads send 200
   requests: every answer equal to the same request run in process on the
   service, exactly 2 rmsnorm launches a request; a tenant over its quota
   gets 429 with ``Retry-After``; ``/v1/healthz`` and ``/v1/metrics``
   answer; one request on a service with ``backend="multiprocess"`` (spawn)
   answers the same number.  Prints requests/s and p50 / p99 ms.  The
   child's failure fails the run.

19. DeepSeek-V2-Lite's multi-head latent attention, in an eighth child
   process (``chip_smoke.py --mla OUT``): the absorbed MLA decode kernel
   against its plain version at the long-prompt cell's shape (batch 4, 16
   heads, a 32150-row latent cache, kv_len 1, a split, 32100 and the whole
   cache, read from the device), by relative L2 against fp32; its time, its
   plain version's and one SDPA call's at kv 32100 (cold L2, median of 25)
   beside the bound from ``bench/counts/mla.py``; then the model served at
   full width and depth (27 layers) through ``serve`` with every launch
   count zeroed just before: one flash launch an MLA layer in the prefill,
   one MLA decode launch a layer and step, none of decode attention.  Its
   row joins the kernels' record.  The child's failure fails the run.

20. The MoE slot kernel, in a ninth child process (``chip_smoke.py
   --moe-slots OUT``): against its plain version, bit for bit, at the
   benchmark cells' slot calls (:data:`SLOT_CALLS`: a decode step's 192 and
   24 choices, a granite pod's 8192 at 32 experts, the prefills' 105,600,
   392,448 and 768,000), at the chunk's edges (:data:`SLOT_EDGES`) and with
   a collapsed router; inside a captured and replayed CUDA graph and under
   ``torch.cuda.set_sync_debug_mode("error")``; its time at each cell's
   shape (cold L2, median of 25) beside its plain version's, one
   ``torch.cumsum`` over the one-hot (the library's yardstick) and its
   bound of 17 bytes a choice.  Its row joins the kernels' record.

``python3 chip_smoke.py --rmsnorm-times ROOT`` only times the rmsnorm
wrapper of the checkout at ROOT (see :func:`rmsnorm_times`), and
``--dataplane-times ROOT`` only its untraced data plane (see
:func:`dataplane_times`); ``--dataplane-compare A B`` runs that for the
checkouts at A and B in alternating pairs (see :func:`dataplane_compare`).

The line before the last is the kernels' JSON record (each kernel's
launches on each path under ``launches_by_path``), the data plane's,
the traced phase's, training's, the MoE phase's, the recurrent phase's,
the families', phase 13's to phase 20's numbers above the card's name; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

ARCH = "llama3.2-3b"
BATCH, PROMPT_LEN, GEN, SEED = 4, 128, 32, 0
CROSS_STEPS = 4
REL_L2_TOL = 2e-2  # bf16 end to end through 28 layers, plain vs kernel path
# A bf16 attention output against the plain version in fp32 on the same
# inputs, by relative L2: rounding the output to bf16 alone gives about
# 2^-9 / sqrt(3) = 1.1e-3; leaving one 64-key tile's P.V out of a row that
# sees up to 2048 keys gives 3e-2 or more.
ATTN_REL_L2_TOL = 1e-2
# rmsnorm's checks on the card: the zoo's widths from 256 (the data plane)
# to 8192, and two that are not a whole number of 16-byte pieces.
RMS_WIDTHS = (256, 768, 896, 1000, 1001, 1024, 2048, 3072, 4096, 4608, 8192, 3)
RMS_ROWS = (1, 4, 5, 33, 512, 8192)
# rmsnorm's timed shapes (bf16): prefill and decode of the serving cell, a
# 2048-token prefill, and the data plane's (64, 256).
RMS_SHAPES = ((BATCH * PROMPT_LEN, 3072), (BATCH, 3072), (8192, 3072), (64, 256))
F32_RATIO = 1.25  # kernel path's distance to the fp32 plain path over the bf16 plain path's
# Phase 10: the MoE archs.  Phase 11: the recurrent archs, each with the
# depth it is served at (None: the config's own).  jamba-v0.1-52b has 51.6 B
# params, 103 GB in bf16, which an 80 GB card cannot hold: its 32 layers are
# cut to 8, one period of its pattern (7 mamba, 1 attention, 4 MoE FFNs of 16
# experts and 4 dense MLPs; 13.3 B params, 26.6 GB) at full width.
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-moe-16b")
REC_ARCHS = {"xlstm-125m": None, "jamba-v0.1-52b": 8}
# The attention of the archs of phases 10 to 12 that reach the decode kernel,
# at the serving shapes (batch BATCH, prompt PROMPT_LEN after the arch's
# prefix of patches, cache GEN rows longer): (query heads, KV heads,
# head_dim, prefix).  granite: GQA group 2 at d 64; deepseek: MHA at d 128;
# jamba: group 4 at d 128; nemotron: group 6 at d 128; qwen: group 8 at d
# 128 (the decode kernel's largest); internvl2: group 7 at d 64 after 256
# patches; seamless's decoder self-attention: MHA at d 64.  And the model
# widths where rmsnorm runs (xlstm has no attention; nemotron and seamless
# use LayerNorm).
SERVE_ATTN = {"granite-moe-1b-a400m": (16, 8, 64, 0), "deepseek-moe-16b": (16, 16, 128, 0),
              "jamba-v0.1-52b": (32, 8, 128, 0), "nemotron-4-15b": (48, 8, 128, 0),
              "qwen1.5-110b": (64, 8, 128, 0), "internvl2-1b": (14, 2, 64, 256),
              "seamless-m4t-medium": (16, 16, 64, 0)}
SERVE_WIDTHS = {"granite-moe-1b-a400m": 1024, "deepseek-moe-16b": 2048, "jamba-v0.1-52b": 4096,
                "xlstm-125m": 768, "internvl2-1b": 896, "gemma2-27b": 4608, "qwen1.5-110b": 8192}
# Phase 3: gemma2's attention (32 / 16 heads of 128, logit softcap 50, a
# 4096-key window on its local layers), which never reaches the decode
# kernel; a prompt past the window at batch 1, and decode steps at Lq = 1.
GEMMA_ATTN = dict(hq=32, hkv=16, d=128, window=4096, softcap=50.0)
GEMMA_LONG = (4500, 4608)  # prompt rows, cache rows
GEMMA_STEP_CACHE = 4352
# Phase 3: seamless's non-causal attention (16 heads of 64): the encoder over
# its 1024 frames, and the cross-attention's prefill and step against them.
SEAMLESS_ATTN = dict(h=16, d=64, frames=1024)
# Phase 10's routing check, set before its first run.  Two bf16 paths round
# differently, and rounding can flip a near-tie between a token's k-th and
# (k+1)-th expert.  The router's logits are about N(0, 1) (a unit-RMS input,
# 1/sqrt(d) weights), so the gap after the k-th is about 1 / (E f(z_k)) ~ 0.1
# for both archs (f the normal density at the top-k quantile), and a relative
# difference d of the router's input flips the last choice of ~11 d of the
# tokens, 1/k of that share of the choices.  d between the paths is at most
# ~2e-2 (phase 5: llama's logits, 1.87e-2 apart), so ~3 % of granite's
# choices (k 8) and ~4 % of deepseek's (k 6) may flip; a wrong kernel leaves
# about k/E of them standing (25 % and 9 %).  A flip moves its token by a
# tenth or so of its MoE output, and in a free run that token (and those that
# attend to it) then drifts further, layer after layer: so the free runs'
# agreement is printed, not held.  The check is on a forced run, in which the
# plain path routes as the kernel path did (:class:`RouteTape`) and its own
# top-k on the same inputs must agree with the kernel path's on at least
# ROUTE_AGREE of the (token, choice) decisions in every MoE layer.
ROUTE_AGREE = 0.9
# The forced run's last-position logits against the kernel path's, by
# relative L2.  Rounding alone set llama's at 1.87e-2 (each path 1.6e-2 from
# fp32, phase 5); a new arch's floor is not known before its first run, so
# this bound is loose by about 2.5x, and the tight test is the one against
# fp32: the kernel path at most F32_RATIO times as far as the plain bf16 path.
MOE_REL_L2_TOL = 5e-2
# Phase 11: the recurrent archs' kernel path against the plain path (jamba's
# MoE routing forced), by relative L2 of the last-position logits.  The paths
# differ only in the three kernels; the mixers are the same plain ops on both.
# Jamba: as MOE_REL_L2_TOL (the kernels round as in phases 5 and 10, 1.1e-2
# to 2.3e-2 there), loose by ~2.5x, with the tight test against fp32
# (F32_RATIO).  xlstm-125m: 5e-2 was set before the first run too, and failed
# there at 6.25e-2 (PR 18, call 1), because xlstm-125m in bf16 is itself far
# from fp32: 5.8e-2 to 8.6e-2 on either path on the card, the mLSTM's
# normaliser and the exponential gates amplifying each rounding, as they do
# in the reference (tests/test_torch_model.py::
# test_xlstm_bf16_drifts_from_fp32_no_further_than_the_reference).  Two bf16
# paths can then be up to the sum apart, so its bound is 1.5e-1, and again the
# tight test is F32_RATIO (0.68 to 1.005 in that call).
REC_REL_L2_TOL = {"xlstm-125m": 1.5e-1, "jamba-v0.1-52b": 5e-2}
# Decode against a cache-free forward over the same tokens, on the kernel path
# in fp32: only sums reorder (a one-chunk scan against single steps, flash
# against decode attention, matmuls of 528 rows against 4), ~1e-6, gated at
# 1e-3, where a state carried wrongly moves the logits by its whole
# contribution (~1e-1).  The same in bf16 is printed, not held: the forward and
# the steps round apart, and xlstm's bf16 noise and jamba's MoE near-ties
# (a flipped choice moves its token by a tenth of its MoE output) amplify it.
DECODE_F32_REL_L2_TOL = 1e-3
# Phase 12: the other families, each with the depth it is served at (None:
# the config's own).  gemma2-27b (27.23 B params, 54.5 GB in bf16) and
# nemotron-4-15b (15.63 B, 31.3 GB) fit one 80 GB card whole; qwen1.5-110b
# (111.2 B, 222 GB) does not, and its 80 layers are cut to 8 (13.36 B, 26.7
# GB) at full width.  internvl2-1b and seamless-m4t-medium are whole.
FAMILY_ARCHS = {"gemma2-27b": None, "nemotron-4-15b": None, "qwen1.5-110b": 8, "internvl2-1b": None,
                "seamless-m4t-medium": None}
# Phase 12's kernel path against the plain path, by relative L2 of the
# last-position logits: MOE_REL_L2_TOL, set before the first run.  The paths
# differ only in the three kernels, which round as in phases 5, 10 and 11
# (1.1e-2 to 2.3e-2 there, through up to 28 layers); gemma2's 46 layers
# compound more roundings, by sqrt(46 / 28) ~ 1.3 if they add as noise, so
# ~2.5e-2 is expected there, and 5e-2 keeps a margin of two.  The tight test
# is against fp32: the kernel path at most F32_RATIO times as far as the
# plain bf16 path.
FAMILY_REL_L2_TOL = MOE_REL_L2_TOL
# Phases 12 and 13 run in child processes of their own (see run_child), each
# of which must end within this many seconds.
CHILD_TIMEOUT = 600
# Training granite-moe at full width and depth (24 layers, 1.33 B params):
# T-full's pods, batch and sequence; one iteration counted from launch counts
# of 0 (and checked), then MOE_TRAIN_TIMED timed.
MOE_TRAIN_ARCH, MOE_TRAIN_TIMED = "granite-moe-1b-a400m", 2
# Phase 7, the data plane: the reference benchmark's 12-step pipeline
# (benchmarks/run.py, rmsnorm on steps k = 0, 4, 8), at its own (64, 256)
# and at llama3.2-3b's width for a 2048-token prefill at batch 4, and the
# 1000 Genomes instance at the paper's scale; 7 timed runs an arm after a warm one.
DP_STEPS, DP_REPEATS = 12, 7
DP_NORMS = len(range(0, DP_STEPS, 4))  # the rmsnorm steps of a run
DP_SHAPES = {"P-ref": (64, 256), "P-full": (8192, 3072)}
DP_RTOL, DP_ATOL = 1e-5, 1e-6  # the reference benchmark's fused-vs-interpreted gate
G_ELEMS = 65536
# Phase 8: the exec spans' least share of an untraced run's device time at
# P-full interpreted, and the 1000 Genomes instance that the bisimulation
# checker explores within its 20,000 states (the paper's scale has more).
TRACE_COVER = 0.9
CERT_GENOMES = dict(n=2, m=1, a=1, b=1, c=1)
G_RULES = ("R1R2", "R3")
# --dataplane-compare: the share of pairs that must agree in sign for a verdict.
SIGN_AGREE = 0.9
# Phase 9: training.  T-full is llama3.2-3b at full width with its depth cut
# from 28 layers to 8 (1.20 B params): the functional AdamW update holds old
# and new params and moments at once, and the full depth's 3.21 B params
# would need about 77 GB before any temporary (PERF.md, section 4).  Two
# pods with int8 compression (the reference trainer's defaults), global
# batch 4 of 512 tokens; one warm iteration, then TRAIN_TIMED timed.
TRAIN_LAYERS, TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 8, 2, 4, 512, 3
# Phase 13: training on the card through the inprocess backend.  Each cell:
# (arch, depth (None: the config's own), pods, timed iterations), at phase
# 9's batch, sequence, bf16, remat and int8 gradsync; a first iteration
# counted from launch counts of 0 and checked, then the timed ones, one by
# steps and one profiled.  TR-xlstm is xlstm-125m whole (0.120 B params);
# its iteration is host-bound in the sLSTM's loop over time, ~20 s (PERF.md,
# section 5), so it is timed once.  TR-gemma2 is gemma2-27b at full width with its
# depth cut from 46 layers to 2, one local and one global (2.31 B params):
# the functional AdamW update holds old and new params and both fp32 moments
# at once, about 22 B a param a pod (T-full: 55.06 GB for 1.199 B params at
# 2 pods), so ~51 GB at 1 pod, and 2 pods (~102 GB) do not fit.
TRAIN_CELLS = {"TR-xlstm": ("xlstm-125m", None, 2, 1), "TR-gemma2": ("gemma2-27b", 2, 1, 2)}
# Each TR cell's fwdbwd is held as phase 9's, and in fp32 too (kernel path
# against plain path, both fp32).  TR-xlstm's bf16 leaves are printed, not
# held: its bf16 gradient is itself far from its fp32 one, 1.33 by relative
# L2 on either path on the card (PERF.md, section 6), the sLSTM's exponential
# gates and the mLSTM's normaliser amplifying each rounding through 512
# steps and 12 layers, as in the reference (tests/test_torch_train.py::
# test_xlstm_bf16_grads_drift_from_fp32_as_the_references_do), so two bf16
# paths differ leaf by leaf by O(1) whatever the kernels do.  Its tight
# tests are the fp32 kernel path within GRAD_REL_L2_TOL and F32_RATIO.
BF16_LEAVES_HELD = {"TR-xlstm": False, "TR-gemma2": True}
# One fwdbwd on the kernel path against the plain path, bf16, same weights
# and batch: the loss within 1e-2 relative and each grad leaf within 5e-2 by
# relative L2 (a bf16 rounding is 2^-9 relative; the two paths round the
# attention's P.V and its backward at different places, and the difference
# compounds through 8 layers forward, recompute and backward); and against
# the plain path in fp32 on the same (bf16-valued) weights, the kernel
# path's whole gradient at most F32_RATIO times as far as the plain bf16 path's.
TRAIN_LOSS_RTOL, GRAD_REL_L2_TOL = 1e-2, 5e-2
# A gradient leaf under this share of the whole gradient's norm is rounding
# noise around zero, and is held as a share of the whole (leaf_rel_l2), as the
# CPU tests floor it (tests/test_torch_train.py::
# test_recurrent_bf16_keeps_its_fp32_leaves_and_grads): xlstm's sLSTM
# input-gate bias, whose shift of every i_t cancels in h = o.c/n (from a zero
# state n stays >= 1), gets ~1e-9 of the whole, and two paths read 1.4-2.3
# apart there by its own norm, in fp32 too (PERF.md, section 6).
LEAF_FLOOR = 1e-6

# Phase 14: distribution on the card.  Each cell: (arch, depth) at full
# width, fp32, remat, batch DIST_BATCH x DIST_SEQ, on a 1 x 1 mesh (one card:
# NCCL takes one rank a GPU).  D-llama: llama3.2-3b at 2 of 28 layers (0.6 B
# params, 2.4 GB fp32, and as much again in grads); Hkv 8 divides TP 1, so H1
# is head-parallel.  D-granite: granite-moe-1b-a400m at 4 of 24 layers (0.27
# B params); H1, H2 (apply_moe_sharded) and H4.
DIST_CELLS = {"D-llama": ("llama3.2-3b", 2), "D-granite": ("granite-moe-1b-a400m", 4)}
DIST_BATCH, DIST_SEQ = 4, 512
# Hinted against unhinted on the same weights and batch: loss and aux within
# 1e-5 and each grad leaf within 1e-4 by max abs, the tolerances of
# tests/test_hints.py; the embedding's gradient sums rows with atomics in an
# order that changes from run to run, so it is held by relative L2 too.
DIST_LOSS_TOL, DIST_GRAD_TOL, DIST_EMBED_REL_L2 = 1e-5, 1e-4, 1e-5

# Phase 15: the dry-run on the card's torch, and two one-card cells held
# beside their roofline.  DRY_CELLS: (arch, shape, mesh, variant).
DRY_CELLS = (
    ("llama3.2-3b", "train_4k", "pod1", "baseline"),
    ("llama3.2-3b", "train_4k", "pod1", "opt"),
    ("llama3.2-3b", "prefill_32k", "pod1", "baseline"),
    ("llama3.2-3b", "decode_32k", "pod1", "baseline"),
    ("granite-moe-1b-a400m", "train_4k", "pod1", "baseline"),
    ("jamba-v0.1-52b", "long_500k", "pod2", "baseline"),
    ("llama3.2-3b", "long_500k", "pod1", "baseline"),
)
DRY_SKIPPED = {  # the reference's reason, word for word
    ("llama3.2-3b", "long_500k"): "pure full-attention arch: 500k decode is quadratic-cost (assignment: skip)",
}
# The reference's unrolled compile of llama3.2-3b x train_4k (the calibration
# of tests/test_roofline.py), and how far the port's global count may be from
# it; the opt variant's count from the baseline's.
DRY_LLAMA_TRAIN, DRY_LLAMA_TOL, DRY_OPT_TOL = 3.0368e16, 0.15, 0.01
# R-train: llama3.2-3b at full width, R_TRAIN_LAYERS of 28 layers, batch
# R_BATCH x R_SEQ; the measured step may not fall under R_FLOOR x its bound.
R_TRAIN_LAYERS, R_BATCH, R_SEQ, R_FLOOR = 2, 4, 512, 0.95
R_DECODE_ROWS = 160  # phase 4's cache: a 128-token prompt and 32 generated

# Phase 16: the threaded backend on the card.  Each plan is lowered with the
# reference benchmark's timeout_s; P-split puts phase 7's odd steps on l0 and
# its even ones on l1, so that every datum crosses a thread; G reruns with
# the channels dropping G_DROP of the messages (seeded); S-serve is the
# reference's serving workload (benchmarks/run.py, _serve_workload) with
# card-sized bodies on a [512, 3072] fp32 datum, SERVE_INSTANCES instances
# per instance and through run_many(max_concurrent=SERVE_LANES).
THREADED_TIMEOUT_S, G_DROP = 60.0, 0.1
SERVE_INSTANCES, SERVE_LANES, SERVE_SHAPE = 100, 8, (512, 3072)

# Phase 17: the multiprocess backend on the card.  Each plan is lowered with
# start_method="spawn" (a forked child cannot use its parent's CUDA context)
# and the reference's default timeout; MP_RUNS runs a cell, each starting its
# own fleet of worker processes.  Every step body is a module-level function
# (so that it pickles) and adds one output of its own, MP_REPORT + its step:
# its process, the kernels it launched there and its span on the monotonic
# clock.  That output reaches only the coordinator's merged store.
MP_TIMEOUT_S, MP_RUNS, MP_REPORT = 120.0, 3, "report:"
# The socket wire resends a message whose ack has not come within its
# ack_timeout (1 s by default, for lossy links).  Nothing is lost on a local
# socket, and a [8192, 3072] fp32 tensor (100 MB) is pickled through the
# host, crosses the socket and is rebuilt on the card before its ack, which
# leaves a 1 s timeout little margin; a resend moves the 100 MB again.
MP_ACK_TIMEOUT_S = 30.0
# Phase 18: the gateway.  GW_CLIENTS client threads send GW_REQUESTS requests
# of the serving shape, each request's datum a GW_SHAPE fp32 tensor made on
# the card from its seed; a run held for the over-quota check waits at most
# GW_GATE_S.
GW_REQUESTS, GW_CLIENTS, GW_SHAPE, GW_GATE_S = 200, 8, (512, 3072), 30.0
# Phase 19: the MLA arch, and its decode kernel at the long-prompt cell's
# batch, cache rows and last length (prompt 32000, 150 generated).  The
# tolerance is bench/tests/test_bench_mla_card.py's: twice the bf16 output's
# own rounding; a kernel that drops a row or half of P reads ~1e-2.
MLA_ARCH = "deepseek-v2-lite"
MLA_BATCH, MLA_CACHE, MLA_KV, MLA_REL_L2_TOL = 4, 32150, 32100, 4e-3
# Phase 20: the MoE slot kernel at the benchmark cells' calls, a name each:
# (arch, tokens a call); and at (tokens, k, experts) on the edges of its
# chunk of 4096 choices, at its 256 experts and at jamba's 16 of top-2.
SLOT_CALLS = {
    "deepseek-moe-16b decode step": ("deepseek-moe-16b", 32),
    "deepseek-v2-lite decode step": ("deepseek-v2-lite", 4),
    "granite-moe-1b-a400m train pod": ("granite-moe-1b-a400m", 2 * 512),
    "deepseek-moe-16b.decode prefill": ("deepseek-moe-16b", 32 * 550),
    "deepseek-moe-16b.prefill prefill": ("deepseek-moe-16b", 16 * 4088),
    "deepseek-v2-lite prefill": ("deepseek-v2-lite", 4 * 32000),
}
SLOT_EDGES = ((1, 1, 256), (4095, 1, 256), (4096, 1, 256), (4097, 1, 256), (8191, 1, 64), (8192, 1, 64),
              (8193, 1, 64), (2048, 2, 16), (2049, 2, 16))

# The leaves that a bf16 model keeps in fp32 (the mLSTM's input and forget
# gates, the sLSTM's gate biases): AdamW must leave them fp32.
FP32_LEAF = re.compile(r"/(i_gate|f_gate)/|/g_[ifzo]/b$")

# T-full's and M-train's ms an iteration (a range of two runs) and peak GB
# on the torch backend, one step at a time (PERF.md, section 5).
TORCH_BACKEND_TRAIN = {"T-full": (429.83, 432.08, 55.06), "M-train": (796.77, 1016.39, 59.26)}

# NVIDIA data-sheet peaks, dense: device memory bytes/s; bf16 tensor-core,
# and fp32 CUDA-core, operations/s.
PEAKS = {
    "H100 SXM": {"bytes": 3.35e12, "bf16": 989e12, "fp32": 67e12},
    "H100 PCIe": {"bytes": 2.0e12, "bf16": 756e12, "fp32": 51e12},
}


def ptxas_report(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill-store bytes, spill-load bytes) for each kernel
    of an ``nvcc -Xptxas -v`` log; rmsnorm's instances are named by their
    template arguments (dtype, elements a load, loads a thread)."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            if t := re.search(r"rmsnorm_kernelI(\w+?)Li(\d+)ELi(\d+)E", name):
                dt = "bf16" if "bfloat16" in t.group(1) else "fp32"
                name = f"rmsnorm_kernel<{dt}, vec {t.group(2)}, n {t.group(3)}>"
            elif "empty_kernel" in name:
                name = "empty_kernel"
            out.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sku_of(name: str) -> str:
    return "H100 PCIe" if "PCIe" in name else "H100 SXM"


class Bench:
    """CUDA-event timing of one launch at a time, with L2 flushed before each."""

    def __init__(self, torch, sku: str):
        self.torch = torch
        self.peak = PEAKS[sku]
        # 512 MiB: far past the 50 MB L2, and zeroing it keeps the card busy
        # while the host enqueues the timed call, so host overhead is not timed.
        self.flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 25) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(self, nbytes: float, ops: float, rate: str) -> tuple[float, str]:
        """Least time in ms: bytes over the memory rate vs ops over ``rate``."""
        t_bytes = nbytes / self.peak["bytes"] * 1e3
        t_ops = ops / self.peak[rate] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def us(ms: float) -> str:
    """A time in ms, printed in microseconds to three significant digits."""
    return f"{ms * 1e3:.3g} us"


def host_us(torch, fn, calls: int = 1000, loops: int = 5) -> float:
    """Host microseconds a call: ``calls`` calls enqueued on a synced card,
    over ``calls``; the median of ``loops`` such loops."""
    fn()
    times = []
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def rel_l2(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def leaf_rel_l2(got, want) -> list:
    """Each gradient leaf's relative L2 distance from ``want``'s.  A leaf whose
    gradient in ``want`` is under LEAF_FLOOR of the whole gradient's norm is
    rounding noise around zero, and its distance is taken as a share of the
    whole gradient's norm instead."""
    norms = [float(b.float().norm()) for b in want]
    whole = sum(n * n for n in norms) ** 0.5
    return [float((a.float() - b.float()).norm()) / (n if n >= LEAF_FLOOR * whole else whole)
            for a, b, n in zip(got, want, norms)]


def close(got, want, tol: float) -> tuple[float, bool]:
    """Max abs error, and whether every element is finite and within
    ``tol`` abs + ``tol`` relative of ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) and bool(got.isfinite().all())
    return float(err.max()), ok


def check_close(name: str, got, want, tol: float) -> float:
    mx, ok = close(got, want, tol)
    print(f"  {name}: max_abs_err {mx:.3e} (tol {tol:g} abs + rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return mx


def flex_softcap_kwargs(q, k, *, softcap: float, window: int, q_offset: int, kv_len: int) -> dict:
    """The arguments that make ``flex_attention(q, k, v, **kwargs)`` compute
    gemma2's attention (``q`` [B, Hq, Lq, d], ``k`` [B, Hkv, Lk, d]): the
    logit softcap as its score_mod; causal, window and ``kv_len`` as its
    block mask, made here once, as a model would make it once for all layers
    of a shape."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask

    def score_mod(s, b, h, qi, ki):
        return torch.tanh(s / softcap) * softcap

    def mask_mod(b, h, qi, ki):
        t = qi + q_offset
        return (ki <= t) & (t - ki < window) & (ki < kv_len)

    mask = create_block_mask(mask_mod, None, None, q.shape[2], k.shape[2], device=q.device)
    return {"score_mod": score_mod, "block_mask": mask, "enable_gqa": True}


def phase_kernels(torch, bench: Bench) -> dict:
    """Phase 3: each kernel against its plain version; times and bounds.

    Returns ``{kernel: [row, ...]}``, a row for each timed shape, the first
    at the serving shape; each row carries the kernel's max abs error over
    this phase's bf16 and fp32 checks.
    """
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as decode_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention, split_chunk
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels import rmsnorm as rms_module
    from repro_torch.kernels.rmsnorm import plan as rms_plan
    from repro_torch.kernels.rmsnorm import rmsnorm

    # As TOL in tests/test_kernels.py: fp32 sums in another order; a bf16
    # output can round to the neighbouring value (one ulp is 2^-8 relative).
    TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    g = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"
    B, HQ, HKV, D, DM = 4, 24, 8, 128, 3072
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def i32(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)

    def poisoned(x, kv, value):
        """x [B, M, H, d] with rows at or past kv set to ``value``."""
        x = x.clone()
        x[:, kv:] = value
        return x

    errs = {"rmsnorm": {}, "flash_attention": {}, "decode_attention": {}}
    rels = {"flash_attention": [0.0, float("inf")], "decode_attention": [0.0, float("inf")]}

    def check(kernel, name, got, want, dtype, fp32=None):
        """Element-wise against ``want``; for a bf16 attention case also by
        relative L2 against ``fp32 = (want32, fault)``: the plain version in
        fp32 on the same inputs, and the reading of a planted fault."""
        e = check_close(name, got, want, TOL[dtype])
        key = str(dtype)[6:]
        errs[kernel][key] = max(errs[kernel].get(key, 0.0), e)
        if fp32 is None:
            return
        want32, fault = fp32
        r = rel_l2(got, want32)
        ok = r <= ATTN_REL_L2_TOL < fault
        print(f"    rel L2 to fp32 {r:.3e}, with one tile's P.V left out {fault:.3e} "
              f"(tol {ATTN_REL_L2_TOL:g} between them) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: relative L2 check failed or cannot tell a missing tile")
        rels[kernel] = [max(rels[kernel][0], r), min(rels[kernel][1], fault)]

    def fp32_refs(plain, v, kv, dtype):
        """``plain(v)`` in fp32, and its distance to ``plain`` of v with the
        rows of one 64-key tile zeroed (the tile holding live key (kv - 1) // 2;
        v is [B, H, L, d]).  None unless bf16 with a live key."""
        if dtype != torch.bfloat16 or kv == 0:
            return None
        v32 = v.float()
        want32 = plain(v32)
        t0 = (kv - 1) // 2 // 64 * 64
        vf = v32.clone()
        vf[:, :, t0:t0 + 64] = 0
        return want32, rel_l2(plain(vf), want32)

    print("[3] kernels vs plain versions")
    # -- rmsnorm: widths of the zoo and two ragged ones (1001 and 3 take the
    # scalar path; 1000 is 125 bf16 pieces of 16 bytes, the vector path with
    # a part-idle last round), row counts that leave the last block ragged,
    # and x and y as contiguous rows, as rows of stride d + 8 and as views
    # one element off 16-byte alignment (the scalar path).  y's buffer is
    # filled with 7 first: what lies outside the view must keep it.
    def rms_case(rows, d, layout, dtype):
        if layout == "contiguous":
            x = randn(rows, d, dtype=dtype)
            buf = torch.full((rows, d), 7.0, dtype=dtype, device=dev)
            return x, buf, buf, None
        if layout == "row stride d+8":
            x = randn(rows, d + 8, dtype=dtype)[:, :d]
            buf = torch.full((rows, d + 8), 7.0, dtype=dtype, device=dev)
            return x, buf, buf[:, :d], buf[:, d:]
        x = randn(rows * d + 1, dtype=dtype)[1:].view(rows, d)
        buf = torch.full((rows * d + 1,), 7.0, dtype=dtype, device=dev)
        return x, buf, buf[1:].view(rows, d), buf[:1]

    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype)[6:]
        for d in RMS_WIDTHS:
            w = randn(d, dtype=dtype) * 0.1
            worst, cases = 0.0, 0
            for rows in RMS_ROWS:
                for layout in ("contiguous", "row stride d+8", "one element off 16 B"):
                    x, buf, out, rest = rms_case(rows, d, layout, dtype)
                    got = rmsnorm(x, w, out=out)
                    e, ok = close(got, ref.rmsnorm_ref(x, w), TOL[dtype])
                    if got.data_ptr() != out.data_ptr() or (rest is not None and not bool((rest == 7).all())):
                        ok = False
                    if not ok:
                        fail(f"rmsnorm {key} [{rows}, {d}] {layout}: max abs err {e:.3e} "
                             f"(tol {TOL[dtype]:g}), or it wrote outside its output")
                    worst, cases = max(worst, e), cases + 1
            # One row of NaN and one of inf, in blocks that hold other rows
            # (a block holds 4 rows at d <= 1024 and 2 at d <= 2048): every
            # other row must still match and stay finite.
            x = randn(33, d, dtype=dtype)
            x[5, 0], x[6, d // 2] = float("nan"), float("inf")
            got, want = rmsnorm(x, w), ref.rmsnorm_ref(x, w)
            keep = [i for i in range(33) if i not in (5, 6)]
            e, ok = close(got[keep], want[keep], TOL[dtype])
            if not ok:
                fail(f"rmsnorm {key} d={d}: a NaN or inf row reached another row (max abs err {e:.3e})")
            worst = max(worst, e)
            p = rms_plan(d, dtype)
            print(f"  rmsnorm {key} d={d} (aligned: {p}): {cases} cases (rows x layouts), "
                  f"NaN/inf rows kept apart: max abs err {worst:.3e} (tol {TOL[dtype]:g}) ok")
            errs["rmsnorm"][key] = max(errs["rmsnorm"].get(key, 0.0), worst)
        del x, buf, out, got, want

    # -- flash: model layout (strided views) over a cache whose rows at or past
    # kv_len hold 1e9, inf or nan; the plain version reads the clean cache, so
    # any leak of a poisoned row shows.
    POISON = (1e9, float("inf"), float("nan"))
    cases = [(256, lq, off, dt) for dt in (torch.bfloat16, torch.float32) for lq in (128, 100) for off in (0, 37)]
    cases += [(2304, 2048, 0, torch.bfloat16), (2304, 2000, 37, torch.bfloat16)]
    for m, lq, off, dtype in cases:
        kv = off + lq
        q = randn(B, lq, HQ, D, dtype=dtype)
        k = randn(B, m, HKV, D, dtype=dtype)
        v = randn(B, m, HKV, D, dtype=dtype)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        want = ref.flash_attention_ref(qt, kt, vt, causal=True, kv_len=kv, q_offset=off)
        fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(qt.float(), kt.float(), vv, causal=True, kv_len=kv,
                                                            q_offset=off), vt, kv, dtype)
        for value in POISON:
            kp, vp = poisoned(k, kv, value), poisoned(v, kv, value)
            got = flash_attention(qt, kp.transpose(1, 2), vp.transpose(1, 2), causal=True,
                                  kv_len=i32(kv), q_offset=i32(off))
            check("flash_attention", f"flash {str(dtype)[6:]} Lq={lq} q_offset={off} kv_len={kv} "
                  f"cache {m} (strided, poison {value:g})", got, want, dtype, fp32)
        del q, k, v, qt, kt, vt, want, kp, vp, got, fp32
    for dtype in (torch.bfloat16, torch.float32):
        # contiguous [B, H, L, d] inputs, int lengths
        q = randn(B, HQ, 100, D, dtype=dtype)
        k = randn(B, HKV, 137, D, dtype=dtype)
        v = randn(B, HKV, 137, D, dtype=dtype)
        got = flash_attention(q, k, v, causal=True, kv_len=137, q_offset=37)
        want = ref.flash_attention_ref(q, k, v, causal=True, kv_len=137, q_offset=37)
        fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(q.float(), k.float(), vv, causal=True, kv_len=137,
                                                            q_offset=37), v, 137, dtype)
        check("flash_attention", f"flash {str(dtype)[6:]} contiguous Lq=100 q_offset=37", got, want, dtype, fp32)

    # -- flash and decode at the serving shapes of phases 10 and 11: a
    # prefill of PROMPT_LEN rows over a cache of PROMPT_LEN + GEN, and decode
    # at every kv_len edge of that cache; model layout, poisoned past kv_len.
    for arch, (hq, hkv, d, prefix) in SERVE_ATTN.items():
        lq = prefix + PROMPT_LEN
        m = lq + GEN
        for dtype in (torch.bfloat16, torch.float32):
            q = randn(B, lq, hq, d, dtype=dtype)
            k = randn(B, m, hkv, d, dtype=dtype)
            v = randn(B, m, hkv, d, dtype=dtype)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            want = ref.flash_attention_ref(qt, kt, vt, causal=True, kv_len=lq)
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(qt.float(), kt.float(), vv, causal=True,
                                                                kv_len=lq), vt, lq, dtype)
            for value in POISON:
                kp, vp = poisoned(k, lq, value), poisoned(v, lq, value)
                got = flash_attention(qt, kp.transpose(1, 2), vp.transpose(1, 2), causal=True,
                                      kv_len=i32(lq), q_offset=i32(0))
                check("flash_attention", f"flash {str(dtype)[6:]} {arch} B{B} Hq{hq} Hkv{hkv} d{d} "
                      f"Lq={lq} cache {m} (strided, poison {value:g})", got, want, dtype, fp32)
            chunk = split_chunk(m, B, hkv, sms)
            qd = randn(B, hq, d, dtype=dtype)
            for kv in sorted({1, chunk - 1, chunk, chunk + 1, lq + 1, m - 1, m} & set(range(1, m + 1))):
                want = ref.decode_attention_ref(qd, kt, vt, kv)
                fp32 = fp32_refs(lambda vv: ref.decode_attention_ref(qd.float(), kt.float(), vv, kv), vt, kv, dtype)
                for value in POISON:
                    kp, vp = poisoned(k, kv, value), poisoned(v, kv, value)
                    got = decode_attention(qd, kp.transpose(1, 2), vp.transpose(1, 2), i32(kv))
                    check("decode_attention", f"decode {str(dtype)[6:]} {arch} cache [{B}, {m}, {hkv}, {d}] "
                          f"({-(-m // chunk)} splits of {chunk}) kv_len={kv} poison {value:g}", got, want, dtype, fp32)
        del q, k, v, qt, kt, vt, qd, want, kp, vp, got, fp32

    # -- flash where the decode kernel does not go: gemma2's softcap and window,
    # at a prompt past the window (batch 1) and at its serving prompt, and
    # at decode steps of one query row (q_offset = kv_len - 1, the window past
    # it from kv_len 4097 on), over caches poisoned past kv_len; seamless's
    # non-causal encoder (1024 frames) and cross-attention (its prefill and a
    # step against the 1024 frames), in the model's layout.
    ga, sa = GEMMA_ATTN, SEAMLESS_ATTN
    gkw = dict(causal=True, window=ga["window"], softcap=ga["softcap"])
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype)[6:]
        for b_, lq, m in ((1, *GEMMA_LONG), (B, PROMPT_LEN, PROMPT_LEN + GEN), (B, TRAIN_SEQ, TRAIN_SEQ)):
            q = randn(b_, lq, ga["hq"], ga["d"], dtype=dtype)
            k = randn(b_, m, ga["hkv"], ga["d"], dtype=dtype)
            v = randn(b_, m, ga["hkv"], ga["d"], dtype=dtype)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            want = ref.flash_attention_ref(qt, kt, vt, kv_len=lq, **gkw)
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(qt.float(), kt.float(), vv, kv_len=lq, **gkw),
                             vt, lq, dtype)
            for value in POISON:
                kp, vp = poisoned(k, lq, value), poisoned(v, lq, value)
                got = flash_attention(qt, kp.transpose(1, 2), vp.transpose(1, 2), kv_len=i32(lq), q_offset=i32(0),
                                      **gkw)
                check("flash_attention", f"flash {key} gemma2 B{b_} Hq{ga['hq']} Hkv{ga['hkv']} d{ga['d']} "
                      f"softcap {ga['softcap']:g} window {ga['window']} Lq={lq} cache {m} (strided, poison "
                      f"{value:g})", got, want, dtype, fp32)
            del q, k, v, qt, kt, vt, want, kp, vp, got, fp32
        m = GEMMA_STEP_CACHE
        k = randn(B, m, ga["hkv"], ga["d"], dtype=dtype)
        v = randn(B, m, ga["hkv"], ga["d"], dtype=dtype)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        q = randn(B, 1, ga["hq"], ga["d"], dtype=dtype)
        qt = q.transpose(1, 2)
        w = ga["window"]
        for kv in (1, PROMPT_LEN + 1, PROMPT_LEN + GEN, w, w + 1, m):
            want = ref.flash_attention_ref(qt, kt, vt, kv_len=kv, q_offset=kv - 1, **gkw)
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(qt.float(), kt.float(), vv, kv_len=kv,
                                                                q_offset=kv - 1, **gkw), vt, kv, dtype)
            for value in POISON:
                kp, vp = poisoned(k, kv, value), poisoned(v, kv, value)
                got = flash_attention(qt, kp.transpose(1, 2), vp.transpose(1, 2), kv_len=i32(kv),
                                      q_offset=i32(kv - 1), **gkw)
                check("flash_attention", f"flash {key} gemma2 decode step Lq=1 B{B} cache {m} kv_len={kv} "
                      f"q_offset={kv - 1} (poison {value:g})", got, want, dtype, fp32)
        del q, k, v, qt, kt, vt, want, kp, vp, got
        kv = randn(2, B, sa["frames"], sa["h"], sa["d"], dtype=dtype)
        kt, vt = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
        for lq, what in ((sa["frames"], "encoder"), (PROMPT_LEN, "cross prefill"), (1, "cross step")):
            q = randn(B, lq, sa["h"], sa["d"], dtype=dtype)
            qt = q.transpose(1, 2)
            want = ref.flash_attention_ref(qt, kt, vt, causal=False)
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(qt.float(), kt.float(), vv, causal=False), vt,
                             sa["frames"], dtype)
            check("flash_attention", f"flash {key} seamless {what} non-causal B{B} H{sa['h']} d{sa['d']} Lq={lq} "
                  f"Lk={sa['frames']} (strided)", flash_attention(qt, kt, vt, causal=False), want, dtype, fp32)
        del kv, kt, vt, q, qt, want

    # -- decode: poisoned caches with one split and many ------------------------
    for dtype in (torch.bfloat16, torch.float32):
        for m in (2048, 160, 64):
            chunk = split_chunk(m, B, HKV, sms)
            splits = -(-m // chunk)
            q = randn(B, HQ, D, dtype=dtype)
            k = randn(B, m, HKV, D, dtype=dtype)
            v = randn(B, m, HKV, D, dtype=dtype)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            for kv in sorted({0, 1, chunk - 1, chunk, chunk + 1, m - 1, m} & set(range(m + 1))):
                # kv_len 0: no live key, and the kernel gives 0 (the plain
                # softmax would average every row).
                want = torch.zeros_like(q) if kv == 0 else ref.decode_attention_ref(q, kt, vt, kv)
                fp32 = fp32_refs(lambda vv: ref.decode_attention_ref(q.float(), kt.float(), vv, kv), vt, kv, dtype)
                for value in POISON:
                    kp, vp = poisoned(k, kv, value), poisoned(v, kv, value)
                    got = decode_attention(q, kp.transpose(1, 2), vp.transpose(1, 2), i32(kv))
                    check("decode_attention", f"decode {str(dtype)[6:]} cache [{B}, {m}, {HKV}, {D}] "
                          f"({splits} splits of {chunk}) kv_len={kv} poison {value:g}", got, want, dtype, fp32)

    # -- decode on two streams at once, each merging through its own counters.
    # The same calls with one set of counters for both streams (a planted
    # fault) must disagree, or the check could not see a shared set.
    m = 2048
    k = randn(B, m, HKV, D, dtype=torch.bfloat16).transpose(1, 2)
    v = randn(B, m, HKV, D, dtype=torch.bfloat16).transpose(1, 2)
    qs = [randn(B, HQ, D, dtype=torch.bfloat16) for _ in range(2)]
    kvs = [m, 1000]
    lens = [i32(n) for n in kvs]
    wants = [ref.decode_attention_ref(qq, k, v, n) for qq, n in zip(qs, kvs)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    main = torch.cuda.current_stream()

    def two_streams(calls=16):
        outs = [[], []]
        # Hold both streams behind ~10 ms of spinning on the card, so the host
        # queues every call before any runs and the two streams' calls overlap.
        torch.cuda._sleep(20_000_000)
        for s in streams:
            s.wait_stream(main)
        for _ in range(calls):
            for i, s in enumerate(streams):
                with torch.cuda.stream(s):
                    outs[i].append(decode_attention(qs[i], k, v, lens[i]))
        for s in streams:
            main.wait_stream(s)
        return [torch.stack(o) for o in outs]

    for i, got in enumerate(two_streams()):
        check("decode_attention", f"decode bf16 kv 2048 on stream {i} of 2, 16 calls each interleaved, "
              f"kv_len={kvs[i]}", got, wants[i].expand_as(got), torch.bfloat16)

    class OneSet(dict):  # every (device, stream) gets the same counters
        def get(self, key, default=None):
            return super().get(key[0], default)

        def __setitem__(self, key, value):
            super().__setitem__(key[0], value)

    saved, decode_module._counters = decode_module._counters, OneSet()
    try:
        outs = two_streams()
    finally:
        decode_module._counters = saved
    tol = TOL[torch.bfloat16]
    wrong = sum(
        not bool(((o.float() - w.float()).abs() <= tol + tol * w.float().abs()).all())
        for got, w in zip(outs, wants) for o in got
    )
    print(f"  planted fault, one set of counters for both streams: {wrong} of 32 calls disagree")
    if wrong == 0:
        fail("the two-stream decode check cannot tell counters shared by the streams")
    del k, v, qs, wants, outs, got

    # -- the kernels' other options and head dims, at test_kernels.py's shapes --
    for dtype in (torch.bfloat16, torch.float32):
        for kw in ({"window": 32}, {"softcap": 20.0}, {"causal": False}, {"kv_len": 77}):
            q, k, v = randn(2, 4, 64, 64, dtype=dtype), randn(2, 2, 128, 64, dtype=dtype), randn(2, 2, 128, 64, dtype=dtype)
            kw = {"causal": True, **kw}
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(q.float(), k.float(), vv, **kw), v,
                             kw.get("kv_len", 128), dtype)
            check("flash_attention", f"flash {str(dtype)[6:]} d=64 {kw}", flash_attention(q, k, v, **kw),
                  ref.flash_attention_ref(q, k, v, **kw), dtype, fp32)
        # Groups of 1, 3 and 8 query heads: at d = 64 the bf16 kernel takes 8
        # as three passes of three heads (the last with one warpgroup idle),
        # at d = 192 as four passes of two.
        for d, hq, hkv in ((192, 3, 1), (192, 8, 1), (192, 2, 2), (64, 8, 1)):
            q, k, v = randn(1, hq, 192, d, dtype=dtype), randn(1, hkv, 192, d, dtype=dtype), randn(1, hkv, 192, d, dtype=dtype)
            fp32 = fp32_refs(lambda vv: ref.flash_attention_ref(q.float(), k.float(), vv), v, 192, dtype)
            check("flash_attention", f"flash {str(dtype)[6:]} d={d} Hq={hq} Hkv={hkv}", flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v), dtype, fp32)
        for d in (64, 192):
            q, k, v = randn(1, 14, d, dtype=dtype), randn(1, 2, 256, d, dtype=dtype), randn(1, 2, 256, d, dtype=dtype)
            fp32 = fp32_refs(lambda vv: ref.decode_attention_ref(q.float(), k.float(), vv, 100), v, 100, dtype)
            check("decode_attention", f"decode {str(dtype)[6:]} d={d} GQA 7:1 kv_len=100",
                  decode_attention(q, k, v, 100), ref.decode_attention_ref(q, k, v, 100), dtype, fp32)
    # bf16 max abs errors of the kernels before the Hopper redesign (CUDA cores only)
    before = {"rmsnorm": 7.8e-3, "flash_attention": 3.9e-3, "decode_attention": 6.1e-5}
    for name, e in errs.items():
        rel = ""
        if name in rels:
            rel = (f"; bf16 rel L2 to fp32 at most {rels[name][0]:.3e}, a planted missing tile at least "
                   f"{rels[name][1]:.3e} (tol {ATTN_REL_L2_TOL:g})")
        print(f"[3] {name}: max abs err bf16 {e['bfloat16']:.3e} (before the redesign: {before[name]:.1e}), "
              f"fp32 {e['float32']:.3e}{rel}")

    # -- times at the serving shapes and at 2048 (bf16) ------------------------
    print("[3] times, bf16 unless marked fp32, cold L2 (median of 25 launches), in us")
    bf, es = torch.bfloat16, 2
    cache_len = PROMPT_LEN + GEN
    rows = {"rmsnorm": [], "flash_attention": [], "decode_attention": []}

    def record(kernel, shape, fn, plain, lib, nbytes, ops, rate, floor=None):
        """Times ``fn`` (the kernel), ``plain`` and ``lib``, and ``floor`` (an
        empty kernel on the same grid) if given."""
        t = bench.ms(fn)
        tp = bench.ms(plain)
        tl = bench.ms(lib)
        tf = bench.ms(floor) if floor is not None else None
        b, by = bench.bound(nbytes, ops, rate)
        lib_s = f"{us(tl)}, kernel/library {t / tl:.3g}x"
        floor_s = f"; launch floor on its grid {us(tf)}, kernel - floor {us(t - tf)}" if tf is not None else ""
        print(
            f"  {kernel} {shape}: kernel {us(t)}, plain {us(tp)}, library {lib_s}; "
            f"bound {us(b)} ({by}), {b / t:.3g} of bound{floor_s}"
        )
        rows[kernel].append({
            "shape": shape, "ms": t, "plain_ms": tp, "library_ms": tl, "bound_ms": b,
            "bound_by": by, "max_abs_err": max(errs[kernel].values()), "launch_floor_ms": tf,
        })

    empty = rms_module.EMPTY.fn()
    for n, dm in RMS_SHAPES:
        x = randn(n, dm, dtype=bf)
        w = randn(dm, dtype=bf) * 0.1
        w1 = 1.0 + w
        _, args = rms_module.launch_args(x, w)
        record(
            "rmsnorm", f"[{n}, {dm}]",
            lambda: rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
            lambda: F.rms_norm(x, (dm,), weight=w1, eps=1e-6),
            (2 * n * dm + dm) * es, 4 * n * dm, "fp32", floor=lambda: empty(*args),
        )
    # The data plane's shapes in its own dtype, fp32 (phase 7).
    for n, dm in DP_SHAPES.values():
        x = randn(n, dm, dtype=torch.float32)
        w = randn(dm, dtype=torch.float32) * 0.1
        w1 = 1.0 + w
        _, args = rms_module.launch_args(x, w)
        record(
            "rmsnorm", f"[{n}, {dm}] fp32",
            lambda: rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
            lambda: F.rms_norm(x, (dm,), weight=w1, eps=1e-6),
            (2 * n * dm + dm) * 4, 4 * n * dm, "fp32", floor=lambda: empty(*args),
        )
    # The launch floor alone: the empty kernel on one block (the grid of one
    # row at d 3072), launched through the same ctypes route.
    x, w = randn(BATCH, DM, dtype=bf), randn(DM, dtype=bf) * 0.1
    _, args = rms_module.launch_args(x[:1], w)
    floor = bench.ms(lambda: empty(*args))
    print(f"  launch floor: an empty kernel, 1 block, through ctypes: {us(floor)}")
    rows["rmsnorm"][1]["launch_floor_1_block_ms"] = floor
    # The wrapper's host cost: 1000 calls enqueued on a synced card, over 1000;
    # beside it the same launch through ctypes alone, and the empty kernel's.
    y, args = rms_module.launch_args(x, w)
    kern = rms_module.LAUNCH.fn()
    host = {
        "wrapper": host_us(torch, lambda: rmsnorm(x, w)),
        "ctypes launch": host_us(torch, lambda: kern(*args)),
        "ctypes empty launch": host_us(torch, lambda: empty(*args)),
    }
    print(f"  rmsnorm [{BATCH}, {DM}] host time a call (median of 5 loops of 1000 calls): "
          + ", ".join(f"{k} {v:.3g} us" for k, v in host.items()))
    rows["rmsnorm"][1]["host_us"] = host

    # prefill: q [B, L, 24, 128] against the layer's cache [B, L + GEN, 8, 128]
    # at the serving prompt, and at a 2048-token prompt, where the tensor
    # cores' operations bound it.
    for lq in (PROMPT_LEN, 2048):
        q = randn(B, lq, HQ, D, dtype=bf).transpose(1, 2)
        k = randn(B, lq + GEN, HKV, D, dtype=bf).transpose(1, 2)
        v = randn(B, lq + GEN, HKV, D, dtype=bf).transpose(1, 2)
        off, kv = i32(0), i32(lq)
        live = lq * (lq + 1) // 2  # causal keys over the rows
        record(
            "flash_attention", f"B{B} Hq{HQ} Hkv{HKV} d{D} Lq=kv={lq}",
            lambda: flash_attention(q, k, v, causal=True, kv_len=kv, q_offset=off),
            lambda: ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv, q_offset=off),
            lambda: F.scaled_dot_product_attention(
                q, k[:, :, :lq], v[:, :, :lq], is_causal=True, enable_gqa=True
            ),
            (2 * B * HQ * lq + 2 * B * HKV * lq) * D * es,
            4 * D * B * HQ * live, "bf16",
        )
        del q, k, v

    # decode: one row against the cache, at the last step's length and at 2048
    for m in (cache_len, 2048):
        q = randn(B, HQ, D, dtype=bf)
        k = randn(B, m, HKV, D, dtype=bf).transpose(1, 2)
        v = randn(B, m, HKV, D, dtype=bf).transpose(1, 2)
        kv = i32(m)
        record(
            "decode_attention", f"B{B} Hq{HQ} Hkv{HKV} d{D} kv={m}",
            lambda: decode_attention(q, k, v, kv),
            lambda: ref.decode_attention_ref(q, k, v, kv),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, enable_gqa=True),
            (2 * B * HQ + 2 * B * HKV * m) * D * es, 4 * D * B * HQ * m, "bf16",
        )

    # The serving shapes of phases 10 and 11: each norm of a prefill and of a
    # decode step, the prefill's flash and the last decode step's attention.
    for arch, dm in SERVE_WIDTHS.items():
        for n in (BATCH * PROMPT_LEN, BATCH):
            x = randn(n, dm, dtype=bf)
            w = randn(dm, dtype=bf) * 0.1
            w1 = 1.0 + w
            record(
                "rmsnorm", f"[{n}, {dm}] ({arch})",
                lambda: rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
                lambda: F.rms_norm(x, (dm,), weight=w1, eps=1e-6),
                (2 * n * dm + dm) * es, 4 * n * dm, "fp32",
            )
    # The norms of phase 13's training cells: a forward's rows at xlstm's and
    # gemma2's widths.
    for arch, dm in (("xlstm-125m", 768), ("gemma2-27b", 4608)):
        n = TRAIN_BATCH * TRAIN_SEQ
        x = randn(n, dm, dtype=bf)
        w = randn(dm, dtype=bf) * 0.1
        w1 = 1.0 + w
        record(
            "rmsnorm", f"[{n}, {dm}] ({arch} training)",
            lambda: rmsnorm(x, w), lambda: ref.rmsnorm_ref(x, w),
            lambda: F.rms_norm(x, (dm,), weight=w1, eps=1e-6),
            (2 * n * dm + dm) * es, 4 * n * dm, "fp32",
        )
    for arch, (hq, hkv, d, prefix) in SERVE_ATTN.items():
        lq = prefix + PROMPT_LEN
        q = randn(B, lq, hq, d, dtype=bf).transpose(1, 2)
        k = randn(B, lq + GEN, hkv, d, dtype=bf).transpose(1, 2)
        v = randn(B, lq + GEN, hkv, d, dtype=bf).transpose(1, 2)
        off, kv = i32(0), i32(lq)
        record(
            "flash_attention", f"B{B} Hq{hq} Hkv{hkv} d{d} Lq=kv={lq} ({arch})",
            lambda: flash_attention(q, k, v, causal=True, kv_len=kv, q_offset=off),
            lambda: ref.flash_attention_ref(q, k, v, causal=True, kv_len=kv, q_offset=off),
            lambda: F.scaled_dot_product_attention(
                q, k[:, :, :lq], v[:, :, :lq], is_causal=True, enable_gqa=True
            ),
            (2 * B * hq * lq + 2 * B * hkv * lq) * d * es,
            4 * d * B * hq * (lq * (lq + 1) // 2), "bf16",
        )
        m = lq + GEN
        qd = randn(B, hq, d, dtype=bf)
        kd = randn(B, m, hkv, d, dtype=bf).transpose(1, 2)
        vd = randn(B, m, hkv, d, dtype=bf).transpose(1, 2)
        kvd = i32(m)
        record(
            "decode_attention", f"B{B} Hq{hq} Hkv{hkv} d{d} kv={m} ({arch})",
            lambda: decode_attention(qd, kd, vd, kvd),
            lambda: ref.decode_attention_ref(qd, kd, vd, kvd),
            lambda: F.scaled_dot_product_attention(qd[:, :, None], kd, vd, enable_gqa=True),
            (2 * B * hq + 2 * B * hkv * m) * d * es, 4 * d * B * hq * m, "bf16",
        )
        del q, k, v, qd, kd, vd

    # gemma2: flash at its long prompt (batch 1), its serving prompt and a
    # decode step (Lq = 1 over the last step's cache).  The library's call is
    # FlexAttention, compiled, with the softcap as its score_mod and the mask
    # as its block mask; its output is held against the plain version first,
    # within ATTN_REL_L2_TOL, so that it is known to compute the same function.
    # The bound counts the keys each row sees: min(t + 1, window) for row t.
    from torch.nn.attention.flex_attention import flex_attention

    w = ga["window"]
    # And at TR-gemma2's training shape (phase 13), B4 Lq = kv = 512, where the
    # window does not bite.
    for b_, lq, m, off in ((1, *GEMMA_LONG, 0), (B, PROMPT_LEN, cache_len, 0), (B, 1, cache_len, cache_len - 1),
                           (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 0)):
        q = randn(b_, lq, ga["hq"], ga["d"], dtype=bf).transpose(1, 2)
        k = randn(b_, m, ga["hkv"], ga["d"], dtype=bf).transpose(1, 2)
        v = randn(b_, m, ga["hkv"], ga["d"], dtype=bf).transpose(1, 2)
        kv, offs = i32(off + lq), i32(off)
        live = sum(min(off + t + 1, w) for t in range(lq))
        keys = min(off + lq, w + lq - 1)  # the rows of k and v that any query row sees
        shape = (f"B{b_} Hq{ga['hq']} Hkv{ga['hkv']} d{ga['d']} softcap {ga['softcap']:g} window {w} "
                 f"Lq={lq} kv={off + lq} (gemma2)")
        fkw = flex_softcap_kwargs(q, k, softcap=ga["softcap"], window=w, q_offset=off, kv_len=off + lq)
        # One compiled function a shape.  At Lq = 1 its host cost can outlast
        # the L2 flush that hides the host, so its reading varies by run.
        flex = torch.compile(flex_attention, dynamic=False)
        lib = lambda: flex(q, k, v, **fkw)  # noqa: E731
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), kv_len=off + lq, q_offset=off, **gkw)
        t0 = time.monotonic()
        lib_rel = rel_l2(lib(), want)
        print(f"  library (FlexAttention, compiled in {time.monotonic() - t0:.1f} s) {shape}: rel L2 to the "
              f"fp32 plain version {lib_rel:.3e} (tol {ATTN_REL_L2_TOL:g})")
        if not lib_rel <= ATTN_REL_L2_TOL:
            fail(f"FlexAttention at {shape} does not compute the plain version's function: rel L2 {lib_rel}")
        record(
            "flash_attention", shape,
            lambda: flash_attention(q, k, v, kv_len=kv, q_offset=offs, **gkw),
            lambda: ref.flash_attention_ref(q, k, v, kv_len=kv, q_offset=offs, **gkw),
            lib, (2 * b_ * ga["hq"] * lq + 2 * b_ * ga["hkv"] * keys) * ga["d"] * es,
            4 * ga["d"] * b_ * ga["hq"] * live, "bf16",
        )
        del q, k, v, want, lib, fkw, flex
    # seamless: the encoder's non-causal attention over its 1024 frames, and
    # the cross-attention's prefill and step against them.
    f_ = sa["frames"]
    k = randn(B, f_, sa["h"], sa["d"], dtype=bf).transpose(1, 2)
    v = randn(B, f_, sa["h"], sa["d"], dtype=bf).transpose(1, 2)
    for lq, what in ((f_, "encoder"), (PROMPT_LEN, "cross prefill"), (1, "cross step")):
        q = randn(B, lq, sa["h"], sa["d"], dtype=bf).transpose(1, 2)
        record(
            "flash_attention", f"B{B} H{sa['h']} d{sa['d']} non-causal Lq={lq} Lk={f_} (seamless {what})",
            lambda: flash_attention(q, k, v, causal=False),
            lambda: ref.flash_attention_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(q, k, v),
            (2 * B * sa["h"] * lq + 2 * B * sa["h"] * f_) * sa["d"] * es,
            4 * sa["d"] * B * sa["h"] * lq * f_, "bf16",
        )
    del q, k, v
    return rows


def profile_decode(torch, model, params, prompts, smi: str, steps: int = 8, tag: str = "6",
                   frontend: dict | None = None) -> dict:
    """Phase 6: torch.profiler over ``steps`` greedy decode steps of the kernel path.

    Prints the host's wall time a step (timed without the profiler), the
    device's kernel time a step and so its busy share, and the kernels and host
    operations that take the most time (from a second, profiled run), and
    rmsnorm's rows: its kernel's device time and its wrapper's host time (a
    ``record_function`` span around the wrapper, in the profiled run only).
    Returns those numbers; ``tag`` heads the printed lines, and ``smi``
    (the card's name and power limit) ends them.  ``frontend`` holds the
    model's ``src_embeds`` or ``patch_embeds`` for its prefill.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import rmsnorm as rms_module
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.obs.events import STEP_SPANS

    step = make_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(BATCH, n_prefix(model.cfg) + PROMPT_LEN + 2 * steps + 2)
        torch.cuda.synchronize()
        t0 = time.monotonic()  # a warm prefill: every shape has run before
        _, cache = model.prefill(params, prompts, cache, **(frontend or {}))
        torch.cuda.synchronize()
        prefill_ms = (time.monotonic() - t0) * 1e3
        tok, cache = step(params, cache, prompts[:, -1:])  # warm
        torch.cuda.synchronize()
        t0 = time.monotonic()  # wall time without the profiler's own cost
        for _ in range(steps):
            tok, cache = step(params, cache, tok)
            tok.cpu()  # as serve() does: each token goes to the host
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
        wrapper = rms_module.rmsnorm

        def spanned(*args, **kwargs):
            with record_function("rmsnorm wrapper"):
                return wrapper(*args, **kwargs)

        rms_module.rmsnorm = spanned
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    tok, cache = step(params, cache, tok)
                    tok.cpu()
                torch.cuda.synchronize()
        finally:
            rms_module.rmsnorm = wrapper
    avgs = prof.key_averages()
    # Device-side events only (the kernels and copies themselves): CPU ops
    # also carry their kernels' device time, which would count it twice, and
    # so do the wrapper's span and the program's step spans, which the
    # profiler also draws on the device.
    dev = [
        (e.key, e.device_time_total / 1e3 / steps, e.count / steps)
        for e in avgs if e.device_type == DeviceType.CUDA and e.key not in ("rmsnorm wrapper", *STEP_SPANS)
    ]
    dev.sort(key=lambda d: -d[1])
    busy_ms = sum(d[1] for d in dev)
    n_kernels = sum(d[2] for d in dev)
    print(f"[{tag}] warm prefill, kernel path: {prefill_ms:.3f} ms for {BATCH} x {PROMPT_LEN} tokens  ({smi})")
    print(
        f"[{tag}] decode step, kernel path: wall {wall_ms:.3f} ms a step (unprofiled); "
        f"profiled: {n_kernels:.0f} device ops a step taking {busy_ms:.3f} ms, "
        f"device busy {busy_ms / wall_ms:.1%} of the wall time  ({smi})"
    )
    for key, ms, n in dev[:10]:
        print(f"  {ms:8.4f} ms a step  x{n:<4.0f} {key[:90]}")
    host = sorted(avgs, key=lambda e: -e.self_cpu_time_total)[:6]
    for e in host:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:8.3f} ms a step  x{e.count / steps:<4.0f} {e.key[:80]}")
    rms_dev = [d for d in dev if "rmsnorm_kernel" in d[0]]
    rms_ms, rms_n = sum(d[1] for d in rms_dev), sum(d[2] for d in rms_dev)
    span = [e for e in avgs if e.key == "rmsnorm wrapper" and e.device_type == DeviceType.CPU]
    host_s = "not recorded"
    if span:
        e = span[0]
        host_s = (f"{e.cpu_time_total / 1e3 / steps:.3f} ms a step over {e.count / steps:.0f} calls, "
                  f"{e.cpu_time_total / e.count:.3g} us a call (profiled)")
    print(f"[{tag}] rmsnorm in a decode step: device {rms_ms:.4f} ms over {rms_n:.0f} launches "
          f"({rms_ms / busy_ms:.1%} of device time); host, wrapper span: {host_s}")
    return {"warm_prefill_ms": prefill_ms, "step_wall_ms": wall_ms, "step_device_ops": n_kernels,
            "step_device_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "top_device": [[k[:90], ms, n] for k, ms, n in dev[:10]]}


def dp_pipeline(swirl, make_instance, make_workflow):
    steps = [f"s{i}" for i in range(1, DP_STEPS + 1)]
    ports = [f"p{i}" for i in range(DP_STEPS + 1)]
    deps = []
    for i, s in enumerate(steps):
        deps += [(f"p{i}", s), (s, f"p{i + 1}")]
    inst = make_instance(
        workflow=make_workflow(steps, ports, deps),
        locations=frozenset({"l0"}),
        mapping={s: ("l0",) for s in steps},
        data=frozenset(f"d{i}" for i in range(DP_STEPS + 1)),
        placement={f"d{i}": f"p{i}" for i in range(DP_STEPS + 1)},
        initial_data={"l0": frozenset({"d0"})},
    )
    return swirl.trace(inst).optimize()


def dp_fns(norm, mix):
    return {
        f"s{k + 1}": (
            lambda i, a=f"d{k}", b=f"d{k + 1}", f=(norm if k % 4 == 0 else mix): {b: f(i[a])}
        )
        for k in range(DP_STEPS)
    }


def dp_time(torch, exe, feed) -> tuple[list[float], object]:
    """Wall ms of DP_REPEATS runs after a warm one (each ends in a sync), and
    the last run's result."""
    exe.run(initial_payloads=dict(feed))
    torch.cuda.synchronize()
    times, res = [], None
    for _ in range(DP_REPEATS):
        t0 = time.perf_counter()
        res = exe.run(initial_payloads=dict(feed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, res


def g_setup(torch, inst, device) -> tuple[dict, dict]:
    """1000 Genomes payloads (float32 x G_ELEMS from seed 0) and bodies on
    ``device``: ``s0`` hands out its inputs, every other step sums its
    inputs into a vector of ones (``benchmarks/run.py``'s bodies)."""
    rng = np.random.default_rng(0)
    init = {("l^d", d): torch.from_numpy(rng.random(G_ELEMS).astype(np.float32)).to(device)
            for d in sorted(inst.g("l^d"))}
    fns = {}
    for s in inst.workflow.steps:
        outs = inst.out_data(s)
        if s == "s0":
            fns[s] = lambda i, outs=outs: {o: init[("l^d", o)] for o in outs}
        else:
            fns[s] = lambda i, outs=outs: {
                o: sum(torch.sum(v) for v in i.values()) * torch.ones(G_ELEMS, device=device)
                for o in outs
            }
    return init, fns


def dp_time_pair(torch, exe_a, exe_b, feed) -> tuple[list[float], object, list[float], object]:
    """:func:`dp_time` for two executables in turns (a b, b a, ...), so that
    the host's drift falls on both alike."""
    times = {0: [], 1: []}
    res = {}
    exes = (exe_a, exe_b)
    for i in (0, 1):
        exes[i].run(initial_payloads=dict(feed))
    torch.cuda.synchronize()
    for r in range(DP_REPEATS):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            t0 = time.perf_counter()
            res[i] = exes[i].run(initial_payloads=dict(feed))
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
    return times[0], res[0], times[1], res[1]


def dp_stores_close(torch, name: str, got: dict, want: dict) -> None:
    for loc in want:
        for d, w in want[loc].items():
            g = got[loc][d]
            if not (isinstance(g, torch.Tensor) and g.shape == w.shape and bool(g.isfinite().all())
                    and torch.allclose(g, w.to(g.device), rtol=DP_RTOL, atol=DP_ATOL)):
                fail(f"{name}: store {loc}/{d} disagrees")


def dp_device_split(avgs, cuda) -> dict:
    """Device ms and kernel count of one profiled run, by kind: the rmsnorm
    kernel, copies (memcpy and copy kernels), everything else, and the total."""
    split = {"rmsnorm": [0.0, 0], "copies": [0.0, 0], "other": [0.0, 0], "total": [0.0, 0]}
    for e in avgs:
        if e.device_type != cuda:
            continue
        key = e.key.lower()
        kind = "rmsnorm" if "rmsnorm_kernel" in key else (
            "copies" if "memcpy" in key or "copy" in key else "other")
        for k in (kind, "total"):
            split[k][0] += e.device_time_total / 1e3
            split[k][1] += e.count
    return split


def path_launches(torch, kops, label: str, interpreted, fused_first) -> tuple[dict, list]:
    """The kernels' launches on one path of the data plane, each run driven
    with the counts set to 0 just before it and read just after: one
    interpreted run, and the first run of a fresh fused executable (its
    warm-up and its capture each call the rmsnorm wrapper once a norm step;
    later runs replay the graph and call no wrapper).  Fails unless rmsnorm
    launched DP_NORMS and 2 * DP_NORMS times.  Returns the counts and the
    two runs' results."""
    counts, results = {}, []
    for arm, run, want in (("interpreted_run", interpreted, DP_NORMS),
                           ("fused_first_run", fused_first, 2 * DP_NORMS)):
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        results.append(run())
        torch.cuda.synchronize()
        counts[arm] = kops.launch_counts()
        if counts[arm].get("rmsnorm", 0) != want:
            fail(f"{label}: {arm} launched rmsnorm {counts[arm].get('rmsnorm', 0)} times, not {want}")
    return counts, results


def phase_dataplane(torch, smi: str) -> dict:
    """Phase 7: SWIRL's own main path on the card — trace → optimize → lower
    ("torch") → compile → run, interpreted and fused (CUDA graphs).

    Checks each fused store against the interpreted one, each rmsnorm step
    against the plain version, the fused stats, the wrapper's launches a run,
    and the rmsnorm kernels in a profiled replay; a body that cannot be
    captured (a host sync) must fall back and leave the card usable, and a
    second fused run must leave the first run's store as it was.  Returns
    the numbers it prints, and the kernels' launches on the untraced path at
    P-full (:func:`path_launches`).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import swirl
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.core.translate import genomes_1000
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    out = {"device": smi}
    plan = dp_pipeline(swirl, DistributedWorkflowInstance, make_workflow)
    mix = lambda v: 0.5 * v + 0.1 * torch.tanh(v)  # noqa: E731
    for label, shape in DP_SHAPES.items():
        w = torch.ones(shape[1], device="cuda")
        fns = dp_fns(lambda v, w=w: kops.rmsnorm(v, w), mix)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).cuda()
        feed = {("l0", "d0"): x}
        if label == "P-full":
            out["launches"], _ = path_launches(
                torch, kops, f"{label} untraced",
                lambda: plan.lower("torch").compile(fns).run(initial_payloads=dict(feed)),
                lambda: plan.lower("torch", fuse=True).compile(fns).run(initial_payloads=dict(feed)))
        interp = plan.lower("torch").compile(fns)
        fused = plan.lower("torch", fuse=True).compile(fns)
        t_i, res_i = dp_time(torch, interp, feed)
        t_f, res_f = dp_time(torch, fused, feed)
        dp_stores_close(torch, f"{label} fused vs interpreted", res_f.data, res_i.data)
        for k in (0, 4, 8):  # the rmsnorm steps, against the plain version
            want = ref.rmsnorm_ref(res_i.data["l0"][f"d{k}"], w)
            for arm, res in (("interpreted", res_i), ("fused", res_f)):
                check_close(f"{label} {arm} d{k + 1} = rmsnorm(d{k})", res.data["l0"][f"d{k + 1}"],
                            want, 2e-5)
        before = kops.launch_counts().get("rmsnorm", 0)
        interp.run(initial_payloads=dict(feed))
        per_run = kops.launch_counts().get("rmsnorm", 0) - before
        if per_run != DP_NORMS:
            fail(f"{label}: an interpreted run launched rmsnorm {per_run} times, not {DP_NORMS}")
        f = res_f.stats["fused"]
        if f["fallbacks"] != 0 or f["fused_execs"] != DP_STEPS or f["fused_calls"] != 1:
            fail(f"{label}: fused stats {f}")
        split = {}
        for arm, exe in (("interpreted", interp), ("fused", fused)):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                exe.run(initial_payloads=dict(feed))
                torch.cuda.synchronize()
            split[arm] = dp_device_split(prof.key_averages(), DeviceType.CUDA)
        n_rms = split["fused"]["rmsnorm"][1]
        if n_rms != 3:
            fail(f"{label}: a profiled fused replay ran {n_rms} rmsnorm kernels, not 3")
        roof = f["roofline"]["l0"]
        mi, mf = min(t_i), min(t_f)
        out[label] = {
            "shape": list(shape), "interpreted_ms": t_i, "fused_ms": t_f,
            "interpreted_min_ms": mi, "fused_min_ms": mf, "fused_over_interpreted": mf / mi,
            "fused": {k: v for k, v in f.items() if k != "roofline"}, "roofline": roof,
            "profiled_replay_rmsnorm_kernels": n_rms, "interpreted_rmsnorm_launches": per_run,
            "device_ms_by_kind": split,
        }
        frac = roof["fraction_of_roof"]
        print(
            f"[7] {label} {shape} fp32: interpreted {mi:.4f} ms (median "
            f"{statistics.median(t_i):.4f}), fused {mf:.4f} ms (median {statistics.median(t_f):.4f}) a "
            f"run, fused/interpreted {mf / mi:.3f}; roofline {roof['achieved_bytes_per_s'] / 1e9:.2f} GB/s "
            f"of {roof['theoretical_bytes_per_s'] / 1e9:.0f}, fraction {frac:.4f}; profiled replay: "
            f"{n_rms} rmsnorm kernels; {smi}"
        )
        print(f"[7] {label} fused stats: {json.dumps(out[label]['fused'])}")
        for arm, kinds in split.items():
            print(f"[7] {label} {arm}, one profiled run, device ms (kernels) by kind: "
                  + ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in kinds.items()))
        if label == "P-ref":
            # A second fused run leaves the first run's store as it was.
            first = fused.run(initial_payloads=dict(feed))
            kept = {d: v.clone() for d, v in first.data["l0"].items()}
            fused.run(initial_payloads={("l0", "d0"): torch.randn_like(x)})
            torch.cuda.synchronize()
            if any(not torch.equal(first.data["l0"][d], v) for d, v in kept.items()):
                fail("a second fused run changed the first run's store")
            # A body with a host sync cannot be captured: the segment falls back.
            sync_fns = dict(fns)
            sync_fns["s2"] = lambda i: {"d2": i["d1"] * float(i["d1"].abs().max())}
            want = plan.lower("torch").compile(sync_fns).run(initial_payloads=dict(feed))
            got = plan.lower("torch", fuse=True).compile(sync_fns).run(initial_payloads=dict(feed))
            gf = got.stats["fused"]
            if (gf["fallbacks"], gf["fused_calls"]) != (1, 0):
                fail(f"a host sync in a body did not fall back: {gf}")
            dp_stores_close(torch, "host-sync fallback", got.data, want.data)
            again = fused.run(initial_payloads=dict(feed))
            dp_stores_close(torch, "P-ref after a failed capture", again.data, res_i.data)
            print("[7] P-ref: a second fused run left the first store as it was; a host sync in a "
                  "body fell back (fallbacks 1) and the card ran on")
        del interp, fused, res_i, res_f
        torch.cuda.empty_cache()

    # G: 1000 Genomes, 9 locations on one card, comms between them.
    inst = genomes_1000(n=4, m=3, a=2, b=2, c=2)
    init, fns = g_setup(torch, inst, "cuda")
    gplan = swirl.trace(inst).optimize(G_RULES)
    t_i, res_i = dp_time(torch, gplan.lower("torch").compile(fns), init)
    t_f, res_f = dp_time(torch, gplan.lower("torch", fuse=True).compile(fns), init)
    dp_stores_close(torch, "G fused vs interpreted", res_f.data, res_i.data)
    mi, mf = min(t_i), min(t_f)
    f = res_f.stats["fused"]
    out["G"] = {
        "locations": len(res_i.stats["devices"]), "comms": res_i.stats["comms"],
        "execs": res_i.stats["execs"], "interpreted_ms": t_i, "fused_ms": t_f,
        "interpreted_min_ms": mi, "fused_min_ms": mf, "fused_over_interpreted": mf / mi,
        "fused": {k: v for k, v in f.items() if k != "roofline"}, "roofline": f["roofline"],
    }
    print(
        f"[7] G genomes_1000(4, 3, 2, 2, 2): {out['G']['locations']} locations, "
        f"{out['G']['execs']} execs, {out['G']['comms']} comms, float32 x {G_ELEMS}: interpreted "
        f"{mi:.4f} ms (median {statistics.median(t_i):.4f}), fused {mf:.4f} ms (median "
        f"{statistics.median(t_f):.4f}) a run, fused/interpreted {mf / mi:.3f}; "
        f"fused stats {json.dumps(out['G']['fused'])}; roofline {f['roofline']}; {smi}"
    )
    return out


def device_ms_and_copies(torch, fn) -> tuple[float, int, int]:
    """Device ms of one profiled call of ``fn``, its ``cudaMemcpy*`` runtime
    calls (any direction) and its DtoH copy records.  The runtime calls are
    the check: once the kernels' own library is loaded, the profiler keeps
    recording kernels but no longer records memcpy activity on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # as phase 7 profiles
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    calls = sum(e.count for e in avgs if e.key.startswith("cudaMemcpy"))
    dtoh = sum(e.count for e in avgs if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    return dp_device_split(avgs, DeviceType.CUDA)["total"][0], calls, dtoh


def median_drift(report) -> float:
    """The median |duration ratio - 1| of a ProfileReport's steps."""
    return statistics.median(abs(d.duration_ratio - 1.0) for d in report.drifts)


def phase_traced(torch, smi: str) -> dict:
    """Phase 8: trace, schedule and certify on the card.

    Each cell runs untraced and traced (interpreted and fused); the traced
    store must equal the untraced one, the span schema the port's own CPU
    schema of the same plan, and the spans must cover the device work; a
    traced run may copy no more to the host than an untraced one; the
    Chrome trace must validate.  Then the schedule (``placement="auto"``)
    and the certificate on G, and the kernels' launches on the traced path
    at P-full (:func:`path_launches`).  Returns the numbers it prints.
    """
    from repro_torch import swirl
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.core.translate import genomes_1000
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.sched import CostModel, NetworkModel

    traces = ROOT / "build" / "traces"
    traces.mkdir(parents=True, exist_ok=True)
    out = {"device": smi, "cells": {}}
    mix = lambda v: 0.5 * v + 0.1 * torch.tanh(v)  # noqa: E731

    def cpu_schema(plan, fns, feed, fuse):
        return plan.lower("torch", platform="cpu", trace=True, fuse=fuse).compile(fns).run(
            initial_payloads=dict(feed)).profile.span_schema()

    def traced_cell(label, plan, fns, feed, cpu_fns, cpu_feed):
        cell = {}
        for fuse in (False, True):
            arm = "fused" if fuse else "interpreted"
            plain_exe = plan.lower("torch", fuse=fuse).compile(fns)
            traced_exe = plan.lower("torch", fuse=fuse, trace=True).compile(fns)
            t_u, res_u, t_t, res_t = dp_time_pair(torch, plain_exe, traced_exe, feed)
            if res_u.profile is not None or res_t.profile is None:
                fail(f"{label} {arm}: a profile on the untraced run or none on the traced one")
            dp_stores_close(torch, f"{label} {arm} traced vs untraced", res_t.data, res_u.data)
            schema = res_t.profile.span_schema()
            if schema != cpu_schema(plan, cpu_fns, cpu_feed, fuse):
                fail(f"{label} {arm}: the span schema on the card differs from the CPU's")
            dev_ms, copies_u, dtoh_u = device_ms_and_copies(
                torch, lambda: plain_exe.run(initial_payloads=dict(feed)))
            _, copies_t, dtoh_t = device_ms_and_copies(
                torch, lambda: traced_exe.run(initial_payloads=dict(feed)))
            if copies_t > copies_u or dtoh_t > dtoh_u:
                fail(f"{label} {arm}: a traced run made {copies_t} memcpy calls ({dtoh_t} DtoH), "
                     f"an untraced one {copies_u} ({dtoh_u})")
            spans = res_t.profile.spans
            execs = [sp for sp in spans if sp.kind == "exec"]
            exec_ms = sum(sp.duration for sp in execs) * 1e3
            seg_ms = sum({(sp.start, sp.end): sp.duration for sp in execs}.values()) * 1e3
            path = traces / f"{label}-{arm}.json"
            res_t.profile.save_chrome_trace(str(path))
            validate_chrome_trace(json.loads(path.read_text()))
            mu, mt = min(t_u), min(t_t)
            cell[arm] = {
                "untraced_ms": t_u, "traced_ms": t_t, "untraced_min_ms": mu, "traced_min_ms": mt,
                "traced_over_untraced": mt / mu, "spans": len(spans), "exec_span_ms": exec_ms,
                "traced_over_untraced_median": statistics.median(t_t) / statistics.median(t_u),
                "distinct_exec_interval_ms": seg_ms, "untraced_device_ms": dev_ms,
                "exec_spans_over_device": exec_ms / dev_ms if dev_ms else None,
                "memcpy_calls_untraced": copies_u, "memcpy_calls_traced": copies_t,
                "dtoh_untraced": dtoh_u, "dtoh_traced": dtoh_t, "chrome_trace": str(path.relative_to(ROOT)),
            }
            print(f"[8] {label} {arm}: untraced {mu:.4f} ms, traced {mt:.4f} ms a run (medians "
                  f"{statistics.median(t_u):.4f}, {statistics.median(t_t):.4f}), traced/untraced "
                  f"{mt / mu:.3f} (medians {cell[arm]['traced_over_untraced_median']:.3f}); {len(spans)} spans, exec spans {exec_ms:.4f} ms ({seg_ms:.4f} ms "
                  f"of distinct intervals) over {dev_ms:.4f} ms of device time in an untraced run; "
                  f"memcpy calls untraced {copies_u} (DtoH {dtoh_u}), traced {copies_t} ({dtoh_t}); schema equals the CPU's; "
                  f"{path.relative_to(ROOT)} valid; {smi}")
            if label == "P-full" and not fuse and exec_ms < TRACE_COVER * dev_ms:
                fail(f"P-full interpreted: exec spans {exec_ms:.4f} ms cover less than "
                     f"{TRACE_COVER} of the device's {dev_ms:.4f} ms")
            del plain_exe, traced_exe, res_u, res_t
        out["cells"][label] = cell
        return cell

    # The memcpy count must see a planted copy to the host.
    probe = torch.ones(1024, device="cuda")
    if device_ms_and_copies(torch, lambda: probe.cpu())[1] < 1:
        fail("the profiler showed no memcpy call for a planted .cpu()")
    plan = dp_pipeline(swirl, DistributedWorkflowInstance, make_workflow)
    for label, shape in DP_SHAPES.items():
        w = torch.ones(shape[1], device="cuda")
        fns = dp_fns(lambda v, w=w: kops.rmsnorm(v, w), mix)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).cuda()
        w_cpu = torch.ones(shape[1])
        cpu_fns = dp_fns(lambda v, w=w_cpu: kops.rmsnorm(v, w), mix)
        cpu_feed = {("l0", "d0"): torch.randn(4, shape[1])}  # the schema depends on no value
        feed = {("l0", "d0"): x}
        traced_cell(label, plan, fns, feed, cpu_fns, cpu_feed)
        if label == "P-full":
            out["launches"], runs = path_launches(
                torch, kops, f"{label} traced",
                lambda: plan.lower("torch", trace=True).compile(fns).run(
                    initial_payloads=dict(feed)),
                lambda: plan.lower("torch", trace=True, fuse=True).compile(fns).run(
                    initial_payloads=dict(feed)))
            for res in runs:
                n = sum(sp.kind == "exec" for sp in res.profile.spans)
                if n != DP_STEPS:
                    fail(f"{label}: a traced run recorded {n} exec spans, not {DP_STEPS}")
            print(f"[8] {label} traced, launches from zero: {out['launches']}")
        torch.cuda.empty_cache()

    inst = genomes_1000(n=4, m=3, a=2, b=2, c=2)
    init, fns = g_setup(torch, inst, "cuda")
    init_cpu, fns_cpu = g_setup(torch, inst, "cpu")
    gplan = swirl.trace(inst).optimize(G_RULES)
    traced_cell("G", gplan, fns, init, fns_cpu, init_cpu)

    # Predicted vs actual on G, and the cost model calibrated from one run.
    exe = gplan.lower("torch", trace=True).compile(fns)
    first = exe.run(initial_payloads=dict(init))
    second = exe.run(initial_payloads=dict(init))
    torch.cuda.synchronize()
    report = gplan.profile(second)
    model = CostModel.from_profile(first.profile)
    calibrated = gplan.profile(second, costs=model)
    if report.unmatched_actual or report.unmatched_predicted or not report.drifts:
        fail(f"G: Plan.profile matched no or not all steps: {report.summary()}")
    print("[8] G Plan.profile(result).summary():")
    print(report.summary())
    before, after = median_drift(report), median_drift(calibrated)
    print(f"[8] G median |duration ratio - 1|: {before:.4f} with the default cost model, "
          f"{after:.4f} after CostModel.from_profile of a first traced run; makespan predicted "
          f"{calibrated.predicted_makespan * 1e3:.4f} ms calibrated ({report.predicted_makespan * 1e3:.4f} "
          f"default) against {calibrated.actual_makespan * 1e3:.4f} ms actual")
    out["G_profile"] = {
        "median_drift_default": before, "median_drift_calibrated": after,
        "predicted_makespan_ms": report.predicted_makespan * 1e3,
        "calibrated_makespan_ms": calibrated.predicted_makespan * 1e3,
        "actual_makespan_ms": calibrated.actual_makespan * 1e3,
    }

    # G scheduled: placement="auto" under two-rack, against the hand placement.
    net = NetworkModel.preset("two-rack")
    auto = gplan.lower("torch", placement="auto", network=net)
    auto_traced = gplan.lower("torch", placement="auto", network=net, trace=True, fuse=True)
    splan = auto.plan
    srep = splan.schedule_report
    cpu_rep = swirl.trace(genomes_1000(n=4, m=3, a=2, b=2, c=2)).optimize(G_RULES).schedule(
        NetworkModel.preset("two-rack"))
    if (cpu_rep.fingerprint(), cpu_rep.schedule_report.bytes_saved_frac) != (
            splan.fingerprint(), srep.bytes_saved_frac):
        fail("G: the schedule is not deterministic")
    t_hand, res_hand, t_auto, res_auto = dp_time_pair(
        torch, gplan.lower("torch").compile(fns), auto.compile(fns), init)
    res_at = auto_traced.compile(fns).run(initial_payloads=dict(init))
    res_cpu = splan.lower("torch", platform="cpu").compile(fns_cpu).run(
        initial_payloads=dict(init_cpu))
    dp_stores_close(torch, "G auto on cuda vs cpu", res_auto.data, res_cpu.data)
    dp_stores_close(torch, "G auto traced fused vs untraced", res_at.data, res_auto.data)
    if res_at.profile.span_schema() != cpu_schema(splan, fns_cpu, init_cpu, True):
        fail("G auto: the span schema on the card differs from the CPU's")
    devices = set(res_auto.stats["devices"].values())
    if devices != {"cuda:0"}:
        fail(f"G auto ran on {devices}")
    out["G_auto"] = {
        "bytes_saved_frac": srep.bytes_saved_frac, "makespan_speedup": srep.makespan_speedup,
        "comms": res_auto.stats["comms"], "comms_hand": res_hand.stats["comms"],
        "auto_min_ms": min(t_auto), "hand_min_ms": min(t_hand), "auto_ms": t_auto, "hand_ms": t_hand,
        "search_ms": srep.search_seconds * 1e3,
    }
    print(f"[8] G placement='auto' two-rack: bytes_saved_frac {srep.bytes_saved_frac:.4f} (the CPU's "
          f"{cpu_rep.schedule_report.bytes_saved_frac:.4f}), predicted makespan x"
          f"{srep.makespan_speedup:.3f}; comms {res_auto.stats['comms']} (hand placement "
          f"{res_hand.stats['comms']}); {min(t_auto):.4f} ms a run (hand {min(t_hand):.4f}; medians "
          f"{statistics.median(t_auto):.4f}, {statistics.median(t_hand):.4f}); search "
          f"{srep.search_seconds * 1e3:.1f} ms; store equals the CPU's; {smi}")

    # Certification: its host cost, and the whole chain on the card.
    certs = {}
    for label, raw in (("pipeline", swirl.trace(plan.instance)),
                       ("genomes-small", swirl.trace(genomes_1000(**CERT_GENOMES)))):
        rules = ("R1R2",) if label == "pipeline" else G_RULES
        t0 = time.perf_counter()
        c = raw.optimize(rules, certify=True).certificate
        certs[label] = {"equivalent": c.equivalent, "states_original": c.states_original,
                        "states_optimized": c.states_optimized,
                        "host_ms": (time.perf_counter() - t0) * 1e3}
        print(f"[8] optimize(certify=True) on {label}: {certs[label]}")
    if not (certs["pipeline"]["equivalent"] and certs["genomes-small"]["equivalent"]):
        fail(f"certification failed: {certs}")
    out["certify"] = certs
    small = genomes_1000(**CERT_GENOMES)
    s_init, s_fns = g_setup(torch, small, "cuda")
    s_init_cpu, s_fns_cpu = g_setup(torch, small, "cpu")
    t0 = time.perf_counter()
    chain = (swirl.trace(small).optimize(G_RULES, certify=True)
             .schedule(NetworkModel.preset("two-rack")).certify())
    chain_ms = (time.perf_counter() - t0) * 1e3
    res = chain.lower("torch", trace=True, fuse=True).compile(s_fns).run(
        initial_payloads=dict(s_init))
    want = chain.lower("torch", platform="cpu").compile(s_fns_cpu).run(
        initial_payloads=dict(s_init_cpu))
    dp_stores_close(torch, "genomes-small certified chain, cuda vs cpu", res.data, want.data)
    if not chain.certificate.equivalent or res.profile is None:
        fail("the certified chain lost its certificate or its profile")
    print(f"[8] trace -> optimize(certify=True) -> schedule(two-rack) -> certify -> lower(torch, "
          f"trace, fuse) -> run on genomes_1000{tuple(CERT_GENOMES.values())}: certificate "
          f"{dataclasses.astuple(chain.certificate)}, {chain_ms:.1f} ms of host time to certify and "
          f"schedule; {len(res.profile.spans)} spans; store equals the CPU's")
    out["chain"] = {"certificate": dataclasses.astuple(chain.certificate), "host_ms": chain_ms,
                    "spans": len(res.profile.spans)}
    return out


def kernel_family(name: str) -> str:
    """The family of a device kernel, by its name, for phase 9's split."""
    n = name.lower()
    if "rmsnorm" in n:
        return "rmsnorm"
    if "flash" in n:
        return "flash"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "matmul")):
        return "GEMM"
    if "elementwise" in n or "reduce" in n:
        return "elementwise"
    return "other"


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Operations an iteration counts, the formula PERF.md states: 6 N T for
    the matmuls (N = the blocks' and the tied head's weights that a token
    uses: of a MoE FFN, its router, its k routed experts and its shared
    ones), 2 N_blocks T for remat's recomputed block forward, and causal
    attention's QK^T and P.V, 2 B Hq L^2 d a layer forward, four times
    (forward, recompute and a backward of twice the forward)."""
    d, qd, kvd, m = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.moe

    def ffn(kind: str) -> int:
        if kind == "moe":
            return d * m.n_experts + (m.top_k + m.n_shared) * 3 * d * m.d_expert
        return 0 if kind == "none" else 3 * d * cfg.d_ff

    n_block = sum(2 * d * qd + 2 * d * kvd + ffn(f) for _, f in cfg.layer_seq())
    n_head = d * cfg.vocab
    attn_fwd = cfg.n_layers * 2 * (tokens // seq) * cfg.n_heads * seq * seq * cfg.head_dim
    return 6 * (n_block + n_head) * tokens + 2 * n_block * tokens + 4 * attn_fwd


def profiled_iteration(torch, tr, it: int, median_ms: float, tag: str, smi: str, sku: str):
    """Iteration ``it`` of trainer ``tr`` under ``torch.profiler``: device ms
    by kernel family, the device ops an iteration and the device's busy share
    of ``median_ms`` (an unprofiled iteration's wall time), and, for an arch
    with attention (:func:`train_flops` counts no recurrent mixer), the share
    of bf16 peak that the counted operations reach at ``median_ms``.  Prints
    them; returns ``(families, operations, share, device ops, busy share)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.iteration(it)
        torch.cuda.synchronize()
    fam: dict = {}
    events = device_events(prof)
    for name, ms in events:
        f = kernel_family(name)
        fam[f] = fam.get(f, 0.0) + ms
    ops = len(events)
    dev_ms = sum(fam.values())
    split = ", ".join(f"{k} {v:.2f} ms ({v / dev_ms:.1%})"
                      for k, v in sorted(fam.items(), key=lambda kv: -kv[1])) if dev_ms else "none recorded"
    print(f"[{tag}] one profiled iteration: device {dev_ms:.2f} ms over {ops} device ops, busy "
          f"{dev_ms / median_ms:.1%} of {median_ms:.2f} ms: {split}  ({smi})")
    if not any(mix in ("attn", "attn_local") for mix, _ in tr.cfg.layer_seq()):
        return fam, None, None, ops, dev_ms / median_ms
    flops = train_flops(tr.cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    share = flops / (median_ms / 1e3) / PEAKS[sku]["bf16"]
    print(f"[{tag}] counted operations {flops:.4e} an iteration: {flops / (median_ms / 1e3) / 1e12:.1f} TFLOP/s, "
          f"{share:.2%} of {PEAKS[sku]['bf16'] / 1e12:.0f} TFLOP/s bf16  ({smi})")
    return fam, flops, share, ops, dev_ms / median_ms


def device_events(prof) -> list:
    """``(name, ms)`` of each device event (kernel, copy, set) that ``prof``
    recorded, read from its Kineto results: ``key_averages()`` first builds a
    Python object an event, which took minutes for TR-xlstm's 843,000 device
    ops and their launches (PERF.md, section 6).  The program's step spans,
    drawn on the device too, are left out."""
    from torch.autograd import DeviceType

    from repro_torch.obs.events import STEP_SPANS

    return [(e.name(), e.duration_ns() / 1e6) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.name() not in STEP_SPANS]


def step_times(torch, tr, it: int) -> dict:
    """The steps of iteration ``it`` of trainer ``tr`` run one at a time, in
    the plan's order, each ended by a synchronise: ms by step kind (the pods'
    summed), by host clock."""
    sync = torch.cuda.synchronize
    pods = tr.n_pods
    fns = tr.step_fns()
    env = {f"iter_{i}": it for i in range(pods)}
    env.update({f"params_{i}": tr.params for i in range(pods)})
    env.update({f"opt_{i}": tr.opt_state for i in range(pods)})
    step_ms = {"shard": 0.0, "fwdbwd": 0.0, "gradsync": 0.0, "update": 0.0}
    order = ([f"shard_{i}" for i in range(pods)] + [f"fwdbwd_{i}" for i in range(pods)]
             + ["gradsync"] + [f"update_{i}" for i in range(pods)])
    for name in order:
        sync()
        t0 = time.perf_counter()
        env.update(fns[name](env))
        sync()
        step_ms[name.split("_")[0]] += (time.perf_counter() - t0) * 1e3
    return step_ms


def beside_torch_backend(tag: str, cell: str, iter_ms, peak_gb: float) -> None:
    """Prints a training cell's ms an iteration and peak memory beside the
    same cell's under the ``torch`` backend, which fired one step at a time
    (TORCH_BACKEND_TRAIN)."""
    lo, hi, gb = TORCH_BACKEND_TRAIN[cell]
    print(f"[{tag}] {cell} on the inprocess backend (both pods' steps at once): {min(iter_ms):.2f}-"
          f"{max(iter_ms):.2f} ms an iteration, peak {peak_gb:.2f} GB; on the torch backend, one step at a "
          f"time (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): {lo:.2f}-{hi:.2f} ms, {gb:.2f} GB")


def hold_fwdbwd(torch, tag: str, label: str, cfg, params, batch, grad_fn, tape=None, bf16_leaves=True,
                fp32_kernel=False) -> dict:
    """One fwdbwd of ``grad_fn`` on the kernel path against the plain path, and
    both against the plain path in fp32 on the same (bf16-valued) weights:
    the loss within TRAIN_LOSS_RTOL, each grad leaf within GRAD_REL_L2_TOL by
    relative L2 (:func:`leaf_rel_l2`; printed only, without ``bf16_leaves``),
    every kernel-path leaf nonzero and finite, and the kernel path's whole
    gradient at most F32_RATIO times as far from fp32 as the plain bf16
    path's.  With
    ``fp32_kernel``, the kernel path in fp32 is held against the plain path
    in fp32 too: the loss within TRAIN_LOSS_RTOL, each leaf within
    GRAD_REL_L2_TOL.  With a :class:`RouteTape`, the plain and fp32 runs
    route each MoE call as the kernel run did.  Returns the numbers."""
    from repro_torch._bridge import tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.models import Model, set_attn_impl

    def record():
        return tape.record() if tape is not None else contextlib.nullcontext([])

    def replay(calls):
        return tape.replay(calls) if tape is not None else contextlib.nullcontext([])

    with record() as rec:
        gk, mk = grad_fn(params, batch)
    set_attn_impl("plain")
    try:
        with replay(rec) as own:
            gp, mp = grad_fn(params, batch)
        m32 = Model(dataclasses.replace(cfg, dtype="float32"), "cuda")
        params32 = tree_map(lambda t: t.float(), params)
        with replay(rec):
            g32, m32m = make_grad_step(m32)(params32, batch)
    finally:
        set_attn_impl(None)
    if fp32_kernel:
        gk32, mk32 = make_grad_step(m32)(params32, batch)
    del params32
    names = [n for n, _ in tree_flatten_with_path(gk)]
    bad = [n for n, g in zip(names, tree_leaves(gk)) if not (bool(g.isfinite().all()) and float(g.abs().max()) > 0)]
    if bad:
        fail(f"{label}: {len(bad)} grad leaves are zero or non-finite on the kernel path: {bad[:4]}")
    lk, lp, l32 = float(mk["loss"]), float(mp["loss"]), float(m32m["loss"])

    def leaf_rels(gs, want) -> dict:
        return dict(zip(names, leaf_rel_l2(tree_leaves(gs), tree_leaves(want))))

    rels = leaf_rels(gk, gp)
    k32 = {n: rel_l2(a, b) for n, a, b in zip(names, tree_leaves(gk), tree_leaves(g32))}
    p32 = {n: rel_l2(a, b) for n, a, b in zip(names, tree_leaves(gp), tree_leaves(g32))}

    def whole_rel_l2(gs) -> float:  # of all leaves as one vector, a leaf at a time
        num = sum(float((a.float() - b).norm()) ** 2 for a, b in zip(tree_leaves(gs), tree_leaves(g32)))
        return (num / sum(float(b.norm()) ** 2 for b in tree_leaves(g32))) ** 0.5

    wk, wp = whole_rel_l2(gk), whole_rel_l2(gp)
    worst = max(rels, key=rels.get)
    routed = ""
    out = {"loss": {"kernel": lk, "plain": lp, "fp32": l32}, "grad_rel_l2_max": rels[worst],
           "fp32_ratio": wk / wp}
    if tape is not None:
        agree = route_agreement(rec, own, 1)[0]
        out.update(aux={"kernel": float(mk["aux"]), "plain": float(mp["aux"]), "fp32": float(m32m["aux"])},
                   forced_route_agreement=agree)
        routed = (f"; the plain and fp32 runs route as the kernel run ({len(rec)} MoE calls; the plain "
                  f"path's own top-k agrees on {agree:.2%} of choices); aux {float(mk['aux']):.6f} vs "
                  f"{float(mp['aux']):.6f} (fp32 {float(m32m['aux']):.6f})")
    print(f"[{tag}] fwdbwd kernel vs plain: loss {lk:.6f} vs {lp:.6f} (fp32 {l32:.6f}), rel "
          f"{abs(lk - lp) / abs(lp):.3e} (tol {TRAIN_LOSS_RTOL:g}); grads: {len(names)} leaves, all "
          f"nonzero and finite; max rel L2 {rels[worst]:.3e} at {worst} (tol {GRAD_REL_L2_TOL:g}){routed}")
    print(f"[{tag}] against fp32: whole gradient rel L2 kernel {wk:.3e}, plain bf16 {wp:.3e}, ratio "
          f"{wk / wp:.3f} (tol {F32_RATIO:g}); per leaf, kernel/plain ratio max "
          f"{max(k32[n] / p32[n] for n in names):.3f}, min {min(k32[n] / p32[n] for n in names):.3f}")
    for nm in sorted(names, key=rels.get)[-5:]:
        print(f"  {nm}: vs plain {rels[nm]:.3e}; vs fp32 kernel {k32[nm]:.3e}, plain {p32[nm]:.3e}")
    # Written so that a NaN fails each test.
    if not (abs(lk - lp) / abs(lp) <= TRAIN_LOSS_RTOL and (all(r <= GRAD_REL_L2_TOL for r in rels.values())
                                                         or not bf16_leaves)):
        fail(f"{label}: the kernel path's fwdbwd disagrees with the plain path")
    if fp32_kernel:
        lk32 = float(mk32["loss"])
        r32 = leaf_rels(gk32, g32)
        w32 = max(r32, key=r32.get)
        print(f"[{tag}] fwdbwd in fp32, kernel vs plain: loss {lk32:.6f} vs {l32:.6f}, rel "
              f"{abs(lk32 - l32) / abs(l32):.3e} (tol {TRAIN_LOSS_RTOL:g}); grads max rel L2 {r32[w32]:.3e} at "
              f"{w32} (tol {GRAD_REL_L2_TOL:g})")
        for nm in sorted(names, key=r32.get)[-3:]:
            print(f"  {nm}: fp32 kernel vs plain {r32[nm]:.3e}")
        out["fp32_kernel_vs_plain"] = {"loss": lk32, "grad_rel_l2_max": r32[w32]}
        if not (abs(lk32 - l32) / abs(l32) <= TRAIN_LOSS_RTOL and all(r <= GRAD_REL_L2_TOL for r in r32.values())):
            fail(f"{label}: the kernel path's fwdbwd in fp32 disagrees with the plain path in fp32")
    if not wk <= F32_RATIO * wp:
        fail(f"{label}: the kernel path's gradient is {wk / wp:.3f}x as far from fp32 as the plain path's")
    if tape is not None and not agree >= ROUTE_AGREE:
        fail(f"{label}: the plain path's own routing agrees with the kernel path's on {agree:.2%} of "
             f"choices (at least {ROUTE_AGREE:.0%})")
    return out


def phase_train(torch, smi: str, sku: str) -> dict:
    """Phase 9a: T-full through ``repro_torch.launch.train.Trainer`` (what
    ``train`` runs) on ``cuda``; 9b: a checkpoint written on the card reads
    back on the CPU bit for bit, and training resumes from it."""
    import shutil

    from repro_torch._bridge import to_torch, tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.ckpt import latest_step, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import Trainer, checkpoint_tree
    from repro_torch.models import Model, params_from_jax

    sync = torch.cuda.synchronize
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_LAYERS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, steps=1 + TRAIN_TIMED, n_pods=TRAIN_PODS, global_batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, ckpt_dir=None, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"[9] T-full: {ARCH} at full width (d {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"remat {cfg.remat}), {TRAIN_LAYERS} of 28 layers, {n_params / 1e9:.3f} B params; "
          f"{TRAIN_PODS} pods, int8 gradsync, global batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    p0 = tr.params
    m = tr.iteration(0)  # warm
    sync()
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        fail(f"T-full: non-finite loss or grad_norm {m}")
    same = [n for (n, a), b in zip(tree_flatten_with_path(p0), tree_leaves(tr.params)) if torch.equal(a, b)]
    if same:
        fail(f"T-full: {len(same)} param leaves unchanged by an update: {same[:4]}")
    del p0
    iter_ms, counts = [], None
    for it in range(1, 1 + TRAIN_TIMED):
        if it == 1:
            kops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        m = tr.iteration(it)
        sync()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        if it == 1:
            counts = kops.launch_counts()
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"T-full: non-finite loss or grad_norm at iteration {it}: {m}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = TRAIN_LAYERS
    want = {"rmsnorm": TRAIN_PODS * ((2 * n + 1) + 2 * n), "flash_attention": TRAIN_PODS * 2 * n}
    print(f"[9] launches in one iteration {counts} (expected {want})")
    if counts != want:
        fail("the training path did not launch each kernel as expected")

    it = 1 + TRAIN_TIMED
    step_ms = step_times(torch, tr, it)
    # One profiled iteration: device time by family.
    med = statistics.median(iter_ms)
    print(f"[9] ms an iteration {fmt_ms(iter_ms)}, median {med:.2f} ms; {tokens / med * 1e3:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB  ({smi})")
    beside_torch_backend("9", "T-full", iter_ms, peak_gb)
    print(f"[9] steps of one iteration (host clock, synchronised): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items()) + f"  ({smi})")
    fam, flops, share, ops, busy = profiled_iteration(torch, tr, it + 1, med, "9", smi, sku)

    # One fwdbwd: the kernel path against the plain path, and both against fp32
    # (the trainer's moments and error feedback go first, to make room).
    params, grad_fn = tr.params, tr.grad_fn
    batch = {k: to_torch(v, "cuda") for k, v in tr.dataset.batch(0, 0, TRAIN_PODS).items()}
    del tr
    torch.cuda.empty_cache()
    held = hold_fwdbwd(torch, "9", "T-full", cfg, params, batch, grad_fn)
    del params
    torch.cuda.empty_cache()

    # 9b: a checkpoint written on the card through the trainer's ckpt step.
    # The smoke config (fp32) with head_dim 64, which the flash kernel takes.
    scfg = dataclasses.replace(get_config(ARCH, smoke=True), head_dim=64)
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    try:
        run = dict(n_pods=2, global_batch=4, seq_len=32, ckpt_dir=str(d), device="cuda")
        st = Trainer(scfg, steps=2, **run)
        kops.reset_launch_counts()
        st.iteration(0)
        smoke_counts = kops.launch_counts()
        if latest_step(d) != 1 or not smoke_counts.get("rmsnorm") or not smoke_counts.get("flash_attention"):
            fail(f"9b: no checkpoint at step 1 ({latest_step(d)}) or no kernel launched ({smoke_counts})")
        like = checkpoint_tree(scfg, st.params, st.opt_state)
        back = load_checkpoint(d, 1, like)
        cpu = {"params": params_from_jax(back["params"], scfg, "cpu"),
               "m": params_from_jax(back["opt"]["m"], scfg, "cpu"),
               "v": params_from_jax(back["opt"]["v"], scfg, "cpu")}
        card = tree_map(lambda t: t.cpu(), {"params": st.params, "m": st.opt_state.m, "v": st.opt_state.v})
        diff = [n for (n, a), b in zip(tree_flatten_with_path(cpu), tree_leaves(card))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        if diff or int(back["opt"]["step"]) != int(st.opt_state.step):
            fail(f"9b: the checkpoint read on the CPU differs from the card's state: {diff[:4]}")
        batch = {k: to_torch(v) for k, v in st.dataset.batch(1, 0, 1).items()}
        cpu_loss = float(Model(scfg, "cpu").loss(cpu["params"], batch)[0])
        with torch.no_grad():
            card_loss = float(st.model.loss(st.params, {k: v.cuda() for k, v in batch.items()})[0])
        rt = Trainer(scfg, steps=1, **run)
        mr = rt.iteration(rt.start)
        if rt.start != 1 or latest_step(d) != 2 or not np.isfinite(mr["loss"]):
            fail(f"9b: resume started at {rt.start}, wrote {latest_step(d)}, loss {mr['loss']}")
        print(f"[9] checkpoint on the card -> CPU: {len(tree_leaves(cpu))} leaves bit for bit; "
              f"loss at the checkpoint, CPU {cpu_loss:.6f} vs card {card_loss:.6f}; resumed from "
              f"step {rt.start}, loss {mr['loss']:.6f}, wrote step {latest_step(d)}")
        if abs(cpu_loss - card_loss) > 1e-4 * abs(cpu_loss):
            fail("9b: the CPU model's loss at the checkpoint differs from the card's")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"launches": counts, "iter_ms": iter_ms, "median_ms": med, "tokens_per_s": tokens / med * 1e3,
            "step_ms": step_ms, "device_ms": fam, "device_ops": ops, "busy_share": busy, "peak_gb": peak_gb,
            "flops": flops, "bf16_share": share, **held, "params": n_params, "device": smi}


class RouteTape:
    """Records or replays the MoE routing of a run, by wrapping
    ``repro_torch.models.moe.route`` for the length of a ``with`` block.

    ``record()`` yields a list that gets each MoE call's expert choices
    ([T, k]) in call order.  ``replay(calls)`` routes each call as the
    recorded one did: its choices, their weights renormalised from this run's
    own router probabilities, and the slots and drops they imply; it yields a
    list that gets what this run would have chosen itself.  Calls run layer
    by layer, pass by pass (a remat recompute is a pass of its own), so the
    same model on the same batch makes them in the same order.
    """

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe

    @contextlib.contextmanager
    def _wrapped(self, route):
        orig = self.moe.route
        self.moe.route = lambda cfg, p, xf: route(orig(cfg, p, xf), cfg)
        try:
            yield
        finally:
            self.moe.route = orig

    @contextlib.contextmanager
    def record(self):
        calls = []

        def route(r, cfg):
            calls.append(r.experts)
            return r

        with self._wrapped(route):
            yield calls

    @contextlib.contextmanager
    def replay(self, calls):
        own = []

        def route(r, cfg):
            if len(own) == len(calls):
                fail(f"replay: more MoE calls than the {len(calls)} recorded")
            e = calls[len(own)]
            own.append(r.experts)
            w = r.probs.gather(-1, e)
            return self.moe.Routing(r.probs, w / w.sum(-1, keepdim=True), e, *self.moe.slots(cfg, e))

        with self._wrapped(route):
            yield own
        if len(own) != len(calls):
            fail(f"replay: {len(own)} MoE calls, {len(calls)} recorded")


def route_agreement(a_calls, b_calls, n_layers: int) -> list[float]:
    """For each of ``n_layers`` MoE layers, the share of ``a``'s (token,
    expert) choices that ``b`` made too, pooled over the passes (call i is
    layer i mod n_layers)."""
    hit, total = [0.0] * n_layers, [0] * n_layers
    for i, (a, b) in enumerate(zip(a_calls, b_calls, strict=True)):
        hit[i % n_layers] += float((a[:, :, None] == b[:, None, :]).any(-1).sum())
        total[i % n_layers] += a.numel()
    return [h / t for h, t in zip(hit, total)]


class F32View(dict):
    """A params tree read in fp32: each tensor is cast when the model reads
    it and freed after use, so a bf16 model that fills most of the card can
    also run the plain path in fp32 on the same (bf16-valued) weights."""

    def __getitem__(self, key):
        return _f32_view(super().__getitem__(key))


def _f32_view(v):
    if isinstance(v, dict):
        return F32View(v)
    if isinstance(v, list):
        return [_f32_view(x) for x in v]
    return v.float()


def n_prefix(cfg) -> int:
    """The positions a vision model's patches take before the prompt."""
    return cfg.frontend_len if cfg.frontend == "vision" else 0


def cross_run(torch, model, params, prompts, impl, feed=None, counts=None, frontend=None) -> list:
    """Prefill + CROSS_STEPS decode steps with the switch set to ``impl``;
    decode inputs from ``feed`` if given, else greedy; ``frontend`` holds the
    model's ``src_embeds`` or ``patch_embeds``.  Returns the
    last-position logits of each pass over the config's vocabulary (the
    padded rows hold -1e30), in fp32.  With a list ``counts``, the
    launch counts are set to 0 just before each pass and appended just after."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import set_attn_impl

    def counted(fn, *args):
        if counts is None:
            return fn(*args)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        counts.append(kops.launch_counts())
        return out

    set_attn_impl(impl)
    try:
        with torch.inference_mode():
            cache = model.init_cache(BATCH, n_prefix(model.cfg) + PROMPT_LEN + CROSS_STEPS + 1)
            prefill = functools.partial(model.prefill, **(frontend or {}))
            logits, cache = counted(prefill, params, prompts, cache)
            vocab = model.cfg.vocab
            outs = [logits[:, -1, :vocab].float()]
            for i in range(CROSS_STEPS):
                tok = feed[i] if feed is not None else outs[-1].argmax(-1, keepdim=True).int()
                logits, cache = counted(model.decode_step, params, tok, cache)
                outs.append(logits[:, -1, :vocab].float())
    finally:
        set_attn_impl(None)
    return outs


def fmt_list(xs, f: str = ".3e") -> str:
    return "[" + ", ".join(format(x, f) for x in xs) + "]"


def serve_launches(cfg) -> tuple[dict, dict]:
    """The launches of a prefill and of a decode step of ``cfg``.

    rmsnorm (none where the config's norm is LayerNorm, which is plain in
    both packages) on each block's norms (norm1, norm2 with an FFN, the
    cross-attention's, and two post norms with ``post_block_norm``), the
    final one, and at prefill the encoder's (2 a layer and ``enc_norm``).
    Flash at each attention layer of a prefill, the encoder's and the
    cross-attentions included; at a step, flash at each cross-attention and
    at each attention layer with a window (``attn_local``) or a logit
    softcap, which the decode kernel does not take, and decode attention at
    the others.  An MLA mixer (``mla``) is flash at a prefill and the MLA
    decode kernel at a step, and one rmsnorm more (its latent's).  A
    recurrent mixer launches none.  Each MoE FFN calls the slot kernel
    once, at a prefill and at a step."""
    kinds = cfg.layer_seq()
    cross = cfg.is_encoder_decoder
    per_ffn = 1 + cfg.post_block_norm
    norms = sum(1 + cfg.post_block_norm + cross + (f != "none") * per_ffn for _, f in kinds) + 1
    enc_norms = 2 * cfg.n_enc_layers + 1 if cross else 0
    if cfg.norm != "rmsnorm":
        norms = enc_norms = 0
    attn = [m for m, _ in kinds if m in ("attn", "attn_local")]
    to_flash = sum(cfg.attn_logit_softcap > 0 or (m == "attn_local" and cfg.sliding_window > 0) for m in attn)
    n_cross = len(kinds) if cross else 0
    n_enc = cfg.n_enc_layers if cross else 0
    n_mla = sum(m == "mla" for m, _ in kinds)
    n_moe = sum(f == "moe" for _, f in kinds)
    if cfg.norm == "rmsnorm":
        norms += n_mla
    return (nonzero({"rmsnorm": norms + enc_norms, "flash_attention": len(attn) + n_cross + n_enc + n_mla,
                     "moe_slots": n_moe}),
            nonzero({"rmsnorm": norms, "flash_attention": to_flash + n_cross,
                     "decode_attention": len(attn) - to_flash, "mla_decode": n_mla, "moe_slots": n_moe}))


def nonzero(counts: dict) -> dict:
    """``counts`` without its zeros, as ``ops.launch_counts`` reads them."""
    return {k: n for k, n in counts.items() if n}


def train_launches(cfg, pods: int) -> dict:
    """The launches of one training iteration of decoder-only ``cfg`` with
    remat at ``pods`` pods: each pod's forward launches what a prefill does
    (:func:`serve_launches`), and remat's recompute of every block again, all
    but the final norm, which lies outside the blocks."""
    fwd, _ = serve_launches(cfg)
    norms = fwd.get("rmsnorm", 0)
    return nonzero({"rmsnorm": pods * (2 * norms - int(norms > 0)),
                    "flash_attention": pods * 2 * fwd.get("flash_attention", 0),
                    "moe_slots": pods * 2 * fwd.get("moe_slots", 0)})


def serve_counted(torch, tag: str, cfg, smi: str, n_layers=None) -> tuple[dict, dict, float]:
    """``serve`` of ``cfg``'s arch on cuda (phase 4's batch, prompt and length,
    depth cut to ``n_layers`` if given), from launch counts of 0: the counts
    must be one prefill's and GEN - 1 steps' exactly.  Returns ``(serve's
    result, the counts, peak GB)``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve

    arch = cfg.name
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] before serve(): {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    res = serve(arch, smoke=False, batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN, seed=SEED, n_layers=n_layers)
    counts = kops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = res["tokens"]
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{arch}: tokens out of range or shape: {toks.shape}, [{toks.min()}, {toks.max()}]")
    steps = GEN - 1
    per_prefill, per_step = serve_launches(cfg)
    want = {k: per_prefill.get(k, 0) + steps * per_step.get(k, 0) for k in {**per_prefill, **per_step}}
    print(f"[{tag}] {arch} launches in serve() {counts} (expected {want})")
    if counts != want:
        fail(f"{arch}: the serving path did not launch each kernel as expected")
    print(f"[{tag}] {arch} prefill {res['prefill_s'] * 1e3:.2f} ms, decode {res['decode_s'] * 1e3:.2f} ms for "
          f"{steps} steps ({res['tok_per_s']:.1f} tok/s), peak memory {peak_gb:.2f} GB  ({smi})")
    torch.cuda.empty_cache()
    return res, counts, peak_gb


def hold_paths(torch, tag: str, model, params, prompts, tol: float, frontend=None) -> dict:
    """Prefill + CROSS_STEPS decode steps on the kernel path, with each pass's
    launches counted from 0 and checked; then on the plain path free (its own
    MoE routing, printed) and with routing forced to the kernel path's
    (:class:`RouteTape`; none where the model has no MoE FFN), and in fp32
    (read through :class:`F32View`), forced too.  Fails unless the forced
    run's last-position logits are within ``tol`` of the kernel path's by
    relative L2, the plain path's own top-k agrees with the kernel path's on
    ROUTE_AGREE of the choices of every MoE layer, and the kernel path is at
    most F32_RATIO times as far from fp32 as the plain bf16 path; each gate
    fails on NaN.  ``frontend`` is passed to each prefill.  Returns the
    numbers and ``feed``, the kernel path's tokens."""
    from repro_torch.models import Model

    cfg = model.cfg
    arch = cfg.name
    n_moe = sum(f == "moe" for _, f in cfg.layer_seq())
    per_prefill, per_step = serve_launches(cfg)
    tape = RouteTape()
    path = []
    with tape.record() as rec:
        kern = cross_run(torch, model, params, prompts, "kernel", counts=path, frontend=frontend)
    print(f"[{tag}] {arch} launches a prefill {path[0]}, a decode step {path[1]} "
          f"(expected {per_prefill}, {per_step})")
    if path[0] != per_prefill or any(c != per_step for c in path[1:]):
        fail(f"{arch}: a prefill or a decode step did not launch each kernel as expected: {path}")
    if not all(bool(o.isfinite().all()) for o in kern):
        fail(f"{arch}: non-finite logits on the kernel path")
    feed = [o.argmax(-1, keepdim=True).int() for o in kern[:-1]]
    with tape.record() as rec_free:
        free = cross_run(torch, model, params, prompts, "plain", feed, frontend=frontend)
    with tape.replay(rec) as own:
        forced = cross_run(torch, model, params, prompts, "plain", feed, frontend=frontend)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), "cuda")
    with tape.replay(rec) as own32:
        f32 = cross_run(torch, m32, F32View(params), prompts, "plain", feed, frontend=frontend)
    del m32
    torch.cuda.empty_cache()
    rel_free = [rel_l2(a, b) for a, b in zip(kern, free)]
    rel_forced = [rel_l2(a, b) for a, b in zip(kern, forced)]
    k32 = [rel_l2(a, b) for a, b in zip(kern, f32)]
    p32 = [rel_l2(a, b) for a, b in zip(forced, f32)]
    ratios = [a / b for a, b in zip(k32, p32)]
    out = {"rel_l2_free": rel_free, "rel_l2_forced": rel_forced, "fp32_ratio": ratios}
    if n_moe:
        agree_free = route_agreement(rec, rec_free, n_moe)
        agree = route_agreement(rec, own, n_moe)
        agree32 = route_agreement(rec, own32, n_moe)
        out.update(route_agreement_free=agree_free, route_agreement_forced=agree, route_agreement_fp32=agree32)
        print(f"[{tag}] {arch} plain vs kernel, free run (own routing, teacher-forced tokens): last-position "
              f"logits rel L2 per pass {fmt_list(rel_free)}; routing agreement per MoE layer "
              f"{fmt_list(agree_free, '.4f')} (min {min(agree_free):.4f}, printed, not held)")
        print(f"[{tag}] {arch} plain vs kernel, routing forced to the kernel path's: rel L2 per pass "
              f"{fmt_list(rel_forced)} (tol {tol:g}); the plain path's own top-k agrees per MoE "
              f"layer {fmt_list(agree, '.4f')} (min {min(agree):.4f}, tol {ROUTE_AGREE:g}); fp32's own "
              f"top-k agrees {fmt_list(agree32, '.4f')}")
    else:
        agree = []
        print(f"[{tag}] {arch} plain vs kernel (teacher-forced tokens): last-position logits rel L2 per pass "
              f"{fmt_list(rel_forced)} (tol {tol:g})")
    print(f"[{tag}] {arch} against the plain path in fp32 (same weights{', routing forced' if n_moe else ''}), "
          f"rel L2 per pass: kernel {fmt_list(k32)}, plain bf16 {fmt_list(p32)}; kernel / plain "
          f"{fmt_list(ratios)} (tol {F32_RATIO:g})")
    # Written so that a NaN fails each test.
    if not all(r <= tol for r in rel_forced):
        fail(f"{arch}: the kernel path disagrees with the plain path: rel L2 {rel_forced}")
    if not all(a >= ROUTE_AGREE for a in agree):
        fail(f"{arch}: the two paths route alike on only {min(agree):.2%} of choices in a layer")
    if not all(r <= F32_RATIO for r in ratios):
        fail(f"{arch}: kernel path is {ratios} times as far from fp32 as the plain bf16 path")
    return {"launches": {"prefill": path[0], "step": path[1]}, **out, "feed": feed}


def decode_bound(model, params, sku: str) -> tuple[float, float]:
    """The least time of a decode step, ms, and its GB: every weight of the
    decoder and the head read once (the embedding table only where it is
    tied, as the head; not the encoder's or ``vision_proj``, which only a
    prefill reads), each attention layer's K and V up to their mean length
    over the timed and profiled steps (at most the window of a local layer),
    the encoder's output that the cross-attention reads, and each recurrent
    state read and written, at the memory rate."""
    from repro_torch._bridge import tree_leaves

    def size(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    cfg = model.cfg
    emb = params["embed"]
    es = emb.element_size()
    read = [params["layers"], params["final_norm"], params.get("lm_head")]
    if cfg.tied_embeddings:
        read.append(emb)
    nbytes = size(read)
    rows = n_prefix(cfg) + PROMPT_LEN + 9  # the mean cache length over the timed and the profiled steps
    kinds = cfg.layer_seq()
    kv_rows = sum(min(rows, cfg.sliding_window) if m == "attn_local" and cfg.sliding_window else rows
                  for m, _ in kinds if m in ("attn", "attn_local"))
    nbytes += 2 * BATCH * kv_rows * cfg.kv_dim * es
    if cfg.is_encoder_decoder:
        nbytes += BATCH * cfg.frontend_len * cfg.d_model * es
    states = [e["state"] for e in model.init_cache(BATCH, 1)["layers"] if "state" in e]
    nbytes += 2 * size(states)
    return nbytes / PEAKS[sku]["bytes"] * 1e3, nbytes / 1e9


def profiled_decode_bound(torch, tag: str, model, params, prompts, smi: str, sku: str, frontend=None) -> dict:
    """Phase 6's decode profile, set beside the step's bound (:func:`decode_bound`)."""
    prof = profile_decode(torch, model, params, prompts, smi, tag=tag, frontend=frontend)
    bound_ms, gb = decode_bound(model, params, sku)
    print(f"[{tag}] {model.cfg.name} decode step: bound {bound_ms:.3f} ms ({gb:.2f} GB of weights, cache and "
          f"state at {PEAKS[sku]['bytes'] / 1e12:.2f} TB/s); measured wall {prof['step_wall_ms']:.3f} ms, "
          f"device {prof['step_device_ms']:.3f} ms over {prof['step_device_ops']:.0f} ops, "
          f"busy {prof['busy_share']:.1%}  ({smi})")
    return {"decode_bound_ms": bound_ms, "decode_bound_gb": gb, "profile": prof}


def moe_serve(torch, arch: str, smi: str, sku: str) -> dict:
    """Phase 10a: serve ``arch`` at full width through ``serve`` on cuda with
    exact launch counts, hold the kernel path against the plain path (free
    and with routing forced) and fp32, and profile decode."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import Model, moe

    cfg = get_config(arch)
    m = cfg.moe
    kinds = cfg.layer_seq()
    n, n_moe = len(kinds), sum(f == "moe" for _, f in kinds)
    print(f"[10] serve {arch} full width: {n} layers ({n_moe} MoE: {m.n_experts} experts top-{m.top_k}, "
          f"d_expert {m.d_expert}, {m.n_shared} shared; {n - n_moe} dense first, d_ff {cfg.d_ff}), "
          f"d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}, "
          f"{cfg.dtype}")
    res, counts, peak_gb = serve_counted(torch, "10", cfg, smi)

    # The kernel path against the plain path, on the same weights and prompts.
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, SEED, "cuda")
    held = hold_paths(torch, "10", model, params, prompts, MOE_REL_L2_TOL)
    held.pop("feed")
    # The MoE FFN waits on nothing on the device (a CUDA graph of the decode
    # step could hold it): one call at a prefill's and one at a decode step's
    # token count, with any synchronising operation made an error.
    ffn = params["layers"][kinds.index(("attn", "moe"))]["ffn"]
    xs = [params["embed"][prompts[:, :rows].long()] for rows in (PROMPT_LEN, 1)]  # [B, rows, d]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for x in xs:
                moe.apply_moe(cfg, ffn, x)
    except RuntimeError as e:
        fail(f"{arch}: apply_moe synchronises with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[10] {arch} apply_moe at {BATCH} x {PROMPT_LEN} and {BATCH} x 1 tokens under "
          f"torch.cuda.set_sync_debug_mode('error'): no synchronising operation")

    # Where a decode step's time goes, and the least time it could take: a
    # step reads every weight (each expert's whole matrix, as the capacity
    # buffer multiplies all E experts).
    bound = profiled_decode_bound(torch, "10", model, params, prompts, smi, sku)
    del model, params, prompts
    torch.cuda.empty_cache()
    launches = held.pop("launches")
    return {
        "params": n_params, "launches": {"serve": counts, **launches},
        "prefill_ms": res["prefill_s"] * 1e3, "decode_ms": res["decode_s"] * 1e3,
        "tok_per_s": res["tok_per_s"], "peak_gb": peak_gb, **held, **bound, "device": smi,
    }


def moe_train(torch, smi: str, sku: str) -> dict:
    """Phase 10b: granite-moe at full width and depth through ``Trainer`` on
    cuda: one iteration from launch counts of 0 (finite loss and grad norm,
    aux > 0, every leaf changed, the router included), MOE_TRAIN_TIMED timed
    and one profiled; then one fwdbwd held against the plain path and fp32
    with routing forced (:func:`hold_fwdbwd`)."""
    from repro_torch._bridge import to_torch, tree_flatten_with_path, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import Trainer

    sync = torch.cuda.synchronize
    cfg = get_config(MOE_TRAIN_ARCH)
    n = cfg.n_layers
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, steps=1 + MOE_TRAIN_TIMED, n_pods=TRAIN_PODS, global_batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, ckpt_dir=None, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"[10] train {MOE_TRAIN_ARCH} at full width and depth ({n} layers, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}, {cfg.dtype}, remat {cfg.remat}), {n_params / 1e9:.3f} B params; "
          f"{TRAIN_PODS} pods, int8 gradsync, global batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    p0 = tr.params
    sync()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    m = tr.iteration(0)
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kops.launch_counts()
    want = {"rmsnorm": TRAIN_PODS * ((2 * n + 1) + 2 * n), "flash_attention": TRAIN_PODS * 2 * n,
            "moe_slots": TRAIN_PODS * 2 * n}
    print(f"[10] {MOE_TRAIN_ARCH} launches in one iteration {counts} (expected {want}); loss "
          f"{m['loss']:.6f}, ce {m['ce']:.6f}, aux {m['aux']:.6f}, grad norm {m['grad_norm']:.4f}")
    if counts != want:
        fail(f"{MOE_TRAIN_ARCH}: the training path did not launch each kernel as expected")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["aux"] > 0):
        fail(f"{MOE_TRAIN_ARCH}: non-finite loss or grad_norm, or aux not > 0: {m}")
    same = [nm for (nm, a), b in zip(tree_flatten_with_path(p0), tree_leaves(tr.params)) if torch.equal(a, b)]
    if same:
        fail(f"{MOE_TRAIN_ARCH}: {len(same)} param leaves unchanged by an update: {same[:4]}")
    routers = [t for nm, t in tree_flatten_with_path(tr.params) if nm.endswith("router/w")]
    if len(routers) != n or any(t.dtype != torch.float32 for t in routers):
        fail(f"{MOE_TRAIN_ARCH}: the routers are not {n} fp32 leaves after an update")
    del p0
    iter_ms = []
    for it in range(1, 1 + MOE_TRAIN_TIMED):
        sync()
        t0 = time.perf_counter()
        m = tr.iteration(it)
        sync()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"{MOE_TRAIN_ARCH}: non-finite loss or grad_norm at iteration {it}: {m}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(iter_ms)
    print(f"[10] {MOE_TRAIN_ARCH} ms an iteration: first (counted) {first_ms:.2f}, then {fmt_ms(iter_ms)}, "
          f"median {med:.2f} ms; {tokens / med * 1e3:.1f} tokens/s; peak memory {peak_gb:.2f} GB  ({smi})")
    beside_torch_backend("10", "M-train", iter_ms, peak_gb)
    fam, flops, share, ops, busy = profiled_iteration(torch, tr, 1 + MOE_TRAIN_TIMED, med, "10", smi, sku)

    params, grad_fn = tr.params, tr.grad_fn
    batch = {k: to_torch(v, "cuda") for k, v in tr.dataset.batch(0, 0, TRAIN_PODS).items()}
    del tr
    torch.cuda.empty_cache()
    held = hold_fwdbwd(torch, "10", MOE_TRAIN_ARCH, cfg, params, batch, grad_fn, RouteTape())
    del params
    torch.cuda.empty_cache()
    return {"launches": counts, "first_ms": first_ms, "iter_ms": iter_ms, "median_ms": med,
            "tokens_per_s": tokens / med * 1e3, "peak_gb": peak_gb, "device_ms": fam, "device_ops": ops,
            "busy_share": busy, "flops": flops, "bf16_share": share,
            "metrics": {k: float(v) for k, v in m.items()}, **held, "params": n_params, "device": smi}


def phase_moe(torch, smi: str, sku: str) -> dict:
    """Phase 10: MoE on the card — serve both MoE archs at full width, then
    train granite-moe; each model is freed before the next is made."""
    torch.cuda.empty_cache()
    out = {arch: moe_serve(torch, arch, smi, sku) for arch in MOE_ARCHS}
    out["train"] = moe_train(torch, smi, sku)
    return out


def no_host_sync(torch, tag: str, model, params, x) -> None:
    """Each recurrent mixer of ``model``, at ``x``'s rows [B, L, d] from no
    state and then one row from the state it returned, under
    ``set_sync_debug_mode("error")``: nothing in it may wait on the device."""
    from repro_torch.models import recurrent

    kinds = model.cfg.layer_seq()
    mixers = sorted({m for m, _ in kinds if m != "attn"})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for mixer in mixers:
                p = params["layers"][[m for m, _ in kinds].index(mixer)]["mixer"]
                mix = getattr(recurrent, f"{mixer}_mix")
                _, st = mix(model.cfg, p, x)
                mix(model.cfg, p, x[:, -1:], st)
    except RuntimeError as e:
        fail(f"{model.cfg.name}: a recurrent mixer synchronises with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"[{tag}] {model.cfg.name} {', '.join(mixers)} at {x.shape[0]} x {x.shape[1]} tokens and 1 token from "
          f"their state under torch.cuda.set_sync_debug_mode('error'): no synchronising operation")


def decode_vs_forward(torch, tag: str, model, params, prompts, feed, frontend=None) -> dict:
    """Prefill + CROSS_STEPS decode steps against one cache-free forward over
    the same tokens, the last-position logits of each pass against the
    forward's at that position, on the kernel path: in fp32 (the bf16 weights
    read through :class:`F32View`), gated by DECODE_F32_REL_L2_TOL, and in
    bf16, printed.  A MoE FFN gets a capacity factor of E / k, so that no
    choice is dropped in either run (a forward routes all L tokens at once,
    a step B).  ``frontend`` goes to the prefill and to the forward, whose
    logits at the patches of a vision model are passed over."""
    from repro_torch.models import Model, set_attn_impl

    cfg = model.cfg
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                                                / cfg.moe.top_k))
    tokens = torch.cat([prompts, *feed], dim=1)  # [B, PROMPT_LEN + CROSS_STEPS]
    out = {}
    for label, c, p in (("fp32", dataclasses.replace(cfg, dtype="float32"), F32View(params)),
                        ("bf16", cfg, params)):
        m = Model(c, "cuda")
        dec = cross_run(torch, m, p, prompts, "kernel", feed, frontend=frontend)
        set_attn_impl("kernel")
        try:
            with torch.inference_mode():
                first = n_prefix(cfg) + PROMPT_LEN - 1
                full = m.forward(p, tokens, **(frontend or {}))[:, first:, : cfg.vocab].float()
        finally:
            set_attn_impl(None)
        out[label] = [rel_l2(d, full[:, i]) for i, d in enumerate(dec)]
        del m, dec, full
        torch.cuda.empty_cache()
    print(f"[{tag}] {cfg.name} decode vs a cache-free forward over the same {tokens.shape[1]} tokens on the "
          f"kernel path, last-position logits rel L2 per pass: fp32 {fmt_list(out['fp32'])} "
          f"(tol {DECODE_F32_REL_L2_TOL:g}), bf16 {fmt_list(out['bf16'])} (printed, not held)")
    if not all(r <= DECODE_F32_REL_L2_TOL for r in out["fp32"]):
        fail(f"{cfg.name}: decode disagrees with the cache-free forward: {out}")
    return out


def profile_prefill(torch, tag: str, model, params, prompts, smi: str, frontend=None) -> dict:
    """A prefill's wall time (warm, the median of 3) beside its device time
    and ops (one profiled prefill, with ``frontend`` passed to it), and each
    recurrent mixer's the same way at the prefill's rows: the host's share of
    a prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import recurrent

    def timed(fn) -> dict:
        with torch.inference_mode():
            fn()  # warm
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        wall = statistics.median(walls)
        ms = sum(e.device_time_total for e in dev) / 1e3
        return {"wall_ms": wall, "device_ms": ms, "device_ops": sum(e.count for e in dev), "busy_share": ms / wall}

    cfg = model.cfg
    out = {"prefill": timed(lambda: model.prefill(params, prompts, model.init_cache(BATCH, n_prefix(cfg) + PROMPT_LEN),
                                                  **(frontend or {})))}
    kinds = [m for m, _ in cfg.layer_seq()]
    x = params["embed"][prompts.long()]
    for mixer in sorted(set(kinds) - {"attn", "attn_local"}):
        p = params["layers"][kinds.index(mixer)]["mixer"]
        mix = getattr(recurrent, f"{mixer}_mix")
        out[mixer] = timed(lambda p=p, mix=mix: mix(cfg, p, x))
    for k, r in out.items():
        what = "a prefill" if k == "prefill" else f"one {k} layer at the prefill's rows"
        print(f"[{tag}] {cfg.name} {what}: wall {r['wall_ms']:.3f} ms (median of 3, warm), device "
              f"{r['device_ms']:.3f} ms over {r['device_ops']} ops, busy {r['busy_share']:.1%}  ({smi})")
    return out


def serve_and_hold(torch, tag: str, arch: str, n_layers, tol: float, smi: str, sku: str) -> dict:
    """Phases 11a and 12: serve ``arch`` (depth cut to ``n_layers`` if given)
    through ``serve`` on cuda with exact launch counts; hold the kernel path
    against the plain path (MoE routing forced) within ``tol`` and against
    fp32; check any recurrent mixer for host syncs; hold decode against a
    cache-free forward; profile prefill and decode, the latter beside its
    bound.  The frontend's inputs are made as ``serve`` makes them."""
    from repro_torch._bridge import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_frontend, make_prompts
    from repro_torch.models import Model

    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    kinds = cfg.layer_seq()
    mixers = {m: sum(k == m for k, _ in kinds) for m in dict.fromkeys(k for k, _ in kinds)}
    ffns = {f: sum(k == f for _, k in kinds) for f in dict.fromkeys(k for _, k in kinds)}
    extra = [cfg.norm, cfg.activation]
    if cfg.sliding_window:
        extra.append(f"window {cfg.sliding_window}")
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        extra.append(f"softcaps {cfg.attn_logit_softcap:g} / {cfg.final_logit_softcap:g}")
    if cfg.post_block_norm:
        extra.append("post norms")
    if cfg.qkv_bias:
        extra.append("QKV bias")
    if cfg.is_encoder_decoder:
        extra.append(f"{cfg.n_enc_layers} encoder layers over {cfg.frontend_len} frames, cross-attention")
    if cfg.frontend == "vision":
        extra.append(f"{cfg.frontend_len} patches before the prompt")
    print(f"[{tag}] serve {arch}: {len(kinds)} of {full_layers} layers at full width, mixers {mixers}, FFNs "
          f"{ffns}, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {', '.join(extra)}, {cfg.dtype}")
    res, counts, peak_gb = serve_counted(torch, tag, cfg, smi, n_layers=n_layers)

    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    print(f"[{tag}] {arch}: {n_params / 1e9:.3f} B params, {gb:.2f} GB")
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, SEED, "cuda")
    frontend = make_frontend(cfg, BATCH, SEED, "cuda")
    held = hold_paths(torch, tag, model, params, prompts, tol, frontend)
    feed = held.pop("feed")
    if set(mixers) - {"attn", "attn_local"}:
        no_host_sync(torch, tag, model, params, params["embed"][prompts.long()])
    dvf = decode_vs_forward(torch, tag, model, params, prompts, feed, frontend)
    pre = profile_prefill(torch, tag, model, params, prompts, smi, frontend)
    bound = profiled_decode_bound(torch, tag, model, params, prompts, smi, sku, frontend)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail(f"TF32 was turned on during phase {tag}")
    del model, params, prompts, frontend
    gc.collect()
    torch.cuda.empty_cache()
    launches = held.pop("launches")
    return {
        "layers": len(kinds), "of_layers": full_layers, "params": n_params, "params_gb": gb,
        "launches": {"serve": counts, **launches}, "prefill_ms": res["prefill_s"] * 1e3,
        "decode_ms": res["decode_s"] * 1e3, "tok_per_s": res["tok_per_s"], "peak_gb": peak_gb, **held,
        "decode_vs_forward": dvf, "prefill_profile": pre, **bound, "device": smi,
    }


def mixers_card_vs_cpu(torch, smi: str) -> dict:
    """Phase 11b: each recurrent mixer at full width in fp32, on the card
    against the same mixer on the CPU, the same weights (drawn on the CPU
    from SEED) and unit-normal inputs: from a state the CPU carried out of 16
    tokens, a prefill of PROMPT_LEN tokens and then one step from each side's
    own state.  Every output and state field must be within fp32 TOL by
    relative L2; element-wise errors are printed.  (Element-wise, the mLSTM
    is ill-conditioned where its normaliser |n·q| nears exp(-m): on the CPU,
    summing one fp32 matmul in another order already moves single elements
    of y past TOL, while y as a whole stays well inside it.)  The same run with TF32 on, a
    planted fault, must read beyond TOL, or the check could not see TF32."""
    from repro_torch._bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import recurrent

    tol = 2e-5  # TOL of tests/test_kernels.py, fp32
    out = {}
    for mixer, arch in (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-125m"), ("slstm", "xlstm-125m")):
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        g = torch.Generator().manual_seed(SEED)
        p = getattr(recurrent, f"init_{mixer}")(g, cfg, torch.float32)
        mix = getattr(recurrent, f"{mixer}_mix")
        xs = [torch.randn((BATCH, n, cfg.d_model), generator=g) for n in (16, PROMPT_LEN, 1)]
        with torch.inference_mode():
            _, st0 = mix(cfg, p, xs[0])
            want, st = [], st0
            for x in xs[1:]:
                y, st = mix(cfg, p, x, st)
                want.append((y, *st))
            pc = tree_map(lambda t: t.cuda(), p)

            def on_card():
                got, sc = [], tree_map(lambda t: t.cuda(), st0)
                for x in xs[1:]:
                    y, sc = mix(cfg, pc, x.cuda(), sc)
                    got.append(tuple(t.cpu() for t in (y, *sc)))
                return got

            got = on_card()
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                planted = on_card()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        names = ("y", *st0._fields)
        rels = {f"{call} {n}": rel_l2(a, b) for call, gw, ww in (("prefill", got[0], want[0]), ("step", got[1], want[1]))
                for n, a, b in zip(names, gw, ww)}
        tf32 = max(rel_l2(a[0], b[0]) for a, b in zip(planted, want))
        elem = max(close(a, b, tol)[0] for gw, ww in zip(got, want) for a, b in zip(gw, ww))
        shape = {"mamba": f"d {cfg.d_model}, d_inner {recurrent.d_inner(cfg)}, d_state {cfg.ssm.d_state}",
                 "mlstm": f"{cfg.n_heads} heads of {cfg.head_dim}", "slstm": f"d {cfg.d_model}"}[mixer]
        worst = max(rels, key=rels.get)
        print(f"[11] {mixer} ({shape}) fp32 on the card vs the CPU, from a carried state, prefill {BATCH} x "
              f"{PROMPT_LEN} then one step: {', '.join(names)} rel L2 at most {rels[worst]:.3e} ({worst}; tol "
              f"{tol:g}), max abs err {elem:.3e}; y with TF32 on (planted) {tf32:.3e}  ({smi})")
        if not (all(r <= tol for r in rels.values()) and tf32 > tol):
            fail(f"{mixer} on the card disagrees with the CPU, or cannot tell TF32: {rels}, TF32 {tf32:.3e}")
        out[mixer] = {"rel_l2": rels, "max_abs_err": elem, "tf32_planted_rel_l2": tf32}
    return out


def phase_recurrent(torch, smi: str, sku: str) -> dict:
    """Phase 11: the recurrent archs on the card — serve each (each model
    freed before the next is made), then each mixer against the CPU."""
    torch.cuda.empty_cache()
    out = {arch: serve_and_hold(torch, "11", arch, n, REC_REL_L2_TOL[arch], smi, sku)
           for arch, n in REC_ARCHS.items()}
    out["card_vs_cpu"] = mixers_card_vs_cpu(torch, smi)
    return out


def phase_families(torch, smi: str, sku: str) -> dict:
    """Phase 12: the other families on the card — serve each (each model
    freed before the next is made)."""
    return {arch: serve_and_hold(torch, "12", arch, n, FAMILY_REL_L2_TOL, smi, sku)
            for arch, n in FAMILY_ARCHS.items()}


def child(torch, out: Path, phase) -> int:
    """``--families OUT``, ``--training OUT`` and the other child options:
    one phase alone, in a process of its own; writes its result to OUT as
    JSON."""
    from repro_torch.kernels import ops as kops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kops.build()  # built already by the parent: found by its hash
    res = phase(torch, nvidia_smi(), sku_of(torch.cuda.get_device_name(0)))
    out.write_text(json.dumps(res))
    return 0


def run_child(tag: str, flag: str, what: str) -> dict:
    """Phase ``tag`` in a child process (``chip_smoke.py FLAG OUT``), whose
    lines print as they come and whose result is read back from OUT.  Its
    failure, or a child past CHILD_TIMEOUT, fails the run."""
    out = ROOT / "build" / f"{flag.strip('-')}.json"
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    t0 = time.monotonic()
    try:
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag, str(out)], cwd=ROOT,
                            timeout=CHILD_TIMEOUT).returncode
    except subprocess.TimeoutExpired:
        fail(f"phase {tag} ({what}'s child process) ran past {CHILD_TIMEOUT} s")
    if rc != 0:
        fail(f"phase {tag} ({what}'s child process) exited {rc}")
    print(f"[{tag}] {what}'s child process took {time.monotonic() - t0:.1f} s")
    return json.loads(out.read_text())


# -- phase 13: training xlstm-125m and gemma2-27b, the mixers' backward -------------


def train_cell(torch, cell: str, smi: str, sku: str) -> dict:
    """Phase 13a/b: one TR cell through ``Trainer`` on cuda (TRAIN_CELLS:
    arch, depth, pods, timed iterations; phase 9's batch, sequence and int8
    gradsync, bf16, remat).  The first iteration must give a finite loss and
    grad norm, change every leaf, keep each leaf's dtype and the fp32 leaves
    (FP32_LEAF) fp32, and, from launch counts of 0, launch each kernel
    exactly as :func:`train_launches` counts.  Prints ms an iteration,
    tokens/s, peak GB, each step's ms, device ops, busy share and device time
    by family (and, for xlstm, the sLSTM loop's share of the ops); then one
    fwdbwd is held against the plain path and fp32 (:func:`hold_fwdbwd`)."""
    from repro_torch._bridge import to_torch, tree_flatten_with_path, tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import Trainer

    sync = torch.cuda.synchronize
    arch, n_layers, pods, timed = TRAIN_CELLS[cell]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, steps=3 + timed, n_pods=pods, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                 ckpt_dir=None, device="cuda")
    sync()
    init_s = time.perf_counter() - t0
    named = tree_flatten_with_path(tr.params)
    n_params = sum(t.numel() for _, t in named)
    kinds = sorted({m for m, _ in cfg.layer_seq()})
    print(f"[13] {cell}: {arch}, {cfg.n_layers} layers ({', '.join(kinds)}) at full width (d {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.dtype}, remat {cfg.remat}), {n_params / 1e9:.3f} B params, made in "
          f"{init_s:.1f} s; {pods} pod(s), int8 gradsync, global batch {TRAIN_BATCH} x {TRAIN_SEQ}")
    fp32 = [n for n, t in named if t.dtype == torch.float32]
    if fp32 != [n for n, _ in named if FP32_LEAF.search(n)]:
        fail(f"{cell}: the fp32 leaves at init are not the gate leaves: {fp32[:6]}")
    p0 = tr.params
    sync()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    m = tr.iteration(0)  # the first: counted and checked, its time includes the cold start
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = kops.launch_counts()
    want = train_launches(cfg, pods)
    print(f"[13] {cell} launches in one iteration {counts} (expected {want})")
    if counts != want:
        fail(f"{cell}: the training path did not launch each kernel as expected")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        fail(f"{cell}: non-finite loss or grad_norm {m}")
    after = tree_leaves(tr.params)
    same = [n for (n, a), b in zip(named, after) if torch.equal(a, b)]
    moved = [n for (n, a), b in zip(named, after) if a.dtype != b.dtype]
    if same or moved:
        fail(f"{cell}: leaves unchanged by an update {same[:4]}, or of another dtype after it {moved[:4]}")
    print(f"[13] {cell} first iteration {first_ms:.2f} ms: loss {m['loss']:.6f}, grad norm {m['grad_norm']:.4f}; "
          f"all {len(after)} leaves changed, each kept its dtype; {len(fp32)} fp32 leaves (the gates) still fp32")
    del p0, named, after
    iter_ms = []
    for it in range(1, 1 + timed):
        sync()
        t0 = time.perf_counter()
        m = tr.iteration(it)
        sync()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            fail(f"{cell}: non-finite loss or grad_norm at iteration {it}: {m}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(iter_ms)
    print(f"[13] {cell} ms an iteration {fmt_ms(iter_ms)}, median {med:.2f} ms; {tokens / med * 1e3:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB  ({smi})")
    it = 1 + timed
    step_ms = step_times(torch, tr, it)
    print(f"[13] {cell} steps of one iteration (host clock, synchronised): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in step_ms.items()) + f"  ({smi})")
    fam, flops, share, ops, busy = profiled_iteration(torch, tr, it + 1, med, "13", smi, sku)
    out = {"arch": arch, "layers": cfg.n_layers, "pods": pods, "params": n_params, "launches": counts,
           "first_ms": first_ms, "iter_ms": iter_ms, "median_ms": med, "tokens_per_s": tokens / med * 1e3,
           "peak_gb": peak_gb, "step_ms": step_ms, "device_ms": fam, "device_ops": ops, "busy_share": busy,
           "flops": flops, "bf16_share": share, "fp32_leaves": len(fp32),
           "metrics": {k: float(v) for k, v in m.items()}, "device": smi}
    if "slstm" in kinds:
        out["slstm_loop_ops"] = slstm_loop_ops(torch, cfg, tr.params, pods, ops)
    params, grad_fn = tr.params, tr.grad_fn
    batch = {k: to_torch(v, "cuda") for k, v in tr.dataset.batch(0, 0, pods).items()}
    del tr
    torch.cuda.empty_cache()
    out.update(hold_fwdbwd(torch, "13", cell, cfg, params, batch, grad_fn, bf16_leaves=BF16_LEAVES_HELD[cell],
                           fp32_kernel=True))
    del params, batch
    torch.cuda.empty_cache()
    return out


def slstm_loop_ops(torch, cfg, params, pods: int, iteration_ops: int) -> int:
    """The device ops of the sLSTM's loop over time in one iteration: one
    sLSTM layer's forward and backward at a pod's rows (bf16), profiled and
    counted, times each pod's sLSTM layers, forward twice (remat)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._bridge import tree_leaves, tree_map
    from repro_torch.models import recurrent

    layers = [i for i, (mix, _) in enumerate(cfg.layer_seq()) if mix == "slstm"]
    p = params["layers"][layers[0]]["mixer"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((TRAIN_BATCH // pods, TRAIN_SEQ, cfg.d_model), generator=g, device="cuda").bfloat16()
    x.requires_grad_()
    pl = tree_map(lambda t: t.detach().requires_grad_(), p)
    leaves = tree_leaves(pl)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        y, _ = recurrent.slstm_mix(cfg, pl, x)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        torch.autograd.grad(y.float().sum(), [x, *leaves])
        torch.cuda.synchronize()
    f, b = len(device_events(fwd)), len(device_events(bwd))
    loop = pods * len(layers) * (2 * f + b)
    print(f"[13] the sLSTM loop: one layer at [{TRAIN_BATCH // pods}, {TRAIN_SEQ}, {cfg.d_model}] launches {f} "
          f"device ops forward ({f / TRAIN_SEQ:.1f} a token) and {b} backward; {pods} pod(s) x {len(layers)} "
          f"layers x (forward, recompute, backward) = {loop} of the iteration's {iteration_ops} ops "
          f"({loop / iteration_ops:.1%})")
    return loop


def mixers_backward_card_vs_cpu(torch, smi: str, device: str = "cuda", cfgs=None, plant=None) -> dict:
    """Phase 13c: each recurrent mixer's backward at full width in fp32 (as
    phase 11b holds its forward): mamba at jamba's width, the mLSTM and the
    sLSTM at xlstm's (or ``cfgs``, mixer -> config).  The weights are drawn
    on the CPU from SEED, the input and a fixed random projection P of the
    output too; the loss is sum(y * P) over a prefill of BATCH x PROMPT_LEN
    tokens from no state.  On ``device`` every weight's grad and the input's
    must be within fp32 TOL of the CPU's by relative L2 (:func:`leaf_rel_l2`),
    and with ``plant`` (a context manager; on the card, TF32 on) beyond it
    somewhere, or the check could not see such a fault."""
    from repro_torch._bridge import tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import recurrent

    tol = 2e-5  # TOL of tests/test_kernels.py, fp32
    if cfgs is None:
        cfgs = {mixer: dataclasses.replace(get_config(arch), dtype="float32")
                for mixer, arch in (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-125m"), ("slstm", "xlstm-125m"))}
    if plant is None:
        plant = tf32_on
    out = {}
    for mixer, cfg in cfgs.items():
        g = torch.Generator().manual_seed(SEED)
        p = getattr(recurrent, f"init_{mixer}")(g, cfg, torch.float32)
        x = torch.randn((BATCH, PROMPT_LEN, cfg.d_model), generator=g)
        proj = torch.randn((BATCH, PROMPT_LEN, cfg.d_model), generator=g)
        names = ["x"] + [n for n, _ in tree_flatten_with_path(p)]

        def grads(dev):
            pd = tree_map(lambda t: t.to(dev).requires_grad_(), p)
            xd = x.to(dev).requires_grad_()
            y, _ = getattr(recurrent, f"{mixer}_mix")(cfg, pd, xd)
            return [t.cpu() for t in torch.autograd.grad((y * proj.to(dev)).sum(), [xd, *tree_leaves(pd)])]

        want = grads("cpu")
        got = grads(device)
        with plant():
            planted = grads(device)
        rels = dict(zip(names, leaf_rel_l2(got, want)))
        fault = max(leaf_rel_l2(planted, want))
        worst = max(rels, key=rels.get)
        shape = {"mamba": f"d {cfg.d_model}, d_inner {recurrent.d_inner(cfg)}, d_state {cfg.ssm.d_state}",
                 "mlstm": f"{cfg.n_heads} heads of {cfg.head_dim}", "slstm": f"d {cfg.d_model}"}[mixer]
        print(f"[13] {mixer} ({shape}) backward, fp32 on {device} vs the CPU, prefill {BATCH} x {PROMPT_LEN}: "
              f"{len(names)} grads (the input's and every weight's), rel L2 at most {rels[worst]:.3e} ({worst}; "
              f"tol {tol:g}); planted fault {fault:.3e}  ({smi})")
        if not (all(r <= tol for r in rels.values()) and fault > tol):
            fail(f"{mixer}'s backward on {device} disagrees with the CPU, or cannot tell the planted fault: "
                 f"{rels}, planted {fault:.3e}")
        out[mixer] = {"rel_l2": rels, "planted_rel_l2": fault}
    return out


@contextlib.contextmanager
def tf32_on():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_training(torch, smi: str, sku: str) -> dict:
    """Phase 13: each recurrent mixer's backward against the CPU, then train
    TR-gemma2 and TR-xlstm (each trainer freed before the next is made)."""
    t0 = time.monotonic()
    out = {"backward_card_vs_cpu": mixers_backward_card_vs_cpu(torch, smi)}
    print(f"[13] the mixers' backward took {time.monotonic() - t0:.1f} s")
    for cell in sorted(TRAIN_CELLS):
        t0 = time.monotonic()
        out[cell] = train_cell(torch, cell, smi, sku)
        print(f"[13] {cell} took {time.monotonic() - t0:.1f} s")
    return out


# -- phase 14: distribution on the card -------------------------------------------------


def dist_launches(cfg, hinted: bool) -> dict:
    """The launches of one fwdbwd (``Model.loss`` and its grads) of
    decoder-only ``cfg`` with remat: one pod's training iteration's
    (:func:`train_launches`), but for the MoE slot kernel where ``hinted``:
    H2's expert-local dispatch takes its slots from the reference's own
    masked cumsum."""
    want = train_launches(cfg, 1)
    if hinted:
        want.pop("moe_slots", None)
    return want


def dist_fwdbwd(torch, model, params, batch) -> tuple:
    """``Model.loss`` and the grads of every leaf of ``params`` (which
    require grad): ``(loss, aux, [grads in leaf order])``."""
    from repro_torch._bridge import tree_leaves

    loss, met = model.loss(params, batch)
    return loss, met["aux"], list(torch.autograd.grad(loss, tree_leaves(params)))


@contextlib.contextmanager
def counted_branches():
    """Counts of the hinted branches while inside: H1's local attention
    (``layers.sdpa_on_shards``) and H2's expert-local MoE
    (``moe.apply_moe_sharded``), each wrapped for the while."""
    from repro_torch.models import layers, moe

    counts = {"H1": 0, "H2": 0}
    orig = layers.sdpa_on_shards, moe.apply_moe_sharded

    def h1(*a, **k):
        counts["H1"] += 1
        return orig[0](*a, **k)

    def h2(*a, **k):
        counts["H2"] += 1
        return orig[1](*a, **k)

    layers.sdpa_on_shards, moe.apply_moe_sharded = h1, h2
    try:
        yield counts
    finally:
        layers.sdpa_on_shards, moe.apply_moe_sharded = orig


def dist_cell(torch, cell: str, mesh, smi: str, device: str = "cuda") -> dict:
    """Phase 14a/b: one D cell (DIST_CELLS) on the 1 x 1 ``mesh``.  Random
    weights from SEED, carried through ``params_to_jax`` / ``params_from_jax``
    and placed by ``distribute_params(param_specs(...))``; the batch placed by
    ``batch_specs``.  One fwdbwd with ``set_hints`` on the DTensors and one
    without hints on the plain tensors, each from launch counts of 0: the
    counts equal :func:`dist_launches` of each mode; H1 is taken (and H2
    where the arch has MoE FFNs); loss and aux within DIST_LOSS_TOL, every
    grad leaf within DIST_GRAD_TOL (the embedding's by DIST_EMBED_REL_L2 too);
    every param and grad (placed as its param by ``redistribute_like``) a
    DTensor on ``device`` with the specs' placements; one AdamW update with
    ``zero1_specs`` moments equal to the unsharded update.  Then each mode's
    ms (host clock, synchronised, median of 3 after a warm one), device ops
    and busy share from one profiled fwdbwd, and peak GB."""
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch._bridge import tree_flatten_with_path, tree_leaves, tree_unflatten
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.sharding import (batch_specs, distribute_params, param_specs, redistribute_like,
                                             to_shardings)
    from repro_torch.models import Model, params_from_jax, params_to_jax
    from repro_torch.models.hints import ShardHints, set_hints
    from repro_torch.optim import adamw, zero1_specs

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    arch, n_layers = DIST_CELLS[cell]
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype="float32", remat=True)
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    base = model.init(gen)
    specs = param_specs(cfg, base, mesh)
    placed = distribute_params(params_from_jax(params_to_jax(base, cfg), cfg, device), specs, mesh)
    for t in tree_leaves(base) + tree_leaves(placed):
        t.requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (DIST_BATCH, DIST_SEQ + 1), generator=gen, device=device)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    dbatch = distribute_params(batch, batch_specs(cfg, batch, mesh), mesh)
    names = [n for n, _ in tree_flatten_with_path(base)]
    n_params = sum(t.numel() for t in tree_leaves(base))
    hints = ShardHints(mesh=mesh, dp_axes=("data",))
    kinds = sorted({f"{m}/{f}" for m, f in cfg.layer_seq()})
    print(f"[14] {cell}: {arch}, {n_layers} layers ({', '.join(kinds)}) at full width (d {cfg.d_model}, vocab "
          f"{cfg.vocab}, fp32, remat), {n_params / 1e9:.3f} B params; batch {DIST_BATCH} x {DIST_SEQ}; mesh "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}")

    def run(hinted: bool):
        set_hints(hints if hinted else None)
        try:
            return dist_fwdbwd(torch, model, placed if hinted else base, dbatch if hinted else batch)
        finally:
            set_hints(None)

    out = {"arch": arch, "layers": n_layers, "params": n_params, "launches": {}, "ms": {}, "device_ops": {},
           "busy_share": {}, "peak_gb": {}}
    res = {}
    for hinted in (False, True):
        mode = "hinted" if hinted else "unhinted"
        sync()
        kops.reset_launch_counts()
        with counted_branches() as branches:
            res[mode] = run(hinted)
        sync()
        out["launches"][mode] = kops.launch_counts()
        out[f"branches_{mode}"] = dict(branches)
    want = {mode: dist_launches(cfg, mode == "hinted") for mode in ("unhinted", "hinted")}
    print(f"[14] {cell} launches in one fwdbwd: unhinted {out['launches']['unhinted']}, hinted "
          f"{out['launches']['hinted']} (expected {want}); hinted branches {out['branches_hinted']}")
    if out["launches"] != want:
        fail(f"{cell}: the hinted and unhinted fwdbwd did not launch each kernel as expected")
    moe = any(f == "moe" for _, f in cfg.layer_seq())
    if out["branches_hinted"]["H1"] == 0 or (moe and out["branches_hinted"]["H2"] == 0) or any(
            out["branches_unhinted"].values()):
        fail(f"{cell}: the hinted branches were not taken, or taken without hints: {out}")

    (l0, a0, g0), (l1, a1, g1) = res["unhinted"], res["hinted"]
    l0, a0, l1, a1 = l0.detach(), a0.detach(), l1.full_tensor().detach(), a1.full_tensor().detach()
    dl, da = float((l1 - l0).abs()), float((a1 - a0).abs())
    errs = [float((a.full_tensor() - b).abs().max()) for a, b in zip(g1, g0)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    embed_rel = rel_l2(g1[names.index("embed")].full_tensor(), g0[names.index("embed")])
    finite = bool(l0.isfinite()) and all(bool(g.isfinite().all()) for g in g0)
    print(f"[14] {cell} hinted vs unhinted: loss {float(l1):.7f} vs {float(l0):.7f} (|d| {dl:.3e}), aux "
          f"{float(a1):.7f} vs {float(a0):.7f} (|d| {da:.3e}; tol {DIST_LOSS_TOL:g}); grads max abs {errs[worst]:.3e} "
          f"({names[worst]}; tol {DIST_GRAD_TOL:g}), embed rel L2 {embed_rel:.3e} (tol {DIST_EMBED_REL_L2:g})")
    if not (finite and dl <= DIST_LOSS_TOL and da <= DIST_LOSS_TOL and max(errs) <= DIST_GRAD_TOL
            and embed_rel <= DIST_EMBED_REL_L2):
        fail(f"{cell}: the hinted fwdbwd disagrees with the unhinted one, or is not finite")
    out.update({"loss": float(l0), "aux": float(a0), "loss_abs_err": dl, "aux_abs_err": da,
                "grad_max_abs_err": errs[worst], "grad_worst_leaf": names[worst], "embed_rel_l2": embed_rel})

    # Placements: every param as its spec, every grad as its param once placed.
    want_pl = [s.placements for s in tree_leaves(to_shardings(mesh, specs))]
    raw = [tuple(g.placements) for g in g1]
    grads = tree_leaves(redistribute_like(tree_unflatten(placed, g1), placed))
    bad = [n for n, p, g, pl in zip(names, tree_leaves(placed), grads, want_pl)
           if not (isinstance(p, DTensor) and isinstance(g, DTensor) and p.device.type == device
                   and g.device.type == device and tuple(p.placements) == tuple(pl) == tuple(g.placements))]
    print(f"[14] {cell}: {len(names)} params placed by param_specs, their grads placed as the params "
          f"({sum(r != tuple(pl) for r, pl in zip(raw, want_pl))} left elsewhere by autograd); "
          f"misplaced {bad[:4]}")
    if bad:
        fail(f"{cell}: params or grads not placed as their specs: {bad[:4]}")

    # One AdamW update, moments placed by zero1_specs, against the unsharded one.
    ocfg = adamw.AdamWConfig(warmup_steps=0)
    with torch.no_grad():
        new0, st0, _ = adamw.update(ocfg, tree_unflatten(base, g0), adamw.init(base), base)
        zspecs = zero1_specs(specs, base, data_size=1)
        mom = adamw.init(base)
        state = adamw.AdamWState(step=mom.step, m=distribute_params(mom.m, zspecs, mesh),
                                 v=distribute_params(mom.v, zspecs, mesh))
        del mom
        new1, st1, _ = adamw.update(ocfg, tree_unflatten(placed, grads), state, placed)
        upd_err = max(float((a.full_tensor() - b).abs().max()) for a, b in zip(tree_leaves(new1), tree_leaves(new0)))
        kept = all(tuple(a.placements) == tuple(b.placements) for a, b in zip(tree_leaves(new1), tree_leaves(placed)))
    print(f"[14] {cell} AdamW with zero1_specs moments vs unsharded: new params max abs {upd_err:.3e}; "
          f"placements kept {kept}")
    if not (upd_err <= DIST_GRAD_TOL and kept):
        fail(f"{cell}: the ZeRO-1 AdamW update disagrees with the unsharded one")
    out["adamw_max_abs_err"] = upd_err
    del new0, st0, new1, st1, state, res, g0, g1, grads
    gc.collect()

    for hinted in (False, True):
        mode = "hinted" if hinted else "unhinted"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(4):  # a warm one, then 3 timed
            sync()
            t0 = time.perf_counter()
            run(hinted)
            sync()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"][mode] = ms
        out["peak_gb"][mode] = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        med = statistics.median(ms)
        if on_card:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run(hinted)
                sync()
            events = device_events(prof)
            out["device_ops"][mode], out["busy_share"][mode] = len(events), sum(e[1] for e in events) / med
            device = (f"{len(events)} device ops, busy {out['busy_share'][mode]:.1%}; peak "
                      f"{out['peak_gb'][mode]:.2f} GB")
        else:
            out["device_ops"][mode] = out["busy_share"][mode] = None
            device = "device ops, busy share and peak not measured"
        print(f"[14] {cell} {mode} fwdbwd {fmt_ms(ms)} ms, median {med:.2f} ms; {device}  ({smi})")
    out["device"] = smi
    return out


def phase_distribution(torch, smi: str, sku: str, device: str = "cuda") -> dict:
    """Phase 14: a one-rank process group (NCCL on the card, from an
    in-process ``HashStore``: no network), ``make_mesh((1, 1), ("data",
    "model"))`` on it, and each D cell (:func:`dist_cell`); the group is
    destroyed before it returns."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    kw = {"device_id": torch.device("cuda", 0)} if device == "cuda" else {}
    dist.init_process_group("nccl" if device == "cuda" else "gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60), **kw)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device)
        out = {}
        for cell in DIST_CELLS:
            t0 = time.monotonic()
            out[cell] = dist_cell(torch, cell, mesh, smi, device)
            print(f"[14] {cell} took {time.monotonic() - t0:.1f} s")
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


# -- phase 15: the dry-run and the roofline on the card ------------------------------------------


def dry_cell(run_cell, cell) -> dict:
    """One dry-run cell on the card's torch, its checks and its line."""
    arch, shape, mesh, variant = cell
    t0 = time.monotonic()
    rec = run_cell(arch, shape, mesh, variant=variant)  # the mesh on cuda, the shards on meta
    secs = time.monotonic() - t0
    tag = f"{arch} x {shape} x {mesh} ({variant})"
    want = DRY_SKIPPED.get((arch, shape))
    if want is not None:
        if rec.get("status") != "skipped" or rec.get("reason") != want:
            fail(f"dry-run {tag}: expected skipped ({want}), got {rec}")
        print(f"[15] {tag}: skipped ({rec['reason']})")
        return rec
    if rec.get("status") != "ok":
        fail(f"dry-run {tag}: {rec}")
    c, rl, coll, chips = rec["cost_analysis"], rec["roofline"], rec["collectives"], rec["chips"]
    if not (c["flops_global"] > 0 and c["flops"] * chips >= c["flops_global"] * (1 - 1e-9)):
        fail(f"dry-run {tag}: counts {c}")
    if not set(coll["count"]) <= {"all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute"}:
        fail(f"dry-run {tag}: collectives {coll['count']}")
    if rec["memory_analysis"]["temp_bytes"] is not None or rec["compile_s"] != 0.0:
        fail(f"dry-run {tag}: temp_bytes and compile_s must be null and 0")
    links = ", ".join(f"{k} {v:.4g} B" for k, v in sorted(coll["link_bytes"].items())) or "none"
    print(f"[15] {tag}: FLOPs a device counted {c['flops']:.6g} (global {c['flops_global']:.6g}, each op once), "
          f"analytic {rec['analytic']['flops_global'] / chips:.6g}; link bytes a device {links}; "
          f"{rl['dominant']} bound {rl['bound_s']:.6g} s, MFU bound {rl['mfu_bound']:.4g}; "
          f"{rec['lower_s']:.1f} s counted, {secs:.1f} s in all")
    return rec


def r_roofline(cfg, kind: str, seq: int, sku: str):
    """The port's roofline of one step of ``cfg`` on one card of ``sku``:
    the analytic FLOPs and HBM bytes at model = data = chips = 1."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.roofline import model_flops, roofline
    from repro_torch.roofline.analytic import analytic_flops_global, analytic_hbm_bytes_per_device

    shape = Shape(f"r_{kind}", kind, seq, R_BATCH)
    return roofline(sku=sku, flops_per_device=analytic_flops_global(cfg, shape),
                    hbm_bytes_per_device=analytic_hbm_bytes_per_device(cfg, shape, model_ways=1, data_ways=1).total,
                    link_bytes_per_device=0.0, model_flops_global=model_flops(cfg, shape), chips=1), shape


def beside_bound(tag: str, measured_ms: float, rl, smi: str) -> dict:
    bound_ms = rl.bound_s * 1e3
    print(f"[15] {tag}: measured {measured_ms:.3f} ms, roofline bound {bound_ms:.3f} ms ({rl.dominant}: compute "
          f"{rl.compute_s * 1e3:.3f}, memory {rl.memory_s * 1e3:.3f} ms), measured / bound "
          f"{measured_ms / bound_ms:.3f}  ({smi})")
    if not measured_ms >= R_FLOOR * bound_ms:
        fail(f"{tag}: measured {measured_ms:.3f} ms under {R_FLOOR} x its bound {bound_ms:.3f} ms: "
             "the model counts more than the card does")
    return {"measured_ms": measured_ms, "bound_ms": bound_ms, "dominant": rl.dominant,
            "compute_ms": rl.compute_s * 1e3, "memory_ms": rl.memory_s * 1e3, "ratio": measured_ms / bound_ms}


def r_decode(torch, smi: str, sku: str) -> dict:
    """R-decode: llama3.2-3b whole, a decode step of the kernel path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import make_prompts
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model

    cfg = get_config(ARCH)
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, SEED, "cuda")
    step = make_serve_step(model)
    with torch.inference_mode():
        cache = model.init_cache(BATCH, R_DECODE_ROWS)
        _, cache = model.prefill(params, prompts, cache)
        torch.cuda.synchronize()
        kops.reset_launch_counts()
        tok, cache = step(params, cache, prompts[:, -1:])
        torch.cuda.synchronize()
        launches = kops.launch_counts()
    n = len(cfg.layer_seq())
    want = {"rmsnorm": 2 * n + 1, "decode_attention": n}
    print(f"[15] R-decode launches {launches} (expected {want})")
    if launches != want:
        fail("R-decode did not launch each kernel as expected")
    prof = profiled_decode_bound(torch, "15", model, params, prompts, smi, sku)
    rl, _ = r_roofline(cfg, "decode", R_DECODE_ROWS, sku)
    out = beside_bound("R-decode (device ms a step, phase 6's profile)", prof["profile"]["step_device_ms"], rl, smi)
    out.update(launches=launches, phase6_bound_ms=prof["decode_bound_ms"], step_wall_ms=prof["profile"]["step_wall_ms"])
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def r_train(torch, smi: str, sku: str, device: str = "cuda") -> dict:
    """R-train: llama3.2-3b at full width, R_TRAIN_LAYERS layers, one train
    step of the kernel path timed; its FLOPs counted on the plain path and
    by the dry-run on a 1 x 1 fake mesh of meta tensors."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, layers
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.roofline.counting import count_step

    cfg = dataclasses.replace(get_config(ARCH), n_layers=R_TRAIN_LAYERS)
    model = Model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab, (R_BATCH, R_SEQ + 1), generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    step = make_train_step(model, AdamWConfig())
    opt = adamw.init(params)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        new = step(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        if not bool(torch.isfinite(new[2]["loss"])):
            fail(f"R-train loss {new[2]['loss']}")
        return ms

    timed()  # warm
    kops.reset_launch_counts()
    times = [timed()]
    launches = kops.launch_counts()
    times += [timed(), timed()]
    want = train_launches(cfg, 1)
    print(f"[15] R-train launches {launches} (expected {want}); ms {fmt_ms(times)}")
    if launches != want:
        fail("R-train did not launch each kernel as expected")
    rl, shape = r_roofline(cfg, "train", R_SEQ, sku)
    out = beside_bound("R-train (median ms of 3 steps)", statistics.median(times), rl, smi)

    prev = layers.get_attn_impl()
    layers.set_attn_impl("plain")
    try:
        with count_step() as cost:
            step(params, opt, batch)
        torch.cuda.synchronize()
    finally:
        layers.set_attn_impl(prev)
    dry, _ = count_cell(cfg, shape, (1, 1), ("data", "model"), device=device)
    c = dry["cost_analysis"]
    print(f"[15] R-train FLOPs: plain path on the card {cost.flops:.8g}, dry-run on a 1 x 1 fake mesh of meta "
          f"tensors {c['flops']:.8g} (global {c['flops_global']:.8g}); analytic {rl.flops_per_device:.8g}")
    if not (cost.flops == c["flops"] == c["flops_global"] > 0):
        fail("R-train: the dry-run does not count what the card runs")
    out.update(launches=launches, times_ms=times, flops_plain=cost.flops, flops_dryrun=c["flops"],
               flops_analytic=rl.flops_per_device)
    del model, params, opt
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_dryrun(torch, smi: str, sku: str) -> dict:
    """Phase 15: the dry-run cells (:data:`DRY_CELLS`), R-decode and R-train."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline import chip_sku

    t0 = time.monotonic()
    recs = {" ".join(cell): dry_cell(run_cell, cell) for cell in DRY_CELLS}
    base = recs["llama3.2-3b train_4k pod1 baseline"]["cost_analysis"]["flops_global"]
    opt = recs["llama3.2-3b train_4k pod1 opt"]["cost_analysis"]["flops_global"]
    print(f"[15] llama3.2-3b x train_4k, global FLOPs: baseline {base:.6g}, opt {opt:.6g}; the reference's "
          f"unrolled compile {DRY_LLAMA_TRAIN:.6g} ({base / DRY_LLAMA_TRAIN - 1:+.2%}, tol {DRY_LLAMA_TOL:.0%}; "
          f"opt {opt / base - 1:+.3%}, tol {DRY_OPT_TOL:.0%}); dry-run {time.monotonic() - t0:.1f} s")
    if not abs(base - DRY_LLAMA_TRAIN) <= DRY_LLAMA_TOL * DRY_LLAMA_TRAIN:
        fail("llama3.2-3b x train_4k: the global count is not the reference's")
    if not abs(opt - base) <= DRY_OPT_TOL * base:
        fail("llama3.2-3b x train_4k: opt and baseline count different work")
    card = chip_sku(torch.cuda.get_device_name(0))
    if card is None:
        fail(f"no roofline constants for {torch.cuda.get_device_name(0)}")
    cells = {k: {f: r.get(f) for f in ("status", "reason", "chips", "lower_s", "total_s", "cost_analysis",
                                       "memory_analysis", "analytic", "roofline", "slstm_steps_scaled")}
             | ({"collectives": {f: r["collectives"][f] for f in ("count", "link_bytes", "total_link_bytes")}}
                if "collectives" in r else {})
             for k, r in recs.items()}
    return {"cells": cells, "R-decode": r_decode(torch, smi, card), "R-train": r_train(torch, smi, card)}


# -- phase 16: the threaded backend, one host thread per location ---------------------


def split_placement(n_steps: int) -> dict:
    """P-split: phase 7's odd steps on l0, its even ones on l1."""
    return {f"s{k}": ("l0",) if k % 2 else ("l1",) for k in range(1, n_steps + 1)}


def serve_setup(torch, device: str) -> tuple:
    """S-serve: the reference's serving workload (ingest -> work_a || work_b ->
    merge on l0, l1, l2) with bodies on ``device``: ingest and work_a are
    rmsnorm, work_b is phase 7's mix and merge sums the two (it outputs no
    datum, as the reference's merge); request i's datum is SERVE_SHAPE fp32
    from seed i.  Returns the instance, the bodies and the inputs."""
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.kernels import ops as kops

    wf = make_workflow(
        ["ingest", "work_a", "work_b", "merge"], ["p_seed", "p_ingest", "p_a", "p_b"],
        [("p_seed", "ingest"), ("ingest", "p_ingest"), ("p_ingest", "work_a"), ("p_ingest", "work_b"),
         ("work_a", "p_a"), ("work_b", "p_b"), ("p_a", "merge"), ("p_b", "merge")])
    inst = DistributedWorkflowInstance(
        workflow=wf, locations=frozenset({"l0", "l1", "l2"}),
        mapping={"ingest": ("l0",), "work_a": ("l1",), "work_b": ("l2",), "merge": ("l0",)},
        data=frozenset({"d_seed", "d_ingest", "d_a", "d_b"}),
        placement={"d_seed": "p_seed", "d_ingest": "p_ingest", "d_a": "p_a", "d_b": "p_b"},
        initial_data={"l0": frozenset({"d_seed"})})
    w = torch.ones(SERVE_SHAPE[1], device=device)

    def merge(i):
        i["d_a"] + i["d_b"]  # noqa: B018 — the sink's work on the card; no datum leaves it
        return {}

    fns = {
        "ingest": lambda i: {"d_ingest": kops.rmsnorm(i["d_seed"], w)},
        "work_a": lambda i: {"d_a": kops.rmsnorm(i["d_ingest"], w)},
        "work_b": lambda i: {"d_b": 0.5 * i["d_ingest"] + 0.1 * torch.tanh(i["d_ingest"])},
        "merge": merge,
    }
    inputs = [{("l0", "d_seed"): torch.from_numpy(
        np.random.default_rng(i).standard_normal(SERVE_SHAPE).astype(np.float32)).to(device)}
        for i in range(SERVE_INSTANCES)]
    return inst, fns, inputs


def stores_equal(torch, name: str, got: dict, want: dict) -> None:
    """Fails unless two stores hold the same data, tensors equal bit for bit."""
    if {loc: sorted(d) for loc, d in got.items()} != {loc: sorted(d) for loc, d in want.items()}:
        fail(f"{name}: the stores hold different data")
    for loc in want:
        for d, w in want[loc].items():
            g = got[loc][d]
            if not (isinstance(g, torch.Tensor) and g.shape == w.shape and torch.equal(g, w)):
                fail(f"{name}: store {loc}/{d} differs")


def on_device(torch, name: str, data: dict, device: str) -> None:
    """Fails unless every payload of a store is a tensor on ``device``."""
    for loc, ds in data.items():
        for d, v in ds.items():
            if not (isinstance(v, torch.Tensor) and v.device.type == device):
                fail(f"{name}: {loc}/{d} is not a tensor on {device}")


def threaded_cell(torch, label: str, plan, fns, feed, device: str, smi: str, **opts) -> tuple:
    """One cell on ``threaded`` beside the ``torch`` backend interpreted: the
    stores must agree (DP_RTOL / DP_ATOL) and hold tensors on the device;
    ms a run of each, in turns (:func:`dp_time_pair`).  Returns the numbers,
    the ``threaded`` executable and its last result."""
    platform = {} if device == "cuda" else {"platform": "cpu"}
    thr = plan.lower("threaded", timeout_s=THREADED_TIMEOUT_S, **opts).compile(fns)
    ref_exe = plan.lower("torch", **platform, **opts).compile(fns)
    t_t, res_t, t_r, res_r = dp_time_pair(torch, thr, ref_exe, feed)
    dp_stores_close(torch, f"{label} threaded vs torch", res_t.data, res_r.data)
    on_device(torch, f"{label} threaded", res_t.data, device)
    if res_t.backend != "threaded":
        fail(f"{label}: ran on {res_t.backend}")
    out = {"threaded_ms": t_t, "torch_ms": t_r, "threaded_min_ms": min(t_t), "torch_min_ms": min(t_r),
           "threaded_median_ms": statistics.median(t_t), "torch_median_ms": statistics.median(t_r),
           "threaded_over_torch": min(t_t) / min(t_r), "transport": res_t.stats}
    print(f"[16] {label}: threaded {min(t_t):.4f} ms a run (median {statistics.median(t_t):.4f}), torch "
          f"interpreted {min(t_r):.4f} ms (median {statistics.median(t_r):.4f}), threaded/torch "
          f"{out['threaded_over_torch']:.3f}; transport {res_t.stats}; stores agree; {smi}")
    return out, thr, res_t


def phase_threaded(torch, smi: str, sku: str, device: str = "cuda") -> dict:
    """Phase 16: SWIRL plans on the ``threaded`` backend, one host thread per
    location, array payloads as tensors on ``device``, each held against the
    ``torch`` backend's interpreted store (see the module doc).  Returns the
    numbers it prints and the kernels' launches on each path."""
    from repro_torch import swirl
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.core.translate import genomes_1000
    from repro_torch.exec.program import SendOp
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.workflow.threaded import total_par_branches

    t_phase = time.monotonic()
    out = {"device": smi, "launches": {}, "threads_a_run": {}}
    mix = lambda v: 0.5 * v + 0.1 * torch.tanh(v)  # noqa: E731
    plan = dp_pipeline(swirl, DistributedWorkflowInstance, make_workflow)

    # (a) P-ref and P-full, (b) P-split.
    for label, shape in DP_SHAPES.items():
        w = torch.ones(shape[1], device=device)
        fns = dp_fns(lambda v, w=w: kops.rmsnorm(v, w), mix)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).to(device)
        feed = {("l0", "d0"): x}
        cells = ((label, {}), (f"{label}/split", {"placement": split_placement(DP_STEPS)}))
        for name, opts in cells:
            cell, exe, res = threaded_cell(torch, name, plan, fns, feed, device, smi, **opts)
            by_loc = exe.program.program.by_location
            out["threads_a_run"][name] = len(by_loc) + total_par_branches(by_loc)
            store = {}
            for loc in res.data:
                store.update(res.data[loc])
            for k in (0, 4, 8):  # the rmsnorm steps, against the plain version
                check_close(f"{name} threaded d{k + 1} = rmsnorm(d{k})", store[f"d{k + 1}"],
                            ref.rmsnorm_ref(store[f"d{k}"], w), 2e-5)
            torch.cuda.synchronize()
            kops.reset_launch_counts()
            again = exe.run(initial_payloads=dict(feed))
            torch.cuda.synchronize()
            counts = kops.launch_counts()
            if counts != {"rmsnorm": DP_NORMS}:
                fail(f"{name}: a threaded run launched {counts}, not rmsnorm {DP_NORMS} alone")
            dp_stores_close(torch, f"{name} a counted run", again.data, res.data)
            cell["launches"] = out["launches"][name] = counts
            if opts:
                # Every datum a step makes on one location and the other
                # reads crosses a thread as the very CUDA tensor: no copy.
                sends = [op for lp in exe.program.program.programs for op in lp.ops if isinstance(op, SendOp)]
                if not sends or again.stats["sent"] != len(sends):
                    fail(f"{name}: {again.stats['sent']} messages for {len(sends)} sends")
                for op in sends:
                    if again.data[op.dst][op.data] is not again.data[op.src][op.data]:
                        fail(f"{name}: {op.data} reached {op.dst} as another object than {op.src}'s")
                cell["sends"] = len(sends)
                print(f"[16] {name}: {len(sends)} tensors crossed from one location thread to the other, "
                      f"each the very object its step returned; rmsnorm launches {counts}")
            out[name] = cell

    # (c) G: 1000 Genomes on 9 location threads, with and without dropped messages.
    inst = genomes_1000(n=4, m=3, a=2, b=2, c=2)
    init, gfns = g_setup(torch, inst, device)
    gplan = swirl.trace(inst).optimize(G_RULES)
    cell, gexe, gres = threaded_cell(torch, "G", gplan, gfns, init, device, smi)
    out["threads_a_run"]["G"] = len(gres.data) + total_par_branches(gexe.program.program.by_location)
    locs = len(gres.data)
    n_comms = sum(isinstance(op, SendOp) for lp in gexe.program.program.programs for op in lp.ops)
    lossy = gplan.lower("threaded", timeout_s=THREADED_TIMEOUT_S, drop_prob=G_DROP, seed=0).compile(gfns).run(
        initial_payloads=dict(init))
    stores_equal(torch, "G with dropped messages", lossy.data, gres.data)
    resends = lossy.stats["sent"] - n_comms
    if lossy.stats["dropped"] < 1 or resends < 1:
        fail(f"G at drop_prob {G_DROP}: transport {lossy.stats} dropped or resent nothing")
    wall = statistics.median(cell["threaded_ms"])
    dev_ms = device_ms_and_copies(torch, lambda: gexe.run(initial_payloads=dict(init)))[0]
    cell |= {"locations": locs, "comms": n_comms, "lossy_transport": lossy.stats, "resends": resends,
             "device_ms": dev_ms, "busy_share": dev_ms / wall}
    out["G"] = cell
    print(f"[16] G genomes_1000(4, 3, 2, 2, 2): {locs} location threads, {n_comms} comms; at drop_prob "
          f"{G_DROP} (seed 0) the store is the same, transport {lossy.stats}, {resends} resends; one run's "
          f"device time {dev_ms:.4f} ms of a {wall:.4f} ms median run, the card busy {dev_ms / wall:.1%}; {smi}")

    # (d) S-serve: per instance through the whole pipeline, and run_many.
    sinst, sfns, inputs = serve_setup(torch, device)
    per = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for payloads in inputs:
        per.append(swirl.trace(sinst).optimize().lower("threaded", timeout_s=THREADED_TIMEOUT_S).compile(sfns)
                   .run(initial_payloads=payloads))
    torch.cuda.synchronize()
    t_per = time.perf_counter() - t0
    sexe = swirl.trace(sinst).optimize().lower("threaded", timeout_s=THREADED_TIMEOUT_S).compile(sfns)
    sexe.run_many(inputs[:SERVE_LANES], max_concurrent=SERVE_LANES)  # warm
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    many = sexe.run_many(inputs, max_concurrent=SERVE_LANES)
    torch.cuda.synchronize()
    t_many = time.perf_counter() - t0
    counts = kops.launch_counts()
    want = {"rmsnorm": 2 * SERVE_INSTANCES}
    if counts != want:
        fail(f"S-serve run_many launched {counts}, not {want}")
    if len(many) != len(per):
        fail("S-serve: run_many returned another number of results")
    for i, (a, b) in enumerate(zip(many, per)):
        stores_equal(torch, f"S-serve instance {i}, run_many vs per instance", a.data, b.data)
        on_device(torch, f"S-serve instance {i}", a.data, device)
    ing = per[0].data["l0"]
    check_close("S-serve d_ingest = rmsnorm(d_seed)", ing["d_ingest"],
                ref.rmsnorm_ref(ing["d_seed"], torch.ones(SERVE_SHAPE[1], device=device)), 2e-5)
    out["launches"]["S-serve run_many"] = counts
    out["S-serve"] = {"instances": SERVE_INSTANCES, "max_concurrent": SERVE_LANES, "per_instance_s": t_per,
                      "run_many_s": t_many, "per_instance_ips": SERVE_INSTANCES / t_per,
                      "run_many_ips": SERVE_INSTANCES / t_many, "launches": counts}
    print(f"[16] S-serve {SERVE_INSTANCES} instances of {list(SERVE_SHAPE)} fp32: per instance (trace -> "
          f"optimize -> lower -> compile -> run each) {SERVE_INSTANCES / t_per:.1f} instances/s, run_many("
          f"max_concurrent={SERVE_LANES}) {SERVE_INSTANCES / t_many:.1f} instances/s "
          f"(x{t_per / t_many:.2f}); stores equal; run_many launched {counts}; {smi}")

    # (e) Traced: P-full and G, each span schema against the same plan's on the CPU.
    for label in ("P-full", "G"):
        if label == "G":
            tplan, tfns, tfeed = gplan, gfns, init
            cpu_feed, cpu_fns = g_setup(torch, inst, "cpu")
        else:
            shape = DP_SHAPES[label]
            w, w_cpu = torch.ones(shape[1], device=device), torch.ones(shape[1])
            tplan, tfns = plan, dp_fns(lambda v, w=w: kops.rmsnorm(v, w), mix)
            tfeed = {("l0", "d0"): torch.from_numpy(
                np.random.default_rng(7).standard_normal(shape).astype(np.float32)).to(device)}
            cpu_fns = dp_fns(lambda v, w=w_cpu: kops.rmsnorm(v, w), mix)
            cpu_feed = {("l0", "d0"): torch.randn(4, shape[1])}  # the schema depends on no value
        cpu_schema = tplan.lower("threaded", timeout_s=THREADED_TIMEOUT_S, trace=True).compile(cpu_fns).run(
            initial_payloads=dict(cpu_feed)).profile.span_schema()
        untraced = tplan.lower("threaded", timeout_s=THREADED_TIMEOUT_S).compile(tfns)
        traced = tplan.lower("threaded", timeout_s=THREADED_TIMEOUT_S, trace=True).compile(tfns)
        t_u, res_u, t_t, res_t = dp_time_pair(torch, untraced, traced, tfeed)
        if res_u.profile is not None or res_t.profile is None:
            fail(f"{label} traced: a profile on the untraced run or none on the traced one")
        stores_equal(torch, f"{label} traced vs untraced", res_t.data, res_u.data)
        if res_t.profile.span_schema() != cpu_schema:
            fail(f"{label} traced: the span schema on the card differs from the CPU's")
        exec_ms = sum(sp.duration for sp in res_t.profile.spans if sp.kind == "exec") * 1e3
        dev_ms = device_ms_and_copies(torch, lambda: untraced.run(initial_payloads=dict(tfeed)))[0]
        ratio = min(t_t) / min(t_u)
        out[f"{label} traced"] = {"untraced_ms": t_u, "traced_ms": t_t, "traced_over_untraced": ratio,
                                  "traced_over_untraced_median": statistics.median(t_t) / statistics.median(t_u),
                                  "exec_span_ms": exec_ms, "untraced_device_ms": dev_ms,
                                  "spans": len(res_t.profile.spans)}
        print(f"[16] {label} traced: untraced {min(t_u):.4f} ms, traced {min(t_t):.4f} ms a run (medians "
              f"{statistics.median(t_u):.4f}, {statistics.median(t_t):.4f}), traced/untraced {ratio:.3f}; "
              f"{len(res_t.profile.spans)} spans, exec spans {exec_ms:.4f} ms over {dev_ms:.4f} ms of device "
              f"time in an untraced run; schema equals the CPU's; {smi}")
        if label == "P-full" and exec_ms < TRACE_COVER * dev_ms:
            fail(f"P-full traced: exec spans {exec_ms:.4f} ms cover less than {TRACE_COVER} of the "
                 f"device's {dev_ms:.4f} ms")

    # (f) A step that fails after it launched a kernel.
    w = torch.ones(DP_SHAPES["P-ref"][1], device=device)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(DP_SHAPES["P-ref"]).astype(np.float32)).to(device)
    bad = dp_fns(lambda v: kops.rmsnorm(v, w), mix)
    planted = []

    def failing(i):
        y = kops.rmsnorm(i["d4"], w)
        if not planted:
            planted.append(RuntimeError("a planted failure after a launch"))
            raise planted[0]
        return {"d5": y}

    bad["s5"] = failing
    fexe = plan.lower("threaded", timeout_s=THREADED_TIMEOUT_S).compile(bad)
    try:
        fexe.run(initial_payloads={("l0", "d0"): x})
    except RuntimeError as e:
        if "location l0 failed" not in str(e) or e.__cause__ is not planted[0]:
            fail(f"the failing step surfaced as {e!r}, not the reference's location error")
    else:
        fail("a run whose step raised did not fail")
    after = fexe.run(initial_payloads={("l0", "d0"): x})
    torch.cuda.synchronize()
    check_close("after a failed run, d5 = rmsnorm(d4)", after.data["l0"]["d5"],
                ref.rmsnorm_ref(after.data["l0"]["d4"], w), 2e-5)
    print("[16] a step that raised after a launch failed its run with RuntimeError('location l0 failed: ...') "
          "from the planted error; the next run of the same executable succeeded")
    # (g) What a run's threads cost the host: one per location and one per
    # Par branch, each started and joined.
    starts = []
    for _ in range(50):
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: None, daemon=True)
        th.start()
        th.join(THREADED_TIMEOUT_S)
        starts.append((time.perf_counter() - t0) * 1e3)
    out["thread_start_join_ms"] = {"min": min(starts), "median": statistics.median(starts)}
    print(f"[16] a host thread started and joined: min {min(starts):.4f} ms, median "
          f"{statistics.median(starts):.4f} ms (50); threads a run starts: {out['threads_a_run']}; {smi}")
    out["seconds"] = time.monotonic() - t_phase
    print(f"[16] the threaded backend's phase took {out['seconds']:.1f} s")
    return out


# -- phase 17: the multiprocess backend, one OS process per location ----------------


def worker_report(kops, before: dict, t0: float) -> dict:
    """What a phase 17 step body reports of itself, as an extra output that
    reaches only the coordinator's merged store (``checkpoint()``): its
    process, the kernels it launched there (its process's counters, read
    just before and just after) and its span on the machine's monotonic
    clock (one clock for every process)."""
    after = kops.launch_counts()
    return {"pid": os.getpid(), "launches": nonzero({k: n - before.get(k, 0) for k, n in after.items()}), "t0": t0,
            "t1": time.monotonic()}


def mp_norm(step: str, a: str, b: str, w, inputs: dict) -> dict:
    """Phase 7's rmsnorm step with the weights ``w``, as a module-level
    function, which pickles for ``start_method="spawn"``."""
    from repro_torch.kernels import ops as kops

    t0, before = time.monotonic(), kops.launch_counts()
    y = kops.rmsnorm(inputs[a], w)
    return {b: y, MP_REPORT + step: worker_report(kops, before, t0)}


def mp_mix(step: str, a: str, b: str, inputs: dict) -> dict:
    """Phase 7's elementwise mix step, module-level."""
    import torch
    from repro_torch.kernels import ops as kops

    t0, before = time.monotonic(), kops.launch_counts()
    v = inputs[a]
    return {b: 0.5 * v + 0.1 * torch.tanh(v), MP_REPORT + step: worker_report(kops, before, t0)}


def mp_dp_fns(w) -> dict:
    """Phase 7's 12 step bodies (rmsnorm with the weights ``w`` at k = 0, 4,
    8, the mix elsewhere), each a partial of a module-level function.  Every
    worker gets every body, so each unpickles ``w`` as it starts: it imports
    torch and, for ``w`` on the card, makes its CUDA context then."""
    return {f"s{k + 1}": (functools.partial(mp_norm, f"s{k + 1}", f"d{k}", f"d{k + 1}", w) if k % 4 == 0
                          else functools.partial(mp_mix, f"s{k + 1}", f"d{k}", f"d{k + 1}"))
            for k in range(DP_STEPS)}


def mp_g_source(step: str, names: tuple, ones, inputs: dict) -> dict:
    """G's ``s0``: hands out :func:`g_setup`'s payloads, made again from
    its seed in the worker (the same values in the same order) on the
    device of ``ones``."""
    import torch
    from repro_torch.kernels import ops as kops

    t0, before = time.monotonic(), kops.launch_counts()
    rng = np.random.default_rng(0)
    out = {d: torch.from_numpy(rng.random(G_ELEMS).astype(np.float32)).to(ones.device) for d in names}
    return out | {MP_REPORT + step: worker_report(kops, before, t0)}


def mp_g_sum(step: str, outs: tuple, ones, inputs: dict) -> dict:
    """Every other G step: :func:`g_setup`'s sum of the inputs into a vector
    of ones.  On the card the body's device time rides on its report (CUDA
    events around its work, then a wait for the second)."""
    import torch
    from repro_torch.kernels import ops as kops

    t0, before = time.monotonic(), kops.launch_counts()
    timed = ones.is_cuda
    if timed:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    out = {o: sum(torch.sum(v) for v in inputs.values()) * ones for o in outs}
    report = worker_report(kops, before, t0)
    if timed:
        events[1].record()
        events[1].synchronize()
        report["device_ms"] = events[0].elapsed_time(events[1])
    return out | {MP_REPORT + step: report}


def mp_g_fns(inst, ones) -> dict:
    """G's bodies as partials of module-level functions, holding a vector of
    G_ELEMS ones on the device (which each worker unpickles as it starts)."""
    names = tuple(sorted(inst.g("l^d")))
    return {s: functools.partial(mp_g_source, s, names, ones) if s == "s0"
            else functools.partial(mp_g_sum, s, tuple(sorted(inst.out_data(s))), ones)
            for s in inst.workflow.steps}


def worker_reports(payloads: dict) -> dict:
    """``{step: report}`` from a coordinator's merged store."""
    return {d[len(MP_REPORT):]: v for (_, d), v in payloads.items() if d.startswith(MP_REPORT)}


def without_reports(data: dict) -> dict:
    """A result's stores without the step bodies' reports."""
    return {loc: {d: v for d, v in ds.items() if not d.startswith(MP_REPORT)} for loc, ds in data.items()}


def pickled_bytes(v) -> int:
    """What a payload weighs on the socket wire (plain pickle; a CUDA
    tensor's bytes go through the host)."""
    return len(pickle.dumps(v, pickle.HIGHEST_PROTOCOL))


def fleet_gone(name: str, mp, pids) -> None:
    """Fails unless every worker of the last run is reaped and gone."""
    if mp.active_children():
        fail(f"{name}: worker processes were not reaped: {mp.active_children()}")
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        fail(f"{name}: worker process {pid} outlived its run")


def mp_cell(torch, label: str, plan, fns, feed, device: str, smi: str, start_method: str, **opts) -> tuple:
    """One cell on ``multiprocess`` (MP_RUNS runs, each starting its own
    fleet), held against ``threaded``'s store of the same plan and bodies
    (bit for bit) and timed beside ``threaded`` and ``torch`` interpreted
    (in turns, :func:`dp_time_pair`).  From the workers' reports: the fleet's
    start (the call to the first step body: processes started, torch
    imported, payloads unpickled) apart from the steps (the first body's
    start to the last body's end) and the rest (the last body to the
    result: done messages, teardown).  Returns the numbers, the executable,
    its last result and that run's reports."""
    import multiprocessing as mp

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    exe = plan.lower("multiprocess", start_method=start_method, timeout_s=MP_TIMEOUT_S,
                     ack_timeout=MP_ACK_TIMEOUT_S, **opts).compile(fns)
    walls, starts, steps, res, reports = [], [], [], None, {}
    for _ in range(MP_RUNS):  # no warm run: every run starts its own fleet
        sync()
        t0 = time.monotonic()
        res = exe.run(initial_payloads=dict(feed))
        sync()
        t1 = time.monotonic()
        reports = worker_reports(exe.checkpoint().payloads)
        first, last = min(r["t0"] for r in reports.values()), max(r["t1"] for r in reports.values())
        walls.append((t1 - t0) * 1e3)
        starts.append((first - t0) * 1e3)
        steps.append((last - first) * 1e3)
        print(f"[17] {label} run {len(walls)}: {walls[-1]:.1f} ms (fleet start {starts[-1]:.1f}, steps "
              f"{steps[-1]:.1f})", flush=True)
        pids = list(res.stats["pids"].values())
        if len(set(pids)) != res.stats["workers"] or os.getpid() in pids:
            fail(f"{label}: worker pids {pids} are not distinct processes apart from this one")
        if {r["pid"] for r in reports.values()} - set(pids):
            fail(f"{label}: a step ran outside the fleet's processes")
        if res.backend != "multiprocess" or res.stats["start_method"] != start_method:
            fail(f"{label}: ran on {res.backend} with {res.stats.get('start_method')}")
        fleet_gone(label, mp, pids)
    platform = {} if device == "cuda" else {"platform": "cpu"}
    thr = plan.lower("threaded", timeout_s=THREADED_TIMEOUT_S, **opts).compile(fns)
    ref_exe = plan.lower("torch", **platform, **opts).compile(fns)
    t_t, res_t, t_r, res_r = dp_time_pair(torch, thr, ref_exe, feed)
    stores_equal(torch, f"{label} multiprocess vs threaded", res.data, res_t.data)
    on_device(torch, f"{label} multiprocess", res.data, device)
    launches = {}
    for r in reports.values():
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
    out = {"multiprocess_ms": walls, "fleet_start_ms": starts, "steps_ms": steps,
           "teardown_ms": [w - s - t for w, s, t in zip(walls, starts, steps)],
           "multiprocess_median_ms": statistics.median(walls), "fleet_start_median_ms": statistics.median(starts),
           "steps_median_ms": statistics.median(steps), "threaded_ms": t_t, "torch_ms": t_r,
           "threaded_median_ms": statistics.median(t_t), "torch_median_ms": statistics.median(t_r),
           "workers": res.stats["workers"], "groups": res.stats["groups"], "start_method": start_method,
           "launches": launches}
    print(f"[17] {label}: multiprocess {statistics.median(walls):.1f} ms a run (median of {MP_RUNS}: fleet start "
          f"{statistics.median(starts):.1f}, steps {statistics.median(steps):.1f}, teardown "
          f"{statistics.median(out['teardown_ms']):.1f}) on {res.stats['workers']} {start_method}ed workers; "
          f"threaded {statistics.median(t_t):.4f} ms, torch interpreted {statistics.median(t_r):.4f} ms (medians); "
          f"stores equal to threaded's; rmsnorm launched {launches.get('rmsnorm', 0)} times in the workers; {smi}")
    return out, exe, res, reports


def wire_bytes(exe, res) -> dict:
    """Messages and pickled bytes of a run: worker to worker (one message a
    COMM) and to the coordinator (every step's delta, then each worker's
    done with its locations' stores)."""
    from repro_torch.exec.program import SendOp

    sends = [op for lp in exe.program.program.programs for op in lp.ops if isinstance(op, SendOp)]
    store = {}
    for loc in res.data:
        store.update(res.data[loc])
    return {"messages": len(sends), "bytes": sum(pickled_bytes(res.data[op.src][op.data]) for op in sends),
            "control_bytes": sum(pickled_bytes(v) for v in store.values())
            + sum(pickled_bytes(v) for loc in res.data for v in res.data[loc].values())}


def phase_multiprocess(torch, smi: str, sku: str, device: str = "cuda", start_method: str = "spawn") -> dict:
    """Phase 17: SWIRL plans on the ``multiprocess`` backend, one OS process
    per location, array payloads as tensors on ``device`` in every worker
    (see the module doc).  Returns the numbers it prints and the kernels'
    launches inside the workers."""
    import multiprocessing as mp

    from repro_torch import swirl
    from repro_torch.backends import WorkerFailedError
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.core.translate import genomes_1000
    from repro_torch.kernels import ref

    t_phase = time.monotonic()
    out = {"device": smi, "launches": {}}
    plan = dp_pipeline(swirl, DistributedWorkflowInstance, make_workflow)
    split = split_placement(DP_STEPS)
    mp_opts = {"start_method": start_method, "timeout_s": MP_TIMEOUT_S, "ack_timeout": MP_ACK_TIMEOUT_S}

    # (a) P-split at (64, 256) and [8192, 3072]: every datum crosses a process.
    for label, shape in DP_SHAPES.items():
        name = f"{label}/split"
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).to(device)
        feed = {("l0", "d0"): x}
        fns = mp_dp_fns(torch.ones(shape[1], device=device))
        cell, exe, res, reports = mp_cell(torch, name, plan, fns, feed, device, smi, start_method, placement=split)
        store = {}
        for loc in res.data:
            store.update(res.data[loc])
        for k in (0, 4, 8):  # the rmsnorm steps, against the plain version
            check_close(f"{name} multiprocess d{k + 1} = rmsnorm(d{k})", store[f"d{k + 1}"],
                        ref.rmsnorm_ref(store[f"d{k}"], torch.ones(shape[1], device=device)), 2e-5)
        want = {"rmsnorm": DP_NORMS}
        if cell["launches"] != want:
            fail(f"{name}: the workers of a run launched {cell['launches']}, not {want}")
        cell["wire"] = wire_bytes(exe, res)
        out["launches"][name] = cell["launches"]
        out[name] = cell
        print(f"[17] {name}: {cell['wire']['messages']} messages, {cell['wire']['bytes']} B worker to worker, "
              f"{cell['wire']['control_bytes']} B to the coordinator (pickled); rmsnorm {cell['launches']} inside "
              f"the workers")

    # (b) G: 1000 Genomes, one worker process per location.
    inst = genomes_1000(n=4, m=3, a=2, b=2, c=2)
    gplan = swirl.trace(inst).optimize(G_RULES)
    gfns = mp_g_fns(inst, torch.ones(G_ELEMS, device=device))
    init, _ = g_setup(torch, inst, device)
    cell, gexe, gres, reports = mp_cell(torch, "G", gplan, gfns, init, device, smi, start_method)
    cell["wire"] = wire_bytes(gexe, gres)
    wall = cell["multiprocess_ms"][-1]
    if device == "cuda":
        # The bodies' kernels, profiled in this process on threaded (the
        # workers' own are out of this process's profiler's sight), and
        # the events in the workers' bodies, which also hold the host's
        # lazy loading of each kernel at its first launch in a fresh
        # process: the card's busy time lies between them.
        thr = gplan.lower("threaded", timeout_s=THREADED_TIMEOUT_S).compile(gfns)
        thr.run(initial_payloads=dict(init))
        dev_ms = device_ms_and_copies(torch, lambda: thr.run(initial_payloads=dict(init)))[0]
        event_ms = sum(r["device_ms"] for r in reports.values() if "device_ms" in r)
        cell |= {"device_ms": dev_ms, "event_ms": event_ms, "busy_share": dev_ms / wall,
                 "busy_share_events": event_ms / wall}
        print(f"[17] G: the bodies' kernels take {dev_ms:.4f} ms of device time a run (profiled on threaded) "
              f"and {event_ms:.4f} ms by CUDA events in the workers' bodies (with each fresh process's lazy "
              f"kernel loading), of a {wall:.1f} ms run: the card busy {dev_ms / wall:.5%} to "
              f"{event_ms / wall:.3%}; {cell['wire']}; {smi}")
    out["launches"]["G"] = cell["launches"]
    out["G"] = cell

    # (c) A killed worker, and the same kill recovered onto a spare.
    shape = DP_SHAPES["P-ref"]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).to(device)
    feed = {("l0", "d0"): x}
    fns = mp_dp_fns(torch.ones(shape[1], device=device))
    victim = "s6"  # an even step: on l1
    kill = plan.lower("multiprocess", placement=split, _kill_at_step=victim, **mp_opts).compile(fns)
    t0 = time.monotonic()
    try:
        kill.run(initial_payloads=dict(feed))
    except WorkerFailedError as e:
        if (e.location, e.step) != ("l1", victim):
            fail(f"a kill at {victim} surfaced as {e!r}, naming {(e.location, e.step)}")
        out["kill"] = {"error": str(e), "seconds": time.monotonic() - t0}
        print(f"[17] kill at {victim}: {e} ({out['kill']['seconds']:.1f} s)")
    else:
        fail(f"a run whose worker was killed at {victim} did not fail")
    fleet_gone("the killed run", mp, kill.program.last_pids.values())
    spare = plan.lower("multiprocess", placement=split, _kill_at_step=victim, recover="spare", spares=["spare0"],
                       **mp_opts).compile(fns)
    rec = spare.run(initial_payloads=dict(feed))
    cleanres = plan.lower("threaded", placement=split, timeout_s=THREADED_TIMEOUT_S).compile(fns).run(
        initial_payloads=dict(feed))
    renamed = {("spare0" if loc == "l1" else loc): d for loc, d in cleanres.data.items()}
    # The recovery fleet starts from the coordinator's merged store, which
    # holds the first fleet's reports too.
    stores_equal(torch, "P-ref/split recovered onto a spare", without_reports(rec.data), renamed)
    recs = rec.stats["recoveries"]
    if len(recs) != 1 or recs[0]["renaming"] != {"l1": "spare0"} or recs[0]["failed_step"] != victim:
        fail(f"the spare recovery recorded {recs}")
    fleet_gone("the recovered run", mp, spare.program.last_pids.values())
    out["spare"] = {"recoveries": recs, "pids": {str(k): v for k, v in spare.program.last_pids.items()}}
    print(f"[17] the same kill with recover='spare': {recs[0]['renaming']}, completed steps "
          f"{recs[0]['completed_steps']} replayed, the store equal to the clean run's under the renaming")

    # (d) fork after CUDA: a forked worker cannot use its parent's context.
    if device == "cuda":
        timeout = 30.0
        forked = plan.lower("multiprocess", placement=split, start_method="fork", timeout_s=timeout,
                            ack_timeout=MP_ACK_TIMEOUT_S).compile(fns)
        t0 = time.monotonic()
        try:
            forked.run(initial_payloads=dict(feed))
        except WorkerFailedError as e:
            secs = time.monotonic() - t0
            if secs >= timeout or e.location is None or e.step is None:
                fail(f"the forked run failed as {e!r} after {secs:.1f} s (timeout_s {timeout})")
            out["fork"] = {"error": str(e), "location": e.location, "step": e.step, "seconds": secs}
            print(f"[17] fork after CUDA: {e} after {secs:.2f} s (timeout_s {timeout:g})")
        except BaseException as e:  # noqa: BLE001 - any other outcome fails the phase
            fail(f"the forked run raised {e!r}, not a WorkerFailedError")
        else:
            fail("a forked run with CUDA payloads succeeded")
        fleet_gone("the forked run", mp, forked.program.last_pids.values())
    out["seconds"] = time.monotonic() - t_phase
    print(f"[17] the multiprocess backend's phase took {out['seconds']:.1f} s")
    return out


# -- phase 18: the gateway, requests answered over HTTP --------------------------------


def gw_tensor(seed, device: str):
    """A request's GW_SHAPE fp32 tensor, made on ``device`` from its seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(GW_SHAPE, generator=gen, device=device)


def gw_ingest(device: str, inputs: dict) -> dict:
    return {"d_ingest": int(inputs["d_seed"])}


def gw_work(kind: str, device: str, inputs: dict) -> dict:
    """``work_a``: rmsnorm of the request's tensor; ``work_b``: rmsnorm of
    phase 7's mix of it; each answers the sum (a float: JSON)."""
    import torch
    from repro_torch.kernels import ops as kops

    x = gw_tensor(inputs["d_ingest"], device)
    if kind == "b":
        x = 0.5 * x + 0.1 * torch.tanh(x)
    y = kops.rmsnorm(x, torch.ones(x.shape[-1], device=device))
    return {f"d_{kind}": float(y.sum())}


def gw_merge(device: str, inputs: dict) -> dict:
    return {"d_out": inputs["d_a"] + inputs["d_b"]}


def gw_gate(event, inputs: dict) -> dict:
    event.wait(GW_GATE_S)
    return {}


def gw_instance():
    """The serving shape of ``examples/serve_batched.py`` (ingest -> work_a
    || work_b -> merge on gateway, pool_a, pool_b), its sink answering a
    number ``d_out``."""
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow

    wf = make_workflow(
        ["ingest", "work_a", "work_b", "merge"], ["p_seed", "p_ingest", "p_a", "p_b", "p_out"],
        [("p_seed", "ingest"), ("ingest", "p_ingest"), ("p_ingest", "work_a"), ("p_ingest", "work_b"),
         ("work_a", "p_a"), ("work_b", "p_b"), ("p_a", "merge"), ("p_b", "merge"), ("merge", "p_out")])
    return DistributedWorkflowInstance(
        workflow=wf, locations=frozenset({"gateway", "pool_a", "pool_b"}),
        mapping={"ingest": ("gateway",), "work_a": ("pool_a",), "work_b": ("pool_b",), "merge": ("gateway",)},
        data=frozenset({"d_seed", "d_ingest", "d_a", "d_b", "d_out"}),
        placement={"d_seed": "p_seed", "d_ingest": "p_ingest", "d_a": "p_a", "d_b": "p_b", "d_out": "p_out"},
        initial_data={"gateway": frozenset({"d_seed"})})


def gw_steps(device: str) -> dict:
    return {"ingest": functools.partial(gw_ingest, device), "work_a": functools.partial(gw_work, "a", device),
            "work_b": functools.partial(gw_work, "b", device), "merge": functools.partial(gw_merge, device)}


def phase_gateway(torch, smi: str, sku: str, device: str = "cuda", start_method: str = "spawn") -> dict:
    """Phase 18: a ``WorkflowService`` behind a ``Gateway`` on 127.0.0.1
    answering GW_REQUESTS requests from GW_CLIENTS client threads (see the
    module doc).  Returns the numbers it prints and the kernels' launches."""
    from repro_torch import swirl
    from repro_torch.core.parser import dumps
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import Gateway, GatewayClient, GatewayError, TenantConfig, WorkflowService
    from repro_torch.serve.gateway import _jsonable

    t_phase = time.monotonic()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    text = dumps(swirl.trace(gw_instance()).system)
    gate = threading.Event()
    steps = gw_steps(device) | {"gate": functools.partial(gw_gate, gate)}
    tenants = [TenantConfig("bulk", api_key="kb", max_concurrent=GW_CLIENTS, max_queue=GW_CLIENTS),
               TenantConfig("tiny", api_key="kt", max_concurrent=1, max_queue=0)]
    service = WorkflowService(steps, tenants=tenants, lower_options={"timeout_s": THREADED_TIMEOUT_S})
    as_json = lambda v: json.loads(json.dumps(v, default=_jsonable))  # noqa: E731
    norms = 2  # work_a and work_b
    out = {"device": smi}
    with Gateway(service) as gw:
        with GatewayClient(gw.url, api_key="kb") as c:
            fp = c.submit({"swirl": text})["fingerprint"]
            c.run(fp, {"gateway:d_seed": GW_REQUESTS})  # warm: the first request on a cold card
        answers, lat = {}, {}
        errors = []

        def client(k: int) -> None:
            try:
                with GatewayClient(gw.url, api_key="kb") as cl:
                    for i in range(k, GW_REQUESTS, GW_CLIENTS):
                        t0 = time.perf_counter()
                        answers[i] = cl.run(fp, {"gateway:d_seed": i})
                        lat[i] = (time.perf_counter() - t0) * 1e3
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        sync()
        kops.reset_launch_counts()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(GW_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(CHILD_TIMEOUT)
        sync()
        wall = time.perf_counter() - t0
        counts = kops.launch_counts()
        if errors or len(answers) != GW_REQUESTS:
            fail(f"gateway: {len(answers)} of {GW_REQUESTS} requests answered; errors {errors[:3]}")
        want = {"rmsnorm": norms * GW_REQUESTS}
        if counts != want:
            fail(f"gateway: {GW_REQUESTS} requests launched {counts}, not {want}")
        for i in range(GW_REQUESTS):
            inproc = as_json(service.run(fp, {"gateway:d_seed": i}))
            if answers[i] != inproc or not isinstance(answers[i]["data"]["gateway"]["d_out"], float):
                fail(f"gateway: request {i} answered {answers[i]} over HTTP and {inproc} in process")
        x = gw_tensor(0, device)
        check_close("gateway work_a = sum(rmsnorm(x))", torch.tensor(answers[0]["data"]["pool_a"]["d_a"]),
                    ref_sum(torch, x), 1e-3)
        # A tenant over its quota: its one slot held by a run that waits on an event.
        with GatewayClient(gw.url, api_key="kt") as c:
            gfp = c.submit({"dag": {"edges": {"gate": []}, "mapping": {"gate": ["gateway"]}}})["fingerprint"]
        def hold() -> None:
            with GatewayClient(gw.url, api_key="kt") as cl:
                cl.run(gfp)

        held = threading.Thread(target=hold)
        held.start()
        with GatewayClient(gw.url) as c:
            for _ in range(500):
                if c.healthz()["tenants"]["tiny"]["active"] == 1:
                    break
                time.sleep(0.01)
            health = c.healthz()
            metrics = c.metrics()
        try:
            with GatewayClient(gw.url, api_key="kt") as c:
                c.run(gfp)
        except GatewayError as e:
            if e.status != 429 or not e.retry_after or e.retry_after < 1:
                fail(f"gateway: a tenant over its quota got {e.status} (Retry-After {e.retry_after})")
            out["over_quota"] = {"status": e.status, "retry_after": e.retry_after, "reason": e.error.get("reason")}
        else:
            fail("gateway: a tenant over its quota was admitted")
        finally:
            gate.set()
            held.join(GW_GATE_S)
        if health.get("status") != "ok" or "gateway_requests_total" not in metrics:
            fail(f"gateway: /v1/healthz answered {health}, /v1/metrics without its request counter")
        with GatewayClient(gw.url, api_key="kb") as c:
            stats = c.stats()
    ms = sorted(lat.values())
    out |= {"requests": GW_REQUESTS, "clients": GW_CLIENTS, "seconds": wall, "requests_per_s": GW_REQUESTS / wall,
            "p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "launches": counts, "counters": stats["counters"], "cache": stats["cache"]}
    print(f"[18] gateway: {GW_REQUESTS} requests of {list(GW_SHAPE)} fp32 from {GW_CLIENTS} client threads over "
          f"HTTP in {wall:.2f} s, {out['requests_per_s']:.1f} requests/s, p50 {out['p50_ms']:.2f} ms, p99 "
          f"{out['p99_ms']:.2f} ms; every answer equal to the same request in process; rmsnorm launched "
          f"{counts['rmsnorm']} times; over quota: {out['over_quota']}; {smi}")

    # One request on the multiprocess backend: the same number back.
    mp_service = WorkflowService(gw_steps(device), backend="multiprocess",
                                 lower_options={"start_method": start_method, "timeout_s": MP_TIMEOUT_S})
    with Gateway(mp_service) as gw, GatewayClient(gw.url) as c:
        mfp = c.submit({"swirl": text})["fingerprint"]
        t0 = time.perf_counter()
        got = c.run(mfp, {"gateway:d_seed": 3})
        secs = time.perf_counter() - t0
    if mfp != fp or got != answers[3]:
        fail(f"gateway on multiprocess answered {got}, not {answers[3]}")
    out["multiprocess"] = {"seconds": secs, "answer": got["data"]["gateway"]["d_out"]}
    print(f"[18] one request on multiprocess ({start_method}): d_out {got['data']['gateway']['d_out']!r}, the "
          f"threaded service's number, in {secs:.2f} s (a fleet a request)")
    out["phase_seconds"] = time.monotonic() - t_phase
    print(f"[18] the gateway's phase took {out['phase_seconds']:.1f} s")
    return out


def ref_sum(torch, x):
    """The plain version of ``work_a``'s answer: the sum of ``ref.rmsnorm_ref``."""
    from repro_torch.kernels import ref

    return ref.rmsnorm_ref(x, torch.ones(x.shape[-1], device=x.device)).sum().cpu()


def fmt_ms(xs) -> str:
    return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def rmsnorm_times(torch, root: Path) -> int:
    """``--rmsnorm-times ROOT``: the rmsnorm wrapper of the port in ``ROOT``
    (a checkout: this one, or another commit's unpacked beside it) timed at
    RMS_SHAPES beside ``F.rms_norm``, and its host time a call at [4, 3072].
    Run it once for each of two checkouts in turns (A, B, B, A) to compare
    them on one card; it prints one JSON line."""
    import torch.nn.functional as F

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import rmsnorm

    _build.build(("rmsnorm",))
    bench = Bench(torch, sku_of(torch.cuda.get_device_name(0)))
    g = torch.Generator(device="cuda").manual_seed(1234)
    res = {"root": str(root), "device": nvidia_smi(), "ms": {}, "library_ms": {}}
    for n, dm in RMS_SHAPES:
        x = torch.randn((n, dm), generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn((dm,), generator=g, device="cuda").to(torch.bfloat16) * 0.1
        w1 = 1.0 + w
        res["ms"][f"[{n}, {dm}]"] = bench.ms(lambda: rmsnorm(x, w))
        res["library_ms"][f"[{n}, {dm}]"] = bench.ms(lambda: F.rms_norm(x, (dm,), weight=w1, eps=1e-6))
        if n == BATCH:
            res["host_us"] = host_us(torch, lambda: rmsnorm(x, w))
    print(json.dumps(res))
    return 0


def dataplane_times(torch, root: Path) -> int:
    """``--dataplane-times ROOT``: the untraced data plane of the port in
    ``ROOT`` (phase 7's P-ref and P-full, interpreted and fused), DP_REPEATS
    runs an arm after a warm one.  Run it for two checkouts in turns (A, B,
    B, A) to compare them on one card; it prints one JSON line."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch import swirl
    from repro_torch.core.graph import DistributedWorkflowInstance, make_workflow
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops

    _build.build(("rmsnorm",))
    plan = dp_pipeline(swirl, DistributedWorkflowInstance, make_workflow)
    mix = lambda v: 0.5 * v + 0.1 * torch.tanh(v)  # noqa: E731
    res = {"root": str(root), "device": nvidia_smi()}
    for label, shape in DP_SHAPES.items():
        w = torch.ones(shape[1], device="cuda")
        fns = dp_fns(lambda v, w=w: kops.rmsnorm(v, w), mix)
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32)).cuda()
        for fuse in (False, True):
            t, _ = dp_time(torch, plan.lower("torch", fuse=fuse).compile(fns), {("l0", "d0"): x})
            res[f"{label} {'fused' if fuse else 'interpreted'}"] = {
                "min_ms": min(t), "median_ms": statistics.median(t), "ms": t}
    print(json.dumps(res))
    return 0


def dataplane_compare(a: Path, b: Path, pairs: int) -> int:
    """``--dataplane-compare A B``: ``--dataplane-times`` of the checkouts at
    A (the parent) and B (the change), one process each, in ``pairs`` pairs
    whose order alternates (A B, B A, ...).  For each cell it prints the
    per-process medians of both sides, the ratio B / A of each pair's
    medians, and a verdict: "slower" or "faster" when at least
    SIGN_AGREE of the pairs agree in sign (a two-sided sign test at
    p < 0.05 for 10 pairs), else "unresolved".  One JSON line."""
    runs = {"A": [], "B": []}
    for i in range(pairs):
        for side in (("A", "B") if i % 2 == 0 else ("B", "A")):
            root = a if side == "A" else b
            p = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--dataplane-times",
                                str(root)], capture_output=True, text=True, timeout=600)
            if p.returncode != 0:
                print(p.stderr[-4000:], file=sys.stderr)
                fail(f"--dataplane-times {root} exited {p.returncode}")
            runs[side].append(json.loads(p.stdout.strip().splitlines()[-1]))
    res = {"A": str(a), "B": str(b), "pairs": pairs, "device": runs["A"][0]["device"], "cells": {}}
    for cell in [k for k in runs["A"][0] if k not in ("root", "device")]:
        med = {s: [r[cell]["median_ms"] for r in runs[s]] for s in runs}
        mins = {s: [r[cell]["min_ms"] for r in runs[s]] for s in runs}
        ratios = [y / x for x, y in zip(med["A"], med["B"])]
        slower = sum(r > 1 for r in ratios)
        faster = sum(r < 1 for r in ratios)
        verdict = ("slower" if slower >= SIGN_AGREE * pairs else
                   "faster" if faster >= SIGN_AGREE * pairs else "unresolved")
        res["cells"][cell] = {
            "A_median_ms": med["A"], "B_median_ms": med["B"], "A_min_ms": mins["A"],
            "B_min_ms": mins["B"], "ratio_of_medians": ratios,
            "median_ratio": statistics.median(ratios), "pairs_slower": slower,
            "pairs_faster": faster, "verdict": verdict,
        }
        print(f"{cell}: median of per-process medians A {statistics.median(med['A']):.4f} ms, "
              f"B {statistics.median(med['B']):.4f} ms; B/A median {statistics.median(ratios):.4f}, "
              f"{slower} of {pairs} pairs slower, {faster} faster: {verdict}")
    print(json.dumps(res))
    return 0


# -- phase 19: DeepSeek-V2-Lite's multi-head latent attention --------------------------


def phase_mla(torch, smi: str, sku: str) -> dict:
    """Phase 19: the absorbed MLA decode kernel against its plain version and
    timed at the long-prompt cell's shape, then MLA_ARCH served at full width
    and depth with exact launch counts.  Returns the kernel's row and the
    serve's launches."""
    import torch.nn.functional as F

    from bench.counts import mla as mla_counts
    from repro_torch.configs import get_config
    from repro_torch.kernels import mla_decode as kmla
    from repro_torch.kernels import ref
    from repro_torch.models import mla

    cfg = get_config(MLA_ARCH)
    lat, rope, h = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim, cfg.n_heads
    b, rows, kv = MLA_BATCH, MLA_CACHE, MLA_KV
    scale = mla.softmax_scale(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(b, h, lat + rope, generator=g, device="cuda").bfloat16()
    buf = torch.randn(b, rows, lat + rope, generator=g, device="cuda").bfloat16()
    q_lat, q_pe, c_kv, k_pe = q[..., :lat], q[..., lat:], buf[..., :lat], buf[..., lat:]
    chunk = kmla.split_chunk(rows, b, torch.cuda.get_device_properties(0).multi_processor_count)
    rels = {}
    for n in (1, chunk, chunk + 1, kv, rows):
        got = kmla.mla_decode(q_lat, q_pe, c_kv, k_pe, torch.tensor(n, dtype=torch.int32, device="cuda"), scale)
        want = ref.mla_decode_ref(q_lat.float(), q_pe.float(), c_kv.float(), k_pe.float(), n, scale)
        rels[n] = rel_l2(got, want)
    print(f"[19] mla_decode B{b} H{h} cache {rows} x {lat}+{rope} bf16 against fp32, rel L2 by kv_len: "
          f"{', '.join(f'{n} {r:.3e}' for n, r in rels.items())} (tol {MLA_REL_L2_TOL:g})")
    if not all(r <= MLA_REL_L2_TOL for r in rels.values()):  # so that a NaN fails too
        fail(f"mla_decode disagrees with its plain version: {rels}")

    bench = Bench(torch, sku)
    kv_len = torch.tensor(kv, dtype=torch.int32, device="cuda")
    # The library's yardstick: one SDPA call, the 576-wide cache rows as one
    # key head for all 16 query heads and their first 512 as the value.
    qs, ks, vs = q[:, :, None], buf[:, None, :kv], c_kv[:, None, :kv]
    t = bench.ms(lambda: kmla.mla_decode(q_lat, q_pe, c_kv, k_pe, kv_len, scale))
    tp = bench.ms(lambda: ref.mla_decode_ref(q_lat, q_pe, c_kv, k_pe, kv_len, scale))
    tl = bench.ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=scale, enable_gqa=True))
    bound, by = bench.bound(mla_counts.mla_decode_bytes(b, h, kv, lat, rope),
                            mla_counts.mla_decode_flops(b, h, kv, lat, rope), "bf16")
    shape = f"B{b} H{h} cache {rows} kv={kv} latent {lat}+{rope}"
    print(f"[19] mla_decode {shape}: kernel {us(t)}, plain {us(tp)}, library {us(tl)}, kernel/library "
          f"{t / tl:.3g}x; bound {us(bound)} ({by}), {bound / t:.3g} of bound  ({smi})")
    row = {"shape": shape, "ms": t, "plain_ms": tp, "library_ms": tl, "bound_ms": bound, "bound_by": by,
           "max_rel_l2": max(rels.values()), "rel_l2_by_kv_len": {str(n): r for n, r in rels.items()}}
    del bench, q, buf, q_lat, q_pe, c_kv, k_pe, qs, ks, vs, kv_len
    torch.cuda.empty_cache()

    n = len(cfg.layer_seq())
    per_prefill, per_step = serve_launches(cfg)
    if (per_prefill.get("mla_decode", 0), per_step.get("mla_decode", 0), per_step.get("decode_attention", 0)) != (
            0, n, 0):
        fail(f"{MLA_ARCH}: serve_launches counts {per_prefill}, {per_step} for {n} MLA layers")
    print(f"[19] serve {MLA_ARCH} full width: {n} layers of MLA (latent {lat}, rope {rope}, {h} heads), "
          f"d {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}")
    res, counts, peak_gb = serve_counted(torch, "19", cfg, smi)
    return {"row": row, "launches": counts, "prefill_ms": res["prefill_s"] * 1e3,
            "decode_ms": res["decode_s"] * 1e3, "tok_per_s": res["tok_per_s"], "peak_gb": peak_gb, "device": smi}


# -- phase 20: the MoE slot kernel ---------------------------------------------------------


def slot_ids(torch, t: int, k: int, e: int, seed: int, device, collapsed: bool = False):
    """A router's ``[T, k]`` choices as the model hands them to the slot
    kernel: the first k columns (a strided view) of a stable descending sort
    of skewed scores, so each token's k experts differ and some experts are
    far more popular.  ``collapsed``: every token the same k experts."""
    if collapsed:
        return torch.arange(k, device=device).expand(t, k).clone()
    g = torch.Generator(device=device).manual_seed(seed)
    scores = torch.randn(t, e, generator=g, device=device) + 2.0 * torch.randn(e, generator=g, device=device)
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def slot_shapes(get_config) -> dict:
    """Phase 20's shapes, a name each: ``(T, k, E, capacity)``, the edges'
    at a capacity factor of 1.25."""
    from types import SimpleNamespace

    from repro_torch.models.moe import moe_capacity

    shapes = {}
    for name, (arch, t) in SLOT_CALLS.items():
        cfg = get_config(arch)
        shapes[name] = (t, cfg.moe.top_k, cfg.moe.n_experts, moe_capacity(cfg, t))
    for t, k, e in SLOT_EDGES:
        cfg = SimpleNamespace(moe=SimpleNamespace(n_experts=e, top_k=k, capacity_factor=1.25))
        shapes[f"edge {t * k} choices E{e} k{k}"] = (t, k, e, moe_capacity(cfg, t))
    return shapes


def phase_moe_slots(torch, smi: str, sku: str) -> dict:
    """Phase 20: the MoE slot kernel against its plain version, bit for bit,
    at every shape of :func:`slot_shapes` and with a collapsed router, in a
    replayed CUDA graph and with no host sync; timed at the cells' calls.
    Returns the kernel's rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_slots as kslots
    from repro_torch.kernels import ref

    shapes = slot_shapes(get_config)

    def exact(name, ids, e, cap):
        got, want = kslots.moe_slots(ids, e, cap), ref.moe_slots_ref(ids, e, cap)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
            fail(f"moe_slots differs from its plain version at {name}: {bad} of {2 * want[0].numel()} values")

    for i, (name, (t, k, e, cap)) in enumerate(shapes.items()):
        exact(name, slot_ids(torch, t, k, e, SEED + i, "cuda"), e, cap)
        exact(f"{name}, collapsed", slot_ids(torch, t, k, e, 0, "cuda", collapsed=True), e, cap)
    print(f"[20] moe_slots equals its plain version bit for bit at {len(shapes)} shapes, routed and collapsed: "
          f"{', '.join(f'{n} ({t * k})' for n, (t, k, _, _) in shapes.items())}")

    # Captured into a CUDA graph, replayed on new choices; no host sync.
    replays = 0
    for name in ("deepseek-moe-16b decode step", "deepseek-moe-16b.decode prefill"):
        t, k, e, cap = shapes[name]
        static = slot_ids(torch, t, k, e, SEED, "cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kslots.moe_slots(static, e, cap)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kslots.moe_slots(static, e, cap)
        for seed in range(3):
            ids = slot_ids(torch, t, k, e, SEED + 100 + seed, "cuda")
            static.copy_(ids)
            graph.replay()
            want = ref.moe_slots_ref(ids, e, cap)
            if not (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])):
                fail(f"moe_slots replayed from a CUDA graph differs from its plain version at {name}")
            replays += 1
        del graph
        torch.cuda.set_sync_debug_mode("error")
        try:
            kslots.moe_slots(static, e, cap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[20] moe_slots replayed {replays} times from CUDA graphs, each equal to its plain version; no host "
          f"sync under set_sync_debug_mode('error')")

    bench = Bench(torch, sku)
    rows = []
    for name in SLOT_CALLS:
        t, k, e, cap = shapes[name]
        ids = slot_ids(torch, t, k, e, SEED, "cuda")
        onehot = torch.nn.functional.one_hot(ids.reshape(-1), e).to(torch.int32)
        tk = bench.ms(lambda: kslots.moe_slots(ids, e, cap))
        tp = bench.ms(lambda: ref.moe_slots_ref(ids, e, cap))
        tl = bench.ms(lambda: torch.cumsum(onehot, dim=0, dtype=torch.int32))
        bound, by = bench.bound(17 * t * k, 0, "bf16")
        chunks, launches = kslots.plan(t * k)
        shape = f"{name}: T {t} x k {k} = {t * k} choices, E {e}, C {cap}"
        print(f"[20] moe_slots {shape}, {launches} launch(es) of {chunks} block(s): kernel {us(tk)}, plain "
              f"{us(tp)}, library (one cumsum) {us(tl)}; bound {us(bound)} ({by}), {bound / tk:.3g} of bound  "
              f"({smi})")
        rows.append({"shape": shape, "choices": t * k, "launches_a_call": launches, "ms": tk, "plain_ms": tp,
                     "library_ms": tl, "bound_ms": bound, "bound_by": by})
        del onehot
    del bench
    torch.cuda.empty_cache()
    return {"rows": rows, "shapes": len(shapes), "replays": replays, "device": smi}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmsnorm-times", metavar="ROOT", type=Path,
                    help="only time the rmsnorm wrapper of the checkout at ROOT")
    ap.add_argument("--dataplane-times", metavar="ROOT", type=Path,
                    help="only time the untraced data plane of the checkout at ROOT")
    ap.add_argument("--dataplane-compare", metavar=("A", "B"), type=Path, nargs=2,
                    help="--dataplane-times of checkouts A and B in alternating pairs")
    ap.add_argument("--pairs", type=int, default=10, help="pairs for --dataplane-compare")
    ap.add_argument("--families", metavar="OUT", type=Path,
                    help="only phase 12, the other families, its result to OUT (the child process of a whole run)")
    ap.add_argument("--training", metavar="OUT", type=Path,
                    help="only phase 13, training xlstm-125m and gemma2-27b, its result to OUT (a child process)")
    ap.add_argument("--distribution", metavar="OUT", type=Path,
                    help="only phase 14, distribution on a 1 x 1 mesh, its result to OUT (a child process)")
    ap.add_argument("--dryrun", metavar="OUT", type=Path,
                    help="only phase 15, the dry-run and the roofline, its result to OUT (a child process)")
    ap.add_argument("--threaded", metavar="OUT", type=Path,
                    help="only phase 16, the threaded backend, its result to OUT (a child process)")
    ap.add_argument("--multiprocess", metavar="OUT", type=Path,
                    help="only phase 17, the multiprocess backend, its result to OUT (a child process)")
    ap.add_argument("--gateway", metavar="OUT", type=Path,
                    help="only phase 18, the gateway over HTTP, its result to OUT (a child process)")
    ap.add_argument("--mla", metavar="OUT", type=Path,
                    help="only phase 19, DeepSeek-V2-Lite's latent attention, its result to OUT (a child process)")
    ap.add_argument("--moe-slots", metavar="OUT", type=Path,
                    help="only phase 20, the MoE slot kernel, its result to OUT (a child process)")
    opts = ap.parse_args()
    # One process makes and frees models of up to 34 GB and trains two more:
    # with fixed segments the freed memory splinters, and phase 11's jamba
    # (1.75 GiB expert tensors, 3.5 GiB fp32 draws) found 59 GiB reserved but
    # no free block of 1.75 GiB (PR 18, call 2).  Segments that grow in place
    # do not splinter so.  A caller's own setting is kept.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # Phase 3 compiles FlexAttention (the library's call for gemma2's
    # attention): its caches go under the checkout's build directory.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    try:
        import torch
    except ModuleNotFoundError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if opts.dataplane_compare is not None:
        a, b = (r.resolve() for r in opts.dataplane_compare)
        return dataplane_compare(a, b, opts.pairs)
    other = opts.rmsnorm_times or opts.dataplane_times
    root = ROOT if other is None else other.resolve()
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch in {root}", file=sys.stderr)
        return 1
    if opts.rmsnorm_times is not None:
        return rmsnorm_times(torch, root)
    if opts.dataplane_times is not None:
        return dataplane_times(torch, root)
    sys.path.insert(0, str(ROOT / "src"))
    if opts.families is not None:
        return child(torch, opts.families, phase_families)
    if opts.training is not None:
        return child(torch, opts.training, phase_training)
    if opts.distribution is not None:
        return child(torch, opts.distribution, phase_distribution)
    if opts.dryrun is not None:
        return child(torch, opts.dryrun, phase_dryrun)
    if opts.threaded is not None:
        return child(torch, opts.threaded, phase_threaded)
    if opts.multiprocess is not None:
        return child(torch, opts.multiprocess, phase_multiprocess)
    if opts.gateway is not None:
        return child(torch, opts.gateway, phase_gateway)
    if opts.mla is not None:
        return child(torch, opts.mla, phase_mla)
    if opts.moe_slots is not None:
        return child(torch, opts.moe_slots, phase_moe_slots)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch._bridge import tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import make_prompts, serve
    from repro_torch.models import Model

    t_start = time.monotonic()
    # -- 1. environment -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    sku = sku_of(name)
    print(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[1] device {name} x{torch.cuda.device_count()}; bounds from the {sku} data sheet")
    print(f"[1] nvidia-smi: {smi}")

    # -- 2. build -----------------------------------------------------------------
    t0 = time.monotonic()
    secs = kops.build()
    print(f"[2] built {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}; {time.monotonic() - t0:.1f} s in all")
    from repro_torch.kernels import _build

    for kernel in _build.KERNELS:
        report = ptxas_report((_build.BUILD_DIR / f"{kernel}.log").read_text())
        spilled = [r for r in report if r[2] or r[3]]
        if kernel == "rmsnorm":
            for fn, regs, st, ld in report:
                print(f"  {fn}: {regs} registers, spill stores {st} B, spill loads {ld} B")
        else:
            print(f"  {kernel}: {len(report)} kernels, {min(r[1] for r in report)}-"
                  f"{max(r[1] for r in report)} registers, {len(spilled)} with spills")
        if kernel == "rmsnorm" and spilled:
            fail(f"rmsnorm spills registers: {spilled}")

    # -- 12. the other families, in a child process, before this one holds memory --------
    # In this process, phase 12's profiles of the big models made phase 7's
    # later profiles lose kernel records (a P-full replay showed 2 of its 3
    # rmsnorm kernels); a process of its own keeps them apart, and finds the
    # card free.
    families = run_child("12", "--families", "the families")

    # -- 13. training xlstm-125m and gemma2-27b, in a child process, on a free card ---------
    # TR-gemma2 peaks at 68.29 GB (PERF.md, section 5), and from phase 10 on this
    # process holds 59-62 GiB reserved (PERF.md, section 7).
    training = run_child("13", "--training", "training")

    # -- 14. distribution: the hinted model on DTensors, a 1 x 1 mesh -------------------------
    distribution = run_child("14", "--distribution", "distribution")

    # -- 15. the dry-run on the card's torch, and the roofline beside two measured cells -----
    dryrun = run_child("15", "--dryrun", "the dry-run")

    # -- 16. the threaded backend: one host thread per location, tensors on the card -------
    threaded = run_child("16", "--threaded", "the threaded backend")

    # -- 17. the multiprocess backend: one OS process per location, tensors on the card ----
    multiprocess = run_child("17", "--multiprocess", "the multiprocess backend")

    # -- 18. the gateway: workflow requests answered over HTTP, steps on the card ----------
    gateway = run_child("18", "--gateway", "the gateway")

    # -- 19. DeepSeek-V2-Lite: the MLA decode kernel, and the model served ------------------
    mla = run_child("19", "--mla", "latent attention")

    # -- 20. the MoE slot kernel ------------------------------------------------------------
    slots = run_child("20", "--moe-slots", "the MoE slot kernel")

    # -- 3. kernels vs plain -----------------------------------------------------
    bench = Bench(torch, sku)
    rows = phase_kernels(torch, bench)
    del bench
    torch.cuda.empty_cache()

    # -- 4. serve at full width ---------------------------------------------------
    cfg = get_config(ARCH)
    n_layers = len(cfg.layer_seq())
    print(f"[4] serve {ARCH} full width: {n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    res = serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT_LEN, gen=GEN, seed=SEED)
    counts = kops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = res["tokens"]
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"tokens out of range or shape: {toks.shape}, [{toks.min()}, {toks.max()}]")
    steps = GEN - 1
    want = {
        "rmsnorm": (2 * n_layers + 1) * (1 + steps),
        "flash_attention": n_layers,
        "decode_attention": n_layers * steps,
    }
    print(f"[4] launches {counts} (expected {want})")
    if counts != want:
        fail("the serving path did not launch each kernel as expected")
    print(
        f"[4] prefill {res['prefill_s'] * 1e3:.2f} ms, decode {res['decode_s'] * 1e3:.2f} ms "
        f"for {steps} steps ({res['tok_per_s']:.1f} tok/s), peak memory {peak_gb:.2f} GB"
    )
    print(f"[4] tokens[0]: {toks[0].tolist()}")

    # -- 5. cross-check against the plain path on the card -------------------------
    model = Model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = make_prompts(cfg, BATCH, PROMPT_LEN, SEED, "cuda")

    def rel_l2s(xs, ys):
        return [rel_l2(a, b) for a, b in zip(xs, ys)]

    kern = cross_run(torch, model, params, prompts, "kernel")
    feed = [o.argmax(-1, keepdim=True).int() for o in kern[:-1]]
    plain = cross_run(torch, model, params, prompts, "plain", feed)  # teacher-forced with the kernel path's tokens
    for i, a in enumerate(kern):
        if not bool(a.isfinite().all()):
            fail(f"non-finite logits on the kernel path at step {i}")
    rels = rel_l2s(kern, plain)
    worst = max(rels)
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean()) for a, b in zip(kern, plain)]
    # The plain path in fp32 on the same (bf16-valued) weights.
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), "cuda")
    f32 = cross_run(torch, m32, tree_map(lambda t: t.float(), params), prompts, "plain", feed)
    del m32
    torch.cuda.empty_cache()
    fed = torch.cat(feed, dim=1).cpu().numpy()  # the kernel path's first tokens
    same_as_serve = bool((fed == toks[:, :CROSS_STEPS]).all())

    print(
        f"[5] plain vs kernel, last-position logits over prefill + {CROSS_STEPS} steps: "
        f"max rel L2 {worst:.3e} (tol {REL_L2_TOL:g}), per step {fmt_list(rels)}; greedy "
        f"agreement per step {agree}; kernel-path tokens equal serve()'s: {same_as_serve}"
    )
    # Both bf16 paths against the plain path in fp32 on the same weights: the
    # kernel path may be at most F32_RATIO times as far from it as the plain
    # bf16 path, step by step (bf16 noise through 28 layers sets both).
    k32, p32 = rel_l2s(kern, f32), rel_l2s(plain, f32)
    ratios = [a / b for a, b in zip(k32, p32)]
    print(
        f"[5] against the plain path in fp32 (same weights), rel L2 per step: "
        f"kernel {fmt_list(k32)}, plain bf16 {fmt_list(p32)}; kernel / plain {fmt_list(ratios)} "
        f"(tol {F32_RATIO:g})"
    )
    if not all(r <= REL_L2_TOL for r in rels):  # so that a NaN fails too
        fail(f"kernel path disagrees with the plain path: rel L2 {rels}")
    if not all(r <= F32_RATIO for r in ratios):
        fail(f"kernel path is {ratios} times as far from fp32 as the plain bf16 path")

    # -- 6. where a decode step's time goes, beside its bound -----------------------------
    profiled_decode_bound(torch, "6", model, params, prompts, smi, sku)

    # -- 7. the data plane: SWIRL's own main path ----------------------------------------
    del model, params
    torch.cuda.empty_cache()
    dataplane = phase_dataplane(torch, smi)
    print(f"[7] P-full untraced, launches from zero: {dataplane['launches']}")

    # -- 8. trace, schedule and certify on the card ----------------------------------------
    torch.cuda.empty_cache()
    traced = phase_traced(torch, smi)

    # -- 9. training on the card ---------------------------------------------------------
    train = phase_train(torch, smi, sku)

    # -- 10. MoE on the card ---------------------------------------------------------------
    moe = phase_moe(torch, smi, sku)

    # -- 11. the recurrent archs on the card --------------------------------------------------
    recurrent = phase_recurrent(torch, smi, sku)

    # -- result ----------------------------------------------------------------------------
    src = "src/repro_torch/csrc/{}.cu"
    replaces = {
        "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
        "flash_attention": "src/repro/kernels/flash_attention.py:38",
        "decode_attention": "src/repro/kernels/decode_attention.py:35",
    }
    record = []
    for k in ("rmsnorm", "flash_attention", "decode_attention"):
        r = rows[k][0]  # the serving shape; "rows" has every timed shape
        record.append({
            "name": k, "route": "cuda", "source": src.format(k), "replaces": replaces[k],
            "launches": counts.get(k, 0), "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"], "rows": rows[k],
            "launches_by_path": {
                "serve": counts.get(k, 0),
                **{path: {arm: c.get(k, 0) for arm, c in res["launches"].items()}
                   for path, res in (("dataplane", dataplane), ("traced", traced))},
                "train": train["launches"].get(k, 0),
                **{f"serve {arch}": {path: c.get(k, 0) for path, c in moe[arch]["launches"].items()}
                   for arch in MOE_ARCHS},
                f"train {MOE_TRAIN_ARCH}": moe["train"]["launches"].get(k, 0),
                **{f"serve {arch}": {path: c.get(k, 0) for path, c in recurrent[arch]["launches"].items()}
                   for arch in REC_ARCHS},
                **{f"serve {arch}": {path: c.get(k, 0) for path, c in families[arch]["launches"].items()}
                   for arch in FAMILY_ARCHS},
                **{f"train {cell}": training[cell]["launches"].get(k, 0) for cell in TRAIN_CELLS},
                **{f"fwdbwd {cell}": {mode: c.get(k, 0) for mode, c in distribution[cell]["launches"].items()}
                   for cell in DIST_CELLS},
                **{f"step {cell}": dryrun[cell]["launches"].get(k, 0) for cell in ("R-decode", "R-train")},
                **{f"threaded {path}": c.get(k, 0) for path, c in threaded["launches"].items()},
                **{f"multiprocess {path}": c.get(k, 0) for path, c in multiprocess["launches"].items()},
                "gateway": gateway["launches"].get(k, 0),
                f"serve {MLA_ARCH}": mla["launches"].get(k, 0),
            },
        })
    r = mla["row"]
    record.append({
        "name": "mla_decode", "route": "cuda", "source": src.format("mla_decode"), "replaces": None,
        "launches": mla["launches"].get("mla_decode", 0), "max_rel_l2": r["max_rel_l2"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"], "shape": r["shape"], "rows": [r],
        # Every other path's expected counts hold it at 0.
        "launches_by_path": {f"serve {MLA_ARCH}": mla["launches"].get("mla_decode", 0)},
    })
    r = slots["rows"][0]  # a decode step's call; "rows" has every cell's
    record.append({
        "name": "moe_slots", "route": "cuda", "source": src.format("moe_slots"), "replaces": None,
        "launches": moe["deepseek-moe-16b"]["launches"]["serve"].get("moe_slots", 0), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "rows": slots["rows"],
        "launches_by_path": {
            **{f"serve {arch}": {path: c.get("moe_slots", 0) for path, c in moe[arch]["launches"].items()}
               for arch in MOE_ARCHS},
            f"train {MOE_TRAIN_ARCH}": moe["train"]["launches"].get("moe_slots", 0),
            f"serve {MLA_ARCH}": mla["launches"].get("moe_slots", 0),
            **{f"fwdbwd {cell}": {mode: c.get("moe_slots", 0) for mode, c in distribution[cell]["launches"].items()}
               for cell in DIST_CELLS},
        },
    })
    print(json.dumps({"dataplane": dataplane}))
    print(json.dumps({"traced": traced}))
    print(json.dumps({"train": train}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"recurrent": recurrent}))
    print(json.dumps({"families": families}))
    print(json.dumps({"training": training}))
    print(json.dumps({"distribution": distribution}))
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"threaded": threaded}))
    print(json.dumps({"multiprocess": multiprocess}))
    print(json.dumps({"gateway": gateway}))
    print(json.dumps({"mla": mla}))
    print(json.dumps({"moe_slots": slots}))
    print(f"kernels: {', '.join(r['name'] for r in record)}; {time.monotonic() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
