#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (pcfm_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only voxel   # phases 1, 10 and 31 alone
    python3 chip_smoke.py --only chamfer # phases 1 and 14 alone
    python3 chip_smoke.py --only hybrid_train  # phases 1 and 17-20 alone
    python3 chip_smoke.py --only distill # phases 1 and 21-23 alone
    python3 chip_smoke.py --only distill --seed 1  # other weights and data
    python3 chip_smoke.py --only parallel # phases 1 and 24-25 alone
    python3 chip_smoke.py --only wide    # phases 1 and 26-28 alone
    python3 chip_smoke.py --only interop # phases 1 and 29-30 alone
    python3 chip_smoke.py --only data    # phases 1 and 32 alone
    python3 chip_smoke.py --only learning  # phases 1 and 33 alone

Needs one CUDA device (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; imports nothing of JAX.  Phases, each fatal on
failure:

1. build every kernel of the path from pcfm_torch/csrc with nvcc;
2. kernel vs plain: the fused FiLM-block kernel against its plain-torch
   version (fp32 math, TF32 off), bitwise equal across two launches, at
   the sampling path's shapes (8 and 16 clouds x 20 000 points x 512
   channels) and the edges (1 and 129 points; bf16 and fp32; C = 1024);
   CUDA-event times of the kernel, the plain version and one torch.matmul
   of the same product alone (a yardstick, not used by the port), and the
   W bytes the kernel reads from L2 (reckoned from the grid, not measured);
3. main path: a full-width reference-format checkpoint of the bench
   configuration (bench.py: 8 clouds x 20 000 RGB points, latent 128,
   cond_dim 1, mlp point flow 512/6/256, latent flow 512/6/256, bf16
   compute, Heun x 50) with random weights from a seeded generator,
   sampled through the sampling CLI, plain and with guidance 0.25; the
   kernel must run 5 blocks x 100 evaluations = 500 times per run;
4. Heun x 50 ms/shape with the kernel trunk and with the plain trunk;
5. kernel trunk vs plain trunk end to end: the same priors through 4 Heun
   steps, each bf16 path against an fp32 plain run;
6. backward kernel vs plain: all seven gradients of the FiLM-block
   backward kernel against its plain-torch version at (8 | 16, 20 000,
   512) bf16 and the edges (N = 1, 129, 300; C = 128, 256, 384; fp32
   inputs), each within GRAD_REL_TOL of the gradient's max, bitwise equal
   across two launches; fp32 inputs with W = 0 (df = dy), every gradient
   but dW within FP32_DY_TOL; CUDA-event times of the kernel, the plain
   version and one torch.matmul of each of its two products alone
   (yardsticks, not used by the port), W's L2 bytes (reckoned), and the
   rows and dW passes' device times from one profiled run;
7. the training path: the training CLI at the same full width
   (`--dataset_type synthetic`, 8 steps, validation, a checkpoint); the
   forward and backward kernels must run 5 times per step, the losses be
   finite, and a rerun must find nothing to do;
8. train step ms at bench.py's workload with the kernel trunk and the plain
   trunk in turns (x 293 steps = s/epoch), peak memory, and the kernels'
   share of device time from one torch.profiler run;
9. determinism: two 3-step runs from one seed and batch (kernel trunk)
   give bitwise-equal losses and parameters;
10. voxel kernels vs plain: the gather and the scatter against their
   plain-torch versions (fp32 math) at the hybrid's stage shapes
   ((R, C) = (32, 128), (16, 256), (8, 256); 8 and 16 clouds x 20 000
   points; K = 1 and 8; bf16 and fp32 inputs) and skewed (every point of
   a cloud in one voxel: one run of K x N entries), two launches bitwise
   equal, CUDA-event times of the kernel, the plain version and the one
   PyTorch call that computes the same function (``F.grid_sample`` for the
   K = 8 gather, ``scatter_reduce(mean)`` for the K = 1 scatter-mean), the
   kernel's device time (CUDA events around calls queued behind a sleep
   kernel: no host time between them) and the output's write alone (a
   floor);
11. the hybrid main path: a full-width hybrid checkpoint of the bench
   configuration with the Config's ContextNet (128/256/256 channels, 2/2/2
   blocks, resolutions 32/16/8, SE, GroupNorm 32, global branch, bf16
   island; head 512/6/256 with the kernel trunk), random weights from a
   seeded generator, through the sampling CLI (``--device cuda``), plain
   and with guidance 0.25: exact launch counts (FiLM block 5 x 100, gather
   and scatter one each per PVConv per evaluation: 6 x 100), 8 finite
   clouds and PLYs, peak memory;
12. hybrid Heun x 50 ms/shape (three runs after a warm-up) and one
   torch.profiler run: device time and launches of the gather, the
   scatter, the FiLM block, the convolutions and the scatter plans' glue
   (sort, searchsorted, cumsum), and the idle share;
13. end to end: the full-width hybrid velocity on the same checkpoint and
   inputs at (2, 20 000), on the card (bf16, kernels) and on the CPU (fp32,
   plain versions), within HYB_E2E_REL_TOL of each other;
14. chamfer kernel vs plain: the nearest-neighbour kernel against its
   plain-torch version at (8 | 16, 20 000, 3) fp32 both ways, N != M off
   the tile, duplicated targets (ties must go to the lowest index) and the
   suite's pairs form (32 clouds x 2048 points, all 32^2 pairs), within
   CHAMFER_REL_TOL, bitwise equal across two launches; CUDA-event times of
   the kernel, the plain version and ``cdist`` + ``min`` (8 and 16
   clouds; the pairs form); then the cases
   that test its screen's margin at (8, 20 000, 3): clouds shifted by 1e2
   and 1e4, an integer lattice (exact ties: the indices must equal the
   plain version's), clouds sorted along x, each held the same way and
   timed; the tensor cores' screen against its plain version (D = 3 and
   8, shifted), within the SCREEN_KAPPA its margin assumes; and a query
   with a NaN coordinate, which must get a valid index (and a gradient
   through it) while the other queries stay right;
15. the evaluation CLI at full width on phase 7's trained run (8 x 20 000,
   synthetic; recon and gen, 2 batches, Heun x 50): exact chamfer launches
   (2 a batch), 500 FiLM-block launches per Heun x 50 call, finite
   recon_ / gen_ cd, emd, fscore, precision, recall; the streamed EMD's
   time per batch and a profile of one batch's metrics;
16. the suite: a full-width mlp checkpoint with random weights (the
   synthetic test split at 2048 points) through ``--mode suite
   --suite_size 32 --suite_emd --suite_seeds 0,1``: exact launches, finite
   MMD / COV / 1-NNA bands in range;
17. hybrid training: the training CLI with ``--pf_backbone hybrid`` at the
   bench configuration (phase 11's; synthetic, one epoch of 8 steps,
   validation, a checkpoint, a rerun with nothing to do): exact launches
   (HYB_STEP_LAUNCHES a step: FiLM block 5 forward and 5 backward; gather
   and scatter 12 each: a K = 1 scatter and a K = 8 gather forward a
   PVConv, a K = 1 gather and a K = 8 scatter backward), validation's
   counted apart, finite losses, the BatchNorm updates, peak memory;
18. the hybrid train step's ms/step (host clock, 3 x 10 steps after 3
   warm-up steps; x 293 = s/epoch), peak memory, and one torch.profiler
   run of 3 steps: the wrapper launches per step (HYB_STEP_LAUNCHES;
   the kernels line's ``launches_hybrid_train``), device busy time, idle
   share, device time and launches of the voxel kernels, the FiLM
   forward and backward, cuDNN's conv3d
   forward / dgrad / wgrad, the plans' sort / searchsorted / cumsum and
   the reductions (BatchNorm and GroupNorm statistics among them);
19. determinism: two 3-step hybrid runs from one seed and batch give
   bitwise-equal losses, parameters and running statistics;
20. card against CPU: one hybrid step at (2, 20 000) from phase 11's
   checkpoint and the same draws on the CPU (plain versions) and on the
   card through the kernels.  The CPU's fp32 step records its choices at
   the kinks (ReLU masks, amax elements, voxel coordinates:
   pcfm_torch/kinks.py) and the pinned steps replay them: the card's bf16
   step (the main path) within HYB_GRAD_REL_TOL_BF16 of the CPU's bf16
   step and HYB_GRAD_REL_TOL of its fp32 step, and the card's
   fp32 step with the plain trunk (the voxel kernels its only kernels)
   within HYB_GRAD_REL_TOL_FP32 of the CPU's fp32 step, every gradient's
   error over its max; each bound's control (the bf16 step against the
   CPU's fp32; the unpinned bf16 step; the fp32 step with TF32) must
   exceed it; every card step's loss and grad norm within
   HYB_LOSS_REL_TOL.  Printed: the unpinned card steps' flips against
   the CPU's choices, and the CPU's bf16 step with the prior moved by one
   bf16 ulp;
21. mlp distillation: phase 3's checkpoint on the synthetic set with
   guidance 0.25 (random weights from the seed) through the distill CLI
   (``--device cuda``, 2 phases x 4 steps: Heun x 50 -> Euler x 12),
   guided and with ``--guidance_scale 0``: exact launches a step
   (``distill_step_launches``: FiLM 5 x (4 teacher + 1 student) forward,
   5 backward), finite losses, the saved config (euler x 12, guidance 0
   when baked in); the sampling CLI on the distilled run (5 x 12 FiLM
   launches, 8 finite clouds), its Euler x 12 ms/shape beside phase 4's
   Heun x 50; the distill step's ms/step, peak memory, idle share and the
   kernels' share of device time from one torch.profiler run;
22. the same for the hybrid (phase 11's checkpoint, its running
   statistics moved; gather and scatter 6 x 5 forward + 6 backward a
   step), and the distilled checkpoint's live and EMA statistics equal to
   the input's EMA statistics;
23. one distill step at (2, 20 000) from phases 21 and 22's inputs on the
   CPU (plain versions, fp32 and bf16) and on the card (kernels), the
   hybrid's legs pinned at the CPU's kinks as phase 20's: each gradient's
   error over its max within its bound, each bound's control beyond it;
   full-width mlp train steps with ``fm_coupling sliced_ot``, with
   ``lambda_adv 0.1`` and, at the largest point count the dense EMD fits,
   ``lambda_emd 0.1`` (exact FiLM launches, finite losses, peak memory);
   and one distill step at ``pf_width 1024`` with the kernel trunk (the
   backward's wide path) at WIDE_DISTILL_POINTS on the card and the CPU,
   with the mlp's legs: the fp32 leg within
   WIDE_DISTILL_GRAD_REL_TOL_FP32 and its control beyond it, the bf16 leg
   within phase 23's bound;
24. data and point-axis parallel steps: two ranks as processes on the one
   card (NCCL takes one rank a device), joined over a gloo group the
   phase makes, which must take CUDA tensors in all-reduce, all-gather
   and broadcast; for the mlp and the hybrid at full width (8 x 20 000
   RGB points globally) in two layouts, dp = 2 (4 x 20 000 a rank) and
   sp = 2 (8 x 10 000 a rank): one fp32 step through the kernels from the
   seed's weights and the global batch's draws against the one-rank step
   (rank 0 alone): the loss within PAR_LOSS_REL_TOL, every gradient after
   the all-reduce within its bound of its max, the control (the rank's
   gradient before the all-reduce) beyond it, the kinks on another side
   counted; each rank's launches (as one device's a step); after
   PAR_STEPS steps every rank's parameters and buffers bitwise equal; the
   bf16 train step's ms/step of each layout (two ranks sharing one card:
   not a scaling number) beside the one-rank step's;
25. the training CLI through torchrun's variables at WORLD_SIZE = 1 over
   NCCL (the hybrid at full width, PAR_TRAIN_COUNT clouds,
   ``--async_save``), its resume, and a two-rank dp = 2 CLI run over
   gloo on the one card: one checkpoint and one validation dump, from
   rank 0;
26. the FiLM-block kernels at the widths of their wide paths (forward
   C > 1024: statistics and a packed silu(f), then a streamed product;
   backward C > 512: packed dy, then a thread-block cluster a 64-row tile
   that keeps dp on chip, 9 / 9 / 10 / 10 / 11 CTAs a cluster at C =
   2176 / 2304 / 2432 / 2560 / 2688, where the rows pass runs in chunks
   beside the dW pass) against their plain versions: (8, 20 000, C) bf16
   for C = 640, 768, 1024, 1536, 2048, 2176, 2304, 2432, 2560, 2688 and
   the edges (N = 1, 129, 300; fp32 inputs), within KERNEL_TOL /
   GRAD_REL_TOL, bitwise equal across two launches, fp32 with W = 0
   within FP32_DY_TOL; CUDA-event times of each kernel, its plain version
   and torch.matmul of each product alone at C = 640, 1024, 2048, 2304,
   2560, 2688 beside the bounds, each kernel's parts profiled (above
   2048 also the time the cluster kernel and the dW pass run at once),
   the backward's plan, workspace bytes and the clusters the card holds
   at once (at every C above 2048); the forward
   above 2048 (its statistics kernel's wider instantiation), to each
   dtype's limit (MAX_C_BF16 = 4608, MAX_C_F32 = 4352, the JAX kernel's):
   at (8, 20 000, C) for C = 2176, 2560, 3200, 4096, 4608 bf16 and 2176,
   4352 fp32 and the edges (N = 1, 129, 300 at 4608 bf16 and 4352 fp32)
   within KERNEL_TOL, bitwise equal across two launches, timed at C =
   2560 and 4608 bf16 and 4352 fp32 beside the bound and torch.matmul of
   the product alone, its parts profiled; the forward stopped at 4736
   (bf16) and 4480 (fp32), the backward at 2816 (MAX_C_BWD = 2688, the
   JAX kernel's limit in both dtypes), each by its wrappers' named
   limit;
27. the mlp at ``pf_width 1024`` with the kernel trunk at bench.py's
   workload: the training CLI (8 steps, 5 forward and 5 backward launches
   a step, validation, a checkpoint, a rerun with nothing to do), the train
   step's ms/step with both trunks and the kernels' share, the sampling
   CLI (Heun x 50, 500 launches) and ms/shape with both trunks, the
   distill step (25 forward + 5 backward launches a step) and its ms/step;
   then ``pf_width 2048`` (both wide paths): train steps with exact
   launches, finite losses and peak memory; then ``pf_width 2688``
   (MAX_C_BWD, the backward's widest): the training CLI as at 1024, the
   sampling CLI on its checkpoint (Heun x 50, exactly 500 forward and no
   backward launches, 8 finite clouds), train steps as at 2048, and one
   train step at WIDE_DISTILL_POINTS on the card against the CPU (bf16
   and fp32, phase 23's mlp legs and bounds); then ``pf_width 4608``
   (MAX_C_BF16, the forward's widest; a run from freshly initialised
   weights, since the backward stops at 2688): the sampling CLI (Heun x
   50, exactly 500 forward launches, finite clouds), ms/shape and peak
   memory (``--only wide`` also runs phase 23's wide distill step);
28. the PointNet++ modules (plain PyTorch): set abstraction from 8 x 20 000
   points to 1024 centers, then feature propagation back, on the card and
   on the CPU with the same weights and lattice coordinates, within
   PN_REL_TOL;
29. reference checkpoints imported into port runs: a full-width mlp
   (512/6/256, the synthetic set's args) and hybrid (the Config's
   ContextNet) in the reference's format with random weights from the seed
   and its variants (``module.``-prefixed state_dicts, the legacy key
   ``model``, float-only EMA shadows, args without ``ctx_dtype`` and with
   a reference-only key, an empty optimizer state) through ``python -m
   pcfm_torch.interop`` on the card and with ``--device cpu``: the runs'
   state_dicts equal the files' bit for bit after unwrapping and each
   other's, the hybrid's island fp32, the counters carried; the sampling
   CLI on both runs (Heun x 50 at 8 x 20 000, kernel trunk: exact launches,
   finite clouds, ms/shape), the eval CLI on the mlp's (one batch: exact
   launches, finite metrics), and one fp32 plain-trunk velocity of each
   imported model, card against CPU, within INTEROP_VEL_REL_TOL (the card
   at the CPU's kinks);
30. model FLOPs (pcfm_torch.utils.flops): the mlp and hybrid train steps at
   8 x 20 000 bf16 and one velocity evaluation of each, counted with the
   kernels (their formula hooks) and with the plain trunk and plain voxel
   ops (the counter sees their products), equal exactly; MFU against the
   dense bf16 peak beside each kernel step's host-clock and device-busy
   ms;
31. the voxel kernels at channel counts that are not multiples of 8 (C =
   36, 100 and 37 at R = 32, 8 clouds x 20 000 points, K = 1 and 8, bf16
   and fp32) against their plain versions as phase 10 holds them, bitwise
   equal across two launches, timed; then the hybrid with
   ``ctx_stage_channels 100 200 200`` (its R = 32 stage at C = 100) through
   the sampling CLI (Heun x 50 at 8 x 20 000, launches as phase 11's, 8
   finite clouds) and two bf16 train steps at 8 x 20 000 with exact
   launches a step (HYB_STEP_LAUNCHES) and finite losses.
32. the input pipeline (the card's machine has no h5py, so the packer
   and the H5 dataset are held by the CPU tests alone): a pose tree as
   make_dataset.py lays it out (16 models x 4 poses of 30 000 RGB points,
   ``angles.json``, ASCII and binary PLYs) read back through the port's
   ``load_ply`` with its native parser built and required (one native
   parse an ASCII cloud, each equal to the numpy path's bit for bit);
   the training CLI at bench.py's width through the worker-process
   backend (``--loader_backend grain --num_workers 8``, synthetic, 8
   steps, validation, a checkpoint; 5 forward and 5 backward launches a
   step, finite losses, a rerun with nothing to do); its first 6 batches
   equal the thread backend's bit for bit; 3-step CLI runs on each backend
   from one seed with bitwise-equal losses, weights and optimizer state;
   printed, not gated: ms a batch at 8 x 20 000 of the thread backend at
   0 / 8 workers and the process backend at 8 / 16 (30 batches after
   warm-up, from 96 clouds of 30 000 points) and the CLI's ms a step with
   each backend beside phase 8's train step.
33. learning: the mlp (400 steps) and the hybrid (100 steps) at bench.py's
   width (8 x 20 000 RGB points, latent 128), each trained twice side by
   side from the same weights on the same device-resident batches
   (LEARN_CLOUDS synthetic clouds) with the same draws each step: in bf16
   with the kernel trunk and in fp32 with the plain trunk (TF32 off);
   exact launches (the kernel run's FiLM blocks; the voxel kernels in
   both hybrid runs); every loss finite; each run's mean over its last
   LEARN_LATE_SHARE of steps below the mean of its first LEARN_EARLY
   steps; bf16 against fp32 on those late means within LEARN_REL_TOL
   (loss_point 10 %, loss_latent 20 %); both curves' summaries printed.

The CPU legs of phases 20 and 23 (the plain versions' steps that the
card's are held against) run in a child process, ``--cpu_legs``, beside
the card's phases after phases 11 and 22; phase 20's card legs wait for
it in place, phase 23's run after phase 31.  ``[time]`` lines give the
run's time after each group of phases.

A profile whose session holds kernel records for fewer than
PROFILE_RECORDED of its kernel launches is taken again in new sessions
(PROFILE_TRAILS_S), and fails its phase if every one is short.  The line
before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(ROOT, "runs", "chip_smoke")
SEED = 0
DEVICE = "cuda"
B, N, C = 8, 20000, 512
FILM_BLOCKS = 5                      # pf_depth 6 -> 5 FiLM trunk blocks
NFE = 100                            # Heun x 50
KERNEL_TOL = 6e-2                    # atol = rtol, as the JAX bf16 test
E2E_REL_TOL = 5e-2
# backward: each gradient's max abs error over its max |plain| value; the
# kernel's products are bf16 x bf16 -> fp32 summed over up to 320k rows in
# another order than the fp32 plain version
GRAD_REL_TOL = 2e-2
# fp32 inputs with W = 0, so that df = dy: the gradients other than dW
# (a bf16 product) take dy in fp32; dy rounded to bf16 would miss by ~1e-3
FP32_DY_TOL = 1e-4
TRAIN_SAMPLE_STEPS = 4               # validation sampler of the CLI phase
STEPS_PER_EPOCH = 293                # bench.py's epoch at batch 8
TIMED_STEPS = 10                     # a timed run of train steps
WARMUP_STEPS = 3
# a profile whose session holds kernel records for fewer than this share
# of its kernel launches (a whole Heun x 50 run's 112 409 launches held
# 112 401) is taken again in new sessions, each held open its trail of
# PROFILE_TRAILS_S after the kernels.  Once a process has run a minute,
# sessions lose most of a short session's records (PERF.md §6).  The
# first retry follows at once: in scripts/torch_profile_probe.py's runs
# on the card late sessions alternate short and whole, whatever their
# trail.  The later ones hold 5 s and more: in those runs only a 5 s trail
# kept every record at every point of the process, and in one whole run a
# profile of 6 launches kept 0, 0 and then 4 records in its three sessions
# (0, 0 and 5 s), so two longer sessions follow.  (A 5 s trail as the only
# retry took 67 short profiles of a whole run, 335 s of its 1005 s.)
PROFILE_RECORDED = 0.99
PROFILE_TRAILS_S = (0.0, 0.0, 5.0, 5.0, 10.0)
HYB_DIR = os.path.join(RUN_DIR, "hybrid")
# the hybrid's ContextNet stages (Config defaults): (resolution, channels)
VOXEL_STAGES = ((32, 128), (16, 256), (8, 256))
PVCONVS = 6                          # ctx_stage_blocks 2 + 2 + 2
# gather / scatter vs plain (fp32 math): both sum the same fp32 products of
# the same inputs, in another order (the plain scatter's index_add_ uses
# atomics on the card, in an order that changes from run to run), so the
# error of an output is bounded relative to the sum of the magnitudes of
# its products (up to ~10^4 of them for a central voxel at R = 8):
# |kernel - plain| <= VOXEL_TOL * sum |w * x| + VOXEL_ATOL
VOXEL_TOL = 1e-5
VOXEL_ATOL = 1e-6
# the card's bf16 island and head against the CPU's fp32 plain path, for
# one velocity evaluation: max abs error over max |v|
HYB_E2E_REL_TOL = 5e-2
HYB_E2E_POINTS = (2, 20000)
# one hybrid train step at HYB_E2E_POINTS, card (kernels) against the CPU
# (plain versions): the loss and grad norm of every card step, pinned or not
HYB_LOSS_REL_TOL = 5e-2
# and each gradient's error over the CPU value's max, both steps taking the
# CPU fp32 step's choices at the kinks (ReLU masks, amax elements, voxel
# coordinates: pcfm_torch.kinks).  Unpinned, a ReLU input within rounding
# distance of 0 takes another side on the card and moves whole channels of
# the pyramid's gradients.  Each bound lies between the sound run's reading
# and its control's, which must exceed it (PERF.md, the hybrid train
# step's findings; on an H100):
# the main path's bf16 step against the CPU's bf16 step: the same roundings
# in other orders of summation (7.05e-2); control: the same card step
# against the CPU's fp32 step (0.221)
HYB_GRAD_REL_TOL_BF16 = 0.12
# the bf16 step against the CPU's fp32 step: bf16 rounding of the
# pyramid's activations and cotangents (0.221); control: the unpinned bf16
# step, whose choices differ at 1.5 % of the ReLU inputs (1.53)
HYB_GRAD_REL_TOL = 0.4
# the fp32 step with the plain trunk (the voxel kernels its only kernels)
# against the CPU's fp32 step (7.41e-5); control: the same card step with
# TF32 convolutions and GEMMs, 2^-11 rounding of the products' operands
# (1.87e-2)
HYB_GRAD_REL_TOL_FP32 = 1e-3
# a hybrid train step's launches: each of the PVCONVS PVConvs one scatter
# (K = 1) and one gather (K = 8) forward, and their transposes backward
# (K = 1 gather, K = 8 scatter); the head's FILM_BLOCKS blocks forward and
# backward
HYB_STEP_LAUNCHES = {"film_block": FILM_BLOCKS, "film_block_bwd": FILM_BLOCKS,
                     "voxel_gather": 2 * PVCONVS,
                     "voxel_scatter": 2 * PVCONVS}
# distillation (phases 21-23): the distill CLI's phases and steps a phase;
# the teacher's Heun rollout evaluates the field 4 times a step (one 2B
# call each under CFG), the student once forward and once backward; Heun x
# 50 halves twice to Euler x 12
DISTILL_PHASES, DISTILL_STEPS_PER_PHASE = 2, 4
DISTILL_TEACHER_EVALS = 4
DISTILL_EULER_STEPS = 12
DISTILL_GUIDANCE = 0.25
# one distill step at HYB_E2E_POINTS, card (bf16, kernels) against the CPU
# (plain versions), each gradient's error over the CPU value's max; the
# hybrid's legs take the CPU fp32 step's choices at the kinks, as phase
# 20's.  The loss within DISTILL_LOSS_REL_TOL in every card leg.  Each
# bound lies between the sound run's readings and its control's, read at
# --seed 0, 1 and 2 (PERF.md, the distillation findings; on an H100):
DISTILL_LOSS_REL_TOL = 5e-2
# the mlp's bf16 step against the CPU's bf16 step: the same roundings in
# other orders of summation, the kernels' bf16 products (8.26e-3 to
# 1.47e-2); control: the same card step against the CPU's fp32 step
# (2.37e-2 to 3.07e-2)
MLP_DISTILL_GRAD_REL_TOL_BF16 = 1.85e-2
# the mlp's fp32 step (fp32 inputs; the kernels' products in bf16) against
# the CPU's fp32 step (4.21e-3 to 7.70e-3); control: the bf16 step against
# it
MLP_DISTILL_GRAD_REL_TOL_FP32 = 1.5e-2
# the dense EMD's step peaks at ~6.2 (B, N, N) fp32 matrices (approxmatch's
# distances, match, weights and products, the distances' temporaries;
# 43.418 GiB at 8 x 15 360 on an H100): the point count is sized for 6.5
EMD_DENSE_MATRICES = 6.5
# chamfer kernel vs plain: the same fp32 difference form, the kernel's
# fused multiply-adds aside: |d_kernel - d_plain| <= CHAMFER_REL_TOL *
# max(d) + CHAMFER_ATOL; indices equal unless the kernel's neighbour is
# within that of the best (a near tie)
CHAMFER_REL_TOL = 1e-6
CHAMFER_ATOL = 1e-9
SUITE_CLOUDS, SUITE_POINTS = 32, 2048
EVAL_BATCHES = 2
# cdist's launch grid takes at most 2^31 - 1 (cloud x row x column)
# entries a call, so the yardstick runs in calls of at most this many
CDIST_MAX_ENTRIES = 2 ** 31 - 1
# phase 31: the voxel kernels at channel counts that are not multiples of
# 8, at the hybrid's R = 32 stage, and the hybrid whose first stage has
# C = 100 (the Config's [128, 256, 256] otherwise)
ODD_CS = (36, 100, 37)
ODD_STAGE_CHANNELS = (100, 200, 200)
HYB_ODD_DIR = os.path.join(RUN_DIR, "hybrid_odd")
# the FiLM kernels' wide paths (phases 26-27): the widths held against the
# plain versions (above 2048 the backward's non-portable clusters of 9 /
# 10 / 11 CTAs, each with its edges), the widths timed, the mlp's
# point-flow width on the wide path (forward one-kernel, backward wide),
# and the (clouds, points) of its distill step and of the pf_width
# MAX_C_BWD train step against the CPU
WIDE_CS = (640, 768, 1024, 1536, 2048, 2176, 2304, 2432, 2560, 2688)
WIDE_EDGE_CS = (640, 1536, 2048, 2176, 2304, 2432, 2560, 2688)
WIDE_F32_CS = (640, 2048, 2176, 2304, 2432, 2560, 2688)
WIDE_TIMED_CS = (640, 1024, 2048, 2304, 2560, 2688)
WIDE_PF_WIDTH = 1024
# the forward alone above 2048 (phase 26), up to each dtype's limit
# (MAX_C_BF16, MAX_C_F32): the widths held against the plain version at
# (8, 20 000, C) (a last chunk of 128 columns at 2176 and 3200), the
# widths and dtypes timed;
# phase 27 samples the mlp at MAX_C_BF16
WIDE_FWD_CS = (2176, 2560, 3200, 4096, 4608)
WIDE_FWD_F32_CS = (2176, 4352)
WIDE_FWD_TIMED = ((2560, "bfloat16"), (4608, "bfloat16"),
                  (4352, "float32"))
WIDE_DISTILL_POINTS = (2, 256)
# its bound on the card's fp32 step against the CPU's fp32 step, between
# the sound readings (4.72e-3 to 6.37e-3 at --seed 0, 1, 2: the kernels'
# bf16 products) and the control's (the bf16 step against the CPU's fp32
# step, 1.18e-2 to 1.77e-2); on an H100, PERF.md §6.  At 256 points
# the bf16 step's difference from the CPU's bf16 step (7.6e-3 to 1.36e-2)
# reaches its control's, so that leg keeps phase 23's bound with its
# control printed, not required
WIDE_DISTILL_GRAD_REL_TOL_FP32 = 9e-3
# phase 32: the input pipeline.  PLY poses as make_dataset.py lays them
# out (DATA_MODELS x DATA_POSES clouds of DATA_POINTS RGB points); the
# training CLI's worker processes; the batches held equal across the
# backends; the loaders timed over LOADER_CLOUDS such clouds
DATA_MODELS, DATA_POSES, DATA_POINTS = 16, 4, 30000
DATA_WORKERS = 8
DATA_SAME_BATCHES = 6
LOADER_CLOUDS = 96
LOADER_TIMED_BATCHES, LOADER_WARMUP_BATCHES = 30, 6
# phase 33: learning over many steps.  Train steps a backbone, the
# device-resident synthetic clouds the batches are gathered from, the LR
# warmup, the late window (a share of the steps) and the early one (steps),
# and the bf16 run's late means against the fp32 run's
LEARN_STEPS = {"mlp": 400, "hybrid": 100}
LEARN_CLOUDS = 64
LEARN_WARMUP = 20
LEARN_LATE_SHARE, LEARN_EARLY = 0.2, 10
LEARN_REL_TOL = {"loss_point": 0.10, "loss_latent": 0.20}
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 tensor-core
# and fp32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def sh(*cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(torch, fn, calls: int = 10) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    calls queued behind a sleep kernel, so that the card runs them back
    to back with no host time between them (the host must have queued
    them all before the sleep ends, else a longer sleep is tried); the
    median of 3 such runs."""
    times, cycles = [], 1 << 21             # ~1 ms at the card's clock
    while len(times) < 3:
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        e2.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < 0.5 * e0.elapsed_time(e1):
            times.append(e1.elapsed_time(e2) / calls)
        elif cycles < 1 << 31:
            cycles *= 4
        else:
            raise RuntimeError(f"queued_ms: the host took {host_ms:.3f} ms "
                               f"to queue {calls} calls, longer than a "
                               f"{e0.elapsed_time(e1):.1f} ms sleep")
    return statistics.median(times)


def ply_vertices(path: str) -> tuple:
    """(vertex count, property names) from an ASCII PLY header, checked
    against the number of data rows."""
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    count = next(int(x.split()[2]) for x in lines[:end]
                 if x.startswith("element vertex"))
    props = [x.split()[-1] for x in lines[:end] if x.startswith("property")]
    if len(lines) - end - 1 != count:
        raise RuntimeError(f"{path}: {len(lines) - end - 1} rows, header "
                           f"says {count}")
    return count, tuple(props)


def bench_cfg(**kw):
    from pcfm_torch.config import Config
    base = dict(pf_backbone="mlp", latent_dim=128, has_rgb=True, cond_dim=1,
                pointflow_rgb=True, use_rgb_in_latent=True, amp=True,
                use_bf16=True, tr_max_sample_points=N, batch_size=B,
                warmup_steps=0, fused_trunk="on", sampler="heun",
                sample_steps=50)
    base.update(kw)
    return Config(**base)


def film_inputs(torch, g, bsz: int, n: int, c: int, dtype) -> tuple:
    """The forward's arguments at (bsz, n, c), h / gamma / beta in dtype."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=DEVICE, generator=g) * scale
    h = rnd(bsz, n, c, scale=0.7).to(dtype)
    s, t = 1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1)
    gamma = rnd(bsz, c, scale=0.2).to(dtype)
    beta = rnd(bsz, c, scale=0.2).to(dtype)
    w, b = rnd(c, c, scale=c ** -0.5), rnd(c, scale=0.1)
    return h, s, t, gamma, beta, w, b


def check_forward(fb, torch, args) -> float:
    """The forward kernel against its plain version (atol = rtol =
    KERNEL_TOL on y; mean within 1e-5, rstd within 1e-4 relative), two
    launches bitwise equal. Returns the max abs error of y."""
    h = args[0]
    tag = f"{tuple(h.shape)} {str(h.dtype).replace('torch.', '')}"
    y, mean, rstd = fb.film_block_forward(*args)
    again = fb.film_block_forward(*args)
    torch.cuda.synchronize()
    y_ref, mean_ref, rstd_ref = fb.film_block_reference_forward(*args)
    err = (y.float() - y_ref.float()).abs()
    bound = KERNEL_TOL + KERNEL_TOL * y_ref.float().abs()
    ok = bool((err <= bound).all()) and bool(torch.isfinite(y).all())
    mean_err = (mean - mean_ref).abs().max().item()
    rstd_rel = ((rstd - rstd_ref).abs() / rstd_ref).max().item()
    same = all(torch.equal(a, b) for a, b in zip((y, mean, rstd), again))
    print(f"[kernel] film_block {tag}: max abs err {err.max().item():.6g}, "
          f"max err/bound {(err / bound).max().item():.4g} "
          f"(atol=rtol={KERNEL_TOL}); mean err {mean_err:.3g}, rstd rel "
          f"err {rstd_rel:.3g}; two launches bitwise equal: {same}")
    if not ok or mean_err > 1e-5 or rstd_rel > 1e-4 or not same:
        raise RuntimeError(f"film_block kernel disagrees with its plain "
                           f"version at {tag}")
    return err.max().item()


def film_w_l2_bytes(bsz: int, n: int, c: int) -> tuple:
    """W bytes read from L2 per forward call: (this kernel: every block of
    128 rows (64 for C > 512) reads the packed bf16 W, plus the pack's
    fp32 read; the earlier wmma kernel: every 64-row block read the fp32
    W)."""
    rows = 128 if c <= 512 else 64
    new = -(-n // rows) * bsz * c * c * 2 + c * c * 4
    return new, -(-n // 64) * bsz * c * c * 4


def kernel_vs_plain(fb, torch):
    """Phase 2. Edge cases (N = 1, 129 and the main N at C = 512, bf16 and
    fp32, B = 8 and 16; C = 1024), then CUDA-event times at the main
    shapes: the kernel, its plain version and one torch.matmul of the
    same (B*N, C) x (C, C) bf16 product alone (a yardstick of the product
    part; the port never calls it). Returns ({B: (kernel ms, plain ms,
    gemm-only ms)}, max abs err over every case)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = 0.0
    cases = [(bsz, n, C, dtype) for dtype in (torch.bfloat16, torch.float32)
             for bsz in (B, 2 * B) for n in (1, 129, N)]
    cases += [(2, 300, 1024, torch.bfloat16), (2, 300, 1024, torch.float32)]
    for bsz, n, c, dtype in cases:
        worst = max(worst, check_forward(
            fb, torch, film_inputs(torch, g, bsz, n, c, dtype)))
        torch.cuda.empty_cache()
    out = {}
    for bsz in (B, 2 * B):
        args = film_inputs(torch, g, bsz, N, C, torch.bfloat16)
        a2d = args[0].reshape(-1, C)
        wt = args[5].T.contiguous().bfloat16()
        # plain, kernel, kernel, plain: compare inside one call, in turns
        t = timed_turns({"kernel": lambda: fb.film_block(*args),
                         "plain": lambda: fb.film_block_reference(*args),
                         "gemm": lambda: torch.matmul(a2d, wt)}, rounds=3)
        l2_new, l2_old = film_w_l2_bytes(bsz, N, C)
        print(f"[kernel] film_block ({bsz}, {N}, {C}): kernel "
              f"{t['kernel']:.4f} ms, plain fp32 {t['plain']:.4f} ms, "
              f"torch.matmul ({bsz * N}, {C}) x ({C}, {C}) bf16 alone "
              f"{t['gemm']:.4f} ms (medians of 6 x 10 calls in turns); W "
              f"read from L2 per call, reckoned from the grid (not "
              f"measured): {l2_new / 1e9:.3f} GB (a 64-row fp32-W wmma "
              f"kernel: {l2_old / 1e9:.3f} GB)")
        out[bsz] = (t["kernel"], t["plain"], t["gemm"])
        del args, a2d
        torch.cuda.empty_cache()
    return out, worst


def check_spills(log: str) -> None:
    """Print ptxas's registers and spills for each kernel of the build log
    and fail if a FiLM-block, voxel or chamfer kernel spills."""
    name, spilled = "?", []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            # the kernel and its template arguments, without the mangled
            # anonymous namespace (one line for each instantiation)
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                           "", name)
            print(f"[build] {short[:80]}: "
                  f"{line.split(':', 1)[-1].strip()}")
            if any(k in name for k in ("film_block", "voxel", "chamfer")) \
                    and "spill" in line and any(
                    int(x) for x in re.findall(r"(\d+) bytes spill", line)):
                spilled.append(name)
    if spilled:
        raise RuntimeError(f"ptxas spills in {sorted(set(spilled))}")


def backward_inputs(fb, torch, g, bsz: int, n: int, c: int, dtype) -> tuple:
    """The backward's arguments at (bsz, n, c): dy, h, s, t, gamma, beta,
    w, and the forward kernel's mean and rstd."""
    h, s, t, gamma, beta, w, b = film_inputs(torch, g, bsz, n, c, dtype)
    dy = (torch.randn(bsz, n, c, device=DEVICE, generator=g) * 1e-3).to(dtype)
    _, mean, rstd = fb.film_block_forward(h, s, t, gamma, beta, w, b)
    return dy, h, s, t, gamma, beta, w, mean, rstd


def check_backward(fb, torch, args) -> tuple:
    """The backward kernel against its plain version: each of the seven
    gradients within GRAD_REL_TOL of its max |plain|, finite, of the plain
    version's dtype and shape, and two launches bitwise equal. Returns
    (max abs err, max err over the gradient's max)."""
    names = ("dh", "ds", "dt", "dgamma", "dbeta", "dW", "db")
    h = args[1]
    tag = f"{tuple(h.shape)} {str(h.dtype).replace('torch.', '')}"
    got = fb.film_block_backward(*args)
    again = fb.film_block_backward(*args)
    torch.cuda.synchronize()
    want = fb.film_block_reference_backward(*args)
    worst, worst_abs, errs = 0.0, 0.0, []
    for name, k, k2, p in zip(names, got, again, want):
        if k.shape != p.shape or k.dtype != p.dtype:
            raise RuntimeError(f"backward {name} at {tag}: {k.shape} "
                               f"{k.dtype}, plain {p.shape} {p.dtype}")
        if not torch.equal(k, k2):
            raise RuntimeError(f"backward {name} at {tag} differs between "
                               f"two launches on the same inputs")
        err = (k.float() - p.float()).abs().max().item()
        rel = err / max(p.float().abs().max().item(), 1e-30)
        if not torch.isfinite(k).all() or rel > GRAD_REL_TOL:
            raise RuntimeError(f"backward kernel {name} disagrees with its "
                               f"plain version at {tag}: {err:.4g}, "
                               f"{rel:.4g} of its max")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
        errs.append(f"{name} {rel:.3g}")
    print(f"[bwd] {tag}: err / max |plain| {', '.join(errs)} (bound "
          f"{GRAD_REL_TOL}); two launches bitwise equal")
    return worst_abs, worst


def check_backward_fp32_dy(fb, torch, g,
                           shapes=((B, 1000, C), (2, 300, 384))) -> float:
    """fp32 inputs with W = 0, so that df = dy: dh, ds, dt, dgamma, dbeta
    and db within FP32_DY_TOL of each one's max |plain|, at each (B, N, C)
    of ``shapes``. Returns the worst of those errors over the max."""
    worst = 0.0
    for bsz, n, c in shapes:
        args = list(backward_inputs(fb, torch, g, bsz, n, c, torch.float32))
        args[6] = torch.zeros_like(args[6])
        got = fb.film_block_backward(*args)
        want = fb.film_block_reference_backward(*args)
        errs = []
        for name, k, p in zip(("dh", "ds", "dt", "dgamma", "dbeta", "dW",
                               "db"), got, want):
            if name == "dW":
                continue
            rel = (k - p).abs().max().item() / max(
                p.abs().max().item(), 1e-30)
            if not rel <= FP32_DY_TOL:
                raise RuntimeError(f"backward kernel {name} at ({bsz}, {n}, "
                                   f"{c}) fp32, W = 0: {rel:.4g} of its max "
                                   f"(bound {FP32_DY_TOL}): dy not in fp32")
            worst = max(worst, rel)
            errs.append(f"{name} {rel:.3g}")
        print(f"[bwd] ({bsz}, {n}, {c}) fp32, W = 0 (df = dy): err / max "
              f"|plain| {', '.join(errs)} (bound {FP32_DY_TOL})")
    return worst


def film_bwd_w_l2_bytes(bsz: int, n: int, c: int) -> int:
    """W bytes read from L2 per backward call: every 64-row rows-pass
    block reads the packed bf16 Wᵀ, and the pack reads the fp32 W."""
    return -(-n // 64) * bsz * c * c * 2 + c * c * 4


def backward_vs_plain(fb, torch):
    """Phase 6: the backward kernel against its plain version (fp32 math)
    at the training path's shapes (8 | 16, 20 000, 512) bf16 and the edges
    (N = 1, 129, 300; C = 128, 256, 384; fp32 inputs); then CUDA-event
    times of the kernel, the plain version and one torch.matmul of each
    product alone (dy @ W and dyᵀ @ p in bf16: yardsticks, not used by the
    port), W's L2 bytes, and one profiled run for the rows pass's and the
    dW pass's device times. Returns {B: row} and the worst errors."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    worst, worst_abs = 0.0, 0.0
    cases = [(B, n, C, torch.bfloat16) for n in (1, 129, 300)]
    cases += [(B, 300, c, torch.bfloat16) for c in (128, 256, 384)]
    cases += [(B, n, c, torch.float32) for n, c in ((129, 512), (300, 128),
                                                    (N, C))]
    cases += [(bsz, N, C, torch.bfloat16) for bsz in (B, 2 * B)]
    for bsz, n, c, dtype in cases:
        e_abs, e_rel = check_backward(
            fb, torch, backward_inputs(fb, torch, g, bsz, n, c, dtype))
        worst, worst_abs = max(worst, e_rel), max(worst_abs, e_abs)
        torch.cuda.empty_cache()
    out = {"max_abs_err": worst_abs, "max_err_over_grad_max": worst,
           "fp32_dy_err_over_grad_max": check_backward_fp32_dy(fb, torch, g)}
    for bsz in (B, 2 * B):
        args = backward_inputs(fb, torch, g, bsz, N, C, torch.bfloat16)
        dy2d = args[0].reshape(-1, C)
        w16 = args[6].bfloat16()
        p2d = torch.nn.functional.silu(args[1].float()).bfloat16() \
            .reshape(-1, C)
        t = timed_turns({
            "kernel": lambda: fb.film_block_backward(*args),
            "plain": lambda: fb.film_block_reference_backward(*args),
            "gemm_dp": lambda: torch.matmul(dy2d, w16),
            "gemm_dw": lambda: torch.matmul(dy2d.T, p2d)},
            rounds=2, reps={"kernel": 10, "plain": 3, "gemm_dp": 10,
                            "gemm_dw": 10})
        prof = profile_kernels(
            torch, lambda: fb.film_block_backward(*args), 5,
            {"rows": ("film_block_bwd_rows",),
             "dw": ("film_block_bwd_dw",),
             "pack": ("film_block_bwd_pack",),
             "reduce": ("film_block_bwd_sum", "film_block_bwd_finalize")},
            os.path.join(RUN_DIR, f"backward_b{bsz}_trace.json"))
        l2 = film_bwd_w_l2_bytes(bsz, N, C)
        print(f"[bwd] film_block backward ({bsz}, {N}, {C}) bf16: kernel "
              f"{t['kernel']:.4f} ms, plain fp32 {t['plain']:.4f} ms; "
              f"torch.matmul alone (bf16, cuBLAS): dy @ W ({bsz * N}, {C}) "
              f"x ({C}, {C}) {t['gemm_dp']:.4f} ms, dyᵀ @ p ({C}, "
              f"{bsz * N}) x ({bsz * N}, {C}) {t['gemm_dw']:.4f} ms "
              f"(medians of 4 timings in turns); W read from L2 per call, "
              f"reckoned from the grid (not measured): {l2 / 1e9:.3f} GB")
        print(f"[bwd] profiled, 5 calls: rows pass {prof['rows'][0]:.4f} ms"
              f", dW pass {prof['dw'][0]:.4f} ms, Wᵀ pack "
              f"{prof['pack'][0]:.4f} ms, reductions {prof['reduce'][0]:.4f}"
              f" ms a call (device busy {prof['busy_ms']:.4f} ms a call; "
              f"read beside the CUDA-event time)")
        out[bsz] = {"ms": t["kernel"], "plain_ms": t["plain"],
                    "gemm_dp_ms": t["gemm_dp"], "gemm_dw_ms": t["gemm_dw"],
                    "rows_ms": prof["rows"][0], "dw_ms": prof["dw"][0]}
        del args, dy2d, p2d, w16
        torch.cuda.empty_cache()
    return out


def main_path(fb, torch, np):
    """Phase 3: the sampling CLI on a full-width checkpoint."""
    from pcfm_torch.sample import cli
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle

    shutil.rmtree(RUN_DIR, ignore_errors=True)
    bundle = ModelBundle(bench_cfg(), DEVICE,
                         torch.Generator().manual_seed(SEED))
    path = checkpoint.save(RUN_DIR, 1, bundle)
    print(f"[main] wrote {os.path.relpath(path, ROOT)}")
    del bundle

    launches = {}
    for name, extra in (("heun50", []),
                        ("heun50_cfg0.25", ["--guidance_scale", "0.25"])):
        save_dir = os.path.join(RUN_DIR, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb.launches = fb.bwd_launches = 0
        t0 = time.perf_counter()
        x = cli.main(["--out_dir", RUN_DIR, "--save_dir", save_dir,
                      "--num_samples", str(B), "--n_points", str(N),
                      "--seed", str(SEED), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = fb.launches
        plys = sorted(os.listdir(save_dir))
        headers = {ply_vertices(os.path.join(save_dir, p)) for p in plys}
        print(f"[main] {name}: {launches[name]} film_block launches, "
              f"{len(plys)} PLYs, clouds {x.shape}, finite "
              f"{bool(np.isfinite(x).all())}, |x| max "
              f"{np.abs(x).max():.4g}, CLI wall {wall:.3f} s incl. load "
              f"and PLY writes, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if launches[name] != FILM_BLOCKS * NFE or fb.bwd_launches:
            raise RuntimeError(f"{name}: {launches[name]} kernel launches "
                               f"(expected {FILM_BLOCKS * NFE}) and "
                               f"{fb.bwd_launches} backward launches")
        rgb_ply = (N, ("x", "y", "z", "red", "green", "blue"))
        if (len(plys) != B or headers != {rgb_ply}
                or x.shape != (B, N, 6) or not np.isfinite(x).all()):
            raise RuntimeError(f"{name}: bad output")
    return launches["heun50"]


def sample_ms_per_shape(torch, run_dir: str = RUN_DIR, over=None,
                        tag: str = "[sample]",
                        order=("on", "off", "off", "on", "on", "off")):
    """Phase 4: Heun x 50 ms/shape, kernel trunk vs plain trunk, in turns
    (the first run of each trunk a warm-up)."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train.evaluate import make_sample_fn

    fns = {}
    for trunk in ("on", "off"):
        _, bundle, _ = load_run(run_dir, {**(over or {}),
                                          "fused_trunk": trunk}, DEVICE)
        fns[trunk] = make_sample_fn(bundle)
    times = {"on": [], "off": []}
    for trunk in order:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[trunk](None, gen, B, N)
        torch.cuda.synchronize()
        times[trunk].append((time.perf_counter() - t0) * 1e3 / B)
    for trunk, ts in times.items():
        print(f"{tag} Heun x50 at {B} x {N}, fused_trunk={trunk}: "
              f"{' '.join(f'{t:.2f}' for t in ts)} ms/shape (first is "
              f"warm-up)")
    return {k: statistics.median(v[1:]) for k, v in times.items()}


def trunk_end_to_end(torch):
    """Phase 5: the same priors through a few Heun steps on three paths."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.sample.priors import make_latent_prior, make_pf_prior
    from pcfm_torch.train.evaluate import make_sample_fn

    over = {"sample_steps": 4}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    cfg, _, _ = load_run(RUN_DIR, over, DEVICE)
    z0 = make_latent_prior(gen, B, cfg.latent_dim)
    x0 = make_pf_prior(gen, (B, N, cfg.pf_point_dim))
    out = {}
    for name, extra in (("kernel_bf16", {"fused_trunk": "on"}),
                        ("plain_bf16", {"fused_trunk": "off"}),
                        ("plain_fp32", {"fused_trunk": "off",
                                        "amp": False})):
        _, bundle, _ = load_run(RUN_DIR, {**over, **extra}, DEVICE)
        out[name] = make_sample_fn(bundle)(None, None, B, N, z0=z0, x0=x0)
        del bundle
    ref = out["plain_fp32"]
    scale = ref.abs().max().item()
    rel = {}
    for name in ("kernel_bf16", "plain_bf16"):
        rel[name] = (out[name] - ref).abs().max().item() / scale
    diff = (out["kernel_bf16"] - out["plain_bf16"]).abs().max().item()
    print(f"[e2e] Heun x4 at {B} x {N}: max |kernel - plain| (bf16) "
          f"{diff:.4g}; vs fp32 plain (max |x| {scale:.4g}): kernel "
          f"{rel['kernel_bf16']:.4g}, plain bf16 {rel['plain_bf16']:.4g} "
          f"relative (bound {E2E_REL_TOL})")
    if not all(torch.isfinite(v).all() for v in out.values()) or \
            max(rel.values()) > E2E_REL_TOL:
        raise RuntimeError("kernel trunk and plain trunk disagree")
    return diff


def train_cli(fb, torch, name: str = "train", extra=(),
              tag: str = "[train]"):
    """Phase 7: the training CLI at full width: one epoch of the synthetic
    set (8 steps), validation and a checkpoint, then a rerun that must
    find nothing to do (``extra``: more flags, into RUN_DIR/``name``).
    Returns (forward, backward launches, steps)."""
    from pcfm_torch.train import cli
    out_dir = os.path.join(RUN_DIR, name)
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--dataset_type", "synthetic", "--batch_size", str(B),
            "--tr_max_sample_points", str(N), "--te_max_sample_points",
            str(N), "--latent_dim", "128", "--fused_trunk", "on",
            "--epochs", "1", "--save_every", "1", "--warmup_steps", "0",
            "--sample_steps", str(TRAIN_SAMPLE_STEPS), "--num_workers", "2",
            "--out_dir", out_dir, *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.launches = fb.bwd_launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = fb.launches, fb.bwd_launches
    ckpt_path = os.path.join(out_dir, "ckpts", "hybrid_ep0001.pt")
    steps = torch.load(ckpt_path, map_location="cpu",
                       weights_only=True)["global_step"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    # validation: recon + sample, Heun x TRAIN_SAMPLE_STEPS (2 NFE a step)
    val_fwd = FILM_BLOCKS * 2 * 2 * TRAIN_SAMPLE_STEPS
    print(f"{tag} CLI 1 epoch at {B} x {N}: {steps} steps, {bwd} backward "
          f"and {fwd} forward launches ({fwd - val_fwd} in the steps, "
          f"{val_fwd} in validation), losses {rows[-1]}, wall {wall:.2f} s "
          f"incl. data, validation and checkpoint, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if (steps != 8 or bwd != FILM_BLOCKS * steps
            or fwd - val_fwd != FILM_BLOCKS * steps or not finite
            or not os.path.isdir(os.path.join(out_dir, "samples_ep0001"))):
        raise RuntimeError("training CLI: wrong step or launch count, "
                           "non-finite loss or missing outputs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = cli.main(argv)
    print(f"{tag} rerun: {buf.getvalue().strip().splitlines()[-1]}")
    if again != {"epochs_run": 0} or "Nothing to do" not in buf.getvalue():
        raise RuntimeError("training CLI rerun did not resume as finished")
    return fwd, bwd, steps


def train_batch(torch):
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    return {"pts": torch.randn(B, N, 3, device=DEVICE, generator=g) * 0.5,
            "rgb": torch.rand(B, N, 3, device=DEVICE, generator=g),
            "cond": torch.rand(B, 1, device=DEVICE, generator=g)}


def train_state(torch, trunk: str, **kw):
    from pcfm_torch.train.state import init_state
    cfg = bench_cfg(fused_trunk=trunk, **kw)
    return init_state(cfg, DEVICE, STEPS_PER_EPOCH,
                      torch.Generator().manual_seed(SEED))


def kernel_share(prof_dir: str, torch, fn, steps: int,
                 trace: str = "train_step_trace.json") -> dict:
    """One torch.profiler run of ``steps`` calls of ``fn``: device time by
    kernel and the FiLM-block kernels' share of it."""
    prof = profile_kernels(torch, fn, steps, {"film_block": ("film_block",)},
                           os.path.join(prof_dir, trace))
    ours, busy = prof["film_block"][0], prof["busy_ms"]
    return {"wall_ms": prof["wall_ms"], "busy_ms": busy,
            "film_block_ms": ours,
            "film_block_share": ours / busy if busy else 0.0,
            "top": [(k, v) for k, v, _ in prof["top"][:10]]}


def step_run_ms(torch, state, batch, gen) -> tuple:
    """One run of TIMED_STEPS synchronised train steps: ms/step on the
    host clock and the last step's metrics."""
    from pcfm_torch.train.step import train_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        m = train_step(state, batch, gen, 1.0, 0.1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / TIMED_STEPS, m


def kernel_step_ms(torch, state, batch, gen, runs: int = 2) -> dict:
    """The train step with one trunk, by train_step_time's method:
    WARMUP_STEPS steps, then ``runs`` runs of step_run_ms; the runs'
    ms/step and their median, the runs' last losses, and the peak device
    memory of the timed runs."""
    from pcfm_torch.train.step import train_step
    for _ in range(WARMUP_STEPS):
        train_step(state, batch, gen, 1.0, 0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = [step_run_ms(torch, state, batch, gen) for _ in range(runs)]
    times = [t for t, _ in got]
    return {"ms": statistics.median(times), "runs_ms": times,
            "losses": [float(m["loss"]) for _, m in got],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def train_step_time(torch, tag: str = "[step]", rounds: int = 2,
                    trace: str = "train_step_trace.json", **kw):
    """Phase 8: the train step at bench.py's workload (``kw``: Config
    changes), kernel trunk and plain trunk in turns, after warm-up; peak
    memory; profiler shares."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    out = {}
    runs = {}
    for trunk in ("on", "off"):
        state = train_state(torch, trunk, **kw)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        runs[trunk] = (state, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARMUP_STEPS):
            train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        out[f"peak_gib_{trunk}"] = torch.cuda.max_memory_allocated() / 2**30
    times = {"on": [], "off": []}
    for trunk in ("on", "off", "off", "on") * rounds:
        state, gen = runs[trunk]
        ms, m = step_run_ms(torch, state, batch, gen)
        times[trunk].append(ms)
        if not math.isfinite(float(m["loss"])):
            raise RuntimeError(f"train step, trunk {trunk}: loss {m}")
    for trunk, ts in times.items():
        ms = statistics.median(ts)
        out[f"ms_{trunk}"] = ms
        print(f"{tag} train step at {B} x {N} bf16, fused_trunk={trunk}: "
              f"{' '.join(f'{t:.3f}' for t in ts)} ms/step (median "
              f"{ms:.3f}; x {STEPS_PER_EPOCH} = "
              f"{ms * STEPS_PER_EPOCH / 1e3:.3f} s/epoch), peak device "
              f"memory {out[f'peak_gib_{trunk}']:.3f} GiB")
    state, gen = runs["on"]
    share = kernel_share(RUN_DIR, torch,
                         lambda: train_step(state, batch, gen, 1.0, 0.1), 3,
                         trace)
    print(f"{tag} profiler, 3 kernel-trunk steps: {share['wall_ms']:.3f} ms"
          f"/step wall, {share['busy_ms']:.3f} ms device busy (idle share "
          f"{1 - share['busy_ms'] / share['wall_ms']:.3f}), film_block "
          f"kernels {share['film_block_ms']:.3f} ms = "
          f"{share['film_block_share']:.3f} of device time")
    for name, ms in share["top"]:
        print(f"{tag}   {ms:9.3f} ms/step  {name}")
    out["share"] = share
    del runs
    torch.cuda.empty_cache()
    return out


def determinism(torch):
    """Phase 9: two 3-step runs from the same seed and batch with the
    kernel trunk give bitwise-equal losses and parameters."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    results = []
    for _ in range(2):
        state = train_state(torch, "on")
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        losses = [train_step(state, batch, gen, 1.0, 0.1)["loss"]
                  for _ in range(3)]
        params = [p.detach().clone() for m in state.bundle.modules().values()
                  for p in m.parameters()]
        results.append((torch.stack(losses), params))
        del state
    (l1, p1), (l2, p2) = results
    same = torch.equal(l1, l2) and all(torch.equal(a, b)
                                       for a, b in zip(p1, p2))
    print(f"[determinism] 2 x 3 kernel-trunk steps: losses "
          f"{l1.tolist()} / {l2.tolist()}; {len(p1)} parameter tensors "
          f"(live and EMA) bitwise equal: {same}")
    if not same:
        raise RuntimeError("train step is not bitwise reproducible")


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple:
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def film_bounds(bsz: int, n: int, c: int, es: int = 2) -> dict:
    """Least times of the FiLM-block kernels at (bsz, n, c), activations
    of ``es`` bytes (2: bf16, 4: fp32): each input read once and each
    output written once; the products on the bf16 tensor cores (forward
    silu(f) @ W^T; backward dy @ W and the dW product)."""
    act, rows = bsz * n * c * es, bsz * n
    fwd_bytes = (2 * act + c * c * 4 + 3 * c * 4 + 2 * bsz * c * es
                 + 2 * rows * 4)
    bwd_bytes = (3 * act + 2 * c * c * 4 + 2 * rows * 4 + 2 * c * 4
                 + 4 * bsz * c * es + 3 * c * 4)
    return {"fwd": bound_ms(fwd_bytes, 2 * rows * c * c, BF16_FLOPS),
            "bwd": bound_ms(bwd_bytes, 4 * rows * c * c, BF16_FLOPS)}


def stats_bound_ms(bsz: int, n: int, c: int, es: int = 2) -> float:
    """Least time of the wide forward's statistics kernel at (bsz, n, c),
    h of ``es`` bytes: h read once, silu(f) written once as the packed bf16
    A (the pairs' padding rows included), mean and rstd written, s, t,
    gamma and beta read, at the HBM rate (it does no product)."""
    tiles = -(-bsz * -(-n // 64) // 2) * 2
    nbytes = (bsz * n * c * es + tiles * 64 * c * 2 + 2 * bsz * n * 4
              + 2 * c * 4 + 2 * bsz * c * es)
    return nbytes / HBM_BPS * 1e3


def wide_forward_build(fb, torch, build_log: str) -> dict:
    """Phase 26: the wide forward's kernels as ptxas built them (phase 1's
    log: registers at launch, stack, spill bytes, one line an
    instantiation) and how they launch at (B, N, C) for each timed width
    and dtype (fwd_wide_config): the product's producer and consumer
    registers after setmaxnreg, its stages, shared memory and CTAs, the
    statistics kernel's threads, shared memory and blocks. Fails on a
    spill."""
    name, kernels = "", {}
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "film_block_fwd_wide" in name and ("registers" in line
                                                or "spill" in line):
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                           name)
            kernels.setdefault(short[:70], []).append(
                line.split(":", 1)[-1].strip())
    spilled = [k for k, v in kernels.items()
               if any(int(x) for line in v
                      for x in re.findall(r"(\d+) bytes spill", line))]
    for k, v in kernels.items():
        print(f"[wide] ptxas {k}: {'; '.join(v)}")
    configs = {}
    for c, dtype in ((2048, "bfloat16"),) + WIDE_FWD_TIMED:
        cfg = fb.fwd_wide_config(B, N, c, getattr(torch, dtype),
                                 torch.cuda.current_device())
        configs[f"{c} {dtype}"] = cfg
        print(f"[wide] film_block forward ({B}, {N}, {c}) {dtype} launch: "
              f"product {cfg['product_ctas']} CTAs of "
              f"{cfg['product_threads']} threads (producer warpgroup "
              f"{cfg['producer_regs']} registers a thread after setmaxnreg, "
              f"two consumer warpgroups {cfg['consumer_regs']}), "
              f"{cfg['stages']} stages, "
              f"{cfg['product_smem_bytes']} bytes of shared memory a CTA; "
              f"statistics {cfg['stats_blocks']} blocks of "
              f"{cfg['stats_threads']} threads, {cfg['stats_smem_bytes']} "
              f"bytes of shared memory a block")
    if not kernels or spilled:
        raise RuntimeError(f"wide forward: ptxas report {sorted(kernels)}, "
                           f"spills in {spilled}")
    return {"ptxas": kernels, "launch": configs}


def voxel_bounds(torch, ids, w, dense, out_rows: int, what: str) -> tuple:
    """Least time of one gather or scatter on these inputs: the rows it
    must read (gather: the distinct grid rows the ids name; scatter: every
    update row), ids and weights, and the fp32 output written once; one
    multiply-add per (entry, channel) at the fp32 rate."""
    bsz, c, es = dense.shape[0], dense.shape[-1], dense.element_size()
    if what == "gather":
        offs = torch.arange(bsz, device=ids.device)[:, None, None]
        rows = int((ids.long() + offs * dense.shape[1]).unique().numel())
    else:
        rows = bsz * dense.shape[1]
    nbytes = rows * c * es + ids.numel() * 4 + w.numel() * 4 \
        + bsz * out_rows * c * 4
    return bound_ms(nbytes, 2 * ids.numel() * c, FP32_FLOPS)


def timed_turns(fns: dict, rounds: int = 2, reps=10) -> dict:
    """Median CUDA-event ms of each function, timed in turns (plain,
    kernel, kernel, plain, ...) after one warm-up call each; ``reps`` is
    the calls a timing, one number or one for each function."""
    names = list(fns)
    order = (names + names[::-1]) * rounds
    times = {k: [] for k in names}
    for k in names:
        fns[k]()
    for k in order:
        times[k].append(cuda_ms(fns[k], reps if isinstance(reps, int)
                                else reps[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def voxel_vs_plain(tvs, torch, stages=VOXEL_STAGES, batches=(B, 2 * B),
                   skewed: bool = True):
    """Phase 10: both voxel kernels against their plain versions at the
    hybrid's stage shapes (``stages``: (R, C) pairs, for each batch of
    ``batches``), then the skewed cases.  Returns two dicts
    {(kernel, R, C, B, K, dtype): row}: the stages and the skewed cases
    (empty unless ``skewed``)."""
    import torch.nn.functional as F
    from pcfm_torch.models.context import VOXEL_EPS
    out = {}
    for bsz in batches:
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
        pts = torch.randn(bsz, N, 3, device=DEVICE, generator=g)
        # the ContextNet's entry sort by the R = 32 voxel id
        perm, inv = tvs.sort_perm_by_voxel(pts, VOXEL_STAGES[0][0],
                                           eps=VOXEL_EPS)
        pts = tvs.permute_points(pts, perm, inv)
        for r, c in stages:
            cache = tvs.build_stage_cache(pts, r, eps=VOXEL_EPS)
            v = r ** 3
            ids8, w8 = cache["corners"]
            cases = {1: (cache["plan"].ids, cache["inv_pt"][:, None, :],
                         cache["plan"]),
                     8: (ids8, w8, tvs.corner_plan(cache))}
            for dtype in (torch.bfloat16, torch.float32):
                grid = torch.randn(bsz, v, c, device=DEVICE,
                                   generator=g).to(dtype)
                upd = torch.randn(bsz, N, c, device=DEVICE,
                                  generator=g).to(dtype)
                for k, (ids, w, plan) in cases.items():
                    out.update(voxel_case(tvs, torch, F, cache, r, c, bsz, k,
                                          dtype, ids, w, plan, grid, upd))
                del grid, upd
            del cache, cases
        torch.cuda.empty_cache()
    return out, voxel_skewed(tvs, torch, F) if skewed else {}


def voxel_skewed(tvs, torch, F) -> dict:
    """Phase 10's skewed cases: every point of each cloud in one voxel (the
    centre voxel at R = 8), so the scatter has one run of N entries (K = 1,
    weight 1 / N) or 8 N (K = 8, random weights), at B = 8 and C = 256."""
    r, c = VOXEL_STAGES[-1]
    v = r ** 3
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    centre = (r // 2) * (r * r + r + 1)
    out = {}
    for k in (1, 8):
        ids = torch.full((B, k, N), centre, dtype=torch.int32, device=DEVICE)
        w = (torch.full((B, 1, N), 1.0 / N, device=DEVICE) if k == 1 else
             torch.rand((B, k, N), device=DEVICE, generator=g))
        plan = tvs.scatter_plan(ids, v)
        for dtype in (torch.bfloat16, torch.float32):
            grid = torch.randn(B, v, c, device=DEVICE, generator=g).to(dtype)
            upd = torch.randn(B, N, c, device=DEVICE, generator=g).to(dtype)
            out.update(voxel_case(tvs, torch, F, None, r, c, B, k, dtype,
                                  ids, w, plan, grid, upd, tag="skewed "))
    return out


def voxel_case(tvs, torch, F, cache, r, c, bsz, k, dtype, ids, w, plan,
               grid, upd, tag="") -> dict:
    """One (R, C, B, K, dtype) case of phase 10, both kernels; the one
    PyTorch call is timed beside them where ``cache`` gives its inputs."""
    v = r ** 3
    tag = f"{tag}R={r} C={c} B={bsz} K={k} {str(dtype)[6:]}"
    fns = {"gather": (lambda: tvs.voxel_gather(grid, ids, w),
                      lambda: tvs.voxel_gather_reference(grid, ids, w)),
           "scatter": (lambda: tvs.voxel_scatter(upd, w, plan),
                       lambda: tvs.voxel_scatter_reference(upd, ids, w, v))}
    magnitude = {  # the same sums over |w * x|
        "gather": lambda: tvs.voxel_gather_reference(grid.abs(), ids,
                                                     w.abs()),
        "scatter": lambda: tvs.voxel_scatter_reference(upd.abs(), ids,
                                                       w.abs(), v)}
    library = {}
    if cache is not None and k == 8:  # devoxelize: grid_sample, 5-D grid
        grid5 = grid.view(bsz, r, r, r, c).permute(0, 4, 1, 2, 3)
        loc = (cache["norm_coords"].flip(-1) * (2.0 / (r - 1)) - 1.0)
        loc = loc.view(bsz, 1, 1, N, 3).to(dtype)
        library["gather"] = lambda: F.grid_sample(
            grid5, loc, mode="bilinear", padding_mode="zeros",
            align_corners=True)
    elif cache is not None:           # weights 1 / count: the scatter-mean
        idx = ids[:, 0].long()[..., None].expand(-1, -1, c).contiguous()
        zeros = torch.zeros((bsz, v, c), dtype=dtype, device=DEVICE)
        library["scatter"] = lambda: zeros.scatter_reduce(
            1, idx, upd, "mean", include_self=False)
    rows = {}
    for what, (kern, plain) in fns.items():
        got, again = kern(), kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (got - ref).abs()
        worst = (err / (VOXEL_TOL * magnitude[what]() + VOXEL_ATOL)).max()
        ok = worst.item() <= 1.0 and bool(torch.isfinite(got).all())
        if not ok or not torch.equal(got, again):
            raise RuntimeError(f"voxel_{what} {tag}: disagrees with its "
                               f"plain version (max abs err "
                               f"{err.max().item():.4g}, max err/bound "
                               f"{worst.item():.4g}) or differs between "
                               f"two launches")
        lib_note = ""
        if what in library:
            lib_out = library[what]().float()
            if what == "gather":
                lib_out = lib_out.view(bsz, c, N).transpose(1, 2)
            lib_note = (f"; library call max abs diff "
                        f"{(lib_out - ref).abs().max().item():.3g}")
        t = timed_turns({"plain": plain, "kernel": kern,
                         **({"library": library[what]}
                            if what in library else {})})
        # the kernel's own device time (calls queued back to back), beside
        # the CUDA-event time that includes the wrapper's host time
        dev_ms = queued_ms(torch, kern)
        # the floor under both: the fp32 output written once (zero_)
        sink = torch.empty_like(got)
        write_ms = cuda_ms(sink.zero_)
        del sink
        dense = grid if what == "gather" else upd
        bms, by = voxel_bounds(torch, ids, w, dense,
                               N if what == "gather" else v, what)
        lib_t = f", library {t['library']:.4f} ms" if "library" in t else ""
        print(f"[voxel] {what} {tag}: max abs err {err.max().item():.4g} "
              f"(max err/bound {worst.item():.3g}), bitwise equal across "
              f"two launches"
              f"{lib_note}; kernel {t['kernel']:.4f} ms (device "
              f"{dev_ms:.4f}), plain "
              f"{t['plain']:.4f} ms{lib_t}; bound {bms:.4f} ms ({by}); "
              f"the output's write alone {write_ms:.4f} ms")
        rows[(what, r, c, bsz, k, dtype)] = {
            "max_abs_err": err.max().item(), "ms": t["kernel"],
            "device_ms": dev_ms, "write_ms": write_ms,
            "plain_ms": t["plain"], "library_ms": t.get("library"),
            "bound_ms": bms, "bound_by": by}
        del got, again, ref, err, worst
    return rows


def hybrid_cfg(**kw):
    """The bench configuration with the hybrid point flow (the Config's
    ContextNet defaults, bf16 island, kernel trunk)."""
    return bench_cfg(pf_backbone="hybrid", **kw)


def reset_counts(fb, tvs, tc=None):
    fb.launches = fb.bwd_launches = 0
    for name in tvs.launches:
        tvs.launches[name] = 0
    if tc is not None:
        tc.launches = 0


def write_hybrid_checkpoint(torch, out_dir: str = HYB_DIR,
                            moved_stats: bool = False, **kw):
    """The full-width hybrid checkpoint of phases 11-13 and 20 (``kw``:
    Config changes): random weights from the seed, the zero-init head_out
    and FiLM1d affines drawn N(0, 0.02) so that the PVConv pyramid reaches
    the velocity.  ``moved_stats``: the EMA's running means drawn N(0, 0.1)
    and variances U(0.75, 1.25), the live ones apart from them, so that a
    check of which statistics a consumer took is not vacuous."""
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    shutil.rmtree(out_dir, ignore_errors=True)
    gen = torch.Generator().manual_seed(SEED)
    bundle = ModelBundle(hybrid_cfg(**kw), DEVICE, gen)
    with torch.no_grad():
        for name, p in bundle.pf.named_parameters():
            if name.endswith(("head_out.weight", "film.affine.weight")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        bundle.ema_pf.load_state_dict(bundle.pf.state_dict())
        for module in ((bundle.ema_pf, bundle.pf) if moved_stats else ()):
            for name, v in module.named_buffers():
                if name.endswith("running_mean"):
                    v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
                elif name.endswith("running_var"):
                    v.copy_(torch.rand(v.shape, generator=gen) * 0.5 + 0.75)
    path = checkpoint.save(out_dir, 1, bundle)
    n_params = sum(p.numel() for p in bundle.pf.parameters())
    print(f"[hybrid] wrote {os.path.relpath(path, ROOT)} (point flow "
          f"{n_params / 1e6:.3f} M parameters)")
    del bundle
    return path


def hybrid_main_path(fb, tvs, torch, np, out_dir: str = HYB_DIR,
                     runs=(("heun50", []),
                           ("heun50_cfg0.25", ["--guidance_scale", "0.25"])),
                     tag: str = "[hybrid]", **kw):
    """Phase 11: the sampling CLI on a full-width hybrid checkpoint (``kw``:
    Config changes), once for each of ``runs`` (name, extra flags).
    Returns each run's launch counts and peak memory."""
    from pcfm_torch.sample import cli

    write_hybrid_checkpoint(torch, out_dir, **kw)
    want = {"film_block": FILM_BLOCKS * NFE,
            "voxel_gather": PVCONVS * NFE, "voxel_scatter": PVCONVS * NFE}
    result = {}
    for name, extra in runs:
        save_dir = os.path.join(out_dir, name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fb, tvs)
        t0 = time.perf_counter()
        x = cli.main(["--out_dir", out_dir, "--save_dir", save_dir,
                      "--num_samples", str(B), "--n_points", str(N),
                      "--seed", str(SEED), "--device", "cuda", *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"film_block": fb.launches, **tvs.launches}
        plys = sorted(os.listdir(save_dir))
        headers = {ply_vertices(os.path.join(save_dir, p)) for p in plys}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{tag} {name}: launches {got} (expected {want}: FiLM "
              f"{FILM_BLOCKS} blocks and {PVCONVS} PVConvs x one scatter + "
              f"one gather, x {NFE} evaluations), {len(plys)} PLYs, clouds "
              f"{x.shape}, finite {bool(np.isfinite(x).all())}, |x| max "
              f"{np.abs(x).max():.4g}, CLI wall {wall:.3f} s incl. load and "
              f"PLY writes, peak device memory {peak:.3f} GiB")
        rgb_ply = (N, ("x", "y", "z", "red", "green", "blue"))
        if got != want or fb.bwd_launches:
            raise RuntimeError(f"{name}: launches {got}, expected {want}")
        if (len(plys) != B or headers != {rgb_ply}
                or x.shape != (B, N, 6) or not np.isfinite(x).all()):
            raise RuntimeError(f"{name}: bad output")
        result[name] = dict(got, peak_gib=peak)
    return result



def odd_channels(fb, tvs, torch, np) -> dict:
    """Phase 31: the voxel kernels at channel counts that are not multiples
    of 8 (ODD_CS: 8-byte bf16 slices at 36 and 100, one channel a slice at
    37; fp32 rows in 16-byte slices at 36 and 100, 4-byte at 37), both
    against their plain versions at R = 32, B = 8, N = 20 000, K = 1 and 8,
    bf16 and fp32 (the fp32 cases are the transposes the backward runs),
    as phase 10 holds them; then the hybrid with ctx_stage_channels
    ODD_STAGE_CHANNELS (its R = 32 stage at C = 100, the rest the Config's)
    through the sampling CLI, Heun x 50 at 8 x 20 000 with exact launches,
    and two bf16 train steps at 8 x 20 000 with exact launches a step
    (HYB_STEP_LAUNCHES), finite losses, the second step's ms and the peak
    memory."""
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import train_step
    rows, _ = voxel_vs_plain(tvs, torch, stages=[(32, c) for c in ODD_CS],
                             batches=(B,), skewed=False)
    channels = list(ODD_STAGE_CHANNELS)
    sample = hybrid_main_path(fb, tvs, torch, np, HYB_ODD_DIR,
                              (("heun50", []),), "[hybrid-odd]",
                              ctx_stage_channels=channels)
    state = init_state(hybrid_train_cfg(ctx_stage_channels=channels), DEVICE,
                       STEPS_PER_EPOCH, torch.Generator().manual_seed(SEED))
    batch = train_batch(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    steps, times, losses, counted = 2, [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        reset_counts(fb, tvs)
        t0 = time.perf_counter()
        m = train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        counted.append({"film_block": fb.launches,
                        "film_block_bwd": fb.bwd_launches, **tvs.launches})
    peak = torch.cuda.max_memory_allocated() / 2**30
    at_c = 2 * state.bundle.cfg.ctx_stage_blocks[0]   # forward, backward
    print(f"[hybrid-odd] train step at {B} x {N} bf16, ctx_stage_channels "
          f"{channels}: {' '.join(f'{t:.3f}' for t in times)} ms (the "
          f"first builds the stage caches), losses {losses}, launches a "
          f"step {counted[-1]} (expected {HYB_STEP_LAUNCHES}; {at_c} of "
          f"each voxel kernel at C = {channels[0]}), peak device memory "
          f"{peak:.3f} GiB")
    if any(c != HYB_STEP_LAUNCHES for c in counted) \
            or not all(math.isfinite(v) for v in losses):
        raise RuntimeError("hybrid train step at odd channels: launches or "
                           "loss")
    del state
    torch.cuda.empty_cache()
    return {"rows": rows, "sample": sample["heun50"],
            "train_launches_per_step": counted[-1],
            "train_step_ms": times[-1], "train_peak_gib": peak,
            "launches_per_step_at_c100": at_c}

def profile_kernels(torch, fn, calls: int, groups: dict,
                    trace: str) -> dict:
    """One torch.profiler run of ``calls`` calls of ``fn``: device time
    and launches by kernel group (a group takes the kernel names that
    contain any of its words and no earlier group took), device-busy time
    and the wall time."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    for attempt, wait in enumerate(PROFILE_TRAILS_S, 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            time.sleep(wait)
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            every = json.load(f)["traceEvents"]
        events = [e for e in every if e.get("cat") == "kernel"]
        launched = sum(1 for e in every
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", ""))
        if events and len(events) >= PROFILE_RECORDED * launched:
            break
        print(f"[profile] {os.path.relpath(trace, ROOT)}: session "
              f"{attempt} held {len(events)} kernel records of {launched} "
              f"launches")
    else:               # a measurement that would hide itself as zeros
        raise RuntimeError(f"{trace}: the profile holds {len(events)} "
                           f"kernel records of {launched} launches in each "
                           f"of {attempt} sessions")
    by_name, count = {}, {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        count[e["name"]] = count.get(e["name"], 0) + 1
    busy = sum(by_name.values())
    # every call of ``fn`` in all sessions (counters read after it)
    out = {"calls_run": attempt * calls,
           "wall_ms": wall_us / 1e3 / calls, "busy_ms": busy / 1e3 / calls,
           "top": [(k[:90], v / 1e3 / calls, count[k]) for k, v in
                   sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]}
    taken = set()
    for group, words in groups.items():
        names = [k for k in by_name if k not in taken
                 and any(w in k.lower() for w in words)]
        taken.update(names)
        out[group] = (sum(by_name[k] for k in names) / 1e3 / calls,
                      sum(count[k] for k in names) // calls)
        out[f"{group}_kernels"] = sorted({k[:60] for k in names})
    return out


def kernel_overlap_ms(trace: str, words_a: tuple, words_b: tuple,
                      calls: int) -> float:
    """From a trace of profile_kernels: the device time a call in which a
    kernel whose name holds one of ``words_a`` and one that holds one of
    ``words_b`` ran at once (the two groups' unions of intervals,
    intersected)."""
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]

    def union(words):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if any(w in e["name"].lower() for w in words))
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out
    both, ua, ub = 0.0, union(words_a), union(words_b)
    for a0, a1 in ua:
        for b0, b1 in ub:
            both += max(0.0, min(a1, b1) - max(a0, b0))
    return both / 1e3 / calls


def hybrid_ms_per_shape(torch):
    """Phase 12: hybrid Heun x 50 ms/shape, then a profiled run."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train.evaluate import make_sample_fn

    _, bundle, _ = load_run(HYB_DIR, None, DEVICE)
    sample = make_sample_fn(bundle)

    def run():
        return sample(None, torch.Generator(device=DEVICE).manual_seed(SEED),
                      B, N)

    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / B)
    ms = statistics.median(times[1:])
    print(f"[hybrid] Heun x50 at {B} x {N}: "
          f"{' '.join(f'{t:.2f}' for t in times)} ms/shape (first is "
          f"warm-up; median {ms:.2f})")
    # the plans' glue (3 stage caches an
    # evaluation: sort, searchsorted for the row pointer and the chunks'
    # voxels, the chunk prefix) by kernel name, where the entry sort's
    # argsort joins the sorts
    groups = {"voxel_gather": ("voxel_gather",),
              "voxel_scatter": ("voxel_scatter",),
              "film_block": ("film_block",),
              "conv3d": ("fprop", "conv", "cudnn"),
              "plan_searchsorted": ("searchsorted",),
              "plan_sort": ("sort",),
              "plan_cumsum": ("scan",)}
    prof = profile_kernels(torch, run, 1, groups,
                           os.path.join(HYB_DIR, "sample_trace.json"))
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    print(f"[hybrid] profiler, one Heun x50 run: {prof['wall_ms']:.1f} ms "
          f"wall, {prof['busy_ms']:.1f} ms device busy (idle share "
          f"{idle:.3f})")
    for group in groups:
        g_ms, g_n = prof[group]
        print(f"[hybrid]   {group}: {g_ms:.2f} ms device time, {g_n} "
              f"launches, {g_ms / prof['busy_ms']:.3f} of device time "
              f"({len(prof[group + '_kernels'])} kernel names: "
              f"{'; '.join(prof[group + '_kernels'])})")
    for name, k_ms, k_n in prof["top"]:
        print(f"[hybrid]   {k_ms:9.2f} ms  {k_n:5d} x  {name}")
    return {"ms_per_shape": ms, "profile": prof, "idle_share": idle}


def hybrid_end_to_end(tvs, torch):
    """Phase 13: one full-width hybrid velocity, card (bf16, kernels) vs
    CPU (fp32, plain versions), on the same checkpoint and inputs."""
    from pcfm_torch.sample.cli import load_run
    b, n = HYB_E2E_POINTS
    cfg = hybrid_cfg()
    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn(b, n, 6, generator=g)
    t = torch.rand(b, generator=g)
    cond = torch.randn(b, cfg.pf_cond_dim, generator=g)
    out = {}
    for dev, over in ((DEVICE, None), ("cpu", {"amp": False,
                                               "ctx_dtype": "fp32"})):
        _, bundle, _ = load_run(HYB_DIR, over, dev)
        before = dict(tvs.launches)
        with torch.no_grad():
            v = bundle.ema_pf.eval()(x.to(dev), t.to(dev), cond.to(dev))
        out[dev] = v.float().cpu()
        launched = {k: tvs.launches[k] - before[k] for k in before}
        if launched != dict.fromkeys(before, PVCONVS if dev == DEVICE
                                     else 0):
            raise RuntimeError(f"end to end on {dev}: voxel launches "
                               f"{launched}")
        del bundle
    ref = out["cpu"]
    rel = (out[DEVICE] - ref).abs().max().item() / ref.abs().max().item()
    print(f"[hybrid] end to end, one velocity at ({b}, {n}): card bf16 "
          f"kernels vs CPU fp32 plain: max abs err / max |v| {rel:.4g} "
          f"(bound {HYB_E2E_REL_TOL}; max |v| {ref.abs().max().item():.4g})")
    if not torch.isfinite(out[DEVICE]).all() or rel > HYB_E2E_REL_TOL:
        raise RuntimeError("hybrid velocity: card and CPU disagree")
    return rel


def chamfer_bound(clouds: int, pairs: int, n: int, m: int,
                  d: int) -> tuple:
    """Least time of both ways of the nearest-neighbour search over
    ``pairs`` pairs of (n, d) / (m, d) fp32 clouds: the ``clouds`` distinct
    clouds read once, (dist, idx) of every point written once; 3 d - 1
    FLOP a (query, target) pair and way, at the fp32 rate."""
    nbytes = clouds * (n + m) // 2 * d * 4 + pairs * (n + m) * 8
    return bound_ms(nbytes, 2 * pairs * n * m * (3 * d - 1), FP32_FLOPS)


def chamfer_screen_bound(clouds: int, pairs: int, n: int, m: int,
                         d: int) -> tuple:
    """The kernel's bound: the least time of its screen, which every
    (query, target) pair needs (the difference-form check takes only the
    few targets that pass it), over both ways of ``pairs`` pairs.  The
    bytes as in ``chamfer_bound``; the operations 2 K FLOP a pair on the
    TF32 tensor cores (K = D + 4 padded to 8 or 16), or one fp32 min a
    pair, whichever is longer."""
    nbytes = clouds * (n + m) // 2 * d * 4 + pairs * (n + m) * 8
    k = 8 * ((d + 4 + 7) // 8)
    both = 2 * pairs * n * m
    return max(bound_ms(nbytes, both * 2 * k, TF32_FLOPS),
               bound_ms(nbytes, both, FP32_FLOPS))


def cdist_min(torch, q, t):
    """The yardstick: ``cdist`` (difference form) then ``min`` both ways,
    in as few calls as cdist's launch grid takes (CDIST_MAX_ENTRIES)."""
    per = max(1, CDIST_MAX_ENTRIES // (q.shape[1] * t.shape[1]))
    out = []
    for s in range(0, q.shape[0], per):
        c = torch.cdist(q[s:s + per], t[s:s + per],
                        compute_mode="donot_use_mm_for_euclid_dist")
        out.append((c.min(-1), c.min(-2)))
    return out


def check_nn(tc, torch, q, t, qi, ti, dist, idx, tag: str) -> tuple:
    """One way of the kernel against the plain version: distances within
    the stated tolerance, indices equal except on near ties, where the
    kernel's neighbour must be within it of the best.  Returns (max abs
    err, indices that differ, tolerance)."""
    ref_d, ref_i = tc.chamfer_nn_reference(q, t, qi, ti)
    tol = CHAMFER_REL_TOL * ref_d.max().item() + CHAMFER_ATOL
    err = (dist - ref_d).abs().max().item()
    qq = q[torch.as_tensor(qi, device=q.device).long()]
    tt = t[torch.as_tensor(ti, device=q.device).long()]
    chosen = ((qq - torch.gather(tt, 1, idx.long()[..., None].expand(
        -1, -1, q.shape[-1]))) ** 2).sum(-1)
    differ = idx != ref_i
    near = (chosen - ref_d)[differ].abs().max().item() if differ.any() \
        else 0.0
    if not torch.isfinite(dist).all() or err > tol or near > tol:
        raise RuntimeError(f"chamfer_nn {tag}: max abs err {err:.4g}, "
                           f"{int(differ.sum())} indices differ by up to "
                           f"{near:.4g} (tolerance {tol:.4g})")
    return err, int(differ.sum()), tol


def chamfer_timed(tag, kernel, plain, library, shape) -> dict:
    """Kernel and plain CUDA-event ms in turns, beside the bound (the
    screen's, ``chamfer_screen_bound``) and the difference form's bound
    (``chamfer_bound``, which earlier rows were held to); the yardstick
    (seconds a call) timed once, when given.  ``shape``: (clouds, pairs,
    n, m, d)."""
    t = timed_turns({"plain": plain, "kernel": kernel}, rounds=1,
                    reps={"plain": 1, "kernel": 10})
    lib = cuda_ms(library, reps=1) if library else None
    lib_note = f", cdist + min {lib:.1f} ms (one run)" if lib else ""
    bound, diff = chamfer_screen_bound(*shape), chamfer_bound(*shape)
    print(f"[chamfer] {tag}: kernel {t['kernel']:.4f} ms, plain "
          f"{t['plain']:.3f} ms{lib_note}; bound (the screen) "
          f"{bound[0]:.4f} ms ({bound[1]}), "
          f"{100 * bound[0] / t['kernel']:.1f} % of it; the difference "
          f"form's {diff[0]:.4f} ms")
    return {"ms": t["kernel"], "plain_ms": t["plain"], "library_ms": lib,
            "bound_ms": bound[0], "bound_by": bound[1],
            "difference_form_bound_ms": diff[0]}


def chamfer_vs_plain(tc, torch):
    """Phase 14: the chamfer kernel against its plain version.  Returns
    {B: timed row, "suite": timed row, "max_abs_err": x}."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)

    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=g)

    out, worst = {}, 0.0

    def both_ways(a, b, tag):
        nonlocal worst
        pairs = list(range(a.shape[0]))
        got, again = tc.chamfer_distance(a, b), tc.chamfer_distance(a, b)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"chamfer_nn {tag}: two launches differ")
        e1, n1, tol = check_nn(tc, torch, a, b, pairs, pairs, got[0],
                               got[2], tag)
        e2, n2, _ = check_nn(tc, torch, b, a, pairs, pairs, got[1], got[3],
                             tag)
        worst = max(worst, e1, e2)
        print(f"[chamfer] {tag}: max abs err {max(e1, e2):.4g} (tolerance "
              f"{tol:.4g}), {n1 + n2} indices differ on near ties, bitwise "
              f"equal across two launches")
        return got

    for bsz in (B, 2 * B):
        a, b = rnd(bsz, N, 3), rnd(bsz, N, 3)
        pairs = list(range(bsz))
        got = both_ways(a, b, f"({bsz}, {N}, 3) both ways")
        lib = cdist_min(torch, a, b)
        per = lib[0][0][0].shape[0]
        lib_err = (lib[0][0][0] ** 2 - got[0][:per]).abs().max().item()
        print(f"[chamfer] ({bsz}, {N}, 3): cdist + min in {len(lib)} "
              f"calls, max |cdist^2 - kernel| {lib_err:.3g}")
        del lib
        out[bsz] = chamfer_timed(
            f"({bsz}, {N}, 3) both ways",
            lambda: tc.chamfer_distance(a, b),
            lambda: (tc.chamfer_nn_reference(a, b, pairs, pairs),
                     tc.chamfer_nn_reference(b, a, pairs, pairs)),
            lambda: cdist_min(torch, a, b), (2 * bsz, bsz, N, N, 3))
        del a, b, got
        torch.cuda.empty_cache()
    both_ways(rnd(B, 20011, 3), rnd(B, 17389, 3), f"({B}, 20011 vs 17389, 3)")
    base = rnd(B, N // 2, 3)
    got = both_ways(rnd(B, N, 3), torch.cat([base, base], dim=1),
                    f"({B}, {N} vs {N // 2} x 2 duplicated, 3)")
    if int(got[2].max()) >= N // 2:
        raise RuntimeError("chamfer_nn: a tie went to the higher index")
    print(f"[chamfer] duplicated targets: every query chose the lower copy")

    sets = rnd(SUITE_CLOUDS, SUITE_POINTS, 3)
    qi = torch.arange(SUITE_CLOUDS).repeat_interleave(SUITE_CLOUDS)
    ti = torch.arange(SUITE_CLOUDS).repeat(SUITE_CLOUDS)
    d1, i1 = tc.chamfer_nn(sets, sets, qi, ti)
    d2, i2 = tc.chamfer_nn(sets, sets, qi, ti)
    torch.cuda.synchronize()
    err, differ, tol = check_nn(tc, torch, sets, sets, qi, ti, d1, i1,
                                "suite pairs")
    diag = d1.view(SUITE_CLOUDS, SUITE_CLOUDS, -1).diagonal()
    if not (torch.equal(d1, d2) and torch.equal(i1, i2)) \
            or diag.abs().max().item() != 0.0:
        raise RuntimeError("chamfer_nn suite pairs: launches differ or a "
                           "cloud is not at distance 0 from itself")
    worst = max(worst, err)
    print(f"[chamfer] suite pairs ({SUITE_CLOUDS}^2 pairs of {SUITE_POINTS} "
          f"points): max abs err {err:.4g} (tolerance {tol:.4g}), {differ} "
          f"indices differ on near ties, bitwise equal, self pairs 0")
    pairs_q, pairs_t = sets[qi], sets[ti]
    out["suite"] = chamfer_timed(
        f"suite pairs form, {SUITE_CLOUDS ** 2} pairs both ways",
        lambda: (tc.chamfer_nn(sets, sets, qi, ti),
                 tc.chamfer_nn(sets, sets, ti, qi)),
        lambda: (tc.chamfer_nn_reference(sets, sets, qi, ti),
                 tc.chamfer_nn_reference(sets, sets, ti, qi)),
        lambda: cdist_min(torch, pairs_q, pairs_t),
        (SUITE_CLOUDS, SUITE_CLOUDS ** 2, SUITE_POINTS, SUITE_POINTS, 3))
    del sets, pairs_q, pairs_t
    torch.cuda.empty_cache()

    # the screen's margin: clouds that shift its error, exact ties, and
    # targets in spatial order (the bound falls slowly, more shares pass)
    def by_x(x):
        return torch.gather(x, 1, x[..., :1].argsort(dim=1).expand(-1, -1, 3)
                            ).contiguous()

    pairs = list(range(B))
    a, b = rnd(B, N, 3), rnd(B, N, 3)
    cases = {"random": (a, b), "shifted +1e2": (a + 1e2, b + 1e2),
             "shifted +1e4": (a + 1e4, b + 1e4),
             "integer lattice": tuple(
                 torch.randint(0, 20, (B, N, 3), device=DEVICE,
                               generator=g).float() for _ in range(2)),
             "sorted along x": (by_x(a), by_x(b))}
    out["cases"] = {}
    for tag, (x, y) in cases.items():
        if tag != "random":
            got = both_ways(x, y, f"({B}, {N}, 3) {tag}")
            if tag == "integer lattice":
                for q, t, idx in ((x, y, got[2]), (y, x, got[3])):
                    if not torch.equal(idx, tc.chamfer_nn_reference(
                            q, t, pairs, pairs)[1]):
                        raise RuntimeError("chamfer_nn lattice: an exact tie "
                                           "did not go to the lowest index")
                print("[chamfer] integer lattice: indices equal the plain "
                      "version's (exact ties to the lowest index)")
        ms = cuda_ms(lambda: tc.chamfer_distance(x, y))
        print(f"[chamfer] ({B}, {N}, 3) {tag}: kernel {ms:.4f} ms both ways")
        out["cases"][tag] = {"ms": ms}
    del a, b, cases
    torch.cuda.empty_cache()

    # the tensor cores' screen against its plain version
    ratio = 0.0
    for d, shift in ((3, 0.0), (3, 1e4), (8, 0.0)):
        q, t = rnd(4096, d) + shift, rnd(8192, d) + shift
        exact, scale = tc.screen_reference(q, t)
        r = ((tc.screen(q, t).double() - exact).abs() / scale).max().item()
        print(f"[chamfer] screen (4096 x 8192, D = {d}, shifted {shift:g}): "
              f"max |s - |a~ - b~|^2| / (|a~| + |b~|)^2 = {r:.3g} "
              f"(SCREEN_KAPPA {tc.SCREEN_KAPPA:.3g})")
        ratio = max(ratio, r / tc.SCREEN_KAPPA)
        del q, t, exact, scale
    if ratio > 1.0:
        raise RuntimeError(f"chamfer screen error {ratio:.3g} x its bound")

    # a query with a NaN coordinate: no share passes its threshold, so it
    # keeps the index it starts with (0, with +inf); the other queries'
    # results must not move, and the gradient path must gather in range
    a, b = rnd(B, N, 3), rnd(B, N, 3)
    clean = tc.chamfer_nn(a, b, pairs, pairs)
    a[0, 5, 1] = float("nan")
    d1, i1 = tc.chamfer_nn(a, b, pairs, pairs)
    i2 = tc.chamfer_nn(b, a, pairs, pairs)[1]
    rest = torch.ones_like(i1, dtype=torch.bool)
    rest[0, 5] = False
    a.requires_grad_(True)
    g1, g2, _, _ = tc.chamfer_distance(a, b)
    (g1.nan_to_num(0.0).sum() + g2.sum()).backward()
    torch.cuda.synchronize()
    if not (int(i1[0, 5]) == 0 and int(i1.min()) >= 0 and int(i1.max()) < N
            and int(i2.min()) >= 0 and int(i2.max()) < N
            and torch.equal(d1[rest], clean[0][rest])
            and torch.equal(i1[rest], clean[1][rest])):
        raise RuntimeError("chamfer_nn: a NaN query gave an index out of "
                           "range or moved the other queries' results")
    print("[chamfer] a NaN query: index 0, the other queries bitwise as "
          "without it, the gradient path gathers in range")
    del a, b, clean, d1, i1, i2, g1, g2
    out["screen_err_over_kappa"] = ratio
    out["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return out


def eval_cli_full_width(fb, tvs, tc, torch):
    """Phase 15: the evaluation CLI on phase 7's trained run, then the
    streamed EMD's time per batch and a profile of one batch's metrics."""
    from pcfm_torch.eval import cli
    from pcfm_torch.eval.metrics import _pick_chunk, cloud_metrics
    from pcfm_torch.ops.emd import earth_mover_distance_streamed
    run = os.path.join(RUN_DIR, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fb, tvs, tc)
    t0 = time.perf_counter()
    out = cli.main(["--out_dir", run, "--mode", "both", "--max_batches",
                    str(EVAL_BATCHES), "--sample_steps", "50", "--device",
                    "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"chamfer_nn": tc.launches, "film_block": fb.launches,
           "film_block_bwd": fb.bwd_launches, **tvs.launches}
    # recon and gen: per batch one chamfer_distance (2 launches) and one
    # point-flow Heun x 50 (5 blocks x 100 evaluations)
    calls = 2 * EVAL_BATCHES
    want = {"chamfer_nn": 2 * calls, "film_block": calls * FILM_BLOCKS * NFE,
            "film_block_bwd": 0, **dict.fromkeys(tvs.launches, 0)}
    keys = [f"{m}_{k}" for m in ("recon", "gen")
            for k in ("cd", "emd", "fscore", "precision", "recall")]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[eval] CLI --mode both, {EVAL_BATCHES} batches of {B} x {N}, "
          f"Heun x 50: launches {got} (expected {want}), wall {wall:.3f} s "
          f"incl. load, data and metrics, peak device memory {peak:.3f} GiB")
    if got != want or out.get("n_clouds") != EVAL_BATCHES * B \
            or not all(math.isfinite(out.get(k, math.nan)) for k in keys):
        raise RuntimeError(f"evaluation CLI: launches {got} or output {out}")

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    x = torch.randn(B, N, 3, device=DEVICE, generator=g)
    y = torch.randn(B, N, 3, device=DEVICE, generator=g) * 0.5
    chunk = _pick_chunk(N, N)
    emd_ms = cuda_ms(lambda: earth_mover_distance_streamed(x, y, chunk),
                     reps=1)
    print(f"[eval] streamed EMD at {B} x {N} (chunk {chunk}): "
          f"{emd_ms:.1f} ms a batch")
    groups = {"chamfer_nn": ("chamfer_nn",), "exp": ("exp",),
              "gemm": ("gemm", "cutlass", "xmma")}
    prof = profile_kernels(torch, lambda: cloud_metrics(x, y), 1, groups,
                           os.path.join(RUN_DIR, "eval_metrics_trace.json"))
    print(f"[eval] profiler, one batch's cloud_metrics: "
          f"{prof['wall_ms']:.1f} ms wall, {prof['busy_ms']:.1f} ms device "
          f"busy (idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f})")
    for group in groups:
        g_ms, g_n = prof[group]
        print(f"[eval]   {group}: {g_ms:.2f} ms device time, {g_n} launches")
    for name, k_ms, k_n in prof["top"][:8]:
        print(f"[eval]   {k_ms:9.2f} ms  {k_n:5d} x  {name}")
    return {"launches": got, "wall_s": wall, "emd_ms": emd_ms,
            "profile": prof, "peak_gib": peak}


def suite_full_width(fb, tvs, tc, torch):
    """Phase 16: the MMD / COV / 1-NNA suite on a full-width mlp checkpoint
    with random weights."""
    from pcfm_torch.eval import cli
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    suite_dir = os.path.join(RUN_DIR, "suite")
    shutil.rmtree(suite_dir, ignore_errors=True)
    bundle = ModelBundle(bench_cfg(dataset_type="synthetic",
                                   te_max_sample_points=SUITE_POINTS),
                         DEVICE, torch.Generator().manual_seed(SEED))
    checkpoint.save(suite_dir, 1, bundle)
    del bundle
    seeds = (0, 1)
    torch.cuda.synchronize()
    reset_counts(fb, tvs, tc)
    t0 = time.perf_counter()
    out = cli.main(["--out_dir", suite_dir, "--mode", "suite",
                    "--suite_size", str(SUITE_CLOUDS), "--suite_emd",
                    "--suite_seeds", ",".join(map(str, seeds)),
                    "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"chamfer_nn": tc.launches, "film_block": fb.launches,
           "film_block_bwd": fb.bwd_launches, **tvs.launches}
    # per seed: SUITE_CLOUDS / B sampling calls of Heun x 50, and three
    # cd matrices (gen-ref, gen-gen, ref-ref) of 2 launches each
    want = {"chamfer_nn": len(seeds) * 3 * 2,
            "film_block": len(seeds) * SUITE_CLOUDS // B * FILM_BLOCKS * NFE,
            "film_block_bwd": 0, **dict.fromkeys(tvs.launches, 0)}
    print(f"[suite] CLI --mode suite, {SUITE_CLOUDS} clouds x "
          f"{SUITE_POINTS} points, CD and EMD, seeds {seeds}: launches "
          f"{got} (expected {want}), wall {wall:.3f} s; "
          + ", ".join(f"{k} {out[k]['mean']:.4g} [{out[k]['min']:.4g}, "
                      f"{out[k]['max']:.4g}]" for m in ("cd", "emd")
                      for k in (f"mmd_{m}", f"cov_{m}", f"nna_{m}")))
    ok = got == want and out.get("n_clouds") == SUITE_CLOUDS \
        and len(out.get("per_seed", ())) == len(seeds)
    for m in ("cd", "emd"):
        for k, lo, hi in ((f"mmd_{m}", 0.0, math.inf), (f"cov_{m}", 0.0, 1.0),
                          (f"nna_{m}", 0.0, 1.0), (f"nna_{m}_se", 0.0, 1.0)):
            band = out.get(k, {})
            vals = [band.get(x, math.nan) for x in ("min", "mean", "max")]
            ok = ok and all(math.isfinite(v) and lo <= v <= hi
                            for v in vals) and vals == sorted(vals)
    if not ok:
        raise RuntimeError(f"suite: launches {got} or output {out}")
    return {"launches": got, "wall_s": wall}


def hybrid_train_cfg(**kw):
    """The hybrid bench configuration for training (the synthetic set's
    8 x 20 000 RGB points, latent 128, bf16, kernel trunk)."""
    return hybrid_cfg(warmup_steps=0, **kw)


def hybrid_train_cli(fb, tvs, torch):
    """Phase 17: the training CLI with the hybrid point flow at full
    width: one epoch of the synthetic set (8 steps), validation and a
    checkpoint, then a rerun that must find nothing to do.  Returns the
    launches per step and the peak memory."""
    from pcfm_torch.train import cli
    out_dir = os.path.join(RUN_DIR, "hybrid_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--pf_backbone", "hybrid", "--dataset_type", "synthetic",
            "--batch_size", str(B), "--tr_max_sample_points", str(N),
            "--te_max_sample_points", str(N), "--latent_dim", "128",
            "--fused_trunk", "on", "--epochs", "1", "--save_every", "1",
            "--warmup_steps", "0", "--sample_steps", str(TRAIN_SAMPLE_STEPS),
            "--num_workers", "2", "--out_dir", out_dir]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fb, tvs)
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"film_block": fb.launches, "film_block_bwd": fb.bwd_launches,
           **tvs.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    ckpt_path = os.path.join(out_dir, "ckpts", "hybrid_ep0001.pt")
    ck = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    steps = ck["global_step"]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    # a step: HYB_STEP_LAUNCHES.  Validation: recon and sample, Heun x
    # TRAIN_SAMPLE_STEPS (2 NFE a step), forward only
    val_nfe = 2 * 2 * TRAIN_SAMPLE_STEPS
    per_step = HYB_STEP_LAUNCHES
    val = {"film_block": FILM_BLOCKS * val_nfe, "film_block_bwd": 0,
           "voxel_gather": PVCONVS * val_nfe,
           "voxel_scatter": PVCONVS * val_nfe}
    want = {k: per_step[k] * steps + val[k] for k in per_step}
    bn = "ctx_net.stages.0.blocks.0.pvconv.voxel_layers.1"
    tracked = int(ck["pf"][f"{bn}.num_batches_tracked"])
    print(f"[hybrid-train] CLI 1 epoch at {B} x {N}: {steps} steps, "
          f"launches {got} (expected {want}: per step {per_step}, "
          f"validation {val}), BatchNorm updates {tracked}, losses "
          f"{rows[-1]}, wall {wall:.2f} s incl. data, validation and "
          f"checkpoint, peak device memory {peak:.3f} GiB")
    if (steps != 8 or got != want or not finite or tracked != steps
            or not os.path.isdir(os.path.join(out_dir, "samples_ep0001"))):
        raise RuntimeError("hybrid training CLI: wrong step or launch "
                           "count, non-finite loss or missing outputs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        again = cli.main(argv)
    print(f"[hybrid-train] rerun: "
          f"{buf.getvalue().strip().splitlines()[-1]}")
    if again != {"epochs_run": 0} or "Nothing to do" not in buf.getvalue():
        raise RuntimeError("hybrid training CLI rerun did not resume as "
                           "finished")
    return {"launches": got, "peak_gib": peak, "wall_s": wall}


def hybrid_train_state(torch):
    from pcfm_torch.train.state import init_state
    return init_state(hybrid_train_cfg(), DEVICE, STEPS_PER_EPOCH,
                      torch.Generator().manual_seed(SEED))


def hybrid_train_step_time(fb, tvs, torch):
    """Phase 18: the hybrid train step at bench.py's workload: ms/step on
    the host clock (3 x 10 steps after 3 warm-up steps), s/epoch, peak
    memory, and one torch.profiler run of 3 steps: device busy time, idle
    share, device time and launches by kernel group."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    state = hybrid_train_state(torch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):                                          # warm-up
        train_step(state, batch, gen, 1.0, 0.1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            m = train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
        if not math.isfinite(float(m["loss"])):
            raise RuntimeError(f"hybrid train step: loss {m}")
    ms = statistics.median(times)
    print(f"[hybrid-train] train step at {B} x {N} bf16: "
          f"{' '.join(f'{t:.3f}' for t in times)} ms/step (median {ms:.3f};"
          f" x {STEPS_PER_EPOCH} = {ms * STEPS_PER_EPOCH / 1e3:.3f} "
          f"s/epoch), peak device memory {peak:.3f} GiB")
    groups = {"film_block_bwd": ("film_block_bwd",),
              "film_block_fwd": ("film_block", "pack_w"),
              "voxel_gather": ("voxel_gather",),
              "voxel_scatter": ("voxel_scatter",),
              "conv3d_fwd": ("fprop",), "conv3d_dgrad": ("dgrad",),
              "conv3d_wgrad": ("wgrad",), "conv3d_other": ("conv", "cudnn"),
              "gemm": ("gemm", "cutlass", "splitkreduce"),
              "plan_searchsorted": ("searchsorted",), "plan_sort": ("sort",),
              "plan_cumsum": ("scan",), "reductions": ("reduce",)}
    reset_counts(fb, tvs)
    prof = profile_kernels(torch, lambda: train_step(state, batch, gen, 1.0,
                                                     0.1), 3, groups,
                           os.path.join(RUN_DIR, "hybrid_train_trace.json"))
    per_step = {k: v / prof["calls_run"] for k, v in (
        ("film_block", fb.launches), ("film_block_bwd", fb.bwd_launches),
        *tvs.launches.items())}
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    print(f"[hybrid-train] profiler, 3 steps: {prof['wall_ms']:.3f} ms/step "
          f"wall, {prof['busy_ms']:.3f} ms device busy (idle share "
          f"{idle:.3f}); wrapper launches per step {per_step} (expected "
          f"{HYB_STEP_LAUNCHES})")
    if per_step != HYB_STEP_LAUNCHES:
        raise RuntimeError("hybrid train step: wrong launch count")
    for group in groups:
        g_ms, g_n = prof[group]
        print(f"[hybrid-train]   {group}: {g_ms:.3f} ms/step device time, "
              f"{g_n} launches/step, {g_ms / prof['busy_ms']:.3f} of device "
              f"time ({'; '.join(prof[group + '_kernels'])[:300]})")
    for name, k_ms, k_n in prof["top"]:
        print(f"[hybrid-train]   {k_ms:9.3f} ms/step  {k_n:5d} x  {name}")
    del state
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "times": times, "peak_gib": peak,
            "profile": prof, "idle_share": idle,
            "launches_per_step": per_step}


def hybrid_determinism(torch):
    """Phase 19: two 3-step hybrid runs from the same seed and batch give
    bitwise-equal losses, parameters and running statistics (live and
    EMA)."""
    from pcfm_torch.train.step import train_step
    batch = train_batch(torch)
    results = []
    for _ in range(2):
        state = hybrid_train_state(torch)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        losses = [train_step(state, batch, gen, 1.0, 0.1)["loss"]
                  for _ in range(3)]
        tensors = {f"{k}/{n}": v.detach().clone()
                   for k, m in state.bundle.modules().items()
                   for n, v in (*m.named_parameters(), *m.named_buffers())}
        results.append((torch.stack(losses), tensors))
        del state
    (l1, t1), (l2, t2) = results
    differ = [k for k in t1 if not torch.equal(t1[k], t2[k])]
    same = torch.equal(l1, l2) and not differ
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in t1)
    print(f"[hybrid-train] determinism, 2 x 3 steps: losses {l1.tolist()} / "
          f"{l2.tolist()}; {len(t1)} tensors (parameters and buffers, live "
          f"and EMA; {n_stats} running statistics) bitwise equal: {same}"
          + (f"; differ: {differ[:8]}" if differ else ""))
    if not same:
        raise RuntimeError("hybrid train step is not bitwise reproducible")
    torch.cuda.empty_cache()


def grad_errors(got: dict, ref: dict) -> dict:
    """Loss, grad norm and every gradient of one step against another's:
    each error over the reference value's max."""
    (l_got, n_got, g_got), (l_ref, n_ref, g_ref) = got, ref
    rel = {k: ((g_got[k] - v).abs().max()
               / v.abs().max().clamp_min(1e-30)).item()
           for k, v in g_ref.items()}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    return {"loss_rel": abs(l_got - l_ref) / abs(l_ref),
            "norm_rel": abs(n_got - n_ref) / n_ref,
            "worst_rel": worst[0][1], "worst": worst[:4],
            "median_rel": statistics.median(rel.values()),
            "finite": set(g_got) == set(g_ref)
            and all(bool(v.isfinite().all()) for v in g_got.values())}


def hybrid_step_legs(torch) -> tuple:
    """Phase 20's inputs: the batch and its draws at HYB_E2E_POINTS, and
    the legs {name: (device, config, pinned, TF32, draws, launches)}."""
    from pcfm_torch.train.step import make_draws
    b, n = HYB_E2E_POINTS
    g = torch.Generator().manual_seed(SEED + 8)
    batch = {"pts": torch.randn(b, n, 3, generator=g) * 0.5,
             "rgb": torch.rand(b, n, 3, generator=g),
             "cond": torch.rand(b, 1, generator=g)}
    draws = make_draws(hybrid_train_cfg(), batch, g, 0.5)
    # the prior's xyz moved by one bf16 ulp (at the top of a binade)
    x0 = draws["x0"].clone()
    x0[..., :3] *= 1.0 + 2.0 ** -8
    moved = dict(draws, x0=x0)
    fp32 = {"amp": False, "ctx_dtype": "fp32"}
    plain_trunk = dict(fp32, fused_trunk="off")
    voxels = {k: HYB_STEP_LAUNCHES[k] for k in ("voxel_gather",
                                                "voxel_scatter")}
    legs = {"cpu_fp32": ("cpu", fp32, False, False, draws, {}),
            "cpu_bf16": ("cpu", {}, True, False, draws, {}),
            "cpu_bf16_moved": ("cpu", {}, True, False, moved, {}),
            "bf16": (DEVICE, {}, False, False, draws, HYB_STEP_LAUNCHES),
            "bf16_pinned": (DEVICE, {}, True, False, draws,
                            HYB_STEP_LAUNCHES),
            "fp32_plain_trunk": (DEVICE, plain_trunk, False, False, draws,
                                 voxels),
            "fp32_plain_trunk_pinned": (DEVICE, plain_trunk, True, False,
                                        draws, voxels),
            "fp32_plain_trunk_pinned_tf32": (DEVICE, plain_trunk, True,
                                             True, draws, voxels)}
    return batch, legs


def run_hybrid_step_legs(fb, tvs, torch, names, out: dict,
                         rec: dict) -> None:
    """Phase 20's legs ``names`` into ``out`` (loss, grad norm, gradients)
    and ``rec`` (their kinks; the pinned legs replay rec["cpu_fp32"])."""
    from pcfm_torch import kinks
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import clip_by_global_norm_, init_state
    from pcfm_torch.train.step import compute_loss
    b, n = HYB_E2E_POINTS
    path, _ = checkpoint.find_latest(HYB_DIR)
    batch, legs = hybrid_step_legs(torch)
    for leg in names:
        dev, over, pinned, tf32, dr, want = legs[leg]
        t0 = time.perf_counter()
        state = init_state(hybrid_train_cfg(**over), dev, 1,
                           torch.Generator().manual_seed(SEED))
        with contextlib.redirect_stdout(io.StringIO()):
            checkpoint.restore_tolerant(path, state)
        before = {"film_block": fb.launches,
                  "film_block_bwd": fb.bwd_launches, **tvs.launches}
        rec[leg] = kinks.Kinks()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with (kinks.replay(rec["cpu_fp32"]) if pinned
                  else kinks.record(rec[leg])):
                loss, _ = compute_loss(
                    state.bundle, {k: v.to(dev) for k, v in batch.items()},
                    {k: v.to(dev) for k, v in dr.items()}, 1.0)
            loss.backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        params = [(f"{gname}/{name}", p) for gname in ("enc", "pf", "lf")
                  for name, p in getattr(state.bundle, gname)
                  .named_parameters() if p.grad is not None]
        gnorm = clip_by_global_norm_([p.grad for _, p in params], 0.0)
        launched = {k: v - before[k] for k, v in (
            ("film_block", fb.launches), ("film_block_bwd", fb.bwd_launches),
            *tvs.launches.items())}
        if launched != dict(dict.fromkeys(launched, 0), **want):
            raise RuntimeError(f"hybrid step, {leg}: launches {launched}, "
                               f"expected {want}")
        out[leg] = (float(loss.detach()), float(gnorm),
                    {k: p.grad.float().cpu() for k, p in params})
        del state, params, loss
        print(f"[hybrid-train] step {leg} at ({b}, {n}): "
              f"{time.perf_counter() - t0:.1f} s"
              + ("" if pinned else f", kinks {rec[leg].counts()}"),
              flush=True)


def hybrid_grads_card_vs_cpu(fb, tvs, torch, cpu=None):
    """Phase 20: one hybrid step at HYB_E2E_POINTS from phase 11's
    checkpoint and the same draws, on the CPU (plain versions) and on the
    card through the kernels.  The CPU's fp32 step records its choices at
    the kinks (pcfm_torch.kinks); the pinned steps replay them, so that
    only rounding separates them: the card's bf16 step (the main path)
    against the CPU's bf16 step (HYB_GRAD_REL_TOL_BF16) and fp32 step
    (HYB_GRAD_REL_TOL), and the card's fp32 step with the plain trunk (the
    voxel kernels its only kernels) against the CPU's fp32 step
    (HYB_GRAD_REL_TOL_FP32); each bound's control must exceed it.  Every
    card step's loss and grad norm within HYB_LOSS_REL_TOL.  Printed: the
    CPU's bf16 step with the prior's xyz moved by one bf16 ulp against its
    own (what a bf16 change of the input does), and the unpinned card
    steps with their flips against the CPU's choices.  The CPU legs come
    from ``cpu`` (a CpuLegs child started after phase 11) or a child
    started here."""
    from pcfm_torch import kinks
    b, n = HYB_E2E_POINTS
    _, legs = hybrid_step_legs(torch)
    out, rec = (cpu or CpuLegs(torch, "hybrid_train")).result()
    run_hybrid_step_legs(fb, tvs, torch,
                         [k for k in legs if not k.startswith("cpu_")],
                         out, rec)
    torch.cuda.empty_cache()
    # (leg, reference leg, bound, control: (leg, reference leg))
    checks = (("bf16_pinned", "cpu_bf16", HYB_GRAD_REL_TOL_BF16,
               ("bf16_pinned", "cpu_fp32")),
              ("bf16_pinned", "cpu_fp32", HYB_GRAD_REL_TOL,
               ("bf16", "cpu_fp32")),
              ("fp32_plain_trunk_pinned", "cpu_fp32", HYB_GRAD_REL_TOL_FP32,
               ("fp32_plain_trunk_pinned_tf32", "cpu_fp32")),
              ("cpu_bf16_moved", "cpu_bf16", None, None),
              ("bf16", "cpu_fp32", None, None),
              ("fp32_plain_trunk", "cpu_fp32", None, None))
    res, ok = {}, all(grad_errors(out[leg], out["cpu_fp32"])["finite"]
                      for leg in out)
    for leg, ref, tol, control in checks:
        e = res[f"{leg}_vs_{ref}"] = grad_errors(out[leg], out[ref])
        card = legs[leg][0] != "cpu"
        flips = ("; flips against the CPU's choices (elements, of) "
                 + str(kinks.flips(rec["cpu_fp32"], rec[leg]))
                 if rec[leg].sites else "")
        line = (f"[hybrid-train] {'card ' * card}{leg} vs {ref}, one step "
                f"at ({b}, {n}): loss rel {e['loss_rel']:.3g}, grad norm rel "
                f"{e['norm_rel']:.3g}; {len(out[ref][2])} gradients, max "
                f"abs err / max |grad|: worst {e['worst_rel']:.4g}, median "
                f"{e['median_rel']:.3g}")
        if card:
            ok = ok and max(e["loss_rel"], e["norm_rel"]) <= HYB_LOSS_REL_TOL
        line += " (printed)" if tol is None else f" (bound {tol})"
        ok = ok and (tol is None or e["worst_rel"] <= tol)
        if control is not None:
            c = res[f"{control[0]}_vs_{control[1]}"] = grad_errors(
                out[control[0]], out[control[1]])
            line += (f"; control {control[0]} vs {control[1]}: worst "
                     f"{c['worst_rel']:.4g}, median {c['median_rel']:.3g} "
                     f"(must exceed {tol})")
            ok = ok and c["worst_rel"] > tol
        print(line + "; worst: " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in e["worst"]) + flips)
    if not ok:
        raise RuntimeError("hybrid step: card and CPU disagree, or a "
                           "control is within its bound")
    return res


def distill_step_launches(kind: str) -> dict:
    """Wrapper launches of one distill step: the teacher's evaluations
    and the student's forward, each FILM_BLOCKS forward blocks (and, for
    the hybrid, one scatter and one gather a PVConv), and the student's
    backward (FILM_BLOCKS backward blocks; a gather and a scatter a
    PVConv)."""
    evals = DISTILL_TEACHER_EVALS + 1
    voxel = PVCONVS * (evals + 1) if kind == "hybrid" else 0
    return {"film_block": FILM_BLOCKS * evals, "film_block_bwd": FILM_BLOCKS,
            "voxel_gather": voxel, "voxel_scatter": voxel}


def counts(fb, tvs) -> dict:
    return {"film_block": fb.launches, "film_block_bwd": fb.bwd_launches,
            **tvs.launches}


def write_distill_input(torch, kind: str) -> str:
    """The input of phase 21 (mlp, phase 3's checkpoint) or 22 (hybrid,
    phase 11's, its running statistics moved): the bench configuration at
    full width with random weights from the seed, on the synthetic set
    (where the CLI finds its batches) and with the run's guidance 0.25."""
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    out_dir = os.path.join(RUN_DIR, f"distill_{kind}")
    kw = dict(dataset_type="synthetic", guidance_scale=DISTILL_GUIDANCE)
    if kind == "hybrid":
        write_hybrid_checkpoint(torch, out_dir, moved_stats=True, **kw)
        return out_dir
    shutil.rmtree(out_dir, ignore_errors=True)
    bundle = ModelBundle(bench_cfg(**kw), DEVICE,
                         torch.Generator().manual_seed(SEED))
    path = checkpoint.save(out_dir, 1, bundle)
    print(f"[distill-mlp] wrote {os.path.relpath(path, ROOT)}")
    return out_dir


def running_stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def distill_cli_full_width(fb, tvs, torch, np, kind: str, heun_ms=None):
    """Phase 21 (mlp) / 22 (hybrid): the distill CLI at full width, guided
    (the run's 0.25: 2B teacher calls) and with --guidance_scale 0 (cond
    dropout), exact launches, finite losses, the saved config, the hybrid's
    frozen statistics; then the sampling CLI on the distilled run (Euler x
    12) and its ms/shape; then the distill step's ms/step, peak memory,
    idle share and the kernels' share from one profile."""
    from pcfm_torch.distill import cli as dcli
    from pcfm_torch.sample import cli as scli
    from pcfm_torch.train import checkpoint
    t_phase = time.perf_counter()
    tag = f"[distill-{kind}]"
    src = write_distill_input(torch, kind)
    src_ck = torch.load(checkpoint.find_latest(src)[0], map_location="cpu",
                        weights_only=True)
    per_step = distill_step_launches(kind)
    n_steps = DISTILL_PHASES * DISTILL_STEPS_PER_PHASE
    want = {k: v * n_steps for k, v in per_step.items()}
    out = {}
    for name, extra, want_g in (
            ("guided", [], 0.0),
            ("unguided", ["--guidance_scale", "0"], DISTILL_GUIDANCE)):
        save = f"{src}_{name}"
        shutil.rmtree(save, ignore_errors=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fb, tvs)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, steps = dcli.main(
                ["--out_dir", src, "--save_dir", save, "--phases",
                 str(DISTILL_PHASES), "--steps_per_phase",
                 str(DISTILL_STEPS_PER_PHASE), "--device", DEVICE, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts(fb, tvs)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log = buf.getvalue()
        losses = [float(x) for x in re.findall(r"final loss (\S+)", log)]
        ck = torch.load(checkpoint.find_latest(save)[0], map_location="cpu",
                        weights_only=True)
        args = ck["args"]
        stats_ok = all(
            torch.equal(ck[key][k], v)
            for key in ("pf", "ema_pf")
            for k, v in running_stats(src_ck["ema_pf"]).items())
        moved = kind == "mlp" or any(
            not torch.equal(src_ck["pf"][k], v)
            for k, v in running_stats(src_ck["ema_pf"]).items())
        print(f"{tag} CLI {name} at {B} x {N}, {DISTILL_PHASES} phases x "
              f"{DISTILL_STEPS_PER_PHASE} steps: launches {got} (expected "
              f"{want}: {per_step} a step), losses {losses}, saved "
              f"{args['sampler']} x {args['sample_steps']} guidance "
              f"{args['guidance_scale']}, running statistics of the "
              f"distilled pf and EMA = the input's EMA's: {stats_ok} "
              f"({len(running_stats(src_ck['ema_pf']))} tensors), wall "
              f"{wall:.2f} s incl. load, data and save, peak device memory "
              f"{peak:.3f} GiB")
        for line in log.strip().splitlines():
            print(f"{tag}   {line}")
        if (got != want or len(losses) != DISTILL_PHASES
                or not all(math.isfinite(v) for v in losses)
                or steps != DISTILL_EULER_STEPS
                or args["sampler"] != "euler"
                or args["sample_steps"] != DISTILL_EULER_STEPS
                or args["guidance_scale"] != want_g
                or not stats_ok or not moved):
            raise RuntimeError(f"distill CLI ({kind}, {name}): launches, "
                               "losses, saved config or statistics wrong")
        out[name] = {"launches": got, "losses": losses, "wall_s": wall,
                     "peak_gib": peak}

    # the sampling CLI on the distilled run
    save = f"{src}_guided"
    want = {"film_block": FILM_BLOCKS * DISTILL_EULER_STEPS,
            "film_block_bwd": 0,
            **dict.fromkeys(tvs.launches, PVCONVS * DISTILL_EULER_STEPS
                            if kind == "hybrid" else 0)}
    reset_counts(fb, tvs)
    with contextlib.redirect_stdout(io.StringIO()):
        x = scli.main(["--out_dir", save, "--save_dir",
                       os.path.join(save, "generated"), "--num_samples",
                       str(B), "--n_points", str(N), "--seed", str(SEED),
                       "--device", DEVICE])
    got = counts(fb, tvs)
    print(f"{tag} sampling CLI on the distilled run: launches {got} "
          f"(expected {want}), clouds {x.shape}, finite "
          f"{bool(np.isfinite(x).all())}")
    if got != want or x.shape != (B, N, 6) or not np.isfinite(x).all():
        raise RuntimeError(f"sampling the distilled {kind} run: launches "
                           "or output wrong")
    out["euler_ms_per_shape"] = euler_ms_per_shape(torch, save, tag, heun_ms)
    out["step"] = distill_step_time(fb, tvs, torch, kind, src)
    print(f"{tag} phase {21 if kind == 'mlp' else 22}: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def euler_ms_per_shape(torch, run_dir: str, tag: str, heun_ms) -> float:
    """The distilled run's sampler (Euler x 12) ms/shape: 3 runs after a
    warm-up, beside the teacher's Heun x 50 (phases 4 / 12)."""
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train.evaluate import make_sample_fn
    _, bundle, _ = load_run(run_dir, None, DEVICE)
    sample = make_sample_fn(bundle)
    times = []
    for _ in range(4):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(None, gen, B, N)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / B)
    ms = statistics.median(times[1:])
    print(f"{tag} Euler x{DISTILL_EULER_STEPS} at {B} x {N}: "
          f"{' '.join(f'{t:.2f}' for t in times)} ms/shape (first is "
          f"warm-up; median {ms:.2f}); the teacher's Heun x50: "
          + (f"{heun_ms:.2f} ms/shape" if heun_ms else "not run here"))
    del bundle
    torch.cuda.empty_cache()
    return ms


def distill_step_time(fb, tvs, torch, kind: str, src: str, over=None,
                      label: str = "") -> dict:
    """The distill step of phase 0 (guided, N_p = 25) at bench.py's
    workload: ms/step on the host clock (3 x 5 steps after 2 warm-up
    steps), peak memory, and one torch.profiler run of 3 steps: launches
    per step, device busy time, idle share, the kernels' share.  ``over``:
    changes to the run's Config; ``label``: the tag, if not ``kind``."""
    import copy

    from pcfm_torch.distill.progressive import (init_distill_state,
                                                make_distill_step)
    from pcfm_torch.sample.cli import load_run
    label = label or kind
    tag = f"[distill-{label}]"
    cfg, bundle, _ = load_run(src, over, DEVICE)
    batch = train_batch(torch)
    dstate = init_distill_state(copy.deepcopy(bundle.ema_pf), 1e-4)
    dstep = make_distill_step(bundle, cfg.sample_steps // 2,
                              guidance_scale=cfg.guidance_scale)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def run():
        return dstep(bundle.ema_pf, dstate, batch, gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            m = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / 5)
        if not math.isfinite(float(m["loss_distill"])):
            raise RuntimeError(f"{kind} distill step: loss {m}")
    ms = statistics.median(times)
    groups = {"film_block_bwd": ("film_block_bwd",),
              "film_block_fwd": ("film_block", "pack_w"),
              "voxel_gather": ("voxel_gather",),
              "voxel_scatter": ("voxel_scatter",)}
    reset_counts(fb, tvs)
    prof = profile_kernels(torch, run, 3, groups,
                           os.path.join(RUN_DIR, f"distill_{label}_trace.json"))
    per_step = {k: v / prof["calls_run"] for k, v in counts(fb, tvs).items()}
    idle = 1 - prof["busy_ms"] / prof["wall_ms"]
    ours = sum(prof[g][0] for g in groups)
    print(f"{tag} distill step (phase 0, N_p {cfg.sample_steps // 2}, "
          f"guidance {cfg.guidance_scale}) at {B} x {N} bf16: "
          f"{' '.join(f'{t:.3f}' for t in times)} ms/step (median "
          f"{ms:.3f}), peak device memory {peak:.3f} GiB; profiler, 3 "
          f"steps: {prof['wall_ms']:.3f} ms/step wall, {prof['busy_ms']:.3f}"
          f" ms device busy (idle share {idle:.3f}); the kernels "
          f"{ours:.3f} ms = {ours / prof['busy_ms']:.3f} of device time; "
          f"wrapper launches per step {per_step} (expected "
          f"{distill_step_launches(kind)})")
    for group in groups:
        g_ms, g_n = prof[group]
        print(f"{tag}   {group}: {g_ms:.3f} ms/step device time, {g_n} "
              f"launches/step, {g_ms / prof['busy_ms']:.3f} of device time")
    for name, k_ms, k_n in prof["top"]:
        print(f"{tag}   {k_ms:9.3f} ms/step  {k_n:5d} x  {name}")
    if per_step != distill_step_launches(kind):
        raise RuntimeError(f"{kind} distill step: wrong launch count")
    del dstate, bundle
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "times": times, "peak_gib": peak,
            "busy_ms": prof["busy_ms"], "idle_share": idle,
            "kernel_share": ours / prof["busy_ms"],
            "launches_per_step": per_step,
            "profiled_ms": {g: prof[g][0] for g in groups}}


def check_legs(tag: str, what: str, points, out: dict, checks) -> tuple:
    """Each check (leg, reference leg, bound, control: (leg, reference
    leg)[, control required]) of the card's steps against the CPU's:
    every leg's gradients finite, the leg's worst gradient error over the
    reference's max within the bound, the control's beyond it where it is
    required, both losses within DISTILL_LOSS_REL_TOL; each printed.
    Returns ({name: grad_errors}, all held)."""
    b, n = points
    res, ok = {}, all(grad_errors(out[leg], out["cpu_fp32"])["finite"]
                      for leg in out)
    for leg, ref, tol, control, *required in checks:
        must = not required or required[0]
        e = res[f"{leg}_vs_{ref}"] = grad_errors(out[leg], out[ref])
        c = res[f"{control[0]}_vs_{control[1]}"] = grad_errors(
            out[control[0]], out[control[1]])
        ok = (ok and e["worst_rel"] <= tol
              and (c["worst_rel"] > tol or not must)
              and max(e["loss_rel"], c["loss_rel"]) <= DISTILL_LOSS_REL_TOL)
        print(f"{tag} card {leg} vs {ref}, one {what} at ({b}, {n}): "
              f"loss rel {e['loss_rel']:.3g}, grad norm rel "
              f"{e['norm_rel']:.3g}; {len(out[ref][2])} gradients, max abs "
              f"err / max |grad|: worst {e['worst_rel']:.4g}, median "
              f"{e['median_rel']:.3g} (bound {tol}); control {control[0]} "
              f"vs {control[1]}: worst {c['worst_rel']:.4g}, median "
              f"{c['median_rel']:.3g} ("
              + (f"must exceed {tol}" if must else "printed") + "); worst: "
              + ", ".join(f"{k} {v:.3g}" for k, v in e["worst"]))
    return res, ok


def distill_card_vs_cpu(fb, tvs, torch, kind: str, src: str = "",
                        points=HYB_E2E_POINTS, label: str = "",
                        mlp_checks=None, cpu=None, legs_only=None):
    """Phase 23, first part: one distill step (phase 0: guided, N_p 25)
    at HYB_E2E_POINTS from phase 21's or 22's input and the same draws, on
    the CPU (plain versions) and on the card (kernels); each gradient's
    error over the CPU value's max.  mlp: the card's bf16 step against
    the CPU's bf16 step and the card's fp32 step (fp32 inputs to the
    kernels) against the CPU's fp32 step, each bound's control the card's
    bf16 step against the CPU's fp32 step.  hybrid: as phase 20, the pinned
    legs replaying the CPU fp32 step's choices at the kinks.  ``src``,
    ``points``, ``label``, ``mlp_checks``: another input run, another
    (clouds, points), the tag and the mlp's (leg, reference, bound,
    control, control required) checks, if not phase 23's.  ``cpu``: the
    CPU legs' (out, rec), computed by a CpuLegs child beside the card's
    phases.  ``legs_only``: run only those legs and return (out, rec)
    (what the child does)."""
    import copy

    from pcfm_torch import kinks
    from pcfm_torch.distill.progressive import (init_distill_state,
                                                make_distill_draws,
                                                make_distill_step)
    from pcfm_torch.sample.cli import load_run
    tag = f"[distill-{label or kind}]"
    b, n = points
    src = src or os.path.join(RUN_DIR, f"distill_{kind}")
    g = torch.Generator().manual_seed(SEED + 9)
    batch = {"pts": torch.randn(b, n, 3, generator=g) * 0.5,
             "rgb": torch.rand(b, n, 3, generator=g),
             "cond": torch.rand(b, 1, generator=g)}
    n_p = bench_cfg().sample_steps // 2
    draws = make_distill_draws(bench_cfg(), batch, g, n_p, 0.0)
    fp32 = {"amp": False, "ctx_dtype": "fp32"}
    full = distill_step_launches(kind)
    voxels = dict(full, film_block=0, film_block_bwd=0)
    none = dict.fromkeys(full, 0)
    if kind == "mlp":
        # leg: (device, overrides, pinned, TF32, launches)
        legs = {"cpu_fp32": ("cpu", fp32, False, False, none),
                "cpu_bf16": ("cpu", {}, False, False, none),
                "bf16": (DEVICE, {}, False, False, full),
                "fp32": (DEVICE, fp32, False, False, full)}
        checks = mlp_checks or (
            ("bf16", "cpu_bf16", MLP_DISTILL_GRAD_REL_TOL_BF16,
             ("bf16", "cpu_fp32")),
            ("fp32", "cpu_fp32", MLP_DISTILL_GRAD_REL_TOL_FP32,
             ("bf16", "cpu_fp32")))
    else:
        plain = dict(fp32, fused_trunk="off")
        legs = {"cpu_fp32": ("cpu", fp32, False, False, none),
                "cpu_bf16": ("cpu", {}, True, False, none),
                "bf16": (DEVICE, {}, False, False, full),
                "bf16_pinned": (DEVICE, {}, True, False, full),
                "fp32_plain_trunk_pinned": (DEVICE, plain, True, False,
                                            voxels),
                "fp32_plain_trunk_pinned_tf32": (DEVICE, plain, True, True,
                                                 voxels)}
        # the hybrid's legs reuse phase 20's bounds, each with phase 20's
        # control
        checks = (("bf16_pinned", "cpu_bf16", HYB_GRAD_REL_TOL_BF16,
                   ("bf16_pinned", "cpu_fp32")),
                  ("bf16_pinned", "cpu_fp32", HYB_GRAD_REL_TOL,
                   ("bf16", "cpu_fp32")),
                  ("fp32_plain_trunk_pinned", "cpu_fp32",
                   HYB_GRAD_REL_TOL_FP32,
                   ("fp32_plain_trunk_pinned_tf32", "cpu_fp32")))
    out, rec = cpu if cpu is not None else ({}, {})
    names = legs_only or [k for k in legs if k not in out]
    for leg in names:
        dev, over, pinned, tf32, want = legs[leg]
        t0 = time.perf_counter()
        _, bundle, _ = load_run(src, over, dev)
        dstate = init_distill_state(copy.deepcopy(bundle.ema_pf), 1e-4)
        dstep = make_distill_step(bundle, n_p,
                                  guidance_scale=DISTILL_GUIDANCE)
        before = counts(fb, tvs)
        rec[leg] = kinks.Kinks()
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with (kinks.replay(rec["cpu_fp32"]) if pinned
                  else kinks.record(rec[leg])):
                m = dstep(bundle.ema_pf, dstate,
                          {k: v.to(dev) for k, v in batch.items()},
                          draws={k: v.to(dev) for k, v in draws.items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        launched = {k: v - before[k] for k, v in counts(fb, tvs).items()}
        if launched != want:
            raise RuntimeError(f"{kind} distill step, {leg}: launches "
                               f"{launched}, expected {want}")
        grads = {name: p.grad.float().cpu()
                 for name, p in dstate.params.named_parameters()
                 if p.grad is not None}
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in grads.values()]))
        out[leg] = (float(m["loss_distill"]), float(gnorm), grads)
        del bundle, dstate
        print(f"{tag} step {leg} at ({b}, {n}): "
              f"{time.perf_counter() - t0:.1f} s"
              + ("" if pinned else f", kinks {rec[leg].counts()}"),
              flush=True)
    if legs_only:
        return out, rec
    torch.cuda.empty_cache()
    res, ok = check_legs(tag, "distill step", points, out, checks)
    if kind == "hybrid" and rec["bf16"].sites:
        print(f"{tag} unpinned card bf16 step: flips against the CPU's "
              f"choices (elements, of) "
              f"{kinks.flips(rec['cpu_fp32'], rec['bf16'])}")
    if not ok:
        raise RuntimeError(f"{kind} distill step: card and CPU disagree, "
                           "or a control is within its bound")
    return res


def train_knobs_full_width(fb, tvs, torch):
    """Phase 23, second part: one full-width mlp train step (8 x 20 000,
    bf16, kernel trunk) with each opt-in option: sliced-OT coupling and
    the adversary (lambda_adv 0.1, cond_dim 1) at bench.py's workload, the
    endpoint EMD (lambda_emd 0.1) at the largest multiple of 1024 points a
    cloud at which its EMD_DENSE_MATRICES (B, N, N) fp32 matrices fit in
    80 % of the free memory; exact FiLM launches, finite losses, ms/step
    after a warm-up step, peak memory.  Then the distill step at pf_width
    1024 with the kernel trunk (the backward's wide path) against the CPU
    (``wide_distill_card_vs_cpu``)."""
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import train_step
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    n_emd = min(N, int(math.sqrt(0.8 * free / (EMD_DENSE_MATRICES * B * 4)))
                // 1024 * 1024)
    if n_emd < 1:
        raise RuntimeError(f"the dense EMD does not fit: {free} bytes free")
    out = {}
    for name, kw, n in (("sliced_ot", {"fm_coupling": "sliced_ot"}, N),
                        ("adv", {"lambda_adv": 0.1}, N),
                        ("emd", {"lambda_emd": 0.1}, n_emd)):
        state = init_state(bench_cfg(tr_max_sample_points=n, **kw), DEVICE,
                           STEPS_PER_EPOCH,
                           torch.Generator().manual_seed(SEED))
        batch = {k: v[:, :n] if v.dim() == 3 else v
                 for k, v in train_batch(torch).items()}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        train_step(state, batch, gen, 1.0, 0.1)                 # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fb, tvs)
        t0 = time.perf_counter()
        m = train_step(state, batch, gen, 1.0, 0.1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = counts(fb, tvs)
        want = dict(HYB_STEP_LAUNCHES, voxel_gather=0, voxel_scatter=0)
        losses = {k: float(v) for k, v in m.items()}
        print(f"[knobs] mlp train step with {name} at ({B}, {n}) bf16: "
              f"{ms:.3f} ms (one step after a warm-up), peak device memory "
              f"{peak:.3f} GiB, launches {got}, losses {losses}")
        key = {"emd": "loss_emd", "adv": "loss_adv"}.get(name, "loss")
        if got != want or not all(math.isfinite(v) for v in losses.values()) \
                or key not in losses:
            raise RuntimeError(f"train step with {name}: launches or loss")
        out[name] = {"ms": ms, "peak_gib": peak, "points": n}
        del state
        torch.cuda.empty_cache()
    print(f"[knobs] the endpoint EMD's step ran at {n_emd} points a cloud "
          f"(free memory {free / 2**30:.1f} GiB before the steps)")
    out["wide_distill"] = wide_distill_card_vs_cpu(fb, tvs, torch)
    torch.cuda.empty_cache()
    return out


def wide_distill_card_vs_cpu(fb, tvs, torch) -> dict:
    """Phase 23's last part (also in ``--only wide``): one distill step at
    pf_width WIDE_PF_WIDTH with the kernel trunk, so the backward's wide
    path, at WIDE_DISTILL_POINTS, on the card and on the CPU from a
    random-weight checkpoint of the bench configuration at that width:
    phase 23's mlp legs (exact launches, finite loss), the fp32 step
    within WIDE_DISTILL_GRAD_REL_TOL_FP32 of the CPU's and its control
    beyond it, the bf16 step within phase 23's bound of the CPU's bf16
    step, its control printed."""
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    src = os.path.join(RUN_DIR, "distill_wide")
    shutil.rmtree(src, ignore_errors=True)
    checkpoint.save(src, 1, ModelBundle(
        bench_cfg(pf_width=WIDE_PF_WIDTH, dataset_type="synthetic"),
        DEVICE, torch.Generator().manual_seed(SEED)))
    checks = (("bf16", "cpu_bf16", MLP_DISTILL_GRAD_REL_TOL_BF16,
               ("bf16", "cpu_fp32"), False),
              ("fp32", "cpu_fp32", WIDE_DISTILL_GRAD_REL_TOL_FP32,
               ("bf16", "cpu_fp32")))
    res = distill_card_vs_cpu(fb, tvs, torch, "mlp", src, WIDE_DISTILL_POINTS,
                              f"wide-{WIDE_PF_WIDTH}", checks)
    return {k: {"worst": e["worst_rel"], "median": e["median_rel"]}
            for k, e in res.items()}


def format_parts(parts: dict) -> str:
    return " / ".join(f"{v:.4f}" for v in parts.values()) + " ms a call"


def wide_kernels_vs_plain(fb, torch, build_log: str) -> dict:
    """Phase 26: the FiLM-block kernels at the widths of their wide paths
    (forward C > NARROW_C, backward C > NARROW_C_BWD) against their plain
    versions: at (8, 20 000, C) bf16 for every C of WIDE_CS and the edges
    (N = 1, 129, 300 at each C of WIDE_EDGE_CS bf16; fp32 inputs at each C
    of WIDE_F32_CS), the forward within KERNEL_TOL and every backward
    gradient within GRAD_REL_TOL of its max, two launches bitwise equal;
    fp32 with W = 0 within FP32_DY_TOL; the clusters of the backward's
    cluster kernel that the card holds at once above 2048; then for each
    C of WIDE_TIMED_CS CUDA-event times of both kernels, their plain
    versions and torch.matmul of each product alone (yardsticks the port
    never calls), beside the bounds, one profile of each kernel's parts,
    the backward's workspace bytes and its clusters at once; the wide
    forward's ptxas report (``build_log``) and launch."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    fwd_err, bwd_abs, bwd_rel = 0.0, 0.0, 0.0
    cases = [(B, N, c, torch.bfloat16) for c in WIDE_CS]
    cases += [(B, n, c, torch.bfloat16) for c in WIDE_EDGE_CS
              for n in (1, 129, 300)]
    cases += [(B, n, c, torch.float32) for c in WIDE_F32_CS
              for n in (129, 300)]
    for bsz, n, c, dtype in cases:
        fwd_err = max(fwd_err, check_forward(
            fb, torch, film_inputs(torch, g, bsz, n, c, dtype)))
        e_abs, e_rel = check_backward(
            fb, torch, backward_inputs(fb, torch, g, bsz, n, c, dtype))
        bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
        torch.cuda.empty_cache()
    # the forward alone above 2048 (its statistics kernel's wider
    # instantiation), to each dtype's own limit
    fcases = [(B, N, c, torch.bfloat16) for c in WIDE_FWD_CS]
    fcases += [(B, N, c, torch.float32) for c in WIDE_FWD_F32_CS]
    fcases += [(B, n, fb.MAX_C_BF16, torch.bfloat16) for n in (1, 129, 300)]
    fcases += [(B, n, fb.MAX_C_F32, torch.float32) for n in (1, 129, 300)]
    for bsz, n, c, dtype in fcases:
        fwd_err = max(fwd_err, check_forward(
            fb, torch, film_inputs(torch, g, bsz, n, c, dtype)))
        torch.cuda.empty_cache()
    out = {"fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_abs,
           "bwd_max_err_over_grad_max": bwd_rel,
           "fp32_dy_err_over_grad_max": check_backward_fp32_dy(
               fb, torch, g, [(2, 300, c) for c in WIDE_F32_CS]
               + [(B, 1000, 1024)]),
           "bwd_clusters": {}}
    # the backward's clusters above the portable size of 8 CTAs
    for c in WIDE_CS:
        if c > 2048:
            ctas = len(fb.cluster_split(c))
            held = {dt: fb.bwd_max_clusters(c, dt == "bf16",
                                            torch.cuda.current_device())
                    for dt in ("bf16", "fp32")}
            print(f"[wide] film_block backward at C = {c}: {ctas} CTAs a "
                  f"cluster (non-portable), clusters at once: bf16 "
                  f"{held['bf16']}, fp32 {held['fp32']} ({ctas * held['bf16']}"
                  f" of {torch.cuda.get_device_properties(0).multi_processor_count}"
                  f" SMs in bf16)")
            out["bwd_clusters"][c] = {"ctas": ctas, **held}
    for c in WIDE_TIMED_CS:
        args = film_inputs(torch, g, B, N, c, torch.bfloat16)
        bargs = backward_inputs(fb, torch, g, B, N, c, torch.bfloat16)
        a2d = args[0].reshape(-1, c)
        wt = args[5].T.contiguous().bfloat16()
        dy2d = bargs[0].reshape(-1, c)
        w16 = bargs[6].bfloat16()
        p2d = torch.nn.functional.silu(bargs[1].float()).bfloat16() \
            .reshape(-1, c)
        tf = timed_turns({"kernel": lambda: fb.film_block_forward(*args),
                          "plain": lambda: fb.film_block_reference(*args),
                          "gemm": lambda: torch.matmul(a2d, wt)},
                         rounds=2, reps={"kernel": 10, "plain": 3,
                                         "gemm": 10})
        tb = timed_turns({
            "kernel": lambda: fb.film_block_backward(*bargs),
            "plain": lambda: fb.film_block_reference_backward(*bargs),
            "gemm_dp": lambda: torch.matmul(dy2d, w16),
            "gemm_dw": lambda: torch.matmul(dy2d.T, p2d)},
            rounds=2, reps={"kernel": 5, "plain": 2, "gemm_dp": 10,
                            "gemm_dw": 10})
        fprof = profile_kernels(
            torch, lambda: fb.film_block_forward(*args), 3,
            {"pack": ("pack_w",), "stats": ("wide_stats",),
             "product": ("film_block_fwd",)},
            os.path.join(RUN_DIR, f"wide_forward_c{c}_trace.json"))
        btrace = os.path.join(RUN_DIR, f"wide_backward_c{c}_trace.json")
        bprof = profile_kernels(
            torch, lambda: fb.film_block_backward(*bargs), 3,
            {"pack": ("bwd_pack", "wide_pack"), "cluster": ("cluster",),
             "dw": ("bwd_dw",), "reduce": ("bwd_sum", "bwd_finalize")},
            btrace)
        overlap = kernel_overlap_ms(btrace, ("cluster",), ("bwd_dw",),
                                    bprof["calls_run"])
        bounds = film_bounds(B, N, c)
        fpath = "wide" if c > fb.NARROW_C else "one-kernel"
        bpath = "wide" if c > fb.NARROW_C_BWD else "register"
        fparts = {g: fprof[g][0] for g in ("pack", "stats", "product")}
        bparts = {g: bprof[g][0] for g in ("pack", "cluster", "dw",
                                           "reduce")}
        work = fb._lib().pcfm_film_block_bwd_workspace(B, N, c) * 4
        clusters = fb.bwd_max_clusters(c, True, torch.cuda.current_device())
        plan = fb.bwd_plan_of_kernel(B, N, c)
        if plan != fb.bwd_plan(B, N, c):
            raise RuntimeError(f"backward plan at C = {c}: the kernel's "
                               f"{plan}, bwd_plan's {fb.bwd_plan(B, N, c)}")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sbound = stats_bound_ms(B, N, c)
        stats_share = (f"; the statistics kernel's bound {sbound:.4f} ms "
                       f"(bytes), {sbound / fparts['stats']:.0%} of its time"
                       if c > fb.NARROW_C and fparts["stats"] else "")
        print(f"[wide] film_block forward ({B}, {N}, {c}) bf16 ({fpath} "
              f"path): kernel {tf['kernel']:.4f} ms, bound "
              f"{bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}), plain fp32 "
              f"{tf['plain']:.4f} ms, torch.matmul ({B * N}, {c}) x ({c}, "
              f"{c}) bf16 alone {tf['gemm']:.4f} ms (medians of 4 timings "
              f"in turns); profiled, 3 calls (W pack, statistics and "
              f"silu(f) pack, product and epilogue): "
              f"{format_parts(fparts)}{stats_share}")
        print(f"[wide] film_block backward ({B}, {N}, {c}) bf16 ({bpath} "
              f"path): kernel {tb['kernel']:.4f} ms, bound "
              f"{bounds['bwd'][0]:.4f} ms ({bounds['bwd'][1]}), plain fp32 "
              f"{tb['plain']:.4f} ms; torch.matmul alone (bf16): dy @ W "
              f"{tb['gemm_dp']:.4f} ms, dyᵀ @ p {tb['gemm_dw']:.4f} ms; "
              f"profiled, 3 calls (packs, cluster kernel, dW, "
              f"reductions): {format_parts(bparts)}, the cluster kernel "
              f"and dW at once {overlap:.4f} ms a call; workspace "
              f"{work} bytes; {plan['cluster_ctas']} CTAs a cluster, "
              f"{clusters} clusters at once ({clusters * plan['cluster_ctas']}"
              f" of {sms} SMs); {plan['chunks']} row chunk(s), the dW "
              f"pass's {plan['dw_blocks']} blocks a chunk ({plan['dw_nb']} x"
              f" 128 columns, {plan['dw_slices']} slice(s)): "
              f"{plan['dw_blocks'] / sms:.2f} waves of {sms}")
        out[c] = {"fwd_ms": tf["kernel"], "fwd_plain_ms": tf["plain"],
                  "fwd_gemm_ms": tf["gemm"], "fwd_bound_ms": bounds["fwd"][0],
                  "fwd_bound_by": bounds["fwd"][1],
                  "fwd_profiled_ms": fparts,
                  "fwd_stats_bound_ms": sbound if c > fb.NARROW_C else None,
                  "bwd_ms": tb["kernel"], "bwd_plain_ms": tb["plain"],
                  "bwd_gemm_dp_ms": tb["gemm_dp"],
                  "bwd_gemm_dw_ms": tb["gemm_dw"],
                  "bwd_bound_ms": bounds["bwd"][0],
                  "bwd_bound_by": bounds["bwd"][1],
                  "bwd_profiled_ms": bparts, "bwd_workspace_bytes": work,
                  "bwd_max_active_clusters": clusters,
                  "bwd_cluster_dw_overlap_ms": overlap, "bwd_plan": plan}
        del args, bargs, a2d, wt, dy2d, w16, p2d
        torch.cuda.empty_cache()
    out["fwd_wide"] = {c: wide_forward_times(fb, torch, g, c,
                                             getattr(torch, dtype))
                       for c, dtype in WIDE_FWD_TIMED}
    out["fwd_wide_build"] = wide_forward_build(fb, torch, build_log)
    # above each kernel's width: the wrappers stop with its named limit
    for what, dtype, name in (("forward", torch.bfloat16, "MAX_C_BF16"),
                              ("forward", torch.float32, "MAX_C_F32"),
                              ("backward", torch.bfloat16, "MAX_C_BWD")):
        limit = getattr(fb, name)
        c = limit + fb.N_TILE
        try:
            if what == "forward":
                fb.film_block_forward(*film_inputs(torch, g, 1, 4, c, dtype))
            else:
                fb.film_block_backward(*backward_inputs(fb, torch, g, 1, 4, c,
                                                        dtype))
        except ValueError as e:
            said = str(e)
        else:
            said = ""
        print(f"[wide] film_block {what} at C = {c} "
              f"{str(dtype)[6:]}: {said or 'no error'}")
        if f"C <= {limit} ({name})" not in said:
            raise RuntimeError(f"{what} at C = {c}: the kernel's limit "
                               f"{name} did not stop it")
    return out


def wide_forward_times(fb, torch, g, c: int, dtype) -> dict:
    """Phase 26, the forward above 2048: at (8, 20 000, c)
    in ``dtype``, CUDA-event times of the kernel, its plain version and
    torch.matmul of the product alone in bf16, as the kernel multiplies (a
    yardstick the port never calls), in turns, beside the bound; one
    profile of its parts (the W pack, the statistics kernel, the product
    and its epilogue); W's reads from L2, reckoned from the grid (every
    pair of row tiles reads all of the packed W: not measured)."""
    args = film_inputs(torch, g, B, N, c, dtype)
    a2d = args[0].reshape(-1, c).bfloat16()
    wt = args[5].T.contiguous().bfloat16()
    t = timed_turns({"kernel": lambda: fb.film_block_forward(*args),
                     "plain": lambda: fb.film_block_reference(*args),
                     "gemm": lambda: torch.matmul(a2d, wt)},
                    rounds=2, reps={"kernel": 5, "plain": 2, "gemm": 5})
    prof = profile_kernels(
        torch, lambda: fb.film_block_forward(*args), 3,
        {"pack": ("pack_w",), "stats": ("wide_stats",),
         "product": ("film_block_fwd",)},
        os.path.join(RUN_DIR, f"wide_forward_c{c}_trace.json"))
    parts = {k: prof[k][0] for k in ("pack", "stats", "product")}
    es = torch.finfo(dtype).bits // 8
    bound, by = film_bounds(B, N, c, es)["fwd"]
    sbound = stats_bound_ms(B, N, c, es)
    tiles = B * -(-N // 64)
    pairs = -(-tiles // 2)
    w_l2 = pairs * c * c * 2
    print(f"[wide] film_block forward ({B}, {N}, {c}) {str(dtype)[6:]} "
          f"(wide path, forward only): kernel {t['kernel']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}, {bound / t['kernel']:.0%} of the call), "
          f"plain fp32 {t['plain']:.4f} ms, torch.matmul "
          f"({B * N}, {c}) x ({c}, {c}) bf16 alone {t['gemm']:.4f} ms "
          f"(medians of 4 timings in turns); profiled, 3 calls (W pack, "
          f"statistics and silu(f) pack, product and epilogue): "
          f"{format_parts(parts)}; the statistics kernel's bound "
          f"{sbound:.4f} ms (bytes: h read, the packed silu(f) written), "
          f"{sbound / parts['stats']:.0%} of its time; packed W "
          f"{c * c * 2 / 1e6:.1f} MB, read {pairs} times a call "
          f"({w_l2 / 1e9:.1f} GB from L2 or device memory, reckoned from "
          f"the grid, not measured)")
    del args, a2d, wt
    torch.cuda.empty_cache()
    return {"dtype": str(dtype)[6:], "ms": t["kernel"],
            "plain_ms": t["plain"], "gemm_ms": t["gemm"], "bound_ms": bound,
            "bound_by": by, "profiled_ms": parts,
            "stats_bound_ms": sbound,
            "stats_bound_share": sbound / parts["stats"],
            "w_reads_bytes_reckoned": w_l2}


def wide_path(fb, tvs, torch, np) -> dict:
    """Phase 27: the mlp at pf_width WIDE_PF_WIDTH with the kernel trunk,
    bench.py's workload otherwise: the training CLI (8 steps, validation,
    a checkpoint, a rerun with nothing to do; 5 forward and 5 backward
    launches a step), the train step's ms/step with the kernel and the
    plain trunk in turns and the kernels' share, the sampling CLI from the
    checkpoint (Heun x 50: 500 forward launches, 8 finite clouds) and
    ms/shape with both trunks, and the distill step (N_p 25, guided: 25
    forward and 5 backward launches a step) with its ms/step."""
    from pcfm_torch.sample import cli
    width = ["--pf_width", str(WIDE_PF_WIDTH)]
    name = f"train_wide{WIDE_PF_WIDTH}"
    fwd, bwd, steps = train_cli(fb, torch, name, width, "[wide-train]")
    src = os.path.join(RUN_DIR, name)
    step = train_step_time(torch, "[wide-step]", 1,
                           f"train_step_wide{WIDE_PF_WIDTH}_trace.json",
                           pf_width=WIDE_PF_WIDTH)
    save_dir = os.path.join(RUN_DIR, f"sample_wide{WIDE_PF_WIDTH}")
    fb.launches = fb.bwd_launches = 0
    x = cli.main(["--out_dir", src, "--save_dir", save_dir, "--num_samples",
                  str(B), "--n_points", str(N), "--sample_steps", "50",
                  "--seed", str(SEED)])
    torch.cuda.synchronize()
    plys = sorted(os.listdir(save_dir))
    print(f"[wide-sample] sampling CLI, Heun x 50 at {B} x {N}: "
          f"{fb.launches} film_block launches, {fb.bwd_launches} backward, "
          f"{len(plys)} PLYs, clouds {x.shape}, finite "
          f"{bool(np.isfinite(x).all())}")
    if fb.launches != FILM_BLOCKS * NFE or fb.bwd_launches \
            or len(plys) != B or x.shape != (B, N, 6) \
            or not np.isfinite(x).all():
        raise RuntimeError("wide sampling CLI: launches or output")
    sample = sample_ms_per_shape(torch, src, {"sample_steps": 50},
                                 "[wide-sample]", ("on", "off", "on", "off"))
    dist = distill_step_time(fb, tvs, torch, "mlp", src,
                             {"sample_steps": 50,
                              "guidance_scale": DISTILL_GUIDANCE},
                             f"wide-{WIDE_PF_WIDTH}")
    return {"train_fwd_launches": fwd, "train_bwd_launches": bwd,
            "train_steps": steps, "step": step, "sample": sample,
            "sample_launches": FILM_BLOCKS * NFE, "distill": dist,
            "max_width": wide_max_width(fb, torch, np),
            "fwd_width": wide_forward_width(fb, torch, np)}


def wide_train_steps(fb, torch, width: int) -> dict:
    """Train steps of the mlp at ``width`` with the kernel trunk at
    bench.py's workload by kernel_step_ms (5 forward and 5 backward
    launches a step, finite losses), with their peak device memory."""
    state = train_state(torch, "on", pf_width=width)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fb.launches = fb.bwd_launches = 0
    step = kernel_step_ms(torch, state, train_batch(torch), gen)
    ms, losses, peak = step["ms"], step["losses"], step["peak_gib"]
    steps = WARMUP_STEPS + len(step["runs_ms"]) * TIMED_STEPS
    print(f"[wide-{width}] train step at {B} x {N} bf16, kernel trunk: "
          f"{' '.join(f'{t:.3f}' for t in step['runs_ms'])} ms/step "
          f"(median {ms:.3f}; runs of {TIMED_STEPS} steps after "
          f"{WARMUP_STEPS}), last losses {losses}, launches {fb.launches} "
          f"forward, {fb.bwd_launches} backward in {steps} steps, peak "
          f"device memory {peak:.3f} GiB")
    if (fb.launches, fb.bwd_launches) != (steps * FILM_BLOCKS,) * 2 \
            or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"pf_width {width} train step: launches or loss")
    del state
    torch.cuda.empty_cache()
    return {"train_ms_per_step": ms, "train_runs_ms": step["runs_ms"],
            "train_launches_per_step": FILM_BLOCKS, "train_peak_gib": peak}


def wide_max_width(fb, torch, np) -> dict:
    """Phase 27, last part: the mlp with the kernel trunk at pf_width 2048
    (train steps, wide_train_steps) and at pf_width MAX_C_BWD, the
    backward's widest (its clusters of 11 CTAs): the training CLI (8
    steps, 5 forward and 5 backward launches a step, validation, a
    checkpoint, a rerun with nothing to do), the sampling CLI on that
    run's checkpoint (Heun x 50 at bench.py's 8 x 20 000: exactly 500
    forward launches, no backward, 8 finite clouds), train steps as at
    2048 and one train step on the card against the CPU
    (wide_train_card_vs_cpu)."""
    from pcfm_torch.sample import cli
    out = {2048: wide_train_steps(fb, torch, 2048)}
    width = fb.MAX_C_BWD
    name, tag = f"train_wide{width}", f"[wide-{width}]"
    fwd, bwd, steps = train_cli(fb, torch, name, ["--pf_width", str(width)],
                                tag)
    src = os.path.join(RUN_DIR, name)
    save_dir = os.path.join(src, "ply")
    fb.launches = fb.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = cli.main(["--out_dir", src, "--save_dir", save_dir, "--num_samples",
                  str(B), "--n_points", str(N), "--sample_steps", "50",
                  "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bwd_s = fb.launches, fb.bwd_launches
    plys = sorted(os.listdir(save_dir))
    print(f"{tag} sampling CLI on the training CLI's checkpoint, Heun x 50 "
          f"at {B} x {N}: {launches} film_block launches, {bwd_s} backward, "
          f"{len(plys)} PLYs, clouds {x.shape}, finite "
          f"{bool(np.isfinite(x).all())}, CLI wall {wall:.3f} s incl. load "
          f"and PLY writes")
    if launches != FILM_BLOCKS * NFE or bwd_s or len(plys) != B \
            or x.shape != (B, N, 6) or not np.isfinite(x).all():
        raise RuntimeError(f"pf_width {width} sampling: launches or output")
    out[width] = dict(wide_train_steps(fb, torch, width),
                      train_cli_fwd_launches=fwd, train_cli_bwd_launches=bwd,
                      train_steps=steps, sample_launches=launches,
                      sample_cli_wall_s=wall,
                      card_vs_cpu=wide_train_card_vs_cpu(fb, torch, src))
    return out


def wide_train_card_vs_cpu(fb, torch, src: str) -> dict:
    """Phase 27: one mlp train step at pf_width MAX_C_BWD with the kernel
    trunk at WIDE_DISTILL_POINTS, from the training CLI's checkpoint
    ``src`` and the same draws, on the CPU (plain versions) and on the
    card (kernels), legs and bounds as phase 23's wide distill step: the
    card's bf16 step within MLP_DISTILL_GRAD_REL_TOL_BF16 of the CPU's
    bf16 step (its control, the card's bf16 step against the CPU's fp32
    step, printed), the card's fp32 step (fp32 inputs to the kernels)
    within WIDE_DISTILL_GRAD_REL_TOL_FP32 of the CPU's fp32 step (the same
    control, which must exceed it); 5 forward and 5 backward launches a
    card step, none on the CPU."""
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import clip_by_global_norm_
    from pcfm_torch.train.step import compute_loss, make_draws
    tag = f"[wide-{fb.MAX_C_BWD}]"
    b, n = WIDE_DISTILL_POINTS
    path, _ = checkpoint.find_latest(src)
    g = torch.Generator().manual_seed(SEED + 10)
    batch = {"pts": torch.randn(b, n, 3, generator=g) * 0.5,
             "rgb": torch.rand(b, n, 3, generator=g),
             "cond": torch.rand(b, 1, generator=g)}
    fp32 = {"amp": False, "ctx_dtype": "fp32"}
    legs = {"cpu_fp32": ("cpu", fp32), "cpu_bf16": ("cpu", {}),
            "bf16": (DEVICE, {}), "fp32": (DEVICE, fp32)}
    out, draws = {}, None
    for leg, (dev, over) in legs.items():
        t0 = time.perf_counter()
        cfg, bundle, _ = checkpoint.load(path, dev, over)
        if draws is None:
            draws = make_draws(cfg, batch, g, 0.5)
        before = (fb.launches, fb.bwd_launches)
        loss, _ = compute_loss(bundle,
                               {k: v.to(dev) for k, v in batch.items()},
                               {k: v.to(dev) for k, v in draws.items()}, 1.0)
        loss.backward()
        launched = (fb.launches - before[0], fb.bwd_launches - before[1])
        if launched != ((0, 0) if dev == "cpu" else (FILM_BLOCKS,) * 2):
            raise RuntimeError(f"pf_width {fb.MAX_C_BWD} train step, {leg}: "
                               f"launches {launched}")
        params = [(f"{gname}/{name}", p) for gname in ("enc", "pf", "lf")
                  for name, p in getattr(bundle, gname).named_parameters()
                  if p.grad is not None]
        gnorm = clip_by_global_norm_([p.grad for _, p in params], 0.0)
        out[leg] = (float(loss.detach()), float(gnorm),
                    {k: p.grad.float().cpu() for k, p in params})
        del bundle, params, loss
        print(f"{tag} step {leg} at ({b}, {n}): "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    checks = (("bf16", "cpu_bf16", MLP_DISTILL_GRAD_REL_TOL_BF16,
               ("bf16", "cpu_fp32"), False),
              ("fp32", "cpu_fp32", WIDE_DISTILL_GRAD_REL_TOL_FP32,
               ("bf16", "cpu_fp32")))
    res, ok = check_legs(tag, "train step", (b, n), out, checks)
    if not ok:
        raise RuntimeError(f"pf_width {fb.MAX_C_BWD} train step: card and "
                           "CPU disagree, or a control is within its bound")
    return {k: {"worst": e["worst_rel"], "median": e["median_rel"],
                "loss_rel": e["loss_rel"]} for k, e in res.items()}


def wide_forward_width(fb, torch, np) -> dict:
    """Phase 27, the forward's widest: the mlp at pf_width MAX_C_BF16 with
    the kernel trunk, a run written from freshly initialised weights (seed)
    by the port's checkpoint.save (the backward stops at MAX_C_BWD, so no
    trainer writes it): the sampling CLI, Heun x 50 at bench.py's 8 x 20
    000 (exactly 500 forward launches, no backward, 8 finite clouds), then
    Heun x 50 ms/shape (make_sample_fn, a warm-up and two timed runs) and
    the peak device memory of the timed runs."""
    from pcfm_torch.sample import cli
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.evaluate import make_sample_fn
    from pcfm_torch.train.state import ModelBundle
    width = fb.MAX_C_BF16
    src = os.path.join(RUN_DIR, f"wide{width}")
    shutil.rmtree(src, ignore_errors=True)
    checkpoint.save(src, 1, ModelBundle(bench_cfg(pf_width=width), DEVICE,
                                        torch.Generator().manual_seed(SEED)))
    fb.launches = fb.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = cli.main(["--out_dir", src, "--save_dir", os.path.join(src, "ply"),
                  "--num_samples", str(B), "--n_points", str(N),
                  "--seed", str(SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bwd = fb.launches, fb.bwd_launches
    plys = sorted(os.listdir(os.path.join(src, "ply")))
    print(f"[wide-{width}] sampling CLI, Heun x 50 at {B} x {N}: "
          f"{launches} film_block launches, {bwd} backward, {len(plys)} "
          f"PLYs, clouds {x.shape}, finite {bool(np.isfinite(x).all())}, "
          f"CLI wall {wall:.3f} s incl. load and PLY writes")
    if launches != FILM_BLOCKS * NFE or bwd or len(plys) != B \
            or x.shape != (B, N, 6) or not np.isfinite(x).all():
        raise RuntimeError(f"pf_width {width} sampling: launches or output")
    _, bundle, _ = load_run(src, {"fused_trunk": "on"}, DEVICE)
    sample = make_sample_fn(bundle)
    times = []
    for i in range(3):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sample(None, gen, B, N)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / B)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[1:])
    print(f"[wide-{width}] Heun x 50 at {B} x {N}, kernel trunk: "
          f"{' '.join(f'{t:.2f}' for t in times)} ms/shape (first is "
          f"warm-up; median {ms:.2f}), peak device memory {peak:.3f} GiB")
    del bundle, sample
    torch.cuda.empty_cache()
    return {"sample_launches": launches, "ms_per_shape": ms,
            "peak_gib": peak}


# the PointNet++ modules on the card (phase 28): SA from 8 x 20 000 points
# to PN_CENTERS centers (radius PN_RADIUS, PN_NEIGHBORS neighbours), then
# FP back to the points; coordinates on a 1/64 lattice, so that every
# squared distance is exact in fp32 and the card and the CPU choose the
# same centers and neighbours; outputs within PN_REL_TOL of the CPU's
# (max abs error over max |CPU|; fp32, TF32 off: sums in other orders)
PN_CENTERS, PN_RADIUS, PN_NEIGHBORS = 1024, 0.2, 32
PN_REL_TOL = 1e-4


def pointnet_on_card(torch) -> dict:
    """Phase 28: ``PointNetSAModule`` and ``PointNetFPModule`` (plain
    PyTorch, as the JAX package's are jnp) on the card and on the CPU with
    the same weights, in training mode (batch statistics): finite outputs
    within PN_REL_TOL of the CPU's, the running statistics too, and the
    card's time."""
    from pcfm_torch.nn.pointnet import PointNetFPModule, PointNetSAModule
    g = torch.Generator().manual_seed(SEED + 13)
    coords = torch.round((torch.rand(B, N, 3, generator=g) * 2 - 1) * 64) / 64
    rgb = torch.rand(B, N, 3, generator=g)
    mods = {}
    for dev in ("cpu", DEVICE):
        gen = torch.Generator().manual_seed(SEED)
        sa = PointNetSAModule(PN_CENTERS, PN_RADIUS, PN_NEIGHBORS, 3,
                              [64, 128], generator=gen)
        fp = PointNetFPModule(128 + 3, [128, 64], generator=gen)
        mods[dev] = (sa.to(dev).train(), fp.to(dev).train())
    outs, ms = {}, 0.0
    for dev, (sa, fp) in mods.items():
        x, f = coords.to(dev), rgb.to(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, centers = sa(f, x)
        up, _ = fp(x, centers, feats, f)
        if dev != "cpu":
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        outs[dev] = [t.detach().cpu() for t in (centers, feats, up)] + [
            v.detach().cpu() for m in (sa, fp)
            for k, v in m.state_dict().items() if k.endswith("running_var")]
    errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            for a, b in zip(outs[DEVICE], outs["cpu"])]
    finite = all(torch.isfinite(t).all() for t in outs[DEVICE])
    print(f"[pointnet] SA ({B} x {N} -> {PN_CENTERS} centers, r "
          f"{PN_RADIUS}, {PN_NEIGHBORS} neighbours, [64, 128]) then FP back "
          f"to {N} ([128, 64]), training mode, card vs CPU: max abs err / "
          f"max |CPU| centers {errs[0]:.3g}, SA {errs[1]:.3g}, FP "
          f"{errs[2]:.3g}, running variances {max(errs[3:]):.3g} (bound "
          f"{PN_REL_TOL}); finite {finite}; card {ms:.1f} ms (one call, "
          f"host clock, the first)")
    if not finite or max(errs) > PN_REL_TOL:
        raise RuntimeError("PointNet++ modules: card and CPU disagree")
    return {"rel_errs": errs, "card_ms_first_call": ms}


def wide_phases(fb, tvs, torch, np, distill_check: bool,
                build_log: str) -> dict:
    """Phases 26-28 (``distill_check``: phase 23's distill step at the wide
    width against the CPU as well; ``build_log``: phase 1's nvcc output,
    whose ptxas report phase 26 prints for the wide forward)."""
    t0 = time.perf_counter()
    kernels = wide_kernels_vs_plain(fb, torch, build_log)
    print(f"[wide] phase 26: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path = wide_path(fb, tvs, torch, np)
    if distill_check:
        path["distill_card_vs_cpu"] = wide_distill_card_vs_cpu(fb, tvs, torch)
    print(f"[wide] phase 27: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pn = pointnet_on_card(torch)
    print(f"[wide] phase 28: {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "path": path, "pointnet": pn}


def distill_phases(fb, tvs, torch, np, heun_ms=None, hyb_heun_ms=None):
    """Phases 21-23; the distill step's CPU legs (phase 23's first part)
    run in a CpuLegs child from here, and ``distill_card_vs_cpu_finish``
    (the card's legs and the checks) completes the result's
    ``card_vs_cpu`` later, beside the phases run in between."""
    dm = distill_cli_full_width(fb, tvs, torch, np, "mlp", heun_ms)
    dh = distill_cli_full_width(fb, tvs, torch, np, "hybrid", hyb_heun_ms)
    cpu = CpuLegs(torch, "distill")
    t0 = time.perf_counter()
    kn = train_knobs_full_width(fb, tvs, torch)
    print(f"[distill] phase 23, second part: "
          f"{time.perf_counter() - t0:.1f} s")
    return {"mlp": dm, "hybrid": dh, "knobs": kn, "cpu_legs": cpu}


def distill_card_vs_cpu_finish(fb, tvs, torch, dist: dict) -> None:
    """Phase 23's first part: the card's legs of the distill step beside
    the child's CPU legs, and the checks, into dist["card_vs_cpu"]."""
    t0 = time.perf_counter()
    cpu = dist.pop("cpu_legs").result()
    dist["card_vs_cpu"] = {
        kind: distill_card_vs_cpu(fb, tvs, torch, kind, cpu=cpu[kind])
        for kind in ("mlp", "hybrid")}
    print(f"[distill] phase 23, first part (the card's legs): "
          f"{time.perf_counter() - t0:.1f} s")


# phases 20 and 23: the CPU legs' child process keeps this many threads,
# the rest of the card machine's cores to the card's phases beside it
CPU_LEGS_THREADS = 4
CHILDREN = []


class CpuLegs:
    """The CPU legs of phase 20 (``what`` "hybrid_train") or phase 23's
    distill step ("distill": the mlp's, then the hybrid's) computed in a
    child process, ``python3 chip_smoke.py --cpu_legs WHAT``, beside the
    card's phases: they take minutes of the host's CPU and none of the
    card.  ``result()`` waits for the child, prints its lines and returns
    what it wrote: (out, rec) as the phase's own loop fills them, a dict
    of them by backbone for "distill"."""

    def __init__(self, torch, what: str):
        self.torch, self.what = torch, what
        self.path = os.path.join(RUN_DIR, f"cpu_legs_{what}.pt")
        self.log = self.path + ".log"
        os.makedirs(RUN_DIR, exist_ok=True)
        self.t0 = time.perf_counter()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu_legs",
                 what, "--seed", str(SEED)], stdout=f,
                stderr=subprocess.STDOUT, cwd=ROOT)
        CHILDREN.append(self.proc)

    def result(self):
        from pcfm_torch import kinks
        rc = self.proc.wait()
        with open(self.log) as f:
            text = f.read()
        print(text, end="")
        if rc != 0:
            raise RuntimeError(f"CPU legs ({self.what}): the child exited "
                               f"{rc}: {text[-3000:]}")
        print(f"[cpu-legs] {self.what}: the child's legs done "
              f"{time.perf_counter() - self.t0:.1f} s after its start, "
              f"{CPU_LEGS_THREADS} threads beside the card's phases")
        saved = self.torch.load(self.path, weights_only=False)

        def unpack(out, sites):
            rec = {}
            for leg, leg_sites in sites.items():
                rec[leg] = kinks.Kinks()
                rec[leg].sites = leg_sites
            return out, rec
        if self.what == "distill":
            return {kind: unpack(*saved[kind]) for kind in saved}
        return unpack(*saved)


def cpu_legs_child(what: str) -> int:
    """``--cpu_legs WHAT``: the CPU legs alone, written for CpuLegs."""
    import torch
    torch.set_num_threads(CPU_LEGS_THREADS)
    from pcfm_torch.ops import film_block as fb
    from pcfm_torch.ops import voxel_sorted as tvs

    def pack(out, rec):
        return out, {leg: r.sites for leg, r in rec.items()}
    if what == "hybrid_train":
        _, legs = hybrid_step_legs(torch)
        out, rec = {}, {}
        run_hybrid_step_legs(fb, tvs, torch,
                             [k for k in legs if k.startswith("cpu_")],
                             out, rec)
        saved = pack(out, rec)
    else:
        cpu = {"mlp": ["cpu_fp32", "cpu_bf16"],
               "hybrid": ["cpu_fp32", "cpu_bf16"]}
        saved = {kind: pack(*distill_card_vs_cpu(
            fb, tvs, torch, kind, legs_only=names))
            for kind, names in cpu.items()}
    path = os.path.join(RUN_DIR, f"cpu_legs_{what}.pt")
    torch.save(saved, path + ".tmp")
    os.replace(path + ".tmp", path)
    return 0


def stop_children() -> None:
    """Stop any CpuLegs child still running (a phase failed first)."""
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------------------ parallel

# phases 24-25: data and point-axis parallel training.  The card machine
# has one card and NCCL takes one rank a device, so the multi-rank runs
# put their ranks on the one card as processes joined over gloo (a group
# the phase makes; pcfm_torch.parallel takes it as it is)
PAR_LAYOUTS = {"dp2": (2, 1), "sp2": (1, 2)}     # of the global 8 x 20 000
PAR_STEPS = 3            # steps before the ranks' parameters are compared
PAR_WARM, PAR_TIMED = 2, 5
PAR_TRAIN_COUNT = 32     # the CLI runs' synthetic clouds (4 steps at B = 8)
# one step of the sharded layout against the one-rank step, from the same
# weights, batch and draws, in fp32 with the kernels (the FiLM kernels'
# products in bf16): the loss within PAR_LOSS_REL_TOL, every gradient
# after the all-reduce within the bound of its max.  Each bound lies
# between the sound reading and its control, the rank's own gradient
# before the all-reduce (its block's gradient, not the batch's), which
# must exceed it (readings: PERF.md, the parallel findings; on an H100).
PAR_LOSS_REL_TOL = 1e-4
# mlp: no kink moves; the ranks' partial sums of dW and the all-reduce
# add in another order than one rank's sum (seeds 0 / 1: 2.32e-5 /
# 2.52e-5 at dp2, 2.34e-5 / 2.53e-5 at sp2; control 0.257 / 0.327 and
# 0.589 / 0.727)
PAR_GRAD_REL_TOL_MLP = 1e-3
# hybrid: unpinned; a ReLU input or voxel coordinate within rounding
# distance of a kink may take another side under the all-reduced
# statistics, counted and printed (seeds 0 / 1: 2.51e-5 / 2.12e-5 at
# dp2 with 512 / 704 ReLU and 29 / 51 grid leaky-ReLU elements on
# another side, 2.53e-5 / 2.13e-5 at sp2 with 52 / 60 grid elements;
# control 0.581 / 0.825 and 0.909 / 0.825); the bound leaves room for a
# flip's whole contribution (PERF.md: one step card against CPU, 327
# ReLU flips, read 3.776e-2 unpinned)
PAR_GRAD_REL_TOL_HYBRID = 1e-2


def par_cfg(kind: str, precision: str):
    """The bench configuration of ``kind`` in fp32 (the comparison's) or
    bf16 (the main path's, timed)."""
    over = {} if precision == "bf16" else {"amp": False, "ctx_dtype": "fp32"}
    return (hybrid_cfg if kind == "hybrid" else bench_cfg)(**over)


def par_batch(torch):
    """The global batch, the same on every rank (CPU generator)."""
    g = torch.Generator().manual_seed(SEED + 24)
    return {"pts": torch.randn(B, N, 3, generator=g) * 0.5,
            "rgb": torch.rand(B, N, 3, generator=g),
            "cond": torch.rand(B, 1, generator=g)}


def par_grads(bundle) -> dict:
    return {f"{g}/{n}": p.grad for g in ("enc", "pf", "lf")
            for n, p in getattr(bundle, g).named_parameters()
            if p.grad is not None}


def par_rank_step(torch, kinks, cfg, batch, draws, rec):
    """One forward and backward on this rank's block (the grid in
    sp_context): (loss, this rank's gradients)."""
    from pcfm_torch.train.state import broadcast_state, init_state
    from pcfm_torch.train.step import compute_loss, shard_draws
    from pcfm_torch.parallel import sp_context
    from pcfm_torch.parallel.mesh import shard_batch
    state = init_state(cfg, "cuda:0", STEPS_PER_EPOCH,
                       torch.Generator().manual_seed(SEED))
    broadcast_state(state)
    mine = {k: v.cuda() for k, v in shard_batch(
        batch, sp_context.get_grid()).items()}
    with kinks.record(rec):
        loss, _ = compute_loss(state.bundle, mine, {
            k: v.cuda() for k, v in shard_draws(draws).items()}, 1.0)
    loss.backward()
    return state, loss.detach()


def par_flips(kinks, ref, rec, grid) -> dict:
    """The kinks at which this rank's step took another side than the
    one-rank step: every kind under dp (the rank's rows of each record),
    the voxel grids' leaky ReLUs under sp (a replica of the whole grid;
    the points' records are in each rank's own sorted order)."""
    from pcfm_torch.parallel.mesh import batch_block
    rows = batch_block(grid, B)
    if grid.sp == 1:
        mine = kinks.Kinks()
        mine.sites = [(k, (d[0][rows], d[1][rows]) if k == "coords"
                       else d[rows]) for k, d in ref.sites]
        return kinks.flips(mine, rec)
    pairs = [(x, y) for (k, x), (_, y) in zip(ref.sites, rec.sites)
             if k == "leaky_relu"]
    return {"leaky_relu": (sum(int((x != y).sum()) for x, y in pairs),
                           sum(x.numel() for x, _ in pairs))}


def parallel_rank(rank: int, world: int, port: int, out: str,
                  seed: int) -> None:
    """Phase 24 in one of two ranks on the one card (a spawned process:
    ``seed`` is the parent's ``--seed``)."""
    global SEED
    SEED = seed
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        res = _parallel_rank(torch, dist, rank)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _gloo_on_cuda(torch, dist, rank: int) -> dict:
    """Whether this torch's gloo takes CUDA tensors in the three
    collectives the port uses (each must give the right values)."""
    x = torch.full((8,), rank + 1.0, device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty(8, device="cuda") for _ in range(2)]
    dist.all_gather(parts, torch.full((8,), rank + 1.0, device="cuda"))
    y = torch.full((8,), rank + 1.0, device="cuda")
    dist.broadcast(y, 0)
    got = {"all_reduce": bool((x == 3).all()),
           "all_gather": bool((parts[0] == 1).all() and (parts[1] == 2).all()),
           "broadcast": bool((y == 1).all())}
    if not all(got.values()):
        raise RuntimeError(f"gloo on CUDA tensors: {got}")
    return got


def _parallel_rank(torch, dist, rank: int) -> dict:
    from pcfm_torch import kinks
    from pcfm_torch.ops import film_block as fb
    from pcfm_torch.ops import voxel_sorted as tvs
    from pcfm_torch.parallel import sp_context
    from pcfm_torch.parallel.mesh import make_grid
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import compute_loss, make_draws, train_step
    res = {"gloo_cuda": _gloo_on_cuda(torch, dist, rank)}
    batch = par_batch(torch)
    for kind in ("mlp", "hybrid"):
        cfg32 = par_cfg(kind, "fp32")
        draws = make_draws(cfg32, batch, torch.Generator().manual_seed(
            SEED + 25), 0.5)
        # the one-rank step on rank 0 (the other waits)
        ref = {}
        if rank == 0:
            t0 = time.perf_counter()
            rec_ref = kinks.Kinks()
            state = init_state(cfg32, "cuda:0", STEPS_PER_EPOCH,
                               torch.Generator().manual_seed(SEED))
            with kinks.record(rec_ref):
                loss, _ = compute_loss(state.bundle, {
                    k: v.cuda() for k, v in batch.items()},
                    {k: v.cuda() for k, v in draws.items()}, 1.0)
            loss.backward()
            ref = {"loss": float(loss.detach()), "grads": {
                k: g.float().clone() for k, g in par_grads(
                    state.bundle).items()}, "kinks": rec_ref}
            del state, loss
            torch.cuda.empty_cache()
            print(f"[parallel] {kind} one-rank step at {B} x {N} fp32: "
                  f"{time.perf_counter() - t0:.1f} s, kinks "
                  f"{rec_ref.counts()}", flush=True)
        dist.barrier()
        for layout, (dp, sp) in PAR_LAYOUTS.items():
            grid = make_grid(dp, sp, N)
            sp_context.set_sp_group(grid)
            try:
                entry = _par_layout(torch, dist, kinks, fb, tvs, kind,
                                    layout, grid, cfg32, batch, draws, ref,
                                    rank)
            finally:
                sp_context.set_sp_group(None)
            res[f"{kind}_{layout}"] = entry
        # the one-rank bf16 step's time, rank 0 alone
        if rank == 0:
            state = init_state(par_cfg(kind, "bf16"), "cuda:0",
                               STEPS_PER_EPOCH,
                               torch.Generator().manual_seed(SEED))
            full = {k: v.cuda() for k, v in batch.items()}
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            ms = _par_time(torch, None, lambda: train_step(
                state, full, gen, 1.0, 0.1))
            res[f"{kind}_one_rank_ms_per_step"] = ms
            del state
            torch.cuda.empty_cache()
        dist.barrier()
    return res


def _par_time(torch, dist, step) -> float:
    """ms/step of ``step`` after PAR_WARM warm-up steps (host clock,
    synchronised; with ``dist``, every rank starts and ends together)."""
    for _ in range(PAR_WARM):
        step()
    torch.cuda.synchronize()
    if dist is not None:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        step()
    torch.cuda.synchronize()
    if dist is not None:
        dist.barrier()
    return (time.perf_counter() - t0) * 1e3 / PAR_TIMED


def _par_layout(torch, dist, kinks, fb, tvs, kind, layout, grid, cfg32,
                batch, draws, ref, rank) -> dict:
    """One layout of phase 24 in this rank."""
    from pcfm_torch.parallel.collectives import reduce_no_grad
    from pcfm_torch.parallel.mesh import shard_batch
    from pcfm_torch.train.state import average_gradients, init_state
    from pcfm_torch.train.step import train_step
    tag = f"[parallel] {kind} {layout}"
    reset_counts(fb, tvs)
    rec = kinks.Kinks()
    state, loss = par_rank_step(torch, kinks, cfg32, batch, draws, rec)
    launched = counts(fb, tvs)
    grads = par_grads(state.bundle)
    local = {k: g.float().clone() for k, g in grads.items()}
    average_gradients(list(grads.values()))
    loss = float(reduce_no_grad(loss, grid.world)) / grid.size
    flips = par_flips(kinks, ref["kinks"], rec, grid) if rank == 0 else {}
    every = [None] * grid.size
    dist.all_gather_object(every, {"launches": launched, "flips": flips})
    entry = {"launches_step": [e["launches"] for e in every]}
    if rank == 0:
        got = (loss, 1.0, {k: g.float() for k, g in grads.items()})
        want = (ref["loss"], 1.0, ref["grads"])
        e = grad_errors(got, want)
        c = grad_errors((loss, 1.0, local), want)
        bound = PAR_GRAD_REL_TOL_MLP if kind == "mlp" \
            else PAR_GRAD_REL_TOL_HYBRID
        ok = (e["finite"] and e["loss_rel"] <= PAR_LOSS_REL_TOL
              and e["worst_rel"] <= bound < c["worst_rel"])
        print(f"{tag}: one step at {B} x {N} fp32 ({grid.dp} x "
              f"{grid.sp} ranks, {B // grid.dp} x {N // grid.sp} a rank) "
              f"against the one-rank step: loss rel {e['loss_rel']:.3g} "
              f"(bound {PAR_LOSS_REL_TOL}); {len(want[2])} gradients after "
              f"the all-reduce, max abs err / max |grad|: worst "
              f"{e['worst_rel']:.4g}, median {e['median_rel']:.3g} (bound "
              f"{bound}); control, rank 0's gradient before the all-reduce:"
              f" worst {c['worst_rel']:.4g}, median {c['median_rel']:.3g} "
              f"(must exceed {bound}); worst: "
              + ", ".join(f"{k} {v:.3g}" for k, v in e["worst"])
              + f"; kinks on another side (elements, of): {flips}; "
              f"launches per rank {entry['launches_step']}", flush=True)
        entry.update(loss_rel=e["loss_rel"], worst_rel=e["worst_rel"],
                     median_rel=e["median_rel"],
                     control_worst_rel=c["worst_rel"], flips=flips, ok=ok)
    del local, grads
    # PAR_STEPS steps: every rank's parameters stay bitwise equal
    mine = {k: v.cuda() for k, v in shard_batch(batch, grid).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    reset_counts(fb, tvs)
    for _ in range(PAR_STEPS):
        m = train_step(state, mine, gen, 1.0, 0.1)
    launched = counts(fb, tvs)
    flat = torch.cat([t.detach().float().flatten() for mod in
                      state.bundle.modules().values()
                      for t in (*mod.parameters(), *mod.buffers())])
    first = flat.clone()
    dist.broadcast(first, 0)
    same = torch.tensor([float(torch.equal(flat, first))], device="cuda")
    dist.all_reduce(same)
    del state, flat, first
    torch.cuda.empty_cache()
    # the main path's bf16 step: ms/step with two ranks on one card
    state = init_state(par_cfg(kind, "bf16"), "cuda:0", STEPS_PER_EPOCH,
                       torch.Generator().manual_seed(SEED))
    ms = _par_time(torch, dist, lambda: train_step(state, mine, gen, 1.0,
                                                   0.1))
    del state
    torch.cuda.empty_cache()
    if grid.sp > 1 and kind == "hybrid":
        # the grids' all-reduces of one step, alone: each PVConv's partial
        # grid forward and its cotangent backward, fp32 (B, R^3, C)
        entry["grid_all_reduce_ms"] = {
            f"R{r}_C{c}": _par_time(torch, dist, lambda: dist.all_reduce(
                grid_buf)) for r, c in VOXEL_STAGES
            for grid_buf in [torch.zeros(B, r ** 3, c, device="cuda")]}
    every = [None] * grid.size
    dist.all_gather_object(every, launched)
    entry.update(launches_steps=every, bitwise_equal=int(same) == grid.size,
                 ms_per_step_shared_card=ms,
                 loss_after=float(m["loss"]))
    if rank == 0:
        print(f"{tag}: {PAR_STEPS} steps: parameters and buffers of every "
              f"rank bitwise equal: {entry['bitwise_equal']}; launches per "
              f"rank {every}; bf16 train step {ms:.3f} ms/step (two ranks "
              f"sharing one card, not a scaling number)"
              + (f"; one gloo all-reduce of a stage's fp32 grid (ms): "
                 f"{entry['grid_all_reduce_ms']} (2 a PVConv a step)"
                 if "grid_all_reduce_ms" in entry else ""), flush=True)
        entry["ok"] = entry["ok"] and entry["bitwise_equal"] \
            and math.isfinite(entry["loss_after"])
    return entry


def parallel_steps(fb, tvs, torch) -> dict:
    """Phase 24: the sharded train step against the one-rank step, two
    ranks on the one card over gloo, for the mlp and the hybrid at full
    width, dp = 2 and sp = 2.  Returns rank 0's results."""
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    out = os.path.join(RUN_DIR, "parallel_steps.json")
    os.makedirs(RUN_DIR, exist_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(parallel_rank, args=(2, free_port(), out, SEED),
                       nprocs=2, join=True, start_method="spawn")
    with open(out) as f:
        res = json.load(f)
    print(f"[parallel] gloo on CUDA tensors: {res['gloo_cuda']}")
    for kind in ("mlp", "hybrid"):
        shared = {lay: res[f"{kind}_{lay}"]["ms_per_step_shared_card"]
                  for lay in PAR_LAYOUTS}
        print(f"[parallel] {kind} bf16 train step at {B} x {N}: one rank "
              f"{res[f'{kind}_one_rank_ms_per_step']:.3f} ms/step; "
              + "; ".join(f"{lay} {ms:.3f}" for lay, ms in shared.items())
              + " ms/step (two ranks sharing one card)")
    per_step = {"mlp": {"film_block": FILM_BLOCKS,
                        "film_block_bwd": FILM_BLOCKS, "voxel_gather": 0,
                        "voxel_scatter": 0},
                "hybrid": HYB_STEP_LAUNCHES}
    ok = True
    for kind in ("mlp", "hybrid"):
        for lay in PAR_LAYOUTS:
            e = res[f"{kind}_{lay}"]
            want = per_step[kind]
            ok = ok and e["ok"] and all(
                got == want for got in e["launches_step"]) and all(
                got == {k: v * PAR_STEPS for k, v in want.items()}
                for got in e["launches_steps"])
    print(f"[parallel] phase 24: {time.perf_counter() - t0:.1f} s")
    if not ok:
        raise RuntimeError("parallel step: a sharded step disagrees with "
                           "the one-rank step, a control is within its "
                           "bound, ranks differ or a kernel count is wrong")
    return res


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_cli_argv(out_dir: str) -> list:
    return ["--pf_backbone", "hybrid", "--dataset_type", "synthetic",
            "--train_count", str(PAR_TRAIN_COUNT), "--batch_size", str(B),
            "--tr_max_sample_points", str(N), "--te_max_sample_points",
            str(N), "--latent_dim", "128", "--fused_trunk", "on",
            "--save_every", "1", "--warmup_steps", "0", "--sample_steps",
            str(TRAIN_SAMPLE_STEPS), "--num_workers", "2", "--async_save",
            "--seed", str(SEED), "--out_dir", out_dir]


def parallel_cli_rank(rank: int, world: int, port: int, argv: list) -> None:
    """One rank of phase 25's two-rank CLI run on the one card."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from pcfm_torch.train import cli
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cli.main(argv, device="cuda:0")
    finally:
        dist.destroy_process_group()


def parallel_cli(torch) -> dict:
    """Phase 25: the train CLI through torchrun's variables at WORLD_SIZE
    = 1 over NCCL (the hybrid at full width, PAR_TRAIN_COUNT clouds,
    ``--async_save``), its resume, and a two-rank dp = 2 CLI run over gloo
    on the one card: one checkpoint and one validation dump, from rank
    0."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    out_dir = os.path.join(RUN_DIR, "parallel_nccl")
    shutil.rmtree(out_dir, ignore_errors=True)
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    logs, walls = [], []
    for epochs in (1, 2):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pcfm_torch.train.cli",
             *par_cli_argv(out_dir), "--epochs", str(epochs)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        walls.append(time.perf_counter() - t)
        if proc.returncode != 0:
            raise RuntimeError(f"NCCL CLI run failed: {proc.stderr[-3000:]}")
        logs.append(proc.stdout)
    steps = PAR_TRAIN_COUNT // B
    ck = torch.load(os.path.join(out_dir, "ckpts", "hybrid_ep0002.pt"),
                    map_location="cpu", weights_only=True)
    nccl_ok = ("[Dist] nccl, world 1" in logs[0]
               and "[Val ep0001]" in logs[0]
               and "Resume from epoch 1" in logs[1]
               and "Ep2: lp=" in logs[1] and ck["global_step"] == 2 * steps)
    print(f"[parallel] CLI through torchrun's variables, WORLD_SIZE 1, "
          f"NCCL: {walls[0]:.1f} s (epoch 1, {steps} steps, validation, "
          f"asynchronous save), resume {walls[1]:.1f} s: "
          + " | ".join(line for log in logs for line in log.splitlines()
                       if line.startswith(("[Dist]", "[Auto-Resume] Resume",
                                           "Ep"))))
    out2 = os.path.join(RUN_DIR, "parallel_dp2")
    shutil.rmtree(out2, ignore_errors=True)
    t = time.perf_counter()
    torch.cuda.empty_cache()
    mp.start_processes(parallel_cli_rank, args=(
        2, free_port(), par_cli_argv(out2) + ["--epochs", "1", "--dp", "2"]),
        nprocs=2, join=True, start_method="spawn")
    wall2 = time.perf_counter() - t
    ckpts = sorted(os.listdir(os.path.join(out2, "ckpts")))
    dumps = sorted(d for d in os.listdir(out2) if d.startswith("samples"))
    with open(os.path.join(out2, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ck2 = torch.load(os.path.join(out2, "ckpts", ckpts[0]),
                     map_location="cpu", weights_only=True)
    dp_ok = (ckpts == ["hybrid_ep0001.pt"]
             and dumps == ["samples_ep0001", "samples_recon_ep0001"]
             and len(rows) == 1 and math.isfinite(rows[0]["loss"])
             and ck2["global_step"] == PAR_TRAIN_COUNT // (2 * B))
    print(f"[parallel] two-rank dp = 2 CLI over gloo on one card: "
          f"{wall2:.1f} s, checkpoints {ckpts}, dumps {dumps}, metrics "
          f"{rows}, global step {ck2['global_step']}")
    print(f"[parallel] phase 25: {time.perf_counter() - t0:.1f} s")
    if not (nccl_ok and dp_ok):
        raise RuntimeError("parallel CLI: a run did not train, save, "
                           "validate or resume as it should")
    return {"nccl_wall_s": walls, "dp2_wall_s": wall2}


def parallel_phases(fb, tvs, torch) -> dict:
    return {"steps": parallel_steps(fb, tvs, torch),
            "cli": parallel_cli(torch)}


def parallel_launches(par: dict, name: str) -> dict:
    """The kernels line's per-rank launches of one sharded step."""
    return {f"{kind}_{lay}": [e[name] for e in
                              par["steps"][f"{kind}_{lay}"]["launches_step"]]
            for kind in ("mlp", "hybrid") for lay in PAR_LAYOUTS}


# ------------------------------------------------------- interop and FLOPs

# phases 29-30: reference checkpoints imported into port runs, and the
# model-FLOP counter
INTEROP_DIR = os.path.join(RUN_DIR, "interop")
# one velocity evaluation of each imported model in fp32 with the plain
# trunk, at HYB_E2E_POINTS, card against CPU (the card's pass takes the
# CPU pass's choices at the kinks, pcfm_torch.kinks; TF32 off): max abs
# err over max |v|
INTEROP_VEL_REL_TOL = 1e-4
INTEROP_EVAL_BATCHES = 1
MODULE_KEYS = ("encoder", "pf", "lf", "ema_pf", "ema_lf")


def reference_ckpt(torch, bundle, epoch: int, global_step: int) -> dict:
    """A reference-format checkpoint of ``bundle`` (on the CPU) with the
    reference's variants: every state_dict taken from a live DDP wrapper
    (``module.`` prefix), the point flow under the legacy key ``model``,
    EMA shadows of the float entries only (the reference's EMA registers
    no other) moved off the live weights, ``args`` without ``ctx_dtype``
    and with a reference-only key, and an empty optimizer state."""
    import dataclasses
    gen = torch.Generator().manual_seed(SEED + 29)

    def ddp(sd):
        return {f"module.{k}": v.detach().cpu().clone()
                for k, v in sd.items()}

    def ema(module):
        params = dict(module.named_parameters())
        return ddp({k: (v + 1e-3 * torch.randn(v.shape, generator=gen)
                        if k in params else v)
                    for k, v in module.state_dict().items()
                    if v.is_floating_point()})

    args = dataclasses.asdict(bundle.cfg)
    del args["ctx_dtype"]
    args["local_rank"] = 0                       # the reference's DDP flag
    return {"encoder": ddp(bundle.enc.state_dict()),
            "model": ddp(bundle.pf.state_dict()),
            "lf": ddp(bundle.lf.state_dict()), "ema_pf": ema(bundle.pf),
            "ema_lf": ema(bundle.lf), "args": args,
            "cond_dim": bundle.cfg.cond_dim, "opt": {}, "scaler": None,
            "epoch": epoch, "global_step": global_step}


def unwrapped_reference(ref: dict) -> dict:
    """What a port run must hold of ``ref``: the state_dicts unwrapped,
    ``model`` as ``pf``, the EMA with the live non-float entries."""
    def strip(sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    out = {"encoder": strip(ref["encoder"]), "pf": strip(ref["model"]),
           "lf": strip(ref["lf"])}
    for key in ("ema_pf", "ema_lf"):
        out[key] = {**out[key[4:]], **strip(ref[key])}
    return out


def same_state_dicts(torch, a: dict, b: dict) -> bool:
    return all(set(a[k]) == set(b[k]) and all(
        a[k][n].dtype == b[k][n].dtype and torch.equal(a[k][n], b[k][n])
        for n in a[k]) for k in MODULE_KEYS)


def interop_sample(fb, tvs, torch, np, kind: str, run: str) -> dict:
    """The sampling CLI (Heun x 50, kernel trunk) on an imported run:
    exact launches, finite clouds, then ms/shape of one more call."""
    from pcfm_torch.sample import cli
    from pcfm_torch.sample.cli import load_run
    from pcfm_torch.train.evaluate import make_sample_fn
    tag = f"[interop] {kind}"
    reset_counts(fb, tvs)
    x = cli.main(["--out_dir", run, "--save_dir", os.path.join(run, "gen"),
                  "--num_samples", str(B), "--n_points", str(N), "--seed",
                  str(SEED), "--device", DEVICE])
    got = counts(fb, tvs)
    pv = PVCONVS if kind == "hybrid" else 0
    want = {"film_block": FILM_BLOCKS * NFE, "film_block_bwd": 0,
            "voxel_gather": pv * NFE, "voxel_scatter": pv * NFE}
    _, bundle, _ = load_run(run, None, DEVICE)
    sample = make_sample_fn(bundle)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample(None, gen, B, N)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / B
    del bundle, sample
    torch.cuda.empty_cache()
    print(f"{tag}: sampling CLI, Heun x 50 at {B} x {N}, kernel trunk: "
          f"launches {got} (expected {want}), clouds {x.shape}, finite "
          f"{bool(np.isfinite(x).all())}; {ms:.2f} ms/shape (one call "
          f"after the CLI's)")
    if got != want or x.shape != (B, N, 6) or not np.isfinite(x).all():
        raise RuntimeError(f"{tag}: sampling launches {got} or output")
    return {"launches": got, "ms_per_shape": ms}


def interop_eval(fb, tvs, tc, torch, run: str) -> dict:
    """The evaluation CLI on the imported mlp run, INTEROP_EVAL_BATCHES
    batch(es): exact launches, finite metrics."""
    from pcfm_torch.eval import cli
    reset_counts(fb, tvs, tc)
    t0 = time.perf_counter()
    out = cli.main(["--out_dir", run, "--mode", "both", "--max_batches",
                    str(INTEROP_EVAL_BATCHES), "--device", DEVICE])
    wall = time.perf_counter() - t0
    got = {"chamfer_nn": tc.launches, **counts(fb, tvs)}
    calls = 2 * INTEROP_EVAL_BATCHES              # recon and gen
    want = {"chamfer_nn": 2 * calls, "film_block": calls * FILM_BLOCKS * NFE,
            "film_block_bwd": 0, **dict.fromkeys(tvs.launches, 0)}
    keys = [f"{m}_{k}" for m in ("recon", "gen")
            for k in ("cd", "emd", "fscore", "precision", "recall")]
    print(f"[interop] mlp: eval CLI --mode both, {INTEROP_EVAL_BATCHES} "
          f"batch of {B} x {N}: launches {got} (expected {want}), wall "
          f"{wall:.3f} s; " + ", ".join(f"{k} {out.get(k, math.nan):.4g}"
                                        for k in keys))
    if got != want or not all(math.isfinite(out.get(k, math.nan))
                              for k in keys):
        raise RuntimeError(f"interop eval: launches {got} or output {out}")
    return {"launches": got, "wall_s": wall}


def interop_velocity(torch, kind: str, card_run: str, cpu_run: str) -> float:
    """One velocity evaluation of the imported model in fp32 with the plain
    trunk: the card-imported run on the card against the CPU-imported run
    on the CPU, the card taking the CPU's choices at the kinks."""
    from pcfm_torch import kinks
    from pcfm_torch.sample.cli import load_run
    b, n = HYB_E2E_POINTS
    over = {"amp": False, "fused_trunk": "off"}
    g = torch.Generator().manual_seed(SEED + 30)
    cfg, cpu_bundle, _ = load_run(cpu_run, over, "cpu")
    x = torch.randn(b, n, cfg.pf_point_dim, generator=g)
    t = torch.rand(b, generator=g)
    cond = torch.randn(b, cfg.pf_cond_dim, generator=g)
    rec = kinks.Kinks()
    with torch.no_grad(), kinks.record(rec):
        want = cpu_bundle.ema_pf.eval()(x, t, cond)
    _, bundle, _ = load_run(card_run, over, DEVICE)
    with torch.no_grad(), kinks.replay(rec):
        got = bundle.ema_pf.eval()(x.to(DEVICE), t.to(DEVICE),
                                   cond.to(DEVICE)).cpu()
    scale = want.abs().max().item()
    rel = (got - want).abs().max().item() / scale
    print(f"[interop] {kind}: one velocity at ({b}, {n}), fp32, plain "
          f"trunk, card-imported run on the card against the CPU-imported "
          f"run on the CPU (kinks pinned: {rec.counts()}): max abs err / "
          f"max |v| {rel:.4g} (bound {INTEROP_VEL_REL_TOL}; max |v| "
          f"{scale:.4g})")
    if not torch.isfinite(got).all() or rel > INTEROP_VEL_REL_TOL:
        raise RuntimeError(f"interop {kind}: card and CPU velocities differ")
    del bundle, cpu_bundle
    torch.cuda.empty_cache()
    return rel


def interop_import(fb, tvs, tc, torch, np) -> dict:
    """Phase 29: full-width reference checkpoints (mlp 512/6/256 and the
    hybrid with the Config's ContextNet, random weights from the seed, the
    reference's variants) through ``python -m pcfm_torch.interop`` on the
    card and with ``--device cpu``; the runs' state_dicts, Config and
    counters; the sampling CLI on both imported runs and the eval CLI on
    the mlp's; one fp32 velocity of each, card against CPU."""
    from pcfm_torch.train.state import ModelBundle
    t_phase = time.perf_counter()
    shutil.rmtree(INTEROP_DIR, ignore_errors=True)
    os.makedirs(INTEROP_DIR)
    refs = {}
    for kind, cfg in (("mlp", bench_cfg(dataset_type="synthetic",
                                        te_max_sample_points=N)),
                      ("hybrid", hybrid_cfg())):
        gen = torch.Generator().manual_seed(SEED)
        bundle = ModelBundle(cfg, "cpu", gen)
        if kind == "hybrid":   # as write_hybrid_checkpoint: the pyramid
            with torch.no_grad():                     # reaches the head
                for name, p in bundle.pf.named_parameters():
                    if name.endswith(("head_out.weight",
                                      "film.affine.weight")):
                        p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        refs[kind] = reference_ckpt(torch, bundle, epoch=3, global_step=879)
        torch.save(refs[kind], os.path.join(INTEROP_DIR, f"{kind}_ref.pt"))
        del bundle
    # the four imports at once: each a process, as a user runs it
    procs, t0 = {}, time.perf_counter()
    for kind in refs:
        for where, dev in (("card", DEVICE), ("cpu", "cpu")):
            procs[kind, where] = subprocess.Popen(
                [sys.executable, "-m", "pcfm_torch.interop",
                 os.path.join(INTEROP_DIR, f"{kind}_ref.pt"), "--out_dir",
                 os.path.join(INTEROP_DIR, f"{kind}_{where}"), "--device",
                 dev], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    logs = {}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"import {key} failed: {err[-3000:]}")
        logs[key] = out
    wall = time.perf_counter() - t0
    res = {"import_wall_s": wall}
    for kind, ref in refs.items():
        saved = {where: torch.load(os.path.join(
            INTEROP_DIR, f"{kind}_{where}", "ckpts", "hybrid_ep0003.pt"),
            map_location="cpu", weights_only=True)
            for where in ("card", "cpu")}
        card = saved["card"]
        want = unwrapped_reference(ref)
        exact = same_state_dicts(torch, card, want)
        devices = same_state_dicts(torch, card, saved["cpu"])
        ctx = card["args"]["ctx_dtype"]
        ok = (exact and devices and ctx == "fp32"
              and "local_rank" not in card["args"]
              and card["global_step"] == 879 and card["epoch"] == 3
              and "opt" not in card)
        print(f"[interop] {kind}: python -m pcfm_torch.interop (card and "
              f"--device cpu, 4 imports at once: {wall:.1f} s): "
              + " | ".join(line for line in logs[kind, "card"].splitlines())
              + f"; state_dicts equal the file's after unwrapping, bit for "
              f"bit: {exact}; card and CPU imports bit for bit: {devices}; "
              f"ctx_dtype {ctx}; global_step {card['global_step']}, epoch "
              f"{card['epoch']}")
        if not ok:
            raise RuntimeError(f"interop {kind}: the imported run differs "
                               "from the reference file")
    for kind in refs:
        res[kind] = interop_sample(fb, tvs, torch, np, kind,
                                   os.path.join(INTEROP_DIR, f"{kind}_card"))
    res["eval"] = interop_eval(fb, tvs, tc, torch,
                               os.path.join(INTEROP_DIR, "mlp_card"))
    for kind in refs:
        res[kind]["velocity_rel_err"] = interop_velocity(
            torch, kind, os.path.join(INTEROP_DIR, f"{kind}_card"),
            os.path.join(INTEROP_DIR, f"{kind}_cpu"))
    print(f"[interop] phase 29: {time.perf_counter() - t_phase:.1f} s")
    return res


@contextlib.contextmanager
def plain_voxel_ops(tvs, on: bool):
    """The voxel ops' plain versions on CUDA tensors for the block (a
    comparison's yardstick, never the port's path)."""
    if not on:
        yield
        return
    kernel = tvs.use_kernel
    tvs.use_kernel = lambda x, what: False
    try:
        yield
    finally:
        tvs.use_kernel = kernel


def flop_counts(fb, tvs, torch) -> dict:
    """Phase 30: pcfm_torch.utils.flops's count of the mlp and hybrid train
    steps at 8 x 20 000 (bf16) and of one velocity evaluation (a Heun
    NFE), with the kernels and with the plain trunk and plain voxel ops:
    equal, exactly.  MFU of each kernel step beside its host-clock and
    device-busy ms."""
    from pcfm_torch.train.evaluate import eval_mode
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import train_step
    from pcfm_torch.utils import flops
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    batch = train_batch(torch)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    x = torch.randn(B, N, 6, device=DEVICE, generator=g)
    t = torch.rand(B, device=DEVICE, generator=g)
    res = {}
    for kind, make in (("mlp", bench_cfg), ("hybrid", hybrid_train_cfg)):
        entry = {}
        for path in ("kernels", "plain"):
            cfg = make(fused_trunk="on" if path == "kernels" else "off")
            state = init_state(cfg, DEVICE, STEPS_PER_EPOCH,
                               torch.Generator().manual_seed(SEED))
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            cond = torch.randn(B, cfg.pf_cond_dim, device=DEVICE,
                               generator=torch.Generator(
                                   device=DEVICE).manual_seed(SEED + 32))
            with plain_voxel_ops(tvs, path == "plain"):
                reset_counts(fb, tvs)
                with flops.FlopCount() as step_count:
                    m = train_step(state, batch, gen, 1.0, 0.1)
                step_launches = counts(fb, tvs)
                reset_counts(fb, tvs)
                pf = state.bundle.ema_pf
                with torch.no_grad(), eval_mode(pf), \
                        flops.FlopCount() as nfe_count:
                    v = pf(x, t, cond)
                nfe_launches = counts(fb, tvs)
            if not (math.isfinite(float(m["loss"]))
                    and torch.isfinite(v).all()):
                raise RuntimeError(f"flops {kind} {path}: not finite")
            entry[path] = {"step": step_count.total,
                           "step_by_op": step_count.by_op,
                           "nfe": nfe_count.total,
                           "step_launches": step_launches,
                           "nfe_launches": nfe_launches}
            if path == "kernels":
                step = lambda: train_step(state, batch, gen, 1.0, 0.1)  # noqa
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(TIMED_STEPS):
                    step()
                torch.cuda.synchronize()
                entry["ms_per_step"] = (time.perf_counter() - t0) * 1e3 \
                    / TIMED_STEPS
                prof = profile_kernels(torch, step, 3, {}, os.path.join(
                    RUN_DIR, f"flops_{kind}_step_trace.json"))
                entry["busy_ms_per_step"] = prof["busy_ms"]
            del state
            torch.cuda.empty_cache()
        k, p = entry["kernels"], entry["plain"]
        mfu_host = flops.mfu(k["step"], entry["ms_per_step"] / 1e3)
        mfu_busy = flops.mfu(k["step"], entry["busy_ms_per_step"] / 1e3)
        entry.update(mfu_host_clock=mfu_host, mfu_device_busy=mfu_busy)
        kernel_launched = any(k["step_launches"].values())
        plain_launched = any(p["step_launches"].values()) \
            or any(p["nfe_launches"].values())
        print(f"[flops] {kind} train step at {B} x {N} bf16: "
              f"{k['step']:.6e} FLOP with the kernels ({k['step_by_op']}; "
              f"launches {k['step_launches']}), {p['step']:.6e} with the "
              f"plain trunk and plain voxel ops ({p['step_by_op']}; "
              f"launches {p['step_launches']}): equal {k['step'] == p['step']}"
              f"; one velocity evaluation (Heun NFE): {k['nfe']:.6e} / "
              f"{p['nfe']:.6e}, equal {k['nfe'] == p['nfe']} ({smi})")
        print(f"[flops] {kind} train step, kernels: "
              f"{entry['ms_per_step']:.3f} ms/step host clock ({TIMED_STEPS}"
              f" steps after 3), {entry['busy_ms_per_step']:.3f} ms device "
              f"busy (profiler, 3 steps); MFU at "
              f"{flops.H100_BF16_DENSE_PEAK / 1e12:.0f} TFLOP/s dense bf16: "
              f"{100 * mfu_host:.3f} % host clock, {100 * mfu_busy:.3f} % "
              f"device busy ({smi})")
        if (k["step"] != p["step"] or k["nfe"] != p["nfe"]
                or not kernel_launched or plain_launched
                or not (0 < mfu_host < 1 and 0 < mfu_busy < 1)):
            raise RuntimeError(f"flops {kind}: counts differ between the "
                               f"kernels and the plain versions, or MFU "
                               f"out of range: {entry}")
        res[kind] = entry
    res["card"] = smi
    return res


def write_pose_tree(np, root: str) -> dict:
    """Phase 32's PLY poses, laid out as make_dataset.py writes them:
    {model}/joint.json and {model}/pose_XXX/{pointcloud.ply, angles.json},
    DATA_MODELS x DATA_POSES hinge clouds of DATA_POINTS RGB points from
    the seed; the even models' PLYs ASCII (the port's writer), the odd
    models' binary little-endian.  Returns {path: (xyz, rgb uint8,
    ascii)} as written."""
    from pcfm_torch.data.ply import save_point_cloud_ply_rgb
    from pcfm_torch.data.synthetic import hinge_shape
    rng = np.random.RandomState(SEED + 32)
    written = {}
    for m in range(DATA_MODELS):
        model = os.path.join(root, f"model_{m:02d}")
        os.makedirs(model, exist_ok=True)
        with open(os.path.join(model, "joint.json"), "w") as f:
            json.dump({"anno_id": f"model_{m:02d}", "category": "Hinge",
                       "joints": [{"index": 0, "name": "joint_0",
                                   "type": "revolute", "lower": 0.1,
                                   "upper": 2.5}]}, f)
        for pose in range(DATA_POSES):
            d = os.path.join(model, f"pose_{pose:03d}")
            os.makedirs(d, exist_ok=True)
            theta = float(rng.uniform(0.1, 2.5))
            xyz, rgb = hinge_shape(rng, DATA_POINTS, theta)
            xyz = xyz * np.float32(rng.uniform(0.5, 3.0))
            rgb = np.clip(rgb + rng.uniform(-0.1, 0.1, rgb.shape), 0, 1)
            rgb8 = (rgb * 255.0 + 0.5).astype(np.uint8)
            path = os.path.join(d, "pointcloud.ply")
            if m % 2 == 0:
                save_point_cloud_ply_rgb(xyz, rgb, path)
            else:
                rec = np.empty(len(xyz), [("x", "<f4"), ("y", "<f4"),
                                          ("z", "<f4"), ("red", "u1"),
                                          ("green", "u1"), ("blue", "u1")])
                for i, k in enumerate("xyz"):
                    rec[k] = xyz[:, i]
                for i, k in enumerate(("red", "green", "blue")):
                    rec[k] = rgb8[:, i]
                header = ("ply\nformat binary_little_endian 1.0\n"
                          f"element vertex {len(xyz)}\n"
                          + "".join(f"property float {k}\n" for k in "xyz")
                          + "".join(f"property uchar {k}\n"
                                    for k in ("red", "green", "blue"))
                          + "end_header\n")
                with open(path, "wb") as f:
                    f.write(header.encode())
                    f.write(rec.tobytes())
            with open(os.path.join(d, "angles.json"), "w") as f:
                json.dump({"angles": [theta]}, f)
            written[path] = (xyz, rgb8, m % 2 == 0)
    return written


def read_pose_tree(np, written: dict) -> dict:
    """Phase 32, step 1: every PLY back through the port's ``load_ply``
    with the native parser required (built here, its count of parses
    checked), each ASCII read equal to the numpy path's bit for bit and
    within the writer's 6 decimals of what was written, each binary read
    equal to what was written; host ms a cloud for both paths."""
    from unittest import mock

    from pcfm_torch.data.ply import load_ply
    from pcfm_torch.native import build as nb
    t0 = time.perf_counter()
    nb.build(force=True)
    build_s = time.perf_counter() - t0
    if not nb.available():
        raise RuntimeError("the native PLY library did not load")
    ascii_paths = [p for p, (_, _, a) in written.items() if a]
    before = nb.parses
    t0 = time.perf_counter()
    native = {p: load_ply(p) for p in written}
    native_s = time.perf_counter() - t0
    parsed = nb.parses - before
    with mock.patch.object(nb, "get_lib", lambda: None):
        t0 = time.perf_counter()
        plain = {p: load_ply(p) for p in ascii_paths}
        plain_s = time.perf_counter() - t0
    ascii_err, bad, bound = 0.0, [], 0.0
    for path, (xyz, rgb8, is_ascii) in written.items():
        got_xyz, got_rgb = native[path]
        if got_xyz.shape != xyz.shape or got_xyz.dtype != np.float32 \
                or not np.array_equal(got_rgb, rgb8):
            bad.append(path)
        elif is_ascii:
            # %.6f rounds by at most 5e-7, float32 by half an ulp
            ascii_err = max(ascii_err, float(np.abs(got_xyz - xyz).max()))
            bound = max(bound, 5e-7 + float(np.abs(xyz).max())
                        * float(np.finfo(np.float32).eps))
            if not (np.array_equal(got_xyz, plain[path][0])
                    and np.array_equal(got_rgb, plain[path][1])):
                bad.append(path)
        elif not np.array_equal(got_xyz, xyz):
            bad.append(path)
    n_ascii = len(ascii_paths)
    out = {"clouds": len(written), "ascii": n_ascii,
           "native_parses": parsed, "build_s": build_s,
           "ascii_max_abs_err": ascii_err,
           "native_ms_per_cloud_all": native_s * 1e3 / len(written),
           "numpy_ms_per_ascii_cloud": plain_s * 1e3 / n_ascii}
    print(f"[data] PLY poses: {DATA_MODELS} models x {DATA_POSES} poses x "
          f"{DATA_POINTS} RGB points ({n_ascii} ASCII, "
          f"{len(written) - n_ascii} binary); native library built in "
          f"{build_s:.2f} s, {parsed} native parses; host ms a cloud: "
          f"{out['native_ms_per_cloud_all']:.3f} (all, native), numpy "
          f"path {out['numpy_ms_per_ascii_cloud']:.3f} (ASCII); ASCII max "
          f"|read - written| {ascii_err:.3g} (bound {bound:.3g}); wrong "
          f"reads: "
          f"{len(bad)}")
    if bad or parsed != n_ascii or ascii_err > bound:
        raise RuntimeError(f"PLY read-back: {len(bad)} wrong, {parsed} of "
                           f"{n_ascii} ASCII clouds parsed natively")
    return out


def loader_ms(torch, loader, feed, batches: int, warmup: int) -> tuple:
    """Host ms a batch of ``loader`` over ``batches`` batches after
    ``warmup`` (epochs in turn), not counting ``feed``: the train loop's
    host work on each batch, timed apart (then synchronised); and the
    first batch's ms (a process loader's worker start)."""
    t0 = time.perf_counter()
    first, times, fed, ep = None, [], [], 0
    while len(times) < batches:
        t = time.perf_counter()
        for batch in loader.epoch_batches(ep):
            now = time.perf_counter()
            feed(batch)
            done = time.perf_counter()
            torch.cuda.synchronize()
            if first is None:
                first = (now - t0) * 1e3
            elif warmup > 0:
                warmup -= 1
            else:
                times.append((now - t) * 1e3)
                fed.append((done - now) * 1e3)
            if len(times) == batches:
                break
            t = time.perf_counter()
        ep += 1
    return statistics.mean(times), statistics.mean(fed), first


def data_cli_run(fb, torch, name: str, backend: str, extra=()) -> dict:
    """One training CLI run from scratch at bench.py's width on the
    synthetic set (no h5py on the card's machine), with ``backend``'s
    train loader: its result, launches, metrics rows and checkpoint."""
    from pcfm_torch.train import cli
    run = os.path.join(RUN_DIR, "data", name)
    shutil.rmtree(run, ignore_errors=True)
    fb.launches = fb.bwd_launches = 0
    out = cli.main(["--dataset_type", "synthetic", "--batch_size", str(B),
                    "--tr_max_sample_points", str(N),
                    "--te_max_sample_points", str(N), "--latent_dim", "128",
                    "--fused_trunk", "on", "--warmup_steps", "0",
                    "--sample_steps", str(TRAIN_SAMPLE_STEPS),
                    "--loader_backend", backend, "--num_workers",
                    str(DATA_WORKERS), "--out_dir", run, *extra])
    torch.cuda.synchronize()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpts = sorted(os.listdir(os.path.join(run, "ckpts")))
    sd = torch.load(os.path.join(run, "ckpts", ckpts[-1]),
                    map_location="cpu", weights_only=True)
    return {"out": out, "rows": rows, "fwd": fb.launches,
            "bwd": fb.bwd_launches, "sd": sd}


def same_tree(torch, a, b) -> bool:
    """Bitwise equality of two nested checkpoint values."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(torch, x, y)
                                        for x, y in zip(a, b))
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


def data_pipeline(fb, torch, np, step_ms=None) -> dict:
    """Phase 32: the input pipeline on the card's host (this machine has no
    h5py, so no packing or H5 shards here: the CPU tests hold them).  PLY
    poses written and read back natively (step 1); the training CLI at
    bench.py's width through the worker-process backend (``--loader_backend
    grain --num_workers DATA_WORKERS``, 8 steps, validation, a checkpoint)
    with exact launches; its first DATA_SAME_BATCHES batches equal the
    thread backend's bit for bit; 3-step CLI runs on each backend from one
    seed with bitwise-equal losses and weights; then, printed and not
    gated, ms a batch of both backends and the CLI's ms a step with each
    beside phase 8's train step."""
    from pcfm_torch.data.grain_loader import ProcessLoader
    from pcfm_torch.data.loader import DataLoader, to_model_batch
    from pcfm_torch.data.synthetic import SyntheticDataset
    from pcfm_torch.train.loop import to_device
    root = os.path.join(RUN_DIR, "data")
    shutil.rmtree(root, ignore_errors=True)
    out = {"ply": read_pose_tree(np, write_pose_tree(
        np, os.path.join(root, "poses")))}

    fwd, bwd, steps = train_cli(fb, torch, name="data/train_grain",
                                extra=("--loader_backend", "grain",
                                       "--num_workers", str(DATA_WORKERS)),
                                tag="[data]")
    out["train_cli"] = {"fwd": fwd, "bwd": bwd, "steps": steps}

    # the CLI's train set and loader arguments (synthetic, seed 123)
    ds = SyntheticDataset(split="train", tr_sample_size=N, te_sample_size=N)
    kw = dict(shuffle=True, drop_last=True, seed=bench_cfg().seed)
    proc = ProcessLoader(ds, B, num_workers=DATA_WORKERS, **kw)
    try:
        got = [b for _, b in zip(range(DATA_SAME_BATCHES),
                                 proc.epoch_batches(1))]
    finally:
        proc.close()
    want = [b for _, b in zip(range(DATA_SAME_BATCHES), DataLoader(
        ds, B, num_workers=DATA_WORKERS, **kw).epoch_batches(1))]
    same = len(got) == len(want) == DATA_SAME_BATCHES and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) and
                                     x[k].dtype == y[k].dtype for k in x)
        for x, y in zip(got, want))
    print(f"[data] first {DATA_SAME_BATCHES} batches of epoch 1 at {B} x "
          f"{N}: process backend ({DATA_WORKERS} workers) and thread "
          f"backend bitwise equal: {same}")
    if not same:
        raise RuntimeError("process and thread backends' batches differ")

    short = ("--epochs", "1", "--train_count", str(3 * B))
    runs = {b: data_cli_run(fb, torch, f"three_{b}", b, short)
            for b in ("grain", "thread")}
    g, t = runs["grain"], runs["thread"]
    args = [{k: v for k, v in r["sd"].pop("args").items()
             if k not in ("out_dir", "loader_backend")} for r in (g, t)]
    equal = same_tree(torch, g["sd"], t["sd"]) and args[0] == args[1] \
        and g["out"] == t["out"] and g["fwd"] == t["fwd"]
    print(f"[data] 3-step CLI runs, grain / thread: loss "
          f"{g['out']['loss']!r} / {t['out']['loss']!r}; checkpoints "
          f"(weights, EMA, optimizer) bitwise equal: {equal}; launches "
          f"{g['fwd']} / {t['fwd']} forward, {g['bwd']} / {t['bwd']} "
          f"backward")
    if not equal or g["bwd"] != 3 * FILM_BLOCKS or \
            not math.isfinite(g["out"]["loss"]):
        raise RuntimeError("3-step runs differ between backends")
    out["three_step_loss"] = g["out"]["loss"]

    # printed, not gated: the loaders alone on 30 000-point clouds (as
    # PartNet shards hold them), then the CLI's epochs of 8 steps
    big = SyntheticDataset(split="train", size=LOADER_CLOUDS,
                           n_points=DATA_POINTS, tr_sample_size=N,
                           te_sample_size=N)
    cfg = bench_cfg()

    def feed(batch):                  # the loop's device_prefetch, one batch
        to_device(to_model_batch(batch, train=True, has_rgb=True,
                                 cond_dim=1), torch.device(DEVICE))

    ms, fed, first = {}, {}, {}
    for name, kind, workers in (("thread_0", DataLoader, 0),
                                ("thread_8", DataLoader, 8),
                                ("process_8", ProcessLoader, 8),
                                ("process_16", ProcessLoader, 16)):
        loader = kind(big, B, num_workers=workers, seed=cfg.seed)
        ms[name], fed[name], first[name] = loader_ms(
            torch, loader, feed, LOADER_TIMED_BATCHES, LOADER_WARMUP_BATCHES)
        if kind is ProcessLoader:
            loader.close()
    del big
    timed = ("--epochs", "3", "--save_every", "3")
    cli_ms = {b: [row["sec"] * 1e3 / 8 for row in data_cli_run(
        fb, torch, f"timed_{b}", b, timed)["rows"][1:]]
        for b in ("thread", "grain")}
    if step_ms is None:               # --only data: phase 8's method
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        step_ms = kernel_step_ms(torch, train_state(torch, "on"),
                                 train_batch(torch), gen)["ms"]
    card = sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")
    print(f"[data] loaders at {B} x {N} from {LOADER_CLOUDS} clouds of "
          f"{DATA_POINTS} points (in memory; {LOADER_TIMED_BATCHES} "
          f"batches after {LOADER_WARMUP_BATCHES}), host ms a batch: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + "; the loop's host work on each batch (to_model_batch + "
          "pinned to_device): "
          + ", ".join(f"{k} {v:.3f}" for k, v in fed.items())
          + "; first batch (worker start) "
          + ", ".join(f"{k} {v:.1f}" for k, v in first.items())
          + f" ({card})")
    print(f"[data] training CLI, epochs 2-3 of 8 steps, ms a step: "
          + ", ".join(f"{b} {' '.join(f'{x:.2f}' for x in v)} (median "
                      f"{statistics.median(v):.2f})"
                      for b, v in cli_ms.items())
          + f"; train step alone (phase 8's method) {step_ms:.3f} ms "
          f"({card})")
    out.update(loader_ms_per_batch=ms, loop_feed_ms_per_batch=fed,
               first_batch_ms=first, cli_ms_per_step={
        b: statistics.median(v) for b, v in cli_ms.items()},
        step_ms=step_ms, card=card)
    torch.cuda.empty_cache()
    return out


def learning_run(fb, tvs, torch, np, kind: str) -> dict:
    """Phase 33 for one backbone: LEARN_STEPS[kind] steps in bf16 with the
    kernel trunk and in fp32 with the plain trunk, side by side from the
    same weights, batches and draws; the curves' summaries and the gates
    (finite, learning, bf16 against fp32)."""
    from pcfm_torch.quality.common import (EpochOrder, device_split,
                                           gather_batch)
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import make_draws, train_step
    steps, tag = LEARN_STEPS[kind], f"[learning] {kind}"
    mk = hybrid_cfg if kind == "hybrid" else bench_cfg
    kw = dict(warmup_steps=LEARN_WARMUP, epochs=1)
    cfgs = {"bf16_kernel": mk(**kw),
            "fp32_plain": mk(fused_trunk="off", amp=False, ctx_dtype="fp32",
                             **kw)}
    states = {p: init_state(c, DEVICE, steps,
                            torch.Generator().manual_seed(SEED))
              for p, c in cfgs.items()}
    ref = states["bf16_kernel"].bundle.modules()
    for k, m in states["fp32_plain"].bundle.modules().items():
        m.load_state_dict(ref[k].state_dict())
    _, split = device_split("train", LEARN_CLOUDS, N, DEVICE, seed=SEED)
    order = EpochOrder(LEARN_CLOUDS, B, DEVICE, seed=SEED + 1)
    idx = []
    while len(idx) < steps:
        idx += order.next()
    cfg = cfgs["bf16_kernel"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 33)
    names = ("loss_point", "loss_latent")
    losses = {p: [] for p in states}
    events = {p: [] for p in states}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fb, tvs)
    t0 = time.perf_counter()
    for i in range(steps):
        batch = gather_batch(split, idx[i])
        draws = make_draws(cfg, batch, gen, cfg.cfg_drop_p)
        for p, st in states.items():
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            m = train_step(st, batch, None, 1.0, cfg.cfg_drop_p, draws=draws)
            ev[1].record()
            events[p].append(ev)
            losses[p].append(torch.stack([m[k] for k in names]))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    got = counts(fb, tvs)
    per_step = (HYB_STEP_LAUNCHES if kind == "hybrid" else
                {"film_block": FILM_BLOCKS, "film_block_bwd": FILM_BLOCKS})
    want = {k: per_step.get(k, 0) * steps for k in got}
    if kind == "hybrid":          # the fp32 run's voxel kernels as well
        for k in ("voxel_gather", "voxel_scatter"):
            want[k] *= 2
    if got != want:
        raise SystemExit(f"{tag}: launches {got}, expected {want}")
    late_n = max(1, int(round(LEARN_LATE_SHARE * steps)))
    out = {"steps": steps, "launches": got, "wall_s": wall_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    for p in states:
        curve = torch.stack(losses[p]).cpu().numpy().astype(np.float64)
        if not np.isfinite(curve).all():
            raise SystemExit(f"{tag} {p}: a loss is not finite")
        early, late = curve[:LEARN_EARLY].mean(0), curve[-late_n:].mean(0)
        deciles = [int(round(q * (steps - 1))) for q in np.linspace(0, 1, 11)]
        out[p] = {"ms_per_step": statistics.median(
                      a.elapsed_time(b) for a, b in events[p]),
                  **{k: {"first": float(curve[0, j]),
                         f"early{LEARN_EARLY}": float(early[j]),
                         "late": float(late[j]),
                         "min": float(curve[:, j].min()),
                         "at_steps": {str(s_): float(curve[s_, j])
                                      for s_ in deciles}}
                     for j, k in enumerate(names)}}
        for j, k in enumerate(names):
            print(f"{tag} {p} {k}: first {curve[0, j]:.4f}, mean of steps "
                  f"1-{LEARN_EARLY} {early[j]:.4f}, mean of the last "
                  f"{late_n} {late[j]:.4f}, min {curve[:, j].min():.4f}; "
                  f"at steps {deciles}: "
                  f"{[round(float(curve[s_, j]), 4) for s_ in deciles]}")
            if not late[j] < early[j]:
                raise SystemExit(f"{tag} {p} {k}: the late mean "
                                 f"{late[j]:.4f} is not below the early "
                                 f"mean {early[j]:.4f}")
        print(f"{tag} {p}: {out[p]['ms_per_step']:.2f} ms/step (CUDA "
              f"events, median)")
    rel = {}
    for k in names:
        a = out["bf16_kernel"][k]["late"]
        b = out["fp32_plain"][k]["late"]
        rel[k] = abs(a - b) / abs(b)
        print(f"{tag} {k}: late mean bf16 kernel {a:.4f} against fp32 plain "
              f"{b:.4f}: {rel[k]:.4f} relative (tolerance "
              f"{LEARN_REL_TOL[k]})")
        if not rel[k] <= LEARN_REL_TOL[k]:
            raise SystemExit(f"{tag} {k}: bf16 and fp32 late means differ "
                             f"by {rel[k]:.4f} > {LEARN_REL_TOL[k]}")
    out["late_rel_diff"] = rel
    print(f"{tag}: {steps} steps x 2 runs in {wall_s:.1f} s, launches "
          f"{got}, peak {out['peak_gib']:.2f} GiB")
    del states
    torch.cuda.empty_cache()
    return out


def learning(fb, tvs, torch, np) -> dict:
    """Phase 33: learning_run for the mlp, then the hybrid."""
    return {kind: learning_run(fb, tvs, torch, np, kind)
            for kind in LEARN_STEPS}


def main() -> int:
    global SEED
    p = argparse.ArgumentParser(description="on-card smoke run of pcfm_torch")
    p.add_argument("--only", choices=("voxel", "chamfer", "hybrid_train",
                                      "distill", "parallel", "wide",
                                      "interop", "data", "learning"),
                   help="phase 1 and one group of phases alone")
    p.add_argument("--seed", type=int, default=SEED,
                   help="seed of every random weight, cloud and draw")
    p.add_argument("--cpu_legs", choices=("hybrid_train", "distill"),
                   help=argparse.SUPPRESS)   # CpuLegs' child process
    args = p.parse_args()
    SEED = args.seed
    if args.cpu_legs:
        sys.path.insert(0, ROOT)
        return cpu_legs_child(args.cpu_legs)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs a CUDA device")
    sys.path.insert(0, ROOT)
    import numpy as np

    from pcfm_torch.ops import build
    from pcfm_torch.ops import chamfer as tc
    from pcfm_torch.ops import film_block as fb
    from pcfm_torch.ops import voxel_sorted as tvs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{sh(build.nvcc(), '--version').splitlines()[-1]}")

    info = build.build(force=True)
    print(f"[build] {len(build.sources())} source(s) -> "
          f"{os.path.relpath(info['path'], ROOT)} in {info['seconds']:.2f} s")
    check_spills(info["log"])

    if args.only == "voxel":
        # phases 1, 10 and 31 alone, for work on the voxel kernels
        voxel_vs_plain(tvs, torch)
        odd_channels(fb, tvs, torch, np)
        return 0
    if args.only == "chamfer":
        # phases 1 and 14 alone, for work on the chamfer kernel
        chamfer_vs_plain(tc, torch)
        return 0
    if args.only == "distill":
        # phase 1 and phases 21-23 (which write their own inputs), for
        # work on distillation and the train step's options
        try:
            distill_card_vs_cpu_finish(fb, tvs, torch,
                                       distill_phases(fb, tvs, torch, np))
        finally:
            stop_children()
        return 0
    if args.only == "parallel":
        # phase 1 and phases 24-25, for work on parallel training
        par = parallel_phases(fb, tvs, torch)
        print(json.dumps({"parallel": par}))
        return 0
    if args.only == "wide":
        # phase 1 and phases 26-28, for work on the FiLM kernels' wide
        # paths and the PointNet++ modules
        wide_phases(fb, tvs, torch, np, distill_check=True,
                    build_log=info["log"])
        return 0
    if args.only == "interop":
        # phase 1 and phases 29-30, for work on checkpoint import and the
        # FLOP counter
        inter = interop_import(fb, tvs, tc, torch, np)
        fl = flop_counts(fb, tvs, torch)
        print(json.dumps({"interop": inter, "flops": fl}))
        return 0
    if args.only == "data":
        # phase 1 and phase 32, for work on the input pipeline
        print(json.dumps({"data": data_pipeline(fb, torch, np)}))
        return 0
    if args.only == "learning":
        # phase 1 and phase 33, for work on training over many steps
        print(json.dumps({"learning": learning(fb, tvs, torch, np)}))
        return 0
    if args.only == "hybrid_train":
        # phase 1, phase 11's checkpoint and phases 17-20 alone, for work
        # on hybrid training
        write_hybrid_checkpoint(torch)
        hybrid_train_cli(fb, tvs, torch)
        hybrid_train_step_time(fb, tvs, torch)
        hybrid_determinism(torch)
        try:
            hybrid_grads_card_vs_cpu(fb, tvs, torch)
        finally:
            stop_children()
        return 0
    try:
        return full_run(args, info, fb, tvs, tc, torch, np)
    finally:
        stop_children()


def full_run(args, info, fb, tvs, tc, torch, np) -> int:
    """Phases 2-33 and the last two lines (the default run)."""
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        """The script's time so far, after a group of phases (the run has
        a time limit; each slice reads what its phases cost)."""
        print(f"[time] after {what}: {time.perf_counter() - t_start:.0f} s "
              f"since the build")

    kv, kv_err = kernel_vs_plain(fb, torch)
    launches = main_path(fb, torch, np)
    ms = sample_ms_per_shape(torch)
    trunk_end_to_end(torch)
    bw = backward_vs_plain(fb, torch)
    fwd_train, bwd_train, steps = train_cli(fb, torch)
    step = train_step_time(torch)
    lap("phases 2-9")
    determinism(torch)
    vox, vox_skewed = voxel_vs_plain(tvs, torch)
    hyb = hybrid_main_path(fb, tvs, torch, np)
    # phase 20's CPU legs, from phase 11's checkpoint, beside phases 12-19
    hyb_cpu = CpuLegs(torch, "hybrid_train")
    hyb_ms = hybrid_ms_per_shape(torch)
    hyb_rel = hybrid_end_to_end(tvs, torch)
    lap("phases 10-13")
    cham = chamfer_vs_plain(tc, torch)
    ev = eval_cli_full_width(fb, tvs, tc, torch)
    su = suite_full_width(fb, tvs, tc, torch)
    lap("phases 14-16")
    htc = hybrid_train_cli(fb, tvs, torch)
    hts = hybrid_train_step_time(fb, tvs, torch)
    hybrid_determinism(torch)
    htg = hybrid_grads_card_vs_cpu(fb, tvs, torch, hyb_cpu)
    lap("phases 17-20")
    dist = distill_phases(fb, tvs, torch, np, ms["on"],
                          hyb_ms["ms_per_shape"])
    dm, dh = dist["mlp"]["step"], dist["hybrid"]["step"]
    lap("phases 21-22 and 23's second part")
    par = parallel_phases(fb, tvs, torch)
    lap("phases 24-25")
    wide = wide_phases(fb, tvs, torch, np, distill_check=False,
                       build_log=info["log"])
    lap("phases 26-28")
    inter = interop_import(fb, tvs, tc, torch, np)
    fl = flop_counts(fb, tvs, torch)
    print(json.dumps({"interop": inter, "flops": fl}))
    lap("phases 29-30")
    odd = odd_channels(fb, tvs, torch, np)
    lap("phase 31")
    # phase 23's card legs, its CPU legs' child having run beside 24-31
    distill_card_vs_cpu_finish(fb, tvs, torch, dist)
    lap("phase 23's first part")
    print(json.dumps({"data": data_pipeline(fb, torch, np, step["ms_on"])}))
    lap("phase 32")
    print(json.dumps({"learning": learning(fb, tvs, torch, np)}))
    lap("phase 33")

    film = film_bounds(B, N, C)
    # the main path's shapes: R = 32 stage, 8 clouds, bf16 features;
    # devoxelize is the K = 8 gather, avg_voxelize the K = 1 scatter
    gather = vox[("gather", 32, 128, B, 8, torch.bfloat16)]
    scatter = vox[("scatter", 32, 128, B, 1, torch.bfloat16)]
    hyb_prof = hyb_ms["profile"]
    hts_prof = hts["profile"]

    def voxel_entry(name, source, replaces, row, what, **extra):
        def rows(cases, fields):
            # B = 8 (the main path's batch), both K and dtypes
            return [{"R": r, "C": c, "K": k, "dtype": str(dt)[6:],
                     **{f: rw[f] for f in fields}}
                    for (wh, r, c, bsz, k, dt), rw in cases.items()
                    if wh == what and bsz == B]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": hyb["heun50"][name],
                "max_abs_err": max(r["max_abs_err"] for key, r in
                                   (*vox.items(), *vox_skewed.items(),
                                    *odd["rows"].items())
                                   if key[0] == what),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "shape": {"gather": [B, 32 ** 3, 128, 8],
                          "scatter": [B, N, 128, 1]}[what],
                "stages": rows(vox, ("ms", "device_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "write_ms")),
                "skewed": rows(vox_skewed, ("ms", "device_ms", "plain_ms",
                                            "bound_ms")),
                "profiled_ms_per_run": hyb_prof[name][0],
                "launches_cfg": hyb["heun50_cfg0.25"][name],
                "launches_hybrid_train": hts["launches_per_step"][name],
                # the hybrid backward's case: fp32 cotangents, K = 1 gather
                # (avg-voxelize's transpose), K = 8 scatter (devoxelize's)
                "train_backward_stages": [
                    {"R": r, "C": c, "K": k, **{f: rw[f] for f in (
                        "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by")}}
                    for (wh, r, c, bsz, k, dt), rw in vox.items()
                    if wh == what and bsz == B and dt == torch.float32
                    and k == {"gather": 1, "scatter": 8}[what]],
                "hybrid_train_ms_per_step": hts["ms_per_step"],
                "hybrid_train_peak_gib": hts["peak_gib"],
                "hybrid_train_profiled_ms_per_step": hts_prof[name][0],
                "launches_distill_mlp": dm["launches_per_step"][name],
                "launches_distill_hybrid": dh["launches_per_step"][name],
                "distill_hybrid_profiled_ms_per_step": dh["profiled_ms"][name],
                "launches_parallel_step_per_rank": parallel_launches(par,
                                                                     name),
                "launches_imported_reference_sample": inter["hybrid"][
                    "launches"][name],
                # phase 31: C % 8 != 0 at R = 32, and the hybrid with
                # ctx_stage_channels ODD_STAGE_CHANNELS
                "odd_channels": rows(odd["rows"], (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")),
                "launches_hybrid_odd_channels_sample": odd["sample"][name],
                "launches_hybrid_odd_channels_train_step": odd[
                    "train_launches_per_step"][name],
                "launches_per_train_step_at_c100": odd[
                    "launches_per_step_at_c100"],
                **extra}

    wk, wp = wide["kernels"], wide["path"]

    def wide_entry(d: str, c: int, launches: int, **extra):
        """The kernels line's entry of one direction's wide path: its time
        at (B, N, c), and each timed width's row."""
        rows = {str(cc): {k[4:]: v for k, v in wk[cc].items()
                          if k.startswith(d + "_")} for cc in WIDE_TIMED_CS}
        row = rows[str(c)]
        return {"name": f"film_block_{d}_wide", "route": "cuda",
                "source": {"fwd": "pcfm_torch/csrc/film_block.cu",
                           "bwd": "pcfm_torch/csrc/film_block_bwd.cu"}[d],
                "replaces": {"fwd": "pcfm/ops/pallas/film_block.py:56",
                             "bwd": "pcfm/ops/pallas/film_block.py:75"}[d],
                "launches": launches,
                "max_abs_err": wk[f"{d}_max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "shape": [B, N, c], "widths": rows,
                "widths_checked": list(WIDE_CS), **extra}

    mw = wp["max_width"]

    def bwd_max_width():
        """The backward's fields at its widest, pf_width MAX_C_BWD: time
        and bound at (B, N, MAX_C_BWD), clusters, the training CLI's
        launches, train ms/step, the step against the CPU."""
        row, top = wk[fb.MAX_C_BWD], mw[fb.MAX_C_BWD]
        return {"C": fb.MAX_C_BWD, "ms": row["bwd_ms"],
                "plain_ms": row["bwd_plain_ms"],
                "bound_ms": row["bwd_bound_ms"],
                "bound_by": row["bwd_bound_by"],
                "gemm_dp_ms": row["bwd_gemm_dp_ms"],
                "gemm_dw_ms": row["bwd_gemm_dw_ms"],
                "profiled_ms": row["bwd_profiled_ms"],
                "cluster_dw_overlap_ms": row["bwd_cluster_dw_overlap_ms"],
                "plan": row["bwd_plan"],
                "workspace_bytes": row["bwd_workspace_bytes"],
                "clusters": {str(c): v for c, v in wk["bwd_clusters"].items()},
                "launches": top["train_cli_bwd_launches"],
                "launches_from": f"training CLI, pf_width {fb.MAX_C_BWD}",
                "train_steps": top["train_steps"],
                "train_ms_per_step": top["train_ms_per_step"],
                "train_peak_gib": top["train_peak_gib"],
                "train_ms_per_step_2048": mw[2048]["train_ms_per_step"],
                "train_grad_rel_err": top["card_vs_cpu"]}

    def fwd_above_entry():
        """The kernels line's entry of the forward above 2048 (its
        statistics kernel's wider instantiation): its time at (B, N,
        MAX_C_BF16), launches from the sampling
        CLI at that pf_width, each timed width's row."""
        rows = {str(c): r for c, r in wk["fwd_wide"].items()}
        row, fw = rows[str(fb.MAX_C_BF16)], wp["fwd_width"]
        return {"name": "film_block_fwd_wide_above_2048", "route": "cuda",
                "source": "pcfm_torch/csrc/film_block.cu",
                "replaces": "pcfm/ops/pallas/film_block.py:56",
                "launches": fw["sample_launches"],
                "launches_from": f"sampling CLI, Heun x 50, pf_width "
                                 f"{fb.MAX_C_BF16}",
                "max_abs_err": wk["fwd_max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "gemm_only_ms": row["gemm_ms"],
                "profiled_ms": row["profiled_ms"],
                "shape": [B, N, fb.MAX_C_BF16], "widths": rows,
                "widths_checked": {"bf16": list(WIDE_FWD_CS),
                                   "fp32": list(WIDE_FWD_F32_CS)},
                "sample_heun50_ms_per_shape": fw["ms_per_shape"],
                "sample_peak_gib": fw["peak_gib"],
                "launch": wk["fwd_wide_build"]["launch"]}

    # the card again, beside the numbers (the first line may scroll away)
    print(sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"))

    print(json.dumps({"kernels": [{
        "name": "film_block_fwd", "route": "cuda",
        "source": "pcfm_torch/csrc/film_block.cu",
        "replaces": "pcfm/ops/pallas/film_block.py:56",
        "launches": launches,
        "max_abs_err": kv_err,
        "ms": kv[B][0], "plain_ms": kv[B][1],
        "bound_ms": film["fwd"][0], "bound_by": film["fwd"][1],
        "library_ms": None, "gemm_only_ms": kv[B][2],
        "shape": [B, N, C],
        "ms_2b": kv[2 * B][0], "plain_ms_2b": kv[2 * B][1],
        "gemm_only_ms_2b": kv[2 * B][2],
        "sample_heun50_ms_per_shape": ms["on"],
        "sample_heun50_plain_trunk_ms_per_shape": ms["off"],
        "launches_train_cli": fwd_train,
        "launches_hybrid_train": hts["launches_per_step"]["film_block"],
        "launches_distill_mlp": dm["launches_per_step"]["film_block"],
        "launches_distill_hybrid": dh["launches_per_step"]["film_block"],
        "distill_mlp_ms_per_step": dm["ms_per_step"],
        "distill_mlp_idle_share": dm["idle_share"],
        "distill_mlp_peak_gib": dm["peak_gib"],
        "distill_mlp_kernel_share": dm["kernel_share"],
        "distilled_mlp_euler12_ms_per_shape":
            dist["mlp"]["euler_ms_per_shape"],
        "launches_parallel_step_per_rank": parallel_launches(par,
                                                             "film_block"),
        "parallel_ms_per_step_two_ranks_sharing_one_card": {
            f"{kind}_{lay}": par["steps"][f"{kind}_{lay}"][
                "ms_per_step_shared_card"]
            for kind in ("mlp", "hybrid") for lay in PAR_LAYOUTS},
        "parallel_one_rank_ms_per_step": {
            kind: par["steps"][f"{kind}_one_rank_ms_per_step"]
            for kind in ("mlp", "hybrid")},
        "launches_imported_reference_sample": {
            kind: inter[kind]["launches"]["film_block"]
            for kind in ("mlp", "hybrid")},
        "model_flops_train_step": {kind: fl[kind]["kernels"]["step"]
                                   for kind in ("mlp", "hybrid")},
        "model_flops_velocity": {kind: fl[kind]["kernels"]["nfe"]
                                 for kind in ("mlp", "hybrid")},
        "train_step_mfu_host_clock": {kind: fl[kind]["mfu_host_clock"]
                                      for kind in ("mlp", "hybrid")},
        "train_step_mfu_device_busy": {kind: fl[kind]["mfu_device_busy"]
                                       for kind in ("mlp", "hybrid")}}, {
        "name": "film_block_bwd", "route": "cuda",
        "source": "pcfm_torch/csrc/film_block_bwd.cu",
        "replaces": "pcfm/ops/pallas/film_block.py:75",
        "launches": bwd_train, "train_steps": steps,
        "max_abs_err": bw["max_abs_err"],
        "max_err_over_grad_max": bw["max_err_over_grad_max"],
        "fp32_dy_err_over_grad_max": bw["fp32_dy_err_over_grad_max"],
        "ms": bw[B]["ms"], "plain_ms": bw[B]["plain_ms"],
        "bound_ms": film["bwd"][0], "bound_by": film["bwd"][1],
        "library_ms": None, "shape": [B, N, C],
        "gemm_only_ms": bw[B]["gemm_dp_ms"] + bw[B]["gemm_dw_ms"],
        "gemm_dp_ms": bw[B]["gemm_dp_ms"], "gemm_dw_ms": bw[B]["gemm_dw_ms"],
        "rows_pass_profiled_ms": bw[B]["rows_ms"],
        "dw_pass_profiled_ms": bw[B]["dw_ms"],
        "ms_2b": bw[2 * B]["ms"], "plain_ms_2b": bw[2 * B]["plain_ms"],
        "gemm_only_ms_2b": bw[2 * B]["gemm_dp_ms"]
        + bw[2 * B]["gemm_dw_ms"],
        "gemm_dp_ms_2b": bw[2 * B]["gemm_dp_ms"],
        "gemm_dw_ms_2b": bw[2 * B]["gemm_dw_ms"],
        "rows_pass_profiled_ms_2b": bw[2 * B]["rows_ms"],
        "dw_pass_profiled_ms_2b": bw[2 * B]["dw_ms"],
        "train_ms_per_step": step["ms_on"],
        "train_plain_trunk_ms_per_step": step["ms_off"],
        "train_peak_gib": step["peak_gib_on"],
        "train_film_block_share": step["share"]["film_block_share"],
        "launches_hybrid_train":
            hts["launches_per_step"]["film_block_bwd"],
        "launches_distill_mlp": dm["launches_per_step"]["film_block_bwd"],
        "launches_distill_hybrid":
            dh["launches_per_step"]["film_block_bwd"],
        "distill_mlp_grad_rel_err": {
            k: {"worst": e["worst_rel"], "median": e["median_rel"]}
            for k, e in dist["card_vs_cpu"]["mlp"].items()},
        "train_knobs": dist["knobs"],
        "launches_parallel_step_per_rank": parallel_launches(
            par, "film_block_bwd")},
        wide_entry("fwd", fb.MAX_C_BWD, mw[fb.MAX_C_BWD]["sample_launches"],
                   launches_from=f"sampling CLI, Heun x 50, pf_width "
                                 f"{fb.MAX_C_BWD}, on its training CLI's "
                                 f"checkpoint",
                   launches_train_cli_max_width=mw[fb.MAX_C_BWD][
                       "train_cli_fwd_launches"],
                   launches_train_per_step_max_width=mw[fb.MAX_C_BWD][
                       "train_launches_per_step"],
                   train_ms_per_step_2048=mw[2048]["train_ms_per_step"],
                   train_peak_gib_2048=mw[2048]["train_peak_gib"],
                   pointnet_card_vs_cpu_rel_errs=wide["pointnet"][
                       "rel_errs"]),
        wide_entry("bwd", WIDE_PF_WIDTH, wp["train_bwd_launches"],
                   launches_from=f"training CLI, pf_width {WIDE_PF_WIDTH}",
                   max_width=bwd_max_width(),
                   train_steps=wp["train_steps"],
                   fp32_dy_err_over_grad_max=wk["fp32_dy_err_over_grad_max"],
                   max_err_over_grad_max=wk["bwd_max_err_over_grad_max"],
                   train_ms_per_step=wp["step"]["ms_on"],
                   train_plain_trunk_ms_per_step=wp["step"]["ms_off"],
                   train_film_block_share=wp["step"]["share"][
                       "film_block_share"],
                   train_peak_gib=wp["step"]["peak_gib_on"],
                   sample_heun50_ms_per_shape=wp["sample"]["on"],
                   sample_heun50_plain_trunk_ms_per_shape=wp["sample"]["off"],
                   distill_ms_per_step=wp["distill"]["ms_per_step"],
                   distill_launches_per_step=wp["distill"][
                       "launches_per_step"],
                   distill_grad_rel_err=dist["knobs"]["wide_distill"]),
        fwd_above_entry(),
        voxel_entry("voxel_gather", "pcfm_torch/csrc/voxel_gather.cu",
                    "pcfm/ops/pallas/voxel_sorted.py:150", gather, "gather",
                    hybrid_heun50_ms_per_shape=hyb_ms["ms_per_shape"],
                    hybrid_idle_share=hyb_ms["idle_share"],
                    hybrid_peak_gib=hyb["heun50"]["peak_gib"],
                    hybrid_peak_gib_cfg=hyb["heun50_cfg0.25"]["peak_gib"],
                    hybrid_end_to_end_rel_err=hyb_rel,
                    hybrid_train_idle_share=hts["idle_share"],
                    hybrid_train_grad_rel_err={
                        k: {"worst": e["worst_rel"], "median": e["median_rel"]}
                        for k, e in htg.items()},
                    hybrid_train_cli_peak_gib=htc["peak_gib"],
                    distill_hybrid_ms_per_step=dh["ms_per_step"],
                    distill_hybrid_idle_share=dh["idle_share"],
                    distill_hybrid_peak_gib=dh["peak_gib"],
                    distill_hybrid_kernel_share=dh["kernel_share"],
                    distilled_hybrid_euler12_ms_per_shape=dist["hybrid"][
                        "euler_ms_per_shape"],
                    distill_hybrid_grad_rel_err={
                        k: {"worst": e["worst_rel"],
                            "median": e["median_rel"]}
                        for k, e in dist["card_vs_cpu"]["hybrid"].items()}),
        voxel_entry("voxel_scatter", "pcfm_torch/csrc/voxel_scatter.cu",
                    "pcfm/ops/pallas/voxel_sorted.py:182", scatter,
                    "scatter", plan_glue_profiled_ms_per_run={
                        part: hyb_prof[f"plan_{part}"][0]
                        for part in ("sort", "searchsorted", "cumsum")},
                    plan_glue_hybrid_train_profiled_ms_per_step={
                        part: hts_prof[f"plan_{part}"][0]
                        for part in ("sort", "searchsorted", "cumsum")}), {
        "name": "chamfer_nn", "route": "cuda",
        "source": "pcfm_torch/csrc/chamfer_nn.cu",
        "replaces": "pcfm/ops/pallas/chamfer_v3.py:19",
        "variant": "tensor-core TF32 screen (mma.sync m16n8k8) with a "
                   "proven margin, then a difference-form check",
        "launches": ev["launches"]["chamfer_nn"],
        "max_abs_err": cham["max_abs_err"], **cham[B],
        "shape": [B, N, N, 3],
        "screen_err_over_kappa": cham["screen_err_over_kappa"],
        "cases": cham["cases"],
        **{f"{k}_2b": v for k, v in cham[2 * B].items() if k != "bound_by"},
        **{f"suite_{k}": v for k, v in cham["suite"].items()},
        "suite_shape": [SUITE_CLOUDS ** 2, SUITE_POINTS, SUITE_POINTS, 3],
        "launches_suite": su["launches"]["chamfer_nn"],
        "eval_cli_wall_s": ev["wall_s"], "suite_cli_wall_s": su["wall_s"],
        "streamed_emd_ms_per_batch": ev["emd_ms"],
        "eval_metrics_profiled_chamfer_ms": ev["profile"]["chamfer_nn"][0],
        "launches_imported_reference_eval": inter["eval"]["launches"][
            "chamfer_nn"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
