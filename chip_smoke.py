#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):
  1. The card (name and power limit from nvidia-smi) and the build of every
     kernel of the paths from the sources in this checkout, one nvcc per
     source, all started together.
  2. Each kernel against its plain PyTorch version on the card, at the
     headline shape (752x480, 4 levels, 10240 features, a pair translated
     by (7, -4)) and on border, off-image and skipped features: the FAST
     basic-KLT kernel (also at the front end's 300 features and with a
     31-row patch, wider than the TPU kernel's limit), the DIRECT / INVERSE
     basic-KLT kernel in both modes, the affine kernel through
     ``AffineKlt.track`` and the SE(2) kernel through ``LssdKlt.track``
     with luminance off and on (each one launch for the whole pyramid, held
     against the plain level loop and, level by level, against its
     one-level case), the last two also on a pair rotated by 0.03 rad.
  3. The main paths through the front end, each with the launch counts set
     to 0 just before and read just after:
     ``TrackingFrontEnd(FrontEndConfig(), device="cuda")`` over a 752x480
     sequence translating a little each frame (24 frames, one FAST launch
     per tracked frame and one launch of detection's suppression kernel,
     kernel 6, per frame that replenishes), and over 8 frames each with
     ``tracker=BasicKlt(method=INVERSE)``, ``AffineKlt`` and ``LssdKlt``
     (one launch per tracked frame each): live tracks kept, the median
     tracked flow equal to the true shift, track ids kept across frames.
  4. Timings with CUDA events (warm-up first, median of >= 20 samples),
     each kernel's bound from its bytes and the operations of the steps
     actually taken, occupancy and phase-clock profiles of the KLT kernels,
     each kernel's device time per launch from torch.profiler (the time the
     kernels line carries: a kernel shorter than its wrapper's enqueue on
     the host is timed by the host in a run of back-to-back calls), and
     torch.profiler windows over five headline kernel calls and ten more
     front-end frames. Then (4b) detection's suppression kernel (kernel 6)
     against the plain path on the same ranked candidates of a front-end
     frame (``HarrisOptions()`` at ``max_num`` 300, where the scan stops
     early, and 2000; a 6 px distance, whose grid takes 197 KB of shared
     memory; a 3 px one, its list path), bit for bit, its
     device time per launch, and detection per call with the kernel and
     with the plain path.
  5. RAFT inference. The correlation-lookup kernel against its plain
     version at the serving shape (batch 4, 55x128 queries, 128 channels,
     3 levels, radius 3), on locations that leave the map or are NaN,
     infinite or 1e9, at odd sizes, channel counts and radii, on a tile
     that straddles a motion boundary and on tiles whose windows lie too far
     apart to stage. Then the path at full width:
     ``Raft(RaftConfig(max_iterations=6, low_memory=True,
     upsample_last_only=True), device="cuda")`` on 440x1024 textured pairs
     with a known shift, batch 4, weights from a seeded generator, the
     launch count set to 0 just before and read just after (6 launches per
     call); the same model with the lookup forced to the plain version and
     with the materialised all-pairs volume must give the same flow; the
     bfloat16 model is held loosely against the float32 flow, and a compact
     model on the card against the same model on the CPU. Timings of the
     kernel on the seeded noisy locations and on the locations of the
     driven call's last iteration (with the share of tiles it staged in
     shared memory), of its plain version, the materialised route, the encoders, one
     update iteration and whole calls in float32 and bfloat16. Then (5d)
     CoTracker2's correlation: the kernel in border mode against its plain
     version at the online benchmark cell's shape (8 frames x 50x50
     tracks, 96x128 maps, C=128, 4 levels, radius 3) on noisy grid
     locations and on locations off the map; one ``CoTracker2Online``
     window at the published widths on 8 rendered 384x512 RGB frames with
     a 50x50 grid of queries, in float32 and bfloat16, the launch count
     set to 0 just before and read just after (4 launches), against the
     plain float32 reference (``benchmark/reference/cotracker2.py``) run from
     the clip's start; the border kernel on that window's last lookup
     (against its plain version, its staging, its time, bound, plain time
     and phase clocks) and the bfloat16 step's time.
  6. The slice's other paths on the card, each checked against the same
     path on the CPU and timed per call (CUDA events, warm-up first, median
     of >= 20 runs) with a profiler window for the device's idle share:
     the BRIEF pipeline of bench.py's ``w_brief_match`` (detect 300 corners
     in both frames of a 752x480 pair translated by (7, -4), describe,
     Hamming distances, valid-masked ``nearby_match``,
     ``fill_matched_pixels``) at ``min_valid_response`` 40 and 10; the
     direct SE(3) pose tracker in DIRECT, INVERSE and FAST at KITTI's
     1241x376 with its intrinsics, 5 levels and 300 features on a rendered
     textured plane with a known motion (also against the native DIRECT
     ground truth); Farnebäck dense flow on the 752x480 pair, 5 levels, 20
     iterations (also against the native ground truth); and the stream
     path: the phase-3 sequence as uint8 through ``FrameStream`` (native
     ring and pyramid) into ``BasicKlt`` on the card, the FAST kernel's
     launch count set to 0 just before and read just after (one launch per
     tracked frame).
  7. The neural models on their shipped weights (``weights/*.npz``, read
     by the port's loaders; a missing file fails the run), each on the
     card against the same model on the CPU, timed per call (CUDA events,
     inputs on the card) and profiled for the device's idle share:
     ``SuperPointDetector.from_file(max_features=300)`` on both frames of
     the headline pair into ``NNFeatureMatcher.from_file`` in both
     SuperPoint variants (uv and counts equal, descriptors within 1e-5,
     valid scores within 1e-3, matched uv and statuses equal); the same
     with ``DiskDetector`` and the DISK variants; bench.py's
     ``w_lightglue`` shape (256 random keypoints, depth 9); and CoTracker
     at the configuration of ``weights/metrics.json`` on 8 frames of 96x96
     with 24 queries and on 24 frames of 384x512 with 256 queries (each
     iteration from the CPU's positions within 1e-3 px and 1e-3 in the
     visibility logits; the whole run within those or twice the card's
     own spread under a one-ulp change of the video). Then (7e)
     SuperPoint at the inputs of the benchmark cell
     ``superpoint_lightglue.seq2048``: ``SuperPointDetector.from_file(
     max_features=2048, min_response=5e-4, min_feature_distance=4)
     .detect`` on 1024x768 ``uint8`` frames, where kernel 6 takes its list
     path, each detection's uv and num held bit for bit to the plain
     suppression (``ops/detect.py::suppress_candidates``) on the ranked
     scores of the heatmap that detection computed, kernel 6's launch
     count set to 0 just before and read just after (one launch per
     detection), its device time per launch and a detection's time.
  8. The parallel layer (``feature_tracker_tpu_torch/parallel``) and the
     SLAM back end, each sub-phase timed: (a) ``make_mesh()`` in this
     process (one rank, its own NCCL group): ``track_klt_sharded`` with
     ``BasicKlt`` FAST, ``AffineKlt`` and ``LssdKlt`` at the headline shape,
     bit-equal to the unsharded trackers at one kernel launch per call and
     timed against them, and ``track_direct_sharded`` at the KITTI plane in
     all three modes, bit-equal to ``DirectMethod``; (b) two ranks spawned
     on the one card, joined by gloo over a FileStore: the same sharded
     trackers (uv and statuses bit-equal to one rank's), the direct method
     (statuses equal, uv within 1e-3 px) and the landmark-sharded BA at the
     launcher's problem (65536 landmarks, 4 views each, 8 poses, 10
     iterations: JAX's sharded tolerances against one rank, and one reduced
     camera system all-reduced per step); (c) that BA on the card against
     the CPU, two card runs bit-equal, ms per Gauss-Newton iteration, the
     device's idle share and ``measure_overhead_vs_landmarks`` up to 262144
     landmarks; (d) ``demos/slam_demo.py``'s path on six rendered
     KITTI-shaped frames: ``TrackingFrontEnd`` (one FAST launch per tracked
     frame), landmarks from frame 0 at the plane's true depth,
     ``SlidingWindowBa`` with the demo's settings, the direct method as a
     cross-check; the camera positions near the truth and the direct
     method's, the same path on the CPU giving the same tracks and BA.
  9. Training, each sub-phase timed, TF32 off, every step held to the same
     step on the CPU from the same state (the loss; the clipped gradients,
     read from Adam's first moments, each leaf within 1e-3 of its largest;
     the parameters where the gradient counts; the new batch statistics):
     (a) RAFT at full width (``RaftConfig(max_iterations=8)``, from
     ``weights/raft.npz`` with a fresh optimizer, lr 3e-4) on
     ``raft_pretrain.make_pool`` batches of 4 x 128x128, the shipped model's
     training shape: one step against the CPU, then 20 steps timed (ms per
     step, peak memory, the device's idle share), and the step at 4 x
     368x496 with 12 iterations (the RAFT paper's FlyingChairs crop); (b)
     the unsupervised photometric step on the same pool; (c) two ranks on
     the one card (gloo, the batch split 2 + 2) against the one-rank step,
     with the all-reduced bytes counted; (d) a checkpoint at step 5
     restored into a fresh state, step 6 both ways (bit-equal, or within
     twice the spread of identical runs), retention and a restore without a
     checkpoint; (e) the SuperPoint, DISK and LightGlue trainers at their
     shipped configurations and weights with their trainers' defaults: one
     step against the CPU, then 20 steps timed and profiled; (f)
     ``raft_pretrain.main(steps=20, h=128, w=128, batch=4, iters=8)``
     writing into a temporary directory, its held-out line printed, and
     every file under ``weights/`` byte for byte as before the run; (g)
     height sharding, ranks sharing the card through gloo (agreement,
     memory and traffic, not scaling): (i) the supervised and the
     unsupervised step on a ("data", "model") = (1, 2) mesh against the
     one-rank step, and the (1, 2) step timed; (ii) the (1, 2) step at the
     FlyingChairs crop, each rank's peak memory beside the one-rank peak;
     (iii) a (2, 2) mesh on four ranks; for each, every rank's band rows
     (its input, first encoder activation and fmap0) and its collectives
     by operation against ``expected_train_comm``, and the ranks' states
     equal bit for bit; (iv) the ``low_memory`` step on the card against
     the CPU, with no launch of the lookup kernel.
 10. Pretraining (``train/pretrain.py``, ``train/cotracker_pretrain.py``),
     each sub-phase timed, TF32 off, every step held to the same step on
     the CPU from the same state by phase 9's rules, within twice the
     CPU's own one-ulp spread where that is larger, then 20 steps timed
     (CUDA events: ms per step, peak memory; torch.profiler: the device's
     idle share): the pools of ``adapt_superpoint`` (Harris labels on the
     card, with and without point descriptors) and
     ``distill_superpoint_from_disk`` (DISK labels, the DISK teacher's
     targets) at 4 x 96x96, built by the stages; (a) SuperPoint's training
     mode (``train=True``) on them from ``weights/superpoint.npz``: outputs
     and the new running statistics; (b) the SuperPoint step with
     ``point_desc`` off and on and the distillation step; (c) the DISK step
     (192 samples at 96x96) and ``train_disk``, the LightGlue step at
     ``train_lightglue``'s defaults (160x160, 192 keypoints, depth 9) on the
     shipped SuperPoint's detections, ``train_lightglue`` and
     ``evaluate_matching`` on 4 pairs; (d) ``reference_pair_counts`` and
     ``reference_pair_lightglue_counts`` with the shipped detector (300
     keypoints) and LightGlue on the synthetic 752x480 pair put in place of
     the reference pair, one FAST-kernel launch per ``_klt_verified``
     (counted), the raw counts equal to the CPU's and the verified ones
     within phase 2's status rule; (e) CoTracker's train step with the
     parameter average at the shipped run's configuration and weights
     (4 clips of 8x96x96, 24 points): its loss, and every Adam moment 0 on
     both sides (the global gradient norm overflows float32); at one
     refinement iteration, where every leaf has a finite gradient that is
     not 0, its moments; (f) ``pretrain.main`` and
     ``cotracker_pretrain.main`` with two or three steps per stage at full
     width into a temporary directory: JAX's files and ``metrics.json``
     keys, and every file under ``weights/`` as before.
 11. The demos (``feature_tracker_tpu_torch/demos/``, in ``run.sh``'s
     order), each ``run`` on the card at the demo's own size with its PNGs
     written into a temporary directory, the launch counts set to 0 just
     before and read just after: kernels 1, 3 and 4 once per ``track``
     call the demo made (``track_demo`` 11 each, ``stream_demo`` one per
     tracked frame, ``slam_demo`` and ``cotracker_demo`` 5), no launch in
     the other demos. Each is held to the same ``run`` on the CPU: KLT
     statuses by phase 2's rule and uv within 1e-3 px (5e-3 px for the
     affine and SE(2) trackers), the median tracked flow within 0.2 px of
     the synthetic pair's (-3, +5), the direct poses within 1e-5 of the
     CPU's and of the synthetic set's pure translation, Farnebäck by
     interior statistics, BRIEF exactly, the learned detectors' keypoints
     and matches per keypoint, the SLAM window BA by phase 8's rules with
     the CPU's one-ulp spread, CoTracker within twice the card's one-ulp
     spread, the stream against the CPU on the frames that came through
     the ring; overlays differ in at most 0.1 % of their pixels. Every
     file under ``demos/`` and ``weights/`` is hashed before and after,
     and each demo's wall ms is printed with the card.
 12. The timing and evaluation scripts (``feature_tracker_tpu_torch/
     scripts/``) at the JAX scripts' sizes, the launch counts set to 0
     before each call and read after it: ``raft_bf16_eval`` ``accuracy``
     and ``anytime`` (16 pairs of 64x64, the shipped compact weights; no
     kernel) held to the same functions on the CPU (float32 EPE within
     1e-3 px, bfloat16 within 0.05 px of float32), ``speed`` and
     ``speed_sidecar`` at 1x440x1024 (kernel 5 once per iteration: 1 or 12
     launches a call, 12 / 6 / 12 in the sidecar), ``split`` at 55x128
     (12 launches a lookup loop, the loop held to the same loop on the
     plain lookup); ``time_klt_modes`` fast / direct / inverse at N=10240
     (one launch of kernel 1 or 2 a call, ``tracked`` against the plain
     path by phase 2's rule); ``klt_multipair`` at K = 1, 2, 4 (one launch
     a composite call, K a sequential one; the composite held to the
     sequential calls on the features its parity rule covers and to the
     native CPU port by phase 2's rule; times by events, and device
     times with the host's enqueue hidden behind a stream sleep). Every
     file under ``weights/`` is hashed before and after.
Then one JSON line with the kernels of the paths (kernels 1, 3 and 4 also
with their launches on the sharded paths, kernel 1 with those of phase
10d, kernel 6 with those of phase 7e, and with their launches in the
demos; kernels 1, 2 and 5 with their
launches in phase 12's scripts), the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA device, and outside a checkout of the
repository (the port and its kernel sources are imported from beside this
file).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

H, W, LEVELS, N = 480, 752, 4, 10240       # headline shape
PAIR_SHIFT = (7.0, -4.0)                   # (dx, dy) of the headline pair
FRAMES, FRAME_SHIFT = 24, (0.6, -0.35)     # front-end sequence, px / frame
REPEATS = 25                               # timed runs per median
UV_TOL = 1e-3                              # px, commonly tracked features
WARP_FRAMES = 8                            # front-end frames per new tracker
# Affine / SE(2) kernels against their plain versions. Their 6x6 / 3x3
# systems hold absolute pixel coordinates and are ill-conditioned: with
# float32 sums the order of the patch sums alone showed through the solve
# (up to 0.08 px on a few lanes), which is why both sides accumulate the
# system in float64. The limits are what a float32 system could still meet.
WARP_UV_P99, WARP_UV_MAX = 1e-3, 5e-2      # px, commonly tracked features
AFFINE_P99, ROT_P99 = 5e-3, 1e-4           # matrix entries, 99th percentile
# The SE(2) kernel against its plain level loop, held tighter: at most 0.1 %
# of the statuses flip (at least 1), and every commonly tracked position and
# rotation entry agrees (both sides accumulate in float64).
LSSD_UV_MAX, LSSD_ROT_MAX = 1e-3, 1e-4
# RAFT: the serving shape, and the limits of its comparisons.
RAFT_H, RAFT_W, RAFT_B, RAFT_ITERS, RAFT_CALLS = 440, 1024, 4, 6, 3
RAFT_SHIFTS = ((3.0, -2.0), (-1.5, 2.5))   # (dx, dy) of the pairs, px
LOOKUP_TOL = 1e-4       # |kernel - plain| <= LOOKUP_TOL * (1 + |plain|)
# Float32 flows of the three lookup routes (kernel, plain, materialised
# volume): the routes differ by ~1e-6 per lookup (order of the sums) and
# six iterations of a randomly weighted update block feed that back.
RAFT_ROUTE_TOL = 5e-3   # px
# bfloat16 against float32 flow, px: loose, the weights are random.
RAFT_BF16_MEDIAN, RAFT_BF16_P99 = 0.25, 1.5
RAFT_CPU_TOL = 1e-3     # px, compact model on the card against the CPU
# Phase 5d. CoTracker2's online window at the published widths: 8 frames of
# 384x512 and a 50x50 grid of queries, as the benchmark's online cell.
COT_H, COT_W, COT_FRAMES, COT_GRID = 384, 512, 8, 50
# The port's window against the plain reference, mean gaps in px and in the
# visibility logits: float32 differs by the order of its sums (~1e-4 px);
# bfloat16 by its precision (0.06-0.08 px in the benchmark's windows).
COT_F32_TOL, COT_BF16_TOL = 1e-3, 0.2
# Phase 6. The BRIEF pipeline (bench.py's w_brief_match): 300 corners, a
# Hamming threshold of 60 and a 50 px gate; the JAX package matches 54 and
# 282 features at the two responses on this pair.
BRIEF_CAP, BRIEF_RESPONSES = 300, ((40.0, 54), (10.0, 282))
BRIEF_COUNT_SLACK = 5           # matched count within this of JAX's
# The direct method at KITTI's shape and intrinsics (bench.py's w_direct).
KITTI_W, KITTI_H, KITTI_LEVELS, DIRECT_N = 1241, 376, 5, 300
KITTI_K4 = (718.856, 718.856, 607.1928, 185.2157)
PLANE_Z = 5.0                   # the textured plane's depth
DIRECT_POSE_TOL, DIRECT_UV_TOL = 1e-5, 1e-3
# Farnebäck on the card against the CPU: statistics over interior pixels
# (the flow is chaotic at the last bit, through bfloat16 roundings).
DENSE_MARGIN, DENSE_MEAN, DENSE_P99, DENSE_FAR, DENSE_FAR_SHARE = (
    20, 1e-3, 5e-3, 0.05, 0.005)
# Phase 7: the neural models on their shipped weights (weights/*.npz), each
# on the card against the same model on the CPU.
MODEL_CAP = 300                 # keypoints per frame (SuperPoint, DISK)
DESC_TOL, SCORE_TOL = 1e-5, 1e-3
LG_BENCH_N = 256                # bench.py's w_lightglue
# 7e: SuperPoint at the superpoint_lightglue.seq2048 cell's inputs (frame
# height and width, keypoints kept, detection threshold, radius in px).
SP_CELL_H, SP_CELL_W, SP_CELL_CAP, SP_CELL_RESPONSE, SP_CELL_RADIUS = (
    768, 1024, 2048, 5e-4, 4)
SP_CELL_FRAMES = 3
# CoTracker: the training shape of metrics.json, then a longer, larger
# clip; (frames, height, width, queries). The texture moves COT_STEP px
# per frame. Each iteration is held from the CPU's positions; the whole
# run against the card's own spread under a one-ulp change of the video
# (the flow embedding's high channels, see models/cotracker.py).
COT_CLIPS = ((8, 96, 96, 24), (24, 384, 512, 256))
COT_STEP = (0.7, -0.4)
COT_TRACK_TOL, COT_VIS_TOL = 1e-3, 1e-3
# Phase 8: the parallel layer. The landmark-sharded BA at the launcher's
# default problem (parallel/scaling.py::_make_problem: landmarks, views per
# landmark, poses) and JAX's sharded tolerances (tests/test_parallel.py:
# q 1e-4; t rtol/atol 1e-3; landmarks rtol 1e-3, atol 5e-3). The rms
# history of two ranks is held to one rank's within 1e-4 relative, the
# card's to the CPU's within 1e-3, or within twice the one-rank history's
# own spread under a one-ulp change of its inputs where that is larger:
# on this noise-free problem the history falls to ~1.5e-4 px, where a
# one-ulp change of the observations moves it by up to ~6e-4 relative
# (ROADMAP.md section 3).
BA_L, BA_O, BA_P, BA_ITERS = 65536, 4, 8, 10
BA_RMS_RANKS, BA_RMS_CPU = 1e-4, 1e-3
BA_Q_TOL, BA_T_TOL, BA_LM_RTOL, BA_LM_ATOL = 1e-4, 1e-3, 1e-3, 5e-3
SWEEP_L = (8192, 65536, 262144)
# The SLAM back end (demos/slam_demo.py's path) on SLAM_FRAMES frames of the
# KITTI plane: camera k at k * SLAM_STEP (m) turned k * SLAM_YAW (rad) about
# y; the window and BA settings of the demo. Camera positions are held to
# the truth and to the direct method's within SLAM_POS_TOL m.
SLAM_FRAMES, SLAM_STEP, SLAM_YAW = 6, (0.01, -0.005, 0.02), 0.001
SLAM_POS_TOL = 0.01
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores.
# Phase 9: the shipped RAFT's own training shape (weights/metrics.json
# "raft": batch 4, 128x128, 8 iterations), and the RAFT paper's
# FlyingChairs crop and training iteration count.
TRAIN_SHAPE = (4, 128, 128)
TRAIN_ITERS = 8
CHAIRS = (4, 368, 496, 12)
TRAIN_STEPS = 20
RAFT_VARIABLES = 3435088        # RaftConfig()'s parameters + statistics
TRAIN_GRAD_TOL = 1e-3           # of a leaf's largest |g|, card vs CPU
TRAIN_GRAD_FLOOR = 1e-6         # of the largest |g| over all leaves
TRAIN_ZERO_GRAD = 1e-5          # of the largest, where the gradient is 0
TRAIN_PARAM_TOL = 1e-6          # where |g| counts (moments_agree)
BAND_MESHES = ({"data": 1, "model": 2}, {"data": 2, "model": 2})
BAND_STEPS = 6                  # timed (1, 2) steps on each rank
TRAIN_LOSS_RTOL = 1e-4
TRAIN_STATS_RTOL, TRAIN_STATS_ATOL = 1e-4, 1e-5
# Phase 10: the pretraining stages. train_superpoint's batch and images;
# the pool entries built per SuperPoint step kind; train_lightglue's
# defaults (height, width, keypoints, depth); the shipped CoTracker run's
# batch, frames, height, width and points (weights/metrics.json); the
# reference-pair counts' keypoints and the share of KLT statuses that may
# differ between the card and the CPU (phase 2's rule). SuperPoint's
# training mode on the card against the CPU: the heatmap absolutely, the
# descriptors relative to their largest.
PRE_SHAPE = (4, 96, 96)
PRE_POOL = 8
LG_PRE = (160, 160, 192, 9)
COT_TRAIN = (4, 8, 96, 96, 24)
PRE_COUNT_CAP = 300
KLT_STATUS_SHARE = 1e-3
SP_TRAIN_HEAT_TOL, SP_TRAIN_DESC_TOL = 1e-5, 1e-4
# pretrain.main's metrics.json keys without the reference pair (phase 10f).
PRETRAIN_KEYS = ["superpoint", "superpoint_adapt", "disk", "lightglue",
                 "heldout", "lightglue_disk", "heldout_disk", "wall_s"]
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cotracker2_reference():
    """The plain float32 CoTracker2 reference that the benchmark holds the
    port to (``benchmark/reference/cotracker2.py``), loaded by path: an
    installed ``benchmark`` or ``tests`` package may shadow the
    repository's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_ftk_cotracker2_reference",
        os.path.join(ROOT, "benchmark", "reference", "cotracker2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def clock_line(label: str) -> None:
    """The card's SM clock, its maximum, power draw and temperature now
    (nvidia-smi): kernel times are read beside them, since a card that has
    lowered its clock runs the same kernel slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"[clocks] {label}: SM clock, max, power, temperature: "
          f"{out.strip().splitlines()[0]}")


def cuda_ms(fn, repeats: int = REPEATS, warmup: int = 3,
            batch: int = 1) -> float:
    """Median over ``repeats`` samples of the time per ``fn()`` call in ms,
    by CUDA events around ``batch`` back-to-back calls. With ``batch > 1``
    the host enqueues ahead of the device, so a kernel's time excludes the
    host's launch overhead; with ``batch == 1`` a call that is cheap on the
    device measures the host's enqueue time too."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def uniform_features(n, h, w, margin, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, w - margin, n),
                     rng.uniform(margin, h - margin, n)],
                    -1).astype(np.float32)


def status_agreement(label, ks, ps, limit):
    """Statuses of kernel and plain version as numpy; at most ``limit``
    may differ. Returns the mask of lanes both track."""
    n = len(ks)
    mismatch = int((ks != ps).sum())
    print(f"[compare] {label}: n={n} tracked kernel={int((ks == 1).sum())} "
          f"plain={int((ps == 1).sum())} status mismatches={mismatch} "
          f"(limit {limit})")
    check(mismatch <= limit, f"{label}: {mismatch} status mismatches of {n}")
    return (ks == 1) & (ps == 1)


def compare_klt(label, opts, rp, cp, uv, skip, status=None):
    """A basic-KLT kernel against its plain version on the same card
    inputs: the FAST kernel, or with ``status`` (the incoming statuses) the
    DIRECT / INVERSE kernel in ``opts.method``.
    Returns (max |duv| on commonly tracked features, plain GN steps)."""
    from feature_tracker_tpu_torch.ops import cuda_klt
    from feature_tracker_tpu_torch.trackers.klt import basic

    if status is None:
        wrapper, plain = (cuda_klt.track_pyramid_fast_cuda,
                          basic.track_pyramid_fast_reference)
        args = (opts, rp, cp, uv, uv, skip)
    else:
        wrapper, plain = (cuda_klt.track_pyramid_iter_cuda,
                          basic.track_pyramid_iter_reference)
        args = (opts, rp, cp, uv, uv, status, skip)
    before = wrapper.launches
    ku, ks = wrapper(*args)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1,
          f"{label}: the wrapper did not launch the kernel")
    pu, ps, steps = plain(*args, with_steps=True)
    ku, pu = ku.cpu().numpy(), pu.cpu().numpy()
    # Sums run in another order than in the plain version: at most 0.1 %
    # of statuses (at least 1) may flip at the convergence threshold.
    both = status_agreement(label, ks.cpu().numpy(), ps.cpu().numpy(),
                            max(1, len(ku) // 1000))
    err = float(np.abs(ku[both] - pu[both]).max()) if both.any() else 0.0
    print(f"[compare] {label}: max|duv| on both-tracked={err:.3g} px")
    sk = skip.cpu().numpy()
    check(np.array_equal(ku[sk], uv.cpu().numpy()[sk]),
          f"{label}: a skipped lane moved")
    check(np.isfinite(ku).all(), f"{label}: non-finite kernel uv")
    check(err <= UV_TOL, f"{label}: max |duv| {err} > {UV_TOL}")
    return err, steps


class LevelRecorder:
    """Stands in for a warp tracker's per-level function inside its level
    loop: runs the CUDA kernel or the plain version, and keeps each
    level's inputs, outputs and (plain) steps."""

    def __init__(self, kind, plain):
        self.kind, self.plain, self.levels = kind, plain, []

    def __call__(self, opts, *args):
        from feature_tracker_tpu_torch.ops import cuda_warp_klt as cw
        from feature_tracker_tpu_torch.trackers.klt import affine, lssd

        args = list(args)
        del args[-2]      # the incoming status: FAST mode rewrites it
        steps = None
        if self.plain:
            fn = (affine.affine_track_level_reference if self.kind == "affine"
                  else lssd.lssd_track_level_reference)
            *out, steps = fn(opts, *args, with_steps=True)
        else:
            fn = (cw.affine_track_level_cuda if self.kind == "affine"
                  else cw.lssd_track_level_cuda)
            out = fn(opts, *args)
        self.levels.append({"args": args, "out": out, "steps": steps})
        return tuple(out)


def p99_and_max(a, b, both):
    d = np.abs(a.cpu().numpy()[both] - b.cpu().numpy()[both])
    if d.size == 0:
        return 0.0, 0.0
    d = d.reshape(len(d), -1).max(axis=1)
    return float(np.percentile(d, 99)), float(d.max())


def compare_warp(label, tracker, rp, cp, uv, status=None):
    """A warp tracker's ``track`` on the card (one launch for the whole
    pyramid) against the level loop through the one-level kernel (the same
    bits) and through the plain versions.
    Returns (max |duv| on commonly tracked features, the kernel run's and
    the plain run's LevelRecorder, the tracker's uv and status)."""
    from feature_tracker_tpu_torch.ops import cuda_warp_klt as cw
    from feature_tracker_tpu_torch.trackers import klt

    kind = "affine" if isinstance(tracker, klt.AffineKlt) else "lssd"
    wrapper = (cw.affine_track_pyramid_cuda if kind == "affine"
               else cw.lssd_track_pyramid_cuda)
    before = wrapper.launches
    tu, tst = tracker.track(rp, cp, uv, None, status)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1,
          f"{label}: {wrapper.launches - before} launches in track(), "
          "expected 1")
    ref_uv, cur_uv, st0 = tracker._prep(uv, None, status)

    def run(plain):
        rec = LevelRecorder(kind, plain)
        if kind == "affine":
            out = klt.affine_pyramid(tracker.options, rp, cp, ref_uv, cur_uv,
                                     st0, level_fn=rec)
        else:
            out = klt.lssd_pyramid(
                tracker.options, tracker.consider_patch_luminance, rp, cp,
                ref_uv, cur_uv, st0,
                tracker._f32(tracker.predict_rotation), level_fn=rec)
        return out, rec

    (ku, kst), krec = run(plain=False)
    (pu, pst), prec = run(plain=True)
    check(torch.equal(ku, tu) and torch.equal(kst, tst),
          f"{label}: track() and its level loop disagree")
    flips = len(ku) // (100 if kind == "affine" else 1000)
    both = status_agreement(label, kst.cpu().numpy(), pst.cpu().numpy(),
                            max(1, flips))
    uv_p99, uv_max = p99_and_max(ku, pu, both)
    # The warp of the finest level: affine, or rotation.
    m_p99, m_max = p99_and_max(krec.levels[-1]["out"][1 if kind == "affine"
                                                      else 0],
                               prec.levels[-1]["out"][1 if kind == "affine"
                                                      else 0], both)
    m_name, m_lim = (("affine", AFFINE_P99) if kind == "affine"
                     else ("rotation", ROT_P99))
    print(f"[compare] {label}: |duv| p99={uv_p99:.3g} max={uv_max:.3g} px; "
          f"{m_name} entries p99={m_p99:.3g} max={m_max:.3g}")
    check(np.isfinite(ku.cpu().numpy()[both]).all(),
          f"{label}: non-finite kernel uv")
    check(uv_p99 <= WARP_UV_P99, f"{label}: p99 |duv| {uv_p99}")
    check(uv_max <= WARP_UV_MAX, f"{label}: max |duv| {uv_max}")
    check(m_p99 <= m_lim, f"{label}: p99 {m_name} difference {m_p99}")
    if kind == "lssd":
        check(uv_max <= LSSD_UV_MAX and m_max <= LSSD_ROT_MAX,
              f"{label}: max |duv| {uv_max}, max rotation difference "
              f"{m_max}")
    return uv_max, krec, prec, tu, tst


def klt_work(opts, pyr_shapes, n, n_tracked, steps, mode="fast"):
    """(bytes, FLOPs) the whole-pyramid basic KLT needs on these inputs:
    each pyramid level of both frames read once, uv/skip (and status) in
    and uv/status out once; per tracked feature and level the reference
    setup, and per Gauss-Newton step actually taken the resample, residual,
    products and solve. ``mode``: fast, inverse or direct; DIRECT resamples
    the extended patch every step, and both rebuild H every step."""
    pix = sum(h * w for h, w in pyr_shapes)
    nbytes = 2 * pix * 4 + n * (8 + 8 + 1) + n * (8 + 1)
    ex_n = opts.ex_patch_rows * opts.ex_patch_cols
    p_n = opts.patch_rows * opts.patch_cols
    if mode == "fast":
        setup = ex_n * 7 + p_n * 8 + 10    # bilinear taps; grads and H
        per_step = p_n * 12 + 14           # taps, dt, b; solve and update
    else:
        nbytes += n                        # the incoming status
        setup = ex_n * 7
        taps = p_n if mode == "inverse" else ex_n
        per_step = taps * 7 + p_n * 13 + 18  # taps; grads, dt, H, b; solve
    flops = n_tracked * len(pyr_shapes) * setup + int(steps) * per_step
    return nbytes, flops


def warp_level_work(kind, opts, img_shape, n, n_tracked, steps,
                    luminance=False):
    """(bytes, FLOPs) of one level of a warp tracker on these inputs: both
    images read once, the per-feature state in and out once; per tracked
    feature the reference setup (affine: and the 21 sums of H), per step
    actually taken the warp, a bilinear sample with its own weights (15),
    the residual, the system's sums and its solve (counted as ~2/3 n^3 +
    2 n^2 operations)."""
    h, w = img_shape
    ex_n = opts.ex_patch_rows * opts.ex_patch_cols
    p_n = opts.patch_rows * opts.patch_cols
    if kind == "affine":
        nbytes = 2 * h * w * 4 + n * (8 + 8 + 16 + 1) + n * (8 + 16 + 1)
        setup = ex_n * 7 + p_n * (2 + 2 + 4 + 42)
        per_step = p_n * (8 + 15 + 1 + 14) + 216 + 14
    else:
        nbytes = 2 * h * w * 4 + n * (8 + 16 + 8 + 1) + n * (16 + 8 + 1)
        setup = ex_n * 7 + p_n * (2 + (4 if luminance else 0))
        per_step = (p_n * (10 + 15 + 1 + 9 + 18 + (1 if luminance else 0))
                    + 36 + 25)
    return nbytes, n_tracked * setup + int(steps) * per_step


def print_phases(label, clocks, units, unit):
    """One line with a phase-clock profile (``read_phase_clocks``)."""
    shares = ", ".join(f"{name} {share:.3f}"
                       for name, share in clocks["share"].items())
    print(f"[phases] {label}: {clocks['clocks'] / units:.0f} SM clocks per "
          f"{unit} (all resident warps share the SM); shares: {shares}")


def bound(nbytes, flops):
    """(least ms the card could take, which resource bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def drive_front_end(label, fe, frames, wrapper, launches_per_frame,
                    min_live, true_flow):
    """Drive ``fe`` over ``frames`` with ``wrapper``'s launch count set to
    0 just before and read just after; check launches, live tracks, ids
    and the median tracked flow. Returns (launches, results, seconds per
    frame)."""
    from feature_tracker_tpu_torch.core.status import TrackStatus

    wrapper.launches = 0
    results, frame_s = [], []
    for f in frames:
        t0 = time.perf_counter()
        results.append(fe.process_frame(f))   # ends in a device-to-host copy
        frame_s.append(time.perf_counter() - t0)
    launches = wrapper.launches
    tracked_frames = len(frames) - 1
    check(launches == tracked_frames * launches_per_frame,
          f"{label}: {launches} kernel launches over {tracked_frames} "
          f"tracked frames, expected {launches_per_frame} each")
    flows, kept = [], []
    for prev, res in zip(results, results[1:]):
        check(res.num_live >= min_live,
              f"{label} frame {res.frame_id}: {res.num_live} live tracks")
        check(np.isfinite(res.uv).all(), f"{label} frame {res.frame_id}: uv")
        # Lanes alive before and after whose id was not handed out this
        # frame are survivors: they must keep their id.
        old = (prev.track_ids >= 0) & (res.track_ids >= 0) & (
            res.track_ids <= prev.track_ids.max())
        check(np.array_equal(res.track_ids[old], prev.track_ids[old]),
              f"{label} frame {res.frame_id}: a surviving track changed "
              "its id")
        surv = old & (res.status == int(TrackStatus.TRACKED))
        kept.append(int(surv.sum()))
        flows.append(res.uv[surv] - prev.uv[surv])
    flow = np.median(np.concatenate(flows), axis=0)
    from_first = np.intersect1d(
        results[0].track_ids[results[0].track_ids >= 0],
        results[-1].track_ids)
    print(f"[front end] {label}: {len(frames)} frames 752x480: "
          f"launches={launches} "
          f"live min={min(r.num_live for r in results[1:])} survivors/frame "
          f"min={min(kept)} ids kept from frame 0={len(from_first)} "
          f"median flow=({flow[0]:.4f}, {flow[1]:.4f}) true={true_flow}")
    check(np.abs(flow - np.asarray(true_flow)).max() <= 0.05,
          f"{label}: median flow {flow} vs true {true_flow}")
    check(min(kept) >= min_live // 2,
          f"{label}: only {min(kept)} tracks survived a frame")
    return launches, results, frame_s


def replenished_frames(results, min_live):
    """How many frames of a front-end run replenished: the first, and each
    whose surviving tracks (alive before and after, with an id handed out
    before this frame) fell below ``min_live``."""
    from feature_tracker_tpu_torch.core.status import TrackStatus

    n = 1
    for prev, res in zip(results, results[1:]):
        old = (prev.track_ids >= 0) & (res.track_ids >= 0) & (
            res.track_ids <= prev.track_ids.max())
        n += int((old & (res.status == int(TrackStatus.TRACKED))).sum()
                 < min_live)
    return n


def suppression_phase(dev, card, frames, launches):
    """Phase 4b: kernel 6 against the plain path (``ops/detect.py::
    suppress_candidates``) on the same ranked candidates of the front end's
    first frame, bit for bit; its device time per launch (profiler), and
    detection per call with the kernel and with the plain path (host clock
    to a synchronise, median of 20). Returns its entry of the kernels line,
    with ``launches``, its launches on the main path (phase 3)."""
    from feature_tracker_tpu_torch.core.config import HarrisOptions
    from feature_tracker_tpu_torch.ops import cuda_detect, detect

    wrapper = cuda_detect.suppress_candidates_cuda
    t = torch.as_tensor(frames[0], device=dev)
    shape = tuple(t.shape)

    def detect_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    def plain_detect(opts, max_num):
        ranked = detect.ranked_candidates(t, opts)
        return detect.suppress_candidates(*ranked, shape, max_num,
                                          opts.min_feature_distance)

    entry = None
    for label, opts, max_num in (
            ("front end", HarrisOptions(), 300),
            ("no early stop", HarrisOptions(), 2000),
            ("6 px, a 197 KB grid", HarrisOptions(min_feature_distance=6),
             5000),
            ("3 px, list path", HarrisOptions(min_feature_distance=3), 5000)):
        args = (*detect.ranked_candidates(t, opts), shape, max_num,
                opts.min_feature_distance)
        got, want = wrapper(*args), detect.suppress_candidates(*args)
        check(torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]),
              f"kernel 6 ({label}): not the plain path's uv and num")
        k_ms = queued_ms(lambda: wrapper(*args))
        k_dev = device_ms(lambda: wrapper(*args), "detect_suppress_kernel",
                          k_ms)
        with_kernel = detect_ms(lambda: detect.detect_good_features(
            t, max_num, opts, device=dev))
        plain = detect_ms(lambda: plain_detect(opts, max_num))
        print(f"[time] suppression kernel {shape[1]}x{shape[0]}, {label} "
              f"(max_num {max_num}, distance {opts.min_feature_distance}): kept "
              f"{int(got[1])}, the plain path's bits; {k_dev * 1e3:.2f} us "
              f"device time per launch (profiler), {k_ms * 1e3:.2f} us "
              f"queued; detect_good_features {with_kernel:.4f} ms per call, "
              f"with the plain path {plain:.4f} ms; {card}")
        if entry is None:
            entry = {"name": "detect_suppress", "route": "cuda",
                     "source": "feature_tracker_tpu_torch/csrc/"
                               "detect_suppress.cu",
                     "replaces": None, "max_abs_err": 0.0, "ms": k_dev,
                     "plain_ms": plain, "detect_ms": with_kernel,
                     "bound_ms": None, "bound_by": None, "library_ms": None,
                     "launches": launches}
    return entry


def profile_window(label: str, fn, calls: int) -> None:
    """Device time by kernel and the device's idle share over ``calls``
    calls of ``fn``, from torch.profiler (diagnostic: printed as not
    measured when the profiler reports no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    dev_rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev_rows)
    if busy_us == 0:
        print(f"[profile] {label}: device time not measured (the profiler "
              "reported none)")
        return
    print(f"[profile] {label}, {calls} calls: wall {wall_us / calls:.1f} "
          f"us/call, device busy {busy_us / calls:.1f} us/call, idle share "
          f"{1 - busy_us / wall_us:.4f}")
    for e in sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / calls:9.1f} us/call"
              f" {e.count / calls:6.1f} launches/call  {e.key[:70]}")


def device_ms(fn, kernel: str, events_ms: float, calls: int = 20) -> float:
    """Mean device time in ms of one launch of the kernels whose name holds
    ``kernel``, over ``calls`` calls of ``fn`` under torch.profiler: the
    kernel's own time, without the host's enqueue time that a timing of
    back-to-back calls includes when the kernel is shorter than it. Where
    the profiler reports no device time, ``events_ms`` (the timing by CUDA
    events) stands in, and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key
            and e.self_device_time_total > 0]
    launches = sum(e.count for e in rows)
    if launches == 0:
        print(f"[time] {kernel}: device time not measured (the profiler "
              "reported none); the CUDA events' time stands in")
        return events_ms
    return sum(e.self_device_time_total for e in rows) / launches / 1e3


def queued_ms(fn, repeats: int = 20, sleep_cycles: int = 40_000_000):
    """Median device time in ms of one ``fn()`` call with the host's
    enqueue hidden: the stream first spins for ``sleep_cycles`` SM clocks
    (``torch.cuda._sleep``, ~20 ms), long enough for the host to enqueue the
    start event, the call and the end event behind it, so the events time
    the call's kernels back to back. torch.profiler has lost the kernel
    records of such one-launch calls late in this script."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def lookup_inputs(dev, seed, b, h, w, c, levels, spread=None):
    """Feature maps, pooled pyramid and lookup locations on ``dev`` from a
    numpy seed. ``spread=None``: locations uniform from -8 to max(h, w) + 8
    (whole windows and single taps leave the map) with a few NaN, infinite
    and 1e9 entries; else the pixel grid plus N(0, spread) px."""
    from feature_tracker_tpu_torch.models.raft import pool_feature_pyramid

    rng = np.random.default_rng(seed)
    f0 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    if spread is None:
        locs = rng.uniform(-8, max(h, w) + 8, (b, h, w, 2))
        locs[0, 0, :5, 0] = [np.nan, np.inf, -np.inf, 1e9, -1e9]
        locs[-1, -1, -3:, 1] = [np.nan, 1e9, np.inf]
    else:
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        locs = np.stack([gx, gy], -1)[None] + rng.normal(0, spread,
                                                         (b, h, w, 2))
    f0, f1, locs = (torch.from_numpy(a.astype(np.float32)).to(dev)
                    for a in (f0, f1, locs))
    pyr = [p.contiguous() for p in pool_feature_pyramid(f1, levels)]
    return f0, pyr, locs


def boundary_locations(locs, x_from, shift):
    """``locs`` with every query from column ``x_from`` on moved ``shift``
    px in x: a motion boundary."""
    locs = locs.clone()
    locs[:, :, x_from:, 0] += shift
    return locs


def scattered_locations(locs):
    """``locs`` with the odd columns left of column 56 moved 64 px in x and
    the odd rows above row 24 moved 32 px in y: at level 0 the windows of
    one tile lie too far apart to stage."""
    locs = locs.clone()
    locs[:, :, 1:56:2, 0] += 64.0
    locs[:, 1:24:2, :, 1] += 32.0
    return locs


def staged_line(label, f0, pyr, locs, radius, padding="zeros"):
    """Print and return the host mirror of the kernel's staging rule
    (``staged_share``) on these inputs."""
    from feature_tracker_tpu_torch.ops.cuda_raft_lookup import staged_share

    share = staged_share(locs, [p.shape[1:3] for p in pyr], radius,
                         f0.shape[-1], padding)
    copied = 4 * f0.shape[-1] * share["staged_pixels"] + 4 * f0.numel() * len(
        pyr) * share["tiles"]
    print(f"[staged] {label}: {share['tiles']:.4f} of (tile, level) pairs, "
          f"{share['queries']:.4f} of queries staged; mean box pixels per "
          f"level {[round(x, 1) for x in share['box_pixels']]}; tiles by "
          f"chunk {share['chunks']}; {copied / 1e6:.1f} MB copied to shared "
          "memory per launch")
    return share


class LookupRecorder:
    """Stands in for ``Raft.lookup_fn``: passes every call on to the CUDA
    wrapper and keeps the inputs of the latest one."""

    def __init__(self):
        self.last = None

    def __call__(self, fmap0, fpyr, locs, radius, padding="zeros"):
        from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
            lookup_correlation_cuda,
        )
        self.last = (fmap0, list(fpyr), locs)
        return lookup_correlation_cuda(fmap0, fpyr, locs, radius, padding)


def compare_lookup(label, f0, pyr, locs, radius, padding="zeros"):
    """The lookup kernel against its plain version on the same card
    inputs, in ``padding`` mode. Returns max |kernel - plain|."""
    from feature_tracker_tpu_torch.models.raft import lookup_correlation_otf
    from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
        lookup_correlation_cuda,
    )

    before = lookup_correlation_cuda.launches
    got = lookup_correlation_cuda(f0, pyr, locs, radius, padding)
    torch.cuda.synchronize()
    check(lookup_correlation_cuda.launches == before + 1,
          f"{label}: the wrapper did not launch the kernel")
    want = lookup_correlation_otf(f0, pyr, locs, radius, padding)
    k = 2 * radius + 1
    check(got.shape == want.shape
          == tuple(f0.shape[:3]) + (len(pyr) * k * k,),
          f"{label}: shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got - want).abs()
    err = float(diff.max())
    over = int((diff > LOOKUP_TOL * (1 + want.abs())).sum())
    # Border mode clamps a finite location, however far, into the map.
    runaway = ~torch.isfinite(locs).all(-1)
    if padding == "zeros":
        runaway |= (locs.abs() > 1e8).any(-1)
    print(f"[compare] {label}: max|kernel - plain|={err:.3g} on values up "
          f"to {float(want.abs().max()):.3g}; {over} of {diff.numel()} over "
          f"{LOOKUP_TOL} * (1 + |plain|); {int(runaway.sum())} runaway "
          "locations")
    check(over == 0, f"{label}: {over} values differ, max {err}")
    check(bool((got[runaway] == 0).all()),
          f"{label}: a runaway location did not give zeros")
    return err


def lookup_work(f0, pyr, locs, radius, padding="zeros"):
    """(bytes, FLOPs) of one lookup on these inputs: fmap0, every level and
    the locations read once, the output written once; the scaling of
    fmap0; a dot product over C for every grid pixel that lies inside its
    map (a pixel outside costs nothing, a runaway location has none; in
    border mode the grid's centre is first clamped into ``[-r, w_l - 1 +
    r] x [-r, h_l - 1 + r]``, so only a NaN or infinite one has none); the
    four-tap blend of every output value."""
    b, h, w, c = f0.shape
    k = 2 * radius + 1
    out_n = b * h * w * len(pyr) * k * k
    nbytes = 4 * (f0.numel() + sum(p.numel() for p in pyr) + locs.numel()
                  + out_n)
    dots = 0
    for lvl, p in enumerate(pyr):
        centre = locs.double() / 2 ** lvl
        ok = torch.isfinite(centre).all(-1)
        if padding == "border":
            hi = centre.new_tensor([p.shape[2] - 1 + radius,
                                    p.shape[1] - 1 + radius])
            centre = torch.minimum(torch.maximum(
                centre, centre.new_tensor([-radius, -radius])), hi)
        corner = torch.floor(centre) - radius
        ok &= (corner.abs() < 2 ** 30).all(-1)
        corner = corner[ok]
        nx = (torch.clamp(corner[:, 0] + k + 1, max=p.shape[2])
              - torch.clamp(corner[:, 0], min=0)).clamp(min=0)
        ny = (torch.clamp(corner[:, 1] + k + 1, max=p.shape[1])
              - torch.clamp(corner[:, 1], min=0)).clamp(min=0)
        dots += int((nx * ny).sum())
    return nbytes, f0.numel() + dots * 2 * c + out_n * 7


def random_raft_state(model, seed):
    """A ``state_dict`` for ``model`` from a seeded generator: He-normal
    convolutions, batch-norm scales and variances in [0.5, 1.5], small
    biases and means, and a flow head scaled down so that six iterations
    move the flow by a few pixels, not hundreds."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("num_batches_tracked"):
            value = torch.zeros(shape, dtype=torch.long)
        elif ref.dim() == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            value = torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5
        elif key.endswith("running_var") or (
                "BatchNorm" in key and key.endswith("weight")):
            value = torch.rand(shape, generator=gen) + 0.5
        else:
            value = 0.1 * torch.randn(shape, generator=gen)
        if "flow_conv2" in key:
            value = 0.05 * value
        state[key] = value
    return state


def flow_difference(a, b):
    """(median, 99th percentile, max) over pixels of |a - b| in px."""
    d = (a.float() - b.float()).abs().amax(-1).flatten().cpu().numpy()
    return float(np.median(d)), float(np.percentile(d, 99)), float(d.max())


def raft_phases(dev, card):
    """Phase 5 (see the module docstring). Returns the lookup kernel's
    entry for the kernels line."""
    import dataclasses

    from synthetic import Texture

    from feature_tracker_tpu_torch.models import raft
    from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
        TILE,
        lookup_blocks_per_sm,
        lookup_correlation_cuda,
        lookup_phase_clocks,
    )

    # 5a. The kernel against its plain version.
    cfg = raft.RaftConfig(max_iterations=RAFT_ITERS, low_memory=True,
                          upsample_last_only=True)
    radius, levels = cfg.correlation_radius, cfg.correlation_pyramid_levels
    fh, fw, fc = RAFT_H // 8, RAFT_W // 8, cfg.feature_channels
    serving = lookup_inputs(dev, 30, RAFT_B, fh, fw, fc, levels, spread=4.0)
    shape = f"B={RAFT_B} {fh}x{fw} C={fc} L={levels} r={radius}"
    errs = [compare_lookup(f"lookup serving shape {shape}, grid + N(0, 4 px)",
                           *serving, radius),
            compare_lookup(f"lookup {shape}, locations off the map",
                           *lookup_inputs(dev, 31, RAFT_B, fh, fw, fc,
                                          levels), radius),
            compare_lookup("lookup B=2 13x22 C=16 L=3 r=3, off the map",
                           *lookup_inputs(dev, 32, 2, 13, 22, 16, 3), 3),
            compare_lookup("lookup B=1 13x22 C=96 L=2 r=4, off the map",
                           *lookup_inputs(dev, 33, 1, 13, 22, 96, 2), 4)]
    # A smooth flow; a tile that straddles a motion boundary; windows too
    # far apart to stage; a map smaller than a tile; other channel counts
    # (130: not a multiple of 4), radius 4, and one level.
    smooth = lookup_inputs(dev, 34, RAFT_B, fh, fw, fc, levels, spread=0.25)
    f0s, pyrs, locss = smooth
    more = [
        (f"lookup {shape}, grid + N(0, 0.25 px)", smooth, radius, 1.0),
        (f"lookup {shape}, columns from 60 on shifted 40 px",
         (f0s, pyrs, boundary_locations(locss, 60, 40.0)), radius, 1.0),
        (f"lookup {shape}, windows of a tile up to 64 x 32 px apart",
         (f0s, pyrs, scattered_locations(locss)), radius, None),
        ("lookup B=2 5x6 C=32 L=2 r=3, a map smaller than a tile",
         lookup_inputs(dev, 35, 2, 5, 6, 32, 2, spread=1.0), 3, 1.0),
        ("lookup B=2 20x30 C=96 L=3 r=3",
         lookup_inputs(dev, 36, 2, 20, 30, 96, 3, spread=0.5), 3, 1.0),
        ("lookup B=1 13x22 C=130 L=2 r=3",
         lookup_inputs(dev, 37, 1, 13, 22, 130, 2, spread=1.0), 3, 0.0),
        ("lookup B=2 20x30 C=64 L=3 r=4",
         lookup_inputs(dev, 38, 2, 20, 30, 64, 3, spread=0.5), 4, 1.0),
        ("lookup B=2 20x30 C=32 L=1 r=3, one level",
         lookup_inputs(dev, 39, 2, 20, 30, 32, 1, spread=2.0), 3, 1.0)]
    for label, case, rad, want_share in more:
        errs.append(compare_lookup(label, *case, rad))
        got_share = staged_line(label, *case, rad)["queries"]
        check(got_share == want_share if want_share is not None
              else 0.0 < got_share < 1.0,
              f"{label}: {got_share} of the queries staged")

    # 5b. The path at full width.
    refs, curs = [], [[] for _ in RAFT_SHIFTS]
    for item in range(RAFT_B):
        tex = Texture(100 + item, n_waves=16, min_period=5.0,
                      max_period=30.0)
        refs.append(tex.render(RAFT_H, RAFT_W))
        for cur, (dx, dy) in zip(curs, RAFT_SHIFTS):
            cur.append(tex.render(RAFT_H, RAFT_W, warp=lambda x, y: (
                x - dx, y - dy)))
    ref = np.stack(refs)[..., None].astype(np.float32)
    curs = [np.stack(c)[..., None].astype(np.float32) for c in curs]

    model = raft.Raft(cfg, device="cuda")
    state = random_raft_state(model, 40)
    model.load_state_dict(state)
    tf32_outside = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
    lookup_correlation_cuda.launches = 0
    inputs = [(ref, curs[i % len(curs)]) for i in range(RAFT_CALLS)]
    flows = [model(r, c) for r, c in inputs]
    torch.cuda.synchronize()
    launches = lookup_correlation_cuda.launches
    check(launches == RAFT_ITERS * RAFT_CALLS,
          f"raft: {launches} lookup launches in {RAFT_CALLS} calls of "
          f"{RAFT_ITERS} iterations")
    for flow in flows:
        check(flow.shape == (1, RAFT_B, RAFT_H, RAFT_W, 2)
              and flow.dtype == torch.float32 and flow.is_cuda,
              f"raft: output {tuple(flow.shape)} {flow.dtype}")
        check(bool(torch.isfinite(flow).all()), "raft: non-finite flow")
    check(torch.equal(flows[0], flows[len(curs)]),
          "raft: the same pair gave another flow the second time")
    check(not torch.equal(flows[0], flows[1]),
          "raft: two different pairs gave the same flow")
    mags = [float(f.abs().mean()) for f in flows]
    # One more call (after the counts are read) that keeps the inputs of
    # its last lookup: the main path's own locations, timed below.
    recorder = LookupRecorder()
    model.lookup_fn = recorder
    check(torch.equal(model(*inputs[0]), flows[0]),
          "raft: the recorded call gave another flow")
    model.lookup_fn = lookup_correlation_cuda
    real = recorder.last
    print(f"[raft] {RAFT_CALLS} calls {RAFT_W}x{RAFT_H} batch {RAFT_B}, full "
          f"configuration, {RAFT_ITERS} iterations, low_memory: lookup "
          f"launches={launches}; output {tuple(flows[0].shape)}; mean |flow| "
          f"per call {', '.join(f'{m:.3f}' for m in mags)} px (random "
          "weights)")

    # The same model with the lookup forced to the plain version (which also
    # records the TF32 switches inside forward), and with the volume.
    tf32_inside = []

    def plain_lookup(*args):
        tf32_inside.append((torch.backends.cudnn.allow_tf32,
                            torch.backends.cuda.matmul.allow_tf32))
        return raft.lookup_correlation_otf(*args)

    plain_model = raft.Raft(cfg, device="cuda")
    plain_model.load_state_dict(state)
    plain_model.lookup_fn = plain_lookup
    full_model = raft.Raft(dataclasses.replace(cfg, low_memory=False),
                           device="cuda")
    full_model.load_state_dict(state)
    before = lookup_correlation_cuda.launches
    plain_flow = plain_model(*inputs[0])
    torch.cuda.reset_peak_memory_stats()
    full_flow = full_model(*inputs[0])
    full_peak = torch.cuda.max_memory_allocated()
    check(lookup_correlation_cuda.launches == before,
          "raft: the plain and materialised routes launched the kernel")
    check(set(tf32_inside) == {(False, False)}
          and (torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32) == tf32_outside,
          "raft: forward did not switch TF32 off and restore it")
    print(f"[raft] forward ran with cudnn.allow_tf32=False, "
          f"cuda.matmul.allow_tf32=False (outside it: cudnn "
          f"{tf32_outside[0]}, matmul {tf32_outside[1]}, restored)")
    for label, other in (("plain lookup", plain_flow),
                         ("materialised volume", full_flow)):
        med, p99, worst = flow_difference(flows[0], other)
        print(f"[raft] float32 flow, kernel route against {label}: |dflow| "
              f"median={med:.3g} p99={p99:.3g} max={worst:.3g} px (limit "
              f"{RAFT_ROUTE_TOL})")
        check(worst <= RAFT_ROUTE_TOL,
              f"raft: kernel route and {label} differ by {worst} px")
    print(f"[raft] materialised route peak memory "
          f"{full_peak / 2 ** 20:.1f} MiB")
    del plain_model, plain_flow, full_flow

    # bfloat16, the configuration the JAX package's benchmark ships.
    bf16_model = raft.Raft(dataclasses.replace(cfg, dtype=torch.bfloat16),
                           device="cuda")
    bf16_model.load_state_dict(state)
    before = lookup_correlation_cuda.launches
    bf16_flow = bf16_model(*inputs[0])
    check(lookup_correlation_cuda.launches == before + RAFT_ITERS,
          "raft bfloat16: lookup launches")
    check(bf16_flow.dtype == torch.float32
          and bool(torch.isfinite(bf16_flow).all()), "raft bfloat16: output")
    med, p99, worst = flow_difference(flows[0], bf16_flow)
    print(f"[raft] bfloat16 against float32 flow: |dflow| median={med:.3g} "
          f"p99={p99:.3g} max={worst:.3g} px (limits median "
          f"{RAFT_BF16_MEDIAN}, p99 {RAFT_BF16_P99})")
    check(med <= RAFT_BF16_MEDIAN and p99 <= RAFT_BF16_P99,
          f"raft bfloat16: median {med}, p99 {p99} px from float32")

    # A compact model on the card against the same model on the CPU.
    small = raft.RaftConfig(
        max_iterations=3, low_memory=True, feature_channels=64,
        context_channels=64, hidden_channels=32,
        correlation_pyramid_levels=2, correlation_hidden_channels=32,
        correlation_out_channels=16, flow_hidden_channels=16,
        flow_out_channels=8, motion_out_channels=16, mask_hidden_channels=32)
    small_gpu = raft.Raft(small, device="cuda")
    small_cpu = raft.Raft(small, device="cpu")
    small_state = random_raft_state(small_cpu, 41)
    small_gpu.load_state_dict(small_state)
    small_cpu.load_state_dict(small_state)
    crop = (ref[:2, :64, :96], curs[0][:2, :64, :96])
    _, _, worst = flow_difference(small_gpu(*crop).cpu(), small_cpu(*crop))
    print(f"[raft] compact model 96x64 on the card against the CPU: max "
          f"|dflow|={worst:.3g} px (limit {RAFT_CPU_TOL})")
    check(worst <= RAFT_CPU_TOL, f"raft: card and CPU differ by {worst} px")

    # 5c. Timings (the launches here are not the main path's).
    def timed(fn, **kw):
        with torch.inference_mode(), raft.full_float32():
            return cuda_ms(fn, **kw)

    f0, pyr, locs = serving
    kernel_ms = cuda_ms(lambda: lookup_correlation_cuda(f0, pyr, locs,
                                                        radius), batch=10)
    call_ms = cuda_ms(lambda: lookup_correlation_cuda(f0, pyr, locs, radius))
    plain_ms = cuda_ms(lambda: raft.lookup_correlation_otf(
        f0, pyr, locs, radius), repeats=10, warmup=1)
    nbytes, flops = lookup_work(f0, pyr, locs, radius)
    bound_ms, bound_by = bound(nbytes, flops)
    staged_line(f"lookup {shape}, grid + N(0, 4 px) (timed)", *serving,
                radius)
    # The main path's own input: feature maps and locations of the last
    # iteration of the driven call.
    real_ms = cuda_ms(lambda: lookup_correlation_cuda(*real, radius),
                      batch=10)
    real_bytes, real_flops = lookup_work(*real, radius)
    real_bound, real_by = bound(real_bytes, real_flops)
    real_err = compare_lookup("lookup on the driven call's last iteration",
                              *real, radius)
    errs.append(real_err)
    real_share = staged_line("lookup on the driven call's last iteration "
                             "(timed)", *real, radius)
    check(real_share["queries"] >= 0.9,
          f"raft: only {real_share['queries']} of the driven call's queries "
          "were staged")
    flow_now = real[2] - real[2].new_tensor(
        np.stack(np.meshgrid(np.arange(fw), np.arange(fh)), -1))
    print(f"[time] raft lookup kernel on the driven call's last iteration "
          f"(|flow| mean {float(flow_now.abs().mean()):.3f}, max "
          f"{float(flow_now.abs().max()):.3f} px at 1/8 scale): "
          f"{real_ms:.4f} ms per launch back to back; bound "
          f"{real_bound:.4f} ms by {real_by} ({real_bytes} B, {real_flops} "
          f"FLOP); {lookup_blocks_per_sm(radius)} blocks resident per SM")
    volume_ms = timed(lambda: raft.compute_correlation_pyramid(
        f0, pyr[0], levels), repeats=10, warmup=2)
    volume = raft.compute_correlation_pyramid(f0, pyr[0], levels)
    sample_ms = timed(lambda: raft.lookup_correlation(volume, locs, radius),
                      repeats=10, warmup=2)
    del volume
    library_ms = sample_ms + volume_ms / RAFT_ITERS
    dev_ms = device_ms(lambda: lookup_correlation_cuda(f0, pyr, locs, radius),
                       "raft_lookup_kernel", kernel_ms)
    print(f"[time] raft lookup kernel {shape}: {kernel_ms:.4f} ms per launch "
          f"back to back, {call_ms:.4f} ms per lone call, {dev_ms:.4f} ms "
          f"device time per launch (profiler); bound {bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes} B, {flops} FLOP)")
    blocks = RAFT_B * -(-fh // TILE) * -(-fw // TILE) * levels
    for label, case in (("grid + N(0, 4 px)", serving),
                        ("the driven call's last iteration", real)):
        print_phases(f"raft lookup kernel, {label}",
                     lookup_phase_clocks(*case, radius), blocks, "block")
    print(f"[time] raft lookup plain PyTorch version on the card: "
          f"{plain_ms:.4f} ms")
    print(f"[time] raft materialised route (two library calls, the nearest "
          f"PyTorch has): all-pairs matmul and pooling once per call "
          f"{volume_ms:.4f} ms, lookup_correlation {sample_ms:.4f} ms per "
          f"iteration; {library_ms:.4f} ms per iteration at {RAFT_ITERS} "
          "iterations")

    ref_t = torch.from_numpy(ref).to(dev)
    cur_t = torch.from_numpy(curs[0]).to(dev)
    for label, mdl in (("float32", model), ("bfloat16", bf16_model)):
        dt = mdl.cfg.dtype
        img = (2.0 * (ref_t / 255.0) - 1.0).to(dt)
        both = torch.cat([img, img])
        fenc_ms = timed(lambda: mdl.feature_enc(both), repeats=5, warmup=1)
        cenc_ms = timed(lambda: mdl.context_enc(img), repeats=5, warmup=1)
        with torch.inference_mode():
            net = torch.zeros(RAFT_B, fh, fw, cfg.hidden_channels, dtype=dt,
                              device=dev)
            inp = torch.zeros(RAFT_B, fh, fw, cfg.context_channels, dtype=dt,
                              device=dev)
            corr = lookup_correlation_cuda(f0, pyr, locs, radius).to(dt)
            flow = torch.zeros(RAFT_B, fh, fw, 2, dtype=dt, device=dev)
        update_ms = timed(lambda: mdl.UpdateBlock_0(net, inp, corr, flow),
                          repeats=10, warmup=2)
        whole_ms = cuda_ms(lambda: mdl(ref_t, cur_t), repeats=10, warmup=2)
        print(f"[time] raft {label} {RAFT_W}x{RAFT_H} batch {RAFT_B}: "
              f"feature encoder ({2 * RAFT_B} images) {fenc_ms:.4f} ms, context "
              f"encoder ({RAFT_B} images) {cenc_ms:.4f} ms, one update block "
              f"{update_ms:.4f} ms, whole call ({RAFT_ITERS} iterations) "
              f"{whole_ms:.4f} ms = {whole_ms / RAFT_B:.4f} ms per frame")
    # cuDNN's choice for the context encoder's widest float32 layers
    # without TF32 is slow; PyTorch's own convolution is the yardstick.
    img = 2.0 * (ref_t / 255.0) - 1.0
    with torch.backends.cudnn.flags(enabled=False):
        native_ms = timed(lambda: model.context_enc(img), repeats=5, warmup=1)
    print(f"[time] raft float32 context encoder ({RAFT_B} images) with cuDNN "
          f"switched off (PyTorch's own convolutions): {native_ms:.4f} ms")
    # What TF32 would cost: the same encoder with cuDNN's default setting.
    with torch.inference_mode():
        with raft.full_float32():
            exact = model.context_enc(img)
        torch.backends.cudnn.allow_tf32 = True
        tf32_ms = cuda_ms(lambda: model.context_enc(img), repeats=5, warmup=1)
        tf32_err = float((model.context_enc(img) - exact).abs().max())
        torch.backends.cudnn.allow_tf32 = tf32_outside[0]
    print(f"[time] raft float32 context encoder with TF32 allowed in cuDNN: "
          f"{tf32_ms:.4f} ms, output up to {tf32_err:.3g} from full float32 "
          f"(values up to {float(exact.abs().max()):.3g})")
    del exact
    whole_full = cuda_ms(lambda: full_model(ref_t, cur_t), repeats=5,
                         warmup=1)
    print(f"[time] raft float32 with the materialised volume: whole call "
          f"{whole_full:.4f} ms")
    print(f"[time] card: {card}")
    profile_window(f"raft float32 call {RAFT_W}x{RAFT_H} batch {RAFT_B}",
                   lambda: model(ref_t, cur_t), calls=2)
    profile_window(f"raft bfloat16 call {RAFT_W}x{RAFT_H} batch {RAFT_B}",
                   lambda: bf16_model(ref_t, cur_t), calls=2)
    return {
        "name": "raft_lookup",
        "route": "cuda",
        "source": "feature_tracker_tpu_torch/csrc/raft_lookup.cu",
        "replaces": "feature_tracker_tpu/ops/pallas_raft_lookup.py:158",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def cotracker2_lookup_inputs(dev, seed, off_map):
    """Track features, pooled pyramid and locations on ``dev`` at the
    CoTracker2 cell's lookup shape (``COT_FRAMES`` frames of a
    ``COT_GRID`` x ``COT_GRID`` grid of tracks, 128 channels, maps at a
    quarter of ``COT_H`` x ``COT_W`` in 4 levels) from a numpy seed: the
    grid of queries in feature pixels plus N(0, 2 px); with ``off_map``,
    uniform from 20 px before the map to 20 px beyond it, with NaN,
    infinite and 1e9 entries."""
    from feature_tracker_tpu_torch.models.raft import pool_feature_pyramid

    rng = np.random.default_rng(seed)
    s, g, h, w = COT_FRAMES, COT_GRID, COT_H // 4, COT_W // 4
    f0 = rng.normal(0, 1, (s, g, g, 128)).astype(np.float32)
    f1 = rng.normal(0, 1, (s, h, w, 128)).astype(np.float32)
    if off_map:
        locs = np.stack([rng.uniform(-20, w + 20, (s, g, g)),
                         rng.uniform(-20, h + 20, (s, g, g))], -1)
        locs[0, 0, :5, 0] = [np.nan, np.inf, -np.inf, 1e9, -1e9]
        locs[-1, -1, -3:, 1] = [np.nan, 1e9, np.inf]
    else:
        grid = cotracker2_queries()[:, 1:].reshape(g, g, 2) / 4
        locs = grid[None] + rng.normal(0, 2.0, (s, g, g, 2))
    f0, f1, locs = (torch.from_numpy(a.astype(np.float32)).to(dev)
                    for a in (f0, f1, locs))
    return f0, [p.contiguous() for p in pool_feature_pyramid(f1, 4)], locs


def cotracker2_queries():
    """co-tracker's ``get_points_on_a_grid(COT_GRID, (COT_H, COT_W))`` on
    frame 0: ``[COT_GRID^2, 3]`` (t, x, y), a margin of ``COT_W / 64``."""
    margin = COT_W / 64
    gy, gx = np.meshgrid(np.linspace(margin, COT_H - margin, COT_GRID),
                         np.linspace(margin, COT_W - margin, COT_GRID),
                         indexing="ij")
    return np.stack([np.zeros(gx.size), gx.ravel(), gy.ravel()],
                    -1).astype(np.float32)


def cotracker2_phases(dev, card):
    """Phase 5d (see the module docstring). Returns kernel 5's border-mode
    entries for the kernels line."""
    import dataclasses

    from synthetic import Texture

    from feature_tracker_tpu_torch.models import raft
    from feature_tracker_tpu_torch.models.cotracker2 import (
        CoTracker2,
        CoTracker2Config,
        CoTracker2Online,
    )
    from feature_tracker_tpu_torch.ops.cuda_raft_lookup import (
        TILE,
        lookup_correlation_cuda,
        lookup_phase_clocks,
    )

    cfg = CoTracker2Config()
    radius = cfg.corr_radius
    shape = (f"B={COT_FRAMES} {COT_GRID}x{COT_GRID} C={cfg.latent_dim} maps "
             f"{COT_H // 4}x{COT_W // 4} L={cfg.corr_levels} r={radius}")
    errs = [compare_lookup(f"border lookup {shape}, grid + N(0, 2 px)",
                           *cotracker2_lookup_inputs(dev, 60, False), radius,
                           "border"),
            compare_lookup(f"border lookup {shape}, locations off the map",
                           *cotracker2_lookup_inputs(dev, 61, True), radius,
                           "border")]

    # One online window at the published widths, float32 and bfloat16,
    # against the plain reference from the clip's start (the reference
    # samples the query points' features itself).
    texs = [Texture(200 + ch, n_waves=16, min_period=5.0, max_period=30.0)
            for ch in range(3)]
    video = np.stack([np.stack([t.render(COT_H, COT_W, warp=lambda x, y, k=k: (
        x - 2.0 * k, y + 1.0 * k)) for t in texs], -1)
        for k in range(COT_FRAMES)]).round().clip(0, 255).astype(np.uint8)
    queries = cotracker2_queries()
    half = cfg.window_len // 2
    ref_cfg = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
               if f.name != "dtype"}
    cot_ref = cotracker2_reference()
    weights = cot_ref.draw_weights(ref_cfg, 62, dev)
    reference = cot_ref.CoTracker2Reference(weights, ref_cfg, dev)
    (want, want_vis), _ = reference.online_step(
        reference.online_start(queries, video[:half]), video[half:])
    for dtype, limit in ((torch.float32, COT_F32_TOL),
                         (torch.bfloat16, COT_BF16_TOL)):
        model = CoTracker2(dataclasses.replace(cfg, dtype=dtype), device=dev)
        model.load_state_dict(weights)
        online = CoTracker2Online(model)
        check(online.step(video[:half], queries) is None,
              "cotracker2: a clip's first call returned tracks")
        recorder = LookupRecorder()
        model.lookup_fn = recorder
        lookup_correlation_cuda.launches = 0
        tracks, vis = online.step(video[half:])
        torch.cuda.synchronize()
        launches = lookup_correlation_cuda.launches
        check(launches == cfg.iterations,
              f"cotracker2: {launches} lookup launches in a window of "
              f"{cfg.iterations} iterations")
        check(tracks.shape == want.shape and bool(torch.isfinite(tracks).all())
              and bool(torch.isfinite(vis).all()),
              f"cotracker2: output {tuple(tracks.shape)}")
        gap = torch.linalg.vector_norm(tracks - want, dim=-1)
        vis_gap = float((vis - want_vis).abs().mean())
        moved = (tracks[-1] - tracks.new_tensor(queries[:, 1:])).norm(dim=-1)
        print(f"[cotracker2] {dtype} online window at the published widths, "
              f"{COT_W}x{COT_H}, {len(queries)} tracks: {launches} lookup "
              f"launches in border mode; against the float32 reference "
              f"|dtrack| mean={float(gap.mean()):.3g} p99="
              f"{float(torch.quantile(gap.flatten(), 0.99)):.3g} max="
              f"{float(gap.max()):.3g} px, |dvis| mean={vis_gap:.3g} "
              f"(limits {limit} px and {limit} mean); the last frame's "
              f"tracks {float(moved.mean()):.3f} px from their queries")
        check(float(gap.mean()) <= limit and vis_gap <= limit,
              f"cotracker2 {dtype}: mean gaps {float(gap.mean())} px, "
              f"{vis_gap} in the logits")
    step_ms = cuda_ms(lambda: online.step(video[half:]), repeats=10,
                      warmup=2)
    print(f"[time] cotracker2 bfloat16 online step (encoder over "
          f"{cfg.window_len} frames, one window of {cfg.iterations} "
          f"iterations): {step_ms:.4f} ms")

    # Kernel 5 in border mode on the bfloat16 window's last lookup: the
    # online path's own locations.
    f0, pyr, locs = recorder.last
    errs.append(compare_lookup("border lookup on the online window's last "
                               "iteration", f0, pyr, locs, radius, "border"))
    share = staged_line("border lookup on the online window's last "
                        "iteration", f0, pyr, locs, radius, "border")
    check(share["queries"] >= 0.9,
          f"cotracker2: only {share['queries']} of the queries were staged")
    kernel_ms = cuda_ms(lambda: lookup_correlation_cuda(
        f0, pyr, locs, radius, "border"), batch=10)
    dev_ms = device_ms(lambda: lookup_correlation_cuda(
        f0, pyr, locs, radius, "border"), "raft_lookup_kernel", kernel_ms)
    plain_ms = cuda_ms(lambda: raft.lookup_correlation_otf(
        f0, pyr, locs, radius, "border"), repeats=10, warmup=1)
    nbytes, flops = lookup_work(f0, pyr, locs, radius, "border")
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[time] raft lookup kernel in border mode {shape}, the online "
          f"window's last iteration: {kernel_ms:.4f} ms per launch back to "
          f"back, {dev_ms:.4f} ms device time per launch (profiler); bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {flops} FLOP); "
          f"plain PyTorch version {plain_ms:.4f} ms")
    tiles = -(-COT_GRID // TILE)
    blocks = COT_FRAMES * tiles * tiles * cfg.corr_levels
    print_phases("raft lookup kernel in border mode, the online window's "
                 "last iteration",
                 lookup_phase_clocks(f0, pyr, locs, radius, "border"),
                 blocks, "block")
    print(f"[time] card: {card}")
    return {"border_launches": launches, "border_max_abs_err": max(errs),
            "border_ms": dev_ms, "border_plain_ms": plain_ms,
            "border_bound_ms": bound_ms, "border_bound_by": bound_by}


def stage_done(label, since):
    """Print the seconds a part of phase 6 took; returns the time now."""
    now = time.perf_counter()
    print(f"[path] phase {label} took {now - since:.1f} s")
    return now


def path_line(label, ms, card, extra="", repeats=REPEATS):
    """One line per phase-6 or phase-7 path: ms per call with the card
    beside it."""
    print(f"[path] {label}: {ms:.4f} ms per call (CUDA events, median of "
          f"{repeats}){extra}; card {card}")


def brief_pipeline(ref, cur, opts, device):
    """bench.py's w_brief_match on ``device``: detect in both frames,
    describe, valid-masked Hamming distances, nearby match, fill."""
    from feature_tracker_tpu_torch.match import (
        compute_brief,
        fill_matched_pixels,
        hamming_distance_matrix,
        nearby_match,
    )
    from feature_tracker_tpu_torch.ops.detect import detect_good_features

    ref_uv, _ = detect_good_features(ref, BRIEF_CAP, opts, device=device)
    cur_uv, _ = detect_good_features(cur, BRIEF_CAP, opts, device=device)
    ref_bits, ref_valid = compute_brief(ref, ref_uv)
    cur_bits, cur_valid = compute_brief(cur, cur_uv)
    dist = hamming_distance_matrix(ref_bits, cur_bits)
    dist = torch.where(ref_valid[:, None] & cur_valid[None, :], dist,
                       torch.inf)
    idx = nearby_match(dist, ref_uv, cur_uv, max_valid_distance=60.0,
                       max_col_distance=50.0, max_row_distance=50.0)
    muv, st = fill_matched_pixels(idx, cur_uv)
    return ref_uv, cur_uv, ref_bits, cur_bits, idx, muv, st


def render_plane(tex, q_wc, p_wc, h, w, k4, z0, tex_scale):
    """A pinhole camera ``k4`` at (q_wc, p_wc) viewing the textured plane
    z = z0 (tests/test_direct.py's scene, at any shape)."""
    from feature_tracker_tpu_torch.core.geometry import quat_to_matrix

    rot = quat_to_matrix(torch.tensor(q_wc, dtype=torch.float64)).numpy()
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(uu - k4[2]) / k4[0], (vv - k4[3]) / k4[1],
                      np.ones_like(uu)], axis=-1)
    d_world = d_cam @ rot.T
    lam = (z0 - p_wc[2]) / d_world[..., 2]
    x = p_wc[0] + lam * d_world[..., 0]
    y = p_wc[1] + lam * d_world[..., 1]
    return tex.eval(x * tex_scale, y * tex_scale).astype(np.float32)


def small_quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)],
                           np.sin(angle / 2) * axis]).astype(np.float32)


def kitti_scene(q_true, p_true, seed=11):
    """The reference and current views of a textured plane at KITTI's
    shape and intrinsics, and DIRECT_N features back-projected onto it
    (the KITTI pair and its disparities are not in the repository)."""
    from synthetic import Texture

    tex = Texture(seed, min_period=8.0, max_period=80.0)
    # About 0.45 texture units per pixel, as tests/test_direct.py's scene.
    tex_scale = 0.45 * KITTI_K4[0] / PLANE_Z
    args = (KITTI_H, KITTI_W, KITTI_K4, PLANE_Z, tex_scale)
    ref = render_plane(tex, np.array([1.0, 0, 0, 0]), np.zeros(3), *args)
    cur = render_plane(tex, q_true, p_true, *args)
    # Integer pixels anywhere in the image, as bench.py's w_direct draws
    # them (some leave the image under the motion and end OUTSIDE).
    rng = np.random.default_rng(0)
    ref_uv = np.stack([rng.integers(0, KITTI_W, DIRECT_N),
                       rng.integers(0, KITTI_H, DIRECT_N)],
                      -1).astype(np.float32)
    fx, fy, cx, cy = KITTI_K4
    p_ref = np.stack([(ref_uv[:, 0] - cx) / fx * PLANE_Z,
                      (ref_uv[:, 1] - cy) / fy * PLANE_Z,
                      np.full(DIRECT_N, PLANE_Z)], -1).astype(np.float32)
    return ref, cur, ref_uv, p_ref


def slice_paths(dev, card, frames):
    """Phase 6 (see the module docstring): the BRIEF pipeline, the direct
    method, Farnebäck and the stream into the FAST tracker, each on the
    card against the CPU, timed and profiled."""
    from synthetic import translated_pair

    from feature_tracker_tpu_torch.core.config import (
        HarrisOptions,
        KltOptions,
    )
    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.ops import cuda_klt
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.runtime import (
        FrameStream,
        cpu_baseline,
        get_runtime,
    )
    from feature_tracker_tpu_torch.trackers.dense import (
        DenseFlowOptions,
        DenseOpticalFlow,
    )
    from feature_tracker_tpu_torch.trackers.direct import (
        DirectMethod,
        DirectMethodMode,
        DirectMethodOptions,
    )
    from feature_tracker_tpu_torch.trackers.klt import BasicKlt

    t_phase = time.perf_counter()
    check(cpu_baseline.available(), "the native ground truth did not build")
    ref, cur = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    ref_d = torch.from_numpy(ref).to(dev)
    cur_d = torch.from_numpy(cur).to(dev)

    # 6a. The BRIEF pipeline.
    for response, jax_matched in BRIEF_RESPONSES:
        opts = HarrisOptions(min_feature_distance=20,
                             min_valid_response=response)
        got = brief_pipeline(ref_d, cur_d, opts, dev)
        want = brief_pipeline(torch.from_numpy(ref), torch.from_numpy(cur),
                              opts, "cpu")
        for name, g, w_ in zip(("ref uv", "cur uv", "ref bits", "cur bits",
                                "indices", "matched uv", "statuses"),
                               got, want):
            check(torch.equal(g.cpu(), w_),
                  f"brief response {response}: {name} differ card vs CPU")
        ref_uv, st = got[0].cpu().numpy(), got[6].cpu().numpy()
        ok = st == int(TrackStatus.TRACKED)
        err = np.abs(got[5].cpu().numpy()[ok] - ref_uv[ok]
                     - np.asarray(PAIR_SHIFT)).max(1)
        within = float((err <= 1.0).mean()) if ok.any() else 0.0
        valid = int(((ref_uv >= 0).all(1)).sum())
        ms = cuda_ms(lambda: brief_pipeline(ref_d, cur_d, opts, dev))
        path_line(f"brief pipeline 752x480 cap {BRIEF_CAP} response "
                  f"{response}", ms, card,
                  f"; {valid} corners, {int(ok.sum())} matched (JAX "
                  f"{jax_matched}), {within:.4f} within 1 px of the shift; "
                  "bits, indices and statuses equal to the CPU's")
        check(abs(int(ok.sum()) - jax_matched) <= BRIEF_COUNT_SLACK,
              f"brief response {response}: {int(ok.sum())} matched, JAX "
              f"{jax_matched}")
        check(within >= 0.95, f"brief response {response}: only {within} "
              "of the matches within 1 px")
        profile_window(f"brief pipeline response {response}",
                       lambda: brief_pipeline(ref_d, cur_d, opts, dev),
                       calls=3)

    t_phase = stage_done("6a (BRIEF)", t_phase)

    # 6b. The direct method at KITTI's shape.
    q_true = small_quat([0, 1, 0], 0.01)
    p_true = np.array([0.12, -0.06, 0.08], np.float32)
    kref, kcur, kuv, kp = kitti_scene(q_true, p_true)
    k4 = np.asarray(KITTI_K4, np.float32)
    pyr_d = (build_pyramid(kref, KITTI_LEVELS, device=dev),
             build_pyramid(kcur, KITTI_LEVELS, device=dev))
    pyr_c = (build_pyramid(kref, KITTI_LEVELS, device="cpu"),
             build_pyramid(kcur, KITTI_LEVELS, device="cpu"))
    native = cpu_baseline.direct_method_cpu(*pyr_c, k4, kp, kuv)
    for mode in (DirectMethodMode.DIRECT, DirectMethodMode.INVERSE,
                 DirectMethodMode.FAST):
        opts = DirectMethodOptions(method=mode)
        card_tracker = DirectMethod(opts, device=dev)
        t_first = time.perf_counter()
        got = [x.cpu().numpy() for x in card_tracker.track(*pyr_d, k4, kp,
                                                           kuv)]
        t_cpu = time.perf_counter()
        stats = card_tracker.last_stats
        want = [x.numpy() for x in DirectMethod(opts, device="cpu").track(
            *pyr_c, k4, kp, kuv)]
        print(f"[path] direct {mode.value}: first call on the card "
              f"{t_cpu - t_first:.2f} s (host clock, library loads "
              f"included), the same call on the CPU "
              f"{time.perf_counter() - t_cpu:.2f} s")
        others = [("the CPU", want)]
        if mode == DirectMethodMode.DIRECT:
            others.append(("the native ground truth", native))
        for who, (uv_w, q_w, p_w, st_w) in others:
            dq = float(np.abs(got[1] - q_w).max())
            dp = float(np.abs(got[2] - p_w).max())
            duv = float(np.abs(got[0] - uv_w).max())
            flips = int((got[3] != st_w).sum())
            print(f"[compare] direct {mode.value} 1241x376 L=5 N=300 card vs "
                  f"{who}: |dq| {dq:.3g} |dp| {dp:.3g} |duv| {duv:.3g} px, "
                  f"{flips} status differences")
            check(dq <= DIRECT_POSE_TOL and dp <= DIRECT_POSE_TOL
                  and duv <= DIRECT_UV_TOL and flips == 0,
                  f"direct {mode.value}: card vs {who} differ")
        qd = min(np.linalg.norm(got[1] - q_true),
                 np.linalg.norm(got[1] + q_true))
        pd = float(np.linalg.norm(got[2] - p_true))
        tracked = float((got[3] == int(TrackStatus.TRACKED)).mean())
        check(pd < 0.02 and qd < 5e-3 and tracked > 0.9,
              f"direct {mode.value}: pose not recovered (|dp| {pd}, "
              f"|dq| {qd}, tracked {tracked})")
        ms = cuda_ms(lambda: card_tracker.track(*pyr_d, k4, kp, kuv))
        path_line(f"direct {mode.value} 1241x376 L=5 N=300", ms, card,
                  f"; GN iterations per level (coarsest first) "
                  f"{stats['iterations']}, {stats['host_syncs']} host syncs "
                  f"per call; pose error |dp| {pd:.4g} |dq| {qd:.4g}, "
                  f"tracked {tracked:.4f}")
        # (Few calls: the profiler's own processing of thousands of small
        # launches per call takes seconds.)
        profile_window(f"direct {mode.value} per frame",
                       lambda: card_tracker.track(*pyr_d, k4, kp, kuv),
                       calls=2)

    t_phase = stage_done("6b (direct method)", t_phase)

    # 6c. Farnebäck.
    dopts = DenseFlowOptions(half_patch_size=2, max_iterations=20)
    rp_d = build_pyramid(ref, 5, quantize=False, device=dev)
    cp_d = build_pyramid(cur, 5, quantize=False, device=dev)
    rp_c = build_pyramid(ref, 5, quantize=False, device="cpu")
    cp_c = build_pyramid(cur, 5, quantize=False, device="cpu")
    flow_tracker = DenseOpticalFlow(dopts, device=dev)
    flow = flow_tracker.track(rp_d, cp_d).cpu().numpy()
    its = flow_tracker.last_stats["iterations"]
    m = DENSE_MARGIN
    inner = flow[:, m:-m, m:-m]
    d = np.abs(inner - DenseOpticalFlow(dopts, device="cpu").track(
        rp_c, cp_c).numpy()[:, m:-m, m:-m])
    d_native = np.abs(inner - cpu_baseline.farneback_cpu(
        rp_c, cp_c, dopts)[:, m:-m, m:-m])
    med_r, med_c = float(np.median(inner[0])), float(np.median(inner[1]))
    print(f"[compare] farneback 752x480 L=5 20 iterations card vs CPU, "
          f"interior (margin {m}): mean |d| {d.mean():.3g} px, p99 "
          f"{np.percentile(d, 99):.3g} px, max {d.max():.3g} px, share > "
          f"{DENSE_FAR} px {(d > DENSE_FAR).mean():.4g}; vs the native "
          f"ground truth: mean |d| {d_native.mean():.4g} px; median flow "
          f"(rows, columns) ({med_r:.5f}, {med_c:.5f}), true "
          f"({PAIR_SHIFT[1]}, {PAIR_SHIFT[0]})")
    check(d.mean() <= DENSE_MEAN and np.percentile(d, 99) <= DENSE_P99
          and (d > DENSE_FAR).mean() <= DENSE_FAR_SHARE,
          "farneback: card vs CPU beyond the statistics' limits")
    check(abs(med_r - PAIR_SHIFT[1]) <= 0.05
          and abs(med_c - PAIR_SHIFT[0]) <= 0.05,
          f"farneback: median flow ({med_r}, {med_c})")
    check(d_native.mean() < 0.05, "farneback: card vs native ground truth")
    ms = cuda_ms(lambda: flow_tracker.track(rp_d, cp_d))
    path_line("farneback 752x480 L=5 20 iterations", ms, card,
              f"; iterations per level (coarsest first) {its}, "
              f"{sum(its)} host syncs per call")
    profile_window("farneback per frame",
                   lambda: flow_tracker.track(rp_d, cp_d), calls=2)

    t_phase = stage_done("6c (Farnebäck)", t_phase)

    # 6d. The stream into the FAST tracker.
    u8 = [np.clip(np.round(f), 0, 255).astype(np.uint8) for f in frames]
    detect_opts = HarrisOptions(min_feature_distance=25,
                                min_valid_response=40.0)
    kopts = KltOptions(max_track_points=BRIEF_CAP)
    tracker = BasicKlt(kopts, device=dev)

    def chain(pyramids, events=None):
        """Detect on the first pyramid, track through the rest: the demo's
        loop. Returns the (uv, status) after each frame."""
        out, prev = [], None
        for pyr in pyramids:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pyr = tuple(torch.as_tensor(l, device=dev) for l in pyr)
            if prev is None:
                uv, num = detect_good_features(pyr[0], BRIEF_CAP, detect_opts,
                                               device=dev)
                status = torch.where(
                    torch.arange(BRIEF_CAP, device=dev) < num,
                    int(TrackStatus.NOT_TRACKED),
                    int(TrackStatus.OUTSIDE)).to(torch.int8)
            else:
                uv, status = tracker.track(prev, pyr, uv, uv, status)
                end.record()
                if events is not None:
                    events.append((start, end))
                out.append((uv.clone(), status.clone()))
                status = torch.where(status == int(TrackStatus.TRACKED),
                                     int(TrackStatus.NOT_TRACKED),
                                     status).to(torch.int8)
            prev = pyr
        return out

    streamed, events = [], []

    def stream_pyramids(stream):
        for fid, pyr in stream:
            want = build_pyramid(u8[fid], 4, quantize=True, device=dev)
            check(all(torch.equal(torch.as_tensor(a, device=dev), b)
                      for a, b in zip(pyr, want)),
                  f"stream frame {fid}: pyramid differs from build_pyramid")
            streamed.append(fid)
            yield pyr

    stream = FrameStream(iter(u8), levels=4, capacity=len(u8))
    cuda_klt.track_pyramid_fast_cuda.launches = 0
    got = chain(stream_pyramids(stream), events)
    launches = cuda_klt.track_pyramid_fast_cuda.launches
    torch.cuda.synchronize()
    want = chain(build_pyramid(f, 4, quantize=True, device=dev) for f in u8)
    check(streamed == list(range(len(u8))) and stream.dropped == 0,
          f"stream: frames {streamed}, {stream.dropped} dropped")
    check(launches == len(u8) - 1,
          f"stream: {launches} FAST launches over {len(u8) - 1} tracked "
          "frames")
    for i, ((gu, gs), (wu, ws)) in enumerate(zip(got, want)):
        check(torch.equal(gu, wu) and torch.equal(gs, ws),
              f"stream frame {i + 1}: uv or statuses differ from the chain "
              "on build_pyramid pyramids")
    alive = int((got[-1][1] == int(TrackStatus.TRACKED)).sum())
    frame_ms = [s.elapsed_time(e) for s, e in events[2:]]
    path_line(f"stream {len(u8)} frames 752x480 L=4 into BasicKlt FAST "
              f"N={BRIEF_CAP} (upload + track per tracked frame)",
              float(np.median(frame_ms)), card,
              f"; native runtime {get_runtime().is_native}, "
              f"{stream.dropped} frames dropped, {launches} FAST launches, "
              f"{alive} tracked on the last frame")
    check(alive >= BRIEF_CAP // 10, f"stream: {alive} tracked at the end")
    more = [build_pyramid(f, 4, quantize=True, device="cpu") for f in u8[:6]]
    host = [tuple(l.numpy() for l in p) for p in more]
    profile_window("stream chain of 6 frames",
                   lambda: chain(iter(host)), calls=2)
    stage_done("6d (stream)", t_phase)
    return launches


def cotracker_clip(t, h, w, n, seed=0):
    """``t`` frames ``[t, h, w, 1]`` of the synthetic texture moving
    COT_STEP px per frame, and ``n`` queries on frame 0 (numpy)."""
    from synthetic import Texture

    tex = Texture(seed)
    video = np.stack([tex.render(h, w, warp=lambda x, y, k=k: (
        x - k * COT_STEP[0], y - k * COT_STEP[1])) for k in range(t)])
    rng = np.random.default_rng(seed)
    queries = rng.uniform(8, [w - 8, h - 8], (n, 2)).astype(np.float32)
    return video[..., None].astype(np.float32), queries


def superpoint_cell_phase(dev, card):
    """Phase 7e (see the module docstring): SuperPoint's selection at the
    ``superpoint_lightglue.seq2048`` cell's inputs, kernel 6's list path,
    held bit for bit to the plain suppression on the ranked scores of the
    heatmap each detection computed. Returns kernel 6's launches over the
    detections."""
    from synthetic import Texture

    from feature_tracker_tpu_torch.models.superpoint import (
        KEYPOINT_BORDER,
        MAX_CANDIDATES,
        SuperPointDetector,
    )
    from feature_tracker_tpu_torch.ops import cuda_detect, detect

    t_phase = time.perf_counter()
    shape = (SP_CELL_H, SP_CELL_W)
    check(cuda_detect.grid_layout(shape, cuda_detect.conflict_threshold(
        SP_CELL_RADIUS)) is None, "7e: kernel 6 would take its grid, not "
          "its list path")
    det = SuperPointDetector.from_file(
        max_features=SP_CELL_CAP, min_response=SP_CELL_RESPONSE,
        min_feature_distance=SP_CELL_RADIUS, device=dev)
    frames = [np.clip(np.round(Texture(300 + i, n_waves=16, min_period=5.0,
                                       max_period=30.0).render(*shape)),
                      0, 255).astype(np.uint8)
              for i in range(SP_CELL_FRAMES)]
    # The heatmap each detection computes, as the model returns it.
    heats = []
    hook = det.model.register_forward_hook(
        lambda mod, inp, out: heats.append(out[0][0].clone()))
    wrapper = cuda_detect.suppress_candidates_cuda
    wrapper.launches = 0
    got = [det.detect(f) for f in frames]
    launches = wrapper.launches
    hook.remove()
    check(launches == len(frames), f"7e: {launches} launches of kernel 6 "
          f"in {len(frames)} SuperPoint detections")
    kept, valid = [], []
    with torch.inference_mode():
        for i, ((uv, _, num), heat) in enumerate(zip(got, heats)):
            scores, idx = detect.ranked_scores(
                heat, SP_CELL_RESPONSE, KEYPOINT_BORDER, MAX_CANDIDATES)
            want_uv, want_num = detect.suppress_candidates(
                scores, idx, shape, SP_CELL_CAP, SP_CELL_RADIUS)
            check(torch.equal(uv, want_uv) and int(num) == int(want_num),
                  f"7e frame {i}: kernel 6 kept {int(num)}, the plain "
                  f"path {int(want_num)}; uv equal: "
                  f"{torch.equal(uv, want_uv)}")
            kept.append(int(num))
            valid.append(int((scores > -torch.inf).sum()))
    check(min(kept) > SP_CELL_CAP // 2, f"7e: only {kept} keypoints kept")
    args = (scores, idx, shape, SP_CELL_CAP, SP_CELL_RADIUS)
    k_ms = queued_ms(lambda: wrapper(*args))
    k_dev = device_ms(lambda: wrapper(*args), "detect_suppress_kernel", k_ms)
    ms = cuda_ms(lambda: det.detect(frames[0]), repeats=10)
    path_line(f"superpoint detect {SP_CELL_W}x{SP_CELL_H} max_features="
              f"{SP_CELL_CAP} radius {SP_CELL_RADIUS} (seq2048's inputs)",
              ms, card, f"; kept {kept} of {valid} ranked candidates, the "
              f"plain path's bits; kernel 6 list path {launches} launches "
              f"in {len(frames)} detections, {k_dev * 1e3:.2f} us device "
              "time per launch (profiler)", repeats=10)
    stage_done("7e (SuperPoint at seq2048's inputs)", t_phase)
    return launches


def model_paths(dev, card):
    """Phase 7 (see the module docstring): SuperPoint and DISK into
    LightGlue on the headline pair, bench's LightGlue shape, CoTracker and
    SuperPoint at the seq2048 cell's inputs, each on the card against the
    CPU or the plain path, timed and profiled. Returns kernel 6's launches
    in 7e."""
    from synthetic import translated_pair

    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.match.nn_matcher import (
        NNFeatureMatcher,
        NNMatcherModelType,
        NNMatcherOptions,
    )
    from feature_tracker_tpu_torch.models.cotracker import CoTracker
    from feature_tracker_tpu_torch.models.disk import DiskDetector
    from feature_tracker_tpu_torch.models.lightglue import NEG_INF
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPointDetector,
    )
    from feature_tracker_tpu_torch.utils.weights import (
        has_weights,
        load_cotracker_npz,
        shipped_cotracker_config,
        weights_path,
    )

    t_phase = time.perf_counter()
    for name in ("superpoint.npz", "disk.npz", "lightglue_superpoint.npz",
                 "lightglue_disk.npz", "cotracker.npz"):
        check(has_weights(name), f"phase 7 runs the shipped weights, and "
              f"weights/{name} is missing")
    ref, cur = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    frames = [torch.from_numpy(f).to(dev) for f in (ref, cur)]
    shift = torch.tensor(PAIR_SHIFT)

    # 7a and 7b: a detector on both frames, then both LightGlue variants of
    # its descriptor width.
    for sub, label, det_cls, variants in (
            ("7a", "superpoint", SuperPointDetector,
             (NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT,
              NNMatcherModelType.LIGHTGLUE_SUPERPOINT_MATCHES)),
            ("7b", "disk", DiskDetector,
             (NNMatcherModelType.LIGHTGLUE_DISK_SCORE_MAT,
              NNMatcherModelType.LIGHTGLUE_DISK_MATCHES))):
        det = det_cls.from_file(max_features=MODEL_CAP, device=dev)
        det_cpu = det_cls(det.variables, max_features=MODEL_CAP,
                          device="cpu")
        got = [det.detect(f) for f in frames]
        desc_err = 0.0
        for (gu, gd, gn), frame, which in zip(got, (ref, cur),
                                              ("ref", "cur")):
            wu, wd, wn = det_cpu.detect(frame)
            check(torch.equal(gu.cpu(), wu) and int(gn) == int(wn),
                  f"{label} {which}: keypoints differ card vs CPU "
                  f"({int(gn)} / {int(wn)})")
            desc_err = max(desc_err, float((gd.cpu() - wd).abs().max()))
        check(desc_err <= DESC_TOL, f"{label}: descriptors {desc_err} from "
              "the CPU's")
        ms = cuda_ms(lambda: det.detect(frames[0]), repeats=10)
        path_line(f"{label} detect 752x480 max_features={MODEL_CAP}", ms,
                  card, f"; {int(got[0][2])} / {int(got[1][2])} keypoints, "
                  "uv equal to the CPU's, descriptors within "
                  f"{desc_err:.3g}", repeats=10)
        profile_window(f"{label} detect 752x480",
                       lambda: det.detect(frames[0]), calls=2)

        (ru, rd, rn), (cu, cd, cn) = got
        mask_r = torch.arange(MODEL_CAP, device=dev) < rn
        mask_c = torch.arange(MODEL_CAP, device=dev) < cn
        pair = (mask_r[:, None] & mask_c[None, :]).cpu()
        args = (ru, rd, cu, cd, mask_r, mask_c)
        cpu_args = tuple(a.cpu() for a in args)
        for variant in variants:
            m = NNFeatureMatcher.from_file(
                NNMatcherOptions(model_type=variant), device=dev)
            m_cpu = NNFeatureMatcher(m.options, variables=m.variables,
                                     device="cpu")
            sc = m.scores(*args).cpu()
            sc_cpu = m_cpu.scores(*cpu_args)
            score_err = float((sc - sc_cpu).abs()[pair].max())
            check(score_err <= SCORE_TOL and bool((sc[~pair] == NEG_INF)
                                                  .all()),
                  f"{variant.name}: scores {score_err} from the CPU's")
            match_args = (rd, cd, ru, cu, mask_r, mask_c)
            muv, st = m.match(*match_args)
            muv_c, st_c = m_cpu.match(*(a.cpu() for a in match_args))
            check(torch.equal(st.cpu(), st_c) and torch.equal(muv.cpu(),
                                                              muv_c),
                  f"{variant.name}: matches differ card vs CPU")
            ok = st.cpu() == int(TrackStatus.TRACKED)
            err = (muv.cpu()[ok] - ru.cpu()[ok] - shift).abs().amax(1)
            within = float((err <= 1.0).float().mean()) if ok.any() else 0.0
            ms = cuda_ms(lambda: m.match(*match_args), repeats=10)
            path_line(f"{variant.name} match {int(rn)} x {int(cn)}", ms,
                      card, f"; {int(ok.sum())} matched, {within:.4f} "
                      "within 1 px of the shift; scores within "
                      f"{score_err:.3g} of the CPU's, statuses and matched "
                      "uv equal", repeats=10)
            profile_window(f"{variant.name} match",
                           lambda: m.match(*match_args), calls=2)
            if variant == NNMatcherModelType.LIGHTGLUE_SUPERPOINT_SCORE_MAT:
                sp_matcher = m
        t_phase = stage_done(f"{sub} ({label} into LightGlue)", t_phase)

    # 7c. bench.py's w_lightglue: 256 random keypoints and descriptors.
    rng = np.random.default_rng(0)
    n = LG_BENCH_N
    kr, kc = (rng.uniform(0, 480, (n, 2)).astype(np.float32)
              for _ in range(2))
    dr, dc = (rng.normal(0, 1, (n, 256)).astype(np.float32)
              for _ in range(2))
    m = sp_matcher
    m_cpu = NNFeatureMatcher(m.options, variables=m.variables, device="cpu")
    args = [torch.from_numpy(a).to(dev) for a in (kr, dr, kc, dc)]
    sc = m.scores(*args).cpu()
    score_err = float((sc - m_cpu.scores(kr, dr, kc, dc)).abs().max())
    check(score_err <= SCORE_TOL, f"w_lightglue: scores {score_err} from "
          "the CPU's")
    ms = cuda_ms(lambda: m.scores(*args))
    path_line(f"lightglue scores N={n} depth 9 (bench's w_lightglue, "
              "shipped SuperPoint weights)", ms, card,
              f"; scores within {score_err:.3g} of the CPU's")
    profile_window("lightglue scores N=256", lambda: m.scores(*args),
                   calls=5)
    t_phase = stage_done("7c (w_lightglue)", t_phase)

    # 7d. CoTracker at the shipped configuration.
    cfg = shipped_cotracker_config()
    tracker = CoTracker(cfg, device=dev)
    tracker.load_state_dict(load_cotracker_npz(weights_path(
        "cotracker.npz")))
    tracker_cpu = CoTracker(cfg, device="cpu")
    tracker_cpu.load_state_dict(tracker.state_dict())
    for t, h, w, nq in COT_CLIPS:
        label = f"cotracker {t} frames {w}x{h} {nq} queries"
        video, queries = cotracker_clip(t, h, w, nq)
        video_d = torch.from_numpy(video).to(dev)
        queries_d = torch.from_numpy(queries).to(dev)
        tracks, vis = tracker(video_d, queries_d)
        want, want_vis, want_iters = tracker_cpu(video, queries,
                                                 return_all_iterations=True)
        start = torch.from_numpy(queries)[None].expand(t, nq, 2)
        step_err = 0.0
        for k in range(cfg.iterations):
            got, got_vis = tracker.refine_step(video_d, queries_d,
                                               start.to(dev))
            step_err = max(step_err, float((got.cpu() - want_iters[k])
                                           .abs().max()))
            start = want_iters[k]
        vis_err = float((got_vis.cpu() - want_vis).abs().max())
        check(step_err <= COT_TRACK_TOL and vis_err <= COT_VIS_TOL,
              f"{label}: an iteration from the CPU's positions is "
              f"{step_err} px / {vis_err} from the CPU's")
        moved = torch.nextafter(video_d, torch.full_like(video_d, np.inf))
        tracks2, vis2 = tracker(moved, queries_d)
        spread = (float((tracks - tracks2).abs().max()),
                  float((vis - vis2).abs().max()))
        whole = (float((tracks.cpu() - want).abs().max()),
                 float((vis.cpu() - want_vis).abs().max()))
        check(whole[0] <= max(COT_TRACK_TOL, 2 * spread[0])
              and whole[1] <= max(COT_VIS_TOL, 2 * spread[1]),
              f"{label}: the whole run is {whole} from the CPU's, the "
              f"card's own spread {spread}")
        true = (torch.from_numpy(queries)[None]
                + torch.arange(t)[:, None, None] * torch.tensor(COT_STEP))
        inside = ((true >= 0) & (true <= torch.tensor([w - 1, h - 1]))
                  ).all(-1)
        err = (tracks.cpu() - true).norm(dim=-1)[inside].mean()
        still = (torch.from_numpy(queries)[None] - true).norm(
            dim=-1)[inside].mean()
        ms = cuda_ms(lambda: tracker(video_d, queries_d), repeats=10)
        path_line(label, ms, card,
                  f"; each iteration within {step_err:.3g} px (vis "
                  f"{vis_err:.3g}) of the CPU's from its positions, the "
                  f"whole run {whole[0]:.3g} px / {whole[1]:.3g} (card's "
                  f"own one-ulp spread {spread[0]:.3g} / {spread[1]:.3g}); "
                  f"mean error to the true motion {float(err):.4f} px "
                  f"(zero motion {float(still):.4f})", repeats=10)
        profile_window(label, lambda: tracker(video_d, queries_d), calls=2)
    stage_done("7d (CoTracker)", t_phase)
    return superpoint_cell_phase(dev, card)


def ba_spread(problem, opts, device):
    """``bundle_adjust`` of ``problem`` on ``device`` (numpy outputs) and
    the largest relative change of its rms history under a one-ulp change
    of the observations or of the initial translations."""
    from feature_tracker_tpu_torch.parallel import bundle_adjust

    base = [x.cpu().numpy() for x in bundle_adjust(*problem, opts,
                                                    device=device)]
    spread = 0.0
    for i in (4, 1):              # obs_uv, t_cw
        moved = list(problem)
        moved[i] = np.nextafter(problem[i], np.float32(np.inf))
        rms = bundle_adjust(*moved, opts, device=device)[3].cpu().numpy()
        spread = max(spread, float(np.abs(rms / base[3] - 1).max()))
    return base, spread


def ba_agree(label, got, want, rms_limit, spread):
    """(q, t, landmarks, rms history) against another run's: JAX's sharded
    tolerances, the rms history within ``rms_limit`` relative or twice the
    one-ulp ``spread`` where that is larger."""
    def excess(a, b, rtol, atol):
        return float((np.abs(a - b) - atol - rtol * np.abs(b)).max())

    rel = float(np.abs(got[3] / want[3] - 1).max())
    dq, dt, dl = (float(np.abs(a - b).max()) for a, b in zip(got, want[:3]))
    print(f"[compare] {label}: |dq| {dq:.3g} |dt| {dt:.3g} |dlandmark| "
          f"{dl:.3g}; rms history {want[3][0]:.6g} -> {want[3][-1]:.6g} px, "
          f"max relative difference {rel:.3g} (limit {rms_limit:g}, or "
          f"twice the one-ulp spread {spread:.3g})")
    check(excess(got[0], want[0], 0.0, BA_Q_TOL) <= 0
          and excess(got[1], want[1], BA_T_TOL, BA_T_TOL) <= 0
          and excess(got[2], want[2], BA_LM_RTOL, BA_LM_ATOL) <= 0,
          f"{label}: poses or landmarks differ")
    check(rel <= max(rms_limit, 2.0 * spread),
          f"{label}: rms histories differ by {rel} relative")


class SlamTexture:
    """Phase 3's corner-rich texture at about one texture unit per pixel of
    frame 0 (the corner density of real imagery at the front end's
    thresholds) plus kitti_scene's smooth one (the coarse structure the
    direct method's top levels need), each at 0.6 of its contrast."""

    def __init__(self):
        from synthetic import Texture

        self.fine = Texture(0, n_waves=16, min_period=5.0, max_period=30.0)
        self.coarse = Texture(11, min_period=8.0 / 0.45,
                              max_period=80.0 / 0.45)

    def eval(self, x, y):
        return (0.6 * (self.fine.eval(x, y) + self.coarse.eval(x, y))
                - 0.2 * 127.5)


def slam_frames():
    """SLAM_FRAMES views of a SlamTexture plane at depth PLANE_Z with
    KITTI's shape and intrinsics, camera k at k * SLAM_STEP turned
    k * SLAM_YAW about y; and the true camera positions [T, 3]."""
    tex = SlamTexture()
    tex_scale = KITTI_K4[0] / PLANE_Z
    frames, centres = [], []
    for k in range(SLAM_FRAMES):
        p_wc = k * np.asarray(SLAM_STEP, np.float32)
        frames.append(render_plane(tex, small_quat([0, 1, 0], k * SLAM_YAW),
                                   p_wc, KITTI_H, KITTI_W, KITTI_K4, PLANE_Z,
                                   tex_scale))
        centres.append(p_wc)
    return frames, np.stack(centres)


def slam_back_end(frames, device):
    """demos/slam_demo.py's path on ``device``: the front end over the
    frames; landmarks from the frame-0 tracks at the plane's true depth;
    every frame a keyframe at identity, each landmark observed where its
    lane keeps its frame-0 id and is tracked; the window BA; and the direct
    method's pose of every frame against frame 0 from the same landmarks.
    Returns the front end's results, the window's state and rms history,
    ms of ``optimize()`` and both estimators' camera positions."""
    from feature_tracker_tpu_torch.core.geometry import quat_to_matrix
    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.parallel import BaOptions
    from feature_tracker_tpu_torch.parallel.window_ba import (
        SlidingWindowBa,
        WindowConfig,
    )
    from feature_tracker_tpu_torch.pipeline import (
        FrontEndConfig,
        TrackingFrontEnd,
    )
    from feature_tracker_tpu_torch.trackers.direct import DirectMethod

    fe = TrackingFrontEnd(FrontEndConfig(), device=device)
    results = [fe.process_frame(f) for f in frames]
    first = results[0]
    lanes = np.nonzero(first.track_ids >= 0)[0]
    fx, fy, cx, cy = KITTI_K4
    uv0 = first.uv[lanes]
    p_w = np.stack([(uv0[:, 0] - cx) / fx * PLANE_Z,
                    (uv0[:, 1] - cy) / fy * PLANE_Z,
                    np.full(len(lanes), PLANE_Z)], -1).astype(np.float32)
    k4 = np.asarray(KITTI_K4, np.float32)
    window = SlidingWindowBa(
        k4, WindowConfig(max_keyframes=len(frames), max_landmarks=512,
                         obs_per_landmark=len(frames)),
        BaOptions(max_iterations=20, landmark_prior=30.0, huber_px=2.0),
        device=device)
    slots = np.array([window.add_landmark(p) for p in p_w])
    n_obs = 0
    for res in results:
        kf = window.add_keyframe([1, 0, 0, 0], [0, 0, 0])
        seen = ((res.track_ids[lanes] == first.track_ids[lanes])
                & (res.status[lanes] == int(TrackStatus.TRACKED)))
        for slot, lane in zip(slots[seen], lanes[seen]):
            window.add_observation(slot, kf, res.uv[lane])
        n_obs += int(seen.sum())
    t0 = time.perf_counter()
    rms = window.optimize()                  # ends in device-to-host copies
    optimize_ms = (time.perf_counter() - t0) * 1e3
    rot = quat_to_matrix(torch.as_tensor(window.q_cw)).numpy()
    cam_ba = -np.einsum("kji,kj->ki", rot, window.t_cw)       # -R^T t

    solver = DirectMethod(device=device)
    ref_pyr = build_pyramid(frames[0], KITTI_LEVELS, device=device)
    q_rc = p_rc = None
    cam_direct = [np.zeros(3, np.float32)]
    for f in frames[1:]:
        _, q_rc, p_rc, _ = solver.track(
            ref_pyr, build_pyramid(f, KITTI_LEVELS, device=device), k4, p_w,
            uv0, q_rc, p_rc)
        cam_direct.append(p_rc.cpu().numpy())
    return {"results": results, "landmarks_n": len(lanes), "n_obs": n_obs,
            "rms": rms, "optimize_ms": optimize_ms,
            "state": (window.q_cw, window.t_cw, window.landmarks, rms),
            "cam_ba": cam_ba, "cam_direct": np.stack(cam_direct)}


def parallel_paths(dev, card, rp, cp, uv, opts):
    """Phase 8 (see the module docstring): the parallel layer and the SLAM
    back end on the card. Returns each KLT kernel's launches on the
    sharded paths."""
    import functools
    import tempfile

    import torch.distributed as dist

    from feature_tracker_tpu_torch.ops import cuda_klt, cuda_warp_klt
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.parallel import (
        BaOptions,
        ba_comm_report,
        bundle_adjust,
        make_mesh,
        track_direct_sharded,
        track_klt_sharded,
    )
    from feature_tracker_tpu_torch.parallel.ba import ba_step
    from feature_tracker_tpu_torch.parallel.mesh import comm_stats
    from feature_tracker_tpu_torch.parallel.multihost_ba import (
        ba_case,
        run_cases,
        spawn,
    )
    from feature_tracker_tpu_torch.parallel.scaling import (
        _make_problem,
        measure_overhead_vs_landmarks,
    )
    from feature_tracker_tpu_torch.trackers.direct import (
        DirectMethod,
        DirectMethodMode,
        DirectMethodOptions,
    )
    from feature_tracker_tpu_torch.trackers.klt import (
        AffineKlt,
        BasicKlt,
        LssdKlt,
    )

    t_phase = time.perf_counter()
    # 8a. One rank in this process, its own NCCL group.
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1,
          f"make_mesh() gave {mesh} over {dist.get_backend()}")
    psum = ba_comm_report(BA_P, BA_L, BA_O, mesh)["psum_bytes"]
    trackers = {
        "klt_fast_pyramid": (BasicKlt(opts),
                             cuda_klt.track_pyramid_fast_cuda),
        "klt_affine_pyramid": (AffineKlt(opts),
                               cuda_warp_klt.affine_track_pyramid_cuda),
        "klt_lssd_pyramid": (LssdKlt(opts, False),
                             cuda_warp_klt.lssd_track_pyramid_cuda)}
    launches, single = {}, {}
    for name, (tracker, wrapper) in trackers.items():
        want = tracker.track(rp, cp, uv)
        wrapper.launches = 0
        got = track_klt_sharded(tracker, mesh, rp, cp, uv)
        launches[name] = wrapper.launches
        check(launches[name] == 1,
              f"sharded {name}: {launches[name]} launches in one call")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"sharded {name}: one rank differs from the unsharded tracker")
        single[name] = [x.cpu().numpy() for x in want]
        sharded_ms = cuda_ms(lambda: track_klt_sharded(tracker, mesh, rp, cp,
                                                       uv))
        plain_ms = cuda_ms(lambda: tracker.track(rp, cp, uv))
        print(f"[parallel] 8a {name} sharded over one rank, 752x480 L=4 "
              f"N={N}: bit-equal to the unsharded tracker, 1 launch; "
              f"{sharded_ms:.4f} ms per call against {plain_ms:.4f} ms "
              f"unsharded (CUDA events, median of {REPEATS}); card {card}")

    q_true = small_quat([0, 1, 0], 0.01)
    p_true = np.array([0.12, -0.06, 0.08], np.float32)
    kref, kcur, kuv, kp = kitti_scene(q_true, p_true)
    k4 = np.asarray(KITTI_K4, np.float32)
    kpyr = (build_pyramid(kref, KITTI_LEVELS, device=dev),
            build_pyramid(kcur, KITTI_LEVELS, device=dev))
    direct_single = {}
    for mode in DirectMethodMode:
        solver = DirectMethod(DirectMethodOptions(method=mode), device=dev)
        want = solver.track(*kpyr, k4, kp, kuv)
        before = comm_stats().get("all_reduce", {"calls": 0, "bytes": 0})
        got = track_direct_sharded(solver, mesh, *kpyr, k4, kp, kuv)
        after = comm_stats()["all_reduce"]
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"sharded direct {mode.value}: one rank differs from the "
              "unsharded solver")
        direct_single[mode] = [x.cpu().numpy() for x in want]
        print(f"[parallel] 8a direct {mode.value} sharded over one rank, "
              f"1241x376 L=5 N={DIRECT_N}: bit-equal to the unsharded "
              f"solver; GN iterations {solver.last_stats['iterations']}, "
              f"{after['calls'] - before['calls']} all-reduces of "
              f"{after['bytes'] - before['bytes']} B")
    print(f"[parallel] 8a collectives: {comm_stats()}")
    dist.destroy_process_group()
    t_phase = stage_done("8a (one rank, NCCL)", t_phase)

    # 8b. Two ranks on this card: spawned processes, gloo over a FileStore.
    problem = _make_problem(BA_L, BA_O, BA_P)
    ba_opts = BaOptions(max_iterations=BA_ITERS, num_fixed_poses=2)

    def host(pyr):
        return [level.cpu().numpy() for level in pyr]

    cases = [(functools.partial(track_klt_sharded, tracker),
              (host(rp), host(cp), uv.cpu().numpy()))
             for tracker, _ in trackers.values()]
    cases += [(functools.partial(track_direct_sharded, DirectMethod(
        DirectMethodOptions(method=mode), device=dev)),
        (host(kpyr[0]), host(kpyr[1]), k4, kp, kuv))
        for mode in DirectMethodMode]
    cases.append((ba_case, (problem, ba_opts)))
    t_spawn = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = spawn(run_cases, 2, store, "cuda", cases, device="cuda",
                      timeout=300.0)
    print(f"[parallel] 8b two ranks on the card (gloo, FileStore): "
          f"{time.perf_counter() - t_spawn:.1f} s, start-up included")
    one, spread = ba_spread(problem, ba_opts, dev)
    for rank, result in enumerate(ranks):
        for i, name in enumerate(trackers):
            check(all(np.array_equal(g, w)
                      for g, w in zip(result[i], single[name])),
                  f"8b rank {rank} {name}: two ranks differ from one")
        for j, mode in enumerate(DirectMethodMode):
            g_uv, g_q, g_p, g_st = result[len(trackers) + j]
            w_uv, w_q, w_p, w_st = direct_single[mode]
            duv = float(np.abs(g_uv - w_uv).max())
            dpose = float(max(np.abs(g_q - w_q).max(),
                              np.abs(g_p - w_p).max()))
            print(f"[compare] 8b rank {rank} direct {mode.value}: |duv| "
                  f"{duv:.3g} px, |dpose| {dpose:.3g}, "
                  f"{int((g_st != w_st).sum())} status differences")
            check(np.array_equal(g_st, w_st) and duv <= DIRECT_UV_TOL,
                  f"8b rank {rank} direct {mode.value}: two ranks differ")
        ba = result[-1]
        ba_agree(f"8b rank {rank} BA L={BA_L} two ranks vs one",
                 (ba["q"], ba["t"], ba["landmarks"], ba["rms"]), one,
                 BA_RMS_RANKS, spread)
        print(f"[parallel] 8b rank {rank} BA all-reduces: "
              f"{ba['all_reduce_calls']} calls, {ba['all_reduce_bytes']} B "
              f"({BA_ITERS} steps of psum_bytes {psum} and "
              f"{BA_ITERS + 1} rms sums of 8 B)")
        check(ba["all_reduce_calls"] == 2 * BA_ITERS + 1
              and ba["all_reduce_bytes"]
              == BA_ITERS * psum + (BA_ITERS + 1) * 8,
              f"8b rank {rank}: the BA's all-reduces are not one reduced "
              "camera system per step")
    print(f"[parallel] 8b one rank's rms history under a one-ulp change of "
          f"its inputs moves by up to {spread:.3g} relative")
    t_phase = stage_done("8b (two ranks, gloo)", t_phase)

    # 8c. The BA on the card against the CPU.
    again = [x.cpu().numpy() for x in bundle_adjust(*problem, ba_opts)]
    check(all(np.array_equal(a, b) for a, b in zip(again, one)),
          "8c: two BA runs on the card differ")
    t_cpu = time.perf_counter()
    cpu = [x.numpy() for x in bundle_adjust(*problem, ba_opts,
                                            device="cpu")]
    print(f"[parallel] 8c BA L={BA_L} on the CPU: "
          f"{time.perf_counter() - t_cpu:.2f} s (host clock)")
    ba_agree(f"8c BA L={BA_L} card vs CPU", one, cpu, BA_RMS_CPU, spread)
    q, t, lm, idx, uv_o, mask, kk = problem
    args = (*(torch.as_tensor(a, device=dev) for a in (q, t, lm)),
            torch.as_tensor(idx, device=dev).long(),
            torch.as_tensor(uv_o, device=dev),
            torch.as_tensor(mask, device=dev), torch.as_tensor(kk, device=dev))
    step_ms = cuda_ms(lambda: ba_step(*args, ba_opts), repeats=20)
    print(f"[parallel] 8c ba_step L={BA_L} O={BA_O} P={BA_P}: {step_ms:.4f} "
          f"ms per Gauss-Newton iteration (CUDA events, median of 20); two "
          f"card runs bit-equal; card {card}")
    profile_window(f"ba_step L={BA_L}", lambda: ba_step(*args, ba_opts),
                   calls=5)
    sweep = measure_overhead_vs_landmarks(l_list=SWEEP_L)
    print(f"[parallel] 8c measure_overhead_vs_landmarks: {json.dumps(sweep)}")
    check(sweep["hlo_allreduce_bytes"] == sweep["analytic_psum_bytes"],
          "8c: counted all-reduce bytes differ from ba_comm_report's")
    dist.destroy_process_group()
    t_phase = stage_done("8c (BA on the card)", t_phase)

    # 8d. The SLAM back end on rendered KITTI-shaped frames.
    frames, centres = slam_frames()
    cuda_klt.track_pyramid_fast_cuda.launches = 0
    got = slam_back_end(frames, dev)
    slam_launches = cuda_klt.track_pyramid_fast_cuda.launches
    check(slam_launches == SLAM_FRAMES - 1,
          f"8d: {slam_launches} FAST launches over {SLAM_FRAMES - 1} "
          "tracked frames")
    want = slam_back_end(frames, "cpu")
    for mine, theirs in zip(got["results"], want["results"]):
        alive = mine.status == 1
        check(np.array_equal(mine.track_ids, theirs.track_ids)
              and np.array_equal(mine.status, theirs.status)
              and np.abs(mine.uv[alive] - theirs.uv[alive]).max()
              <= UV_TOL, f"8d frame {mine.frame_id}: card and CPU tracks "
              "differ")
    rms = got["rms"]
    err_truth = np.linalg.norm(got["cam_ba"] - centres, axis=1)
    err_direct = np.linalg.norm(got["cam_ba"] - got["cam_direct"], axis=1)
    print(f"[parallel] 8d SLAM back end, {SLAM_FRAMES} frames 1241x376: "
          f"{got['landmarks_n']} landmarks, {got['n_obs']} observations, "
          f"{slam_launches} FAST launches; BA rms {rms[0]:.4f} -> "
          f"{rms[-1]:.4f} px in {len(rms) - 1} iterations; optimize() "
          f"{got['optimize_ms']:.2f} ms (host clock); camera position "
          f"error max {err_truth.max():.4g} m against the truth, "
          f"{err_direct.max():.4g} m against the direct method (limit "
          f"{SLAM_POS_TOL} m); card {card}")
    check(rms[-1] < rms[0], "8d: the BA did not lower the rms")
    check(err_truth.max() <= SLAM_POS_TOL and err_direct.max()
          <= SLAM_POS_TOL, "8d: camera positions off")
    ba_agree("8d window BA card vs CPU", got["state"], want["state"],
             BA_RMS_CPU, 0.0)
    stage_done("8d (SLAM back end)", t_phase)
    return launches


# --------------------------------------------------------------- phase 9
def tree_digest(*dirs) -> dict:
    """sha256 of every file under the repository's ``dirs``."""
    import hashlib

    out = {}
    for top in dirs:
        for base, _, names in os.walk(os.path.join(ROOT, top)):
            for name in names:
                path = os.path.join(base, name)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, ROOT)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def to_device(tree, dev):
    """Tensors of nested dicts on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    return torch.as_tensor(tree).to(dev)


def moments_agree(label, got, want, zero=(), spread=None):
    """(params, opt_state) after one step from the same state, on the card
    and on the CPU: the first moments (``mu = (1 - b1) * clipped g`` after
    a first step, so the clipped gradients) leaf by leaf within
    TRAIN_GRAD_TOL of the leaf's largest value plus TRAIN_GRAD_FLOOR of the
    largest over all leaves, the second moments likewise, and the
    parameters within TRAIN_PARAM_TOL where |g| is above TRAIN_GRAD_TOL of
    its leaf's largest and the floor (elsewhere Adam's first step turns
    rounding into +-lr). The leaves named in ``zero`` have a gradient that
    is 0 but for rounding (a convolution's bias ahead of a training-mode
    batch norm): on both sides it stays below TRAIN_ZERO_GRAD of the
    largest. ``spread`` (``train_spread``: how far any leaf's moments move
    under a one-ulp change of the inputs) raises every limit to twice it
    where that is larger, and leaves out of the parameter check the
    elements whose |g| is within twice it (their sign is rounding).
    Returns the clipped global gradient norms (card, CPU)."""
    (gp, go), (wp, wo) = (to_device(got, "cpu"), to_device(want, "cpu"))
    check(list(gp) == list(wp) and int(go["count"]) == int(wo["count"]),
          f"{label}: the states differ in layout")
    spread = spread or {"mu": 0.0, "nu": 0.0}
    worst, by_spread = {}, 0
    for moment in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in wo[moment].values())
        ratios = []
        for k, w in wo[moment].items():
            if k in zero:
                continue
            base = (TRAIN_GRAD_TOL * float(w.abs().max())
                    + TRAIN_GRAD_FLOOR * top)
            lim = max(base, 2.0 * spread[moment])
            by_spread += lim > base
            d = float((go[moment][k] - w).abs().max())
            # A limit of 0: every moment is 0 on the CPU (the clipped
            # gradient is 0 where the global norm overflows float32).
            ratios.append((d / lim if lim > 0 else
                           (np.inf if d > 0 else 0.0), k))
        worst[moment] = max(ratios)[0]
        if worst[moment] > 1:
            print(f"[compare] {label}: {moment} beyond its limit: " + ", ".join(
                f"{k} at {r:.3g}" for r, k in sorted(ratios)[-5:]))
    top = max(float(v.abs().max()) for v in wo["mu"].values())
    if zero:
        z = max(float(o["mu"][k].abs().max()) for o in (go, wo)
                for k in zero) / top
        print(f"[compare] {label}: {len(zero)} leaves with a zero gradient "
              f"stay within {z:.3g} of the largest |g| (limit "
              f"{TRAIN_ZERO_GRAD:g})")
        check(z <= TRAIN_ZERO_GRAD, f"{label}: a zero gradient is not")
    floor = TRAIN_GRAD_FLOOR * top
    dp = 0.0
    for k, w in wp.items():
        g = wo["mu"][k].abs()
        sel = ((g > TRAIN_GRAD_TOL * g.max()) & (g > floor)
               & (g > 2.0 * spread["mu"]))
        if sel.any() and k not in zero:
            dp = max(dp, float((gp[k] - w).abs()[sel].max()))
    norms = tuple(float(torch.sqrt(sum((v.double() ** 2).sum()
                                       for v in o["mu"].values())) / 0.1)
                  for o in (go, wo))
    print(f"[compare] {label}: clipped gradient norm {norms[0]:.6g} / "
          f"{norms[1]:.6g}; worst leaf of mu at {worst['mu']:.3g} and of nu "
          f"at {worst['nu']:.3g} of its limit ({TRAIN_GRAD_TOL:g} of the "
          f"leaf's largest + {TRAIN_GRAD_FLOOR:g} of the largest, or twice "
          f"the one-ulp spread {spread['mu']:.3g} / {spread['nu']:.3g} for "
          f"{by_spread} of the moments' leaves); parameters within "
          f"{dp:.3g} where |g| counts")
    check(worst["mu"] <= 1 and worst["nu"] <= 1,
          f"{label}: gradients differ")
    check(dp <= TRAIN_PARAM_TOL, f"{label}: parameters differ by {dp}")
    return norms


def step_spread(step, params, opt_state, batch, nudged):
    """How far the Adam moments after one CPU step of ``(params,
    opt_state, *batch) -> (params, opt_state, ...)`` move, in any leaf,
    when the inputs at the positions ``nudged`` (the images) or the
    parameters move by one ulp: ``{"mu": max |d|, "nu": max |d|}``. The
    full RAFT's gradient is discontinuous (the cells of the bilinear taps,
    ReLUs), and such a move crosses some of its kinks, which shifts small
    leaves, such as the encoders', by up to a few percent of their own
    largest value (on the CPU and on an H100 alike); the card's rounding
    crosses others."""
    def up(t):
        t = torch.as_tensor(t)
        return torch.nextafter(t, torch.full_like(t, np.inf))

    base = step(params, opt_state, *batch)[1]
    others = [step(params, opt_state, *[up(t) if i in nudged else t
                                        for i, t in enumerate(batch)])[1],
              step({k: up(v) for k, v in params.items()}, opt_state,
                   *batch)[1]]
    return {m: max(float((o[m][k] - v).abs().max())
                   for o in others for k, v in base[m].items())
            for m in ("mu", "nu")}


def train_spread(step, start, batch):
    """``step_spread`` of a RAFT step ``(TrainState, *batch) ->
    (TrainState, metrics)`` from ``start``, the images being the first two
    inputs."""
    def run(params, opt_state, *b):
        state = step(start.replace(params=params, opt_state=opt_state),
                     *b)[0]
        return state.params, state.opt_state

    return step_spread(run, start.params, start.opt_state,
                       [torch.as_tensor(t).cpu() for t in batch], (0, 1))


def train_state_agree(label, got, want, got_m, want_m, spread=None):
    """Two RAFT TrainStates after one step from the same state, and their
    metrics: ``moments_agree``, the loss and metrics within TRAIN_LOSS_RTOL,
    the new batch statistics within TRAIN_STATS_RTOL + TRAIN_STATS_ATOL."""
    for key in want_m:
        a, b = float(got_m[key]), float(want_m[key])
        check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b),
              f"{label}: {key} {a} against {b}")
    d_stats = {k: (got.batch_stats[k].cpu() - w.cpu()).abs()
               for k, w in want.batch_stats.items()}
    print(f"[compare] {label}: " + ", ".join(
        f"{k} {float(got_m[k]):.6f} / {float(want_m[k]):.6f}"
        for k in want_m) + "; batch statistics within "
        f"{max(float(d.max()) for d in d_stats.values()):.3g}")
    check(all(bool((d <= TRAIN_STATS_RTOL * want.batch_stats[k].cpu().abs()
                    + TRAIN_STATS_ATOL).all()) for k, d in d_stats.items()),
          f"{label}: batch statistics differ")
    zero = {k for k in want.params
            if re.search(r"ResNetBlock_\d+\.Conv_\d+\.bias$", k)}
    return moments_agree(label, (got.params, got.opt_state),
                         (want.params, want.opt_state), zero, spread)


def _halo_convs(cfg, iterations, unsup):
    """(k, channels, scale, has a backward) of every halo exchange of one
    RAFT train step on row bands, in the model's order: each convolution
    taller than one row fetches kh // 2 rows of its input (the z and r
    gates of the (5, 1) GRU convolutions share one, and so do the flow and
    mask heads, which both read ``net``), convex upsampling one row of the
    flow, and the photometric loss's smoothness one row of each
    prediction. The stem's input (the images) and the first iteration's
    flow (zero) take no gradient, so those exchanges have no backward."""
    def encoder(out):
        step = out // 4
        widths = (step, step, step * 2, step * 2, step * 3, step * 3, out)
        convs, scale = [(3, cfg.in_channels, 1, False)], 1
        for i in range(6):
            convs.append((1, widths[i], scale, True))
            scale *= 1 + i % 2
            convs.append((1, widths[i + 1], scale, True))
        return convs + [(1, out, 8, True)]

    convs = (2 * encoder(cfg.feature_channels)
             + encoder(cfg.context_channels + cfg.hidden_channels))
    gru = cfg.context_channels + cfg.motion_out_channels + cfg.hidden_channels
    for it in range(iterations):
        convs += [(1, cfg.correlation_hidden_channels, 8, True),
                  (3, 2, 8, it > 0),
                  (1, cfg.flow_hidden_channels, 8, True),
                  (1, cfg.correlation_out_channels + cfg.flow_out_channels,
                   8, True),
                  (2, gru, 8, True), (2, gru, 8, True),
                  (1, cfg.hidden_channels, 8, True),
                  (1, cfg.flow_out_channels, 8, True)]
        if not cfg.upsample_last_only:
            convs.append((1, 2, 8, True))
    if cfg.upsample_last_only:
        convs.append((1, 2, 8, True))
    if unsup:
        convs += [(1, 2, 1, True)] * iterations
    return convs


def expected_train_comm(cfg, n_params, shape, mesh_shape, unsup=False):
    """{operation: (calls, bytes)} of one RAFT train step (the photometric
    one with ``unsup``) on a mesh ``mesh_shape`` (``{"data": d}`` or
    ``{"data": d, "model": m}``) for a batch of ``shape`` (B, H, W), as
    ``comm_stats`` counts it, from the configuration alone.

    All-reduces: each training-mode batch norm sums [2, C] float32 forward
    and its gradient backward (the feature encoder runs twice, the context
    encoder once), the loss its per-iteration sums both ways ([T] for the
    sequence loss, [T, 4] for the photometric one), the metric one sum, the
    gradient one flat all-reduce; each is one call per mesh axis. With a
    ``model`` axis of m > 1, every halo exchange (``_halo_convs``)
    all-gathers each band's first and last k rows of the data slice's B/d
    images, m * 2k rows, forward and, for its backward, all-reduces a
    gradient of that size; the second feature map is all-gathered once,
    each band padded to the largest (ceil(H / 8 / m) rows), and its
    gradient all-reduced once."""
    from feature_tracker_tpu_torch.models.raft import BatchNorm, Raft

    b, h, w = shape
    axes = len(mesh_shape)
    m = mesh_shape.get("model", 1)
    b //= mesh_shape["data"]
    t = cfg.max_iterations
    calls = nbytes = 0
    for name, module in Raft(cfg, device="cpu").named_modules():
        if isinstance(module, BatchNorm):
            runs = 2 if name.startswith("feature_enc") else 1
            calls += 2 * runs
            nbytes += 2 * runs * 2 * module.num_features * 4
    loss = 4 * t * (4 if unsup else 1)
    out = {"all_reduce": (axes * (calls + 4),
                          axes * (nbytes + 2 * loss + 4 + 4 * n_params))}
    if m == 1:
        return out
    halos = _halo_convs(cfg, t, unsup)
    size = [m * 2 * k * b * (w // s) * c * 4 for k, c, s, _ in halos]
    out["halo"] = (len(halos), sum(size))
    out["halo_backward"] = (sum(g for *_, g in halos),
                            sum(n for n, (*_, g) in zip(size, halos) if g))
    rows = -(-h // 8 // m)
    gather = m * rows * b * (w // 8) * cfg.feature_channels * 4
    out["row_gather"] = out["row_gather_backward"] = (1, gather)
    return out


def band_mesh_case(label, results, mesh_shape, cfg, n_params, shape, unsup,
                   want, want_m, spread=None):
    """The ranks' results of ``data_parallel_case`` on a mesh with a
    'model' axis: each rank's band rows (its first row and rows, and the
    rows of its first encoder activation and of fmap0) against the band
    rule, its collectives against ``expected_train_comm``, the ranks'
    states against each other (bit for bit) and against the one-rank step
    ``want`` by ``train_state_agree`` (the loss alone where ``want`` is
    None)."""
    from feature_tracker_tpu_torch.train.raft_train import TrainState

    b, h, w = shape
    m = mesh_shape["model"]
    units = h // 8
    sizes = [8 * (units // m + (i < units % m)) for i in range(m)]
    comm = expected_train_comm(cfg, n_params, shape, mesh_shape, unsup)
    states = []
    for rank, got in enumerate(results):
        j = rank % m
        rows = got["band_rows"]
        print(f"[parallel] {label} rank {rank} of {mesh_shape}: rows "
              f"{rows['start']}..{rows['start'] + rows['rows'] - 1} of {h}; "
              f"first encoder activation {rows['stem']} rows, fmap0 "
              f"{rows['fmap0']} rows")
        check(rows == {"start": sum(sizes[:j]), "rows": sizes[j],
                       "stem": sizes[j], "fmap0": sizes[j] // 8},
              f"{label} rank {rank}: not its band's rows")
        for op, (calls, nbytes) in comm.items():
            print(f"[parallel] {label} rank {rank} {op}: "
                  f"{got['comm'].get(op)} (expected {calls} calls, "
                  f"{nbytes} B)")
        check(got["comm"] == {op: {"calls": c, "bytes": n}
                              for op, (c, n) in comm.items()},
              f"{label} rank {rank}: unexpected collectives")
        state = TrainState(**to_device(got["state"], "cpu"))
        metrics = {k: got[k] for k in want_m}
        if want is None:
            for k, v in want_m.items():
                a, ref = float(metrics[k]), float(v)
                print(f"[compare] {label} rank {rank}: {k} {a:.6f} against "
                      f"{ref:.6f} on one rank")
                check(abs(a - ref) <= TRAIN_LOSS_RTOL * abs(ref),
                      f"{label}: {k} differs")
        else:
            train_state_agree(f"{label} rank {rank} vs one rank on the card",
                              state, want, metrics, want_m, spread)
        states.append(state)
    check(all(torch.equal(a, c) for s in states[1:]
              for a, c in zip(states[0].leaves(), s.leaves())),
          f"{label}: the ranks' states differ")


def timed_steps(label, run, card, steps, extra=""):
    """ms per step of ``run`` (CUDA events, median after warm-up) and the
    peak device memory over the run; prints one line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(run, repeats=steps - 3, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[train] {label}: {ms:.4f} ms per step (CUDA events, median of "
          f"{steps - 3} after 3 warm-up steps); peak memory {peak:.1f} MiB"
          f"{extra}; card {card}")
    return ms, peak


def train_paths(dev, card, weights_before):
    """Phase 9 (see the module docstring): RAFT's trainers, the checkpoint
    and the model trainers on the card, each step held to the CPU's."""
    import contextlib
    import io
    import tempfile

    from feature_tracker_tpu_torch.models.disk import Disk, DiskConfig
    from feature_tracker_tpu_torch.models.layers import flax_order
    from feature_tracker_tpu_torch.models.lightglue import (
        LightGlue,
        LightGlueConfig,
    )
    from feature_tracker_tpu_torch.models.raft import RaftConfig
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointConfig,
    )
    from feature_tracker_tpu_torch.ops import cuda_raft_lookup
    from feature_tracker_tpu_torch.parallel.multihost_ba import (
        run_cases,
        spawn,
    )
    from feature_tracker_tpu_torch.train import (
        disk_train,
        lightglue_train,
        raft_pretrain,
        superpoint_train,
    )
    from feature_tracker_tpu_torch.train.checkpoint import CheckpointManager
    from feature_tracker_tpu_torch.train.raft_train import (
        RaftTrainConfig,
        TrainState,
        data_parallel_case,
        make_optimizer,
        make_train_step,
        make_unsup_train_step,
        split_state,
    )
    from feature_tracker_tpu_torch.utils.weights import (
        load_disk_npz,
        load_lightglue_npz,
        load_raft_npz,
        load_superpoint_npz,
        weights_path,
    )

    t_phase = time.perf_counter()
    # 9a. RAFT at full width from the shipped weights, fresh optimizer.
    b, h, w = TRAIN_SHAPE
    cfg = RaftConfig(max_iterations=TRAIN_ITERS)
    tcfg = RaftTrainConfig(learning_rate=3e-4)
    params, stats = split_state(load_raft_npz(weights_path("raft.npz"), cfg))
    n_params = sum(v.numel() for v in params.values())
    n_stats = sum(v.numel() for v in stats.values())
    check(n_params + n_stats == RAFT_VARIABLES,
          f"RAFT has {n_params} parameters and {n_stats} statistics")
    start = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, batch_stats=stats,
                       opt_state=make_optimizer(tcfg).init(params))
    pool = raft_pretrain.make_pool(np.random.default_rng(0), TRAIN_STEPS, h,
                                   w, b, augment=False, device=dev)
    step = make_train_step(cfg, tcfg)
    one, m_one = step(start.to(dev), *pool[0])
    t0 = time.perf_counter()
    cpu_one, m_cpu = step(start, *(t.cpu() for t in pool[0]))
    print(f"[train] 9a one step on the CPU: {time.perf_counter() - t0:.1f} s"
          " (host clock)")
    label = (f"9a RAFT {n_params} parameters + {n_stats} statistics, "
             f"{b} x {h}x{w}, "
             f"{TRAIN_ITERS} iterations, card vs CPU")
    spread = train_spread(step, start, pool[0])
    train_state_agree(label, one, cpu_one, m_one, m_cpu, spread)
    box, losses = [start.to(dev)], []

    def run():
        box[0], m = step(box[0], *pool[len(losses) % len(pool)])
        losses.append(m["loss"])

    ms, peak = timed_steps(f"9a RAFT train step {b} x {h}x{w}, "
                           f"{TRAIN_ITERS} iterations (shipped weights, lr "
                           f"{tcfg.learning_rate:g})", run, card, TRAIN_STEPS)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"9a losses {losses}")
    print(f"[train] 9a losses over {len(losses)} steps: {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    profile_window(f"raft train step {b}x{h}x{w}", run, calls=5)

    cb, ch, cw, citers = CHAIRS
    ccfg = RaftConfig(max_iterations=citers)
    cpool = raft_pretrain.make_pool(np.random.default_rng(1), 1, ch, cw, cb,
                                    augment=False, device=dev)
    cstep = make_train_step(ccfg, tcfg)
    cbox, closses = [start.to(dev)], []

    def crun():
        cbox[0], m = cstep(cbox[0], *cpool[0])
        closses.append(m["loss"])

    _, c_peak = timed_steps(f"9a RAFT train step {cb} x {ch}x{cw}, {citers} "
                            "iterations (FlyingChairs crop and iterations of "
                            "the RAFT paper)", crun, card, 13)
    check(all(np.isfinite([float(x) for x in closses])), "9a chairs losses")
    t_phase = stage_done("9a (RAFT train step)", t_phase)

    # 9b. The unsupervised step on the same pool.
    ustep = make_unsup_train_step(cfg, tcfg)
    u_one, um = ustep(start.to(dev), pool[0][0], pool[0][1])
    u_cpu, umc = ustep(start, pool[0][0].cpu(), pool[0][1].cpu())
    uspread = train_spread(ustep, start, pool[0][:2])
    train_state_agree(f"9b RAFT unsupervised step {b} x {h}x{w}, card vs CPU",
                      u_one, u_cpu, um, umc, uspread)
    ubox = [start.to(dev)]

    def urun():
        ubox[0], _ = ustep(ubox[0], pool[0][0], pool[0][1])

    timed_steps(f"9b RAFT unsupervised step {b} x {h}x{w}", urun, card, 13)
    t_phase = stage_done("9b (unsupervised step)", t_phase)

    # 9c. Two ranks on the one card: the batch of 4 split 2 + 2. The same
    # two ranks then run 9g's (1, 2) meshes (each case makes its mesh).
    t_spawn = time.perf_counter()
    batch0 = [t.cpu().numpy() for t in pool[0]]
    cbatch = [t.cpu().numpy() for t in cpool[0]]
    band2 = functools.partial(data_parallel_case, shape=BAND_MESHES[0])
    with tempfile.TemporaryDirectory() as store:
        ranks = spawn(run_cases, 2, store, "cuda",
                      [(data_parallel_case, (cfg, tcfg, start, *batch0)),
                       (functools.partial(band2, time_steps=BAND_STEPS),
                        (cfg, tcfg, start, *batch0)),
                       (band2, (cfg, tcfg, start, *batch0[:2])),
                       (band2, (ccfg, tcfg, start, *cbatch))],
                      device="cuda", timeout=600.0)
    print(f"[parallel] 9c and 9g (i, ii) two ranks on the card (gloo, "
          f"FileStore): {time.perf_counter() - t_spawn:.1f} s, start-up and "
          f"{BAND_STEPS} timed steps included")
    calls, nbytes = expected_train_comm(cfg, n_params, TRAIN_SHAPE,
                                        {"data": 2})["all_reduce"]
    for rank, (got, *_) in enumerate(ranks):
        state = TrainState(**to_device(got["state"], "cpu"))
        train_state_agree(f"9c rank {rank} of 2 vs one rank on the card",
                          state, one, {k: got[k] for k in ("loss", "epe")},
                          m_one, spread)
        reduces = got["comm"]["all_reduce"]
        print(f"[parallel] 9c rank {rank} all-reduces: "
              f"{reduces['calls']} calls, {reduces['bytes']} B "
              f"(expected {calls} calls, {nbytes} B: the batch norms' "
              f"statistics both ways, the loss, the EPE, {n_params} "
              "gradients)")
        check(got["comm"] == {"all_reduce": {"calls": calls,
                                             "bytes": nbytes}},
              f"9c rank {rank}: unexpected collectives")
    t_phase = stage_done("9c (two ranks, gloo)", t_phase)

    # 9g. Height sharding: the rows of every image split into bands over a
    # mesh's 'model' axis, ranks sharing the one card through gloo (which
    # measures agreement, memory and traffic, not scaling).
    two, four = BAND_MESHES
    band_mesh_case("9g (i) supervised", [r[1] for r in ranks], two, cfg,
                   n_params, TRAIN_SHAPE, False, one, m_one, spread)
    print(f"[train] 9g (i) (1, 2) supervised step {b} x {h}x{w}: "
          + ", ".join(f"rank {i} {r[1]['step_ms']:.4f} ms"
                      for i, r in enumerate(ranks))
          + f" per step (host clock, median of {BAND_STEPS - 1} after one; "
          f"two processes on one card) against {ms:.4f} ms on one rank (9a); "
          f"card {card}")
    band_mesh_case("9g (i) unsupervised", [r[2] for r in ranks], two, cfg,
                   n_params, TRAIN_SHAPE, True, u_one, um, uspread)
    band_mesh_case("9g (ii) FlyingChairs crop", [r[3] for r in ranks], two,
                   ccfg, n_params, CHAIRS[:3], False, None,
                   {"loss": closses[0]})
    # One rank on one band's rows alone: what the rows cost, apart from
    # the halo rows and the gathered feature map.
    half = [t[:, :ch // 2] for t in cpool[0]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 20
    cstep(start.to(dev), *half)
    half_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"[train] 9g (ii) (1, 2) step {cb} x {ch}x{cw} x {citers}: peak "
          "memory " + ", ".join(
              f"rank {i} {r[3]['peak_bytes'] / 2 ** 20:.1f} MiB"
              for i, r in enumerate(ranks))
          + f" against {c_peak:.1f} MiB on one rank (9a) and "
          f"{half_peak:.1f} MiB for one rank's step on {ch // 2} rows alone "
          f"({half_peak - before:.1f} MiB of it the step's own; states "
          f"included); card {card}")
    t_spawn = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        quads = spawn(run_cases, 4, store, "cuda",
                      [(functools.partial(data_parallel_case, shape=four),
                        (cfg, tcfg, start, *batch0))],
                      device="cuda", timeout=600.0)
    print(f"[parallel] 9g (iii) four ranks on the card: "
          f"{time.perf_counter() - t_spawn:.1f} s, start-up included")
    band_mesh_case("9g (iii) supervised", [r[0] for r in quads], four, cfg,
                   n_params, TRAIN_SHAPE, False, one, m_one, spread)
    lcfg = dataclasses.replace(cfg, low_memory=True)
    lstep = make_train_step(lcfg, tcfg)
    launches = cuda_raft_lookup.lookup_correlation_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_one, lm = lstep(start.to(dev), *pool[0])
    torch.cuda.synchronize()
    l_s = time.perf_counter() - t0
    l_cpu, lmc = lstep(start, *(t.cpu() for t in pool[0]))
    check(cuda_raft_lookup.lookup_correlation_cuda.launches == launches,
          "9g (iv): low_memory training launched the lookup kernel")
    # The same function as 9a's step (another route to the correlation), so
    # 9a's one-ulp spread.
    train_state_agree(f"9g (iv) low_memory supervised step {b} x {h}x{w}, "
                      "card vs CPU", l_one, l_cpu, lm, lmc, spread)
    print(f"[train] 9g (iv) low_memory step on the card: {l_s * 1e3:.1f} ms "
          "(host clock, one step from cold; the plain on-the-fly lookup, no "
          f"kernel launch); card {card}")
    t_phase = stage_done("9g (height sharding, low_memory training)",
                         t_phase)

    # 9d. Checkpoint at step 5, restore into a fresh state, step 6 both ways.
    s5 = start.to(dev)
    for i in range(5):
        s5, _ = step(s5, *pool[i])
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), max_to_keep=2)
        check(mgr.save(5, s5), "9d: the first save did not happen")
        restored = mgr.restore(start.to(dev))
        check(all(torch.equal(a, b) for a, b in
                  zip(restored.leaves(), s5.leaves())),
              "9d: the restored state differs from the saved one")
        direct = step(s5, *pool[5])[0]
        resumed = step(restored, *pool[5])[0]
        again = [step(s5, *pool[5])[0] for _ in range(2)]

        def diff(a, b):
            return max(float((x.float() - y.float()).abs().max())
                       for x, y in zip(a.leaves(), b.leaves()))

        d_resumed = diff(direct, resumed)
        spread = max(diff(direct, a) for a in again)
        held = ("bit-equal" if d_resumed == 0 else
                f"within {d_resumed:.3g}, twice the spread of identical "
                f"step-6 runs being {2 * spread:.3g}")
        print(f"[train] 9d step 6 from the restored step-5 checkpoint "
              f"against step 6 without it: {held}; identical runs differ by "
              f"up to {spread:.3g} (cuDNN's and the lookup's backward "
              f"{'are' if spread == 0 else 'are not'} deterministic here)")
        check(d_resumed <= 2 * spread, "9d: the resumed step differs")
        mgr.save(6, direct)
        mgr.save(7, step(direct, *pool[0])[0])
        check(mgr.all_steps() == [6, 7] and not mgr.save(7, direct),
              f"9d: retention kept {mgr.all_steps()}")
        try:
            CheckpointManager(os.path.join(tmp, "empty")).restore(start)
            check(False, "9d: restoring from an empty directory")
        except FileNotFoundError:
            pass
    t_phase = stage_done("9d (checkpoint)", t_phase)

    # 9e. The model trainers at their shipped configurations and weights,
    # with their trainers' defaults.
    rng = np.random.default_rng(2)

    def sp_batch():
        imgs, labs = [], []
        for _ in range(4):
            img, corners = superpoint_train.synthetic_corners_image(rng, 64,
                                                                    64)
            imgs.append(img[..., None])
            labs.append(superpoint_train.corner_label_map(corners, 64, 64))
        return np.stack(imgs), np.stack(labs)

    def disk_batch():
        a, bb, (dx, dy) = disk_train.translated_training_pair(rng, 64, 64)
        uv_a = rng.uniform(10, [54, 54], (disk_train.DiskTrainConfig()
                                          .num_samples, 2)).astype(np.float32)
        return a, bb, uv_a, uv_a + np.array([dx, dy], np.float32)

    def lg_batch():
        return lightglue_train.synthetic_matching_problem(rng, 64, 64, 256,
                                                          40)

    trainers = (
        ("SuperPoint", superpoint_train, SuperPoint, SuperPointConfig(),
         superpoint_train.SuperPointTrainConfig(),
         load_superpoint_npz(weights_path("superpoint.npz")), sp_batch,
         "4 x 64x64 synthetic corners"),
        ("DISK", disk_train, Disk, DiskConfig(), disk_train.DiskTrainConfig(),
         load_disk_npz(weights_path("disk.npz")), disk_batch,
         "64x64 pairs, 128 samples"),
        ("LightGlue", lightglue_train, LightGlue, LightGlueConfig(),
         lightglue_train.LightGlueTrainConfig(),
         load_lightglue_npz(weights_path("lightglue_superpoint.npz")),
         lg_batch, "64 + 64 keypoints, 40 matched, depth 9"))
    for name, module, model_cls, mcfg, tr_cfg, state, make, shape in trainers:
        params = flax_order(state)
        step_card, tx = module.make_train_step(model_cls(mcfg, device=dev),
                                               tr_cfg)
        step_cpu, _ = module.make_train_step(model_cls(mcfg, device="cpu"),
                                             tr_cfg)
        opt = tx.init(params)
        batches = [make() for _ in range(TRAIN_STEPS)]
        p_d, o_d, l_d = step_card(to_device(params, dev), to_device(opt, dev),
                                  *batches[0])
        p_c, o_c, l_c = step_cpu(params, opt, *batches[0])
        l_d, l_c = (float(x["loss"] if isinstance(x, dict) else x)
                    for x in (l_d, l_c))
        print(f"[compare] 9e {name}: loss {l_d:.6f} on the card, {l_c:.6f} "
              "on the CPU")
        check(abs(l_d - l_c) <= TRAIN_LOSS_RTOL * abs(l_c),
              f"9e {name}: losses differ")
        moments_agree(f"9e {name} trainer, card vs CPU", (p_d, o_d),
                      (p_c, o_c))
        mbox, it = [to_device(params, dev), to_device(opt, dev)], [0]

        def mrun():
            mbox[0], mbox[1], _ = step_card(mbox[0], mbox[1],
                                            *batches[it[0] % len(batches)])
            it[0] += 1

        timed_steps(f"9e {name} train step, {shape} (shipped weights)", mrun,
                    card, TRAIN_STEPS)
        profile_window(f"{name} train step", mrun, calls=5)
    t_phase = stage_done("9e (model trainers)", t_phase)

    # 9f. raft_pretrain.main at the full configuration, writing into a
    # temporary directory.
    with tempfile.TemporaryDirectory() as tmp:
        shipped_dir = raft_pretrain.WEIGHTS_DIR
        raft_pretrain.WEIGHTS_DIR = tmp
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                agg = raft_pretrain.main(steps=20, h=128, w=128, batch=4,
                                         iters=8, device="cuda")
        finally:
            raft_pretrain.WEIGHTS_DIR = shipped_dir
        print(out.getvalue().rstrip())
        check("[raft] held-out:" in out.getvalue()
              and np.isfinite(agg["epe"]), "9f: no held-out line")
        check(sorted(os.listdir(tmp)) == ["metrics.json", "raft.npz"],
              f"9f wrote {sorted(os.listdir(tmp))}")
        load_raft_npz(os.path.join(tmp, "raft.npz"), cfg)
    check(tree_digest("weights") == weights_before,
          "a file under weights/ changed during the run")
    print("[train] 9f weights/ unchanged: every file's sha256 as before the "
          "run")
    stage_done("9f (raft_pretrain.main)", t_phase)


# -------------------------------------------------------------- phase 10
def captured_pools(stage, *args, **kw):
    """Run a SuperPoint pretraining stage (``adapt_superpoint``,
    ``distill_superpoint_from_disk``) with its training loop replaced by
    one that keeps the pool it is given and trains nothing: the pools as
    the stage builds them, on its model's device."""
    from feature_tracker_tpu_torch.train import pretrain

    pools, loop = [], pretrain._sp_train_loop

    def keep(step, params, opt_state, pool, *rest):
        pools.append(pool)
        return params, opt_state, []

    pretrain._sp_train_loop = keep
    try:
        stage(*args, **kw)
    finally:
        pretrain._sp_train_loop = loop
    return pools


def pool_batches(pool, batch):
    """The pool's entries stacked ``batch`` at a time, in order, as
    ``_sp_train_loop`` stacks them (numpy)."""
    return [[np.stack([e[i] for e in pool[j:j + batch]])
             for i in range(len(pool[0]))]
            for j in range(0, len(pool) - batch + 1, batch)]


def disk_pretrain_batch(rng, h, w, samples):
    """One ``train_disk`` input as it draws it: a warped texture pair and
    ``samples`` correspondences, degenerate where they leave the image."""
    from feature_tracker_tpu_torch.train.pretrain import warped_texture_pair

    a, b, warp = warped_texture_pair(rng, h, w, max_theta=0.12,
                                     max_shift=8.0)
    margin = 14
    uv_a = rng.uniform(margin, [w - margin, h - margin],
                       (samples, 2)).astype(np.float32)
    uv_b = warp(uv_a).astype(np.float32)
    keep = ((uv_b[:, 0] > 2) & (uv_b[:, 0] < w - 3)
            & (uv_b[:, 1] > 2) & (uv_b[:, 1] < h - 3))
    uv_a[~keep] = margin
    uv_b[~keep] = margin
    return a, b, uv_a, uv_b


def step_card_vs_cpu(label, dev, step_card, step_cpu, params, opt_state,
                     batch, nudged):
    """One step on the card against the same step on the CPU from the same
    state (``moments_agree``, within twice the CPU's one-ulp spread where
    that is larger; the loss within TRAIN_LOSS_RTOL), and the card's
    state after it."""
    p_d, o_d, l_d = step_card(to_device(params, dev),
                              to_device(opt_state, dev),
                              *to_device(tuple(batch), dev))[:3]
    p_c, o_c, l_c = step_cpu(params, opt_state, *batch)[:3]
    spread = step_spread(step_cpu, params, opt_state, batch, nudged)
    l_d, l_c = float(l_d), float(l_c)
    print(f"[compare] {label}: loss {l_d:.6f} on the card, {l_c:.6f} on the "
          "CPU")
    check(abs(l_d - l_c) <= TRAIN_LOSS_RTOL * abs(l_c),
          f"{label}: losses differ")
    moments_agree(label, (p_d, o_d), (p_c, o_c), spread=spread)
    return p_d, o_d


def timed_model_steps(label, dev, step, params, opt_state, batches, card):
    """TRAIN_STEPS steps of ``step`` on the card over ``batches`` (moved
    there first): ms per step and peak memory (``timed_steps``), and the
    device's idle share over five more (``profile_window``)."""
    batches = [to_device(tuple(b), dev) for b in batches]
    box, it = [to_device(params, dev), to_device(opt_state, dev)], [0]

    def run():
        out = step(box[0], box[1], *batches[it[0] % len(batches)])
        box[0], box[1] = out[0], out[1]
        it[0] += 1

    ms, peak = timed_steps(label, run, card, TRAIN_STEPS)
    profile_window(label, run, calls=5)
    return ms, peak


def pretrain_paths(dev, card, weights_before):
    """Phase 10 (see the module docstring): the pretraining stages of
    ``train/pretrain.py`` and ``train/cotracker_pretrain.py`` on the card,
    each step held to the CPU's; returns kernel 1's launches in the
    reference-pair counts."""
    import contextlib
    import io
    import tempfile

    from synthetic import translated_pair

    from feature_tracker_tpu_torch.models.cotracker import CoTracker
    from feature_tracker_tpu_torch.models.disk import Disk, DiskConfig
    from feature_tracker_tpu_torch.models.layers import flax_order
    from feature_tracker_tpu_torch.models.lightglue import (
        LightGlue,
        LightGlueConfig,
    )
    from feature_tracker_tpu_torch.models.superpoint import (
        SuperPoint,
        SuperPointDetector,
    )
    from feature_tracker_tpu_torch.ops import cuda_klt
    from feature_tracker_tpu_torch.train import cotracker_pretrain, pretrain
    from feature_tracker_tpu_torch.train.disk_train import (
        DiskTrainConfig,
        make_train_step,
    )
    from feature_tracker_tpu_torch.train.optim import (
        ClipAdamW,
        warmup_cosine_schedule,
    )
    from feature_tracker_tpu_torch.utils.weights import (
        load_cotracker_npz,
        load_disk_npz,
        load_lightglue_npz,
        load_superpoint_npz,
        shipped_cotracker_config,
        weights_path,
    )

    t_phase = time.perf_counter()
    b, h, w = PRE_SHAPE
    sp_state = flax_order(load_superpoint_npz(weights_path("superpoint.npz")))
    sp_card = SuperPoint(device=dev)
    sp_cpu = SuperPoint(device="cpu")

    # 10b's pools first: adapt_superpoint's (Harris labels, with and without
    # point descriptors) and distill_superpoint_from_disk's (DISK labels
    # and teacher targets), built on the card by the stages themselves.
    pools = {pd: captured_pools(pretrain.adapt_superpoint, sp_card,
                                sp_state, rounds=1, steps=0, h=h, w=w,
                                batch=b, pool_size=PRE_POOL,
                                point_desc=pd)[0]
             for pd in (False, True)}
    pools["distill"] = captured_pools(
        pretrain.distill_superpoint_from_disk, sp_card, sp_state, steps=0,
        h=h, w=w, batch=b, pool_size=PRE_POOL)[0]
    t_phase = stage_done("10 pools (adapt_superpoint, distill_superpoint_"
                         "from_disk; Harris and DISK labels on the card)",
                         t_phase)

    # 10a. SuperPoint's training mode, 4 x 96x96, from the shipped weights.
    images = np.stack([e[0] for e in pools[True][:b]])
    sp_card.load_state_dict(sp_state)
    sp_cpu.load_state_dict(sp_state)
    (heat_d, desc_d), stats_d = sp_card(images, train=True)
    (heat_c, desc_c), stats_c = sp_cpu(images, train=True)
    d_heat = float((heat_d.detach().cpu() - heat_c.detach()).abs().max())
    d_desc = float((desc_d.detach().cpu() - desc_c.detach()).abs().max())
    d_desc /= float(desc_c.detach().abs().max())
    d_stats = max(float(((stats_d[k].cpu() - v).abs()
                         - TRAIN_STATS_RTOL * v.abs()).max())
                  for k, v in stats_c.items())
    print(f"[compare] 10a SuperPoint train=True {b} x {h}x{w}, card vs CPU: "
          f"heatmap within {d_heat:.3g}, descriptors within {d_desc:.3g} of "
          f"their largest, {len(stats_c)} new running statistics within "
          f"{TRAIN_STATS_RTOL:g} relative + {d_stats:.3g}")
    check(list(stats_d) == list(stats_c) and len(stats_c) == 20,
          "10a: the new statistics differ in layout")
    check(d_heat <= SP_TRAIN_HEAT_TOL and d_desc <= SP_TRAIN_DESC_TOL
          and d_stats <= TRAIN_STATS_ATOL, "10a: training mode differs")
    x = torch.from_numpy(images).to(dev)

    def sp_forward():
        sp_card(x, train=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(sp_forward, repeats=TRAIN_STEPS - 3, warmup=3)
    print(f"[train] 10a SuperPoint train=True forward {b} x {h}x{w}: {ms:.4f} "
          f"ms per call (CUDA events); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; card "
          f"{card}")
    profile_window("10a SuperPoint train=True forward", sp_forward, calls=5)
    t_phase = stage_done("10a (SuperPoint training mode)", t_phase)

    # 10b. The SuperPoint steps at train_superpoint's shape.
    hc, wc = h // 8, w // 8
    for kind in (False, True, "distill"):
        tx = ClipAdamW(2e-4 if kind == "distill" else 1e-4,
                       weight_decay=1e-5)
        if kind == "distill":
            make = pretrain._make_sp_distill_step
            card_step, cpu_step = (make(m, tx) for m in (sp_card, sp_cpu))
            label = "distillation step"
        else:
            card_step, cpu_step = (
                pretrain._make_sp_step(m, tx, hc, wc, point_desc=kind)
                for m in (sp_card, sp_cpu))
            label = f"step, point_desc={kind}"
        batches = pool_batches(pools[kind], b)
        opt = tx.init(sp_state)
        step_card_vs_cpu(f"10b SuperPoint {label}, {b} x {h}x{w}, card vs "
                         "CPU", dev, card_step, cpu_step, sp_state, opt,
                         batches[0], (0, 1))
        timed_model_steps(f"10b SuperPoint {label}, {b} x {h}x{w} (shipped "
                          "weights)", dev, card_step, sp_state, opt, batches,
                          card)
    t_phase = stage_done("10b (SuperPoint steps)", t_phase)

    # 10c. DISK (192 samples at 96x96), LightGlue at train_lightglue's
    # defaults on the shipped SuperPoint detector, evaluate_matching.
    rng = np.random.default_rng(10)
    disk_state = flax_order(load_disk_npz(weights_path("disk.npz")))
    tcfg = DiskTrainConfig(num_samples=192, learning_rate=1e-3)
    d_card, tx = make_train_step(Disk(DiskConfig(), device=dev), tcfg)
    d_cpu, _ = make_train_step(Disk(DiskConfig(), device="cpu"), tcfg)
    batches = [disk_pretrain_batch(rng, h, w, 192) for _ in range(4)]
    opt = tx.init(disk_state)
    step_card_vs_cpu(f"10c DISK step, {h}x{w} pair, 192 samples, card vs "
                     "CPU", dev, d_card, d_cpu, disk_state, opt, batches[0],
                     (0, 1))
    timed_model_steps(f"10c DISK step, {h}x{w} pair, 192 samples (shipped "
                      "weights)", dev, d_card, disk_state, opt, batches, card)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, _, hist = pretrain.train_disk(steps=3, h=h, w=w,
                                         init_params=disk_state, device=dev)
    check(all(np.isfinite(x["loss"]) for x in hist), "10c train_disk")

    lh, lw, n_kpts, depth = LG_PRE
    sp_det = SuperPointDetector(sp_state, max_features=n_kpts,
                                min_response=0.01, device=dev)
    lcfg = LightGlueConfig(depth=depth)
    lg_state = flax_order(load_lightglue_npz(
        weights_path("lightglue_superpoint.npz"), lcfg))
    tx = ClipAdamW(1e-4, weight_decay=1e-5)
    lg_card = LightGlue(lcfg, device=dev)
    l_card = pretrain._make_lightglue_step(lg_card, tx)
    l_cpu = pretrain._make_lightglue_step(LightGlue(lcfg, device="cpu"), tx)
    samples = [to_device(pretrain.make_lightglue_sample(
        sp_det, rng, lh, lw, n_kpts), "cpu") for _ in range(4)]
    matched = [int((s[-1] >= 0).sum()) for s in samples]
    opt = tx.init(lg_state)
    step_card_vs_cpu(f"10c LightGlue step, {n_kpts} + {n_kpts} keypoints of "
                     f"{lh}x{lw} pairs ({matched} matched), depth {depth}, "
                     "card vs CPU", dev, l_card, l_cpu, lg_state, opt, samples[0],
                     ())
    timed_model_steps(f"10c LightGlue step, {n_kpts} keypoints, depth {depth} "
                      "(shipped weights)", dev, l_card, lg_state, opt, samples,
                      card)
    with contextlib.redirect_stdout(out):
        lg_model, lg_params, hist = pretrain.train_lightglue(
            sp_det, steps=3, init_params=lg_state)
    check(all(np.isfinite(x["loss"]) for x in hist), "10c train_lightglue")
    t0 = time.perf_counter()
    ev = pretrain.evaluate_matching(sp_det, lg_model, lg_params, n_pairs=4)
    print(f"[train] 10c evaluate_matching on 4 pairs of {lh}x{lw}: {ev}; "
          f"{time.perf_counter() - t0:.2f} s (host clock)")
    check(ev["gt_matches"] > 0 and 0 <= ev["precision"] <= 1,
          "10c evaluate_matching")
    t_phase = stage_done("10c (DISK, LightGlue, evaluate_matching)", t_phase)

    # 10d. The reference-pair counts on a synthetic 752x480 pair in place
    # of the reference pair, on the card (kernel 1 in _klt_verified) and
    # on the CPU.
    pair = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    loader = pretrain._load_reference_pair
    pretrain._load_reference_pair = lambda: pair
    try:
        counts = {}
        for where in (dev, torch.device("cpu")):
            det = SuperPointDetector.from_file(max_features=PRE_COUNT_CAP,
                                               min_response=0.01,
                                               device=where)
            lg = LightGlue(device=where)
            params = {k: v.to(where) for k, v in lg_state.items()}
            if where == dev:
                cuda_klt.track_pyramid_fast_cuda.launches = 0
            t0 = time.perf_counter()
            counts[where.type] = (pretrain.reference_pair_counts(det),
                                  pretrain.reference_pair_lightglue_counts(
                                      det, lg, params))
            if where == dev:
                torch.cuda.synchronize()
                count_s = time.perf_counter() - t0
                launches = cuda_klt.track_pyramid_fast_cuda.launches
    finally:
        pretrain._load_reference_pair = loader
    print(f"[compare] 10d reference-pair counts on the synthetic {W}x{H} pair "
          f"(card / CPU): nearby-match {counts[dev.type][0]} / "
          f"{counts['cpu'][0]}; LightGlue {counts[dev.type][1]} / "
          f"{counts['cpu'][1]}; {launches} launches of the FAST kernel in "
          f"the two _klt_verified calls; {count_s:.2f} s (host clock)")
    check(launches == 2, f"10d: {launches} FAST launches for two counts")
    for got, want in zip(counts[dev.type], counts["cpu"]):
        limit = max(1, int(KLT_STATUS_SHARE * PRE_COUNT_CAP))
        check(got["raw"] == want["raw"]
              and abs(got["verified"] - want["verified"]) <= limit,
              f"10d: counts {got} on the card, {want} on the CPU")
    t_phase = stage_done("10d (reference-pair counts)", t_phase)

    # 10e. CoTracker's train step at the shipped run's configuration.
    cb, ct, ch, cw, cn = COT_TRAIN
    ccfg = shipped_cotracker_config()
    cot_state = flax_order(load_cotracker_npz(weights_path("cotracker.npz"),
                                              ccfg))
    sched = warmup_cosine_schedule(1e-4, 500, 3000, init_value=0.0,
                                   end_value=1e-6)
    tx = ClipAdamW(sched, weight_decay=1e-4)
    opt = tx.init(cot_state)

    def cot_steps(cfg):
        """The train step on the card and on the CPU, as ``(params,
        opt_state, *batch) -> (params, opt_state, loss)`` with the average
        started at the parameters."""
        def wrap(step):
            def run(params, opt_state, *batch):
                params, _, opt_state, loss, _ = step(params, params,
                                                     opt_state, *batch)
                return params, opt_state, loss
            return run
        return [wrap(cotracker_pretrain.make_train_step(
            CoTracker(cfg, device=d), tx)) for d in (dev, "cpu")]

    cpool = cotracker_pretrain.make_pool(np.random.default_rng(11), 3, cb,
                                         ct, ch, cw, cn, wide_motion=True,
                                         device="cpu")
    shape = (f"{cb} clips of {ct}x{ch}x{cw}, {cn} points, config "
             f"{ccfg.feature_dim}/{ccfg.model_dim}/{ccfg.depth}")
    # At the shipped configuration the gradients that cross the flow
    # embedding's top frequencies (2^47) from one iteration to the next
    # grow until their global norm overflows float32, so the clipped
    # update is 0 (tests/test_torch_cotracker_shipped_step.py: in JAX
    # too): the loss is held, and the moments are held to be 0 on both.
    card_step, cpu_step = cot_steps(ccfg)
    _, o_d, l_d = card_step(to_device(cot_state, dev), to_device(opt, dev),
                            *to_device(tuple(cpool[0]), dev))
    _, o_c, l_c = cpu_step(cot_state, opt, *cpool[0])
    l_d, l_c = float(l_d), float(l_c)
    zero = [all(float(v.abs().max()) == 0 for o in (o_s["mu"], o_s["nu"])
                for v in o.values()) for o_s in (o_d, o_c)]
    print(f"[compare] 10e CoTracker step from the shipped weights, {shape}/"
          f"{ccfg.iterations}, card vs CPU: loss {l_d:.6f} / {l_c:.6f}; "
          f"every Adam moment 0 (the global gradient norm overflows "
          f"float32): {zero[0]} / {zero[1]}")
    check(abs(l_d - l_c) <= TRAIN_LOSS_RTOL * abs(l_c),
          "10e: losses differ")
    check(zero == [True, True], "10e: the overflow differs on the card")
    # The same widths and weights with the refinement cut to one
    # iteration, where no gradient crosses the flow embedding: every leaf
    # has a finite gradient that is not 0, and the moments are held.
    one = dataclasses.replace(ccfg, iterations=1)
    one_steps = cot_steps(one)
    _, o_d = step_card_vs_cpu(
        f"10e CoTracker step from the shipped weights, {shape}/1, card vs "
        "CPU", dev, *one_steps, cot_state, opt, cpool[0], (0,))
    timed_model_steps(f"10e CoTracker step at one iteration, {cb} x "
                      f"{ct}x{ch}x{cw} (shipped weights)", dev, one_steps[0],
                      cot_state, opt, cpool, card)
    silent = [k for k, v in o_d["mu"].items()
              if not (bool(torch.isfinite(v).all())
                      and float(v.abs().max()) > 0)]
    print(f"[train] 10e at one iteration: {len(o_d['mu']) - len(silent)} of "
          f"{len(o_d['mu'])} leaves have a finite gradient that is not 0")
    check(not silent, f"10e: no gradient reaches {silent}")
    c_step = cotracker_pretrain.make_train_step(CoTracker(ccfg, device=dev),
                                                tx)
    cbox = [to_device(cot_state, dev), to_device(cot_state, dev),
            to_device(opt, dev)]
    dpool = [to_device(tuple(x), dev) for x in cpool]
    losses = []

    def crun():
        out = c_step(*cbox, *dpool[len(losses) % len(dpool)])
        cbox[:] = out[:3]
        losses.append(out[3])

    timed_steps(f"10e CoTracker step with the parameter average, {cb} x "
                f"{ct}x{ch}x{cw} (shipped weights)", crun, card, TRAIN_STEPS)
    profile_window("10e CoTracker step", crun, calls=5)
    check(all(np.isfinite([float(x) for x in losses])), "10e losses")
    t_phase = stage_done("10e (CoTracker step)", t_phase)

    # 10f. Both mains, a handful of steps per stage, full widths, into a
    # temporary directory.
    with tempfile.TemporaryDirectory() as tmp:
        shipped_dirs = [m.WEIGHTS_DIR for m in (pretrain, cotracker_pretrain)]
        for module in (pretrain, cotracker_pretrain):
            module.WEIGHTS_DIR = tmp
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                pretrain.main(sp_steps=2, disk_steps=2, lg_steps=2,
                              adapt_rounds=1, adapt_steps=2, adapt_pool=4,
                              lg_disk_steps=2, device=dev)
                agg = cotracker_pretrain.main(
                    steps=3, batch=cb, pool_size=3, eval_videos=2,
                    feature_dim=ccfg.feature_dim, model_dim=ccfg.model_dim,
                    depth=ccfg.depth, iterations=ccfg.iterations,
                    device=dev)
        finally:
            for module, shipped in zip((pretrain, cotracker_pretrain),
                                       shipped_dirs):
                module.WEIGHTS_DIR = shipped
        text = out.getvalue()
        print("\n".join(line for line in text.splitlines()
                        if line.startswith("[")))
        files = sorted(os.listdir(tmp))
        check(files == ["cotracker.npz", "disk.npz", "lightglue_disk.npz",
                        "lightglue_superpoint.npz", "metrics.json",
                        "superpoint.npz"], f"10f wrote {files}")
        with open(os.path.join(tmp, "metrics.json")) as fh:
            metrics = json.load(fh)
        check(list(metrics) == PRETRAIN_KEYS + ["cotracker"],
              f"10f metrics.json keys {list(metrics)}")
        load_superpoint_npz(os.path.join(tmp, "superpoint.npz"))
        load_disk_npz(os.path.join(tmp, "disk.npz"))
        load_lightglue_npz(os.path.join(tmp, "lightglue_superpoint.npz"))
        load_lightglue_npz(os.path.join(tmp, "lightglue_disk.npz"),
                           LightGlueConfig(descriptor_dim=128))
        load_cotracker_npz(os.path.join(tmp, "cotracker.npz"), ccfg)
        check(np.isfinite(agg["epe"]), "10f: CoTracker's held-out EPE")
    check(tree_digest("weights") == weights_before,
          "a file under weights/ changed during the run")
    print("[train] 10f both mains wrote JAX's files and metrics.json keys "
          "into a temporary directory; weights/ unchanged: every file's "
          "sha256 as before the run")
    stage_done("10f (pretrain.main, cotracker_pretrain.main)", t_phase)
    return launches


# -------------------------------------------------------------- phase 11
# The port's demos, in feature_tracker_tpu_torch/demos/run.sh's order.
DEMOS = ("raft_demo", "track_demo", "dense_flow_demo", "direct_method_demo",
         "match_brief_demo", "match_superpoint_demo", "match_disk_demo",
         "nn_matcher_demo", "stream_demo", "slam_demo", "cotracker_demo")
# The synthetic pair's true flow (dx, dy), away from the wrapped border;
# the KLT solver stops once a step is under sqrt(4e-2) = 0.2 px.
DEMO_FLOW, DEMO_FLOW_TOL = (-3.0, 5.0), 0.2
DEMO_WARP_UV_TOL = 5e-3         # px, the affine and SE(2) trackers
DEMO_PNG_SHARE = 1e-3           # overlay pixels that may differ


def statuses_agree(label, got, want):
    """Phase 2's status rule: at most 0.1 % differ (at least 1 may)."""
    bad = int((np.asarray(got) != np.asarray(want)).sum())
    check(bad <= max(1, int(KLT_STATUS_SHARE * np.size(got))),
          f"{label}: {bad} statuses differ")
    return bad


def tracked_uv_err(label, got_uv, got_st, want_uv, want_st, tol):
    both = (np.asarray(got_st) == 1) & (np.asarray(want_st) == 1)
    check(both.any(), f"{label}: no feature tracked on both sides")
    err = float(np.abs(np.asarray(got_uv)[both]
                       - np.asarray(want_uv)[both]).max())
    check(err <= tol, f"{label}: uv {err} px apart (limit {tol})")
    return err


def overlays_agree(label, got, want, exact=False):
    """The share of overlay pixels that differ between the card's and the
    CPU's PNGs of one demo; zero where the numbers are equal."""
    shares = []
    for name in sorted(want):
        a, b = got[name], want[name]
        check(a.shape == b.shape, f"{label}: {name} shapes differ")
        shares.append(float((a != b).any(axis=-1).mean()))
    limit = 0.0 if exact else DEMO_PNG_SHARE
    check(max(shares, default=0.0) <= limit,
          f"{label}: overlays differ in {shares} of their pixels")
    return max(shares, default=0.0)


def hold_track(c, p, synthetic):
    check(c["num"] == p["num"] and np.array_equal(c["uv"], p["uv"]),
          "track_demo: detections differ from the CPU's")
    parts = []
    for name in ("basic", "affine", "lssd"):
        tol = UV_TOL if name == "basic" else DEMO_WARP_UV_TOL
        bad = statuses_agree(f"track_demo {name}", c[name]["status"],
                             p[name]["status"])
        err = tracked_uv_err(f"track_demo {name}", c[name]["uv"],
                             c[name]["status"], p[name]["uv"],
                             p[name]["status"], tol)
        ok = c[name]["status"] == 1
        flow = np.median(c[name]["uv"][ok] - c["uv"][ok], axis=0)
        check(not synthetic or np.abs(flow - DEMO_FLOW).max()
              <= DEMO_FLOW_TOL, f"track_demo {name}: median flow {flow}")
        parts.append(f"{name} {c[name]['tracked']}/{c['num']} tracked, "
                     f"{bad} statuses and {err:.3g} px from the CPU, median "
                     f"flow ({flow[0]:.4f}, {flow[1]:.4f}), "
                     f"{c[name]['ms']:.4f} ms/call steady state")
    return "; ".join(parts)


def stream_replay(left, cur_frames, delivered, device):
    """stream_demo's loop on the frames that came through the ring, their
    pyramids built by build_pyramid (the ring's convert + pyramid gives the
    same, phase 6d): the per-frame uv and statuses."""
    from feature_tracker_tpu_torch.core.config import (
        HarrisOptions,
        KltOptions,
    )
    from feature_tracker_tpu_torch.core.status import TrackStatus
    from feature_tracker_tpu_torch.demos import stream_demo
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.trackers.klt import BasicKlt

    cap = stream_demo.MAX_FEATURES
    frames = [np.clip(f, 0, 255).astype(np.uint8)
              for f in [left] + list(cur_frames)]
    pyrs = [build_pyramid(frames[i], stream_demo.LEVELS, device=device)
            for i in delivered]
    uv, num = detect_good_features(pyrs[0][0], cap, HarrisOptions(
        min_feature_distance=25, min_valid_response=40.0), device=device)
    status = torch.where(torch.arange(cap, device=device) < num,
                         int(TrackStatus.NOT_TRACKED),
                         int(TrackStatus.OUTSIDE)).to(torch.int8)
    tracker = BasicKlt(KltOptions(max_track_points=cap), device=device)
    out = []
    for k in range(1, len(pyrs)):
        uv, status = tracker.track(pyrs[k - 1], pyrs[k], uv, uv, status)
        out.append((uv.cpu().numpy(), status.cpu().numpy()))
        status = torch.where(status == int(TrackStatus.TRACKED),
                             int(TrackStatus.NOT_TRACKED),
                             status).to(torch.int8)
    return out


def hold_direct(c, p, baseline, synthetic):
    err = max(float(np.abs(np.asarray(c[k]) - np.asarray(p[k])).max())
              for k in ("q_rc", "p_rc"))
    check(err <= DIRECT_POSE_TOL, f"direct_method_demo: poses {err} apart")
    truth = np.array([[-2 * (k + 1) * baseline / 64.0, 0, 0]
                      for k in range(len(c["p_rc"]))])
    terr = float(np.abs(np.asarray(c["p_rc"]) - truth).max())
    check(not synthetic or terr <= DIRECT_POSE_TOL, f"direct_method_demo: "
          f"p_rc {terr} from the synthetic set's translation")
    bad = statuses_agree("direct_method_demo", c["status"], p["status"])
    uv_err = tracked_uv_err("direct_method_demo", c["cur_uv"], c["status"],
                            p["cur_uv"], p["status"], DIRECT_UV_TOL)
    return (f"poses {err:.3g} from the CPU and {terr:.3g} from the true "
            f"translation (p_x of frame 5 {c['p_rc'][-1][0]:.7f}), "
            f"{bad} statuses and {uv_err:.3g} px from the CPU, tracked "
            f"{c['tracked']}")


def hold_dense(c, p, synthetic):
    """Phase 6c's interior statistics; on the synthetic pair over the
    pixels whose flow follows the true one (within 1 px; the flow
    diverges by the wrapped border), and the 99th percentile and a mean
    within DENSE_FAR over the whole interior."""
    m = DENSE_MARGIN
    truth = np.array([DEMO_FLOW[1], DEMO_FLOW[0]])[:, None, None]
    inner = c["flow"][:, m:-m, m:-m]
    follows = ((np.abs(inner - truth) < 1.0).all(axis=0) if synthetic
               else np.ones(inner.shape[1:], bool))
    d = np.abs(inner - p["flow"][:, m:-m, m:-m])
    df = d[:, follows]
    check(follows.mean() >= 0.98 and df.mean() <= DENSE_MEAN
          and np.percentile(df, 99) <= DENSE_P99
          and np.percentile(d, 99) <= DENSE_P99 and d.mean() <= DENSE_FAR,
          "dense_flow_demo: card vs CPU beyond the statistics' limits")
    return (f"interior pixels following the true flow {follows.mean():.4f}: "
            f"mean |d| {df.mean():.3g} px, p99 {np.percentile(df, 99):.3g}; "
            f"whole interior mean {d.mean():.3g}, p99 "
            f"{np.percentile(d, 99):.3g}, max {d.max():.3g}; "
            f"{c['ms']:.4f} ms/frame steady state")


def hold_equal(label, c, p, keys):
    for key in keys:
        check(np.array_equal(np.asarray(c[key]), np.asarray(p[key])),
              f"{label}: {key} differs from the CPU's")
    return f"{c['tracked']}/{c['n_ref']} matched, as on the CPU"


def hold_matches(label, c, p):
    """A learned detector's keypoints and their matches against the CPU's:
    the same counts and keypoints, whose order may differ where two
    scores lie closer than the heatmaps' float32 difference (~2e-6); per
    keypoint, by position, the same status (phase 2's share rule) and,
    where both matched, the same matched position."""
    check((c["n_ref"], c["n_cur"]) == (p["n_ref"], p["n_cur"]),
          f"{label}: counts differ from the CPU's")
    n = c["n_ref"]
    row = {tuple(x): i for i, x in enumerate(p["ref_uv"][:n])}
    order = [row.get(tuple(x), -1) for x in c["ref_uv"][:n]]
    cur_same = ({tuple(x) for x in c.get("cur_uv", [])}
                == {tuple(x) for x in p.get("cur_uv", [])})
    check(sorted(order) == list(range(n)) and cur_same,
          f"{label}: keypoints differ from the CPU's")
    order = np.array(order)
    st_c, st_p = c["status"][:n], p["status"][order]
    bad = statuses_agree(label, st_c, st_p)
    both = (st_c == 1) & (st_p == 1)
    check(np.array_equal(c["matched_uv"][:n][both],
                         p["matched_uv"][order][both]),
          f"{label}: matched positions differ from the CPU's")
    moved = int((order != np.arange(n)).sum())
    return (f"{c['tracked']}/{n} matched (CPU {p['tracked']}); {moved} "
            f"keypoints in another order, {bad} statuses differ")


def hold_slam(c, p, disparity, baseline, synthetic):
    import dataclasses as dc

    from feature_tracker_tpu_torch.demos import slam_demo

    bad = 0
    for g, w in zip(c["results"], p["results"]):
        check(g.num_live == w.num_live
              and np.array_equal(g.track_ids, w.track_ids),
              f"slam_demo frame {g.frame_id}: live tracks or ids differ")
        bad = max(bad, statuses_agree(f"slam_demo frame {g.frame_id}",
                                      g.status, w.status))
        tracked_uv_err(f"slam_demo frame {g.frame_id}", g.uv, g.status,
                       w.uv, w.status, UV_TOL)
    check((c["landmarks"], c["n_obs"]) == (p["landmarks"], p["n_obs"]),
          "slam_demo: the window differs from the CPU's")
    # The CPU's own spread: its window with every observation one ulp on.
    nudged = [dc.replace(r, uv=np.nextafter(r.uv, np.float32(np.inf)))
              for r in p["results"]]
    window = slam_demo.landmark_window(nudged, disparity, "cpu")[0]
    spread = float(np.abs(np.asarray(window.optimize()) / p["rms"]
                          - 1).max())
    ba_agree("slam_demo window BA card vs CPU", [*c["window"], c["rms"]],
             [*p["window"], p["rms"]], BA_RMS_CPU, spread)
    derr = float(np.abs(c["cam_direct"] - p["cam_direct"]).max())
    truth = np.array([[-2 * k * baseline / 64.0, 0, 0]
                      for k in range(len(c["cam_direct"]))])
    terr = float(np.abs(c["cam_direct"] - truth).max())
    berr = float(np.abs(c["cam_ba"] - truth).max())
    check(derr <= DIRECT_POSE_TOL and (not synthetic or (
        terr <= DIRECT_POSE_TOL and berr <= SLAM_POS_TOL)),
          f"slam_demo: direct {derr} from the CPU and {terr} from the "
          f"truth, BA {berr} from the truth")
    return (f"{bad} statuses differ at most per frame; {c['landmarks']} "
            f"landmarks, {c['n_obs']} observations, rms "
            f"{c['rms'][0]:.4f} -> {c['rms'][-1]:.6f} px; camera positions: "
            f"direct {derr:.3g} from the CPU and {terr:.3g} from the true "
            f"translation, BA {berr:.3g} m from it; optimize() "
            f"{c['optimize_ms']:.1f} ms")


def hold_cotracker(c, p, video, clip, dev):
    from feature_tracker_tpu_torch.demos import cotracker_demo
    from feature_tracker_tpu_torch.models.cotracker import CoTracker
    from feature_tracker_tpu_torch.utils.weights import (
        load_cotracker_npz,
        shipped_cotracker_config,
        weights_path,
    )

    check(np.array_equal(c["uv0"], p["uv0"]),
          "cotracker_demo: queries differ from the CPU's")
    cfg = shipped_cotracker_config()
    model = CoTracker(cfg, device=dev)
    model.load_state_dict(load_cotracker_npz(weights_path("cotracker.npz"),
                                             cfg))
    crop = cotracker_demo.CROP
    small = video.reshape(-1, crop // 2, 2, crop // 2, 2).mean((2, 4))
    parts = []
    for label, vid, q, got, want in (
            ("crop", small[..., None], c["uv0"] * 0.5,
             (c["tracks"] / 2.0, c["vis"]), (p["tracks"] / 2.0, p["vis"])),
            ("synthetic", clip[0], clip[1],
             (c["synthetic"]["tracks"], c["synthetic"]["vis"]),
             (p["synthetic"]["tracks"], p["synthetic"]["vis"]))):
        vid = torch.as_tensor(np.asarray(vid, np.float32), device=dev)
        q = torch.as_tensor(np.asarray(q, np.float32), device=dev)
        t1, v1 = model(vid, q)
        t2, v2 = model(torch.nextafter(vid, torch.full_like(vid, np.inf)), q)
        spread = (float((t1 - t2).abs().max()), float((v1 - v2).abs().max()))
        whole = (float(np.abs(got[0] - want[0]).max()),
                 float(np.abs(got[1] - want[1]).max()))
        check(whole[0] <= max(COT_TRACK_TOL, 2 * spread[0])
              and whole[1] <= max(COT_VIS_TOL, 2 * spread[1]),
              f"cotracker_demo {label}: {whole} from the CPU, the card's "
              f"own spread {spread}")
        parts.append(f"{label} {whole[0]:.3g} px / {whole[1]:.3g} from the "
                     f"CPU (card's one-ulp spread {spread[0]:.3g} / "
                     f"{spread[1]:.3g})")
    bad = statuses_agree("cotracker_demo KLT chain", c["klt_status"],
                         p["klt_status"])
    err = tracked_uv_err("cotracker_demo KLT chain", c["klt_tracks"][-1],
                         c["klt_status"], p["klt_tracks"][-1],
                         p["klt_status"], UV_TOL)
    parts.append(f"KLT chain {bad} statuses and {err:.3g} px from the CPU; "
                 f"synthetic EPE {c['synthetic']['epe']:.4f} px (zero motion "
                 f"{c['synthetic']['zero_epe']:.4f})")
    return "; ".join(parts)


def demo_paths(dev, card):
    """Phase 11: every port demo's ``run`` on the card at the demo's own
    size, its PNGs into a temporary directory, each held to the same
    ``run`` on the CPU (where a demo times ``iters`` steady-state calls,
    the CPU makes one: the results are the last call's either way), the
    launches of the KLT kernels counted against the ``track`` calls the
    demo made, and ``demos/output/`` and ``weights/`` hashed before and
    after. Returns the launches of each kernel over the demos."""
    import importlib
    import tempfile

    from feature_tracker_tpu_torch.demos import (
        _common,
        cotracker_demo,
        direct_method_demo,
        raft_demo,
    )
    from feature_tracker_tpu_torch.ops import (
        cuda_klt,
        cuda_raft_lookup,
        cuda_warp_klt,
    )

    t_phase = time.perf_counter()
    baseline = direct_method_demo.BASELINE
    before = tree_digest("demos", "weights")
    counters = {"klt_fast_pyramid": cuda_klt.track_pyramid_fast_cuda,
                "klt_iter_pyramid": cuda_klt.track_pyramid_iter_cuda,
                "klt_affine_pyramid": cuda_warp_klt.affine_track_pyramid_cuda,
                "klt_lssd_pyramid": cuda_warp_klt.lssd_track_pyramid_cuda,
                "raft_lookup": cuda_raft_lookup.lookup_correlation_cuda}
    ref, cur, source = _common.load_optical_flow_pair()
    left, disp, curs, source2 = _common.load_direct_method_set()
    video = cotracker_demo.load_video(left, curs)
    clip = cotracker_demo.synthetic_clip()
    inputs = {"raft_demo": raft_demo.inputs(),
              "track_demo": (ref, cur, source),
              "dense_flow_demo": (ref, cur, source),
              "direct_method_demo": (left, disp, curs, source2),
              "match_brief_demo": (ref, cur, source),
              "match_superpoint_demo": (ref, cur, source),
              "match_disk_demo": (ref, cur, source),
              "nn_matcher_demo": (ref, cur, source),
              "stream_demo": (left, curs, source2),
              "slam_demo": (left, disp, curs, source2),
              "cotracker_demo": (video, clip, source2)}
    fast_only = ("stream_demo", "slam_demo", "cotracker_demo")
    # The synthetic sets' truth is held too, where the demos run on them.
    synthetic = source == source2 == "synthetic"
    totals = dict.fromkeys(counters, 0)
    print(f"[demo] inputs: {source} 752x480 pair, {source2} "
          f"{left.shape[1]}x{left.shape[0]} set; card {card}")
    with tempfile.TemporaryDirectory() as tmp:
        for demo in DEMOS:
            module = importlib.import_module(
                f"feature_tracker_tpu_torch.demos.{demo}")
            args = inputs[demo]
            out_dir = os.path.join(tmp, demo)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c = module.run(*args, device=dev, out_dir=out_dir)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: fn.launches for k, fn in counters.items()}
            t0 = time.perf_counter()
            kw = {"iters": 1} if demo in ("raft_demo", "track_demo",
                                          "dense_flow_demo") else {}
            p = module.run(*args, device="cpu", **kw)
            cpu_s = time.perf_counter() - t0

            calls = c.get("track_calls", 0)
            want = dict.fromkeys(counters, 0)
            if demo == "track_demo":
                for k in ("klt_fast_pyramid", "klt_affine_pyramid",
                          "klt_lssd_pyramid"):
                    want[k] = calls
            elif demo in fast_only:
                want["klt_fast_pyramid"] = calls
            check(launches == want, f"{demo}: launches {launches}, "
                  f"expected {want} for {calls} track calls")
            for k, n in launches.items():
                totals[k] += n
            pngs = c.get("png", {})
            written = sorted(os.listdir(out_dir)) if pngs else []
            check(written == sorted(pngs),
                  f"{demo}: wrote {written}, returned {sorted(pngs)}")

            if demo == "raft_demo":
                flow_err = float(np.abs(c["flow"] - p["flow"]).max())
                check(c["shapes"] == p["shapes"] == [(5, 64, 64, 2)] * 5
                      and flow_err <= RAFT_CPU_TOL
                      and abs(c["epe"] - p["epe"]) <= 1e-4,
                      f"raft_demo: shapes {c['shapes']}, flow {flow_err} "
                      f"px and EPE {c['epe']} vs {p['epe']}")
                note = (f"shapes {c['shapes'][0]} x {len(c['shapes'])}; "
                        f"EPE {c['epe']:.6f} px (CPU {p['epe']:.6f}, zero "
                        f"flow {c['zero_epe']:.4f}), flow {flow_err:.3g} px "
                        f"from the CPU; {c['ms']:.4f} ms/call steady state")
            elif demo == "track_demo":
                note = hold_track(c, p, synthetic)
            elif demo == "dense_flow_demo":
                note = hold_dense(c, p, synthetic)
            elif demo == "direct_method_demo":
                note = hold_direct(c, p, baseline, synthetic)
            elif demo == "match_brief_demo":
                note = hold_equal(demo, c, p, (
                    "ref_uv", "cur_uv", "ref_bits", "cur_bits", "idx",
                    "matched_uv", "status"))
            elif demo in ("match_superpoint_demo", "match_disk_demo"):
                note = hold_matches(demo, c, p)
            elif demo == "nn_matcher_demo":
                note = "; ".join(
                    f"{key}: " + hold_matches(f"{demo} {key}", c[key],
                                              p[key])
                    for key in ("superpoint", "disk"))
            elif demo == "stream_demo":
                replay = stream_replay(left, curs, c["frames"], "cpu")
                bad = 0
                for k, (uv, st) in enumerate(replay):
                    bad = max(bad, statuses_agree(
                        f"stream_demo frame {k + 1}", c["status"][k], st))
                    tracked_uv_err(f"stream_demo frame {k + 1}",
                                   c["uv"][k], c["status"][k], uv, st,
                                   UV_TOL)
                note = (f"frames {c['frames']} through the ring "
                        f"({c['dropped']} dropped), tracked {c['tracked']}, "
                        f"{bad} statuses differ at most per frame from the "
                        f"CPU on the same frames; ms per frame "
                        f"{[round(x, 3) for x in c['ms']]}")
            elif demo == "slam_demo":
                note = hold_slam(c, p, disp, baseline, synthetic)
            else:
                note = hold_cotracker(c, p, video, clip, dev)
            share = overlays_agree(demo, pngs, p.get("png", {}),
                                   exact=demo == "match_brief_demo")
            print(f"[demo] {demo}: {wall_ms:.1f} ms wall on the card "
                  f"(first run in this process), CPU run {cpu_s:.1f} s; "
                  f"launches {dict((k, n) for k, n in launches.items() if n)}"
                  f" for {calls} track calls; PNGs {sorted(pngs)} differ "
                  f"from the CPU's in {share:.3g} of their pixels; {note}; "
                  f"card {card}")
    after = tree_digest("demos", "weights")
    check(after == before, "phase 11 changed files under demos/ or weights/: "
          f"{sorted(set(after.items()) ^ set(before.items()))}")
    stage_done("11 (demos)", t_phase)
    return totals


# -------------------------------------------------------------- phase 12
# The port's timing and evaluation scripts (feature_tracker_tpu_torch/
# scripts/) at the JAX scripts' own sizes. Float32 EPEs on the card are
# held to the CPU's within SCRIPT_EPE_TOL (TF32 off in Raft.forward); the
# bfloat16 EPE to the float32 one within SCRIPT_BF16_EPE (JAX's own gap on
# the CPU is 0.0054 px on one batch of these pairs). The lookup loop of ``split`` on the kernel is held to the same loop
# on the plain lookup within SPLIT_LOCS_RTOL (the carry adds 1e-6 * the
# mean correlation, which the two lookups give to ~1e-6 relative).
# klt_multipair: the composite tracks a feature exactly as its pair alone
# where it lies at least ``parity_margin`` rows inside its crop; there
# statuses must be equal and uv within the solver's stop step
# (DEMO_FLOW_TOL, 0.2 px: the band offset rounds the rows by up to an ulp).
SCRIPT_EPE_TOL, SCRIPT_BF16_EPE = 1e-3, 0.05
SPLIT_LOCS_RTOL = 1e-6
MULTIPAIR_KS = (1, 2, 4)


def script_paths(dev, card):
    """Phase 12: every mode of the port's scripts on the card at the JAX
    scripts' sizes, each held to the CPU or to the kernel's plain version,
    the launches of kernels 1, 2 and 5 counted per call, and ``weights/``
    hashed before and after. Returns each kernel's launches over the
    phase's script calls (the comparisons' own launches not counted)."""
    from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
    from feature_tracker_tpu_torch.models.layers import flax_init_
    from feature_tracker_tpu_torch.models.raft import (
        Raft,
        RaftConfig,
        UpdateBlock,
        lookup_correlation_otf,
    )
    from feature_tracker_tpu_torch.ops import cuda_klt, cuda_raft_lookup
    from feature_tracker_tpu_torch.scripts import (
        klt_multipair,
        raft_bf16_eval,
        time_klt_modes,
    )
    from feature_tracker_tpu_torch.trackers.klt import basic

    t_phase = time.perf_counter()
    before = tree_digest("weights")
    counters = {"klt_fast_pyramid": cuda_klt.track_pyramid_fast_cuda,
                "klt_iter_pyramid": cuda_klt.track_pyramid_iter_cuda,
                "raft_lookup": cuda_raft_lookup.lookup_correlation_cuda}
    totals = dict.fromkeys(counters, 0)

    def counted(fn, *args, **kw):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for k, c in counters.items():
            totals[k] += c.launches
        return out

    # 12a. accuracy and anytime: the all-pairs route, no kernel.
    acc = counted(raft_bf16_eval.accuracy, device=dev)
    acc_cpu = raft_bf16_eval.accuracy(device="cpu")
    key = "raft_accuracy_64x64_compact_6it"
    a, p = acc[key], acc_cpu[key]
    check(abs(a["f32"]["epe"] - p["f32"]["epe"]) <= SCRIPT_EPE_TOL
          and abs(a["bf16"]["epe"] - a["f32"]["epe"]) <= SCRIPT_BF16_EPE,
          f"accuracy: card {a}, CPU {p}")
    anyt = counted(raft_bf16_eval.anytime, device=dev)["raft_anytime"]
    anyt_cpu = raft_bf16_eval.anytime(device="cpu")["raft_anytime"]
    check(all(abs(anyt[k] - anyt_cpu[k]) <= SCRIPT_EPE_TOL
              for k in ("epe_k6", "epe_k12", "zero_flow_epe")),
          f"anytime: card {anyt}, CPU {anyt_cpu}")
    check(totals["raft_lookup"] == 0, "accuracy / anytime launched the "
          "lookup kernel: they take the all-pairs route")
    print(f"[script] accuracy 16 pairs 64x64: f32 EPE {a['f32']['epe']} "
          f"(CPU {p['f32']['epe']}), bf16 {a['bf16']['epe']} (CPU "
          f"{p['bf16']['epe']}), epe_delta_bf16_minus_f32 "
          f"{a['epe_delta_bf16_minus_f32']} (CPU "
          f"{p['epe_delta_bf16_minus_f32']}); anytime epe_k6 "
          f"{anyt['epe_k6']} / epe_k12 {anyt['epe_k12']} (CPU "
          f"{anyt_cpu['epe_k6']} / {anyt_cpu['epe_k12']}), zero flow "
          f"{anyt['zero_flow_epe']}; card {card}")

    # 12b. speed and speed_sidecar at 1x440x1024.
    speed = counted(raft_bf16_eval.speed, device=dev)
    sp = speed["raft_speed_1024x440"]
    for name in ("f32", "bf16", "bf16_last_up"):
        check(sp[name]["lookup_launches_per_call"] == {"1it": 1, "12it": 12},
              f"speed {name}: lookup launches per call "
              f"{sp[name]['lookup_launches_per_call']}, expected 1 / 12")
        print(f"[script] speed {name} 1x440x1024: {sp[name]['ms_12it']} ms "
              f"at 12 iterations ({sp[name]['fps_12it']} fps), "
              f"{sp[name]['per_iteration_ms']} ms per iteration, "
              f"encoders + set-up {sp[name]['encoders_plus_init_ms']} ms; "
              f"card {card}")
    print(f"[script] speed speedup_bf16 {sp['speedup_bf16']} (f32 / bf16 at "
          f"12 iterations); card {card}")
    side = counted(raft_bf16_eval.speed_sidecar, device=dev)["raft_speed"]
    for key, n_it in (("shipped_k12", 12), ("shipped_k6", 6),
                      ("parity_f32_k12", 12)):
        check(side[key]["lookup_launches_per_call"] == n_it,
              f"speed_sidecar {key}: {side[key]['lookup_launches_per_call']}"
              f" lookup launches per call, expected {n_it}")
        print(f"[script] speed_sidecar {key} 1x440x1024: {side[key]['ms']} "
              f"ms ({side[key]['fps']} fps); card {card}")

    # 12c. split at 55x128: the lookup loop against the same loop on the
    # plain lookup, on the card.
    split = counted(raft_bf16_eval.split, device=dev)["raft_iteration_split"]
    check(split["lookup_launches_per_loop"] == split["iterations"] == 12,
          f"split: {split['lookup_launches_per_loop']} lookup launches per "
          "loop of 12")
    cfg = RaftConfig(low_memory=True, dtype=torch.bfloat16,
                     upsample_last_only=True)
    x = raft_bf16_eval.split_inputs(55, 128, cfg, dev)
    loop = functools.partial(raft_bf16_eval.lookup_loop, x["fmap0"],
                             x["fpyr"], x["ref_locs"],
                             cfg.correlation_radius, 12)
    kernel_locs, plain_locs = loop(), loop(lookup=lookup_correlation_otf)
    locs_err = float(((kernel_locs - plain_locs).abs()
                      / (1 + plain_locs.abs())).max())
    plain_sum = float(plain_locs.sum())
    check(locs_err <= SPLIT_LOCS_RTOL and abs(
        split["lookup_checksum"] - plain_sum) <= SPLIT_LOCS_RTOL * abs(
            plain_sum), f"split: the kernel's loop {locs_err} from the plain "
          f"loop's locations, checksum {split['lookup_checksum']} against "
          f"{plain_sum}")
    # Where an iteration's time goes: the update loop alone and the whole
    # shipped call, by device busy time against wall time.
    update = flax_init_(UpdateBlock(cfg).to(dev).to(
        memory_format=torch.channels_last).eval(), 0)
    profile_window("split's update loop (12 steps, 55x128, bf16)",
                   lambda: raft_bf16_eval.update_loop(
                       update, x["net0"], x["inp"], x["corr0"], x["flow0"],
                       12), calls=3)
    shipped = flax_init_(Raft(dataclasses.replace(cfg, max_iterations=12),
                              device=dev), 0)
    images = raft_bf16_eval._images(440, 1024, dev)
    profile_window("shipped RAFT call (bf16, upsample_last_only, 12 "
                   "iterations, 1x440x1024)", lambda: shipped(*images),
                   calls=3)
    print(f"[script] split 55x128 bf16: lookup "
          f"{split['lookup_ms_per_iteration']} ms, update block "
          f"{split['update_block_ms_per_iteration']} ms, sum "
          f"{split['sum_ms_per_iteration']} ms per iteration; the whole "
          f"call (bf16_last_up, 440x1024) "
          f"{split['whole_call_per_iteration_ms']} ms per iteration; lookup "
          f"loop {locs_err:.3g} from the plain loop (checksum "
          f"{split['lookup_checksum']} / {plain_sum}); card {card}")

    # 12d. time_klt_modes at N=10240: tracked against the plain path on the
    # card, one launch per call.
    for mode, method in (("fast", KltMethod.FAST),
                         ("direct", KltMethod.DIRECT),
                         ("inverse", KltMethod.INVERSE)):
        r = counted(time_klt_modes.run, mode, device=dev)
        rp, cp, uv, source = time_klt_modes.klt_inputs(N, device=dev)
        opts = KltOptions(max_track_points=N, method=method)
        skip = torch.zeros(N, dtype=torch.bool, device=dev)
        if method == KltMethod.FAST:
            _, st = basic.track_pyramid_fast_reference(opts, rp, cp, uv, uv,
                                                       skip)
        else:
            _, st = basic.track_pyramid_iter_reference(
                opts, rp, cp, uv, uv,
                torch.zeros(N, dtype=torch.int8, device=dev), skip)
        plain = int((st == 1).sum())
        check(r["launches_per_call"] == 1 and abs(r["tracked"] - plain)
              <= max(1, int(KLT_STATUS_SHARE * N)),
              f"time_klt_modes {mode}: {r['launches_per_call']} launches, "
              f"tracked {r['tracked']} against the plain path's {plain}")
        print(f"[script] time_klt_modes {mode} N={N} ({source} pair): "
              f"{r['ms']:.4f} ms per call by events, tracked {r['tracked']} "
              f"(plain {plain}), {r['launches_per_call']} launch per call; "
              f"card {card}")

    # 12e. klt_multipair at its defaults, K = 1, 2, 4.
    for k in MULTIPAIR_KS:
        r = counted(klt_multipair.run, k, device=dev)
        n_all = k * r["n_per_pair"]
        check(r["composite_launches"] == 1
              and r["sequential_launches"] == k,
              f"klt_multipair K={k}: {r['composite_launches']} / "
              f"{r['sequential_launches']} launches, expected 1 / {k}")
        check(r["status_mismatch_composite_vs_sequential_interior"] == 0
              and r["max_pos_diff_composite_vs_sequential_interior_px"]
              <= DEMO_FLOW_TOL,
              f"klt_multipair K={k}: composite against sequential {r}")
        check(0 <= r["status_mismatch_vs_cpu"]
              <= max(1, int(KLT_STATUS_SHARE * n_all)),
              f"klt_multipair K={k}: {r['status_mismatch_vs_cpu']} statuses "
              "against the native CPU port (-1: it could not be built)")
        # Device time: a call launches only the kernel (K for sequential),
        # timed with the host's enqueue hidden behind a stream sleep.
        prob = klt_multipair.composite_problem(k, 320, 512, r["n_per_pair"],
                                               dev)
        comp_dev, seq_dev = (queued_ms(prob[case])
                             for case in ("composite", "sequential"))
        print(f"[script] klt_multipair K={k} 512x320 N={r['n_per_pair']} "
              f"per pair ({r['source']} crops): composite "
              f"{r['composite_ms']:.4f} ms per call by events, "
              f"{comp_dev:.4f} ms device time (queued behind a sleep); "
              f"sequential {r['sequential_ms']:.4f} ms by events, "
              f"{seq_dev:.4f} ms device time for its {k} launches; "
              f"launch_amortization {r['launch_amortization']:.4f} by "
              f"events, {seq_dev / comp_dev:.4f} by device time; tracked "
              f"{r['tracked_composite']}; statuses against sequential "
              f"{r['status_mismatch_composite_vs_sequential']} (all) / "
              f"{r['status_mismatch_composite_vs_sequential_interior']} "
              f"(>= {r['interior_margin_px']} rows inside), uv "
              f"{r['max_pos_diff_composite_vs_sequential_interior_px']:.3g} "
              f"px; against the CPU port {r['status_mismatch_vs_cpu']} "
              f"statuses, cpu_ms {r['cpu_ms']:.3f}, vs_cpu_composite "
              f"{r['vs_cpu_composite']:.2f}; card {card}")

    after = tree_digest("weights")
    check(after == before, "phase 12 changed files under weights/: "
          f"{sorted(set(after.items()) ^ set(before.items()))}")
    print(f"[script] launches over the phase's script calls: {totals}")
    stage_done("12 (scripts)", t_phase)
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from synthetic import Texture, se2_pair, translated_pair

    from feature_tracker_tpu_torch.core.config import KltMethod, KltOptions
    from feature_tracker_tpu_torch.ops import (
        _build,
        cuda_detect,
        cuda_klt,
        cuda_raft_lookup,
        cuda_warp_klt,
    )
    from feature_tracker_tpu_torch.ops.detect import detect_good_features
    from feature_tracker_tpu_torch.ops.pyramid import build_pyramid
    from feature_tracker_tpu_torch.pipeline import (
        FrontEndConfig,
        TrackingFrontEnd,
    )
    from feature_tracker_tpu_torch.trackers.klt import (
        AffineKlt,
        BasicKlt,
        LssdKlt,
    )
    from feature_tracker_tpu_torch.trackers.klt.affine import (
        affine_track_level_reference,
        affine_track_pyramid_reference,
    )
    from feature_tracker_tpu_torch.trackers.klt.basic import (
        track_pyramid_fast_reference,
        track_pyramid_iter_reference,
    )
    from feature_tracker_tpu_torch.trackers.klt.lssd import (
        lssd_track_level_reference,
        lssd_track_pyramid_reference,
    )

    weights_before = tree_digest("weights")
    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the plain versions need full float32 matrix products")

    # 1. Build every kernel of the paths from this checkout's sources, one
    # nvcc per source, all started together.
    t0 = time.perf_counter()
    kernels = [cuda_klt.FAST, cuda_klt.ITER, cuda_warp_klt.AFFINE,
               cuda_warp_klt.LSSD, cuda_raft_lookup.LOOKUP]
    libraries = [k.library for k in kernels] + [cuda_detect.SUPPRESS.library]
    # And the redesigned kernels once more with phase clocks compiled in,
    # for the profiles printed with their timings.
    profiled = [k.phase_clock_spec() for k in kernels]
    lib_paths = _build.build_libraries(libraries + profiled)[:len(libraries)]
    for k in kernels + [cuda_detect.SUPPRESS]:
        k.load()
    print(f"[build] {len(lib_paths)} libraries (and {len(profiled)} with "
          "phase clocks) ready in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS[:2])}, --fmad=false but for "
          "raft_lookup, in parallel)")
    for lib_path in lib_paths:
        print(f"[build] {os.path.relpath(lib_path, ROOT)}")
        if os.path.exists(lib_path + ".log"):
            with open(lib_path + ".log") as fh:
                for line in fh.read().splitlines():
                    if "Compiling entry" in line:
                        # The kernel's name inside the mangled one.
                        found = re.findall(
                            r"\d((?:klt|raft|detect)_[a-z_]+_kernel"
                            r"(?:ILi\d+ELi\d+E)?)", line)
                        print("[build]   kernel "
                              f"{found[-1] if found else line}")
                    elif "Used" in line or "spill" in line:
                        print(f"[build]   {line.strip()}")

    # 2. Kernels against their plain versions. First the FAST kernel: at
    # the headline shape, at the front end's shape, and on two small cases.
    ref, cur = translated_pair(h=H, w=W, shift=PAIR_SHIFT)
    rp = build_pyramid(ref, LEVELS, device=dev)
    cp = build_pyramid(cur, LEVELS, device=dev)
    uv = torch.from_numpy(uniform_features(N, H, W, 20)).to(dev)
    no_skip = torch.zeros(N, dtype=torch.bool, device=dev)
    fresh = torch.zeros(N, dtype=torch.int8, device=dev)
    opts = KltOptions(max_track_points=N)
    err, steps = compare_klt("headline 752x480 L=4 N=10240", opts, rp, cp,
                             uv, no_skip)
    cfg = FrontEndConfig()
    fe_uv = uv[:cfg.capacity].contiguous()
    fe_skip = no_skip[:cfg.capacity].contiguous()
    errs = [err, compare_klt(f"front end's shape N={cfg.capacity}", cfg.klt,
                             rp, cp, fe_uv, fe_skip)[0]]

    bref, bcur = translated_pair(h=64, w=96, shift=(1.0, 1.0))
    brp = build_pyramid(bref, 2, device=dev)
    bcp = build_pyramid(bcur, 2, device=dev)
    buv = np.concatenate([uniform_features(48, 64, 96, 1.0, seed=3),
                          [[-30.0, -30.0], [200.0, 20.0], [48.0, 32.0]]])
    buv = torch.from_numpy(buv.astype(np.float32)).to(dev)
    bskip = torch.zeros(len(buv), dtype=torch.bool, device=dev)
    bskip[5] = True
    errs.append(compare_klt("border + off-image 96x64 L=2", KltOptions(),
                            brp, bcp, buv, bskip)[0])
    wide = KltOptions(max_track_points=N, patch_row_half_size=15)
    errs.append(compare_klt("patch_row_half_size=15 (31x13 patch)", wide,
                            rp, cp, uv[:2048].contiguous(),
                            no_skip[:2048].contiguous())[0])

    # The DIRECT / INVERSE kernel, both modes: headline and border case
    # (with incoming TRACKED and failed statuses; lane 5 skipped).
    bstatus = torch.zeros(len(buv), dtype=torch.int8, device=dev)
    bstatus[::3] = 1
    bstatus[5] = 4
    iter_errs, iter_steps, iter_opts = [], {}, {}
    for method in (KltMethod.INVERSE, KltMethod.DIRECT):
        mopts = KltOptions(max_track_points=N, method=method)
        iter_opts[method] = mopts
        e, iter_steps[method] = compare_klt(
            f"iter {method.value} headline 752x480 L=4 N=10240", mopts, rp,
            cp, uv, no_skip, fresh)
        iter_errs += [e, compare_klt(
            f"iter {method.value} border + off-image 96x64 L=2",
            KltOptions(method=method), brp, bcp, buv, bskip, bstatus)[0]]

    # The warp kernels through their trackers: translated pair, rotated
    # pair, and the border case with failed (skipped) lanes.
    sref, scur, s_rot, s_t = se2_pair(h=H, w=W, theta=0.03)
    srp = build_pyramid(sref, LEVELS, device=dev)
    scp = build_pyramid(scur, LEVELS, device=dev)
    true_uv = uv.cpu().numpy().astype(np.float64) @ s_rot.T + s_t
    warp_errs = {"affine": [], "lssd": []}
    warp_recs = {}
    trackers = {"affine": AffineKlt(opts), "lssd": LssdKlt(opts, False),
                "lssd luminance": LssdKlt(opts, True)}
    for tname, tracker in trackers.items():
        kind = tname.split()[0]
        e, krec, prec, _, _ = compare_warp(
            f"{tname} headline 752x480 L=4 N=10240", tracker, rp, cp, uv)
        warp_recs[tname] = (krec, prec)
        e2, _, _, su, sst = compare_warp(
            f"{tname} rotated 0.03 rad 752x480 L=4 N=10240", tracker, srp,
            scp, uv)
        ok = sst.cpu().numpy() == 1
        miss = np.linalg.norm(su.cpu().numpy()[ok] - true_uv[ok], axis=1)
        print(f"[compare] {tname} rotated pair: tracked {int(ok.sum())} of "
              f"{N}, median |uv - (R p + t)| = {np.median(miss):.4f} px")
        # (The luminance means only approximately cancel, which biases
        # that tracker by a fraction of a pixel in the JAX package too.)
        check(ok.sum() > N // 2 and (tname != "lssd"
                                     or np.median(miss) <= 0.1),
              f"{tname}: rotated pair not tracked ({int(ok.sum())} tracked, "
              f"median error {np.median(miss)})")
        small = type(tracker)(KltOptions(max_track_points=len(buv) - 1),
                              device=dev)
        if kind == "lssd":
            small.consider_patch_luminance = tracker.consider_patch_luminance
        e3, _, _, bu, bst = compare_warp(
            f"{tname} border + off-image 96x64 L=2", small, brp, bcp, buv,
            bstatus)
        bst = bst.cpu().numpy()
        check(bst[5] == 4 and torch.equal(bu[5], buv[5]),
              f"{tname}: the skipped lane did not pass through")
        check(list(bst[-3:-1]) == [3, 3] and bst[-1] == bstatus[-1].item(),
              f"{tname}: off-image / capped lanes gave {bst[-3:]}")
        warp_errs[kind] += [e, e2, e3]

    # 3. The main paths: the front end on the card. Fewer, shorter waves
    # than the default texture give the corner density of real imagery
    # (~100 Shi-Tomasi corners per 376x240 at the default thresholds).
    tex = Texture(0, n_waves=16, min_period=5.0, max_period=30.0)

    def render(t):
        return tex.render(H, W, warp=lambda x, y: (
            x - t * FRAME_SHIFT[0], y - t * FRAME_SHIFT[1]))

    frames = [render(t) for t in range(FRAMES)]
    fe = TrackingFrontEnd(cfg, device="cuda")
    cuda_detect.suppress_candidates_cuda.launches = 0
    launches, results, frame_s = drive_front_end(
        "basic FAST", fe, frames, cuda_klt.track_pyramid_fast_cuda, 1,
        cfg.min_live_tracks, FRAME_SHIFT)
    detect_launches = cuda_detect.suppress_candidates_cuda.launches
    replenished = replenished_frames(results, cfg.min_live_tracks)
    check(detect_launches == replenished,
          f"basic FAST: {detect_launches} launches of kernel 6 over "
          f"{replenished} replenishing frames, expected one each")
    print(f"[front end] basic FAST: {replenished} of {len(frames)} frames "
          f"replenished, kernel 6 launches={detect_launches}")
    path_launches = {}
    for label, tracker, wrapper, per_frame in (
            ("basic INVERSE",
             BasicKlt(KltOptions(max_track_points=cfg.capacity,
                                 method=KltMethod.INVERSE)),
             cuda_klt.track_pyramid_iter_cuda, 1),
            ("affine", AffineKlt(cfg.klt),
             cuda_warp_klt.affine_track_pyramid_cuda, 1),
            ("lssd", LssdKlt(cfg.klt, False),
             cuda_warp_klt.lssd_track_pyramid_cuda, 1)):
        path_launches[label], _, path_s = drive_front_end(
            label, TrackingFrontEnd(cfg, tracker=tracker, device="cuda"),
            frames[:WARP_FRAMES], wrapper, per_frame, cfg.min_live_tracks,
            FRAME_SHIFT)
        print(f"[time] front end with {label} per tracked frame (host clock, "
              f"median of {len(path_s[2:])}): "
              f"{float(np.median(path_s[2:])) * 1e3:.4f} ms")

    # 4. Timings (the launches here are not the main paths').
    clock_line("before the KLT timings")
    kernel_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        opts, rp, cp, uv, uv, no_skip), batch=10)
    call_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        opts, rp, cp, uv, uv, no_skip))
    plain_ms = cuda_ms(lambda: track_pyramid_fast_reference(
        opts, rp, cp, uv, uv, no_skip), repeats=20, warmup=2)
    ref_t = torch.from_numpy(ref).to(dev)
    pyr_ms = cuda_ms(lambda: build_pyramid(ref_t, LEVELS, device=dev))
    det_ms = cuda_ms(lambda: detect_good_features(ref_t, cfg.capacity,
                                                  cfg.harris, device=dev))
    fe_kernel_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        cfg.klt, rp, cp, fe_uv, fe_uv, fe_skip), batch=10)
    fe_call_ms = cuda_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        cfg.klt, rp, cp, fe_uv, fe_uv, fe_skip))
    frame_ms = float(np.median(frame_s[2:])) * 1e3
    pyr_shapes = [tuple(l.shape) for l in rp]
    nbytes, flops = klt_work(opts, pyr_shapes, N, N, int(steps.sum()))
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[time] klt kernel 752x480 L=4 N=10240: {kernel_ms:.4f} ms "
          f"per launch back to back, {call_ms:.4f} ms per lone call; bound "
          f"{bound_ms:.4f} ms by "
          f"{bound_by} ({nbytes} B, {flops} FLOP, {int(steps.sum())} GN "
          "steps)")
    print(f"[time] klt kernel at the front end's shape (N={cfg.capacity}): "
          f"{fe_kernel_ms:.4f} ms per launch back to back, "
          f"{fe_call_ms:.4f} ms per lone call")
    dev_ms = device_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        opts, rp, cp, uv, uv, no_skip), "klt_fast_pyramid_kernel", kernel_ms)
    fe_dev_ms = device_ms(lambda: cuda_klt.track_pyramid_fast_cuda(
        cfg.klt, rp, cp, fe_uv, fe_uv, fe_skip), "klt_fast_pyramid_kernel",
        fe_kernel_ms)
    print(f"[time] klt kernel device time per launch (profiler): "
          f"{dev_ms:.4f} ms at N={N}, {fe_dev_ms:.4f} ms at "
          f"N={cfg.capacity}; {N / dev_ms * 1e3:.4g} features/s at N={N}")
    occ = cuda_klt.fast_occupancy(opts)
    print(f"[time] klt kernel: {occ['registers']} registers, "
          f"{occ['warps_per_block']} warps a block, {occ['blocks_per_sm']} "
          f"blocks = {occ['warps_per_sm']} warps resident per SM")
    print_phases("klt fast kernel, headline pair",
                 cuda_klt.fast_phase_clocks(opts, rp, cp, uv, uv, no_skip), N,
                 "feature")
    print_phases(f"klt fast kernel, front end's shape N={cfg.capacity}",
                 cuda_klt.fast_phase_clocks(cfg.klt, rp, cp, fe_uv, fe_uv,
                                            fe_skip), cfg.capacity, "feature")
    print(f"[time] klt plain PyTorch version on the card: {plain_ms:.4f} ms")
    print(f"[time] build_pyramid 752x480 L=4: {pyr_ms:.4f} ms")
    print(f"[time] detect_good_features 752x480 max_num=300: {det_ms:.4f} ms")
    print(f"[time] front end per tracked frame (host clock, median of "
          f"{len(frame_s[2:])}): {frame_ms:.4f} ms")
    kernels = [{
        "name": "klt_fast_pyramid",
        "route": "cuda",
        "source": "feature_tracker_tpu_torch/csrc/klt_fast.cu",
        "replaces": "feature_tracker_tpu/ops/pallas_klt.py:1016",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": dev_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]

    # The DIRECT / INVERSE kernel: both modes are timed; the kernels line
    # carries INVERSE, the mode the front-end path above ran.
    for method in (KltMethod.INVERSE, KltMethod.DIRECT):
        mopts = iter_opts[method]
        m_ms = cuda_ms(lambda: cuda_klt.track_pyramid_iter_cuda(
            mopts, rp, cp, uv, uv, fresh, no_skip), batch=10)
        m_call = cuda_ms(lambda: cuda_klt.track_pyramid_iter_cuda(
            mopts, rp, cp, uv, uv, fresh, no_skip))
        m_dev = device_ms(lambda: cuda_klt.track_pyramid_iter_cuda(
            mopts, rp, cp, uv, uv, fresh, no_skip), "klt_iter_pyramid_kernel",
            m_ms)
        m_plain = cuda_ms(lambda: track_pyramid_iter_reference(
            mopts, rp, cp, uv, uv, fresh, no_skip), repeats=20, warmup=2)
        m_steps = int(iter_steps[method].sum())
        m_bytes, m_flops = klt_work(mopts, pyr_shapes, N, N, m_steps,
                                    mode=method.value)
        m_bound, m_by = bound(m_bytes, m_flops)
        print(f"[time] klt iter kernel {method.value} 752x480 L=4 N=10240: "
              f"{m_ms:.4f} ms per launch back to back, {m_call:.4f} ms per "
              f"lone call, {m_dev:.4f} ms device time per launch "
              f"(profiler); plain {m_plain:.4f} ms; bound {m_bound:.4f} ms by "
              f"{m_by} ({m_bytes} B, {m_flops} FLOP, {m_steps} GN steps)")
        occ = cuda_klt.iter_occupancy(mopts)
        print(f"[time] klt iter kernel: {occ['registers']} registers, "
              f"{occ['warps_per_block']} warps a block, "
              f"{occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} warps "
              "resident per SM")
        print_phases(f"klt iter kernel {method.value}, headline pair",
                     cuda_klt.iter_phase_clocks(mopts, rp, cp, uv, uv, fresh,
                                                no_skip), N, "feature")
        if method == KltMethod.INVERSE:
            kernels.append({
                "name": "klt_iter_pyramid",
                "route": "cuda",
                "source": "feature_tracker_tpu_torch/csrc/klt_iter.cu",
                "replaces": "feature_tracker_tpu/ops/pallas_klt.py:1327",
                "launches": path_launches["basic INVERSE"],
                "max_abs_err": max(iter_errs),
                "ms": m_dev, "plain_ms": m_plain, "bound_ms": m_bound,
                "bound_by": m_by, "library_ms": None,
            })

    # The warp kernels: each launches one kernel for the whole pyramid, and
    # its entry in the kernels line carries that launch, its bound the sum
    # over the levels, its plain time the plain level loop. Each level is
    # also timed through the one-level wrapper at the inputs the headline
    # track() gave it.
    eye = torch.eye(2, device=dev).expand(N, 2, 2).contiguous()
    for tname, tracker in trackers.items():
        kind = tname.split()[0]
        lum = kind == "lssd" and tracker.consider_patch_luminance
        krec, prec = warp_recs[tname]
        if kind == "affine":
            wrapper, plain_fn = (cuda_warp_klt.affine_track_level_cuda,
                                 affine_track_level_reference)
            pyramid = cuda_warp_klt.affine_track_pyramid_cuda
            plain_pyramid = affine_track_pyramid_reference
            p_args = (tracker.options, rp, cp, uv, uv, eye, no_skip)
            occ = cuda_warp_klt.affine_occupancy(tracker.options)
            phase_clocks = cuda_warp_klt.affine_phase_clocks
        else:
            wrapper, plain_fn = (cuda_warp_klt.lssd_track_level_cuda,
                                 lssd_track_level_reference)
            pyramid = cuda_warp_klt.lssd_track_pyramid_cuda
            plain_pyramid = lssd_track_pyramid_reference
            p_args = (tracker.options, lum, rp, cp, uv, uv, eye, no_skip)
            occ = cuda_warp_klt.lssd_occupancy(tracker.options, lum)
            phase_clocks = cuda_warp_klt.lssd_phase_clocks
        rows = []
        for depth, (klvl, plvl) in enumerate(zip(krec.levels, prec.levels)):
            lvl = LEVELS - 1 - depth
            args = klvl["args"]
            l_ms = cuda_ms(lambda: wrapper(tracker.options, *args), batch=10)
            l_plain = cuda_ms(lambda: plain_fn(tracker.options, *args),
                              repeats=10, warmup=1)
            l_steps = int(plvl["steps"].sum())
            l_bytes, l_flops = warp_level_work(
                kind, tracker.options, pyr_shapes[lvl], N, N, l_steps, lum)
            l_bound, l_by = bound(l_bytes, l_flops)
            rows.append((l_ms, l_plain, l_bytes, l_flops, l_steps))
            print(f"[time] {tname} kernel level {lvl} "
                  f"{pyr_shapes[lvl][1]}x{pyr_shapes[lvl][0]} N=10240 (one-"
                  f"level launch): {l_ms:.4f} ms per launch back to back; "
                  f"plain {l_plain:.4f} ms; bound {l_bound:.4f} ms by "
                  f"{l_by} ({l_bytes} B, {l_flops} FLOP, {l_steps} GN "
                  "steps)")
        track_ms = cuda_ms(lambda: tracker.track(rp, cp, uv))
        k_ms = cuda_ms(lambda: pyramid(*p_args), batch=10)
        k_dev = device_ms(lambda: pyramid(*p_args),
                          f"klt_{kind}_pyramid_kernel", k_ms)
        k_plain = cuda_ms(lambda: plain_pyramid(*p_args), repeats=10,
                          warmup=2)
        k_bound, k_by = bound(sum(r[2] for r in rows),
                              sum(r[3] for r in rows))
        print(f"[time] {tname} whole-pyramid kernel 752x480 L=4 N=10240: "
              f"{k_ms:.4f} ms per launch back to back, {k_dev:.4f} ms "
              f"device time per launch (profiler); plain level loop "
              f"{k_plain:.4f} ms; bound {k_bound:.4f} ms by {k_by} (sum "
              f"over the levels, {sum(r[4] for r in rows)} GN steps); "
              f"{occ['registers']} registers, {occ['warps_per_block']} "
              f"warps a block, {occ['blocks_per_sm']} blocks = "
              f"{occ['warps_per_sm']} warps resident per SM")
        print(f"[time] {tname} track() 752x480 L=4 N=10240 (one launch): "
              f"{track_ms:.4f} ms per lone call; the four levels launched "
              f"one by one {sum(r[0] for r in rows):.4f} ms")
        check(occ["warps_per_sm"] >= 16,
              f"{tname} kernel: {occ['warps_per_sm']} warps per SM")
        print_phases(f"{tname} whole-pyramid kernel, headline pair",
                     phase_clocks(*p_args), N, "feature")
        if tname in ("affine", "lssd"):   # the front-end paths above
            kernels.append({
                "name": f"klt_{kind}_pyramid",
                "route": "cuda",
                "source": f"feature_tracker_tpu_torch/csrc/klt_{kind}.cu",
                "replaces": "feature_tracker_tpu/ops/pallas_warp_klt.py:"
                            + ("728" if kind == "affine" else "761"),
                "launches": path_launches[kind],
                "max_abs_err": max(warp_errs[kind]),
                "ms": k_dev, "plain_ms": k_plain, "bound_ms": k_bound,
                "bound_by": k_by, "library_ms": None,
            })
    suppression = suppression_phase(dev, card, frames, detect_launches)
    kernels.append(suppression)
    clock_line("after the KLT timings")
    print(f"[time] card: {card}")

    profile_window("klt kernel 752x480 L=4 N=10240",
                   lambda: cuda_klt.track_pyramid_fast_cuda(
                       opts, rp, cp, uv, uv, no_skip), calls=5)
    profile_window("affine track() 752x480 L=4 N=10240",
                   lambda: trackers["affine"].track(rp, cp, uv), calls=5)
    profile_window("lssd luminance track() 752x480 L=4 N=10240",
                   lambda: trackers["lssd luminance"].track(rp, cp, uv),
                   calls=5)
    more = iter([render(t) for t in range(FRAMES, FRAMES + 10)])
    profile_window("front end per frame",
                   lambda: fe.process_frame(next(more)), calls=10)

    lookup = raft_phases(dev, card)
    lookup.update(cotracker2_phases(dev, card))
    kernels.append(lookup)
    slice_paths(dev, card, frames)
    suppression["superpoint_launches"] = model_paths(dev, card)
    sharded = parallel_paths(dev, card, rp, cp, uv, opts)
    train_paths(dev, card, weights_before)
    kernels[0]["pretrain_launches"] = pretrain_paths(dev, card,
                                                     weights_before)
    demo_launches = demo_paths(dev, card)
    for k in kernels:
        if demo_launches.get(k["name"]):
            k["demo_launches"] = demo_launches[k["name"]]
    script_launches = script_paths(dev, card)
    for k in kernels:
        if k["name"] in script_launches:
            k["scripts_launches"] = script_launches[k["name"]]
    for k in kernels:
        if k["name"] in sharded:
            k["sharded_launches"] = sharded[k["name"]]

    check(len(kernels) == 6 and all(k["launches"] > 0 for k in kernels),
          "a kernel of the paths was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
