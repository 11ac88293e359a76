#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (`pose_estimation_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the six CUDA kernels from `pose_estimation_tpu_torch/csrc/` and
checks each against its torch twin at the shapes the main paths give it,
timing each by CUDA events and by the profiler's device time: K1 (FAST
select) at EuRoC scale (752x480 stereo, 8 levels, 800 features) and on the
accuracy protocol's 320x240 stack, its bound counted over the planes'
content, K2 (descriptor sampler, one launch over every level of the pair)
there and at KITTI width, K3 (FAST score + NMS) at KITTI width (1242x375,
8 levels), K4 (circular moment maps) on both plane stacks, also against
the 31x31 convolution that computes the same maps and beside its own count
of shared-memory traffic, with the map front end's sparse and integral
angles held to the float64 ones, K5 (stream probe) over its sweep of
plane counts, heights and element types, and K6 (Jacobi eigh and 3x3 SVD,
`ops/small_linalg.py`) at every shape of its paths (the PnP solvers'
[512, 12, 12] and [512, 3, 3] in float32, the PSD clip's [1, 45, 45] and
[8, 45, 45] in float64, and of the identity's Schur complement, which the
frames that marginalize nothing clip; the proper rotations' [512, 3, 3]
SVD; the DLT's null vector against float64; each clip's Jacobi rounds
and device us a round), beside `torch.linalg.eigh` and `svd`. It runs
the eager `ok_step`, `sfm_step` (each PnP solver), `bootstrap_frame`,
`full_init` and `refine_gravity` once each under
`torch.cuda.set_sync_debug_mode("error")`, and holds the log-depth IMU
preintegration (`integrate_chunk`) to its per-sample loop over 16 chained
EuRoC chunks (phase 3d). Then it drives,
each with the kernel counts set to 0 just before and read just after:

- `ok_step` over 16 simulated EuRoC-scale frames from a window seeded at
  the true pose: finite state, non-negative BA cost, tracking and BA alive
  after a 6-frame warm-up, no divergence, K1 and K2 launched once per
  extraction;
- the same 16 frames through the map-based front end (K1 detection, K4
  moment maps, full-stack blur and pool gather), with 4 seeds of the
  RANSAC draws: the same checks, but the divergence bound held by at least
  half of the chains and no chain beyond 2 x distance + 10 m (on this slice
  a frame that tracks a handful of features moves the pose by metres on
  either front end); K1 and K4 launched once per frame and K2 never;
- a small input through the kernel path and the CPU twin path, which must
  agree, and 16 chains at full pyramid depth (384x240, 8 levels) held to
  the JAX package's drift;
- the captured CUDA graphs (`graphs.py`, phase 4c): K1 and K2 read out of
  a graph replay against their twins on another frame's stack than the
  capture's; phase 4's chain eager and graphed in turns, every frame's
  metrics and the final state bit-equal, on the kernel path and on the
  map front end with K4; the staged graphs, the overflow chunks'
  `integrate` graph, `ok_scan` as one graph and the batched step of 8
  lanes, each bit-equal to its eager run; the `imu`, `frame`,
  `integrate` and `scan` graphs' nodes beside the staged ms; one
  replay a fused frame, an `ok_scan` and a batched step, four a staged
  frame; each path's launches as replays x the graph's; each graph's
  capture and instantiate seconds, nodes and pool bytes and the busy
  share of graphed frames; the chain's frames split into marginalizing
  keyframes and the others, each replay timed by CUDA events, and K6's
  clip profiled inside two frames of each kind (`frames_by_kind`);
- the host state machine (`slam.VisualInertialSLAM`, its OK frames as
  graphs) at KITTI width over a 6-s noisy simulation with the kitti
  profile: it must reach OK, launch K3 and K2 equally and K1 never in
  every OK frame, K6 in its SfM frames and clips, replay one graph an OK
  frame and one graph a solve after the first call of its shapes, which
  runs eagerly (extraction of the reference image, SfM frame, SfM
  constraint, initializer, bootstrap frame, gravity refinement, warm
  recovery), keep the BA cost >= 0, the state finite
  and the aligned error under 2 x distance + 1 m, and equal, bit for bit,
  the same run with `graphed=False`;
- the accuracy protocol of `benchmarks/chip_accuracy.py` through the port
  (family A worlds 0-2 for 6 s, family B worlds 0-1 for 12 s; gates ATE
  < 4 % of path, |ba| < 1.5, |bg| < 0.01), its runs spread over worker
  processes that share the card. Every run must reach OK, launch K1 and
  K2 once per extraction and K3 never, and stay under 2 x distance + 1 m.
  A2, B0 and B1 must
  pass the gates. A0 and A1 pass or fail by the random draws in both
  packages (PERF.md, findings on the state machine), so each runs with
  12 seeds of the draws: every run must stay under 3 x each gate, and the
  passes must not fall short of the JAX package's measured pass rate
  (fail when, at that rate, so few passes would come with probability
  below 5 %). Seed 0's runs are printed beside the JAX package's record.
  Three more runs share the workers: world A2 on the map-based front end
  (K4 launched once per extraction, K2 never), world A2 with the P3P
  bootstrap (`solve_pnp=2`) and the KITTI-width rig with
  `rectify_mode="dense"` (K3 and K2 once per extraction, never K1). Each
  must reach OK, stay
  finite, under 2 x distance + 1 m and under 3 x each gate; whether it
  passes the gates is printed;
- many sequences in one frame step (`parallel.batched`): K1, K2, K3 and
  K4 on the plane stack of 8 EuRoC-width stereo pairs (128 planes, one
  launch each) against their twins, 8 chained batched frames of 8 lanes
  (lane j replaying from frame j) with one extraction and one K1 and K2
  launch a frame, under the divergence guard (at least half the lanes
  within 2 x distance + 1 m, none beyond + 10 m), the second frame run
  again per lane against the single-sequence `ok_step` from the same
  state and uniforms, the keyframe full-BA branch under `torch.func.vmap`
  held lane by lane against each lane's own solve, and a checkpoint in
  the middle of a state-machine run on the card that the resumed object
  must continue identically;
- the entry points: a EuRoC-format directory at 752x480 (20 Hz) and a
  KITTI raw directory at 1242x375 (10 Hz), written from the simulator with
  PNGs whose rows cycle through the five filters (the C PNG unfilter held
  bit-equal to its numpy twin on every frame), replayed through
  `run_euroc.main` (K1 and K2 once per extraction), through the CLI's body
  with keyframe full BA, and through `run_kitti.main` (K3 and K2), each
  graphed, and each dataset again through the CLI's body with
  `graphed=False`: each must reach OK, stay finite and under 2 x distance
  + 1 m, and write the JAX package's `states.csv` format, and the eager
  file must equal the graphed one; the profiler counts an eager
  keyframe's and another frame's kernels. Each replay prints its first OK
  frame's ms (a graphed run's warm-up and captures) and its later frames'
  ms split by the host work each ran beside the step (health check,
  gravity refinement, recovery, overflow IMU chunks).

- the staged OK path: frames 6-15 of the kernel path's chain through the
  four stages of `models.vio` (each timed to a synchronize: the per-stage
  split of a frame), then through the fused `ok_step` from the same state
  with the same uniforms, bit-equal, K1 and K2 once per staged frame; and
  8 of those frames through `ok_scan`, bit-equal to 8 `ok_step` calls;
- the EuRoC directory again through the CLI's body, unprofiled, without a
  viewer, with a `LiveViewer` attached (its pushes counted: one pose per
  OK frame, one keyframe commit per keyframe, landmarks every 10 frames)
  and with `staged=True` (each stage timed), each under the replay gates;
- the mesh: the sharded pool match's packed reduction against the
  unsharded match on the card, then `parallel.multihost.dryrun`: 4
  processes share the card over gloo as a (data 2, model 2) grid at EuRoC
  width, each rank's lanes held to the single-process batched step.

The 16-frame chain of the kernel path also runs once more with keyframe
full BA, under the same divergence guard. Any failure exits non-zero. The second-to-last line is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import subprocess
import sys
import time
import traceback
import types

import numpy as np

N_FRAMES = 16
WARMUP = 6
K1_TOL_XY = 1e-5       # px: same float32 operations as the twin
K2_TOL_MOM = 1e-5      # of the largest moment: float32 sums in another order
K2_TOL_VAL = 1e-3      # intensity, on >= 99.9 % of samples (a rounded sample
K2_MIN_CLOSE = 0.999   # point can flip at .5 when the rotation rounds apart)
# K4 against its twin and the convolution against the twin, of the plane's
# largest |moment|: three summation orders of ~1e3-1e5 moments (the kernel's
# tile-local prefix sums, the twin's whole-row prefix sums in float64,
# cuDNN's own algorithm); the kernel is also held much closer to the twin
# run in float64.
K4_TOL_MOM = 1e-3
K4_TOL_MOM_F64 = 2e-5
K4_TOL_ANGLE = 2e-3    # rad, at detected keypoints, from the float64 twin's angle
# The map front end's own angle forms (`orb.ic_angle_sparse`, and
# `moments.ic_angle_integral` of the twin's maps) at the detected keypoints,
# from the float64 twin's angle, rad. Their prefix sums and differences are
# taken in float64: float32 whole-row sums from CUDA's block scan put them
# 1.8e-3 (752 px) and 7.1e-3 rad (1242 px) off.
MAP_TOL_ANGLE = 1e-3
K4_MIN_MOMENT = 1e-3   # keypoints with a shorter moment vector (of the plane's
#                        longest) are skipped: atan2 is ill conditioned there
# float32 instructions per pixel of the moment maps in prefix-sum form: 2
# prefix adds and the x-weight multiply, for each of the 10 distinct radii
# a box difference, a ramp difference and its multiply-add (30), and the
# 31-row accumulation (31 adds, 30 multiply-adds)
K4_OPS_PER_PX = 3 + 30 + 61
# Shared memory moves 128 bytes a clock on each SM: 132 SMs at 1.98 GHz.
# K4's own count of its shared-memory bytes (`moment_maps_smem_bytes`, from
# the constants of csrc/moment_maps.cu) over this rate is a model of the
# kernel, printed beside its measured time.
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
# EuRoC run: a divergence guard, not an accuracy gate. The seeded slice at
# this scale tracks 5-35 features per frame in both packages and drifts by
# decimetres to metres (PERF.md); a run that diverges (an indefinite
# marginalization prior ran LM to kilometres) exceeds this at once.
DIVERGED_PER_M, DIVERGED_M = 2.0, 1.0   # error bound: 2 x distance travelled + 1 m
# Whether a chain of this slice stays under that bound depends on its RANSAC
# draws: a frame that tracks 1-4 features moves the pose by metres on any
# front end (over generator seeds 0-7 on the card, 6 of 8 chains hold it on
# the kernel path, 6 of 8 on the map front end with K4, 8 of 8 with the
# sparse angles; PERF.md). The kernel path is held to it at seed 0, as
# before. The map front end runs MAP_SEEDS: at least half of its chains
# must hold the bound, and none may run away beyond 2 x distance + 10 m.
MAP_SEEDS = (0, 1, 2, 3)
RUNAWAY_M = 10.0
# Drift at full pyramid depth (384x240, 8 levels, 400 features, 8 frames
# from the seeded window): the JAX package's median final position error
# over 16 RANSAC seeds (measured on a CPU, sampler in interpret mode, keys
# PRNGKey(1000 * seed + frame)), and the bound on the port's median (the
# CPU test tests/test_torch_vio_mid.py holds the port's CPU path to the
# same ratio against the JAX package run live).
# A checkpoint in the middle of a run on the card (protocol world A2): saved
# at RESUME_AT s, the resumed object and the original run on to RESUME_END
# s and must agree within RESUME_TOL.
RESUME_AT, RESUME_END, RESUME_TOL = 1.5, 2.5, 1e-6

MID = dict(width=384, height=240, levels=8, features=400)
MID_FRAMES, MID_SEEDS, MID_LANDMARKS = 8, 16, 400
JAX_MID_MEDIAN_M = 0.1384
MID_RATIO = 1.5
# The batched phase: B sequences of the EuRoC-width world, lane j seeded at
# frame j's true state and replaying from frame j (bench.py's protocol),
# BATCH_FRAMES chained batched frames. The second is then run again with
# the LM capped at HELD_LM_ITERS (on the seeded window the production
# cap's solve is ill posed, tests/test_torch_vio.py) and held lane by lane:
# (1) bit for bit against the same lane in a batch of B copies of itself,
# so a lane depends on its own data alone; (2) against the single-sequence
# `ok_step` from the same state and uniforms. A lane agrees with its single
# step when its counts and LM iterations are equal and its newest position
# within BATCH_TOL_P; at least BATCH_MIN_AGREE lanes must, and every lane
# must stay within BATCH_LOOSE_P. (1) once failed: a lane's sum over its 801
# features depended on its place in the batch (`ops/ransac.py:_row_sum`).
# (2) still differs because a batched product picks its kernel, and so its
# order of summation, by the batch size: the first output to differ on
# identical inputs is a 3x3 product of the IMU preintegration, bit-equal
# alone and under vmap at batch 1, 4.7e-10 off at batch 8; the first
# decision to differ is a pivot of the fundamental RANSAC's elimination,
# over ~10 matches (ROADMAP C7). Over 40 lane-frames (B = 8, frames 1-5,
# tools/lane_diff.py on the card, PERF.md) 25 agreed, at worst 3 of 8 in a
# frame, and a position moved at most 0.140 m; the bounds leave room below
# and above those readings.
BATCH, BATCH_FRAMES = 8, 8
HELD_LM_ITERS = 4
BATCH_TOL_P = 1e-3      # m, as tests/test_torch_vio.py holds the port to JAX
BATCH_MIN_AGREE = 2
BATCH_LOOSE_P = 0.3     # m
# KITTI width: ORB-SLAM2's KITTI settings (2000 features, 8 levels, scale
# 1.2, FAST 20/7) on the simulator's rig at 1242x375 with the kitti
# profile; IMU noise densities in that profile's units, equal in discrete
# terms to the euroc protocol's (tests/test_profiles_e2e.py)
KITTI = dict(dataset="kitti", width=1242, height=375, level_pyramid=8, num_features=2000,
             keyframe_rotation=0.1, keyframe_translation=0.15)
# The accuracy protocol (testing.protocol_world; benchmarks/chip_accuracy.py)
# and the JAX package's record of it on a TPU (CHIP_ACCURACY_r05.json: ATE
# % of path, |ba|, |bg|, one PRNG key), printed beside the port's seed 0.
JAX_RECORD = {"A0": (2.25, 0.2585, 0.00257), "A1": (2.005, 1.2186, 0.00215),
              "A2": (1.2, 0.3205, 0.00231), "B0": (1.018, 0.3173, 0.00163),
              "B1": (1.122, 0.3789, 0.00144)}
# Runs held to the gates with the state machine's default seed 0.
HARD_RUNS = ("B0", "B1", "A2")
# Runs held to a pass rate over seeds 0-11 of the draws: the JAX package's
# passes over PRNG keys on the same worlds (tools/fsm_parity.py jax-seeds,
# float32 on a CPU, the sampler kernel in interpret mode: A0 keys 0-46, A1
# keys 0-7). The run set fails when, at that rate, as few passes as it
# made would come with probability below RATE_ALPHA.
# Runs beside the protocol's, held like the map front end's A2: the
# KITTI-width rig in dense mode and world A2 with the P3P bootstrap.
EXTRA_RUNS = ("KITTI-dense", "A2-p3p")
RATE_RUNS = {"A0": (14, 47), "A1": (4, 8)}
RATE_SEEDS = tuple(range(12))
RATE_ALPHA = 0.05
# A rate run beyond 3 x a gate is a runaway, not a draw: the worst seen
# over 55 JAX keys and 92 of the port's seeds on the card was ATE 10.93 %,
# |ba| 4.32, |bg| 0.029.
RUNAWAY = 3.0
PROTOCOL_WORKERS = 4
# The least time the card could take (NVIDIA H100 SXM data sheet at 700 W):
# HBM bytes over 3.35 TB/s, or float32 instructions outside the tensor
# cores over their issue rate, whichever is larger. The data sheet's
# 67 TFLOP/s counts a fused multiply-add as two operations; one min, max,
# subtraction, compare or multiply-add issues at half that rate, 33.5e12
# a second (132 SMs x 128 float32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# float64 outside the tensor cores: the data sheet's 34 TFLOP/s, a fused
# multiply-add counted as two operations (132 SMs x 64 float64 lanes x
# 1.98 GHz instructions a second)
FP64_INSTR_PER_S = 34e12 / 2
# Phase 3b, K6 (ops/small_linalg.py) at the shapes of the paths: (label,
# matrices, n, dtype); the PnP solvers' [512, ...] in float32 (the graded
# stop), the PSD clip of one frame's and of BATCH lanes' Schur complements
# in float64 (the stop at eps ||A||_F, as `ba.psd_clip` calls it), and the
# clip of the identity's Schur complement, which every frame that
# marginalizes nothing passes (models/vio.py:stage_ba_solve). Each
# eigenvalue within K6_TOL[dtype] x ||A||_F of the twin's; the residual
# ||A V - V diag(w)||_F and ||V^T V - I||_max within K6_RES_TOL[dtype]
# (x ||A||_F for the residual); the clip (float64) within 1e-12 x ||S||_F
# of the twin's; the SVD's ||U S Vh - A|| within K6_TOL x ||A||_F. The
# DLT's null vector, on normal matrices of 6 projected points each (the
# simulator's landmark box, small motions, 1e-3 image noise), against
# float64 `torch.linalg.eigh` of the same float32 matrices: the sine of
# the angle within K6_NULL_TOL x eps32 ||A||_2 / (l2 - l1), the Davis-Kahan
# bound of a backward error of that size; the bound is one the twin meets
# (on an H100 the twin, cuSOLVER's float32 eigh, read up to 8.72 on these
# 512 matrices and K6 0.105).
K6_EIGH_SHAPES = (("dlt", 512, 12, "float32"), ("epnp_axes", 512, 3, "float32"),
                  ("epnp", 512, 12, "float32"), ("clip", 1, 45, "float64"),
                  ("clip_batched", 8, 45, "float64"), ("clip_identity", 1, 45, "float64"))
K6_TOL = {"float32": 1e-5, "float64": 1e-12}
K6_NULL_TOL = 16.0
K6_RES_TOL = {"float32": 1e-4, "float64": 1e-11}
# operations of a symmetric eigendecomposition with its vectors, and of an
# SVD with U and V, in the least form known (Golub and Van Loan, Matrix
# Computations, 4th ed., Fig. 8.6.1: 9 n^3 flops for the symmetric QR
# algorithm with V; 4 m^2 n + 8 m n^2 + 9 n^3 for the R-SVD with U and V),
# as multiply-add instructions (half the flops)
def eigh_instr(n):
    return 9 * n ** 3 / 2


SVD3_INSTR = (4 * 27 + 8 * 27 + 9 * 27) / 2
# float32 instructions per pixel of the FAST-9 score and 3x3 NMS, counted
# in the least form known (csrc/fast_common.cuh): 16 ring differences, for
# each polarity the 8 two-, four- and eight-long window extrema that the 16
# nine-long arcs share (24), the pairs of arcs (16) and the reduction over
# them (7), the polarity max (1), 8 NMS compares. (The twin's form, 16
# arcs from three-long extrema, takes 183.)
FAST_OPS_PER_PX = 16 + 2 * (24 + 16 + 7) + 1 + 8

# Phase 10, the entry points: a EuRoC-format directory written from the
# simulator at 752x480 (20 Hz for ENTRY_EUROC_S, 8 levels, 800 features,
# keyframes at 0.1 rad or 0.15 m, the protocol's IMU noise) replayed by the
# CLI, then by the CLI's body with keyframe full BA, and a KITTI raw
# directory at 1242x375 (10 Hz for ENTRY_KITTI_S) by its CLI. In each EuRoC
# run the profiler counts the kernels of OK frames from ENTRY_PROFILE_FROM
# on until it has seen a keyframe and another frame, at most ENTRY_PROFILED
# frames (a session costs seconds at ~15-27k kernels a frame).
ENTRY_EUROC_S, ENTRY_KITTI_S = 2.5, 2.0
ENTRY_PROFILE_FROM, ENTRY_PROFILED = 10, 6
ENTRY_EUROC = dict(dataset="euroc", width=752, height=480, camera_frequency=20,
                   level_pyramid=8, num_features=800, keyframe_rotation=0.1,
                   keyframe_translation=0.15)
# The header of the JAX package's `save_results` (its states.csv), whose
# 17 columns every row of the port's must have.
STATES_CSV_HEADER = "timestamp,qw,qx,qy,qz,px,py,pz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz"

# Phase 3d, the IMU preintegration (imu/preintegration.py): the log-depth
# `integrate_chunk`, which every path runs, against its per-sample loop
# `integrate_chunk_sequential`, over phase 4's N_FRAMES chunks chained from
# the seeded state; each field within IMU_SCAN_TOL of its largest |entry|
# (float32: the loop reassociates every product and sums dt sample by
# sample; tests/test_torch_geometry.py holds the loop to the JAX package's
# oracle at the same 1e-5, tests/test_torch_preintegration.py the scan to
# the JAX package's scan at 1e-6).
IMU_SCAN_TOL = 1e-5

# Phase 4b, the staged OK path: frames WARMUP..N_FRAMES-1 of phase 4's
# kernel-path chain (generator seed 0) through the four stages of
# `models.vio`, each waiting for the card before it returns (so each is
# timed alone), then through the fused `ok_step` from the same state with
# the same uniforms. The fused step is the stages' own code in one call,
# so the two states should be bit-equal; a difference up to STAGED_TOL_P m
# in the positions would be accepted with its cause printed. The first
# SCAN_FRAMES of those frames also run through `ok_scan`, which must equal
# the fused chain bit for bit.
STAGED_TOL_P = 1e-5
SCAN_FRAMES = 8
STAGES = ("stage_imu", "stage_frontend", "stage_ba", "stage_pool")
# the staged frame's captured graphs (graphs.FrameGraphs.staged_step) by stage
GRAPH_STAGES = {"imu": "imu", "frontend": "frontend", "ba": "ba", "pool": "pool"}
# Phase 11, the mesh dry run (parallel/multihost.py): MESH_RANKS processes
# share the card over gloo as a (data MESH_RANKS / MESH_MODEL, model
# MESH_MODEL) grid, MESH_LANES lanes a data rank, at phase 4's EuRoC-width
# configuration and world. The warm-up is MESH_WARMUP single steps (the JAX
# dry run takes 2): after frame 4's keyframe the pool holds ~586 landmarks,
# so both model ranks' 512-slot blocks hold valid slots and the argmin
# reduction decides between them.
MESH_RANKS, MESH_MODEL, MESH_LANES, MESH_WARMUP = 4, 2, 2, 5
MESH_TIMEOUT_S = 420.0

# kernels whose first profiler session in `device_ms` recorded no launch
PROFILE_MISSES = []


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_activity(prof) -> dict:
    """What `torch.profiler` saw on the card: `events`, its kernels, copies
    and sets; `busy_ms`, the union of their intervals (overlaps counted
    once); `summed_ms`, their device times summed; `span_ms`, from the
    first one's start to the last one's end. The `record_function` ranges
    (`ok_step.*`), which kineto also lays on the device's timeline as
    spans over the kernels they hold and the gaps between them, are left
    out of these and summed apart as `annotation_ms`."""
    on_card = [e for e in prof.events() if e.device_type.name == "CUDA"]

    def annotation(e):
        return e.is_user_annotation or e.name.startswith("ok_step.")

    work = sorted((e.time_range.start, e.time_range.end) for e in on_card if not annotation(e))
    busy, lo, hi = 0.0, None, None
    for a, b in work:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0.0 if hi is None else hi - lo
    return {"events": len(work), "busy_ms": busy / 1e3,
            "summed_ms": sum(b - a for a, b in work) / 1e3,
            "span_ms": (max(b for _, b in work) - work[0][0]) / 1e3 if work else 0.0,
            "annotation_ms": sum(e.device_time for e in on_card if annotation(e)) / 1e3}


def bound(n_bytes: float, n_instr: float, instr_per_s: float = FP32_INSTR_PER_S):
    """(least time in ms, "bytes" or "operations") for `n_bytes` of HBM
    traffic and `n_instr` instructions (float32 unless `instr_per_s` says
    otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / instr_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kitti_config(**extra):
    """sim_config at KITTI width with the kitti profile's noise units."""
    from pose_estimation_tpu_torch.testing import G, sim_config

    sdt = np.sqrt(1.0 / 200)
    return sim_config(**KITTI, acc_noise=2.0e-3 / G, gyr_walk=1.9e-5 * sdt,
                      acc_walk=3.0e-3 * sdt / G, **extra)


def wrappers() -> dict:
    """The kernels' wrappers by name; each counts its launches."""
    from pose_estimation_tpu_torch.ops import fast, moments, probe, sample, small_linalg

    return {"fast_select": fast.fast_select, "sample_patches": sample.sample_patches,
            "fast_score_nms": fast.fast_score_nms, "moment_maps": moments.moment_maps,
            "stream_probe": probe.stream_probe, "eigh": small_linalg.eigh,
            "svd": small_linalg.svd}


# the extraction kernels (the others, K5 and K6, run on other paths)
EXTRACTION = ("fast_select", "sample_patches", "fast_score_nms", "moment_maps")
# every CUDA graph replay of the process (`count_replays`)
REPLAYS = {"n": 0}


def count_replays() -> None:
    """Count every `torch.cuda.CUDAGraph.replay` in REPLAYS."""
    import torch

    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        REPLAYS["n"] += 1
        return replay(self)

    torch.cuda.CUDAGraph.replay = counted


@contextlib.contextmanager
def counted_solves():
    """While the block runs, count the calls of `graphs.SolveGraphs.run` by
    name and the graph replays they ran. Yields a dict, filled at the end
    with {name: [calls, eager calls, replays]}: the first call of a name and
    input shapes runs eagerly (no replay), every later one is one replay."""
    from pose_estimation_tpu_torch import graphs

    run, got = graphs.SolveGraphs.run, {}

    def counted(self, name, fn, *args):
        before = REPLAYS["n"]
        first = self.key(name, args) not in self.calls
        out = run(self, name, fn, *args)
        calls = got.setdefault(name, [0, 0, 0])
        calls[0] += 1
        calls[1] += first
        calls[2] += REPLAYS["n"] - before
        return out

    graphs.SolveGraphs.run = counted
    try:
        yield got
    finally:
        graphs.SolveGraphs.run = run
    if any(c - e != r for c, e, r in got.values()):
        fail(f"state machine solves: calls, eager first calls and replays by name {got} (one "
             "replay a call after the first of its shapes)")


def check_frame_replays(label, frames, per_frame=1) -> None:
    """Every graphed OK frame that ran the step alone, or with a health
    check that ran nothing more (marks "" and "H"), replayed `per_frame`
    graphs: the fused frame is one graph, the staged frame four."""
    bad = [(i, f["replays"]) for i, f in enumerate(frames)
           if f["events"] in ("", "H") and f["replays"] != per_frame]
    if bad:
        fail(f"{label}: OK frames (index, replays) {bad[:8]}, expected {per_frame} replays")


def counters() -> dict:
    """The kernels' launches run: each wrapper's count, less the launches
    that CUDA graph captures recorded (a recording runs nothing), plus
    those that graph replays ran (`graphs.recorded`, `graphs.replayed`)."""
    from pose_estimation_tpu_torch import graphs

    return {name: fn.launches - graphs.recorded.get(name, 0) + graphs.replayed.get(name, 0)
            for name, fn in wrappers().items()}


def zero_counters() -> None:
    from pose_estimation_tpu_torch import graphs

    for name, fn in wrappers().items():
        fn.launches = 0
        graphs.recorded.pop(name, None)
        graphs.replayed.pop(name, None)


@contextlib.contextmanager
def count_prior_clip():
    """Count, over the block, how often `ba.psd_clip` clips a Schur
    complement of the marginalization in eager frames (in a graphed frame
    the clip runs inside the frame's graph, out of Python's sight): K6's
    `eigh` is wrapped while psd_clip runs, and the ratio of the smallest to
    the largest eigenvalue of each matrix stays on the device until the
    block ends. The frame step computes the marginalization on every frame
    and keeps it on a keyframe of a full window only; on the other frames
    it passes the identity, whose Schur complement is a multiple of the
    identity, and those are not counted. Yields a dict that is then filled
    with the marginalizations, those with a negative eigenvalue (where the
    clip fires) and the most negative ratio."""
    import torch

    from pose_estimation_tpu_torch.backend import ba as ba_mod
    from pose_estimation_tpu_torch.ops import small_linalg

    clip, eigh = ba_mod.psd_clip, small_linalg.eigh
    ratios, kept, stats = [], [], {}
    # the clip's own view of K6 (the wrapper's counter stays its own)

    def recording_eigh(a, **kw):
        evals, evecs = eigh(a, **kw)
        ratios.append((evals[..., 0] / torch.clamp(evals[..., -1].abs(), min=1e-300))
                      .reshape(-1))
        return evals, evecs

    def counted_clip(schur):
        eye = torch.eye(schur.shape[-1], dtype=schur.dtype, device=schur.device)
        kept.append((schur != schur[..., :1, :1] * eye).flatten(-2).any(-1).reshape(-1))
        ba_mod.small_linalg = types.SimpleNamespace(eigh=recording_eigh)
        try:
            return clip(schur)
        finally:
            ba_mod.small_linalg = small_linalg

    ba_mod.psd_clip = counted_clip
    try:
        yield stats
    finally:
        ba_mod.psd_clip = clip
    r = ([x for x, k in zip(torch.cat(ratios).tolist(), torch.cat(kept).tolist()) if k]
         if ratios else [])
    stats.update(calls=len(r), negative=sum(x < 0 for x in r), worst_ratio=min(r, default=0.0))


def extractions(launches) -> int:
    """The stereo pairs that a run extracted, read from its launch counts
    (`counters`): each extraction launches one detector, K1
    (`fast_select`) or, at widths not divisible by 16, K3
    (`fast_score_nms`)."""
    return launches["fast_select"] + launches["fast_score_nms"]


@contextlib.contextmanager
def timed_stages(graphed=False):
    """While the block runs, each stage of a staged OK frame waits for the
    card before it returns and adds its host time to the yielded
    `profiling.StageTimers` under its name without "stage_". Eager: each of
    `models.vio`'s four stages (the staged state machine calls them through
    the module). `graphed`: each replay of a staged graph
    (`GRAPH_STAGES`), captures left out."""
    import torch

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.profiling import StageTimers

    timers = StageTimers()
    if graphed:
        call = graphs.CapturedStep.__call__

        def timed_call(self):
            stage = GRAPH_STAGES.get(self.name)
            if stage is None or self.graph is None:
                return call(self)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(self)
            torch.cuda.synchronize()
            timers.total[stage] += time.perf_counter() - t0
            timers.count[stage] += 1
            return out

        graphs.CapturedStep.__call__ = timed_call
        try:
            yield timers
        finally:
            graphs.CapturedStep.__call__ = call
        return
    saved = {name: getattr(vio, name) for name in STAGES}

    def timed(name, fn):
        def run(state, *args, **kwargs):
            # the state's tensors live on the card: the timer synchronizes
            with timers.stage(name[len("stage_"):], result=state.win.R):
                return fn(state, *args, **kwargs)
        return run

    for name, fn in saved.items():
        setattr(vio, name, timed(name, fn))
    try:
        yield timers
    finally:
        for name, fn in saved.items():
            setattr(vio, name, fn)


def stage_split(timers) -> dict:
    """ms per call of each stage in `timers`, in the stages' order."""
    return {name[len("stage_"):]: timers.total[name[len("stage_"):]] * 1e3
            / timers.count[name[len("stage_"):]] for name in STAGES}


def staged_checks(dev, consts, static, inputs, truth) -> dict:
    """Phase 4b (see STAGED_TOL_P): the staged OK path against the fused
    `ok_step` on the same frames, states and uniforms, with the per-stage
    split of a frame and K1 and K2 once per staged frame; then `ok_scan`
    over SCAN_FRAMES of them against the fused chain. Returns the phase's
    numbers."""
    import torch

    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.testing import seeded_state
    from pose_estimation_tpu_torch.utils.tree import tree_leaves

    start = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(WARMUP):
        start, _ = vio.ok_step(start, *inputs[i], gen, consts, static)
    frames = list(range(WARMUP, N_FRAMES))
    gen_at_us = gen.get_state()
    us = [vio.draw_ransac_uniforms(gen, dev) for _ in frames]

    torch.cuda.synchronize()
    zero_counters()
    per_frame = []
    staged = start
    with timed_stages() as timers:
        t0 = time.perf_counter()
        for u, i in zip(us, frames):
            img_l, img_r, gyr, acc, mask = inputs[i]
            before = counters()
            staged, _ = vio.stage_imu(staged, gyr, acc, mask, consts, static)
            staged, cur, tr = vio.stage_frontend(staged, img_l, img_r, u, consts, static)
            staged, _, _ = vio.stage_ba(staged, tr.n_matches, consts, static)
            staged = vio.stage_pool(staged, cur, tr, tr.n_matches, consts, static)
            per_frame.append({k: v - before[k] for k, v in counters().items()})
        torch.cuda.synchronize()
        staged_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    staged_launches = counters()
    split = stage_split(timers)
    if any((n["fast_select"], n["sample_patches"], n["fast_score_nms"], n["eigh"])
           != (1, 1, 0, 1) for n in per_frame):
        fail(f"staged path: launches per frame {per_frame} (K1, K2 and the clip's K6 once, "
             "K3 never)")

    zero_counters()
    fused, chain = start, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u, i in zip(us, frames):
        fused, _ = vio.ok_step(fused, *inputs[i], None, consts, static, ransac_u=u)
        chain.append(fused)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    pairs = list(zip(tree_leaves(staged), tree_leaves(fused)))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    p_diff = float((staged.win.p - fused.win.p).abs().max())
    float_diff = max(float((a.double() - b.double()).abs().max())
                     for a, b in pairs if a.is_floating_point())
    print(f"staged OK path ({len(frames)} frames of the kernel-path chain, each stage "
          f"synchronized): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" ms per frame, sum {sum(split.values()):.2f}; {staged_ms:.2f} ms per staged "
          f"frame against {fused_ms:.2f} fused; launches per staged frame "
          f"{per_frame[0]}; staged state "
          + ("bit-equal to the fused state" if bit_equal else
             f"differs from the fused state: positions {p_diff:.3g} m, any float "
             f"{float_diff:.3g}"))
    if not bit_equal and not p_diff <= STAGED_TOL_P:
        fail(f"staged path: positions {p_diff:.3g} m from the fused step's")
    if not bit_equal:
        print("  (the stages run the fused step's code: a difference means a kernel or "
              "library call that is not deterministic run to run on the card)")

    sel = frames[:SCAN_FRAMES]
    stacked = [torch.stack([inputs[i][k] for i in sel]) for k in range(5)]
    u_scan = torch.stack([torch.stack(u) for u in us[:SCAN_FRAMES]])
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_state, outs = vio.ok_scan(start, *stacked, None, consts, static, ransac_u=u_scan)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / SCAN_FRAMES
    scan_launches = counters()
    ref = chain[SCAN_FRAMES - 1]
    scan_equal = (all(torch.equal(a, b) for a, b in zip(tree_leaves(scan_state),
                                                         tree_leaves(ref)))
                  and all(torch.equal(outs["p"][k], chain[k].win.p[-1])
                          for k in range(SCAN_FRAMES)))
    if not scan_equal or outs["p"].shape != (SCAN_FRAMES, 3):
        fail(f"ok_scan over {SCAN_FRAMES} frames differs from {SCAN_FRAMES} ok_step calls")
    if (scan_launches["fast_select"], scan_launches["sample_patches"]) != (SCAN_FRAMES,) * 2:
        fail(f"ok_scan: launches {scan_launches} in {SCAN_FRAMES} frames")
    print(f"ok_scan ({SCAN_FRAMES} chained frames): bit-equal to {SCAN_FRAMES} ok_step "
          f"calls with the same uniforms; {scan_ms:.2f} ms per frame; tracked "
          f"{outs['n_tracked'].tolist()}; launches {scan_launches}")

    # ok_scan as one graph of SCAN_FRAMES frames, the uniforms drawn from a
    # generator in the state that drew `us`
    from pose_estimation_tpu_torch import graphs

    runner = graphs.FrameGraphs(start, consts, static, dev)
    sgen = torch.Generator(device=dev)
    sgen.set_state(gen_at_us)
    zero_counters()
    before = REPLAYS["n"]
    g_outs = graphs.snapshot(runner.ok_scan(*stacked, sgen))
    torch.cuda.synchronize()
    g_scan_launches, g_replays = counters(), REPLAYS["n"] - before
    g_equal = (all(torch.equal(a, b) for a, b in zip(tree_leaves(runner.state),
                                                      tree_leaves(ref)))
               and all(torch.equal(g_outs["p"][k], chain[k].win.p[-1])
                       for k in range(SCAN_FRAMES)))
    scan_graph = runner.stats()["scan"]
    print(f"ok_scan as one graph ({SCAN_FRAMES} frames): " + ("bit-equal" if g_equal
                                                              else "DIFFERS")
          + f" to {SCAN_FRAMES} ok_step calls; {g_replays} replay; graph "
          + graph_line("scan", scan_graph) + f"; launches {g_scan_launches} (with the warm-up)")
    if not g_equal:
        fail(f"graphed ok_scan over {SCAN_FRAMES} frames differs from {SCAN_FRAMES} ok_step calls")
    if g_replays != 1 or (g_scan_launches["fast_select"], g_scan_launches["eigh"]) \
            != (2 * SCAN_FRAMES,) * 2:
        fail(f"graphed ok_scan: {g_replays} replays, launches {g_scan_launches} (one replay; "
             f"K1 and K6 {SCAN_FRAMES} times in it and in the warm-up)")
    del runner
    return {"frames": len(frames), "stage_ms": split, "stage_sum_ms": sum(split.values()),
            "staged_ms_per_frame": staged_ms, "fused_ms_per_frame": fused_ms,
            "bit_equal": bit_equal, "p_diff_m": p_diff, "launches": staged_launches,
            "launches_per_frame": per_frame[0], "scan_ms_per_frame": scan_ms,
            "scan_launches": scan_launches, "scan_graph": scan_graph}


def graph_line(name, g) -> str:
    """One captured graph's numbers (`graphs.CapturedStep.stats`) as text."""
    if "nodes" not in g:
        return (f"{name} (eager once, not captured)" if g.get("eager")
                else f"{name} (not captured: {g['replays']} calls)")
    return (f"{name} {'eager once, then ' if g.get('eager') else ''}{g['nodes']} nodes, "
            f"capture {g['capture_s']:.3f} s, instantiate "
            f"{g['instantiate_s']:.3f} s, pool {g['pool_bytes'] / 2**20:.1f} MiB, launches "
            f"{g['launches']}, {g['replays']} replays")


def frames_by_kind(runner, start, inputs, frames, dev, profiled_per_kind=2) -> dict:
    """The graphed chain's frames by kind: a keyframe that tracks
    marginalizes the window's oldest frame (the seeded window is full) and
    clips its Schur complement on K6; any other frame clips the identity's
    (models/vio.py:stage_ba_solve). `frames` run from `start` with seeded
    draws, each replay between two CUDA events, enqueued back to back;
    then again, the first `profiled_per_kind` frames of each kind each
    profiled alone: its kernels' busy device ms (`device_activity`) and
    K6's device ms (`eigh_kernel`, the clip). Returns per kind the frames,
    event ms each and their mean, and the profiled frames' numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pose_estimation_tpu_torch.models import vio

    def chain(profile_at=()):
        runner.load_state(start)
        gen = torch.Generator(device=dev).manual_seed(4)
        torch.cuda.synchronize()
        recs = []
        for i in frames:
            u = vio.draw_ransac_uniforms(gen, dev)
            if i in profile_at:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    runner.ok_step(*inputs[i], u)
                    torch.cuda.synchronize()
                clip = [e.device_time for e in prof.events()
                        if e.device_type.name == "CUDA" and "eigh_kernel" in e.name]
                recs.append({"frame": i, "busy_ms": device_activity(prof)["busy_ms"],
                             "clip_device_ms": sum(clip) / 1e3, "clip_launches": len(clip)})
                continue
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            m = runner.ok_step(*inputs[i], u)
            e1.record()
            recs.append((e0, e1, (m["is_keyframe"] & (m["n_tracked"] > 0)).clone()))
        torch.cuda.synchronize()
        return recs

    timed = chain()
    kinds = {"marginalizing": [], "other": []}
    for i, (e0, e1, marg) in zip(frames, timed):
        kinds["marginalizing" if bool(marg) else "other"].append((i, e0.elapsed_time(e1)))
    picked = {i for group in kinds.values() for i, _ in group[:profiled_per_kind]}
    profiled = {r["frame"]: r for r in chain(picked) if isinstance(r, dict)}
    out = {}
    for kind, group in kinds.items():
        ms = [x for _, x in group]
        out[kind] = {"frames": [i for i, _ in group], "event_ms": ms,
                     "mean_event_ms": float(np.mean(ms)) if ms else None,
                     "profiled": [profiled[i] for i, _ in group[:profiled_per_kind]]}
    return out


def graph_checks(dev, consts, static, inputs, truth, frames, gyrs, accs, mask) -> dict:
    """Phase 4c, the captured graphs (`graphs.py`) against the eager steps
    in this call: K1 and K2 read out of a graph replay against their twins
    on another frame's stack than the capture's; the fused frame's chain
    (phase 4's 16 frames, generator seed 0) eager and graphed in turns
    (E G G E), every frame's metrics and the final state bit for bit, on
    the kernel path and on the map front end with K4; the staged graphs
    and `ok_scan`'s replays from the chain's state after the warm-up
    against the fused eager frames; the overflow chunks' `integrate` graph
    against the eager `integrate_chunk`; the batched step of BATCH lanes
    graphed against eager over BATCH_FRAMES frames; one replay a fused
    frame, a batched step and an `ok_scan`, four a staged frame; each
    path's launches as replays x the graph's launches; each graph's
    capture and instantiate seconds, nodes and pool bytes; the device's
    busy share in graphed frames by the profiler. Returns the phase's
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, orb, sample
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.testing import seeded_state
    from pose_estimation_tpu_torch.utils.tree import tree_leaves

    def equal(a, b) -> bool:
        la, lb = tree_leaves(a), tree_leaves(b)
        return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))

    out = {}
    # K1 and K2 inside a graph: captured on frame 0's stack, replayed on
    # frame 1's, held to the twins on frame 1's
    ocfg, oc = static.orb, consts.orb
    budgets = orb.level_budgets(ocfg)

    def pair_stack(i):
        imgs = torch.stack([inputs[i][0], inputs[i][1]]).to(torch.float32)
        return orb.plane_stack(imgs, ocfg, oc)

    stack0, bounds = pair_stack(0)
    stack1, _ = pair_stack(1)
    sel_args = (bounds, ocfg.th_hi, ocfg.th_lo, orb.EDGE, ocfg.k_per_cell)

    def k1k2(st):
        sel = fast.fast_select(st, *sel_args)
        _, (gx, gy) = fast.plane_topk(sel[0], (sel[2], sel[3]),
                                      min(budgets[0], sel[0].shape[1]))
        xy_p = torch.stack([gx, gy], dim=-1)
        xy = torch.cat([xy_p[lvl * 2:(lvl + 1) * 2, :kb] for lvl, kb in enumerate(budgets)],
                       dim=1).contiguous()
        return sel, xy, sample.sample_patches(st, bounds, xy, budgets, oc.pool_xy)

    buf = stack0.clone()
    k1k2(stack0.clone())
    torch.cuda.synchronize()
    kstep = graphs.CapturedStep("k1k2", k1k2, (buf,), dev)
    kstep()
    buf.copy_(stack1)
    sel, xy, packed = kstep()
    twin = fast.select_plain(stack1, *sel_args)
    torch.cuda.synchronize()
    ok = twin[0] > -5e8
    if not (torch.equal(sel[0], twin[0]) and torch.equal(sel[1], twin[1])):
        fail("K1 in a graph replay: scores or codes differ from the twin")
    k1_err = max(float((sel[2] - twin[2])[ok].abs().max()),
                 float((sel[3] - twin[3])[ok].abs().max()))
    ref2 = sample.sample_stack_plain(stack1, bounds, xy, budgets, oc.pool_xy)
    n_pool = oc.pool_xy.shape[0]
    mom_err = float((packed[..., n_pool:] - ref2[..., n_pool:]).abs().max()
                    / ref2[..., n_pool:].abs().max())
    close = float(((packed[..., :n_pool] - ref2[..., :n_pool]).abs() <= K2_TOL_VAL)
                  .float().mean())
    if k1_err > K1_TOL_XY or mom_err > K2_TOL_MOM or close < K2_MIN_CLOSE:
        fail(f"K1/K2 in a graph replay: subpixel {k1_err:.3g} px, moments {mom_err:.3g} of "
             f"the largest, {close:.5f} of samples within {K2_TOL_VAL}")
    print(f"K1 and K2 in a graph replay (captured on frame 0's stack, replayed on frame 1's "
          f"[{tuple(stack1.shape)}]): K1 scores and codes bit-equal to the twin, subpixel "
          f"within {k1_err:.3g} px; K2 moments within {mom_err:.3g} of the largest, "
          f"{close:.5f} of samples within {K2_TOL_VAL}; graph "
          + graph_line("k1k2", {"replays": kstep.replays, "launches": kstep.launches,
                                **kstep.stats}))
    out["kernels_in_graph"] = {"k1_xy_err": k1_err, "k2_mom_err": mom_err, "k2_close": close}
    del buf, stack0, stack1, kstep

    def chain(st, label, runner=None):
        """N_FRAMES frames from the seeded window, the draws from seed 0:
        eager `ok_step` or the runner's replays. Returns (state after the
        warm-up, final state, each frame's metrics, ms a frame after the
        warm-up, launches)."""
        state = seeded_state(st, truth, dev)
        if runner is not None:
            runner.load_state(state)
        gen = torch.Generator(device=dev).manual_seed(0)
        metrics, start = [], None
        torch.cuda.synchronize()
        zero_counters()
        replays = REPLAYS["n"]
        t0 = time.perf_counter()
        for i in range(N_FRAMES):
            if i == WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start = graphs.snapshot(state if runner is None else runner.state)
            if runner is None:
                state, m = vio.ok_step(state, *inputs[i], gen, consts, st)
            else:
                u = vio.draw_ransac_uniforms(gen, dev)
                m = graphs.snapshot(runner.ok_step(*inputs[i], u))
                state = runner.state
            metrics.append(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (N_FRAMES - WARMUP)
        if runner is not None and REPLAYS["n"] - replays != N_FRAMES:
            fail(f"graphed ok_step chain ({label}): {REPLAYS['n'] - replays} replays in "
                 f"{N_FRAMES} frames (one a frame)")
        return start, graphs.snapshot(state), metrics, ms, counters()

    runs, runner = {}, None
    for turn, mode in enumerate(("eager", "graphed", "graphed", "eager")):
        if mode == "graphed" and runner is None:
            runner = graphs.FrameGraphs(seeded_state(static, truth, dev), consts, static, dev)
        runs.setdefault(mode, []).append(chain(static, mode, runner if mode == "graphed"
                                                else None))
    (start, e_state, e_m, e_ms, _), e2 = runs["eager"][0], runs["eager"][1]
    g1, g2 = runs["graphed"]
    same = [equal((e_state, e_m), (r[1], r[2])) for r in (e2, g1, g2)]
    print(f"graphed ok_step chain ({N_FRAMES} frames, kernel path, turns E G G E): "
          f"{e_ms:.2f}, {g1[3]:.2f}, {g2[3]:.2f}, {e2[3]:.2f} ms/frame over frames "
          f"{WARMUP}-{N_FRAMES - 1}; eager repeat, graphed runs "
          f"{'bit-equal' if all(same) else 'DIFFER: ' + str(same)} to the first eager run "
          f"(every frame's metrics and the final state); graphed launches {g1[4]} "
          f"(frame 0 also warms up), {g2[4]}")
    if not all(same):
        fail(f"graphed ok_step chain differs from the eager one (eager repeat, graphed "
             f"runs: {same})")
    # K1, K2 and the clip's K6 once a replayed frame, and once in the
    # warm-up of a new runner
    for r, n in ((g1, N_FRAMES + 1), (g2, N_FRAMES)):
        if (r[4]["fast_select"], r[4]["sample_patches"], r[4]["eigh"]) != (n, n, n) \
                or r[4]["fast_score_nms"] or r[4]["moment_maps"] or r[4]["svd"]:
            fail(f"graphed ok_step chain: launches {r[4]}, expected K1, K2 and K6's eigh "
                 f"{n} times")
    fused_stats = runner.stats()
    out["chain"] = {"ms_per_frame": {"eager": [e_ms, e2[3]], "graphed": [g1[3], g2[3]]},
                    "launches": g2[4], "graphs": fused_stats}
    for name, g in fused_stats.items():
        print("  graph " + graph_line(name, g))

    # the map front end with K4
    map_static = dataclasses.replace(static, orb=static.orb._replace(**MAP_FRONT))
    _, me_state, me_m, me_ms, _ = chain(map_static, "eager")
    map_runner = graphs.FrameGraphs(seeded_state(map_static, truth, dev), consts, map_static,
                                    dev)
    _, mg_state, mg_m, mg_ms, mg_l = chain(map_static, "graphed", map_runner)
    map_same = equal((me_state, me_m), (mg_state, mg_m))
    print(f"graphed ok_step chain, map front end (K1, K4): {me_ms:.2f} ms/frame eager, "
          f"{mg_ms:.2f} graphed; " + ("bit-equal" if map_same else "DIFFERS")
          + f"; graphed launches {mg_l}")
    if not map_same:
        fail("graphed ok_step chain on the map front end differs from the eager one")
    if (mg_l["fast_select"], mg_l["moment_maps"], mg_l["eigh"]) != (N_FRAMES + 1,) * 3 \
            or mg_l["sample_patches"] or mg_l["fast_score_nms"]:
        fail(f"graphed map front end: launches {mg_l}, expected K1, K4 and K6's eigh "
             f"{N_FRAMES + 1} times (the replays and the warm-up)")
    out["map_chain"] = {"ms_per_frame": {"eager": me_ms, "graphed": mg_ms}, "launches": mg_l,
                        "graphs": map_runner.stats()}
    del map_runner

    # the staged graphs from the warm-up's state, against the fused eager
    # frames with the same uniforms
    frames_s = list(range(WARMUP, N_FRAMES))
    ugen = torch.Generator(device=dev).manual_seed(1)
    us = [vio.draw_ransac_uniforms(ugen, dev) for _ in frames_s]
    ref, ref_m = start, []
    for u, i in zip(us, frames_s):
        ref, m = vio.ok_step(ref, *inputs[i], None, consts, static, ransac_u=u)
        ref_m.append(m)
    staged = graphs.FrameGraphs(start, consts, static, dev)
    zero_counters()
    st_m, st_replays = [], []
    with timed_stages(graphed=True) as timers:
        for u, i in zip(us, frames_s):
            before = REPLAYS["n"]
            st_m.append(graphs.snapshot(staged.staged_step(*inputs[i], u)))
            st_replays.append(REPLAYS["n"] - before)
    st_launches = counters()
    split = {k: timers.total[k] * 1e3 / max(timers.count[k], 1) for k in ("imu", "frontend", "ba",
                                                                   "pool")}
    staged_same = equal(ref, staged.state) and all(equal(a, b) for a, b in zip(ref_m, st_m))
    print(f"staged graphs ({len(frames_s)} frames from the chain's frame {WARMUP}, each stage "
          f"synchronized, the first frame's captures left out): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f" ms, sum {sum(split.values()):.2f}; state and metrics "
          + ("bit-equal to the fused eager frames" if staged_same else "DIFFER")
          + f"; launches {st_launches}")
    if not staged_same:
        fail("staged graphs differ from the fused eager frames")
    if any(n != 4 for n in st_replays):
        fail(f"staged graphs: replays per frame {st_replays} (four, one a stage)")
    if (st_launches["fast_select"], st_launches["sample_patches"]) != (len(frames_s) + 1,) * 2:
        fail(f"staged graphs: launches {st_launches}, expected K1 and K2 {len(frames_s) + 1} "
             "times (the replays and the warm-up)")
    staged_stats = staged.stats()
    for name, g in staged_stats.items():
        print("  graph " + graph_line(name, g))
    out["staged"] = {"stage_ms": split, "launches": st_launches, "graphs": staged_stats}

    # the overflow chunks' graph (`integrate`) on the staged runner's state,
    # against the eager `integrate_chunk` from the same state
    from pose_estimation_tpu_torch.imu import preintegration as pre

    base = graphs.snapshot(staged.state)
    ref_pre = base.preint
    for i in frames_s[:3]:
        ref_pre = pre.integrate_chunk(ref_pre, *inputs[i][2:5], base.bg, base.ba, consts.imu)
    before = REPLAYS["n"]
    for i in frames_s[:3]:
        staged.integrate(*inputs[i][2:5])
    int_replays = REPLAYS["n"] - before
    int_same = equal(ref_pre, staged.state.preint)
    int_stats = staged.stats()["integrate"]
    print("integrate graph (3 overflow chunks on the staged state): "
          + ("bit-equal to the eager integrate_chunk" if int_same else "DIFFERS")
          + "; graph " + graph_line("integrate", int_stats))
    if not int_same:
        fail("the integrate graph differs from the eager integrate_chunk")
    if int_replays != 3:
        fail(f"the integrate graph: {int_replays} replays in 3 chunks (one a chunk)")
    out["integrate"] = {"graph": int_stats}
    del staged

    # ok_scan as one graph of SCAN_FRAMES frames
    sel_f = frames_s[:SCAN_FRAMES]
    stacked = [torch.stack([inputs[i][k] for i in sel_f]) for k in range(5)]
    e_scan_state, e_outs = vio.ok_scan(start, *stacked,
                                       torch.Generator(device=dev).manual_seed(2), consts,
                                       static)
    runner.load_state(start)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    before = REPLAYS["n"]
    g_outs = runner.ok_scan(*stacked, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3 / SCAN_FRAMES
    scan_launches, scan_replays = counters(), REPLAYS["n"] - before
    scan_same = equal(e_scan_state, runner.state) and equal(e_outs, g_outs)
    t0 = time.perf_counter()
    runner.load_state(start)
    runner.ok_scan(*stacked, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    scan_replay_ms = (time.perf_counter() - t0) * 1e3 / SCAN_FRAMES
    print(f"ok_scan as one graph of {SCAN_FRAMES} frames: "
          + ("bit-equal to the eager ok_scan" if scan_same else "DIFFERS")
          + f"; {scan_replays} replay; {scan_ms:.2f} ms a frame with the warm-up and capture, "
          f"{scan_replay_ms:.2f} replayed; launches {scan_launches}; graph "
          + graph_line("scan", runner.stats()["scan"]))
    if not scan_same:
        fail("graphed ok_scan differs from the eager ok_scan")
    if scan_replays != 1 or (scan_launches["fast_select"], scan_launches["sample_patches"]) \
            != (2 * SCAN_FRAMES,) * 2:
        fail(f"graphed ok_scan: {scan_replays} replays, launches {scan_launches} in "
             f"{SCAN_FRAMES} frames (one replay; K1 and K2 once a frame in it and in the "
             "warm-up)")
    out["ok_scan"] = {"ms_per_frame": scan_ms, "replayed_ms_per_frame": scan_replay_ms,
                      "launches": scan_launches, "graph": runner.stats()["scan"]}
    nodes = {"imu": staged_stats["imu"]["nodes"], "frame": fused_stats["frame"]["nodes"],
             "integrate": int_stats["nodes"], "scan": runner.stats()["scan"]["nodes"]}
    print(f"graph nodes: imu {nodes['imu']}, frame {nodes['frame']}, integrate "
          f"{nodes['integrate']}, scan {nodes['scan']} ({SCAN_FRAMES} frames); staged ms, "
          "each stage synchronized: " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    out["graph_nodes"] = nodes

    # the device's busy share of graphed frames under the profiler (the
    # union of its kernels' intervals over the profiled frames' host time),
    # and unprofiled: the frame's graph replayed back to back, timed by CUDA
    # events, over the chained frame's host time
    runner.load_state(start)
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for i in frames_s[:4]:
            runner.ok_step(*inputs[i], vio.draw_ransac_uniforms(gen, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    act = device_activity(prof)
    replay_ms = {"frame": cuda_ms(runner.steps["frame"].graph.replay, reps=10, warm=2)}
    graphs_ms = sum(replay_ms.values())
    print(f"4 graphed frames under the profiler: {wall_ms / 4:.2f} ms a frame, "
          f"{act['events'] / 4:.0f} device events a frame, busy {act['busy_ms'] / 4:.3f} ms "
          f"a frame (union of their intervals; summed {act['summed_ms'] / 4:.3f}, first to "
          f"last {act['span_ms'] / 4:.3f}, record_function ranges {act['annotation_ms']:.3f} "
          f"in all): busy share {act['busy_ms'] / wall_ms:.4f} of the profiled frames; "
          f"unprofiled, the frame graph {replay_ms['frame']:.3f} device ms a replay (CUDA "
          f"events, back to back): {graphs_ms / g2[3]:.4f} of the chained graphed frame "
          f"({g2[3]:.2f} ms)")
    out.update(profiled_ms_per_frame=wall_ms / 4,
               device_events_per_frame=act["events"] / 4,
               device_busy_ms_per_frame=act["busy_ms"] / 4,
               device_summed_ms_per_frame=act["summed_ms"] / 4,
               busy_share_profiled=act["busy_ms"] / wall_ms, graph_replay_ms=replay_ms,
               graph_share_unprofiled=graphs_ms / g2[3])
    kinds = frames_by_kind(runner, start, inputs, frames_s, dev)
    for kind, k in kinds.items():
        print(f"graphed chain, {kind} frames {k['frames']}: event ms "
              + ", ".join(f"{x:.3f}" for x in k["event_ms"])
              + (f" (mean {k['mean_event_ms']:.3f})" if k["event_ms"] else "")
              + "; profiled alone: "
              + ("; ".join(f"frame {r['frame']} busy {r['busy_ms']:.3f} device ms, K6 clip "
                           f"{r['clip_device_ms']:.4f} in {r['clip_launches']} launch"
                           for r in k["profiled"]) or "none"))
        if any(r["clip_launches"] != 1 for r in k["profiled"]):
            fail(f"graphed chain, {kind} frames: K6's clip not once a replay: {k['profiled']}")
    out["frames_by_kind"] = kinds

    # the batched step, B = BATCH: eager against graphed
    lanes = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
             for i in range(BATCH + BATCH_FRAMES)]
    b_runs = {}
    for mode in ("eager", "graphed"):
        state = batched.stack_states([seeded_state(static, truth, dev, j)
                                      for j in range(BATCH)])
        gens = [torch.Generator(device=dev).manual_seed(100 + j) for j in range(BATCH)]
        step = (batched.make_batched_step(consts, static) if mode == "eager"
                else graphs.BatchedGraphs(state, consts, static, dev).step)
        bg = getattr(step, "__self__", None)
        ms_t, mets = [], []
        zero_counters()
        replays = REPLAYS["n"]
        for i in range(BATCH_FRAMES):
            u = torch.stack([torch.stack(vio.draw_ransac_uniforms(g, dev)) for g in gens])
            lane_in = [torch.stack(parts) for parts in zip(*(lanes[j + i]
                                                             for j in range(BATCH)))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if bg is None:
                state, m = step(state, *lane_in, u)
            else:
                m = graphs.snapshot(step(*lane_in, u))
                state = bg.state
            torch.cuda.synchronize()
            ms_t.append((time.perf_counter() - t0) * 1e3)
            mets.append(m)
        if bg is not None and REPLAYS["n"] - replays != BATCH_FRAMES:
            fail(f"graphed batched step: {REPLAYS['n'] - replays} replays in {BATCH_FRAMES} "
                 "steps (one a step)")
        b_runs[mode] = (graphs.snapshot(state), mets, float(np.mean(ms_t[2:])), counters(),
                        bg.stats() if bg is not None else None)
    (es, em, ems, _, _), (gs, gm, gms, gl, gstats) = b_runs["eager"], b_runs["graphed"]
    b_same = equal((es, em), (gs, gm))
    print(f"batched step, B = {BATCH}, {BATCH_FRAMES} frames: {ems:.2f} ms a step eager, "
          f"{gms:.2f} graphed ({BATCH / gms * 1e3:.2f} frames/s), over frames 2-"
          f"{BATCH_FRAMES - 1}; " + ("bit-equal" if b_same else "DIFFERS")
          + f"; graphed launches {gl}; graphs "
          + "; ".join(graph_line(n, g) for n, g in gstats.items()))
    if not b_same:
        fail("graphed batched step differs from the eager one")
    if (gl["fast_select"], gl["sample_patches"], gl["eigh"]) != (BATCH_FRAMES + 1,) * 3:
        fail(f"graphed batched step: launches {gl}, expected K1, K2 and K6's eigh "
             f"{BATCH_FRAMES + 1} times (one extraction and one clip a step, and the warm-up)")
    out["batched"] = {"ms_per_step": {"eager": ems, "graphed": gms}, "launches": gl,
                      "graphs": gstats}
    return out


def mesh_checks(dev) -> dict:
    """Phase 11: the sharded pool match's packed reduction on the card
    against the unsharded `match`, index for index (2 and 4 shards, ties
    across the blocks' borders), then the multi-process dry run (see
    MESH_RANKS). Returns the phase's numbers."""
    import torch

    from pose_estimation_tpu_torch.ops import matching
    from pose_estimation_tpu_torch.parallel import multihost

    gen = torch.Generator(device=dev).manual_seed(0)

    def desc(n):
        return matching.pack_descriptors(torch.rand((n, 256), generator=gen, device=dev) < 0.5)

    train, query = desc(1024), desc(256)
    train[356] = train[612] = train[100]      # other blocks at 2 and at 4 shards
    query[::3] = train[100]
    train_mask = torch.rand(1024, generator=gen, device=dev) < 0.6
    train_mask[[100, 356, 612]] = True
    query_mask = torch.ones(256, dtype=torch.bool, device=dev)
    ref = matching.match(query, train, query_mask, train_mask, 3.0, 40.0)
    for shards in (2, 4):
        keys = [matching.shard_nearest(query, train, train_mask, i, shards)
                for i in range(shards)]
        idx, d = matching.unpack_nearest(matching.reduce_nearest(keys), 1024)
        got = matching.gate(idx, d, query_mask, 3.0, 40.0)
        if not (torch.equal(idx, ref.index) and torch.equal(d, ref.dist)
                and torch.equal(got.valid, ref.valid)):
            fail(f"packed reduction over {shards} shards differs from the unsharded match "
                 "on the card")
    if not bool((ref.index[::3] == 100).all()):
        fail("unsharded match: ties did not go to the lowest slot")
    print("sharded pool match: the packed reduction over 2 and 4 shards equals the "
          "unsharded match on the card, index for index (ties across the blocks' borders "
          "to the lowest slot)")

    t0 = time.perf_counter()
    results = multihost.dryrun(
        MESH_RANKS, model=MESH_MODEL, device="cuda", backend="gloo",
        config=("synthetic_config", dict(width=752, height=480, levels=8, features=800)),
        lanes=MESH_LANES, n_landmarks=1200, warmup=MESH_WARMUP, timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for r in results:
        if (r["launches"]["fast_select"], r["launches"]["sample_patches"]) != (1, 1):
            fail(f"mesh rank {r['rank']}: launches {r['launches']} in its batched step")
        if not all(min(b) > 0 for b in r["pool_blocks"]):
            fail(f"mesh rank {r['rank']}: a model rank's block holds no valid slot "
                 f"({r['pool_blocks']}): the reduction decides nothing")
        print(f"mesh rank {r['rank']} (data {r['data_index']}, model {r['model_index']}, "
              f"{r['backend']} on {r['device']}): lanes {r['lanes']}, tracked "
              f"{r['n_tracked']}, BA iterations {r['ba_iters']}, valid slots per block "
              f"{r['pool_blocks']}; step {r['step_ms']:.2f} ms; largest state difference "
              f"from the single-process step {r['state_max_diff']:.3g}; launches "
              f"{r['launches']}")
    print(f"mesh dry run: {MESH_RANKS} ranks ({MESH_RANKS // MESH_MODEL} x {MESH_MODEL}) at "
          f"752x480, {wall:.1f} s")
    return {"ranks": MESH_RANKS, "model": MESH_MODEL, "wall_s": wall,
            "step_ms": [r["step_ms"] for r in results],
            "state_max_diff": max(r["state_max_diff"] for r in results),
            "launches": {k: sum(r["launches"][k] for r in results)
                         for k in results[0]["launches"]}}


# The map-based front end, selected as the JAX package selects it: on the
# static configuration after construction. Detection stays on K1 or K3.
MAP_FRONT = dict(sample_backend="xla", moments_backend="pallas")


# the host work that the state machine runs beside an OK frame's step, by
# the method that runs it, and the mark that a frame's record gets for it
FRAME_EVENTS = {"_health_check": "H", "_refine_gravity": "G", "_warm_recover": "W",
                "_reinitialize": "R", "_relocalize": "L", "_integrate": "I"}


def observe_ok_frames(slam, frames, profile=None, on_frame=None):
    """Record each OK frame that `slam` processes into `frames`: the host ms
    of its `process` call (to a synchronize), the kernel launches it ran
    (graph replays included; the first graphed frame also warms its graphs
    up), the CUDA graphs it replayed, and the stereo pairs they extracted,
    the marks (`FRAME_EVENTS`,
    sorted) of the host work it ran beside the step, and its metrics
    (snapshot copies, as `_record` keeps them). `profile(frames)`, where
    given, says whether to run the frame under `torch.profiler`, whose
    CUDA kernel count is then recorded as `device_kernels` and its ms left
    out; `on_frame(record)` may add to each record."""
    import torch
    from torch.profiler import ProfilerActivity

    from pose_estimation_tpu_torch.slam import State

    process, record, last, ran = slam.process, slam._record, {}, set()

    def observed_record(ts, metrics=None):
        last["metrics"] = metrics
        return record(ts, metrics)

    def marked(mark, fn):
        def run(*args, **kwargs):
            ran.add(mark)
            return fn(*args, **kwargs)
        return run

    def observed_process(img_l, img_r, ts):
        ok, count = slam.state == State.OK, slam._frame_count
        before, replays = counters(), REPLAYS["n"]
        ran.clear()
        wanted = bool(ok and profile is not None and profile(frames))
        t0 = time.perf_counter()
        if wanted:
            with torch.profiler.profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = process(img_l, img_r, ts)
                torch.cuda.synchronize()
            kernels = device_activity(prof)["events"]
        else:
            out = process(img_l, img_r, ts)
            getattr(torch, slam.device.type).synchronize()
            kernels = None
        if ok and slam._frame_count > count:
            launches = {k: v - before[k] for k, v in counters().items()}
            frame = {"launches": launches, "extractions": extractions(launches),
                     "replays": REPLAYS["n"] - replays,
                     "events": "".join(sorted(ran)), "metrics": last.get("metrics"),
                     "device_kernels": kernels}
            if kernels is None:
                frame["ms"] = (time.perf_counter() - t0) * 1e3
            if on_frame is not None:
                on_frame(frame)
            frames.append(frame)
        return out

    for name, mark in FRAME_EVENTS.items():
        setattr(slam, name, marked(mark, getattr(slam, name)))
    slam.process, slam._record = observed_process, observed_record


def frame_times(frames) -> dict:
    """The host ms of observed OK frames (`observe_ok_frames`; profiled
    frames left out): the first OK frame's (in a graphed run its graphs'
    warm-up and captures), the mean and median of the later ones, and the
    later ones grouped by their marks ("" = the step alone): per group the
    frames, their mean and, for marked groups, each frame's index and
    ms."""
    later = [(i, f["ms"]) for i, f in enumerate(frames) if i > 0 and "ms" in f]
    ms = [m for _, m in later]
    groups = {}
    for i, m in later:
        groups.setdefault(frames[i]["events"], []).append((i, m))
    return {"first_ms": frames[0].get("ms") if frames else None,
            "mean_ms": float(np.mean(ms)) if ms else None,
            "median_ms": float(np.median(ms)) if ms else None,
            "by_events": {k: {"frames": len(v), "mean_ms": float(np.mean([m for _, m in v])),
                              "sum_ms": float(np.sum([m for _, m in v])),
                              **({"ms": [[i, m] for i, m in v]} if k else {})}
                          for k, v in sorted(groups.items())}}


def frame_times_line(t) -> str:
    """`frame_times` in one line."""
    def group(k, g):
        name = k or "step alone"
        each = ("" if not k else " [" + ", ".join(f"#{i} {m:.2f}" for i, m in g["ms"]) + "]")
        return f"{name}: {g['frames']} frames, mean {g['mean_ms']:.2f}{each}"

    first = "n/a" if t["first_ms"] is None else f"{t['first_ms']:.2f}"
    if t["mean_ms"] is None:
        return f"first OK frame {first} ms; no later frame timed"
    return (f"first OK frame {first} ms; later frames mean {t['mean_ms']:.2f}, median "
            f"{t['median_ms']:.2f}; by host work beside the step (H health check, G gravity "
            f"refinement, W warm recovery, R reinit, L relocalization, I overflow IMU "
            f"chunks): " + "; ".join(group(k, g) for k, g in t["by_events"].items()))


def run_state_machine(cfg, world, duration, imu_seed, seed, dev, orb_replace=None,
                      graphed=True):
    """Replay `world` through the port's VisualInertialSLAM(seed=seed,
    graphed=graphed) on the card, with `orb_replace` applied to its static
    ORB configuration. Returns (slam, ground truth, per-OK-frame records
    (`observe_ok_frames`), stereo pairs extracted)."""
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM
    from pose_estimation_tpu_torch.testing import PROTOCOL_IMU_NOISE

    slam = VisualInertialSLAM(cfg, seed=seed, device=dev, graphed=graphed)
    if orb_replace:
        slam.static = dataclasses.replace(slam.static,
                                          orb=slam.static.orb._replace(**orb_replace))
    frames = []
    before = extractions(counters())
    observe_ok_frames(slam, frames)
    gt = world.run(slam, duration=duration, imu_noise=PROTOCOL_IMU_NOISE, seed=imu_seed)
    return slam, gt, frames, extractions(counters()) - before


def protocol_worker(job):
    """One run of the state machine in a worker process: (run, seed of the
    draws, device, front end) -> its record, checked by the caller. `run`
    names a world of the accuracy protocol, "A2-p3p": world A2 with the
    P3P bootstrap, or "KITTI-dense": the KITTI-width rig with the frames
    remapped before detection. The front end is "kernel" or "map". A run
    that raises returns its traceback under "error", so that the other
    runs are still checked and the failure is printed whole."""
    try:
        return protocol_run(job)
    except Exception:
        run, seed, _, front = job
        return {"run": run, "seed": seed, "front": front, "error": traceback.format_exc()}


def protocol_run(job):
    """`protocol_worker`'s run, which may raise."""
    import torch

    from pose_estimation_tpu_torch.testing import (StereoInertialSim, protocol_world,
                                                   run_errors, within_gates)

    run, seed, device, front = job
    if run == "KITTI-dense":
        cfg = kitti_config(rectify_mode="dense")
        world, duration, imu_seed = StereoInertialSim(cfg, n_landmarks=150, seed=0), 6.0, 10
    elif run == "A2-p3p":       # world A2 with the P3P bootstrap (solve_pnp=2)
        cfg, world, duration, imu_seed = protocol_world("A2")
        cfg = dataclasses.replace(cfg, solve_pnp=2)
    else:
        cfg, world, duration, imu_seed = protocol_world(run)
    t0 = time.perf_counter()
    zero_counters()
    slam, gt, frames, extractions = run_state_machine(
        cfg, world, duration, imu_seed, seed, torch.device(device),
        MAP_FRONT if front == "map" else None)
    launches = counters()
    e = run_errors(slam, gt)
    return {"run": run, "seed": seed, "front": front, "extractions": extractions,
            "state": slam.state.name, "ate_pct": e["ate_pct"],
            "ba": e["ba"], "bg": e["bg"], "pass": slam.state.name == "OK" and within_gates(e),
            "finite": bool(np.isfinite(slam.trajectory).all()),
            "worst_err_m": float(e["err"].max()),
            "over_divergence_m": float((e["err"] - DIVERGED_PER_M * e["dist"]).max()),
            "ok_frames": len(frames),
            "ms_per_ok_frame": float(np.mean([f["ms"] for f in frames if "ms" in f]))
            if frames else None,
            "launches": launches, "seconds": time.perf_counter() - t0}


def min_passes(n: int, passes: int, trials: int, alpha: float) -> int:
    """The fewest passes of `n` runs that are not too few at the measured
    rate passes/trials: the smallest k whose binomial lower tail
    P(X <= k) reaches `alpha`."""
    p = passes / trials
    tail = 0.0
    for k in range(n + 1):
        tail += math.comb(n, k) * p ** k * (1.0 - p) ** (n - k)
        if tail >= alpha:
            return k
    return n


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels named `kernel` per call of fn(), in
    ms: their summed durations under torch.profiler over `reps` calls, the
    host gaps between launches left out. A session that records no such
    kernel is profiled once more (and counted in PROFILE_MISSES); a second
    miss fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        hits = [e for e in events if kernel in e.name]
        if hits:
            return sum(e.device_time for e in hits) / 1e3 / reps
        PROFILE_MISSES.append(kernel)
        print(f"note: profiler session {session} recorded no kernel named {kernel} "
              f"({len(events)} device events)")
    fail(f"the profiler saw no kernel named {kernel} in two sessions")


def check_select(select_args, label):
    """K1 against its twin on the card: scores and codes bit-equal,
    subpixel x, y within K1_TOL_XY on the valid slots. Returns (outputs,
    valid slots, largest subpixel error)."""
    import torch

    from pose_estimation_tpu_torch.ops import fast

    out, twin = fast.fast_select(*select_args), fast.select_plain(*select_args)
    torch.cuda.synchronize()
    ok = twin[0] > -5e8
    if not (torch.equal(out[0], twin[0]) and torch.equal(out[1], twin[1])):
        fail(f"fast_select ({label}): scores or codes differ from the twin")
    xy_err = max(float((out[2] - twin[2])[ok].abs().max()),
                 float((out[3] - twin[3])[ok].abs().max()))
    if xy_err > K1_TOL_XY:
        fail(f"fast_select ({label}): subpixel error {xy_err} > {K1_TOL_XY}")
    return out, ok, xy_err


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b| of its plane, worst plane."""
    scale = b.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    return float(((a - b).abs() / scale).max())


def kernel_result(err, ms, dev_ms, plain_ms, bound_ms_by, lib_ms=None, **extra) -> dict:
    """One kernel's record: its largest error against the twin, event and
    device ms, the twin's ms, the bound (ms, "bytes" or "operations"), the
    library call's ms or None, and any further fields."""
    return dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound=bound_ms_by[0],
                by=bound_ms_by[1], lib_ms=lib_ms, **extra)


def check_sample(name, st, bnds, kp, bud, pool_xy) -> dict:
    """K2 against its all-levels twin on the plane stack `st` at the
    keypoints `kp` of `orb.detect`: moments within K2_TOL_MOM of each
    level's largest, at least K2_MIN_CLOSE of the samples within
    K2_TOL_VAL. Returns its kernel_result (timed)."""
    import torch

    from pose_estimation_tpu_torch.ops import sample

    n_pool = pool_xy.shape[0]
    n_circle = sum(1 for dy in range(-sample.PATCH_R, sample.PATCH_R + 1)
                   for dx in range(-sample.PATCH_R, sample.PATCH_R + 1)
                   if dx * dx + dy * dy <= sample.PATCH_R ** 2)
    b = st.shape[0] // len(bud)
    xy = torch.cat([kp.xy[lvl * b:(lvl + 1) * b, :kb] for lvl, kb in enumerate(bud)],
                   dim=1).contiguous()
    k2args = (st, bnds, xy, bud, pool_xy)
    got2 = sample.sample_patches(*k2args)
    ref2 = sample.sample_stack_plain(*k2args)
    torch.cuda.synchronize()
    off = sample.level_offsets(bud)
    close = []
    for lvl in range(len(bud)):
        g, rr = got2[:, off[lvl]:off[lvl + 1]], ref2[:, off[lvl]:off[lvl + 1]]
        scale = float(rr[..., n_pool:].abs().max())
        mom_err = float((g[..., n_pool:] - rr[..., n_pool:]).abs().max())
        if mom_err > K2_TOL_MOM * scale:
            fail(f"sample_patches ({name}, level {lvl}): moment error {mom_err} > "
                 f"{K2_TOL_MOM} x {scale}")
        close.append(float(((g[..., :n_pool] - rr[..., :n_pool]).abs()
                            <= K2_TOL_VAL).float().mean()))
    if min(close) < K2_MIN_CLOSE:
        fail(f"sample_patches ({name}): only {min(close):.5f} of samples within {K2_TOL_VAL}")
    n_kp = xy.shape[0] * xy.shape[1]
    # bytes: each plane's content read once (not the stack's padding), each
    # keypoint and pool point read once, the [K, P + 2] outputs written
    # once; instructions per keypoint: the moments (2 multiply-adds per
    # pixel of the radius-15 circle) and per pool point the 7 x 7 blur as
    # 49 + 7 multiply-adds, the rotation (4 multiplies, 2 adds), its
    # rounding (2) and clamps (4)
    k2_bytes = (sum(lh * lw for lh, lw in bnds) * 4 + n_kp * (8 + 4 * (n_pool + 2))
                + n_pool * 8)
    r = kernel_result(
        float((got2[..., :n_pool] - ref2[..., :n_pool]).abs().max()),
        cuda_ms(lambda: sample.sample_patches(*k2args)),
        device_ms(lambda: sample.sample_patches(*k2args), "sample_patches_kernel"),
        cuda_ms(lambda: sample.sample_stack_plain(*k2args), reps=5, warm=1),
        bound(k2_bytes, n_kp * (2 * n_circle + n_pool * (56 + 6 + 2 + 4))),
        keypoints=n_kp, min_close=min(close))
    print(f"K2 sample_patches [{tuple(st.shape)}] ({name}), {n_kp} keypoints over {len(bud)} "
          f"levels, one launch: moments within {K2_TOL_MOM} rel, min share of samples "
          f"within {K2_TOL_VAL}: {min(close):.5f}, max |dv| {r['err']:.3g}; kernel "
          f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound']:.4f} ms ({r['by']})")
    return r


def k6_inputs(dev, label, b, n, dtype):
    """Seeded inputs of K6's eigh at one path's shape: the PnP solvers'
    normal matrices M^T M of 12 rows (DLT, EPnP) and point covariances
    (EPnP's axes) in float32; Schur complements of an information matrix
    (rank 30 of 45, its blocks scaled over three decades) with a small
    indefinite part, as float32 rounding leaves them, in float64; for
    "clip_identity" the Schur complement of the identity, as the frame step
    builds it when it marginalizes nothing."""
    import torch

    from pose_estimation_tpu_torch.backend import ba as ba_mod

    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, label)))
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    if label == "clip_identity":
        wsize = n // 15 + 1
        eye = torch.eye(15 * wsize, dtype=torch.float32, device=dev)
        a = ba_mod.marg_schur(eye, wsize).expand(b, n, n).double()
    elif label.startswith("clip"):
        x = randn(b, n, 30) * torch.logspace(0, 3, n, device=dev, dtype=torch.float64)[:, None]
        e = randn(b, n, n)
        a = x @ x.transpose(-1, -2) + 1e-3 * (e + e.transpose(-1, -2))
    elif label == "epnp_axes":
        c = randn(b, 6, 3)
        c = c - c.mean(dim=1, keepdim=True)
        a = c.transpose(-1, -2) @ c / 6
    else:
        m = randn(b, 12, n)
        a = m.transpose(-1, -2) @ m
    return a.to(dt)


def dlt_null_check(dev, b=512) -> dict:
    """K6's smallest eigenvector of DLT normal matrices (`ops/pnp.py`'s
    [512, 12, 12] float32) against float64 `torch.linalg.eigh` of the same
    matrices, as the Davis-Kahan ratio sin(angle) (l2 - l1) / (eps32
    ||A||_2); the twin's beside it."""
    import torch

    from pose_estimation_tpu_torch.ops import small_linalg
    from pose_estimation_tpu_torch.utils import lie

    gen = torch.Generator(device=dev).manual_seed(12)

    def uni(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

    x = torch.stack([uni(-3, 3, b, 6), uni(-4, 4, b, 6), uni(2.5, 11, b, 6)], dim=-1)
    r = lie.so3_exp(0.02 * torch.randn((b, 3), generator=gen, device=dev, dtype=torch.float64))
    t = 0.06 * torch.randn((b, 3), generator=gen, device=dev, dtype=torch.float64)
    xc = torch.einsum("bij,bmj->bmi", r, x) + t[:, None]
    uv = xc[..., :2] / xc[..., 2:] + 1e-3 * torch.randn((b, 6, 2), generator=gen, device=dev,
                                                          dtype=torch.float64)
    xh = torch.cat([x, torch.ones_like(x[..., :1])], -1)
    zero = torch.zeros_like(xh)
    rows = torch.cat([torch.cat([xh, zero, -uv[..., :1] * xh], -1),
                      torch.cat([zero, xh, -uv[..., 1:] * xh], -1)], 1).float()
    a = torch.einsum("bij,bik->bjk", rows, rows)
    w64, v64 = torch.linalg.eigh(a.double())
    gap = (w64[:, 1] - w64[:, 0]) / (torch.finfo(torch.float32).eps * w64[:, -1])

    def ratio(v):
        c = (v[..., 0].double() * v64[..., 0]).sum(-1).abs() / v[..., 0].double().norm(dim=-1)
        return torch.sqrt(torch.clamp(1 - c * c, min=0.0)) * gap

    got = ratio(small_linalg.eigh(a)[1])
    twin = ratio(small_linalg.eigh_plain(a)[1])
    rec = {"shape": [b, 12, 12], "kernel_median": float(got.median()),
           "kernel_max": float(got.max()), "twin_median": float(twin.median()),
           "twin_max": float(twin.max())}
    print(f"K6 eigh DLT null vector [{b}, 12, 12] float32 against float64: sin(angle) x gap / "
          f"(eps ||A||) median {rec['kernel_median']:.3g}, max {rec['kernel_max']:.3g} (twin "
          f"{rec['twin_median']:.3g}, {rec['twin_max']:.3g}; bound {K6_NULL_TOL})")
    if not rec["kernel_max"] <= K6_NULL_TOL:
        fail(f"K6 eigh DLT null vector: {rec} beyond {K6_NULL_TOL}")
    return rec


def rec_us_per_round(rounds, dev_ms):
    """Device us a Jacobi round of the slowest matrix of a launch, or None
    when it took no round."""
    return dev_ms * 1e3 / max(rounds) if max(rounds) else None


def k6_checks(dev) -> dict:
    """Phase 3b: K6 (`ops/small_linalg.py`) against its twin on the card at
    every shape of its paths (`K6_EIGH_SHAPES`, and the proper rotations'
    [512, 3, 3] SVD of rank 3 and rank 2): eigenvalues, the residual and
    orthogonality, the PSD clip in float64, the SVD's reconstruction; each
    timed by CUDA events and the profiler's device time beside the twin
    and the library call (`torch.linalg.eigh` / `svd`, eager), with its
    bound; the clip's Jacobi rounds (`small_linalg.eigh_rounds`, a launch
    of its own) and device us a round of the slowest matrix. Returns
    {"eigh": {shape label: record}, "svd": record}."""
    import torch

    from pose_estimation_tpu_torch.ops import small_linalg

    res = {"eigh": {}}
    for label, b, n, dtype in K6_EIGH_SHAPES:
        a = k6_inputs(dev, label, b, n, dtype)
        graded = not label.startswith("clip")
        w, v = small_linalg.eigh(a, graded=graded)
        pw, pv = small_linalg.eigh_plain(a)
        torch.cuda.synchronize()
        a64, w64, v64 = a.double(), w.double(), v.double()
        norm = torch.linalg.matrix_norm(a64)
        w_err = float(((w64 - pw.double()).abs().amax(-1) / norm).max())
        resid = float((torch.linalg.matrix_norm(a64 @ v64 - v64 * w64[:, None, :]) / norm).max())
        orth = float((v64.transpose(-1, -2) @ v64
                      - torch.eye(n, dtype=torch.float64, device=dev)).abs().max())
        rec = {"shape": [b, n, n], "dtype": dtype, "w_err_rel": w_err, "residual_rel": resid,
               "orth_err": orth}
        if not (w_err <= K6_TOL[dtype] and resid <= K6_RES_TOL[dtype]
                and orth <= K6_RES_TOL[dtype]):
            fail(f"K6 eigh {label} {rec}: beyond {K6_TOL[dtype]} (eigenvalues) or "
                 f"{K6_RES_TOL[dtype]} (residual, orthogonality)")
        if label.startswith("clip"):
            def clip(ww, vv):
                return (vv * ww.clamp(min=0.0)[..., None, :]) @ vv.transpose(-1, -2)

            clip_err = float((torch.linalg.matrix_norm(clip(w, v) - clip(pw, pv)) / norm).max())
            rec["clip_err_rel"] = clip_err
            if not clip_err <= 1e-12:
                fail(f"K6 eigh {label}: the clip {clip_err:.3g} x ||S|| from the twin's")
        es = a.element_size()
        rounds = small_linalg.eigh_rounds(a, graded=graded)[2].tolist()
        rec.update(
            ms=cuda_ms(lambda: small_linalg.eigh(a, graded=graded)),
            device_ms=device_ms(lambda: small_linalg.eigh(a, graded=graded), "eigh_kernel"),
            plain_ms=cuda_ms(lambda: small_linalg.eigh_plain(a), reps=5, warm=1),
            lib_ms=cuda_ms(lambda: torch.linalg.eigh(a), reps=5, warm=1),
            rounds_max=max(rounds), sweeps_max=max(rounds) / (n + (n & 1) - 1))
        rec["us_per_round"] = rec_us_per_round(rounds, rec["device_ms"])
        # a diagonal input needs no rotation: the work its data needs is the
        # sort's n compares a column
        instr = b * n * n if label == "clip_identity" else b * eigh_instr(n)
        rec["bound"], rec["by"] = bound(b * (2 * n * n + n) * es, instr,
                                        FP64_INSTR_PER_S if dtype == "float64"
                                        else FP32_INSTR_PER_S)
        print(f"K6 eigh {label} [{b}, {n}, {n}] {dtype}: eigenvalues within {w_err:.3g} x "
              f"||A|| of the twin, residual {resid:.3g} x ||A||, ||V^T V - I|| {orth:.3g}"
              + (f", clip {rec['clip_err_rel']:.3g} x ||S||" if "clip_err_rel" in rec else "")
              + f"; {rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), twin "
              f"{rec['plain_ms']:.4f}, torch.linalg.eigh {rec['lib_ms']:.4f}, bound "
              f"{rec['bound']:.6f} ({rec['by']}); rounds, slowest matrix {rec['rounds_max']} "
              f"({rec['sweeps_max']:.2f} sweeps)"
              + (f", {rec['us_per_round']:.3f} device us a round" if rec["us_per_round"]
                 else ""))
        res["eigh"][label] = rec
    res["dlt_null"] = dlt_null_check(dev)

    gen = torch.Generator(device=dev).manual_seed(6)
    full = torch.randn((256, 3, 3), generator=gen, device=dev)
    low = (torch.randn((256, 3, 2), generator=gen, device=dev)
           @ torch.randn((256, 2, 3), generator=gen, device=dev))
    a = torch.cat([full, low])                          # [512, 3, 3]: rank 3 and rank 2
    u, sv, vh = small_linalg.svd(a)
    pu, ps, pvh = small_linalg.svd_plain(a)
    torch.cuda.synchronize()
    a64 = a.double()
    norm = torch.linalg.matrix_norm(a64)
    rec_err = float((torch.linalg.matrix_norm((u.double() * sv.double()[..., None, :])
                                              @ vh.double() - a64) / norm).max())
    s_err = float(((sv.double() - ps.double()).abs().amax(-1) / norm).max())
    eye = torch.eye(3, dtype=torch.float64, device=dev)
    orth = max(float((x.double().transpose(-1, -2) @ x.double() - eye).abs().max())
               for x in (u, vh.transpose(-1, -2)))
    rec = {"shape": [512, 3, 3], "dtype": "float32", "reconstruction_rel": rec_err,
           "s_err_rel": s_err, "orth_err": orth}
    if not (rec_err <= K6_TOL["float32"] and s_err <= K6_TOL["float32"]
            and orth <= K6_RES_TOL["float32"]):
        fail(f"K6 svd {rec}: beyond {K6_TOL['float32']} or {K6_RES_TOL['float32']}")
    rec.update(ms=cuda_ms(lambda: small_linalg.svd(a)),
               device_ms=device_ms(lambda: small_linalg.svd(a), "svd3_kernel"),
               plain_ms=cuda_ms(lambda: small_linalg.svd_plain(a), reps=5, warm=1),
               lib_ms=cuda_ms(lambda: torch.linalg.svd(a), reps=5, warm=1))
    rec["bound"], rec["by"] = bound(512 * (9 + 9 + 3 + 9) * 4, 512 * SVD3_INSTR)
    print(f"K6 svd [512, 3, 3] float32 (rank 3 and rank 2): ||U S Vh - A|| {rec_err:.3g} x "
          f"||A||, S within {s_err:.3g} x ||A|| of the twin, orthogonality {orth:.3g}; "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), twin {rec['plain_ms']:.4f}, "
          f"torch.linalg.svd {rec['lib_ms']:.4f}, bound {rec['bound']:.6f} ({rec['by']})")
    res["svd"] = rec
    return res


def keyframe_chain(consts, k, dev, seed=0):
    """(R [K, 3, 3], p [K, 3], ics [K-1]) of small random motions and random
    IMU chunks on the card, for the solves' sync check."""
    import torch

    from pose_estimation_tpu_torch.imu import preintegration as pre
    from pose_estimation_tpu_torch.utils import lie

    g = torch.Generator(device=dev).manual_seed(seed)
    zero3 = torch.zeros(3, device=dev)
    grav = torch.zeros(3, device=dev)
    grav[2] = 9.81
    ics = []
    for _ in range(k - 1):
        gyr = 0.1 * torch.randn((20, 3), generator=g, device=dev)
        acc = grav + 0.5 * torch.randn((20, 3), generator=g, device=dev)
        st = pre.integrate_chunk(pre.init_state(dev), gyr, acc,
                                 torch.ones(20, dtype=torch.bool, device=dev), zero3, zero3,
                                 consts.imu)
        ics.append(pre.finalize(st, zero3, zero3, consts.imu))
    R = lie.so3_exp(0.05 * torch.randn((k, 3), generator=g, device=dev))
    p = torch.cumsum(0.1 * torch.randn((k, 3), generator=g, device=dev), dim=0)
    return R, p, pre.ImuConstraint(*(torch.stack(a) for a in zip(*ics)))


def sync_checks(dev, cfg, consts, static, inputs, truth) -> dict:
    """Phase 3c: the eager `ok_step`, `sfm_step` (DLT, EPnP, P3P),
    `bootstrap_frame`, `full_init` and `refine_gravity` (routine and warm)
    once each under `torch.cuda.set_sync_debug_mode("error")`, after a
    warm-up call and with their uniforms drawn before: an operation that
    waits for the card raises, naming itself. Returns each call's seconds."""
    import torch

    from pose_estimation_tpu_torch.backend import init_solvers
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.testing import seeded_state

    gen = torch.Generator(device=dev).manual_seed(7)
    state = seeded_state(static, truth, dev)
    img_l, img_r, gyr, acc, mask = inputs[1]
    ref, _ = vio.extract_rectified(inputs[0][0], inputs[0][1], consts, static)
    prof = cfg.profile
    unit_g = torch.tensor(prof.gravity_dir, dtype=torch.float32, device=dev)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32, device=dev)
    R, p, ics = keyframe_chain(consts, 6, dev)

    def sfm(solver):
        st = dataclasses.replace(static, pnp_solver=solver)
        return (lambda: vio.draw_sfm_uniforms(gen, dev, solver),
                lambda u: vio.sfm_step(img_l, img_r, ref.desc, ref.xy, ref.valid, u, consts, st))

    def none():
        return None

    calls = {
        "ok_step": (lambda: vio.draw_ransac_uniforms(gen, dev),
                    lambda u: vio.ok_step(state, img_l, img_r, gyr, acc, mask, None, consts,
                                          static, ransac_u=u)),
        **{f"sfm_step.{solver}": sfm(solver) for solver in ("dlt", "epnp", "p3p")},
        "bootstrap_frame": (lambda: vio.draw_ransac_uniforms(gen, dev),
                            lambda u: vio.bootstrap_frame(state, img_l, img_r, u, consts,
                                                          static)),
        "full_init": (none, lambda _: init_solvers.full_init(R, p, ics, unit_g,
                                                             prof.alignment_axes, gravity)),
        "refine_gravity": (none, lambda _: init_solvers.refine_gravity(
            R, p, ics, unit_g, prof.alignment_axes, gravity, sigma_tilt=2.0, sigma_dba=2.0)),
        "refine_gravity.warm": (none, lambda _: init_solvers.refine_gravity(
            R, p, ics, unit_g, prof.alignment_axes, gravity, sigma_tilt=5.0, sigma_dba=5.0,
            rounds=3)),
    }
    out = {}
    for name, (draw, call) in calls.items():
        call(draw())
        u = draw()
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            call(u)
        except RuntimeError as exc:
            fail(f"{name} waits for the card under set_sync_debug_mode('error'): {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    print("no synchronization under set_sync_debug_mode('error'): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in out.items()))
    return out


def imu_checks(dev, consts, static, inputs, truth) -> dict:
    """Phase 3d (see IMU_SCAN_TOL): `integrate_chunk` against
    `integrate_chunk_sequential` on the card over phase 4's chunks chained
    from the seeded state and biases; each form's eager ms a chunk (CUDA
    events); one chunk of the scan captured alone as a graph, its nodes and
    device ms a replay, its output bit-equal to the eager call's. Returns
    the phase's numbers."""
    import torch

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.imu import preintegration as pre
    from pose_estimation_tpu_torch.testing import seeded_state

    state = seeded_state(static, truth, dev)
    bg, ba, imu = state.bg, state.ba, consts.imu
    chunks = [inp[2:5] for inp in inputs]
    forms = {"scan": pre.integrate_chunk, "loop": pre.integrate_chunk_sequential}
    runs = {}
    for name, fn in forms.items():
        st = state.preint
        for c in chunks:
            st = fn(st, *c, bg, ba, imu)
        runs[name] = st
    err = {field: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for field, a, b in zip(pre.PreintState._fields, runs["scan"], runs["loop"])}
    worst = max(err, key=err.get)
    if not all(bool(torch.isfinite(t).all()) for t in runs["scan"]):
        fail("integrate_chunk: non-finite state over the chained chunks")
    if err[worst] > IMU_SCAN_TOL:
        fail(f"integrate_chunk against integrate_chunk_sequential: {worst} off by "
             f"{err[worst]:.3g} of its largest entry (bound {IMU_SCAN_TOL})")
    ms = {name: cuda_ms(lambda fn=fn: fn(state.preint, *chunks[0], bg, ba, imu), reps=10,
                        warm=2) for name, fn in forms.items()}

    def one(st, g, a, m):
        return pre.integrate_chunk(st, g, a, m, bg, ba, imu)

    # whether the cyclic garbage collector could run during the capture
    collecting = []

    def captured(*a):
        collecting.append(gc.isenabled())
        return one(*a)

    args = (state.preint, *chunks[0])
    graphs.warm_up(one, args, dev)
    step = graphs.CapturedStep("integrate_chunk", captured, args, dev)
    same = all(torch.equal(x, y) for x, y in zip(step(), one(*args)))
    if collecting != [False] or not gc.isenabled():
        fail(f"the garbage collector during the capture: {collecting} (held off), after "
             f"it: {gc.isenabled()} (running again)")
    replay_ms = cuda_ms(step.graph.replay, reps=20, warm=2)
    m_valid = int(chunks[0][2].sum())
    print(f"IMU preintegration, {len(chunks)} chained EuRoC chunks ({chunks[0][0].shape[0]} "
          f"samples, {m_valid} valid): integrate_chunk within {err[worst]:.3g} of "
          f"integrate_chunk_sequential ({worst}; bound {IMU_SCAN_TOL} of each field's largest "
          f"entry); eager ms a chunk: scan {ms['scan']:.3f}, loop {ms['loop']:.3f}; one chunk "
          f"captured: {step.stats['nodes']} nodes, {replay_ms:.4f} device ms a replay, "
          + ("bit-equal to the eager call" if same else "DIFFERS from the eager call"))
    if not same:
        fail("integrate_chunk captured alone differs from its eager call")
    return {"rel_err": err, "eager_ms": ms, "graph_nodes": step.stats["nodes"],
            "graph_replay_ms": replay_ms}


def kernel_checks(dev, cfg, frame, kcfg) -> dict:
    """Phase 3: each kernel against its twin on the card, at the shapes its
    path gives it: the EuRoC-width stereo pair `frame` [2, H, W] under
    `cfg` (K1, K2, K4) and a KITTI-width pair under `kcfg` (K3, K2, K4),
    and K5 over its sweep. Fails on a disagreement; returns each kernel's
    error, event time, device time, twin time and bound by name."""
    import torch

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, kernels, moments, orb, probe, sample
    from pose_estimation_tpu_torch.testing import StereoInertialSim, protocol_world

    res = {}
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    ocfg, oc = static.orb, consts.orb
    imgs = torch.from_numpy(frame).to(dev)
    stack, bounds = orb.plane_stack(imgs, ocfg, oc)
    args = (stack, bounds, ocfg.th_hi, ocfg.th_lo, orb.EDGE, ocfg.k_per_cell)

    got, valid, k1_err = check_select(args, "EuRoC stack")
    # bytes: each plane's content read once (no keypoint can lie in the
    # stack's zero padding), the four [N, C] outputs written once;
    # instructions: FAST + NMS per content pixel, plus the border/threshold
    # gates and the per-cell top-4 (8 compares a pixel). The count over the
    # whole canvas is printed beside it.
    content = sum(lh * lw for lh, lw in bounds)
    out_bytes = sum(a.numel() * 4 for a in got)
    canvas_bound = bound(stack.numel() * 4 + out_bytes, stack.numel() * (FAST_OPS_PER_PX + 8))
    plan = fast.select_plan(*stack.shape[1:], bounds, orb.EDGE)
    res["fast_select"] = kernel_result(
        k1_err, cuda_ms(lambda: fast.fast_select(*args)),
        device_ms(lambda: fast.fast_select(*args), "fast_select_kernel"),
        cuda_ms(lambda: fast.select_plain(*args), reps=5, warm=1),
        bound(content * 4 + out_bytes, content * (FAST_OPS_PER_PX + 8)))
    r = res["fast_select"]
    print(f"K1 fast_select [{tuple(stack.shape)}]: {int(valid.sum())} candidates, "
          f"scores/codes exact, max |dxy| {k1_err:.3g} px; kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound']:.4f} ms ({r['by']}) over the content's {content} px, "
          f"{canvas_bound[0]:.4f} ms ({canvas_bound[1]}) over the canvas's {stack.numel()}; "
          f"{plan.first[-1]} work blocks of {plan.first[-1] + len(bounds)} launched")

    # K1 on the accuracy protocol's stack (320x240, 4 levels): the same
    # checks at the shape of the state machine's runs
    pcfg, pworld, _, _ = protocol_world("A2")
    pconsts, pstatic = vio.build_constants(pcfg, CameraModel.from_config(pcfg), dev)
    pstack, pbounds = orb.plane_stack(torch.from_numpy(np.stack(pworld.render(1.0))).to(dev),
                                      pstatic.orb, pconsts.orb)
    pargs = (pstack, pbounds, pstatic.orb.th_hi, pstatic.orb.th_lo, orb.EDGE,
             pstatic.orb.k_per_cell)
    _, pvalid, p_err = check_select(pargs, "protocol stack")
    pwork = fast.select_plan(*pstack.shape[1:], pbounds, orb.EDGE).first[-1]
    r["protocol"] = dict(err=p_err, ms=cuda_ms(lambda: fast.fast_select(*pargs)),
                         device_ms=device_ms(lambda: fast.fast_select(*pargs),
                                             "fast_select_kernel"))
    print(f"K1 fast_select [{tuple(pstack.shape)}] (protocol): {int(pvalid.sum())} candidates, "
          f"scores/codes exact, max |dxy| {p_err:.3g} px; kernel {r['protocol']['ms']:.4f} ms "
          f"(device {r['protocol']['device_ms']:.4f}); {pwork} work blocks of "
          f"{pwork + len(pbounds)} launched")

    # plane top-k: stable sort and first-index argmin on CUDA as on the CPU
    budgets = orb.level_budgets(ocfg)
    k_top = min(budgets[0], got[0].shape[1])
    order_gpu = torch.sort(got[0], dim=1, descending=True, stable=True).indices[:, :k_top]
    order_cpu = torch.sort(got[0].cpu(), dim=1, descending=True, stable=True).indices[:, :k_top]
    if not torch.equal(order_gpu.cpu(), order_cpu):
        fail("stable descending sort differs between CUDA and CPU")
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 8, (512, 1024)).astype(np.float32))
    if not torch.equal(torch.argmin(d.to(dev), dim=1).cpu(), torch.argmin(d, dim=1)):
        fail("argmin ties resolve differently on CUDA")
    print(f"plane top-k {k_top}: stable sort and first-index argmin agree with the CPU")
    kps = orb.detect(stack, bounds, ocfg, budgets[0])

    # K3 at KITTI width: the level-major plane stack of one stereo pair,
    # [16, 375, 1242]; raw and NMS-masked maps bit-equal to the twin
    kconsts, kstatic = vio.build_constants(kcfg, CameraModel.from_config(kcfg), dev)
    kimgs = torch.from_numpy(np.stack(StereoInertialSim(kcfg, n_landmarks=150).render(1.0)))
    kstack, kbounds = orb.plane_stack(kimgs.to(dev), kstatic.orb, kconsts.orb)
    kraw, kmasked = fast.fast_score_nms(kstack)
    praw, pmasked = fast.score_nms_plain(kstack)
    torch.cuda.synchronize()
    if not (torch.equal(kraw, praw) and torch.equal(kmasked, pmasked)):
        n_bad = int((kraw != praw).sum() + (kmasked != pmasked).sum())
        fail(f"fast_score_nms: {n_bad} values differ from the twin")
    # bytes: 4 read and 8 written per pixel; instructions: FAST + NMS per pixel
    res["fast_score_nms"] = kernel_result(
        float(torch.maximum((kraw - praw).abs().max(), (kmasked - pmasked).abs().max())),
        cuda_ms(lambda: fast.fast_score_nms(kstack)),
        device_ms(lambda: fast.fast_score_nms(kstack), "fast_score_nms_kernel"),
        cuda_ms(lambda: fast.score_nms_plain(kstack), reps=5, warm=1),
        bound(kstack.numel() * 12, kstack.numel() * FAST_OPS_PER_PX))
    r = res["fast_score_nms"]
    print(f"K3 fast_score_nms [{tuple(kstack.shape)}]: raw and masked bit-equal to the twin "
          f"({int((pmasked > 0).sum())} NMS maxima); kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound']:.4f} ms ({r['by']})")
    del kraw, kmasked, praw, pmasked
    kbudgets = orb.level_budgets(kstatic.orb)
    kkps = orb.detect(kstack, kbounds, kstatic.orb, kbudgets[0])

    # K2: one launch over every level of the pair, against the all-levels
    # twin, at EuRoC width (its path's shape, kept as the kernel's row) and
    # at KITTI width
    k2 = {name: check_sample(name, st, bnds, kp, bud, oc.pool_xy)
          for name, st, bnds, kp, bud in (("euroc", stack, bounds, kps, budgets),
                                          ("kitti", kstack, kbounds, kkps, kbudgets))}
    res["sample_patches"] = dict(k2["euroc"], kitti_width=k2["kitti"])

    # K4 on both plane stacks: against its twin in float32 and in float64,
    # at the angles of the detected keypoints, and beside the one PyTorch
    # call that computes the same maps, a 2-channel 31x31 convolution of the
    # zero-meaned stack with the circular moment masks (TF32 off, zero
    # padding: the same function on the whole map). The map front end's
    # sparse and integral forms are held to the float64 angles as well.
    d = torch.arange(-moments.PATCH_R, moments.PATCH_R + 1, device=dev, dtype=torch.float32)
    circle = (d[:, None] ** 2 + d[None, :] ** 2 <= moments.PATCH_R ** 2).to(torch.float32)
    masks = torch.stack([circle * d[None, :], circle * d[:, None]])[:, None]   # [2, 1, 31, 31]

    def conv_moments(st):
        return torch.nn.functional.conv2d(moments.zero_mean(st)[:, None], masks,
                                          padding=moments.PATCH_R)

    k4 = {}
    for name, st, kp in (("euroc", stack, kps), ("kitti", kstack, kkps)):
        n, h, w = st.shape
        g10, g01 = moments.moment_maps(st)
        r10, r01 = moments.moment_maps_plain(st)
        d10, d01 = moments.moment_maps_plain(st.double())
        lib = conv_moments(st)
        torch.cuda.synchronize()
        err = max(rel_err(g10, r10), rel_err(g01, r01))
        err64 = max(rel_err(g10.double(), d10), rel_err(g01.double(), d01))
        twin64 = max(rel_err(r10.double(), d10), rel_err(r01.double(), d01))
        lib_err = max(rel_err(lib[:, 0], r10), rel_err(lib[:, 1], r01))
        if err > K4_TOL_MOM:
            fail(f"moment_maps ({name}): {err:.3g} of the largest |moment| from the twin "
                 f"> {K4_TOL_MOM}")
        if err64 > K4_TOL_MOM_F64:
            fail(f"moment_maps ({name}): {err64:.3g} of the largest |moment| from the "
                 f"float64 twin > {K4_TOL_MOM_F64}")
        if lib_err > K4_TOL_MOM:
            fail(f"moment_maps ({name}): the convolution is {lib_err:.3g} from the twin")
        xy = kp.xy.reshape(-1, 2)
        base = (torch.arange(n, device=dev) * (h * w)).repeat_interleave(kp.xy.shape[1])
        # angles at the detected keypoints against those of the float64
        # twin: the kernel's, the float32 twin's and the sparse form's
        idx = base + torch.round(xy[:, 1]).long().clamp(0, h - 1) * w \
            + torch.round(xy[:, 0]).long().clamp(0, w - 1)
        mag = torch.hypot(d10, d01)
        longest = mag.amax(dim=(1, 2)).repeat_interleave(kp.xy.shape[1])
        keep = kp.valid.reshape(-1) & (mag.reshape(-1)[idx] >= K4_MIN_MOMENT * longest)
        ang64 = moments.ic_angle_integral(d10.reshape(-1), d01.reshape(-1), base, xy, h, w)

        def ang_off(ang):
            dang = torch.remainder(ang.double() - ang64 + math.pi, 2 * math.pi) - math.pi
            return float(dang[keep].abs().max())

        ang_err = ang_off(moments.ic_angle_integral(g10.reshape(-1), g01.reshape(-1),
                                                    base, xy, h, w))
        ang_twin = ang_off(moments.ic_angle_integral(r10.reshape(-1), r01.reshape(-1),
                                                     base, xy, h, w))
        ang_sparse = ang_off(orb.ic_angle_sparse(st, base, xy))
        if ang_err > K4_TOL_ANGLE:
            fail(f"moment_maps ({name}): angle error {ang_err:.3g} rad > {K4_TOL_ANGLE}")
        if max(ang_twin, ang_sparse) > MAP_TOL_ANGLE:
            fail(f"map front end ({name}): the integral form's angles are {ang_twin:.3g} rad "
                 f"and the sparse form's {ang_sparse:.3g} rad from the float64 angles "
                 f"> {MAP_TOL_ANGLE}")
        # bytes: the stack read once, the two maps written once
        k4[name] = kernel_result(
            float(torch.maximum((g10 - r10).abs().max(), (g01 - r01).abs().max())),
            cuda_ms(lambda: moments.moment_maps(st)),
            device_ms(lambda: moments.moment_maps(st), "moment_maps_kernel"),
            cuda_ms(lambda: moments.moment_maps_plain(st), reps=5, warm=1),
            bound(st.numel() * 12, st.numel() * K4_OPS_PER_PX),
            lib_ms=cuda_ms(lambda: conv_moments(st), reps=5, warm=1),
            angle_err=ang_err, twin_angle_err=ang_twin, sparse_angle_err=ang_sparse)
        r = k4[name]
        smem = kernels.library().moment_maps_smem_bytes(n, h, w)
        print(f"K4 moment_maps [{tuple(st.shape)}]: {err:.3g} of the largest |moment| from "
              f"the twin (tolerance {K4_TOL_MOM}), {err64:.3g} from the twin in float64 "
              f"(the float32 twin: {twin64:.3g}), conv2d {lib_err:.3g} from the twin; "
              f"angles at {int(keep.sum())} of {int(kp.valid.sum())} keypoints from the "
              f"float64 twin's: the kernel {ang_err:.3g} rad (tolerance {K4_TOL_ANGLE}), the "
              f"integral form {ang_twin:.3g}, the sparse form {ang_sparse:.3g} (tolerance "
              f"{MAP_TOL_ANGLE}); kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), "
              f"plain {r['plain_ms']:.4f} ms, conv2d {r['lib_ms']:.4f} ms, "
              f"bound {r['bound']:.4f} ms ({r['by']}); its own count of shared-memory "
              f"traffic {smem / st.numel():.1f} bytes a pixel, modelled at 128 bytes a clock "
              f"per SM {smem / SMEM_BYTES_PER_S * 1e3:.4f} ms")
        del g10, g01, r10, r01, d10, d01, lib
    res["moment_maps"] = dict(k4["euroc"], kitti_width=k4["kitti"])

    # K5: the probe's sweep is its path. Every entry's output is held
    # exactly equal to the twin's inside `sweep`; the largest entry is then
    # run once more here for the error, the twin's time and the bound.
    zero_counters()
    probe_rows = probe.sweep(dev)
    probe_launches = counters()["stream_probe"]
    for row in probe_rows:
        print(f"K5 stream_probe planes={row['planes']:4d} h={row['h']:3d} {row['dtype']:9s} "
              f"{row['mbytes']:7.1f} MB, {row['programs']} blocks: {row['ms']:.4f} ms/call "
              f"({row['us_per_block']:.3f} us/block, {row['gbytes_per_s']:.1f} GB/s)")
    big = max(probe_rows, key=lambda row: row["mbytes"])
    pstack = torch.rand((big["planes"], big["h"], probe.WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1)) * 255
    ppp = torch.arange(big["planes"], dtype=torch.int32, device=dev).repeat_interleave(
        probe.PROGS_PER_PLANE)
    pout = probe.stream_probe(pstack, ppp)
    k5_err = float((pout - probe.stream_probe_plain(pstack, ppp)).abs().max())
    if k5_err != 0.0:
        fail(f"stream_probe: {k5_err} from the twin (must be exact)")
    # bytes: each distinct plane and index read once, the tiles written
    # once; one multiply per output element
    res["stream_probe"] = kernel_result(
        k5_err, big["ms"], device_ms(lambda: probe.stream_probe(pstack, ppp),
                                     "stream_probe_kernel"),
        cuda_ms(lambda: probe.stream_probe_plain(pstack, ppp), reps=5, warm=1),
        bound(pstack.numel() * 4 + ppp.numel() * 4 + pout.numel() * 4, pout.numel()),
        launches=probe_launches)
    r = res["stream_probe"]
    print(f"K5 stream_probe [{tuple(pstack.shape)}], {ppp.numel()} blocks: exact; "
          f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound']:.4f} ms ({r['by']}); {probe_launches} launches in the "
          "sweep")
    return res


class ResumeSplit:
    """Feeds one simulated run to `first`; at the first frame at or after
    `t_split` s that finds `first` in OK it checkpoints `first` to `path`
    and loads it into `second`, which from then on gets every call too."""

    def __init__(self, first, second, t_split, path):
        self.first, self.second, self.t_split, self.path = first, second, t_split, path
        self.resumed = False

    def collect_imu_data(self, *args):
        for s in (self.first, self.second) if self.resumed else (self.first,):
            s.collect_imu_data(*args)

    def process(self, img_l, img_r, ts):
        if not self.resumed and ts >= self.t_split * 1e9 and self.first.state.name == "OK":
            self.first.save_checkpoint(self.path)
            self.second.load_checkpoint(self.path)
            self.resumed = True
        out = self.first.process(img_l, img_r, ts)
        if self.resumed:
            self.second.process(img_l, img_r, ts)
        return out


def batched_checks(dev, consts, static, frames, gyrs, accs, mask, truth) -> dict:
    """Phase 9: many sequences in one frame step (`parallel.batched`) at
    EuRoC width. The kernels at the batched plane stack of BATCH stereo
    pairs (K1 and K2 on their path's shape, K3 and K4 at the same shape)
    against their twins; BATCH_FRAMES chained batched frames, K1 and K2
    once per frame, under the divergence guard; the second frame held per
    lane against the single-sequence `ok_step` from the same state and
    uniforms; then a checkpoint in the middle of a state-machine run that
    must continue as the run does. Returns the kernels' batched records
    and the phase's numbers."""
    import os
    import tempfile

    import torch

    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, moments, orb
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM
    from pose_estimation_tpu_torch.testing import protocol_world, seeded_state
    from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_map

    out = {}
    ocfg, oc = static.orb, consts.orb
    imgs = torch.stack([torch.from_numpy(np.ascontiguousarray(frames[j][c])).to(dev)
                        for c in (0, 1) for j in range(BATCH)]).to(torch.float32)
    stack, bounds = orb.plane_stack(imgs, ocfg, oc)
    args = (stack, bounds, ocfg.th_hi, ocfg.th_lo, orb.EDGE, ocfg.k_per_cell)
    got, valid, k1_err = check_select(args, "batched stack")
    content = sum(lh * lw for lh, lw in bounds)
    out_bytes = sum(a.numel() * 4 for a in got)
    out["fast_select"] = kernel_result(
        k1_err, cuda_ms(lambda: fast.fast_select(*args)),
        device_ms(lambda: fast.fast_select(*args), "fast_select_kernel"),
        cuda_ms(lambda: fast.select_plain(*args), reps=3, warm=1),
        bound(content * 4 + out_bytes, content * (FAST_OPS_PER_PX + 8)))
    cls, per = fast.plane_classes(tuple(bounds))
    n_work = fast.select_plan(*stack.shape[1:], cls, orb.EDGE).first[-1]
    r = out["fast_select"]
    print(f"K1 fast_select [{tuple(stack.shape)}] (batched, {BATCH} pairs): "
          f"{int(valid.sum())} candidates, scores/codes exact, max |dxy| {k1_err:.3g} px; "
          f"one launch of ({len(cls)} + {n_work}) x {per} blocks; kernel {r['ms']:.4f} ms "
          f"(device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound']:.4f} ms ({r['by']})")
    budgets = orb.level_budgets(ocfg)
    kps = orb.detect(stack, bounds, ocfg, budgets[0])
    out["sample_patches"] = check_sample("batched", stack, bounds, kps, budgets, oc.pool_xy)

    # K3 and K4 at the batched stack's shape (off this width's path)
    raw, masked = fast.fast_score_nms(stack)
    praw, pmasked = fast.score_nms_plain(stack)
    torch.cuda.synchronize()
    if not (torch.equal(raw, praw) and torch.equal(masked, pmasked)):
        fail("fast_score_nms (batched stack): values differ from the twin")
    del raw, masked, praw, pmasked
    out["fast_score_nms"] = kernel_result(
        0.0, cuda_ms(lambda: fast.fast_score_nms(stack)),
        device_ms(lambda: fast.fast_score_nms(stack), "fast_score_nms_kernel"),
        cuda_ms(lambda: fast.score_nms_plain(stack), reps=2, warm=1),
        bound(stack.numel() * 12, stack.numel() * FAST_OPS_PER_PX))
    g10, g01 = moments.moment_maps(stack)
    r10, r01 = moments.moment_maps_plain(stack)
    k4_err = max(rel_err(g10, r10), rel_err(g01, r01))
    if k4_err > K4_TOL_MOM:
        fail(f"moment_maps (batched stack): {k4_err:.3g} of the largest |moment| from the twin")
    k4_abs = float(torch.maximum((g10 - r10).abs().max(), (g01 - r01).abs().max()))
    del g10, g01, r10, r01
    out["moment_maps"] = kernel_result(
        k4_abs, cuda_ms(lambda: moments.moment_maps(stack)),
        device_ms(lambda: moments.moment_maps(stack), "moment_maps_kernel"),
        cuda_ms(lambda: moments.moment_maps_plain(stack), reps=2, warm=1),
        bound(stack.numel() * 12, stack.numel() * K4_OPS_PER_PX))
    for name in ("fast_score_nms", "moment_maps"):
        r = out[name]
        print(f"{name} [{tuple(stack.shape)}] (batched): {r['err']:.3g} from the twin; kernel "
              f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound']:.4f} ms ({r['by']})")
    del stack

    # the batched chain: lane j replays frames j, j + 1, ...
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(BATCH + BATCH_FRAMES)]
    gens = [torch.Generator(device=dev).manual_seed(100 + j) for j in range(BATCH)]
    step = batched.make_batched_step(consts, static)
    state = batched.stack_states([seeded_state(static, truth, dev, j) for j in range(BATCH)])
    held, metrics = None, []
    torch.cuda.synchronize()
    zero_counters()
    t_start = time.perf_counter()
    for i in range(BATCH_FRAMES):
        if i == 2:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        u = torch.stack([torch.stack(vio.draw_ransac_uniforms(g, dev)) for g in gens])
        before = state
        lane_in = [torch.stack(parts) for parts in zip(*(inputs[j + i] for j in range(BATCH)))]
        state, m = step(state, *lane_in, u)
        if i == 1:
            held = (before, lane_in, u)
        metrics.append(m)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = counters()
    ms_step = (t_end - t_warm) * 1e3 / (BATCH_FRAMES - 2)
    if (launches["fast_select"], launches["sample_patches"], launches["eigh"]) \
            != (BATCH_FRAMES,) * 3 or launches["fast_score_nms"] or launches["moment_maps"]:
        fail(f"batched step: launches {launches} in {BATCH_FRAMES} batched frames (one "
             "extraction, K1 and K2 once each, and the clip's K6, a frame)")
    excess = np.full(BATCH, -math.inf)
    dist = np.zeros(BATCH)
    for i, m in enumerate(metrics):
        p = m["rec_p"].cpu().numpy()
        for j in range(BATCH):
            dist[j] += float(np.linalg.norm(truth(j + i + 1)[1] - truth(j + i)[1]))
            err = float(np.linalg.norm(p[j] - truth(j + i + 1)[1]))
            excess[j] = max(excess[j], err - DIVERGED_PER_M * dist[j])
        cost = m["ba_cost"].cpu().numpy()
        if not (cost >= 0.0).all():
            fail(f"batched frame {i}: BA cost {cost} negative or not finite")
        if i >= 2 and not (float(m["n_tracked"].float().mean()) > 0
                           and float(m["ba_iters"].float().mean()) > 0):
            fail(f"batched frame {i}: tracking or BA dead in every lane")
        print(f"  batched frame {i}: tracked {m['n_tracked'].tolist()} "
              f"ba_iters {m['ba_iters'].tolist()} kf {m['is_keyframe'].int().tolist()}")
    held_lanes = int((excess <= DIVERGED_M).sum())
    if 2 * held_lanes < BATCH or (excess > RUNAWAY_M).any():
        fail(f"batched chain: {held_lanes} of {BATCH} lanes within {DIVERGED_PER_M} x distance "
             f"+ {DIVERGED_M} m, largest excess {excess.max():.3f} m")
    leaves = [t for t in tree_leaves(state) if t.is_floating_point()]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail("batched chain: non-finite state")
    print(f"batched step, B = {BATCH} at {imgs.shape[2]}x{imgs.shape[1]}: {BATCH_FRAMES} "
          f"frames in {t_end - t_start:.2f} s, {ms_step:.2f} ms a batched frame over frames "
          f"2-{BATCH_FRAMES - 1} ({BATCH / ms_step * 1e3:.2f} frames/s); launches {launches}; "
          f"{held_lanes} of {BATCH} lanes within the divergence bound (largest excess per "
          f"lane, m: {[round(float(x), 3) for x in excess]})")

    # the second batched frame again, lane by lane: against the lane in a
    # batch of copies of itself, then against the single step
    before, lane_in, u = held
    held_static = dataclasses.replace(static, max_iterations=HELD_LM_ITERS)
    held_step = batched.make_batched_step(consts, held_static)
    b_out, m = held_step(before, *lane_in, u)
    agree, rows = 0, []
    for j in range(BATCH):
        def copies(t):
            return t[j:j + 1].expand((BATCH,) + t.shape[1:]).contiguous()

        c_out, c_m = held_step(tree_map(copies, before), *map(copies, lane_in), copies(u))
        pairs = zip(tree_leaves((b_out, tuple(m.values()))),
                    tree_leaves((c_out, tuple(c_m.values()))))
        if not all(torch.equal(a[j], c[k]) for a, c in pairs for k in range(BATCH)):
            fail(f"batched lane {j} differs from the same lane in a batch of {BATCH} copies "
                 "of itself: a lane's result depends on the other lanes")
        _, sm = vio.ok_step(batched.lane(before, j), *inputs[j + 1], None, consts, held_static,
                            ransac_u=tuple(u[j]))
        dc = max(abs(int(m[k][j]) - int(sm[k])) for k in ("n_stereo", "n_tracked"))
        di = abs(int(m["ba_iters"][j]) - int(sm["ba_iters"]))
        dp = float((m["rec_p"][j] - sm["rec_p"]).abs().max())
        rows.append((int(m["n_tracked"][j]), int(sm["n_tracked"]), dc, di, dp))
        agree += dc == 0 and di == 0 and dp <= BATCH_TOL_P
        if dp > BATCH_LOOSE_P:
            fail(f"batched lane {j}: position {dp:.3g} m from the single step "
                 f"(bound {BATCH_LOOSE_P} m)")
    print(f"batched frame 1 (LM capped at {HELD_LM_ITERS}): every lane bit-equal to itself in "
          f"a batch of {BATCH} copies; against {BATCH} single ok_steps (same states and "
          f"uniforms), per lane (tracked batched, single, largest count difference, LM "
          f"iteration difference, position difference m): {rows}; {agree} lanes agree "
          f"(counts and LM iterations equal, position within {BATCH_TOL_P} m; at least "
          f"{BATCH_MIN_AGREE} must)")
    if agree < BATCH_MIN_AGREE:
        fail(f"batched frame against single steps: {agree} of {BATCH} lanes agree")
    worst_p = max(r[4] for r in rows)
    out.update(launches=launches, ms_per_step=ms_step, frames_per_s=BATCH / ms_step * 1e3,
               lane_p_err=worst_p, lanes_agree=agree)

    # the keyframe full-BA branch under vmap on the lanes' states after the
    # chain, against each lane's own solve
    full_static = dataclasses.replace(static, full_ba_keyframes=True)

    def full_branch(win, pool):
        return vio.keyframe_full_ba(win, pool, consts, full_static)

    vbranch = torch.func.vmap(full_branch)
    b_win, b_pool = vbranch(state.win, state.pool)
    if not all(bool(torch.isfinite(t).all()) for t in (*b_win[:5], b_pool.pos)):
        fail("full BA under vmap: non-finite window or landmarks")
    dps = []
    for j in range(BATCH):
        s_win, _ = full_branch(batched.lane(state.win, j), batched.lane(state.pool, j))
        dps.append(float((b_win.p[j] - s_win.p).abs().max()))
    moved = float((b_win.p - state.win.p).abs().max())
    full_ms = cuda_ms(lambda: vbranch(state.win, state.pool), reps=5, warm=1)
    full_agree = sum(d <= BATCH_TOL_P for d in dps)
    print(f"keyframe full BA under vmap, B = {BATCH}: {full_ms:.2f} ms a call; moved the "
          f"windows by up to {moved:.4f} m; each lane against its own solve, largest position "
          f"difference m: {[round(d, 6) for d in dps]} ({full_agree} within {BATCH_TOL_P} m)")
    if full_agree < BATCH_MIN_AGREE or max(dps) > BATCH_LOOSE_P:
        fail(f"full BA under vmap: {full_agree} of {BATCH} lanes agree with their own solve, "
             f"largest difference {max(dps):.3g} m")
    out.update(full_ba_vmap_ms=full_ms, full_ba_lane_p_err=max(dps))

    # a checkpoint in the middle of a state-machine run on the card
    cfg, world, _, imu_seed = protocol_world("A2")
    first = VisualInertialSLAM(cfg, seed=5, device=dev)
    second = VisualInertialSLAM(cfg, seed=77, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        split = ResumeSplit(first, second, RESUME_AT, os.path.join(tmp, "ck.npz"))
        world.run(split, duration=RESUME_END, imu_noise=2.4e-3, seed=imu_seed)
    if not split.resumed or first.state != State.OK or second.state != State.OK:
        fail(f"checkpoint: the runs ended in {first.state.name} and {second.state.name}")
    diff = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(tree_leaves(first.vio), tree_leaves(second.vio)))
    n_after = len(second._records)
    traj_diff = float(np.abs(first.trajectory[-n_after:] - second.trajectory).max())
    if n_after < 5 or diff > RESUME_TOL or traj_diff > RESUME_TOL:
        fail(f"checkpoint: the resumed run is {diff:.3g} (state) and {traj_diff:.3g} "
             f"(trajectory) from the uninterrupted one over {n_after} frames")
    print(f"checkpoint at {RESUME_AT} s of world A2, resumed in a new object: {n_after} frames "
          f"to {RESUME_END} s, state within {diff:.3g} and trajectory within {traj_diff:.3g} "
          f"of the uninterrupted run (tolerance {RESUME_TOL})")
    out["resume_diff"] = max(diff, traj_diff)
    return out


def is_keyframe(metrics) -> bool:
    """A keyframe with matches: the frames whose full BA is kept."""
    return bool(metrics["is_keyframe"]) and int(metrics["n_tracked"]) > 0


@contextlib.contextmanager
def observed_replays(profile=False):
    """While the block runs, every `slam.VisualInertialSLAM` the code builds
    (the CLIs' too) records its replay on `.observed`: the states it passed
    through and the seconds to its first OK frame; per OK frame
    `observe_ok_frames`' record, and the full-BA iterations of an eager
    frame (where configured; a graphed frame's solve runs inside its graph);
    with `profile`, the device kernels the profiler saw in OK frames from
    ENTRY_PROFILE_FROM on until a keyframe and another frame were among
    them (those frames' ms are left out); and the host seconds of each PNG
    decode. Yields the list of the objects built."""
    from pose_estimation_tpu_torch import slam as slam_mod
    from pose_estimation_tpu_torch.backend import full_ba as full_ba_mod
    from pose_estimation_tpu_torch.io import png

    made, decode_s, full_iters = [], [], []
    base, read, solve = slam_mod.VisualInertialSLAM, png.read_png, full_ba_mod.full_ba
    frames = []

    def wanted(frames) -> bool:
        seen = {is_keyframe(f["metrics"]) for f in frames if f["device_kernels"] is not None}
        return (profile and len(frames) >= ENTRY_PROFILE_FROM and len(seen) < 2
                and len(frames) < ENTRY_PROFILE_FROM + ENTRY_PROFILED)

    def recorded_solve(*args, **kwargs):
        out = solve(*args, **kwargs)
        full_iters.append(out[3]["iterations"])
        return out

    def timed_read(*args, **kwargs):
        t0 = time.perf_counter()
        out = read(*args, **kwargs)
        decode_s.append(time.perf_counter() - t0)
        return out

    class Observed(base):
        def __init__(self, *args, **kwargs):
            self.t_start = time.perf_counter()
            super().__init__(*args, **kwargs)
            frames.clear()
            self.observed = {"states": [self.state.name], "frames": frames,
                             "decode_s": decode_s}
            self._full_iters = None
            observe_ok_frames(self, frames, wanted,
                              lambda f: f.update(full_ba_iters=self._full_iters))
            made.append(self)

        def process(self, img_l, img_r, ts):
            n_iters = len(full_iters)
            out = super().process(img_l, img_r, ts)
            self._full_iters = (full_iters[-1] if not self.graphed
                                and len(full_iters) > n_iters else None)
            if self.state.name != self.observed["states"][-1]:
                self.observed["states"].append(self.state.name)
                if self.state == slam_mod.State.OK:
                    self.observed["to_ok_s"] = time.perf_counter() - self.t_start
            return out

    slam_mod.VisualInertialSLAM = Observed
    png.read_png, full_ba_mod.full_ba = timed_read, recorded_solve
    try:
        yield made
    finally:
        slam_mod.VisualInertialSLAM = base
        png.read_png, full_ba_mod.full_ba = read, solve


def check_replay(label, slam, gt, states_csv, launches, path_kernels) -> dict:
    """Phase 10's gates on one finished replay: it reached OK, its state is
    finite, every position lies within 2 x distance + 1 m of the truth,
    its states.csv has the JAX package's header and 17 columns a row, the
    extraction kernels of its path launched once per extraction, at least
    once an OK frame (the others never), K6 launched (the SfM frames' PnP,
    the clip), and a graphed replay's OK frames replayed one graph each
    (four staged). Returns the replay's numbers."""
    import torch

    from pose_estimation_tpu_torch.io.ate import ate_rmse
    from pose_estimation_tpu_torch.testing import run_errors

    obs = slam.observed
    frames = obs["frames"]
    if slam.state.name != "OK" or not frames:
        fail(f"{label}: ended in {slam.state.name} after {len(frames)} OK frames "
             f"(states {obs['states']})")
    win = slam.vio.win
    if not all(bool(torch.isfinite(t).all()) for t in (*win[:5], slam.vio.pool.pos)) \
            or not np.isfinite(slam.trajectory).all():
        fail(f"{label}: non-finite state")
    e = run_errors(slam, gt)
    over = e["err"] - (DIVERGED_PER_M * e["dist"] + DIVERGED_M)
    if (over > 0).any():
        i = int(np.argmax(over))
        fail(f"{label}: frame {i} {e['err'][i]:.3f} m off after {e['dist'][i]:.3f} m")
    lines = states_csv.read_text().splitlines()
    rows = [line.split(",") for line in lines[1:]]
    if lines[0] != STATES_CSV_HEADER or len(rows) != len(slam.trajectory) \
            or any(len(r) != 17 or not np.isfinite([float(v) for v in r]).all() for r in rows):
        fail(f"{label}: states.csv is not the JAX package's format (header {lines[0]!r}, "
             f"{len(rows)} rows)")
    n_ext = extractions(launches)
    others = [k for k in EXTRACTION if k not in path_kernels]
    if any(launches[k] != n_ext for k in path_kernels) or any(launches[k] for k in others) \
            or n_ext < len(frames) or not (launches["eigh"] and launches["svd"]):
        fail(f"{label}: launches {launches} in {len(frames)} OK frames ({path_kernels} once "
             "an extraction, the other extraction kernels never, K6 at least once)")
    if slam.graphed:
        check_frame_replays(label, frames, 4 if slam.staged else 1)
    ms = [f["ms"] for f in frames if "ms" in f]
    times = frame_times(frames)
    ate = ate_rmse(slam.trajectory, gt)
    path = ate / e["ate_pct"] * 100.0
    out = {"ok_frames": len(frames), "states": obs["states"], "to_ok_s": obs["to_ok_s"],
           "ms_per_ok_frame": float(np.mean(ms)), "first_ok_frame_ms": times["first_ms"],
           "ms_per_later_ok_frame": times["mean_ms"],
           "median_ms_per_ok_frame": times["median_ms"], "frame_times": times, "ate_m": ate,
           "ate_pct": e["ate_pct"], "path_m": path, "launches": launches,
           "extractions": n_ext, "worst_err_m": float(e["err"].max())}
    decode = obs["decode_s"]
    out["decode_ms_per_frame"] = 2e3 * float(np.mean(decode)) if decode else None
    print(f"{label}: states {' -> '.join(obs['states'])} ({obs['to_ok_s']:.1f} s to OK, "
          f"construction included); {len(frames)} OK frames, "
          f"{out['ms_per_ok_frame']:.2f} ms per OK frame over {len(ms)}; "
          + frame_times_line(times) + "; PNG decode "
          f"{out['decode_ms_per_frame']:.3f} ms a frame (2 images); ATE {ate:.4f} m, "
          f"{e['ate_pct']:.3f} % of the {path:.3f}-m path, worst aligned error "
          f"{out['worst_err_m']:.3f} m; {n_ext} extractions, launches {launches}")
    return out


def replay_cli_body(kind, yml, states_csv, dev, graphed, **overrides):
    """Replay the dataset that the configuration `yml` names as the replay
    CLI of `kind` ("euroc" or "kitti") does (`load_config` with
    `overrides`, `VisualInertialSLAM`, the reader's loop, states.csv),
    with `graphed` chosen: the CLIs' yardstick (`graphed=False`) and their
    body with keyframe full BA."""
    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch import slam as slam_mod
    from pose_estimation_tpu_torch.io import euroc as euroc_io
    from pose_estimation_tpu_torch.io import kitti as kitti_io
    from pose_estimation_tpu_torch.utils.config import _parse_opencv_yaml

    cfg = load_config(yml, dataset=kind, **overrides)
    slam = slam_mod.VisualInertialSLAM(cfg, device=dev, graphed=graphed)
    if kind == "euroc":
        euroc_io.run_euroc(slam, euroc_io.EurocDataset(cfg.dataset_path),
                           speed_up=cfg.speed_up)
    else:
        raw = _parse_opencv_yaml(yml)
        kitti_io.run_kitti(slam, kitti_io.KittiDataset(cfg.dataset_path),
                           int(raw.get("maxNumImu", 10**9)), int(raw.get("maxNumImage", 10**9)),
                           cfg.sampling_rate // cfg.camera_frequency)
    slam.save_results(str(states_csv))
    return slam


def entry_point_checks(dev) -> dict:
    """Phase 10: the entry points. Writes a EuRoC-format directory at
    752x480 and a KITTI raw directory at 1242x375 from the simulator (PNGs
    whose rows cycle through the five filters), holds the C PNG unfilter
    bit-equal to its numpy twin on every written frame, replays the EuRoC
    directory through `run_euroc.main` (K1 and K2), again through the
    CLI's body with keyframe full BA (`load_config(..., full_ba_keyframes=
    True)` -> VisualInertialSLAM -> `io.euroc.run_euroc`), and the KITTI
    directory through `run_kitti.main` (K3 and K2), all graphed, and each
    dataset again through the CLI's body eagerly (`replay_cli_body`,
    `graphed=False`), whose states.csv must equal the graphed one's, each
    under `check_replay`'s gates. Then the EuRoC directory again through the
    CLI's body, unprofiled, in turns: without a viewer, with a `LiveViewer`
    attached (pushes only: the card's machine has no matplotlib to render
    with), which must get one pose per OK frame, one keyframe commit per
    keyframe and the landmarks every `viewer_landmark_every` frames, and
    with `staged=True`, each stage timed. Returns the phase's numbers."""
    import tempfile
    from pathlib import Path

    from pose_estimation_tpu_torch import load_config, run_euroc, run_kitti
    from pose_estimation_tpu_torch import slam as slam_mod
    from pose_estimation_tpu_torch.io import euroc as euroc_io
    from pose_estimation_tpu_torch.live_viewer import LiveViewer
    from pose_estimation_tpu_torch.io import png
    from pose_estimation_tpu_torch.testing import sim_config, write_euroc, write_kitti

    out = {}
    with tempfile.TemporaryDirectory() as tmp, counted_solves() as solves:
        out["solves"] = solves
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ecfg = sim_config(**ENTRY_EUROC)
        e_yml, mav0, n_e = write_euroc(tmp / "euroc", ecfg, ENTRY_EUROC_S)
        kcfg = kitti_config()
        k_yml, _, n_k, kgt = write_kitti(tmp / "kitti", kcfg, ENTRY_KITTI_S)
        written = sorted(tmp.rglob("*.png"))
        print(f"entry points: wrote {n_e} EuRoC frames at {ecfg.image_width}x"
              f"{ecfg.image_height} and {n_k} KITTI frames at {kcfg.image_width}x"
              f"{kcfg.image_height} ({len(written)} PNGs) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        c_s = 0.0
        for path in written:
            rows = png.read_filtered(str(path))
            t1 = time.perf_counter()
            got = png.unfilter(rows)
            c_s += time.perf_counter() - t1
            if not np.array_equal(got, png.unfilter_plain(rows)):
                fail(f"PNG unfilter: the C unfilter differs from its numpy twin on {path.name}")
        print(f"PNG unfilter: C bit-equal to the numpy twin on all {len(written)} written "
              f"frames (every row filter type); C {c_s * 1e3 / len(written):.3f} ms an image, "
              f"check {time.perf_counter() - t0:.1f} s")
        out["png_frames_checked"] = len(written)

        gt = euroc_io.EurocDataset(str(mav0)).ground_truth()
        for label, full, eager in (("EuRoC CLI", False, False), ("EuRoC, eager", False, True),
                                   ("EuRoC, full BA", True, False),
                                   ("EuRoC, full BA, eager", True, True)):
            key = ("euroc_full_ba" if full else "euroc") + ("_eager" if eager else "")
            csv = tmp / f"states_{key}.csv"
            zero_counters()
            with observed_replays(profile=eager) as made:
                t0 = time.perf_counter()
                if not (full or eager):
                    run_euroc.main(["--config", str(e_yml), "--out", str(csv), "--ate"])
                else:
                    replay_cli_body("euroc", e_yml, csv, dev, graphed=not eager,
                                    **({"full_ba_keyframes": True} if full else {}))
                wall = time.perf_counter() - t0
            (slam,) = made
            if slam.device != dev or slam.static.full_ba_keyframes != full \
                    or slam.graphed == eager:
                fail(f"{label}: ran on {slam.device} with full BA "
                     f"{slam.static.full_ba_keyframes}, graphed {slam.graphed}")
            r = check_replay(label, slam, gt, csv, counters(), ("fast_select", "sample_patches"))
            frames = slam.observed["frames"]
            kf = [is_keyframe(f["metrics"]) for f in frames]
            for name, pick in (("keyframe", True), ("other", False)):
                counted = [f["device_kernels"] for f, k in zip(frames, kf)
                           if k == pick and f["device_kernels"]]
                r[f"device_kernels_{name}"] = float(np.mean(counted)) if counted else None
                if full and eager:
                    iters = [int(f["full_ba_iters"]) for f, k in zip(frames, kf) if k == pick]
                    r[f"full_ba_iters_{name}"] = float(np.mean(iters)) if iters else None
            n_prof = sum(f["device_kernels"] is not None for f in frames)
            r.update(keyframes=sum(kf), wall_s=wall, profiled_frames=n_prof)
            if not eager:
                r["graphs"] = {**slam._graphs.stats(), **slam._solve_graphs.stats()}
                print(f"  {label}: {sum(kf)} keyframes of {len(frames)} OK frames; graphs "
                      + "; ".join(graph_line(n, g) for n, g in r["graphs"].items())
                      + f"; {wall:.1f} s")
            else:
                graphed = out[key[:-len("_eager")]]
                same = csv.read_text() == (tmp / f"states_{key[:-len('_eager')]}.csv").read_text()
                r["bit_equal_to_graphed"] = same
                print(f"  {label}: {sum(kf)} keyframes of {len(frames)} OK frames; kernels a "
                      f"frame by the profiler ({n_prof} OK frames from {ENTRY_PROFILE_FROM}): "
                      f"keyframe {r['device_kernels_keyframe']}, other "
                      f"{r['device_kernels_other']}"
                      + (f"; full-BA LM iterations: keyframe {r['full_ba_iters_keyframe']}, "
                         f"other {r['full_ba_iters_other']} (computed, not kept)" if full else "")
                      + f"; {r['ms_per_ok_frame']:.2f} ms per OK frame against "
                      f"{graphed['ms_per_ok_frame']:.2f} graphed; states.csv "
                      + ("bit-equal to the graphed replay's" if same else "DIFFERS")
                      + f"; {wall:.1f} s")
                if not same:
                    fail(f"{label}: states.csv differs from the graphed replay's")
            out[key] = r

        for key, eager in (("kitti", False), ("kitti_eager", True)):
            kcsv = tmp / f"states_{key}.csv"
            zero_counters()
            with observed_replays() as made:
                if eager:
                    replay_cli_body("kitti", k_yml, kcsv, dev, graphed=False)
                else:
                    run_kitti.main(["--config", str(k_yml), "--out", str(kcsv)])
            (slam,) = made
            if slam.graphed == eager:
                fail(f"KITTI: graphed {slam.graphed} in the {key} replay")
            out[key] = check_replay("KITTI, eager" if eager else "KITTI CLI", slam, kgt, kcsv,
                                    counters(), ("fast_score_nms", "sample_patches"))
        same = ((tmp / "states_kitti.csv").read_text()
                == (tmp / "states_kitti_eager.csv").read_text())
        out["kitti_eager"]["bit_equal_to_graphed"] = same
        print(f"  KITTI CLI: {out['kitti']['ms_per_ok_frame']:.2f} ms per OK frame graphed, "
              f"{out['kitti_eager']['ms_per_ok_frame']:.2f} eager; states.csv "
              + ("bit-equal" if same else "DIFFERS"))
        if not same:
            fail("KITTI CLI: the eager replay's states.csv differs from the graphed one's")

        class CountingViewer(LiveViewer):
            """A LiveViewer that counts its pose, keyframe and landmark pushes."""

            def __init__(self):
                super().__init__(out_path=None, port=None, window_size=cfg.window_size)
                self.pushes = {"pose": 0, "keyframe": 0, "landmark": 0}

            def push_pose(self, R, p):
                self.pushes["pose"] += 1
                super().push_pose(R, p)

            def push_keyframe(self):
                self.pushes["keyframe"] += 1
                super().push_keyframe()

            def push_landmark(self, points, valid=None):
                self.pushes["landmark"] += 1
                super().push_landmark(points, valid)

        cfg = load_config(e_yml, dataset="euroc")
        for key, label in (("euroc_plain", "EuRoC, no viewer"), ("euroc_viewer", "EuRoC, viewer"),
                           ("euroc_staged", "EuRoC, staged")):
            csv = tmp / f"states_{key}.csv"
            viewer = CountingViewer() if key == "euroc_viewer" else None
            zero_counters()
            with observed_replays() as made, \
                    (timed_stages(graphed=True) if key == "euroc_staged"
                     else contextlib.nullcontext()) as timers:
                slam = slam_mod.VisualInertialSLAM(cfg, device=dev,
                                                   staged=key == "euroc_staged")
                if viewer is not None:
                    slam.set_viewer(viewer)
                euroc_io.run_euroc(slam, euroc_io.EurocDataset(str(mav0)),
                                   speed_up=cfg.speed_up)
                slam.save_results(str(csv))
            r = check_replay(label, slam, gt, csv, counters(), ("fast_select", "sample_patches"))
            frames = slam.observed["frames"]
            if viewer is not None:
                want = {"pose": len(frames), "landmark": slam._frame_count
                        // slam.viewer_landmark_every,
                        "keyframe": sum(bool(f["metrics"]["is_keyframe"]) for f in frames)}
                pos, raw, pose, lms, _ = viewer._snapshot()
                if viewer.pushes != want or slam._frame_count != len(frames) \
                        or not np.isfinite(pos).all() or len(pos) < cfg.window_size \
                        or pose is None:
                    fail(f"{label}: pushes {viewer.pushes}, expected {want} "
                         f"({slam._frame_count} OK frames; {len(pos)} positions)")
                r["pushes"] = viewer.pushes
                print(f"  {label}: pushes {viewer.pushes} over {len(frames)} OK frames, as "
                      f"expected; {r['ms_per_ok_frame']:.2f} ms per OK frame against "
                      f"{out['euroc_plain']['ms_per_ok_frame']:.2f} without a viewer")
            if timers is not None:
                r["stage_ms"] = stage_split(timers)
                if any((f["launches"]["fast_select"], f["launches"]["sample_patches"])
                       != (f["extractions"],) * 2 or not f["extractions"] for f in frames):
                    fail(f"{label}: launches per OK frame {[f['launches'] for f in frames]}, "
                         f"extractions {[f['extractions'] for f in frames]}")
                print(f"  {label}: per OK frame, each stage synchronized: "
                      + ", ".join(f"{k} {v:.2f}" for k, v in r["stage_ms"].items())
                      + f" ms, sum {sum(r['stage_ms'].values()):.2f}, against "
                      f"{r['ms_per_ok_frame']:.2f} ms per staged OK frame and "
                      f"{out['euroc_plain']['ms_per_ok_frame']:.2f} fused")
            out[key] = r
    return out


def main() -> None:
    import torch

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.slam import State
    from pose_estimation_tpu_torch.testing import (GATE_ATE_PCT, GATE_BA, GATE_BG,
                                                   StereoInertialSim, run_errors,
                                                   seeded_state, sim_frames,
                                                   synthetic_config)
    from pose_estimation_tpu_torch.utils.precision import require_cuda
    from pose_estimation_tpu_torch.utils.tree import tree_leaves

    # ---- phase 1: the card
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build the kernels
    lib_path, build_s, log = kernels.build()
    kernels.library()
    print(f"kernels built in {build_s:.1f} s -> {lib_path.name}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- phase 3: each kernel against its twin at the paths' shapes
    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    t0 = time.perf_counter()
    frames, gyrs, accs, mask, truth = sim_frames(cfg, N_FRAMES, n_landmarks=1200)
    print(f"sim: {N_FRAMES} frames of {cfg.image_width}x{cfg.image_height} "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    kcfg = kitti_config()
    k = kernel_checks(dev, cfg, np.stack(frames[0]), kcfg)

    # ---- phase 3b: K6 against its twin at the shapes of its paths
    k6 = k6_checks(dev)

    # ---- phase 4: the frame step over the sim, from the true start pose,
    # on the kernel path and on the map-based front end
    inputs = [
        tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
        for i in range(N_FRAMES)
    ]

    # ---- phase 3c: the eager steps and solves wait for the card nowhere
    syncs = sync_checks(dev, cfg, consts, static, inputs, truth)
    count_replays()

    # ---- phase 3d: the log-depth IMU preintegration against its loop
    imu = imu_checks(dev, consts, static, inputs, truth)

    def run_chain(label, static, seed=0):
        """N_FRAMES chained ok_steps from the seeded window, the RANSAC
        draws from `seed`. Returns (launches, ms per frame after the
        warm-up, the largest error in m beyond DIVERGED_PER_M x distance)."""
        state = seeded_state(static, truth, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.synchronize()
        zero_counters()
        metrics = []
        t_start = t_warm = time.perf_counter()
        for i in range(N_FRAMES):
            if i == WARMUP:
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
            state, m = vio.ok_step(state, *inputs[i], gen, consts, static)
            metrics.append(m)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = counters()
        ms_frame = (t_end - t_warm) * 1e3 / (N_FRAMES - WARMUP)
        print(f"{label}: {N_FRAMES} frames in {t_end - t_start:.2f} s; chained "
              f"{ms_frame:.2f} ms/frame over frames {WARMUP}-{N_FRAMES - 1}; "
              f"launches {launches}")
        dist, excess = 0.0, -math.inf
        for i, m in enumerate(metrics):
            dist += float(np.linalg.norm(truth(i + 1)[1] - truth(i)[1]))
            err = float(np.linalg.norm(m["rec_p"].cpu().numpy() - truth(i + 1)[1]))
            excess = max(excess, err - DIVERGED_PER_M * dist)
            print(f"  frame {i:2d}: stereo {int(m['n_stereo']):4d} "
                  f"tracked {int(m['n_tracked']):4d} "
                  f"ba_iters {int(m['ba_iters']):2d} kf {int(m['is_keyframe'])} "
                  f"pool {int(m['pool_size']):4d} |p - p_true| {err:.4f} m "
                  f"(travelled {dist:.3f} m)")
            if i >= WARMUP and (int(m["n_tracked"]) <= 0 or int(m["ba_iters"]) <= 0):
                fail(f"{label} frame {i}: tracking or BA dead after the warm-up")
            if not float(m["ba_cost"]) >= 0.0:
                fail(f"{label} frame {i}: BA cost {float(m['ba_cost'])} is negative "
                     "or not finite")
            if not err <= DIVERGED_PER_M * dist + RUNAWAY_M:
                fail(f"{label} frame {i}: ran away, {err:.3f} m from the truth "
                     f"after {dist:.3f} m")
        leaves = [t for t in (*state.win[:5], *state.win.ics, state.pool.pos, *state.preint)
                  if t.is_floating_point()]
        if not all(bool(torch.isfinite(t).all()) for t in leaves):
            fail(f"{label}: non-finite state")
        return launches, ms_frame, excess

    launches, ms_frame, excess = run_chain("ok_step", static)
    if excess > DIVERGED_M:
        fail(f"ok_step: diverged, {excess:.3f} m beyond {DIVERGED_PER_M} x the distance")
    if (launches["fast_select"], launches["sample_patches"]) != (N_FRAMES, N_FRAMES):
        fail(f"ok_step on the kernel path must launch K1 and K2 once a frame "
             f"({N_FRAMES} frames): {launches}")
    if launches["fast_score_nms"] or launches["moment_maps"]:
        fail(f"ok_step on the kernel path at a width divisible by 16 launched K3 or K4: "
             f"{launches}")
    if launches["eigh"] != N_FRAMES or launches["svd"]:
        fail(f"ok_step must launch K6's eigh once a frame (the PSD clip) and its svd never "
             f"({N_FRAMES} frames): {launches}")
    full_static = dataclasses.replace(static, full_ba_keyframes=True)
    full_launches, full_ms_frame, full_excess = run_chain(
        "ok_step, keyframe full BA", full_static)
    if full_excess > DIVERGED_M:
        fail(f"ok_step with full BA: diverged, {full_excess:.3f} m beyond {DIVERGED_PER_M} x "
             "the distance")
    if (full_launches["fast_select"], full_launches["sample_patches"]) != (N_FRAMES, N_FRAMES):
        fail(f"ok_step with full BA: launches {full_launches} in {N_FRAMES} frames")
    print(f"keyframe full BA: {full_ms_frame:.2f} ms/frame beside {ms_frame:.2f} without")
    map_static = dataclasses.replace(static, orb=static.orb._replace(**MAP_FRONT))
    map_chains = [run_chain(f"ok_step, map front end, seed {seed}", map_static, seed)
                  for seed in MAP_SEEDS]
    for chain_launches, _, _ in map_chains:
        if (chain_launches["fast_select"], chain_launches["moment_maps"]) \
                != (N_FRAMES, N_FRAMES) \
                or chain_launches["sample_patches"] or chain_launches["fast_score_nms"]:
            fail(f"the map front end must launch K1 and K4 once per frame and K2 and K3 "
                 f"never: {chain_launches}")
    map_launches, map_ms_frame, _ = map_chains[0]
    map_excess = [x for _, _, x in map_chains]
    map_held = sum(x <= DIVERGED_M for x in map_excess)
    print(f"map front end: {map_held} of {len(MAP_SEEDS)} chains within {DIVERGED_PER_M} x "
          f"distance + {DIVERGED_M} m (largest excess per chain, m: "
          f"{[round(x, 3) for x in map_excess]}); seed 0 {map_ms_frame:.2f} ms/frame beside "
          f"the kernel path's {ms_frame:.2f}")
    if 2 * map_held < len(MAP_SEEDS):
        fail(f"map front end: only {map_held} of {len(MAP_SEEDS)} chains hold the bound")

    # ---- phase 4b: the staged OK path and ok_scan on the kernel path's chain
    staged = staged_checks(dev, consts, static, inputs, truth)

    # ---- phase 4c: the captured graphs against the eager steps
    graphed = graph_checks(dev, consts, static, inputs, truth, frames, gyrs, accs, mask)

    # ---- phase 5: the kernel path against the CPU twin path on a small
    # input. The CPU path is the one tests/test_torch_vio.py holds to the
    # JAX package (same tolerances: 5 mm, counts within 2 %, LM capped at 4
    # iterations because the seeded window's BA is ill posed).
    scfg = synthetic_config(width=160, height=128, levels=3, features=200,
                            camera_frequency=40, imu_chunk=8, max_num_iterations=4)
    sframes, sgyrs, saccs, smask, struth = sim_frames(scfg, 5, n_landmarks=250)
    ugen = torch.Generator().manual_seed(1)
    us = [vio.draw_ransac_uniforms(ugen, "cpu") for _ in sframes]
    paths = {}
    for where in (dev, torch.device("cpu")):
        c, s = vio.build_constants(scfg, CameraModel.from_config(scfg), where)
        st = seeded_state(s, struth, where)
        out = []
        for i in range(len(sframes)):
            args = (torch.from_numpy(a).to(where) for a in
                    (sframes[i][0], sframes[i][1], sgyrs[i], saccs[i], smask))
            st, m = vio.ok_step(st, *args, None, c, s,
                                ransac_u=tuple(u.to(where) for u in us[i]))
            out.append((m["rec_p"].cpu().numpy(), int(m["n_stereo"]), int(m["n_tracked"])))
        paths[where.type] = out
    worst = 0.0
    for i, ((pg, sg, tg), (pc, sc, tc)) in enumerate(zip(paths["cuda"], paths["cpu"])):
        worst = max(worst, float(np.linalg.norm(pg - pc)))
        if abs(sg - sc) > 0.02 * sc or abs(tg - tc) > 0.02 * max(tc, 1):
            fail(f"small run frame {i}: counts cuda {sg}/{tg} vs cpu {sc}/{tc}")
    if worst > 5e-3:
        fail(f"small run: kernel path {worst:.2e} m from the CPU twin path (> 5 mm)")
    print(f"small run (160x128, 5 frames): kernel path within {worst:.2e} m of the "
          f"CPU twin path; tracked {[t for _, _, t in paths['cuda']]}")

    # ---- phase 6: drift at full pyramid depth against the JAX package's
    mcfg = synthetic_config(**MID)
    mc, ms = vio.build_constants(mcfg, CameraModel.from_config(mcfg), dev)
    mframes, mgyrs, maccs, mmask, mtruth = sim_frames(mcfg, MID_FRAMES, n_landmarks=MID_LANDMARKS)
    minputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (mframes[i][0], mframes[i][1], mgyrs[i], maccs[i], mmask))
               for i in range(MID_FRAMES)]
    mid_err = []
    t0 = time.perf_counter()
    for seed in range(MID_SEEDS):
        st = seeded_state(ms, mtruth, dev)
        mgen = torch.Generator(device=dev).manual_seed(seed)
        for i in range(MID_FRAMES):
            st, m = vio.ok_step(st, *minputs[i], mgen, mc, ms)
        p = m["rec_p"].cpu().numpy()
        if not np.isfinite(p).all():
            fail(f"full-depth chain {seed}: non-finite position")
        mid_err.append(float(np.linalg.norm(p - mtruth(MID_FRAMES)[1])))
    mid_median = float(np.median(mid_err))
    print(f"full depth (384x240, 8 levels, {MID_FRAMES} frames, {MID_SEEDS} seeds, "
          f"{time.perf_counter() - t0:.1f} s): final position error median {mid_median:.4f} m, "
          f"range {min(mid_err):.4f}-{max(mid_err):.4f} m; the JAX package's median "
          f"{JAX_MID_MEDIAN_M} m, bound {MID_RATIO}x")
    if mid_median > MID_RATIO * JAX_MID_MEDIAN_M:
        fail(f"full-depth drift: median {mid_median:.4f} m > {MID_RATIO} x {JAX_MID_MEDIAN_M} m")

    # ---- phase 9 (run here, before the state machines): many sequences
    # in one frame step, and a checkpoint
    batched_res = batched_checks(dev, consts, static, frames, gyrs, accs, mask, truth)

    # ---- phase 7: the host state machine at KITTI width (K3's route),
    # graphed (the default), then eager: the same run bit for bit
    kworld = StereoInertialSim(kcfg, n_landmarks=150, seed=0)
    zero_counters()
    t0 = time.perf_counter()
    with counted_solves() as kitti_solves:
        kslam, kgt, kframes, k_extract = run_state_machine(kcfg, kworld, 6.0, 10, 0, dev)
    kitti_launches = counters()
    k_wall = time.perf_counter() - t0
    check_frame_replays("KITTI width", kframes)
    if not (kitti_launches["eigh"] and kitti_launches["svd"]):
        fail(f"KITTI width: launches {kitti_launches} (K6's eigh and svd in the SfM frames, "
             "its eigh in every OK frame's clip)")
    if kslam.state != State.OK or not kframes:
        fail(f"KITTI width: the state machine ended in {kslam.state.name} "
             f"after {len(kframes)} OK frames")
    if (kitti_launches["fast_score_nms"], kitti_launches["sample_patches"]) \
            != (k_extract, k_extract) or kitti_launches["fast_select"]:
        fail(f"KITTI width: launches {kitti_launches} (K3 and K2 once an extraction, K1 "
             "never)")
    for i, fr in enumerate(kframes):
        n = fr["launches"]
        if n["fast_select"] or n["sample_patches"] != n["fast_score_nms"] \
                or not n["fast_score_nms"]:
            fail(f"KITTI width, OK frame {i}: launches {n} (K3 and K2 once an extraction, "
                 "at least once, K1 never)")
        cost = float(fr["metrics"]["ba_cost"])
        if not cost >= 0.0:
            fail(f"KITTI width, OK frame {i}: BA cost {cost} is negative or not finite")
    win = kslam.vio.win
    if not all(bool(torch.isfinite(t).all()) for t in (*win[:5], kslam.vio.pool.pos)):
        fail("KITTI width: non-finite state")
    ke = run_errors(kslam, kgt)
    k_err, k_dist = ke["err"], ke["dist"]
    if (k_err > DIVERGED_PER_M * k_dist + DIVERGED_M).any():
        i = int(np.argmax(k_err - DIVERGED_PER_M * k_dist))
        fail(f"KITTI width: frame {i} {k_err[i]:.3f} m off after {k_dist[i]:.3f} m")
    k_times = frame_times(kframes)
    kitti_ms, kitti_median = k_times["mean_ms"], k_times["median_ms"]
    kitti_graphs = {**kslam._graphs.stats(), **kslam._solve_graphs.stats()}
    with count_prior_clip() as kitti_clip:
        eslam, _, eframes, _ = run_state_machine(
            kcfg, StereoInertialSim(kcfg, n_landmarks=150, seed=0), 6.0, 10, 0, dev,
            graphed=False)
    ke_times = frame_times(eframes)
    kitti_eager_ms, kitti_eager_median = ke_times["mean_ms"], ke_times["median_ms"]
    kitti_same = (np.array_equal(kslam.trajectory, eslam.trajectory)
                  and all(torch.equal(a, b) for a, b in zip(tree_leaves(kslam.vio),
                                                            tree_leaves(eslam.vio))))
    print(f"state machine at KITTI width ({kcfg.image_width}x{kcfg.image_height}, "
          f"{kcfg.level_pyramid} levels, {kcfg.num_features} features, 6 s, "
          f"{k_wall:.1f} s): {len(kframes)} OK frames, {kitti_ms:.2f} ms/frame over them "
          f"graphed (median {kitti_median:.2f}; the first, which captures, left out), "
          f"{kitti_eager_ms:.2f} eager (median {kitti_eager_median:.2f}); "
          f"ATE {ke['ate_pct']:.3f} % of path, |ba| {ke['ba']:.4f}, |bg| {ke['bg']:.5f}, "
          f"worst aligned error {k_err.max():.3f} m; {k_extract} extractions, launches "
          f"{kitti_launches}; marginalization clip (eager run) {kitti_clip}; solve calls, "
          f"eager first calls and replays {kitti_solves}; graphs "
          + "; ".join(graph_line(n, g) for n, g in kitti_graphs.items())
          + "; the eager run's trajectory and state "
          + ("bit-equal" if kitti_same else "DIFFER"))
    print(f"  KITTI width, graphed: {frame_times_line(k_times)}")
    print(f"  KITTI width, eager: {frame_times_line(ke_times)}")
    if not kitti_same:
        fail("KITTI width: the graphed state machine differs from the eager one")

    # the accuracy protocol's failures are raised after the later phases
    # (the entry points, the mesh) have run, so that one call reports them
    # all; the run still fails
    deferred = []

    def defer(msg):
        print(f"FAIL (raised at the end of the run): {msg}", flush=True)
        deferred.append(msg)

    # ---- phase 8: the accuracy protocol (benchmarks/chip_accuracy.py), its
    # runs in worker processes that share the card, the longest first
    jobs = ([(run, 0, "cuda", "kernel") for run in HARD_RUNS]
            + [("KITTI-dense", 0, "cuda", "kernel"), ("A2", 0, "cuda", "map"),
               ("A2-p3p", 0, "cuda", "kernel")]
            + [(run, s, "cuda", "kernel") for run in RATE_RUNS for s in RATE_SEEDS])
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(PROTOCOL_WORKERS) as pool:
        results = pool.map(protocol_worker, jobs, chunksize=1)
        pool.close()
        pool.join()
    print(f"accuracy protocol: {len(jobs)} runs in {PROTOCOL_WORKERS} worker processes, "
          f"{time.perf_counter() - t0:.1f} s")
    for r in results:
        if "error" in r:
            defer(f"accuracy {r['run']} seed {r['seed']} ({r['front']} front end) raised:\n"
                  + r["error"])
    results = [r for r in results if "error" not in r]
    for r in results:
        name = f"{r['run']} seed {r['seed']}" + (" (map front end)" if r["front"] == "map"
                                                  else "")
        if r["state"] != "OK" or not r["ok_frames"]:
            defer(f"accuracy {name}: the state machine ended in {r['state']} "
                 f"after {r['ok_frames']} OK frames")
        if not r["finite"] or r["over_divergence_m"] > DIVERGED_M:
            defer(f"accuracy {name}: diverged (worst aligned error {r['worst_err_m']:.3f} m)")
        n = r["launches"]
        if r["front"] == "map":
            if (n["moment_maps"], n["fast_select"]) != (r["extractions"], r["extractions"]) \
                    or n["sample_patches"] or n["fast_score_nms"]:
                defer(f"accuracy {name}: launches {n} in {r['extractions']} extractions "
                     "(K1 and K4 once each, K2 and K3 never)")
        elif r["run"] == "KITTI-dense":
            if (n["fast_score_nms"], n["sample_patches"]) != (r["extractions"],) * 2 \
                    or n["fast_select"] or n["moment_maps"]:
                defer(f"accuracy {name}: launches {n} in {r['extractions']} extractions "
                     "(K3 and K2 once each, K1 and K4 never)")
        elif (n["fast_select"], n["sample_patches"]) != (r["extractions"],) * 2 \
                or n["fast_score_nms"] or n["moment_maps"]:
            defer(f"accuracy {name}: launches {n} in {r['extractions']} extractions (K1 and "
                 "K2 once each, K3 and K4 never)")
        if not (n["eigh"] and n["svd"]):
            defer(f"accuracy {name}: launches {n} (K6's eigh in the clip and the PnP, its svd "
                 "in the PnP)")
        line = (f"accuracy {name}: ATE {r['ate_pct']:.3f} % of path, |ba| {r['ba']:.4f}, "
                f"|bg| {r['bg']:.5f} -> {'pass' if r['pass'] else 'miss'}; "
                f"{r['ok_frames']} OK frames, {r['ms_per_ok_frame']:.2f} ms each "
                f"({PROTOCOL_WORKERS} processes share the card); {r['seconds']:.1f} s")
        if r["front"] == "map" or r["run"] in EXTRA_RUNS:
            line += f"; {r['extractions']} extractions, launches {n}"
        elif r["seed"] == 0:
            j_ate, j_ba, j_bg = JAX_RECORD[r["run"]]
            line += (f"; the JAX package on a TPU (CHIP_ACCURACY_r05): ATE {j_ate} %, "
                     f"|ba| {j_ba}, |bg| {j_bg}")
        print(line)
    extra = [r for r in results if r["front"] == "map" or r["run"] in EXTRA_RUNS]
    results = [r for r in results if r not in extra]
    for r in extra:     # held to 3 x the gates; the gate verdict is printed above
        if not (r["ate_pct"] < RUNAWAY * GATE_ATE_PCT and r["ba"] < RUNAWAY * GATE_BA
                and r["bg"] < RUNAWAY * GATE_BG):
            defer(f"accuracy {r['run']} ({r['front']} front end): ATE {r['ate_pct']:.3f} %, "
                 f"|ba| {r['ba']:.4f}, |bg| {r['bg']:.5f} beyond {RUNAWAY} x the gates")
    for r in results:
        if r["run"] in HARD_RUNS and not r["pass"]:
            defer(f"accuracy {r['run']} seed 0: ATE {r['ate_pct']:.3f} %, |ba| {r['ba']:.4f}, "
                 f"|bg| {r['bg']:.5f} outside ATE < {GATE_ATE_PCT} %, |ba| < {GATE_BA}, "
                 f"|bg| < {GATE_BG}")
        if r["run"] in RATE_RUNS and not (r["ate_pct"] < RUNAWAY * GATE_ATE_PCT
                                          and r["ba"] < RUNAWAY * GATE_BA
                                          and r["bg"] < RUNAWAY * GATE_BG):
            defer(f"accuracy {r['run']} seed {r['seed']}: ATE {r['ate_pct']:.3f} %, "
                 f"|ba| {r['ba']:.4f}, |bg| {r['bg']:.5f} beyond {RUNAWAY} x the gates")
    for run, (j_pass, j_n) in RATE_RUNS.items():
        got = sum(r["pass"] for r in results if r["run"] == run)
        need = min_passes(len(RATE_SEEDS), j_pass, j_n, RATE_ALPHA)
        print(f"accuracy {run}: {got} of {len(RATE_SEEDS)} seeds pass the gates, at least "
              f"{need} needed (the JAX package passes {j_pass} of {j_n} keys; at that rate "
              f"fewer than {need} passes come with probability below {RATE_ALPHA})")
        if got < need:
            defer(f"accuracy {run}: {got} of {len(RATE_SEEDS)} passes, fewer than {need}")

    # ---- phase 10: the entry points (the replay CLIs, their datasets and
    # configuration files written here)
    t0 = time.perf_counter()
    entry = entry_point_checks(dev)
    print(f"entry points: {time.perf_counter() - t0:.1f} s")

    # ---- phase 11: the (data x model) mesh over processes sharing the card
    mesh = mesh_checks(dev)

    loaded = sorted(
        k for k, v in sys.modules.items() if v is not None
        and (k in ("jax", "pose_estimation_tpu")
             or k.startswith(("jax.", "jaxlib", "pose_estimation_tpu."))))
    if loaded:
        fail(f"the run imported JAX or the JAX package: {loaded[:5]}")

    # K4 has a library time, one conv2d computes its maps, and K6 has two,
    # torch.linalg.eigh and svd. No single PyTorch call computes what K1,
    # K2, K3 or K5 computes. Launches are those of the paths' runs, each
    # counted from zero: the main path (the EuRoC-width chain on the kernel
    # path for K1, K2 and K6's eigh, the KITTI-width state machine for K3
    # and K6's svd, the map front end's chain for K4, the probe's sweep for
    # K5), then the paths that run them beside it: the staged frames,
    # ok_scan, the graphed chains, staged frames, ok_scan and batched step
    # (launches run: each graph's recorded launches times its replays, and
    # the warm-up's), the unprofiled EuRoC replays without and with the
    # viewer and staged, and the mesh dry run's ranks. K6's headline
    # numbers are those of its most frequent call on the paths: the clip of
    # one frame's [45, 45] Schur complement (eigh), the proper rotations'
    # [512, 3, 3] (svd); every shape's are in "shapes".
    main_launches = {"fast_select": launches["fast_select"],
                     "sample_patches": launches["sample_patches"],
                     "fast_score_nms": kitti_launches["fast_score_nms"],
                     "moment_maps": map_launches["moment_maps"],
                     "stream_probe": k["stream_probe"]["launches"],
                     "eigh": launches["eigh"], "svd": kitti_launches["svd"]}
    by_path = {name: {"main": n} for name, n in main_launches.items()}
    for path, counts in (("staged", staged["launches"]), ("ok_scan", staged["scan_launches"]),
                         ("graphed_chain", graphed["chain"]["launches"]),
                         ("graphed_map_chain", graphed["map_chain"]["launches"]),
                         ("graphed_staged", graphed["staged"]["launches"]),
                         ("graphed_ok_scan", graphed["ok_scan"]["launches"]),
                         ("graphed_batched", graphed["batched"]["launches"]),
                         *((key, entry[key]["launches"]) for key in
                           ("euroc_plain", "euroc_viewer", "euroc_staged")),
                         ("mesh_dryrun", mesh["launches"]),
                         ("kitti_state_machine", {"eigh": kitti_launches["eigh"]})):
        for name, n in counts.items():
            if n and name in by_path:
                by_path[name][path] = n
    sources = {"fast_select": ("fast_select.cu", "pose_estimation_tpu/ops/pallas_fast.py:160"),
               "sample_patches": ("sample_patches.cu",
                                  "pose_estimation_tpu/ops/pallas_sample.py:111"),
               "fast_score_nms": ("fast_score_nms.cu",
                                  "pose_estimation_tpu/ops/pallas_fast.py:34"),
               "moment_maps": ("moment_maps.cu", "pose_estimation_tpu/ops/pallas_fast.py:518"),
               "stream_probe": ("stream_probe.cu", "benchmarks/launch_overhead_exp.py:37"),
               "eigh": ("small_linalg.cu", "no pallas_call: the device-side jnp.linalg.eigh "
                        "of pose_estimation_tpu/ops/pnp.py:50"),
               "svd": ("small_linalg.cu", "no pallas_call: the device-side jnp.linalg.svd "
                       "of pose_estimation_tpu/ops/pnp.py:54")}
    k["eigh"] = dict(k6["eigh"]["clip"], err=k6["eigh"]["clip"]["w_err_rel"],
                     shapes=k6["eigh"])
    k["svd"] = dict(k6["svd"], err=k6["svd"]["reconstruction_rel"])
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": f"pose_estimation_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": k[name]["err"], "ms": k[name]["ms"], "plain_ms": k[name]["plain_ms"],
         "bound_ms": k[name]["bound"], "bound_by": k[name]["by"],
         "library_ms": k[name]["lib_ms"], "device_ms": k[name]["device_ms"],
         **{key: k[name][key] for key in ("kitti_width", "protocol", "shapes")
            if key in k[name]},
         **({"batched": dict(batched_res[name],
                             launches=batched_res["launches"][name])}
            if name in batched_res else {})}
        for name, (src, replaces) in sources.items()
    ], "ok_step_ms_per_frame": ms_frame, "map_ok_step_ms_per_frame": map_ms_frame,
        "kitti_ms_per_ok_frame": kitti_ms, "full_ba_ok_step_ms_per_frame": full_ms_frame,
        "kitti_eager_ms_per_ok_frame": kitti_eager_ms, "kitti_graphs": kitti_graphs,
        "kitti_median_ms": {"graphed": kitti_median, "eager": kitti_eager_median},
        "kitti_frame_times": {"graphed": k_times, "eager": ke_times},
        "entry_points": entry, "staged": staged, "graphed": graphed, "mesh": mesh,
        "sync_checks_s": syncs, "imu_preintegration": imu,
        "batched": {"batch": BATCH, "ms_per_step": batched_res["ms_per_step"],
                    "frames_per_s": batched_res["frames_per_s"],
                    "lane_p_err": batched_res["lane_p_err"],
                    "lanes_agree": batched_res["lanes_agree"],
                    "resume_diff": batched_res["resume_diff"],
                    "full_ba_vmap_ms": batched_res["full_ba_vmap_ms"],
                    "full_ba_lane_p_err": batched_res["full_ba_lane_p_err"]},
        "profiler_sessions_repeated": PROFILE_MISSES}
    print(json.dumps(summary))
    if deferred:
        fail("; ".join(deferred))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
