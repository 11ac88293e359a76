#!/usr/bin/env python3
"""The IMU stage's share of a graphed OK frame, for one checkout of the
PyTorch port on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/imu_turns.py [--root DIR]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout),
builds its kernels there, and on `chip_smoke.py` phase 4's EuRoC-width
chain (16 frames from the seeded window, RANSAC draws from seed 0; its
helpers are taken from this checkout) measures:

- the fused frame graph (`graphs.FrameGraphs.ok_step`): its nodes, ms a
  chained graphed frame over frames 6-15 (host clock to a synchronize),
  the LM iterations of those frames, and device ms a replay back to back
  (CUDA events);
- the staged graphs from frame 6's state (draws from seed 1): each
  stage's ms, each synchronized, and each graph's nodes; the `imu`
  graph's device ms a replay back to back;
- the overflow chunks' `integrate` graph: nodes and device ms a replay;
- `ok_scan` as one graph of 8 frames: nodes.

Prints the card's name and power limit and one JSON line. Compare two
commits inside one call, in turns: unpack the parent into a git-ignored
directory and run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose port is measured")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    import pose_estimation_tpu_torch
    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    kernels.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)

    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    n, warm = smoke.N_FRAMES, smoke.WARMUP
    frames, gyrs, accs, mask, truth = sim_frames(cfg, n, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(n)]

    # the fused frame, chained
    runner = graphs.FrameGraphs(seeded_state(static, truth, dev), consts, static, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    iters, start = [], None
    t0 = time.perf_counter()
    for i in range(n):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start = graphs.snapshot(runner.state)
        m = runner.ok_step(*inputs[i], vio.draw_ransac_uniforms(gen, dev))
        if i >= warm:
            iters.append(m["ba_iters"].clone())
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3 / (n - warm)
    frame_replay_ms = smoke.cuda_ms(runner.steps["frame"].graph.replay, reps=10, warm=2)

    # the staged frames from the chain's frame `warm`
    staged = graphs.FrameGraphs(start, consts, static, dev)
    ugen = torch.Generator(device=dev).manual_seed(1)
    with smoke.timed_stages(graphed=True) as timers:
        for i in range(warm, n):
            staged.staged_step(*inputs[i], vio.draw_ransac_uniforms(ugen, dev))
    stage_ms = {k: timers.total[k] * 1e3 / max(timers.count[k], 1)
                for k in ("imu", "frontend", "ba", "pool")}
    imu_replay_ms = smoke.cuda_ms(staged.steps["imu"].graph.replay, reps=20, warm=2)
    for i in range(warm, warm + 2):
        staged.integrate(*inputs[i][2:5])
    integrate_replay_ms = smoke.cuda_ms(staged.steps["integrate"].graph.replay, reps=20, warm=2)
    staged_stats = staged.stats()

    # ok_scan's graph
    runner.load_state(start)
    stacked = [torch.stack([inputs[i][k] for i in range(warm, warm + smoke.SCAN_FRAMES)])
               for k in range(5)]
    runner.ok_scan(*stacked, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    fused_stats = runner.stats()

    print(smi.stdout.strip())
    print(json.dumps({
        "root": root,
        "nodes": {"imu": staged_stats["imu"]["nodes"], "frame": fused_stats["frame"]["nodes"],
                  "integrate": staged_stats["integrate"]["nodes"],
                  "scan": fused_stats["scan"]["nodes"],
                  "staged": {k: staged_stats[k]["nodes"] for k in stage_ms}},
        "chained_graphed_frame_ms": frame_ms,
        "lm_iterations": [int(x) for x in iters],
        "frame_replay_device_ms": frame_replay_ms,
        "staged_ms": stage_ms,
        "imu_replay_device_ms": imu_replay_ms,
        "integrate_replay_device_ms": integrate_replay_ms}))


if __name__ == "__main__":
    main()
