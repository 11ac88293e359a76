#!/usr/bin/env python3
"""End-to-end frame times of one checkout of the PyTorch port on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/e2e_pair.py [--root DIR]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout),
builds its kernels there, and measures the port's two end-to-end times as
`chip_smoke.py` does (its helpers are taken from this checkout): the
chained `ok_step` ms/frame over frames 6-15 of 16 EuRoC-width frames from
the seeded window on the kernel path (phase 4), and the state machine's ms
per OK frame at KITTI width over 6 s (phase 7), each with the LM
iterations of the timed frames (the work a frame does depends on how well
it tracks, which a kernel's last bits can change). Prints the card and one
JSON line. The host clock spreads between calls, so two commits are
compared inside one call, in turns: unpack the parent into a git-ignored
directory and run parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
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
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.slam import State
    from pose_estimation_tpu_torch.testing import (StereoInertialSim, seeded_state,
                                                   sim_frames, synthetic_config)
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    kernels.build()

    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    frames, gyrs, accs, mask, truth = sim_frames(cfg, smoke.N_FRAMES, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(smoke.N_FRAMES)]
    state = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t_warm = time.perf_counter()
    metrics = []
    for i in range(smoke.N_FRAMES):
        if i == smoke.WARMUP:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        state, m = vio.ok_step(state, *inputs[i], gen, consts, static)
        metrics.append(m)
    torch.cuda.synchronize()
    ok_ms = (time.perf_counter() - t_warm) * 1e3 / (smoke.N_FRAMES - smoke.WARMUP)
    ok_iters = [int(m["ba_iters"]) for m in metrics[smoke.WARMUP:]]

    kcfg = smoke.kitti_config()
    slam, _, kframes, _ = smoke.run_state_machine(
        kcfg, StereoInertialSim(kcfg, n_landmarks=150, seed=0), 6.0, 10, 0, dev)
    if slam.state != State.OK or not kframes:
        raise RuntimeError(f"KITTI width: ended in {slam.state.name}")
    kitti_ms = float(np.mean([fr["ms"] for fr in kframes if "ms" in fr]))
    kitti_iters = sum(int(fr["metrics"]["ba_iters"]) for fr in kframes)
    print(torch.cuda.get_device_name(0))
    print(json.dumps({"root": root, "ok_step_ms_per_frame": ok_ms,
                      "ok_step_lm_iterations": ok_iters, "kitti_ms_per_ok_frame": kitti_ms,
                      "kitti_ok_frames": len(kframes), "kitti_lm_iterations": kitti_iters}))


if __name__ == "__main__":
    main()
