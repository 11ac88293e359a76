#!/usr/bin/env python3
"""Times of kernel K6's Jacobi `eigh` and 3x3 `svd` and of the graphed OK frame by kind,
for one checkout of the PyTorch port on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/k6_times.py [--root DIR] [--frames]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout) and
builds its kernels there. At every shape of K6's paths
(`chip_smoke.K6_EIGH_SHAPES`, inputs from `chip_smoke.k6_inputs`) it
holds the kernel's eigenvalues within `K6_TOL` x ||A|| of the twin's and
times it as `chip_smoke.py` does (its helpers are taken from this
checkout): CUDA events over 100 calls, the profiler's device time over 20,
`torch.linalg.eigh` beside it; where the checkout's `small_linalg` has
`eigh_rounds`, the Jacobi rounds of the slowest matrix and device us a
round; and the 3x3 SVD at [512, 3, 3] (rank 3 and rank 2, as
`chip_smoke.py` phase 3b builds it) beside `torch.linalg.svd`.
`--frames` also runs `chip_smoke.frames_by_kind`
on the graphed EuRoC-width chain of phase 4 (frames 6-15 of 16 from the
seeded window): each frame's replay by CUDA events, split into
marginalizing keyframes and other frames, and K6's clip profiled inside
two frames of each kind. Prints the card's name and power limit and one
JSON line. Two commits are compared inside one call, in turns: unpack the
parent into a git-ignored directory and run parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_REPS = 100


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose kernels are measured")
    ap.add_argument("--frames", action="store_true",
                    help="also time the graphed chain's frames by kind")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    import pose_estimation_tpu_torch
    from pose_estimation_tpu_torch.ops import kernels, small_linalg
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    kernels.library()
    has_rounds = hasattr(small_linalg, "eigh_rounds")

    out = {"root": root, "eigh": {}}
    for label, b, n, dtype in smoke.K6_EIGH_SHAPES:
        a = smoke.k6_inputs(dev, label, b, n, dtype)
        graded = not label.startswith("clip")
        w, _ = small_linalg.eigh(a, graded=graded)
        pw, _ = small_linalg.eigh_plain(a)
        torch.cuda.synchronize()
        norm = torch.linalg.matrix_norm(a.double())
        err = float(((w.double() - pw.double()).abs().amax(-1) / norm).max())
        if not err <= smoke.K6_TOL[dtype]:
            smoke.fail(f"K6 eigh {label}: eigenvalues {err:.3g} x ||A|| from the twin")
        rec = {"shape": [b, n, n], "dtype": dtype, "w_err_rel": err,
               "ms": smoke.cuda_ms(lambda: small_linalg.eigh(a, graded=graded), reps=EVENT_REPS),
               "device_ms": smoke.device_ms(lambda: small_linalg.eigh(a, graded=graded),
                                            "eigh_kernel"),
               "lib_ms": smoke.cuda_ms(lambda: torch.linalg.eigh(a), reps=20)}
        if has_rounds:
            rounds = small_linalg.eigh_rounds(a, graded=graded)[2].tolist()
            rec.update(rounds_max=max(rounds), sweeps_max=max(rounds) / (n + (n & 1) - 1),
                       us_per_round=smoke.rec_us_per_round(rounds, rec["device_ms"]))
        print(f"{label}: {rec}")
        out["eigh"][label] = rec
    # the SVD at the proper rotations' [512, 3, 3], as phase 3b builds it
    # (rank 3 and rank 2), held to its twin
    gen = torch.Generator(device=dev).manual_seed(6)
    a = torch.cat([torch.randn((256, 3, 3), generator=gen, device=dev),
                   torch.randn((256, 3, 2), generator=gen, device=dev)
                   @ torch.randn((256, 2, 3), generator=gen, device=dev)])
    s = small_linalg.svd(a)[1]
    err = float(((s.double() - small_linalg.svd_plain(a)[1].double()).abs().amax(-1)
                 / torch.linalg.matrix_norm(a.double())).max())
    if not err <= smoke.K6_TOL["float32"]:
        smoke.fail(f"K6 svd: singular values {err:.3g} x ||A|| from the twin")
    out["svd"] = {"shape": [512, 3, 3], "s_err_rel": err,
                  "ms": smoke.cuda_ms(lambda: small_linalg.svd(a), reps=EVENT_REPS),
                  "device_ms": smoke.device_ms(lambda: small_linalg.svd(a), "svd3_kernel"),
                  "lib_ms": smoke.cuda_ms(lambda: torch.linalg.svd(a), reps=20)}
    print(f"svd: {out['svd']}")
    if opts.frames:
        from pose_estimation_tpu_torch import graphs
        from pose_estimation_tpu_torch.camera import CameraModel
        from pose_estimation_tpu_torch.models import vio
        from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config

        cfg = synthetic_config(width=752, height=480, levels=8, features=800)
        consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
        frames, gyrs, accs, mask, truth = sim_frames(cfg, smoke.N_FRAMES, n_landmarks=1200)
        inputs = [tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                        for x in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
                  for i in range(smoke.N_FRAMES)]
        runner = graphs.FrameGraphs(seeded_state(static, truth, dev), consts, static, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for i in range(smoke.WARMUP):
            runner.ok_step(*inputs[i], vio.draw_ransac_uniforms(gen, dev))
        start = graphs.snapshot(runner.state)
        out["frames_by_kind"] = smoke.frames_by_kind(
            runner, start, inputs, list(range(smoke.WARMUP, smoke.N_FRAMES)), dev)
        print(f"frames by kind: {out['frames_by_kind']}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
