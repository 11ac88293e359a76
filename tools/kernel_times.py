#!/usr/bin/env python3
"""Times of kernels K1 (FAST select) and K4 (moment maps) of one checkout of
the PyTorch port on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/kernel_times.py [--root DIR]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout),
builds its kernels there and, at the shapes of the main paths, holds each
kernel to its twin by `chip_smoke.py`'s checks (K1 scores and codes
bit-equal, subpixel within `K1_TOL_XY`; K4 within `K4_TOL_MOM` of the
largest moment) and times it as `chip_smoke.py` does (its helpers are taken
from this checkout): CUDA events over 100 calls and the profiler's device
time over 20. K1 runs on the EuRoC-width plane stack of a simulated stereo pair
([16, 480, 752], 8 levels) and on the accuracy protocol's ([8, 240, 320],
4 levels), K4 on the EuRoC-width and the KITTI-width ([16, 375, 1242])
stacks. Prints the card and one JSON line. Kernel times of two calls land
on different hosts, so two commits are compared inside one call, in
turns: unpack the parent into a git-ignored directory and run parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENT_REPS = 100


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose kernels are measured")
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
    from pose_estimation_tpu_torch.ops import fast, kernels, moments, orb
    from pose_estimation_tpu_torch.testing import (StereoInertialSim, protocol_world,
                                                   synthetic_config)
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    kernels.library()

    def stack_of(cfg, world):
        consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
        imgs = torch.from_numpy(np.stack(world.render(1.0))).to(dev)
        return orb.plane_stack(imgs, static.orb, consts.orb), static.orb

    ecfg = synthetic_config(width=752, height=480, levels=8, features=800)
    (estack, ebounds), eorb = stack_of(ecfg, StereoInertialSim(ecfg, n_landmarks=1200, seed=0))
    pcfg, pworld, _, _ = protocol_world("A2")
    (pstack, pbounds), porb = stack_of(pcfg, pworld)
    kcfg = smoke.kitti_config()
    (kstack, _), _ = stack_of(kcfg, StereoInertialSim(kcfg, n_landmarks=150, seed=0))

    out = {"root": root}
    for name, st, bnds, ocfg in (("euroc", estack, ebounds, eorb),
                                 ("protocol", pstack, pbounds, porb)):
        args = (st, bnds, ocfg.th_hi, ocfg.th_lo, orb.EDGE, ocfg.k_per_cell)
        _, _, err = smoke.check_select(args, name)
        out[f"k1_{name}"] = {
            "shape": list(st.shape), "max_abs_err": err,
            "ms": smoke.cuda_ms(lambda: fast.fast_select(*args), reps=EVENT_REPS),
            "device_ms": smoke.device_ms(lambda: fast.fast_select(*args), "fast_select_kernel")}
    for name, st in (("euroc", estack), ("kitti", kstack)):
        g10, g01 = moments.moment_maps(st)
        r10, r01 = moments.moment_maps_plain(st)
        torch.cuda.synchronize()
        err = max(smoke.rel_err(g10, r10), smoke.rel_err(g01, r01))
        if err > smoke.K4_TOL_MOM:
            smoke.fail(f"K4 ({name}): {err} of the largest moment from the twin")
        out[f"k4_{name}"] = {
            "shape": list(st.shape), "rel_err": err,
            "ms": smoke.cuda_ms(lambda: moments.moment_maps(st), reps=EVENT_REPS),
            "device_ms": smoke.device_ms(lambda: moments.moment_maps(st), "moment_maps_kernel")}
    print(torch.cuda.get_device_name(0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
