#!/usr/bin/env python3
"""Where the PyTorch port's frame step spends its time on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/profile_torch_step.py [--frames 14] [--warmup 6] [--front map]
                                        [--trace PATH]

Drives `ok_step` at EuRoC scale (752x480 stereo, 8 levels, 800 features,
the simulator world of `chip_smoke.py`) from a seeded window, profiles the
frames after the warm-up with `torch.profiler`, and prints: the wall time
per frame, the device busy share (summed kernel time over wall time), the
host and device time of each stage span (`ok_step.imu`, `.extract`,
`.match`, `.backend`, `.pool`), the kernels with the most device time, the
hand-written kernels by name (K1 `fast_select`, K2 `sample_patches`, K3
`fast_score_nms`, K4 `moment_maps`), and the state of the profiled frames
(LM iterations, keyframes, position error), since the LM and keyframe work
per frame depends on how well it tracks. `--front map` profiles the
map-based front end (K1 detection, K4 moment maps, full-stack blur and pool
gather) in place of the kernel path (K1 and K2), so `ok_step.extract` can
be split for either. `--trace` writes a Chrome trace as well.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--front", choices=("kernel", "map"), default="kernel",
                    help="the ORB front end: K1 + K2, or K1 + K4 with the full-stack blur")
    ap.add_argument("--trace", default="")
    opts = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda()
    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    if opts.front == "map":
        static = dataclasses.replace(static, orb=static.orb._replace(
            sample_backend="xla", moments_backend="pallas"))
    print(f"front end: {opts.front} ({static.orb})")
    frames, gyrs, accs, mask, truth = sim_frames(cfg, opts.frames, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(opts.frames)]
    state = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(opts.warmup):
        state, _ = vio.ok_step(state, *inputs[i], gen, consts, static)
    torch.cuda.synchronize()

    n = opts.frames - opts.warmup
    metrics = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(opts.warmup, opts.frames):
            state, m = vio.ok_step(state, *inputs[i], gen, consts, static)
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = [int(m["ba_iters"]) for m in metrics]
    kfs = sum(int(m["is_keyframe"]) for m in metrics)
    errs = [float(np.linalg.norm(m["rec_p"].cpu().numpy() - truth(i + 1)[1]))
            for i, m in zip(range(opts.warmup, opts.frames), metrics)]
    print(f"profiled frames {opts.warmup}-{opts.frames - 1}: LM iterations {iters}, "
          f"{kfs} keyframes, position error {min(errs):.3f}-{max(errs):.3f} m")
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    # device-side kernels only: the stage spans also appear on the GPU
    # timeline (as ranges over their kernels) and must not count twice
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and not e.name.startswith("ok_step.")]
    busy_us = sum(e.device_time for e in kernels)
    print(f"{torch.cuda.get_device_name(0)}: {n} frames, {wall * 1e3 / n:.2f} ms/frame wall "
          f"under the profiler, device busy {busy_us / 1e3 / n:.2f} ms/frame "
          f"({100 * busy_us / 1e6 / wall:.1f} % of wall)")
    spans: dict[str, list[float]] = {}
    for e in events:
        if e.key.startswith("ok_step."):
            s = spans.setdefault(e.key, [0.0, 0.0])
            s[0] = max(s[0], e.cpu_time_total)
            s[1] = max(s[1], dev_us(e))
    print("stage spans (per frame): host ms, device range ms")
    for key, (host, devt) in spans.items():
        print(f"  {key:18s} {host / 1e3 / n:9.3f} {devt / 1e3 / n:9.3f}")
    print("top device ops (per frame): device ms, calls")
    top = sorted((e for e in events if dev_us(e) > 0 and not e.key.startswith("ok_step.")),
                 key=dev_us, reverse=True)[:25]
    for e in top:
        print(f"  {dev_us(e) / 1e3 / n:9.4f} {e.count // n:6d}  {e.key[:90]}")
    print("hand-written kernels (per frame): device ms, calls")
    for name in ("fast_select_kernel", "sample_patches_kernel", "fast_score_nms_kernel",
                 "moment_maps_kernel"):
        hits = [e for e in kernels if name in e.name]
        print(f"  {sum(e.device_time for e in hits) / 1e3 / n:9.4f} {len(hits) / n:6.1f}  {name}")
    print(f"kernel launches per frame: {len(kernels) / n:.0f}")
    if opts.trace:
        prof.export_chrome_trace(opts.trace)


if __name__ == "__main__":
    main()
