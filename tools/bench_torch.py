#!/usr/bin/env python3
"""Batched frames per second of the PyTorch port on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/bench_torch.py [--batches 1,4,16,64] [--budget-s 900]
        [--modes eager,graphed,graphed,eager]

The chained-state protocol of `bench.py` (its `measure`), on the port's
EuRoC-width configuration (`testing.synthetic_config(width=752,
height=480, levels=8, features=800)`, 1200 landmarks, as `chip_smoke.py`
phase 4): for each batch size B, lane j starts from the window seeded at
frame j's true state and replays the simulated trajectory from frame j,
so every lane sees its own consistent frames and IMU; 6 warm frames run
outside the timed region, then 8 timed frames, a scalar read of the
state as the barrier. B = 1 is the single-stream `ok_step`, B > 1 the
batched step (`parallel.batched.make_batched_step`: one ORB extraction
for all 2B images, the rest of the step mapped over the lanes); each lane
draws its RANSAC uniforms from its own generator. Each B runs in the
modes given, in that order (the default in turns): `eager` op by op,
`graphed` as captured CUDA graphs (`graphs.FrameGraphs` at B = 1,
`graphs.BatchedGraphs` above; captured in the first warm frame), with the
same draws. Liveness gate: the
timed frames must track (mean tracked > 0) and run the motion BA (mean LM
iterations > 0), else the row is refused. One further frame under
`torch.profiler` counts the CUDA kernel launches of a step and the device
time of kernels K1 (FAST select) and K2 (descriptor sampler), each one
launch over the step's 16B planes. A batch size
whose run would not fit in memory or in what is left of the time budget
(estimated from the last size's step time, scaled by the batch) is cut,
and the cut and its reason are printed.

Prints the card's name and power limit, then one JSON line: per B and
mode the frames/s (B over the step time), ms per step, CUDA kernels per
step seen by the profiler, K1's and K2's device ms, the device's busy
share in the profiled step (the union of the intervals of its kernels,
copies and sets over the step's host time, `chip_smoke.device_activity`;
the `record_function` ranges, which the profiler also lays on the
device's timeline over whole stages, gaps included, are left out and
their summed span printed apart), and the mean tracked features and LM
iterations of the timed frames.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARM, TIMED = 6, 8
EUROC = dict(width=752, height=480, levels=8, features=800)
N_LANDMARKS = 1200


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,4,16,64",
                    help="comma-separated batch sizes, measured in this order")
    ap.add_argument("--budget-s", type=float, default=900.0,
                    help="seconds for all measurements; a size that would exceed it is cut")
    ap.add_argument("--modes", default="eager,graphed,graphed,eager",
                    help="comma-separated modes run for each batch size, in this order")
    opts = ap.parse_args()
    batches = [int(b) for b in opts.batches.split(",")]
    modes = opts.modes.split(",")

    import torch

    import chip_smoke as smoke
    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    t_start = time.perf_counter()
    kernels.build()
    cfg = synthetic_config(**EUROC)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    n_frames = max(batches) + WARM + TIMED + 1
    t0 = time.perf_counter()
    frames, gyrs, accs, mask, truth = sim_frames(cfg, n_frames, n_landmarks=N_LANDMARKS)
    print(f"sim: {n_frames} frames rendered in {time.perf_counter() - t0:.1f} s", flush=True)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    imgs_l = torch.stack([t(f[0]) for f in frames])
    imgs_r = torch.stack([t(f[1]) for f in frames])
    gyr, acc = torch.stack([t(g) for g in gyrs]), torch.stack([t(a) for a in accs])
    imu_mask = t(mask)
    step_b = batched.make_batched_step(consts, static)

    def runner(b, mode):
        """(state, step(state, frame) -> (state, metrics)) for batch b in
        `mode`: lane j at frame j + i in step i."""
        gens = [torch.Generator(device=dev).manual_seed(j) for j in range(b)]
        if b == 1:
            state = seeded_state(static, truth, dev)
            if mode == "eager":
                def step(state, i):
                    return vio.ok_step(state, imgs_l[i], imgs_r[i], gyr[i], acc[i], imu_mask,
                                       gens[0], consts, static)
                return state, step
            g = graphs.FrameGraphs(state, consts, static, dev)

            def step(state, i):
                u = vio.draw_ransac_uniforms(gens[0], dev)
                m = g.ok_step(imgs_l[i], imgs_r[i], gyr[i], acc[i], imu_mask, u)
                return g.state, m
            return state, step

        lanes = torch.arange(b, device=dev)
        masks = imu_mask.expand(b, -1)
        state = batched.stack_states([seeded_state(static, truth, dev, j) for j in range(b)])
        g = graphs.BatchedGraphs(state, consts, static, dev) if mode == "graphed" else None

        def step(state, i):
            idx = lanes + i
            u = torch.stack([torch.stack(vio.draw_ransac_uniforms(g_, dev)) for g_ in gens])
            args = (imgs_l[idx], imgs_r[idx], gyr[idx], acc[idx], masks, u)
            if g is None:
                return step_b(state, *args)
            m = g.step(*args)
            return g.state, m
        return state, step

    rows, cuts, last = [], [], None
    for b, mode in ((b, mode) for b in batches for mode in modes):
        if cuts:
            break
        left = opts.budget_s - (time.perf_counter() - t_start)
        if last is not None:
            estimate = last["ms_per_step"] / 1e3 * b / last["batch"] * (WARM + TIMED + 1) * 1.5
            if estimate > left:
                cuts.append({"batch": b, "reason": f"time: ~{estimate:.0f} s estimated, "
                                                   f"{left:.0f} s of the budget left"})
                print(f"B={b}: cut ({cuts[-1]['reason']})", flush=True)
                break
        try:
            state, step = runner(b, mode)
            for i in range(WARM):
                state, _ = step(state, i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = []
            for i in range(WARM, WARM + TIMED):
                state, m = step(state, i)
                stats.append((m["n_tracked"].clone(), m["ba_iters"].clone()))
            float(state.win.p.reshape(-1)[0])
            ms = (time.perf_counter() - t0) * 1e3 / TIMED
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                state, _ = step(state, WARM + TIMED)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t1) * 1e3
            cuda_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
            act = smoke.device_activity(prof)
            launches = act["events"]
            busy = act["busy_ms"] / prof_ms
            kernel_ms = {name: sum(e.device_time for e in cuda_events if name in e.name) / 1e3
                         for name in ("fast_select_kernel", "sample_patches_kernel")}
        except torch.cuda.OutOfMemoryError as exc:
            cuts.append({"batch": b, "reason": f"memory: {str(exc).splitlines()[0]}"})
            print(f"B={b}: cut ({cuts[-1]['reason']})", flush=True)
            break
        tracked = float(np.mean([n.float().mean().item() for n, _ in stats]))
        iters = float(np.mean([k.float().mean().item() for _, k in stats]))
        row = {"batch": b, "mode": mode, "path": "ok_step" if b == 1 else "batched",
               "frames_per_s": b / (ms / 1e3), "ms_per_step": ms,
               "launches_per_step": launches, "planes": 2 * b * cfg.level_pyramid,
               "k1_device_ms": kernel_ms["fast_select_kernel"],
               "k2_device_ms": kernel_ms["sample_patches_kernel"],
               "tracked": tracked, "ba_iters": iters, "busy_share": busy,
               "profiled_ms": prof_ms, "device_busy_ms": act["busy_ms"],
               "device_summed_ms": act["summed_ms"], "annotation_ms": act["annotation_ms"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"B={b} {mode}: {ms:.2f} ms/step -> {row['frames_per_s']:.2f} frames/s, "
              f"{launches} CUDA kernels/step (profiler), busy share {busy:.4f} "
              f"({act['busy_ms']:.3f} device ms in the {prof_ms:.2f}-ms profiled step; "
              f"record_function ranges {act['annotation_ms']:.3f} ms, which a sum over all "
              f"device events would add), K1 "
              f"{row['k1_device_ms']:.4f} and K2 "
              f"{row['k2_device_ms']:.4f} device ms over {row['planes']} planes, tracked "
              f"{tracked:.1f}, LM iterations {iters:.2f}, peak {row['peak_gib']:.2f} GiB",
              flush=True)
        if not (tracked > 0 and iters > 0):
            raise RuntimeError(f"B={b}: the pipeline is dead (tracked {tracked}, LM iterations "
                               f"{iters}): refusing to report a hollow number")
        rows.append(row)
        last = row
        del state, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"card": card, "config": {**EUROC, "landmarks": N_LANDMARKS},
                      "warm": WARM, "timed": TIMED, "rows": rows, "cuts": cuts}))


if __name__ == "__main__":
    main()
