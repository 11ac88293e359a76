#!/usr/bin/env python3
"""How often `torch.profiler` records no launch of a kernel, on a GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/profiler_probe.py [--sessions 30] [--pad-ms 0]

Profiles, `--sessions` times over, the three calls that `chip_smoke.py`
profiles first, in its order: kernel K1 (`fast_select`) on the EuRoC-width
stack of a stereo pair, K1 on the accuracy protocol's 320x240 stack, and
K2 (`sample_patches`) on the EuRoC-width stack; each session 20 calls
after one outside it, as `chip_smoke.py:device_ms` does. With `--pad-ms`,
each session sleeps that long on the host after it starts and again after
its last synchronize. Per call it counts the sessions whose events hold
no kernel of the name, and for those the device events they did hold (how
many, their names, and how many events of the kernel's name the
profiler's raw results held). Prints the card and one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=30)
    ap.add_argument("--pad-ms", type=float, default=0.0)
    opts = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, kernels, orb, sample
    from pose_estimation_tpu_torch.testing import protocol_world, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda()
    kernels.build()
    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    frames = sim_frames(cfg, 1, n_landmarks=1200)[0]
    stack, bounds = orb.plane_stack(torch.from_numpy(np.stack(frames[0])).to(dev),
                                    static.orb, consts.orb)
    args = (stack, bounds, static.orb.th_hi, static.orb.th_lo, orb.EDGE, static.orb.k_per_cell)
    pcfg, pworld, _, _ = protocol_world("A2")
    pconsts, pstatic = vio.build_constants(pcfg, CameraModel.from_config(pcfg), dev)
    pstack, pbounds = orb.plane_stack(torch.from_numpy(np.stack(pworld.render(1.0))).to(dev),
                                      pstatic.orb, pconsts.orb)
    pargs = (pstack, pbounds, pstatic.orb.th_hi, pstatic.orb.th_lo, orb.EDGE,
             pstatic.orb.k_per_cell)
    budgets = orb.level_budgets(static.orb)
    kps = orb.detect(stack, bounds, static.orb, budgets[0])
    xy = torch.cat([kps.xy[lvl * 2:(lvl + 1) * 2, :kb] for lvl, kb in enumerate(budgets)],
                   dim=1).contiguous()
    k2args = (stack, bounds, xy, budgets, consts.orb.pool_xy)
    calls = [("K1 EuRoC", lambda: fast.fast_select(*args), "fast_select_kernel"),
             ("K1 protocol", lambda: fast.fast_select(*pargs), "fast_select_kernel"),
             ("K2 EuRoC", lambda: sample.sample_patches(*k2args), "sample_patches_kernel")]

    misses = collections.defaultdict(list)
    seen = collections.Counter()
    t0 = time.perf_counter()
    for _ in range(opts.sessions):
        for label, fn, kernel in calls:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(opts.pad_ms / 1e3)
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                time.sleep(opts.pad_ms / 1e3)
            dev_events = [e for e in prof.events() if e.device_type.name == "CUDA"]
            if any(kernel in e.name for e in dev_events):
                seen[label] += 1
            else:
                names = collections.Counter(e.name[:60] for e in dev_events)
                raw = [e for e in prof.profiler.kineto_results.events() if kernel in e.name()]
                misses[label].append(dict(device_events=len(dev_events),
                                          names=dict(names.most_common(4)),
                                          raw_kineto_hits=len(raw)))
    print(torch.cuda.get_device_name(0))
    print(json.dumps(dict(sessions=opts.sessions, pad_ms=opts.pad_ms,
                          teardown_cupti=os.environ.get("TEARDOWN_CUPTI"),
                          seconds=time.perf_counter() - t0, seen=dict(seen),
                          missed={k: len(v) for k, v in misses.items()},
                          misses=dict(misses))))


if __name__ == "__main__":
    main()
