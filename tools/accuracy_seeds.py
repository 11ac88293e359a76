#!/usr/bin/env python3
"""The accuracy protocol's worlds through the port, over several seeds of
the state machine's random draws.

Run from the repository root (on a GPU by default):

    python3 tools/accuracy_seeds.py [--runs A0,A1,A2,B0,B1] [--seeds 0-7]
                                    [--device cuda|cpu]

Each run is one world of `benchmarks/chip_accuracy.py`
(`testing.protocol_world`) replayed through
`slam.VisualInertialSLAM(seed=s)`, where `s` seeds the RANSAC and PnP
draws. The world is the same for every `s`, so the spread over `s` is the
spread the random draws alone make. Prints one JSON line per (run, s)
with the gates' quantities (ATE % of path, |ba|, |bg|) and a summary line
of passes per run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _seeds(text: str) -> list[int]:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="A0,A1,A2,B0,B1")
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--device", default="cuda")
    opts = ap.parse_args()

    import torch

    from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM
    from pose_estimation_tpu_torch.testing import (PROTOCOL_IMU_NOISE, protocol_world,
                                                   run_errors, within_gates)

    passes = {}
    for run in opts.runs.split(","):
        for s in _seeds(opts.seeds):
            cfg, world, duration, imu_seed = protocol_world(run)
            slam = VisualInertialSLAM(cfg, seed=s, device=opts.device)
            t0 = time.perf_counter()
            gt = world.run(slam, duration=duration, imu_noise=PROTOCOL_IMU_NOISE, seed=imu_seed)
            e = run_errors(slam, gt)
            ok = slam.state == State.OK and within_gates(e)
            passes.setdefault(run, []).append(ok)
            print(json.dumps({"run": run, "seed": s, "state": slam.state.name,
                              "ate_pct": e["ate_pct"], "ba": e["ba"], "bg": e["bg"], "pass": ok,
                              "seconds": time.perf_counter() - t0}), flush=True)
    device = (torch.cuda.get_device_name(0) if torch.device(opts.device).type == "cuda"
              else "cpu")
    print(json.dumps({"device": device,
                      "passes": {r: f"{sum(v)}/{len(v)}" for r, v in passes.items()}}))


if __name__ == "__main__":
    main()
