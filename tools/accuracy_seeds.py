#!/usr/bin/env python3
"""The accuracy protocol's worlds through the port, over several seeds of
the state machine's random draws.

Run from the repository root (on a GPU by default):

    python3 tools/accuracy_seeds.py [--runs A0,A1,A2,B0,B1] [--seeds 0-7]
                                    [--device cuda|cpu] [--fronts kernel,sparse,pallas]
                                    [--workers 1]

Each run is one world of `benchmarks/chip_accuracy.py`
(`testing.protocol_world`) replayed through
`slam.VisualInertialSLAM(seed=s)`, where `s` seeds the RANSAC and PnP
draws. The world is the same for every `s`, so the spread over `s` is the
spread the random draws alone make. `--fronts` picks the ORB front ends:
`kernel` (the configuration's kernel path, K1 and K2), `sparse` and
`pallas` (the map front end, `sample_backend="xla"`, with the IC angle by
sparse prefix sums or by K4's moment maps); every (front, run, s) is one
run. The OK frames run as captured CUDA graphs on the card (the state
machine's default). `--workers` runs that many processes side by side,
sharing the device. Prints one JSON line per run with the gates'
quantities (ATE % of path, |ba|, |bg|) and a summary line of passes per
front end and world.
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


def run_one(job) -> dict:
    """One (front end, world, seed, device) run through the state machine."""
    import dataclasses

    from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM
    from pose_estimation_tpu_torch.testing import (PROTOCOL_IMU_NOISE, protocol_world,
                                                   run_errors, within_gates)

    front, run, s, device = job
    cfg, world, duration, imu_seed = protocol_world(run)
    slam = VisualInertialSLAM(cfg, seed=s, device=device)
    if front != "kernel":
        slam.static = dataclasses.replace(slam.static, orb=slam.static.orb._replace(
            sample_backend="xla", moments_backend=front))
    t0 = time.perf_counter()
    gt = world.run(slam, duration=duration, imu_noise=PROTOCOL_IMU_NOISE, seed=imu_seed)
    e = run_errors(slam, gt)
    return {"front": front, "run": run, "seed": s, "state": slam.state.name,
            "ate_pct": e["ate_pct"], "ba": e["ba"], "bg": e["bg"],
            "pass": slam.state == State.OK and within_gates(e),
            "seconds": time.perf_counter() - t0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="A0,A1,A2,B0,B1")
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fronts", default="kernel",
                    help="comma-separated: kernel, sparse, pallas")
    ap.add_argument("--workers", type=int, default=1)
    opts = ap.parse_args()

    import multiprocessing

    import torch

    jobs = [(front, run, s, opts.device) for front in opts.fronts.split(",")
            for run in opts.runs.split(",") for s in _seeds(opts.seeds)]
    passes = {}
    if opts.workers > 1:
        pool = multiprocessing.get_context("spawn").Pool(opts.workers)
        # each run's line as soon as it ends, so that a run cut short keeps
        # every finished one
        results = pool.imap_unordered(run_one, jobs)
    else:
        pool, results = None, map(run_one, jobs)
    for r in results:
        passes.setdefault(f"{r['front']} {r['run']}", []).append(r["pass"])
        print(json.dumps(r), flush=True)
    if pool is not None:
        pool.close()
        pool.join()
    device = (torch.cuda.get_device_name(0) if torch.device(opts.device).type == "cuda"
              else "cpu")
    print(json.dumps({"device": device,
                      "passes": {r: f"{sum(v)}/{len(v)}" for r, v in passes.items()}}))


if __name__ == "__main__":
    main()
