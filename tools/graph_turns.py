#!/usr/bin/env python3
"""Eager against graphed OK frames, in turns on one GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/graph_turns.py [--parts chain,kitti,cli] [--turns 1]
        [--modes graphed,eager,eager,graphed] [--root DIR]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout), its
helpers from this checkout's `chip_smoke.py`. Two commits are compared
inside one call, in turns: unpack the parent into a git-ignored directory
and run parent, change, change, parent (`--modes graphed` for the graphed
runs alone).

- chain: `chip_smoke.graph_checks` (phase 4c): K1 and K2 in a graph
  replay against their twins, the 16-frame EuRoC-width `ok_step` chain
  eager and graphed in turns (E G G E) with every frame bit-equal, the map
  front end, the staged graphs, `ok_scan`, the batched step at B = 8, each
  graph's capture and instantiate seconds, nodes and pool bytes and the
  busy share of graphed frames.
- kitti: the state machine at KITTI width (`chip_smoke.py` phase 7's
  world, 6 s or `--kitti-s`) graphed and eager in turns (G E E G,
  `--turns` times): the first
  OK frame's ms (a graphed run's warm-up and captures), the later frames'
  mean and median ms and their split by the host work each ran beside the
  step (`chip_smoke.frame_times`; a graphed run's first refinement or
  recovery frame of each chain length also captures its graph), each
  graph's nodes (top level and inside its conditional bodies), capture
  and instantiate seconds and replays, every LM solve's iterations by
  solve (mean and largest against its cap, `graphs.iteration_log`) and
  the iterations a steady OK frame skips, and whether each run's
  trajectory and iterations equal the first's.
- cli: the EuRoC directory of `chip_smoke.py` phase 10 (752x480, 2.5 s at
  20 Hz) through `run_euroc.main` (graphed) and through the CLI's body
  with `graphed=False` (`chip_smoke.replay_cli_body`), again with keyframe
  full BA, and the KITTI directory (1242x375, 2 s at 10 Hz) through
  `run_kitti.main` and the eager body, each pair in turns (G E E G): the
  same ms per OK frame (host clock around `process` to a synchronize), the
  LM iterations as above and whether the states.csv files are equal.

Prints the card's name and power limit, each run, and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="chain,kitti,cli")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--kitti-s", type=float, default=6.0)
    ap.add_argument("--modes", default="graphed,eager,eager,graphed",
                    help="the runs of a turn of the kitti and cli parts, in order")
    ap.add_argument("--root", default=REPO, help="checkout whose port is measured")
    opts = ap.parse_args()
    parts = opts.parts.split(",")
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    import pose_estimation_tpu_torch
    from pose_estimation_tpu_torch import graphs, run_euroc, run_kitti
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.testing import (StereoInertialSim, sim_config, sim_frames,
                                                   synthetic_config, write_euroc, write_kitti)
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    # a checkout before the LM's conditional nodes logs no iterations
    counting = hasattr(graphs, "read_iterations")

    def logged():
        return smoke.logged_iterations() if counting else contextlib.nullcontext([])

    def read(log):
        return graphs.read_iterations(log) if counting else []

    def iterations(times):
        if not counting:
            return "LM iterations not logged by this checkout"
        return (f"LM iterations {smoke.iteration_line(times['lm_iterations'])}, "
                f"{times['lm_skipped_per_ok_frame']:.2f} a steady OK frame skipped")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    kernels.build()
    smoke.count_replays()
    out = {"card": card, "root": root}

    if "chain" in parts:
        cfg = synthetic_config(width=752, height=480, levels=8, features=800)
        consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
        n = max(smoke.N_FRAMES, smoke.BATCH + smoke.BATCH_FRAMES)
        frames, gyrs, accs, mask, truth = sim_frames(cfg, n, n_landmarks=1200)
        inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
                  for i in range(smoke.N_FRAMES)]
        out["chain"] = smoke.graph_checks(dev, consts, static, inputs, truth, frames, gyrs,
                                          accs, mask)

    order = opts.modes.split(",") * opts.turns
    if "kitti" in parts:
        kcfg = smoke.kitti_config()
        runs = {"graphed": [], "eager": []}
        first = None
        first_iters = None
        for mode in order:
            with logged() as log:
                slam, _, frames_k, _ = smoke.run_state_machine(
                    kcfg, StereoInertialSim(kcfg, n_landmarks=150, seed=0), opts.kitti_s, 10,
                    0, dev, graphed=mode == "graphed")
                counts = read(log)
            times = smoke.frame_times(frames_k)
            times["lm_iterations"] = smoke.iteration_summary(counts)
            times["lm_skipped_per_ok_frame"] = smoke.frame_iterations(
                frames_k)["skipped_per_frame"]
            if mode == "graphed":
                times["solve_graphs"] = slam._solve_graphs.stats()
                times["frame_graphs"] = slam._graphs.stats()
                print("  " + "; ".join(smoke.graph_line(n, g)
                                       for n, g in {**times["frame_graphs"],
                                                    **times["solve_graphs"]}.items()))
            same = first is None or (np.array_equal(first, slam.trajectory)
                                     and counts == first_iters)
            if first is None:
                first, first_iters = slam.trajectory, counts
            runs[mode].append(times)
            print(f"KITTI-width state machine, {mode}: {len(frames_k)} OK frames, "
                  f"{smoke.frame_times_line(times)}; {iterations(times)}; trajectory and "
                  f"iterations {'equal to' if same else 'DIFFER from'} the first run's",
                  flush=True)
            if not same:
                smoke.fail("KITTI-width state machine: the runs differ")
        out["kitti"] = runs

    if "cli" in parts:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            e_yml, _, _ = write_euroc(tmp / "euroc", sim_config(**smoke.ENTRY_EUROC),
                                         smoke.ENTRY_EUROC_S)
            k_yml, _, _, _ = write_kitti(tmp / "kitti", smoke.kitti_config(),
                                         smoke.ENTRY_KITTI_S)
            res = {}
            for label in ("euroc", "euroc_full_ba", "kitti"):
                runs = {"graphed": [], "eager": []}
                ref = None
                for mode in order:
                    csv = tmp / f"{label}_{mode}.csv"
                    kind, yml = ("kitti", k_yml) if label == "kitti" else ("euroc", e_yml)
                    with smoke.observed_replays() as made, logged() as log:
                        if label == "euroc_full_ba" or mode == "eager":
                            smoke.replay_cli_body(
                                kind, yml, csv, dev, graphed=mode == "graphed",
                                **({"full_ba_keyframes": True} if label == "euroc_full_ba"
                                   else {}))
                        else:
                            cli = run_kitti if kind == "kitti" else run_euroc
                            cli.main(["--config", str(yml), "--out", str(csv)])
                        counts = read(log)
                    (slam,) = made
                    text = csv.read_text()
                    same = ref is None or text == ref
                    ref = text if ref is None else ref
                    times = smoke.frame_times(slam.observed["frames"])
                    times["lm_iterations"] = smoke.iteration_summary(counts)
                    times["lm_skipped_per_ok_frame"] = smoke.frame_iterations(
                        slam.observed["frames"])["skipped_per_frame"]
                    runs[mode].append(times)
                    print(f"{label} replay, {mode}: {len(slam.observed['frames'])} OK frames, "
                          f"{smoke.frame_times_line(times)}; {iterations(times)}; "
                          f"states.csv {'equal to' if same else 'DIFFERS from'} the first "
                          "run's", flush=True)
                    if not same:
                        smoke.fail(f"{label} replay: the runs differ")
                res[label] = runs
            out["cli"] = res
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
