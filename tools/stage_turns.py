#!/usr/bin/env python3
"""The staged OK path against the fused one, and the live viewer's cost, in
turns on one GPU.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/stage_turns.py [--turns 2]

Part 1, the chain of `chip_smoke.py` phase 4b (EuRoC width, frames 6-15
after a 6-frame warm-up, the same uniforms every run): ms per frame of the
fused `ok_step`, of the four stages called in turn, and of the stages each
synchronized (`chip_smoke.timed_stages`, whose per-stage split it prints),
in the order fused, staged, timed, timed, staged, fused, `--turns` times.
Part 2, the EuRoC directory of phase 10 (752x480, 2.5 s at 20 Hz) replayed
through the CLI's body, unprofiled, in the order plain, viewer, staged,
staged, viewer, plain: ms per OK frame (host clock around `process` to a
synchronize), and for the viewer runs the host ms spent inside
`_push_viewer` a frame (a `LiveViewer` attached, pushes only). Prints the
card, each run, and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    opts = ap.parse_args()

    import torch

    import chip_smoke as smoke
    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch import slam as slam_mod
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.io import euroc as euroc_io
    from pose_estimation_tpu_torch.live_viewer import LiveViewer
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.testing import (seeded_state, sim_config, sim_frames,
                                                   synthetic_config, write_euroc)
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    kernels.build()

    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    frames, gyrs, accs, mask, truth = sim_frames(cfg, smoke.N_FRAMES, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(smoke.N_FRAMES)]
    start = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(smoke.WARMUP):
        start, _ = vio.ok_step(start, *inputs[i], gen, consts, static)
    timed = list(range(smoke.WARMUP, smoke.N_FRAMES))
    us = [vio.draw_ransac_uniforms(gen, dev) for _ in timed]

    def staged_frame(st, u, i):
        img_l, img_r, gyr, acc, m = inputs[i]
        st, _ = vio.stage_imu(st, gyr, acc, m, consts, static)
        st, cur, tr = vio.stage_frontend(st, img_l, img_r, u, consts, static)
        st, _, _ = vio.stage_ba(st, tr.n_matches, consts, static)
        return vio.stage_pool(st, cur, tr, tr.n_matches, consts, static)

    def chain(kind):
        st = start
        splits = None
        torch.cuda.synchronize()
        with (smoke.timed_stages() if kind == "timed" else contextlib.nullcontext()) as timers:
            t0 = time.perf_counter()
            for u, i in zip(us, timed):
                if kind == "fused":
                    st, _ = vio.ok_step(st, *inputs[i], None, consts, static, ransac_u=u)
                else:
                    st = staged_frame(st, u, i)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(timed)
            if timers is not None:
                splits = smoke.stage_split(timers)
        return ms, splits, st.win.p[-1].tolist()

    chain_runs = []
    for _ in range(opts.turns):
        for kind in ("fused", "staged", "timed", "timed", "staged", "fused"):
            ms, split, p = chain(kind)
            chain_runs.append({"kind": kind, "ms_per_frame": ms, "stage_ms": split, "p": p})
            print(f"chain {kind}: {ms:.2f} ms/frame" + (
                f" ({', '.join(f'{k} {v:.2f}' for k, v in split.items())})" if split else ""),
                flush=True)
    if len({tuple(r["p"]) for r in chain_runs}) != 1:
        raise RuntimeError("the chain's runs ended at different positions")

    replays = []
    with tempfile.TemporaryDirectory() as tmp:
        e_yml, mav0, _ = write_euroc(Path(tmp) / "euroc", sim_config(**smoke.ENTRY_EUROC),
                                     smoke.ENTRY_EUROC_S)
        rcfg = load_config(e_yml, dataset="euroc")
        for _ in range(opts.turns):
            for kind in ("plain", "viewer", "staged", "staged", "viewer", "plain"):
                slam = slam_mod.VisualInertialSLAM(rcfg, device=dev, staged=kind == "staged")
                push_s = []
                if kind == "viewer":
                    slam.set_viewer(LiveViewer(out_path=None, port=None,
                                               window_size=rcfg.window_size))
                    push = slam._push_viewer

                    def timed_push(metrics, push=push, push_s=push_s):
                        t0 = time.perf_counter()
                        push(metrics)
                        push_s.append(time.perf_counter() - t0)

                    slam._push_viewer = timed_push
                process, ms = slam.process, []

                def timed_process(img_l, img_r, ts, slam=slam, process=process, ms=ms):
                    ok = slam.state == slam_mod.State.OK
                    count = slam._frame_count
                    t0 = time.perf_counter()
                    out = process(img_l, img_r, ts)
                    if ok and slam._frame_count > count:
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                    return out

                slam.process = timed_process
                euroc_io.run_euroc(slam, euroc_io.EurocDataset(str(mav0)),
                                   speed_up=rcfg.speed_up)
                r = {"kind": kind, "ok_frames": len(ms), "ms_per_ok_frame": float(np.mean(ms)),
                     "push_ms_per_frame": 1e3 * float(np.mean(push_s)) if push_s else None,
                     "final_p": slam.trajectory[-1, 1:].tolist()}
                replays.append(r)
                print(f"replay {kind}: {r['ms_per_ok_frame']:.2f} ms per OK frame over "
                      f"{len(ms)}" + (f"; _push_viewer {r['push_ms_per_frame']:.3f} ms a frame"
                                      if push_s else ""), flush=True)

    if len({tuple(r["final_p"]) for r in replays}) != 1:
        raise RuntimeError("the replays ended at different positions")

    def median(rows, kind, key):
        return float(np.median([r[key] for r in rows if r["kind"] == kind]))

    out = {"card": card, "turns": opts.turns,
           "chain_median_ms": {k: median(chain_runs, k, "ms_per_frame")
                               for k in ("fused", "staged", "timed")},
           "replay_median_ms": {k: median(replays, k, "ms_per_ok_frame")
                                for k in ("plain", "viewer", "staged")},
           "push_median_ms": median([r for r in replays if r["push_ms_per_frame"]],
                                    "viewer", "push_ms_per_frame"),
           "chain": chain_runs, "replays": replays}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
