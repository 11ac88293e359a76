#!/usr/bin/env python3
"""The graphed OK frame by kind (marginalizing keyframes, other frames), in
the default configuration and with keyframe full BA, for one checkout of
the PyTorch port on a GPU; and a probe of an IF node that holds a WHILE
node.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/cond_turns.py [--root DIR] [--configs default,full_ba]
        [--kitti-s S] [--check] [--probe] [--sites]

Imports `pose_estimation_tpu_torch` from DIR (default: this checkout), its
helpers from this checkout's `chip_smoke.py`. For each configuration it
runs the EuRoC-width chain of `chip_smoke.py` phase 4 (752x480, 8 levels,
16 frames from the seeded window) through `graphs.FrameGraphs`: frames
0-5 warm up and capture, then `chip_smoke.frames_by_kind` replays frames
6-15 with seeded draws, each between two CUDA events, and splits them by
kind; it prints the `frame` graph's nodes (top level, and inside its
WHILE and IF bodies where the checkout has them) and the card's SM clock,
power draw and temperature sampled by `nvidia-smi` while the frames ran. With `--kitti-s S` it
also runs the state machine at KITTI width (`chip_smoke.py` phase 7's
world, S s, graphed) in each configuration and splits its OK frames that
ran the step alone by kind (a keyframe that tracks, any other frame):
host ms to a synchronize (`chip_smoke.observe_ok_frames`). `--check` also runs
frames 6-15 eagerly from the same state with the same draws and holds the
graphed frames to them bit for bit, with the LM iterations that each
solve logged (`graphs.iteration_log`). `--probe` (this checkout only)
captures `graphs.cond` around an LM solve (`backend/lm.py`, a WHILE node
in the IF node's body) and replays it with the predicate true and false
against the eager select. `--sites` (this checkout only) times each
branch of the frame's `lax.cond` sites alone, on the chain's frame 6 from
the state after its warm-up: the branch captured as a graph of its own
and replayed back to back between CUDA events, with its nodes (top level
and in its WHILE bodies); and the cost of an IF node itself, a `cond`
whose one-operation branch is not taken, and one whose branch is taken,
against the copy it makes and the branch alone. Prints the card's name and power limit and one
JSON line. Two commits are compared inside one call, in turns: unpack the
parent into a git-ignored directory and run parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def sampled_clocks():
    """While the block runs, `nvidia-smi` samples the card's SM clock (MHz),
    power draw (W) and temperature (C) every 200 ms; yields a dict that is
    then filled with each one's least, mean and largest sample."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                             "--format=csv,noheader,nounits", "-lms", "200"],
                            stdout=subprocess.PIPE, text=True)
    out = {}
    try:
        yield out
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    rows = [[float(x) for x in line.split(",")] for line in text.splitlines()
            if line.strip() and "N/A" not in line]
    for k, name in enumerate(("sm_mhz", "power_w", "temp_c")):
        vals = [r[k] for r in rows]
        if vals:
            out[name] = [min(vals), float(np.mean(vals)), max(vals)]


def probe(dev, smoke) -> dict:
    """`graphs.cond` around `lm_solve_normal` captured as an IF node whose
    body holds the solve's WHILE node, replayed with the predicate true,
    false and true again, each against the eager select on the same
    inputs: the outputs and the logged iterations bit for bit."""
    import torch

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.backend import lm

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((30, 6), generator=gen, device=dev)
    b = 3.0 * torch.randn(30, generator=gen, device=dev)
    cap = 20

    def normal_fn(x):
        r = a @ x - b + 0.3 * torch.sin(x).sum()
        return a.T @ a, a.T @ r, 0.5 * (r * r).sum()

    def fn(pred, x0):
        def branch():
            x, info = lm.lm_solve_normal(normal_fn, x0, lm.LMOptions(max_iterations=cap),
                                         name="probe")
            return x, info["iterations"]

        return graphs.cond(pred, branch, (x0, torch.zeros((), dtype=torch.int32, device=dev)),
                           solves=(("probe", cap),))

    pred = torch.ones((), dtype=torch.bool, device=dev)
    x0 = torch.zeros(6, device=dev)
    graphs.warm_up(fn, (pred, x0), dev)
    step = graphs.CapturedStep("probe", fn, (pred, x0), dev)
    res = []
    for value in (True, False, True):
        pred.fill_(value)
        with smoke.logged_iterations() as log:
            eager = fn(pred.clone(), x0.clone())
            e_log = graphs.read_iterations(list(log))
            del log[:]
            got = graphs.snapshot(step())
            g_log = graphs.read_iterations(list(log))
        same = all(torch.equal(x, y) for x, y in zip(eager, got)) and e_log == g_log
        res.append({"pred": value, "iterations": int(got[1]), "logged": g_log, "same": same})
        print(f"probe, predicate {value}: graphed {'bit-equal to' if same else 'DIFFERS from'} "
              f"the eager select; iterations {int(got[1])}, logged {g_log} (eager {e_log})",
              flush=True)
        if not same:
            smoke.fail(f"cond probe, predicate {value}: the graphed IF node differs")
        if (value and not 0 < int(got[1]) <= cap) or (not value and g_log != [("probe", 0, cap)]):
            smoke.fail(f"cond probe, predicate {value}: iterations {int(got[1])}, {g_log}")
    stats = step.stats
    print("probe graph: " + smoke.graph_line("probe", {"replays": step.replays,
                                                       "launches": step.launches, **stats}))
    if (stats.get("if_nodes"), stats.get("while_nodes")) != (1, 1):
        smoke.fail(f"cond probe: {stats} (one IF node holding one WHILE node)")
    return {"replays": res, "graph": stats}


def sites(dev, smoke, consts, static, inputs, truth) -> dict:
    """Each `lax.cond` site's branch of the frame step (`models/vio.py`),
    captured alone on the inputs it has in frame WARMUP of the chain: its
    nodes and the device ms of a replay (CUDA events over back-to-back
    replays), and the IF node's own cost."""
    import dataclasses as dc

    import torch

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.backend import ba as ba_mod
    from pose_estimation_tpu_torch.backend.ba import LandmarkObs
    from pose_estimation_tpu_torch.imu import preintegration as pre
    from pose_estimation_tpu_torch.models import pool as pool_mod
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.models import window as win_mod
    from pose_estimation_tpu_torch.testing import seeded_state

    state = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(smoke.WARMUP):
        state, _ = vio.ok_step(state, *inputs[i], gen, consts, static)
    img_l, img_r, gyr, acc, mask = inputs[smoke.WARMUP]
    s1, _ = vio.stage_imu(state, gyr, acc, mask, consts, static)
    s2, cur, tr = vio.stage_frontend(s1, img_l, img_r, vio.draw_ransac_uniforms(gen, dev),
                                     consts, static)
    win, pool = s2.win, s2.pool
    wsize = win.R.shape[0] - 1
    obs = LandmarkObs(pool.pos, pool.obs_px, pool.obs_mask)

    def ba():
        dpose, dvdbga, info = ba_mod.motion_only_ba(
            win, obs, consts.calib, consts.gravity, static.prior_factor,
            static.max_iterations, use_marg_prior=True)
        solved = win_mod.apply_deltas(win, dpose, dvdbga, static.max_gyr_bias,
                                      static.max_acc_bias)
        return (win_mod.check_keyframe(solved, static.keyframe_rotation,
                                       static.keyframe_translation, static.max_imu_time),
                info["final_cost"], info["iterations"], info["marg_h"])

    marg_h = ba()[3]
    schur = vio.psd_clip(ba_mod.marg_schur(marg_h, wsize, static.marg_forget))
    full = dc.replace(static, full_ba_keyframes=True)
    ic = pre.finalize(state.preint, state.bg, state.ba, consts.imu)
    kf = torch.ones((), dtype=torch.bool, device=dev)
    branches = {
        "c1 motion-only BA": ba,
        "c2 keyframe full BA": lambda: vio.keyframe_full_ba(win, pool, consts, full),
        "c3 Schur complement": lambda: ba_mod.marg_schur(marg_h, wsize, static.marg_forget),
        "c3 marg_apply": lambda: ba_mod.marg_apply(win, schur),
        "c4 preintegrator reset": lambda: vio.select(kf, pre.init_state(dev), state.preint),
        "c5/c7 shift_window": lambda: pool_mod.shift_window(pool, kf),
        "c6/c8 pool update": lambda: vio.pool_update(s2, cur, tr, consts, static),
        "c9 re-predict": lambda: pre.predict(win.R[-2], win.v[-2], win.p[-2], ic,
                                             consts.gravity, dbg_i=win.dbg[-2],
                                             dba_i=win.dba[-2]),
    }
    x = torch.zeros(1024, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    branches["IF node, branch not taken"] = lambda: graphs.cond(off, lambda: x + 1.0, x)
    branches["IF node, branch taken"] = lambda: graphs.cond(~off, lambda: x + 1.0, x)
    branches["its copy alone"] = lambda: graphs.snapshot(x)
    branches["its branch alone"] = lambda: x + 1.0
    out = {}
    for name, fn in branches.items():
        graphs.warm_up(lambda: fn(), (), dev)
        step = graphs.CapturedStep(name, fn, (), dev)
        step()
        ms = smoke.cuda_ms(step.graph.replay, reps=50, warm=5)
        g = step.stats
        out[name] = {"nodes": g["nodes"], "while_body_nodes": g["while_body_nodes"],
                     "if_nodes": g["if_nodes"], "ms": ms}
        print(f"  {name}: {g['nodes']} nodes (+{g['while_body_nodes']} in WHILE bodies), "
              f"{ms:.4f} device ms a replay", flush=True)
    return out


def by_kind(dev, smoke, consts, static, inputs, truth, check: bool) -> dict:
    import torch

    from pose_estimation_tpu_torch import graphs
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.testing import seeded_state

    runner = graphs.FrameGraphs(seeded_state(static, truth, dev), consts, static, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(smoke.WARMUP):
        runner.ok_step(*inputs[i], vio.draw_ransac_uniforms(gen, dev))
    start = graphs.snapshot(runner.state)
    frames = list(range(smoke.WARMUP, smoke.N_FRAMES))
    with sampled_clocks() as card:
        kinds = smoke.frames_by_kind(runner, start, inputs, frames, dev)
    out = {"kinds": kinds, "graph": runner.stats()["frame"], "card": card}
    if check:
        runs = {}
        for mode in ("eager", "graphed"):
            state = graphs.snapshot(start)
            runner.load_state(start)
            gen = torch.Generator(device=dev).manual_seed(4)
            mets = []
            with smoke.logged_iterations() as log:
                for i in frames:
                    u = vio.draw_ransac_uniforms(gen, dev)
                    if mode == "eager":
                        state, m = vio.ok_step(state, *inputs[i], None, consts, static,
                                               ransac_u=u)
                    else:
                        m = graphs.snapshot(runner.ok_step(*inputs[i], u))
                    mets.append(m)
                counts = graphs.read_iterations(log) if hasattr(graphs, "read_iterations") \
                    else []
            runs[mode] = (state if mode == "eager" else graphs.snapshot(runner.state), mets,
                          counts)
        (es, em, ec), (gs, gm, gc) = runs["eager"], runs["graphed"]
        from pose_estimation_tpu_torch.utils.tree import tree_leaves

        same = all(torch.equal(x, y) for x, y in zip(tree_leaves((es, em)),
                                                       tree_leaves((gs, gm))))
        out["check"] = {"bit_equal": same, "iterations_equal": ec == gc,
                        "iterations": [(name, n) for name, n, _ in gc]}
        print(f"  frames {frames[0]}-{frames[-1]} graphed against eager: "
              f"{'bit-equal' if same else 'DIFFER'}; LM iterations solve by solve "
              f"{'equal' if ec == gc else 'DIFFER'}: {out['check']['iterations']}", flush=True)
        if not (same and ec == gc):
            smoke.fail("the graphed chain differs from the eager one")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose port is measured")
    ap.add_argument("--configs", default="default,full_ba")
    ap.add_argument("--kitti-s", type=float, default=0.0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--sites", action="store_true")
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
    from pose_estimation_tpu_torch.testing import sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    if not os.path.dirname(pose_estimation_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {pose_estimation_tpu_torch.__file__}, not from {root}")
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    kernels.library()
    out = {"card": card, "root": root}
    if opts.probe:
        out["probe"] = probe(dev, smoke)
    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    frames, gyrs, accs, mask, truth = sim_frames(cfg, smoke.N_FRAMES, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(smoke.N_FRAMES)]
    if opts.sites:
        print("the lax.cond sites' branches, each captured alone (frame 6 of the chain):")
        out["sites"] = sites(dev, smoke, consts, static, inputs, truth)
    for label in opts.configs.split(","):
        st = dataclasses.replace(static, full_ba_keyframes=label == "full_ba")
        res = out[label] = by_kind(dev, smoke, consts, st, inputs, truth, opts.check)
        g = res["graph"]
        print(f"{label}: frame graph " + smoke.graph_line("frame", {**g, "launches": {},
                                                                    "replays": 0})
              + f"; the card while timed (least, mean, largest): {res['card']}", flush=True)
        for kind, k in res["kinds"].items():
            print(f"  {kind} frames {k['frames']}: event ms "
                  + ", ".join(f"{x:.3f}" for x in k["event_ms"])
                  + (f" (mean {k['mean_event_ms']:.3f})" if k["event_ms"] else ""), flush=True)
    if opts.kitti_s:
        from pose_estimation_tpu_torch.testing import StereoInertialSim

        for label in opts.configs.split(","):
            kcfg = smoke.kitti_config(full_ba_keyframes=label == "full_ba")
            _, _, frames_k, _ = smoke.run_state_machine(
                kcfg, StereoInertialSim(kcfg, n_landmarks=150, seed=0), opts.kitti_s, 10, 0, dev)
            res = out[f"kitti_{label}"] = kitti_by_kind(frames_k)
            print(f"KITTI-width state machine, {label}, {opts.kitti_s:g} s: "
                  + "; ".join(f"{kind} frames {r['frames']}, mean {r['mean_ms']:.2f} ms, median "
                              f"{r['median_ms']:.2f}" for kind, r in res.items()), flush=True)
    print(json.dumps(out, default=str))


def kitti_by_kind(frames) -> dict:
    """The OK frames after the first that ran the step alone (no host work
    beside it), by kind: a keyframe that tracks, any other frame."""
    kinds = {"keyframe": [], "other": []}
    for f in frames[1:]:
        if f["events"] == "" and "ms" in f:
            m = f["metrics"]
            kf = bool(m["is_keyframe"]) and int(m["n_tracked"]) > 0
            kinds["keyframe" if kf else "other"].append(f["ms"])
    return {k: {"frames": len(v), "mean_ms": float(np.mean(v)) if v else float("nan"),
                "median_ms": float(np.median(v)) if v else float("nan"), "ms": v}
            for k, v in kinds.items()}


if __name__ == "__main__":
    main()
