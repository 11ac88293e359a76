#!/usr/bin/env python3
"""The SfM bootstrap's PnP against the simulator's true poses.

Run from the repository root (on the CPU by default):

    python3 tools/sfm_pnp_truth.py [--run A0] [--seeds 0-31] [--device cpu|cuda]

For each seed of the state machine's draws, the protocol world `--run`
(`testing.protocol_world`) is replayed through
`slam.VisualInertialSLAM(seed=s, graphed=False)` until it leaves the SfM
state, recording the inputs of every `pnp_ransac` call (the frame's
correspondences and the draw's uniforms). Each recorded problem is then
solved again on the same hypotheses with two rules for the RANSAC winner:
`pnp_ransac`'s own (the least truncated squared error, MSAC) and the
inlier count (the JAX package's rule), each followed by the same
Gauss-Newton polish. Both poses are held to the true relative pose of the
two camera frames. Prints one line per rule: the translation error's
median, 90th percentile and maximum, the problems more than 4 cm off, the
rotation error and the inliers; then one JSON line of the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _seeds(text: str) -> list[int]:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(x) for x in text.split(",")]


def record(run: str, seed: int, device: str):
    """[(pnp_ransac args, kwargs, reference frame's ns, frame's ns)] of the
    SfM frames of one replay, and the world."""
    from pose_estimation_tpu_torch.ops import pnp
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM
    from pose_estimation_tpu_torch.testing import PROTOCOL_IMU_NOISE, protocol_world

    cfg, world, duration, imu_seed = protocol_world(run)
    slam = VisualInertialSLAM(cfg, seed=seed, device=device, graphed=False)
    calls, now = [], {}
    solve = pnp.pnp_ransac

    def recording(*args, **kw):
        calls.append(([a.clone() for a in args], kw, now["ref"], now["ts"]))
        return solve(*args, **kw)

    class Done(Exception):
        pass

    process = slam.process

    def step(img_l, img_r, ts):
        now["ts"] = ts
        before = (slam.state.name, slam._sfm_count)
        out = process(img_l, img_r, ts)
        if slam.state.name == "SFM" and (before[0] != "SFM" or slam._sfm_count > before[1]):
            now["ref"] = ts     # the new reference frame of the next PnP
        if slam.state.name in ("INITIALIZING", "OK"):
            raise Done
        return out

    slam.process = step
    pnp.pnp_ransac = recording
    try:
        world.run(slam, duration=duration, imu_noise=PROTOCOL_IMU_NOISE, seed=imu_seed)
    except Done:
        pass
    finally:
        pnp.pnp_ransac = solve
    return calls, cfg, world


def count_winner(obj, px, mask, k_mat, u, solver="dlt", threshold_px=8.0, gn_iters=10,
                 idx=None):
    """`pnp_ransac` with the winner by inlier count: (rvec, tvec, inliers)."""
    import torch

    from pose_estimation_tpu_torch.ops import pnp
    from pose_estimation_tpu_torch.ops.ransac import sample_indices
    from pose_estimation_tpu_torch.utils import lie

    fx, fy, cx, cy = k_mat[0, 0], k_mat[1, 1], k_mat[0, 2], k_mat[1, 2]
    img_n = torch.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy], dim=-1)
    thr_n2 = (threshold_px / ((fx + fy) * 0.5)) ** 2
    if idx is None:
        idx = sample_indices(mask, u)
    r_h, t_h = {"dlt": pnp._dlt_pose, "epnp": pnp._epnp_pose}[solver](obj[idx], img_n[idx])
    inl = (pnp._reproj_err2(r_h, t_h, obj, img_n) < thr_n2) & mask[None, :]
    best = int(torch.argmax(inl.sum(1)))
    inliers = inl[best]
    rvec, tvec = lie.so3_log(r_h[best]), t_h[best]
    for _ in range(2):
        rvec, tvec = pnp.gauss_newton_pose(obj, img_n, inliers.to(obj.dtype), rvec, tvec,
                                           gn_iters)
        err2 = pnp._reproj_err2(lie.so3_exp(rvec)[None], tvec[None], obj, img_n)[0]
        inliers = (err2 < thr_n2) & mask
    return rvec, tvec, int(inliers.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default="A0")
    ap.add_argument("--seeds", default="0-31")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pose_estimation_tpu_torch.ops import pnp
    from pose_estimation_tpu_torch.utils import lie

    errs = {"msac": [], "count": []}
    for seed in _seeds(args.seeds):
        calls, cfg, world = record(args.run, seed, args.device)
        r_cb = np.asarray(cfg.r_cb, np.float64)
        for a, kw, ref_ns, ns in calls:
            # x_c2 = R x_c1 + t from the trajectory (camera at the body's
            # origin, x_c = r_cb R_wb^T (x_w - p_wb)); sfm_step's PnP takes
            # the current camera's points into the reference camera: the
            # inverse
            r1, p1 = world.traj.rot(ref_ns * 1e-9), world.traj.pos(ref_ns * 1e-9)
            r2, p2 = world.traj.rot(ns * 1e-9), world.traj.pos(ns * 1e-9)
            r21 = r_cb @ r2.T @ r1 @ r_cb.T
            t21 = r_cb @ r2.T @ (p1 - p2)
            r_true, t_true = r21.T, -r21.T @ t21
            got = pnp.pnp_ransac(*a, **kw)
            poses = {"msac": (got.rvec, got.tvec, int(got.n_inliers)),
                     "count": count_winner(*a, **kw)}
            for rule, (rvec, tvec, n) in poses.items():
                r = lie.so3_exp(rvec.double()).cpu().numpy()
                cos = np.clip((np.trace(r @ r_true.T) - 1) / 2, -1, 1)
                errs[rule].append((float(np.linalg.norm(tvec.double().cpu().numpy() - t_true)),
                                   float(np.degrees(np.arccos(cos))), n))
    out = {"run": args.run, "seeds": args.seeds, "device": args.device}
    for rule, rows in errs.items():
        e = np.asarray(rows)
        out[rule] = {"problems": len(e), "t_err_median_m": float(np.median(e[:, 0])),
                     "t_err_p90_m": float(np.percentile(e[:, 0], 90)),
                     "t_err_max_m": float(e[:, 0].max()),
                     "over_4cm": int((e[:, 0] > 0.04).sum()),
                     "rot_err_median_deg": float(np.median(e[:, 1])),
                     "inliers_mean": float(e[:, 2].mean())}
        o = out[rule]
        print(f"{rule}: {o['problems']} SfM PnP problems, translation error median "
              f"{o['t_err_median_m']:.4f} m, p90 {o['t_err_p90_m']:.4f}, max "
              f"{o['t_err_max_m']:.4f}, {o['over_4cm']} over 4 cm; rotation error median "
              f"{o['rot_err_median_deg']:.3f} deg; {o['inliers_mean']:.1f} inliers")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
