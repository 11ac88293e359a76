#!/usr/bin/env python3
"""The port's state machine against the JAX package's on one world of the
accuracy protocol, on the CPU (both packages; the JAX sampler in Pallas
interpret mode, so both follow the kernel path).

    python3 tools/fsm_parity.py teacher A0      # per-frame, teacher-forced
    python3 tools/fsm_parity.py jax-seeds A0 --seeds 1-4
    python3 tools/fsm_parity.py cross A0 --seeds 0-1

`teacher` runs the JAX state machine over the world and, at every OK
frame, steps the port's `ok_step` from the JAX state with the uniforms of
JAX's key, printing per frame the position, velocity and acc-bias gaps and
both packages' tracked counts, then a summary. `jax-seeds` runs the JAX
state machine alone with several PRNG keys and prints the protocol's gate
quantities per key, the counterpart of `tools/accuracy_seeds.py`.
`cross` runs both state machines (JAX key s, port seed s) to their first
OK frame, prints each one's gravity error there, then finishes the world
four ways: each package from its own state and each from the other's
state (the other package's first-OK state and host queues carried over),
and prints the gates of all four, separating what the bootstrap and
initializer contribute to an outcome from what the OK phase does. Each
6-s world takes 3-4 minutes per JAX run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _world(run: str):
    import sim as jsim

    family, world_seed = run[0], int(run[1:])
    duration = 6.0 if family == "A" else 12.0
    cfg = jsim.sim_config(sample_backend="pallas_interpret", keyframe_rotation=0.1,
                          keyframe_translation=0.15)
    world = jsim.StereoInertialSim(cfg, n_landmarks=150 if family == "A" else 220,
                                   seed=world_seed, y_max=max(11.0, 0.8 * duration + 5.0))
    jsim.set_family(world, family)
    return cfg, world, duration, world_seed + 10


def _gates(slam, gt):
    from pose_estimation_tpu.io.ate import ate_rmse

    path = float(np.linalg.norm(np.diff(gt[:, 1:], axis=0), axis=1).sum())
    win = slam.vio.win
    return {"state": slam.state.name,
            "ate_pct": ate_rmse(slam.trajectory, gt) / path * 100.0,
            "ba": float(np.linalg.norm(np.asarray(win.ics.ba_i[-1] + win.dba[-1]))),
            "bg": float(np.linalg.norm(np.asarray(win.ics.bg_i[-1] + win.dbg[-1])))}


def teacher(run: str) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM
    from pose_estimation_tpu_torch import convert, testing
    from pose_estimation_tpu_torch.models import vio as tvio
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM

    cfg, world, duration, imu_seed = _world(run)
    jslam = JaxSLAM(cfg)
    port = VisualInertialSLAM(testing.sim_config(keyframe_rotation=0.1,
                                                 keyframe_translation=0.15), device="cpu")
    step, rows = jslam._ok_step, []

    def t(a):
        return torch.from_numpy(np.array(a))

    def both(state, img_l, img_r, gyr, acc, mask, key):
        new, jm = step(state, img_l, img_r, gyr, acc, mask, key)
        us = tuple(t(jax.random.uniform(k, (64, 8), dtype=jnp.float32))
                   for k in jax.random.split(key))
        _, tm = tvio.ok_step(convert.state_from_numpy(jax.tree.map(np.asarray, state), "cpu"),
                             t(img_l), t(img_r), t(gyr), t(acc), t(mask), None, port.consts,
                             port.static, ransac_u=us)
        row = {k: float(np.linalg.norm(np.asarray(jm[f"rec_{k}"]) - tm[f"rec_{k}"].numpy()))
               for k in ("p", "v", "ba")}
        row.update(jax_tracked=int(jm["n_tracked"]), port_tracked=int(tm["n_tracked"]))
        rows.append(row)
        print(json.dumps(row), flush=True)
        return new, jm

    jslam._ok_step = both
    gt = world.run(jslam, duration=duration, imu_noise=2.4e-3, seed=imu_seed)
    same = [r for r in rows if r["jax_tracked"] == r["port_tracked"]]
    other = [r for r in rows if r["jax_tracked"] != r["port_tracked"]]
    print(json.dumps({
        "run": run, "ok_frames": len(rows), "same_tracked": len(same),
        "port_fewer": sum(r["port_tracked"] < r["jax_tracked"] for r in other),
        "port_more": sum(r["port_tracked"] > r["jax_tracked"] for r in other),
        "p_gap_median_same_tracked": float(np.median([r["p"] for r in same])) if same else None,
        "p_gap_median_other_tracked": float(np.median([r["p"] for r in other])) if other else None,
        "p_gap_max": max(r["p"] for r in rows), "jax": _gates(jslam, gt)}))


def jax_seeds(run: str, seeds) -> None:
    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM

    for s in seeds:
        cfg, world, duration, imu_seed = _world(run)
        slam = JaxSLAM(cfg, seed=s)
        gt = world.run(slam, duration=duration, imu_noise=2.4e-3, seed=imu_seed)
        g = _gates(slam, gt)
        g["pass"] = g["state"] == "OK" and g["ate_pct"] < 4.0 and g["ba"] < 1.5 and g["bg"] < 0.01
        print(json.dumps({"run": run, "key": s, **g}), flush=True)


class _Recorder:
    """Stands in for a state machine and records the replay's calls."""

    def __init__(self):
        self.calls = []

    def collect_imu_data(self, sensor, *args):
        self.calls.append(("imu", sensor.name, args))

    def process(self, *args):
        self.calls.append(("img", None, args))
        return True


def _feed(slam, calls, sensor_type, until=None) -> int:
    """Replay `calls` into `slam`, stopping before the first call at which
    until(slam) holds. Returns the number of calls replayed."""
    for i, (kind, name, args) in enumerate(calls):
        if until is not None and until(slam):
            return i
        if kind == "imu":
            slam.collect_imu_data(sensor_type[name], *args)
        else:
            slam.process(*args)
    return len(calls)


def _gravity_error_deg(slam, world) -> float:
    """Angle between the gravity direction in the newest window frame's
    body frame, estimated and true, at that frame's timestamp."""
    up = np.asarray(world.cfg.profile.gravity_dir, np.float64)
    est = np.asarray(slam.vio.win.R[-1], np.float64).T @ up
    true = world.traj.rot(slam._records[-1][0] * 1e-9).T @ up
    return float(np.degrees(np.arccos(np.clip(est @ true, -1.0, 1.0))))


def cross(run: str, seeds) -> None:
    import copy

    import jax
    import jax.numpy as jnp
    import torch

    from pose_estimation_tpu.slam import SensorType as JaxSensor
    from pose_estimation_tpu.slam import State as JaxState
    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM
    from pose_estimation_tpu_torch import convert, testing
    from pose_estimation_tpu_torch.slam import SensorType, State, VisualInertialSLAM

    cfg, world, duration, imu_seed = _world(run)
    rec = _Recorder()
    gt = world.run(rec, duration=duration, imu_noise=2.4e-3, seed=imu_seed)
    port_cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)

    def to_jax(template, tree):
        if hasattr(template, "_fields"):
            return type(template)(*(to_jax(getattr(template, f), getattr(tree, f))
                                    for f in template._fields))
        return jnp.asarray(np.asarray(tree), dtype=template.dtype)

    def carry(dst, src, vio, records):
        dst.vio = vio
        dst.state = JaxState.OK if isinstance(dst, JaxSLAM) else State.OK
        dst._imu_ts = list(src._imu_ts)
        dst._imu_data = [a.copy() for a in src._imu_data]
        dst._records = records
        return dst

    for s in seeds:
        jslam = JaxSLAM(cfg, seed=s)
        pslam = VisualInertialSLAM(port_cfg, device="cpu", seed=s)
        at_j = _feed(jslam, rec.calls, JaxSensor, lambda m: m.state == JaxState.OK)
        at_p = _feed(pslam, rec.calls, SensorType, lambda m: m.state == State.OK)
        out = {"run": run, "seed": s,
               "gravity_error_deg": {"jax": _gravity_error_deg(jslam, world),
                                     "port": _gravity_error_deg(pslam, world)}}
        j_records = [(r[0], *(np.asarray(x) for x in r[1:])) for r in jslam._records]
        p_records = [(r[0], *(x.cpu().numpy() for x in r[1:])) for r in pslam._records]
        port_from_jax = carry(
            VisualInertialSLAM(port_cfg, device="cpu", seed=s), jslam,
            convert.state_from_numpy(jax.tree.map(np.asarray, jslam.vio), "cpu"),
            [(r[0], *(torch.from_numpy(np.array(x)) for x in r[1:])) for r in j_records])
        jax_from_port = JaxSLAM(cfg, seed=s)
        carry(jax_from_port, pslam,
              to_jax(jax_from_port.vio, convert.state_to_numpy(pslam.vio)),
              copy.deepcopy(p_records))
        runs = {"jax>jax": (jslam, JaxSensor, at_j), "jax>port": (port_from_jax, SensorType, at_j),
                "port>jax": (jax_from_port, JaxSensor, at_p),
                "port>port": (pslam, SensorType, at_p)}
        out["gates"] = {}
        for name, (slam, sensor, at) in runs.items():
            _feed(slam, rec.calls[at:], sensor)
            g = _gates(slam, gt)
            g["pass"] = (g["state"] == "OK" and g["ate_pct"] < 4.0 and g["ba"] < 1.5
                         and g["bg"] < 0.01)
            out["gates"][name] = g
        print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("teacher", "jax-seeds", "cross"))
    ap.add_argument("run", help="A0, A1, A2, B0 or B1")
    ap.add_argument("--seeds", default="0-4")
    opts = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    lo, _, hi = opts.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    if opts.mode == "teacher":
        teacher(opts.run)
    elif opts.mode == "jax-seeds":
        jax_seeds(opts.run, seeds)
    else:
        cross(opts.run, seeds)


if __name__ == "__main__":
    main()
