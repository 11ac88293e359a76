"""Traffic kind `stream`: one sequence, closed loop, through the state
machine (`slam.VisualInertialSLAM` with its defaults: graphed, fused).

For each frame the harness hands the frame's IMU samples to
`collect_imu_data`, the stereo pair to `process`, then waits for the card;
the next frame goes in when that returns. A frame's latency runs from its
first IMU sample handed over to the return of that wait.

Set-up: the bootstrap (SYNC to the first OK frame, `bootstrap_s`), then
the same sequence on until the gravity refinement at the full keyframe
chain has run captured (its first call runs eagerly, its second captures
the graph) and, where the traffic sets `settle_frames`, until the state
machine has stayed in OK that many frames in a row (the resets of its
start-up transient fall in set-up, not in the window), then
`warm_frames` more. The window continues the sequence.
A solve whose first call falls inside the window (a warm recovery, a
refinement at a new chain length) runs eagerly there: the run says so on
standard error.

The comparison runs the reference from the program's state at `samples`
window frames drawn from the seed among the first `sample_rate_low` x
seconds, and at the first frames after each of the window's first
`after_refine` replayed gravity refinements, `chain` frames each.

A traced run keeps the program's own spans over the window
(`record.program_trace`): cleared when the window starts, read when it
ends.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from vio_bench import check
from vio_bench.record import Record
from vio_bench.trace import Tracer, span


def frames_needed(traffic: dict, seconds: float) -> int:
    return int(traffic["setup_frames_max"] + traffic["warm_frames"]
               + math.ceil(traffic["frames_factor"] * traffic["frames_per_s_high"] * seconds) + 2)


def _solve_calls(slam) -> dict:
    sg = slam._solve_graphs
    return dict(sg.calls) if sg is not None else {}


def _refine_captured(slam) -> bool:
    k = slam.gravity_refine_window
    return any(key[0] == "refine" and key[1][0][0] == k and n >= 2
               for key, n in _solve_calls(slam).items())


def run(ctx) -> Record:
    from pose_estimation_tpu_torch import graphs, profiling
    from pose_estimation_tpu_torch.slam import SensorType, State, VisualInertialSLAM

    tr, rec = ctx.traffic, Record()
    world = ctx.world(frames_needed(tr, ctx.seconds))
    slam = VisualInertialSLAM(ctx.cfg, seed=ctx.world_seed, device=ctx.device)
    sync = ctx.sync
    gyro, accel = SensorType.GYROSCOPE, SensorType.ACCELEROMETER

    def feed_imu(i):
        for k in world.samples_before(i):
            ts = world.sample_ns(k)
            slam.collect_imu_data(gyro, ts, *world.gyr[k])
            slam.collect_imu_data(accel, ts, *world.acc[k])

    def frame(i) -> bool:
        feed_imu(i)
        return slam.process(world.left[i], world.right[i], world.frame_ns(i))

    i, t_first, resets = 0, time.perf_counter(), 0
    while slam.state != State.OK:
        if i >= tr["setup_frames_max"]:
            raise RuntimeError(f"the bootstrap did not reach OK in {i} frames")
        frame(i)
        i += 1
    sync()
    rec.bootstrap_s = time.perf_counter() - t_first
    to_ok = i
    # on until the refinement at the full chain has replayed (a reset of the
    # state machine starts its keyframe chain again) and the state machine
    # has stayed in OK `settle_frames` frames in a row, at most
    # `setup_frames_max` frames in all, and then in OK
    settle, in_ok_run = tr.get("settle_frames", 0), 0
    while i < tr["setup_frames_max"] and (
            slam.state != State.OK or in_ok_run < settle
            or (tr["refine_captured"] and not _refine_captured(slam))):
        was_ok = slam.state == State.OK
        frame(i)
        resets += was_ok and slam.state != State.OK
        in_ok_run = in_ok_run + 1 if was_ok and slam.state == State.OK else 0
        i += 1
    if in_ok_run < settle:
        raise RuntimeError(f"the state machine did not stay in OK {settle} frames in a row "
                           f"within {i} set-up frames ({resets} reset(s))")
    for _ in range(tr["warm_frames"]):
        frame(i)
        i += 1
    while slam.state != State.OK:
        if i >= tr["setup_frames_max"] + tr["warm_frames"] + tr["setup_frames_max"]:
            raise RuntimeError(f"set-up ended in state {slam.state.name}")
        frame(i)
        i += 1
    sync()
    rec.setup_frames = i
    print(f"set-up: OK after {to_ok} frames, {i} in all, {resets} reset(s) of the state "
          f"machine, refinement at the full chain captured: {_refine_captured(slam)}, "
          f"{in_ok_run} frames in OK in a row before the warm frames", file=sys.stderr)

    # the window
    rng = ctx.sample_rng()
    n_low = max(int(tr["sample_rate_low"] * ctx.seconds), 1)
    starts = set(int(s) for s in rng.choice(n_low, size=min(tr["samples"], n_low), replace=False))
    tracer = Tracer(ctx.trace, sync)
    if ctx.trace:
        graphs.iteration_log = []
    calls_before = _solve_calls(slam)
    latencies, host_ms, sync_ms, frames_run, samples, open_sample = [], [], [], [], [], None
    traced_frames = 0
    trace_from_refines = None
    prev_ok_before, pending, paused = False, 0, 0.0
    refines_seen, after_refine = _refine_replays(slam), tr["after_refine"]
    reset_ms = 0.0
    ctx.mark_setup_done()
    if ctx.trace:
        profiling.reset()
    t0 = time.perf_counter()
    n = 0
    while True:
        if i >= world.n_frames:
            raise RuntimeError(
                f"ran out of frames after {n} window frames ({n / (time.perf_counter() - t0):.1f} "
                f"frames/s); the generator made {world.n_frames} for "
                f"{tr['frames_factor']} x {tr['frames_per_s_high']} frames/s")
        if ctx.trace and n == tr["trace_from"]:
            tracer.start()
            trace_from_refines = _refine_replays(slam)
        ok_before = slam.state == State.OK
        pending += n in starts
        # a sample starts only where the frame before was an OK frame too
        # (else it waits for such a frame): only then does the queue hold
        # exactly this frame's IMU samples (after a reset's bootstrap frames
        # it holds more, which `process` integrates before the step)
        if pending and ok_before and prev_ok_before and open_sample is None:
            pending -= 1
            open_sample = check.Sample(check.copy_leaves(slam.vio), [slam._gen.get_state()],
                                       [[i]])
            calls_at = sum(_solve_calls(slam).values())
        ta = time.perf_counter()
        with span("imu_feed"):
            feed_imu(i)
        tb = time.perf_counter()
        with span("process"):
            ok = slam.process(world.left[i], world.right[i], world.frame_ns(i))
        tc = time.perf_counter()
        with span("sync"):
            sync()
        td = time.perf_counter()
        latencies.append((td - ta) * 1e3)
        if tracer.active:
            traced_frames += 1
        else:
            host_ms.append((tc - tb) * 1e3)
            sync_ms.append((td - tc) * 1e3)
        in_ok = slam.state == State.OK
        frames_run.append((i, ok, in_ok))
        if not (ok_before and in_ok):
            reset_ms += latencies[-1]
        refines = _refine_replays(slam)
        if refines > refines_seen:
            refines_seen = refines
            if after_refine:
                after_refine -= 1
                pending += 1
        if open_sample is not None:
            if open_sample.frames[-1] != [i]:
                open_sample.frames.append([i])
            solved = sum(_solve_calls(slam).values()) != calls_at
            if len(open_sample.frames) >= tr["chain"] or solved or not in_ok:
                samples.append(open_sample)
                open_sample = None
        if tracer.active and traced_frames >= tr["trace_min_frames"] and (
                _refine_replays(slam) > trace_from_refines
                or traced_frames >= tr["trace_max_frames"]):
            paused += tracer.stop()
        prev_ok_before = ok_before
        i += 1
        n += 1
        if td - t0 - paused >= ctx.seconds:
            break
    tracer.stop()
    rec.window_s = td - t0 - paused
    if open_sample is not None:
        samples.append(open_sample)
    rec.frames = n
    rec.latencies_ms = latencies
    rec.host_ms = host_ms
    rec.sync_ms = sync_ms
    rec.reset_ms = reset_ms
    if ctx.trace:
        rec.program_trace = profiling.read()
        rec.trace = tracer.read()
    rec.memory_peak_bytes = ctx.memory_peak()
    for key, count in _solve_calls(slam).items():
        if count == 1 and key not in calls_before:
            print(f"note: the solve {key[0]} (first input {tuple(key[1][0])}) ran its eager "
                  "first call inside the window", file=sys.stderr)
            rec.eager_in_window += 1
    if slam._graphs is not None:
        st = slam._graphs.stats().get("frame")
        if st and "nodes" in st:
            rec.graph_nodes = st["nodes"] + st["while_body_nodes"] + st["if_body_nodes"]
    if ctx.trace:
        rec.lm_iters = [n for name, n, _ in graphs.read_iterations(graphs.iteration_log)
                        if name == "ba"]
        graphs.iteration_log = None

    # the program's poses, as its users read them (save_results)
    poses = _saved_poses(slam, ctx.scratch_file("states.csv"))
    rec.attempted = n
    rec.failed = sum(1 for f, ok, in_ok in frames_run
                     if not ok or not in_ok or not _finite(poses.get(world.frame_ns(f))))
    left_ok = sum(1 for a, b in zip(frames_run, frames_run[1:]) if a[2] and not b[2])
    print(f"window: {rec.failed} failed frames, the state machine left OK {left_ok} time(s)",
          file=sys.stderr)
    del slam, frame, feed_imu
    ctx.free()

    def program_pose(s, k):
        pose = poses.get(world.frame_ns(s.frames[k][0]))
        return None if pose is None else (pose[0][None], pose[1][None])

    rec.samples, rec.world, rec.program_pose = samples, world, program_pose
    return rec


def _refine_replays(slam) -> int:
    sg = slam._solve_graphs
    if sg is None:
        return 0
    return sum(s.replays for key, s in sg.steps.items() if key[0] == "refine")


def _finite(pose) -> bool:
    return pose is not None and bool(np.all(np.isfinite(pose[0])) and np.all(np.isfinite(pose[1])))


def _saved_poses(slam, path) -> dict:
    """{timestamp: (p [3], q [4] as w, x, y, z)} from `save_results`. The
    file holds float32 values in their shortest decimal form, which reads
    back exactly only as float32."""
    slam.save_results(str(path))
    rows = np.atleast_2d(np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64))
    rows = rows.astype(np.float32).astype(np.float64)
    with open(path) as f:
        next(f)
        stamps = [int(line.split(",", 1)[0]) for line in f]
    return {ts: (row[5:8], row[1:5]) for ts, row in zip(stamps, rows)}
