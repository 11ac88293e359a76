"""Traffic kind `batch`: `lanes` sequences in lock-step, closed loop,
through `parallel.batched_slam.BatchedReplay.step`.

The harness stands in for the replay's bootstrap: each lane's window is
seeded at its own true state (every window frame at the true pose and
velocity of the frame before its first), and lane j starts `lane_offset`
x j frames into the one shared sequence, so the lanes see different
frames. Each step hands the host `uint8` frames of all lanes (a strided
view of the sequence) to `step`, then waits for the card. Set-up runs
`warm_steps` steps, the first of which captures the batched graph.

The comparison runs the reference from the start (every lane seeded at
its true state by the reference itself, through the set-up's steps and
the window's first `chain`) and from the program's state at `samples`
window steps drawn from the seed, `chain` steps each.

A traced run keeps the program's own spans over the window
(`record.program_trace`): cleared when the window starts, read when it
ends.
"""

from __future__ import annotations

import math
import time

import numpy as np

from vio_bench import check
from vio_bench.record import Record
from vio_bench.trace import Tracer, span


def run(ctx) -> Record:
    import torch

    from pose_estimation_tpu_torch import profiling
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.parallel.batched_slam import BatchedReplay

    tr, rec = ctx.traffic, Record()
    b, off = int(tr["lanes"]), int(tr["lane_offset"])
    steps_max = tr["warm_steps"] + math.ceil(
        tr["frames_factor"] * tr["frames_per_s_high"] * ctx.seconds / b) + 2
    world = ctx.world(1 + off * (b - 1) + steps_max)
    br = BatchedReplay(ctx.cfg, b, seed=ctx.world_seed, device=ctx.device)
    dev, sync = br.device, ctx.sync

    def seeded(first):
        r, p, v = world.truth(first - 1)
        state = vio.init_vio_state(br.static, dev)
        wlen = state.win.R.shape[0]

        def rep(a, shape):
            return torch.as_tensor(np.broadcast_to(a, shape).copy(), dtype=torch.float32,
                                   device=dev)
        return state._replace(win=state.win._replace(
            R=rep(r, (wlen, 3, 3)), p=rep(p, (wlen, 3)), v=rep(v, (wlen, 3))))

    br.batched_state = batched.stack_states([seeded(1 + off * j) for j in range(b)])
    masks = np.broadcast_to(world.mask, (b, world.m))

    def step(n):
        lo = 1 + n
        sl = slice(lo, lo + off * b, off)
        return br.step(world.left[sl], world.right[sl], world.gyr_chunks[sl],
                       world.acc_chunks[sl], masks)

    poses = []     # every step's (p [B, 3], quat [B, 4]), the set-up's first
    for n in range(tr["warm_steps"]):
        m = step(n)
        poses.append((m["rec_p"], m["rec_quat"]))
    sync()
    rec.setup_frames = tr["warm_steps"]

    rng = ctx.sample_rng()
    n_low = max(int(tr["sample_rate_low"] * ctx.seconds), 1)
    wanted = set(int(s) for s in rng.choice(n_low, size=min(tr["samples"], n_low), replace=False))
    tracer = Tracer(ctx.trace, sync)
    s0 = tr["warm_steps"]
    samples = [check.Sample(None, [], [[1 + off * j + k for j in range(b)]
                                       for k in range(s0 + tr["chain"])],
                            batched=True, gen_seeds=[ctx.world_seed + j for j in range(b)])]
    ctx.mark_setup_done()
    if ctx.trace:
        profiling.reset()
    t0 = time.perf_counter()
    n, paused = 0, 0.0
    while True:
        if s0 + n >= steps_max:
            raise RuntimeError(
                f"ran out of frames after {n} window steps ({n * b / (time.perf_counter() - t0):.1f}"
                f" frames/s); the generator made frames for {tr['frames_factor']} x "
                f"{tr['frames_per_s_high']} frames/s")
        if ctx.trace and n == tr["trace_from"]:
            tracer.start()
        if n in wanted:
            samples.append(check.Sample(
                check.copy_leaves(br.batched_state), [s._gen.get_state() for s in br.slams],
                [[1 + off * j + s0 + n + k for j in range(b)] for k in range(tr["chain"])],
                batched=True))
        with span("step"):
            m = step(s0 + n)
        with span("sync"):
            sync()
        td = time.perf_counter()
        poses.append((m["rec_p"], m["rec_quat"]))
        n += 1
        if tracer.active and n >= tr["trace_from"] + tr["trace_steps"]:
            paused += tracer.stop()
        if td - t0 - paused >= ctx.seconds:
            break
    tracer.stop()
    rec.window_s = td - t0 - paused
    rec.frames = n * b
    if ctx.trace:
        rec.program_trace = profiling.read()
        rec.trace = tracer.read()
    rec.memory_peak_bytes = ctx.memory_peak()
    if br._graphs is not None:
        st = br._graphs.stats().get("batch")
        if st and "nodes" in st:
            rec.graph_nodes = st["nodes"] + st["while_body_nodes"] + st["if_body_nodes"]
    p = torch.stack([a for a, _ in poses]).double().cpu().numpy()     # [steps, B, 3]
    q = torch.stack([a for _, a in poses]).double().cpu().numpy()     # [steps, B, 4]
    rec.attempted = n * b
    ok = np.isfinite(p[s0:]).all(axis=-1) & np.isfinite(q[s0:]).all(axis=-1)
    rec.failed = int((~ok).sum())
    del br, poses, m, step
    ctx.free()
    # a chained sample reaching past the window compares what the window made
    for s in samples:
        s.frames = [f for f in s.frames if f[0] - 1 < s0 + n]

    def program_pose(s, k):
        i = s.frames[k][0] - 1      # lane 0 takes frame 1 + i at step i
        return p[i], q[i]

    rec.samples, rec.world, rec.program_pose = samples, world, program_pose
    return rec
