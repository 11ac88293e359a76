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

    python3 tools/profiler_probe.py --mode conditional [--sessions 5] [--iterations 7]

Whether the profiler sees the kernels of a conditional node's body: a
captured graph (`graphs.CapturedStep`) of a top-level kernel
(`torch.flip`), a WHILE node (`graphs.iterate`) whose body runs a scan
(`cumsum`) and stops after `--iterations` of its cap of 20, and an IF node
(`graphs.cond`, taken) whose body sorts, profiled over 5 replays a
session; then the same with the WHILE node inside the IF node's body, as
the frame graph nests the BA's LM in its branch. `--body-kernels N` adds
N - 1 `sin` kernels to the WHILE body (the BA's body has 618 nodes). Per kind it counts the
profiler's device events of the kernels that the same operation launches
eagerly against those the replays ran, and the iterations the body's
stamps (`profiling`) saw.
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
    ap.add_argument("--mode", choices=("launches", "conditional"), default="launches")
    ap.add_argument("--iterations", type=int, default=7)
    ap.add_argument("--body-kernels", type=int, default=1)
    opts = ap.parse_args()
    if opts.mode == "conditional":
        conditional_probe(opts.sessions, opts.iterations, opts.body_kernels)
        return

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


def conditional_probe(sessions: int, iterations: int, body_kernels: int, cap: int = 20,
                      replays: int = 5) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pose_estimation_tpu_torch import graphs, profiling
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda()
    kernels.build()
    profiling.enable(dev)
    x0 = torch.rand(1 << 16, device=dev)
    stop = torch.tensor(iterations, dtype=torch.int32, device=dev)
    def scan(x):
        x = torch.cumsum(x, 0) * 1e-4
        for _ in range(body_kernels - 1):
            x = torch.sin(x)
        return x

    ops = {"top": lambda x: torch.flip(x, (0,)), "while": scan,
           "if": lambda x: torch.sort(x).values}

    def loop(y):
        return graphs.iterate(lambda c: (ops["while"](c[0]), c[1] + 1),
                              (y, torch.zeros((), dtype=torch.int32, device=dev)), cap,
                              lambda c: c[1] < stop, name="probe")[0]

    def flat(x, stop):
        y = loop(ops["top"](x))
        return graphs.cond(stop > 0, lambda: ops["if"](y), y, name="probe")

    def nested(x, stop):
        y = ops["top"](x)
        return graphs.cond(stop > 0, lambda: ops["if"](loop(y)), y, name="probe")

    def device_names(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return collections.Counter(e.name for e in prof.events()
                                   if e.device_type.name == "CUDA" and not e.is_user_annotation)

    eager = {kind: device_names(lambda op=op: op(x0)) for kind, op in ops.items()}
    out = {"mode": "conditional", "iterations": iterations, "cap": cap,
           "body_kernels": body_kernels,
           "replays_a_session": replays, "eager_kernels": {k: dict(v) for k, v in eager.items()}}
    for label, fn in (("flat", flat), ("nested", nested)):
        args = (x0.clone(), stop)
        graphs.warm_up(fn, args, dev)
        step = graphs.CapturedStep(label, fn, args, dev, torch.cuda.graph_pool_handle())
        step()
        torch.cuda.synchronize()
        rows = []
        for _ in range(sessions):
            profiling.reset()
            seen = device_names(lambda: [step() for _ in range(replays)])
            spans = profiling.read()
            row = {"stamped_iterations": len(spans.named("lm.probe")),
                   "stamped_if_bodies": len(spans.named("cond.probe"))}
            for kind, names in eager.items():
                runs = replays * {"top": 1, "while": iterations, "if": 1}[kind]
                row[kind] = {"expected": runs * sum(names.values()),
                             "seen": sum(seen[n] for n in names)}
            rows.append(row)
        out[label] = {"graph": step.stats, "sessions": rows}
    print(torch.cuda.get_device_name(0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
