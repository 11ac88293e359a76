#!/usr/bin/env python3
"""A benchmark cell with the program's own spans on: the per-layer metrics
that read them, beside those the benchmark reads.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/trace_cells.py --workload euroc-stream --seed 7 --seconds 20 \
        [--stamps 1] [--profile 1] [--out trace_cells.jsonl]

Runs the cell through the benchmark's own traffic drivers
(`vio_bench/stream.py`, `vio_bench/batch.py`), as `vio_bench/run.py
--trace <profile>` does, with the program's tracing (`profiling.enable`)
turned on before the system is built where `--stamps 1`, reset when the
window starts and read after it; the profiler's stretch is kept on the
same clock (`vio_bench/stamps.py`). Prints one JSON line: the end-to-end
metrics, every per-layer metric of `vio_bench/metrics/` that finds
something to read (the six that read the program's spans among them), the
graph's node count without the stamps, frame by frame the stamped `lm.ba`
iterations against the logged ones, the stage spans' device ms against
the frame's, the stamps' own device time a frame (the profiler's
`span_stamp_kernel`), how far each stamp's converted time lies from the
profiler's interval of its kernel, how many of the profiler's device
intervals fall inside each stamped LM iteration of the stretch, and the
seconds the profiler took to start. `--rehearse` runs the cell's tiny CPU
rehearsal (no device metric).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import run as bench  # noqa: E402

NEW = ("frame_device_ms", "frontend_device_ms", "backend_device_ms", "lm_iter_device_ms",
       "host_wait_ms_per_frame", "device_idle_share_stamped")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--stamps", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--out", default="")
    opts = ap.parse_args(argv)
    bench._set_cache_dirs()
    import torch

    from pose_estimation_tpu_torch import graphs, profiling
    from vio_bench import batch, spec, stamps, stream, trace

    cell = spec.load_cell(opts.workload, rehearse=opts.rehearse)
    device = "cpu" if opts.rehearse else "cuda:0"
    torch.set_num_threads(4)
    if not opts.rehearse:
        from pose_estimation_tpu_torch.ops import kernels

        kernels.build()
    cfg = spec.program_config(cell, opts.rehearse)

    class Context(bench.Context):
        def mark_setup_done(self):
            super().mark_setup_done()
            profiling.reset()
            # the reset's calibration is set-up: the window starts after it
            self.setup_done = time.perf_counter()

    read, start, starts = trace.Tracer.read, trace.Tracer.start, []

    def read_with_timeline(self):
        out = read(self)
        if out is not None:
            timeline = stamps.profiler_timeline(self.prof, trace.STRETCH)
            if timeline is not None:
                out.stretch_ns, out.device_ns = timeline
                base = self.prof.profiler.kineto_results.trace_start_ns()
                out.stamp_ns = sorted(
                    (base + int(e.time_range.start * 1e3), base + int(e.time_range.end * 1e3))
                    for e in self.prof.events()
                    if e.device_type.name == "CUDA" and "span_stamp" in e.name)
        return out

    def timed_start(self):
        t0 = time.perf_counter()
        start(self)
        if self.active:
            starts.append(time.perf_counter() - t0)

    trace.Tracer.read, trace.Tracer.start = read_with_timeline, timed_start
    stats, last_stats = graphs._Graphs.stats, {}

    def kept_stats(self):
        out = stats(self)
        last_stats.update(out)
        return out

    graphs._Graphs.stats = kept_stats
    if opts.stamps:
        profiling.enable(device)
    drivers = {"stream": stream.run, "batch": batch.run}
    with tempfile.TemporaryDirectory(prefix="trace_cells_") as scratch:
        ctx = Context(cell, cfg, opts.seed, opts.seconds, bool(opts.profile), device, scratch)
        rec = drivers[cell.traffic["kind"]](ctx)
    rec.setup_s = ctx.setup_done - bench.T_START
    program = profiling.read() if opts.stamps else None
    rec.program_trace = program

    view = bench.RunView(rec, cfg, cell.traffic)
    names = [m["name"] for m in cell.end_to_end + cell.per_layer] + list(NEW)
    metrics = {}
    for name in names:
        value = spec.reader(name)(view)
        if value is not None:
            metrics[name] = value
    line = {"workload": opts.workload, "seed": opts.seed, "stamps": opts.stamps,
            "profile": opts.profile, "frames": rec.frames, "window_s": rec.window_s,
            "metrics": metrics, "profiler_start_s": starts}
    if not opts.rehearse:
        line["device"] = torch.cuda.get_device_name(0)
    if program is not None:
        line.update(_checks(program, rec))
    graph = last_stats.get("frame") or last_stats.get("batch")
    if graph is not None and "nodes" in graph:
        line["graph"] = {k: graph[k] for k in ("nodes", "while_body_nodes", "if_body_nodes",
                                              "stamp_nodes")}
    print(json.dumps(line), flush=True)
    if opts.out:
        with open(opts.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


def _checks(program, rec) -> dict:
    """What the program's spans say beside the benchmark's own readings."""
    from vio_bench import stamps

    replays = stamps.graph_replays(program)
    lm = {}
    for s in program.spans:
        if s.kind == "device" and s.name == "lm.ba":
            lm[s.replays] = lm.get(s.replays, 0) + 1
    stamped = [lm.get(r.replays, 0) for r in replays]
    stages = {n: stamps.per_replay_ms(program, (n,)) for n in (
        "ok_step.imu", "ok_step.extract", "ok_step.match", "ok_step.backend", "ok_step.pool")}
    stage_sum = [sum(v) for v in zip(*stages.values())]
    frame_ms = [(r.end - r.start) / 1e6 for r in replays]
    # the LM's period: one iteration's start to the next one's in a replay
    starts = {}
    for s in program.spans:
        if s.kind == "device" and s.name == "lm.ba":
            starts.setdefault(s.replays, []).append(s.start)
    period = [(b - a) / 1e6 for v in starts.values() for a, b in zip(v, v[1:])]
    # each device span name's ms a replay, and the host spans' ms a frame
    by_name, frames = {}, {s.frame for s in program.spans if s.name == "slam.process"}
    for s in program.spans:
        key = (s.kind, s.name)
        by_name[key] = by_name.get(key, 0) + (s.end - s.start) / 1e6
    per = {"device": max(len(replays), 1), "host": max(len(frames), 1)}
    # the PSD clip (K6): the middle of a replay's three `ok_step.backend` spans
    backend = {}
    for s in program.spans:
        if s.kind == "device" and s.name == "ok_step.backend":
            backend.setdefault(s.replays, []).append(s)
    clip = [(v[1].end - v[1].start) / 1e6 for v in backend.values() if len(v) == 3]
    out = {"replays": len(replays), "records": program.records, "dropped": program.dropped,
           "clock": [list(p) for p in program.clock],
           "stamped_lm_iters": stamped, "lm_period_ms": stamps.mean(period),
           "stage_ms": {n: stamps.mean(v) for n, v in stages.items()},
           "clip_span_ms": stamps.mean(clip),
           "span_ms": {f"{k}:{n}": v / per[k] for (k, n), v in sorted(by_name.items())},
           "stage_ms_sum": stamps.mean(stage_sum), "frame_device_ms": stamps.mean(frame_ms)}
    if rec.lm_iters is not None:
        out["logged_lm_iters"] = rec.lm_iters
        out["lm_iters_equal"] = stamped == rec.lm_iters
    t = rec.trace
    if t is not None:
        out["kernel_ms"] = {part: [stamps.mean(v), len(v)] for part in (
            "fast_select_kernel", "fast_score_nms_kernel", "sample_patches_kernel", "eigh_kernel",
            "svd3_kernel", "span_stamp_kernel")
            for v in [[x for k, xs in t.kernel_ms.items() if part in k for x in xs]] if v}
        ms = [v for k, vs in t.kernel_ms.items() if "span_stamp" in k for v in vs]
        traced = [r for r in replays if hasattr(t, "stretch_ns")
                  and t.stretch_ns[0] <= r.start and r.end <= t.stretch_ns[1]]
        if ms and traced:
            out["stamp_ms_per_frame"] = sum(ms) / len(traced)
            out["stamp_launches_traced"] = len(ms)
    if t is not None and getattr(t, "stamp_ns", None):
        out.update(_against_profiler(program, t))
    out["idle_gaps"] = t.idle_gaps if t is not None else None
    return out


def _against_profiler(program, t) -> dict:
    """How far each stamp's converted time lies outside the profiler's
    interval of the nearest stamp kernel (ns), and the profiler's device
    intervals inside each stamped `lm.ba` iteration of the stretch."""
    import bisect

    lo, hi = t.stretch_ns
    # the stamps outside conditional bodies, whose kernels the profiler records
    times = sorted(x for s in program.spans if s.kind == "device" and not s.body
                   for x in (s.start, s.end) if lo <= x <= hi)
    starts = [a for a, _ in t.stamp_ns]
    off, signed = [], []
    for x in times:
        k = bisect.bisect_right(starts, x)
        near = [t.stamp_ns[j] for j in (k - 1, k) if 0 <= j < len(starts)]
        off.append(min(max(a - x, x - b, 0) for a, b in near))
        a, b = min(near, key=lambda ab: abs((ab[0] + ab[1]) / 2 - x))
        signed.append((x, (a + b) / 2 - x))
    off.sort()
    # the signed offset (kernel's middle minus stamp) at the stretch's start
    # and end: a constant offset, or one that drifts
    q = max(len(signed) // 4, 1)
    drift = [sorted(o for _, o in part)[len(part) // 2] for part in (signed[:q], signed[-q:])]
    work = sorted(t.device_ns)
    mids = [(a + b) / 2 for a, b in work]
    seen, covered, frames = [], [], {}
    health = {s.frame for s in program.spans if s.kind == "host" and s.name == "slam.health"}
    for s in program.spans:
        if s.kind != "device" or s.name != "lm.ba" or s.start < lo or s.end > hi:
            continue
        i, j = bisect.bisect_left(mids, s.start), bisect.bisect_right(mids, s.end)
        seen.append(j - i)
        row = frames.setdefault(s.frame, [0, 0, s.frame in health])
        row[0] += 1
        row[1] += j > i
        inside = [(max(a, s.start), min(b, s.end)) for a, b in work[i:j]]
        covered.append(sum(b - a for a, b in inside if b > a) / (s.end - s.start))
    return {"top_stamps_in_stretch": len(times), "stamp_kernels_profiled": len(t.stamp_ns),
            "stamp_signed_offset_ns_first_last_quarter": drift if signed else None,
            "stamp_offset_ns": {"median": off[len(off) // 2] if off else None,
                                "p95": off[int(0.95 * (len(off) - 1))] if off else None,
                                "max": off[-1] if off else None},
            "lm_iterations_in_stretch": len(seen),
            "lm_iterations_no_kernel_seen": sum(n == 0 for n in seen),
            "profiler_intervals_per_lm_iteration": sum(seen) / len(seen) if seen else None,
            "lm_iteration_share_covered": sum(covered) / len(covered) if covered else None,
            "lm_by_frame_iterations_seen_health": [[f, *v] for f, v in sorted(frames.items())]}


if __name__ == "__main__":
    sys.exit(main())
