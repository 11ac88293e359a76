"""The program's own spans (`pose_estimation_tpu_torch.profiling`) as the
per-layer metrics that read them see them.

A traced run that turns the program's tracing on before it builds the
system, resets it at the window's start and reads it after the window
keeps what `profiling.read()` returned in `record.program_trace`; it keeps
the profiler stretch's bounds and the device intervals the profiler
recorded in it, on the same clock (`profiling.clock_ns`), in
`record.trace.stretch_ns` and `record.trace.device_ns`
(`profiler_timeline`). Where a run has none of these (a harness or a
program without the program's spans), every reader here finds nothing and
returns None.
"""

from __future__ import annotations

GRAPHS = ("graph.frame", "graph.batch")


def program_trace(run):
    return getattr(run.record, "program_trace", None)


def graph_replays(trace) -> list:
    """The device spans of the frame or batch graph's replays."""
    return [s for s in trace.spans if s.kind == "device" and s.name in GRAPHS]


def per_replay_ms(trace, names) -> list:
    """For each replay of the frame or batch graph, the device ms of its
    spans named in `names`, summed."""
    sums = {s.replays: 0 for s in graph_replays(trace)}
    for s in trace.spans:
        if s.kind == "device" and s.name in names and s.replays in sums:
            sums[s.replays] += s.end - s.start
    return [ns / 1e6 for ns in sums.values()]


def mean(values):
    return sum(values) / len(values) if values else None


def profiler_timeline(prof, stretch_name: str):
    """((start, end) of the host span `stretch_name`, [(start, end)] of
    every device interval of the profiler's kernels, copies and sets
    inside it, cut to it), in ns on the profiler's clock; None without the
    span."""
    base = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    stretch = [e for e in events if e.name == stretch_name and e.device_type.name == "CPU"]
    if not stretch:
        return None
    lo = base + int(stretch[0].time_range.start * 1e3)
    hi = base + int(stretch[0].time_range.end * 1e3)
    work = []
    for e in events:
        if e.device_type.name != "CUDA" or e.is_user_annotation:
            continue
        a = max(base + int(e.time_range.start * 1e3), lo)
        b = min(base + int(e.time_range.end * 1e3), hi)
        if b > a:
            work.append((a, b))
    return (lo, hi), work
