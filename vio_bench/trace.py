"""The traced stretch of a `--trace 1` run and what is read from it.

The harness's own spans (`record_function`, around its calls into each
layer: `imu_feed`, `process` or `step`, `sync`) and one span over the
whole stretch (`bench.traced`) sit on the host's timeline. On the
device's timeline the profiler records every kernel, copy and set (the
kernels inside a replayed CUDA graph too); the spans it also lays there
as user annotations are left out, as `arith.union_length` counts work
only. From them: the stretch's length, the device's busy time (the union
of the work's intervals), each kernel's device times by name, the
operations that took most time, and the longest idle gaps, each named by
the harness span that covers most of it (or `harness` for the harness's
own work between spans). Beside them, on the clock of the program's own
spans (`stamps.profiler_timeline`), the stretch's bounds and its device
intervals, which the readers of those spans lay against them.
"""

from __future__ import annotations

import contextlib
import dataclasses

from vio_bench import arith, stamps

SPANS = ("imu_feed", "process", "step", "sync")
STRETCH = "bench.traced"


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_ms: dict          # kernel name -> [device ms of each launch]
    device_ops: list         # [[name, seconds]], the 10 largest sums
    idle_gaps: list          # [[host span, seconds]], the 10 longest gaps
    stretch_ns: tuple | None = None   # (start, end) on the program spans' clock
    device_ns: list | None = None     # [(start, end)] of the device work in it, same clock

    def mean_kernel_ms(self, part: str) -> float | None:
        """The mean device ms of the launches whose kernel name holds
        `part`, or None when the trace holds none."""
        times = [t for name, ts in self.kernel_ms.items() if part in name for t in ts]
        return sum(times) / len(times) if times else None


class Tracer:
    """A profiler session over a stretch of the window (or nothing when
    tracing is off)."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self.sync = sync
        self.active = False
        self.done = False
        self._stack = None
        self.prof = None

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        self._stack = contextlib.ExitStack()
        self.prof = self._stack.enter_context(profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        self._stack.enter_context(torch.profiler.record_function(STRETCH))
        self.active = True

    def stop(self) -> float:
        """End the session; returns the seconds that took (the profiler
        parses its events here), which the window leaves out."""
        if not self.active:
            return 0.0
        import time

        t0 = time.perf_counter()
        self.sync()
        self._stack.close()
        self.active, self.done = False, True
        return time.perf_counter() - t0

    def read(self) -> Trace | None:
        """The stretch's reading, or None when nothing was traced or the
        profiler saw no device work."""
        if self.prof is None:
            return None
        events = self.prof.events()
        stretch = [e for e in events if e.name == STRETCH and e.device_type.name == "CPU"]
        if not stretch:
            return None
        t0, t1 = stretch[0].time_range.start, stretch[0].time_range.end
        host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type.name == "CPU" and e.name in SPANS)
        work = []
        for e in events:
            if e.device_type.name != "CUDA" or e.is_user_annotation:
                continue
            if e.name in SPANS or e.name == STRETCH:
                continue
            a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
            if b > a:
                work.append((a, b, e.name, e.time_range.end - e.time_range.start))
        if not work:
            return None
        kernel_ms, sums = {}, {}
        for _, _, name, dur in work:
            kernel_ms.setdefault(name, []).append(dur / 1e3)
            sums[name] = sums.get(name, 0.0) + dur / 1e6
        busy = arith.union_length([(a, b) for a, b, _, _ in work])
        gaps, at = [], t0
        for a, b in arith.merged([(a, b) for a, b, _, _ in work]) + [[t1, t1]]:
            if a > at:
                gaps.append((a - at, at))
            at = max(at, b)
        named = []
        for length, start in sorted(gaps, reverse=True)[:10]:
            # the harness span that covers most of the gap
            cover = {}
            for s, e, n in host:
                part = min(e, start + length) - max(s, start)
                if part > 0:
                    cover[n] = cover.get(n, 0.0) + part
            named.append([max(cover, key=cover.get) if cover else "harness", length / 1e6])
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:10]
        stretch_ns, device_ns = stamps.profiler_timeline(self.prof, STRETCH)
        return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6, kernel_ms=kernel_ms,
                     device_ops=[[n, s] for n, s in top], idle_gaps=named,
                     stretch_ns=stretch_ns, device_ns=device_ns)
