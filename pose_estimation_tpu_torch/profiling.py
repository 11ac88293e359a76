"""The program's spans, and per-stage wall-clock timing.

Spans. `span(name)` marks a region of the program: a layer's entry on the
host (`slam.process` and its parts, `batch.step`, `graphs.capture`; these
pass `host=True`) or a region of device work (a graph's replay
`graph.<name>`, the frame's stages `ok_step.*`, each LM iteration `lm.<solve>`,
each taken branch `cond.<site>`). With tracing off (the default) it is one
shared no-op, so a graph captured then is node for node the graph of a
program without spans. `enable()` turns tracing on; do it before the
system captures its graphs, which hold the stamps they were captured with.

With tracing on:

- a host span records its name, start, end and parent on the host clock,
  and is also a `torch.profiler.record_function` range, so a profiler
  trace holds it;
- a device span records a stamp at its start and at its end: a one-thread
  kernel (`csrc/span_stamp.cu`) that reads the device's global timer and
  appends (site, replay ordinal, ns) to a ring in device memory, allocated
  once by `enable()` outside every graph pool. Inside a capture
  (`graphs.CapturedStep`) the stamps are nodes of the graph, also inside
  a conditional node's WHILE or IF body: each replay, each LM iteration
  and each taken branch leaves its own records, which `torch.profiler`
  does not see (the kernels of a conditional body never reach its device
  timeline). Eagerly a device span stamps too and is a host span as well.
  A graph's first stamp (and an eager device span with none around it)
  takes a new replay ordinal; the innermost host span open at the replay
  carries that ordinal (`Span.replays`), and so does every device span of
  the replay. A full ring drops records and counts them; it never wraps.
  On the CPU the host clock stands in for the device's timer: the same
  records in a list of the same capacity.

Nothing reads the device on the hot path: `read()` copies the ring to the
host in one transfer and returns every closed span on the host clock (the
clock of `torch.profiler`'s events, `time.time_ns`), the device's
nanoseconds mapped by the offset and rate of two calibrations (one at
`enable()` or `reset()`, one at `read()`, each the tightest of several
synchronised brackets around a timer read). `reset()` clears the spans
and the ring. `hold()` keeps device spans from recording: the warm-up of a
graph and the eager first call of a solve (`graphs.warm_up`,
`graphs.SolveGraphs`) leave no records, as their LM iterations are not
logged.

`StageTimers` keeps a registry of named stages and waits for the device
where the result it is given holds CUDA tensors (PyTorch returns before
the GPU finishes, as JAX does before `block_until_ready`).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch

# the host clock of every span: CLOCK_REALTIME, the clock of torch.profiler's
# CPU and device events (csrc/span_stamp.cu's `span_clock` reads it too)
clock_ns = time.time_ns

# records the device ring holds (16 bytes each) unless `enable` is told
CAPACITY = 1 << 20
# the brackets of one clock calibration, of which the tightest is kept
BRACKETS = 8
_RECORD = np.dtype([("code", "<i4"), ("ordinal", "<i4"), ("ns", "<i8")])


class Span(NamedTuple):
    name: str
    start: int            # ns on the host clock (`clock_ns`)
    end: int
    parent: int           # index of the parent span in `Trace.spans`, -1 for a root
    kind: str             # "host" or "device"
    frame: int | None     # the frame id of `slam.process` or `batch.step` above it
    replays: tuple        # device: its replay ordinal; host: those begun inside it
    body: bool = False    # a device span captured inside a conditional node's body


class Trace(NamedTuple):
    spans: list           # [Span], the host spans first, each after its parent
    records: int          # device records appended since the last reset
    dropped: int          # of those, the ones a full ring dropped
    clock: tuple = ()     # the calibration points (host ns, device ns, half width)

    def named(self, name: str, kind: str = "device") -> list:
        return [s for s in self.spans if s.name == name and s.kind == kind]


def fit_clock(brackets) -> tuple[int, int, int]:
    """(host ns, device ns, half width) from (host before, device ns, host
    after) brackets around a device timer read: the tightest bracket, its
    host time taken at its middle."""
    before, dev, after = min(brackets, key=lambda b: b[2] - b[0])
    return (before + after) // 2, dev, (after - before) // 2


def to_host(dev_ns, points) -> np.ndarray:
    """Device ns on the host clock, by the calibration points [(host ns,
    device ns, half width)]: the first point's offset, and the rate between
    the first and the last where they are apart."""
    h0, d0, _ = points[0]
    h1, d1, _ = points[-1]
    dev = np.asarray(dev_ns, np.int64) - d0
    if d1 == d0:
        return h0 + dev
    return h0 + np.round(dev * ((h1 - h0) / (d1 - d0))).astype(np.int64)


def pair_records(codes, ordinals) -> list:
    """[[site, ordinal, begin index, end index, parent]] of device records
    in their order: a span's begin record (even code) and its end (odd)
    paired by nesting, a parent the position of the span around it in the
    list (-1 for none). A record that breaks the nesting (a dropped
    record's neighbour) closes nothing and empties the stack."""
    out, stack = [], []
    for i, (c, o) in enumerate(zip(codes, ordinals)):
        site, end = int(c) >> 1, int(c) & 1
        if not end:
            out.append([site, int(o), i, None, stack[-1] if stack else -1])
            stack.append(len(out) - 1)
        elif stack and out[stack[-1]][0] == site and out[stack[-1]][1] == o:
            out[stack.pop()][3] = i
        else:
            stack.clear()
    return out


class _Recorder:
    def __init__(self, device, capacity: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.capacity = capacity
        self.sites: list[tuple[str, int, bool]] = []    # (name, parent site, in a body)
        self.site_of: dict[tuple[str, int, bool], int] = {}
        self.held = 0
        self.body = 0
        self.stamps = 0                             # stamp launches, for node counts
        self.ring = None
        if self.cuda:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("profiling.enable inside a capture")
            self.ring = torch.zeros(((capacity + 1) * 2,), dtype=torch.int64,
                                    device=self.device)
            self.clock_out = torch.zeros((BRACKETS,), dtype=torch.int64, device=self.device)
        self.clear()

    def clear(self) -> None:
        self.host: list[list] = []       # [name, start, end, parent, frame, replays]
        self.open_host: list[int] = []
        self.open_sites: list[int] = []
        self.records: list[tuple] = []   # the CPU's records, and all it was handed
        self.head = 0
        self.ordinal = 0
        self.current = -1
        if self.cuda:
            self.ring.zero_()
            self.points = [self.calibrate()]

    def calibrate(self) -> tuple[int, int, int]:
        import ctypes

        from pose_estimation_tpu_torch.ops import kernels

        lib = kernels.library()
        stream = torch.cuda.current_stream(self.device)
        torch.cuda.synchronize(self.device)
        hosts = []
        for k in range(BRACKETS):
            before, after = ctypes.c_longlong(0), ctypes.c_longlong(0)
            kernels.check(lib.span_clock(stream.cuda_stream, self.clock_out[k:].data_ptr(),
                                         ctypes.byref(before), ctypes.byref(after)),
                          "span_clock")
            hosts.append((before.value, after.value))
        devs = self.clock_out.tolist()
        return fit_clock([(b, d, a) for (b, a), d in zip(hosts, devs)])

    def site(self, name: str) -> int:
        key = (name, self.open_sites[-1] if self.open_sites else -1, self.body > 0)
        site = self.site_of.get(key)
        if site is None:
            site = self.site_of[key] = len(self.sites)
            self.sites.append(key)
        return site

    def tag(self, ordinal: int) -> None:
        if self.open_host:
            self.host[self.open_host[-1]][5].append(ordinal)

    def stamp(self, code: int, fresh: bool, capturing: bool) -> None:
        if fresh and not capturing:
            self.current, self.ordinal = self.ordinal, self.ordinal + 1
            self.tag(self.current)
        self.stamps += 1
        if not self.cuda:
            self.head += 1
            if len(self.records) < self.capacity:
                self.records.append((code, self.current, clock_ns()))
            return
        from pose_estimation_tpu_torch.ops import kernels

        stream = torch.cuda.current_stream(self.device).cuda_stream
        kernels.check(kernels.library().span_stamp(stream, self.ring.data_ptr(), self.capacity,
                                                   code, int(fresh)), "span_stamp")


_rec: _Recorder | None = None
# every ring allocated: a graph captured with stamps writes its ring at each
# replay, so a ring outlives its recorder
_rings: list = []


class _Span:
    __slots__ = ("name", "host", "root", "frame", "capturing", "site", "index", "range")

    def __init__(self, name, host, root, frame):
        self.name, self.host, self.root, self.frame = name, host, root, frame

    def __enter__(self):
        rec = _rec
        stamping = not self.host and rec.held == 0
        self.capturing = rec.cuda and torch.cuda.is_current_stream_capturing()
        self.index = self.range = None
        if not self.capturing and (self.host or stamping):
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            parent = rec.open_host[-1] if rec.open_host else -1
            self.index = len(rec.host)
            rec.host.append([self.name, clock_ns(), None, parent, self.frame, []])
            rec.open_host.append(self.index)
        self.site = None
        if stamping:
            self.site = rec.site(self.name)
            rec.stamp(2 * self.site, self.root or not rec.open_sites, self.capturing)
            rec.open_sites.append(self.site)
        return self

    def __exit__(self, *exc):
        rec = _rec
        if self.site is not None:
            rec.open_sites.pop()
            rec.stamp(2 * self.site + 1, False, self.capturing)
        if self.index is not None:
            rec.host[self.index][2] = clock_ns()
            rec.open_host.pop()
            self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, host: bool = False, root: bool = False, frame: int | None = None):
    """The span `name` around a block (see the module's docstring): a host
    span where `host`, else a device span, `root` where the block is a
    graph's whole capture (its first stamp takes a new replay ordinal);
    `frame` is the frame id that the spans inside share. A shared no-op
    while tracing is off."""
    if _rec is None:
        return _OFF
    return _Span(name, host, root, frame)


def enable(device, capacity: int = CAPACITY) -> None:
    """Turn tracing on for `device`: a new recorder and, on a CUDA device,
    its ring (calibrated once here)."""
    global _rec
    _rec = _Recorder(device, capacity)
    if _rec.ring is not None:
        _rings.append(_rec.ring)


def disable() -> None:
    """Turn tracing off (a graph captured with stamps still writes its
    ring)."""
    global _rec
    _rec = None


def replayed() -> None:
    """A captured graph with stamps was replayed: its first stamp took the
    next ordinal, which the innermost open host span carries."""
    if _rec is not None:
        _rec.current, _rec.ordinal = _rec.ordinal, _rec.ordinal + 1
        _rec.tag(_rec.current)


def stamp_count() -> int:
    """The stamps launched or captured so far (0 with tracing off)."""
    return _rec.stamps if _rec is not None else 0


@contextlib.contextmanager
def _within(attr: str):
    rec = _rec
    if rec is None:
        yield
        return
    setattr(rec, attr, getattr(rec, attr) + 1)
    try:
        yield
    finally:
        setattr(rec, attr, getattr(rec, attr) - 1)


def body():
    """The block is captured as a conditional node's body
    (`graphs._conditional`): its device spans say so (`Span.body`)."""
    return _within("body")


def hold():
    """Inside the block device spans record nothing."""
    return _within("held")


def reset() -> None:
    """Clear the spans and the ring, and calibrate the clock anew. Not
    inside an open span."""
    if _rec is None:
        return
    if _rec.open_host or _rec.open_sites:
        raise RuntimeError("profiling.reset inside an open span")
    _rec.clear()


def read() -> Trace:
    """Every closed span since the last reset, on the host clock: the host
    spans first, each after its parent, then the device spans. A device
    span's frame is that of the host span that carries its replay ordinal,
    and a root device span's parent is that host span."""
    rec = _rec
    if rec is None:
        return Trace([], 0, 0)
    points = ()
    if rec.cuda:
        raw = rec.ring.cpu().numpy()
        head = int(raw[0])
        n = min(head, rec.capacity)
        recs = raw[2:2 + 2 * n].view(_RECORD)
        codes, ordinals = recs["code"], recs["ordinal"]
        points = (*rec.points, rec.calibrate())
        host_ns = to_host(recs["ns"], points)
    else:
        head, n = rec.head, len(rec.records)
        arr = np.array(rec.records, dtype=np.int64).reshape(-1, 3)
        codes, ordinals, host_ns = arr[:, 0], arr[:, 1], arr[:, 2]

    spans, index, carrier = [], {}, {}
    for i, (name, start, end, parent, frame, replays) in enumerate(rec.host):
        if end is None or (parent >= 0 and parent not in index):
            continue
        p = index.get(parent, -1)
        if frame is None and p >= 0:
            frame = spans[p].frame
        index[i] = len(spans)
        spans.append(Span(name, start, end, p, "host", frame, tuple(replays)))
        for o in replays:
            carrier[o] = index[i]
    pairs = pair_records(codes, ordinals)
    where = {}
    for k, (site, ordinal, b, e, parent) in enumerate(pairs):
        if e is None or (parent >= 0 and parent not in where):
            continue
        host = carrier.get(ordinal, -1)
        p = where[parent] if parent >= 0 else host
        where[k] = len(spans)
        name, _, in_body = rec.sites[site]
        spans.append(Span(name, int(host_ns[b]), int(host_ns[e]), p, "device",
                          spans[host].frame if host >= 0 else None, (ordinal,), in_body))
    return Trace(spans, head, head - n, points)


class StageTimers:
    """Accumulates wall-clock per named stage; waits for the device before
    stopping the clock where the stage's result lives there, so the
    numbers mean what they say."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None and _holds_cuda(result):
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.total[name] += dt
        self.count[name] += 1

    def add(self, name: str, seconds: float):
        self.total[name] += seconds
        self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            n = max(self.count[name], 1)
            lines.append(
                f"{name:30s} {self.total[name] / n * 1e3:9.3f} ms/call "
                f"x{self.count[name]}"
            )
        return "\n".join(lines)


def _holds_cuda(tree) -> bool:
    """Whether a tensor, or a (nested) tuple, list or dict of them, holds a
    CUDA tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_holds_cuda(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_holds_cuda(v) for v in tree)
    return False
