"""The readers of the program's own spans (`vio_bench/stamps.py` and the
six metrics that use it) on synthetic spans: two replays of the frame
graph with their stages, LM iterations and an IF body, two frames of the
host state machine with their waits, and a profiler stretch whose device
intervals leave the bodies out. A run without the program's spans (the
harness and program of an earlier commit) reads nothing."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pose_estimation_tpu_torch.profiling import Span, Trace  # noqa: E402
from vio_bench import spec  # noqa: E402

NEW = ("frame_device_ms", "frontend_device_ms", "backend_device_ms", "lm_iter_device_ms",
       "host_wait_ms_per_frame", "device_idle_share_stamped")
MS = 1_000_000


def _spans():
    """Frame f (0, 1) starts at 100 f ms: `slam.process` over 0-30 ms of
    it, a `slam.wait` of 2 ms (frame 0) and 4 ms (frame 1); the frame
    graph over 10-30 ms: extract 10-14, imu 14-15, match 15-17, backend
    17-27 (an IF body 18-26 holding 2 + f LM iterations of 2 ms), pool
    27-29."""
    spans = []

    def add(name, a, b, parent, kind, frame, replay, body=False):
        spans.append(Span(name, a, b, parent, kind, frame, replay, body))
        return len(spans) - 1

    for f in (0, 1):
        t = 100 * MS * f
        root = add("slam.process", t, t + 30 * MS, -1, "host", f, ())
        add("slam.wait", t + 2 * MS, t + (4 + 2 * f) * MS, root, "host", f, ())
        carrier = add("slam.replay", t + 5 * MS, t + 9 * MS, root, "host", f, (f,))
        g = add("graph.frame", t + 10 * MS, t + 30 * MS, carrier, "device", f, (f,))
        add("ok_step.extract", t + 10 * MS, t + 14 * MS, g, "device", f, (f,))
        add("ok_step.imu", t + 14 * MS, t + 15 * MS, g, "device", f, (f,))
        add("ok_step.match", t + 15 * MS, t + 17 * MS, g, "device", f, (f,))
        back = add("ok_step.backend", t + 17 * MS, t + 27 * MS, g, "device", f, (f,))
        cond = add("cond.ba", t + 18 * MS, t + 26 * MS, back, "device", f, (f,), True)
        for k in range(2 + f):
            a = t + (18 + 2 * k) * MS
            add("lm.ba", a, a + 2 * MS, cond, "device", f, (f,), True)
        add("ok_step.pool", t + 27 * MS, t + 29 * MS, g, "device", f, (f,))
    return Trace(spans, 100, 0)


def _run(program=True, timeline=True):
    trace = SimpleNamespace(window_s=0.2, busy_s=0.0, kernel_ms={}, device_ops=[],
                            idle_gaps=[])
    if timeline:
        # frame 0's stretch: the profiler saw 10-18 and 26-30 ms (not the body)
        trace.stretch_ns = (0, 40 * MS)
        trace.device_ns = [(10 * MS, 18 * MS), (26 * MS, 30 * MS)]
    record = SimpleNamespace(trace=trace)
    if program:
        record.program_trace = _spans()
    return SimpleNamespace(record=record, cfg=None, traffic={})


def _read(name, run):
    return spec.reader(name)(run)


def test_readers_of_the_program_spans():
    run = _run()
    assert _read("frame_device_ms", run) == pytest.approx(20.0)
    assert _read("frontend_device_ms", run) == pytest.approx(6.0)
    assert _read("backend_device_ms", run) == pytest.approx(10.0)
    assert _read("lm_iter_device_ms", run) == pytest.approx(2.0)
    assert _read("host_wait_ms_per_frame", run) == pytest.approx(3.0)
    # busy: 10-30 ms (the profiler's 10-18 and 26-30 with the body 18-26)
    assert _read("device_idle_share_stamped", run) == pytest.approx(50.0)


def test_idle_share_stamped_equals_the_profilers_without_bodies():
    run = _run()
    run.record.program_trace = Trace([s._replace(body=False) for s in _spans().spans], 100, 0)
    assert _read("device_idle_share_stamped", run) == pytest.approx(70.0)


@pytest.mark.parametrize("program,timeline", [(False, True), (False, False), (True, False)])
def test_a_run_without_the_program_spans_reads_nothing(program, timeline):
    run = _run(program, timeline)
    values = {name: _read(name, run) for name in NEW}
    if program:
        assert values.pop("device_idle_share_stamped") is None
        assert all(v is not None for v in values.values())
    else:
        assert all(v is None for v in values.values())
