"""The port's spans (`profiling.span`, `profiling.read`) on the CPU, where
the host clock stands in for the device's stamps; and on the card
(`cuda`-marked, skipped here) the stamps a captured graph replays.

- With tracing off a span is one shared no-op that records nothing, and
  the state machine's frames are bit-equal with tracing on and off.
- A frame's device spans: `graph.frame` over the stages in their order
  (`ok_step.extract`, `.imu`, `.match`, `.backend`, `.pool`), under the
  host spans `slam.replay` and `slam.process`, all of one frame id.
- In the conditional nodes' host form (`graphs.host_conditionals`) each
  LM iteration run is one `lm.<solve>` span: as many as the solve logs,
  on problems that converge early, hit their cap or fail their Cholesky
  factorization, and frame by frame in the state machine; an IF body's
  span (`cond.<site>`) only where its predicate holds; the batched step's
  fixed loop under `vmap` runs its cap.
- Every health check's frame has its `slam.wait`; the warm-up and a
  solve's eager first call record no device span; a full ring counts
  what it drops; the clock calibration recovers a known offset and rate;
  host spans lie on `torch.profiler`'s clock; stamps are no hand kernel
  (`graphs.kernel_counts`); `VisualInertialSLAM.counters`.

This file imports no JAX, so its card tests run on the machine with the
card: `python3 -m pytest --noconftest -m cuda tests/test_torch_tracing.py`.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch import graphs, profiling, testing  # noqa: E402
from pose_estimation_tpu_torch.backend import lm  # noqa: E402
from pose_estimation_tpu_torch.models import vio  # noqa: E402
from pose_estimation_tpu_torch.parallel import batched  # noqa: E402
from pose_estimation_tpu_torch.slam import SensorType, State, VisualInertialSLAM  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402

SMALL = dict(width=160, height=120, levels=2, features=150, camera_frequency=20, imu_chunk=16,
             max_num_iterations=6, keyframe_translation=0.03, keyframe_rotation=1.0)
N_FRAMES = 6
STAGES = ["ok_step.extract", "ok_step.imu", "ok_step.match", "ok_step.backend", "ok_step.pool"]


@pytest.fixture(autouse=True)
def _clean():
    """One intra-op thread; tracing and the iteration log off after each
    test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    profiling.disable()
    graphs.iteration_log = None


def _world():
    cfg = testing.synthetic_config(**SMALL)
    return (cfg, *testing.sim_frames(cfg, N_FRAMES + 1, n_landmarks=200))


def _ok_slam(cfg, truth, **kwargs):
    slam = VisualInertialSLAM(cfg, device="cpu", **kwargs)
    slam.state, slam.vio = State.OK, testing.seeded_state(slam.static, truth, "cpu")
    return slam


def _feed(slam, cfg, frames, gyrs, accs, mask, i, blank=False):
    """Frame i's IMU samples, then its images (zeros where `blank`)."""
    dt_ns = 1_000_000_000 // cfg.sampling_rate
    n = int(mask.sum())
    img_ts = (i + 1) * 10 * n * dt_ns
    for k in range(n):
        ts = img_ts - (n - k) * dt_ns
        slam.collect_imu_data(SensorType.GYROSCOPE, ts, *map(float, gyrs[i][k]))
        slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *map(float, accs[i][k]))
    left, right = frames[i]
    if blank:
        left, right = np.zeros_like(left), np.zeros_like(right)
    return slam.process(left, right, img_ts)


def _run_frames(traced, conditional=False, blank=(), **kwargs):
    """N_FRAMES OK frames of the state machine, tracing on where `traced`,
    the conditionals in host form where `conditional`: (slam, the read
    spans, the logged iterations)."""
    cfg, frames, gyrs, accs, mask, truth = _world()
    slam = _ok_slam(cfg, truth, **kwargs)
    if traced:
        profiling.enable("cpu")
    graphs.iteration_log = []
    ctx = graphs.host_conditionals() if conditional else contextlib.nullcontext()
    with ctx:
        for i in range(N_FRAMES):
            assert _feed(slam, cfg, frames, gyrs, accs, mask, i, blank=i in blank)
    logged = graphs.read_iterations(graphs.iteration_log)
    return slam, profiling.read(), logged


def _children(trace, parent):
    return [s for s in trace.spans if s.parent == parent]


def _by_frame(trace, name):
    counts = {}
    for s in trace.named(name):
        counts[s.frame] = counts.get(s.frame, 0) + 1
    return counts


def test_off_records_nothing_and_frames_equal_traced():
    assert profiling.span("x") is profiling.span("y", host=True)
    with profiling.span("ok_step.imu"):
        pass
    assert profiling.read() == profiling.Trace([], 0, 0)
    off, none, _ = _run_frames(traced=False)
    assert none.spans == []
    on, trace, _ = _run_frames(traced=True)
    assert trace.records > 0
    for a, b in zip(tree_leaves(off.vio), tree_leaves(on.vio), strict=True):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(off.trajectory, on.trajectory)


def test_stage_spans_nest_in_order_under_the_frame():
    _, trace, _ = _run_frames(traced=True)
    frames = trace.named("graph.frame")
    assert [s.frame for s in frames] == list(range(N_FRAMES))
    for frame in frames:
        carrier = trace.spans[frame.parent]
        replay = trace.spans[carrier.parent]
        root = trace.spans[replay.parent]
        assert (carrier.name, replay.name, root.name) == ("graph.frame", "slam.replay",
                                                          "slam.process")
        assert carrier.replays == frame.replays and root.frame == frame.frame
        stages = _children(trace, trace.spans.index(frame))
        names = [s.name for s in stages]
        assert [n for k, n in enumerate(names) if k == 0 or names[k - 1] != n] == STAGES
        assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
        assert frame.start <= stages[0].start and stages[-1].end <= frame.end
        assert all(s.frame == frame.frame and s.replays == frame.replays for s in stages)


def _normal_problem(case):
    """A small LM problem in normal form from a seed: one that converges
    early, one that reaches a cap of 3, one whose negated normal matrix no
    Cholesky factorization takes until the damping outgrows it."""
    rng = np.random.default_rng(["early", "cap", "cholesky"].index(case))
    a = torch.from_numpy(rng.normal(size=(30, 6)))
    b = torch.from_numpy(rng.normal(size=30) * 3.0)
    sign = -1.0 if case == "cholesky" else 1.0

    def normal_fn(x):
        r = a @ x - b + 0.3 * torch.sin(x).sum()
        w = torch.where(r.abs() <= 1.0, 1.0, 1.0 / r.abs()) * sign
        jtw = a.T * w[None, :]
        return jtw @ a, jtw @ r, 0.5 * (w * r * r).sum()

    return normal_fn, torch.zeros(6, dtype=torch.float64), {"cap": 3}.get(case, 50)


@pytest.mark.parametrize("case", ["early", "cap", "cholesky"])
def test_lm_iteration_spans_equal_the_logged_count(case):
    normal_fn, x0, cap = _normal_problem(case)
    profiling.enable("cpu")
    graphs.iteration_log = []
    with graphs.host_conditionals(), profiling.span("solve"):
        _, info = lm.lm_solve_normal(normal_fn, x0, lm.LMOptions(max_iterations=cap), name="ba")
    ((name, it, _),) = graphs.read_iterations(graphs.iteration_log)
    trace = profiling.read()
    iterations = trace.named("lm.ba")
    assert name == "ba" and len(iterations) == it == int(info["iterations"])
    assert {trace.spans[s.parent].name for s in iterations} == {"solve"}
    if case == "early":
        assert it < cap
    if case == "cap":
        assert it == cap
    if case == "cholesky":
        assert int(info["accepted_steps"]) < it


def test_frame_lm_and_branch_spans_follow_the_conditionals():
    """Frame by frame in the conditionals' host form, a blank pair among
    them: `lm.ba` spans as many as the frame's logged `ba` count, and the
    BA's branch span exactly on the frames that ran it (matches found)."""
    _, trace, logged = _run_frames(traced=True, conditional=True, blank=(3,))
    counts = [n for name, n, _ in logged if name == "ba"]
    assert len(counts) == N_FRAMES and counts[3] == 0 and max(counts) > 0
    per_frame = _by_frame(trace, "lm.ba")
    assert [per_frame.get(f, 0) for f in range(N_FRAMES)] == counts
    branch = _by_frame(trace, "cond.ba")
    assert [branch.get(f, 0) for f in range(N_FRAMES)] == [int(n > 0) for n in counts]


def test_if_body_spans_only_where_the_predicate_holds():
    profiling.enable("cpu")
    preds = [True, False, True, True, False]
    x = torch.zeros(3)
    with graphs.host_conditionals():
        for p in preds:
            with profiling.span("step"):
                graphs.cond(torch.tensor(p), lambda: x + 1.0, x, name="site")
    trace = profiling.read()
    steps = trace.named("step")
    taken = {s.replays for s in trace.named("cond.site")}
    assert [s.replays in taken for s in steps] == preds
    # the select (eagerly, without the host form) computes every branch
    profiling.reset()
    for p in preds:
        graphs.cond(torch.tensor(p), lambda: x + 1.0, x, name="site")
    assert len(profiling.read().named("cond.site")) == len(preds)


def test_every_health_check_frame_has_its_wait():
    slam, trace, _ = _run_frames(traced=True, reinit_check_every=2)
    checks = trace.named("slam.health", "host")
    assert [s.frame for s in checks] == [1, 3, 5]
    for check in checks:
        waits = [s for s in _children(trace, trace.spans.index(check)) if s.name == "slam.wait"]
        assert len(waits) >= 1 and all(w.frame == check.frame for w in waits)
    assert slam.counters()["frames"] == N_FRAMES


def test_batched_fixed_loop_runs_its_cap():
    """The batched step under `vmap` keeps the fixed loop and the select:
    every step runs the BA's cap of iterations and its branch."""
    cfg, frames, gyrs, accs, mask, truth = _world()
    slam = _ok_slam(cfg, truth)
    state = batched.stack_states([slam.vio, testing.seeded_state(slam.static, truth, "cpu",
                                                                 j=1)])
    runner = graphs.BatchedGraphs(state, slam.consts, slam.static, "cpu")
    profiling.enable("cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        u = torch.stack([torch.stack(vio.draw_ransac_uniforms(gen, "cpu")) for _ in range(2)])
        pair = [torch.from_numpy(np.stack([frames[i][k]] * 2)) for k in (0, 1)]
        imu = [torch.from_numpy(np.stack([a[i]] * 2)) for a in (gyrs, accs)]
        runner.step(*pair, *imu, torch.from_numpy(np.stack([mask] * 2)), u)
    trace = profiling.read()
    per_step = {}
    for s in trace.named("lm.ba"):
        per_step[s.replays] = per_step.get(s.replays, 0) + 1
    assert list(per_step.values()) == [slam.static.max_iterations] * 2
    assert len(trace.named("cond.ba")) == 2 and len(trace.named("graph.batch")) == 2


def test_warm_up_and_first_solve_record_no_device_span():
    profiling.enable("cpu")
    normal_fn, x0, cap = _normal_problem("early")
    solves = graphs.SolveGraphs(None, None, "cpu")

    def fn(x):
        return lm.lm_solve_normal(normal_fn, x, lm.LMOptions(max_iterations=cap),
                                  name="tilt")[0]

    with profiling.hold():
        fn(x0)
    solves.run("refine", fn, x0)
    assert profiling.read().named("lm.tilt") == []
    solves.run("refine", fn, x0)
    trace = profiling.read()
    (replay,) = trace.named("graph.refine")
    assert len(trace.named("lm.tilt")) == cap
    assert all(s.replays == replay.replays for s in trace.named("lm.tilt"))


def test_a_full_ring_counts_what_it_drops():
    profiling.enable("cpu", capacity=10)
    for _ in range(8):
        with profiling.span("a"):
            pass
    trace = profiling.read()
    assert (trace.records, trace.dropped) == (16, 6)
    assert len(trace.named("a")) == 5
    profiling.reset()
    assert profiling.read() == profiling.Trace([], 0, 0)
    with profiling.span("outer", host=True), pytest.raises(RuntimeError, match="open span"):
        profiling.reset()


def test_clock_calibration_recovers_offset_and_rate():
    """Brackets around device timer reads of a known offset: the tightest
    bracket's middle is within its half width; two points a second apart
    recover a rate off by 20 ppm."""
    rng = np.random.default_rng(0)
    offset, rate = 1_700_000_000_123_456_789, 1.0 + 20e-6

    def brackets(at):
        out = []
        for _ in range(8):
            lead, lag = rng.integers(2_000, 30_000, size=2)
            dev = int(round((at - offset) * rate))
            out.append((at - int(lead), dev, at + int(lag)))
            at += 100_000
        return out

    first = brackets(offset + 5_000_000)
    last = brackets(offset + 1_005_000_000)
    points = [profiling.fit_clock(first), profiling.fit_clock(last)]
    for (host, dev, half), bs in zip(points, (first, last)):
        assert half == min((b[2] - b[0]) // 2 for b in bs)
        assert abs(host - (offset + dev / rate)) <= half
    mid = int(round((offset + 505_000_000 - offset) * rate))
    got = int(profiling.to_host([mid], points)[0])
    assert abs(got - (offset + 505_000_000)) <= max(p[2] for p in points)


def test_host_spans_lie_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    profiling.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("slam.process", host=True, frame=0):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (mine,) = profiling.read().named("slam.process", "host")
    base = prof.profiler.kineto_results.trace_start_ns()
    (event,) = [e for e in prof.events() if e.name == "slam.process"]
    start = base + int(event.time_range.start * 1e3)
    end = base + int(event.time_range.end * 1e3)
    assert abs(start - mine.start) < 1_000_000 and abs(end - mine.end) < 1_000_000


def test_stamps_are_no_hand_kernel_and_counters_count():
    before = graphs.kernel_counts()
    slam, trace, _ = _run_frames(traced=True)
    assert graphs.kernel_counts() == before
    assert "span_stamp" not in before
    assert trace.records == profiling.stamp_count() > 0
    counters = slam.counters()
    assert counters["frames"] == N_FRAMES and counters["replays"] == {"frame": N_FRAMES}
    assert counters["captures"] == 0 and counters["solve_calls"] == {}
    # a solve's first call of a shape runs eagerly, its later ones replay
    for n in (3, 3, 4):
        slam._solve("refine", lambda x: x * 2.0, torch.zeros(n))
    counters = slam.counters()
    assert counters["solve_calls"] == {"refine": 3}
    assert counters["replays"] == {"frame": N_FRAMES, "refine": 1}


# ---- on the card (skipped without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span stamp is a CUDA kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_while_stamps_its_iterations_on_gpu(gpu):
    """A captured LM solve (one WHILE node): each replay's `lm.ba` spans as
    many as the iterations it logged, under the replay's `graph.solve`;
    the stamps counted apart from the body's nodes."""
    profiling.enable(gpu)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(30, 6))).to(gpu)
    b = torch.from_numpy(rng.normal(size=30) * 3.0).to(gpu)

    def normal(y):
        r = a @ y - b + 0.3 * torch.sin(y).sum()
        return a.T @ a, a.T @ r, 0.5 * (r * r).sum()

    def fn(x):
        return lm.lm_solve_normal(normal, x, lm.LMOptions(max_iterations=50), name="ba")[0]

    static = (torch.zeros(6, dtype=torch.float64, device=gpu),)
    graphs.warm_up(fn, static, gpu)
    step = graphs.CapturedStep("solve", fn, static, gpu, torch.cuda.graph_pool_handle())
    graphs.iteration_log = []
    for _ in range(3):
        step()
    logged = [n for _, n, _ in graphs.read_iterations(graphs.iteration_log)]
    trace = profiling.read()
    replays = trace.named("graph.solve")
    assert len(replays) == 3
    for replay, n in zip(replays, logged):
        its = [s for s in trace.named("lm.ba") if s.replays == replay.replays]
        assert len(its) == n > 0
        assert all(replay.start <= s.start <= s.end <= replay.end for s in its)
    assert step.stats["stamp_nodes"] == 4
    assert trace.dropped == 0


@pytest.mark.cuda
def test_stamp_lies_in_the_profilers_kernel_interval_on_gpu(gpu):
    from torch.profiler import ProfilerActivity, profile

    profiling.enable(gpu)
    x = torch.ones(256, 256, device=gpu)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with profiling.span("probe"):
                x = x @ x * 1e-3
        torch.cuda.synchronize()
    spans = profiling.read().named("probe")
    base = prof.profiler.kineto_results.trace_start_ns()
    stamps = sorted((base + int(e.time_range.start * 1e3), base + int(e.time_range.end * 1e3))
                    for e in prof.events()
                    if e.device_type.name == "CUDA" and "span_stamp" in e.name)
    assert len(stamps) == 2 * len(spans) == 10
    ends = sorted([s.start for s in spans] + [s.end for s in spans])
    off = [max(a - t, t - b, 0) for t, (a, b) in zip(ends, stamps)]
    assert max(off) <= 5_000, (off, [b - a for a, b in stamps],
                               [t - a for t, (a, _) in zip(ends, stamps)])
