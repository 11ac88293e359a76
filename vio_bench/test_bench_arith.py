"""The benchmark's arithmetic: percentiles, rates and spreads against
numpy and `statistics`; the copies of `chip_smoke.py`'s busy time, bound
and K1/K3 counts against the originals; the counts' shapes against the
program's own plane stack."""

import statistics
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from vio_bench import arith  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_is_numpys(n):
    xs = np.random.default_rng(n).exponential(20.0, n)
    for q in (0, 50, 95, 99, 100):
        assert arith.percentile(list(xs), q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def test_rate_and_spread():
    assert arith.rate(500, 20.0) == 25.0
    with pytest.raises(ValueError):
        arith.rate(1, 0.0)
    xs = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert arith.union_length(iv) == 5.0
    assert arith.merged(iv) == [[0, 3], [5, 6], [8, 9]]
    assert arith.union_length([]) == 0.0


def _event(start, end, name="k", device="CUDA", annotation=False):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=types.SimpleNamespace(name=device), is_user_annotation=annotation,
        device_time=end - start)


def test_busy_time_is_chip_smokes():
    events = [_event(0, 10), _event(5, 12), _event(20, 25, "memcpy"), _event(0, 30, "a", "CUDA", True),
              _event(0, 40, "cpu_op", "CPU")]
    prof = types.SimpleNamespace(events=lambda: events)
    work = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type.name == "CUDA" and not e.is_user_annotation]
    assert arith.union_length(work) / 1e3 == chip_smoke.device_activity(prof)["busy_ms"]


def test_bound_is_chip_smokes():
    assert arith.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert arith.FP32_INSTR_PER_S == chip_smoke.FP32_INSTR_PER_S
    assert arith.FAST_OPS_PER_PX == chip_smoke.FAST_OPS_PER_PX
    for b, i in ((1e9, 1e6), (1e3, 1e12), (0, 0)):
        assert arith.bound_ms(b, i) == chip_smoke.bound(b, i)


@pytest.mark.parametrize("images,h,w,levels", [(2, 480, 752, 8), (128, 480, 752, 8),
                                                (2, 120, 160, 3)])
def test_k1_counts_follow_the_programs_stack(images, h, w, levels):
    """chip_smoke's K1 count (content bytes read, four [planes, cells]
    outputs written) over the program's own plane stack and K1 plan."""
    from pose_estimation_tpu_torch.ops import fast, orb

    cfg = orb.OrbConfig(n_levels=levels, scale=1.2)
    shapes = orb.pyramid_shapes(h, w, cfg)
    bounds = [shapes[p // images] for p in range(levels * images)]
    content = sum(lh * lw for lh, lw in bounds)
    ncr = -(-h // fast.BAND) * fast.BAND // fast.CELL
    cells = ncr * (w // fast.CELL) * 4
    out_bytes = 4 * (levels * images) * cells * 4
    want = (content * 4 + out_bytes, content * (chip_smoke.FAST_OPS_PER_PX + 8))
    assert arith.k1_counts(images, h, w, levels, 1.2) == want


def test_k3_counts_are_chip_smokes():
    from pose_estimation_tpu_torch.ops import orb

    cfg = orb.OrbConfig(n_levels=3, scale=1.2)
    h, w = 64, 200
    imgs = torch.zeros((2, h, w))
    oc = orb.build_orb_constants(h, w, cfg, "cpu")
    stack, _ = orb.plane_stack(imgs, cfg, oc)
    want = (stack.numel() * 12, stack.numel() * chip_smoke.FAST_OPS_PER_PX)
    assert arith.k3_counts(2, h, w, 3) == want


def test_trace_reading():
    """The traced stretch's reading from a profiler's events: the busy time
    clipped to the stretch, the gaps named by the span covering them, the
    kernels' times by name; the annotations on the device's timeline left
    out; and the stretch and its device intervals in ns on the clock of the
    program's spans (the profiler's start, 1,000 ns here, plus its us)."""
    from vio_bench import trace

    ev = [_event(0, 100, trace.STRETCH, "CPU"), _event(0, 30, "process", "CPU"),
          _event(30, 35, "sync", "CPU"), _event(35, 60, "imu_feed", "CPU"),
          _event(60, 100, "process", "CPU"),
          _event(-5, 10, "fast_select_kernel"), _event(12, 20, "gemm"), _event(15, 25, "gemm"),
          _event(70, 74, "fast_select_kernel"), _event(90, 130, "copy"),
          _event(0, 100, "process", "CUDA", True)]
    tr = trace.Tracer(True, lambda: None)
    tr.prof = types.SimpleNamespace(events=lambda: ev, profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(trace_start_ns=lambda: 1000)))
    got = tr.read()
    assert got.window_s == 100 / 1e6
    assert got.busy_s == (10 + 13 + 4 + 10) / 1e6
    assert got.mean_kernel_ms("fast_select_kernel") == (15 + 4) / 2 / 1e3
    assert got.mean_kernel_ms("nothing") is None
    # gaps: [25, 70) mostly in imu_feed, [74, 90) in process, [10, 12) in process
    assert got.idle_gaps[0] == ["imu_feed", 45 / 1e6]
    assert got.idle_gaps[1] == ["process", 16 / 1e6]
    assert [n for n, _ in got.device_ops][0] == "copy"
    assert got.stretch_ns == (1000, 101000)
    assert got.device_ns == [(1000, 11000), (13000, 21000), (16000, 26000), (71000, 75000),
                             (91000, 101000)]
