"""Per-stage wall-clock timing and device traces.

Counterpart of `pose_estimation_tpu/profiling.py`: `StageTimers` keeps a
registry of named stages and waits for the device where the result it is
given holds CUDA tensors (PyTorch returns before the GPU finishes, as JAX
does before `block_until_ready`); `device_trace` records a
`torch.profiler` trace of host and device activity and writes it as a
Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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


@contextlib.contextmanager
def device_trace(logdir: str):
    """A `torch.profiler` trace of the block (the CPU, and the GPU where
    there is one), written to `logdir/trace.json` as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
