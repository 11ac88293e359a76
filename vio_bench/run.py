#!/usr/bin/env python3
"""The benchmark of `pose_estimation_tpu_torch` on one NVIDIA GPU.

    python3 vio_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` once: makes the cell's world from the
seed (`world.py`), sets up the system under the cell's traffic
(`stream.py`, `batch.py`), measures for `--seconds`, then holds the poses
that the window produced to the plain reference (`check.py`, `ref/`) and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer ones, each read by `metrics/<name>.py`), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside
its limit (also the last lines on standard error). A `--trace 1` run also
turns the program's own spans on (`profiling.enable`) before the system
is built; the drivers keep what they recorded in the window.

Without a CUDA device it exits non-zero and prints no result. `--rehearse`
runs the cell end to end on the CPU at the tiny size of the configuration's
and traffic's `rehearsal` entries, the kernels' plain twins in the
kernels' place, for the tests; it prints no device metric.

The kernels build into `pose_estimation_tpu_torch/build/` in the checkout
(keyed by their sources' digest), so only a checkout's first run builds
them; any PyTorch extension or Triton cache goes to `.vio_bench_cache/`
in the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pose_estimation_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: the port's own name begins with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _set_cache_dirs() -> None:
    cache = ROOT / ".vio_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


class Context:
    """What a traffic driver is handed: the cell's configuration and
    traffic, the seeds, the device and its barrier, and the run's clock.

    The sequence (its landmarks, IMU noise and the system's RANSAC draws)
    comes from the configuration's `world.seed`, so every run of a cell
    replays the same sequence and does the same work, as a recorded dataset
    does; `--seed` draws the window frames that the comparison checks."""

    def __init__(self, cell, cfg, seed, seconds, trace, device, scratch):
        import torch

        self.cell, self.cfg, self.traffic = cell, cfg, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.world_seed = int(cell.config["world"]["seed"])
        self.device = torch.device(device)
        self.scratch = scratch
        self.setup_done = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def world(self, n_frames: int):
        from vio_bench.world import Rig, World

        c, w = self.cfg, self.cell.config["world"]
        if w["trajectory"] != "B":
            raise ValueError(f"trajectory family {w['trajectory']!r}: the generator has B")
        rig = Rig(c.image_width, c.image_height, c.k_left, c.r_cb, c.t_lr)
        return World(rig, c.profile.gravity_dir, c.sampling_rate, c.camera_frequency,
                     c.imu_chunk, n_frames, self.world_seed, w["landmarks_per_m"], w["imu_noise"],
                     self.device)

    def sample_rng(self):
        """The generator of the frames the comparison checks, from `--seed`."""
        import numpy as np

        return np.random.default_rng([self.seed % 2**63, 2])

    def mark_setup_done(self) -> None:
        self.sync()
        self.setup_done = time.perf_counter()

    def memory_peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def scratch_file(self, name: str) -> Path:
        return Path(self.scratch) / name


class RunView:
    """What a metric reader reads: the run's record, the configuration and
    the traffic."""

    def __init__(self, record, cfg, traffic):
        self.record, self.cfg, self.traffic = record, cfg, traffic


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at the tiny rehearsal size (tests only)")
    ap.add_argument("--bench", default=None, help="another BENCHMARK.json (tests only)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _set_cache_dirs()
    import torch

    from vio_bench import batch, check, spec, stream

    cell = spec.load_cell(args.workload, rehearse=args.rehearse, bench_path=args.bench)
    if args.rehearse:
        device = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"error: {args.workload} needs {cell.chips} CUDA device(s); found {n}",
                  file=sys.stderr)
            return 3
        device = "cuda:0"
    torch.set_num_threads(4)
    if device != "cpu":
        from pose_estimation_tpu_torch.ops import kernels

        kernels.build()
    cfg = spec.program_config(cell, args.rehearse)
    overrides = spec.reference_overrides(cell, args.rehearse)
    drivers = {"stream": stream.run, "batch": batch.run}
    if args.trace:
        from pose_estimation_tpu_torch import profiling

        profiling.enable(device)
    try:
        with tempfile.TemporaryDirectory(prefix="vio_bench_") as scratch:
            ctx = Context(cell, cfg, args.seed, args.seconds, bool(args.trace), device, scratch)
            rec = drivers[cell.traffic["kind"]](ctx)
    finally:
        if args.trace:
            profiling.disable()
    rec.setup_s = ctx.setup_done - T_START

    # the comparison, after the window, with the program freed
    t_ref = time.perf_counter()
    reference = check.Reference(cell.yaml, cell.config["dataset"], overrides, device)
    found = check.gaps(reference, rec.samples, rec.world, rec.program_pose)
    t_ref = time.perf_counter() - t_ref
    correct, checks = check.verdict(found, cell.limits)

    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4

    view = RunView(rec, cfg, cell.traffic)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec.reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.rehearse:
        device_info = {"platform": "cpu", "kind": "rehearsal", "count": 0, "memory_peak_bytes": 0}
        metrics = {}
    else:
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    line = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": device_info}
    if args.trace and rec.trace is not None and not args.rehearse:
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": rec.trace.device_ops,
                             "idle_gaps": rec.trace.idle_gaps}
    line["checks"] = checks
    print(f"window: {rec.frames} frames in {rec.window_s:.3f} s; set-up {rec.setup_s:.3f} s "
          f"({rec.setup_frames} set-up frames); {rec.eager_in_window} eager solve(s) in the "
          f"window; {found['frames']} lane-frames compared in {t_ref:.1f} s "
          f"({found['keyframes']} keyframes)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
