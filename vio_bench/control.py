#!/usr/bin/env python3
"""The comparison's two readings for a cell, over many seeds in one process.

    python3 vio_bench/control.py --workload <cell> --seeds 1-12 --seconds 6 [--out FILE]
        [--bench BENCHMARK.json]

For each seed: the cell's set-up and a short window at its own load
(the run's own drivers), then over the window's sample (as many frames as
a run compares) the numbers of `check.py` twice: the program against the
plain reference (the lower reading of each limit), and the control, the
reference with TF32 on for its matmuls and convolutions in the program's
place, against the same reference (the upper reading). The configuration
states float32 with TF32 off, so TF32 is the nearest precision below it.
One JSON line a seed (and all of them to `--out`). The benchmark's own
runs do not run it; `test_bench_control.py` keeps it at the rehearsal's
size.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the configuration's and traffic's tiny rehearsal sizes")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: cuda; cpu with --rehearse)")
    ap.add_argument("--bench", default=None, help="another BENCHMARK.json")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from vio_bench import run as bench

    bench._set_cache_dirs()
    import torch

    from vio_bench import batch, check, spec, stream

    cell = spec.load_cell(args.workload, rehearse=args.rehearse, bench_path=args.bench)
    device = args.device or ("cpu" if args.rehearse else "cuda")
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("error: no CUDA device", file=sys.stderr)
            return 3
        device = "cuda:0"
        from pose_estimation_tpu_torch.ops import kernels

        kernels.build()
    torch.set_num_threads(4)
    cfg = spec.program_config(cell, args.rehearse)
    overrides = spec.reference_overrides(cell, args.rehearse)
    drivers = {"stream": stream.run, "batch": batch.run}
    lines = []
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="vio_bench_") as scratch:
            ctx = bench.Context(cell, cfg, seed, args.seconds, False, device, scratch)
            rec = drivers[cell.traffic["kind"]](ctx)
        reference = check.Reference(cell.yaml, cell.config["dataset"], overrides, device)
        program = check.gaps(reference, rec.samples, rec.world, rec.program_pose)
        ref_poses = {id(s): reference.run(s, rec.world) for s in rec.samples}
        control = check.gaps(reference, rec.samples, rec.world,
                             lambda s, k: ref_poses[id(s)][k], tf32=True)
        line = {"workload": args.workload, "seed": seed, "program": program, "control": control,
                "window_frames": rec.frames, "failed": rec.failed,
                "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
        del rec, reference, ref_poses
        ctx.free()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
