"""EuRoC replay CLI — the analog of the reference's euroc-state-estimation.

    python -m pose_estimation_tpu_torch.run_euroc --config config/euroc.yml \
        [--dataset-dir /path/to/mav0] [--max-frames N] [--out states.csv] [--ate]

The arguments and output of `pose_estimation_tpu/run_euroc.py`. The replay
runs on the GPU; `main(argv, device="cpu")` runs it on the CPU (the tests
do). The PNG frames are read without OpenCV (`io/png.py`).
"""

from __future__ import annotations

import argparse
import sys
import time

LIVE_VIEW_MISSING = ("--live-view needs the live viewer (live_viewer.py), which the port "
                     "does not have yet (ROADMAP queue A, the A9 leftovers)")


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset-dir", default=None,
                    help="mav0 directory (default: `dataset` key in config)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default="states.csv")
    ap.add_argument("--ate", action="store_true",
                    help="evaluate ATE RMSE against ground truth")
    ap.add_argument("--live-view", nargs="?", const=8642, type=int,
                    default=None, metavar="PORT",
                    help="not available in the port yet")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.live_view is not None:
        ap.error(LIVE_VIEW_MISSING)

    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch.io.euroc import EurocDataset, run_euroc
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM

    cfg = load_config(args.config, dataset="euroc")
    root = args.dataset_dir or cfg.dataset_path
    ds = EurocDataset(root)
    slam = VisualInertialSLAM(cfg, verbose=args.verbose, device=device)

    t0 = time.time()
    n = run_euroc(slam, ds, speed_up=cfg.speed_up, max_frames=args.max_frames)
    wall = time.time() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} FPS)")

    slam.save_results(args.out)
    print(f"wrote {args.out}")

    if args.ate:
        from pose_estimation_tpu_torch.io.ate import ate_rmse

        gt = ds.ground_truth()
        print(f"ATE RMSE: {ate_rmse(slam.trajectory, gt):.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
