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

LIVE_VIEW_HELP = ("serve the live raw-vs-optimized 3-D view on http://localhost:PORT "
                  "(also writes live_view.png; needs matplotlib)")


def check_live_view(ap, port) -> None:
    """Refuse --live-view without matplotlib: the viewer's render thread
    swallows every error, so it would serve a page with no image."""
    if port is None:
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        ap.error("--live-view renders with matplotlib, which cannot be imported here")


def start_live_view(slam, port, window_size):
    """A started LiveViewer attached to `slam` (None without --live-view)."""
    if port is None:
        return None
    from pose_estimation_tpu_torch.live_viewer import LiveViewer

    viewer = LiveViewer(port=port, window_size=window_size).start()
    slam.set_viewer(viewer)
    print(f"live view: http://localhost:{viewer.port}/")
    return viewer


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
                    help=LIVE_VIEW_HELP)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    check_live_view(ap, args.live_view)

    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch.io.euroc import EurocDataset, run_euroc
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM

    cfg = load_config(args.config, dataset="euroc")
    root = args.dataset_dir or cfg.dataset_path
    ds = EurocDataset(root)
    slam = VisualInertialSLAM(cfg, verbose=args.verbose, device=device)
    viewer = start_live_view(slam, args.live_view, cfg.window_size)

    t0 = time.time()
    n = run_euroc(slam, ds, speed_up=cfg.speed_up, max_frames=args.max_frames)
    wall = time.time() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} FPS)")
    if viewer is not None:
        viewer.stop()

    slam.save_results(args.out)
    print(f"wrote {args.out}")

    if args.ate:
        from pose_estimation_tpu_torch.io.ate import ate_rmse

        gt = ds.ground_truth()
        print(f"ATE RMSE: {ate_rmse(slam.trajectory, gt):.4f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
