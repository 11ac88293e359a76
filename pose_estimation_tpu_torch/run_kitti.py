"""KITTI replay CLI — analog of the reference's kitti-state-estimation.

    python -m pose_estimation_tpu_torch.run_kitti --config config/kitti.yml \
        [--dataset-dir DIR] [--max-num-imu N] [--max-num-image N] [--out states.csv]

The arguments and output of `pose_estimation_tpu/run_kitti.py`. The replay
runs on the GPU; `main(argv, device="cpu")` runs it on the CPU (the tests
do). The PNG frames are read without OpenCV (`io/png.py`).
"""

from __future__ import annotations

import argparse
import sys
import time

from pose_estimation_tpu_torch.run_euroc import LIVE_VIEW_HELP, check_live_view, start_live_view


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset-dir", default=None)
    ap.add_argument("--max-num-imu", type=int, default=None)
    ap.add_argument("--max-num-image", type=int, default=None)
    ap.add_argument("--out", default="states.csv")
    ap.add_argument("--live-view", nargs="?", const=8642, type=int,
                    default=None, metavar="PORT",
                    help=LIVE_VIEW_HELP)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    check_live_view(ap, args.live_view)

    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch.io.kitti import KittiDataset, run_kitti
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM
    from pose_estimation_tpu_torch.utils.config import _parse_opencv_yaml

    cfg = load_config(args.config, dataset="kitti")
    raw = _parse_opencv_yaml(args.config)
    max_imu = args.max_num_imu or int(raw.get("maxNumImu", 10**9))
    max_img = args.max_num_image or int(raw.get("maxNumImage", 10**9))
    rate = cfg.sampling_rate // cfg.camera_frequency

    ds = KittiDataset(args.dataset_dir or cfg.dataset_path)
    slam = VisualInertialSLAM(cfg, verbose=args.verbose, device=device)
    viewer = start_live_view(slam, args.live_view, cfg.window_size)

    t0 = time.time()
    n = run_kitti(slam, ds, max_imu, max_img, rate)
    wall = time.time() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} FPS)")
    if viewer is not None:
        viewer.stop()
    slam.save_results(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
