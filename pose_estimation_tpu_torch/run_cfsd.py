"""CFSD entry — replay of `cluonRecordingsToLocal` outputs, optionally with
LIVE IMU over an OD4 session (the reference's car mode,
`cfsd-state-estimation.cpp:50-95`: cluon dataTrigger callbacks feeding
`collectImuData` while frames arrive on the main loop).

The arguments and output of `pose_estimation_tpu/run_cfsd.py`. The replay
runs on the GPU; `main(argv, device="cpu")` runs it on the CPU. The
recordings' frames are JPEGs, which OpenCV reads: the port's own image
reader takes 8-bit grayscale PNGs only.
"""

from __future__ import annotations

import argparse
import sys
import time

from pose_estimation_tpu_torch.run_euroc import LIVE_VIEW_HELP, check_live_view, start_live_view


def _live_camera_loop(slam, cfg, args):
    """The reference's car loop (`cfsd-state-estimation.cpp:104-132`):
    wait on the shared condition, lock+copy the side-by-side frame, split
    L/R, resize to the configured size, feed `process`. Ends on shm wait
    timeout (producer gone) or --max-frames."""
    import numpy as np

    from pose_estimation_tpu_torch.io.shm import ShmStereoSource

    src = ShmStereoSource(
        args.live_camera, args.shm_width, args.shm_height,
        channels=args.shm_channels,
    )

    def fit(img):
        h, w = cfg.image_height, cfg.image_width
        if img.shape == (h, w):
            return img
        try:
            import cv2

            return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        except ImportError:  # nearest-neighbor fallback, host-side only
            yi = (np.arange(h) * img.shape[0] / h).astype(int)
            xi = (np.arange(w) * img.shape[1] / w).astype(int)
            return img[yi][:, xi]

    n = 0
    while True:
        out = src.read()
        if out is None:
            print("shm wait timeout; camera daemon gone — stopping")
            break
        ts, gl, gr = out
        slam.process(fit(gl), fit(gr), int(ts) * 1000)  # micros -> nanos
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    src.close()
    return n


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--recording-dir", default=None,
                    help="output of tools/cluonRecordingsToLocal (required "
                         "unless --live-camera)")
    ap.add_argument("--out", default="states.csv")
    ap.add_argument("--live-view", nargs="?", const=8642, type=int,
                    default=None, metavar="PORT",
                    help=LIVE_VIEW_HELP)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--live-imu", action="store_true",
                    help="ingest IMU from a live OD4 session (io/od4.py) "
                         "instead of the recording's imu.csv")
    ap.add_argument("--cid", type=int, default=253,
                    help="OD4 conference id (live mode)")
    ap.add_argument("--ellipse-id", type=int, default=112,
                    help="IMU sender stamp filter (live mode)")
    ap.add_argument("--live-camera", default=None, metavar="SHM_NAME",
                    help="ingest side-by-side stereo frames from a cluon "
                         "SharedMemory segment (io/shm.py) instead of the "
                         "recording — the reference's car mode "
                         "(cfsd-state-estimation.cpp:99-132)")
    ap.add_argument("--shm-width", type=int, default=1344,
                    help="side-by-side width of the shm frames")
    ap.add_argument("--shm-height", type=int, default=376)
    ap.add_argument("--shm-channels", type=int, default=4,
                    help="4 = CV_8UC4 like the car camera daemon, 1 = gray")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="live mode: stop after N frames (0 = until timeout)")
    args = ap.parse_args(argv)
    check_live_view(ap, args.live_view)

    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch.io.cfsd import CfsdRecording, run_cfsd
    from pose_estimation_tpu_torch.slam import VisualInertialSLAM

    cfg = load_config(args.config, dataset="cfsd")
    if args.recording_dir is None and not args.live_camera:
        ap.error("--recording-dir is required unless --live-camera is given")
    rec = CfsdRecording(args.recording_dir) if args.recording_dir else None
    slam = VisualInertialSLAM(cfg, verbose=args.verbose, device=device)
    viewer = start_live_view(slam, args.live_view, cfg.window_size)

    session = None
    if args.live_imu:
        from pose_estimation_tpu_torch.io import od4 as od4_mod

        session = od4_mod.OD4Session(cid=args.cid)
        od4_mod.attach_imu(session, slam, ellipse_id=args.ellipse_id)
        if rec is not None:
            rec.imu = []  # frames from the recording, IMU from the wire
        print(f"live IMU: OD4 cid={args.cid} ellipseID={args.ellipse_id}")

    t0 = time.time()
    try:
        if args.live_camera:
            n = _live_camera_loop(slam, cfg, args)
        else:
            n = run_cfsd(slam, rec)
    finally:
        if session is not None:
            session.stop()
        if viewer is not None:
            viewer.stop()
    wall = time.time() - t0
    print(f"processed {n} frames in {wall:.1f}s ({n / wall:.1f} FPS)")
    slam.save_results(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
