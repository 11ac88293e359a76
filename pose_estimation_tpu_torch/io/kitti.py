"""KITTI raw-dataset replay.

Mirror of the reference's `src/kitti-state-estimation.cpp:8-111`: per-sample
`oxts/processed/0000NNNNN.txt` files (ax ay az wx wy wz) with
`timestamps.txt`, zero-padded `image_00/data/0000000NNN.png` stereo pairs
with `processed_timestamps.txt`, interleaved `rate+1` IMU rows per image.

A copy of `pose_estimation_tpu/io/kitti.py` that drives the port's
`slam.VisualInertialSLAM`; the image reader is injected (`imread`) and
defaults to `io/png.py:reader` on the replay's device, which reads the
PNGs without OpenCV. `tests/test_torch_slam.py` and `tests/test_torch_io.py`
hold the copy equal to the original.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pose_estimation_tpu_torch.io import png


class KittiDataset:
    def __init__(self, root: str):
        self.root = Path(root)
        self.imu_ts = [
            int(t) for t in
            (self.root / "oxts" / "processed" / "timestamps.txt").read_text().split()
        ]
        self.img_ts = [
            int(t) for t in
            (self.root / "image_00" / "processed_timestamps.txt").read_text().split()
        ]

    def imu_row(self, i: int):
        path = self.root / "oxts" / "processed" / f"{i:010d}.txt"
        ax, ay, az, wx, wy, wz = (float(v) for v in path.read_text().split()[:6])
        return np.array([ax, ay, az]), np.array([wx, wy, wz])

    def image_paths(self, i: int):
        return (
            str(self.root / "image_00" / "data" / f"{i:010d}.png"),
            str(self.root / "image_01" / "data" / f"{i:010d}.png"),
        )


def run_kitti(slam, dataset: KittiDataset, max_num_imu: int, max_num_image: int,
              rate: int, imread=None):
    """Replay loop with the reference's `rate+1` IMU rows per image."""
    from pose_estimation_tpu_torch.slam import SensorType

    if imread is None:
        imread = png.reader(slam.device)

    num_imu = 0
    num_image = 0
    while num_imu < max_num_imu and num_image < max_num_image:
        for _ in range(rate + 1):
            if num_imu >= len(dataset.imu_ts):
                return num_image
            acc, gyr = dataset.imu_row(num_imu)
            ts = dataset.imu_ts[num_imu]
            slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *acc)
            slam.collect_imu_data(SensorType.GYROSCOPE, ts, *gyr)
            num_imu += 1
        if num_image >= len(dataset.img_ts):
            return num_image
        pl, pr = dataset.image_paths(num_image)
        img_l = imread(pl)
        img_r = imread(pr)
        ts = dataset.img_ts[num_image]
        num_image += 1
        if img_l is None or img_r is None:
            continue
        slam.process(img_l, img_r, ts)
    return num_image
