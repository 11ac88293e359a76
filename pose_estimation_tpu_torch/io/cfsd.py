"""CFSD recordings replay (offline).

The reference's live path ingests OD4 UDP multicast + cluon SharedMemory
(`src/cfsd-state-estimation.cpp`). The offline equivalent
replays the output of the reference's own conversion tool
`tools/cluonRecordingsToLocal` (`src/cluonRecordingsToLocal.cpp:30-109`):
a directory of side-by-side stereo JPEGs (or pre-split left/ right/ dirs,
`bin/split.py`) plus `imgTimestamp.txt` and an IMU CSV.

Live OD4 ingestion would be a thin UDP adapter calling the same
`collect_imu_data`/`process` API; it is optional and needs a running OD4
session.

A copy of `pose_estimation_tpu/io/cfsd.py` that drives the port's
`slam.VisualInertialSLAM`. The recordings are JPEGs, so the default image
reader (`io/png.py:reader`) hands them to OpenCV, which must be installed.
`tests/test_torch_io.py` holds the copy equal to the original.
"""

from __future__ import annotations

import csv
from pathlib import Path

from pose_estimation_tpu_torch.io import png


class CfsdRecording:
    def __init__(self, root: str):
        self.root = Path(root)
        self.img_ts = [
            int(t) for t in (self.root / "imgTimestamp.txt").read_text().split()
        ]
        imu_file = self.root / "imu.csv"
        self.imu = []
        if imu_file.exists():
            with open(imu_file) as f:
                for row in csv.reader(f):
                    if row and not row[0].startswith("#"):
                        # ts, gx, gy, gz, ax, ay, az
                        self.imu.append([float(v) for v in row])

    def frame(self, i: int, imread):
        """Returns (gray_left, gray_right) — splits side-by-side images, or
        reads from left//right/ dirs when present."""
        left_dir = self.root / "left"
        if left_dir.exists():
            l = imread(str(left_dir / f"{i}.jpg"))
            r = imread(str(self.root / "right" / f"{i}.jpg"))
            return l, r
        img = imread(str(self.root / f"{i}.jpg"))
        if img is None:
            return None, None
        w = img.shape[1] // 2
        return img[:, :w], img[:, w:]


def run_cfsd(slam, rec: CfsdRecording, imread=None):
    from pose_estimation_tpu_torch.slam import SensorType

    if imread is None:
        imread = png.reader(slam.device)

    imu_i = 0
    n = 0
    for k, ts in enumerate(rec.img_ts):
        while imu_i < len(rec.imu) and rec.imu[imu_i][0] <= ts:
            row = rec.imu[imu_i]
            slam.collect_imu_data(SensorType.GYROSCOPE, int(row[0]), *row[1:4])
            slam.collect_imu_data(SensorType.ACCELEROMETER, int(row[0]), *row[4:7])
            imu_i += 1
        img_l, img_r = rec.frame(k, imread)
        if img_l is None:
            continue
        slam.process(img_l, img_r, ts)
        n += 1
    return n
