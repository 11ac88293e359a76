"""EuRoC MAV dataset replay.

Mirror of the reference's EuRoC replay (`src/euroc-state-estimation.cpp:
8-103`): reads `mav0/{cam0,cam1}/data.csv` + `mav0/imu0/data.csv`, feeds
IMU rows and every `speedUp`-th stereo pair to the SLAM object in
timestamp order.

A copy of `pose_estimation_tpu/io/euroc.py` that drives the port's
`slam.VisualInertialSLAM`; the image reader defaults to `io/png.py:reader`
on the replay's device, which reads the PNGs without OpenCV.
`tests/test_torch_io.py` holds the copy equal to the original.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from pose_estimation_tpu_torch.io import png


def _read_csv(path: Path) -> list[list[str]]:
    with open(path) as f:
        rows = [r for r in csv.reader(f) if r and not r[0].startswith("#")]
    return rows


class EurocDataset:
    def __init__(self, mav0_dir: str):
        self.root = Path(mav0_dir)
        self.cam0 = _read_csv(self.root / "cam0" / "data.csv")
        self.cam1 = _read_csv(self.root / "cam1" / "data.csv")
        self.imu = _read_csv(self.root / "imu0" / "data.csv")

    def events(self, speed_up: int = 1, max_frames: int | None = None):
        """Yield ('imu', ts, gyr, acc) and ('img', ts, path_l, path_r) in
        timestamp order, keeping every speed_up-th image pair."""
        imu_i = 0
        n_frames = 0
        for k in range(0, len(self.cam0), speed_up):
            ts = int(self.cam0[k][0])
            while imu_i < len(self.imu) and int(self.imu[imu_i][0]) <= ts:
                row = self.imu[imu_i]
                yield (
                    "imu", int(row[0]),
                    np.array([float(row[1]), float(row[2]), float(row[3])]),
                    np.array([float(row[4]), float(row[5]), float(row[6])]),
                )
                imu_i += 1
            if k < len(self.cam1):
                yield (
                    "img", ts,
                    str(self.root / "cam0" / "data" / self.cam0[k][1].strip()),
                    str(self.root / "cam1" / "data" / self.cam1[k][1].strip()),
                )
                n_frames += 1
                if max_frames and n_frames >= max_frames:
                    return

    def ground_truth(self) -> np.ndarray:
        """[N, 4] (ts, px, py, pz) from state_groundtruth_estimate0."""
        rows = _read_csv(
            self.root / "state_groundtruth_estimate0" / "data.csv"
        )
        return np.array(
            [[int(r[0]), float(r[1]), float(r[2]), float(r[3])] for r in rows]
        )


def run_euroc(slam, dataset: "EurocDataset", speed_up: int = 1,
              max_frames: int | None = None, imread=None):
    """Replay loop (the reference main's body)."""
    from pose_estimation_tpu_torch.slam import SensorType

    if imread is None:
        imread = png.reader(slam.device)

    n = 0
    for ev in dataset.events(speed_up, max_frames):
        if ev[0] == "imu":
            _, ts, gyr, acc = ev
            slam.collect_imu_data(SensorType.GYROSCOPE, ts, *gyr)
            slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *acc)
        else:
            _, ts, pl, pr = ev
            img_l = imread(pl)
            img_r = imread(pr)
            if img_l is None or img_r is None:
                continue
            slam.process(img_l, img_r, ts)
            n += 1
    return n
