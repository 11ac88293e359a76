"""Runtime configuration of the port.

The same record as `pose_estimation_tpu/utils/config.py:VIOConfig`, field
for field and default for default, kept in the port so that the port and
its GPU smoke test import nothing of the JAX package. The YAML loader
(`load_config`) is not ported yet: the port's slice takes its configuration
from `testing.synthetic_config`. `tests/test_torch_geometry.py` holds both
records and both profile tables equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WINDOW_SIZE = 4  # sliding window


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    gravity_dir: tuple[float, float, float]
    acc_noise_times_g: bool
    bias_walk_over_sqrt_dt: bool
    acc_bias_times_g: bool
    key_gyr_noise: str
    key_acc_noise: str
    key_gyr_walk: str
    key_acc_walk: str
    alignment_axes: tuple[int, int]


PROFILES = {
    "euroc": DatasetProfile(
        name="euroc", gravity_dir=(-1.0, 0.0, 0.0),
        acc_noise_times_g=False, bias_walk_over_sqrt_dt=False,
        acc_bias_times_g=False,
        key_gyr_noise="gyroscope_noise_density",
        key_acc_noise="accelerometer_noise_density",
        key_gyr_walk="gyroscope_random_walk",
        key_acc_walk="accelerometer_random_walk",
        alignment_axes=(1, 2),
    ),
    "kitti": DatasetProfile(
        name="kitti", gravity_dir=(0.0, 0.0, -1.0),
        acc_noise_times_g=True, bias_walk_over_sqrt_dt=True,
        acc_bias_times_g=True,
        key_gyr_noise="gyrNoise", key_acc_noise="accNoise",
        key_gyr_walk="gyrBias", key_acc_walk="accBias",
        alignment_axes=(0, 1),
    ),
    "cfsd": DatasetProfile(
        name="cfsd", gravity_dir=(0.0, 0.0, 1.0),
        acc_noise_times_g=True, bias_walk_over_sqrt_dt=True,
        acc_bias_times_g=True,
        key_gyr_noise="gyrNoise", key_acc_noise="accNoise",
        key_gyr_walk="gyrBias", key_acc_walk="accBias",
        alignment_axes=(0, 1),
    ),
}


@dataclasses.dataclass(frozen=True)
class VIOConfig:
    """All tunables of the pipeline (see the JAX package's record for the
    meaning of each field)."""

    dataset: str
    dataset_path: str

    image_width: int
    image_height: int
    camera_frequency: int
    std_x: float
    std_y: float
    k_left: np.ndarray
    dist_left: np.ndarray
    k_right: np.ndarray
    dist_right: np.ndarray
    r_lr: np.ndarray
    t_lr: np.ndarray
    r_cb: np.ndarray
    t_cb: np.ndarray

    sampling_rate: int
    gyr_noise: float
    acc_noise: float
    gyr_walk: float
    acc_walk: float
    gravity_magnitude: float

    num_features: int
    scale_factor: float
    level_pyramid: int
    ini_th_fast: int
    min_th_fast: int
    match_ratio: float
    min_match_dist: float
    max_vertical_pixel_dist: float
    max_feature_age: int
    max_depth: float

    keyframe_rotation: float
    keyframe_translation: float
    max_imu_time: float
    max_gyr_bias: float
    max_acc_bias: float
    sfm_rotation: float
    sfm_translation: float
    solve_pnp: int

    max_num_iterations: int
    prior_factor: float

    speed_up: int

    max_keypoints: int = 1024
    max_matches: int = 384
    pool_capacity: int = 1024
    imu_chunk: int = 32
    window_size: int = WINDOW_SIZE
    rectify_mode: str = "sparse"
    full_ba_keyframes: bool = False
    full_ba_iterations: int = 8
    marg_prior: bool = True
    marg_forget: float = 1.0
    ba_prior_sigma: float = 0.0
    fast_backend: str = "auto"
    sample_backend: str = "auto"
    select_dtype: str = "f32"

    @property
    def profile(self) -> DatasetProfile:
        return PROFILES[self.dataset]

    @property
    def dt(self) -> float:
        return 1.0 / float(self.sampling_rate)

    @property
    def gravity(self) -> np.ndarray:
        return np.asarray(self.profile.gravity_dir) * self.gravity_magnitude

    def discrete_noise(self) -> tuple[float, float, float, float]:
        """(gyr_noise_d, acc_noise_d, gyr_walk_d, acc_walk_d)."""
        p = self.profile
        sdt = np.sqrt(self.dt)
        g = self.gravity_magnitude
        gyr_n = self.gyr_noise / sdt
        acc_n = self.acc_noise * (g if p.acc_noise_times_g else 1.0) / sdt
        gyr_w = self.gyr_walk / (sdt if p.bias_walk_over_sqrt_dt else 1.0)
        acc_w = (
            self.acc_walk
            * (g if p.acc_bias_times_g else 1.0)
            / (sdt if p.bias_walk_over_sqrt_dt else 1.0)
        )
        return gyr_n, acc_n, gyr_w, acc_w
