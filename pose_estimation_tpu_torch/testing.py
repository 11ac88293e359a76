"""Synthetic configurations and a numpy stereo-inertial world.

`synthetic_config` is `pose_estimation_tpu/testing.py:synthetic_config`;
`StereoInertialSim` and `sim_frames` are the trajectory-family-A renderer and
IMU synthesizer of `tests/sim.py` (`StereoInertialSim`, `sim_world`) in plain
numpy. They live here so that the GPU smoke test drives the port without
importing the JAX package; `tests/test_torch_vio.py` holds the frames and
IMU chunks equal to `tests/sim.py`'s.
"""

from __future__ import annotations

import numpy as np

from pose_estimation_tpu_torch.utils.config import VIOConfig

G = 9.81


def synthetic_config(
    width: int = 320,
    height: int = 240,
    levels: int = 4,
    features: int = 600,
    **overrides,
) -> VIOConfig:
    """A zero-distortion stereo rig for synthetic-data runs."""
    fx = width * 0.8
    k = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    base = dict(
        dataset="euroc", dataset_path="",
        image_width=width, image_height=height, camera_frequency=10,
        std_x=1.0, std_y=1.0,
        k_left=k, dist_left=np.zeros(5), k_right=k.copy(),
        dist_right=np.zeros(5),
        r_lr=np.eye(3), t_lr=np.array([-0.11, 0.0, 0.0]),
        r_cb=np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]),
        t_cb=np.zeros(3),
        sampling_rate=200, gyr_noise=1.7e-4, acc_noise=2.0e-3,
        gyr_walk=1.9e-5, acc_walk=3.0e-3, gravity_magnitude=9.81,
        num_features=features, scale_factor=1.2, level_pyramid=levels,
        ini_th_fast=20, min_th_fast=7, match_ratio=3.0, min_match_dist=40.0,
        max_vertical_pixel_dist=2.0, max_feature_age=8, max_depth=12.0,
        keyframe_rotation=0.1, keyframe_translation=0.15, max_imu_time=4.0,
        max_gyr_bias=0.1, max_acc_bias=0.6, sfm_rotation=0.0,
        sfm_translation=0.0, solve_pnp=0, max_num_iterations=15,
        prior_factor=1e-5, speed_up=1, max_keypoints=512, max_matches=256,
        pool_capacity=1024, imu_chunk=32,
    )
    base.update(overrides)
    return VIOConfig(**base)


def _rot(t: float) -> np.ndarray:
    """Body-to-world rotation of trajectory family A."""
    from scipy.spatial.transform import Rotation

    rv = np.array([0.12 * np.sin(0.5 * t), 0.10 * np.sin(0.8 * t), 0.08 * t])
    return Rotation.from_rotvec(rv).as_matrix()


def _pos(t: float) -> np.ndarray:
    return np.array([0.15 * np.sin(0.9 * t), 0.8 * t, 0.5 * np.sin(0.7 * t)])


class StereoInertialSim:
    """Landmarks splatted as random 9x9 patches into a moving stereo rig."""

    def __init__(self, cfg: VIOConfig, n_landmarks: int = 400, seed: int = 0,
                 y_max: float = 11.0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.g_w = G * np.asarray(cfg.profile.gravity_dir, np.float64)
        self.lm = np.stack([
            rng.uniform(2.5, 11.0, n_landmarks),
            rng.uniform(-3.0, y_max, n_landmarks),
            rng.uniform(-4.0, 4.0, n_landmarks),
        ], axis=1)
        self.patches = rng.uniform(60, 255, size=(n_landmarks, 9, 9))

    rot = staticmethod(_rot)
    pos = staticmethod(_pos)

    def imu_at(self, t, dt=1e-4):
        """(gyro, specific force) in the body frame by finite differences."""
        from scipy.spatial.transform import Rotation

        r0, r1 = _rot(t), _rot(t + dt)
        w_hat = Rotation.from_matrix(r0.T @ r1).as_rotvec() / dt
        a_w = (_pos(t + dt) - 2 * _pos(t) + _pos(t - dt)) / dt**2
        return w_hat, r0.T @ (a_w - self.g_w)

    def vel_at(self, t, dt=1e-4):
        return (_pos(t + dt) - _pos(t - dt)) / (2 * dt)

    def render(self, t):
        """(left, right) float32 images at time t."""
        cfg = self.cfg
        w, h = cfg.image_width, cfg.image_height
        R_wb, p_wb = _rot(t), _pos(t)
        imgs = []
        for cam in (0, 1):
            img = np.full((h, w), 20.0, np.float32)
            x_cam = (cfg.r_cb @ (R_wb.T @ (self.lm - p_wb).T)).T
            if cam == 1:
                x_cam = x_cam + cfg.t_lr
            z = x_cam[:, 2]
            zc = np.maximum(z, 0.1)
            u = cfg.k_left[0, 0] * x_cam[:, 0] / zc + cfg.k_left[0, 2]
            v = cfg.k_left[1, 1] * x_cam[:, 1] / zc + cfg.k_left[1, 2]
            for i in np.where(z > 0.5)[0]:
                u0, v0 = u[i], v[i]
                ui, vi = int(np.floor(u0)), int(np.floor(v0))
                if 7 <= ui < w - 7 and 7 <= vi < h - 7:
                    fx_, fy_ = u0 - ui, v0 - vi
                    big = np.zeros((11, 11), np.float32)
                    big[1:10, 1:10] = self.patches[i]
                    shifted = (
                        big[1:11, 1:11] * (1 - fx_) * (1 - fy_)
                        + big[1:11, 0:10] * fx_ * (1 - fy_)
                        + big[0:10, 1:11] * (1 - fx_) * fy_
                        + big[0:10, 0:10] * fx_ * fy_
                    )
                    win = img[vi - 4 : vi + 6, ui - 4 : ui + 6]
                    img[vi - 4 : vi + 6, ui - 4 : ui + 6] = np.maximum(
                        win, shifted
                    )
            imgs.append(img)
        return imgs[0], imgs[1]


def sim_frames(cfg: VIOConfig, n_frames: int, imu_noise: float = 2.4e-3,
               n_landmarks: int = 400, seed: int = 0, t0: float = 0.5):
    """numpy form of `tests/sim.py:sim_world`: (frames [(l, r)], gyrs [n][M,
    3], accs [n][M, 3], imu_mask [M] bool, truth(j) -> (R, p, v) at frame
    j's predecessor time)."""
    sim = StereoInertialSim(cfg, n_landmarks=n_landmarks, seed=seed)
    nrng = np.random.default_rng(seed + 1)
    hz = cfg.camera_frequency
    spf = int(round(cfg.sampling_rate / hz))
    m = cfg.imu_chunk
    if spf > m:
        raise ValueError(f"{spf} IMU samples per frame exceed imu_chunk {m}")
    frames, gyrs, accs = [], [], []
    for i in range(n_frames):
        t = t0 + i / hz
        frames.append(sim.render(t))
        g = np.zeros((m, 3), np.float32)
        a = np.zeros((m, 3), np.float32)
        for k in range(spf):
            w_b, f_b = sim.imu_at(t - (spf - 1 - k) * cfg.dt)
            g[k] = w_b + nrng.normal(0, imu_noise, 3)
            a[k] = f_b + nrng.normal(0, imu_noise * 10, 3)
        gyrs.append(g)
        accs.append(a)
    mask = np.arange(m) < spf

    def truth(j):
        t = t0 + (j - 1) / hz
        return _rot(t), _pos(t), sim.vel_at(t)

    return frames, gyrs, accs, mask, truth


def seeded_state(static, truth, device):
    """A fresh VIOState with every window frame at frame 0's true start
    state (`tests/sim.py:seeded_state`): the stand-in for the host state
    machine's SYNC/SFM/INIT phases."""
    import torch

    from pose_estimation_tpu_torch.models import vio

    state = vio.init_vio_state(static, device)
    wlen = static.window + 1

    def rep(a, shape):
        return torch.as_tensor(np.broadcast_to(a, shape).copy(), dtype=torch.float32,
                               device=device)

    r0, p0, v0 = truth(0)
    return state._replace(win=state.win._replace(
        R=rep(r0, (wlen, 3, 3)), p=rep(p0, (wlen, 3)), v=rep(v0, (wlen, 3))))

