"""Synthetic configurations and a numpy stereo-inertial world.

`synthetic_config` and `tiny_config` are
`pose_estimation_tpu/testing.py`'s;
`sim_config`, `Trajectory` (families A and B), `set_family`,
`StereoInertialSim` (renderer, IMU synthesizer and the replay `run` that
feeds a `slam.VisualInertialSLAM`) and `sim_frames` are copies of
`tests/sim.py` (`sim_config`, `Trajectory`, `set_family`,
`StereoInertialSim`, `sim_world`) in plain numpy. They live here so that
the GPU smoke test drives the port without importing the JAX package;
`tests/test_torch_vio.py` and `tests/test_torch_slam.py` hold the frames
and IMU equal to `tests/sim.py`'s.

`protocol_world` and `run_errors` set up and score the accuracy protocol
of `benchmarks/chip_accuracy.py` for `chip_smoke.py` and
`tools/accuracy_seeds.py`.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path

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


def tiny_config(**overrides) -> VIOConfig:
    """Minimal shapes for the multi-process dry runs (96x64, 2 levels, 64
    features, a 128-slot pool)."""
    base = dict(max_keypoints=64, max_matches=32, pool_capacity=128, imu_chunk=8)
    base.update(overrides)
    return synthetic_config(width=96, height=64, levels=2, features=64, **base)


def sim_config(width: int = 320, height: int = 240, **overrides) -> VIOConfig:
    """The end-to-end simulator's rig (`tests/sim.py:sim_config`): fx = 260
    with the principal point at the image centre, keyframes at 0.05 rad or
    0.05 m."""
    k = np.array([[260.0, 0, width / 2], [0, 260.0, height / 2], [0, 0, 1.0]])
    base = dict(
        dataset="euroc", dataset_path="",
        image_width=width, image_height=height, camera_frequency=10,
        std_x=1.0, std_y=1.0,
        k_left=k, dist_left=np.zeros(5), k_right=k.copy(), dist_right=np.zeros(5),
        r_lr=np.eye(3), t_lr=np.array([-0.11, 0.0, 0.0]),
        r_cb=np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]),
        t_cb=np.array([0.0, 0.0, 0.0]),
        sampling_rate=200, gyr_noise=1.7e-4, acc_noise=2.0e-3,
        gyr_walk=1.9e-5, acc_walk=3.0e-3, gravity_magnitude=G,
        num_features=600, scale_factor=1.2, level_pyramid=4,
        ini_th_fast=20, min_th_fast=7, match_ratio=3.0, min_match_dist=40.0,
        max_vertical_pixel_dist=2.0, max_feature_age=8, max_depth=12.0,
        keyframe_rotation=0.05, keyframe_translation=0.05, max_imu_time=4.0,
        max_gyr_bias=0.1, max_acc_bias=0.6, sfm_rotation=0.0,
        sfm_translation=0.0, solve_pnp=0, max_num_iterations=15,
        prior_factor=1e-5, speed_up=1, max_keypoints=512, max_matches=256,
        pool_capacity=1024, imu_chunk=32,
    )
    base.update(overrides)
    return VIOConfig(**base)


@dataclasses.dataclass
class Trajectory:
    """Analytic body trajectory. Family A is a 6-s meander whose yaw drifts
    at 0.08 rad/s; family B has other harmonics and bounded yaw, so it stays
    inside the landmark field on 12-20 s horizons."""

    family: str = "A"

    def pos(self, t):
        if self.family == "B":
            return np.array([0.12 * np.sin(0.8 * t + 1.0), 0.8 * t,
                             0.45 * np.cos(0.55 * t) - 0.45])
        return np.array([0.15 * np.sin(0.9 * t), 0.8 * t, 0.5 * np.sin(0.7 * t)])

    def rot(self, t):
        """Body-to-world rotation."""
        from scipy.spatial.transform import Rotation

        if self.family == "B":
            rv = np.array([0.10 * np.sin(0.6 * t), 0.12 * np.sin(0.45 * t + 0.5),
                           0.25 * np.sin(0.3 * t)])
        else:
            rv = np.array([0.12 * np.sin(0.5 * t), 0.10 * np.sin(0.8 * t), 0.08 * t])
        return Rotation.from_rotvec(rv).as_matrix()


def set_family(sim: "StereoInertialSim", family: str) -> None:
    """Switch a sim's trajectory family in place (the landmark field stays)."""
    sim.traj = Trajectory(family=family)


class StereoInertialSim:
    """Landmarks splatted as random 9x9 patches into a moving stereo rig,
    with world gravity on the configuration's dataset-profile axis."""

    def __init__(self, cfg: VIOConfig, n_landmarks: int = 400, seed: int = 0,
                 y_max: float = 11.0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.traj = Trajectory()
        self.g_w = G * np.asarray(cfg.profile.gravity_dir, np.float64)
        # y_max must cover the trajectory's y extent (0.8 m/s x duration)
        self.lm = np.stack([
            rng.uniform(2.5, 11.0, n_landmarks),
            rng.uniform(-3.0, y_max, n_landmarks),
            rng.uniform(-4.0, 4.0, n_landmarks),
        ], axis=1)
        self.patches = rng.uniform(60, 255, size=(n_landmarks, 9, 9))

    def imu_at(self, t, dt=1e-4):
        """(gyro, specific force) in the body frame by finite differences."""
        from scipy.spatial.transform import Rotation

        r0, r1 = self.traj.rot(t), self.traj.rot(t + dt)
        w_hat = Rotation.from_matrix(r0.T @ r1).as_rotvec() / dt
        a_w = (self.traj.pos(t + dt) - 2 * self.traj.pos(t) + self.traj.pos(t - dt)) / dt**2
        return w_hat, r0.T @ (a_w - self.g_w)

    def vel_at(self, t, dt=1e-4):
        return (self.traj.pos(t + dt) - self.traj.pos(t - dt)) / (2 * dt)

    def render(self, t):
        """(left, right) float32 images at time t."""
        cfg = self.cfg
        w, h = cfg.image_width, cfg.image_height
        R_wb, p_wb = self.traj.rot(t), self.traj.pos(t)
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

    def run(self, slam, duration=6.0, frame_hz=10, imu_noise=0.0, seed=1):
        """Feed `slam` (IMU at the sampling rate, a stereo frame every
        1/frame_hz s, nanosecond timestamps); returns the true trajectory
        [N, 4] (ts, x, y, z) at the frames."""
        from pose_estimation_tpu_torch.slam import SensorType

        nrng = np.random.default_rng(seed)
        dt_imu = 1.0 / self.cfg.sampling_rate
        n_imu = int(duration / dt_imu)
        frame_every = self.cfg.sampling_rate // frame_hz
        gt = []
        for k in range(n_imu):
            t = k * dt_imu
            ts = int(t * 1e9)
            w_b, f_b = self.imu_at(t)
            if imu_noise:
                w_b = w_b + nrng.normal(0, imu_noise, 3)
                f_b = f_b + nrng.normal(0, imu_noise * 10, 3)
            slam.collect_imu_data(SensorType.GYROSCOPE, ts, *w_b)
            slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *f_b)
            if k % frame_every == 0:
                img_l, img_r = self.render(t)
                slam.process(img_l, img_r, ts)
                gt.append([ts, *self.traj.pos(t)])
        return np.array(gt)


# The accuracy protocol of `benchmarks/chip_accuracy.py:45-52, 110-158`:
# family A worlds 0-2 for 6 s with 150 landmarks, family B worlds 0-1 for
# 12 s with 220, the landmark field reaching y = max(11, 0.8 x duration +
# 5), keyframes at 0.1 rad or 0.15 m, IMU noise 2.4e-3 drawn with seed
# world seed + 10. A run passes with ATE < 4 % of path, |ba| < 1.5 and
# |bg| < 0.01.
PROTOCOL_RUNS = ("A0", "A1", "A2", "B0", "B1")
PROTOCOL_IMU_NOISE = 2.4e-3
GATE_ATE_PCT, GATE_BA, GATE_BG = 4.0, 1.5, 0.01


def protocol_world(run: str):
    """(config, world, duration [s], IMU seed) of protocol run `run`, one
    of PROTOCOL_RUNS (family letter and world seed)."""
    family, world_seed = run[0], int(run[1:])
    duration = 6.0 if family == "A" else 12.0
    cfg = sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    world = StereoInertialSim(cfg, n_landmarks=150 if family == "A" else 220, seed=world_seed,
                              y_max=max(11.0, 0.8 * duration + 5.0))
    set_family(world, family)
    return cfg, world, duration, world_seed + 10


def run_errors(slam, gt) -> dict:
    """A finished replay against its ground truth `gt` (rows [t, x, y, z]):
    ATE as % of path, the newest frame's |ba| and |bg|, the aligned error
    of each matched frame [m] and the distance travelled up to it [m]."""
    import torch

    from pose_estimation_tpu_torch.io.ate import associate, ate_rmse, umeyama

    path = float(np.linalg.norm(np.diff(gt[:, 1:], axis=0), axis=1).sum())
    traj = slam.trajectory
    e, g = associate(traj, gt)
    _, r, t = umeyama(e, g)
    win = slam.vio.win
    return {
        "ate_pct": ate_rmse(traj, gt) / path * 100.0,
        "ba": float(torch.linalg.norm(win.ics.ba_i[-1] + win.dba[-1])),
        "bg": float(torch.linalg.norm(win.ics.bg_i[-1] + win.dbg[-1])),
        "err": np.linalg.norm((r @ e.T).T + t - g, axis=1),
        "dist": np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(g, axis=0), axis=1))]),
    }


def within_gates(errors: dict) -> bool:
    """The protocol's verdict on `run_errors`' result (the state machine
    must also have ended in OK)."""
    return (errors["ate_pct"] < GATE_ATE_PCT and errors["ba"] < GATE_BA
            and errors["bg"] < GATE_BG)


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
        return sim.traj.rot(t), sim.traj.pos(t), sim.vel_at(t)

    return frames, gyrs, accs, mask, truth


def seeded_state(static, truth, device, j: int = 0):
    """A fresh VIOState with every window frame at frame j's true start
    state (`tests/sim.py:seeded_state`): the stand-in for the host state
    machine's SYNC/SFM/INIT phases."""
    import torch

    from pose_estimation_tpu_torch.models import vio

    state = vio.init_vio_state(static, device)
    wlen = static.window + 1

    def rep(a, shape):
        return torch.as_tensor(np.broadcast_to(a, shape).copy(), dtype=torch.float32,
                               device=device)

    r0, p0, v0 = truth(j)
    return state._replace(win=state.win._replace(
        R=rep(r0, (wlen, 3, 3)), p=rep(p0, (wlen, 3)), v=rep(v0, (wlen, 3))))


# ---- datasets on disk, in the formats the replay readers take


def write_png(path, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG of `img` [H, W] whose rows cycle through the
    five row filters (None, Sub, Up, Average, Paeth), so that a reader of
    these files runs every unfilter path."""
    x = np.asarray(img)
    if x.dtype != np.uint8 or x.ndim != 2:
        raise ValueError("write_png takes a [H, W] uint8 image")
    h, w = x.shape
    xi = x.astype(np.int64)
    left = np.pad(xi, ((0, 0), (1, 0)))[:, :w]
    up = np.pad(xi, ((1, 0), (0, 0)))[:h]
    corner = np.pad(xi, ((1, 0), (1, 0)))[:h, :w]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    preds = np.stack([np.zeros_like(xi), left, up, (left + up) >> 1, paeth])
    kind = np.arange(h) % 5
    filt = (xi - preds[kind, np.arange(h)]) & 0xFF
    raw = np.concatenate([kind[:, None], filt], axis=1).astype(np.uint8).tobytes()

    def chunk(kind_: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind_ + body
                + struct.pack(">I", zlib.crc32(kind_ + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _yaml_mat(name: str, a) -> str:
    a = np.asarray(a, np.float64)
    rows, cols = (a.shape[0], 1) if a.ndim == 1 else a.shape
    data = ", ".join(repr(float(x)) for x in a.reshape(-1))
    return (f"{name}: !!opencv-matrix\n    rows: {rows}\n    cols: {cols}\n"
            f"    dt: d\n    data: [ {data} ]\n")


def write_config(path, cfg: VIOConfig, dataset_dir, extra: dict | None = None) -> None:
    """A reference-format OpenCV-YAML configuration of `cfg` for replaying
    `dataset_dir` (the format of `tools/render_euroc.py:write_config`).
    A kitti configuration takes the profile's IMU keys and the reference
    kitti.yml's spelling of the keyframe keys (`keyframe_rotation`);
    `extra` adds keys (KITTI's `maxNumImu`, `maxNumImage`)."""
    p = cfg.profile
    s = ["%YAML:1.0", f"dataset: {dataset_dir}/", f"speedUp: {cfg.speed_up}", ""]
    s += [f"imageWidth: {cfg.image_width}", f"imageHeight: {cfg.image_height}",
          f"cameraFrequency: {cfg.camera_frequency}",
          f"stdX: {cfg.std_x}", f"stdY: {cfg.std_y}", ""]
    s += [_yaml_mat("camLeft", cfg.k_left), _yaml_mat("distLeft", cfg.dist_left),
          _yaml_mat("camRight", cfg.k_right), _yaml_mat("distRight", cfg.dist_right),
          _yaml_mat("rotationLeftToRight", cfg.r_lr),
          _yaml_mat("translationLeftToRight", cfg.t_lr),
          _yaml_mat("rotationImuToCamera", cfg.r_cb),
          _yaml_mat("translationImuToCamera", cfg.t_cb)]
    s += [f"samplingRate: {cfg.sampling_rate}",
          f"{p.key_gyr_noise}: {cfg.gyr_noise}",
          f"{p.key_gyr_walk}: {cfg.gyr_walk}",
          f"{p.key_acc_noise}: {cfg.acc_noise}",
          f"{p.key_acc_walk}: {cfg.acc_walk}", ""]
    s += ["cvORB: 0", f"numberOfFeatures: {cfg.num_features}",
          f"scaleFactor: {cfg.scale_factor}",
          f"levelPyramid: {cfg.level_pyramid}",
          "edgeThreshold: 31", "scoreType: 1", "patchSize: 31",
          "fastThreshold: 20", "gridRow: 1", "gridCol: 1",
          f"iniThFAST: {cfg.ini_th_fast}", f"minThFAST: {cfg.min_th_fast}",
          f"matchRatio: {cfg.match_ratio}",
          f"minMatchDist: {cfg.min_match_dist}",
          f"maxVerticalPixelDist: {cfg.max_vertical_pixel_dist}",
          f"maxFeatureAge: {cfg.max_feature_age}",
          f"maxDepth: {cfg.max_depth}", ""]
    rot_key, trans_key = (("keyframe_rotation", "keyframe_translation") if cfg.dataset == "kitti"
                          else ("keyframeRotation", "keyframeTranslation"))
    s += [f"{rot_key}: {cfg.keyframe_rotation}",
          f"{trans_key}: {cfg.keyframe_translation}",
          f"maxImuTime: {cfg.max_imu_time}",
          f"maxGyrBias: {cfg.max_gyr_bias}",
          f"maxAccBias: {cfg.max_acc_bias}",
          f"sfmRotation: {cfg.sfm_rotation}",
          f"sfmTranslation: {cfg.sfm_translation}",
          f"solvePnP: {cfg.solve_pnp}", ""]
    s += [f"max_num_iterations: {cfg.max_num_iterations}",
          "max_solver_time_in_seconds: 10", "num_threads: 4",
          "check_gradients: 0", f"gravity: {cfg.gravity_magnitude}",
          f"priorFactor: {cfg.prior_factor}", ""]
    s += ["viewScale: 1", "pointSize: 4", "landmarkSize: 2",
          "cameraSize: 0.08", "cameraLineWidth: 3", "lineWidth: 2",
          "viewpointX: 10", "viewpointY: 10", "viewpointZ: -30",
          "viewpointF: 2000", "background: 0", "axisDirection: 2"]
    s += [f"{k}: {v}" for k, v in (extra or {}).items()]
    Path(path).write_text("\n".join(s) + "\n")


def _imu_rows(sim: StereoInertialSim, n: int, imu_noise: float, seed: int):
    """(t [n], gyro [n, 3], specific force [n, 3]) at the sampling rate from
    t = 0, with the noise of the accuracy protocol (gyro sigma
    `imu_noise`, accelerometer 10x) drawn from `seed`."""
    nrng = np.random.default_rng(seed)
    t = np.arange(n) / sim.cfg.sampling_rate
    gyr, acc = np.zeros((n, 3)), np.zeros((n, 3))
    for k in range(n):
        gyr[k], acc[k] = sim.imu_at(t[k])
        if imu_noise:
            gyr[k] = gyr[k] + nrng.normal(0, imu_noise, 3)
            acc[k] = acc[k] + nrng.normal(0, imu_noise * 10, 3)
    return t, gyr, acc


def write_euroc(out, cfg: VIOConfig, duration: float, n_landmarks: int = 150, seed: int = 0,
                imu_noise: float = PROTOCOL_IMU_NOISE):
    """Render the simulated world `seed` (family A) to EuRoC's format, as
    `tools/render_euroc.py` does: `out/mav0` with `imu0`, `cam0`, `cam1`
    (8-bit PNGs by `write_png`) and `state_groundtruth_estimate0`, and the
    configuration `out/euroc_sim.yml`. The IMU runs past the last frame by
    2 frame intervals + 8 samples (the reference's replay reads one row
    more than elapses per frame). Returns (config path, mav0 path, number
    of frames)."""
    from scipy.spatial.transform import Rotation

    out = Path(out)
    sim = StereoInertialSim(cfg, n_landmarks=n_landmarks, seed=seed,
                            y_max=max(11.0, 0.8 * duration + 5.0))
    mav0 = out / "mav0"
    for d in ("imu0", "cam0/data", "cam1/data", "state_groundtruth_estimate0"):
        (mav0 / d).mkdir(parents=True, exist_ok=True)
    frame_every = cfg.sampling_rate // cfg.camera_frequency
    n_imu = int(duration * cfg.sampling_rate) + 2 * frame_every + 8
    n_img = int(duration * cfg.sampling_rate) // frame_every + 1
    t, gyr, acc = _imu_rows(sim, n_imu, imu_noise, seed + 10)
    imu_rows = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]"]
    imu_rows += [f"{int(round(t[k] * 1e9))}," + ",".join(repr(float(v)) for v in (*gyr[k], *acc[k]))
                 for k in range(n_imu)]
    img_rows = ["#timestamp [ns],filename"]
    gt_rows = ["#timestamp,px,py,pz,qw,qx,qy,qz,vx,vy,vz"]
    for j in range(n_img):
        tj = j * frame_every / cfg.sampling_rate
        ts = int(round(tj * 1e9))
        for cam, img in zip(("cam0", "cam1"), sim.render(tj)):
            write_png(mav0 / cam / "data" / f"{ts}.png", np.clip(img, 0, 255).astype(np.uint8))
        img_rows.append(f"{ts},{ts}.png")
        q = Rotation.from_matrix(sim.traj.rot(tj)).as_quat()
        vals = (*sim.traj.pos(tj), q[3], q[0], q[1], q[2], *sim.vel_at(tj))
        gt_rows.append(f"{ts}," + ",".join(repr(float(v)) for v in vals))
    (mav0 / "imu0/data.csv").write_text("\n".join(imu_rows) + "\n")
    for cam in ("cam0", "cam1"):
        (mav0 / cam / "data.csv").write_text("\n".join(img_rows) + "\n")
    (mav0 / "state_groundtruth_estimate0/data.csv").write_text("\n".join(gt_rows) + "\n")
    write_config(out / "euroc_sim.yml", cfg, mav0)
    return out / "euroc_sim.yml", mav0, n_img


def write_kitti(out, cfg: VIOConfig, duration: float, n_landmarks: int = 150, seed: int = 0,
                imu_noise: float = PROTOCOL_IMU_NOISE):
    """Render the simulated world `seed` to KITTI raw's format (the layout
    `io/kitti.py` reads): `oxts/processed/` with `timestamps.txt` and one
    `ax ay az wx wy wz` file a sample, `image_00`/`image_01` with
    `data/NNNNNNNNNN.png` and `processed_timestamps.txt`, and the
    configuration `out/kitti_sim.yml` with `maxNumImu` and `maxNumImage`.
    The replay reads rate + 1 samples an image, so the IMU runs on by one
    sample a frame. Returns (config path, dataset path, number of frames,
    ground truth [N, 4] rows (ts, x, y, z))."""
    out = Path(out)
    sim = StereoInertialSim(cfg, n_landmarks=n_landmarks, seed=seed,
                            y_max=max(11.0, 0.8 * duration + 5.0))
    oxts = out / "oxts" / "processed"
    oxts.mkdir(parents=True, exist_ok=True)
    rate = cfg.sampling_rate // cfg.camera_frequency
    n_img = int(duration * cfg.camera_frequency) + 1
    n_imu = n_img * (rate + 1) + 8
    t, gyr, acc = _imu_rows(sim, n_imu, imu_noise, seed + 10)
    (oxts / "timestamps.txt").write_text("\n".join(str(int(round(x * 1e9))) for x in t) + "\n")
    for k in range(n_imu):
        (oxts / f"{k:010d}.txt").write_text(" ".join(repr(float(v)) for v in (*acc[k], *gyr[k])))
    gt = []
    for cam in ("image_00", "image_01"):
        (out / cam / "data").mkdir(parents=True, exist_ok=True)
    for j in range(n_img):
        tj = j / cfg.camera_frequency
        for cam, img in zip(("image_00", "image_01"), sim.render(tj)):
            write_png(out / cam / "data" / f"{j:010d}.png", np.clip(img, 0, 255).astype(np.uint8))
        gt.append([int(round(tj * 1e9)), *sim.traj.pos(tj)])
    stamps = "\n".join(str(int(r[0])) for r in gt) + "\n"
    for cam in ("image_00", "image_01"):
        (out / cam / "processed_timestamps.txt").write_text(stamps)
    write_config(out / "kitti_sim.yml", cfg, out,
                 extra={"maxNumImu": n_imu, "maxNumImage": n_img})
    return out / "kitti_sim.yml", out, n_img, np.array(gt, np.float64)
