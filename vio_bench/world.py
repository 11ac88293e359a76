"""The benchmark's simulated stereo-inertial world, made from `--seed`.

A vectorized form of the port's simulator (`testing.StereoInertialSim`
with trajectory family B, `sim_frames`): landmarks in a field stretched
along the whole path, each a random 9x9 patch splatted bilinearly into
both images by max, 20 grey elsewhere; the body's gyro and specific
force by the same finite differences. Frames are rendered in blocks on
the device and kept on the host as the `uint8` arrays a replay hands to
the system (clipped to [0, 255] and truncated). It imports nothing of the
program: it is part of the yardstick.

Sample k of the IMU is at `t0 + k / rate`; frame i at sample `i * spf`
(`spf` samples a frame). Frame i's IMU chunk is the `spf` samples before
it, `[(i - 1) spf, i spf)`, which is what the state machine's queue hands
frame i when the samples are fed up to and including frame i's own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

G = 9.81
T0 = 0.5          # seconds: the time of sample 0
FIELD_Y0 = -3.0   # m: the landmark field's start along the path
SPEED_Y = 0.8     # m/s along y (family B)
NOISE_BLOCK = 4096  # IMU samples drawn from one generator


def pos(t):
    """Family B's body position [..., 3] at times t (numpy float64)."""
    t = np.asarray(t, np.float64)
    return np.stack([0.12 * np.sin(0.8 * t + 1.0), SPEED_Y * t,
                     0.45 * np.cos(0.55 * t) - 0.45], axis=-1)


def rotvec(t):
    t = np.asarray(t, np.float64)
    return np.stack([0.10 * np.sin(0.6 * t), 0.12 * np.sin(0.45 * t + 0.5),
                     0.25 * np.sin(0.3 * t)], axis=-1)


def exp_so3(rv):
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3] (Rodrigues)."""
    rv = np.asarray(rv, np.float64)
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = np.zeros(rv.shape[:-1] + (3, 3))
    k[..., 0, 1], k[..., 0, 2] = -rv[..., 2], rv[..., 1]
    k[..., 1, 0], k[..., 1, 2] = rv[..., 2], -rv[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -rv[..., 1], rv[..., 0]
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)
    b = np.where(small, 0.5, (1.0 - np.cos(ths)) / ths ** 2)
    return np.eye(3) + a * k + b * (k @ k)


def log_so3(r):
    """Rotation vectors [..., 3] of rotation matrices [..., 3, 3], by the
    quaternion (accurate at small angles)."""
    r = np.asarray(r, np.float64)
    w = 0.5 * np.sqrt(np.maximum(1.0 + np.trace(r, axis1=-2, axis2=-1), 0.0))
    v = np.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                  r[..., 1, 0] - r[..., 0, 1]], axis=-1) / np.maximum(4.0 * w, 1e-300)[..., None]
    n = np.linalg.norm(v, axis=-1)
    scale = np.where(n > 0, 2.0 * np.arctan2(n, w) / np.where(n > 0, n, 1.0), 2.0)
    return v * scale[..., None]


def rot(t):
    """Body-to-world rotations [..., 3, 3] at times t."""
    return exp_so3(rotvec(t))


def imu_at(t, g_w, dt=1e-4):
    """(gyro [..., 3], specific force [..., 3]) in the body frame at times t,
    by the simulator's finite differences."""
    t = np.asarray(t, np.float64)
    r0, r1 = rot(t), rot(t + dt)
    w = log_so3(np.swapaxes(r0, -1, -2) @ r1) / dt
    a_w = (pos(t + dt) - 2 * pos(t) + pos(t - dt)) / dt ** 2
    f = np.einsum("...ji,...j->...i", r0, a_w - g_w)
    return w, f


def vel_at(t, dt=1e-4):
    return (pos(np.asarray(t) + dt) - pos(np.asarray(t) - dt)) / (2 * dt)


SEGMENT_M = 14.0  # m of the field drawn from one generator


def landmarks(seed, n: int, y_lo: float, y_hi: float):
    """(positions [n, 3], patches [n, 9, 9]) drawn as the simulator draws
    them: x, y, z, then the patches, from `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    lm = np.stack([rng.uniform(2.5, 11.0, n), rng.uniform(y_lo, y_hi, n),
                   rng.uniform(-4.0, 4.0, n)], axis=1)
    return lm, rng.uniform(60, 255, size=(n, 9, 9))


def field(seed: int, density: float, y_max: float):
    """The landmark field from FIELD_Y0 to past y_max: segments of
    SEGMENT_M metres, segment j drawn from `default_rng([seed, 3, j])`, so
    a longer world holds a shorter one's landmarks."""
    n = int(round(density * SEGMENT_M))
    parts = [landmarks([seed, 3, j], n, FIELD_Y0 + SEGMENT_M * j, FIELD_Y0 + SEGMENT_M * (j + 1))
             for j in range(int(math.ceil((y_max - FIELD_Y0) / SEGMENT_M)))]
    return np.concatenate([a for a, _ in parts]), np.concatenate([b for _, b in parts])


class Rig:
    """What the renderer needs of a configuration: image size, the left
    camera's intrinsics (both cameras project with them, as in the
    simulator), the body-to-camera rotation and the stereo offset."""

    def __init__(self, width, height, k_left, r_cb, t_lr):
        self.width, self.height = int(width), int(height)
        self.k = np.asarray(k_left, np.float64)
        self.r_cb = np.asarray(r_cb, np.float64)
        self.t_lr = np.asarray(t_lr, np.float64).reshape(3)


def render(rig: Rig, lm, patches, times, device, quantize=True):
    """Stereo frames at `times` [T]: (left, right) [T, H, W], uint8 (or the
    float images before quantization). lm [n, 3] and patches [n, 9, 9] are
    tensors on `device` (float64)."""
    h, w = rig.height, rig.width
    t = np.asarray(times, np.float64)
    r_wb = torch.as_tensor(rot(t), device=device)                      # [T, 3, 3]
    p_wb = torch.as_tensor(pos(t), device=device)                      # [T, 3]
    r_cb = torch.as_tensor(rig.r_cb, device=device)
    fx, fy, cx, cy = (float(v) for v in (rig.k[0, 0], rig.k[1, 1], rig.k[0, 2], rig.k[1, 2]))
    big = torch.nn.functional.pad(patches, (1, 1, 1, 1))              # [n, 11, 11]
    out = []
    for cam in (0, 1):
        rel = lm[None, :, :] - p_wb[:, None, :]                        # [T, n, 3]
        x = torch.einsum("ij,tkj,tkl->tli", r_cb, r_wb, rel.transpose(1, 2))
        if cam == 1:
            x = x + torch.as_tensor(rig.t_lr, device=device)
        z = x[..., 2]
        zc = torch.clamp(z, min=0.1)
        u = fx * x[..., 0] / zc + cx
        v = fy * x[..., 1] / zc + cy
        ui, vi = torch.floor(u), torch.floor(v)
        ok = (z > 0.5) & (ui >= 7) & (ui < w - 7) & (vi >= 7) & (vi < h - 7)
        ti, li = torch.nonzero(ok, as_tuple=True)
        fx_ = (u - ui)[ti, li][:, None, None]
        fy_ = (v - vi)[ti, li][:, None, None]
        b = big[li]
        shifted = (b[:, 1:11, 1:11] * (1 - fx_) * (1 - fy_) + b[:, 1:11, 0:10] * fx_ * (1 - fy_)
                   + b[:, 0:10, 1:11] * (1 - fx_) * fy_ + b[:, 0:10, 0:10] * fx_ * fy_)
        rows = vi[ti, li].long()[:, None, None] - 4 + torch.arange(10, device=device)[None, :, None]
        cols = ui[ti, li].long()[:, None, None] - 4 + torch.arange(10, device=device)[None, None, :]
        flat = (ti[:, None, None] * h + rows) * w + cols
        img = torch.full((len(t) * h * w,), 20.0, dtype=torch.float64, device=device)
        img.scatter_reduce_(0, flat.reshape(-1), shifted.reshape(-1), reduce="amax")
        img = img.reshape(len(t), h, w)
        out.append(torch.clamp(img, 0, 255).to(torch.uint8) if quantize else img)
    return out[0], out[1]


class World:
    """Frames and IMU samples of one seed for `n_frames` frames.

    `left`, `right`: uint8 [n_frames, H, W] on the host; `gyr`, `acc`:
    float64 [n_frames * spf + 1, 3] samples with the protocol's noise
    (gyro sigma `imu_noise`, accelerometer ten times that); `chunk(i)`
    frame i's padded chunk (float32 gyr, acc [m, 3], bool mask [m]);
    `truth(i)` the true (R, p, v) at frame i."""

    def __init__(self, rig: Rig, gravity_dir, rate: int, hz: int, imu_chunk: int,
                 n_frames: int, seed: int, density: float, imu_noise: float, device,
                 block: int = 32):
        self.rig, self.rate, self.hz, self.m = rig, int(rate), int(hz), int(imu_chunk)
        if self.rate % self.hz:
            raise ValueError(f"IMU rate {rate} is not a multiple of the frame rate {hz}")
        self.spf = self.rate // self.hz
        if self.spf > self.m:
            raise ValueError(f"{self.spf} IMU samples a frame exceed the chunk of {self.m}")
        self.n_frames = int(n_frames)
        self.g_w = G * np.asarray(gravity_dir, np.float64)
        self.dt_ns = 1_000_000_000 // self.rate
        n_samples = self.n_frames * self.spf + 1
        self.sample_t = T0 + np.arange(n_samples) / self.rate
        self.frame_t = self.sample_t[::self.spf][:self.n_frames]
        lm, patches = field(seed, density, SPEED_Y * float(self.frame_t[-1]) + 8.0)
        self.n_landmarks = len(lm)
        gyr, acc = imu_at(self.sample_t, self.g_w)
        # the noise in blocks of a fixed number of samples, block j from its
        # own generator, so that a longer world holds a shorter one's
        self.gyr, self.acc = gyr.copy(), acc.copy()
        for lo in range(0, n_samples, NOISE_BLOCK):
            nrng = np.random.default_rng([seed, 1, lo // NOISE_BLOCK])
            hi = min(lo + NOISE_BLOCK, n_samples)
            self.gyr[lo:hi] += nrng.normal(0, imu_noise, (NOISE_BLOCK, 3))[:hi - lo]
            self.acc[lo:hi] += nrng.normal(0, imu_noise * 10, (NOISE_BLOCK, 3))[:hi - lo]
        dev = torch.device(device)
        lm_d = torch.as_tensor(lm, device=dev)
        pa_d = torch.as_tensor(patches, device=dev)
        h, w = rig.height, rig.width
        self.left = np.empty((self.n_frames, h, w), np.uint8)
        self.right = np.empty((self.n_frames, h, w), np.uint8)
        for lo in range(0, self.n_frames, block):
            hi = min(lo + block, self.n_frames)
            l_, r_ = render(rig, lm_d, pa_d, self.frame_t[lo:hi], dev)
            self.left[lo:hi] = l_.cpu().numpy()
            self.right[lo:hi] = r_.cpu().numpy()
        # the padded chunks of every frame, as the batched replay takes them
        self.gyr_chunks = np.zeros((self.n_frames, self.m, 3), np.float32)
        self.acc_chunks = np.zeros((self.n_frames, self.m, 3), np.float32)
        for i in range(1, self.n_frames):
            lo = (i - 1) * self.spf
            self.gyr_chunks[i, :self.spf] = self.gyr[lo:lo + self.spf]
            self.acc_chunks[i, :self.spf] = self.acc[lo:lo + self.spf]
        self.mask = np.arange(self.m) < self.spf

    def sample_ns(self, k: int) -> int:
        return int(round(T0 * 1e9)) + k * self.dt_ns

    def frame_ns(self, i: int) -> int:
        return self.sample_ns(i * self.spf)

    def samples_before(self, i: int) -> range:
        """The samples to feed before frame i (up to and including its own;
        frame 0 takes its own alone)."""
        return range(max(i - 1, 0) * self.spf + (1 if i else 0), i * self.spf + 1)

    def chunk(self, i: int):
        return self.gyr_chunks[i], self.acc_chunks[i], self.mask

    def truth(self, i: int):
        t = self.frame_t[i]
        return rot(t), pos(t), vel_at(t)
