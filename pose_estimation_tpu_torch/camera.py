"""Stereo camera model: Bouguet rectification on the host, in numpy float64.

The set-up-time geometry of `pose_estimation_tpu/camera.py`, kept in the
port so that the port imports nothing of the JAX package: the rectifying
rotations and projections, the body-camera extrinsics and the dense
undistort/rectify sampling maps of the dense rectify mode
(`ops.remap.remap_bilinear`). `tests/test_torch_geometry.py` and
`tests/test_torch_remap.py` hold this model equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rodrigues(r_or_R):
    """Rotation vector <-> matrix."""
    a = np.asarray(r_or_R, dtype=np.float64)
    if a.shape in ((3,), (3, 1), (1, 3)):
        w = a.reshape(3)
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    R = a
    cos_t = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(cos_t)
    if th < 1e-12:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2 * np.sin(th))
    )
    return w * th


def _distort(x, y, dist):
    """Plumb-bob distortion of normalized coordinates."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_points(pts, K, dist, R=None, P=None, iters=5):
    """cv::undistortPoints: [N, 2] pixels -> normalized, or pixels of P."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3 = (list(np.ravel(dist)) + [0.0] * 5)[:5]
    x0 = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    if R is not None:
        v = np.asarray(R, np.float64) @ np.stack([x, y, np.ones_like(x)], axis=0)
        x, y = v[0] / v[2], v[1] / v[2]
    if P is not None:
        P = np.asarray(P, np.float64)
        return np.stack([x * P[0, 0] + P[0, 2], y * P[1, 1] + P[1, 2]], axis=1)
    return np.stack([x, y], axis=1)


def _get_rectangles(K, dist, R, P, size):
    nx, ny = size
    N = 9
    xs, ys = np.meshgrid(
        np.arange(N) * nx / (N - 1), np.arange(N) * ny / (N - 1)
    )
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    und = undistort_points(pts, K, dist, R=R, P=P).reshape(N, N, 2)
    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()
    ix0 = und[:, 0, 0].max()
    ix1 = und[:, -1, 0].min()
    iy0 = und[0, :, 1].max()
    iy1 = und[-1, :, 1].min()
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


def stereo_rectify(K1, D1, K2, D2, size, R, T, alpha=0.0):
    """cv::stereoRectify with CALIB_ZERO_DISPARITY. Returns (R1, R2, P1, P2)."""
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    nx, ny = size

    om = _rodrigues(R)
    r_r = _rodrigues(-om * 0.5)
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    uu = np.zeros(3)
    uu[idx] = 1.0 if t[idx] > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(abs(t[idx]) / np.linalg.norm(t)) / nw
    wR = _rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    fc_new = np.inf
    for K, D in ((K1, D1), (K2, D2)):
        dk1 = np.ravel(D)[0] if D is not None else 0.0
        fc = K[idx ^ 1, idx ^ 1]
        if dk1 < 0:
            fc *= 1 + dk1 * (nx * nx + ny * ny) / (4 * fc * fc)
        fc_new = min(fc_new, fc)

    cc_new = []
    for K, D, Rk in ((K1, D1, R1), (K2, D2, R2)):
        corners = np.array(
            [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float64
        )
        avg = undistort_points(corners, K, D, R=Rk).mean(axis=0) * fc_new
        cc_new.append(np.array([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]]))
    cc = (cc_new[0] + cc_new[1]) * 0.5

    def make_p():
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cc
        P[2, 2] = 1.0
        return P

    P1, P2 = make_p(), make_p()
    P2[idx, 3] = t[idx] * fc_new

    inner1, outer1 = _get_rectangles(K1, D1, R1, P1, size)
    inner2, outer2 = _get_rectangles(K2, D2, R2, P2, size)

    def s_inner(rect):
        cx, cy = cc
        x, y, w, h = rect
        return max(cx / (cx - x), cy / (cy - y),
                   (nx - cx) / (x + w - cx), (ny - cy) / (y + h - cy))

    def s_outer(rect):
        cx, cy = cc
        x, y, w, h = rect
        return min(cx / (cx - x), cy / (cy - y),
                   (nx - cx) / (x + w - cx), (ny - cy) / (y + h - cy))

    s0 = max(s_inner(inner1), s_inner(inner2))
    s1 = min(s_outer(outer1), s_outer(outer2))
    fc_new *= s0 * (1 - alpha) + s1 * alpha
    for P in (P1, P2):
        P[0, 0] = P[1, 1] = fc_new
    P2[idx, 3] = t[idx] * fc_new
    return R1, R2, P1, P2


def undistort_rectify_map(K, dist, R, P, size):
    """cv::initUndistortRectifyMap: for each rectified pixel, where to
    sample the raw image. Returns [H, W, 2] float32 (x, y)."""
    K = np.asarray(K, np.float64)
    P = np.asarray(P, np.float64)
    R = np.asarray(R, np.float64)
    nx, ny = size
    u, v = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    iR = np.linalg.inv(R)
    X = iR[0, 0] * x + iR[0, 1] * y + iR[0, 2]
    Y = iR[1, 0] * x + iR[1, 1] * y + iR[1, 2]
    W = iR[2, 0] * x + iR[2, 1] * y + iR[2, 2]
    xd, yd = _distort(X / W, Y / W, np.ravel(dist))
    map_x = xd * K[0, 0] + K[0, 2]
    map_y = yd * K[1, 1] + K[1, 2]
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Rectified-camera constants."""

    image_size: tuple[int, int]        # (width, height)
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray                     # 3x4 rectified projection, left
    P2: np.ndarray                     # 3x4 rectified projection, right
    map_left: np.ndarray               # [H, W, 2] float32 sampling map
    map_right: np.ndarray
    R_cb: np.ndarray                   # body->camera rotation
    p_cb: np.ndarray
    std_x: float
    std_y: float

    @classmethod
    def from_config(cls, cfg) -> "CameraModel":
        size = (cfg.image_width, cfg.image_height)
        R1, R2, P1, P2 = stereo_rectify(
            cfg.k_left, cfg.dist_left, cfg.k_right, cfg.dist_right,
            size, cfg.r_lr, cfg.t_lr,
        )
        u, _, vt = np.linalg.svd(np.asarray(cfg.r_cb, np.float64))
        return cls(
            image_size=size, R1=R1, R2=R2, P1=P1, P2=P2,
            map_left=undistort_rectify_map(cfg.k_left, cfg.dist_left, R1, P1, size),
            map_right=undistort_rectify_map(cfg.k_right, cfg.dist_right, R2, P2, size),
            R_cb=u @ vt, p_cb=np.asarray(cfg.t_cb, np.float64),
            std_x=cfg.std_x, std_y=cfg.std_y,
        )

    @property
    def fx(self):
        return float(self.P1[0, 0])

    @property
    def fy(self):
        return float(self.P1[1, 1])

    @property
    def cx(self):
        return float(self.P1[0, 2])

    @property
    def cy(self):
        return float(self.P1[1, 2])

    @property
    def baseline(self):
        """Rectified stereo baseline (meters, positive)."""
        return float(-self.P2[0, 3] / self.P2[0, 0])
