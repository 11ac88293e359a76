"""Absolute trajectory error (ATE RMSE) with Umeyama SE(3)+scale alignment.

A copy of `pose_estimation_tpu/io/ate.py` (plain numpy), kept in the port
so that the port and its GPU smoke test import nothing of the JAX package;
`tests/test_torch_slam.py` holds the copy equal to the original. The
reference only dumps `states.csv` for offline comparison
(`visual-inertial-slam.cpp:175-204`); this provides the standard evaluation
(associate by timestamp, align, RMSE).
"""

from __future__ import annotations

import numpy as np


def associate(est: np.ndarray, gt: np.ndarray, max_dt_ns: float = 20e6):
    """est, gt: [N,4] (ts, x, y, z). Returns matched (est_xyz, gt_xyz)."""
    gt_ts = gt[:, 0]
    idx = np.searchsorted(gt_ts, est[:, 0])
    idx = np.clip(idx, 1, len(gt_ts) - 1)
    left = idx - 1
    pick = np.where(
        np.abs(gt_ts[idx] - est[:, 0]) < np.abs(gt_ts[left] - est[:, 0]),
        idx, left,
    )
    ok = np.abs(gt_ts[pick] - est[:, 0]) < max_dt_ns
    return est[ok, 1:4], gt[pick[ok], 1:4]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform src -> dst. Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s_mat) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """est, gt: [N,4] (ts, x, y, z) trajectories. Returns RMSE in meters."""
    e, g = associate(est, gt)
    if len(e) < 3:
        return float("inf")
    if align:
        s, r, t = umeyama(e, g, with_scale)
        e = (s * (r @ e.T)).T + t
    err = np.linalg.norm(e - g, axis=1)
    return float(np.sqrt((err**2).mean()))
