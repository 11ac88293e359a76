"""Analytic keypoint undistortion + rectification.

Counterpart of `pose_estimation_tpu/ops/remap.py:rectify_points` (the sparse
rectify mode: detection runs on the raw image and only the keypoint
coordinates are rectified). The dense `remap_bilinear` is not ported yet.
"""

from __future__ import annotations

import torch


def rectify_points(xy, k_raw, dist, r_rect, p_new, iters: int = 5):
    """Rectified pixels of raw-image keypoints, cv::undistortPoints' fixed-
    point compensation. xy [..., 2]; k_raw [4] = (fx, fy, cx, cy); dist [5]
    = (k1, k2, p1, p2, k3); r_rect [3, 3]; p_new [3, 4]."""
    fx, fy, cx, cy = k_raw[0], k_raw[1], k_raw[2], k_raw[3]
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x0 = (xy[..., 0] - cx) / fx
    y0 = (xy[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    v = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ r_rect.T
    xr = v[..., 0] / v[..., 2]
    yr = v[..., 1] / v[..., 2]
    return torch.stack(
        [xr * p_new[0, 0] + p_new[0, 2], yr * p_new[1, 1] + p_new[1, 2]], dim=-1
    )
