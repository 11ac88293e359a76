"""Undistortion + rectification: of keypoints, or of whole frames.

Counterpart of `pose_estimation_tpu/ops/remap.py`. `rectify_points` serves
the sparse rectify mode (detection runs on the raw image and only the
keypoint coordinates are rectified); `remap_bilinear` the dense mode (the
frames are resampled through the maps of `camera.undistort_rectify_map`
before detection, cv::remap with INTER_LINEAR and a constant 0 border).
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


def remap_bilinear(img: torch.Tensor, mapxy: torch.Tensor) -> torch.Tensor:
    """Sample img [..., H, W] (any dtype) at the float (x, y) source
    coordinates mapxy [Ho, Wo, 2] -> [..., Ho, Wo] float32, bilinear, 0
    outside the image. A batched map [B, Ho, Wo, 2] with img [B, H, W]
    gives each image its own map (the stereo pair)."""
    h, w = img.shape[-2], img.shape[-1]
    x, y = mapxy[..., 0], mapxy[..., 1]
    paired = img.ndim == 3 and mapxy.ndim == 4 and img.shape[0] == mapxy.shape[0]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0).to(torch.float32), (y - y0).to(torch.float32)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(*img.shape[:-2], h * w)

    def gather(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        if paired:
            vals = torch.gather(flat, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
        else:
            vals = flat[..., idx.reshape(-1)].reshape(*img.shape[:-2], *xi.shape)
        return torch.where(inb, vals.to(torch.float32), 0.0)

    v00, v01 = gather(y0i, x0i), gather(y0i, x0i + 1)
    v10, v11 = gather(y0i + 1, x0i), gather(y0i + 1, x0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy
