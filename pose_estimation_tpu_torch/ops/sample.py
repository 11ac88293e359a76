"""Per-keypoint descriptor sampling: kernel K2 and its twin.

Counterpart of `pose_estimation_tpu/ops/pallas_sample.py`. For each
keypoint on a level canvas: the 43x43 raw patch of the canvas padded by
2 px (reflect-101) with its origin clamped inside, the intensity-centroid
moments m10, m01 over the radius-15 circle, the rotation (cos, sin) =
(m10, m01) / r without transcendentals, and the 256 pool points rotated,
rounded half to even and sampled on the 7x7 sigma=2 Gaussian-blurred patch,
the blur folded into separable taps exp(-d^2/8)/norm. All in float32.

`sample_patches` launches `csrc/sample_patches.cu` on a CUDA tensor and
runs the twin `sample_patches_plain` only on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.ops import kernels

PATCH_R = 15       # orientation circle radius
REACH = 21         # rotated pool reach 13*sqrt(2) -> 18, + blur radius 3
PS = 2 * REACH + 1  # 43: raw patch side
PAD = 2            # reflect-101 canvas pad

_d = np.arange(-3, 4, dtype=np.float32)
_norm = np.float32(1.0 / float(np.sum(np.exp(-np.arange(-3, 4) ** 2 / 8.0))))
TAPS = (np.exp(_d * _d * np.float32(-1.0 / 8.0)) * _norm).astype(np.float32)


def sample_patches_plain(canvas: torch.Tensor, plane: torch.Tensor,
                         xy: torch.Tensor, pool_xy: torch.Tensor):
    """Twin of kernel K2. canvas [N, H, W] f32, plane [K] int, xy [K, 2],
    pool_xy [P, 2] -> (vals [K, P], m10 [K], m01 [K])."""
    n, h, w = canvas.shape
    dev, dt = canvas.device, canvas.dtype
    hp, wp = h + 2 * PAD, w + 2 * PAD
    padded = torch.nn.functional.pad(
        canvas[:, None], (PAD, PAD, PAD, PAD), mode="reflect"
    )[:, 0]
    # zero fill past the reflect pad, read only by planes smaller than a patch
    padded = torch.nn.functional.pad(
        padded, (0, max(wp, PS) - wp, 0, max(hp, PS) - hp)
    )
    # patch origin in the padded canvas, clamped so the patch stays inside
    cx = torch.round(xy[:, 0]).to(torch.int64)
    cy = torch.round(xy[:, 1]).to(torch.int64)
    y0 = torch.clamp(cy + PAD - REACH, 0, max(hp - PS, 0))
    x0 = torch.clamp(cx + PAD - REACH, 0, max(wp - PS, 0))
    r = torch.arange(PS, device=dev)
    patch = padded[
        plane.to(torch.int64)[:, None, None],
        (y0[:, None] + r)[:, :, None],
        (x0[:, None] + r)[:, None, :],
    ]                                                    # [K, 43, 43]
    d = r.to(dt) - REACH
    circ = d[:, None] ** 2 + d[None, :] ** 2 <= PATCH_R * PATCH_R
    m10 = (patch * torch.where(circ, d[None, :], 0.0)).sum(-1).sum(-1)
    m01 = (patch * torch.where(circ, d[:, None], 0.0)).sum(-1).sum(-1)

    inv = 1.0 / torch.sqrt(torch.clamp(m10 * m10 + m01 * m01, min=1e-12))
    ca = (m10 * inv)[:, None]
    sa = (m01 * inv)[:, None]
    px, py = pool_xy[None, :, 0], pool_xy[None, :, 1]
    col = torch.round(px * ca - py * sa).clamp(-18, 18).to(torch.int64) + REACH
    row = torch.round(px * sa + py * ca).clamp(-18, 18).to(torch.int64) + REACH

    o = torch.arange(-3, 4, device=dev)
    k = torch.arange(patch.shape[0], device=dev)[:, None, None, None]
    win = patch[
        k, (row[:, :, None, None] + o[:, None]), (col[:, :, None, None] + o[None, :])
    ]                                                    # [K, P, 7r, 7c]
    taps = torch.as_tensor(TAPS, device=dev)
    t1 = (win * taps[:, None]).sum(2)                    # rows first, [K, P, 7c]
    vals = (t1 * taps).sum(-1)
    return vals, m10, m01


def sample_patches(canvas: torch.Tensor, plane: torch.Tensor,
                   xy: torch.Tensor, pool_xy: torch.Tensor):
    """Kernel K2: IC moments + rotated, blurred pool-point samples.

    Replaces the TPU kernel `pose_estimation_tpu/ops/pallas_sample.py:
    _kernel` (via `sample_patches_pallas`). On the H100 it is bound by the
    per-sample arithmetic (49 taps for each of 256 points, ~25k FMAs per
    keypoint) on a small, L2-resident gather (a 7.4 KB patch per keypoint);
    one block per keypoint stages its patch in shared memory once, reduces
    the moments there and gives each thread one pool point, so nothing but
    the 258 outputs per keypoint reaches device memory. A CUDA tensor
    launches the kernel (or raises); a CPU tensor runs the twin."""
    if not canvas.is_cuda:
        return sample_patches_plain(canvas, plane, xy, pool_xy)
    n, h, w = canvas.shape
    k = xy.shape[0]
    for name, t, dt in (("canvas", canvas, torch.float32), ("plane", plane, torch.int32),
                        ("xy", xy, torch.float32), ("pool_xy", pool_xy, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != canvas.device:
            raise ValueError(f"sample_patches: {name} must be contiguous {dt} on {canvas.device}")
    if plane.shape != (k,) or xy.shape != (k, 2) or pool_xy.ndim != 2 or pool_xy.shape[1] != 2:
        raise ValueError("sample_patches: bad shapes")
    n_pool = pool_xy.shape[0]
    vals = torch.empty((k, n_pool), dtype=torch.float32, device=canvas.device)
    m10 = torch.empty((k,), dtype=torch.float32, device=canvas.device)
    m01 = torch.empty_like(m10)
    if k == 0:
        return vals, m10, m01
    err = kernels.library().sample_patches_launch(
        canvas.data_ptr(), plane.data_ptr(), xy.data_ptr(), pool_xy.data_ptr(),
        TAPS.ctypes.data, vals.data_ptr(), m10.data_ptr(), m01.data_ptr(),
        k, n_pool, n, h, w, torch.cuda.current_stream(canvas.device).cuda_stream,
    )
    kernels.check(err, "sample_patches")
    sample_patches.launches += 1
    return vals, m10, m01


sample_patches.launches = 0
