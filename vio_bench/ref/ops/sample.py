"""Per-keypoint descriptor sampling: kernel K2 and its twin.

Counterpart of `pose_estimation_tpu/ops/pallas_sample.py`. For each
keypoint on a level canvas: the 43x43 raw patch of the canvas padded by
2 px (reflect-101) with its origin clamped inside, the intensity-centroid
moments m10, m01 over the radius-15 circle, the rotation (cos, sin) =
(m10, m01) / r without transcendentals, and the 256 pool points rotated,
rounded half to even and sampled on the 7x7 sigma=2 Gaussian-blurred patch,
the blur folded into separable taps exp(-d^2/8)/norm. All in float32.

In the reference `sample_patches` computes kernel K2's results
(`csrc/sample_patches.cu`) in plain PyTorch: `sample_stack_plain` runs
`sample_patches_exact`, which follows the kernel's order of arithmetic,
on each level's planes.
"""

from __future__ import annotations

import numpy as np
import torch


PATCH_R = 15       # orientation circle radius
REACH = 21         # rotated pool reach 13*sqrt(2) -> 18, + blur radius 3
PS = 2 * REACH + 1  # 43: raw patch side
PAD = 2            # reflect-101 canvas pad

_d = np.arange(-3, 4, dtype=np.float32)
_norm = np.float32(1.0 / float(np.sum(np.exp(-np.arange(-3, 4) ** 2 / 8.0))))
TAPS = (np.exp(_d * _d * np.float32(-1.0 / 8.0)) * _norm).astype(np.float32)


# The kernel's order of arithmetic (`csrc/sample_patches.cu`): 8 warps of
# 32 lanes; warp w stages the patch rows w, w + 8, ... and lane l the
# columns l and l + 32, each adding v * dx (v * dy) into its own partial by
# a fused multiply-add; the partials reduced by the butterfly of
# `__shfl_xor_sync` (offsets 16, 8, 4, 2, 1), the warps' sums added in
# order; the blur's sums fused multiply-adds, rows first. A fused
# multiply-add rounds once: here its product and sum are formed exactly in
# float64 and rounded to float32.
WARPS, LANES = 8, 32
KEYPOINTS_A_BLOCK = 4096


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def sample_patches_exact(canvas: torch.Tensor, plane: torch.Tensor,
                         xy: torch.Tensor, pool_xy: torch.Tensor):
    """K2's semantics on the planes `canvas` [N, H, W] (their content) for
    the keypoints xy [K, 2] on planes `plane` [K] -> (vals [K, P], m10 [K],
    m01 [K]), by K2's order of arithmetic, so that the results are K2's bit
    for bit (the port's twin sums in another order, and a moment that
    rounds apart can move a rotated sample by a pixel). Keypoints in blocks
    of KEYPOINTS_A_BLOCK."""
    if xy.shape[0] > KEYPOINTS_A_BLOCK:
        parts = [sample_patches_exact(canvas, plane[lo:lo + KEYPOINTS_A_BLOCK],
                                      xy[lo:lo + KEYPOINTS_A_BLOCK], pool_xy)
                 for lo in range(0, xy.shape[0], KEYPOINTS_A_BLOCK)]
        return tuple(torch.cat(a) for a in zip(*parts))
    n, h, w = canvas.shape
    dev, dt = canvas.device, canvas.dtype
    hp, wp = h + 2 * PAD, w + 2 * PAD
    padded = torch.nn.functional.pad(canvas[:, None], (PAD, PAD, PAD, PAD), mode="reflect")[:, 0]
    padded = torch.nn.functional.pad(padded, (0, max(wp, PS) - wp, 0, max(hp, PS) - hp))
    cx = torch.round(xy[:, 0]).to(torch.int64)
    cy = torch.round(xy[:, 1]).to(torch.int64)
    y0 = torch.clamp(cy + PAD - REACH, 0, max(hp - PS, 0))
    x0 = torch.clamp(cx + PAD - REACH, 0, max(wp - PS, 0))
    r = torch.arange(PS, device=dev)
    patch = padded[plane.to(torch.int64)[:, None, None], (y0[:, None] + r)[:, :, None],
                   (x0[:, None] + r)[:, None, :]]                # [K, 43, 43]
    k = patch.shape[0]

    # the moments: each lane's partial over its rows, in its order
    s10 = torch.zeros((k, WARPS, LANES), dtype=dt, device=dev)
    s01 = torch.zeros_like(s10)
    lanes = torch.arange(LANES, device=dev)
    for step in range(-(-PS // WARPS)):
        rows = torch.arange(WARPS, device=dev) + step * WARPS    # [8]
        live_r = rows < PS
        rr = rows.clamp(max=PS - 1)
        dy = (rr - REACH).to(dt)
        for c in (lanes, lanes + LANES):
            live = live_r[:, None] & (c < PS)[None, :]
            cc = c.clamp(max=PS - 1)
            dx = (cc - REACH).to(dt)
            circ = live & (dx[None, :] ** 2 + dy[:, None] ** 2 <= PATCH_R * PATCH_R)
            v = patch[:, rr[:, None], cc[None, :]]               # [K, 8, 32]
            s10 = torch.where(circ, _fma(v, dx[None, None, :], s10), s10)
            s01 = torch.where(circ, _fma(v, dy[None, :, None], s01), s01)
    for o in (16, 8, 4, 2, 1):
        s10 = s10 + s10[:, :, lanes ^ o]
        s01 = s01 + s01[:, :, lanes ^ o]
    m10 = torch.zeros(k, dtype=dt, device=dev)
    m01 = torch.zeros_like(m10)
    for wi in range(WARPS):
        m10 = m10 + s10[:, wi, 0]
        m01 = m01 + s01[:, wi, 0]

    inv = 1.0 / torch.sqrt(torch.clamp(m10 * m10 + m01 * m01, min=1e-12))
    ca = (m10 * inv)[:, None]
    sa = (m01 * inv)[:, None]
    px, py = pool_xy[None, :, 0], pool_xy[None, :, 1]
    col = torch.round(px * ca - py * sa).clamp(-18, 18).to(torch.int64) + REACH
    row = torch.round(px * sa + py * ca).clamp(-18, 18).to(torch.int64) + REACH

    taps = torch.as_tensor(TAPS, device=dev)
    ki = torch.arange(k, device=dev)[:, None]
    acc = torch.zeros(row.shape, dtype=dt, device=dev)
    for dc in range(7):
        t1 = torch.zeros_like(acc)
        for dr in range(7):
            t1 = _fma(patch[ki, row - 3 + dr, col - 3 + dc], taps[dr], t1)
        acc = _fma(t1, taps[dc], acc)
    return acc, m10, m01


def level_offsets(budgets) -> np.ndarray:
    """[n_levels + 1] int32: the first slot of each level within an image's
    K_tot = sum(budgets) keypoint slots (levels in ascending order), then
    K_tot."""
    return np.concatenate([[0], np.cumsum(budgets)]).astype(np.int32)


def slot_planes(b: int, budgets, device) -> torch.Tensor:
    """[b * K_tot] int64: the plane of the level-major stack that each
    keypoint slot lies on, by the kernel's arithmetic: slot t = image *
    K_tot + k is on level l where off[l] <= k < off[l + 1], plane l * b +
    image."""
    off = torch.as_tensor(level_offsets(budgets), device=device, dtype=torch.int64)
    t = torch.arange(b * int(off[-1]), device=device)
    image, k = t // off[-1], t % off[-1]
    level = torch.searchsorted(off[1:], k, right=True)
    return level * b + image


def sample_stack_plain(stack: torch.Tensor, bounds, xy: torch.Tensor, budgets,
                       pool_xy: torch.Tensor) -> torch.Tensor:
    """Kernel K2 over all levels by `sample_patches_exact`, a level's planes
    at once (they share their content size). stack [n_levels * B, H, W],
    bounds [(lh, lw)] per plane, xy [B, K_tot, 2] plane-local, budgets per
    level -> packed [B, K_tot, P + 2] (the P samples, m10, m01)."""
    b, k_tot = xy.shape[0], xy.shape[1]
    n_pool = pool_xy.shape[0]
    plane = slot_planes(b, budgets, stack.device)
    xy = xy.reshape(b * k_tot, 2)
    out = torch.empty((b * k_tot, n_pool + 2), dtype=stack.dtype, device=stack.device)
    for lvl in range(len(budgets)):
        lh, lw = bounds[lvl * b]
        sel = torch.nonzero(plane // b == lvl).squeeze(1)
        vals, m10, m01 = sample_patches_exact(stack[lvl * b:(lvl + 1) * b, :lh, :lw],
                                              plane[sel] - lvl * b, xy[sel], pool_xy)
        out[sel] = torch.cat([vals, m10[:, None], m01[:, None]], 1)
    return out.reshape(b, k_tot, n_pool + 2)


def sample_patches(stack: torch.Tensor, bounds, xy: torch.Tensor, budgets,
                   pool_xy: torch.Tensor) -> torch.Tensor:
    """Kernel K2's results by `sample_stack_plain`: packed [B, K_tot,
    P + 2] float32 (the P samples, m10, m01)."""
    return sample_stack_plain(stack, bounds, xy, budgets, pool_xy)


