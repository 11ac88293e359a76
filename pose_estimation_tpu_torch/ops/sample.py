"""Per-keypoint descriptor sampling: kernel K2 and its twin.

Counterpart of `pose_estimation_tpu/ops/pallas_sample.py`. For each
keypoint on a level canvas: the 43x43 raw patch of the canvas padded by
2 px (reflect-101) with its origin clamped inside, the intensity-centroid
moments m10, m01 over the radius-15 circle, the rotation (cos, sin) =
(m10, m01) / r without transcendentals, and the 256 pool points rotated,
rounded half to even and sampled on the 7x7 sigma=2 Gaussian-blurred patch,
the blur folded into separable taps exp(-d^2/8)/norm. All in float32.

`sample_patches` samples every keypoint of every pyramid level of every
image in one launch of `csrc/sample_patches.cu`, reading the level-major
plane stack and reflecting at each plane's content edge (all images of a
level share one content size); on a CPU tensor it runs the all-levels twin
`sample_stack_plain`, which runs the per-level twin `sample_patches_plain`
on each plane's content.
"""

from __future__ import annotations

import functools

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
    """Per-level twin of kernel K2. canvas [N, H, W] f32 (the content of N
    planes), plane [K] int, xy [K, 2], pool_xy [P, 2] -> (vals [K, P],
    m10 [K], m01 [K])."""
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


@functools.lru_cache(maxsize=16)
def _launch_table(budgets: tuple, bounds: tuple):
    """(table, its address): int32 [n_levels + 1 + 2 * n_planes], the level
    offsets, then every plane's content height, then its width, as the
    kernel reads them. Cached per extractor shape: numpy's `.ctypes` costs
    microseconds of host time on every launch otherwise."""
    table = np.concatenate([level_offsets(budgets), [d[0] for d in bounds],
                            [d[1] for d in bounds]]).astype(np.int32)
    return table, table.ctypes.data


_TAPS_PTR = TAPS.ctypes.data


def sample_stack_plain(stack: torch.Tensor, bounds, xy: torch.Tensor, budgets,
                       pool_xy: torch.Tensor) -> torch.Tensor:
    """Twin of kernel K2 over all levels: `sample_patches_plain` on each
    plane's content `stack[plane, :lh, :lw]` for the slots on that plane.
    stack [n_levels * B, H, W], bounds [(lh, lw)] per plane, xy [B, K_tot,
    2] plane-local, budgets per level -> packed [B, K_tot, P + 2] (the P
    samples, m10, m01)."""
    b, k_tot = xy.shape[0], xy.shape[1]
    n_pool = pool_xy.shape[0]
    plane = slot_planes(b, budgets, stack.device)
    xy = xy.reshape(b * k_tot, 2)
    out = torch.empty((b * k_tot, n_pool + 2), dtype=stack.dtype, device=stack.device)
    for p, (lh, lw) in enumerate(bounds):
        sel = torch.nonzero(plane == p).squeeze(1)
        vals, m10, m01 = sample_patches_plain(
            stack[p:p + 1, :lh, :lw], torch.zeros_like(sel), xy[sel], pool_xy)
        out[sel] = torch.cat([vals, m10[:, None], m01[:, None]], 1)
    return out.reshape(b, k_tot, n_pool + 2)


def sample_patches(stack: torch.Tensor, bounds, xy: torch.Tensor, budgets,
                   pool_xy: torch.Tensor) -> torch.Tensor:
    """Kernel K2: IC moments + rotated, blurred pool-point samples of every
    keypoint of every level of every image, one launch. stack [n_levels *
    B, H, W] (the level-major zero-padded plane stack of
    `orb.plane_stack`), bounds [(lh, lw)] per plane, equal within a level
    (the kernel keeps a row per level, so B is unbounded), xy [B, K_tot, 2]
    plane-local keypoints, level l
    owning slots `level_offsets(budgets)[l:l + 2]` of each image, pool_xy
    [P, 2] -> packed [B, K_tot, P + 2] float32 (the P samples, m10, m01).

    Replaces the TPU kernel `pose_estimation_tpu/ops/pallas_sample.py:
    _kernel` (via `sample_patches_pallas`, called per level). On the H100
    its bounds (a 7.4 KB gather and ~25k multiply-adds per keypoint) are a
    few microseconds; what costs is a block's latency and each launch's
    host work. One block per keypoint stages its patch by rows, sums the
    moments while staging and reduces them by warp shuffles, then samples
    one pool point per thread, writing straight into the packed layout. A
    CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `sample_stack_plain`."""
    if not stack.is_cuda:
        return sample_stack_plain(stack, bounds, xy, budgets, pool_xy)
    table, table_ptr = _launch_table(tuple(budgets), tuple(bounds))
    b, k_tot = xy.shape[0], xy.shape[1]
    for name, t in (("stack", stack), ("xy", xy), ("pool_xy", pool_xy)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != stack.device:
            raise ValueError(f"sample_patches: {name} must be contiguous float32 on "
                             f"{stack.device}")
    n, h, w = stack.shape
    if (xy.ndim != 3 or xy.shape[2] != 2 or k_tot != table[len(budgets)]
            or n != len(budgets) * b or len(bounds) != n or pool_xy.ndim != 2
            or pool_xy.shape[1] != 2):
        raise ValueError("sample_patches: bad shapes")
    n_pool = pool_xy.shape[0]
    out = torch.empty((b, k_tot, n_pool + 2), dtype=torch.float32, device=stack.device)
    err = kernels.library().sample_patches_launch(
        stack.data_ptr(), xy.data_ptr(), pool_xy.data_ptr(), _TAPS_PTR, table_ptr,
        out.data_ptr(), b, k_tot, len(budgets), h, w, n_pool,
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    kernels.check(err, "sample_patches")
    sample_patches.launches += 1
    return out


sample_patches.launches = 0
