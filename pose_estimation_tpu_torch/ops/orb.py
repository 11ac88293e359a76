"""Oriented binary descriptors over an image pyramid ("ORB" front-end).

Counterpart of `pose_estimation_tpu/ops/orb.py:extract_batch`, both of its
front ends. Shared by both: content-shaped bilinear pyramid products, one
level-major zero-padded plane stack, detection, the pool difference product
and its sign.

- **Detection** (`OrbConfig.fast_backend`). `"pallas"`: kernel K1
  (`fast.fast_select`) plus the plane top-k when the width is a multiple of
  16, otherwise kernel K3 (`fast.fast_score_nms`) followed by
  `fast.select_keypoints_batched` (KITTI's 1242-px frames take K3).
  `"xla"`: the plain `fast.fast_score` and `select_keypoints_batched` with
  its own NMS.
- **Description** (`OrbConfig.sample_backend`). `"pallas"`, the kernel
  path: kernel K2 (`sample.sample_patches`), one launch over the plane
  stack for every level, each plane reflected at its content edge (as the
  JAX package's per-level calls on the content-shaped levels), then
  `atan2` of its moments.
  `"xla"`, the map path: the intensity-centroid angle from the plane stack
  by `OrbConfig.moments_backend`, a 7x7 Gaussian blur of the whole stack
  (`gaussian_blur7`, reflected at the canvas edge, so upper levels blur
  into their zero padding) and the rotated pool gather
  (`brief_descriptors_pool`). `moments_backend` is `"sparse"` (two prefix
  images sampled at the keypoints, `ic_angle_sparse`), `"integral"` (full
  moment maps in plain torch, `moments.moment_maps_plain`) or `"pallas"`
  (full moment maps by kernel K4, `moments.moment_maps`).

The defaults are the kernel path, which is what `vio.build_constants`
resolves `"auto"` to. On a CPU tensor every kernel runs as its torch twin,
with the same semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch.ops import fast as fast_mod
from pose_estimation_tpu_torch.ops import moments as moments_mod
from pose_estimation_tpu_torch.ops import sample as sample_mod
from pose_estimation_tpu_torch.ops.brief_pattern import POOL_PAIRS, POOL_POINTS

EDGE = 19
N_PAIRS = 256

# bit i = I[pool[a_i]] < I[pool[b_i]]  <=>  (vals @ DIFF)[i] > 0
_DIFF = np.zeros((len(POOL_POINTS), N_PAIRS), np.float32)
_DIFF[POOL_PAIRS[:, 1], np.arange(N_PAIRS)] = 1.0
_DIFF[POOL_PAIRS[:, 0], np.arange(N_PAIRS)] = -1.0


class OrbConfig(NamedTuple):
    n_features: int = 800
    n_levels: int = 8
    scale: float = 1.2
    th_hi: float = 20.0
    th_lo: float = 7.0
    k_per_cell: int = 4   # selection cells are 16x16 (fast.CELL)
    fast_backend: str = "pallas"     # "pallas" (K1 or K3) or "xla" (plain torch)
    sample_backend: str = "pallas"   # "pallas" (K2) or "xla" (the map path)
    # IC angle of the map path: "sparse", "integral" or "pallas" (K4)
    moments_backend: str = "sparse"


class OrbConstants(NamedTuple):
    """Device tensors of the extractor, built once per image size."""

    pyr: tuple              # per level >= 1: (rows [lh, H], cols [W, lw])
    pool_xy: torch.Tensor   # [P, 2] f32
    diff: torch.Tensor      # [P, 256] f32


class OrbFeatures(NamedTuple):
    xy: torch.Tensor      # [K, 2] level-0 pixel coords
    angle: torch.Tensor   # [K] radians
    score: torch.Tensor   # [K]
    level: torch.Tensor   # [K] int32
    desc: torch.Tensor    # [K, 256] int8 {-1, +1}
    valid: torch.Tensor   # [K] bool


def level_budgets(cfg: OrbConfig) -> list[int]:
    """Per-level feature budgets, geometric decay."""
    inv = 1.0 / cfg.scale
    raw = [inv**lvl for lvl in range(cfg.n_levels)]
    s = sum(raw)
    return [max(8, int(round(cfg.n_features * r / s))) for r in raw]


def pyramid_shapes(h: int, w: int, cfg: OrbConfig) -> list[tuple[int, int]]:
    """Per-level content sizes (level 0 = full resolution)."""
    shapes = [(h, w)]
    for lvl in range(1, cfg.n_levels):
        lh = max(int(round(h / cfg.scale**lvl)), 2 * EDGE + 8)
        lw = max(int(round(w / cfg.scale**lvl)), 2 * EDGE + 8)
        shapes.append((lh, lw))
    return shapes


def _bilinear_rows(n_out: int, n_canvas: int, n_in: int) -> np.ndarray:
    """[n_canvas, n_in] cv::resize INTER_LINEAR weights; rows >= n_out zero."""
    m = np.zeros((n_canvas, n_in), np.float32)
    r = np.arange(n_out)
    src = np.clip((r + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    t = (src - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, n_in - 1)
    np.add.at(m, (r, i0), 1.0 - t)
    np.add.at(m, (r, i1), t)
    return m


def build_orb_constants(h: int, w: int, cfg: OrbConfig, device) -> OrbConstants:
    pyr = tuple(
        (torch.as_tensor(_bilinear_rows(lh, lh, h), device=device),
         torch.as_tensor(_bilinear_rows(lw, lw, w).T.copy(), device=device))
        for lh, lw in pyramid_shapes(h, w, cfg)[1:]
    )
    return OrbConstants(
        pyr=pyr,
        pool_xy=torch.as_tensor(POOL_POINTS.astype(np.float32), device=device),
        diff=torch.as_tensor(_DIFF, device=device),
    )


def pyramid_levels(imgs: torch.Tensor, oc: OrbConstants) -> list:
    """[B, H, W] -> per-level content-shaped [[B, lh, lw], ...] (full f32:
    TF32 is off, see utils.precision)."""
    parts = [imgs]
    for ra, ca in oc.pyr:
        parts.append(torch.matmul(torch.matmul(ra, imgs), ca))
    return parts


def plane_stack(imgs: torch.Tensor, cfg: OrbConfig, oc: OrbConstants):
    """(stack, bounds): the level-major zero-padded plane stack [n_levels *
    B, H, W] of the content-shaped levels, which kernels K1-K4 read, and
    each plane's content size."""
    b, h, w = imgs.shape
    stack = torch.cat(
        [torch.nn.functional.pad(lv, (0, w - lv.shape[2], 0, h - lv.shape[1]))
         for lv in pyramid_levels(imgs, oc)], dim=0,
    )
    shapes = pyramid_shapes(h, w, cfg)
    return stack, [shapes[p // b] for p in range(cfg.n_levels * b)]


_BLUR = np.exp(-np.arange(-3, 4) ** 2 / 8.0)
_BLUR = (_BLUR / _BLUR.sum()).astype(np.float32)


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma=2 Gaussian over the last two axes, reflect-101
    at the edges of the array (cv::GaussianBlur), rows first."""
    def conv1d(x, axis):
        x = x.movedim(axis, -1)
        n = x.shape[-1]
        pad = torch.cat([x[..., 1:4].flip(-1), x, x[..., -4:-1].flip(-1)], dim=-1)
        out = pad[..., 0:n] * float(_BLUR[0])
        for i in range(1, 7):
            out = out + pad[..., i:i + n] * float(_BLUR[i])
        return out.movedim(-1, axis)

    return conv1d(conv1d(img, -2), -1)


def ic_angle_sparse(stack: torch.Tensor, base: torch.Tensor, xy: torch.Tensor):
    """Intensity-centroid angles [K] from the two row prefix images of the
    zero-meaned stack [N, H, W], sampled at the keypoints: per circle row
    the prefix values at the two ends of its segment, 4 x 31 gathered
    elements a keypoint, and no moment map (the decomposition is that of
    `moments.moment_maps_plain`; the prefix sums and their differences in
    float64, `moments.prefix_sums`). base [K]: flat plane offsets (plane *
    H * W); xy [K, 2]: plane-local pixels, clamped 16 px inside the canvas."""
    h, w = stack.shape[-2], stack.shape[-1]
    r_ = moments_mod.PATCH_R
    dt = stack.dtype
    p, q, _ = moments_mod.prefix_sums(moments_mod.zero_mean(stack))
    p, q = p.reshape(-1), q.reshape(-1)

    cx = torch.round(xy[..., 0]).to(torch.int64).clamp(r_ + 1, w - 1 - r_)
    cy = torch.round(xy[..., 1]).to(torch.int64).clamp(r_, h - 1 - r_)
    dys, rs = moments_mod.circle_rows(stack.device)
    rows = base[:, None] + (cy[:, None] + dys[None, :]) * w     # [K, 31]
    hi = rows + cx[:, None] + rs[None, :]
    lo = rows + cx[:, None] - rs[None, :] - 1
    box64 = p[hi] - p[lo]
    xck = cx.to(torch.float64)[:, None] - w / 2.0
    ramp = ((q[hi] - q[lo]) - xck * box64).to(dt)
    box = box64.to(dt)
    m10 = ramp.sum(dim=1)
    m01 = (dys.to(dt)[None, :] * box).sum(dim=1)
    return torch.atan2(m01, m10)


def brief_descriptors_pool(blur_flat, base, xy, angle, h: int, w: int,
                           oc: OrbConstants) -> torch.Tensor:
    """Pool-constrained rotated BRIEF, {-1, +1} int8 [K, 256]: the pool
    points rotated by the keypoint angle, rounded half to even and clamped
    to the canvas, gathered from the flattened blurred stack, then the
    difference product (float32, TF32 off) and its sign."""
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    cx = torch.round(xy[:, 0]).to(torch.int64)[:, None]
    cy = torch.round(xy[:, 1]).to(torch.int64)[:, None]
    px, py = oc.pool_xy[None, :, 0], oc.pool_xy[None, :, 1]
    col = torch.round(px * ca - py * sa).to(torch.int64)
    row = torch.round(px * sa + py * ca).to(torch.int64)
    xx = (cx + col).clamp(0, w - 1)
    yy = (cy + row).clamp(0, h - 1)
    vals = blur_flat[base[:, None] + yy * w + xx]
    return torch.where(vals @ oc.diff > 0, 1, -1).to(torch.int8)


def detect(stack: torch.Tensor, bounds, cfg: OrbConfig, k_max: int) -> fast_mod.Keypoints:
    """[N, k_max] keypoints per plane of the stack, by `cfg.fast_backend`."""
    select = dict(border=EDGE, k_per_cell=cfg.k_per_cell)
    if cfg.fast_backend == "pallas" and stack.shape[2] % fast_mod.CELL == 0:
        return fast_mod.select_keypoints_fused(
            stack, bounds, cfg.th_hi, cfg.th_lo, k_max, **select)
    if cfg.fast_backend == "pallas":
        raw, masked = fast_mod.fast_score_nms(stack)
        return fast_mod.select_keypoints_batched(
            masked, bounds, cfg.th_hi, cfg.th_lo, k_max, cell=fast_mod.CELL,
            pre_nms=True, raw_score=raw, **select)
    if cfg.fast_backend != "xla":
        raise ValueError(f"fast_backend {cfg.fast_backend!r}")
    return fast_mod.select_keypoints_batched(
        fast_mod.fast_score(stack), bounds, cfg.th_hi, cfg.th_lo, k_max,
        cell=fast_mod.CELL, **select)


def _describe_kernel(stack, bounds, xy, budgets, oc: OrbConstants):
    """(angle [b * K_tot], desc [b * K_tot, 256]) by kernel K2, one launch
    over the plane stack, each plane reflected at its content edge."""
    packed = sample_mod.sample_patches(stack, bounds, xy, budgets, oc.pool_xy)
    npool = oc.pool_xy.shape[0]
    ang = torch.atan2(packed[..., npool + 1], packed[..., npool]).reshape(-1)
    diff = packed[..., :npool].reshape(-1, npool) @ oc.diff
    return ang, torch.where(diff > 0, 1, -1).to(torch.int8)


def _describe_maps(stack, xy, budgets, cfg: OrbConfig, oc: OrbConstants):
    """(angle [b * K_tot], desc [b * K_tot, 256]) from the plane stack: the
    angle by `cfg.moments_backend`, the blur of the whole stack, the pool
    gather."""
    b = xy.shape[0]
    _, h, w = stack.shape
    dev = stack.device
    base = torch.cat(
        [((lvl * b + torch.arange(b, device=dev)) * (h * w))[:, None].expand(b, kb)
         for lvl, kb in enumerate(budgets)], dim=1).reshape(-1)
    xy = xy.reshape(-1, 2)
    if cfg.moments_backend == "sparse":
        ang = ic_angle_sparse(stack, base, xy)
    else:
        if cfg.moments_backend == "pallas":
            m10, m01 = moments_mod.moment_maps(stack)
        elif cfg.moments_backend == "integral":
            m10, m01 = moments_mod.moment_maps_plain(stack)
        else:
            raise ValueError(f"moments_backend {cfg.moments_backend!r}")
        ang = moments_mod.ic_angle_integral(m10.reshape(-1), m01.reshape(-1), base, xy, h, w)
    blur = gaussian_blur7(stack)
    return ang, brief_descriptors_pool(blur.reshape(-1), base, xy, ang, h, w, oc)


def extract_batch(imgs: torch.Tensor, cfg: OrbConfig, oc: OrbConstants) -> OrbFeatures:
    """ORB features of a batch of images [B, H, W]; fields [B, K_total, ...]
    with levels in ascending order, each level block sorted by score."""
    b = imgs.shape[0]
    budgets = level_budgets(cfg)
    nl = cfg.n_levels
    dev = imgs.device

    stack, bounds = plane_stack(imgs, cfg, oc)
    kps = detect(stack, bounds, cfg, budgets[0])
    xy_l = [kps.xy[lvl * b:(lvl + 1) * b, :budgets[lvl]] for lvl in range(nl)]
    xy = torch.cat(xy_l, dim=1)                           # [b, K_tot, 2]
    if cfg.sample_backend == "pallas":
        ang, desc = _describe_kernel(stack, bounds, xy, budgets, oc)
    elif cfg.sample_backend == "xla":
        ang, desc = _describe_maps(stack, xy, budgets, cfg, oc)
    else:
        raise ValueError(f"sample_backend {cfg.sample_backend!r}")
    k_tot = xy.shape[1]

    score = torch.cat([kps.score[lvl * b:(lvl + 1) * b, :budgets[lvl]]
                       for lvl in range(nl)], dim=1)
    valid = torch.cat([kps.valid[lvl * b:(lvl + 1) * b, :budgets[lvl]]
                       for lvl in range(nl)], dim=1)
    level = torch.cat([torch.full((b, kb), lvl, dtype=torch.int32, device=dev)
                       for lvl, kb in enumerate(budgets)], dim=1)
    scale = torch.cat([torch.full((b, kb), cfg.scale**lvl, dtype=torch.float32, device=dev)
                       for lvl, kb in enumerate(budgets)], dim=1)
    return OrbFeatures(
        xy=xy * scale[..., None], angle=ang.reshape(b, k_tot), score=score, level=level,
        desc=desc.reshape(b, k_tot, N_PAIRS), valid=valid,
    )
