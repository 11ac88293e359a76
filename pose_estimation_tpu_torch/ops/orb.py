"""Oriented binary descriptors over an image pyramid ("ORB" front-end).

Counterpart of the kernel path of `pose_estimation_tpu/ops/orb.py:
extract_batch` (its `fast_backend="pallas"`, `sample_backend="pallas"`
branch): content-shaped bilinear pyramid products, one level-major plane
stack, detection, then per level kernel K2 (`sample.sample_patches`) on the
level's own canvas, `atan2` of the moments, the pool difference product and
the sign. Detection takes kernel K1 (`fast.fast_select`) plus the plane
top-k when the width is a multiple of 16, and otherwise kernel K3
(`fast.fast_score_nms`) followed by `fast.select_keypoints_batched`, as
`orb.py:629-647` does (KITTI's 1242-px frames take K3). On a CPU tensor the kernels run as their torch twins, with
the same semantics.

The XLA alternatives of the JAX package (sparse IC angle, full-stack blur,
pool gather) are not ported: the port follows the kernel path everywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch.ops import fast as fast_mod
from pose_estimation_tpu_torch.ops import sample as sample_mod
from pose_estimation_tpu_torch.ops.brief_pattern import POOL_PAIRS, POOL_POINTS

PATCH_R = 15
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
    """(levels, stack, bounds): the content-shaped levels, the level-major
    zero-padded plane stack [n_levels * B, H, W] that kernel K1 reads, and
    each plane's content size."""
    b, h, w = imgs.shape
    levels = pyramid_levels(imgs, oc)
    stack = torch.cat(
        [torch.nn.functional.pad(lv, (0, w - lv.shape[2], 0, h - lv.shape[1]))
         for lv in levels], dim=0,
    )
    shapes = pyramid_shapes(h, w, cfg)
    return levels, stack, [shapes[p // b] for p in range(cfg.n_levels * b)]


def extract_batch(imgs: torch.Tensor, cfg: OrbConfig, oc: OrbConstants) -> OrbFeatures:
    """ORB features of a batch of images [B, H, W]; fields [B, K_total, ...]
    with levels in ascending order, each level block sorted by score."""
    b = imgs.shape[0]
    budgets = level_budgets(cfg)
    nl = cfg.n_levels
    dev = imgs.device

    levels, stack, bounds = plane_stack(imgs, cfg, oc)
    if imgs.shape[2] % fast_mod.CELL == 0:
        kps = fast_mod.select_keypoints_fused(
            stack, bounds, cfg.th_hi, cfg.th_lo, budgets[0],
            border=EDGE, k_per_cell=cfg.k_per_cell,
        )
    else:
        raw, masked = fast_mod.fast_score_nms(stack)
        kps = fast_mod.select_keypoints_batched(
            masked, bounds, cfg.th_hi, cfg.th_lo, budgets[0], cell=fast_mod.CELL,
            border=EDGE, k_per_cell=cfg.k_per_cell, pre_nms=True, raw_score=raw,
        )

    xy_l, packed_l = [], []
    for lvl in range(nl):
        kb = budgets[lvl]
        xy_lvl = kps.xy[lvl * b:(lvl + 1) * b, :kb]          # [b, kb, 2]
        xy_l.append(xy_lvl)
        plane = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(kb)
        vals, m10, m01 = sample_mod.sample_patches(
            levels[lvl].contiguous(), plane, xy_lvl.reshape(b * kb, 2).contiguous(),
            oc.pool_xy,
        )
        packed_l.append(
            torch.cat([vals, m10[:, None], m01[:, None]], 1).reshape(b, kb, -1)
        )
    packed = torch.cat(packed_l, dim=1)                    # [b, K_tot, P + 2]
    xy = torch.cat(xy_l, dim=1)
    k_tot = xy.shape[1]
    npool = oc.pool_xy.shape[0]
    ang = torch.atan2(packed[..., npool + 1], packed[..., npool])
    diff = packed[..., :npool].reshape(b * k_tot, npool) @ oc.diff
    desc = torch.where(diff > 0, 1, -1).to(torch.int8)

    score = torch.cat([kps.score[lvl * b:(lvl + 1) * b, :budgets[lvl]]
                       for lvl in range(nl)], dim=1)
    valid = torch.cat([kps.valid[lvl * b:(lvl + 1) * b, :budgets[lvl]]
                       for lvl in range(nl)], dim=1)
    level = torch.cat([torch.full((b, kb), lvl, dtype=torch.int32, device=dev)
                       for lvl, kb in enumerate(budgets)], dim=1)
    scale = torch.cat([torch.full((b, kb), cfg.scale**lvl, dtype=torch.float32, device=dev)
                       for lvl, kb in enumerate(budgets)], dim=1)
    return OrbFeatures(
        xy=xy * scale[..., None], angle=ang, score=score, level=level,
        desc=desc.reshape(b, k_tot, N_PAIRS), valid=valid,
    )


def extract_pair(img_a, img_b, cfg: OrbConfig, oc: OrbConstants):
    """Features of a stereo pair, both images in one batch."""
    feats = extract_batch(torch.stack([img_a, img_b]), cfg, oc)
    return (OrbFeatures(*(f[0] for f in feats)),
            OrbFeatures(*(f[1] for f in feats)))
