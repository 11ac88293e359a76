"""Oriented binary descriptors over an image pyramid ("ORB" front-end).

Frozen from `pose_estimation_tpu_torch/ops/orb.py:extract_batch`, its
kernel path (the one both cells run): content-shaped bilinear pyramid
products and one level-major zero-padded plane stack; detection by kernel
K1 (`fast.fast_select`) plus the plane top-k when the width is a multiple
of 16, otherwise by kernel K3 (`fast.fast_score_nms`) followed by
`fast.select_keypoints_batched` (KITTI's 1242-px frames take K3);
description by kernel K2 (`sample.sample_patches`), one launch over the
plane stack for every level, each plane reflected at its content edge,
then `atan2` of its moments, the pool difference product and its sign.
Every kernel runs as its plain twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vio_bench.ref.ops import fast as fast_mod
from vio_bench.ref.ops import sample as sample_mod
from vio_bench.ref.ops.brief_pattern import POOL_PAIRS, POOL_POINTS

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


def detect(stack: torch.Tensor, bounds, cfg: OrbConfig, k_max: int) -> fast_mod.Keypoints:
    """[N, k_max] keypoints per plane of the stack: K1 where the width is a
    multiple of 16, else K3 and the torch selection."""
    select = dict(border=EDGE, k_per_cell=cfg.k_per_cell)
    if stack.shape[2] % fast_mod.CELL == 0:
        return fast_mod.select_keypoints_fused(
            stack, bounds, cfg.th_hi, cfg.th_lo, k_max, **select)
    raw, masked = fast_mod.fast_score_nms(stack)
    return fast_mod.select_keypoints_batched(
        masked, bounds, cfg.th_hi, cfg.th_lo, k_max, cell=fast_mod.CELL,
        pre_nms=True, raw_score=raw, **select)


def _describe_kernel(stack, bounds, xy, budgets, oc: OrbConstants):
    """(angle [b * K_tot], desc [b * K_tot, 256]) by kernel K2, one launch
    over the plane stack, each plane reflected at its content edge."""
    packed = sample_mod.sample_patches(stack, bounds, xy, budgets, oc.pool_xy)
    npool = oc.pool_xy.shape[0]
    ang = torch.atan2(packed[..., npool + 1], packed[..., npool]).reshape(-1)
    diff = packed[..., :npool].reshape(-1, npool) @ oc.diff
    return ang, torch.where(diff > 0, 1, -1).to(torch.int8)


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
    ang, desc = _describe_kernel(stack, bounds, xy, budgets, oc)
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
