"""Stereo feature tracking: stereo match, temporal track, triangulation.

Counterpart of `pose_estimation_tpu/frontend/tracker.py`. The JAX package
compacts rows and selects descriptor rows with one-hot matmuls, a TPU
workaround for slow gathers and scatters; here they are indexed writes and
reads. Triangulated points live in the rectified left camera frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose_estimation_tpu_torch.models.pool import FeaturePool
from pose_estimation_tpu_torch.ops import matching, orb, ransac, triangulate
from pose_estimation_tpu_torch.utils import lie


class CurrentFeatures(NamedTuple):
    px_l: torch.Tensor    # [M, 2]
    px_r: torch.Tensor    # [M, 2]
    desc_l: torch.Tensor  # [M, 256] int8
    desc_r: torch.Tensor  # [M, 256] int8
    valid: torch.Tensor   # [M] bool


class TrackResult(NamedTuple):
    matched: torch.Tensor    # [M] circular-match success
    slot: torch.Tensor       # [M] pool slot of the match
    n_matches: torch.Tensor


def compact(mask: torch.Tensor, capacity: int, *payloads):
    """Pack the rows where mask holds into the first `capacity` slots,
    stably; the rest of the slots are zero. Returns (out_mask, payloads...)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    ok = mask & (rank < capacity)
    target = torch.where(ok, rank, capacity)
    outs = []
    for p in (torch.ones_like(mask), *payloads):
        out = torch.zeros((capacity + 1,) + p.shape[1:], dtype=p.dtype, device=p.device)
        outs.append(out.index_put((target,), p)[:capacity])
    return tuple(outs)


def internal_match(feats_l: orb.OrbFeatures, feats_r: orb.OrbFeatures, u,
                   capacity: int, match_ratio: float, min_match_dist: float,
                   max_vertical_dist: float) -> CurrentFeatures:
    """L/R stereo matching with the distance and epipolar gates and RANSAC
    (uniforms `u` [64, 8])."""
    m = matching.stereo_match(
        feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid,
        feats_l.xy, feats_r.xy, match_ratio, min_match_dist, max_vertical_dist,
    )
    px_r = feats_r.xy[m.index]
    keep = ransac.fundamental_ransac(feats_l.xy, px_r, m.valid, u).inliers
    n = keep.shape[0]
    cm, px_l_c, px_r_c, lidx, ridx = compact(
        keep, capacity, feats_l.xy, px_r,
        torch.arange(n, device=keep.device), m.index,
    )
    zero = torch.zeros((), dtype=torch.int8, device=keep.device)
    dl_c = torch.where(cm[:, None], feats_l.desc[lidx], zero)
    dr_c = torch.where(cm[:, None], feats_r.desc[ridx], zero)
    return CurrentFeatures(px_l=px_l_c, px_r=px_r_c, desc_l=dl_c, desc_r=dr_c, valid=cm)


def external_track(cur: CurrentFeatures, pool: FeaturePool, u,
                   match_ratio: float, min_match_dist: float,
                   shard: matching.PoolShard | None = None) -> TrackResult:
    """Circular matching cur-left <-> pool-left and cur-right <-> pool-right;
    the left matches pass RANSAC against the pool's first-frame pixels.
    `shard` splits the two Hamming tables' pool columns over a model
    group."""
    ml = matching.match(cur.desc_l, pool.desc_l, cur.valid, pool.valid,
                        match_ratio, min_match_dist, shard)
    hist_px = pool.pixel[ml.index]
    left_ok = ransac.fundamental_ransac(cur.px_l, hist_px, ml.valid, u).inliers
    mr = matching.match(cur.desc_r, pool.desc_r, cur.valid, pool.valid,
                        match_ratio, min_match_dist, shard)
    matched = left_ok & mr.valid & (ml.index == mr.index)
    return TrackResult(matched=matched, slot=ml.index, n_matches=torch.sum(matched))


def triangulate_current(cur: CurrentFeatures, p1, p2, R_wb, p_wb, R_bc, p_bc,
                        max_depth: float):
    """World positions of the current stereo pairs and the depth gate."""
    pts_cam = triangulate.triangulate(p1, p2, cur.px_l, cur.px_r)
    depth = pts_cam[:, 2]
    good = cur.valid & (depth > 0.0) & (depth <= max_depth)
    pts_body = lie.mv(R_bc, pts_cam) + p_bc
    return lie.mv(R_wb, pts_body) + p_wb, good
