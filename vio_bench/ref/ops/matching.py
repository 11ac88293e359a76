"""Brute-force Hamming matching of {-1, +1} descriptors.

Counterpart of `pose_estimation_tpu/ops/matching.py`. The Hamming table is
one float32 product of the +-1 vectors: dot = 256 - 2 * hamming is an
integer of magnitude <= 256, exact in float32 with TF32 off. `argmin`
returns the first minimal index on CPU and CUDA alike (torch documents it;
`chip_smoke.py` checks it on the card), as `jnp.argmin` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DESC_BITS = 256
BIG = 1e9


class MatchResult(NamedTuple):
    index: torch.Tensor  # [N] best train index per query
    dist: torch.Tensor   # [N] its Hamming distance
    valid: torch.Tensor  # [N] passed the gates


def pack_descriptors(bits: torch.Tensor) -> torch.Tensor:
    """bool bits [N, 256] -> {-1, +1} int8 [N, 256]."""
    return torch.where(bits, 1, -1).to(torch.int8)


def hamming_table(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """[N, 256] x [K, 256] int8 -> [N, K] float32 Hamming distances."""
    dots = query.to(torch.float32) @ train.to(torch.float32).T
    return (DESC_BITS - dots) * 0.5


def nearest(query, train, train_mask):
    """(index, distance) of each query row's nearest valid train row; BIG
    where no train row is valid."""
    d = hamming_table(query, train)
    d = torch.where(train_mask[None, :], d, BIG)
    best_idx = torch.argmin(d, dim=1)
    return best_idx, torch.gather(d, 1, best_idx[:, None])[:, 0]


def gate(best_idx, best_d, query_mask, match_ratio: float,
         min_match_dist: float) -> MatchResult:
    """The distance gate dist < max(ratio * global min, min_match_dist), the
    global min taken over valid query rows."""
    row_valid = query_mask & (best_d < BIG)
    global_min = torch.min(torch.where(row_valid, best_d, BIG))
    thresh = torch.clamp(match_ratio * global_min, min=min_match_dist)
    return MatchResult(index=best_idx, dist=best_d, valid=row_valid & (best_d < thresh))


def match(query, train, query_mask, train_mask, match_ratio: float,
          min_match_dist: float) -> MatchResult:
    """Nearest neighbour with `gate`'s distance gate."""
    best_idx, best_d = nearest(query, train, train_mask)
    return gate(best_idx, best_d, query_mask, match_ratio, min_match_dist)


def stereo_match(desc_l, desc_r, mask_l, mask_r, px_l, px_r, match_ratio: float,
                 min_match_dist: float, max_vertical_dist: float) -> MatchResult:
    """L->R match plus the rectified epipolar gate |v_l - v_r| < max."""
    m = match(desc_l, desc_r, mask_l, mask_r, match_ratio, min_match_dist)
    v_r = px_r[m.index, 1]
    keep = m.valid & ((px_l[:, 1] - v_r).abs() < max_vertical_dist)
    return m._replace(valid=keep)


def cross_check(fwd: MatchResult, n_train: int) -> torch.Tensor:
    """Mutual-best mask: query i keeps its match j only if no other valid
    query matched j at a smaller distance."""
    d = torch.where(fwd.valid, fwd.dist, BIG)
    best = torch.full((n_train,), BIG, dtype=d.dtype, device=d.device).scatter_reduce(
        0, fwd.index, d, reduce="amin")
    return fwd.valid & (d <= best[fwd.index])
