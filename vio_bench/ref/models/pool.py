"""Fixed-capacity landmark/feature pool with validity masks.

Counterpart of `pose_estimation_tpu/models/pool.py`. The JAX package writes
descriptor rows with one-hot matmuls, a TPU workaround for slow scatters;
here out-of-place indexed writes (`index_put`) do it, so the updates map
over a batch of sequences with `torch.func.vmap`. Rejected requests are
routed to a dummy row past the end (dropped afterwards), so duplicate
indices never reach a real slot.

obs column W-1 is the current frame, columns 0..W-2 the previous keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeaturePool(NamedTuple):
    valid: torch.Tensor     # [P] bool
    age: torch.Tensor       # [P] int32
    pixel: torch.Tensor     # [P, 2] left pixel in the feature's first frame
    desc_l: torch.Tensor    # [P, 256] int8 {-1, +1}
    desc_r: torch.Tensor    # [P, 256] int8
    pos: torch.Tensor       # [P, 3] world position
    fid: torch.Tensor       # [P] int32 global feature id
    next_fid: torch.Tensor  # int32 scalar
    obs_px: torch.Tensor    # [P, W, 2] window observations (left pixels)
    obs_mask: torch.Tensor  # [P, W] bool


def init_pool(capacity: int, window: int, device,
              dtype=torch.float32) -> FeaturePool:
    def z(*s, dt=dtype):
        return torch.zeros(s, dtype=dt, device=device)

    return FeaturePool(
        valid=z(capacity, dt=torch.bool), age=z(capacity, dt=torch.int32),
        pixel=z(capacity, 2), desc_l=z(capacity, 256, dt=torch.int8),
        desc_r=z(capacity, 256, dt=torch.int8), pos=z(capacity, 3),
        fid=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        next_fid=z(dt=torch.int32), obs_px=z(capacity, window, 2),
        obs_mask=z(capacity, window, dt=torch.bool),
    )


def shift_window(pool: FeaturePool, on) -> FeaturePool:
    """Advance the observation window by one frame where `on` (a bool
    tensor) holds."""
    px = torch.cat([pool.obs_px[:, 1:], torch.zeros_like(pool.obs_px[:, :1])], 1)
    mk = torch.cat(
        [pool.obs_mask[:, 1:], torch.zeros_like(pool.obs_mask[:, :1])], 1
    )
    return pool._replace(
        obs_px=torch.where(on, px, pool.obs_px),
        obs_mask=torch.where(on, mk, pool.obs_mask),
    )


def _scatter_rows(arr: torch.Tensor, target: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """arr with rows `target` set to `vals`; targets == len(arr) drop."""
    p = arr.shape[0]
    out = torch.cat([arr, torch.zeros_like(arr[:1])], 0)
    return out.index_put((target,), vals.to(arr.dtype))[:p]


def record_observations(pool: FeaturePool, slot, matched, px) -> FeaturePool:
    """Write the current frame's observations (column W-1), clearing the
    column first. Where several current features matched one slot, the
    last of them writes, as a sequential scatter does (an indexed write
    with duplicate indices picks an arbitrary one on a GPU)."""
    p = pool.valid.shape[0]
    rows = torch.arange(slot.shape[0], device=slot.device)
    safe_slot = torch.where(matched, slot, p)
    last = torch.full((p + 1,), -1, dtype=rows.dtype, device=slot.device).scatter_reduce(
        0, safe_slot, rows, reduce="amax")
    safe_slot = torch.where(last[safe_slot] == rows, safe_slot, p)
    last_px = _scatter_rows(torch.zeros_like(pool.obs_px[:, -1]), safe_slot, px)
    last_mk = _scatter_rows(torch.zeros_like(pool.obs_mask[:, -1]), safe_slot,
                            torch.ones_like(matched))
    return pool._replace(obs_px=torch.cat([pool.obs_px[:, :-1], last_px[:, None]], 1),
                         obs_mask=torch.cat([pool.obs_mask[:, :-1], last_mk[:, None]], 1))


def age_and_evict(pool: FeaturePool, slot, matched, max_age: int) -> FeaturePool:
    """Keyframe aging: matched features -1, every feature +2, evict age >
    maxFeatureAge."""
    safe_slot = torch.where(matched, slot, 0)
    dec = torch.zeros_like(pool.age).index_add(
        0, safe_slot, torch.where(matched, -1, 0).to(pool.age.dtype)
    )
    age = pool.age + dec + torch.where(pool.valid, 2, 0).to(pool.age.dtype)
    return pool._replace(age=age, valid=pool.valid & (age <= max_age))


def insert_features(pool: FeaturePool, new_px_l, new_desc_l, new_desc_r,
                    new_pos, want) -> FeaturePool:
    """Scatter new features into free slots (lowest free slot first); the
    surplus beyond the free capacity is dropped."""
    p = pool.valid.shape[0]
    free = ~pool.valid
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    n_free = torch.sum(free)
    order = torch.argsort((~free).to(torch.int8), stable=True)
    target = order[torch.clamp(want_rank, 0, p - 1)]
    ok = want & (want_rank < n_free)
    safe_t = torch.where(ok, target, p)

    m = want.shape[0]
    fids = pool.next_fid + want_rank.to(torch.int32)
    w = pool.obs_px.shape[1]
    new_obs_px = torch.cat([torch.zeros((m, w - 1, 2), dtype=pool.obs_px.dtype,
                                        device=want.device), new_px_l[:, None]], 1)
    new_obs_mask = torch.arange(w, device=want.device).expand(m, w) == w - 1
    return pool._replace(
        valid=_scatter_rows(pool.valid, safe_t, torch.ones_like(want)),
        age=_scatter_rows(pool.age, safe_t, torch.zeros_like(fids)),
        pixel=_scatter_rows(pool.pixel, safe_t, new_px_l),
        desc_l=_scatter_rows(pool.desc_l, safe_t, new_desc_l),
        desc_r=_scatter_rows(pool.desc_r, safe_t, new_desc_r),
        pos=_scatter_rows(pool.pos, safe_t, new_pos),
        fid=_scatter_rows(pool.fid, safe_t, fids),
        next_fid=pool.next_fid + torch.sum(want).to(torch.int32),
        obs_px=_scatter_rows(pool.obs_px, safe_t, new_obs_px),
        obs_mask=_scatter_rows(pool.obs_mask, safe_t, new_obs_mask),
    )
