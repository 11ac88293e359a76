"""Many sequences, one frame step (the frozen copy of
`pose_estimation_tpu_torch/parallel/batched.py`'s single-process step):
ORB extraction once for all 2B images of a batched frame, then
`models.vio.track_head` under `torch.func.vmap`, the PSD clip of the B
Schur complements, and `track_tail` under `vmap`."""

from __future__ import annotations

import functools

import torch

from vio_bench.ref.models import vio as vio_mod
from vio_bench.ref.utils.tree import tree_map


def stack_states(states):
    """One batched state from a list of single-sequence states."""
    return tree_map(lambda *leaves: torch.stack(leaves), *states)


def make_batched_step(consts, static):
    """step(state_B, imgs_l [B, H, W], imgs_r, gyr [B, m, 3], acc, mask [B,
    m], u_B [B, 2, 64, 8]) -> (state_B, metrics_B)."""
    vhead = torch.func.vmap(functools.partial(vio_mod.track_head, consts=consts,
                                              static=static))
    vtail = torch.func.vmap(functools.partial(vio_mod.track_tail, consts=consts,
                                              static=static))

    def step(state_b, imgs_l, imgs_r, gyr, acc, mask, u_b):
        feats_l, feats_r = vio_mod.extract_rectified_batch(imgs_l, imgs_r, consts, static)
        carry = vhead(state_b, feats_l, feats_r, gyr, acc, mask, u_b)
        return vtail(carry, vio_mod.psd_clip(carry.ba.schur))

    return step
