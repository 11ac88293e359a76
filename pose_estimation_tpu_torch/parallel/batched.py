"""Many sequences, one frame step: a leading batch dimension on one card.

Counterpart of `pose_estimation_tpu/parallel/batched.py`, whose step is
`jit(vmap(ok_step))` over a device mesh. Here ORB extraction runs once for
all 2B images of a batched frame (one plane stack, so one launch of each
kernel), and the rest of the step, `models.vio.track_step`, maps over the
sequences with `torch.func.vmap`: every operation runs once for the whole
batch. Each sequence keeps its own keyframe decisions, pool and window;
the branches of the step are masks selected per sequence. The RANSAC
uniforms come in as an argument, drawn by the caller from one generator
per sequence. The JAX package's mesh and pool-axis sharding are multi-card
work and are not part of this module.
"""

from __future__ import annotations

import functools

import torch

from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.utils.tree import tree_map


def stack_states(states):
    """One batched state from a list of single-sequence states."""
    return tree_map(lambda *leaves: torch.stack(leaves), *states)


def lane(tree, i: int):
    """Sequence i's slice of a batched state (or metrics)."""
    return tree_map(lambda a: a[i], tree)


def init_batched_state(static, batch: int, device):
    """The initial state of `init_vio_state`, repeated for `batch`
    sequences."""
    one = vio_mod.init_vio_state(static, device)
    return tree_map(lambda a: a.expand((batch,) + a.shape).clone(), one)


def make_batched_step(consts, static):
    """step(state_B, imgs_l [B, H, W], imgs_r, gyr [B, m, 3], acc, mask [B,
    m], u_B [B, 2, 64, 8]) -> (state_B, metrics_B): one frame of B
    sequences. u_B holds each sequence's (stereo, temporal) RANSAC
    uniforms."""
    vstep = torch.func.vmap(functools.partial(vio_mod.track_step, consts=consts,
                                              static=static))

    def step(state_b, imgs_l, imgs_r, gyr, acc, mask, u_b):
        with torch.profiler.record_function("ok_step.extract"):
            feats_l, feats_r = vio_mod.extract_rectified_batch(imgs_l, imgs_r, consts, static)
        return vstep(state_b, feats_l, feats_r, gyr, acc, mask, u_b)

    return step
