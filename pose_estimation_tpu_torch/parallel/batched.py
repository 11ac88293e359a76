"""Many sequences, one frame step: a leading batch dimension, and a
(data, model) grid of ranks.

Counterpart of `pose_estimation_tpu/parallel/batched.py`, whose step is
`jit(vmap(ok_step))` over a device mesh. Here ORB extraction runs once for
all 2B images of a batched frame (one plane stack, so one launch of each
kernel), and the rest of the step, `models.vio.track_step`, maps over the
sequences with `torch.func.vmap`: every operation runs once for the whole
batch. The step is `track_head` under vmap, the PSD clip of the B Schur
complements (kernel K6, a launch that cannot run under vmap, so it sits
between the two vmapped parts), then `track_tail` under vmap; nothing in
it reads the device on the host, and `graphs.BatchedGraphs` captures it
as one graph. Each sequence keeps its own keyframe decisions, pool and window;
the branches of the step are masks selected per sequence. The RANSAC
uniforms come in as an argument, drawn by the caller from one generator
per sequence.

The mesh (`make_mesh`) is the port's form of the JAX package's
`_state_sharding`, with one process per device (`parallel/multihost.py`
starts them):

- `data`: JAX shards the batch axis of every state leaf over it. Here each
  data rank holds and steps its own lanes; the step sends nothing between
  data ranks.
- `model`: JAX shards the landmark pool's slot axis (descriptors,
  positions, observation tables) over it and XLA inserts the collectives
  the gathers need. Here the state stays whole on every rank of a model
  group, and the one product whose width is the pool is split: each rank
  computes the Hamming table of the current descriptors against its block
  of pool slots, and one MIN all-reduce of packed (distance, slot) keys
  gives every rank the same argmin (`ops/matching.py`). Everything after
  the match is computed alike on every rank of the group.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.ops.matching import PoolShard
from pose_estimation_tpu_torch.utils.tree import tree_map


class Mesh(NamedTuple):
    """This rank's place in a (data, model) grid of ranks: row
    `data_index` of `data`, column `model_index` of `model`, and the
    process group of its row (None when `model` is 1)."""

    data: int
    model: int
    data_index: int
    model_index: int
    model_group: object = None

    @property
    def pool_shard(self) -> PoolShard | None:
        """The split of the pool's Hamming tables over this rank's row."""
        if self.model == 1:
            return None
        return PoolShard(self.model_index, self.model, self.model_group)


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The (data, model) grid over the ranks of the default process group
    (one rank, uninitialized, is a 1 x 1 grid): ranks in row-major order,
    so each row of `model` ranks is contiguous. Every rank must call it,
    in the same order as the others: it creates every row's group."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh over {world} ranks")
    group = None
    if model > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)))
            if d == rank // model:
                group = g
    return Mesh(data, model, rank // model, rank % model, group)


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


def make_batched_step(consts, static, mesh: Mesh | None = None):
    """step(state_B, imgs_l [B, H, W], imgs_r, gyr [B, m, 3], acc, mask [B,
    m], u_B [B, 2, 64, 8]) -> (state_B, metrics_B): one frame of B
    sequences: one extraction for the 2B images, `track_head` under vmap,
    `vio.psd_clip` of the B Schur complements, `track_tail` under vmap.
    u_B holds each sequence's (stereo, temporal) RANSAC uniforms. With a
    mesh, B is the rank's own lanes (the same on every rank of a model
    group) and the pool's Hamming tables are split over the group."""
    shard = None if mesh is None else mesh.pool_shard
    vhead = torch.func.vmap(functools.partial(vio_mod.track_head, consts=consts,
                                              static=static, shard=shard))
    vtail = torch.func.vmap(functools.partial(vio_mod.track_tail, consts=consts,
                                              static=static))

    def step(state_b, imgs_l, imgs_r, gyr, acc, mask, u_b):
        with torch.profiler.record_function("ok_step.extract"):
            feats_l, feats_r = vio_mod.extract_rectified_batch(imgs_l, imgs_r, consts, static)
        carry = vhead(state_b, feats_l, feats_r, gyr, acc, mask, u_b)
        return vtail(carry, vio_mod.psd_clip(carry.ba.schur))

    return step
