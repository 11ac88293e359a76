"""PyTorch port: the (data x model) mesh and the multi-process dry run
(`parallel/batched.py` `make_mesh`, `make_batched_step(..., mesh)`;
`parallel/multihost.py`; the sharded pool match of `ops/matching.py`).

- the packed nearest-neighbour reduction over 1, 2 and 4 shards equals
  the unsharded `match` (index, distance and gate), with ties between
  shards and train rows masked out;
- a 1 x 1 mesh without a process group is the single-process step;
- the dry run: 4 CPU processes joined over gloo as a (data 2, model 2)
  grid, at `tiny_config` with a 32-slot pool (so the valid slots lie in
  both model ranks' blocks), one batched step after a 2-frame warm-up:
  every lane tracks and runs BA, and each rank's lanes equal the
  single-process batched step's on the same lanes (integers exactly,
  positions within 1e-5 m; measured: bit-equal). The dry run has a
  60-s limit of its own, so a hung rank fails the test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch.ops import matching  # noqa: E402
from pose_estimation_tpu_torch.parallel import batched, multihost  # noqa: E402


def _descriptors(rng, n):
    return matching.pack_descriptors(torch.from_numpy(rng.uniform(size=(n, 256)) < 0.5))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_packed_reduction_equals_unsharded_match(shards):
    """64 query rows against 32 train rows, half of them masked out; train
    row 3's copies sit at rows 11 and 27 (other blocks at 2 and 4 shards)
    and some queries equal row 3, so their nearest distance ties across
    shard borders. Every shard's packed keys, reduced, give the unsharded
    argmin's index (the lowest on ties) and distance, and the gate keeps
    the same rows."""
    rng = np.random.default_rng(shards)
    train = _descriptors(rng, 32)
    train[11] = train[27] = train[3]
    query = _descriptors(rng, 64)
    query[1::7] = -train[3]                   # as far as can be from row 3
    query[::5] = train[3]
    train_mask = torch.from_numpy(rng.uniform(size=32) < 0.5)
    train_mask[[3, 11, 27]] = torch.tensor([True, True, True])
    query_mask = torch.from_numpy(rng.uniform(size=64) < 0.8)
    ref = matching.match(query, train, query_mask, train_mask, 3.0, 40.0)
    keys = [matching.shard_nearest(query, train, train_mask, i, shards)
            for i in range(shards)]
    idx, dist = matching.unpack_nearest(matching.reduce_nearest(keys), 32)
    assert torch.equal(idx, ref.index) and torch.equal(dist, ref.dist)
    got = matching.gate(idx, dist, query_mask, 3.0, 40.0)
    assert torch.equal(got.valid, ref.valid)
    assert bool((ref.index[::5] == 3).all()) and bool((ref.dist[::5] == 0).all())
    # with no valid train row the key is the largest distance at slot 0
    none = torch.zeros(32, dtype=torch.bool)
    keys = [matching.shard_nearest(query, train, none, i, shards) for i in range(shards)]
    idx, dist = matching.unpack_nearest(matching.reduce_nearest(keys), 32)
    ref = matching.match(query, train, query_mask, none, 3.0, 40.0)
    assert torch.equal(idx, ref.index) and torch.equal(dist, ref.dist)
    assert bool((dist == matching.BIG).all()) and not bool(ref.valid.any())


def test_uneven_blocks_are_refused():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="equal blocks"):
        matching.shard_nearest(_descriptors(rng, 4), _descriptors(rng, 30),
                               torch.ones(30, dtype=torch.bool), 0, 4)


def test_single_rank_mesh_is_the_plain_step():
    """Without a process group `make_mesh` is a 1 x 1 grid whose step
    splits nothing."""
    mesh = batched.make_mesh()
    assert mesh == batched.Mesh(1, 1, 0, 0, None) and mesh.pool_shard is None
    with pytest.raises(ValueError):
        batched.make_mesh(data=2)


def test_dryrun_four_processes_data2_model2():
    """The multi-process dry run on the CPU (see the module docstring)."""
    results = multihost.dryrun(4, model=2, device="cpu", backend="gloo",
                               config=("tiny_config", {"camera_frequency": 40,
                                                       "pool_capacity": 32}),
                               timeout=60)
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    assert [(r["data_index"], r["model_index"]) for r in results] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["lanes"] for r in results] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    for r in results:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert min(r["n_tracked"]) > 0 and min(r["ba_iters"]) > 0
        assert r["state_max_diff"] <= 1e-5
        # the pool's valid slots lie in both model ranks' blocks
        assert all(min(blocks) > 0 for blocks in r["pool_blocks"])
    # the ranks of a model group computed the same lanes
    for a, b in ((0, 1), (2, 3)):
        assert results[a]["rec_p"] == results[b]["rec_p"]
