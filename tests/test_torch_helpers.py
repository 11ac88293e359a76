"""PyTorch port: small public helpers against the JAX package's, on the
same numpy inputs.

- `CameraModel.baseline` (EuRoC's and KITTI's rigs and the synthetic one);
- `ops/triangulate.triangulate_rectified` (float32; within 1e-6 relative);
- `ops/matching.pack_descriptors` and `cross_check` (exact);
- `testing.tiny_config` (the same configuration).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu_torch import testing  # noqa: E402
from pose_estimation_tpu_torch.ops import matching, triangulate  # noqa: E402


@pytest.mark.parametrize("dataset", ["euroc", "kitti"])
def test_baseline_matches_jax(dataset):
    from pose_estimation_tpu.camera import CameraModel as JCM
    from pose_estimation_tpu.testing import synthetic_config as jcfg

    from pose_estimation_tpu_torch.camera import CameraModel

    kw = dict(width=752, height=480, dataset=dataset,
              dist_left=np.array([-0.28, 0.07, 2e-4, 2e-5, 0.0]),
              t_lr=np.array([-0.11, 0.002, 0.001]))
    got = CameraModel.from_config(testing.synthetic_config(**kw)).baseline
    want = JCM.from_config(jcfg(**kw)).baseline
    assert got == want and 0.10 < got < 0.12


def test_triangulate_rectified_matches_jax():
    """Pixels of points 1-20 m deep (and two at zero disparity) through
    both packages' closed form in float32: within 1e-6 relative."""
    from pose_estimation_tpu.ops import triangulate as jtri

    rng = np.random.default_rng(0)
    px_l = rng.uniform([0, 0], [752, 480], (64, 2)).astype(np.float32)
    disp = (0.11 * 450.0 / rng.uniform(1, 20, 64)).astype(np.float32)
    disp[:2] = 0.0
    px_r = np.stack([px_l[:, 0] - disp, px_l[:, 1]], -1).astype(np.float32)
    args = (450.0, 376.0, 240.0, 452.0, 0.11)
    got = triangulate.triangulate_rectified(*args, torch.from_numpy(px_l),
                                            torch.from_numpy(px_r)).numpy()
    want = np.asarray(jtri.triangulate_rectified(*(jnp.float32(a) for a in args),
                                                 jnp.asarray(px_l), jnp.asarray(px_r)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_pack_descriptors_and_cross_check_match_jax():
    """Random bits packed to +-1 int8 rows as the JAX package packs them;
    the mutual-best mask of a forward match with duplicate targets and
    distance ties equals the JAX package's."""
    from pose_estimation_tpu.ops import matching as jmatch

    rng = np.random.default_rng(1)
    bits = rng.uniform(size=(40, 256)) < 0.5
    packed = matching.pack_descriptors(torch.from_numpy(bits))
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jmatch.pack_descriptors(bits)))
    index = rng.integers(0, 12, 40)
    dist = rng.integers(0, 6, 40).astype(np.float32)
    valid = rng.uniform(size=40) < 0.8
    fwd = matching.MatchResult(torch.from_numpy(index), torch.from_numpy(dist),
                               torch.from_numpy(valid))
    jfwd = jmatch.MatchResult(jnp.asarray(index), jnp.asarray(dist), jnp.asarray(valid))
    got = matching.cross_check(fwd, 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmatch.cross_check(jfwd, 12)))
    assert 0 < got.sum() < valid.sum()


def test_tiny_config_matches_jax():
    from pose_estimation_tpu.testing import tiny_config as jtiny

    got, want = testing.tiny_config(camera_frequency=40), jtiny(camera_frequency=40)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert (got.image_width, got.image_height, got.pool_capacity) == (96, 64, 128)
