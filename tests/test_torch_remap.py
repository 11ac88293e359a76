"""PyTorch port vs the JAX package: the dense rectify mode.

The port's copy of the rectification maps (`camera.undistort_rectify_map`,
numpy) against the original, `remap.remap_bilinear` against the JAX
function in its single, broadcast and paired forms, and
`vio.extract_rectified` with `rectify_mode="dense"` against the JAX one on
a rig with lens distortion and a rotated right camera.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_parity import jax_setup, torch_setup, world  # noqa: E402

from pose_estimation_tpu import camera as jcamera  # noqa: E402
from pose_estimation_tpu.ops import remap as jremap  # noqa: E402
from pose_estimation_tpu_torch import camera as tcamera  # noqa: E402
from pose_estimation_tpu_torch.ops import remap as tremap  # noqa: E402

F32 = np.float32
# plumb-bob distortion of EuRoC's order of magnitude and a right camera
# turned by about a degree, so the maps bend
RIG = dict(
    dist_left=np.array([-0.28, 0.07, 2e-4, 1.8e-5, 0.0]),
    dist_right=np.array([-0.25, 0.06, -1e-4, 3e-5, 0.0]),
    r_lr=tcamera._rodrigues(np.array([0.012, -0.02, 0.005])),
    rectify_mode="dense",
)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_camera_model_with_maps_equals_jax():
    """Every array the port's CameraModel keeps, the two [H, W, 2] sampling
    maps included, equals the JAX package's (numpy float64 on both sides,
    the same operations)."""
    jcfg, _, _ = jax_setup(**RIG)
    tcfg, _, _ = torch_setup(**RIG)
    jcm = jcamera.CameraModel.from_config(jcfg)
    tcm = tcamera.CameraModel.from_config(tcfg)
    for name in ("R1", "R2", "P1", "P2", "map_left", "map_right", "R_cb", "p_cb"):
        np.testing.assert_array_equal(getattr(tcm, name), getattr(jcm, name), err_msg=name)
    assert tcm.map_left.shape == (128, 160, 2) and tcm.map_left.dtype == np.float32
    # the maps are no identity on this rig
    grid = np.stack(np.meshgrid(np.arange(160), np.arange(128)), -1)
    assert np.abs(tcm.map_left - grid).max() > 2.0
    np.testing.assert_array_equal(
        tcamera.undistort_rectify_map(tcfg.k_left, tcfg.dist_left, tcm.R1, tcm.P1, (160, 128)),
        jcamera.undistort_rectify_map(jcfg.k_left, jcfg.dist_left, jcm.R1, jcm.P1, (160, 128)))


@pytest.mark.parametrize("form", ["single", "broadcast", "paired"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
def test_remap_bilinear_matches_jax(form, dtype):
    """One image with one map, a batch with one map, and the stereo pair
    with a map each; coordinates beyond every edge, on whole pixels and
    just below them. Within 1e-4 on 0-255 data (the same four gathers and
    three float32 blends; XLA may fuse a multiply-add)."""
    rng = np.random.default_rng(3)
    h, w, ho, wo = 40, 56, 32, 48
    n_map = 2 if form == "paired" else 1
    img = rng.uniform(0, 255, (2, h, w)).astype(dtype)
    mapxy = np.stack([rng.uniform(-3, w + 2, (n_map, ho, wo)),
                      rng.uniform(-3, h + 2, (n_map, ho, wo))], -1).astype(F32)
    mapxy[:, 0, :4] = [[0.0, 0.0], [w - 1.0, h - 1.0], [-1.0, 5.0], [w - 1e-3, h - 1e-3]]
    if form == "single":
        img, mapxy = img[0], mapxy[0]
    elif form == "broadcast":
        mapxy = mapxy[0]
    ref = np.asarray(jremap.remap_bilinear(jnp.asarray(img), jnp.asarray(mapxy)))
    got = tremap.remap_bilinear(_t(img), _t(mapxy))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    assert (ref == 0).any() and (ref > 0).any()


def test_extract_rectified_dense_matches_jax():
    """Dense mode at 160x128 on the distorted rig, kernel path on both
    sides (the JAX sampler in interpret mode), to the bounds of
    test_torch_frontend.py::test_extract_pair_matches_jax_kernel_path:
    valid sets within 1 %, coordinates within 1e-3 px, levels equal,
    descriptor bit-flip rate <= 1e-3. The remapped frames are no longer
    integers, so level-0 scores agree to float32 rounding only."""
    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch.models import vio as tvio

    _, jconsts, jstatic = jax_setup(**RIG)
    _, tconsts, tstatic = torch_setup(**RIG)
    assert jstatic.rectify_mode == tstatic.rectify_mode == "dense"
    np.testing.assert_array_equal(tconsts.map_r.numpy(), np.asarray(jconsts.map_r))
    l, r = world(1)[0][0]
    jf2 = jax.tree.map(np.asarray, jax.jit(
        lambda a, b: jvio.extract_rectified(a, b, jconsts, jstatic))(
            jnp.asarray(l), jnp.asarray(r)))
    tf2 = tvio.extract_rectified(_t(l), _t(r), tconsts, tstatic)
    for jf, tf in zip(jf2, tf2):
        jvalid, tvalid = jf.valid, tf.valid.numpy()
        assert jvalid.sum() > 50
        both = jvalid & tvalid
        assert (jvalid != tvalid).sum() <= 0.01 * jvalid.sum()
        np.testing.assert_allclose(tf.xy.numpy()[both], jf.xy[both], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(tf.level.numpy(), jf.level)
        np.testing.assert_allclose(tf.score.numpy()[both], jf.score[both], atol=1e-3, rtol=0)
        assert (tf.desc.numpy()[both] != jf.desc[both]).mean() <= 1e-3
    # and the dense mode is not the sparse one on this rig
    sparse = tvio.extract_rectified(_t(l), _t(r), tconsts,
                                    tvio.dataclasses.replace(tstatic, rectify_mode="sparse"))
    assert not torch.equal(sparse[0].xy, tf2[0].xy)
