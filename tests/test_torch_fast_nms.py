"""PyTorch port vs the JAX package: detection at widths that are not a
multiple of 16 (kernel K3's route).

K3's twin `score_nms_plain` against `fast_score_nms_pallas` in interpret
mode, `select_keypoints_batched` against the JAX function, and ORB
extraction through K3's route against the JAX package's XLA detection route
(the JAX package cannot run K3's route through `extract_batch` on a CPU:
its call at orb.py:642 has no interpret switch; `tests/test_pallas_fast.py`
holds the XLA route equal to K3 inside the detection border). The CUDA
kernel itself is compared with its twin by the `cuda`-marked test at the
end (skipped without a GPU) and by `chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_parity import jax_setup, torch_setup, world  # noqa: E402

from pose_estimation_tpu.ops import fast as jfast  # noqa: E402
from pose_estimation_tpu.ops.pallas_fast import fast_score_nms_pallas  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402

F32 = np.float32
SHAPE = (3, 45, 90)            # 90 % 16 = 10, 45 % 8 = 5: ragged in both


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(seed, shape, integer):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 255, shape)
    if integer:
        return np.round(s).astype(F32)
    return ((s + np.roll(s, 1, 1) + np.roll(s, 1, 2)) / 3).astype(F32)


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "fractional"])
def test_score_nms_plain_bit_equal_to_pallas_interpret(integer):
    """K3's twin and the Pallas kernel (interpret mode): raw and masked maps
    bit-equal on every pixel, the edge rows and wrapped columns included
    (tolerance 0: min, max and one subtraction of the same float32 values)."""
    stack = _stack(3 + integer, SHAPE, integer)
    j_raw, j_masked = (np.asarray(a) for a in fast_score_nms_pallas(
        jnp.asarray(stack), interpret=True))
    t_raw, t_masked = tfast.score_nms_plain(_t(stack))
    assert t_raw.shape == t_masked.shape == SHAPE
    np.testing.assert_array_equal(t_raw.numpy(), j_raw)
    np.testing.assert_array_equal(t_masked.numpy(), j_masked)
    assert (j_masked > 0).sum() > 100


def test_fast_score_nms_on_cpu_runs_the_twin():
    stack = _t(_stack(1, SHAPE, True))
    before = tfast.fast_score_nms.launches
    got = tfast.fast_score_nms(stack)
    ref = tfast.score_nms_plain(stack)
    assert tfast.fast_score_nms.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


BOUNDS = [(45, 90)] * 2 + [(38, 75)]


@pytest.mark.parametrize("pre_nms", [True, False], ids=["masked", "raw"])
def test_select_keypoints_batched_matches_jax(pre_nms):
    """Scores exact and subpixel coordinates within 1e-5 px (same float32
    operations), with and without a pre-masked score map; integer planes
    exercise the tie order of the per-cell and the plane top-k."""
    stack = _stack(7, SHAPE, True)
    raw, masked = fast_score_nms_pallas(jnp.asarray(stack), interpret=True)
    score = masked if pre_nms else raw
    kw = dict(cell=16, border=4, k_per_cell=4, pre_nms=pre_nms)
    ref = jfast.select_keypoints_batched(score, BOUNDS, 20.0, 7.0, 60,
                                         raw_score=raw if pre_nms else None, **kw)
    got = tfast.select_keypoints_batched(
        _t(np.asarray(score)), BOUNDS, 20.0, 7.0, 60,
        raw_score=_t(np.asarray(raw)) if pre_nms else None, **kw)
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    valid = np.asarray(ref.valid)
    assert valid.sum() > 60
    np.testing.assert_allclose(got.xy.numpy()[valid], np.asarray(ref.xy)[valid],
                               atol=1e-5, rtol=0)


K3_SIZE = dict(width=200, height=120, levels=4, features=300)


def test_extract_pair_through_k3_matches_jax():
    """ORB at 200x120 (200 % 16 = 8: K3's route in the port) against the JAX
    package's `OrbConfig(fast_backend="xla", sample_backend=
    "pallas_interpret")`, to the bounds of test_torch_frontend.py::
    test_extract_pair_matches_jax_kernel_path: valid sets within 1 %,
    rectified coordinates within 1e-3 px, level-0 scores exact, descriptor
    bit-flip rate <= 1e-3."""
    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch.models import vio as tvio

    _, jconsts, jstatic = jax_setup(**K3_SIZE)
    assert jstatic.orb.fast_backend == "xla"
    _, tconsts, tstatic = torch_setup(**K3_SIZE)
    frames = world(1, **K3_SIZE)[0]
    before = tfast.fast_select.launches, tfast.fast_score_nms.launches
    l, r = frames[0]
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
        lvl0 = both & (jf.level == 0)
        np.testing.assert_array_equal(tf.score.numpy()[lvl0], jf.score[lvl0])
        assert (tf.desc.numpy()[both] != jf.desc[both]).mean() <= 1e-3
    # CPU tensors run the twins and count no launch
    assert (tfast.fast_select.launches, tfast.fast_score_nms.launches) == before


# ---- on the card: the CUDA kernel against its twin (skipped without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "fractional"])
def test_fast_score_nms_kernel_bit_equal_to_twin_on_gpu(gpu, integer):
    stack = _t(_stack(11 + integer, (16, 375, 1242), integer)).to(gpu)
    before = tfast.fast_score_nms.launches
    got = tfast.fast_score_nms(stack)
    ref = tfast.score_nms_plain(stack)
    torch.cuda.synchronize()
    assert tfast.fast_score_nms.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
