"""PyTorch port vs the JAX package: the pieces of the map-based ORB front
end, one by one.

Kernel K4's twin `moments.moment_maps_plain` against
`orb.moment_maps_integral` and against the Pallas kernel
`moment_maps_pallas` in interpret mode; `ic_angle_sparse`,
`ic_angle_integral`, `gaussian_blur7` and `brief_descriptors_pool` against
their JAX functions on the same numpy inputs. The CUDA kernel itself is
compared with its twin by the `cuda`-marked test at the end (skipped
without a GPU) and by `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import sim as jsim  # noqa: E402

from pose_estimation_tpu.ops import orb as jorb  # noqa: E402
from pose_estimation_tpu.ops.pallas_fast import moment_maps_pallas  # noqa: E402
from pose_estimation_tpu_torch.ops import moments as tmoments  # noqa: E402
from pose_estimation_tpu_torch.ops import orb as torb  # noqa: E402

F32 = np.float32
H, W = 120, 160
# a keypoint's angle is compared where its moment vector is at least this
# share of the plane's largest: below it atan2 amplifies the float32
# rounding of the moments (the flat padding of upper pyramid planes)
MIN_MOMENT = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _wrap(d):
    return np.abs((np.asarray(d) + np.pi) % (2 * np.pi) - np.pi)


@functools.lru_cache(maxsize=2)
def _stack(kind):
    """[4, 120, 160] uniform noise, or the 3-level plane stack of a
    simulator stereo pair at 160x128 (upper planes mostly zero padding)."""
    if kind == "noise":
        return np.random.default_rng(3).uniform(0, 255, (4, H, W)).astype(F32)
    cfg = jsim.sim_config(width=160, height=128)
    imgs = np.stack(jsim.StereoInertialSim(cfg, n_landmarks=150, seed=0).render(0.1))
    ocfg = jorb.OrbConfig(n_levels=3)
    return np.asarray(jorb.pyramid_stack(jnp.asarray(imgs, jnp.float32), ocfg))


def _keypoints(seed, n, h, w, k=300, margin=20):
    rng = np.random.default_rng(seed)
    plane = rng.integers(0, n, k)
    xy = np.stack([rng.uniform(margin, w - margin, k),
                   rng.uniform(margin, h - margin, k)], -1).astype(F32)
    xy[0] = (30.5, 40.5)                     # .5 rounds half to even in both
    return plane, xy, (plane * (h * w)).astype(np.int64)


def _well_conditioned(m10, m01, plane, xy):
    """Keypoints whose moment vector is not tiny against the plane's."""
    cx, cy = np.round(xy[:, 0]).astype(int), np.round(xy[:, 1]).astype(int)
    mag = np.hypot(m10, m01)
    return mag[plane, cy, cx] >= MIN_MOMENT * mag.reshape(len(m10), -1).max(1)[plane]


@pytest.mark.parametrize("kind", ["noise", "sim"])
def test_moment_maps_plain_matches_jax_integral(kind):
    """K4's twin against `orb.moment_maps_integral`, on the whole map (the
    15-px border included: both read zeros beyond the canvas): within 1e-4
    of the plane's largest |moment| (the same sequential float32 prefix
    sums and shifted adds; measured ~1e-7)."""
    stack = _stack(kind)
    j10, j01 = (np.asarray(a) for a in jorb.moment_maps_integral(jnp.asarray(stack)))
    t10, t01 = (a.numpy() for a in tmoments.moment_maps_plain(_t(stack)))
    assert t10.shape == t01.shape == stack.shape
    for got, ref in ((t10, j10), (t01, j01)):
        scale = np.abs(ref).reshape(len(ref), -1).max(1)[:, None, None]
        assert (np.abs(got - ref) <= 1e-4 * scale).all(), (np.abs(got - ref) / scale).max()


@pytest.mark.parametrize("kind", ["noise", "sim"])
def test_moment_maps_plain_matches_pallas_interpret_at_the_angles(kind):
    """K4's twin against the Pallas kernel (interpret mode), as
    tests/test_pallas_fast.py compares the kernel with the integral form:
    angles at keypoints >= 20 px inside within 2e-3 rad (the kernel's
    log-step lane scans sum in another order), where the moment vector is
    not tiny."""
    stack = _stack(kind)
    n, h, w = stack.shape
    plane, xy, base = _keypoints(5, n, h, w)
    p10, p01 = moment_maps_pallas(jnp.asarray(stack), interpret=True)
    ref = np.asarray(jorb.ic_angle_integral(p10.reshape(-1), p01.reshape(-1),
                                            jnp.asarray(base), jnp.asarray(xy), h, w))
    t10, t01 = tmoments.moment_maps_plain(_t(stack))
    got = tmoments.ic_angle_integral(t10.reshape(-1), t01.reshape(-1), _t(base), _t(xy), h, w)
    keep = _well_conditioned(t10.numpy(), t01.numpy(), plane, xy)
    assert keep.sum() > (250 if kind == "noise" else 50)
    assert _wrap(got.numpy() - ref)[keep].max() < 2e-3


@pytest.mark.parametrize("kind", ["noise", "sim"])
def test_ic_angles_match_jax(kind):
    """`ic_angle_sparse` and `ic_angle_integral` (on the twin's maps)
    against their JAX functions: within 1e-4 rad where the moment vector is
    not tiny (the same float32 operations up to atan2's last bits)."""
    stack = _stack(kind)
    n, h, w = stack.shape
    plane, xy, base = _keypoints(7, n, h, w)
    j_sparse = np.asarray(jorb.ic_angle_sparse(jnp.asarray(stack), jnp.asarray(base),
                                               jnp.asarray(xy)))
    t_sparse = torb.ic_angle_sparse(_t(stack), _t(base), _t(xy)).numpy()
    j10, j01 = jorb.moment_maps_integral(jnp.asarray(stack))
    j_int = np.asarray(jorb.ic_angle_integral(j10.reshape(-1), j01.reshape(-1),
                                              jnp.asarray(base), jnp.asarray(xy), h, w))
    t10, t01 = tmoments.moment_maps_plain(_t(stack))
    t_int = tmoments.ic_angle_integral(t10.reshape(-1), t01.reshape(-1), _t(base), _t(xy),
                                       h, w).numpy()
    keep = _well_conditioned(t10.numpy(), t01.numpy(), plane, xy)
    assert keep.sum() > (250 if kind == "noise" else 50)
    assert _wrap(t_sparse - j_sparse)[keep].max() < 1e-4
    assert _wrap(t_int - j_int)[keep].max() < 1e-4
    # the two formulations agree with each other as the JAX ones do
    assert _wrap(t_sparse - t_int)[keep].max() < 2e-3


def test_gaussian_blur7_matches_jax():
    """Reflect-101 7x7 blur of a stack: within 1e-4 on 0-255 data (the same
    taps in the same order; XLA may fuse a multiply-add)."""
    stack = _stack("noise")
    ref = np.asarray(jorb.gaussian_blur7(jnp.asarray(stack)))
    got = torb.gaussian_blur7(_t(stack)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_brief_descriptors_pool_matches_jax():
    """Pool BRIEF on the same blurred stack, keypoints and angles: at most
    1e-3 of the bits differ (a rotated pool point within one float32 ulp of
    .5 can round apart where XLA fuses the rotation's multiply-adds, and
    the two packages' cos and sin differ in the last bit)."""
    stack = _stack("noise")
    n, h, w = stack.shape
    _, xy, base = _keypoints(9, n, h, w)
    blur = np.asarray(jorb.gaussian_blur7(jnp.asarray(stack)))
    angle = np.random.default_rng(1).uniform(-np.pi, np.pi, len(xy)).astype(F32)
    ref = np.asarray(jorb.brief_descriptors_pool(
        jnp.asarray(blur).reshape(-1), jnp.asarray(base), jnp.asarray(xy),
        jnp.asarray(angle), h, w))
    oc = torb.build_orb_constants(h, w, torb.OrbConfig(n_levels=1), "cpu")
    got = torb.brief_descriptors_pool(_t(blur).reshape(-1), _t(base), _t(xy), _t(angle),
                                      h, w, oc).numpy()
    assert got.shape == ref.shape == (len(xy), 256) and got.dtype == np.int8
    assert set(np.unique(got)) == {-1, 1}
    assert (got != ref).mean() <= 1e-3, (got != ref).mean()


def test_moment_maps_on_cpu_runs_the_twin():
    stack = _t(_stack("noise"))
    before = tmoments.moment_maps.launches
    got = tmoments.moment_maps(stack)
    ref = tmoments.moment_maps_plain(stack)
    assert tmoments.moment_maps.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_moment_maps_plain_equals_the_direct_circle_sums():
    """The twin against the definition, summed directly in float64 over the
    709 pixels of the circle with zeros beyond the canvas: within 1e-5 of
    the largest |moment| on every pixel."""
    stack = _t(_stack("noise")[:2, :60, :100].copy())
    r = tmoments.PATCH_R
    j = tmoments.zero_mean(stack).double()
    jp = torch.nn.functional.pad(j, (r, r, r, r))
    d10, d01 = torch.zeros_like(j), torch.zeros_like(j)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy <= r * r:
                part = jp[:, r + dy:r + dy + 60, r + dx:r + dx + 100]
                d10 += dx * part
                d01 += dy * part
    t10, t01 = tmoments.moment_maps_plain(stack)
    assert (t10 - d10).abs().max() <= 1e-5 * d10.abs().max()
    assert (t01 - d01).abs().max() <= 1e-5 * d01.abs().max()


# ---- on the card: the CUDA kernel against its twin (skipped without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 120, 160), (3, 75, 1242)])
def test_moment_maps_kernel_matches_twin_on_gpu(gpu, shape):
    """K4 against its twin on the whole map, within 1e-3 of the plane's
    largest |moment| (the kernel sums over its tile, the twin over whole
    rows)."""
    stack = _t(np.random.default_rng(2).uniform(0, 255, shape).astype(F32)).to(gpu)
    before = tmoments.moment_maps.launches
    got = tmoments.moment_maps(stack)
    ref = tmoments.moment_maps_plain(stack)
    torch.cuda.synchronize()
    assert tmoments.moment_maps.launches == before + 1
    for a, b in zip(got, ref):
        scale = b.abs().amax(dim=(1, 2), keepdim=True)
        assert bool(((a - b).abs() <= 1e-3 * scale).all())
