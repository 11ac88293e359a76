"""PyTorch port vs the JAX package: Lie algebra, IMU preintegration (the
scan form and its loop oracle; tests/test_torch_preintegration.py has more),
keypoint rectification, triangulation, and the port's copies of the JAX
package's JAX-free records (config, camera model, BRIEF pattern).

Inputs come from numpy seeds and run through both packages in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu.imu import preintegration as jpre  # noqa: E402
from pose_estimation_tpu.ops import remap as jremap  # noqa: E402
from pose_estimation_tpu.ops import triangulate as jtri  # noqa: E402
from pose_estimation_tpu.utils import lie as jlie  # noqa: E402
from pose_estimation_tpu_torch.imu import preintegration as tpre  # noqa: E402
from pose_estimation_tpu_torch.ops import remap as tremap  # noqa: E402
from pose_estimation_tpu_torch.ops import triangulate as ttri  # noqa: E402
from pose_estimation_tpu_torch.utils import lie as tlie  # noqa: E402

F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _rot_vecs(rng, n, scale):
    return (rng.normal(size=(n, 3)) * scale).astype(F32)


# float32 results of the same formulas in the same order: a few ulps
# (transcendentals and reductions may round differently between XLA and
# ATen), so 2e-6 absolute on O(1) quantities.
LIE_TOL = 2e-6


@pytest.mark.parametrize("scale", [1e-3, 0.05, 0.8, 2.5])
def test_lie_maps_match_jax(scale):
    rng = np.random.default_rng(int(scale * 1000))
    w = _rot_vecs(rng, 64, scale)
    for jf, tf in ((jlie.hat, tlie.hat), (jlie.so3_exp, tlie.so3_exp),
                   (jlie.right_jacobian, tlie.right_jacobian),
                   (jlie.right_jacobian_inverse, tlie.right_jacobian_inverse)):
        np.testing.assert_allclose(tf(_t(w)).numpy(), np.asarray(jf(_j(w))),
                                   atol=LIE_TOL, rtol=0)
    r = np.asarray(jlie.so3_exp(_j(w)))
    np.testing.assert_allclose(tlie.so3_log(_t(r)).numpy(),
                               np.asarray(jlie.so3_log(_j(r))), atol=LIE_TOL, rtol=0)
    np.testing.assert_allclose(tlie.mat_to_quat(_t(r)).numpy(),
                               np.asarray(jlie.mat_to_quat(_j(r))), atol=LIE_TOL, rtol=0)
    np.testing.assert_array_equal(tlie.vee(tlie.hat(_t(w))).numpy(), w)


def test_sin_cos_is_bit_identical():
    """The Cody-Waite + Taylor sin/cos is elementwise arithmetic only; the
    preintegration recurrences are matched to it, so it must agree exactly."""
    th = np.random.default_rng(1).uniform(-7, 7, 4096).astype(F32)
    ts, tc = tlie.sin_cos(_t(th))
    js, jc = jlie.sin_cos(_j(th))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _imu_inputs(seed, m=16, n_valid=12):
    rng = np.random.default_rng(seed)
    gyr = (rng.normal(size=(m, 3)) * 0.5).astype(F32)
    acc = (rng.normal(size=(m, 3)) * 2 + [9.81, 0, 0]).astype(F32)
    mask = np.arange(m) < n_valid
    bg = (rng.normal(size=3) * 0.01).astype(F32)
    ba = (rng.normal(size=3) * 0.1).astype(F32)
    return gyr, acc, mask, bg, ba


def _imu_params():
    from torch_parity import SMALL

    from pose_estimation_tpu.testing import synthetic_config

    cfg = synthetic_config(**SMALL)
    return cfg, jpre.ImuParams.from_config(cfg), tpre.ImuParams.from_config(cfg, "cpu")


def _state_close(t_state, j_state, rtol):
    for name, tv, jv in zip(t_state._fields, t_state, j_state):
        jv = np.asarray(jv)
        scale = max(np.abs(jv).max(), 1e-30)
        np.testing.assert_allclose(tv.numpy(), jv, atol=rtol * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_chunk_matches_sequential_oracle(seed):
    """The port's sample loop (`integrate_chunk_sequential`) against the
    JAX sequential oracle and the JAX associative-scan fast path, and the
    port's scan (`integrate_chunk`) against that fast path, chained over
    two chunks. Tolerance 1e-5 relative to each field's magnitude: float32
    recurrences of the same math, reassociated only inside the 3x3/9x9
    products; the two scans follow one association order, 1e-6."""
    gyr, acc, mask, bg, ba = _imu_inputs(seed)
    _, jp, tp = _imu_params()
    js = jpre.init_state(jnp.float32)
    ts = tpre.init_state("cpu")
    js_fast, ts_fast = js, ts
    for _ in range(2):
        js = jpre.integrate_chunk_sequential(js, _j(gyr), _j(acc), _j(mask), _j(bg), _j(ba), jp)
        js_fast = jpre.integrate_chunk(js_fast, _j(gyr), _j(acc), _j(mask), _j(bg), _j(ba), jp)
        ts = tpre.integrate_chunk_sequential(ts, _t(gyr), _t(acc), _t(mask), _t(bg), _t(ba), tp)
        ts_fast = tpre.integrate_chunk(ts_fast, _t(gyr), _t(acc), _t(mask), _t(bg), _t(ba), tp)
    _state_close(ts, js, 1e-5)
    _state_close(ts, js_fast, 1e-4)
    _state_close(ts_fast, js_fast, 1e-6)

    jic = jpre.finalize(js, _j(bg), _j(ba), jp)
    tic = tpre.finalize(ts, _t(bg), _t(ba), tp)
    _state_close(tic, jic, 1e-4)

    rng = np.random.default_rng(seed + 10)
    dbg = (rng.normal(size=3) * 1e-3).astype(F32)
    dba = (rng.normal(size=3) * 1e-2).astype(F32)
    _state_close(tpre.repropagate(tic, _t(dbg), _t(dba)),
                 jpre.repropagate(jic, _j(dbg), _j(dba)), 1e-5)
    R = np.asarray(jlie.so3_exp(_j(_rot_vecs(rng, 1, 0.3)[0])))
    v, p, g = (rng.normal(size=3).astype(F32) for _ in range(3))
    for kw_t, kw_j in (({}, {}), (dict(dbg_i=_t(dbg), dba_i=_t(dba)),
                                 dict(dbg_i=_j(dbg), dba_i=_j(dba)))):
        got = tpre.predict(_t(R), _t(v), _t(p), tic, _t(g), **kw_t)
        ref = jpre.predict(_j(R), _j(v), _j(p), jic, _j(g), **kw_j)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_masked_samples_leave_state_untouched():
    gyr, acc, _, bg, ba = _imu_inputs(3)
    _, _, tp = _imu_params()
    s0 = tpre.init_state("cpu")
    s1 = tpre.integrate_chunk(s0, _t(gyr), _t(acc), torch.zeros(16, dtype=torch.bool),
                              _t(bg), _t(ba), tp)
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)


def test_rectify_points_with_distortion():
    """Distorted raw camera + a rectifying rotation; 5 fixed-point
    iterations of the same float32 arithmetic: 1e-3 px."""
    rng = np.random.default_rng(7)
    xy = rng.uniform([0, 0], [752, 480], (500, 2)).astype(F32)
    k = np.array([458.6, 457.3, 367.2, 248.4], F32)
    dist = np.array([-0.28, 0.07, 1.9e-4, 1.8e-5, 0.0], F32)
    r = np.asarray(jlie.so3_exp(_j(np.array([0.01, -0.02, 0.005], F32))))
    p = np.array([[435.2, 0, 367.4, 0], [0, 435.2, 252.2, 0], [0, 0, 1, 0]], F32)
    got = tremap.rectify_points(_t(xy), _t(k), _t(dist), _t(r), _t(p)).numpy()
    ref = np.asarray(jremap.rectify_points(_j(xy), _j(k), _j(dist), _j(r), _j(p)))
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_triangulate_matches_jax():
    """Rectified stereo pairs at 0.5-12 m: the 4x4 adjugate is a sum of
    triple products of O(1e5) entries, so float32 results agree to ~1e-5
    relative; compared at 1e-4 of the depth."""
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.testing import synthetic_config

    cm = CameraModel.from_config(synthetic_config(width=752, height=480))
    p1, p2 = cm.P1.astype(F32), cm.P2.astype(F32)
    rng = np.random.default_rng(3)
    x = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400),
                  rng.uniform(0.5, 12, 400)], 1)

    def proj(p):
        h = (p[:, :3] @ x.T + p[:, 3:4]).T
        return (h[:, :2] / h[:, 2:]).astype(F32)

    px1, px2 = proj(cm.P1), proj(cm.P2)
    got = ttri.triangulate(_t(p1), _t(p2), _t(px1), _t(px2)).numpy()
    ref = np.asarray(jtri.triangulate(_j(p1), _j(p2), _j(px1), _j(px2)))
    np.testing.assert_allclose(got, ref, atol=0, rtol=1e-4)
    np.testing.assert_allclose(got, x, rtol=2e-3)


@pytest.mark.parametrize("dataset", ["euroc", "kitti"])
def test_config_and_camera_copies_equal_jax(dataset):
    """The port keeps its own copies of the JAX package's JAX-free
    records; they must not drift."""
    import dataclasses

    from pose_estimation_tpu.camera import CameraModel as JCM
    from pose_estimation_tpu.testing import synthetic_config as jsyn
    from pose_estimation_tpu.utils import config as jconfig
    from pose_estimation_tpu_torch.camera import CameraModel as TCM
    from pose_estimation_tpu_torch.testing import synthetic_config as tsyn
    from pose_estimation_tpu_torch.utils import config as tconfig

    kw = dict(width=752, height=480, levels=8, features=800, dataset=dataset,
              dist_left=np.array([-0.28, 0.07, 2e-4, 1.8e-5, 0.0]),
              r_lr=np.asarray(jlie.so3_exp(jnp.asarray([0.002, -0.01, 0.003]))),
              t_lr=np.array([-0.11, 0.001, 0.0005]))
    jc, tc = jsyn(**kw), tsyn(**kw)
    assert [f.name for f in dataclasses.fields(jc)] == [f.name for f in dataclasses.fields(tc)]
    for f in dataclasses.fields(jc):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f.name)),
                                      np.asarray(getattr(tc, f.name)), err_msg=f.name)
    assert jc.discrete_noise() == tc.discrete_noise()
    np.testing.assert_array_equal(jc.gravity, tc.gravity)
    assert {k: dataclasses.asdict(v) for k, v in jconfig.PROFILES.items()} == {
        k: dataclasses.asdict(v) for k, v in tconfig.PROFILES.items()}
    jm, tm = JCM.from_config(jc), TCM.from_config(tc)
    for name in ("R1", "R2", "P1", "P2", "R_cb", "p_cb"):
        np.testing.assert_array_equal(getattr(jm, name), getattr(tm, name), err_msg=name)


def test_precision_policy_turns_tf32_off():
    from pose_estimation_tpu_torch.utils import precision

    torch.backends.cuda.matmul.allow_tf32 = True
    precision.apply_policy()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError):
            precision.apply_policy()
    finally:
        torch.set_float32_matmul_precision(prev)


def test_require_cuda_raises_without_gpu():
    from pose_estimation_tpu_torch.utils import precision

    if torch.cuda.is_available():
        assert precision.require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            precision.require_cuda()
