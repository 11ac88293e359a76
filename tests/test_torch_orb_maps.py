"""PyTorch port vs the JAX package: the map-based ORB front end.

`extract_batch` with `fast_backend="xla", sample_backend="xla"` against the
JAX package's, for each `moments_backend`; the frame step and a short run
of the host state machine on that front end against the JAX package's,
whose CPU default it is. On a CPU tensor `moments_backend="pallas"` runs
kernel K4's twin; the JAX side then runs its Pallas kernel in interpret
mode (orb.py calls it without the switch, so the test passes it in).
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import sim as jsim  # noqa: E402
from torch_parity import (MAP_BACKENDS, jax_map_setup, ransac_uniforms, to_np,  # noqa: E402
                          torch_map_setup, world)

from pose_estimation_tpu.ops import pallas_fast as jpallas  # noqa: E402
from pose_estimation_tpu.slam import VisualInertialSLAM as JSLAM  # noqa: E402
from pose_estimation_tpu_torch import convert, testing  # noqa: E402
from pose_estimation_tpu_torch.io import ate as tate  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402
from pose_estimation_tpu_torch.ops import moments as tmoments  # noqa: E402
from pose_estimation_tpu_torch.ops import sample as tsample  # noqa: E402
from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM  # noqa: E402

LM_ITERS = 4
N_FRAMES = 5
# angles are compared where the moment vector is not tiny (see
# tests/test_torch_moments.py); the blurred-canvas descriptor bits elsewhere
MIN_MOMENT = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _wrap(d):
    return np.abs((np.asarray(d) + np.pi) % (2 * np.pi) - np.pi)


@pytest.mark.parametrize("moments_backend", ["sparse", "integral", "pallas"])
def test_extract_pair_on_the_map_path_matches_jax(moments_backend):
    """ORB of a sim stereo pair at 160x128 through the map path of both
    packages. Valid sets, levels and level-0 scores exact, coordinates
    within 1e-3 px (the resampled levels come from matrix products whose
    float32 sums may differ in the last bit: valid sets within 1 %), angles
    within 2e-3 rad where the moment vector is not tiny, descriptor
    bit-flip rate <= 1e-3 on keypoints both keep. K1, K2 and K3 stay
    unused, and a CPU tensor counts no K4 launch."""
    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch.models import vio as tvio

    _, jconsts, jstatic = jax_map_setup(moments_backend)
    _, tconsts, tstatic = torch_map_setup(moments_backend)
    l, r = world(2)[0][1]
    interpret = functools.partial(jpallas.moment_maps_pallas, interpret=True)
    with mock.patch.object(jpallas, "moment_maps_pallas", interpret):
        jf2 = to_np(jax.jit(lambda a, b: jvio.extract_rectified(a, b, jconsts, jstatic))(l, r))
    with mock.patch.object(tfast, "select_plain") as k1, \
            mock.patch.object(tfast, "score_nms_plain") as k3, \
            mock.patch.object(tsample, "sample_patches_plain") as k2, \
            mock.patch.object(tmoments, "moment_maps_plain",
                              wraps=tmoments.moment_maps_plain) as k4:
        before = tmoments.moment_maps.launches
        tf2 = tvio.extract_rectified(_t(l), _t(r), tconsts, tstatic)
    assert (k1.call_count, k2.call_count, k3.call_count) == (0, 0, 0)
    assert k4.call_count == (0 if moments_backend == "sparse" else 1)
    assert tmoments.moment_maps.launches == before
    for jf, tf in zip(jf2, tf2):
        jvalid, tvalid = jf.valid, tf.valid.numpy()
        assert jvalid.sum() > 50
        both = jvalid & tvalid
        assert (jvalid != tvalid).sum() <= 0.01 * jvalid.sum()
        np.testing.assert_allclose(tf.xy.numpy()[both], jf.xy[both], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(tf.level.numpy(), jf.level)
        lvl0 = both & (jf.level == 0)
        np.testing.assert_array_equal(tf.score.numpy()[lvl0], jf.score[lvl0])
        np.testing.assert_array_equal(tf.xy.numpy()[lvl0], jf.xy[lvl0])
        assert _wrap(tf.angle.numpy() - jf.angle)[both].max() < 2e-3
        assert (tf.desc.numpy()[both] != jf.desc[both]).mean() <= 1e-3


@functools.lru_cache(maxsize=1)
def _jax_chain():
    """JAX states before each frame, its metrics, and the frame inputs, on
    the JAX package's CPU default front end (xla / xla / sparse)."""
    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_map_setup(max_num_iterations=LM_ITERS)
    frames, gyrs, accs, mask, state0 = world(N_FRAMES)
    step = jax.jit(functools.partial(jvio.ok_step, consts=consts, static=static))
    st = jsim.seeded_state(static, state0)
    states, metrics, us = [to_np(st)], [], []
    for i in range(N_FRAMES):
        key = jax.random.PRNGKey(i)
        us.append(ransac_uniforms(key))
        st, m = step(st, *frames[i], gyrs[i], accs[i], mask, key)
        states.append(to_np(st))
        metrics.append(to_np(m))
    return states, metrics, us, (frames, gyrs, accs, mask)


def _port_step(state, i, us, inputs, consts, static):
    from pose_estimation_tpu_torch.models import vio as tvio

    frames, gyrs, accs, mask = inputs
    return tvio.ok_step(
        state, _t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask),
        None, consts, static, ransac_u=tuple(_t(u) for u in us[i]),
    )


@pytest.mark.parametrize("moments_backend", ["sparse", "pallas"])
def test_ok_step_on_the_map_path_matches_jax(moments_backend):
    """One ok_step from the same converted state on each of frames 1-4,
    and the port's own chain over all five, to the bounds of
    tests/test_torch_vio.py (LM capped at 4 iterations): counts within
    2 %, BA iterations equal, position within 1e-3 m and rotation within
    1e-3 rad per frame, the chain within 5 mm. With "pallas" the port takes
    K4's twin where the JAX side samples the prefix images."""
    states, metrics, us, inputs = _jax_chain()
    _, consts, static = torch_map_setup(moments_backend, max_num_iterations=LM_ITERS)
    for i in range(1, N_FRAMES):
        _, m = _port_step(convert.state_from_numpy(states[i], "cpu"), i, us, inputs,
                          consts, static)
        jm = metrics[i]
        for k in ("n_stereo", "n_tracked"):
            assert abs(int(m[k]) - int(jm[k])) <= 0.02 * int(jm[k]), (i, k)
        assert int(m["n_tracked"]) > 20
        assert int(m["ba_iters"]) == int(jm["ba_iters"]) > 0
        assert np.abs(m["rec_p"].numpy() - jm["rec_p"]).max() <= 1e-3, i
        c = (np.trace(m["rec_R"].numpy().T @ jm["rec_R"]) - 1) / 2
        assert np.arccos(np.clip(c, -1, 1)) <= 1e-3, i
        assert bool(m["is_keyframe"]) == bool(jm["is_keyframe"])
        assert int(m["pool_size"]) == int(jm["pool_size"])
    s = convert.state_from_numpy(states[0], "cpu")
    for i in range(N_FRAMES):
        s, m = _port_step(s, i, us, inputs, consts, static)
        assert np.linalg.norm(m["rec_p"].numpy() - metrics[i]["rec_p"]) <= 5e-3, i


def test_state_machine_on_the_map_path_runs_like_jax():
    """2 s of the noisy sim (320x240, 4 levels) through both state machines
    on the map front end, the port's with K4's twin. Both go SYNC -> SFM ->
    INIT -> OK and record the same frames from the same timestamp on; each
    stays within 2 x distance + 1 m of the truth after alignment; and the
    two trajectories, which differ by their random draws (the packages'
    generators are not the same), stay within 0.25 m of each other
    (measured 0.03-0.09 m)."""
    kw = dict(keyframe_rotation=0.1, keyframe_translation=0.15)
    jcfg = jsim.sim_config(**kw)
    jslam = JSLAM(jcfg, verbose=False)
    assert jslam.static.orb.sample_backend == "xla"
    jgt = jsim.StereoInertialSim(jcfg, n_landmarks=150, seed=0).run(
        jslam, duration=2.0, imu_noise=2.4e-3, seed=10)

    tcfg = testing.sim_config(**MAP_BACKENDS, **kw)
    tslam = VisualInertialSLAM(tcfg, device="cpu")
    tslam.static = dataclasses.replace(
        tslam.static, orb=tslam.static.orb._replace(moments_backend="pallas"))
    with mock.patch.object(tmoments, "moment_maps_plain",
                           wraps=tmoments.moment_maps_plain) as k4, \
            mock.patch.object(tsample, "sample_patches_plain") as k2:
        tgt = testing.StereoInertialSim(tcfg, n_landmarks=150, seed=0).run(
            tslam, duration=2.0, imu_noise=2.4e-3, seed=10)
    np.testing.assert_array_equal(tgt, jgt)
    assert k2.call_count == 0 and k4.call_count >= len(tslam.trajectory)

    assert tslam.state == State.OK and jslam.state.name == "OK"
    tt, jt = np.asarray(tslam.trajectory), np.asarray(jslam.trajectory)
    assert tt.shape == jt.shape and len(tt) >= 10
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
    assert np.isfinite(tt).all()
    assert np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1).max() <= 0.25
    for traj in (tt, jt):
        e, g = tate.associate(traj, tgt)
        _, r, t = tate.umeyama(e, g)
        err = np.linalg.norm((r @ e.T).T + t - g, axis=1)
        dist = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(g, axis=0), axis=1))])
        assert (err <= 2 * dist + 1.0).all(), err.max()
