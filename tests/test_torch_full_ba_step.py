"""PyTorch port vs the JAX package: the frame step with keyframe full BA.

Both packages run `ok_step` with `full_ba_keyframes=True` on the kernel
path (the JAX sampler in interpret mode), as `test_torch_vio.py` does,
whose tolerances this file uses: keyframes at 3 cm so that every other
frame refines landmarks, and the motion BA capped at 4 LM iterations.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_parity import jax_setup, ransac_uniforms, to_np, torch_setup, world  # noqa: E402

from pose_estimation_tpu_torch import convert  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402

CFG = dict(max_num_iterations=4, keyframe_translation=0.03, keyframe_rotation=1.0,
           full_ba_keyframes=True, full_ba_iterations=4)
N_FRAMES = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def _jax_chain():
    """The JAX states before each frame, its metrics and the uniforms."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_setup(**CFG)
    assert static.full_ba_keyframes
    frames, gyrs, accs, mask, state0 = world(N_FRAMES)
    step = jax.jit(functools.partial(jvio.ok_step, consts=consts, static=static))
    st = seeded_state(static, state0)
    states, metrics, us = [to_np(st)], [], []
    for i in range(N_FRAMES):
        key = jax.random.PRNGKey(i)
        us.append(ransac_uniforms(key))
        st, m = step(st, *frames[i], gyrs[i], accs[i], mask, key)
        states.append(to_np(st))
        metrics.append(to_np(m))
    return states, metrics, us, (frames, gyrs, accs, mask)


def _rot_err(ra, rb):
    return float(np.arccos(np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1)))


def test_ok_step_with_full_ba_matches_jax():
    """One ok_step from the same converted state on each of frames 1-3:
    stereo and tracked counts within 2 %, BA iterations, keyframe flag and
    pool size equal, the newest position within 1e-3 m and rotation within
    1e-3 rad of the JAX step's; at least one of them is a keyframe with
    matches, where full BA moved the newest pose (against the port's step
    without it)."""
    states, metrics, us, (frames, gyrs, accs, mask) = _jax_chain()
    _, consts, static = torch_setup(**CFG)
    plain = dataclasses.replace(static, full_ba_keyframes=False)
    refined = 0
    for i in range(1, N_FRAMES):
        args = (_t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask), None,
                consts)
        u = tuple(_t(x) for x in us[i])
        _, m = tvio.ok_step(convert.state_from_numpy(states[i], "cpu"), *args, static,
                            ransac_u=u)
        jm = metrics[i]
        for k in ("n_stereo", "n_tracked"):
            assert abs(int(m[k]) - int(jm[k])) <= 0.02 * int(jm[k]), (i, k)
        assert int(m["n_tracked"]) > 20
        for k in ("ba_iters", "is_keyframe", "pool_size"):
            assert int(m[k]) == int(jm[k]), (i, k)
        assert np.abs(m["rec_p"].numpy() - jm["rec_p"]).max() <= 1e-3, i
        assert _rot_err(m["rec_R"].numpy(), jm["rec_R"]) <= 1e-3, i
        if bool(m["is_keyframe"]):
            _, pm = tvio.ok_step(convert.state_from_numpy(states[i], "cpu"), *args, plain,
                                 ransac_u=u)
            refined += not torch.equal(pm["rec_p"], m["rec_p"])
    assert refined >= 1
