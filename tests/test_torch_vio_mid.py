"""PyTorch port vs the JAX package: the frame step at full pyramid depth.

384x240 stereo, 8 levels, 400 features, 400 landmarks, with the production
LM cap (15 iterations) and capacities (pool 1024, 256 matches, IMU chunk 32
at 10 Hz): the EuRoC workload's depth, budgets and capacities at half its
width, the largest configuration whose JAX step (sampler in interpret mode)
compiles on a CPU within a test's time.

At this depth the two packages do not follow one trajectory. The resampled
pyramid levels come from matrix products whose float32 sums round
differently in the last bit, so one or two of ~150 stereo matches differ;
RANSAC draws its 8-tuples by index among the valid matches, so one more
match changes every hypothesis, and the tracked set and the BA result move
by millimetres to centimetres. The tests therefore hold (1) one step per
frame from JAX's own state, within bounds set from measurement, and (2) the
drift of whole chains over several RANSAC seeds, as a distribution.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_parity import jax_setup, ransac_uniforms, to_np, torch_setup, world  # noqa: E402

from pose_estimation_tpu_torch import convert  # noqa: E402

MID = dict(width=384, height=240, levels=8, features=400, camera_frequency=10, imu_chunk=32)
N_LANDMARKS = 400
N_FRAMES = 8
N_SEEDS = 6


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def _jax_chains():
    """For each RANSAC seed: JAX's states before each frame, its metrics and
    the uniforms it drew; plus the frame inputs."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_setup(**MID)
    inputs = world(N_FRAMES, N_LANDMARKS, **MID)
    frames, gyrs, accs, mask, state0 = inputs
    step = jax.jit(functools.partial(jvio.ok_step, consts=consts, static=static))
    chains = []
    for seed in range(N_SEEDS):
        st = seeded_state(static, state0)
        states, metrics, us = [to_np(st)], [], []
        for i in range(N_FRAMES):
            key = jax.random.PRNGKey(1000 * seed + i)
            us.append(ransac_uniforms(key))
            st, m = step(st, *frames[i], gyrs[i], accs[i], mask, key)
            states.append(to_np(st))
            metrics.append(to_np(m))
        chains.append((states, metrics, us))
    return chains, inputs


@functools.lru_cache(maxsize=1)
def _port():
    return torch_setup(**MID)[1:]


def _port_step(state, i, us, inputs):
    from pose_estimation_tpu_torch.models import vio as tvio

    consts, static = _port()
    frames, gyrs, accs, mask, _ = inputs
    return tvio.ok_step(
        state, _t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask),
        None, consts, static, ransac_u=tuple(_t(u) for u in us[i]),
    )


def test_step_per_frame_at_full_depth_matches_jax():
    """One ok_step from JAX's state on each of frames 1-7 (seed 0), at the
    production LM cap: stereo counts within 4 % (measured: at most 2.7 %),
    tracking and BA alive, newest position within 5 cm on every frame and
    1.5 cm in the median (measured: 0.2-26 mm, median 6 mm; the large ones
    are frames whose tracked sets differ by a few features). The keyframe
    decision is a threshold on the pose and may flip with these gaps."""
    chains, inputs = _jax_chains()
    states, metrics, us = chains[0]
    gaps = []
    for i in range(1, N_FRAMES):
        _, m = _port_step(convert.state_from_numpy(states[i], "cpu"), i, us, inputs)
        jm = metrics[i]
        assert abs(int(m["n_stereo"]) - int(jm["n_stereo"])) <= 0.04 * int(jm["n_stereo"]), i
        assert int(m["n_tracked"]) > 0 and int(m["ba_iters"]) > 0, i
        gaps.append(float(np.linalg.norm(m["rec_p"].numpy() - jm["rec_p"])))
    assert max(gaps) <= 0.05, gaps
    assert float(np.median(gaps)) <= 0.015, gaps


def test_chained_drift_over_seeds_matches_jax():
    """Both packages chained over 8 frames from the same seeded state with
    the same uniforms, for 6 RANSAC seeds: the port's median final position
    error within 1.5x JAX's (measured on 16 seeds: see PERF.md), and every
    port chain finite and tracking."""
    chains, inputs = _jax_chains()
    _, _, _, _, state0 = inputs
    truth = state0(N_FRAMES)[1]
    jax_err, port_err = [], []
    for states, metrics, us in chains:
        jax_err.append(float(np.linalg.norm(metrics[-1]["rec_p"] - truth)))
        s = convert.state_from_numpy(states[0], "cpu")
        for i in range(N_FRAMES):
            s, m = _port_step(s, i, us, inputs)
            assert np.isfinite(m["rec_p"].numpy()).all()
            assert i == 0 or int(m["n_tracked"]) > 0
        port_err.append(float(np.linalg.norm(m["rec_p"].numpy() - truth)))
    assert np.median(port_err) <= 1.5 * np.median(jax_err), (port_err, jax_err)
