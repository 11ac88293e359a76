"""The benchmark's generator against the port's simulator, at a tiny size
on the CPU: the same landmarks from a seed, the same images to within the
`uint8` rounding, the same IMU, and frame i's IMU chunk equal to what the
state machine's queue hands frame i when the samples are fed as the
stream traffic feeds them."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pose_estimation_tpu_torch.testing import (  # noqa: E402
    StereoInertialSim, set_family, sim_config, synthetic_config)
from vio_bench import world as W  # noqa: E402


def _rig(cfg):
    return W.Rig(cfg.image_width, cfg.image_height, cfg.k_left, cfg.r_cb, cfg.t_lr)


@pytest.mark.parametrize("make", [
    lambda: synthetic_config(width=160, height=120, levels=2, features=100),
    lambda: sim_config(dataset="kitti", width=200, height=64),
])
def test_render_matches_the_simulator(make):
    cfg = make()
    sim = StereoInertialSim(cfg, n_landmarks=300, seed=5, y_max=9.0)
    set_family(sim, "B")
    lm, patches = W.landmarks(5, 300, -3.0, 9.0)
    assert np.array_equal(lm, sim.lm) and np.array_equal(patches, sim.patches)
    times = [0.5, 1.3, 2.7]
    left, right = W.render(_rig(cfg), torch.as_tensor(lm), torch.as_tensor(patches), times,
                           "cpu")
    for i, t in enumerate(times):
        for got, want in zip((left[i], right[i]), sim.render(t)):
            want = np.clip(want, 0, 255).astype(np.uint8).astype(np.int32)
            diff = np.abs(got.numpy().astype(np.int32) - want)
            assert diff.max() <= 1, diff.max()
            assert (diff > 0).mean() < 1e-3


def test_imu_and_truth_match_the_simulator():
    cfg = synthetic_config(width=160, height=120, levels=2, features=100)
    sim = StereoInertialSim(cfg, n_landmarks=10, seed=0)
    set_family(sim, "B")
    g_w = W.G * np.asarray(cfg.profile.gravity_dir)
    ts = np.array([0.5, 0.505, 3.25, 9.0])
    w, f = W.imu_at(ts, g_w)
    for i, t in enumerate(ts):
        w2, f2 = sim.imu_at(t)
        np.testing.assert_allclose(w[i], w2, atol=1e-9)
        np.testing.assert_allclose(f[i], f2, atol=1e-9)
        np.testing.assert_allclose(W.rot(t), sim.traj.rot(t), atol=1e-12)
        np.testing.assert_allclose(W.pos(t), sim.traj.pos(t), atol=1e-12)
        np.testing.assert_allclose(W.vel_at(t), sim.vel_at(t), atol=1e-12)


def _world(cfg, n, seed=3, noise=2.4e-3):
    return W.World(_rig(cfg), cfg.profile.gravity_dir, cfg.sampling_rate, cfg.camera_frequency,
                   cfg.imu_chunk, n, seed, 20.0, noise, "cpu")


def test_world_is_made_from_the_seed():
    cfg = synthetic_config(width=96, height=64, levels=2, features=64, camera_frequency=20)
    a, b, c = _world(cfg, 6, seed=3), _world(cfg, 6, seed=3), _world(cfg, 6, seed=4)
    assert np.array_equal(a.left, b.left) and np.array_equal(a.gyr, b.gyr)
    assert not np.array_equal(a.left, c.left) and not np.array_equal(a.gyr, c.gyr)
    assert a.left.dtype == np.uint8 and a.left.shape == (6, 64, 96)
    longer = _world(cfg, 400, seed=3)
    assert np.array_equal(longer.left[:6], a.left) and np.array_equal(longer.gyr[:a.gyr.shape[0]], a.gyr)
    noise = a.gyr - W.imu_at(a.sample_t, a.g_w)[0]
    assert 1.5e-3 < noise.std() < 3.5e-3


def test_chunks_are_what_the_state_machine_pops():
    from pose_estimation_tpu_torch.slam import SensorType, VisualInertialSLAM

    cfg = synthetic_config(width=96, height=64, levels=2, features=64, camera_frequency=20,
                           max_keypoints=64, max_matches=32, pool_capacity=128, imu_chunk=16)
    world = _world(cfg, 5)
    slam = VisualInertialSLAM(cfg, device="cpu")
    for i in range(5):
        for k in world.samples_before(i):
            ts = world.sample_ns(k)
            slam.collect_imu_data(SensorType.GYROSCOPE, ts, *world.gyr[k])
            slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *world.acc[k])
        if i == 0:
            assert slam._synchronize(world.frame_ns(0))
            continue
        (gyr, acc, mask), = slam._pop_imu_chunks(world.frame_ns(i))
        g, a, m = world.chunk(i)
        assert np.array_equal(mask.numpy(), m)
        assert np.array_equal(gyr.numpy(), g) and np.array_equal(acc.numpy(), a)
