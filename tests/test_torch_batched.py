"""PyTorch port: one frame step for many sequences (`parallel/batched.py`,
`parallel/batched_slam.py`).

- B = 2 against the JAX package's `jit(vmap(ok_step))` on the same states
  (converted), frames and RANSAC uniforms, at `torch_parity.SMALL` on the
  map front end (the JAX package's CPU default, which compiles and runs
  here far faster than its kernels in interpret mode);
- B = 5 at 8 levels (80 planes, beyond the 64 that kernels K1 and K2 once
  took) against five single-sequence `ok_step`s, with one extraction per
  batched frame;
- lanes that take different branches in one batch (no matches, a
  keyframe with marginalization, a plain frame) against their single
  steps;
- a lane of that batch bit-equal to itself in a batch of its own copies;
- `BatchedReplay` with two sequences in lock-step.

The motion BA is capped at 4 LM iterations where the JAX package is the
reference, as in `test_torch_vio.py` (the seeded window's solve is ill
posed). Keyframes at 3 cm make the chain alternate keyframes and plain
frames at 40 Hz.
"""

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_parity import (jax_map_setup, ransac_uniforms, to_np, torch_map_setup,  # noqa: E402
                          torch_setup, world)

from pose_estimation_tpu_torch import convert, testing  # noqa: E402
from pose_estimation_tpu_torch.io import ate as tate  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402
from pose_estimation_tpu_torch.ops import orb as torb  # noqa: E402
from pose_estimation_tpu_torch.ops import sample as tsample  # noqa: E402
from pose_estimation_tpu_torch.parallel import batched  # noqa: E402
from pose_estimation_tpu_torch.parallel.batched_slam import BatchedReplay  # noqa: E402
from pose_estimation_tpu_torch.slam import SensorType  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

CFG = dict(max_num_iterations=4, keyframe_translation=0.03, keyframe_rotation=1.0)
N_FRAMES = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs its files in parallel
    processes, and torch's default of a thread per core in each of them
    oversubscribes the machine (the state-machine runs here took ~8 s
    alone and ~600 s in a parallel run of the suite); the small tensors of
    these steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(i, frames, gyrs, accs, mask):
    return _t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask)


def _stack_inputs(idx, frames, gyrs, accs, mask):
    return tuple(torch.stack(parts) for parts in
                 zip(*(_inputs(i, frames, gyrs, accs, mask) for i in idx)))


@functools.lru_cache(maxsize=1)
def _jax_states():
    """The JAX package's states before frames 0..N_FRAMES-1 of the seeded
    chain (numpy trees), and the world."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_map_setup(**CFG)
    frames, gyrs, accs, mask, state0 = world(N_FRAMES)
    step = jax.jit(functools.partial(jvio.ok_step, consts=consts, static=static))
    st = seeded_state(static, state0)
    states = [to_np(st)]
    for i in range(N_FRAMES - 1):
        st, _ = step(st, *frames[i], gyrs[i], accs[i], mask, jax.random.PRNGKey(i))
        states.append(to_np(st))
    return states, (frames, gyrs, accs, mask)


def _rot_err(ra, rb):
    return float(np.arccos(np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1)))


def test_batched_step_matches_jax_vmap():
    """Lanes (state before frame 1, frame 1) and (state before frame 2,
    frame 2) of the JAX chain, through `jit(vmap(ok_step))` and through
    the port's batched step with `ransac_uniforms` of the same keys: per
    lane the stereo and tracked counts within 2 % (the tolerances of
    `test_torch_vio.py`), and so the pool sizes after a keyframe's
    insertion (measured: 149 against 150), BA iterations and keyframe
    flags equal, the newest position within 1e-3 m and rotation within
    1e-3 rad."""
    from pose_estimation_tpu.models import vio as jvio

    states, (frames, gyrs, accs, mask) = _jax_states()
    lanes = (1, 2)
    _, jconsts, jstatic = jax_map_setup(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(7), len(lanes))
    jstep = jax.jit(jax.vmap(functools.partial(jvio.ok_step, consts=jconsts, static=jstatic)))
    jstate = jax.tree.map(lambda *a: np.stack(a), *(states[j] for j in lanes))
    _, jm = jstep(jstate, np.stack([frames[j][0] for j in lanes]),
                  np.stack([frames[j][1] for j in lanes]), np.stack([gyrs[j] for j in lanes]),
                  np.stack([accs[j] for j in lanes]), np.stack([mask] * len(lanes)), keys)
    jm = to_np(jm)

    _, consts, static = torch_map_setup(**CFG)
    step = batched.make_batched_step(consts, static)
    state_b = batched.stack_states([convert.state_from_numpy(states[j], "cpu") for j in lanes])
    u_b = torch.stack([torch.stack([_t(u) for u in ransac_uniforms(k)]) for k in keys])
    _, m = step(state_b, *_stack_inputs(lanes, frames, gyrs, accs, mask), u_b)
    assert m["rec_p"].shape == (2, 3)
    for b in range(len(lanes)):
        for k in ("n_stereo", "n_tracked", "pool_size"):
            assert abs(int(m[k][b]) - int(jm[k][b])) <= 0.02 * int(jm[k][b]), (b, k)
        assert int(m["n_tracked"][b]) > 20
        for k in ("ba_iters", "is_keyframe"):
            assert int(m[k][b]) == int(jm[k][b]), (b, k)
        assert np.abs(m["rec_p"][b].numpy() - jm["rec_p"][b]).max() <= 1e-3, b
        assert _rot_err(m["rec_R"][b].numpy(), jm["rec_R"][b]) <= 1e-3, b
    # the two lanes took different branches: a keyframe and a plain frame
    assert sorted(int(k) for k in m["is_keyframe"]) == [0, 1]


def _close_lanes(got, ref, b):
    """Lane b of a batched state against a single step's: integer and bool
    leaves equal, floating leaves within 2e-4 x max(1, the leaf's largest
    magnitude). Batched and single float32 products round differently, and
    the solver carries that into the poorly observed biases (measured: 1.1e-4
    in an acc bias of 8e-3, 9e-5 m/s in velocities, 7e-6 m in positions)."""
    for x, y in zip(tree_leaves(batched.lane(got, b)), tree_leaves(ref)):
        x, y = x.numpy(), y.numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=2e-4 * max(1.0, np.abs(y).max()))
        else:
            np.testing.assert_array_equal(x, y)


def test_batched_step_equals_single_steps_beyond_64_planes():
    """B = 5 at 8 pyramid levels (`init_batched_state` repeats the initial
    state): each batched frame extracts once, over a
    stack of 2 x 5 x 8 = 80 planes (the FAST-select and sampler twins
    called once a frame), and two chained batched frames equal five
    single-sequence chains: integer state and counts exactly, floats as
    `_close_lanes` says, the newest positions within 1e-5 m."""
    cfg, consts, static = torch_setup(levels=8, **CFG)
    frames, gyrs, accs, mask, truth = testing.sim_frames(cfg, 6, n_landmarks=250)
    b = 5
    gen = torch.Generator().manual_seed(3)
    us = [[torch.stack(tvio.draw_ransac_uniforms(gen, "cpu")) for _ in range(b)]
          for _ in range(2)]
    singles = [testing.seeded_state(static, truth, "cpu", j) for j in range(b)]
    state_b = batched.stack_states(singles)
    fresh = batched.init_batched_state(static, b, "cpu")
    for a, f in zip(tree_leaves(fresh), tree_leaves(tvio.init_vio_state(static, "cpu"))):
        assert a.shape == (b,) + f.shape and all(torch.equal(x, f) for x in a)
    step = batched.make_batched_step(consts, static)
    with mock.patch.object(torb, "extract_batch", wraps=torb.extract_batch) as ext, \
            mock.patch.object(tfast, "select_plain", wraps=tfast.select_plain) as k1, \
            mock.patch.object(tsample, "sample_stack_plain",
                              wraps=tsample.sample_stack_plain) as k2:
        for f in range(2):
            idx = [j + f for j in range(b)]
            state_b, m = step(state_b, *_stack_inputs(idx, frames, gyrs, accs, mask),
                              torch.stack(us[f]))
            assert ext.call_count == k1.call_count == k2.call_count == f + 1
            assert ext.call_args[0][0].shape == (2 * b, 128, 160)
            assert k1.call_args[0][0].shape[0] == 2 * b * 8
    assert int(m["n_tracked"].min()) > 20
    for j in range(b):
        st = singles[j]
        for f in range(2):
            st, sm = tvio.ok_step(st, *_inputs(j + f, frames, gyrs, accs, mask), None,
                                  consts, static, ransac_u=tuple(us[f][j]))
        _close_lanes(state_b, st, j)
        for k in ("n_stereo", "n_tracked", "ba_iters", "is_keyframe", "pool_size"):
            assert int(m[k][j]) == int(sm[k]), (j, k)
        np.testing.assert_allclose(m["rec_p"][j].numpy(), sm["rec_p"].numpy(), atol=1e-5)


def test_lanes_take_their_own_branches():
    """One batch whose lanes branch apart: a fresh window with an empty
    pool (no matches: BA skipped, the pool filled), a keyframe that turns
    the marginalization prior on, and a plain frame (pool untouched). Each
    lane equals its own single-sequence step (`_close_lanes`)."""
    states, (frames, gyrs, accs, mask) = _jax_states()
    _, consts, static = torch_setup(**CFG)
    lanes = (0, 1, 2)
    singles = [convert.state_from_numpy(states[j], "cpu") for j in lanes]
    gen = torch.Generator().manual_seed(5)
    u_b = torch.stack([torch.stack(tvio.draw_ransac_uniforms(gen, "cpu")) for _ in lanes])
    out, m = batched.make_batched_step(consts, static)(
        batched.stack_states(singles), *_stack_inputs(lanes, frames, gyrs, accs, mask), u_b)
    refs = [tvio.ok_step(s, *_inputs(j, frames, gyrs, accs, mask), None, consts, static,
                         ransac_u=tuple(u_b[j])) for j, s in zip(lanes, singles)]
    for j, (st, sm) in enumerate(refs):
        _close_lanes(out, st, j)
        for k in ("n_tracked", "ba_iters", "is_keyframe", "pool_size"):
            assert int(m[k][j]) == int(sm[k]), (j, k)
    # lane 0: no matches, BA skipped, the empty pool filled
    assert int(m["n_tracked"][0]) == 0 and int(m["ba_iters"][0]) == 0
    assert not bool(singles[0].pool.valid.any()) and int(m["pool_size"][0]) > 50
    # lane 1: a keyframe of a full window marginalizes (the prior turns on)
    # and inserts new features
    assert bool(m["is_keyframe"][1]) and int(m["ba_iters"][1]) > 0
    assert not bool(singles[1].win.prior_on) and bool(out.win.prior_on[1])
    assert int(m["pool_size"][1]) > int(singles[1].pool.valid.sum())
    # lane 2: a plain frame keeps the pool's slots and the prior
    assert not bool(m["is_keyframe"][2]) and int(m["ba_iters"][2]) > 0
    assert torch.equal(out.pool.valid[2], singles[2].pool.valid)
    assert torch.equal(out.win.prior_h[2], singles[2].win.prior_h)


def test_lane_depends_only_on_its_own_data():
    """A lane of a batch of different sequences (one with an empty pool, a
    keyframe, a plain frame) equals, bit for bit, the same lane in a batch
    of copies of itself: state and metrics depend on the lane's own
    inputs and the batch size alone (`chip_smoke.py` holds the same on the
    card)."""
    states, (frames, gyrs, accs, mask) = _jax_states()
    _, consts, static = torch_setup(**CFG)
    lanes = (0, 1, 2)
    gen = torch.Generator().manual_seed(11)
    u_b = torch.stack([torch.stack(tvio.draw_ransac_uniforms(gen, "cpu")) for _ in lanes])
    state_b = batched.stack_states([convert.state_from_numpy(states[j], "cpu") for j in lanes])
    inputs = _stack_inputs(lanes, frames, gyrs, accs, mask)
    step = batched.make_batched_step(consts, static)
    out, m = step(state_b, *inputs, u_b)
    for j in range(len(lanes)):
        def copies(t):
            return t[j:j + 1].expand((len(lanes),) + t.shape[1:]).contiguous()

        c_out, c_m = step(tree_map(copies, state_b), *map(copies, inputs), copies(u_b))
        got = tree_leaves((out, tuple(m.values())))
        ref = tree_leaves((c_out, tuple(c_m.values())))
        assert len(got) == len(ref)
        for a, c in zip(got, ref):
            for k in range(len(lanes)):
                assert torch.equal(a[j], c[k]), j


def test_batched_replay_two_sequences():
    """Two sequences of one world bootstrap through their own state
    machines (0.6 s, the first OK frame), then step in lock-step for 0.6 s
    at 10 Hz: each keeps its own random draws (the lanes differ), tracks,
    and stays within 0.25 x path + 0.05 m of the truth (the JAX package's
    bound in tests/test_batched_slam.py)."""
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    sims = [testing.StereoInertialSim(cfg, n_landmarks=150, seed=0) for _ in range(2)]
    br = BatchedReplay(cfg, n=2, device="cpu")
    dt = 1.0 / cfg.sampling_rate
    boot = int(0.6 / dt)

    def feeder(sim):
        def fn(slam):
            for k in range(boot):
                ts = int(k * dt * 1e9)
                w_b, f_b = sim.imu_at(k * dt)
                slam.collect_imu_data(SensorType.GYROSCOPE, ts, *w_b)
                slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *f_b)
                if k % 20 == 0:
                    slam.process(*sim.render(k * dt), ts)
        return fn

    br.bootstrap([feeder(s) for s in sims])
    m_len = cfg.imu_chunk
    gts = [[], []]
    tracked = []
    for k in range(boot, 2 * boot, 20):     # 6 lock-step frames
        t = k * dt
        ts = int(t * 1e9)
        batch = []
        for i, sim in enumerate(sims):
            samples = [sim.imu_at(t - 0.1 + j * dt) for j in range(20)]
            g = np.zeros((m_len, 3), np.float32)
            a = np.zeros((m_len, 3), np.float32)
            g[:20] = [s[0] for s in samples]
            a[:20] = [s[1] for s in samples]
            batch.append((*sim.render(t), g, a, np.arange(m_len) < 20))
            gts[i].append([ts, *sim.traj.pos(t)])
        m = br.step(*(np.stack(x) for x in zip(*batch)), timestamps=[ts, ts])
        tracked.append(m["n_tracked"].numpy())
    assert (np.array(tracked) > 0).all()
    trajs = [br.trajectory(i) for i in range(2)]
    assert not np.array_equal(trajs[0][:, 1:], trajs[1][:, 1:])
    for i in range(2):
        gt = np.array(gts[i])
        assert len(trajs[i]) == len(gt) == 6 and np.isfinite(trajs[i]).all()
        path = np.linalg.norm(np.diff(gt[:, 1:], axis=0), axis=1).sum()
        assert tate.ate_rmse(trajs[i], gt) < 0.25 * path + 0.05, i
