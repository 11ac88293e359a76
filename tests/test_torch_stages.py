"""PyTorch port: the staged OK frame (`models/vio.py` `stage_imu`,
`stage_frontend`, `stage_ba`, `stage_pool`) and `ok_scan`.

- each stage against the JAX package's stage of the same name on the same
  (converted) input, over three frames of the seeded chain: a frame with
  an empty pool (no matches, BA skipped, the pool filled), then frames
  that track, with a keyframe; both packages on the map front end (the
  JAX package's CPU default; its kernel path in interpret mode would take
  minutes), BA capped at 4 LM iterations as in `test_torch_vio.py`;
- `ok_step` is the stages called in turn, bit for bit;
- `ok_scan` is `ok_step` after `ok_step`, bit for bit, with the JAX
  `ok_scan`'s output keys and shapes (traced with `jax.eval_shape`: the
  JAX scan's compile is what its own test is marked slow for).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_parity import (jax_map_setup, ransac_uniforms, to_np, torch_map_setup,  # noqa: E402
                          world)

from pose_estimation_tpu_torch import convert  # noqa: E402
from pose_estimation_tpu_torch.frontend import tracker  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402

CFG = dict(max_num_iterations=4, keyframe_translation=0.03, keyframe_rotation=1.0)
N_FRAMES = 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_states(port, ref, atol):
    """Integer and bool leaves equal; floating leaves within `atol` x
    max(1, the leaf's largest magnitude)."""
    got, want = tree_leaves(port), tree_leaves(convert.state_from_numpy(ref, "cpu"))
    assert len(got) == len(want)
    for x, y in zip(got, want):
        x, y = x.numpy(), y.numpy()
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=atol * max(1.0, np.abs(y).max()))
        else:
            np.testing.assert_array_equal(x, y)


@functools.lru_cache(maxsize=1)
def _jax_stages():
    """The JAX stages' inputs and outputs over N_FRAMES frames of the
    seeded chain, as numpy trees, and the world."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_map_setup(**CFG)
    frames, gyrs, accs, mask, state0 = world(N_FRAMES)

    def jit(fn):
        return jax.jit(functools.partial(fn, consts=consts, static=static))

    imu, front, ba, pool = (jit(f) for f in (jvio.stage_imu, jvio.stage_frontend,
                                             jvio.stage_ba, jvio.stage_pool))
    st = seeded_state(static, state0)
    out = []
    for i in range(N_FRAMES):
        key = jax.random.PRNGKey(i)
        s1, dt = imu(st, gyrs[i], accs[i], mask)
        s2, cur, tr = front(s1, *frames[i], key)
        s3, cost, iters = ba(s2, tr.n_matches)
        s4 = pool(s3, cur, tr, tr.n_matches)
        out.append(to_np(dict(s0=st, s1=s1, dt=dt, s2=s2, cur=cur, tr=tr, s3=s3, cost=cost,
                              iters=iters, s4=s4, u=ransac_uniforms(key))))
        st = s4
    return out, (frames, gyrs, accs, mask)


def test_stages_match_jax():
    """Each port stage from the JAX stage's converted input. stage_imu:
    floats within 1e-5 x max(1, |leaf|), the rest equal; stage_frontend:
    stereo and tracked counts within 2 % (the tolerance of
    `test_torch_vio.py`: the two ORB implementations may part on a
    descriptor bit) or 2 features (measured: 78 tracked against 76 on the
    third frame); stage_ba: the same LM iterations, keyframe flag and
    marginalization, the cost within 1e-3 relative, the window's positions
    within 1e-4 m and its other floats within 5e-4 x max(1, |leaf|)
    (float32 solves summed in another order; measured: 1.8e-5 m,
    2.7e-4 m/s in a velocity and 2.3e-4 in an acc bias of 0.011, the
    solve's least observed states); stage_pool: the pool's slots, ages and
    ids equal, positions within 1e-5."""
    stages, (frames, gyrs, accs, mask) = _jax_stages()
    _, consts, static = torch_map_setup(**CFG)
    seen = set()
    for i, j in enumerate(stages):
        s1, dt = tvio.stage_imu(convert.state_from_numpy(j["s0"], "cpu"), _t(gyrs[i]),
                                _t(accs[i]), _t(mask), consts, static)
        _close_states(s1, j["s1"], 1e-5)
        assert abs(float(dt) - float(j["dt"])) <= 1e-6

        s2, cur, tr = tvio.stage_frontend(convert.state_from_numpy(j["s1"], "cpu"),
                                          _t(frames[i][0]), _t(frames[i][1]),
                                          tuple(_t(u) for u in j["u"]), consts, static)
        n_stereo, jn_stereo = int(cur.valid.sum()), int(j["cur"].valid.sum())
        assert abs(n_stereo - jn_stereo) <= max(0.02 * jn_stereo, 2), i
        jn = int(j["tr"].n_matches)
        assert abs(int(tr.n_matches) - jn) <= max(0.02 * jn, 2), i
        # the matches are recorded as the newest frame's observations
        assert bool(s2.pool.obs_mask[tr.slot[tr.matched], -1].all())

        s3, cost, iters = tvio.stage_ba(convert.state_from_numpy(j["s2"], "cpu"),
                                        _t(j["tr"].n_matches), consts, static)
        assert int(iters) == int(j["iters"]), i
        assert abs(float(cost) - float(j["cost"])) <= 1e-3 * max(1.0, float(j["cost"]))
        _close_states(s3, j["s3"], 5e-4)
        np.testing.assert_allclose(s3.win.p.numpy(), j["s3"].win.p, rtol=0, atol=1e-4)

        jcur, jtr = j["cur"], j["tr"]
        s4 = tvio.stage_pool(
            convert.state_from_numpy(j["s3"], "cpu"),
            tracker.CurrentFeatures(*(_t(a) for a in jcur)),
            tracker.TrackResult(_t(jtr.matched), _t(jtr.slot).long(), _t(jtr.n_matches)),
            _t(jtr.n_matches), consts, static)
        _close_states(s4, j["s4"], 1e-5)
        seen.add((int(j["tr"].n_matches) > 0, bool(j["s3"].win.is_keyframe)))
    # the frames took every branch: no matches, a keyframe, a plain frame
    assert seen == {(False, True), (True, True), (True, False)}, seen


def _inputs(i, frames, gyrs, accs, mask):
    return _t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask)


def test_ok_step_is_the_stages_in_turn():
    """`ok_step` and the four stages called one after another give the
    same state and metrics, bit for bit, over the chain."""
    stages, (frames, gyrs, accs, mask) = _jax_stages()
    _, consts, static = torch_map_setup(**CFG)
    fused = staged = convert.state_from_numpy(stages[0]["s0"], "cpu")
    for i, j in enumerate(stages):
        u = tuple(_t(a) for a in j["u"])
        img_l, img_r, gyr, acc, m = _inputs(i, frames, gyrs, accs, mask)
        fused, fm = tvio.ok_step(fused, img_l, img_r, gyr, acc, m, None, consts, static,
                                 ransac_u=u)
        staged, dt = tvio.stage_imu(staged, gyr, acc, m, consts, static)
        p_pred = staged.win.p[-1]
        staged, cur, tr = tvio.stage_frontend(staged, img_l, img_r, u, consts, static)
        staged, cost, iters = tvio.stage_ba(staged, tr.n_matches, consts, static)
        staged = tvio.stage_pool(staged, cur, tr, tr.n_matches, consts, static)
        sm = tvio.frame_metrics(staged, cur, tr, cost, iters, dt, p_pred)
        for a, b in zip(tree_leaves(fused), tree_leaves(staged)):
            assert torch.equal(a, b), i
        assert set(sm) < set(fm)
        for k, v in sm.items():
            assert torch.equal(v, fm[k]), (i, k)


def test_ok_scan_equals_sequential_ok_steps():
    """`ok_scan` over the chain's frames equals `ok_step` after `ok_step`
    with the same uniforms, bit for bit (state and stacked outputs), and
    its outputs have the keys and shapes of the JAX `ok_scan`'s."""
    from pose_estimation_tpu.models import vio as jvio

    stages, (frames, gyrs, accs, mask) = _jax_stages()
    _, consts, static = torch_map_setup(**CFG)
    s0 = convert.state_from_numpy(stages[0]["s0"], "cpu")
    us = torch.stack([torch.stack([_t(a) for a in j["u"]]) for j in stages])
    seq = [_inputs(i, frames, gyrs, accs, mask) for i in range(N_FRAMES)]
    scan_state, outs = tvio.ok_scan(s0, *(torch.stack(x) for x in zip(*seq)), None,
                                    consts, static, ransac_u=us)
    st = s0
    rows = []
    for i in range(N_FRAMES):
        st, m = tvio.ok_step(st, *seq[i], None, consts, static, ransac_u=tuple(us[i]))
        rows.append((st.win.R[-1], st.win.p[-1], st.win.v[-1], m["n_tracked"],
                     m["is_keyframe"], m["need_reinit"]))
    for a, b in zip(tree_leaves(scan_state), tree_leaves(st)):
        assert torch.equal(a, b)
    for k, col in zip(("R", "p", "v", "n_tracked", "is_keyframe", "need_reinit"), zip(*rows)):
        assert torch.equal(outs[k], torch.stack(col)), k

    _, jconsts, jstatic = jax_map_setup(**CFG)
    jstate = stages[0]["s0"]
    keys = jax.random.split(jax.random.PRNGKey(0), N_FRAMES)
    _, jouts = jax.eval_shape(
        functools.partial(jvio.ok_scan, consts=jconsts, static=jstatic), jstate,
        np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]), np.stack(gyrs),
        np.stack(accs), np.stack([mask] * N_FRAMES), keys)
    assert set(outs) == set(jouts)
    for k, v in jouts.items():
        assert tuple(outs[k].shape) == v.shape, k
