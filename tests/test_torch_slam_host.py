"""PyTorch port: the state machine's staged OK path and the keyframe-history
refresh (`slam.py`: `staged=True`, `refresh_kf_hist`, `_refresh_kf_hist`).

- the staged state machine against the fused one over one simulated run
  at 320x240: bit for bit on the CPU (the fused `ok_step` is the same
  stages in one call);
- `_refresh_kf_hist` against the JAX package's on equal windows and
  histories, for each slot mapping (`_last_was_kf`) and several active
  window lengths;
- the health check sets `_last_was_kf` and refreshes the history only
  when the knob is on.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu_torch import convert, testing  # noqa: E402
from pose_estimation_tpu_torch.imu.preintegration import ImuConstraint  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402
from pose_estimation_tpu_torch.models.window import WindowState  # noqa: E402
from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Both:
    """Feeds one simulated run to two state machines."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def collect_imu_data(self, *args):
        self.a.collect_imu_data(*args)
        self.b.collect_imu_data(*args)

    def process(self, *args):
        ra, rb = self.a.process(*args), self.b.process(*args)
        assert ra == rb
        return ra


def test_staged_state_machine_equals_fused():
    """320x240, 4 levels, 1.6 s with IMU noise: the staged and the fused
    state machines (the same seed) reach OK and end with equal device
    state, keyframe history, generator state and recorded poses, bit for
    bit. The fused one runs `ok_head` (and then `track_tail`) once per OK
    frame; the staged one calls the stages instead (`stage_ba_solve` runs
    inside `ok_head` too)."""
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    fused = VisualInertialSLAM(cfg, device="cpu")
    staged = VisualInertialSLAM(cfg, device="cpu", staged=True)
    world = testing.StereoInertialSim(cfg, n_landmarks=150, seed=0)
    with mock.patch.object(tvio, "ok_head", wraps=tvio.ok_head) as ok, \
            mock.patch.object(tvio, "stage_ba_solve", wraps=tvio.stage_ba_solve) as ba:
        world.run(_Both(fused, staged), duration=1.6, imu_noise=2.4e-3, seed=10)
    assert fused.state == staged.state == State.OK
    n_ok = fused._frame_count
    assert n_ok == staged._frame_count >= fused.reinit_check_every
    assert ok.call_count == n_ok and ba.call_count == 2 * n_ok
    for a, b in zip(tree_leaves(fused.vio), tree_leaves(staged.vio)):
        assert torch.equal(a, b)
    assert torch.equal(fused._gen.get_state(), staged._gen.get_state())
    assert len(fused._kf_hist) == len(staged._kf_hist) > 0
    for ha, hb in zip(fused._kf_hist, staged._kf_hist):
        for a, b in zip(tree_leaves(ha), tree_leaves(hb)):
            assert torch.equal(a, b)
    np.testing.assert_array_equal(fused.trajectory, staged.trajectory)
    assert len(fused.trajectory) == n_ok + 1


def _random_window(rng, win):
    """The JAX window `win` with random poses and velocities."""
    w = win.R.shape[0]
    return win._replace(R=jnp.asarray(rng.normal(size=(w, 3, 3)), jnp.float32),
                        p=jnp.asarray(rng.normal(size=(w, 3)), jnp.float32),
                        v=jnp.asarray(rng.normal(size=(w, 3)), jnp.float32))


def _random_history(rng, n, ic):
    """n (R, p, v, ic) entries as numpy, the constraints random too."""
    return [(rng.normal(size=(3, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32),
             rng.normal(size=3).astype(np.float32),
             type(ic)(*(rng.normal(size=np.shape(a)).astype(np.float32) for a in ic)))
            for _ in range(n)]


@pytest.mark.parametrize("n_act", [1, 2, 4])
@pytest.mark.parametrize("last_was_kf", [True, False])
def test_refresh_kf_hist_matches_jax(last_was_kf, n_act):
    """Both packages' `_refresh_kf_hist` on an equal window (random poses,
    `n_act` active frames) and an equal 6-entry history: the same entries
    re-snapshotted from the same window slots, bit for bit, the
    constraints kept as stored."""
    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM

    cfg = testing.tiny_config()
    rng = np.random.default_rng(n_act + 10 * last_was_kf)
    jslam = JaxSLAM(cfg)
    jwin = _random_window(rng, jslam.vio.win)._replace(n_act=jnp.asarray(n_act, jnp.int32))
    ic0 = jax.tree.map(lambda a: np.asarray(a[-1]), jslam.vio.win.ics)
    hist = _random_history(rng, 6, ic0)
    jslam.vio = jslam.vio._replace(win=jwin)
    jslam._kf_hist = [tuple(jax.tree.map(jnp.asarray, h)) for h in hist]
    jslam._last_was_kf = last_was_kf
    jslam._refresh_kf_hist()

    slam = VisualInertialSLAM(cfg, device="cpu")
    win_np = jax.tree.map(np.asarray, jwin)
    slam.vio = slam.vio._replace(win=convert.tree_from_numpy(WindowState, win_np, "cpu"))
    slam._kf_hist = [(torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(v),
                      convert.ics_from_numpy(ic, "cpu")) for r, p, v, ic in hist]
    slam._last_was_kf = last_was_kf
    slam._refresh_kf_hist()

    refreshed = 0
    for (r, p, v, ic), (jr, jp, jv, jic), (hr, _, _, hic) in zip(slam._kf_hist,
                                                                jslam._kf_hist, hist):
        for a, b in zip((r, p, v), (jr, jp, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b, c in zip(ic, jic, hic):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c)
        refreshed += not np.array_equal(r.numpy(), hr)
    length = win_np.R.shape[0]
    off = 1 if last_was_kf else 2
    assert refreshed == min(6, max(length - off - max(length - 1 - n_act, 0) + 1, 0))


@pytest.mark.parametrize("refresh", [True, False])
def test_health_check_sets_last_was_kf_and_refreshes_on_request(refresh):
    """A health check over 8 pending frames (keyframes at the 2nd, 5th and
    8th) keeps the keyframes' snapshots, notes that the newest frame was a
    keyframe, and, with `refresh_kf_hist`, re-snapshots the entries still
    in the window from the window's slots (the newest from slot -1);
    without it the snapshots stay as committed."""
    cfg = testing.tiny_config()
    slam = VisualInertialSLAM(cfg, device="cpu")
    slam.refresh_kf_hist = refresh
    rng = np.random.default_rng(3)
    win = slam.vio.win
    win = win._replace(R=torch.from_numpy(rng.normal(size=win.R.shape).astype(np.float32)),
                       p=torch.from_numpy(rng.normal(size=win.p.shape).astype(np.float32)),
                       n_act=torch.tensor(4, dtype=torch.int32))
    slam.vio = slam.vio._replace(win=win)
    ic = ImuConstraint(*(a[-1] for a in win.ics))
    snaps = [(torch.full((3, 3), float(k)), torch.full((3,), float(k)),
              torch.full((3,), float(k)), ic) for k in range(8)]
    kfs = [k in (1, 4, 7) for k in range(8)]
    slam._pending_health = [(torch.tensor(50), torch.tensor(False), torch.tensor(kf), s)
                            for kf, s in zip(kfs, snaps)]
    img = torch.zeros((cfg.image_height, cfg.image_width))
    assert slam._health_check(img, img)
    assert slam._last_was_kf
    assert len(slam._kf_hist) == 3
    if refresh:
        for m, slot in ((1, -1), (2, -2), (3, -3)):
            assert torch.equal(slam._kf_hist[-m][0], win.R[slot])
            assert torch.equal(slam._kf_hist[-m][1], win.p[slot])
    else:
        for h, k in zip(slam._kf_hist, (1, 4, 7)):
            assert torch.equal(h[0], snaps[k][0])
