"""PyTorch port: the live viewer (`live_viewer.py`, `VisualInertialSLAM.
set_viewer` / `_push_viewer`) and the offline plots (`viz.py`).

- `_push_viewer` of both packages on equal states, into a recording
  viewer: the same calls with the same arrays, on a keyframe and not, on a
  landmark frame and not;
- the two `LiveViewer` copies agree on `_snapshot()` after equal pushes,
  and the port's renders a PNG;
- `viz` equal to the JAX package's (`load_states_csv`, `project_points`),
  `project_points` held to the port's BA reprojection residual, and the
  plots written.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu_torch import convert, testing, viz  # noqa: E402
from pose_estimation_tpu_torch.live_viewer import LiveViewer  # noqa: E402
from pose_estimation_tpu_torch.models.pool import FeaturePool  # noqa: E402
from pose_estimation_tpu_torch.models.window import WindowState  # noqa: E402
from pose_estimation_tpu_torch.slam import VisualInertialSLAM  # noqa: E402


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


class _Recorder:
    """A viewer that records its calls, arrays as float64 numpy."""

    def __init__(self):
        self.calls = []

    def _add(self, name, *args):
        self.calls.append((name, *(np.asarray(a, np.float64) if np.ndim(a) else a
                                   for a in args)))

    def push_keyframe(self):
        self._add("push_keyframe")

    def push_position(self, p, i):
        self._add("push_position", p, int(i))

    def push_raw_position(self, p, i):
        self._add("push_raw_position", p, int(i))

    def push_pose(self, R, p):
        self._add("push_pose", R, p)

    def push_landmark(self, points, valid=None):
        self._add("push_landmark", points, np.asarray(valid, bool))


@pytest.mark.parametrize("frame_count", [9, 10])
@pytest.mark.parametrize("keyframe", [True, False])
def test_push_viewer_matches_jax(keyframe, frame_count):
    """Equal windows and pools (random), equal metrics: both packages push
    the same sequence (keyframe commit, W positions, the predicted
    position, the pose, and the landmarks on every 10th frame), with equal
    arrays."""
    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM

    cfg = testing.tiny_config()
    rng = np.random.default_rng(frame_count + keyframe)
    jslam = JaxSLAM(cfg)
    win, pool = jslam.vio.win, jslam.vio.pool
    win = win._replace(R=jnp.asarray(rng.normal(size=win.R.shape), jnp.float32),
                       p=jnp.asarray(rng.normal(size=win.p.shape), jnp.float32))
    pool = pool._replace(pos=jnp.asarray(rng.normal(size=pool.pos.shape), jnp.float32),
                         valid=jnp.asarray(rng.uniform(size=pool.valid.shape) < 0.5))
    jslam.vio = jslam.vio._replace(win=win, pool=pool)
    p_pred = rng.normal(size=3).astype(np.float32)
    slam = VisualInertialSLAM(cfg, device="cpu")
    slam.vio = slam.vio._replace(win=convert.tree_from_numpy(WindowState, _np_tree(win), "cpu"),
                                 pool=convert.tree_from_numpy(FeaturePool, _np_tree(pool), "cpu"))
    recs = []
    for s, metrics in ((jslam, {"is_keyframe": jnp.asarray(keyframe),
                                "p_pred": jnp.asarray(p_pred)}),
                       (slam, {"is_keyframe": torch.tensor(keyframe),
                               "p_pred": torch.from_numpy(p_pred)})):
        rec = _Recorder()
        s.set_viewer(rec)
        s._frame_count = frame_count
        s._push_viewer(metrics)
        recs.append(rec.calls)
    jcalls, calls = recs
    assert [c[0] for c in calls] == [c[0] for c in jcalls]
    names = [c[0] for c in calls]
    assert names.count("push_keyframe") == keyframe
    assert names.count("push_landmark") == (frame_count % 10 == 0)
    assert names.count("push_position") == cfg.window_size
    for c, jc in zip(calls, jcalls):
        for a, b in zip(c[1:], jc[1:]):
            np.testing.assert_array_equal(a, b)


def _feed(v, n=12):
    """The pushes of the JAX package's viewer test."""
    rng = np.random.default_rng(0)
    lms = rng.normal(size=(50, 3)) * 2
    for t in range(n):
        p = np.array([t * 0.1, np.sin(t * 0.3), 0.2 * t])
        for i in range(4):
            v.push_position(p + i * 0.02, i)
            v.push_raw_position(p + i * 0.02 + 0.01, i)
        v.push_pose(np.eye(3), p)
        if t % 3 == 0:
            v.push_keyframe()
        v.push_landmark(lms, np.ones(50, bool))


def test_live_viewer_copies_agree_and_render(tmp_path):
    """Equal pushes into both packages' viewers give equal snapshots (the
    window-indexed overwrite and the keyframe commits); the port's renders
    a PNG to its path."""
    from pose_estimation_tpu.live_viewer import LiveViewer as JaxViewer

    out = tmp_path / "live.png"
    v, jv = LiveViewer(out_path=str(out), port=None), JaxViewer(out_path=None, port=None)
    _feed(v)
    _feed(jv)
    snap, jsnap = v._snapshot(), jv._snapshot()
    for a, b in zip(snap[:2], jsnap[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(snap[2], jsnap[2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(snap[3], jsnap[3])
    assert snap[4] == jsnap[4] == 12 and len(snap[0]) == 4 + 4
    pytest.importorskip("matplotlib")
    png = v.render_once()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.exists() and out.stat().st_size > 1000


def _scene(seed=0, n=40):
    rng = np.random.default_rng(seed)
    pos_w = rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 6.0])
    r_cb = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    p_cb = np.array([0.05, -0.02, 0.01])
    th = 0.1
    R_wb = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    return pos_w, R_wb, np.array([0.3, -0.2, 0.1]), r_cb, p_cb


def test_project_points_matches_jax_and_the_residual():
    """`project_points` equals the JAX package's bit for bit, and feeding
    its projections back to the port's reprojection residual gives zero
    error in front of the camera (1e-3 px, the JAX package's test)."""
    from pose_estimation_tpu import viz as jviz
    from pose_estimation_tpu_torch.backend import residuals

    pos_w, R_wb, p_wb, r_cb, p_cb = _scene()
    args = (pos_w, R_wb, p_wb, r_cb, p_cb, 260.0, 262.0, 320.0, 240.0)
    px, ok = viz.project_points(*args)
    jpx, jok = jviz.project_points(*args)
    np.testing.assert_array_equal(px, jpx)
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() > 10

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    err, _, _ = residuals.reprojection_error_and_jacobian(
        t(R_wb), t(p_wb), t(pos_w), t(px), t(r_cb), t(p_cb), 260.0, 262.0, 320.0, 240.0,
        t([1.0, 1.0]))
    np.testing.assert_allclose(err.numpy()[ok], 0.0, atol=1e-3)


def test_states_csv_and_plots(tmp_path):
    """A `states.csv` written by the port's `save_results` parses to the
    same arrays in both packages' `load_states_csv`; the trajectory, states
    and BA-overlay plots are written."""
    from pose_estimation_tpu import viz as jviz

    rng = np.random.default_rng(1)
    recs = [(int(1e9 + k * 5e7), *(rng.normal(size=n) for n in (4, 3, 3, 3, 3)))
            for k in range(20)]
    path = tmp_path / "states.csv"
    VisualInertialSLAM.save_results(types.SimpleNamespace(_host_records=lambda: recs),
                                    str(path))
    st, jst = viz.load_states_csv(str(path)), jviz.load_states_csv(str(path))
    assert sorted(st) == sorted(jst) == ["ba", "bg", "p", "q", "ts", "v"]
    for k in st:
        np.testing.assert_array_equal(st[k], jst[k])
    assert st["p"].shape == (20, 3) and st["q"].shape == (20, 4)

    pytest.importorskip("matplotlib")
    est = np.column_stack([st["ts"], st["p"]])
    outs = [viz.plot_trajectory(est, gt=est + 0.01, landmarks=rng.normal(size=(30, 3)),
                                out_path=str(tmp_path / "traj.png")),
            viz.plot_states(st, out_path=str(tmp_path / "states.png"))]
    pos_w, R_wb, p_wb, r_cb, p_cb = _scene()
    after, ok = viz.project_points(pos_w, R_wb, p_wb, r_cb, p_cb, 260.0, 262.0, 320.0, 240.0)
    outs.append(viz.plot_ba_overlay(rng.uniform(0, 255, (480, 640)),
                                    after + rng.normal(0, 0.5, after.shape),
                                    after + rng.normal(0, 6.0, after.shape), after, ok,
                                    str(tmp_path / "ovl.png")))
    for out in outs:
        data = open(out, "rb").read()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000
