"""The port's replay entry points on the CPU: `run_euroc` and `run_kitti`
over small simulated datasets written by `testing.write_euroc` and
`testing.write_kitti` (320x240, 1 s at 10 Hz), the `states.csv` they write
against the JAX package's `save_results` format, `--live-view` (served
through the EuRoC CLI, refused without matplotlib), and
`profiling.StageTimers`.

The replays run with `yaml` and `cv2` made unimportable: the port reads
its configuration and its PNG frames without PyYAML or OpenCV, which the
machine with the GPU lacks.
"""

import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch import profiling, run_euroc, run_kitti, testing  # noqa: E402
from pose_estimation_tpu_torch import slam as slam_mod  # noqa: E402

DURATION = 1.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def captured(monkeypatch):
    """The VisualInertialSLAM objects the CLI builds, with `yaml` and `cv2`
    unimportable while it runs."""
    made = []

    class Recorded(slam_mod.VisualInertialSLAM):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(slam_mod, "VisualInertialSLAM", Recorded)
    for name in ("yaml", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    return made


def _check_states_csv(path, slam):
    """The CLI's `states.csv` is what the JAX package's `save_results`
    writes for the same records: the reference's header and 17 columns."""
    from pose_estimation_tpu.slam import VisualInertialSLAM as JaxSLAM

    ref = path.parent / "jax_states.csv"
    JaxSLAM.save_results(types.SimpleNamespace(_records=slam._host_records()), str(ref))
    text = path.read_text()
    assert text == ref.read_text()
    lines = text.splitlines()
    assert lines[0] == "timestamp,qw,qx,qy,qz,px,py,pz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz"
    rows = np.array([[float(v) for v in line.split(",")] for line in lines[1:]])
    assert rows.shape[1] == 17 and len(rows) > 0 and np.isfinite(rows).all()
    return rows


def test_run_euroc_cli_reaches_ok(tmp_path, captured, capsys):
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    cpath, mav0, n_img = testing.write_euroc(tmp_path / "euroc", cfg, DURATION)
    out = tmp_path / "states.csv"
    assert run_euroc.main(["--config", str(cpath), "--out", str(out), "--ate"],
                          device="cpu") == 0
    (slam,) = captured
    assert slam.state == slam_mod.State.OK and slam.device.type == "cpu"
    printed = capsys.readouterr().out
    assert f"processed {n_img} frames in " in printed and "FPS)" in printed
    assert "ATE RMSE: " in printed
    rows = _check_states_csv(out, slam)
    gt = np.loadtxt(mav0 / "state_groundtruth_estimate0" / "data.csv", delimiter=",")
    err = np.linalg.norm(rows[:, 5:8] - gt[-len(rows):, 1:4], axis=1)
    path = np.linalg.norm(np.diff(gt[:, 1:4], axis=0), axis=1).sum()
    assert err.max() < 2 * path + 1.0


def test_run_kitti_cli_reaches_ok(tmp_path, captured, capsys):
    cfg = testing.sim_config(dataset="kitti", keyframe_rotation=0.1,
                             keyframe_translation=0.15)
    cpath, root, n_img, gt = testing.write_kitti(tmp_path / "kitti", cfg, DURATION)
    out = tmp_path / "states.csv"
    assert run_kitti.main(["--config", str(cpath), "--out", str(out)], device="cpu") == 0
    (slam,) = captured
    assert slam.state == slam_mod.State.OK
    assert f"processed {n_img} frames in " in capsys.readouterr().out
    rows = _check_states_csv(out, slam)
    ts = gt[:, 0].astype(np.int64)
    idx = np.searchsorted(ts, rows[:, 0].astype(np.int64))
    err = np.linalg.norm(rows[:, 5:8] - gt[idx, 1:4], axis=1)
    assert err.max() < 2 * np.linalg.norm(np.diff(gt[:, 1:], axis=0), axis=1).sum() + 1.0


@pytest.mark.parametrize("cli", [run_euroc, run_kitti])
def test_live_view_is_refused(cli, tmp_path, capsys, monkeypatch):
    """Without matplotlib (made unimportable here; the GPU machine has
    none) `--live-view` fails with an error naming it, before anything is
    read: the viewer's render thread would swallow the ImportError and
    serve a page with no image."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit) as exc:
        cli.main(["--config", str(tmp_path / "missing.yml"), "--live-view"], device="cpu")
    assert exc.value.code == 2
    assert "matplotlib" in capsys.readouterr().err


def test_live_view_runs_through_the_cli(tmp_path, captured, capsys, monkeypatch):
    """`run_euroc --live-view 0` (any free port) over the 1-s EuRoC replay:
    the viewer is attached, serves its page, gets one pose a frame from the
    state machine, renders `live_view.png` in the working directory, and is
    stopped when the replay ends."""
    import urllib.request

    from pose_estimation_tpu_torch import live_viewer

    pytest.importorskip("matplotlib")
    made = []

    class Counted(live_viewer.LiveViewer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.poses = 0
            made.append(self)

        def push_pose(self, R, p):
            self.poses += 1
            super().push_pose(R, p)

        def stop(self):
            page = urllib.request.urlopen(f"http://127.0.0.1:{self.port}/", timeout=10).read()
            assert b"view.png" in page
            super().stop()

    monkeypatch.setattr(live_viewer, "LiveViewer", Counted)
    monkeypatch.chdir(tmp_path)
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    cpath, _, _ = testing.write_euroc(tmp_path / "euroc", cfg, DURATION)
    assert run_euroc.main(["--config", str(cpath), "--out", str(tmp_path / "s.csv"),
                           "--live-view", "0"], device="cpu") == 0
    (slam,), (viewer,) = captured, made
    assert slam._viewer is viewer and viewer.w == cfg.window_size
    assert f"live view: http://localhost:{viewer.port}/" in capsys.readouterr().out
    assert viewer.poses == slam._frame_count > 0
    pos, raw, pose, _, _ = viewer._snapshot()
    assert len(pos) >= cfg.window_size and np.isfinite(pos).all() and pose is not None
    assert viewer._stop.is_set() and viewer._server is None and viewer._renders > 0
    assert (tmp_path / "live_view.png").stat().st_size > 1000


def test_stage_timers():
    st = profiling.StageTimers()
    x = torch.ones((64, 64))
    with st.stage("matmul", result=None):
        y = x @ x
    with st.stage("matmul", result=y):
        y = x @ x
    with st.stage("tree", result={"a": (y, [y])}):
        pass
    st.add("manual", 0.5)
    rep = st.report()
    assert "matmul" in rep and "x2" in rep
    assert "manual" in rep and "tree" in rep
