"""PyTorch port vs the JAX package: the host state machine.

Host parity (IMU pairing, synchronization and chunking, exact) with the
JAX package's `VisualInertialSLAM` on the scenarios of
`test_slam_host.py`; the SfM step against the JAX one with the same keys'
draws; the initializer's window re-seed from the same SfM chain; the
port's own state machine on the CPU at two widths (the second not a
multiple of 16, so detection takes kernel K3's route, here its twin); the
copies the port keeps of `tests/sim.py`, `io/ate.py` and `io/kitti.py`
against their originals; and that no module of the port imports JAX or the
JAX package.
"""

import dataclasses
import functools
import importlib
import os
import pkgutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import sim as jsim  # noqa: E402

import pose_estimation_tpu_torch  # noqa: E402
from pose_estimation_tpu.io import ate as jate  # noqa: E402
from pose_estimation_tpu.io import kitti as jkitti  # noqa: E402
from pose_estimation_tpu.slam import SensorType as JSensor  # noqa: E402
from pose_estimation_tpu.slam import VisualInertialSLAM as JSLAM  # noqa: E402
from pose_estimation_tpu_torch import convert, testing  # noqa: E402
from pose_estimation_tpu_torch.io import ate as tate  # noqa: E402
from pose_estimation_tpu_torch.io import kitti as tkitti  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402
from pose_estimation_tpu_torch.slam import SensorType as TSensor  # noqa: E402
from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM, reseed_window  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT_NS = 5_000_000


@functools.lru_cache(maxsize=1)
def _host_pair():
    return (JSLAM(jsim.sim_config(), verbose=False),
            VisualInertialSLAM(testing.sim_config(), device="cpu"))


def _feed(s, sensor, ts_list, values=(0.01, 0.02, 0.03, 9.8, 0.0, 0.0)):
    for ts in ts_list:
        s.collect_imu_data(sensor.GYROSCOPE, ts, *values[:3])
        s.collect_imu_data(sensor.ACCELEROMETER, ts, *values[3:])


def _scenario(s, sensor, name):
    """Drive one host scenario of test_slam_host.py; returns what it pops."""
    s._imu_ts.clear()
    s._imu_data.clear()
    m = s.cfg.imu_chunk
    rng = np.random.default_rng(7)
    if name == "pairing":
        s.collect_imu_data(sensor.GYROSCOPE, 1, 0.1, 0.2, 0.3)
        n_before = len(s._imu_ts)
        s.collect_imu_data(sensor.ACCELEROMETER, 1, 1, 2, 3)
        return [n_before]
    if name == "synchronize":
        _feed(s, sensor, [k * DT_NS for k in range(10)])
        return [s._synchronize(5 * DT_NS), s._synchronize(3 * DT_NS)]
    if name == "image_before_imu":
        _feed(s, sensor, [1_000_000_000])
        return [s._synchronize(0)]
    if name == "chunks":
        for k in range(30):
            _feed(s, sensor, [k * DT_NS], tuple(rng.normal(size=6)))
        return [*s._pop_imu_chunk(20 * DT_NS), *s._pop_imu_chunk(25 * DT_NS),
                *s._pop_imu_chunk(123)]
    if name == "overflow":
        n = 3 * m + 5
        for k in range(n + 1):
            _feed(s, sensor, [k * DT_NS + 1234], tuple(rng.normal(size=6)))
        return [a for chunk in s._pop_imu_chunks(n * DT_NS + 1234) for a in chunk]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["pairing", "synchronize", "image_before_imu", "chunks",
                                  "overflow"])
def test_host_ingestion_matches_jax(name):
    """Pairing, synchronization, chunking and overflow splitting: the queues
    and every popped chunk equal the JAX package's exactly."""
    jslam, tslam = _host_pair()
    got = _scenario(tslam, TSensor, name)
    ref = _scenario(jslam, JSensor, name)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tslam._imu_ts == jslam._imu_ts
    np.testing.assert_array_equal(np.asarray(tslam._imu_data), np.asarray(jslam._imu_data))
    if name == "overflow":
        assert len(got) == 4 * 3 and len(tslam._imu_ts) == 1


# ---- the bootstrap steps against the JAX package


def _jax_sfm_setup(cfg):
    from pose_estimation_tpu.camera import CameraModel
    from pose_estimation_tpu.models import vio as jvio

    consts, static = jvio.build_constants(cfg, CameraModel.from_config(cfg))
    return consts, dataclasses.replace(
        static, orb=static.orb._replace(sample_backend="pallas_interpret"))


def test_sfm_step_matches_jax():
    """One SfM frame (320x240, sim_config) against the reference frame
    0.1 s earlier, with the stereo and PnP uniforms of JAX's key: the same
    inlier count (within 2) and pose within 1e-4 (rad, m)."""
    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio as tvio

    cfg = jsim.sim_config()
    jc, js = _jax_sfm_setup(cfg)
    tcfg = testing.sim_config()
    tc, ts = tvio.build_constants(tcfg, CameraModel.from_config(tcfg), "cpu")
    world = jsim.StereoInertialSim(cfg, n_landmarks=150, seed=0)
    (l0, _), (l1, r1) = world.render(0.0), world.render(0.1)
    jref, _ = jax.jit(lambda a: jvio.extract_rectified(a, a, jc, js))(jnp.asarray(l0))
    tref, _ = tvio.extract_rectified(torch.from_numpy(l0), torch.from_numpy(l0), tc, ts)
    key = jax.random.PRNGKey(5)
    jr, jt, jn, _ = jax.jit(functools.partial(jvio.sfm_step, consts=jc, static=js))(
        jnp.asarray(l1), jnp.asarray(r1), jref.desc, jref.xy, jref.valid, key)
    k1, k2 = jax.random.split(key)
    u = (torch.from_numpy(np.asarray(jax.random.uniform(k1, (64, 8), dtype=jnp.float32))),
         torch.from_numpy(np.asarray(jax.random.uniform(k2, (512, 6), dtype=jnp.float32))))
    tr, tt, tn, feats = tvio.sfm_step(torch.from_numpy(l1), torch.from_numpy(r1), tref.desc,
                                      tref.xy, tref.valid, u, tc, ts)
    assert abs(int(tn) - int(jn)) <= 2 and int(jn) > 100
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    assert int(feats.valid.sum()) > 300


def test_initializer_reseeds_the_window_like_jax():
    """The state machine's `_initialize` on one SfM chain (converted with
    `convert.sfm_chain_from_numpy`): the re-seeded window (two newest
    frames, newest constraint, counters, cleared prior) and the biases
    within float32 solver tolerance (2e-4 relative) of the JAX package's,
    and the bootstrap frame seeds the pool in both. `reseed_window` on
    JAX's own solved chain (`convert.window_reseed_from_numpy`) gives JAX's
    window exactly."""
    from test_torch_init import _chain

    cfg = jsim.sim_config()
    jslam = JSLAM(cfg)
    tslam = VisualInertialSLAM(testing.sim_config(), device="cpu")
    _, R, p, ics = _chain()
    R, p = np.asarray(R, np.float32)[:4], np.asarray(p, np.float32)[:4]
    ics_np = jax.tree.map(lambda a: np.asarray(a, np.float32)[:3], ics)
    jslam._sfm_R, jslam._sfm_p = list(R), list(p)
    jslam._sfm_ics = [jax.tree.map(lambda a: jnp.asarray(a[i]), ics_np) for i in range(3)]
    tR, tp, tics = convert.sfm_chain_from_numpy(list(R), list(p), ics_np, "cpu")
    tslam._sfm_R, tslam._sfm_p = list(tR.double().numpy()), list(tp.double().numpy())
    tslam._sfm_ics = [type(tics)(*(a[i] for a in tics)) for i in range(3)]
    l0, r0 = jsim.StereoInertialSim(cfg, n_landmarks=150, seed=0).render(0.5)
    fresh_win = tslam.vio.win
    solved = []
    full_init = jslam._full_init_jit
    jslam._full_init_jit = lambda *a: solved.append(full_init(*a)) or solved[-1]
    jslam._initialize(jnp.asarray(l0), jnp.asarray(r0), 7)
    tslam._initialize(torch.from_numpy(l0), torch.from_numpy(r0), 7)
    assert jslam.state.name == tslam.state.name == "OK"
    jw = jax.tree.map(np.asarray, jslam.vio.win)
    tw = convert.state_to_numpy(tslam.vio.win)
    # the re-seed alone, from JAX's solved chain carried across: exact
    carried = convert.window_reseed_from_numpy(jax.tree.map(np.asarray, solved[0]), "cpu")
    R, v, p_, _, _, _, ics_c = carried
    exact = convert.state_to_numpy(reseed_window(fresh_win, R, v, p_, ics_c))
    for name in ("R", "v", "p", "dbg", "dba", "prior_h", "n_act", "is_keyframe",
                 "sum_imu_time", "prior_on"):
        np.testing.assert_array_equal(getattr(exact, name), getattr(jw, name), err_msg=name)
    for a, b in zip(exact.ics, jw.ics):
        np.testing.assert_array_equal(a, b)
    for name in ("R", "v", "p", "dbg", "dba", "prior_h"):
        ref = getattr(jw, name)
        np.testing.assert_allclose(getattr(tw, name), ref, atol=2e-4 * max(1, np.abs(ref).max()))
    for a, b in zip(tw.ics, jw.ics):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * max(1, np.abs(b).max()))
    assert int(tw.n_act) == int(jw.n_act) == 1
    assert bool(tw.is_keyframe) and not bool(tw.prior_on)
    for a, b in ((tslam.vio.bg, jslam.vio.bg), (tslam.vio.ba, jslam.vio.ba)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    assert int(tslam.vio.pool.valid.sum()) > 50 and int(jslam.vio.pool.valid.sum()) > 50
    assert len(tslam._records) == len(jslam._records) == 1


# ---- the port's own state machine on the CPU


def _run_port(cfg, duration, seed=0):
    world = testing.StereoInertialSim(cfg, n_landmarks=150, seed=seed)
    slam = VisualInertialSLAM(cfg, device="cpu")
    gt = world.run(slam, duration=duration, imu_noise=2.4e-3, seed=seed + 10)
    return slam, gt


def _check_run(slam, gt, tmp_path):
    """Reached OK, every recorded frame finite, the aligned error bounded
    by 2 x distance travelled + 1 m at every frame, and the results file."""
    assert slam.state == State.OK
    traj = slam.trajectory
    assert len(traj) >= len(gt) - 6 and np.isfinite(traj).all()
    e, g = tate.associate(traj, gt)
    s, r, t = tate.umeyama(e, g)
    err = np.linalg.norm((r @ e.T).T + t - g, axis=1)
    dist = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(g, axis=0), axis=1))])
    assert (err <= 2 * dist + 1.0).all(), err.max()
    out = tmp_path / "states.csv"
    slam.save_results(str(out))
    lines = out.read_text().splitlines()
    assert lines[0].startswith("timestamp,qw,qx,qy,qz,px") and len(lines) == len(traj) + 1
    assert len(lines[1].split(",")) == 17


def test_state_machine_reaches_ok_on_cpu(tmp_path):
    """320x240, 4 levels, 3 s of the noisy sim: SYNC -> SFM -> INIT -> OK
    with the health check running, bounded (see _check_run)."""
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    slam, gt = _run_port(cfg, 3.0)
    _check_run(slam, gt, tmp_path)
    assert slam._frame_count >= 24


def test_state_machine_at_kitti_profile_width_takes_k3_route(tmp_path):
    """A kitti-profile rig 328 px wide (328 % 16 = 8), 4 levels, 3 s: the
    state machine reaches OK with every extraction on K3's route (its twin
    on the CPU) and never on K1's, and stays bounded."""
    g = testing.G
    sdt = np.sqrt(1.0 / 200)
    cfg = testing.sim_config(dataset="kitti", width=328, height=200, keyframe_rotation=0.1,
                             keyframe_translation=0.15, acc_noise=2.0e-3 / g,
                             gyr_walk=1.9e-5 * sdt, acc_walk=3.0e-3 * sdt / g)
    with mock.patch.object(tfast, "score_nms_plain", wraps=tfast.score_nms_plain) as k3, \
            mock.patch.object(tfast, "select_plain", wraps=tfast.select_plain) as k1:
        slam, gt = _run_port(cfg, 3.0)
    assert k1.call_count == 0
    assert k3.call_count >= len(gt)              # every frame extracts once
    _check_run(slam, gt, tmp_path)


def test_entry_point_runs_on_the_card_unless_asked():
    """VisualInertialSLAM defaults to the card and raises without one; on
    the CPU when asked, with the P3P bootstrap (solve_pnp=2), a 1-s run
    reaches OK."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        VisualInertialSLAM(testing.sim_config())
    cfg = testing.sim_config(solve_pnp=2, keyframe_rotation=0.1, keyframe_translation=0.15)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # parallel test processes oversubscribe the cores
    try:
        slam, _ = _run_port(cfg, 1.0)
    finally:
        torch.set_num_threads(threads)
    assert slam.static.pnp_solver == "p3p"
    assert slam.state == State.OK and slam._frame_count > 0
    assert np.isfinite(slam.trajectory).all()


# ---- the copies the port keeps


class _Recorder:
    """Stands in for a SLAM object: records every call it gets."""

    def __init__(self):
        self.calls = []

    def collect_imu_data(self, sensor, ts, x, y, z):
        self.calls.append(("imu", sensor.name, ts, (x, y, z)))

    def process(self, img_l, img_r, ts):
        self.calls.append(("img", ts, np.asarray(img_l), np.asarray(img_r)))
        return True


def _same_calls(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[:3] == y[:3] if x[0] == "imu" else x[:2] == y[:2]
        for u, v in zip(x[3:], y[3:]):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("family", ["A", "B"])
def test_sim_copy_equals_tests_sim(family):
    """sim_config, both trajectory families, rendering and the replay
    `run` (frames, IMU samples with noise, timestamps, ground truth)
    bit-equal to tests/sim.py's."""
    cfg = jsim.sim_config(dataset="kitti", width=200, height=120)
    tcfg = testing.sim_config(dataset="kitti", width=200, height=120)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(tcfg, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    js = jsim.StereoInertialSim(cfg, n_landmarks=60, seed=3, y_max=13.0)
    ts = testing.StereoInertialSim(tcfg, n_landmarks=60, seed=3, y_max=13.0)
    jsim.set_family(js, family)
    testing.set_family(ts, family)
    for name in ("lm", "patches", "g_w"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    jrec, trec = _Recorder(), _Recorder()
    jgt = js.run(jrec, duration=0.3, imu_noise=2.4e-3, seed=13)
    tgt = ts.run(trec, duration=0.3, imu_noise=2.4e-3, seed=13)
    np.testing.assert_array_equal(tgt, jgt)
    _same_calls(trec.calls, jrec.calls)
    for t in (0.0, 4.3, 11.7):
        np.testing.assert_array_equal(ts.traj.rot(t), js.traj.rot(t))
        np.testing.assert_array_equal(ts.vel_at(t), js.vel_at(t))


@pytest.mark.parametrize("run", testing.PROTOCOL_RUNS)
def test_protocol_world_equals_chip_accuracy(run):
    """testing.protocol_world builds the world of benchmarks/chip_accuracy.py
    (its configuration, landmark field, trajectory family, duration and
    IMU seed) bit-equal to the one that script builds from tests/sim.py."""
    family, seed = run[0], int(run[1:])
    duration = 6.0 if family == "A" else 12.0
    cfg = jsim.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    js = jsim.StereoInertialSim(cfg, n_landmarks=150 if family == "A" else 220, seed=seed,
                                y_max=max(11.0, 0.8 * duration + 5.0))
    jsim.set_family(js, family)
    tcfg, ts, t_duration, imu_seed = testing.protocol_world(run)
    assert (t_duration, imu_seed) == (duration, seed + 10)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(tcfg, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    for name in ("lm", "patches", "g_w"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    for t in (0.0, 3.1, duration):
        np.testing.assert_array_equal(ts.traj.pos(t), js.traj.pos(t))
        np.testing.assert_array_equal(ts.traj.rot(t), js.traj.rot(t))


def test_ate_copy_equals_original():
    rng = np.random.default_rng(0)
    gt = np.column_stack([np.arange(50) * 1e8, np.cumsum(rng.normal(size=(50, 3)), 0)])
    est = gt.copy()
    est[:, 0] += rng.integers(-5e6, 5e6, 50)
    est[:, 1:] = est[:, 1:] @ np.asarray(jsim.Trajectory().rot(1.0)).T + [1, 2, 3]
    est[:, 1:] += rng.normal(0, 0.05, (50, 3))
    for align in (True, False):
        for scale in (True, False):
            assert tate.ate_rmse(est, gt, align, scale) == jate.ate_rmse(est, gt, align, scale)
    for a, b in zip(tate.umeyama(est[:, 1:], gt[:, 1:], True),
                    jate.umeyama(est[:, 1:], gt[:, 1:], True)):
        np.testing.assert_array_equal(a, b)


def test_kitti_replay_copy_equals_original(tmp_path):
    """The KITTI replay loop over a small fake sequence (rate 4, 16 IMU
    rows, 4 images, the third unreadable) makes the same calls in the same
    order and returns the same count."""
    oxts = tmp_path / "oxts" / "processed"
    oxts.mkdir(parents=True)
    rng = np.random.default_rng(1)
    (oxts / "timestamps.txt").write_text("\n".join(str(1000 * i) for i in range(16)))
    for i in range(16):
        (oxts / f"{i:010d}.txt").write_text(" ".join(f"{v:.6f}" for v in rng.normal(size=6)))
    (tmp_path / "image_00").mkdir()
    (tmp_path / "image_00" / "processed_timestamps.txt").write_text(
        "\n".join(str(5000 * i + 7) for i in range(4)))

    def imread(path):
        if path.endswith("0000000002.png"):
            return None
        return np.full((4, 6), len(path) + int(path[-5]), np.uint8)

    results = []
    for mod, slam_mod in ((jkitti, "pose_estimation_tpu.slam"),
                          (tkitti, "pose_estimation_tpu_torch.slam")):
        rec = _Recorder()
        ds = mod.KittiDataset(str(tmp_path))
        n = mod.run_kitti(rec, ds, max_num_imu=100, max_num_image=10, rate=4, imread=imread)
        results.append((n, rec.calls))
        assert importlib.import_module(slam_mod)
    assert results[0][0] == results[1][0] == 3
    _same_calls(results[1][1], results[0][1])


# ---- the port stands alone


_NO_JAX = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "pose_estimation_tpu", "yaml", "cv2"):
    sys.modules[name] = None          # any import of them now fails
import pose_estimation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None
          and (k == "jax" or k.startswith(("jax.", "jaxlib", "pose_estimation_tpu.")))]
assert not loaded, loaded
print("OK", len(names))
"""


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of the port (54) imports with `jax`, the JAX package,
    PyYAML and OpenCV made unimportable, and no source line of the port
    imports JAX or the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[1]) >= 54
    pkg_dir = os.path.dirname(pose_estimation_tpu_torch.__file__)
    for m in pkgutil.walk_packages([pkg_dir], "pose_estimation_tpu_torch."):
        path = importlib.util.find_spec(m.name).origin
        for line in open(path):
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "pose_estimation_tpu"), (path, line)
