"""PyTorch port: the device calls as captured graphs (`graphs.py`), on the
CPU, where the runners keep their static buffers and run without capture.

- No operation of the captured functions reads the device on the host:
  the fused frame (`ok_step`, the PSD clip inside) on each front end (the
  kernel path, the map front end with sparse angles and with K4's maps,
  K3's width in dense mode) and with keyframe full BA, the four stages,
  `integrate_chunk`, the batched step, and the state machine's other
  calls (`sfm_step` with each PnP solver, `bootstrap_frame`, `full_init`,
  `refine_gravity` in its routine and warm forms, the SfM constraint's
  `finalize`, the left image's extraction) run under a
  `TorchDispatchMode` that fails on `_local_scalar_dense` (`item`,
  `int()`, a Python index by a 0-dim tensor), `nonzero`, `masked_select`,
  `_linalg_check_errors`, an index by a bool tensor, and any
  eigendecomposition or SVD of the library (K6's twins excepted). The
  same mode fails on a tensor made from host values inside the step
  (`torch.tensor`, `as_tensor`, `from_numpy`: a copy to the card, which a
  capture refuses) and on a copy from a CPU tensor to another device.
  Each step runs once before it is watched, as the runner warms it up
  before capture (a cached table made then is made once). The kernels'
  CPU twins stand for launches whose wrappers read only shapes, and run
  unwatched.
- The runner's plumbing: four frames chained through
  `graphs.FrameGraphs` equal four direct `ok_step` calls bit for bit and
  stay within the JAX chain's 5 mm (`test_torch_vio.py`'s bound), on the
  map front end; `ok_scan` as one step equals the chain.
- The graphed state machine from SYNCHRONIZING against the eager one
  (`graphed=False`) over a 2-s run with a gravity refinement, then one
  warm recovery each, bit for bit, every solve of the state machine
  through its own graph.
- The graphed state machine: eight OK frames through
  `VisualInertialSLAM.process` equal direct `ok_step` calls bit for bit;
  the health check's eight pending entries are the eight frames' own
  values (copies, not views of the static outputs the next frame
  overwrites); `load_checkpoint` into a state machine whose graphs hold
  another state, and a reinit's assignment of `slam.vio`, are written
  into the runner's buffers.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes  # noqa: E402
from torch_parity import jax_map_setup, ransac_uniforms, to_np, torch_map_setup, world  # noqa: E402

from pose_estimation_tpu_torch import graphs, testing  # noqa: E402
from pose_estimation_tpu_torch.backend import ba as tba  # noqa: E402
from pose_estimation_tpu_torch.camera import CameraModel  # noqa: E402
from pose_estimation_tpu_torch.imu import preintegration as tpre  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402
from pose_estimation_tpu_torch.ops import moments as tmoments  # noqa: E402
from pose_estimation_tpu_torch.ops import sample as tsample  # noqa: E402
from pose_estimation_tpu_torch.ops import small_linalg  # noqa: E402
from pose_estimation_tpu_torch.utils import lie  # noqa: E402
from pose_estimation_tpu_torch.backend import init_solvers  # noqa: E402
from pose_estimation_tpu_torch.parallel import batched  # noqa: E402
from pose_estimation_tpu_torch.slam import SensorType, State, VisualInertialSLAM  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402

CFG = dict(max_num_iterations=4, keyframe_translation=0.03, keyframe_rotation=1.0)
# the host-read watch needs no particular scene: every branch of the step
# is computed and selected whatever the data, so the smallest images do
TINY = dict(width=96, height=64, levels=2, features=60, camera_frequency=40, imu_chunk=8,
            max_num_iterations=2)
HOST_READS = {"aten._local_scalar_dense.default", "aten.nonzero.default",
              "aten.masked_select.default", "aten._linalg_check_errors.default",
              "aten.lift_fresh.default", "aten.lift_fresh_copy.default",
              # the library's decompositions check their results on the host
              "aten._linalg_eigh.default", "aten._linalg_svd.default"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (see tests/test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


class _HostReads(TorchDispatchMode):
    """Records every operation that reads the device on the host or
    copies host values to it."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.clips = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name in HOST_READS:
            self.found.append(name)
        if name.startswith(("aten.index.", "aten.index_put")):
            index = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
                self.found.append(name + " by a bool tensor")
        if name in ("aten._to_copy.default", "aten.copy_.default"):
            src = args[1] if name == "aten.copy_.default" else args[0]
            dst = (args[0].device if name == "aten.copy_.default"
                   else kwargs.get("device") or getattr(src, "device", "cpu"))
            if (isinstance(src, torch.Tensor) and src.device.type == "cpu"
                    and torch.device(dst).type != "cpu"):
                self.found.append(name + " from the host")
        return func(*args, **kwargs)

    def made_from_host(self, what):
        self.found.append(f"torch.{what} inside the step")


@functools.lru_cache(maxsize=8)
def _tiny(width=96, **over):
    cfg = testing.synthetic_config(**{**TINY, "width": width, **over})
    consts, static = tvio.build_constants(cfg, CameraModel.from_config(cfg), "cpu")
    frames, gyrs, accs, mask, truth = testing.sim_frames(cfg, 2, n_landmarks=120)
    return consts, static, frames, gyrs, accs, mask, truth


def _watched(run, twins=True):
    """Run `run()` twice, the second time watched; returns the watch. The
    kernels' twins run unwatched; the PSD clips are counted."""
    mode = _HostReads()
    flags = {"watch": False, "quiet": 0}

    def quiet(fn):
        def wrapper(*a, **k):
            flags["quiet"] += 1
            try:
                with _disable_current_modes():
                    return fn(*a, **k)
            finally:
                flags["quiet"] -= 1
        return wrapper

    clip = tba.psd_clip

    def watched_clip(schur):
        mode.clips += flags["watch"]
        return clip(schur)

    def host_made(what, fn):
        def wrapper(data, *a, **k):
            if flags["watch"] and not flags["quiet"] and not isinstance(data, torch.Tensor):
                mode.made_from_host(what)
            return fn(data, *a, **k)
        return wrapper

    patches = [mock.patch.object(tba, "psd_clip", watched_clip)]
    if twins:
        patches += [mock.patch.object(tfast, name, quiet(getattr(tfast, name)))
                    for name in ("select_plain", "score_nms_plain")]
        patches += [mock.patch.object(tsample, "sample_stack_plain",
                                      quiet(tsample.sample_stack_plain)),
                    mock.patch.object(tmoments, "moment_maps_plain",
                                      quiet(tmoments.moment_maps_plain))]
        patches += [mock.patch.object(small_linalg, name, quiet(getattr(small_linalg, name)))
                    for name in ("eigh_plain", "svd_plain")]
    patches += [mock.patch.object(torch, what, host_made(what, getattr(torch, what)))
                for what in ("tensor", "as_tensor", "from_numpy")]
    for p in patches:
        p.start()
    try:
        run()
        flags["watch"] = True
        with mode:
            run()
    finally:
        for p in patches:
            p.stop()
    return mode


def _frame_args(frames, gyrs, accs, mask, i=1):
    return (_t(frames[i][0]), _t(frames[i][1]), _t(gyrs[i]), _t(accs[i]), _t(mask))


def _uniforms(seed=0):
    return tvio.draw_ransac_uniforms(torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("front", ["kernel-full-ba", "map-sparse", "map-k4", "kitti-width-dense"])
def test_fused_frame_reads_nothing_on_the_host(front):
    """The fused frame, one captured graph (`ok_step`: `ok_head`, `psd_clip`,
    `track_tail`), on each front end: no host read, one clip."""
    over = {"kernel-full-ba": dict(full_ba_keyframes=True),
            "map-sparse": dict(fast_backend="xla", sample_backend="xla"),
            "map-k4": dict(fast_backend="xla", sample_backend="xla"),
            "kitti-width-dense": dict(width=104, rectify_mode="dense")}[front]
    consts, static, frames, gyrs, accs, mask, truth = _tiny(**over)
    if front == "map-k4":
        static = dataclasses.replace(static, orb=static.orb._replace(moments_backend="pallas"))
    state = testing.seeded_state(static, truth, "cpu")
    args = _frame_args(frames, gyrs, accs, mask)

    def run():
        tvio.ok_step(state, *args, None, consts, static, ransac_u=_uniforms())

    mode = _watched(run)
    assert mode.found == [] and mode.clips == 1, mode.found


def test_stages_and_integrate_read_nothing_on_the_host():
    """The staged frame's four captured stages (`stage_imu`,
    `stage_frontend`, `stage_ba` with the clip inside, `stage_pool` with
    `frame_outputs`) and `integrate_chunk`: no host read, one clip."""
    consts, static, frames, gyrs, accs, mask, truth = _tiny()
    state = testing.seeded_state(static, truth, "cpu")
    img_l, img_r, gyr, acc, m = _frame_args(frames, gyrs, accs, mask)

    def run():
        tpre.integrate_chunk(state.preint, gyr, acc, m, state.bg, state.ba, consts.imu)
        st, dt = tvio.stage_imu(state, gyr, acc, m, consts, static)
        p_pred = st.win.p[-1]
        st, cur, tr = tvio.stage_frontend(st, img_l, img_r, _uniforms(), consts, static)
        st, cost, iters = tvio.stage_ba(st, tr.n_matches, consts, static)
        st = tvio.stage_pool(st, cur, tr, tr.n_matches, consts, static)
        tvio.frame_outputs(st, cur, tr, cost, iters, dt, p_pred)

    mode = _watched(run)
    assert mode.found == [] and mode.clips == 1, mode.found


def test_batched_step_reads_nothing_on_the_host():
    """The batched step, one captured graph (`make_batched_step`: one
    extraction, `track_head` under vmap, the clip, `track_tail` under
    vmap) at B = 2: no host read, one clip of both lanes' Schur
    complements."""
    consts, static, frames, gyrs, accs, mask, truth = _tiny()
    states = batched.stack_states([testing.seeded_state(static, truth, "cpu")] * 2)
    img_l, img_r, gyr, acc, m = (torch.stack([a, a]) for a in
                                 _frame_args(frames, gyrs, accs, mask))
    u = torch.stack([torch.stack(_uniforms(0)), torch.stack(_uniforms(1))])
    step = batched.make_batched_step(consts, static)

    def run():
        step(states, img_l, img_r, gyr, acc, m, u)

    mode = _watched(run)
    assert mode.found == [] and mode.clips == 1, mode.found


def _imu_chain(consts, k, seed=0):
    """(R [K, 3, 3], p [K, 3], ics [K-1]): a keyframe chain of small random
    motions with the constraints of random IMU chunks (the watch needs no
    particular values)."""
    g = torch.Generator().manual_seed(seed)
    zero3 = torch.zeros(3)
    ics = []
    for _ in range(k - 1):
        gyr = 0.1 * torch.randn(8, 3, generator=g)
        acc = torch.tensor([0.0, 0.0, 9.81]) + 0.5 * torch.randn(8, 3, generator=g)
        st = tpre.integrate_chunk(tpre.init_state("cpu"), gyr, acc, torch.ones(8, dtype=torch.bool),
                                  zero3, zero3, consts.imu)
        ics.append(tpre.finalize(st, zero3, zero3, consts.imu))
    R = lie.so3_exp(0.05 * torch.randn(k, 3, generator=g))
    p = torch.cumsum(0.1 * torch.randn(k, 3, generator=g), dim=0)
    return R, p, tpre.ImuConstraint(*(torch.stack(a) for a in zip(*ics)))


@pytest.mark.parametrize("call", ["seed_ref", "sfm_step-dlt", "sfm_step-epnp", "sfm_step-p3p",
                                  "finalize", "full_init", "bootstrap_frame", "refine",
                                  "recover"])
def test_solves_read_nothing_on_the_host(call):
    """The state machine's other calls, each one captured graph
    (`graphs.SolveGraphs`): the left image's extraction, `sfm_step` with
    each PnP solver, the SfM constraint's `finalize`, `full_init`,
    `bootstrap_frame`, and `refine_gravity` in its routine and warm forms
    (the keyframe chain at the minimum length): no host read."""
    consts, static, frames, gyrs, accs, mask, truth = _tiny()
    img_l, img_r, gyr, acc, m = _frame_args(frames, gyrs, accs, mask)
    cfg = testing.synthetic_config(**TINY)
    prof = cfg.profile
    unit_g = torch.tensor(prof.gravity_dir, dtype=torch.float32)
    gravity = torch.tensor(cfg.gravity, dtype=torch.float32)
    state = testing.seeded_state(static, truth, "cpu")
    name, _, solver = call.partition("-")
    if name == "sfm_step":
        static = dataclasses.replace(static, pnp_solver=solver)
        ref, _ = tvio.extract_rectified(*_frame_args(frames, gyrs, accs, mask, 0)[:2], consts,
                                        static)
        u = tvio.draw_sfm_uniforms(torch.Generator().manual_seed(0), "cpu", solver)
    R, p, ics = _imu_chain(consts, 6)
    preint = tpre.integrate_chunk(state.preint, gyr, acc, m, state.bg, state.ba, consts.imu)

    run = {
        "seed_ref": lambda: tvio.extract_rectified(img_l, img_l, consts, static),
        "sfm_step": lambda: tvio.sfm_step(img_l, img_r, ref.desc, ref.xy, ref.valid, u, consts,
                                          static),
        "finalize": lambda: tpre.finalize(preint, state.bg, state.ba, consts.imu),
        "full_init": lambda: init_solvers.full_init(R, p, ics, unit_g, prof.alignment_axes,
                                                    gravity),
        "bootstrap_frame": lambda: tvio.bootstrap_frame(state, img_l, img_r, _uniforms(), consts,
                                                        static),
        "refine": lambda: init_solvers.refine_gravity(R, p, ics, unit_g, prof.alignment_axes,
                                                      gravity, sigma_tilt=2.0, sigma_dba=2.0),
        "recover": lambda: init_solvers.refine_gravity(R, p, ics, unit_g, prof.alignment_axes,
                                                       gravity, sigma_tilt=5.0, sigma_dba=5.0,
                                                       rounds=3),
    }[name]
    mode = _watched(run)
    assert mode.found == [], mode.found


def test_watch_finds_host_reads():
    """The watch itself: an `int()` of a device value, an index by a bool
    tensor, a tensor made from a list, the library's eigendecomposition
    and SVD are each found, and K6's twins are not."""
    x = torch.arange(6.0)

    def run():
        int(x.sum())
        x[x > 2]
        torch.tensor([1.0, 2.0])
        torch.linalg.eigh(torch.eye(3))
        torch.linalg.svd(torch.eye(3))

    found = _watched(run, twins=False).found
    assert "aten._local_scalar_dense.default" in found
    assert any("by a bool tensor" in f or f == "aten.nonzero.default" for f in found)
    assert "torch.tensor inside the step" in found
    assert "aten._linalg_eigh.default" in found
    assert "aten._linalg_svd.default" in found
    twins = _watched(lambda: (small_linalg.eigh(torch.eye(3)), small_linalg.svd(torch.eye(3))))
    assert twins.found == []


@functools.lru_cache(maxsize=1)
def _jax_chain(n):
    """The JAX chain from the seeded state on the map front end: per frame
    its metrics' rec_p and its RANSAC uniforms, and the world."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_map_setup(**CFG)
    frames, gyrs, accs, mask, state0 = world(8)
    step = jax.jit(functools.partial(jvio.ok_step, consts=consts, static=static))
    st = seeded_state(static, state0)
    rec_p, us = [], []
    for i in range(n):
        key = jax.random.PRNGKey(i)
        us.append(ransac_uniforms(key))
        st, m = step(st, *frames[i], gyrs[i], accs[i], mask, key)
        rec_p.append(to_np(m)["rec_p"])
    return rec_p, us


def test_runner_chain_equals_direct_steps_and_jax():
    """Four frames through `FrameGraphs.ok_step` from the seeded state: the
    state and metrics equal four direct `ok_step` calls bit for bit, and
    the newest position stays within 5 mm of the JAX chain's."""
    rec_p, us = _jax_chain(4)
    _, consts, static = torch_map_setup(**CFG)
    frames, gyrs, accs, mask, state0 = world(8)
    direct = testing.seeded_state(static, state0, "cpu")
    runner = graphs.FrameGraphs(direct, consts, static, "cpu")
    for i in range(4):
        u = tuple(_t(a) for a in us[i])
        args = _frame_args(frames, gyrs, accs, mask, i)
        direct, dm = tvio.ok_step(direct, *args, None, consts, static, ransac_u=u)
        gm = runner.ok_step(*args, u)
        for a, b in zip(tree_leaves(direct), tree_leaves(runner.state)):
            assert torch.equal(a, b), i
        for k, v in dm.items():
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(v), tree_leaves(gm[k]))), k
        assert np.linalg.norm(gm["rec_p"].numpy() - rec_p[i]) <= 5e-3, i
    assert set(runner.steps) == {"frame"}
    assert runner.steps["frame"].replays == 4

    # the four frames as one `ok_scan` step, from the seeded state, with the
    # uniforms of four draws in a row
    scan = graphs.FrameGraphs(testing.seeded_state(static, state0, "cpu"), consts, static, "cpu")
    gen, chain = torch.Generator().manual_seed(5), graphs.FrameGraphs(
        testing.seeded_state(static, state0, "cpu"), consts, static, "cpu")
    stacked = [torch.stack(a) for a in zip(*(_frame_args(frames, gyrs, accs, mask, i)
                                            for i in range(4)))]
    outs = scan.ok_scan(*stacked, torch.Generator().manual_seed(5))
    for i in range(4):
        m = chain.ok_step(*(a[i] for a in stacked), tvio.draw_ransac_uniforms(gen, "cpu"))
        assert torch.equal(outs["p"][i], m["rec_p"]) and torch.equal(outs["R"][i], m["rec_R"]), i
    for a, b in zip(tree_leaves(chain.state), tree_leaves(scan.state)):
        assert torch.equal(a, b)
    assert set(scan.steps) == {"scan"} and scan.steps["scan"].replays == 1


def _feed(slam, frames, gyrs, accs, mask, i, cfg):
    """Frame i's IMU samples, then its images, through the ingestion API:
    the samples lie one sample period apart before the image, so the
    frame's chunk holds exactly them."""
    dt_ns = 1_000_000_000 // cfg.sampling_rate
    n = int(mask.sum())
    img_ts = (i + 1) * 10 * n * dt_ns
    for k in range(n):
        ts = img_ts - (n - k) * dt_ns
        slam.collect_imu_data(SensorType.GYROSCOPE, ts, *map(float, gyrs[i][k]))
        slam.collect_imu_data(SensorType.ACCELEROMETER, ts, *map(float, accs[i][k]))
    assert slam.process(frames[i][0], frames[i][1], img_ts)


def _ok_slam(cfg, consts, static, state, **kwargs):
    slam = VisualInertialSLAM(cfg, device="cpu", **kwargs)
    slam.consts, slam.static = consts, static
    slam.state, slam.vio = State.OK, state
    return slam


def test_graphed_state_machine_keeps_its_frames(tmp_path):
    """Eight OK frames through the graphed state machine (CPU plumbing)
    from the seeded state: the state equals eight direct `ok_step` calls
    with the state machine's draws bit for bit, and the health check's
    eight pending entries are the frames' own values. A checkpoint after
    frame 4, loaded into a state machine whose graphs already hold
    another state, continues to the same state; a reinit's assignment of
    `slam.vio` reaches the runner's buffers."""
    cfg, consts, static = torch_map_setup(**CFG)
    frames, gyrs, accs, mask, state0 = world(8)
    seeded = testing.seeded_state(static, state0, "cpu")
    gen = torch.Generator().manual_seed(0)
    direct, positions = seeded, []
    for i in range(8):
        direct, m = tvio.ok_step(direct, *_frame_args(frames, gyrs, accs, mask, i), gen,
                                 consts, static)
        positions.append(m["rec_p"])

    pending = []

    def health(slam):
        def check(img_l, img_r):
            pending.append(list(slam._pending_health))
            slam._pending_health = []
            return True
        return check

    slam = _ok_slam(cfg, consts, static, seeded)
    slam.reinit_check_every = 8
    with mock.patch.object(slam, "_health_check", health(slam)):
        for i in range(8):
            _feed(slam, frames, gyrs, accs, mask, i, cfg)
            if i == 3:
                slam.save_checkpoint(str(tmp_path / "mid.npz"))
    assert slam.vio is slam._graphs.state
    for a, b in zip(tree_leaves(direct), tree_leaves(slam.vio)):
        assert torch.equal(a, b)
    (entries,) = pending
    assert len(entries) == 8
    for (_, _, _, snap), p in zip(entries, positions):
        assert torch.equal(snap[1], p)
    assert len({tuple(snap[1].tolist()) for _, _, _, snap in entries}) == 8
    assert len(slam._records) == 8
    assert all(torch.equal(r[2], p) for r, p in zip(slam._records, positions))

    # a second state machine, its graphs built on other frames, resumes
    other = _ok_slam(cfg, consts, static, testing.seeded_state(static, state0, "cpu", j=2))
    for i in (0, 1):
        _feed(other, frames, gyrs, accs, mask, i, cfg)
    other.load_checkpoint(str(tmp_path / "mid.npz"))
    other.consts, other.static = consts, static
    with mock.patch.object(other, "_health_check", health(other)):
        for i in range(4, 8):
            _feed(other, frames, gyrs, accs, mask, i, cfg)
    for a, b in zip(tree_leaves(direct), tree_leaves(other.vio)):
        assert torch.equal(a, b)
    assert all(torch.equal(e[3][1], p) for e, p in zip(pending[1], positions))

    # a reinit's state replaces the live one in the buffers
    slam.vio = seeded
    g = slam._frame_graphs()
    assert g is slam._graphs
    for a, b in zip(tree_leaves(seeded), tree_leaves(g.state)):
        assert torch.equal(a, b)


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


def _same_machines(graphed, eager):
    assert graphed.state == eager.state
    for a, b in zip(tree_leaves(graphed.vio), tree_leaves(eager.vio)):
        assert torch.equal(a, b)
    assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())
    assert len(graphed._kf_hist) == len(eager._kf_hist)
    for ha, hb in zip(graphed._kf_hist, eager._kf_hist):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ha), tree_leaves(hb)))
    np.testing.assert_array_equal(graphed.trajectory, eager.trajectory)


def test_graphed_state_machine_equals_eager_from_the_start():
    """320x240, 4 levels, 2 s with IMU noise, from SYNCHRONIZING: the
    graphed state machine (the left image's extraction, the SfM frames and
    their constraints, the initializer and the bootstrap frame through the
    solve runner, its IMU chunks integrated through the frame runner, then
    its OK frames, with a health check every 4 frames and a gravity
    refinement over 3 keyframes; each solve eager at its first call and a
    graph from its second) and the eager one (`graphed=False`) with
    the same seed reach OK with equal device state, keyframe history,
    generator state and trajectory, bit for bit: nothing the host keeps
    (the SfM chain's constraints, the reference features, records, pending
    frames) aliases a runner's buffers. Then two warm recoveries each (the
    first eager, the second its graph's replay), again bit for bit."""
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    graphed = VisualInertialSLAM(cfg, device="cpu")
    eager = VisualInertialSLAM(cfg, device="cpu", graphed=False)
    for slam in (graphed, eager):
        slam.reinit_check_every = 4
        slam.gravity_refine_min = slam.gravity_refine_every = 3
    world = testing.StereoInertialSim(cfg, n_landmarks=150, seed=0)
    world.run(_Both(graphed, eager), duration=2.0, imu_noise=2.4e-3, seed=10)
    assert graphed.state == eager.state == State.OK
    assert graphed._graphs is not None and eager._graphs is None and eager._solve_graphs is None
    assert graphed._graphs.steps["integrate"].replays > 0
    assert graphed._frame_count == eager._frame_count >= graphed.reinit_check_every
    assert len(graphed._kf_hist) >= graphed.gravity_refine_min
    _same_machines(graphed, eager)
    for _ in range(2):      # the first eagerly, the second a replay
        assert graphed._warm_recover() == eager._warm_recover()
        _same_machines(graphed, eager)
    # every solve went through the runner: the first call of a name and
    # shapes eagerly, every later one as a replay of its graph
    runner = graphed._solve_graphs
    assert {key[0] for key in runner.calls} == {
        "seed_ref", "sfm_step", "finalize", "full_init", "bootstrap_frame", "refine",
        "recover"}, runner.calls
    for key, n in runner.calls.items():
        step = runner.steps.get(key)
        assert (step.replays if step else 0) == n - 1, (key[0], n)
    assert {key[0] for key in runner.steps} >= {"sfm_step", "finalize", "recover"}
