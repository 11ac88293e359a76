"""VisualInertialSLAM: the host state machine around the frame steps.

Counterpart of `pose_estimation_tpu/slam.py`: the same states
(SYNCHRONIZING -> SFM -> INITIALIZING -> OK), the same ingestion API
(`collect_imu_data`, `process`, `save_results`, `trajectory`), the same
gates, health check, online gravity refinement and warm-first recovery.
The numerics run on `device` (the card unless the caller asks for the
CPU); the host only sequences them. The host reads device values at the
points where the JAX package does: each SfM frame's PnP result, the
initializer's plausibility gates, the gravity refinements and the health
check every `reinit_check_every` OK frames (one transfer for the pending
frames); `models.vio.ok_step` reads nothing. With `metrics_jsonl` each OK
frame's metrics are also written as a JSON line (a host read per frame).
`save_checkpoint` and `load_checkpoint` carry the device state and the
host state a resumed run needs to continue identically, the random
generator's state included.

Every device call runs as a captured CUDA graph, as each is one jitted
program in the JAX package. The OK frame is one graph
(`graphs.FrameGraphs`): the host copies the frame's images, IMU chunk and
RANSAC uniforms into static buffers and replays; the IMU chunks beyond
one are integrated by a graph of their own. The live state is then the
graphs' static buffers: an assignment of `self.vio` (a reinit, a
recovery, `load_checkpoint`) is copied into them before the next replay,
and what the host keeps across frames (records, the health check's
pending frames, the keyframe history) is copied out of them
(`graphs.snapshot`). The other calls (`_seed_ref`, `sfm_step`, the SfM
constraint's `finalize`, `full_init`, `bootstrap_frame`, the routine
gravity refinement and the warm recovery) are graphs of
`graphs.SolveGraphs`, one per call and input shape, each with its own
memory, captured at the second call of that shape (the first runs
eagerly): the host draws their uniforms eagerly, copies the inputs in,
replays, and reads the plausibility gates after the replay, where the
JAX package reads them. `_apply_alignment` and `_history_chain` stay
eager, as in the JAX package. On the CPU the same plumbing runs without
capture. `graphed=False` runs every call eagerly, the yardstick the
graphs are held to.
`staged=True` runs the OK frame as the four stages of `models.vio`
(`stage_imu`, `stage_frontend`, `stage_ba`, `stage_pool`), each its own
graph, which a caller can time one by one; the fused frame is the same
code in one graph.
Spans (`profiling.span`, recorded with tracing on): each call of `process`
is the host span `slam.process`, carrying the frame's id (the count of
earlier calls), with the children `slam.imu` (the IMU queue to the
device, overflow chunks integrated), `slam.inputs` (the pageable image
copies, and the copies into the graphs' static inputs), `slam.uniforms`
(the RANSAC draws), `slam.replay` (a device call: a graph's replay, or an
eager call), `slam.record` (what the host keeps of the frame) and
`slam.health` (the health check and what it starts); `slam.wait` marks
every blocking read of the device. `counters()` gives the calls of
`process`, the solves' calls, the graphs captured and their replays.
`set_viewer` attaches a live viewer (`live_viewer.LiveViewer`), fed after
every OK frame (host reads of the window, and of the pool every
`viewer_landmark_every` frames). `refresh_kf_hist` (off by default, as in
the JAX package) re-snapshots the keyframe history's entries still in the
window at each health check.
"""

from __future__ import annotations

import json
from enum import Enum

import numpy as np
import torch

from pose_estimation_tpu_torch import checkpoint as ckpt
from pose_estimation_tpu_torch import graphs, profiling
from pose_estimation_tpu_torch.backend import init_solvers
from pose_estimation_tpu_torch.camera import CameraModel
from pose_estimation_tpu_torch.imu import preintegration as pre
from pose_estimation_tpu_torch.imu.preintegration import ImuConstraint
from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.utils import lie
from pose_estimation_tpu_torch.utils.config import VIOConfig
from pose_estimation_tpu_torch.utils.precision import require_cuda
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_unflatten


class State(Enum):
    SYNCHRONIZING = 0
    SFM = 1
    INITIALIZING = 2
    OK = 3
    LOST = 4


class SensorType(Enum):
    ACCELEROMETER = 0
    GYROSCOPE = 1


def _host(name: str, **attrs):
    """The host span `name` (`profiling.span`)."""
    return profiling.span(name, host=True, **attrs)


def _stack_ics(ics) -> ImuConstraint:
    """Stack a list of single constraints along a new leading axis."""
    return ImuConstraint(*(torch.stack(a) for a in zip(*ics)))


def reseed_window(win, R, v, p, ics):
    """`Map::reset(0)` after the initializer: the last two frames of the
    solved chain (R, v, p [W, ...], constraints [W-1]) become the window's
    two newest frames, the newest constraint the one between them; the bias
    increments, the IMU timer and the marginalization prior start afresh
    (a new world frame invalidates the prior)."""
    w = R.shape[0]
    dev = win.R.device

    def last_two(a, s):
        return torch.cat([a[:-2], s[w - 2:w]], 0)

    return win._replace(
        R=last_two(win.R, R), v=last_two(win.v, v), p=last_two(win.p, p),
        dbg=torch.zeros_like(win.dbg), dba=torch.zeros_like(win.dba),
        ics=ImuConstraint(*(torch.cat([a[:-1], s[w - 2:w - 1]], 0)
                            for a, s in zip(win.ics, ics))),
        n_act=torch.tensor(1, dtype=torch.int32, device=dev),
        is_keyframe=torch.tensor(True, device=dev),
        sum_imu_time=torch.zeros_like(win.sum_imu_time),
        prior_h=torch.zeros_like(win.prior_h),
        prior_on=torch.tensor(False, device=dev),
    )


class VisualInertialSLAM:
    def __init__(self, cfg: VIOConfig, verbose: bool = False, seed: int = 0,
                 reinit_on_bias_corruption: bool = True, reinit_check_every: int = 8,
                 refine_sigmas: tuple[float, float] = (2.0, 2.0), device="cuda",
                 metrics_jsonl: str | None = None, staged: bool = False,
                 graphed: bool = True):
        self.cfg = cfg
        self.verbose = verbose
        # every device call as a captured graph (on the CPU the same static
        # buffers without capture); False runs them eagerly
        self.graphed = graphed
        self._graphs: graphs.FrameGraphs | None = None
        self._solve_graphs: graphs.SolveGraphs | None = None
        # the OK frame as four calls (stage by stage timing) instead of the
        # fused ok_step; both run the same stages
        self.staged = staged
        self._metrics_sink = open(metrics_jsonl, "w") if metrics_jsonl else None
        self.device = (require_cuda() if torch.device(device).type == "cuda"
                       else torch.device(device))
        dev = self.device
        self.reinit_on_bias_corruption = reinit_on_bias_corruption
        self.reinit_check_every = reinit_check_every
        self._frame_count = 0
        # calls of `process` (the frame id of its spans)
        self._process_calls = 0
        # tracking loss: persistent low track counts trigger a re-bootstrap
        self.min_tracked = 8
        self.lost_after = 3
        self._low_track_streak = 0
        self._pending_health: list[tuple] = []
        # online gravity refinement over an accumulated keyframe chain (the
        # JAX package's slam.py documents each knob and its measurement)
        self.gravity_refine_window = 12   # keyframes per chain (0 disables)
        self.gravity_refine_min = 6
        self.gravity_refine_every = 6     # keyframes between refinements
        self.max_refine_angle = 0.12      # rad
        self.max_refine_dba = 3.0         # m/s^2
        self._kf_hist: list[tuple] = []
        self._kfs_since_refine = 0
        # whether the newest processed frame was a keyframe (it then sits at
        # window slot -1 until the next frame shifts it to -2): the slot
        # mapping of _refresh_kf_hist
        self._last_was_kf = False
        # re-snapshot the history's in-window entries from the current
        # window at each health check; off by default (the JAX package's
        # measurements found the refreshed chains no better)
        self.refresh_kf_hist = False
        self.reinit_patience = 1
        self._corrupt_streak = 0
        # warm-first bias-corruption recovery, escalating to the cold reinit
        # after warm_recovery_max accepted warm passes that do not clear it
        self.warm_recovery = True
        self.warm_recovery_max = 2
        self._warm_streak = 0
        self.max_recover_angle = 0.35     # rad
        self.max_recover_dba = 3.0        # m/s^2
        # initializer sanity gates
        self.min_sfm_inliers = 20
        self.max_init_velocity = 20.0
        self.cm = CameraModel.from_config(cfg)
        self.consts, self.static = vio_mod.build_constants(cfg, self.cm, dev)

        self.state = State.SYNCHRONIZING
        self.vio = vio_mod.init_vio_state(self.static, dev)
        self._gen = torch.Generator(device=dev).manual_seed(seed)

        # optional live viewer (`live_viewer.LiveViewer` or anything with its
        # push API) and its landmark-cloud cadence
        self._viewer = None
        self.viewer_landmark_every = 10

        # host-side ingestion queues
        self._gyr = None
        self._acc = None
        self._imu_ts: list[int] = []
        self._imu_data: list[np.ndarray] = []   # [gyr(3), acc(3)]
        self._dt_us = 1_000_000 // cfg.sampling_rate
        self._last_take = 0

        # SfM bootstrap collections (body-to-world, SfM world = first body frame)
        self._sfm_count = 0
        self._ref_feats = None
        self._sfm_R: list[np.ndarray] = []
        self._sfm_p: list[np.ndarray] = []
        self._sfm_ics: list[ImuConstraint] = []

        self._records: list[tuple] = []

        profile = cfg.profile

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32, device=dev)

        self._unit_g = t(profile.gravity_dir)
        self._axes = profile.alignment_axes
        self._gravity = t(cfg.gravity)
        self.refine_sigmas = refine_sigmas

    # ---- ingestion (`collectImuData`)

    def collect_imu_data(self, sensor: SensorType, timestamp: int, x, y, z):
        if sensor == SensorType.ACCELEROMETER:
            self._acc = np.array([x, y, z], np.float64)
        else:
            self._gyr = np.array([x, y, z], np.float64)
        if self._acc is not None and self._gyr is not None:
            self._imu_ts.append(int(timestamp))
            self._imu_data.append(np.concatenate([self._gyr, self._acc]))
            self._acc = None
            self._gyr = None

    def _pop_imu_chunks(self, img_ts: int):
        """Consume the queued samples up to the image timestamp (half-sample
        tolerance; timestamps in ns). Returns a non-empty list of padded
        (gyr [m, 3], acc [m, 3], mask [m]) chunks on the device covering all
        consumed samples: an overflow beyond `imu_chunk` samples becomes
        extra leading chunks."""
        m = self.cfg.imu_chunk
        take = 0
        half = self._dt_us // 2 * 1000
        while take < len(self._imu_ts) and abs(img_ts - self._imu_ts[take]) > half:
            if self._imu_ts[take] > img_ts:
                break
            take += 1
        rows = self._imu_data[:take]
        self._imu_ts = self._imu_ts[take:]
        self._imu_data = self._imu_data[take:]
        self._last_take = take
        if take > m and self.verbose:
            print(f"[slam] imu queue overflow: {take} samples -> "
                  f"{-(-take // m)} chunks of {m}")
        chunks = []
        for lo in range(0, max(take, 1), m):
            part = rows[lo:lo + m]
            n = len(part)
            gyr = np.zeros((m, 3), np.float32)
            acc = np.zeros((m, 3), np.float32)
            mask = np.zeros(m, bool)
            if n:
                arr = np.stack(part)
                gyr[:n] = arr[:, :3]
                acc[:n] = arr[:, 3:]
                mask[:n] = True
            chunks.append(tuple(torch.from_numpy(a).to(self.device) for a in (gyr, acc, mask)))
        return chunks

    def _frame_graphs(self) -> graphs.FrameGraphs:
        """The graphs of the current configuration (made at first use, and
        again after `self.static` or `self.consts` is replaced), holding the
        current state."""
        g = self._graphs
        if g is None or g.static is not self.static or g.consts is not self.consts:
            g = self._graphs = graphs.FrameGraphs(self.vio, self.consts, self.static,
                                                  self.device)
        elif self.vio is not g.state:
            g.load_state(self.vio)
        return g

    def _solve(self, name: str, fn, *args):
        """`fn(*args)` as the graph `name` of the solve runner (made at first
        use, and again after `self.static` or `self.consts` is replaced), or
        eagerly with `graphed=False`. Its outputs are static: what the host
        keeps past the next call of the same name is copied out."""
        if not self.graphed:
            return fn(*args)
        g = self._solve_graphs
        if g is None or g.static is not self.static or g.consts is not self.consts:
            g = self._solve_graphs = graphs.SolveGraphs(self.consts, self.static, self.device)
        return g.run(name, fn, *args)

    def counters(self) -> dict:
        """The device calls so far: `frames`, the calls of `process`;
        `solve_calls`, each graphed solve's calls by name (the eager first
        call of each input shape included); `captures`, the graphs captured
        (the frame graphs' and the solves'); `replays`, each graph's calls
        by name (the solves' summed over their input shapes)."""
        steps = list(self._graphs.steps.values()) if self._graphs is not None else []
        solve_calls, replays = {}, {}
        if self._solve_graphs is not None:
            steps += self._solve_graphs.steps.values()
            for (name, *_), n in self._solve_graphs.calls.items():
                solve_calls[name] = solve_calls.get(name, 0) + n
        for step in steps:
            replays[step.name] = replays.get(step.name, 0) + step.replays
        return {"frames": self._process_calls, "solve_calls": solve_calls,
                "captures": sum(step.graph is not None for step in steps), "replays": replays}

    def _integrate(self, gyr, acc, mask):
        if self.graphed:
            g = self._frame_graphs()
            g.integrate(gyr, acc, mask)
            self.vio = g.state
            return
        self.vio = self.vio._replace(preint=pre.integrate_chunk(
            self.vio.preint, gyr, acc, mask, self.vio.bg, self.vio.ba, self.consts.imu))

    def _pop_imu_chunk(self, img_ts: int):
        """Integrates any overflow chunks into the running preintegration
        and returns the final chunk (which the fused step integrates)."""
        chunks = self._pop_imu_chunks(img_ts)
        for chunk in chunks[:-1]:
            self._integrate(*chunk)
        return chunks[-1]

    def _synchronize(self, img_ts: int) -> bool:
        """Drop IMU samples predating the first image."""
        half = self._dt_us // 2 * 1000
        if not self._imu_ts or img_ts < self._imu_ts[0]:
            return False
        while self._imu_ts and abs(img_ts - self._imu_ts[0]) > half:
            self._imu_ts.pop(0)
            self._imu_data.pop(0)
            if not self._imu_ts:
                return False
        return True

    def _seed_ref(self, img_l):
        c, s = self.consts, self.static
        with _host("slam.replay"):
            fl = self._solve("seed_ref", lambda im: vio_mod.extract_rectified(im, im, c, s)[0],
                             img_l)
        return graphs.snapshot(fl)

    # ---- per-frame processing (`process`)

    def process(self, gray_l: np.ndarray, gray_r: np.ndarray, img_ts: int) -> bool:
        frame = self._process_calls
        self._process_calls += 1
        with _host("slam.process", frame=frame):
            return self._process(gray_l, gray_r, img_ts)

    def _process(self, gray_l, gray_r, img_ts: int) -> bool:
        with _host("slam.inputs"):
            img_l = torch.as_tensor(np.asarray(gray_l)).to(self.device)
            img_r = torch.as_tensor(np.asarray(gray_r)).to(self.device)

        if self.state == State.SYNCHRONIZING:
            if self._synchronize(img_ts):
                self._ref_feats = self._seed_ref(img_l)
                self.state = State.SFM
                if self.verbose:
                    print("[slam] synchronized; entering SFM")
            return True

        if self.state == State.SFM:
            if self._sfm_count < self.cfg.window_size - 1:
                with _host("slam.imu"):
                    self._integrate(*self._pop_imu_chunk(img_ts))
                ref = self._ref_feats
                c, s = self.consts, self.static
                with _host("slam.uniforms"):
                    u = vio_mod.draw_sfm_uniforms(self._gen, self.device, s.pnp_solver)
                with _host("slam.replay"):
                    rvec, tvec, n_inl, feats_l = self._solve(
                        "sfm_step", lambda *a: vio_mod.sfm_step(*a[:5], a[5:], c, s),
                        img_l, img_r, ref.desc, ref.xy, ref.valid, *u)
                with _host("slam.wait"):
                    r_np = rvec.double().cpu().numpy()
                    t_np = tvec.double().cpu().numpy()
                    n_inl = int(n_inl)
                # degenerate-PnP gate
                if n_inl < self.min_sfm_inliers or np.linalg.norm(t_np) > 5.0:
                    if self.verbose:
                        print(f"[slam] SFM frame rejected (inl={n_inl})")
                elif (np.linalg.norm(r_np) > self.cfg.sfm_rotation
                      or np.linalg.norm(t_np) > self.cfg.sfm_translation):
                    self._push_sfm(r_np, t_np)
                    self.vio = self.vio._replace(preint=pre.init_state(self.device))
                    self._sfm_count += 1
                    self._ref_feats = graphs.snapshot(feats_l)
                    if self.verbose:
                        print(f"[slam] SFM frame {self._sfm_count} accepted "
                              f"(|r|={np.linalg.norm(r_np):.4f}, "
                              f"|p|={np.linalg.norm(t_np):.4f}, inl={n_inl})")
            else:
                self._initialize(img_l, img_r, img_ts)
            return True

        if self.state == State.INITIALIZING:
            self._initialize(img_l, img_r, img_ts)
            return True

        if self.state == State.OK:
            with _host("slam.imu"):
                gyr, acc, mask = self._pop_imu_chunk(img_ts)
            if self._last_take == 0:    # the final chunk holds no sample
                if self.verbose:
                    print("[slam] warning: no IMU samples for frame; skipping")
                return False
            with _host("slam.uniforms"):
                ransac_u = vio_mod.draw_ransac_uniforms(self._gen, self.device)
            if self.graphed:
                g = self._frame_graphs()
                run = g.staged_step if self.staged else g.ok_step
                with _host("slam.inputs"):
                    inputs = g.frame_inputs(img_l, img_r, gyr, acc, mask, ransac_u)
                with _host("slam.replay"):
                    out = run(*inputs)
                self.vio = g.state
            elif self.staged:
                with _host("slam.replay"):
                    out = self._staged_step(img_l, img_r, gyr, acc, mask, ransac_u)
            else:
                with _host("slam.replay"):
                    self.vio, out = vio_mod.ok_step(
                        self.vio, img_l, img_r, gyr, acc, mask, None, self.consts,
                        self.static, ransac_u=ransac_u)
            with _host("slam.record"):
                metrics = graphs.snapshot(out) if self.graphed else out
                self._record(img_ts, metrics)
                if self.verbose:
                    print(f"[slam] ts={img_ts} stereo={int(metrics['n_stereo'])} "
                          f"tracked={int(metrics['n_tracked'])} "
                          f"kf={bool(metrics['is_keyframe'])} "
                          f"pool={int(metrics['pool_size'])} "
                          f"ba_iters={int(metrics['ba_iters'])}")
                if self._metrics_sink is not None:
                    with _host("slam.wait"):
                        self._metrics_sink.write(json.dumps({"ts": img_ts, **{
                            k: (float(v) if v.ndim == 0 else v.tolist())
                            for k, v in metrics.items() if not k.startswith("rec_")}}) + "\n")
                    self._metrics_sink.flush()
                self._frame_count += 1
                if self._viewer is not None:
                    with _host("slam.wait"):
                        self._push_viewer(metrics)
                # device scalars wait here and are read in one transfer every
                # reinit_check_every frames; the streaks still advance per frame
                snap = (metrics["rec_R"], metrics["rec_p"], metrics["rec_v"], metrics["rec_ic"])
                self._pending_health.append((
                    metrics["n_tracked"], metrics["need_reinit"], metrics["is_keyframe"], snap))
            if self._frame_count % self.reinit_check_every == 0:
                with _host("slam.health"):
                    return self._health_check(img_l, img_r)
            return True

        return True  # LOST: relocalization is future work, as in the reference

    def _staged_step(self, img_l, img_r, gyr, acc, mask, ransac_u) -> dict:
        """The OK frame as four eager calls; returns the frame's metrics
        (`models.vio.frame_outputs`)."""
        c, s = self.consts, self.static
        self.vio, imu_dt = vio_mod.stage_imu(self.vio, gyr, acc, mask, c, s)
        p_pred = self.vio.win.p[-1]
        self.vio, cur, tr = vio_mod.stage_frontend(self.vio, img_l, img_r, ransac_u, c, s)
        self.vio, ba_cost, ba_iters = vio_mod.stage_ba(self.vio, tr.n_matches, c, s)
        self.vio = vio_mod.stage_pool(self.vio, cur, tr, tr.n_matches, c, s)
        return vio_mod.frame_outputs(self.vio, cur, tr, ba_cost, ba_iters, imu_dt, p_pred)

    def set_viewer(self, viewer):
        """Attach a live viewer (`live_viewer.LiveViewer`, or anything with
        its push API)."""
        self._viewer = viewer

    def _push_viewer(self, metrics):
        """Feed the viewer after an OK frame: the keyframe commit, the
        window's positions, the predicted newest position, the pose, and
        every `viewer_landmark_every` frames the landmark cloud (host
        reads; the viewer is opt-in)."""
        v = self._viewer
        win = self.vio.win
        w = win.p.shape[0] - 1
        if bool(metrics["is_keyframe"]):
            v.push_keyframe()
        p_host = win.p.cpu().numpy()
        for i in range(w):
            v.push_position(p_host[1 + i], i)
        v.push_raw_position(metrics["p_pred"].cpu().numpy(), w - 1)
        v.push_pose(win.R[-1].cpu().numpy(), p_host[-1])
        if self._frame_count % self.viewer_landmark_every == 0:
            pool = self.vio.pool
            v.push_landmark(pool.pos.cpu().numpy(), pool.valid.cpu().numpy())

    def _health_check(self, img_l, img_r) -> bool:
        pending, self._pending_health = self._pending_health, []
        with _host("slam.wait"):
            flags = torch.stack([
                torch.stack([n.to(torch.int64), r.to(torch.int64), k.to(torch.int64)])
                for n, r, k, _ in pending
            ]).cpu().numpy()
        lost = False
        corrupted = False
        for (n_tracked, need_reinit, is_kf), (_, _, _, snap) in zip(flags, pending):
            if n_tracked < self.min_tracked:
                self._low_track_streak += 1
            else:
                self._low_track_streak = 0
            lost = lost or self._low_track_streak >= self.lost_after
            corrupted = corrupted or bool(need_reinit)
            if is_kf and self.gravity_refine_window:
                self._kf_hist.append(snap)
                self._kfs_since_refine += 1
            self._last_was_kf = bool(is_kf)
        if len(self._kf_hist) > self.gravity_refine_window:
            del self._kf_hist[: -self.gravity_refine_window]
        if self.gravity_refine_window and self._kf_hist and self.refresh_kf_hist:
            self._refresh_kf_hist()
        if lost:
            if self.verbose:
                print("[slam] tracking lost -> re-bootstrapping")
            self._relocalize(img_l)
            return True
        # immediate recovery on a corrupted check (the JAX package measured
        # a patience streak and a soft-first policy as worse)
        self._corrupt_streak = self._corrupt_streak + 1 if corrupted else 0
        if not corrupted:
            self._warm_streak = 0
        if self.reinit_on_bias_corruption and self._corrupt_streak >= self.reinit_patience:
            self._corrupt_streak = 0
            if self.warm_recovery and len(self._kf_hist) < self.gravity_refine_min:
                # init transient: defer until the keyframe chain can carry
                # the continuity-preserving warm solve
                if self.verbose:
                    print("[slam] bias corrupted (init transient; recovery deferred)")
            elif self.warm_recovery:
                if self._warm_streak >= self.warm_recovery_max:
                    if self.verbose:
                        print("[slam] bias corrupted -> reinitializing")
                    self._warm_streak = 0
                    self._reinitialize()
                    return True
                if self._warm_recover():
                    self._warm_streak += 1
                elif self.verbose:
                    print("[slam] warm recovery deferred")
            else:
                if self.verbose:
                    print("[slam] bias corrupted -> reinitializing")
                self._reinitialize()
                return True
        if (self.gravity_refine_window
                and len(self._kf_hist) >= self.gravity_refine_min
                and self._kfs_since_refine >= self.gravity_refine_every):
            self._refine_gravity()
        return True

    # ---- bootstrap

    def _push_sfm(self, r: np.ndarray, p: np.ndarray):
        """`Map::pushSfm` on the host-side SfM chain:
        T_WB2 = T_WB1 * T_BC * T_C1C2 * T_CB."""
        if not self._sfm_R:
            self._sfm_R.append(np.eye(3))
            self._sfm_p.append(np.zeros(3))
        t_c1c2_R = lie.so3_exp(torch.as_tensor(r, dtype=torch.float64)).numpy()
        with _host("slam.wait"):
            r_bc = self.consts.r_bc.double().cpu().numpy()
            p_bc = self.consts.p_bc.double().cpu().numpy()
        r_cb, p_cb = r_bc.T, -r_bc.T @ p_bc
        R1w, p1w = self._sfm_R[-1], self._sfm_p[-1]
        Ra = R1w @ r_bc
        pa = R1w @ p_bc + p1w
        Rb = Ra @ t_c1c2_R
        pb = Ra @ p + pa
        self._sfm_R.append(Rb @ r_cb)
        self._sfm_p.append(Rb @ p_cb + pb)
        # a copy: the constraint shares tensors with the running
        # preintegration, which the next chunk overwrites in the graphs'
        # buffers, and the next replay of `finalize` its outputs
        imu = self.consts.imu
        with _host("slam.replay"):
            self._sfm_ics.append(graphs.snapshot(self._solve(
                "finalize", lambda p, bg, ba: pre.finalize(p, bg, ba, imu),
                self.vio.preint, self.vio.bg, self.vio.ba)))

    def _initialize(self, img_l, img_r, img_ts):
        """The 4-stage initializer, its plausibility gates, the window
        re-seed from the last two SfM frames and the bootstrap frame."""
        dev = self.device

        def t(a):
            return torch.as_tensor(np.stack(a), dtype=torch.float32, device=dev)

        unit_g, axes, gravity = self._unit_g, self._axes, self._gravity
        # every output is used (copied by reseed_window, read by the gates)
        # before the next replay of `full_init`
        with _host("slam.replay"):
            R, v, p, dbg, dba, g_est, ics = self._solve(
                "full_init", lambda *a: init_solvers.full_init(*a, unit_g, axes, gravity),
                t(self._sfm_R), t(self._sfm_p), _stack_ics(self._sfm_ics))
        new_bg = self.vio.bg + dbg
        new_ba = self.vio.ba + dba
        with _host("slam.wait"):
            g_norm, v_max = torch.stack([
                torch.linalg.norm(g_est), torch.max(torch.linalg.norm(v, dim=-1))]).tolist()
        gm = self.cfg.gravity_magnitude
        if not (0.5 * gm < g_norm < 2.0 * gm and v_max < self.max_init_velocity
                and np.isfinite(g_norm)):
            if self.verbose:
                print(f"[slam] init rejected (|g|={g_norm:.2f}, vmax={v_max:.2f}); "
                      "retrying SFM")
            self._relocalize(img_l)
            return
        if self.verbose:
            print(f"[slam] init: bg={new_bg.cpu().numpy()} ba={new_ba.cpu().numpy()}")
            print(f"[slam] init: gravity(initial frame)={g_est.cpu().numpy()}")

        self.vio = self.vio._replace(win=reseed_window(self.vio.win, R, v, p, ics),
                                     preint=pre.init_state(dev), bg=new_bg, ba=new_ba)
        c, s = self.consts, self.static
        u = vio_mod.draw_ransac_uniforms(self._gen, dev)
        # the state stays in the graph's outputs until the next OK frame
        # copies it into the frame graphs' buffers
        with _host("slam.replay"):
            self.vio, n_stereo = self._solve(
                "bootstrap_frame",
                lambda st, il, ir, *u: vio_mod.bootstrap_frame(st, il, ir, u, c, s),
                self.vio, img_l, img_r, *u)
        self._record(img_ts)
        self.state = State.OK
        if self.verbose:
            print(f"[slam] initialized; {int(n_stereo)} stereo features; OK")

    def _relocalize(self, img_l):
        """Restart the visual bootstrap (SFM -> INITIALIZING) from the current
        frame, keeping the estimated biases; the world frame re-anchors."""
        self.state = State.SFM
        self._sfm_count = 0
        self._sfm_R = []
        self._sfm_p = []
        self._sfm_ics = []
        self._low_track_streak = 0
        self._pending_health = []
        self._corrupt_streak = 0
        self._kf_hist = []
        self._kfs_since_refine = 0
        self._ref_feats = self._seed_ref(img_l)
        keep_bg, keep_ba = self.vio.bg, self.vio.ba
        self.vio = vio_mod.init_vio_state(self.static, self.device)._replace(
            bg=keep_bg, ba=keep_ba)

    # ---- gravity refinement and recovery

    def _history_chain(self):
        """(R [K, 3, 3], p [K, 3], ics [K-1]) of the newest keyframe chain,
        the constraints repropagated to the current bias estimate. K is the
        full window once it exists, else the minimum chain."""
        n_hist = (self.gravity_refine_window
                  if len(self._kf_hist) >= self.gravity_refine_window
                  else self.gravity_refine_min)
        hist = self._kf_hist[-n_hist:]
        win = self.vio.win
        ics = _stack_ics([h[3] for h in hist[1:]])
        bg_now = win.ics.bg_i[-1] + win.dbg[-1]
        ba_now = win.ics.ba_i[-1] + win.dba[-1]
        ics = pre.repropagate(ics, bg_now[None] - ics.bg_i, ba_now[None] - ics.ba_i)
        return (torch.stack([h[0] for h in hist]), torch.stack([h[1] for h in hist]), ics,
                ba_now)

    def _refresh_kf_hist(self):
        """Re-snapshot the keyframe-history entries still inside the
        sliding window from the current window states (commit-time
        snapshots go stale while motion BA refines the frames that stay in
        the window). The constraints are measurements and stay as stored.
        Reads the window's active count on the host."""
        win = self.vio.win
        length = win.R.shape[0]
        # the newest entry sits at slot -1 until the next frame shifts the
        # window (then -2)
        off = 1 if self._last_was_kf else 2
        with _host("slam.wait"):
            n_act = int(win.n_act)
        for m in range(1, len(self._kf_hist) + 1):
            slot = length - off - (m - 1)
            if slot < max(length - 1 - n_act, 0):
                break   # left the active window: the entry is final
            ic = self._kf_hist[-m][3]
            self._kf_hist[-m] = (*graphs.snapshot((win.R[slot], win.p[slot], win.v[slot])),
                                 ic)

    def _refine_gravity(self):
        """Routine refinement: re-solve gravity tilt and acc bias over the
        keyframe chain and apply small, physically plausible corrections to
        all live state."""
        R, p, ics, ba_now = self._history_chain()
        unit_g, axes, gravity = self._unit_g, self._axes, self._gravity
        sigma_tilt, sigma_dba = self.refine_sigmas
        # the outputs are read by the gates and _apply_alignment before the
        # next replay
        with _host("slam.replay"):
            g_est, delta_r, dba = self._solve(
                "refine", lambda *a: init_solvers.refine_gravity(
                    *a, unit_g, axes, gravity, sigma_tilt=sigma_tilt, sigma_dba=sigma_dba),
                R, p, ics)
        with _host("slam.wait"):
            g_norm, angle, dba_n, ba_after = torch.stack([
                torch.linalg.norm(g_est), torch.linalg.norm(delta_r), torch.linalg.norm(dba),
                torch.linalg.norm(ba_now + dba)]).tolist()
        self._kfs_since_refine = 0
        gm = self.cfg.gravity_magnitude
        ok = (np.isfinite(g_norm) and np.isfinite(angle) and np.isfinite(dba_n)
              and 0.8 * gm < g_norm < 1.2 * gm
              and angle < self.max_refine_angle and dba_n < self.max_refine_dba
              and ba_after < self.cfg.max_acc_bias)
        if not ok:
            if self.verbose:
                print(f"[slam] gravity refine rejected (|g|={g_norm:.2f}, "
                      f"angle={angle:.3f}, |dba|={dba_n:.3f})")
            return
        if self.verbose:
            print(f"[slam] gravity refine: angle={angle * 57.3:.2f} deg, "
                  f"dba={dba.cpu().numpy()}")
        self._apply_alignment(lie.so3_exp(delta_r), dba)

    def _apply_alignment(self, d_rm, dba):
        """Rotate the world by d_rm and add dba to the acc bias of all live
        state: window, landmark pool, marginalization prior (its dv blocks
        are world vectors; the linearization states rotate, lin_ba absorbs
        dba) and keyframe history."""
        win, pool = self.vio.win, self.vio.pool
        wsize = win.R.shape[0] - 1
        t = torch.eye(15 * wsize, dtype=d_rm.dtype, device=d_rm.device)
        for k in range(wsize):
            o = 6 * wsize + 9 * k
            t[o:o + 3, o:o + 3] = d_rm
        self.vio = self.vio._replace(
            win=win._replace(
                R=d_rm[None] @ win.R, v=win.v @ d_rm.T, p=win.p @ d_rm.T,
                dba=win.dba + dba[None], prior_h=t @ win.prior_h @ t.T,
                lin_R=d_rm[None] @ win.lin_R, lin_p=win.lin_p @ d_rm.T,
                lin_v=win.lin_v @ d_rm.T, lin_ba=win.lin_ba + dba[None],
            ),
            pool=pool._replace(pos=pool.pos @ d_rm.T),
        )
        self._kf_hist = [(d_rm @ h[0], d_rm @ h[1], d_rm @ h[2], h[3]) for h in self._kf_hist]

    def _warm_recover(self) -> bool:
        """Warm bias-corruption recovery: the refinement solve with its
        regularizers opened up (sigmas 5, 3 rounds), applied like a routine
        refinement when plausible and when it shrinks |ba|. Returns False
        when the chain is too short or the solve is rejected."""
        if len(self._kf_hist) < self.gravity_refine_min:
            return False
        R, p, ics, ba_now = self._history_chain()
        unit_g, axes, gravity = self._unit_g, self._axes, self._gravity
        with _host("slam.replay"):
            g_est, delta_r, dba = self._solve(
                "recover", lambda *a: init_solvers.refine_gravity(
                    *a, unit_g, axes, gravity, sigma_tilt=5.0, sigma_dba=5.0, rounds=3),
                R, p, ics)
        with _host("slam.wait"):
            g_norm, angle, dba_n, ba_new, ba_old = torch.stack([
                torch.linalg.norm(g_est), torch.linalg.norm(delta_r), torch.linalg.norm(dba),
                torch.linalg.norm(ba_now + dba), torch.linalg.norm(ba_now)]).tolist()
        gm = self.cfg.gravity_magnitude
        ok = (np.isfinite(g_norm) and np.isfinite(angle) and np.isfinite(dba_n)
              and 0.7 * gm < g_norm < 1.4 * gm
              and angle < self.max_recover_angle and dba_n < self.max_recover_dba
              and ba_new < ba_old)
        if not ok:
            if self.verbose:
                print(f"[slam] warm recovery rejected (|g|={g_norm:.2f}, "
                      f"angle={angle:.3f}, |dba|={dba_n:.3f})")
            return False
        if self.verbose:
            print(f"[slam] warm recovery: angle={angle * 57.3:.2f} deg, "
                  f"dba={dba.cpu().numpy()}")
        self._apply_alignment(lie.so3_exp(delta_r), dba)
        self._kfs_since_refine = 0
        return True

    def _reinitialize(self):
        """Cold bias-corruption recovery: rerun the init solvers on the
        current window."""
        w = self.cfg.window_size
        win = self.vio.win
        with _host("slam.wait"):
            self._sfm_R = list(win.R[1:w + 1].cpu().numpy())
            self._sfm_p = list(win.p[1:w + 1].cpu().numpy())
        self._sfm_ics = [ImuConstraint(*(a[i] for a in graphs.snapshot(win.ics)))
                         for i in range(1, w)]
        zero3 = torch.zeros(3, device=self.device)
        self.vio = self.vio._replace(bg=zero3, ba=zero3.clone(),
                                     preint=pre.init_state(self.device))
        self._kf_hist = []
        self._kfs_since_refine = 0
        self.state = State.INITIALIZING

    # ---- checkpoints

    def save_checkpoint(self, path: str):
        """Write the device state and the host state a resumed run needs:
        the state machine's position, the frame count, the queued IMU
        samples, the health and recovery counters, the keyframe history,
        the pending health snapshots and the random generator's state."""
        def ser(tree):
            return [leaf.tolist() for leaf in tree_leaves(tree)]

        ckpt.save_checkpoint(path, self.vio, meta={
            "state": self.state.name,
            "frame_count": self._frame_count,
            "generator": self._gen.get_state().tolist(),
            "imu_ts": list(self._imu_ts),
            "imu_data": [list(map(float, row)) for row in self._imu_data],
            "low_track_streak": self._low_track_streak,
            "corrupt_streak": self._corrupt_streak,
            "warm_streak": self._warm_streak,
            "kfs_since_refine": self._kfs_since_refine,
            "last_was_kf": self._last_was_kf,
            "kf_hist": [ser(h) for h in self._kf_hist],
            "pending_health": [[int(n), bool(r), bool(k), ser(snap)]
                               for n, r, k, snap in self._pending_health],
        })

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint written by save_checkpoint, onto this
        object's device."""
        dev = self.device
        self.vio, meta = ckpt.load_checkpoint(path, self.static, dev)
        self.state = State[meta.get("state", "OK")]
        self._frame_count = int(meta.get("frame_count", 0))
        if "generator" in meta:
            self._gen.set_state(torch.tensor(meta["generator"], dtype=torch.uint8))
        self._imu_ts = [int(t) for t in meta.get("imu_ts", [])]
        self._imu_data = [np.asarray(r, np.float64) for r in meta.get("imu_data", [])]
        self._low_track_streak = int(meta.get("low_track_streak", 0))
        self._corrupt_streak = int(meta.get("corrupt_streak", 0))
        self._warm_streak = int(meta.get("warm_streak", 0))
        self._kfs_since_refine = int(meta.get("kfs_since_refine", 0))
        self._last_was_kf = bool(meta.get("last_was_kf", False))

        win = self.vio.win
        template = (win.R[-1], win.p[-1], win.v[-1], ImuConstraint(*(a[-1] for a in win.ics)))

        def deser(leaves):
            return tree_unflatten(template, iter(
                torch.tensor(v, dtype=t.dtype, device=dev)
                for v, t in zip(leaves, tree_leaves(template))))

        self._kf_hist = [deser(h) for h in meta.get("kf_hist", [])]
        self._pending_health = [
            (torch.tensor(n, device=dev), torch.tensor(r, device=dev),
             torch.tensor(k, device=dev), deser(snap))
            for n, r, k, snap in meta.get("pending_health", [])]

    # ---- results

    def _record(self, img_ts: int, metrics: dict | None = None):
        """Keep the frame's (quat, p, v, bg, ba) as device tensors, from an
        OK frame's record bundle where given, else copied from the window;
        they are read in save_results / trajectory."""
        if metrics is not None:
            self._records.append((img_ts, metrics["rec_quat"], metrics["rec_p"],
                                  metrics["rec_v"], metrics["rec_bg"], metrics["rec_ba"]))
            return
        win = self.vio.win
        self._records.append((img_ts, *graphs.snapshot((
            lie.mat_to_quat(win.R[-1]), win.p[-1], win.v[-1],
            win.ics.bg_i[-1] + win.dbg[-1], win.ics.ba_i[-1] + win.dba[-1]))))

    def _host_records(self):
        """[(ts, q, p, v, bg, ba)] with numpy leaves, in one transfer."""
        if not self._records:
            return []
        rows = torch.stack([torch.cat(r[1:]) for r in self._records]).cpu().numpy()
        return [(r[0], row[0:4], row[4:7], row[7:10], row[10:13], row[13:16])
                for r, row in zip(self._records, rows)]

    def save_results(self, path: str = "states.csv"):
        """CSV dump in the reference's layout (`visual-inertial-slam.cpp:175-204`)."""
        with open(path, "w") as f:
            f.write("timestamp,qw,qx,qy,qz,px,py,pz,vx,vy,vz,bgx,bgy,bgz,bax,bay,baz\n")
            for ts, q, p, v, bg, ba in self._host_records():
                row = [ts] + list(q) + list(p) + list(v) + list(bg) + list(ba)
                f.write(",".join(str(x) for x in row) + "\n")

    @property
    def trajectory(self) -> np.ndarray:
        """[N, 4] array of (ts, px, py, pz)."""
        recs = self._host_records()
        if not recs:
            return np.zeros((0, 4))
        return np.array([[ts, *p] for ts, q, p, v, bg, ba in recs])
