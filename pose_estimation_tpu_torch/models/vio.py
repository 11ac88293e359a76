"""The steady-state VIO frame step: preintegration -> ORB -> stereo and
temporal matching -> motion-only BA -> keyframe decision -> pool update;
and the bootstrap steps before it (SfM frame, first OK frame).

Counterpart of `pose_estimation_tpu/models/vio.py` (`build_constants`,
`init_vio_state`, `extract_rectified`, `front_end`, `_run_backend` (here `stage_ba`),
`pool_update`, `ok_step`, `ok_scan`, the stages `stage_imu`,
`stage_frontend`, `stage_ba` and `stage_pool`, `sfm_step`,
`bootstrap_frame`). The frame step is the composition of the stages, so
the fused step and the staged OK path of `slam.py` run one body of code.
The JAX `lax.cond` branches are `graphs.cond`: BA is skipped without
circular matches, keyframe full BA (where configured), the
marginalization and the pool update run on keyframes only, the window's
re-predict off them. In a captured graph each is a conditional IF node
that skips the branch not taken; eagerly and under `vmap` both sides run
and `torch.where` selects per sequence, as `lax.cond` does under `vmap`.
The stages are the device spans `ok_step.imu`, `.extract`, `.match`,
`.backend` and `.pool` (`profiling.span`). No host read is inside the step.
So the step after ORB extraction (`track_step`) maps over a batch of
sequences with `torch.func.vmap` (`parallel/batched.py`), while ORB runs
once for the whole batch (`extract_rectified_batch`). The front end follows the JAX package's
kernel path unless the configuration asks for the map path
(`sample_backend="xla"`) or the plain detection (`fast_backend="xla"`); on
a CUDA device it launches the CUDA kernels, on a CPU device their torch
twins.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch import profiling
from pose_estimation_tpu_torch.backend import ba as ba_mod
from pose_estimation_tpu_torch.backend import full_ba as full_ba_mod
from pose_estimation_tpu_torch.backend.ba import Calib, LandmarkObs
from pose_estimation_tpu_torch.frontend import tracker
from pose_estimation_tpu_torch.imu import preintegration as pre
from pose_estimation_tpu_torch.models import pool as pool_mod
from pose_estimation_tpu_torch.models import window as win_mod
from pose_estimation_tpu_torch.ops import matching, orb, pnp, ransac, remap, triangulate
from pose_estimation_tpu_torch.utils import lie
from pose_estimation_tpu_torch.utils.precision import apply_policy

class VIOConstants(NamedTuple):
    """Device-resident constants of the pipeline."""

    map_l: torch.Tensor     # [H, W, 2] dense rectification sampling maps
    map_r: torch.Tensor
    k_raw_l: torch.Tensor   # [4] (fx, fy, cx, cy) of the raw camera
    k_raw_r: torch.Tensor
    dist_l: torch.Tensor    # [5]
    dist_r: torch.Tensor
    r1: torch.Tensor        # [3, 3] rectifying rotations
    r2: torch.Tensor
    p1: torch.Tensor        # [3, 4] rectified projections
    p2: torch.Tensor
    k_rect: torch.Tensor    # [3, 3] rectified camera matrix (for PnP)
    calib: Calib
    r_bc: torch.Tensor      # rectified camera -> body
    p_bc: torch.Tensor
    gravity: torch.Tensor   # [3]
    imu: pre.ImuParams
    orb: orb.OrbConstants


@dataclasses.dataclass(frozen=True)
class VIOStatic:
    """Shape- and branch-determining configuration."""

    orb: orb.OrbConfig
    match_ratio: float
    min_match_dist: float
    max_vertical_dist: float
    max_feature_age: int
    max_depth: float
    keyframe_rotation: float
    keyframe_translation: float
    max_imu_time: float
    max_gyr_bias: float
    max_acc_bias: float
    prior_factor: float
    max_iterations: int
    cur_capacity: int
    pool_capacity: int
    window: int
    # SfM bootstrap's PnP solver, from the reference's `solvePnP` switch:
    # 0 -> "dlt", 1/3/4 -> "epnp", 2/5 -> "p3p"
    pnp_solver: str = "dlt"
    # "sparse": ORB on the raw frames, then analytic rectification of the
    # keypoints; "dense": the frames are remapped first
    rectify_mode: str = "sparse"
    marg_prior: bool = True
    marg_forget: float = 1.0
    ba_prior_sigma: float = 0.0
    full_ba_keyframes: bool = False
    full_ba_iterations: int = 8


def build_constants(cfg, cm, device) -> tuple[VIOConstants, VIOStatic]:
    """(VIOConstants, VIOStatic) from a config and camera model, on `device`.

    Applies the float32 precision policy (TF32 off). A CUDA device makes
    the front end launch the CUDA kernels, a CPU device their twins: the
    kernel wrappers decide by the device of the tensors they are given.
    `fast_backend` and `sample_backend` "auto" mean the kernel path on
    either device. The map path's `moments_backend` is no configuration
    field: set it on the returned static,
    `dataclasses.replace(static, orb=static.orb._replace(...))`. The
    bfloat16 selection is not ported."""
    if cfg.select_dtype != "f32":
        raise NotImplementedError("the port selects keypoints in float32 only")
    if cfg.rectify_mode not in ("sparse", "dense"):
        raise ValueError(f"rectify_mode {cfg.rectify_mode!r}")
    backends = {}
    for name in ("fast_backend", "sample_backend"):
        value = getattr(cfg, name)
        if value not in ("auto", "pallas", "xla"):
            raise ValueError(f"{name} {value!r}")
        backends[name] = "pallas" if value == "auto" else value
    device = torch.device(device)
    apply_policy(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                               device=device)

    r_cb_rect = cm.R1 @ cm.R_cb
    p_cb_rect = cm.R1 @ cm.p_cb
    r_bc_rect = r_cb_rect.T
    p_bc_rect = -r_bc_rect @ p_cb_rect

    def k4(k):
        k = np.asarray(k)
        return t([k[0, 0], k[1, 1], k[0, 2], k[1, 2]])

    def d5(d):
        return t((list(np.ravel(d)) + [0.0] * 5)[:5])

    ocfg = orb.OrbConfig(
        n_features=cfg.num_features, n_levels=cfg.level_pyramid,
        scale=cfg.scale_factor, th_hi=float(cfg.ini_th_fast),
        th_lo=float(cfg.min_th_fast), **backends,
    )
    consts = VIOConstants(
        map_l=torch.as_tensor(cm.map_left, device=device),
        map_r=torch.as_tensor(cm.map_right, device=device),
        k_raw_l=k4(cfg.k_left), k_raw_r=k4(cfg.k_right),
        dist_l=d5(cfg.dist_left), dist_r=d5(cfg.dist_right),
        r1=t(cm.R1), r2=t(cm.R2), p1=t(cm.P1), p2=t(cm.P2),
        k_rect=t(np.asarray(cm.P1)[:, :3]),
        calib=Calib(
            fx=t(cm.fx), fy=t(cm.fy), cx=t(cm.cx), cy=t(cm.cy),
            r_cb=t(r_cb_rect), p_cb=t(p_cb_rect),
            inv_std=t([1.0 / cm.std_x, 1.0 / cm.std_y]),
        ),
        r_bc=t(r_bc_rect), p_bc=t(p_bc_rect), gravity=t(cfg.gravity),
        imu=pre.ImuParams.from_config(cfg, device),
        orb=orb.build_orb_constants(cfg.image_height, cfg.image_width, ocfg, device),
    )
    static = VIOStatic(
        orb=ocfg,
        match_ratio=cfg.match_ratio, min_match_dist=cfg.min_match_dist,
        max_vertical_dist=cfg.max_vertical_pixel_dist,
        max_feature_age=cfg.max_feature_age, max_depth=cfg.max_depth,
        keyframe_rotation=cfg.keyframe_rotation,
        keyframe_translation=cfg.keyframe_translation,
        max_imu_time=cfg.max_imu_time, max_gyr_bias=cfg.max_gyr_bias,
        max_acc_bias=cfg.max_acc_bias, prior_factor=cfg.prior_factor,
        max_iterations=cfg.max_num_iterations, cur_capacity=cfg.max_matches,
        pool_capacity=cfg.pool_capacity, window=cfg.window_size,
        pnp_solver={0: "dlt", 1: "epnp", 2: "p3p", 3: "epnp", 4: "epnp",
                    5: "p3p"}[cfg.solve_pnp],
        rectify_mode=cfg.rectify_mode, marg_prior=cfg.marg_prior, marg_forget=cfg.marg_forget,
        ba_prior_sigma=cfg.ba_prior_sigma,
        full_ba_keyframes=cfg.full_ba_keyframes,
        full_ba_iterations=cfg.full_ba_iterations,
    )
    return consts, static


class VIOState(NamedTuple):
    """Everything that persists across frames."""

    win: win_mod.WindowState
    pool: pool_mod.FeaturePool
    preint: pre.PreintState
    bg: torch.Tensor   # preintegrator bias
    ba: torch.Tensor


def init_vio_state(static: VIOStatic, device) -> VIOState:
    return VIOState(
        win=win_mod.init_window(static.window, device),
        pool=pool_mod.init_pool(static.pool_capacity, static.window, device),
        preint=pre.init_state(device),
        bg=torch.zeros(3, device=device),
        ba=torch.zeros(3, device=device),
    )


def extract_rectified_batch(imgs_l, imgs_r, consts: VIOConstants, static: VIOStatic):
    """ORB features of B stereo pairs [B, H, W] with rectified keypoint
    coordinates, all 2B images in one extraction (one plane stack, so one
    launch of each kernel): (left, right) features, fields [B, K, ...].
    Sparse mode: ORB on the raw pairs, then analytic rectification of the
    keypoints. Dense mode: the pairs are remapped through the
    rectification maps first. Images of any dtype are cast to float32."""
    b = imgs_l.shape[0]
    imgs = torch.cat([imgs_l, imgs_r]).to(torch.float32)
    if static.rectify_mode == "dense":
        maps = torch.stack([consts.map_l, consts.map_r]).repeat_interleave(b, dim=0)
        feats = orb.extract_batch(remap.remap_bilinear(imgs, maps), static.orb, consts.orb)
        return (orb.OrbFeatures(*(f[:b] for f in feats)),
                orb.OrbFeatures(*(f[b:] for f in feats)))
    feats = orb.extract_batch(imgs, static.orb, consts.orb)
    feats_l = orb.OrbFeatures(*(f[:b] for f in feats))
    feats_r = orb.OrbFeatures(*(f[b:] for f in feats))
    feats_l = feats_l._replace(xy=remap.rectify_points(
        feats_l.xy, consts.k_raw_l, consts.dist_l, consts.r1, consts.p1))
    feats_r = feats_r._replace(xy=remap.rectify_points(
        feats_r.xy, consts.k_raw_r, consts.dist_r, consts.r2, consts.p2))
    return feats_l, feats_r


def extract_rectified(img_l, img_r, consts: VIOConstants, static: VIOStatic):
    """ORB features of one stereo pair with rectified keypoint coordinates
    (`extract_rectified_batch` at B = 1)."""
    feats_l, feats_r = extract_rectified_batch(img_l[None], img_r[None], consts, static)
    return (orb.OrbFeatures(*(f[0] for f in feats_l)),
            orb.OrbFeatures(*(f[0] for f in feats_r)))


def match_features(feats_l, feats_r, pool, ransac_u, static: VIOStatic, shard=None):
    """Stereo match -> temporal track of one sequence's extracted features.
    `ransac_u` is the pair of [64, 8] RANSAC uniforms (stereo, temporal);
    `shard` splits the pool's Hamming tables over a model group."""
    with profiling.span("ok_step.match"):
        cur = tracker.internal_match(
            feats_l, feats_r, ransac_u[0], static.cur_capacity,
            static.match_ratio, static.min_match_dist, static.max_vertical_dist,
        )
        tr = tracker.external_track(
            cur, pool, ransac_u[1], static.match_ratio, static.min_match_dist, shard
        )
    return cur, tr


def front_end(img_l, img_r, pool, ransac_u, consts: VIOConstants, static: VIOStatic):
    """rectify -> ORB -> stereo match -> temporal track."""
    with profiling.span("ok_step.extract"):
        feats_l, feats_r = extract_rectified(img_l, img_r, consts, static)
    return match_features(feats_l, feats_r, pool, ransac_u, static)


def select(cond, a, b):
    """`a` where the bool scalar tensor `cond` holds, else `b`, leaf by leaf
    over equal (nested) tuples of tensors: `lax.cond` with both sides
    computed, per sequence under `vmap`. A leaf that both sides share (the
    same tensor object: a field the branch left alone) is kept as it is,
    with no launch."""
    if a is b:
        return a
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    parts = [select(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*parts) if hasattr(a, "_fields") else type(a)(parts)


def keyframe_full_ba(win, pool, consts: VIOConstants, static: VIOStatic):
    """Joint pose + landmark refinement of the window and the pool's
    landmarks: (window, pool) with the deltas applied. It runs without the
    marginalization prior: with the landmarks free, the tension between
    prior and vision resolves by dragging the poses back towards the
    prior's linearization while the landmarks absorb the residual (the JAX
    package measured ATE 3 % -> 17 % of path with it)."""
    obs = LandmarkObs(pool.pos, pool.obs_px, pool.obs_mask)
    dpose, dvdbga, dlm, _ = full_ba_mod.full_ba(
        win, obs, consts.calib, consts.gravity, static.prior_factor,
        static.full_ba_iterations,
    )
    win = win_mod.apply_deltas(win, dpose, dvdbga, static.max_gyr_bias,
                               static.max_acc_bias)
    return win, pool._replace(pos=pool.pos + dlm)


class BackendCarry(NamedTuple):
    """The backend between its solve and the end of the marginalization:
    the state after the motion-only BA, the keyframe decision and keyframe
    full BA; the frame's BA cost and iterations; the keyframe flag, the
    marginalization flag and the raw Schur complement (False and [0, 0]
    without the marginalization prior). `ba_mod.psd_clip` of `schur` is a
    launch of kernel K6, which cannot run under `torch.func.vmap`: the
    batched step (`parallel/batched.py`) clips between its two vmapped
    parts."""

    state: VIOState
    ba_cost: torch.Tensor
    ba_iters: torch.Tensor
    kf: torch.Tensor
    do_marg: torch.Tensor
    schur: torch.Tensor


def psd_clip(schur):
    """`ba_mod.psd_clip` of a `BackendCarry.schur` (an empty one passes),
    inside the backend's span."""
    if schur.numel() == 0:
        return schur
    with profiling.span("ok_step.backend"):
        return ba_mod.psd_clip(schur)


def pool_update(state: VIOState, cur, tr, consts: VIOConstants,
                static: VIOStatic) -> VIOState:
    """Age, evict, triangulate and insert (`featurePoolUpdate`)."""
    win = state.win
    pool = pool_mod.age_and_evict(state.pool, tr.slot, tr.matched, static.max_feature_age)
    pts_w, depth_ok = tracker.triangulate_current(
        cur, consts.p1, consts.p2, win.R[-1], win.p[-1], consts.r_bc,
        consts.p_bc, static.max_depth,
    )
    want = cur.valid & ~tr.matched & depth_ok
    pool = pool_mod.insert_features(pool, cur.px_l, cur.desc_l, cur.desc_r, pts_w, want)
    return state._replace(pool=pool)


def draw_ransac_uniforms(generator: torch.Generator, device):
    """The (stereo, temporal) RANSAC uniforms of one frame."""
    shape = (ransac.N_HYPOTHESES, 8)
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def stage_imu(state: VIOState, gyr, acc, imu_mask, consts: VIOConstants,
              static: VIOStatic):
    """The frame's first stage: the pool's observation window shifts (when
    the last frame was a keyframe), the IMU chunk is integrated and
    finalized, and its constraint pushed onto the window with the predicted
    newest state. Returns (state, the constraint's dt)."""
    win, pool = state.win, state.pool
    with profiling.span("ok_step.imu"):
        pool = pool_mod.shift_window(pool, win.is_keyframe)
        preint = pre.integrate_chunk(state.preint, gyr, acc, imu_mask, state.bg,
                                     state.ba, consts.imu)
        ic = pre.finalize(preint, state.bg, state.ba, consts.imu)
        win = win_mod.push_constraint(win, ic, consts.gravity)
    return state._replace(win=win, pool=pool, preint=preint), ic.dt


def stage_match(state: VIOState, feats_l, feats_r, ransac_u, static: VIOStatic,
                shard=None):
    """The front end after extraction: stereo match, temporal track against
    the pool (its Hamming tables split over `shard`'s model group where
    given, `ops/matching.py`), and the matches recorded as the newest
    frame's observations. Returns (state, current features, track)."""
    cur, tr = match_features(feats_l, feats_r, state.pool, ransac_u, static, shard)
    pool = pool_mod.record_observations(state.pool, tr.slot, tr.matched, cur.px_l)
    return state._replace(pool=pool), cur, tr


def stage_frontend(state: VIOState, img_l, img_r, ransac_u, consts: VIOConstants,
                   static: VIOStatic):
    """ORB extraction of the stereo pair (K1 or K3, then K2 on the kernel
    path), then `stage_match`. Returns (state, current features, track)."""
    with profiling.span("ok_step.extract"):
        feats_l, feats_r = extract_rectified(img_l, img_r, consts, static)
    return stage_match(state, feats_l, feats_r, ransac_u, static)


def _cond(name, pred, branch, otherwise, solves=()):
    """`graphs.cond` at the site `name`: an IF node in a captured graph, else
    the select."""
    # imported here: graphs imports this module
    from pose_estimation_tpu_torch import graphs

    return graphs.cond(pred, branch, otherwise, solves, name=name)


def stage_ba_solve(state: VIOState, tr_n_matches, consts: VIOConstants,
                   static: VIOStatic) -> BackendCarry:
    """`stage_ba` up to the PSD clip: motion-only BA (with circular matches
    only), keyframe decision, keyframe full BA (on a keyframe, where
    configured) and the Schur complement of the marginalization (on a
    keyframe of a full window), each a `graphs.cond` on its predicate (JAX
    `lax.cond`; on a frame that marginalizes nothing the Schur complement
    is the identity, which the clip passes with no round). The keyframe
    decision stays the motion-only solve's; the marginalization takes the
    motion-only information at the state after full BA."""
    with profiling.span("ok_step.backend"):
        win = state.win
        wsize = win.R.shape[0] - 1
        dtype, dev = win.R.dtype, win.R.device
        has_matches = tr_n_matches > 0
        obs = LandmarkObs(state.pool.pos, state.pool.obs_px, state.pool.obs_mask)
        # the information that the marginalization takes (JAX's `skip_ba`
        # gives zeros); none without the marginalization prior
        n_h = 15 * wsize if static.marg_prior else 0
        no_h = torch.zeros((n_h, n_h), dtype=dtype, device=dev)

        def do_ba(win=win):
            dpose, dvdbga, info = ba_mod.motion_only_ba(
                win, obs, consts.calib, consts.gravity, static.prior_factor,
                static.max_iterations, use_marg_prior=static.marg_prior,
                ba_prior_sigma=static.ba_prior_sigma,
            )
            solved = win_mod.apply_deltas(win, dpose, dvdbga, static.max_gyr_bias,
                                          static.max_acc_bias)
            solved = win_mod.check_keyframe(solved, static.keyframe_rotation,
                                            static.keyframe_translation, static.max_imu_time)
            return (solved, info["final_cost"], info["iterations"],
                    info["marg_h"] if static.marg_prior else no_h)

        win, ba_cost, ba_iters, marg_h = _cond(
            "ba", has_matches, do_ba,
            (win, torch.zeros((), dtype=dtype, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev), no_h),
            solves=(("ba", static.max_iterations),))
        kf = win.is_keyframe & has_matches
        pool = state.pool
        if static.full_ba_keyframes:
            def do_full(win=win, pool=pool):
                full_win, full_pool = keyframe_full_ba(win, pool, consts, static)
                return full_win, full_pool.pos

            win, pos = _cond("full_ba", kf, do_full, (win, pool.pos),
                             solves=(("full_ba", static.full_ba_iterations),))
            pool = pool._replace(pos=pos)
        do_marg = torch.zeros_like(kf)
        schur = torch.zeros((0, 0), dtype=dtype, device=dev)
        if static.marg_prior:
            do_marg = kf & (win.n_act >= wsize)
            schur = _cond("marg_schur", do_marg,
                          lambda: ba_mod.marg_schur(marg_h, wsize, static.marg_forget),
                          torch.eye(15 * (wsize - 1), dtype=dtype, device=dev))
        return BackendCarry(state._replace(win=win, pool=pool), ba_cost, ba_iters, kf,
                            do_marg, schur)


def stage_ba_finish(carry: BackendCarry, schur_psd, static: VIOStatic):
    """`stage_ba` after the PSD clip: the marginalization prior from the
    clipped Schur complement (`psd_clip(carry.schur)`, a `graphs.cond` on
    the marginalization's predicate), then the bias bookkeeping and the
    preintegrator's reset on a keyframe (a select: 21 operations, cheaper
    than an IF node's body on the keyframes that take it). Returns (state,
    ba_cost, ba_iters)."""
    with profiling.span("ok_step.backend"):
        state, kf = carry.state, carry.kf
        win = state.win
        if static.marg_prior:
            win = _cond("marg_apply", carry.do_marg, lambda: ba_mod.marg_apply(win, schur_psd),
                        win)
        new_bg = torch.where(kf, win.ics.bg_i[-1] + win.dbg[-1], state.bg)
        new_ba = torch.where(kf, win.ics.ba_i[-1] + win.dba[-1], state.ba)
        preint = select(kf, pre.init_state(win.R.device), state.preint)
        return (state._replace(win=win, preint=preint, bg=new_bg, ba=new_ba),
                carry.ba_cost, carry.ba_iters)


def stage_ba(state: VIOState, tr_n_matches, consts: VIOConstants, static: VIOStatic):
    """The backend (JAX `_run_backend`) as `stage_ba_solve`, `psd_clip`,
    `stage_ba_finish`: returns (state, ba_cost, ba_iters)."""
    carry = stage_ba_solve(state, tr_n_matches, consts, static)
    return stage_ba_finish(carry, psd_clip(carry.schur), static)


def stage_pool(state: VIOState, cur, tr, tr_n_matches, consts: VIOConstants,
               static: VIOStatic) -> VIOState:
    """The pool update (a `graphs.cond`), on a keyframe with matches or
    while the pool is empty."""
    with profiling.span("ok_step.pool"):
        kf = state.win.is_keyframe & (tr_n_matches > 0)
        do_pool = kf | ~torch.any(state.pool.valid)
        pool = _cond("pool", do_pool, lambda: pool_update(state, cur, tr, consts, static).pool,
                     state.pool)
        return state._replace(pool=pool)


def frame_metrics(state: VIOState, cur, tr, ba_cost, ba_iters, imu_dt, p_pred) -> dict:
    """A frame's counts and flags as device tensors: the metrics of the
    staged OK path (JAX `slam.py:380-391`), which `frame_outputs` extends
    with the record and health-check bundle."""
    return {
        "n_stereo": torch.sum(cur.valid),
        "n_tracked": tr.n_matches,
        "is_keyframe": state.win.is_keyframe,
        "ba_cost": ba_cost,
        "ba_iters": ba_iters,
        "need_reinit": state.win.need_reinit,
        "pool_size": torch.sum(state.pool.valid),
        "imu_dt": imu_dt,
        "p_pred": p_pred,
    }


def frame_outputs(state: VIOState, cur, tr, ba_cost, ba_iters, imu_dt, p_pred) -> dict:
    """`frame_metrics` with the record and health-check bundle of the
    newest window frame: the pose as a quaternion, position, velocity,
    biases, rotation and IMU constraint."""
    win = state.win
    metrics = frame_metrics(state, cur, tr, ba_cost, ba_iters, imu_dt, p_pred)
    metrics.update({
        "rec_quat": lie.mat_to_quat(win.R[-1]),
        "rec_p": win.p[-1],
        "rec_v": win.v[-1],
        "rec_bg": win.ics.bg_i[-1] + win.dbg[-1],
        "rec_ba": win.ics.ba_i[-1] + win.dba[-1],
        "rec_R": win.R[-1],
        "rec_ic": pre.ImuConstraint(*(a[-1] for a in win.ics)),
    })
    return metrics


class TrackCarry(NamedTuple):
    """`track_step` up to the PSD clip: the backend's carry, the current
    features, the track, the IMU constraint's dt and the predicted newest
    position."""

    ba: BackendCarry
    cur: tracker.CurrentFeatures
    tr: tracker.TrackResult
    imu_dt: torch.Tensor
    p_pred: torch.Tensor


def track_head(state: VIOState, feats_l, feats_r, gyr, acc, imu_mask, ransac_u,
               consts: VIOConstants, static: VIOStatic, shard=None) -> TrackCarry:
    """`stage_imu`, `stage_match` and `stage_ba_solve` in turn."""
    state, imu_dt = stage_imu(state, gyr, acc, imu_mask, consts, static)
    p_pred = state.win.p[-1]
    state, cur, tr = stage_match(state, feats_l, feats_r, ransac_u, static, shard)
    return TrackCarry(stage_ba_solve(state, tr.n_matches, consts, static), cur, tr,
                      imu_dt, p_pred)


def track_tail(carry: TrackCarry, schur_psd, consts: VIOConstants, static: VIOStatic):
    """`stage_ba_finish` and `stage_pool` after `track_head`, with the
    clipped Schur complement. Returns (new_state, metrics)."""
    state, ba_cost, ba_iters = stage_ba_finish(carry.ba, schur_psd, static)
    state = stage_pool(state, carry.cur, carry.tr, carry.tr.n_matches, consts, static)
    return state, frame_outputs(state, carry.cur, carry.tr, ba_cost, ba_iters,
                                carry.imu_dt, carry.p_pred)


def track_step(state: VIOState, feats_l, feats_r, gyr, acc, imu_mask, ransac_u,
               consts: VIOConstants, static: VIOStatic, shard=None):
    """The frame step after ORB extraction, for one sequence: the stages
    `stage_imu`, `stage_match`, `stage_ba` and `stage_pool` in turn, as
    `track_head`, `psd_clip` and `track_tail`. Nothing in it reads the
    device on the host; the head and tail map over sequences with
    `torch.func.vmap` (`parallel/batched.py`), the clip (a K6 launch)
    between them. `ransac_u` holds the (stereo, temporal) [64,
    8] uniforms; `shard` splits the pool's Hamming tables over a model
    group. Returns (new_state, metrics), metrics as device tensors."""
    head = track_head(state, feats_l, feats_r, gyr, acc, imu_mask, ransac_u, consts,
                      static, shard)
    return track_tail(head, psd_clip(head.ba.schur), consts, static)


def ok_head(state: VIOState, img_l, img_r, gyr, acc, imu_mask, ransac_u,
            consts: VIOConstants, static: VIOStatic) -> TrackCarry:
    """`ok_step` up to the PSD clip: ORB extraction, then `track_head`."""
    with profiling.span("ok_step.extract"):
        feats_l, feats_r = extract_rectified(img_l, img_r, consts, static)
    return track_head(state, feats_l, feats_r, gyr, acc, imu_mask, ransac_u, consts, static)


def ok_step(state: VIOState, img_l, img_r, gyr, acc, imu_mask,
            generator: torch.Generator, consts: VIOConstants, static: VIOStatic,
            ransac_u=None):
    """One steady-state frame: `ok_head` (ORB extraction and `track_head`),
    `psd_clip`, `track_tail`. Returns (new_state, metrics), metrics as
    device tensors. `ransac_u` overrides the RANSAC uniforms drawn from
    `generator` (the parity tests pass JAX's)."""
    if ransac_u is None:
        ransac_u = draw_ransac_uniforms(generator, state.win.R.device)
    head = ok_head(state, img_l, img_r, gyr, acc, imu_mask, ransac_u, consts, static)
    return track_tail(head, psd_clip(head.ba.schur), consts, static)


def ok_scan(state: VIOState, imgs_l, imgs_r, gyrs, accs, imu_masks,
            generator: torch.Generator, consts: VIOConstants, static: VIOStatic,
            ransac_u=None):
    """T steady-state frames of one sequence ([T, ...] inputs), `ok_step`
    after `ok_step`. `ransac_u` [T, 2, 64, 8] overrides the uniforms drawn
    from `generator`. Returns (state, outputs): the newest R, p, v and the
    n_tracked, is_keyframe and need_reinit of each frame, stacked [T, ...]."""
    outs = []
    for t in range(imgs_l.shape[0]):
        state, m = ok_step(state, imgs_l[t], imgs_r[t], gyrs[t], accs[t], imu_masks[t],
                           generator, consts, static,
                           ransac_u=None if ransac_u is None else ransac_u[t])
        outs.append({"R": state.win.R[-1], "p": state.win.p[-1], "v": state.win.v[-1],
                     "n_tracked": m["n_tracked"], "is_keyframe": m["is_keyframe"],
                     "need_reinit": m["need_reinit"]})
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def draw_sfm_uniforms(generator: torch.Generator, device, solver: str = "dlt"):
    """The (stereo RANSAC [64, 8], PnP RANSAC `pnp.uniform_shape(solver)`)
    uniforms of one SfM frame."""
    return (torch.rand((ransac.N_HYPOTHESES, 8), generator=generator, device=device),
            torch.rand(pnp.uniform_shape(solver), generator=generator, device=device))


def sfm_step(img_l, img_r, ref_desc, ref_xy, ref_valid, sfm_u,
             consts: VIOConstants, static: VIOStatic, pnp_idx=None):
    """Structure-from-motion bootstrap against the reference keyframe
    (`FeatureTracker::structFromMotion`): stereo match -> RANSAC ->
    triangulate -> match to the reference keyframe -> PnP RANSAC. `sfm_u`
    is `draw_sfm_uniforms`' pair; `pnp_idx` replaces the PnP draw.
    Returns (rvec, tvec, n_inliers, current left features), (rvec, tvec)
    taking current-camera points into the reference camera frame."""
    feats_l, feats_r = extract_rectified(img_l, img_r, consts, static)
    cur = tracker.internal_match(
        feats_l, feats_r, sfm_u[0], static.cur_capacity,
        static.match_ratio, static.min_match_dist, static.max_vertical_dist,
    )
    pts_cam = triangulate.triangulate(consts.p1, consts.p2, cur.px_l, cur.px_r)
    depth = pts_cam[:, 2]
    depth_ok = cur.valid & (depth > 0.1) & (depth < static.max_depth)
    m = matching.match(cur.desc_l, ref_desc, depth_ok, ref_valid,
                       static.match_ratio, static.min_match_dist)
    res = pnp.pnp_ransac(pts_cam, ref_xy[m.index], m.valid, consts.k_rect, sfm_u[1],
                         solver=static.pnp_solver, idx=pnp_idx)
    return res.rvec, res.tvec, res.n_inliers, feats_l


def bootstrap_frame(state: VIOState, img_l, img_r, ransac_u, consts: VIOConstants,
                    static: VIOStatic):
    """Initial stereo matching and pool seed after the initializer
    (`visual-inertial-slam.cpp:101-107`). Returns (state, n_stereo)."""
    cur, tr = front_end(img_l, img_r, state.pool, ransac_u, consts, static)
    pool = pool_mod.record_observations(state.pool, tr.slot, tr.matched, cur.px_l)
    state = pool_update(state._replace(pool=pool), cur, tr, consts, static)
    return state, torch.sum(cur.valid)
