"""The steady-state VIO frame step: preintegration -> ORB -> stereo and
temporal matching -> motion-only BA -> keyframe decision -> pool update;
and the bootstrap steps before it (SfM frame, first OK frame).

Counterpart of `pose_estimation_tpu/models/vio.py` (`build_constants`,
`init_vio_state`, `extract_rectified`, `front_end`, `_run_backend`,
`pool_update`, `ok_step`, `sfm_step`, `bootstrap_frame`). The JAX
`lax.cond` branches that are cheap run both sides and select on the
device; the three heavy ones (BA, the marginalization, the pool update)
are Python branches, each costing one host sync per frame. The front end
follows the JAX package's kernel path unless the configuration asks for the
map path (`sample_backend="xla"`) or the plain detection
(`fast_backend="xla"`); on a CUDA device it launches the CUDA kernels, on a
CPU device their torch twins.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch.backend import ba as ba_mod
from pose_estimation_tpu_torch.backend.ba import Calib, LandmarkObs
from pose_estimation_tpu_torch.frontend import tracker
from pose_estimation_tpu_torch.imu import preintegration as pre
from pose_estimation_tpu_torch.models import pool as pool_mod
from pose_estimation_tpu_torch.models import window as win_mod
from pose_estimation_tpu_torch.ops import matching, orb, pnp, ransac, remap, triangulate
from pose_estimation_tpu_torch.utils import lie
from pose_estimation_tpu_torch.utils.precision import apply_policy

# Named spans of the frame's stages (imu, extract, match, backend, pool):
# `torch.profiler` attributes host and device time to them
# (tools/profile_torch_step.py); outside a profiler they record nothing.
_span = torch.profiler.record_function


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
    # 0 -> "dlt", 1/3/4 -> "epnp", 2/5 -> "p3p" (not ported; ops.pnp raises)
    pnp_solver: str = "dlt"
    # "sparse": ORB on the raw frames, then analytic rectification of the
    # keypoints; "dense": the frames are remapped first
    rectify_mode: str = "sparse"
    marg_prior: bool = True
    marg_forget: float = 1.0
    ba_prior_sigma: float = 0.0


def build_constants(cfg, cm, device) -> tuple[VIOConstants, VIOStatic]:
    """(VIOConstants, VIOStatic) from a config and camera model, on `device`.

    Applies the float32 precision policy (TF32 off). A CUDA device makes
    the front end launch the CUDA kernels, a CPU device their twins: the
    kernel wrappers decide by the device of the tensors they are given.
    `fast_backend` and `sample_backend` "auto" mean the kernel path on
    either device. The map path's `moments_backend` is no configuration
    field: set it on the returned static,
    `dataclasses.replace(static, orb=static.orb._replace(...))`. Keyframe
    full BA and the bfloat16 selection are not ported."""
    if cfg.full_ba_keyframes:
        raise NotImplementedError("keyframe full BA is not ported")
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
    apply_policy()
    device = torch.device(device)

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


def extract_rectified(img_l, img_r, consts: VIOConstants, static: VIOStatic):
    """ORB features of a stereo pair with rectified keypoint coordinates.
    Sparse mode: ORB on the raw pair, then analytic rectification of the
    keypoints. Dense mode: the pair is remapped through the rectification
    maps first. Images of any dtype are cast to float32."""
    img_l, img_r = img_l.to(torch.float32), img_r.to(torch.float32)
    if static.rectify_mode == "dense":
        rect = remap.remap_bilinear(torch.stack([img_l, img_r]),
                                    torch.stack([consts.map_l, consts.map_r]))
        return orb.extract_pair(rect[0], rect[1], static.orb, consts.orb)
    feats_l, feats_r = orb.extract_pair(img_l, img_r, static.orb, consts.orb)
    feats_l = feats_l._replace(xy=remap.rectify_points(
        feats_l.xy, consts.k_raw_l, consts.dist_l, consts.r1, consts.p1))
    feats_r = feats_r._replace(xy=remap.rectify_points(
        feats_r.xy, consts.k_raw_r, consts.dist_r, consts.r2, consts.p2))
    return feats_l, feats_r


def front_end(img_l, img_r, pool, ransac_u, consts: VIOConstants, static: VIOStatic):
    """rectify -> ORB -> stereo match -> temporal track. `ransac_u` is the
    pair of [64, 8] RANSAC uniforms (stereo, temporal)."""
    with _span("ok_step.extract"):
        feats_l, feats_r = extract_rectified(img_l, img_r, consts, static)
    with _span("ok_step.match"):
        cur = tracker.internal_match(
            feats_l, feats_r, ransac_u[0], static.cur_capacity,
            static.match_ratio, static.min_match_dist, static.max_vertical_dist,
        )
        tr = tracker.external_track(
            cur, pool, ransac_u[1], static.match_ratio, static.min_match_dist
        )
    return cur, tr


def _run_backend(state: VIOState, tr_n_matches, consts: VIOConstants,
                 static: VIOStatic):
    """Motion-only BA (skipped without circular matches), keyframe
    decision, marginalization and bias bookkeeping. Returns (state,
    ba_cost, ba_iters)."""
    win = state.win
    dev = win.R.device
    wsize = win.R.shape[0] - 1
    has_matches = tr_n_matches > 0
    if bool(has_matches):
        obs = LandmarkObs(state.pool.pos, state.pool.obs_px, state.pool.obs_mask)
        dpose, dvdbga, info = ba_mod.motion_only_ba(
            win, obs, consts.calib, consts.gravity, static.prior_factor,
            static.max_iterations, use_marg_prior=static.marg_prior,
            ba_prior_sigma=static.ba_prior_sigma,
        )
        win = win_mod.apply_deltas(win, dpose, dvdbga, static.max_gyr_bias,
                                   static.max_acc_bias)
        win = win_mod.check_keyframe(win, static.keyframe_rotation,
                                     static.keyframe_translation, static.max_imu_time)
        ba_cost, ba_iters = info["final_cost"], info["iterations"]
        ba_h = info["marg_h"] if static.marg_prior else info["h_final"]
    else:
        ba_cost = torch.zeros((), device=dev)
        ba_iters = torch.zeros((), dtype=torch.int32, device=dev)
        ba_h = None
    kf = win.is_keyframe & has_matches
    if static.marg_prior and ba_h is not None and bool(kf & (win.n_act >= wsize)):
        win = ba_mod.marginalize_prior(win, ba_h, static.marg_forget)

    new_bg = torch.where(kf, win.ics.bg_i[-1] + win.dbg[-1], state.bg)
    new_ba = torch.where(kf, win.ics.ba_i[-1] + win.dba[-1], state.ba)
    fresh = pre.init_state(dev)
    preint = pre.PreintState(*(
        torch.where(kf, a, b) for a, b in zip(fresh, state.preint)
    ))
    return (state._replace(win=win, preint=preint, bg=new_bg, ba=new_ba),
            ba_cost, ba_iters)


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


def ok_step(state: VIOState, img_l, img_r, gyr, acc, imu_mask,
            generator: torch.Generator, consts: VIOConstants, static: VIOStatic,
            ransac_u=None):
    """One steady-state frame. Returns (new_state, metrics), metrics as
    device tensors. `ransac_u` overrides the RANSAC uniforms drawn from
    `generator` (the parity tests pass JAX's)."""
    dev = state.win.R.device
    win, pool = state.win, state.pool
    with _span("ok_step.imu"):
        pool = pool_mod.shift_window(pool, win.is_keyframe)
        preint = pre.integrate_chunk(state.preint, gyr, acc, imu_mask, state.bg,
                                     state.ba, consts.imu)
        ic = pre.finalize(preint, state.bg, state.ba, consts.imu)
        win = win_mod.push_constraint(win, ic, consts.gravity)
        p_pred = win.p[-1]

    if ransac_u is None:
        ransac_u = draw_ransac_uniforms(generator, dev)
    cur, tr = front_end(img_l, img_r, pool, ransac_u, consts, static)
    pool = pool_mod.record_observations(pool, tr.slot, tr.matched, cur.px_l)

    state = state._replace(win=win, pool=pool, preint=preint)
    with _span("ok_step.backend"):
        state, ba_cost, ba_iters = _run_backend(state, tr.n_matches, consts, static)
    win = state.win
    kf = win.is_keyframe & (tr.n_matches > 0)
    with _span("ok_step.pool"):
        if bool(kf | ~torch.any(state.pool.valid)):
            state = pool_update(state, cur, tr, consts, static)

    metrics = {
        "n_stereo": torch.sum(cur.valid),
        "n_tracked": tr.n_matches,
        "is_keyframe": win.is_keyframe,
        "ba_cost": ba_cost,
        "ba_iters": ba_iters,
        "need_reinit": win.need_reinit,
        "pool_size": torch.sum(state.pool.valid),
        "imu_dt": ic.dt,
        "p_pred": p_pred,
        "rec_quat": lie.mat_to_quat(win.R[-1]),
        "rec_p": win.p[-1],
        "rec_v": win.v[-1],
        "rec_bg": win.ics.bg_i[-1] + win.dbg[-1],
        "rec_ba": win.ics.ba_i[-1] + win.dba[-1],
        "rec_R": win.R[-1],
        "rec_ic": pre.ImuConstraint(*(a[-1] for a in win.ics)),
    }
    return state, metrics


def draw_sfm_uniforms(generator: torch.Generator, device):
    """The (stereo RANSAC [64, 8], PnP RANSAC [512, 6]) uniforms of one SfM
    frame."""
    return (torch.rand((ransac.N_HYPOTHESES, 8), generator=generator, device=device),
            torch.rand((pnp.N_HYPOTHESES, 6), generator=generator, device=device))


def sfm_step(img_l, img_r, ref_desc, ref_xy, ref_valid, sfm_u,
             consts: VIOConstants, static: VIOStatic, pnp_idx=None):
    """Structure-from-motion bootstrap against the reference keyframe
    (`FeatureTracker::structFromMotion`): stereo match -> RANSAC ->
    triangulate -> match to the reference keyframe -> PnP RANSAC. `sfm_u`
    is `draw_sfm_uniforms`' pair; `pnp_idx` [512, 6] replaces the PnP draw.
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
