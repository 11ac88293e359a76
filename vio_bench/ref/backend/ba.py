"""Motion-only bundle adjustment over the sliding window.

Counterpart of the normal-equations path of
`pose_estimation_tpu/backend/ba.py` (`_prep`, `build_normal_problem`,
`motion_only_ba`, `prior_delta`, `marginalize_prior`). Landmarks are fixed;
the pair Jacobian is constant and the reprojection residual is linear in
the pose increments, so the LM loop only re-weights precomputed per-landmark
Gram blocks. Pair k connects window slots k and k+1 and is the anchor prior
when k == W - n_act, an IMU pair when k > W - n_act, inactive otherwise.
Parameter layout: [6W poses | 9W (v, dbg, dba)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.ref.backend import lm as lm_mod
from vio_bench.ref.backend import residuals as res
from vio_bench.ref.models.window import WindowState
from vio_bench.ref.ops import small_linalg
from vio_bench.ref.utils import lie


class Calib(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    r_cb: torch.Tensor    # [3, 3] body -> rectified camera
    p_cb: torch.Tensor    # [3]
    inv_std: torch.Tensor  # [2]


class LandmarkObs(NamedTuple):
    pos: torch.Tensor   # [L, 3]
    px: torch.Tensor    # [L, W, 2]
    mask: torch.Tensor  # [L, W]


def _prep(win: WindowState, obs: LandmarkObs, calib: Calib, gravity,
          prior_factor: float, use_marg_prior: bool = False):
    """Masks, pre-linearized reprojection pieces, the constant pair
    Jacobian [15W, 15W] and the pair-residual closure."""
    wsize = win.R.shape[0] - 1
    dtype, dev = win.R.dtype, win.R.device
    anchor = (wsize - win.n_act).to(torch.int64)
    ks = torch.arange(wsize, device=dev)
    is_prior = ks == anchor
    is_imu = ks > anchor
    col_active = ks >= anchor
    if use_marg_prior:
        is_prior = is_prior & ~win.prior_on

    obs_mask = obs.mask & col_active[None, :]
    lm_valid = torch.sum(obs_mask, dim=1) >= 2
    obs_mask = obs_mask & lm_valid[:, None]

    err, f_blk, _ = res.reprojection_error_and_jacobian(
        win.R[1:][None], win.p[1:][None], obs.pos[:, None, :], obs.px,
        calib.r_cb, calib.p_cb, calib.fx, calib.fy, calib.cx, calib.cy,
        calib.inv_std,
    )                                                 # [L, W, 2], [L, W, 2, 6]
    err = torch.where(obs_mask[..., None], err, 0.0)
    f_blk = torch.where(obs_mask[..., None, None], f_blk, 0.0)

    R_i, R_j = win.R[:-1], win.R[1:]
    p_i, p_j = win.p[:-1], win.p[1:]
    v_i, v_j = win.v[:-1], win.v[1:]
    dbg_i, dbg_j = win.dbg[:-1], win.dbg[1:]
    dba_i, dba_j = win.dba[:-1], win.dba[1:]
    zrow = torch.zeros((1, 3), dtype=dtype, device=dev)
    off_bg = torch.cat([win.ics.bg_i[1:] - win.ics.bg_i[:-1], zrow])
    off_ba = torch.cat([win.ics.ba_i[1:] - win.ics.ba_i[:-1], zrow])

    jpi, jvi, jpj, jvj = res.imu_jacobians(
        R_i, p_i, v_i, dbg_i, dba_i, R_j, p_j, v_j, win.ics, gravity
    )
    jpj_p, jvj_p = res.prior_jacobians(R_i, dbg_i, R_j, win.ics, prior_factor)
    w_imu = is_imu.to(dtype)[:, None, None]
    w_pri = is_prior.to(dtype)[:, None, None]
    blk_pj = w_imu * jpj + w_pri * jpj_p
    blk_vj = w_imu * jvj + w_pri * jvj_p
    blk_pi = w_imu * jpi
    blk_vi = w_imu * jvi

    # pair k's frame-j blocks go to parameter block k, frame-i blocks to k-1
    # (concatenated block rows, no write into a buffer: `torch.func.vmap`
    # maps this over a batch of sequences)
    zp = torch.zeros((15, 6), dtype=dtype, device=dev)
    zv = torch.zeros((15, 9), dtype=dtype, device=dev)

    def pair_row(k):
        pose = [blk_pj[k] if c == k else blk_pi[k] if c == k - 1 else zp
                for c in range(wsize)]
        vb = [blk_vj[k] if c == k else blk_vi[k] if c == k - 1 else zv
              for c in range(wsize)]
        return torch.cat(pose + vb, dim=1)

    jac_pairs = torch.cat([pair_row(k) for k in range(wsize)], dim=0)

    lts_imu = res.whitener(win.ics.inv_cov)
    lts_pri = res.whitener(win.ics.inv_cov * prior_factor)
    active = is_imu | is_prior
    lts = torch.where(is_prior[:, None, None], lts_pri, lts_imu)
    i_live = (~is_prior).to(dtype)[:, None]
    off_bg_m = off_bg * i_live
    off_ba_m = off_ba * i_live

    def pairs_residual(x):
        dpose = x[:6 * wsize].reshape(wsize, 6)
        dvdbga = x[6 * wsize:].reshape(wsize, 9)
        dpose_i = torch.cat([torch.zeros_like(dpose[:1]), dpose[:-1]]) * i_live
        dvdbga_i = torch.cat([torch.zeros_like(dvdbga[:1]), dvdbga[:-1]]) * i_live
        r = res.imu_residual(
            dpose_i[:, 0:3], dpose_i[:, 3:6],
            dvdbga_i[:, 0:3], dvdbga_i[:, 3:6], dvdbga_i[:, 6:9],
            dpose[:, 0:3], dpose[:, 3:6],
            dvdbga[:, 0:3], dvdbga[:, 3:6], dvdbga[:, 6:9],
            R_i, p_i, v_i, dbg_i, dba_i, R_j, p_j, v_j, dbg_j, dba_j,
            win.ics, gravity, lts, off_bg_m, off_ba_m,
        )
        return torch.where(active[:, None], r, 0.0)

    return dict(
        wsize=wsize, lm_valid=lm_valid, obs_mask=obs_mask, err=err, f_blk=f_blk,
        jac_pairs=jac_pairs, pairs_residual=pairs_residual, is_imu=is_imu,
        is_prior=is_prior, lts_imu=lts_imu, lts_pri=lts_pri,
        num_landmarks=torch.sum(lm_valid), num_observations=torch.sum(obs_mask),
    )


def prior_delta(win: WindowState) -> torch.Tensor:
    """Box-minus of frames 1..W against the marginalization prior's
    linearization states, in the solver layout [15W]; zero while the prior
    is off."""
    wsize = win.R.shape[0] - 1
    dr = lie.so3_log(win.lin_R.transpose(-1, -2) @ win.R[1:])
    dp = lie.mv(win.lin_R.transpose(-1, -2), win.p[1:] - win.lin_p)
    dv = win.v[1:] - win.lin_v
    dbg = (win.ics.bg_i + win.dbg[1:]) - win.lin_bg
    dba = (win.ics.ba_i + win.dba[1:]) - win.lin_ba
    d0 = torch.cat([torch.cat([dr, dp], 1).reshape(6 * wsize),
                    torch.cat([dv, dbg, dba], 1).reshape(9 * wsize)])
    return torch.where(win.prior_on, d0, 0.0)


def _marg_indices(wsize: int, device):
    """(dropped dims, kept dims) for marginalizing parameter block 0, made
    on the device (no host-to-device copy, which a CUDA graph cannot
    capture)."""
    def r(a, b):
        return torch.arange(a, b, device=device)

    n = 15 * wsize
    return (torch.cat([r(0, 6), r(6 * wsize, 6 * wsize + 9)]),
            torch.cat([r(6, 6 * wsize), r(6 * wsize + 9, n)]))


def marg_schur(h_final, wsize: int, forget: float = 1.0) -> torch.Tensor:
    """The Schur complement [15(W-1), 15(W-1)] that marginalizes the
    outgoing frame (parameter block 0) out of the solved information."""
    dtype, dev = h_final.dtype, h_final.device
    idx_m, idx_r = _marg_indices(wsize, dev)
    h = 0.5 * (h_final + h_final.T)
    h_mm = h[idx_m][:, idx_m] + 1e-8 * torch.eye(len(idx_m), dtype=dtype, device=dev)
    h_rm = h[idx_r][:, idx_m]
    h_rr = h[idx_r][:, idx_r]
    schur = h_rr - h_rm @ torch.linalg.solve_ex(h_mm, h_rm.T)[0]
    return 0.5 * (schur + schur.T) * forget


def psd_clip(schur: torch.Tensor) -> torch.Tensor:
    """The Schur complement [..., n, n] with its negative eigenvalues set
    to zero.

    A Schur complement of an information matrix is positive semidefinite,
    but not in float32 when h_mm is near singular (frames the data does
    not constrain): the solve multiplies rounding errors of h_rm by up to
    1e8, and eigenvalues of -4e3 against +5e2 were seen on a seeded
    window. An indefinite prior makes the BA cost unbounded below and LM
    runs away along it. The clip runs in float64, so that it adds no
    rounding itself (a deviation from the JAX package, which keeps them).
    The eigendecomposition is K6 (`ops/small_linalg.py`), which reads
    nothing on the host, so the frame's CUDA graph holds the clip."""
    dtype = schur.dtype
    evals, evecs = small_linalg.eigh(schur.double())
    out = ((evecs * torch.clamp(evals, min=0.0)[..., None, :])
           @ evecs.transpose(-1, -2)).to(dtype)
    return 0.5 * (out + out.transpose(-1, -2))


def marg_apply(win: WindowState, schur) -> WindowState:
    """The clipped Schur complement as the window's new prior, re-indexed
    into the post-roll layout, with the linearization states rolled."""
    wsize = win.R.shape[0] - 1
    n = 15 * wsize
    dtype, dev = win.R.dtype, win.R.device
    # the kept blocks at their post-roll places: the pose part at [0, P),
    # the (v, dbg, dba) part at [6W, 6W + V), zero rows and columns between
    pd = 6 * (wsize - 1)

    def spread(rows):
        return torch.cat([rows[:, :pd], torch.zeros((rows.shape[0], 6), dtype=dtype, device=dev),
                          rows[:, pd:], torch.zeros((rows.shape[0], 9), dtype=dtype, device=dev)],
                         dim=1)

    prior_h = torch.cat([spread(schur[:pd]), torch.zeros((6, n), dtype=dtype, device=dev),
                         spread(schur[pd:]), torch.zeros((9, n), dtype=dtype, device=dev)], dim=0)

    def roll_slot(a):
        return torch.cat([a[2:], a[-1:]])

    def roll_blk(a):
        return torch.cat([a[1:], a[-1:]])

    return win._replace(
        prior_h=prior_h,
        lin_R=roll_slot(win.R), lin_p=roll_slot(win.p), lin_v=roll_slot(win.v),
        lin_bg=roll_blk(win.ics.bg_i + win.dbg[1:]),
        lin_ba=roll_blk(win.ics.ba_i + win.dba[1:]),
        prior_on=torch.ones_like(win.prior_on),
    )


def marginalize_prior(win: WindowState, h_final, forget: float = 1.0) -> WindowState:
    """Schur-marginalize the outgoing frame from the solved information,
    clip the result to positive semidefinite, and re-index the rest into
    the post-roll layout: `marg_schur`, `psd_clip`, `marg_apply`."""
    wsize = win.R.shape[0] - 1
    return marg_apply(win, psd_clip(marg_schur(h_final, wsize, forget)))


def build_normal_problem(win: WindowState, obs: LandmarkObs, calib: Calib, gravity,
                         prior_factor: float, use_marg_prior: bool = False,
                         ba_prior_sigma: float = 0.0):
    """(normal_fn, x0, aux): normal_fn(x) -> (H, g, cost) with the true
    Huber-robustified cost. With use_marg_prior, aux["marg_h_fn"](x) is the
    once-counted information for marginalizing the outgoing frame."""
    pr = _prep(win, obs, calib, gravity, prior_factor, use_marg_prior)
    wsize = pr["wsize"]
    err, f_blk, lm_valid = pr["err"], pr["f_blk"], pr["lm_valid"]
    jac_pairs = pr["jac_pairs"]
    pairs_residual = pr["pairs_residual"]
    n = 15 * wsize
    dtype, dev = win.R.dtype, win.R.device

    h_pairs = jac_pairs.T @ jac_pairs
    gram = torch.einsum("lwai,lwaj->lwij", f_blk, f_blk)     # [L, W, 6, 6]
    bvec = torch.einsum("lwai,lwa->lwi", f_blk, err)         # [L, W, 6]
    e2 = torch.sum(err * err, dim=-1)                        # [L, W]
    aux = {"num_landmarks": pr["num_landmarks"],
           "num_observations": pr["num_observations"]}

    def block_costs(dpose):
        s_lw = (e2 + 2.0 * torch.einsum("lwi,wi->lw", bvec, dpose)
                + torch.einsum("wi,lwij,wj->lw", dpose, gram, dpose))
        s_l = torch.sum(s_lw, dim=1)
        w_l = torch.where(s_l <= 1.0, 1.0, 1.0 / torch.sqrt(torch.clamp(s_l, min=1e-32)))
        return s_l, torch.where(lm_valid, w_l, 0.0)

    if use_marg_prior:
        ph = torch.where(win.prior_on, win.prior_h, 0.0)
        d0 = prior_delta(win)
        h_pairs = h_pairs + ph
        g_pr0 = ph @ d0
        rows1 = jac_pairs[15:30]

        def marg_h_fn(x):
            _, w_l = block_costs(x[:6 * wsize].reshape(wsize, 6))
            top = torch.einsum("l,lij->ij", w_l, gram[:, 0])
            return ph + rows1.T @ rows1 + torch.nn.functional.pad(top, (0, n - 6, 0, n - 6))

        aux["marg_h_fn"] = marg_h_fn

    if ba_prior_sigma > 0:
        inv_s2 = 1.0 / float(ba_prior_sigma) ** 2
        act_blk = (torch.arange(wsize, device=dev) >= (wsize - win.n_act)).to(dtype)
        ba_tot = win.ics.ba_i + win.dba[1:]

        def on_ba_dims(v):
            """[W, 3] values of the acc-bias dims -> the [15W] layout."""
            return torch.cat([torch.zeros(6 * wsize, dtype=dtype, device=dev),
                              torch.nn.functional.pad(v, (6, 0)).reshape(9 * wsize)])

        h_pairs = h_pairs + torch.diag(on_ba_dims(inv_s2 * act_blk[:, None].expand(wsize, 3)))

    def normal_fn(x):
        dpose = x[:6 * wsize].reshape(wsize, 6)
        pairs = pairs_residual(x)
        s_l, w_l = block_costs(dpose)
        hw = torch.einsum("l,lwij->wij", w_l, gram)
        gw = torch.einsum("l,lwi->wi", w_l, bvec) + lie.mv(hw, dpose)
        eye_w = torch.eye(wsize, dtype=dtype, device=dev)
        hw_diag = torch.einsum("kl,kij->kilj", eye_w, hw).reshape(6 * wsize, 6 * wsize)
        h = h_pairs + torch.nn.functional.pad(hw_diag, (0, 9 * wsize, 0, 9 * wsize))
        g = jac_pairs.T @ pairs.reshape(-1)
        g = torch.cat([g[:6 * wsize] + gw.reshape(-1), g[6 * wsize:]])
        rho_l = torch.where(s_l <= 1.0, s_l,
                            2.0 * torch.sqrt(torch.clamp(s_l, min=1e-32)) - 1.0)
        rho_l = torch.where(lm_valid, rho_l, 0.0)
        cost = 0.5 * (torch.sum(pairs * pairs) + torch.sum(rho_l))
        if use_marg_prior:
            rp = d0 + x
            g = g + g_pr0 + ph @ x
            cost = cost + 0.5 * rp @ (ph @ rp)
        if ba_prior_sigma > 0:
            r_ba = (ba_tot + x[6 * wsize:].reshape(wsize, 9)[:, 6:9]) * act_blk[:, None]
            g = g + on_ba_dims(inv_s2 * r_ba)
            cost = cost + 0.5 * inv_s2 * torch.sum(r_ba * r_ba)
        return h, g, cost

    return normal_fn, torch.zeros(n, dtype=dtype, device=dev), aux


def motion_only_ba(win: WindowState, obs: LandmarkObs, calib: Calib, gravity,
                   prior_factor: float, max_iterations: int = 20,
                   use_marg_prior: bool = False, ba_prior_sigma: float = 0.0):
    """Returns (delta_pose [W, 6], delta_vdbga [W, 9], info); info["h_final"]
    (and info["marg_h"] with the marginalization prior) feed
    `marginalize_prior`."""
    wsize = win.R.shape[0] - 1
    normal_fn, x0, aux = build_normal_problem(
        win, obs, calib, gravity, prior_factor, use_marg_prior, ba_prior_sigma
    )
    x, info = lm_mod.lm_solve_normal(
        normal_fn, x0, lm_mod.LMOptions(max_iterations=max_iterations), name="ba"
    )
    info["num_landmarks"] = aux["num_landmarks"]
    info["num_observations"] = aux["num_observations"]
    if use_marg_prior:
        info["marg_h"] = aux["marg_h_fn"](x)
    return x[:6 * wsize].reshape(wsize, 6), x[6 * wsize:].reshape(wsize, 9), info

