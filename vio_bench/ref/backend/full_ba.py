"""Full bundle adjustment: the W window poses and the L landmark positions
refined jointly, the landmark blocks eliminated by the Schur complement.

Frozen from `pose_estimation_tpu_torch/backend/full_ba.py`, the keyframe
full BA of a configuration with `full_ba_keyframes`; there the counterpart
of `pose_estimation_tpu/backend/full_ba.py`:

    H = [ Hpp  Hpl ]   ->  (Hpp - Hpl Hll^-1 Hpl^T) dx_p = -(gp - Hpl Hll^-1 gl)
        [ Hpl^T Hll ]       dx_l = -Hll^-1 (gl + Hpl^T dx_p)

Hll is block-diagonal (3x3 a landmark), so its inverse is a batched 3x3
inverse; Hpl is [L, W, 6, 3]. The Jacobians are frozen at the current
state (chord iteration, as in the motion-only BA), pose increments apply
right-multiplicatively and landmark increments are world deltas. The IMU
and prior pair terms and their Jacobians are the motion-only problem's
(`ba._prep`).

As in `lm.py`, the JAX `lax.while_loop` becomes `max_iterations`
iterations that freeze once done (the same iterate and iteration count;
`graphs.iterate`: in a captured graph one conditional WHILE node that
stops at convergence), with no host read: the batched inverse is
`inv_ex`, the Cholesky solve `cholesky_ex` whose failure zeroes the step
(which is then rejected), and every buffer is built by concatenation, so
the solve maps over sequences with `torch.func.vmap`.
"""

from __future__ import annotations

import torch

from vio_bench.ref.backend import ba as ba_mod
from vio_bench.ref.backend import lm as lm_mod
from vio_bench.ref.backend import residuals as res
from vio_bench.ref.backend.ba import Calib, LandmarkObs
from vio_bench.ref.models.window import WindowState
from vio_bench.ref.utils import lie
from vio_bench.ref.utils.linalg import cho_solve


def _reproj_residual(win: WindowState, obs: LandmarkObs, obs_mask, calib: Calib,
                     dpose, dlm):
    """Whitened reprojection residuals [L, W, 2] at the increments."""
    R_act, p_act = win.R[1:], win.p[1:]
    R_new = R_act @ lie.so3_exp(dpose[:, 0:3])
    p_new = p_act + lie.mv(R_act, dpose[:, 3:6])
    err, _, _ = res.reprojection_error_and_jacobian(
        R_new[None], p_new[None], (obs.pos + dlm)[:, None, :], obs.px,
        calib.r_cb, calib.p_cb, calib.fx, calib.fy, calib.cx, calib.cy,
        calib.inv_std,
    )
    return torch.where(obs_mask[..., None], err, 0.0)


def full_ba(win: WindowState, obs: LandmarkObs, calib: Calib, gravity,
            prior_factor: float, max_iterations: int = 10,
            use_marg_prior: bool = False):
    """Joint pose + landmark refinement. Returns (delta_pose [W, 6],
    delta_vdbga [W, 9], delta_landmarks [L, 3], info). Landmarks observed
    fewer than 2 times stay (delta 0). With use_marg_prior the window's
    marginalization prior joins the pose block as in the motion-only
    problem (and the anchor prior is off while it is live)."""
    pr = ba_mod._prep(win, obs, calib, gravity, prior_factor, use_marg_prior)
    wsize = pr["wsize"]
    obs_mask, lm_valid = pr["obs_mask"], pr["lm_valid"]
    f_pose, jac_pairs = pr["f_blk"], pr["jac_pairs"]           # [L, W, 2, 6]
    is_imu, is_prior = pr["is_imu"], pr["is_prior"]
    L = obs.pos.shape[0]
    dtype, dev = win.R.dtype, win.R.device
    n_pose = 15 * wsize
    np6 = 6 * wsize

    # landmark Jacobian: d err / d X_w = -F_dp R_wb^T
    f_lm = -torch.einsum("lwab,wcb->lwac", f_pose[..., 3:6], win.R[1:])   # [L, W, 2, 3]

    R_i, R_j = win.R[:-1], win.R[1:]
    p_i, p_j = win.p[:-1], win.p[1:]
    v_i, v_j = win.v[:-1], win.v[1:]
    dbg_i, dbg_j = win.dbg[:-1], win.dbg[1:]
    dba_i, dba_j = win.dba[:-1], win.dba[1:]
    zrow = torch.zeros((1, 3), dtype=dtype, device=dev)
    off_bg = torch.cat([win.ics.bg_i[1:] - win.ics.bg_i[:-1], zrow])
    off_ba = torch.cat([win.ics.ba_i[1:] - win.ics.ba_i[:-1], zrow])

    if use_marg_prior:
        ph = torch.where(win.prior_on, win.prior_h, 0.0)           # [n_pose, n_pose]
        d0 = ba_mod.prior_delta(win)                               # [n_pose]

    def pair_residuals(x_pose):
        """[W, 15]: pair k is an IMU pair, the anchor prior or nothing."""
        dpose = x_pose[:np6].reshape(wsize, 6)
        dvb = x_pose[np6:].reshape(wsize, 9)
        dpose_i = torch.cat([torch.zeros_like(dpose[:1]), dpose[:-1]])
        dvb_i = torch.cat([torch.zeros_like(dvb[:1]), dvb[:-1]])
        r_imu = res.imu_residual(
            dpose_i[:, 0:3], dpose_i[:, 3:6], dvb_i[:, 0:3], dvb_i[:, 3:6], dvb_i[:, 6:9],
            dpose[:, 0:3], dpose[:, 3:6], dvb[:, 0:3], dvb[:, 3:6], dvb[:, 6:9],
            R_i, p_i, v_i, dbg_i, dba_i, R_j, p_j, v_j, dbg_j, dba_j,
            win.ics, gravity, pr["lts_imu"], off_bg, off_ba,
        )
        r_pri = res.prior_residual(
            dpose[:, 0:3], dpose[:, 3:6], dvb[:, 0:3], dvb[:, 3:6], dvb[:, 6:9],
            R_i, p_i, v_i, dbg_i, dba_i, R_j, p_j, v_j, dbg_j, dba_j,
            win.ics, gravity, prior_factor, lt=pr["lts_pri"],
        )
        return torch.where(is_imu[:, None], r_imu,
                           torch.where(is_prior[:, None], r_pri, 0.0))

    def cost_of(x_pose, x_lm):
        """(cost, pair residuals, reprojection residuals, landmark weights)."""
        r_pairs = pair_residuals(x_pose)
        err = _reproj_residual(win, obs, obs_mask, calib,
                               x_pose[:np6].reshape(wsize, 6), x_lm)
        w_lm = lm_mod.huber_block_weights(err.reshape(L, -1), lm_valid)
        c = 0.5 * torch.sum(r_pairs * r_pairs) + 0.5 * torch.sum(
            w_lm[:, None, None] * err * err)
        if use_marg_prior:
            rp = d0 + x_pose
            c = c + 0.5 * rp @ (ph @ rp)
        return c, r_pairs, err, w_lm

    h_pairs = jac_pairs.T @ jac_pairs
    if use_marg_prior:
        h_pairs = h_pairs + ph
    eye_w = torch.eye(wsize, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye_n = torch.eye(n_pose, dtype=dtype, device=dev)
    zeros_vb = torch.zeros(9 * wsize, dtype=dtype, device=dev)

    def pose_pad(m):
        """A [6W, 6W] pose block in the top-left of an [n_pose, n_pose] matrix."""
        return torch.nn.functional.pad(m, (0, 9 * wsize, 0, 9 * wsize))

    def solve(x_pose, r_pairs, err, w_lm, lam):
        """The damped Schur step (step_pose, step_lm, reduced gradient,
        damped pose block, bad) at the current iterate."""
        wgt = w_lm[:, None] * obs_mask.to(dtype)                      # [L, W]
        h_pp_rep = torch.einsum("lwai,lwaj,lw->wij", f_pose, f_pose, wgt)
        g_p_rep = torch.einsum("lwai,lwa,lw->wi", f_pose, err, wgt)
        h_ll = torch.einsum("lwai,lwaj,lw->lij", f_lm, f_lm, wgt)
        g_l = torch.einsum("lwai,lwa,lw->li", f_lm, err, wgt)
        h_pl = torch.einsum("lwai,lwaj,lw->lwij", f_pose, f_lm, wgt)

        g_pairs = jac_pairs.T @ r_pairs.reshape(-1)
        if use_marg_prior:
            g_pairs = g_pairs + ph @ (d0 + x_pose)
        h_pp = h_pairs + pose_pad(
            torch.einsum("kl,kij->kilj", eye_w, h_pp_rep).reshape(np6, np6))
        g_p = g_pairs + torch.cat([g_p_rep.reshape(-1), zeros_vb])

        d_pp = torch.diagonal(h_pp)
        d_pp = torch.where(d_pp > 0, d_pp, 1.0)
        h_pp_d = h_pp + lam * torch.diag(d_pp)
        d_ll = torch.diagonal(h_ll, dim1=-2, dim2=-1)
        d_ll = torch.where(d_ll > 0, d_ll, 1.0)
        h_ll_d = h_ll + lam * d_ll[..., None] * eye3
        # unobserved landmarks get the identity, so the inverse stays finite
        h_ll_d = torch.where(lm_valid[:, None, None], h_ll_d, eye3)

        h_ll_inv = torch.linalg.inv_ex(h_ll_d)[0]                    # [L, 3, 3]
        hpl_hllinv = torch.einsum("lwij,ljk->lwik", h_pl, h_ll_inv)
        s_red = torch.einsum("lwik,lvjk->wivj", hpl_hllinv, h_pl).reshape(np6, np6)
        s_mat = h_pp_d - pose_pad(s_red)
        g_red = torch.einsum("lwik,lk->wi", hpl_hllinv, g_l).reshape(-1)
        g_s = g_p - torch.cat([g_red, zeros_vb])

        chol, info = torch.linalg.cholesky_ex(s_mat + 1e-30 * eye_n)
        step_p = -cho_solve(chol, g_s[:, None])[:, 0]
        bad = (info != 0) | ~torch.all(torch.isfinite(step_p))
        step_p = torch.where(bad, 0.0, step_p)

        rhs_l = g_l + torch.einsum("lwij,wi->lj", h_pl, step_p[:np6].reshape(wsize, 6))
        step_l = -torch.einsum("lij,lj->li", h_ll_inv, rhs_l)
        step_l = torch.where(lm_valid[:, None], step_l, 0.0)
        return step_p, step_l, g_s, h_pp_d, bad

    x_pose = torch.zeros(n_pose, dtype=dtype, device=dev)
    x_lm = torch.zeros((L, 3), dtype=dtype, device=dev)
    cost0, r_pairs, err, w_lm = cost_of(x_pose, x_lm)

    def body(s):
        x_pose, x_lm, r_pairs, err, w_lm, cost, lam, nu, it, done = s
        live = ~done
        step_p, step_l, g_s, h_pp_d, bad = solve(x_pose, r_pairs, err, w_lm, lam)
        x_pose_new = x_pose + step_p
        x_lm_new = x_lm + step_l
        new_cost, r_new, err_new, w_new = cost_of(x_pose_new, x_lm_new)
        model_dec = -(g_s @ step_p) - 0.5 * step_p @ (h_pp_d @ step_p)
        model_dec = torch.clamp(model_dec, min=1e-32)
        rho = (cost - new_cost) / model_dec
        accept = (rho > 1e-3) & torch.isfinite(new_cost) & ~bad

        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_new = torch.clamp(torch.where(accept, lam * shrink, lam * nu), 1e-12, 1e32)
        nu_new = torch.where(accept, 2.0, nu * 2.0)
        done_new = accept & ((cost - new_cost).abs() <= 1e-6 * (cost + 1e-32))

        take = live & accept
        return (torch.where(take, x_pose_new, x_pose), torch.where(take, x_lm_new, x_lm),
                torch.where(take, r_new, r_pairs), torch.where(take, err_new, err),
                torch.where(take, w_new, w_lm), torch.where(take, new_cost, cost),
                torch.where(live, lam_new, lam), torch.where(live, nu_new, nu),
                it + live.to(torch.int32), done | (live & done_new))

    start = (x_pose, x_lm, r_pairs, err, w_lm, cost0,
             torch.full((), 1e-4, dtype=dtype, device=dev),
             torch.full((), 2.0, dtype=dtype, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    # imported here: graphs imports the models, which import this module
    from vio_bench.ref import graphs

    x_pose, x_lm, _, _, _, cost, _, _, it, _ = graphs.iterate(body, start, max_iterations,
                                                              lambda s: ~s[-1])
    graphs.log_iterations("full_ba", it, max_iterations)
    info = {"initial_cost": cost0, "final_cost": cost, "iterations": it}
    return (x_pose[:np6].reshape(wsize, 6), x_pose[np6:].reshape(wsize, 9), x_lm, info)
