"""Residuals and analytic Jacobians of the motion-only BA and of the
initializer.

Counterpart of `pose_estimation_tpu/backend/residuals.py`. Every function
broadcasts over a leading pair dimension [W, ...] (the JAX package vmaps,
or loops over pairs, instead). The solver works on increments applied
right-multiplicatively: R <- R exp(dr), p <- p + R dp.
"""

from __future__ import annotations

import torch

from vio_bench.ref.utils import lie
from vio_bench.ref.utils.lie import mv


def whitener(inv_cov: torch.Tensor) -> torch.Tensor:
    """L^T with L L^T = inv_cov. [..., n, n]. A matrix that is not
    positive definite gives NaN, as `jnp.linalg.cholesky` does."""
    chol, info = torch.linalg.cholesky_ex(inv_cov)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol).transpose(-1, -2)


def imu_residual(dr_i, dp_i, dv_i, ddbg_i, ddba_i,
                 dr_j, dp_j, dv_j, ddbg_j, ddba_j,
                 R_i, p_i, v_i, dbg_i, dba_i,
                 R_j, p_j, v_j, dbg_j, dba_j,
                 ic, gravity, lt, off_bg=0.0, off_ba=0.0):
    """Whitened 15-residual [r_R, r_v, r_p, r_bg, r_ba] per pair."""
    up_dbg_i = dbg_i + ddbg_i
    up_dba_i = dba_i + ddba_i
    uR_i = R_i @ lie.so3_exp(dr_i)
    uR_j = R_j @ lie.so3_exp(dr_j)
    corrected_dR = ic.dR @ lie.so3_exp(mv(ic.d_R_bg, up_dbg_i))
    r_R = lie.so3_log(corrected_dR.transpose(-1, -2) @ (uR_i.transpose(-1, -2) @ uR_j))

    dt = ic.dt[..., None]
    dt2 = ic.dt2[..., None]
    uv_i = v_i + dv_i
    uv_j = v_j + dv_j
    uR_iT = uR_i.transpose(-1, -2)
    r_v = mv(uR_iT, uv_j - uv_i - gravity * dt) - (
        ic.dv + mv(ic.d_v_bg, up_dbg_i) + mv(ic.d_v_ba, up_dba_i)
    )
    up_i = p_i + mv(R_i, dp_i)
    up_j = p_j + mv(R_j, dp_j)
    r_p = mv(uR_iT, up_j - up_i - uv_i * dt - gravity * (dt2 / 2)) - (
        ic.dp + mv(ic.d_p_bg, up_dbg_i) + mv(ic.d_p_ba, up_dba_i)
    )
    r_bg = off_bg + dbg_j + ddbg_j - up_dbg_i
    r_ba = off_ba + dba_j + ddba_j - up_dba_i
    res = torch.cat([r_R, r_v, r_p, r_bg, r_ba], dim=-1)
    return mv(lt, res)


def _assemble(rows, lead, dtype, device):
    """A [..., 3R, 3C] matrix from an R x C grid (a list of rows) of
    [..., 3, 3] blocks, None for a zero block. Built by concatenation, with
    no write into a buffer, so it maps over a batch with `torch.func.vmap`."""
    zero = torch.zeros(lead + (3, 3), dtype=dtype, device=device)
    return torch.cat([torch.cat([zero if b is None else b.expand(lead + (3, 3)) for b in row],
                                dim=-1) for row in rows], dim=-2)


def imu_jacobians(R_i, p_i, v_i, dbg_i, dba_i, R_j, p_j, v_j, ic, gravity):
    """Whitened Jacobian blocks at zero increment: (J_pose_i [.., 15, 6],
    J_vb_i [.., 15, 9], J_pose_j [.., 15, 6], J_vb_j [.., 15, 9])."""
    dtype, dev = R_i.dtype, R_i.device
    lead = R_i.shape[:-2]
    eye = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    R_iT = R_i.transpose(-1, -2)
    dt = ic.dt[..., None]
    dt2 = ic.dt2[..., None]
    residual_R = lie.so3_log(
        (ic.dR @ lie.so3_exp(mv(ic.d_R_bg, dbg_i))).transpose(-1, -2) @ (R_iT @ R_j)
    )
    jr_inv = lie.right_jacobian_inverse(residual_R)

    def blocks(rows):
        return _assemble(rows, lead, dtype, dev)

    j_pose_i = blocks([
        [-jr_inv @ R_j.transpose(-1, -2) @ R_i, None],
        [lie.hat(mv(R_iT, v_j - v_i - gravity * dt)), None],
        [lie.hat(mv(R_iT, p_j - p_i - v_i * dt - gravity * (dt2 / 2))), -eye],
        [None, None],
        [None, None],
    ])
    j_vb_i = blocks([
        [None, (-jr_inv @ lie.so3_exp(residual_R).transpose(-1, -2)
                @ lie.right_jacobian(mv(ic.d_R_bg, dbg_i)) @ ic.d_R_bg), None],
        [-R_iT, -ic.d_v_bg, -ic.d_v_ba],
        [-R_iT * ic.dt[..., None, None], -ic.d_p_bg, -ic.d_p_ba],
        [None, -eye, None],
        [None, None, -eye],
    ])
    j_pose_j = blocks([[jr_inv, None], [None, None], [None, R_iT @ R_j],
                       [None, None], [None, None]])
    j_vb_j = blocks([[None, None, None], [R_iT, None, None], [None, None, None],
                     [None, eye, None], [None, None, eye]])
    lt = whitener(ic.inv_cov)
    return lt @ j_pose_i, lt @ j_vb_i, lt @ j_pose_j, lt @ j_vb_j


def prior_residual(dr_j, dp_j, dv_j, ddbg_j, ddba_j,
                   R_i, p_i, v_i, dbg_i, dba_i,
                   R_j, p_j, v_j, dbg_j, dba_j,
                   ic, gravity, prior_factor: float, lt=None):
    """Whitened 15-residual of the anchor prior on frame j
    (PriorCostFunction): the IMU residual with frame i's increments frozen
    at zero and the information scaled by `prior_factor`."""
    uR_j = R_j @ lie.so3_exp(dr_j)
    corrected_dR = ic.dR @ lie.so3_exp(mv(ic.d_R_bg, dbg_i))
    R_iT = R_i.transpose(-1, -2)
    r_R = lie.so3_log(corrected_dR.transpose(-1, -2) @ (R_iT @ uR_j))
    dt = ic.dt[..., None]
    dt2 = ic.dt2[..., None]
    r_v = mv(R_iT, v_j + dv_j - v_i - gravity * dt) - (
        ic.dv + mv(ic.d_v_bg, dbg_i) + mv(ic.d_v_ba, dba_i)
    )
    r_p = mv(R_iT, p_j + mv(R_j, dp_j) - p_i - v_i * dt - gravity * (dt2 / 2)) - (
        ic.dp + mv(ic.d_p_bg, dbg_i) + mv(ic.d_p_ba, dba_i)
    )
    r_bg = dbg_j + ddbg_j - dbg_i
    r_ba = dba_j + ddba_j - dba_i
    res = torch.cat([r_R, r_v, r_p, r_bg, r_ba], dim=-1)
    if lt is None:
        lt = whitener(ic.inv_cov * prior_factor)
    return mv(lt, res)


def prior_jacobians(R_i, dbg_i, R_j, ic, prior_factor: float):
    """(J_pose_j [.., 15, 6], J_vb_j [.., 15, 9]) of the anchor prior."""
    dtype, dev = R_i.dtype, R_i.device
    lead = R_i.shape[:-2]
    eye = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    R_iT = R_i.transpose(-1, -2)
    residual_R = lie.so3_log(
        (ic.dR @ lie.so3_exp(mv(ic.d_R_bg, dbg_i))).transpose(-1, -2) @ (R_iT @ R_j)
    )
    j_pose_j = _assemble([[lie.right_jacobian_inverse(residual_R), None], [None, None],
                          [None, R_iT @ R_j], [None, None], [None, None]], lead, dtype, dev)
    j_vb_j = _assemble([[None, None, None], [R_iT, None, None], [None, None, None],
                        [None, eye, None], [None, None, eye]], lead, dtype, dev)
    lt = whitener(ic.inv_cov * prior_factor)
    return lt @ j_pose_j, lt @ j_vb_j


def reprojection_error_and_jacobian(R_wb, p_wb, landmark_w, pixel, R_cb, p_cb,
                                    fx, fy, cx, cy, inv_std):
    """Per-observation 2-residual and 2x6 pose Jacobian (pre-linearized at
    the current state). Returns (error [..., 2], F [..., 2, 6], depth)."""
    temp = mv(R_wb.transpose(-1, -2), landmark_w - p_wb)   # landmark in body
    x_cam = mv(R_cb, temp) + p_cb
    x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
    safe_z = torch.where(z.abs() < 1e-12, 1e-12, z)
    u = fx * x / safe_z + cx
    v = fy * y / safe_z + cy
    error = torch.stack(
        [inv_std[0] * (u - pixel[..., 0]), inv_std[1] * (v - pixel[..., 1])], dim=-1
    )
    zero = torch.zeros_like(z)
    d_e_pcam = torch.stack(
        [
            torch.stack([fx / safe_z, zero, -fx * x / (safe_z * safe_z)], dim=-1),
            torch.stack([zero, fy / safe_z, -fy * y / (safe_z * safe_z)], dim=-1),
        ],
        dim=-2,
    )                                                       # [..., 2, 3]
    f_dp = -(inv_std[:, None] * d_e_pcam) @ R_cb
    f_dr = -(f_dp @ lie.hat(temp))
    return error, torch.cat([f_dr, f_dp], dim=-1), z


# ---- Initializer residuals (`cost-functions.hpp:453-692`). Each takes the
# pair-stacked constraints ic [B, ...] and returns whitened residuals
# [B, n] or Jacobians [B, n, k]; `lt`, where given, is the whitener of the
# block (constant over a solve, so the solvers compute it once).


def _t(m):
    return m.transpose(-1, -2)


def gyr_bias_residual(ddbg, R_i, R_j, ic, lt=None):
    """3-residual of BiasGyrCostFunction (:459-483)."""
    r = lie.so3_log(_t(ic.dR @ lie.so3_exp(mv(ic.d_R_bg, ddbg))) @ (_t(R_i) @ R_j))
    if lt is None:
        lt = whitener(ic.inv_cov[..., 0:3, 0:3])
    return mv(lt, r)


def gyr_bias_jacobian(R_i, R_j, ic):
    residual_R = lie.so3_log(_t(ic.dR) @ (_t(R_i) @ R_j))
    j = -lie.right_jacobian_inverse(residual_R) @ _t(lie.so3_exp(residual_R)) @ ic.d_R_bg
    return whitener(ic.inv_cov[..., 0:3, 0:3]) @ j


def gravity_velocity_residual(dg, dv_i, dv_j, R_i, p_i, p_j, ic, lt=None):
    """6-residual of GravityVelocityCostFunction (:502-519)."""
    dt = ic.dt[..., None]
    dt2 = ic.dt2[..., None]
    r_v = mv(_t(R_i), dv_j - dv_i - dg * dt) - ic.dv
    r_p = mv(_t(R_i), p_j - p_i - dv_i * dt - dg * (dt2 / 2)) - ic.dp
    if lt is None:
        lt = whitener(ic.inv_cov[..., 3:9, 3:9])
    return mv(lt, torch.cat([r_v, r_p], dim=-1))


def gravity_velocity_jacobians(R_i, ic):
    """(J_g [B, 6, 3], J_vi [B, 6, 3], J_vj [B, 6, 3]); reference `:525-559`."""
    dt = ic.dt[..., None, None]
    dt2 = ic.dt2[..., None, None]
    r_temp = -_t(R_i)
    j_g = torch.cat([r_temp * dt, r_temp * (dt2 / 2)], dim=-2)
    j_vi = torch.cat([r_temp, r_temp * dt], dim=-2)
    j_vj = torch.cat([-r_temp, torch.zeros_like(r_temp)], dim=-2)
    lt = whitener(ic.inv_cov[..., 3:9, 3:9])
    return lt @ j_g, lt @ j_vi, lt @ j_vj


def embed_axes(x2, axes, like):
    """The 3-vector with x2's two entries at `axes` and zero elsewhere (no
    index tensor made from host values, which a CUDA graph cannot hold)."""
    parts = [torch.zeros((), dtype=like.dtype, device=like.device)] * 3
    parts[axes[0]], parts[axes[1]] = x2[0], x2[1]
    return torch.stack(parts)


def alignment_residual(delta_r2, init_g, unit_g, axes):
    """3-residual of AlignmentCostFunction (:578-613). `axes` are the two
    free tangent indices (dataset profile)."""
    return unit_g - mv(lie.so3_exp(embed_axes(delta_r2, axes, init_g)), init_g)


def alignment_jacobian(init_g, axes):
    """[3, 2] Jacobian: columns of hat(init_g) at the free axes (:617-631)."""
    h = lie.hat(init_g)
    return torch.stack([h[:, axes[0]], h[:, axes[1]]], dim=-1)


def acc_bias_residual(ddba, R_i, v_i, v_j, p_i, p_j, ic, gravity, lt=None):
    """6-residual of AccCostFunction (:649-663)."""
    dt = ic.dt[..., None]
    dt2 = ic.dt2[..., None]
    r_v = mv(_t(R_i), v_j - v_i - gravity * dt) - (ic.dv + mv(ic.d_v_ba, ddba))
    r_p = mv(_t(R_i), p_j - p_i - v_i * dt - gravity * (dt2 / 2)) - (
        ic.dp + mv(ic.d_p_ba, ddba))
    if lt is None:
        lt = whitener(ic.inv_cov[..., 3:9, 3:9])
    return mv(lt, torch.cat([r_v, r_p], dim=-1))


def acc_bias_jacobian(ic):
    j = torch.cat([-ic.d_v_ba, -ic.d_p_ba], dim=-2)
    return whitener(ic.inv_cov[..., 3:9, 3:9]) @ j
