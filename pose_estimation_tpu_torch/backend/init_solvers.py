"""The 4-stage visual-inertial initializer and the online gravity
refinement, each stage a small LM solve.

Counterpart of `pose_estimation_tpu/backend/init_solvers.py`. Inputs are
stacked states (R [W, 3, 3], v/p [W, 3]) plus the W-1 pair-stacked IMU
constraints between them. The JAX package evaluates the residual blocks in
a Python loop over pairs; here every block of a stage is one batched
evaluation, and each block's whitener (constant over a solve) is computed
once. The solves run in the dtype of their inputs (float32 on the card,
float64 in the parity tests). Nothing here reads the device on the host
(`inv_ex` reports a failure in `info`), so a CUDA graph captures
`full_init` and `refine_gravity` (`graphs.SolveGraphs`).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.backend import lm as lm_mod
from pose_estimation_tpu_torch.backend import residuals as res
from pose_estimation_tpu_torch.imu.preintegration import repropagate
from pose_estimation_tpu_torch.utils import lie


def _huber_rows(r, n_blocks: int, size: int):
    """Per-row Huber(1) IRLS weights of `n_blocks` leading blocks of `size`."""
    blocks = r[: n_blocks * size].reshape(n_blocks, size)
    mask = torch.ones(n_blocks, dtype=torch.bool, device=r.device)
    return lm_mod.huber_block_weights(blocks, mask).repeat_interleave(size)


def _options(max_iterations: int) -> lm_mod.LMOptions:
    return lm_mod.LMOptions(max_iterations=max_iterations)


def _velocity_columns(jac, jvi, jvj, col0: int):
    """Write each pair's velocity blocks (frames i and i+1) into `jac`."""
    for i in range(jvi.shape[0]):
        jac[6 * i:6 * i + 6, col0 + 3 * i:col0 + 3 * i + 3] = jvi[i]
        jac[6 * i:6 * i + 6, col0 + 3 * i + 3:col0 + 3 * i + 6] = jvj[i]


# the JAX package's name for the constraints' first-order bias repropagation
pre_repropagate = repropagate


def solve_gyr_bias(R, ics, max_iterations: int = 50):
    """delta_bg [3] from W-1 rotation residuals (`optimizer.cpp:183-206`),
    Huber(1) per block. Returns (x, info)."""
    nb = R.shape[0] - 1
    lt = res.whitener(ics.inv_cov[:, 0:3, 0:3])
    jac = res.gyr_bias_jacobian(R[:-1], R[1:], ics).reshape(nb * 3, 3)

    def residual_fn(x):
        return res.gyr_bias_residual(x, R[:-1], R[1:], ics, lt).reshape(-1)

    return lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(3, dtype=R.dtype, device=R.device),
        lambda r: _huber_rows(r, nb, 3), _options(max_iterations), name="gyr_bias",
    )


def solve_gravity_velocity(R, p, ics, max_iterations: int = 50):
    """(gravity estimate [3], dv [W, 3], info), `optimizer.cpp:208-240`.
    Parameters x = [dg(3), dv_0(3) .. dv_{W-1}(3)]."""
    w = R.shape[0]
    nb = w - 1
    lt = res.whitener(ics.inv_cov[:, 3:9, 3:9])
    jg, jvi, jvj = res.gravity_velocity_jacobians(R[:-1], ics)
    jac = torch.zeros((6 * nb, 3 + 3 * w), dtype=R.dtype, device=R.device)
    jac[:, 0:3] = jg.reshape(6 * nb, 3)
    _velocity_columns(jac, jvi, jvj, 3)

    def residual_fn(x):
        dv = x[3:].reshape(w, 3)
        return res.gravity_velocity_residual(
            x[0:3], dv[:-1], dv[1:], R[:-1], p[:-1], p[1:], ics, lt).reshape(-1)

    x, info = lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(3 + 3 * w, dtype=R.dtype, device=R.device),
        lambda r: _huber_rows(r, nb, 6), _options(max_iterations),
        name="gravity_velocity",
    )
    return x[0:3], x[3:].reshape(w, 3), info


def _bias_columns(ics, lt):
    """Whitened Jacobian of the v/p residuals in the acc-bias increment
    (the constraints' own bias Jacobians), [B, 6, 3]."""
    return lt @ torch.cat([-ics.d_v_ba, -ics.d_p_ba], dim=-2)


def solve_gravity_velocity_bias(R, p, ics, max_iterations: int = 50):
    """JOINT (gravity [3], acc-bias increment [3], dv [W, 3], info) solve;
    the bias enters through the constraints' bias Jacobians."""
    w = R.shape[0]
    nb = w - 1
    dtype, dev = R.dtype, R.device
    lt = res.whitener(ics.inv_cov[:, 3:9, 3:9])
    jg, jvi, jvj = res.gravity_velocity_jacobians(R[:-1], ics)
    jac = torch.zeros((6 * nb, 6 + 3 * w), dtype=dtype, device=dev)
    jac[:, 0:3] = jg.reshape(6 * nb, 3)
    jac[:, 3:6] = _bias_columns(ics, lt).reshape(6 * nb, 3)
    _velocity_columns(jac, jvi, jvj, 6)
    zero3 = torch.zeros(3, dtype=dtype, device=dev)

    def residual_fn(x):
        dv = x[6:].reshape(w, 3)
        ic_b = repropagate(ics, zero3, x[3:6])
        return res.gravity_velocity_residual(
            x[0:3], dv[:-1], dv[1:], R[:-1], p[:-1], p[1:], ic_b, lt).reshape(-1)

    x, info = lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(6 + 3 * w, dtype=dtype, device=dev),
        lambda r: _huber_rows(r, nb, 6), _options(max_iterations),
        name="gravity_velocity_bias",
    )
    return x[0:3], x[3:6], x[6:].reshape(w, 3), info


def solve_gravity_tilt_bias(R, p, ics, g0, max_iterations: int = 50,
                            sigma_tilt: float = 0.5, sigma_dba: float = 0.5):
    """Magnitude-constrained joint (tilt [2], acc-bias increment [3],
    dv [W, 3]) solve for the online refinement: g = g0 + B tilt with B an
    orthonormal basis of the tangent plane at g0, and Tikhonov rows pulling
    (tilt, dba) to zero. Returns (g_est [3] renormalized to |g0|, dba,
    dv, info)."""
    w = R.shape[0]
    nb = w - 1
    dtype, dev = R.dtype, R.device
    g_mag = torch.linalg.norm(g0)
    ghat = g0 / g_mag
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    e1, e2 = eye3[0], eye3[1]
    a = torch.where(ghat[0].abs() < 0.9, e1, e2)
    b1 = torch.linalg.cross(ghat, a)
    b1 = b1 / torch.linalg.norm(b1)
    b2 = torch.linalg.cross(ghat, b1)
    basis = torch.stack([b1, b2], dim=1)                     # [3, 2]

    lt = res.whitener(ics.inv_cov[:, 3:9, 3:9])
    jg, jvi, jvj = res.gravity_velocity_jacobians(R[:-1], ics)
    pr = 6 * nb
    jac = torch.zeros((pr + 5, 5 + 3 * w), dtype=dtype, device=dev)
    jac[:pr, 0:2] = (jg @ basis).reshape(pr, 2)
    jac[:pr, 2:5] = _bias_columns(ics, lt).reshape(pr, 3)
    _velocity_columns(jac, jvi, jvj, 5)
    jac[pr:pr + 2, 0:2] = torch.eye(2, dtype=dtype, device=dev) / sigma_tilt
    jac[pr + 2:pr + 5, 2:5] = torch.eye(3, dtype=dtype, device=dev) / sigma_dba
    zero3 = torch.zeros(3, dtype=dtype, device=dev)

    def residual_fn(x):
        tilt, dba = x[0:2], x[2:5]
        dv = x[5:].reshape(w, 3)
        ic_b = repropagate(ics, zero3, dba)
        r = res.gravity_velocity_residual(
            g0 + lie.mv(basis, tilt), dv[:-1], dv[1:], R[:-1], p[:-1], p[1:], ic_b, lt)
        return torch.cat([r.reshape(-1), tilt / sigma_tilt, dba / sigma_dba])

    def weight_fn(r):
        return torch.cat([_huber_rows(r, nb, 6), torch.ones(5, dtype=dtype, device=dev)])

    x, info = lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(5 + 3 * w, dtype=dtype, device=dev),
        weight_fn, _options(max_iterations), name="tilt",
    )
    g_raw = g0 + lie.mv(basis, x[0:2])
    g_est = g_raw / torch.linalg.norm(g_raw) * g_mag
    return g_est, x[2:5], x[5:].reshape(w, 3), info


def solve_alignment(init_g, unit_g, axes, max_iterations: int = 50):
    """2-DoF rotation aligning the estimated gravity direction with the
    world gravity axis (`optimizer.cpp:242-304`). Returns (delta_r [3]
    with zero on the fixed axis, info)."""
    jac = res.alignment_jacobian(init_g, axes)

    def residual_fn(x):
        return res.alignment_residual(x, init_g, unit_g, axes)

    x, info = lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(2, dtype=init_g.dtype, device=init_g.device),
        None, _options(max_iterations), name="alignment",
    )
    return res.embed_axes(x, axes, init_g), info


def solve_acc_bias(R, v, p, ics, gravity, max_iterations: int = 50):
    """delta_ba [3] (`optimizer.cpp:306-329`, with each pair's own
    constraint). Returns (x, info)."""
    nb = R.shape[0] - 1
    lt = res.whitener(ics.inv_cov[:, 3:9, 3:9])
    jac = res.acc_bias_jacobian(ics).reshape(nb * 6, 3)

    def residual_fn(x):
        return res.acc_bias_residual(
            x, R[:-1], v[:-1], v[1:], p[:-1], p[1:], ics, gravity, lt).reshape(-1)

    return lm_mod.lm_solve(
        residual_fn, jac, torch.zeros(3, dtype=R.dtype, device=R.device),
        lambda r: _huber_rows(r, nb, 6), _options(max_iterations), name="acc_bias",
    )


def refine_gravity(R, p, ics, unit_g, axes, gravity, max_iterations: int = 50,
                   rounds: int = 2, sigma_v: float = 0.05, sigma_p: float = 0.02,
                   sigma_tilt: float = 0.5, sigma_dba: float = 0.5):
    """Online gravity refinement over a keyframe chain: `rounds` passes of
    (tilt, acc bias, velocity) solve -> world alignment -> constraint
    repropagation, with the constraints' v/p covariance inflated by the
    expected state noise (sigma_v [m/s], sigma_p [m]). R/p [K, ...] keyframe
    states, ics [K-1] constraints repropagated to the current bias. Returns
    (g_est [3] of the last round, delta_r [3] total alignment rotation,
    dba [3] total acc-bias increment)."""
    dtype, dev = R.dtype, R.device
    total_rot = torch.eye(3, dtype=dtype, device=dev)
    total_dba = torch.zeros(3, dtype=dtype, device=dev)
    g_est = torch.zeros(3, dtype=dtype, device=dev)
    dvec = torch.zeros(ics.inv_cov.shape[-1], dtype=dtype, device=dev)
    dvec[3:6].fill_(sigma_v ** 2)
    dvec[6:9].fill_(sigma_p ** 2)
    inv_cov = torch.linalg.inv_ex(torch.linalg.inv_ex(ics.inv_cov)[0] + torch.diag(dvec))[0]
    ics = ics._replace(inv_cov=inv_cov)
    for _ in range(rounds):
        g_est, dba, _, _ = solve_gravity_tilt_bias(
            R, p, ics, gravity, max_iterations, sigma_tilt=sigma_tilt, sigma_dba=sigma_dba)
        g_unit = g_est / torch.linalg.norm(g_est)
        delta_r, _ = solve_alignment(g_unit, unit_g, axes, max_iterations)
        d_rm = lie.so3_exp(delta_r)
        R = d_rm[None] @ R
        p = p @ d_rm.T
        total_rot = d_rm @ total_rot
        ics = repropagate(ics, torch.zeros_like(ics.bg_i), dba.expand_as(ics.ba_i))
        total_dba = total_dba + dba
    return g_est, lie.so3_log(total_rot), total_dba


def full_init(R, p, ics, unit_g, axes, gravity):
    """The four init solves in sequence (`visual-inertial-slam.cpp:68-110`):
    gyro bias -> repropagate -> gravity + velocity -> world alignment ->
    acc bias -> repropagate. Plausibility gates stay with the caller.
    Returns (R', v', p', dbg, dba, g_est, ics'): states world-aligned,
    constraints repropagated to the solved biases."""
    zero3 = torch.zeros(3, dtype=R.dtype, device=R.device)
    dbg, _ = solve_gyr_bias(R, ics)
    ics = repropagate(ics, dbg, zero3)
    g_est, v, _ = solve_gravity_velocity(R, p, ics)
    init_g_unit = g_est / torch.clamp(torch.linalg.norm(g_est), min=1e-12)
    delta_r, _ = solve_alignment(init_g_unit, unit_g, axes)
    d_rm = lie.so3_exp(delta_r)
    R = d_rm[None] @ R
    v = v @ d_rm.T
    p = p @ d_rm.T
    dba, _ = solve_acc_bias(R, v, p, ics, gravity)
    ics = repropagate(ics, zero3, dba)
    return R, v, p, dbg, dba, g_est, ics
