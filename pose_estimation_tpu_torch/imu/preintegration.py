"""On-manifold IMU preintegration (Forster et al.).

Counterpart of `pose_estimation_tpu/imu/preintegration.py`. The JAX package
integrates a chunk with associative scans, a TPU layout choice; here the
per-sample recurrences run as a loop over the (at most `imu_chunk`) samples,
exactly as its oracle `integrate_chunk_sequential` does. The per-sample
rotation increments and right Jacobians are computed for the whole chunk at
once before the loop. Masked (padding) samples leave the state untouched.

Tangent order of the 15-dof error state: [dr, dv, dp, dbg, dba].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose_estimation_tpu_torch.utils import lie


class ImuParams(NamedTuple):
    cov_noise_d: torch.Tensor  # [6] gyr^2 x3, acc^2 x3 (discrete)
    cov_bias: torch.Tensor     # [6] bias random-walk variances per second
    dt: torch.Tensor           # scalar sample period

    @classmethod
    def from_config(cls, cfg, device, dtype=torch.float32):
        gyr_n, acc_n, gyr_w, acc_w = cfg.discrete_noise()
        return cls(
            cov_noise_d=torch.tensor(
                [gyr_n**2] * 3 + [acc_n**2] * 3, dtype=dtype, device=device
            ),
            cov_bias=torch.tensor(
                [gyr_w**2] * 3 + [acc_w**2] * 3, dtype=dtype, device=device
            ),
            dt=torch.tensor(cfg.dt, dtype=dtype, device=device),
        )


class PreintState(NamedTuple):
    dR: torch.Tensor      # [3, 3]
    dv: torch.Tensor      # [3]
    dp: torch.Tensor      # [3]
    d_R_bg: torch.Tensor  # [3, 3]
    d_v_bg: torch.Tensor
    d_v_ba: torch.Tensor
    d_p_bg: torch.Tensor
    d_p_ba: torch.Tensor
    cov9: torch.Tensor    # [9, 9]
    dt: torch.Tensor      # scalar


class ImuConstraint(NamedTuple):
    inv_cov: torch.Tensor  # [15, 15]
    bg_i: torch.Tensor     # [3]
    ba_i: torch.Tensor
    dR: torch.Tensor       # [3, 3]
    dv: torch.Tensor
    dp: torch.Tensor
    d_R_bg: torch.Tensor
    d_v_bg: torch.Tensor
    d_v_ba: torch.Tensor
    d_p_bg: torch.Tensor
    d_p_ba: torch.Tensor
    dt: torch.Tensor
    dt2: torch.Tensor


def init_state(device, dtype=torch.float32) -> PreintState:
    def z(*s):
        return torch.zeros(s, dtype=dtype, device=device)

    return PreintState(
        dR=torch.eye(3, dtype=dtype, device=device), dv=z(3), dp=z(3),
        d_R_bg=z(3, 3), d_v_bg=z(3, 3), d_v_ba=z(3, 3), d_p_bg=z(3, 3),
        d_p_ba=z(3, 3), cov9=z(9, 9), dt=z(),
    )


def integrate_chunk(
    state: PreintState,
    gyr: torch.Tensor,   # [M, 3]
    acc: torch.Tensor,   # [M, 3]
    mask: torch.Tensor,  # [M] bool
    bg: torch.Tensor,    # [3]
    ba: torch.Tensor,    # [3]
    params: ImuParams,
) -> PreintState:
    """Reference recurrences of `ImuPreintegrator::processImu`, sample by
    sample (integrate, propagateNoise, biasJacobians)."""
    dt = params.dt
    dt2 = dt * dt
    dtype, device = gyr.dtype, gyr.device
    cov_noise = torch.diag(params.cov_noise_d)
    eye = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros((3, 3), dtype=dtype, device=device)

    ub_g_all = gyr - bg
    ub_a_all = acc - ba
    omega_all = ub_g_all * dt
    dR_step_all = lie.so3_exp(omega_all)          # [M, 3, 3]
    jr_all = lie.right_jacobian(omega_all)
    hat_a_all = lie.hat(ub_a_all)

    s = state
    for k in range(gyr.shape[0]):
        ub_a = ub_a_all[k]
        dR_step = dR_step_all[k]
        jr = jr_all[k]
        new_dR = s.dR @ dR_step
        new_dv = s.dv + lie.mv(s.dR, ub_a) * dt
        new_dp = s.dp + s.dv * dt + lie.mv(s.dR, ub_a) * (dt2 / 2)

        temp = s.dR @ hat_a_all[k]
        a_mat = torch.cat([
            torch.cat([dR_step.T, zero, zero], 1),
            torch.cat([-temp * dt, eye, zero], 1),
            torch.cat([-temp * (dt2 / 2), eye * dt, eye], 1),
        ], 0)
        b_mat = torch.cat([
            torch.cat([jr * dt, zero], 1),
            torch.cat([zero, s.dR * dt], 1),
            torch.cat([zero, s.dR * (dt2 / 2)], 1),
        ], 0)
        new_cov9 = a_mat @ s.cov9 @ a_mat.T + b_mat @ cov_noise @ b_mat.T

        temp2 = temp @ s.d_R_bg
        new = PreintState(
            dR=new_dR, dv=new_dv, dp=new_dp,
            d_R_bg=dR_step.T @ s.d_R_bg - jr * dt,
            d_v_bg=s.d_v_bg - temp2 * dt,
            d_v_ba=s.d_v_ba - s.dR * dt,
            d_p_bg=s.d_p_bg + s.d_v_bg * dt - temp2 * (dt2 / 2),
            d_p_ba=s.d_p_ba + s.d_v_ba * dt - s.dR * (dt2 / 2),
            cov9=new_cov9,
            dt=s.dt + dt,
        )
        m = mask[k]
        s = PreintState(*(torch.where(m, n, o) for n, o in zip(new, s)))
    return s


def _spd_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD matrix by Cholesky (no exception on failure: the
    result is then not finite, as with the JAX package's Cholesky)."""
    chol, info = torch.linalg.cholesky_ex(m)
    inv = torch.cholesky_inverse(chol)
    return torch.where(info == 0, inv, torch.full_like(inv, float("nan")))


def finalize(state: PreintState, bg, ba, params: ImuParams) -> ImuConstraint:
    """The 15x15 constraint of the accumulated interval."""
    dtype, device = state.dR.dtype, state.dR.device
    z = torch.zeros((9, 6), dtype=dtype, device=device)
    cov15 = torch.cat([torch.cat([state.cov9, z], 1),
                       torch.cat([z.T, torch.diag(params.cov_bias) * state.dt], 1)], 0)
    return ImuConstraint(
        inv_cov=_spd_inverse(cov15),
        bg_i=bg, ba_i=ba,
        dR=state.dR, dv=state.dv, dp=state.dp,
        d_R_bg=state.d_R_bg, d_v_bg=state.d_v_bg, d_v_ba=state.d_v_ba,
        d_p_bg=state.d_p_bg, d_p_ba=state.d_p_ba,
        dt=state.dt, dt2=state.dt * state.dt,
    )


def repropagate(ic: ImuConstraint, delta_bg, delta_ba) -> ImuConstraint:
    """First-order bias repropagation of a stored constraint."""
    return ic._replace(
        bg_i=ic.bg_i + delta_bg,
        ba_i=ic.ba_i + delta_ba,
        dR=ic.dR @ lie.so3_exp(lie.mv(ic.d_R_bg, delta_bg)),
        dv=ic.dv + lie.mv(ic.d_v_bg, delta_bg) + lie.mv(ic.d_v_ba, delta_ba),
        dp=ic.dp + lie.mv(ic.d_p_bg, delta_bg) + lie.mv(ic.d_p_ba, delta_ba),
    )


def predict(R_i, v_i, p_i, ic: ImuConstraint, gravity, dbg_i=None, dba_i=None):
    """IMU-predicted state j from state i and the constraint; with the bias
    increments of frame i the bias-corrected deltas are used."""
    if dbg_i is None:
        dR, dv, dp = ic.dR, ic.dv, ic.dp
    else:
        dR = ic.dR @ lie.so3_exp(lie.mv(ic.d_R_bg, dbg_i))
        dv = ic.dv + lie.mv(ic.d_v_bg, dbg_i) + lie.mv(ic.d_v_ba, dba_i)
        dp = ic.dp + lie.mv(ic.d_p_bg, dbg_i) + lie.mv(ic.d_p_ba, dba_i)
    R_j = R_i @ dR
    v_j = v_i + gravity * ic.dt + lie.mv(R_i, dv)
    p_j = p_i + v_i * ic.dt + gravity * (ic.dt2 / 2) + lie.mv(R_i, dp)
    return R_j, v_j, p_j
