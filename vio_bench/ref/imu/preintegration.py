"""On-manifold IMU preintegration (Forster et al.).

Counterpart of `pose_estimation_tpu/imu/preintegration.py`. `integrate_chunk`
is the JAX package's log-depth form: the rotation chain is a prefix product
(`utils.tree.associative_scan`, in JAX's association order), (dv, dp) and
the accelerometer-bias Jacobians are cumulative sums once the rotation
prefixes are known, and the gyroscope-bias Jacobians and the covariance
come out of one pairwise tree reduction of per-sample (A, b, Q) elements.
So a chunk of M samples is a few batched [M, ...] products at log2(M)
depth, with no loop over the samples and no host read. Masked (padding)
samples are identity elements and leave the state untouched.
`integrate_chunk_sequential` is the per-sample loop of the reference
recurrences, the JAX package's oracle: tests hold the two against each
other; no path of the system calls it.

Tangent order of the 15-dof error state: [dr, dv, dp, dbg, dba].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vio_bench.ref.utils import lie
from vio_bench.ref.utils.tree import associative_scan


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


def integrate_chunk_sequential(
    state: PreintState,
    gyr: torch.Tensor,   # [M, 3]
    acc: torch.Tensor,   # [M, 3]
    mask: torch.Tensor,  # [M] bool
    bg: torch.Tensor,    # [3]
    ba: torch.Tensor,    # [3]
    params: ImuParams,
) -> PreintState:
    """Reference recurrences of `ImuPreintegrator::processImu`, sample by
    sample (integrate, propagateNoise, biasJacobians): the oracle of
    `integrate_chunk`."""
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


def _grid(blocks) -> torch.Tensor:
    """[M, 9, 9] from a 3 x 3 grid (row-major list) of [M, 3, 3] blocks."""
    t = torch.stack(blocks, dim=1).unflatten(1, (3, 3))   # [M, i, j, r, c]
    return t.transpose(2, 3).flatten(3, 4).flatten(1, 2)


def _fused_combine(c1, c2):
    """(A, b, Q) of two consecutive spans, c1 first: the bias-Jacobian
    recurrence X' = A X + b and the covariance's C' = A C A^T + Q."""
    a1, b1, q1 = c1
    a2, b2, q2 = c2
    return a2 @ a1, a2 @ b1 + b2, a2 @ q1 @ a2.transpose(-1, -2) + q2


def integrate_chunk(
    state: PreintState,
    gyr: torch.Tensor,   # [M, 3]
    acc: torch.Tensor,   # [M, 3]
    mask: torch.Tensor,  # [M] bool
    bg: torch.Tensor,    # [3]
    ba: torch.Tensor,    # [3]
    params: ImuParams,
) -> PreintState:
    """The recurrences of `integrate_chunk_sequential` at log2(M) depth
    (the JAX package's `integrate_chunk`, in its order of operations):

    * the rotation prefixes are an associative scan of 3x3 products;
    * (dv, dp) and (d_v_ba, d_p_ba) are cumulative sums of per-sample terms
      in the i-frame once the rotation prefixes are known;
    * (d_R_bg, d_v_bg, d_p_bg), stacked 9x3, follow X_j = A_j X_{j-1} + b_j
      with A_j the 9x9 noise-propagation matrix, and the covariance
      C_j = A_j C_{j-1} A_j^T + Q_j: one pairwise tree reduction of
      (A, b, Q), whose odd element at a level is carried to the next.

    Masked samples are identity elements (A = I, b = 0, Q = 0), so an
    all-masked chunk returns the state unchanged, exactly."""
    dt = params.dt
    dt2 = dt * dt
    dtype, device = gyr.dtype, gyr.device
    m = gyr.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    mskf = mask.to(dtype)[:, None]
    msk3 = mskf[..., None]

    ub_g = (gyr - bg) * mskf
    ub_a = (acc - ba) * mskf
    omega = ub_g * dt
    exp, jr = lie.so3_exp_and_right_jacobian(omega)
    dR_step = torch.where(mask[:, None, None], exp, eye3)                  # [M, 3, 3]
    jr = jr * msk3

    # rotation prefixes: inclusive in the chunk's frame, then exclusive in
    # the i-frame
    incl = associative_scan(torch.matmul, dR_step)
    dR_total = state.dR @ incl[-1]
    r_prev = state.dR @ torch.cat([eye3[None], incl[:-1]])                 # [M, 3, 3]

    # dv, dp: dp_j = dp_{j-1} + dv_{j-1} dt + r_prev ub dt^2 / 2
    t_v = lie.mv(r_prev, ub_a) * dt
    dv_steps = torch.cumsum(t_v, 0)
    zero = torch.zeros((m, 3, 3), dtype=dtype, device=device)
    dv_prev = state.dv + torch.cat([zero[:1, 0], dv_steps[:-1]])
    dp_total = state.dp + torch.sum((dv_prev * dt + t_v * (dt / 2)) * mskf, 0)

    # per-sample A (9x9), b (9x3) and the noise Q = B covN B^T (9x9)
    temp = r_prev @ lie.hat(ub_a)
    eye_m = eye3.expand(m, 3, 3)
    a_mat = _grid([dR_step.transpose(-1, -2), zero, zero,
                   -temp * dt, eye_m, zero,
                   -temp * (dt2 / 2), eye_m * dt * msk3, eye_m])
    jr_jr_t = (jr @ jr.transpose(-1, -2)) * (params.cov_noise_d[0] * dt * dt)
    rr_t = (r_prev @ r_prev.transpose(-1, -2)) * params.cov_noise_d[3]
    rr_t_vp = rr_t * (dt * dt2 / 2)
    q = _grid([jr_jr_t, zero, zero,
               zero, rr_t * dt2, rr_t_vp,
               zero, rr_t_vp, rr_t * (dt2 * dt2 / 4)]) * msk3
    b = torch.cat([-jr * dt, zero, zero], -2)

    # one pairwise reduction of (A, b, Q): ~M combines at log2(M) depth
    elems = (a_mat, b, q)
    mm = m
    while mm > 1:
        half = mm // 2
        red = _fused_combine(tuple(x[0:2 * half:2] for x in elems),
                             tuple(x[1:2 * half:2] for x in elems))
        if mm % 2:
            red = tuple(torch.cat([r, x[-1:]]) for r, x in zip(red, elems))
        elems = red
        mm = half + mm % 2
    a_tot, b_tot, q_tot = (x[0] for x in elems)
    x_new = a_tot @ torch.cat([state.d_R_bg, state.d_v_bg, state.d_p_bg]) + b_tot
    cov_new = a_tot @ state.cov9 @ a_tot.T + q_tot

    # d_v_ba, d_p_ba: cumulative sums (their A block is constant)
    d_v_ba_steps = -torch.cumsum(r_prev * msk3, 0) * dt
    d_v_ba_prev = state.d_v_ba + torch.cat([zero[:1], d_v_ba_steps[:-1]])
    d_p_ba_total = state.d_p_ba + torch.sum(
        (d_v_ba_prev * dt - r_prev * (dt2 / 2)) * msk3, 0)

    return PreintState(
        dR=dR_total,
        dv=state.dv + dv_steps[-1],
        dp=dp_total,
        d_R_bg=x_new[0:3],
        d_v_bg=x_new[3:6],
        d_v_ba=state.d_v_ba + d_v_ba_steps[-1],
        d_p_bg=x_new[6:9],
        d_p_ba=d_p_ba_total,
        cov9=cov_new,
        dt=state.dt + mask.sum().to(dtype) * dt,
    )


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
