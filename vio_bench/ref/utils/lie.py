"""SO(3) and SE(3) operations on torch tensors.

Counterpart of `pose_estimation_tpu/utils/lie.py`, with the same formulas in
the same order so that float32 results agree: rotations are 3x3 matrices,
every function broadcasts over leading batch dimensions, and small angles
take Taylor branches selected with `torch.where` on safe denominators.
`sin_cos` is the same ~1-ulp Cody-Waite + Taylor evaluation the JAX package
uses instead of the library sin/cos (the preintegration recurrences are
bit-matched to it).
"""

from __future__ import annotations

import math

import torch

# Small-angle cutoff on theta^2 (theta < 0.1 rad), as in the JAX package.
_EPS2 = 1e-2
_PI2_HI = 1.5707963267948966
_PI2_LO = 6.123233995736766e-17


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of `hat`. [..., 3, 3] -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _sincos_core(r):
    r2 = r * r
    s = 1.0 / 121645100408832000.0
    s = 1.0 / 355687428096000.0 - s * r2
    s = 1.0 / 1307674368000.0 - s * r2
    s = 1.0 / 6227020800.0 - s * r2
    s = 1.0 / 39916800.0 - s * r2
    s = 1.0 / 362880.0 - s * r2
    s = 1.0 / 5040.0 - s * r2
    s = 1.0 / 120.0 - s * r2
    s = 1.0 / 6.0 - s * r2
    sin_r = r - r * r2 * s
    c = 1.0 / 6402373705728000.0
    c = 1.0 / 20922789888000.0 - c * r2
    c = 1.0 / 87178291200.0 - c * r2
    c = 1.0 / 479001600.0 - c * r2
    c = 1.0 / 3628800.0 - c * r2
    c = 1.0 / 40320.0 - c * r2
    c = 1.0 / 720.0 - c * r2
    c = 1.0 / 24.0 - c * r2
    cos_r = 1.0 - r2 * (0.5 - r2 * c)
    return sin_r, cos_r


def sin_cos(theta: torch.Tensor):
    """Accurate (sin, cos) for |theta| up to ~1e3."""
    k = torch.round(theta * (2.0 / math.pi))
    r = (theta - k * _PI2_HI) - k * _PI2_LO
    sin_r, cos_r = _sincos_core(r)
    q = k.to(torch.int32) & 3
    sin_t = torch.where(
        q == 0, sin_r,
        torch.where(q == 1, cos_r, torch.where(q == 2, -sin_r, -cos_r)),
    )
    cos_t = torch.where(
        q == 0, cos_r,
        torch.where(q == 1, -sin_r, torch.where(q == 2, -cos_r, sin_r)),
    )
    return sin_t, cos_t


def _sinc_coeffs(theta2):
    """(sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor fallbacks."""
    small = theta2 < _EPS2
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sin_t, cos_t = sin_cos(theta)
    a_exact = sin_t / theta
    b_exact = (1.0 - cos_t) / safe2
    c_exact = (theta - sin_t) / (safe2 * theta)
    t4 = theta2 * theta2
    t6 = t4 * theta2
    a_taylor = 1.0 - theta2 / 6.0 + t4 / 120.0 - t6 / 5040.0
    b_taylor = 0.5 - theta2 / 24.0 + t4 / 720.0 - t6 / 40320.0
    c_taylor = 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0 - t6 / 362880.0
    return (
        torch.where(small, a_taylor, a_exact),
        torch.where(small, b_taylor, b_exact),
        torch.where(small, c_taylor, c_exact),
    )


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def _exp_terms(omega: torch.Tensor):
    """(I, A, B, C, w^, (w^)^2) of the exp map and the right Jacobian,
    the coefficients shaped [..., 1, 1] (`_sinc_coeffs`)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    a, b, c = (x[..., None, None] for x in _sinc_coeffs(theta2))
    k = hat(omega)
    return _eye_like(k), a, b, c, k, k @ k


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3). [..., 3] -> [..., 3, 3]."""
    eye, a, b, _, k, k2 = _exp_terms(omega)
    return eye + a * k + b * k2


def mat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def pos(x):
        return torch.clamp(x, min=1e-30)

    q0 = torch.stack([pos(1.0 + tr), m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack(
        [m21 - m12, pos(1.0 + m00 - m11 - m22), m01 + m10, m02 + m20], dim=-1
    )
    q2 = torch.stack(
        [m02 - m20, m01 + m10, pos(1.0 - m00 + m11 - m22), m12 + m21], dim=-1
    )
    q3 = torch.stack(
        [m10 - m01, m02 + m20, m12 + m21, pos(1.0 - m00 - m11 + m22)], dim=-1
    )
    p = torch.stack(
        [tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1
    )
    idx = torch.argmax(p, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)           # [..., 4, 4]
    q = torch.gather(
        qs, -2, idx[..., None, None].expand(idx.shape + (1, 4))
    )[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix. [..., 4] -> [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) through the quaternion. [..., 3, 3] -> [..., 3]."""
    q = mat_to_quat(r)
    w = q[..., 0]
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1)
    small = n2 < _EPS2
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    factor_exact = 2.0 * torch.atan2(n, w) / n
    factor_taylor = 2.0 / torch.clamp(w, min=1e-30) * (
        1.0 - n2 / (3.0 * torch.clamp(w * w, min=1e-30))
    )
    factor = torch.where(small, factor_taylor, factor_exact)
    return v * factor[..., None]


def right_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), Jr(w) = I - B(w) w^ + C(w) (w^)^2."""
    eye, _, b, c, k, k2 = _exp_terms(omega)
    return eye - b * k + c * k2


def so3_exp_and_right_jacobian(omega: torch.Tensor):
    """(so3_exp(omega), right_jacobian(omega)), bit for bit, from one
    evaluation of the terms they share (theta, sin/cos, the hat and its
    square), as a compiler would share them."""
    eye, a, b, c, k, k2 = _exp_terms(omega)
    return eye + a * k + b * k2, eye - b * k + c * k2


def left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """Left Jacobian, Jl(w) = Jr(-w)."""
    return right_jacobian(-omega)


def right_jacobian_inverse(omega: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) with a Taylor branch for small angles."""
    theta2 = torch.sum(omega * omega, dim=-1)
    small = theta2 < _EPS2
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    sin_t, cos_t = sin_cos(theta)
    coeff_exact = 1.0 / safe2 - (1.0 + cos_t) / (
        2.0 * theta * torch.where(small, torch.ones_like(sin_t), sin_t)
    )
    t4 = theta2 * theta2
    coeff_taylor = (
        1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0 + t4 * theta2 / 1209600.0
    )
    coeff = torch.where(small, coeff_taylor, coeff_exact)
    k = hat(omega)
    k2 = k @ k
    return _eye_like(k) + 0.5 * k + coeff[..., None, None] * k2


def mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product. [..., n, k] x [..., k] -> [..., n]."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


# ---- SE(3) as a pair (R [..., 3, 3], p [..., 3])


def se3_apply(r, p, x):
    """Apply T = (r, p) to points x [..., 3]."""
    return mv(r, x) + p


def se3_compose(r1, p1, r2, p2):
    """T1 * T2."""
    return r1 @ r2, se3_apply(r1, p1, p2)


def se3_inverse(r, p):
    rt = r.transpose(-1, -2)
    return rt, -mv(rt, p)


def se3_exp(xi):
    """se(3) exp with xi = [rho(3), omega(3)] (translation first)."""
    rho, omega = xi[..., :3], xi[..., 3:]
    return so3_exp(omega), mv(left_jacobian(omega), rho)


def se3_log(r, p):
    """Inverse of `se3_exp`: [rho, omega] with rho = Jl^-1(omega) p, and
    Jl^-1(w) = Jr^-1(-w)."""
    omega = so3_log(r)
    rho = mv(right_jacobian_inverse(-omega), p)
    return torch.cat([rho, omega], dim=-1)
