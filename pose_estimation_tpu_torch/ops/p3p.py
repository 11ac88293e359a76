"""Batched closed-form P3P (Grunert): the minimal perspective-3-point solver
behind the reference's SOLVEPNP_P3P/AP3P switch values (solve_pnp 2 and 5).

Counterpart of `pose_estimation_tpu/ops/p3p.py`. With depths s_i along the
three unit bearing rays f_i and the world distances a = |X2 - X3|, b =
|X1 - X3|, c = |X1 - X2|, the law-of-cosines system reduces, with u =
s2/s1 and v = s3/s1, to u = N(v)/D(v) (N quadratic, D linear) and a
quartic in v. Its coefficients come from products of the coefficient
lists of N, D and the u-free part Q; its roots from Ferrari's closed form
(the resolvent cubic's largest real root) followed by three Newton steps
on the original quartic, which make the float32 closed form usable. A
complex root, or one that puts a point behind the camera, comes out as
NaN: callers score the hypotheses with comparisons, which are false for
NaN, so a NaN pose never wins. Each sample gives its up to 4 roots as
separate hypotheses; (R, t) of each root is the rigid Procrustes fit of
the world points to the back-projected camera points s_i f_i, so that
x_cam = R X + t, as cv::solvePnP returns it.

The solver runs in float32 under the port's precision policy (TF32 off,
`utils.precision.apply_policy`), the counterpart of the JAX package's
`@full_precision`.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.utils.precision import apply_policy


def _poly_mul(p, q):
    """Product of two polynomials given as lists of coefficient tensors,
    highest degree first."""
    out = [None] * (len(p) + len(q) - 1)
    for i, pi in enumerate(p):
        for j, qj in enumerate(q):
            t = pi * qj
            out[i + j] = t if out[i + j] is None else out[i + j] + t
    return out


def _cubic_max_real_root(b, c, d):
    """Largest real root of x^3 + b x^2 + c x + d (batched): the
    trigonometric form where there are three real roots, Cardano's where
    there is one."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    pm = torch.clamp(p, max=-1e-30)                     # p < 0 in the trigonometric case
    rr = torch.sqrt(-pm / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (2.0 * pm * rr), -1.0, 1.0))
    x_trig = 2.0 * rr * torch.cos(theta / 3.0) - b / 3.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))

    def cbrt(t):
        return torch.sign(t) * t.abs() ** (1.0 / 3.0)

    x_card = cbrt(-q / 2.0 + sq) + cbrt(-q / 2.0 - sq) - b / 3.0
    return torch.where(disc > 0, x_card, x_trig)


def _quartic_roots(coeffs):
    """Roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0 (each [B]) -> [B, 4]:
    Ferrari's closed form and three Newton steps; a complex pair comes out
    as NaN."""
    c4, c3, c2, c1, c0 = coeffs
    lead = torch.where(c4.abs() < 1e-20, torch.sign(c4) * 1e-20 + 1e-20, c4)
    a = c3 / lead
    b = c2 / lead
    c = c1 / lead
    d = c0 / lead
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0; its largest
    # real root keeps the square roots' arguments non-negative
    m = torch.clamp(_cubic_max_real_root(p, p * p / 4.0 - r, -q * q / 8.0), min=1e-12)
    s = torch.sqrt(2.0 * m)
    t_term = q / (2.0 * s)
    roots = []
    for sgn_s in (1.0, -1.0):
        # y^2 -+ s y + (p/2 + m +- t) = 0
        disc = s * s / 4.0 - (p / 2.0 + m - sgn_s * t_term)
        sd = torch.sqrt(disc)                           # NaN where complex
        for sgn_d in (1.0, -1.0):
            roots.append(-sgn_s * s / 2.0 + sgn_d * sd - a / 4.0)
    x = torch.stack(roots, dim=-1)                      # [B, 4]
    c4, c3, c2, c1, c0 = (k[..., None] for k in coeffs)
    for _ in range(3):
        f = (((c4 * x + c3) * x + c2) * x + c1) * x + c0
        df = ((4.0 * c4 * x + 3.0 * c3) * x + 2.0 * c2) * x + c1
        x = x - f / torch.where(df.abs() < 1e-20, 1e-20, df)
    return x


def p3p_depths(obj: torch.Tensor, img_n: torch.Tensor):
    """The depths (s1, s2, s3), [B, 4] each, of the quartic's roots along
    the unit bearings f [B, 3, 3] (returned too); s1 is NaN for a complex
    root or a point behind the camera."""
    ones = torch.ones(img_n.shape[:-1] + (1,), dtype=obj.dtype, device=obj.device)
    f = torch.cat([img_n, ones], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]
    x1, x2, x3 = obj[:, 0], obj[:, 1], obj[:, 2]

    a2 = torch.sum((x2 - x3) ** 2, dim=-1)
    b2 = torch.sum((x1 - x3) ** 2, dim=-1)
    c2 = torch.sum((x1 - x2) ** 2, dim=-1)
    b2s = torch.where(b2 < 1e-18, 1e-18, b2)
    ca = torch.sum(f2 * f3, dim=-1)                     # cos(alpha)
    cbe = torch.sum(f1 * f3, dim=-1)                    # cos(beta)
    cg = torch.sum(f1 * f2, dim=-1)                     # cos(gamma)

    acb = (a2 - c2) / b2s
    # u = N(v) / D(v): N = n2 v^2 + n1 v + n0, D = d1 v + d0
    n2, n1, n0 = 1.0 - acb, 2.0 * cbe * acb, -acb - 1.0
    d1, d0 = 2.0 * ca, -2.0 * cg
    # the second constraint with u substituted: N^2 - 2 cg N D + Q D^2 = 0,
    # Q = q2 v^2 + q1 v + q0 its u-free part
    cb2 = c2 / b2s
    q2, q1, q0 = -cb2, 2.0 * cb2 * cbe, 1.0 - cb2
    n_poly, d_poly = [n2, n1, n0], [d1, d0]
    quart = _poly_mul(n_poly, n_poly)
    cross = _poly_mul(n_poly, d_poly)
    qd2 = _poly_mul([q2, q1, q0], _poly_mul(d_poly, d_poly))
    v = _quartic_roots([
        quart[0] + qd2[0],
        quart[1] - 2.0 * cg * cross[0] + qd2[1],
        quart[2] - 2.0 * cg * cross[1] + qd2[2],
        quart[3] - 2.0 * cg * cross[2] + qd2[3],
        quart[4] - 2.0 * cg * cross[3] + qd2[4],
    ])

    den_u = d1[..., None] * v + d0[..., None]
    den_u = torch.where(den_u.abs() < 1e-12, torch.where(den_u < 0, -1e-12, 1e-12), den_u)
    u = (n2[..., None] * v * v + n1[..., None] * v + n0[..., None]) / den_u
    s1 = torch.sqrt(b2s[..., None] / torch.clamp(1.0 + v * v - 2.0 * v * cbe[..., None],
                                                  min=1e-12))
    s2 = u * s1
    s3 = v * s1
    bad = (s1 <= 0) | (s2 <= 0) | (s3 <= 0)
    s1 = torch.where(bad, float("nan"), s1)
    return (s1, s2, s3), f


def p3p_solve(obj: torch.Tensor, img_n: torch.Tensor):
    """Batched Grunert P3P. obj [B, 3, 3] world points, img_n [B, 3, 2]
    normalized image coordinates (f = 1, c = 0) -> (R [B, 4, 3, 3], t [B,
    4, 3]): up to 4 solutions per sample, the invalid ones NaN;
    x_cam = R X + t."""
    from pose_estimation_tpu_torch.ops.pnp import _procrustes

    apply_policy()
    (s1, s2, s3), f = p3p_depths(obj, img_n)
    b = obj.shape[0]
    pc = torch.stack([s1[..., None] * f[:, None, 0], s2[..., None] * f[:, None, 1],
                      s3[..., None] * f[:, None, 2]], dim=2)        # [B, 4, 3 points, 3]
    pw = obj[:, None].expand(pc.shape)
    # the SVD gets finite inputs only: an invalid root's points are
    # replaced by the world points, and its pose is NaN afterwards
    bad = ~torch.isfinite(pc).all(dim=-1).all(dim=-1)               # [B, 4]
    pc = torch.where(bad[..., None, None], pw, pc)
    r, t = _procrustes(pw.reshape(b * 4, 3, 3), pc.reshape(b * 4, 3, 3))
    r = torch.where(bad[..., None, None], float("nan"), r.reshape(b, 4, 3, 3))
    t = torch.where(bad[..., None], float("nan"), t.reshape(b, 4, 3))
    return r, t
