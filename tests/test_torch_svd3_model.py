"""A numpy model of kernel K6's 3x3 SVD (`svd3_kernel`,
`csrc/small_linalg.cu`), held against the JAX package's `jnp.linalg.svd`
(x64 on the CPU) and against the contract of its twin
(`ops/small_linalg.py:svd_plain`).

The kernel cannot run here (no nvcc, no GPU), so this model is the CPU
evidence of its algorithm. It follows the kernel's order of operations in
float32, a fused multiply-add as one rounding:

- one-sided Jacobi on the columns of W = A V, V from the identity, a fixed
  count of cyclic sweeps (`SVD_SWEEPS`, read from the kernel's source) of
  the pairs (0, 1), (0, 2), (1, 2), with no data-dependent exit;
- each rotation from the Gram entries (|w_p|^2, |w_q|^2, w_p . w_q)
  recomputed from W: d = |w_q|^2 - |w_p|^2 and w_p . w_q scaled by a power
  of two, rho = rsqrt(d^2 + 4 g^2), w = (|d| + h rho) rho / 2 = c^2,
  g' = rsqrt(w), c = w g', s = sign(d) g rho g'; the identity, by a
  select, for a pair no further from orthogonal than eps;
- S the columns' norms, the descending stable sort as three
  compare-and-swaps, V's canonical signs, U completed as the contract says.

The inputs (`test_torch_small_linalg.SVD_CASES`): rank 3, 2 and 1,
near-repeated singular values, entries near 1e15 and 1e-15 (whose squares
stay finite in float32), a diagonal input (every rotation the identity,
so V is a permutation) and NaN. S and U S V^T are held within 1e-5 ||A||
of JAX's, U and V orthonormal within 1e-5; the sweeps each case needs to
reach the float32 floor are printed (`-s`).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu_torch.ops import small_linalg  # noqa: E402
from test_torch_small_linalg import F32_TOL, SVD_CASES  # noqa: E402

SOURCE = (Path(__file__).resolve().parents[1] / "pose_estimation_tpu_torch" / "csrc"
          / "small_linalg.cu")
SVD_SWEEPS = int(re.search(r"constexpr int SVD_SWEEPS = (\d+);", SOURCE.read_text()).group(1))
F32 = np.float32
EPS = F32(np.finfo(np.float32).eps)


def _fma(a, b, c):
    """a b + c rounded once to float32 (the product of two float32 values
    is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _dot(a, b):
    """The kernel's dot3 of [..., 3] columns: fma(x, x', fma(y, y', z z'))."""
    return _fma(a[..., 0], b[..., 0], _fma(a[..., 1], b[..., 1], a[..., 2] * b[..., 2]))


def _pow2_inverse(g):
    """2^-e for the binary exponent e of g >= 0, from its exponent bits,
    clamped to a normal number."""
    e = (g.astype(F32).view(np.int32) >> 23) & 0xFF
    return (np.clip(254 - e, 1, 253).astype(np.int32) << 23).view(F32)


def _rsqrt(x):
    with np.errstate(divide="ignore", invalid="ignore"):
        return (F32(1) / np.sqrt(x)).astype(F32)


def _rotate(x, y, c, s):
    """(x c - y s, x s + y c) as the kernel's rot_lo and rot_hi round them."""
    c, s = c[..., None], s[..., None]
    return _fma(x, c, -(y * s)), _fma(x, s, y * c)


def rotation(wp, wq):
    """(c, s, over) of the pair of columns wp, wq [B, 3]."""
    al, be, ga = _dot(wp, wp), _dot(wq, wq), _dot(wp, wq)
    with np.errstate(all="ignore"):
        f2 = _pow2_inverse(np.maximum(al, be))
        gs2 = ga * f2
        over = gs2 * gs2 > (EPS * EPS) * (al * f2) * (be * f2)
        d = be - al
        f = _pow2_inverse(np.maximum(np.abs(d), F32(2) * np.abs(ga)))
        ds, gs = d * f, ga * f
        h = _fma(ds, ds, F32(4) * gs * gs)
        rho = _rsqrt(h)
        w = F32(0.5) * _fma(h, rho, np.abs(ds)) * rho
        g = _rsqrt(w)
        c = np.where(over, w * g, F32(1)).astype(F32)
        s = np.where(over, np.where(ds >= 0, gs, -gs) * rho * g, F32(0)).astype(F32)
    return c, s, over


def jacobi(a, sweeps=SVD_SWEEPS):
    """(W [B, 3, 3] as columns w_k = A v_k, V [B, 3, 3] as columns, rotations
    [B] that were not the identity) after `sweeps` cyclic sweeps."""
    w = [a[:, :, k].astype(F32) for k in range(3)]
    v = [np.broadcast_to(np.eye(3, dtype=F32)[k], (a.shape[0], 3)).copy() for k in range(3)]
    rotated = np.zeros(a.shape[0], int)
    with np.errstate(all="ignore"):
        for _ in range(sweeps):
            for p, q in ((0, 1), (0, 2), (1, 2)):
                c, s, over = rotation(w[p], w[q])
                w[p], w[q] = _rotate(w[p], w[q], c, s)
                v[p], v[q] = _rotate(v[p], v[q], c, s)
                rotated += over
    return np.stack(w, -1), np.stack(v, -1), rotated


def model_svd3(a, sweeps=SVD_SWEEPS):
    """(U, S, Vh, rotations) of float32 a [B, 3, 3] by the kernel's order of
    operations."""
    a = a.astype(F32)
    wm, vm, rotated = jacobi(a, sweeps)
    with np.errstate(all="ignore"):
        s = [np.sqrt(_dot(wm[..., k], wm[..., k])) for k in range(3)]
        v = [vm[..., k] for k in range(3)]
        for i, j in ((0, 1), (1, 2), (0, 1)):
            sw = s[j] > s[i]
            s[i], s[j] = np.where(sw, s[j], s[i]), np.where(sw, s[i], s[j])
            v[i], v[j] = (np.where(sw[:, None], v[j], v[i]),
                          np.where(sw[:, None], v[i], v[j]))
        for k in range(3):
            x = v[k]
            lead = x[:, 0]
            lead = np.where(np.abs(x[:, 1]) > np.abs(lead), x[:, 1], lead)
            lead = np.where(np.abs(x[:, 2]) > np.abs(lead), x[:, 2], lead)
            v[k] = np.where((lead < 0)[:, None], -x, x)
        y = [_dot(a, v[k][:, None, :]) for k in range(3)]        # rows of A . v_k
        n1 = _dot(y[0], y[0])
        u0 = np.where((n1 > 0)[:, None], y[0] * _rsqrt(n1)[:, None], np.eye(3, dtype=F32)[0])
        d12 = _dot(u0, y[1])
        r1 = _fma(-d12[:, None], u0, y[1])
        n2 = _dot(r1, r1)
        axis = np.where((np.abs(u0[:, 1]) < np.abs(u0[:, 0]))[:, None],
                        np.eye(3, dtype=F32)[1], np.eye(3, dtype=F32)[0])
        least = np.minimum(np.abs(u0[:, 0]), np.abs(u0[:, 1]))
        axis = np.where((np.abs(u0[:, 2]) < least)[:, None], np.eye(3, dtype=F32)[2], axis)
        side = np.cross(u0, axis).astype(F32)
        u1 = np.where((n2 > F32(64) * EPS * EPS * n1)[:, None], r1 * _rsqrt(n2)[:, None],
                      side * _rsqrt(_dot(side, side))[:, None])
        u2 = np.cross(u0, u1).astype(F32)
        u2 = np.where((_dot(u2, y[2]) < 0)[:, None], -u2, u2)
    bad = ~np.isfinite(a).all((1, 2))
    u = np.stack([u0, u1, u2], -1)
    vh = np.stack(v, 1)
    s = np.stack(s, -1)
    u[bad], s[bad], vh[bad] = np.nan, np.nan, np.nan
    return u, s, vh, rotated


def _orthogonality(wm):
    """The largest |w_p . w_q| / ||A||^2 over the column pairs of W."""
    w64 = wm.astype(np.float64)
    g = np.swapaxes(w64, 1, 2) @ w64
    scale = np.trace(g, axis1=1, axis2=2)
    off = np.abs(g - g * np.eye(3))
    return (off.max((1, 2)) / np.where(scale > 0, scale, 1)).max()


@pytest.mark.parametrize("case", [c for c in SVD_CASES if c != "nan"])
def test_model_matches_jax(case):
    a = SVD_CASES[case](np.random.default_rng(list(SVD_CASES).index(case)))
    u, s, vh, _ = model_svd3(a)
    a64 = a.astype(np.float64)
    js = np.asarray(jnp.linalg.svd(jnp.asarray(a64), compute_uv=False))
    norm = np.linalg.norm(a64, axis=(1, 2))
    u64, s64, vh64 = u.astype(np.float64), s.astype(np.float64), vh.astype(np.float64)
    eye = np.eye(3)
    assert (np.abs(s64 - js).max(1) <= F32_TOL * norm).all()
    rec = (u64 * s64[:, None, :]) @ vh64
    assert (np.abs(rec - a64).max((1, 2)) <= F32_TOL * norm).all()
    assert np.abs(np.swapaxes(u64, 1, 2) @ u64 - eye).max() <= 1e-5
    assert np.abs(vh64 @ np.swapaxes(vh64, 1, 2) - eye).max() <= 1e-5
    assert (np.diff(s64, axis=1) <= 0).all()
    # V's columns canonical; u1 = A v1 / |A v1|; U a rotation or a reflection
    lead = np.take_along_axis(vh64, np.argmax(np.abs(vh64), 2)[..., None], 2)
    assert (lead > 0).all()
    y1 = a64 @ vh64[:, 0, :, None]
    n1 = np.linalg.norm(y1[..., 0], axis=1)
    live = n1 > 0
    np.testing.assert_allclose(u64[live, :, 0], y1[live, :, 0] / n1[live, None], atol=1e-5)
    assert np.allclose(np.abs(np.linalg.det(u64)), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", [c for c in SVD_CASES if c not in ("nan", "diagonal")])
def test_model_against_twin(case):
    """The model's S within 1e-5 ||A|| of the twin's; where the twin's
    singular values are apart by more than 1e-3 ||A||, its V's columns
    equal (both canonical) and U within 1e-3."""
    a = SVD_CASES[case](np.random.default_rng(list(SVD_CASES).index(case)))
    u, s, vh, _ = model_svd3(a)
    pu, ps, pvh = (x.numpy().astype(np.float64) for x in small_linalg.svd(torch.from_numpy(a)))
    norm = np.linalg.norm(a.astype(np.float64), axis=(1, 2))
    assert (np.abs(s - ps).max(1) <= F32_TOL * norm).all()
    gaps = np.abs(np.diff(ps, axis=1)).min(1) / norm
    apart = (gaps > 1e-3) & (ps[:, -1] > 1e-3 * norm)
    if apart.any():
        np.testing.assert_allclose(vh[apart], pvh[apart], atol=1e-3)
        np.testing.assert_allclose(u[apart], pu[apart], atol=1e-3)


def test_sweeps_reach_the_floor():
    """SVD_SWEEPS sweeps leave no pair of W's columns further from
    orthogonal than the float32 floor (~1e-7 ||A||^2) in any case, and
    fewer sweeps print how far they fall short (the count's reason, in the
    kernel's header)."""
    worst = {}
    for case, make in SVD_CASES.items():
        if case == "nan":
            continue
        a = make(np.random.default_rng(list(SVD_CASES).index(case))).astype(F32)
        by = [_orthogonality(jacobi(a, n)[0]) for n in range(2, SVD_SWEEPS + 1)]
        worst[case] = by
        assert by[-1] <= 4 * EPS, (case, by)
    print("K6 svd model: largest |w_p . w_q| / ||A||^2 after 2.."
          f"{SVD_SWEEPS} sweeps: " + "; ".join(
              f"{c} " + ", ".join(f"{x:.1e}" for x in v) for c, v in worst.items()))


def test_diagonal_takes_identity_rotations():
    """A diagonal input: every pair is orthogonal, so every rotation is the
    identity and V is a permutation; S is |d| sorted, exactly."""
    a = SVD_CASES["diagonal"](np.random.default_rng(0))
    u, s, vh, rotated = model_svd3(a)
    assert (rotated == 0).all()
    d = np.abs(np.diagonal(a, axis1=1, axis2=2))
    np.testing.assert_array_equal(s, -np.sort(-d, axis=1))
    np.testing.assert_array_equal(np.abs(vh).sum(1), np.ones((a.shape[0], 3)))
    np.testing.assert_array_equal(np.abs(vh).sum(2), np.ones((a.shape[0], 3)))


def test_nan_in_nan_out():
    a = SVD_CASES["nan"](np.random.default_rng(0))
    u, s, vh, _ = model_svd3(a)
    bad = ~np.isfinite(a).all((1, 2))
    assert bad.any() and (~bad).any()
    assert all(np.isnan(x[bad]).all() for x in (u, s, vh))
    assert all(np.isfinite(x[~bad]).all() for x in (u, s, vh))
    pu, ps, pvh = small_linalg.svd(torch.from_numpy(a))
    assert all(torch.isnan(x[torch.from_numpy(bad)]).all() for x in (pu, ps, pvh))
