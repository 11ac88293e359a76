"""A numpy model of kernel K6's Jacobi `eigh` (`csrc/small_linalg.cu`),
held against the JAX package's `jnp.linalg.eigh` (x64 on the CPU).

The kernel cannot run here (no nvcc, no GPU), so this model is the CPU
evidence of its algorithm. It follows the kernel's order of operations:

- the matrix padded to an even order m with a zero row and column (the
  idle index of an odd n);
- the round-robin pair tables of the m - 1 rounds of a sweep, round r
  pairing r with m - 1 and (r + k) with (r - k) mod (m - 1);
- the rotation of a pair from (a_pp, a_qq, a_pq), d = a_qq - a_pp and a_pq
  scaled by a power of two, by two inverse square roots and no division:
  rho = 1 / sqrt(d^2 + 4 a_pq^2), w = (|d| + 1 / rho) rho / 2 = c^2,
  g = 1 / sqrt(w), c = w g, s = sign(d) a_pq rho g, t = s g = tan; new
  diagonals a_pp - t a_pq and a_qq + t a_pq; a pair at or under its
  threshold is not rotated and its a_pq is dropped;
- a round as one pass over the 2x2 blocks of the round's pairs, A'[Pi, Pj]
  = Ji^T A[Pi, Pj] Jj (the block's right factor first), the diagonal
  blocks from the closed form, V <- V J; the next round's rotations from
  the new A;
- the stop: the block leaves the loop after the first round (or before the
  first) at which no off-diagonal is over its threshold: eps sqrt(|a_pp|)
  sqrt(|a_qq|) (graded, the PnP solvers) or eps ||A||_F (the PSD clip);
- the ascending order by rank (ties by index) and the canonical signs.

It computes in the matrix's own type (float32 for the PnP shapes, as the
kernel does). Eigenvalues are held within 1e-12 ||A|| (float64) and
1e-5 ||A|| (float32) of JAX's, eigenvectors through their projectors as
`tests/test_torch_small_linalg.py` holds the twins, at its CASES; a
diagonal input takes no round; the rounds a case takes are printed (`-s`).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from test_torch_small_linalg import CASES, F32_TOL, F64_TOL, _projectors, _rank_deficient, \
    _indefinite

MAX_SWEEPS = 30


def pair_tables(n):
    """(p [m - 1, m/2], q [m - 1, m/2]) of each round's pairs, p < q, with
    m = n rounded up to even; index n is the idle index of an odd n."""
    m = n + (n & 1)
    r = np.arange(m - 1)[:, None]
    k = np.arange(m // 2)[None, :]
    p = np.where(k == 0, r, (r + k) % (m - 1))
    q = np.where(k == 0, m - 1, (r - k + m - 1) % (m - 1))
    return np.minimum(p, q), np.maximum(p, q)


def _pow2_inverse(g):
    """2^-e with e the binary exponent of g (> 0), clamped to a normal
    number, as the kernel reads it from g's exponent bits."""
    _, e = np.frexp(g)
    info = np.finfo(g.dtype)
    return np.ldexp(np.ones_like(g), np.clip(1 - e, info.minexp, info.maxexp - 2))


def rotations(app, aqq, apq, over):
    """(c, s, new a_pp, new a_qq) of each pair; pairs not `over` their
    threshold keep c = 1, s = 0 and their diagonal."""
    dt = app.dtype
    one = dt.type(1)
    d = aqq - app
    f = _pow2_inverse(np.where(over, np.maximum(np.abs(d), dt.type(2) * np.abs(apq)), one))
    ds, as_ = np.where(over, d * f, 0), np.where(over, apq * f, 0)
    h = np.where(over, ds * ds + dt.type(4) * as_ * as_, one)     # in [1, 8]
    rho = one / np.sqrt(h)                                        # 1 / r
    w = dt.type(0.5) * (np.abs(ds) + h * rho) * rho               # c^2 = (|d| + r) / 2r
    g = one / np.sqrt(w)                                          # 1 / c
    c = np.where(over, w * g, one)
    s = np.where(over, np.where(ds >= 0, as_, -as_) * rho * g, dt.type(0))
    t = s * g
    return c, s, app - t * apq, aqq + t * apq


def model_eigh(a, graded=True, empty_sweep_stop=False):
    """(w [B, n] ascending, v [B, n, n] as columns, rounds [B]) of the
    symmetric a [B, n, n] (its lower triangle) by the kernel's algorithm.
    `empty_sweep_stop` stops as the kernel's first form did instead: after
    the first whole sweep that rotates no pair, that sweep counted."""
    dt = a.dtype
    bsz, n = a.shape[0], a.shape[-1]
    m, eps = n + (n & 1), np.finfo(dt).eps
    low = np.tril(a)
    A = np.zeros((bsz, m, m), dt)
    A[:, :n, :n] = low + np.swapaxes(np.tril(a, -1), 1, 2)
    V = np.broadcast_to(np.eye(m, dtype=dt), A.shape).copy()
    tol = None if graded else dt.type(eps) * np.sqrt((A * A).sum((1, 2)))
    P, Q = pair_tables(n)
    off = ~np.eye(m, dtype=bool)

    def over_threshold(x, diag):
        if graded:
            g = np.sqrt(np.abs(diag))
            return np.abs(x) > dt.type(eps) * g[..., :, None] * g[..., None, :]
        return np.abs(x) > tol[:, None, None]

    def next_rotations(A, r):
        p, q = P[r], Q[r]
        app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
        if graded:
            over = np.abs(apq) > dt.type(eps) * np.sqrt(np.abs(app)) * np.sqrt(np.abs(aqq))
        else:
            over = np.abs(apq) > tol[:, None]
        return rotations(app, aqq, apq, over), over

    busy = (over_threshold(A, np.diagonal(A, axis1=1, axis2=2)) & off).any((1, 2))
    busy &= np.isfinite(A).all((1, 2))
    rounds = np.zeros(bsz, int)
    rot, over = next_rotations(A, 0)
    swept = np.zeros(bsz, bool)             # a pair of this sweep was rotated
    r = 0
    for _ in range(MAX_SWEEPS * (m - 1)):
        if not busy.any():
            break
        c, s, dp, dq = rot
        perm = np.stack([P[r], Q[r]], 1).reshape(-1)          # [p0, q0, p1, q1, ...]
        J = np.zeros(c.shape + (2, 2), dt)                      # [B, half, 2, 2]
        J[..., 0, 0], J[..., 0, 1], J[..., 1, 0], J[..., 1, 1] = c, s, -s, c
        half = m // 2
        blk = A[:, perm][:, :, perm].reshape(bsz, half, 2, half, 2)
        # the right factor first: x = B Jj, then Ji^T x
        x = (blk[..., :, :, :, 0, None] * J[:, None, None, :, 0, :]
             + blk[..., :, :, :, 1, None] * J[:, None, None, :, 1, :])
        new = (J[:, :, 0, :, None, None] * x[:, :, None, 0]
               + J[:, :, 1, :, None, None] * x[:, :, None, 1])
        # new[b, i, a, j, c]: rows of block (i, j) from Ji^T; i <= j kept
        # and mirrored, as the kernel writes a block and its transpose
        ii, jj = np.triu_indices(half, 1)
        new[:, jj, :, ii, :] = np.swapaxes(new[:, ii, :, jj, :], -1, -2)
        d = np.arange(half)
        new[:, d, :, d, :] = 0
        new[:, d, 0, d, 0], new[:, d, 1, d, 1] = dp, dq
        out = np.empty_like(A)
        out[:, perm[:, None], perm[None, :]] = new.reshape(bsz, m, m)
        vp, vq = V[:, :, P[r]], V[:, :, Q[r]]
        vnew = V.copy()
        vnew[:, :, P[r]] = c[:, None] * vp - s[:, None] * vq
        vnew[:, :, Q[r]] = s[:, None] * vp + c[:, None] * vq
        A = np.where(busy[:, None, None], out, A)
        V = np.where(busy[:, None, None], vnew, V)
        rounds += busy
        swept |= over.any(1)
        r = r + 1 if r + 1 < m - 1 else 0
        if not empty_sweep_stop:
            busy &= (over_threshold(A, np.diagonal(A, axis1=1, axis2=2)) & off).any((1, 2))
        elif r == 0:
            busy &= swept
            swept[:] = False
        rot, over = next_rotations(A, r)
    diag = np.diagonal(A, axis1=1, axis2=2)[:, :n]
    order = np.argsort(diag, axis=1, kind="stable")
    w = np.take_along_axis(diag, order, 1)
    v = np.take_along_axis(V[:, :n, :n], order[:, None, :], 2)
    lead = np.take_along_axis(v, np.argmax(np.abs(v), 1)[:, None, :], 1)
    v = v * np.where(lead < 0, -1, 1).astype(dt)
    bad = ~np.isfinite(a).all((1, 2))
    w[bad], v[bad] = np.nan, np.nan
    return w, v, rounds


def _check(a, w, v):
    f64 = a.dtype == np.float64
    tol = F64_TOL if f64 else F32_TOL
    jw, jv = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(a, jnp.float64)))
    for i in range(a.shape[0]):
        norm = np.linalg.norm(a[i].astype(np.float64))
        np.testing.assert_allclose(w[i], jw[i], atol=tol * norm, rtol=0)
        assert np.all(np.diff(w[i]) >= 0)
        cols = v[i].T
        lead = cols[np.arange(len(cols)), np.argmax(np.abs(cols), axis=1)]
        assert np.all(lead > 0)
        gap = 1e-7 * norm if f64 else 1e-4 * norm
        mine = _projectors(w[i].astype(np.float64), v[i].astype(np.float64), gap)
        ref = _projectors(jw[i], jv[i], gap)
        assert len(mine) == len(ref), i
        for (_, p), (_, q) in zip(mine, ref):
            np.testing.assert_allclose(p, q, atol=1e-9 if f64 else 1e-3, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case):
    """The graded stop (the kernel's default) at every case of the twins'
    test, on the same seeded inputs."""
    a = CASES[case](np.random.default_rng(list(CASES).index(case)))
    w, v, rounds = model_eigh(a, graded=True)
    m = a.shape[-1] + (a.shape[-1] & 1)
    print(f"K6 model {case} graded: sweeps {np.unique(rounds / (m - 1)).round(2)}")
    _check(a, w, v)


def test_model_clip_stop():
    """The clip's stop at eps ||A||_F on the clip's inputs (rank 30 of 45
    over three decades with a small indefinite part, as
    `chip_smoke.k6_inputs` builds them): eigenvalues within 1e-12 ||A|| of
    JAX's, the clipped matrix within 1e-12 ||A|| of numpy's, and the
    rounds each matrix takes printed for PERF.md."""
    rng = np.random.default_rng(21)
    a = _rank_deficient(rng, 8, 45, 30) + 1e-3 * _indefinite(rng, 8, 45)
    w, v, rounds = model_eigh(a, graded=False)
    _, _, former = model_eigh(a, graded=False, empty_sweep_stop=True)
    # dependent passes a matrix: the load and the first stop test, then one
    # a round; the first form: the load, then three a round
    print(f"K6 model clip [8, 45, 45] eps ||A||_F: rounds {rounds.tolist()}, sweeps "
          f"{(rounds / 45).round(2).tolist()}, dependent passes {(rounds + 2).tolist()}; "
          f"stopping after an empty sweep, three passes a round: rounds {former.tolist()}, "
          f"passes {(3 * former + 1).tolist()}")
    assert (former > rounds).all()
    jw = np.asarray(jnp.linalg.eigh(jnp.asarray(a))[0])
    for i in range(a.shape[0]):
        norm = np.linalg.norm(a[i])
        np.testing.assert_allclose(w[i], jw[i], atol=F64_TOL * norm, rtol=0)
        ew, ev = np.linalg.eigh(a[i])
        ref = (ev * np.maximum(ew, 0)) @ ev.T
        got = (v[i] * np.maximum(w[i], 0)) @ v[i].T
        assert np.linalg.norm(got - ref) <= F64_TOL * norm
    assert (rounds > 0).all() and (rounds < 15 * 45).all()


@pytest.mark.parametrize("graded", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 12, 45])
def test_diagonal_takes_no_round(n, graded):
    """A diagonal input (the identity's Schur complement on the frames that
    marginalize nothing) leaves before its first round, eigenvalues sorted
    and eigenvectors the permuted identity."""
    d = np.random.default_rng(n).normal(size=(2, n))
    d[1] = 0.99 * np.ones(n)                   # the forgotten identity, marg_forget < 1
    a = np.stack([np.diag(x) for x in d])
    w, v, rounds = model_eigh(a, graded=graded)
    assert (rounds == 0).all()
    np.testing.assert_array_equal(w, np.sort(d, axis=1))
    for i in range(2):
        np.testing.assert_array_equal(np.abs(v[i]).sum(0), np.ones(n))


def test_scaled_extremes():
    """The rotation's scaling: matrices near the overflow and underflow
    ends of float64 and float32 give the eigenvalues of their unscaled
    copies scaled, where d^2 + 4 a_pq^2 unscaled would overflow or
    vanish."""
    rng = np.random.default_rng(5)
    base = _indefinite(rng, 4, 12)
    w0, _, _ = model_eigh(base)
    for dt, scales in ((np.float64, (2.0 ** 900, 2.0 ** -900)), (np.float32, (2.0 ** 100,
                                                                              2.0 ** -100))):
        for sc in scales:
            w, v, _ = model_eigh((base * sc).astype(dt))
            assert np.isfinite(w).all() and np.isfinite(v).all()
            tol = (F64_TOL if dt == np.float64 else F32_TOL) * np.linalg.norm(base, axis=(1, 2))
            assert (np.abs(w.astype(np.float64) / sc - w0).max(1) <= tol).all()


def test_nan_in_nan_out():
    a = _indefinite(np.random.default_rng(3), 3, 6)
    a[1, 2, 0] = np.nan
    w, v, rounds = model_eigh(a)
    assert np.isnan(w[1]).all() and np.isnan(v[1]).all() and rounds[1] == 0
    assert np.isfinite(w[[0, 2]]).all() and np.isfinite(v[[0, 2]]).all()
