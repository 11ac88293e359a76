"""PyTorch port vs the JAX package: the P3P minimal solver and the P3P
branch of the PnP RANSAC.

The same numpy samples go through both packages' `p3p_solve` (float32 on
both sides): the complex or behind-the-camera roots come out NaN at the
same places, and the finite solutions agree. `pnp_ransac(solver="p3p")`
takes the JAX draw's uniforms, so both packages score the same samples.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu.ops import p3p as jp3p  # noqa: E402
from pose_estimation_tpu.ops import pnp as jpnp  # noqa: E402
from pose_estimation_tpu.utils import lie as jlie  # noqa: E402
from pose_estimation_tpu_torch.ops import p3p as tp3p  # noqa: E402
from pose_estimation_tpu_torch.ops import pnp as tpnp  # noqa: E402
from pose_estimation_tpu_torch.ops.ransac import sample_indices  # noqa: E402

F32 = np.float32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs its files in parallel
    processes, and torch's default of a thread per core in each of them
    oversubscribes the machine (the state-machine runs here took ~8 s
    alone and ~600 s in a parallel run of the suite); the small tensors of
    these steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triplets(seed, n):
    """n exact triplets (obj [n, 3, 3], normalized image points [n, 3, 2])
    of random poses with the points in front of the camera, and the poses."""
    rng = np.random.default_rng(seed)
    objs, imgs, rs, ts = [], [], [], []
    while len(objs) < n:
        r = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.6)))
        t = rng.normal(size=3) * np.array([1.0, 1.0, 0.5]) + np.array([0, 0, 4.0])
        x = rng.normal(size=(3, 3)) * 2.0
        xc = x @ r.T + t
        img = xc[:, :2] / xc[:, 2:3]
        if np.all(xc[:, 2] > 0.5) and np.all(np.abs(img) < 1.5):
            objs.append(x), imgs.append(img), rs.append(r), ts.append(t)
    return (np.stack(objs).astype(F32), np.stack(imgs).astype(F32), np.stack(rs),
            np.stack(ts))


def test_quartic_roots_match_jax():
    """Ferrari + Newton on seeded quartics, some with complex pairs: NaN at
    the same roots, the real roots within 1e-4 relative (float32)."""
    rng = np.random.default_rng(0)
    coeffs = [rng.normal(size=256).astype(F32) for _ in range(5)]
    ref = np.asarray(jp3p._quartic_roots([jnp.asarray(c) for c in coeffs]))
    got = tp3p._quartic_roots([torch.from_numpy(c) for c in coeffs]).numpy()
    nan = np.isnan(ref)
    assert 0 < nan.sum() < nan.size                  # both kinds occur
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], ref[~nan], rtol=1e-4, atol=1e-4)
    for deg in (2, 3):                               # the coefficient products
        p = [rng.normal(size=4).astype(F32) for _ in range(deg)]
        q = [rng.normal(size=4).astype(F32) for _ in range(3)]
        ref_pq = jp3p._poly_mul([jnp.asarray(a) for a in p], [jnp.asarray(a) for a in q])
        got_pq = tp3p._poly_mul([torch.from_numpy(a) for a in p], [torch.from_numpy(a) for a in q])
        for a, b in zip(got_pq, ref_pq):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_p3p_solve_matches_jax():
    """200 exact triplets through both solvers in float32, with the JAX
    package in float64 as the reference for both. A root is NaN (complex,
    or a point behind the camera) in the port where it is NaN in the JAX
    package, except at a double root, where the sign of the pair's
    discriminant is float32 rounding: there the JAX package in float32 and
    in float64 disagree too, and such roots are left out (measured: 10 of
    800). The quartic is ill conditioned for some triplets, so float32
    solutions can sit 1e-2 from the float64 one in either package: at least
    90 % of the solutions both give agree within 2e-3 (measured: 92 %), and
    the port's error against float64 is, at its median, 90th and 95th
    percentiles, within 1.5x that of the JAX float32 solver (measured:
    1.00x, 1.02x, 1.15x for R). In float32 one solution of nearly every
    triplet is within 1e-2 of the true pose (R's Frobenius plus t's
    distance) in either package (measured: 189 and 188 of 200; the JAX
    package in float64: 200 within 1e-4)."""
    obj, img, rs, ts = _triplets(0, 200)
    solve = jax.jit(jp3p.p3p_solve)
    jr, jt = (np.asarray(a) for a in solve(jnp.asarray(obj), jnp.asarray(img)))
    jr64, jt64 = (np.asarray(a) for a in solve(jnp.asarray(obj, jnp.float64),
                                                jnp.asarray(img, jnp.float64)))
    tr, tt = (a.numpy() for a in tp3p.p3p_solve(torch.from_numpy(obj), torch.from_numpy(img)))
    assert tr.shape == (200, 4, 3, 3) and tt.shape == (200, 4, 3)

    def nan(r):
        return ~np.isfinite(r).all(axis=(-1, -2))

    bad, bad_t, bad64 = nan(jr), nan(tr), nan(jr64)
    settled = bad == bad64
    assert settled.sum() >= 0.95 * settled.size
    np.testing.assert_array_equal(bad_t[settled], bad[settled])
    assert bad.any() and not bad.all()
    both = ~bad & ~bad_t
    assert (np.abs(tr - jr).max(axis=(-1, -2))[both] <= 2e-3).mean() >= 0.9
    ref = both & ~bad64
    for got, jax32, f64 in ((tr, jr, jr64), (tt, jt, jt64)):
        axes = tuple(range(2, got.ndim))
        err_t = np.abs(got - f64).max(axis=axes)[ref]
        err_j = np.abs(jax32 - f64).max(axis=axes)[ref]
        for q in (50, 90, 95):
            assert np.percentile(err_t, q) <= 1.5 * np.percentile(err_j, q) + 1e-6, q

    def hits(r4, t4, invalid):
        err = (np.linalg.norm(r4 - rs[:, None], axis=(-1, -2))
               + np.linalg.norm(t4 - ts[:, None], axis=-1))
        return int((np.where(invalid, np.inf, err).min(axis=1) < 1e-2).sum())

    assert hits(tr, tt, bad_t) >= 185 and hits(jr, jt, bad) >= 185


@functools.lru_cache(maxsize=1)
def _pnp_problem():
    rng = np.random.default_rng(3)
    n = 220
    obj = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2.5, 11, n)], 1).astype(F32)
    rv, tv = np.array([0.02, -0.01, 0.015]), np.array([0.1, -0.03, 0.05])
    xc = obj @ np.asarray(jlie.so3_exp(jnp.asarray(rv))).T + tv
    k = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]], F32)
    px = xc[:, :2] / xc[:, 2:] * 260 + [160, 120] + rng.normal(0, 0.5, (n, 2))
    px[:40] += rng.uniform(-60, 60, (40, 2))            # outliers
    mask = np.ones(n, bool)
    mask[-12:] = False
    return obj, px.astype(F32), mask, k


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_p3p_matches_jax(seed):
    """The P3P branch with the JAX draw's uniforms: the same 128 x 3
    samples as `jax.random.choice`, the same inlier set and the pose
    within 1e-4 (rad, m)."""
    obj, px, mask, k = _pnp_problem()
    key = jax.random.PRNGKey(20 + seed)
    probs = mask.astype(F32) / F32(mask.sum())
    jidx = np.asarray(jax.random.choice(key, len(obj), shape=(128, 3), p=jnp.asarray(probs)))
    u = np.asarray(jax.random.uniform(key, (128, 3), dtype=jnp.float32))
    t = torch.from_numpy
    np.testing.assert_array_equal(sample_indices(t(mask), t(u)).numpy(), jidx)
    ref = jax.jit(functools.partial(jpnp.pnp_ransac, solver="p3p"))(
        jnp.asarray(obj), jnp.asarray(px), jnp.asarray(mask), jnp.asarray(k), key)
    got = tpnp.pnp_ransac(t(obj), t(px), t(mask), t(k), t(u), solver="p3p")
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 150
    np.testing.assert_allclose(got.rvec.numpy(), np.asarray(ref.rvec), atol=1e-4)
    np.testing.assert_allclose(got.tvec.numpy(), np.asarray(ref.tvec), atol=1e-4)


def test_nan_hypotheses_never_win():
    """A sample whose roots are all NaN scores no inlier, and hypotheses
    that are mostly NaN do not hide the one real sample: `argmax` over the
    integer counts never picks a NaN pose."""
    obj, px, mask, k = _pnp_problem()
    t = torch.from_numpy
    obj_t, px_t = t(obj), t(px)
    # the first point three times over: no triangle, every root NaN
    nan_r, _ = tp3p.p3p_solve(obj_t[[0, 0, 0]][None], (px_t[[0, 0, 0]][None] - 150) / 260.0)
    idx = torch.zeros((128, 3), dtype=torch.int64)
    idx[7] = torch.tensor([60, 120, 180])            # one real sample
    got = tpnp.pnp_ransac(obj_t, px_t, t(mask), t(k), None, solver="p3p", idx=idx)
    assert not torch.isfinite(nan_r).any()
    assert torch.isfinite(got.rvec).all() and int(got.n_inliers) > 150
    np.testing.assert_allclose(got.rvec.numpy(), [0.02, -0.01, 0.015], atol=1e-2)
