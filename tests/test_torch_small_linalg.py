"""Kernel K6's twins (`ops/small_linalg.py`) against the JAX package's
`jnp.linalg.eigh` and `svd` (x64 on the CPU), and the solves built on them.

Inputs are made from numpy with a seed: symmetric positive definite,
rank-deficient (a 45x45 float64 Schur-like matrix with zero eigenvalues)
and indefinite matrices at every shape the port's paths give K6 (the
DLT's and EPnP's [512, 12, 12] and [512, 3, 3] in float32, the clip's
[45, 45] and [B, 45, 45] in float64), and 3x3 matrices of rank 3 and 2.

- Eigenvalues within 1e-5 ||A|| in float32 and 1e-12 ||A|| in float64
  (the JAX side runs in float64 on the float32 inputs).
- Eigenvectors through their projectors V V^T per cluster of equal
  eigenvalues (a cluster's basis is free), within 1e-3 in float32 (the
  smallest gap of these inputs over ||A|| is ~1e-2; a projector moves by
  eps / gap) and 1e-9 in float64; and the contract's signs.
- U S Vh against A, U and V orthonormal, S against JAX's; the proper
  rotation of `ops/pnp.py:_proper_rotation` against JAX's rotation
  U diag(1, 1, det) Vt, a rotation also at rank 2.
- The PSD clip (`backend/ba.py:psd_clip`) against a numpy clip.
- NaN in, NaN out.

The kernel itself is held to the twins by the `cuda`-marked tests (skipped
without a GPU; the SVD also on `SVD_CASES`: ranks 3, 2 and 1, near-repeated
singular values, entries near 1e15 and 1e-15, diagonal, NaN, which
`tests/test_torch_svd3_model.py` runs through a numpy model of the kernel)
and by `chip_smoke.py` phase 3b.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pose_estimation_tpu_torch.backend import ba as tba  # noqa: E402
from pose_estimation_tpu_torch.ops import pnp as tpnp  # noqa: E402
from pose_estimation_tpu_torch.ops import small_linalg  # noqa: E402

F32_TOL, F64_TOL = 1e-5, 1e-12


def _spd(rng, b, n):
    x = rng.normal(size=(b, n, n))
    return x @ x.transpose(0, 2, 1) + 0.1 * np.eye(n)


def _rank_deficient(rng, b, n, rank):
    """Schur-like: a Gram matrix of `rank` columns, scaled over decades as
    an information matrix's blocks are."""
    x = rng.normal(size=(b, n, rank)) * np.logspace(0, 3, n)[None, :, None]
    return x @ x.transpose(0, 2, 1)


def _indefinite(rng, b, n):
    x = rng.normal(size=(b, n, n))
    return x + x.transpose(0, 2, 1)


CASES = {
    "spd-12-f32": lambda r: _spd(r, 64, 12).astype(np.float32),
    "indefinite-12-f32": lambda r: _indefinite(r, 64, 12).astype(np.float32),
    "spd-3-f32": lambda r: _spd(r, 64, 3).astype(np.float32),
    "rank2-3-f32": lambda r: _rank_deficient(r, 64, 3, 2).astype(np.float32),
    "schur-45-f64": lambda r: _rank_deficient(r, 4, 45, 30),
    "indefinite-45-f64": lambda r: _indefinite(r, 4, 45),
    "spd-64-f64": lambda r: _spd(r, 2, 64),
}


def _projectors(w, v, tol):
    """[(eigenvalue, projector)] of each cluster of eigenvalues within tol."""
    out, start = [], 0
    for k in range(1, len(w) + 1):
        if k == len(w) or w[k] - w[k - 1] > tol:
            vk = v[:, start:k]
            out.append((w[start], vk @ vk.T))
            start = k
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_eigh_twin_matches_jax(case):
    a = CASES[case](np.random.default_rng(list(CASES).index(case)))
    f64 = a.dtype == np.float64
    tol = F64_TOL if f64 else F32_TOL
    w, v = (x.numpy() for x in small_linalg.eigh(torch.from_numpy(a)))
    jw, jv = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(a, jnp.float64)))
    for i in range(a.shape[0]):
        norm = np.linalg.norm(a[i].astype(np.float64))
        np.testing.assert_allclose(w[i], jw[i], atol=tol * norm, rtol=0)
        assert np.all(np.diff(w[i]) >= 0)
        # the contract's signs: each column's largest component is positive
        cols = v[i].T
        lead = cols[np.arange(len(cols)), np.argmax(np.abs(cols), axis=1)]
        assert np.all(lead > 0)
        gap = 1e-7 * norm if f64 else 1e-4 * norm
        mine = _projectors(w[i].astype(np.float64), v[i].astype(np.float64), gap)
        ref = _projectors(jw[i], jv[i], gap)
        assert len(mine) == len(ref), i
        for (_, p), (_, q) in zip(mine, ref):
            np.testing.assert_allclose(p, q, atol=1e-9 if f64 else 1e-3, rtol=0)


def _orthogonal(rng, b):
    q, r = np.linalg.qr(rng.normal(size=(b, 3, 3)))
    return q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]


def _with_singular_values(rng, b, s):
    """[b, 3, 3] matrices U diag(s) V^T of random orthogonal U and V."""
    return _orthogonal(rng, b) @ (np.asarray(s)[:, None] * _orthogonal(rng, b))


def _with_nan(rng, b):
    a = rng.normal(size=(b, 3, 3))
    a[1::3, rng.integers(3), rng.integers(3)] = np.nan
    a[2::5, 1, 2] = np.inf
    return a


# float32 [B, 3, 3] inputs of K6's svd: ranks 3, 2 and 1, near-repeated
# singular values (the first two, the last two, all three), entries near
# 1e15 and 1e-15 (squares finite in float32), diagonal, NaN and infinity
SVD_CASES = {
    "rank3": lambda r: r.normal(size=(256, 3, 3)).astype(np.float32),
    "rank2": lambda r: (r.normal(size=(256, 3, 2)) @ r.normal(size=(256, 2, 3)))
    .astype(np.float32),
    "rank1": lambda r: (r.normal(size=(256, 3, 1)) @ r.normal(size=(256, 1, 3)))
    .astype(np.float32),
    "repeated12": lambda r: _with_singular_values(r, 256, [1.0, 1.0 - 1e-6, 0.3])
    .astype(np.float32),
    "repeated23": lambda r: _with_singular_values(r, 256, [1.0, 0.3, 0.3 * (1 + 1e-6)])
    .astype(np.float32),
    "repeated123": lambda r: _with_singular_values(r, 256, [1.0, 1.0 + 1e-7, 1.0 - 1e-7])
    .astype(np.float32),
    "big": lambda r: (1e15 * r.normal(size=(64, 3, 3))).astype(np.float32),
    "small": lambda r: (1e-15 * r.normal(size=(64, 3, 3))).astype(np.float32),
    "diagonal": lambda r: np.stack([np.diag(x) for x in r.normal(size=(32, 3))])
    .astype(np.float32),
    "nan": lambda r: _with_nan(r, 32).astype(np.float32),
}


def _svd_cases(rng):
    full = rng.normal(size=(256, 3, 3))
    low = rng.normal(size=(256, 3, 2)) @ rng.normal(size=(256, 2, 3))
    return {"rank3": full.astype(np.float32), "rank2": low.astype(np.float32)}


@pytest.mark.parametrize("rank", ["rank3", "rank2"])
def test_svd_twin_matches_jax(rank):
    a = _svd_cases(np.random.default_rng(7))[rank]
    u, s, vh = (x.numpy().astype(np.float64) for x in small_linalg.svd(torch.from_numpy(a)))
    a64 = a.astype(np.float64)
    ju, js, jvt = (np.asarray(x) for x in jnp.linalg.svd(jnp.asarray(a64)))
    eye = np.eye(3)
    for i in range(a.shape[0]):
        norm = np.linalg.norm(a64[i])
        np.testing.assert_allclose(s[i], js[i], atol=F32_TOL * norm, rtol=0)
        np.testing.assert_allclose(u[i] @ np.diag(s[i]) @ vh[i], a64[i], atol=F32_TOL * norm,
                                   rtol=0)
        np.testing.assert_allclose(u[i].T @ u[i], eye, atol=1e-5)
        np.testing.assert_allclose(vh[i] @ vh[i].T, eye, atol=1e-5)
        assert np.all(np.diff(s[i]) <= 0)
        lead = vh[i][np.arange(3), np.argmax(np.abs(vh[i]), axis=1)]
        assert np.all(lead > 0)
    # the proper rotation against JAX's U diag(1, 1, det(U Vt)) Vt
    r, _, _ = tpnp._proper_rotation(torch.from_numpy(a))
    r = r.numpy().astype(np.float64)
    det = np.linalg.det(ju @ jvt)
    jr = ju @ (np.stack([np.ones_like(det), np.ones_like(det), det], -1)[..., None] * jvt)
    for i in range(a.shape[0]):
        np.testing.assert_allclose(r[i].T @ r[i], eye, atol=1e-5)
        assert abs(np.linalg.det(r[i]) - 1.0) < 1e-5
        if rank == "rank3":
            # at rank 2 the rotation is free about the null direction's sign
            # pair; at rank 3 it is the nearest rotation, unique
            np.testing.assert_allclose(r[i], jr[i], atol=1e-4)


@pytest.mark.parametrize("batch", [None, 3])
def test_psd_clip_matches_numpy(batch):
    """The clip of [45, 45] and [B, 45, 45] float32 Schur complements (an
    indefinite part added, as float32 rounding makes it), in float64,
    against a numpy clip within 1e-12 ||S||."""
    rng = np.random.default_rng(11)
    n = 1 if batch is None else batch
    s = _rank_deficient(rng, n, 45, 30) + 1e-3 * _indefinite(rng, n, 45)
    s = s.astype(np.float32)
    got = tba.psd_clip(torch.from_numpy(s[0] if batch is None else s)).numpy()
    got = got[None] if batch is None else got
    for i in range(n):
        w, v = np.linalg.eigh(s[i].astype(np.float64))
        ref = (v * np.maximum(w, 0.0)) @ v.T
        norm = np.linalg.norm(s[i].astype(np.float64))
        # the clip's float64 result is rounded to float32 on the way out
        np.testing.assert_allclose(got[i], ref, atol=1e-12 * norm + 2e-7 * np.abs(ref).max(),
                                   rtol=0)
        assert np.linalg.eigvalsh(got[i].astype(np.float64)).min() >= -1e-6 * norm


def test_nan_in_nan_out():
    a = np.random.default_rng(3).normal(size=(4, 3, 3)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    a[1, 0, 0] = np.nan
    w, v = small_linalg.eigh(torch.from_numpy(a))
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    assert torch.isfinite(w[[0, 2, 3]]).all() and torch.isfinite(v[[0, 2, 3]]).all()
    u, s, vh = small_linalg.svd(torch.from_numpy(a))
    assert all(torch.isnan(x[1]).all() for x in (u, s, vh))
    assert all(torch.isfinite(x[[0, 2, 3]]).all() for x in (u, s, vh))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_twin(cuda, case):
    """K6 against its twin at the shapes of the paths: eigenvalues within
    the stated tolerance of ||A||, the residual ||A V - V diag(w)|| and
    ||V^T V - I||; the SVD's reconstruction."""
    a = torch.from_numpy(CASES[case](np.random.default_rng(0)))
    tol = F64_TOL if a.dtype == torch.float64 else F32_TOL
    w, v = small_linalg.eigh(a.to(cuda))
    torch.cuda.synchronize()
    pw, _ = small_linalg.eigh_plain(a)
    norm = torch.linalg.matrix_norm(a.double())[:, None]
    assert ((w.cpu().double() - pw.double()).abs() <= tol * norm).all()
    a64, w64, v64 = a.double(), w.cpu().double(), v.cpu().double()
    res = torch.linalg.matrix_norm(a64 @ v64 - v64 * w64[:, None, :])
    assert (res <= 10 * tol * norm[:, 0]).all()
    eye = torch.eye(a.shape[-1], dtype=torch.float64)
    assert (v64.transpose(-1, -2) @ v64 - eye).abs().max() <= 100 * tol
    if a.shape[-1] == 3 and a.dtype == torch.float32:
        u, s, vh = small_linalg.svd(a.to(cuda))
        rec = (u * s[..., None, :]) @ vh
        assert ((rec.cpu().double() - a64).abs().amax((-2, -1)) <= 10 * tol * norm[:, 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SVD_CASES))
def test_svd_kernel_matches_twin(cuda, case):
    """K6's svd against its twin on the model's matrices (the
    `chip_smoke.py` phase 3b tolerances): S within 1e-5 ||A|| of the
    twin's, ||U S Vh - A|| within 1e-5 ||A||, U and V orthonormal within
    1e-4, S descending, V canonical; NaN for a non-finite matrix."""
    a = torch.from_numpy(SVD_CASES[case](np.random.default_rng(list(SVD_CASES).index(case))))
    u, s, vh = (x.cpu().double() for x in small_linalg.svd(a.to(cuda)))
    pu, ps, pvh = (x.double() for x in small_linalg.svd_plain(a))
    bad = ~torch.isfinite(a).all(-1).all(-1)
    assert all(torch.isnan(x[bad]).all() for x in (u, s, vh))
    a64, live = a.double()[~bad], ~bad
    u, s, vh, ps = u[live], s[live], vh[live], ps[live]
    norm = torch.linalg.matrix_norm(a64)
    assert ((s - ps).abs().amax(-1) <= F32_TOL * norm).all()
    rec = (u * s[..., None, :]) @ vh
    assert ((rec - a64).abs().amax((-2, -1)) <= F32_TOL * norm).all()
    eye = torch.eye(3, dtype=torch.float64)
    assert (u.transpose(-1, -2) @ u - eye).abs().max() <= 1e-4
    assert (vh @ vh.transpose(-1, -2) - eye).abs().max() <= 1e-4
    assert (s[:, :-1] >= s[:, 1:]).all()
    lead = torch.gather(vh, 2, vh.abs().argmax(2, keepdim=True))
    assert (lead > 0).all()
