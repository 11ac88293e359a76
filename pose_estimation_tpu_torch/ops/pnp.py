"""Batched-hypothesis PnP RANSAC with Gauss-Newton refinement.

Counterpart of `pose_estimation_tpu/ops/pnp.py` (the SfM bootstrap's
`cv::solvePnPRansac`): 512 minimal-sample hypotheses solved at once by
DLT or EPnP (or 128 three-point samples solved by P3P, each giving its up
to 4 roots as hypotheses), scored against every correspondence with an
8-px gate, the one with the least truncated squared error (MSAC, where the
reference counts inliers) polished by two rounds of weighted Gauss-Newton
on its inliers. The returned (rvec, t) map object points into the camera
frame: x_cam = R(rvec) X + t.

The draw takes its uniforms `u` [samples, sample size] (`uniform_shape`)
or the index tensor `idx` itself as an argument; `ransac.sample_indices`
turns uniforms into the indices `jax.random.choice(key, n, shape,
p=mask)` draws.

Nothing here reads the device on the host, so a CUDA graph captures the
solve (`graphs.SolveGraphs`): the eigendecompositions and SVDs are K6
(`ops/small_linalg.py`), the inverse and the solves report a failure in
`info` (`inv_ex`, `solve_ex`) where `inv` and `solve` would check it on the
host (`torch.linalg.det` reads nothing back and stays).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pose_estimation_tpu_torch.ops import small_linalg
from pose_estimation_tpu_torch.ops.ransac import sample_indices
from pose_estimation_tpu_torch.utils import lie

N_HYPOTHESES = 512
SOLVER_SAMPLE_SIZE = {"dlt": 6, "epnp": 6, "p3p": 3}


def uniform_shape(solver: str) -> tuple[int, int]:
    """(samples, sample size) of the draw: P3P keeps the hypothesis budget
    with a quarter of the samples, each giving up to 4 roots."""
    sample = SOLVER_SAMPLE_SIZE[solver]
    return (N_HYPOTHESES // 4 if solver == "p3p" else N_HYPOTHESES), sample


class PnPResult(NamedTuple):
    rvec: torch.Tensor      # [3]
    tvec: torch.Tensor      # [3]
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor


def _proper_rotation(m):
    """(U diag(1, 1, det(U V^T)) V^T, singular values, that diagonal) of a
    batch of 3x3 matrices."""
    uu, ss, vt = small_linalg.svd(m)
    det = torch.linalg.det(uu @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return uu @ (d[..., None] * vt), ss, d


def _dlt_pose(obj, img_n):
    """Batched DLT pose from >= 6 points in normalized image coordinates.
    obj [B, M, 3], img_n [B, M, 2] -> R [B, 3, 3], t [B, 3]."""
    b, m, _ = obj.shape
    zeros = torch.zeros((b, m, 4), dtype=obj.dtype, device=obj.device)
    xh = torch.cat([obj, torch.ones((b, m, 1), dtype=obj.dtype, device=obj.device)], -1)
    u = img_n[..., 0:1]
    v = img_n[..., 1:2]
    row_u = torch.cat([xh, zeros, -u * xh], dim=-1)              # [B, M, 12]
    row_v = torch.cat([zeros, xh, -v * xh], dim=-1)
    a = torch.cat([row_u, row_v], dim=1)                         # [B, 2M, 12]
    _, vecs = small_linalg.eigh(torch.einsum("bij,bik->bjk", a, a))
    p = vecs[..., 0].reshape(b, 3, 4)
    # the null vector's sign is arbitrary, and for P = -|s| [R | t] the
    # proper rotation of -|s| R is R with a half turn: take the sign with
    # det(P[:, :3]) > 0, as OpenCV's DLT does (the JAX package does not, and
    # loses the hypotheses whose eigensolver returned the other sign)
    p = torch.where((torch.linalg.det(p[:, :, :3]) < 0)[:, None, None], -p, p)
    r, ss, d = _proper_rotation(p[:, :, :3])
    scale = torch.sum(ss * d, dim=-1) / 3.0
    safe = torch.where(scale.abs() < 1e-12, 1e-12, scale)
    t = p[:, :, 3] / safe[:, None]
    # cheirality on the centroid: negate the pose if it lands behind the
    # camera, then re-orthogonalize (-R has det -1)
    z = (lie.mv(r, torch.mean(obj, dim=1)) + t)[:, 2]
    flip = z < 0
    t = torch.where(flip[:, None], -t, t)
    r = torch.where(flip[:, None, None], -r, r)
    r, _, _ = _proper_rotation(r)
    return r, t


def _procrustes(src, dst):
    """Batched rigid alignment dst ~= R src + t. [B, M, 3] -> R, t."""
    mu_s = torch.mean(src, dim=1, keepdim=True)
    mu_d = torch.mean(dst, dim=1, keepdim=True)
    h = torch.einsum("bmi,bmj->bij", dst - mu_d, src - mu_s)
    r, _, _ = _proper_rotation(h)
    return r, mu_d[:, 0] - lie.mv(r, mu_s[:, 0])


def _epnp_pose(obj, img_n):
    """Batched EPnP pose from M >= 4 points: four control points (centroid
    plus principal axes), the null space of the 2M x 12 projection system,
    the N = 1, 2, 3 cases with scale from control-point distances and a
    cheirality flip, Procrustes for (R, t); the case with the lowest
    reprojection error on the sample wins. obj [B, M, 3], img_n [B, M, 2]."""
    b, m, _ = obj.shape
    dtype, dev = obj.dtype, obj.device
    c0 = torch.mean(obj, dim=1, keepdim=True)
    centered = obj - c0
    _, axes = small_linalg.eigh(torch.einsum("bmi,bmj->bij", centered, centered) / m)
    basis = axes.transpose(-1, -2)                               # rows = axes
    cw = torch.cat([c0, c0 + basis], dim=1)                      # [B, 4, 3]
    basis_inv = torch.linalg.inv_ex(basis + 1e-9 * torch.eye(3, dtype=dtype, device=dev))[0]
    a123 = torch.einsum("bij,bmj->bmi", basis_inv.transpose(-1, -2), centered)
    alpha = torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)

    u = img_n[..., 0:1]
    v = img_n[..., 1:2]
    zeros = torch.zeros((b, m, 4), dtype=dtype, device=dev)
    row_u = torch.stack([alpha, zeros, -u * alpha], dim=-1)     # [B, M, 4, 3]
    row_v = torch.stack([zeros, alpha, -v * alpha], dim=-1)
    mm = torch.cat([row_u.reshape(b, m, 12), row_v.reshape(b, m, 12)], dim=1)
    _, vecs = small_linalg.eigh(torch.einsum("bri,brj->bij", mm, mm))
    v1, v2, v3 = (vecs[..., k].reshape(b, 4, 3) for k in range(3))

    # the six pairs (i < j) of the four control points, made on the device
    pi, pj = torch.triu_indices(4, 4, 1, device=dev)

    def pair_diffs(q):                                           # [B, 6, 3]
        return q[:, pi] - q[:, pj]

    dw2 = torch.sum(pair_diffs(cw) ** 2, dim=-1)                 # [B, 6]
    d1, d2, d3 = pair_diffs(v1), pair_diffs(v2), pair_diffs(v3)

    def finish(cc):
        dc = torch.sqrt(torch.sum(pair_diffs(cc) ** 2, dim=-1) + 1e-18)
        dwr = torch.sqrt(dw2 + 1e-18)
        beta = torch.sum(dc * dwr, dim=1) / torch.clamp(torch.sum(dc * dc, dim=1), min=1e-18)
        cc = cc * beta[:, None, None]
        pts_cam = torch.einsum("bmj,bji->bmi", alpha, cc)
        flip = torch.mean(pts_cam[..., 2], dim=1) < 0
        return _procrustes(cw, torch.where(flip[:, None, None], -cc, cc))

    def lstsq(a, y):
        ata = torch.einsum("bki,bkj->bij", a, a)
        ata = ata + 1e-12 * torch.eye(a.shape[-1], dtype=dtype, device=dev)
        return torch.linalg.solve_ex(ata, torch.einsum("bki,bk->bi", a, y)[..., None])[0][..., 0]

    def dot(x, y):
        return torch.sum(x * y, dim=-1)

    cand = [finish(v1)]
    bb = lstsq(torch.stack([dot(d1, d1), 2.0 * dot(d1, d2), dot(d2, d2)], dim=-1), dw2)
    b1 = torch.sqrt(bb[:, 0].abs() + 1e-18)
    b2 = torch.sign(bb[:, 1]) * torch.sqrt(bb[:, 2].abs() + 1e-18)
    cand.append(finish(b1[:, None, None] * v1 + b2[:, None, None] * v2))
    l3 = torch.stack([dot(d1, d1), 2.0 * dot(d1, d2), 2.0 * dot(d1, d3),
                      dot(d2, d2), 2.0 * dot(d2, d3), dot(d3, d3)], dim=-1)
    b6 = lstsq(l3, dw2)
    c1 = torch.sqrt(b6[:, 0].abs() + 1e-18)
    safe_c1 = torch.where(c1 < 1e-9, 1e-9, c1)
    c2 = b6[:, 1] / safe_c1
    c3 = b6[:, 2] / safe_c1
    cand.append(finish(c1[:, None, None] * v1 + c2[:, None, None] * v2
                       + c3[:, None, None] * v3))

    best_r, best_t = cand[0]
    best_err = torch.full((b,), float("inf"), dtype=dtype, device=dev)
    for r_c, t_c in cand:
        xc = torch.einsum("bij,bmj->bmi", r_c, obj) + t_c[:, None, :]
        z = torch.where(xc[..., 2] < 1e-6, 1e-6, xc[..., 2])
        err = torch.sum((xc[..., :2] / z[..., None] - img_n) ** 2, dim=(1, 2)) + torch.where(
            torch.any(xc[..., 2] <= 0, dim=1), 1e12, 0.0)
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_r = torch.where(take[:, None, None], r_c, best_r)
        best_t = torch.where(take[:, None], t_c, best_t)
    return best_r, best_t


def _reproj_err2(r, t, obj, img_n):
    """Squared reprojection error in normalized coordinates, 1e12 behind
    the camera. r [B, 3, 3], t [B, 3], obj [N, 3], img_n [N, 2] -> [B, N]."""
    xc = torch.einsum("bij,nj->bni", r, obj) + t[:, None, :]
    z = torch.where(xc[..., 2] < 1e-6, 1e-6, xc[..., 2])
    err = torch.sum((xc[..., :2] / z[..., None] - img_n[None]) ** 2, dim=-1)
    return torch.where(xc[..., 2] <= 0, 1e12, err)


def gauss_newton_pose(obj, img_n, weights, rvec0, tvec0, iters: int = 10):
    """Weighted Gauss-Newton on (rvec, t), residual in normalized image
    coordinates, rotation perturbed on the right: R exp(w)."""
    rvec, t = rvec0, tvec0
    eye6 = torch.eye(6, dtype=obj.dtype, device=obj.device)
    for _ in range(iters):
        r = lie.so3_exp(rvec)
        xc = obj @ r.T + t
        z = torch.where(xc[:, 2] < 1e-6, 1e-6, xc[:, 2])
        res = xc[:, :2] / z[:, None] - img_n                     # [N, 2]
        zero = torch.zeros_like(z)
        j_proj = torch.stack([
            torch.stack([1.0 / z, zero, -xc[:, 0] / (z * z)], dim=-1),
            torch.stack([zero, 1.0 / z, -xc[:, 1] / (z * z)], dim=-1),
        ], dim=1)                                                # [N, 2, 3]
        j_r = -(r @ lie.hat(obj))                                # [N, 3, 3]
        jfull = torch.cat([j_proj @ j_r, j_proj], dim=-1)        # [N, 2, 6]
        jw = jfull * weights[:, None, None]
        h = torch.einsum("nia,nib->ab", jw, jfull) + 1e-9 * eye6
        g = torch.einsum("nia,ni->a", jw, res)
        step = -torch.linalg.solve_ex(h, g)[0]
        rvec = lie.so3_log(r @ lie.so3_exp(step[:3]))
        t = t + step[3:]
    return rvec, t


def pnp_ransac(obj, px, mask, k_mat, u=None, threshold_px: float = 8.0,
               gn_iters: int = 10, solver: str = "dlt", idx=None) -> PnPResult:
    """PnP RANSAC over correspondences obj [N, 3] <-> px [N, 2] where `mask`
    holds. The hypotheses' samples are `idx` [`uniform_shape(solver)`] if
    given, else drawn from the uniforms `u` of that shape. `solver` is
    "dlt" (the reference's SOLVEPNP_ITERATIVE), "epnp"
    (SOLVEPNP_EPNP/DLS/UPNP) or "p3p" (SOLVEPNP_P3P/AP3P: each sample's up
    to 4 roots are separate hypotheses, a NaN root scores no inlier)."""
    fx, fy = k_mat[0, 0], k_mat[1, 1]
    cx, cy = k_mat[0, 2], k_mat[1, 2]
    img_n = torch.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy], dim=-1)
    thr_n2 = (threshold_px / ((fx + fy) * 0.5)) ** 2
    if idx is None:
        idx = sample_indices(mask, u)
    if idx.shape[-1] != SOLVER_SAMPLE_SIZE[solver]:
        raise ValueError(f"the {solver!r} solver takes samples of {SOLVER_SAMPLE_SIZE[solver]} "
                         f"points, not {idx.shape[-1]}")
    if solver == "p3p":
        from pose_estimation_tpu_torch.ops.p3p import p3p_solve

        r_h, t_h = p3p_solve(obj[idx], img_n[idx])
        r_h, t_h = r_h.reshape(-1, 3, 3), t_h.reshape(-1, 3)
    else:
        pose = {"dlt": _dlt_pose, "epnp": _epnp_pose}[solver]
        r_h, t_h = pose(obj[idx], img_n[idx])

    # The winner has the least truncated squared error (MSAC, Torr and
    # Zisserman): an inlier adds its error, any other correspondence the
    # gate's. The reference counts inliers, and in the SfM bootstrap, where
    # far landmarks leave translation weakly observed, poses several cm
    # apart keep nearly the same inlier count, so the count picks among
    # them by a point or two (ROADMAP.md C15). A NaN hypothesis compares
    # false everywhere: it adds the gate's error for every point and so
    # cannot win over a finite one.
    err2 = _reproj_err2(r_h, t_h, obj, img_n)
    inl = (err2 < thr_n2) & mask[None, :]
    cost = torch.sum(torch.where(inl, err2, thr_n2), dim=1)
    # the winner taken by a one-element index tensor: a 0-dim one would be
    # read on the host
    best = torch.argmin(cost).reshape(1)
    inliers = inl[best][0]
    # two rounds of GN on the current inlier set, re-deciding the inliers in
    # between (LO-RANSAC style)
    rvec, tvec = lie.so3_log(r_h[best][0]), t_h[best][0]
    for _ in range(2):
        rvec, tvec = gauss_newton_pose(obj, img_n, inliers.to(obj.dtype), rvec, tvec,
                                       gn_iters)
        err2 = _reproj_err2(lie.so3_exp(rvec)[None], tvec[None], obj, img_n)[0]
        inliers = (err2 < thr_n2) & mask
    return PnPResult(rvec=rvec, tvec=tvec, inliers=inliers, n_inliers=torch.sum(inliers))
