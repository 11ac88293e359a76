"""Fixed-budget RANSAC for the fundamental matrix (8-point).

Counterpart of `pose_estimation_tpu/ops/ransac.py`: 64 hypotheses from
8-tuples drawn with replacement among the valid correspondences, each
solved by exact Gauss-Jordan null vectors plus one ridged inverse-iteration
step, scored by the Sampson distance against a 3-px gate; the hypothesis
with most inliers wins (first on ties).

The draw takes its uniforms `u` [64, 8] as an argument. It reproduces
`jax.random.choice(key, n, (64, 8), p)`, which is
`searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u), side="left")` with
`u = jax.random.uniform(key, (64, 8))`; the parity tests pass JAX's `u`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vio_bench.ref.utils.linalg import cho_solve

N_HYPOTHESES = 64


class RansacResult(NamedTuple):
    inliers: torch.Tensor    # [N] bool
    model: torch.Tensor      # [3, 3]
    n_inliers: torch.Tensor


def _row_sum(x):
    """Sum of the vector `x` in the order a lone contiguous row gets, also
    under vmap. There a batch's rows lie end to end, so a row whose length
    is not a multiple of 4 starts at another 16-byte alignment in each
    lane, and CUDA's vectorized reduction adds the unaligned head apart:
    the sum then depends on the lane's place in the batch. The row is
    padded to a multiple of 4 and the view of its first n summed."""
    n = x.shape[-1]
    pad = -n % 4
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])[:n]
    return torch.sum(x)


def _normalize(pts, mask):
    """Hartley normalization over valid points: zero mean, mean dist sqrt 2."""
    wsum = torch.clamp(torch.sum(mask), min=1)
    mean = torch.sum(torch.where(mask[:, None], pts, 0.0), dim=0) / wsum
    d = torch.linalg.norm(pts - mean, dim=1)
    scale = math.sqrt(2.0) / torch.clamp(_row_sum(torch.where(mask, d, 0.0)) / wsum, min=1e-9)
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    t = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, t


def _adjugate3(m):
    """adj(M) for [..., 3, 3]."""

    def cof(i, j):
        r = [a for a in range(3) if a != i]
        c = [a for a in range(3) if a != j]
        return (
            m[..., r[0], c[0]] * m[..., r[1], c[1]]
            - m[..., r[0], c[1]] * m[..., r[1], c[0]]
        ) * ((-1.0) ** (i + j))

    cofm = torch.stack(
        [torch.stack([cof(i, j) for j in range(3)], -1) for i in range(3)], -2
    )
    return cofm.transpose(-1, -2)


def _null8(a):
    """Null vector of each [8, 9] constraint matrix: Gauss-Jordan with full
    pivoting, then one ridged inverse-iteration step (see the JAX package
    for why)."""
    b = a.shape[0]
    m = a
    dtype = a.dtype
    row_avail = torch.ones((b, 8), dtype=dtype, device=a.device)
    col_avail = torch.ones((b, 9), dtype=dtype, device=a.device)
    # one-hot rows by comparison: `one_hot` checks its classes on the host
    # off the card
    rows = torch.arange(8, device=a.device)
    cols = torch.arange(9, device=a.device)
    pivots = []
    for _ in range(8):
        absm = m.abs() * row_avail[:, :, None] * col_avail[:, None, :]
        pidx = torch.argmax(absm.reshape(b, 72), dim=1)
        prow_oh = ((pidx // 9)[:, None] == rows).to(dtype)
        pcol_oh = ((pidx % 9)[:, None] == cols).to(dtype)
        piv = torch.einsum("br,brc,bc->b", prow_oh, m, pcol_oh)
        safe = torch.where(piv.abs() < 1e-30, 1.0, piv)
        prow = torch.einsum("br,brc->bc", prow_oh, m) / safe[:, None]
        colv = torch.einsum("brc,bc->br", m, pcol_oh)
        factor = colv * (1.0 - prow_oh)
        m = m - factor[:, :, None] * prow[:, None, :]
        m = (m * (1.0 - prow_oh)[:, :, None]
             + prow_oh[:, :, None] * prow[:, None, :])
        row_avail = row_avail * (1.0 - prow_oh)
        col_avail = col_avail * (1.0 - pcol_oh)
        pivots.append((prow_oh, pcol_oh))
    free_oh = col_avail
    mf = torch.einsum("brc,bc->br", m, free_oh)
    x = free_oh
    for prow_oh, pcol_oh in pivots:
        coeff = torch.einsum("br,br->b", prow_oh, mf)
        x = x - coeff[:, None] * pcol_oh
    x = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-30)

    ata = torch.einsum("bri,brj->bij", a, a)
    tr = torch.diagonal(ata, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(9, dtype=dtype, device=a.device)
    h = ata + (1e-10 * tr)[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(h)
    w = cho_solve(chol, x[..., None])[..., 0]
    wn = torch.linalg.norm(w, dim=-1, keepdim=True)
    ok = (torch.isfinite(w).all(dim=-1, keepdim=True) & (wn > 1e-30)
          & (info == 0)[:, None])
    return torch.where(ok, w / torch.clamp(wn, min=1e-30), x)


def _eight_point(x1, x2):
    """Batched 8-point algorithm with rank-2 projection. [B, 8, 2] -> [B, 3, 3]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    ones = torch.ones_like(u1)
    a = torch.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1
    )
    f = _null8(a).reshape(-1, 3, 3)
    fft = torch.einsum("bij,bkj->bik", f, f)
    adj = _adjugate3(fft)
    diag = torch.diagonal(adj, dim1=-2, dim2=-1).abs()
    col = torch.argmax(diag, dim=-1)
    u3 = torch.gather(adj, -1, col[:, None, None].expand(-1, 3, 1))[..., 0]
    u3 = u3 / torch.clamp(torch.linalg.norm(u3, dim=-1, keepdim=True), min=1e-30)
    return f - u3[..., :, None] * torch.einsum("bi,bij->bj", u3, f)[:, None, :]


def _sampson_dist(f, pts1, pts2):
    """Sampson epipolar distance. f [B, 3, 3], pts [N, 2] -> [B, N]."""
    ones = torch.ones((pts1.shape[0], 1), dtype=pts1.dtype, device=pts1.device)
    x1 = torch.cat([pts1, ones], dim=1)
    x2 = torch.cat([pts2, ones], dim=1)
    fx1 = torch.einsum("bij,nj->bni", f, x1)
    ftx2 = torch.einsum("bji,nj->bni", f, x2)
    num = torch.einsum("ni,bni->bn", x2, fx1) ** 2
    den = fx1[..., 0] ** 2 + fx1[..., 1] ** 2 + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sample_indices(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices [64, 8] drawn with probability proportional to `mask`."""
    probs = mask.to(torch.float32)
    probs = probs / torch.clamp(torch.sum(probs), min=1e-9)
    cum = torch.cumsum(probs, dim=0)
    return torch.searchsorted(cum, (cum[-1] * (1 - u)).contiguous())


def fundamental_ransac(pts1, pts2, mask, u, threshold: float = 3.0) -> RansacResult:
    """RANSAC inlier mask for the correspondences pts1[i] <-> pts2[i]."""
    p1n, t1 = _normalize(pts1, mask)
    p2n, t2 = _normalize(pts2, mask)
    idx = sample_indices(mask, u)
    f_n = _eight_point(p1n[idx], p2n[idx])
    f = torch.einsum("ji,bjk,kl->bil", t2, f_n, t1)
    d = _sampson_dist(f, pts1, pts2)
    inl = (d < threshold * threshold) & mask[None, :]
    counts = torch.sum(inl, dim=1)
    # a one-element index, not the 0-dim `best`: Python indexing would
    # read that on the host
    best = torch.argmax(counts).reshape(1)
    return RansacResult(inliers=inl[best][0], model=f[best][0], n_inliers=counts[best][0])
