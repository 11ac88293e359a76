"""Batched two-view DLT triangulation by the adjugate of A^T A, and the
closed form for a rectified pair.

Counterpart of `pose_estimation_tpu/ops/triangulate.py` (`triangulate`,
`triangulate_rectified`). In `triangulate` the null vector of the rank-3
4x4 normal matrix is the adjugate column with the largest diagonal entry
(first one on ties). Near-degenerate pairs come out with wrong depth and
are dropped by the callers' depth gates.
"""

from __future__ import annotations

import torch


def _adjugate4(m: torch.Tensor) -> torch.Tensor:
    """adj(M) for [..., 4, 4] from 16 3x3 determinants."""

    def det3(r: int, c: int):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a, b, cc = (m[..., rows[0], cols[k]] for k in range(3))
        d, e, f = (m[..., rows[1], cols[k]] for k in range(3))
        g, h, i = (m[..., rows[2], cols[k]] for k in range(3))
        return a * (e * i - f * h) - b * (d * i - f * g) + cc * (d * h - e * g)

    cof = torch.stack(
        [torch.stack([(-1.0) ** (i + j) * det3(i, j) for j in range(4)], dim=-1)
         for i in range(4)], dim=-2,
    )
    return cof.transpose(-1, -2)


def triangulate(p1, p2, px1, px2) -> torch.Tensor:
    """[N, 3] points in the projections' common frame. p1, p2 [3, 4];
    px1, px2 [N, 2]."""
    a = torch.stack(
        [
            px1[:, 0:1] * p1[2] - p1[0],
            px1[:, 1:2] * p1[2] - p1[1],
            px2[:, 0:1] * p2[2] - p2[0],
            px2[:, 1:2] * p2[2] - p2[1],
        ],
        dim=1,
    )                                                   # [N, 4, 4]
    ata = a.transpose(-1, -2) @ a
    adj = _adjugate4(ata)
    diag = torch.diagonal(adj, dim1=-2, dim2=-1).abs()  # [N, 4]
    col = torch.argmax(diag, dim=-1)                    # first maximum
    x = torch.gather(adj, -1, col[:, None, None].expand(-1, 4, 1))[..., 0]
    wcomp = x[:, 3]
    safe_w = torch.where(wcomp.abs() < 1e-12, 1e-12, wcomp)
    return x[:, :3] / safe_w[:, None]


def triangulate_rectified(fx, cx, cy, fy, baseline, px_l, px_r) -> torch.Tensor:
    """Closed form for a rectified pair with zero disparity offset (depth
    from disparity): [N, 3] points in the left rectified camera frame."""
    disp = px_l[:, 0] - px_r[:, 0]
    safe_disp = torch.where(disp.abs() < 1e-6, 1e-6, disp)
    z = fx * baseline / safe_disp
    x = (px_l[:, 0] - cx) / fx * z
    y = (px_l[:, 1] - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)
