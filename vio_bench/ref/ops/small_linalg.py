"""Eigendecomposition of small symmetric matrices: kernel K6's twin (the
marginalization prior's PSD clip, `backend/ba.py:psd_clip`).

Frozen from `pose_estimation_tpu_torch/ops/small_linalg.py`. The kernel
and its twin follow one contract, so that they agree beyond the ordering
and signs that the library call leaves open: the lower triangle of a
symmetric [..., n, n] matrix, n <= 64, float32 or float64; eigenvalues
ascending and eigenvectors as columns, each column's component of largest
magnitude positive (the first such index on ties). A matrix holding a NaN
or an infinity gives NaN throughout (the library call raises).
"""

from __future__ import annotations

import torch


def _canonical_columns(v: torch.Tensor) -> torch.Tensor:
    """v [..., n, k] with each column's component of largest magnitude
    made positive (the first such index on ties)."""
    arg = torch.argmax(v.abs(), dim=-2, keepdim=True)
    lead = torch.gather(v, -2, arg)
    return v * torch.where(lead < 0, -1.0, 1.0).to(v.dtype)


def _bad(a: torch.Tensor) -> torch.Tensor:
    """[...] whether each matrix of a [..., n, n] holds a non-finite value."""
    return ~torch.isfinite(a).all(dim=-1).all(dim=-1)


def eigh_plain(a: torch.Tensor):
    """The twin of `eigh`: `torch.linalg.eigh` with the canonical signs."""
    bad = _bad(a)
    w, v = torch.linalg.eigh(torch.where(bad[..., None, None], 0.0, a))
    v = _canonical_columns(v)
    return (torch.where(bad[..., None], float("nan"), w),
            torch.where(bad[..., None, None], float("nan"), v))


def eigh(a: torch.Tensor):
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n] as columns)
    of the symmetric matrices a [..., n, n], by the twin on every device."""
    return eigh_plain(a)
