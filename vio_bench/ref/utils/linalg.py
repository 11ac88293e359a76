"""A Cholesky solve that a CUDA graph can capture on any backend.

`torch.cholesky_solve` picks MAGMA for a batch of matrices on the card (a
`vmap`ped step, RANSAC's 64 hypotheses) unless cuSOLVER is preferred
(`precision.apply_policy`), and MAGMA's path reads its result on the
host, which a captured graph cannot do. Two triangular solves compute the
same (`cho_solve` of the JAX package's `jax.scipy.linalg`) with no host
read on any backend; on the CPU they are bit-equal to
`torch.cholesky_solve`.
"""

from __future__ import annotations

import torch


def cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with chol chol^T x = b, chol [..., n, n] lower, b [..., n, k]."""
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)

