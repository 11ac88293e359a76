"""Eigendecomposition and SVD of small matrices that a CUDA graph can
capture: kernel K6 and its twins.

`torch.linalg.eigh` and `torch.linalg.svd` check their results on the host,
so no CUDA graph can hold them. Inside its jitted programs the JAX package
computes `jnp.linalg.eigh` and `svd` on the device with no host read (the
PnP solvers of `pose_estimation_tpu/ops/pnp.py`; the port's PSD clip of the
marginalization prior, `backend/ba.py:psd_clip`). `eigh` and `svd` launch
`csrc/small_linalg.cu` on a CUDA tensor (or raise) and run their twins
`eigh_plain` and `svd_plain` only on a CPU tensor. K6 replaces no Pallas
kernel.

Both follow one contract, so that the kernel and its twin agree beyond
the ordering and signs that the library calls leave open:

- `eigh(a)`: the lower triangle of a symmetric [..., n, n] matrix, n <= 64,
  float32 or float64; eigenvalues ascending and eigenvectors as columns,
  each column's component of largest magnitude positive (the first such
  index on ties).
- `svd(a)`: a float32 [..., 3, 3] matrix as (U, S, Vh) in
  `torch.linalg.svd`'s convention, S descending. V's columns are canonical
  as above; u1 = A v1 / |A v1|, u2 = A v2 made orthogonal to u1 and
  normalised (any unit vector orthogonal to u1 when A v2 is nothing
  more), u3 = +-(u1 x u2) with the sign of (u1 x u2) . A v3. So U is
  orthonormal for every A, rank 2 and rank 1 included, and the proper
  rotation U diag(1, 1, det(U V^T)) V^T of `ops/pnp.py` is a rotation.

A matrix holding a NaN or an infinity gives NaN throughout (the library
calls raise).
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import kernels

MAX_N = 64


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


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _complete_u(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """U of the contract from A [..., 3, 3] and its canonical V (columns)."""
    eps = torch.finfo(a.dtype).eps
    y = (a @ v).transpose(-1, -2)                       # rows y_k = A v_k
    y1, y2, y3 = y[..., 0, :], y[..., 1, :], y[..., 2, :]
    e = torch.eye(3, dtype=a.dtype, device=a.device)
    n1 = torch.sqrt(_dot(y1, y1))
    u1 = torch.where((n1 > 0)[..., None], y1 / n1[..., None], e[0])
    w2 = y2 - _dot(u1, y2)[..., None] * u1
    n2 = torch.sqrt(_dot(w2, w2))
    axis = e[torch.argmin(u1.abs(), dim=-1)]
    side = _cross(u1, axis)
    side = side / torch.sqrt(_dot(side, side))[..., None]
    u2 = torch.where((n2 > 8.0 * eps * n1)[..., None], w2 / n2[..., None], side)
    u3 = _cross(u1, u2)
    u3 = torch.where((_dot(u3, y3) < 0)[..., None], -u3, u3)
    return torch.stack([u1, u2, u3], dim=-1)


def svd_plain(a: torch.Tensor):
    """The twin of `svd`: `torch.linalg.svd` for S and V, V's columns made
    canonical and U completed as the contract says."""
    bad = _bad(a)
    safe = torch.where(bad[..., None, None], 0.0, a)
    _, s, vh = torch.linalg.svd(safe)
    v = _canonical_columns(vh.transpose(-1, -2))
    u = _complete_u(safe, v)
    nan = float("nan")
    return (torch.where(bad[..., None, None], nan, u), torch.where(bad[..., None], nan, s),
            torch.where(bad[..., None, None], nan, v.transpose(-1, -2)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _eigh_launch(a: torch.Tensor, graded: bool, rounds: torch.Tensor | None = None):
    """Launch K6's eigh on the CUDA tensor a [..., n, n] (or raise), each
    matrix's rounds into `rounds` if given. Returns (w, v, launched)."""
    n = a.shape[-1]
    if (a.ndim < 2 or a.shape[-2] != n or not 0 < n <= MAX_N
            or a.dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"eigh takes float32 or float64 [..., n, n] with n <= {MAX_N}, "
                         f"not {a.dtype} {tuple(a.shape)}")
    flat = a.reshape(-1, n, n).contiguous()
    w = torch.empty(flat.shape[:-1], dtype=a.dtype, device=a.device)
    v = torch.empty_like(flat)
    if flat.shape[0]:
        err = kernels.library().small_eigh_launch(
            flat.data_ptr(), w.data_ptr(), v.data_ptr(),
            None if rounds is None else rounds.data_ptr(), flat.shape[0], n,
            int(a.dtype == torch.float64), int(graded), _stream(a))
        kernels.check(err, "eigh")
    return w.reshape(a.shape[:-1]), v.reshape(a.shape), bool(flat.shape[0])


def eigh(a: torch.Tensor, graded: bool = True):
    """(eigenvalues [..., n] ascending, eigenvectors [..., n, n] as columns)
    of the symmetric matrices a [..., n, n] (their lower triangles), n <=
    64, float32 or float64, with canonical signs.

    A CUDA tensor launches K6's Jacobi kernel, one block a matrix with
    the matrix and its eigenvector accumulator in shared memory, one
    barrier-separated pass a round (or raises); a CPU tensor runs
    `eigh_plain`. `graded` keeps the small eigenpairs accurate to their own
    size (the kernel's relative stop, for the PnP solvers' null vectors);
    otherwise the kernel stops at off-diagonals of eps ||A||_F, in fewer
    rounds (the PSD clip)."""
    if not a.is_cuda:
        return eigh_plain(a)
    w, v, launched = _eigh_launch(a, graded)
    eigh.launches += launched
    return w, v


eigh.launches = 0


def eigh_rounds(a: torch.Tensor, graded: bool = True):
    """`eigh` of a CUDA tensor with the number of Jacobi rounds each matrix
    took ([...] int32; a sweep is n - 1 rounds, n rounded up to even), for
    measurement: not counted in `eigh.launches`."""
    if not a.is_cuda:
        raise ValueError("eigh_rounds measures the kernel: it takes a CUDA tensor")
    rounds = torch.empty(a.shape[:-2], dtype=torch.int32, device=a.device)
    w, v, _ = _eigh_launch(a, graded, rounds)
    return w, v, rounds


def svd(a: torch.Tensor):
    """(U, S, Vh) of float32 [..., 3, 3] matrices by the contract above.

    A CUDA tensor launches K6's one-sided Jacobi kernel, one thread a
    matrix and a fixed 5 cyclic sweeps with no data-dependent exit (or
    raises); a CPU tensor runs `svd_plain`."""
    if not a.is_cuda:
        return svd_plain(a)
    if a.ndim < 2 or a.shape[-2:] != (3, 3) or a.dtype != torch.float32:
        raise ValueError(f"svd takes float32 [..., 3, 3], not {a.dtype} {tuple(a.shape)}")
    flat = a.reshape(-1, 3, 3).contiguous()
    u = torch.empty_like(flat)
    s = torch.empty(flat.shape[:-1], dtype=a.dtype, device=a.device)
    vh = torch.empty_like(flat)
    if flat.shape[0]:
        err = kernels.library().small_svd3_launch(
            flat.data_ptr(), u.data_ptr(), s.data_ptr(), vh.data_ptr(), flat.shape[0],
            _stream(a))
        kernels.check(err, "svd")
        svd.launches += 1
    return u.reshape(a.shape), s.reshape(a.shape[:-1]), vh.reshape(a.shape)


svd.launches = 0
