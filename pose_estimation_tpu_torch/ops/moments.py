"""Full-image intensity-centroid moment maps: kernel K4 and its twin.

Counterpart of `pose_estimation_tpu/ops/pallas_fast.py:moment_maps_pallas`
(the TPU kernel) and `pose_estimation_tpu/ops/orb.py:moment_maps_integral`
(its XLA form, the twin here). For every pixel of a plane stack the first
moments over the radius-15 circle,

    m10[y, x] = sum dx * J[y + dy, x + dx],  m01[y, x] = sum dy * J[...],

with J the plane minus its mean over the whole canvas (both moments are
invariant to a constant, and the subtraction keeps the prefix sums small)
and exactly 0 beyond the canvas. Row dy of the circle spans |dx| <= r(dy),
so each moment is a sum over 31 rows of windowed differences of two row
prefix sums, P = cumsum(J) and Q = cumsum(xc * J):

    box(x; r)  = P[x + r] - P[x - r - 1]
    ramp(x; r) = (Q[x + r] - Q[x - r - 1]) - xc * box(x; r)

`ic_angle_integral` samples the maps at the keypoints. `moment_maps`
launches `csrc/moment_maps.cu` on a CUDA tensor and runs the twin
`moment_maps_plain` only on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.ops import kernels

PATCH_R = 15
# circle geometry: row offset dy covers |dx| <= RS[dy + 15]
DYS = np.arange(-PATCH_R, PATCH_R + 1)
RS = np.floor(np.sqrt(PATCH_R**2 - DYS.astype(np.float64) ** 2)).astype(np.int64)


def zero_mean(stack: torch.Tensor) -> torch.Tensor:
    """The stack minus each plane's mean over its whole canvas."""
    return stack - stack.mean(dim=(-2, -1), keepdim=True)


def prefix_sums(stack: torch.Tensor):
    """(P, Q, xc): the row prefix sums of the zero-meaned stack [..., H, W]
    and of its product with xc = x - W / 2, in float64, with xc in float64.

    A float32 prefix sum over a whole row reaches ~1e7 (spacing 1-2) where
    the windowed differences taken from it are ~1e3-1e5, so its rounding
    decides the moments. A sequential sum shares its rounding between
    neighbouring partial sums, which the differences cancel; CUDA's cumsum
    is a block scan whose partial sums do not, and its angles drift by up
    to 7e-3 rad at 1242 px. In float64 the differences are exact to float32
    whatever the scan order, so the forms agree on every device."""
    w = stack.shape[-1]
    s = stack.to(torch.float64)
    xc = torch.arange(w, dtype=torch.float64, device=stack.device) - w / 2.0
    return torch.cumsum(s, dim=-1), torch.cumsum(s * xc, dim=-1), xc


def moment_maps_plain(stack: torch.Tensor):
    """Twin of kernel K4: (m10, m01) of a plane stack [..., H, W], each
    [..., H, W] in the stack's type, by row prefix sums and shifted adds.
    The prefix sums and their windowed differences are taken in float64
    (`prefix_sums`), the 31-row accumulation in the stack's type. The whole
    map is defined: windows and rows that leave the canvas read zeros."""
    h, w = stack.shape[-2], stack.shape[-1]
    dt = stack.dtype
    stack = zero_mean(stack)
    p, q, xc = prefix_sums(stack)

    def window(c, r):
        """c[..., x + r] - c[..., x - r - 1], with c[..., < 0] = 0 and
        c[..., >= w] = the row total."""
        hi = c if r == 0 else torch.cat(
            [c[..., r:], c[..., -1:].expand(*c.shape[:-1], r)], dim=-1)
        lo = torch.nn.functional.pad(c[..., :w - r - 1], (r + 1, 0))
        return hi - lo

    box, ramp = {}, {}
    for r in sorted(set(RS.tolist())):
        b = window(p, r)
        box[r] = b.to(dt)
        ramp[r] = (window(q, r) - xc * b).to(dt)

    def shift_y(a, dy):
        """a[..., y + dy, :] with zero fill."""
        return torch.nn.functional.pad(a, (0, 0, PATCH_R, PATCH_R))[
            ..., PATCH_R + dy:PATCH_R + dy + h, :]

    m10 = torch.zeros_like(stack)
    m01 = torch.zeros_like(stack)
    for dy, r in zip(DYS.tolist(), RS.tolist()):
        m10 = m10 + shift_y(ramp[r], dy)
        if dy:
            m01 = m01 + dy * shift_y(box[r], dy)
    return m10, m01


def moment_maps(stack: torch.Tensor):
    """Kernel K4: (m10, m01) circular moment maps of a plane stack
    [N, H, W] float32, any width.

    Replaces the TPU kernel `pose_estimation_tpu/ops/pallas_fast.py:
    _moments_kernel` (via `moment_maps_pallas`). On the H100 it is bound by
    its shared-memory traffic and staging, not its bytes of device memory
    (4 read and 8 written per pixel): one block of 128 threads owns a
    130-row x 128-column tile and streams its rows, with the 15-row and
    16-column halo, through shared memory in 32-row chunks, subtracting
    the plane mean on the way in and scanning each row there; each thread
    walks down one column, forms each staged row's 10 radius windows once
    and adds them into the 31 output rows that use it, held in registers,
    so only the two maps reach device memory. The plane means are one
    torch reduction before the launch. A CUDA tensor launches the kernel
    (or raises); a CPU tensor runs `moment_maps_plain`."""
    if not stack.is_cuda:
        return moment_maps_plain(stack)
    if stack.dtype != torch.float32 or not stack.is_contiguous() or stack.ndim != 3:
        raise ValueError("moment_maps needs a contiguous float32 [N, H, W] stack")
    n, h, w = stack.shape
    mean = stack.mean(dim=(1, 2))
    m10 = torch.empty_like(stack)
    m01 = torch.empty_like(stack)
    err = kernels.library().moment_maps_launch(
        stack.data_ptr(), mean.data_ptr(), m10.data_ptr(), m01.data_ptr(), n, h, w,
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    kernels.check(err, "moment_maps")
    moment_maps.launches += 1
    return m10, m01


moment_maps.launches = 0


def ic_angle_integral(m10_flat, m01_flat, base, xy, h: int, w: int):
    """Orientation [K] (radians) from the flattened moment maps at the
    rounded keypoints xy [K, 2] of the planes at flat offsets base [K]."""
    cx = torch.round(xy[..., 0]).to(torch.int64).clamp(0, w - 1)
    cy = torch.round(xy[..., 1]).to(torch.int64).clamp(0, h - 1)
    idx = base + cy * w + cx
    return torch.atan2(m01_flat[idx], m10_flat[idx])
