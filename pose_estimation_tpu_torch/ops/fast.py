"""FAST-9/16 detection with per-cell selection: kernels K1 and K3 and
their twins.

Counterpart of `pose_estimation_tpu/ops/fast.py` (plain form) and of two
TPU kernels of `pose_estimation_tpu/ops/pallas_fast.py`:

- `fast_select` (K1, `csrc/fast_select.cu`, twin `select_plain`) replaces
  `fast_select_pallas`: score, NMS, gates, per-cell top-k and subpixel fit
  in one kernel. It takes widths that are multiples of 16 only; `orb`
  routes every other width to K3.
- `fast_score_nms` (K3, `csrc/fast_score_nms.cu`, twin `score_nms_plain`)
  replaces `fast_score_nms_pallas`: the raw and the NMS-masked score maps;
  `select_keypoints_batched` then gates and selects in torch.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its twin
only on a CPU tensor. The plane top-k stays in torch as a stable
descending sort: `lax.top_k` breaks ties toward the lower index and
level-0 scores are integers, so ties are common.

K1's output contract: for each plane, candidates in raster order
(cell-row, cell-col, k) with C = n_cell_rows * (W / 16) * k_per_cell,
n_cell_rows = 2 * ceil(H / 32): score [N, C] (invalid -1e9), flat code
y * W + x [N, C] int32 (invalid 0), subpixel x, y [N, C] (invalid 0).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from pose_estimation_tpu_torch.ops import kernels

NEG = -1e9
CELL = 16
BAND = 32   # the cell-row count follows the TPU kernel's 32-row bands
TILE_CELLS = 8            # K1's blocks are BAND x TILE_W
TILE_W = CELL * TILE_CELLS

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class Keypoints(NamedTuple):
    xy: torch.Tensor     # [N, K, 2] (x, y)
    score: torch.Tensor  # [N, K]
    valid: torch.Tensor  # [N, K] bool


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(img, (-dy, -dx), dims=(-2, -1))


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST score [..., H, W]: max over bright and dark of the
    max over 9-arcs of the minimum ring-minus-center difference. Cyclic
    shifts wrap at the border; the wrapped band lies outside the detection
    border."""
    diffs = [_shift2d(img, dy, dx) - img for dy, dx in CIRCLE]

    def arc_min9(ds):
        m3 = [torch.minimum(torch.minimum(ds[i], ds[(i + 1) % 16]), ds[(i + 2) % 16])
              for i in range(16)]
        m9 = [torch.minimum(torch.minimum(m3[i], m3[(i + 3) % 16]), m3[(i + 6) % 16])
              for i in range(16)]
        out = m9[0]
        for i in range(1, 16):
            out = torch.maximum(out, m9[i])
        return out

    return torch.maximum(arc_min9(diffs), arc_min9([-d for d in diffs]))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression mask, ties broken toward the top-left."""
    keep = torch.ones_like(score, dtype=torch.bool)
    strictly_before = True
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                strictly_before = False
                continue
            nb = _shift2d(score, dy, dx)
            keep &= (score > nb) if strictly_before else (score >= nb)
    return keep


def _para(sm, s0, sp):
    den = sm - 2.0 * s0 + sp
    off = torch.where(den.abs() > 1e-6, 0.5 * (sm - sp) / den, 0.0)
    return torch.clamp(off, -0.5, 0.5)


def select_plain(stack: torch.Tensor, bounds, th_hi: float, th_lo: float,
                 border: int = 19, k_per_cell: int = 4):
    """Twin of kernel K1: FAST score -> NMS -> gates -> per-cell threshold
    fallback -> top-k per cell -> subpixel fit. Returns (vals, codes, xs,
    ys), each [N, C], in the module's output contract."""
    n, h, w = stack.shape
    dev = stack.device
    score = fast_score(stack)
    keep = nms3(score)
    lh = torch.tensor([b[0] for b in bounds], device=dev)[:, None, None]
    lw = torch.tensor([b[1] for b in bounds], device=dev)[:, None, None]
    ys_ = torch.arange(h, device=dev)[None, :, None]
    xs_ = torch.arange(w, device=dev)[None, None, :]
    inb = (ys_ >= border) & (ys_ < lh - border) & (xs_ >= border) & (xs_ < lw - border)
    s = torch.where(keep & (score > 0) & inb, score, NEG)

    hp = -(-h // BAND) * BAND
    ncr, ncx = hp // CELL, w // CELL
    s = torch.nn.functional.pad(s, (0, 0, 0, hp - h), value=NEG)
    cells = s.reshape(n, ncr, CELL, ncx, CELL).permute(0, 1, 3, 2, 4).reshape(
        n, ncr * ncx, CELL * CELL
    )
    cell_max = cells.amax(dim=2, keepdim=True)
    thr = torch.where(cell_max > th_hi, th_hi, th_lo)
    cand = torch.where(cells > thr, cells, NEG)

    # top-k per cell by k (argmax, mask) passes: argmax returns the first
    # maximum, which is the lowest in-cell raster index
    comb = cand.clone()
    idxs = []
    for _ in range(k_per_cell):
        idx = torch.argmax(comb, dim=-1, keepdim=True)
        idxs.append(idx)
        comb.scatter_(-1, idx, float("-inf"))
    top_i = torch.cat(idxs, dim=-1)                          # [n, C, k]
    top_s = torch.gather(cand, -1, top_i)
    cell_id = torch.arange(ncr * ncx, device=dev)[None, :, None]
    py = (cell_id // ncx) * CELL + top_i // CELL
    px = (cell_id % ncx) * CELL + top_i % CELL

    flat = score.reshape(n, h * w)

    def sc(yy, xx):
        yy = yy.clamp(0, h - 1)
        xx = xx.clamp(0, w - 1)
        return torch.gather(flat, 1, (yy * w + xx).reshape(n, -1)).reshape(yy.shape)

    s0 = sc(py, px)
    fx = px.to(stack.dtype) + _para(sc(py, px - 1), s0, sc(py, px + 1))
    fy = py.to(stack.dtype) + _para(sc(py - 1, px), s0, sc(py + 1, px))
    ok = top_s > NEG / 2
    vals = top_s.reshape(n, -1)
    codes = torch.where(ok, py * w + px, 0).to(torch.int32).reshape(n, -1)
    xs = torch.where(ok, fx, 0.0).reshape(n, -1)
    ys = torch.where(ok, fy, 0.0).reshape(n, -1)
    return vals, codes, xs, ys


class SelectPlan(NamedTuple):
    """Kernel K1's launch plan for one stack shape and set of bounds: per
    plane the rectangle of 32-row x 128-column blocks [band0, band0 +
    bands) x [tile0, tile0 + tiles) that hold a pixel inside the detection
    border, and the first work block of each plane (then the total)."""

    band0: tuple
    bands: tuple
    tile0: tuple
    tiles: tuple
    first: tuple


def select_plan(h: int, w: int, bounds, border: int = 19) -> SelectPlan:
    """K1's work blocks: block (band, tile) of a plane with content (lh,
    lw) does work iff it holds a pixel with border <= y < lh - border and
    border <= x < lw - border, the only pixels whose slots can be valid.
    Every other cell's slots are written invalid by the plane's fill
    block."""
    n_bands, n_tiles = -(-h // BAND), -(-(w // CELL) // TILE_CELLS)
    band0, bands, tile0, tiles, first = [], [], [], [], [0]
    for lh, lw in bounds:
        b0, t0 = border // BAND, border // TILE_W
        nb = min(n_bands, -(-(lh - border) // BAND)) - b0
        nt = min(n_tiles, -(-(lw - border) // TILE_W)) - t0
        if lh - border <= border or lw - border <= border:
            nb = nt = 0
        band0.append(b0)
        tile0.append(t0)
        bands.append(nb)
        tiles.append(nt)
        first.append(first[-1] + nb * nt)
    return SelectPlan(tuple(band0), tuple(bands), tuple(tile0), tuple(tiles), tuple(first))


@functools.lru_cache(maxsize=16)
def plane_classes(bounds: tuple) -> tuple[tuple, int]:
    """(content size of each class, planes per class): the planes split
    into classes of `per` consecutive planes of equal content size, `per`
    the largest such count. A level-major stack of b images has one class
    per level (or per run of levels of equal size) of b planes, so K1's
    plan has a row per level whatever the batch."""
    runs, start = [], 0
    for i in range(1, len(bounds) + 1):
        if i == len(bounds) or bounds[i] != bounds[start]:
            runs.append(i - start)
            start = i
    per = functools.reduce(math.gcd, runs)
    return tuple(bounds[::per]), per


@functools.lru_cache(maxsize=16)
def _launch_table(h: int, w: int, bounds: tuple, border: int):
    """(table, its address): int32 [7 * n + 1], the n planes' (or plane
    classes') content heights and widths, then `select_plan`'s fields, as
    the kernel's launcher reads them. Cached per stack shape and bounds: no
    numpy work per launch."""
    plan = select_plan(h, w, bounds, border)
    table = np.concatenate([[b[0] for b in bounds], [b[1] for b in bounds], *plan]).astype(
        np.int32)
    return table, table.ctypes.data


def fast_select(stack: torch.Tensor, bounds, th_hi: float, th_lo: float,
                border: int = 19, k_per_cell: int = 4):
    """Kernel K1: fused FAST + NMS + gates + per-cell top-k + subpixel.

    Replaces the TPU kernel `pose_estimation_tpu/ops/pallas_fast.py:
    _select_kernel` (via `fast_select_pallas`). On the H100 it is bound by
    the per-pixel stencil arithmetic (~127 float32 instructions a pixel of
    the planes' content, most of them min/max). One launch for a stack of
    any number of images: the plan has a row per class of equally sized
    planes (`plane_classes`: a level of the stack), the grid's y index is
    the plane within its class. A fill block per plane writes the invalid
    slots of the cells outside the plane's work rectangle (`select_plan`),
    and one block per 32 x 128 tile of the rectangles stages it with its
    halo in shared memory, scores it a column per thread, gates it and
    selects with one warp per cell, so only the selected slots reach device
    memory. A CUDA tensor launches the kernel (or raises); a CPU tensor
    runs `select_plain`."""
    if not stack.is_cuda:
        return select_plain(stack, bounds, th_hi, th_lo, border, k_per_cell)
    n, h, w = stack.shape
    if stack.dtype != torch.float32 or not stack.is_contiguous():
        raise ValueError("fast_select needs a contiguous float32 stack")
    if w % CELL or len(bounds) != n:
        # other widths take K3 (`orb.extract_batch`)
        raise ValueError(f"bad shape {tuple(stack.shape)} / {len(bounds)} bounds")
    cls_bounds, per = plane_classes(tuple(bounds))
    _, table_ptr = _launch_table(h, w, cls_bounds, int(border))
    ncr = -(-h // BAND) * BAND // CELL
    ncx = w // CELL
    c = ncr * ncx * k_per_cell
    vals = torch.empty((n, c), dtype=torch.float32, device=stack.device)
    codes = torch.empty((n, c), dtype=torch.int32, device=stack.device)
    xs = torch.empty_like(vals)
    ys = torch.empty_like(vals)
    err = kernels.library().fast_select_launch(
        stack.data_ptr(), table_ptr,
        vals.data_ptr(), codes.data_ptr(), xs.data_ptr(), ys.data_ptr(),
        len(cls_bounds), per, h, w, ncr, ncx, float(th_hi), float(th_lo), int(border),
        int(k_per_cell), BAND, TILE_W, torch.cuda.current_stream(stack.device).cuda_stream,
    )
    kernels.check(err, "fast_select")
    fast_select.launches += 1
    return vals, codes, xs, ys


fast_select.launches = 0


def plane_topk(vals, payloads, k: int):
    """Top-k of vals [N, C] along axis 1, descending, ties to the lower
    index (`lax.top_k` semantics), with the matching entries of each
    payload [N, C]."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(vals, 1, order), [torch.gather(p, 1, order) for p in payloads]


def select_keypoints_fused(stack, bounds, th_hi, th_lo, k_max,
                           border: int = 19, k_per_cell: int = 4) -> Keypoints:
    """K1 then the plane top-k: [N, k_max] keypoints per plane."""
    vals, _codes, xs, ys = fast_select(stack, bounds, th_hi, th_lo, border, k_per_cell)
    k_max = min(k_max, vals.shape[1])
    g_s, (gx, gy) = plane_topk(vals, (xs, ys), k_max)
    return Keypoints(xy=torch.stack([gx, gy], dim=-1), score=g_s, valid=g_s > NEG / 2)


# ---- K3: raw and NMS-masked FAST score maps

HALO = 4   # FAST ring 3 + NMS 1


def score_nms_plain(stack: torch.Tensor):
    """Twin of kernel K3: (raw, masked) [N, H, W] float32 FAST score maps,
    masked = raw where the 3x3 NMS keeps it, else 0. The edges follow the
    TPU kernel (`pallas_fast.fast_score_nms_pallas`): rows are clamped to
    the plane (its edge padding), columns wrap (its roll), ties break in
    raster order. `fast_score`'s cyclic row shifts would differ near the
    top and bottom rows."""
    n, h, w = stack.shape
    rows = torch.clamp(torch.arange(-HALO, h + HALO, device=stack.device), 0, h - 1)
    padded = stack[:, rows]                         # [n, h + 8, w], row r <-> y = r - 4
    center = padded[:, HALO - 1:HALO + h + 1]       # rows y = -1 .. h

    def ring(dy, dx):
        part = padded[:, HALO - 1 + dy:HALO + h + 1 + dy]
        return part if dx == 0 else torch.roll(part, -dx, dims=-1)

    diffs = [ring(dy, dx) - center for dy, dx in CIRCLE]

    def arc_min9(ds):
        m3 = [torch.minimum(torch.minimum(ds[i], ds[(i + 1) % 16]), ds[(i + 2) % 16])
              for i in range(16)]
        m9 = [torch.minimum(torch.minimum(m3[i], m3[(i + 3) % 16]), m3[(i + 6) % 16])
              for i in range(16)]
        out = m9[0]
        for i in range(1, 16):
            out = torch.maximum(out, m9[i])
        return out

    score = torch.maximum(arc_min9(diffs), arc_min9([-d for d in diffs]))  # [n, h + 2, w]
    raw = score[:, 1:h + 1]
    keep = torch.ones_like(raw, dtype=torch.bool)
    strictly_before = True
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                strictly_before = False
                continue
            nb = score[:, 1 + dy:1 + dy + h]
            if dx:
                nb = torch.roll(nb, -dx, dims=-1)
            keep &= (raw > nb) if strictly_before else (raw >= nb)
    return raw.contiguous(), torch.where(keep, raw, 0.0)


def fast_score_nms(stack: torch.Tensor):
    """Kernel K3: (raw, masked) FAST score maps of a plane stack [N, H, W].

    Replaces the TPU kernel `pose_estimation_tpu/ops/pallas_fast.py:
    _kernel` (via `fast_score_nms_pallas`). On the H100 it is bound about
    equally by its bytes (4 read and 8 written per pixel) and by ~120
    float32 instructions per pixel, most of them min/max, which issue at
    half the rate of adds; one block of 256 threads stages a 32 x 128 tile
    with its 4-px halo in shared memory, each thread scores one column of
    it with the arcs' window extrema shared (`csrc/fast_common.cuh`), and
    writes both maps. A CUDA tensor launches the kernel (or raises); a CPU
    tensor runs `score_nms_plain`."""
    if not stack.is_cuda:
        return score_nms_plain(stack)
    if stack.dtype != torch.float32 or not stack.is_contiguous() or stack.ndim != 3:
        raise ValueError("fast_score_nms needs a contiguous float32 [N, H, W] stack")
    n, h, w = stack.shape
    raw = torch.empty_like(stack)
    masked = torch.empty_like(stack)
    err = kernels.library().fast_score_nms_launch(
        stack.data_ptr(), raw.data_ptr(), masked.data_ptr(), n, h, w,
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    kernels.check(err, "fast_score_nms")
    fast_score_nms.launches += 1
    return raw, masked


fast_score_nms.launches = 0


def _topk_iter(x: torch.Tensor, k: int):
    """Top-k along the last axis by k (argmax, mask) passes: ties to the
    lower index, values taken from x."""
    comb = x.clone()
    idxs = []
    for _ in range(k):
        idx = torch.argmax(comb, dim=-1, keepdim=True)     # first maximum
        idxs.append(idx)
        comb.scatter_(-1, idx, float("-inf"))
    top_i = torch.cat(idxs, dim=-1)
    return torch.gather(x, -1, top_i), top_i


def select_keypoints_batched(score: torch.Tensor, bounds, th_hi: float, th_lo: float,
                             k_max: int, cell: int = 16, border: int = 19,
                             k_per_cell: int = 4, pre_nms: bool = False,
                             raw_score: torch.Tensor | None = None) -> Keypoints:
    """NMS (or, with pre_nms, a score map already NMS-masked) + per-plane
    detection border + per-cell threshold fallback + per-cell top-k + plane
    top-k + subpixel fit on `raw_score` (default `score`). Counterpart of
    `pose_estimation_tpu/ops/fast.py:select_keypoints_batched`; [N, k_max]
    fields. H and W are padded to cell multiples with -1e9."""
    n, h, w = score.shape
    dev = score.device
    if len(bounds) != n:
        raise ValueError(f"{len(bounds)} bounds for {n} planes")
    keep = (score > 0.0) if pre_nms else nms3(score)
    lh = torch.tensor([b[0] for b in bounds], device=dev)[:, None, None]
    lw = torch.tensor([b[1] for b in bounds], device=dev)[:, None, None]
    ys_ = torch.arange(h, device=dev)[None, :, None]
    xs_ = torch.arange(w, device=dev)[None, None, :]
    inb = (ys_ >= border) & (ys_ < lh - border) & (xs_ >= border) & (xs_ < lw - border)
    s = torch.where(keep & inb, score, NEG)

    hp, wp = -(-h // cell) * cell, -(-w // cell) * cell
    s = torch.nn.functional.pad(s, (0, wp - w, 0, hp - h), value=NEG)
    ncy, ncx = hp // cell, wp // cell
    cells = s.reshape(n, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
        n, ncy * ncx, cell * cell)
    cell_max = cells.amax(dim=2, keepdim=True)
    eligible = torch.where(cell_max > th_hi, cells > th_hi, cells > th_lo)
    cand = torch.where(eligible, cells, NEG)

    top_s, top_i = _topk_iter(cand, k_per_cell)              # [n, C, k]
    cell_id = torch.arange(ncy * ncx, device=dev)[None, :, None]
    py = ((cell_id // ncx) * cell + top_i // cell).reshape(n, -1)
    px = ((cell_id % ncx) * cell + top_i % cell).reshape(n, -1)
    k_max = min(k_max, ncy * ncx * k_per_cell)
    g_s, (gx, gy) = plane_topk(top_s.reshape(n, -1), (px, py), k_max)

    flat = (score if raw_score is None else raw_score).reshape(n, h * w)

    def sc(yy, xx):
        yy = yy.clamp(0, h - 1)
        xx = xx.clamp(0, w - 1)
        return torch.gather(flat, 1, yy * w + xx)

    s0 = sc(gy, gx)
    fx = gx.to(score.dtype) + _para(sc(gy, gx - 1), s0, sc(gy, gx + 1))
    fy = gy.to(score.dtype) + _para(sc(gy - 1, gx), s0, sc(gy + 1, gx))
    return Keypoints(xy=torch.stack([fx, fy], dim=-1), score=g_s, valid=g_s > NEG / 2)
