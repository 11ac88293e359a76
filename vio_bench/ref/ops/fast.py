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

In the reference each wrapper runs its twin on every device. The plane
top-k stays in torch as a stable
descending sort: `lax.top_k` breaks ties toward the lower index and
level-0 scores are integers, so ties are common.

K1's output contract: for each plane, candidates in raster order
(cell-row, cell-col, k) with C = n_cell_rows * (W / 16) * k_per_cell,
n_cell_rows = 2 * ceil(H / 32): score [N, C] (invalid -1e9), flat code
y * W + x [N, C] int32 (invalid 0), subpixel x, y [N, C] (invalid 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch


NEG = -1e9
# planes the reference's twins take at a time
PLANES_A_BLOCK = 16
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


@functools.lru_cache(maxsize=32)
def bounds_tensors(bounds: tuple, device):
    """(heights, widths) [N, 1, 1] of the planes' content on `device`, made
    once per stack shape: a tensor made from host values inside a step is
    a copy to the card, which a CUDA graph cannot capture."""
    return tuple(torch.tensor([b[i] for b in bounds], device=device)[:, None, None]
                 for i in (0, 1))


def select_plain(stack: torch.Tensor, bounds, th_hi: float, th_lo: float,
                 border: int = 19, k_per_cell: int = 4):
    """Twin of kernel K1: FAST score -> NMS -> gates -> per-cell threshold
    fallback -> top-k per cell -> subpixel fit. Returns (vals, codes, xs,
    ys), each [N, C], in the module's output contract."""
    n, h, w = stack.shape
    dev = stack.device
    score = fast_score(stack)
    keep = nms3(score)
    lh, lw = bounds_tensors(tuple(bounds), dev)
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


def fast_select(stack: torch.Tensor, bounds, th_hi: float, th_lo: float,
                border: int = 19, k_per_cell: int = 4):
    """Kernel K1's results by its twin `select_plain`, the planes taken
    PLANES_A_BLOCK at a time (each plane is independent), so that a batch's
    stack fits beside the twin's intermediates: (vals, codes, xs, ys)."""
    parts = [select_plain(stack[lo:lo + PLANES_A_BLOCK], bounds[lo:lo + PLANES_A_BLOCK],
                          th_hi, th_lo, border, k_per_cell)
             for lo in range(0, stack.shape[0], PLANES_A_BLOCK)]
    return tuple(torch.cat(a) for a in zip(*parts))


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
    """Kernel K3's results (raw and NMS-masked score maps) by its twin
    `score_nms_plain`, PLANES_A_BLOCK planes at a time."""
    parts = [score_nms_plain(stack[lo:lo + PLANES_A_BLOCK])
             for lo in range(0, stack.shape[0], PLANES_A_BLOCK)]
    return tuple(torch.cat(a) for a in zip(*parts))


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
    lh, lw = bounds_tensors(tuple(bounds), dev)
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
