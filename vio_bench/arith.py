"""The benchmark's arithmetic: percentiles and rates, the spread of runs,
the device's busy time from a profiler trace, and the least time of
kernels K1 and K3 at a cell's shapes (their roofline's numerator).

The busy time, the bound and the counts are copies of `chip_smoke.py`'s
`device_activity`, `bound`, `HBM_BYTES_PER_S`, `FP32_INSTR_PER_S` and
`FAST_OPS_PER_PX` with K1's and K3's byte and instruction counts, kept
here so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math
import statistics

# The least time the card could take (NVIDIA H100 SXM data sheet at 700 W):
# HBM bytes over 3.35 TB/s, or float32 instructions outside the tensor
# cores over their issue rate, whichever is larger. The data sheet's
# 67 TFLOP/s counts a fused multiply-add as two operations; one min, max,
# subtraction, compare or multiply-add issues at half that rate, 33.5e12
# a second (132 SMs x 128 float32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
# float32 instructions per pixel of the FAST-9 score and 3x3 NMS in the
# least form known: 16 ring differences, for each polarity the 8 two-,
# four- and eight-long window extrema that the 16 nine-long arcs share
# (24), the pairs of arcs (16) and the reduction over them (7), the
# polarity max (1), 8 NMS compares.
FAST_OPS_PER_PX = 16 + 2 * (24 + 16 + 7) + 1 + 8
# K1's selection: cells of 16 x 16 px in bands of 32 rows, 4 slots a cell
# (`ops/fast.py` CELL, BAND; `OrbConfig.k_per_cell`); its border gates and
# per-cell top-4 take 8 more compares a pixel.
CELL, BAND, K_PER_CELL = 16, 32, 4
K1_EXTRA_OPS_PER_PX = 8
EDGE = 19


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between the closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if pos == lo or xs[hi] == xs[lo]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError("a rate over no time")
    return count / seconds


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (`statistics.quantiles(values, n=4)`)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals, overlaps once."""
    busy, lo, hi = 0.0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + (0.0 if hi is None else hi - lo)


def merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def bound_ms(n_bytes: float, n_instr: float, instr_per_s: float = FP32_INSTR_PER_S):
    """(least time in ms, "bytes" or "operations") for `n_bytes` of HBM
    traffic and `n_instr` instructions."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_instr / instr_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pyramid_shapes(h: int, w: int, levels: int, scale: float) -> list:
    """Each pyramid level's content size (level 0 the image), as the ORB
    extractor sizes them."""
    shapes = [(h, w)]
    for lvl in range(1, levels):
        shapes.append((max(int(round(h / scale ** lvl)), 2 * EDGE + 8),
                       max(int(round(w / scale ** lvl)), 2 * EDGE + 8)))
    return shapes


def k1_counts(images: int, h: int, w: int, levels: int, scale: float):
    """(bytes, instructions) of one K1 launch over the plane stack of
    `images` images: each plane's content read once (no keypoint lies in
    the stack's zero padding), its four [planes, cells] outputs written
    once; FAST + NMS and the gates per content pixel."""
    content = images * sum(lh * lw for lh, lw in pyramid_shapes(h, w, levels, scale))
    planes = images * levels
    cells = (-(-h // BAND) * BAND // CELL) * (w // CELL) * K_PER_CELL
    out_bytes = 4 * planes * cells * 4
    return content * 4 + out_bytes, content * (FAST_OPS_PER_PX + K1_EXTRA_OPS_PER_PX)


def k3_counts(images: int, h: int, w: int, levels: int):
    """(bytes, instructions) of one K3 launch over the zero-padded plane
    stack of `images` images: 4 bytes read and 8 written per pixel, FAST +
    NMS per pixel."""
    px = images * levels * h * w
    return px * 12, px * FAST_OPS_PER_PX
