"""8-bit grayscale PNG reader: the replay readers' image reader on a
machine without OpenCV.

EuRoC's and KITTI's frames are 8-bit grayscale, non-interlaced PNGs. A
file is its chunks (each CRC-checked); the IDAT data inflate with `zlib`
to one filtered row per image row, a filter-type byte before each, and
undoing the five row filters (None, Sub, Up, Average, Paeth) gives the
pixels. Any other PNG (colour, another bit depth, interlaced) is refused
with ValueError.

Average and Paeth predict a byte from its reconstructed left and upper
neighbours, so a row is a sequential loop. `unfilter` runs that loop in C
(`csrc/png_unfilter.cu`, host code built into the port's kernel library);
`unfilter_plain` is its numpy twin, which undoes all rows at once, one
anti-diagonal of the image at a time (every byte of an anti-diagonal
depends only on the one before it). `reader(device)` gives the replay
readers' default: the C unfilter where the replay runs on the GPU, the
twin on the CPU; files other than PNGs go to OpenCV, imported when first
needed.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np
import torch

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_TYPES = ("none", "sub", "up", "average", "paeth")


def read_filtered(path: str) -> np.ndarray:
    """The inflated image data of an 8-bit grayscale, non-interlaced PNG:
    [H, 1 + W] uint8, each row's filter type, then its filtered bytes."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        end = pos + 12 + length
        body = data[pos + 8:end - 4]
        if end > len(data) or zlib.crc32(kind + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        pos = end
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if (depth, color, compression, filter_method, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}: only "
            "8-bit grayscale (colour type 0), non-interlaced PNGs are read")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for {width}x{height}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, width + 1)
    if (rows[:, 0] >= len(FILTER_TYPES)).any():
        raise ValueError(f"{path}: unknown row filter type {int(rows[:, 0].max())}")
    return rows


def unfilter_plain(rows: np.ndarray) -> np.ndarray:
    """Twin of `unfilter`: the pixels [H, W] uint8 of [H, 1 + W] filtered
    rows, all rows at once over the image's anti-diagonals."""
    h, w = rows.shape[0], rows.shape[1] - 1
    kind = rows[:, 0].astype(np.int64)
    filt = rows[:, 1:].astype(np.int64)
    x = np.zeros((h + 1, w + 1), np.int64)      # a zero row above, a zero column left
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        left, up, corner = x[r + 1, c], x[r, c + 1], x[r, c]
        p = left + up - corner
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
        pred = np.choose(kind[r], (np.zeros_like(left), left, up, (left + up) >> 1, paeth))
        x[r + 1, c + 1] = (filt[r, c] + pred) & 0xFF
    return x[1:, 1:].astype(np.uint8)


def unfilter(rows: np.ndarray) -> np.ndarray:
    """The pixels [H, W] uint8 of [H, 1 + W] filtered rows, by the C
    unfilter of the port's library (built at first use)."""
    from pose_estimation_tpu_torch.ops import kernels

    rows = np.ascontiguousarray(rows, np.uint8)
    h, w = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, w), np.uint8)
    bad = kernels.library().png_unfilter(rows.ctypes.data_as(ctypes.c_void_p), h, w,
                                         out.ctypes.data_as(ctypes.c_void_p))
    if bad:
        raise ValueError(f"png_unfilter: unknown filter type in row {bad - 1}")
    return out


def read_png(path: str, unfilter_fn=unfilter) -> np.ndarray:
    """An 8-bit grayscale PNG as a [H, W] uint8 array."""
    return unfilter_fn(read_filtered(path))


def reader(device):
    """The replay readers' default `imread` for a replay on `device`:
    path -> [H, W] uint8 grayscale, or None when the file is missing (as
    OpenCV's `imread` answers, which the readers skip). PNGs are read here
    (the C unfilter on a CUDA device, its twin on the CPU); other files
    by OpenCV, which must then be installed."""
    unfilter_fn = unfilter if torch.device(device).type == "cuda" else unfilter_plain

    def imread(path: str):
        if not path.lower().endswith(".png"):
            import cv2

            return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if not os.path.exists(path):
            return None
        return read_png(path, unfilter_fn)

    return imread
