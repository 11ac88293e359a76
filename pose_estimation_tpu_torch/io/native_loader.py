"""ctypes bindings for the native C++ ingestion runtime (native/ingest.cpp).

Optional fast path for replay: a C++ worker thread reads CSVs, decodes
stereo pairs, and prefetches frames into a bounded ring, overlapping host
I/O with device compute. Falls back gracefully when the library is absent.

A copy of `pose_estimation_tpu/io/native_loader.py` (the two packages load
the same `native/libingest.so`), except that `available()` answers False
where the library cannot load: it links OpenCV's image codecs.
`tests/test_torch_io.py` holds the copy equal to the original.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libingest.so"
_lib = None


def available() -> bool:
    """Whether the library loads: False where it is missing or cannot load
    (it links OpenCV's image codecs, which a machine may lack)."""
    global _lib
    if _lib is None and _LIB_PATH.exists():
        try:
            _load()
        except OSError:
            return False
    return _lib is not None


def _load():
    global _lib
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.euroc_open.restype = ctypes.c_void_p
    lib.euroc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.euroc_close.argtypes = [ctypes.c_void_p]
    lib.euroc_next.restype = ctypes.c_int
    lib.euroc_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib


class NativeEurocLoader:
    """Iterator of (ts, gray_left, gray_right, imu [M,7]) with C++ prefetch."""

    def __init__(self, mav0_dir: str, speed_up: int = 1,
                 max_frames: int = -1, queue_cap: int = 4,
                 max_wh: tuple[int, int] = (1024, 1024), imu_cap: int = 4096):
        if not available():
            raise RuntimeError(
                f"native ingest library not built ({_LIB_PATH}); run "
                "`make -C native`"
            )
        self._h = _lib.euroc_open(
            str(mav0_dir).encode(), speed_up, max_frames or -1, queue_cap
        )
        if not self._h:
            raise RuntimeError(f"failed to open dataset {mav0_dir}")
        self._img_cap = max_wh[0] * max_wh[1]
        self._imu_cap = imu_cap
        self._left = np.empty(self._img_cap, np.uint8)
        self._right = np.empty(self._img_cap, np.uint8)
        self._imu = np.empty(self._imu_cap * 7, np.float64)

    def __iter__(self):
        return self

    def __next__(self):
        ts = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        nimu = ctypes.c_int()
        rc = _lib.euroc_next(
            self._h, ctypes.byref(ts),
            self._left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(w), ctypes.byref(h), self._img_cap,
            self._imu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self._imu_cap, ctypes.byref(nimu),
        )
        if rc == 0:
            raise StopIteration
        if rc < 0:
            raise RuntimeError("frame larger than buffer capacity")
        shape = (h.value, w.value)
        left = self._left[: shape[0] * shape[1]].reshape(shape).copy()
        right = self._right[: shape[0] * shape[1]].reshape(shape).copy()
        imu = self._imu[: nimu.value * 7].reshape(-1, 7).copy()
        return ts.value, left, right, imu

    def close(self):
        if self._h:
            _lib.euroc_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
