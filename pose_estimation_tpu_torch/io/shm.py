"""Live stereo-camera ingestion over cluon-compatible POSIX shared memory.

The reference's car mode reads stereo frames from a `cluon::SharedMemory`
segment under a wait/lock protocol published by a separate camera daemon
(`src/cfsd-state-estimation.cpp:99-132`). This module is
the framework's analog, built on `native/shm_frames.cpp` — a
wire-compatible reimplementation of cluon's POSIX SharedMemory layout
(`cluon-complete-v0.0.121.hpp:15005-15230`): header {size, process-shared
robust mutex, process-shared condvar} + payload, sample timestamp on the
shm file's mtime. It can therefore consume frames from a REAL cluon
camera daemon, and `ShmStereoProducer` below can feed a real cluon
consumer (used by the loopback test, tests/test_shm.py — the mirror of
tests/test_od4.py for the UDP wire).

Frame layout convention matches the reference daemon: one side-by-side
stereo image, 8-bit, either 4-channel ARGB/BGRA (`CV_8UC4`, like the
car's camera daemon) or 1-channel grayscale; left half = left camera.

A copy of `pose_estimation_tpu/io/shm.py` (the two packages load the same
`native/libshmframes.so`); `tests/test_torch_io.py` holds the copy equal to
the original.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libshmframes.so"
_lib = None


def available() -> bool:
    global _lib
    if _lib is None and _LIB_PATH.exists():
        _load()
    return _lib is not None


def _load():
    global _lib
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.cluon_shm_create.restype = ctypes.c_void_p
    lib.cluon_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.cluon_shm_attach.restype = ctypes.c_void_p
    lib.cluon_shm_attach.argtypes = [ctypes.c_char_p]
    lib.cluon_shm_size.restype = ctypes.c_uint32
    lib.cluon_shm_size.argtypes = [ctypes.c_void_p]
    lib.cluon_shm_data.restype = ctypes.c_void_p
    lib.cluon_shm_data.argtypes = [ctypes.c_void_p]
    for fn in ("lock", "unlock", "notify_all"):
        f = getattr(lib, f"cluon_shm_{fn}")
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    lib.cluon_shm_wait.restype = ctypes.c_int
    lib.cluon_shm_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cluon_shm_set_timestamp.restype = ctypes.c_int
    lib.cluon_shm_set_timestamp.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    ]
    lib.cluon_shm_get_timestamp.restype = ctypes.c_int
    lib.cluon_shm_get_timestamp.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.cluon_shm_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lib = lib


class _Segment:
    """Shared base: mmap'd view + lock/wait/notify/timestamp plumbing."""

    def __init__(self, handle, owns: bool):
        if not handle:
            raise RuntimeError("shared-memory open failed")
        self._h = handle
        self._owns = owns
        self.size = _lib.cluon_shm_size(self._h)
        buf = (ctypes.c_uint8 * self.size).from_address(
            _lib.cluon_shm_data(self._h)
        )
        self._view = np.frombuffer(buf, dtype=np.uint8)

    def lock(self):
        rc = _lib.cluon_shm_lock(self._h)
        if rc:
            raise RuntimeError(f"shm lock failed ({rc})")

    def unlock(self):
        _lib.cluon_shm_unlock(self._h)

    def notify_all(self):
        _lib.cluon_shm_notify_all(self._h)

    def wait(self, timeout_ms: int = 0) -> bool:
        """cluon wait(); returns False on timeout (timeout_ms > 0)."""
        rc = _lib.cluon_shm_wait(self._h, timeout_ms)
        if rc < 0:
            raise RuntimeError(f"shm wait failed ({-rc})")
        return rc == 0

    def set_timestamp(self, ts_micros: int):
        _lib.cluon_shm_set_timestamp(
            self._h, ts_micros // 1_000_000, ts_micros % 1_000_000
        )

    def get_timestamp(self) -> int:
        sec = ctypes.c_int64()
        usec = ctypes.c_int32()
        _lib.cluon_shm_get_timestamp(
            self._h, ctypes.byref(sec), ctypes.byref(usec)
        )
        return int(sec.value) * 1_000_000 + int(usec.value)

    def close(self):
        if self._h:
            self._view = None
            _lib.cluon_shm_close(self._h, 1 if self._owns else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ShmStereoProducer(_Segment):
    """Synthetic camera daemon: publishes side-by-side stereo frames.

    Stands in for the car's camera process in tests and replay-to-live
    bridging; speaks the exact cluon protocol (lock, copy, set mtime
    timestamp, unlock, notifyAll)."""

    def __init__(self, name: str, width: int, height: int, channels: int = 4):
        if not available():
            raise RuntimeError(
                f"libshmframes.so not built ({_LIB_PATH}); run `make -C native`"
            )
        self.width, self.height, self.channels = width, height, channels
        nbytes = width * height * channels
        super().__init__(
            _lib.cluon_shm_create(name.encode(), nbytes), owns=True
        )

    def publish(self, frame: np.ndarray, ts_micros: int | None = None):
        """frame [H, W] gray or [H, W, C]; W is the side-by-side width."""
        flat = np.ascontiguousarray(frame, dtype=np.uint8).reshape(-1)
        assert flat.size == self.size, (flat.size, self.size)
        self.lock()
        self._view[:] = flat
        self.set_timestamp(
            int(time.time() * 1e6) if ts_micros is None else int(ts_micros)
        )
        self.unlock()
        self.notify_all()


class ShmStereoSource(_Segment):
    """Consumer of a cluon SharedMemory stereo stream (the reference's
    `cfsd-state-estimation.cpp:99-132` loop as an iterator).

    Yields (ts_micros, gray_left [H, W/2], gray_right [H, W/2]) float32.
    """

    def __init__(self, name: str, width: int, height: int, channels: int = 4,
                 timeout_ms: int = 2000):
        if not available():
            raise RuntimeError(
                f"libshmframes.so not built ({_LIB_PATH}); run `make -C native`"
            )
        super().__init__(_lib.cluon_shm_attach(name.encode()), owns=False)
        expected = width * height * channels
        if self.size != expected:
            raise RuntimeError(
                f"shm size {self.size} != expected {expected} "
                f"({width}x{height}x{channels})"
            )
        self.width, self.height, self.channels = width, height, channels
        self.timeout_ms = timeout_ms

    def read(self):
        """Wait for the next frame notification; returns
        (ts, grayL, grayR) or None on timeout."""
        if not self.wait(self.timeout_ms):
            return None
        self.lock()
        try:
            ts = self.get_timestamp()
            img = (
                self._view.reshape(self.height, self.width, self.channels)
                if self.channels > 1
                else self._view.reshape(self.height, self.width)
            ).copy()
        finally:
            self.unlock()
        if self.channels == 4:
            # BGRA (CV_8UC4) -> gray with OpenCV's BT.601 weights
            gray = (
                0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
            ).astype(np.float32)
        elif self.channels == 1:
            gray = img.astype(np.float32)
        else:
            gray = img.mean(axis=-1).astype(np.float32)
        half = self.width // 2
        return ts, gray[:, :half], gray[:, half:]

    def __iter__(self):
        return self

    def __next__(self):
        out = self.read()
        if out is None:
            raise StopIteration
        return out
