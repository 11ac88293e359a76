"""Build and load the CUDA kernels of `csrc/`.

The `.cu` sources (the kernels, the host-side PNG unfilter of
`io/png.py`, the conditional nodes of `graphs.iterate` and `graphs.cond`,
and the span stamps of `profiling.py`) are compiled at first use with
`nvcc` for `sm_90a` into one shared library with a plain C interface,
loaded with `ctypes`. The library lands in `pose_estimation_tpu_torch/build/`
(git-ignored) under a name that carries the hash of the sources, the shared
header and the flags, so an edited source is rebuilt. A failed build
raises. Nothing here runs at import time, so the CPU-only test environment
(no nvcc, no GPU) imports every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("fast_select.cu", "sample_patches.cu", "fast_score_nms.cu",
           "moment_maps.cu", "stream_probe.cu", "small_linalg.cu", "png_unfilter.cu",
           "graph_cond.cu", "span_stamp.cu")
HEADERS = ("fast_common.cuh",)
# No --use_fast_math: the kernels rely on IEEE division and square root
# and on rintf's round-half-to-even, to agree with their torch twins.
# --threads 0: the sources compile side by side, one thread for each.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--threads", "0",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the kernels if their library is missing. Returns (library
    path, seconds spent compiling (0 when cached), the compiler's log)."""
    lib = BUILD / f"libpet_kernels_{_digest()}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with its C signatures declared."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fast_select_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, f, i, i, i, i, p]
    lib.fast_select_launch.restype = i
    lib.sample_patches_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.sample_patches_launch.restype = i
    lib.fast_score_nms_launch.argtypes = [p, p, p, i, i, i, p]
    lib.fast_score_nms_launch.restype = i
    lib.moment_maps_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.moment_maps_launch.restype = i
    lib.moment_maps_smem_bytes.argtypes = [i, i, i]
    lib.moment_maps_smem_bytes.restype = ctypes.c_longlong
    lib.stream_probe_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.stream_probe_launch.restype = i
    lib.small_eigh_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.small_eigh_launch.restype = i
    lib.small_svd3_launch.argtypes = [p, p, p, p, i, p]
    lib.small_svd3_launch.restype = i
    lib.png_unfilter.argtypes = [p, i, i, p]
    lib.png_unfilter.restype = i
    lib.graph_while_begin.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_ulonglong),
                                      ctypes.POINTER(p)]
    lib.graph_while_begin.restype = i
    lib.graph_while_end.argtypes = [p, ctypes.c_ulonglong, p]
    lib.graph_while_end.restype = i
    lib.graph_if_begin.argtypes = lib.graph_while_begin.argtypes
    lib.graph_if_begin.restype = i
    lib.graph_if_end.argtypes = [p]
    lib.graph_if_end.restype = i
    lib.span_stamp.argtypes = [p, p, ctypes.c_longlong, i, i]
    lib.span_stamp.restype = i
    lib.span_clock.argtypes = [p, p, ctypes.POINTER(ctypes.c_longlong),
                               ctypes.POINTER(ctypes.c_longlong)]
    lib.span_clock.restype = i
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
