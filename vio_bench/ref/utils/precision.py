"""Float32 precision policy and the device guard.

The JAX package sets full-f32 matmul precision because a TPU's default
one-pass bf16 matmul moved the simulator ATE from 2.3 % to 61-165 % of path
(`pose_estimation_tpu/models/vio.py`, `build_constants`). TF32 is the same
trap on a GPU: it keeps about three decimal digits. `apply_policy` turns it
off for matmuls and cuDNN and checks that nothing re-enabled it.
"""

from __future__ import annotations

import torch


def apply_policy(device=None) -> None:
    """Full-f32 matmuls and convolutions; raises if the process asked for
    less. On a CUDA `device`, linear algebra on cuSOLVER and cuBLAS: for
    some batched shapes PyTorch picks MAGMA, whose paths read pivots and
    error codes on the host, which a captured CUDA graph cannot do
    (`graphs.py`) and which costs a host sync eagerly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is not None and torch.device(device).type == "cuda":
        torch.backends.cuda.preferred_linalg_library("cusolver")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; the solver and geometry "
            "path needs 'highest' (TF32 breaks the accuracy gates)"
        )


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when there is no GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs on the GPU only")
    return torch.device("cuda", torch.cuda.current_device())
