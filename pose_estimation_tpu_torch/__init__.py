"""pose_estimation_tpu_torch — the steady-state VIO frame step in PyTorch.

A port of `pose_estimation_tpu` (JAX) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (`csrc/`). The layout mirrors the JAX package:
each module here is the counterpart of the module of the same path there.
The package imports `torch` and numpy only; the JAX package stays the
reference the port is tested against (`tests/test_torch_*.py`).

Entry point: `models.vio.build_constants` then `models.vio.ok_step`.
"""

__version__ = "0.1.0"
