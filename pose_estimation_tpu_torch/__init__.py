"""pose_estimation_tpu_torch — the stereo VIO system in PyTorch.

A port of `pose_estimation_tpu` (JAX) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (`csrc/`). The layout mirrors the JAX package:
each module here is the counterpart of the module of the same path there.
The package imports `torch` and numpy only; the JAX package stays the
reference the port is tested against (`tests/test_torch_*.py`).

Entry points: the replay CLIs (`python -m pose_estimation_tpu_torch.run_euroc
--config ... --dataset-dir ...`, `run_kitti`, `run_cfsd`), `load_config`
of the reference's OpenCV-YAML files, `slam.VisualInertialSLAM` (one
sequence through the state machine), `parallel.batched_slam.BatchedReplay`
(many in lock-step), and the frame steps themselves, `models.vio.ok_step`
and `parallel.batched.make_batched_step`.
"""

__version__ = "0.1.0"

from pose_estimation_tpu_torch.utils.config import (  # noqa: F401
    PROFILES,
    VIOConfig,
    WINDOW_SIZE,
    load_config,
)
