"""Shared fixtures of the PyTorch-port parity tests (`test_torch_*.py`).

Both packages are built from the same small synthetic configuration; data
moves between them as numpy arrays. `jax_setup` and `torch_setup` give the
kernel path: the JAX side runs on the CPU with the descriptor sampler in
Pallas interpret mode (`sample_backend="pallas_interpret"`), the port with
its defaults (per-level reflect-101 canvases and rotation by m/r).
`jax_map_setup` and `torch_map_setup` give the map path (full-stack blur
and atan2/cos/sin), which is the JAX package's own default on a CPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# 160x128, 3 levels, 200 features; 40 Hz frames so that one frame's 5 IMU
# samples fit an 8-sample chunk.
SMALL = dict(width=160, height=128, levels=3, features=200,
             camera_frequency=40, imu_chunk=8)


def jax_setup(**overrides):
    """(cfg, consts, static) of the JAX package, sampler in interpret mode."""
    from pose_estimation_tpu.camera import CameraModel
    from pose_estimation_tpu.models import vio
    from pose_estimation_tpu.testing import synthetic_config

    cfg = synthetic_config(**{**SMALL, **overrides})
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg))
    static = dataclasses.replace(
        static, orb=static.orb._replace(sample_backend="pallas_interpret")
    )
    return cfg, consts, static


def torch_setup(**overrides):
    """(cfg, consts, static) of the port on the CPU."""
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.testing import synthetic_config

    cfg = synthetic_config(**{**SMALL, **overrides})
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), "cpu")
    return cfg, consts, static


MAP_BACKENDS = dict(fast_backend="xla", sample_backend="xla")


def jax_map_setup(moments_backend="sparse", **overrides):
    """(cfg, consts, static) of the JAX package on the map path, its CPU
    default, with the given IC-angle formulation."""
    from pose_estimation_tpu.camera import CameraModel
    from pose_estimation_tpu.models import vio
    from pose_estimation_tpu.testing import synthetic_config

    cfg = synthetic_config(**{**SMALL, **overrides})
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg))
    assert (static.orb.fast_backend, static.orb.sample_backend) == ("xla", "xla")
    static = dataclasses.replace(
        static, orb=static.orb._replace(moments_backend=moments_backend))
    return cfg, consts, static


def torch_map_setup(moments_backend="sparse", **overrides):
    """(cfg, consts, static) of the port on the CPU, on the map path."""
    cfg, consts, static = torch_setup(**{**MAP_BACKENDS, **overrides})
    static = dataclasses.replace(
        static, orb=static.orb._replace(moments_backend=moments_backend))
    return cfg, consts, static


@functools.lru_cache(maxsize=4)
def world(n_frames: int, n_landmarks: int = 250, **overrides):
    """`tests/sim.py:sim_world` frames and IMU as numpy, plus truth(j)."""
    from sim import sim_world

    from pose_estimation_tpu.testing import synthetic_config

    cfg = synthetic_config(**{**SMALL, **overrides})
    frames, gyrs, accs, mask, state0 = sim_world(cfg, n_frames, n_landmarks=n_landmarks,
                                                 seed=0)
    frames = [(np.asarray(l), np.asarray(r)) for l, r in frames]
    return (frames, [np.asarray(g) for g in gyrs], [np.asarray(a) for a in accs],
            np.asarray(mask), state0)


def ransac_uniforms(key):
    """JAX's RANSAC uniforms of one frame: the (stereo, temporal) [64, 8]
    draws that `jax.random.choice` makes from split(key) in `front_end`."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(key)
    return tuple(
        np.asarray(jax.random.uniform(k, (64, 8), dtype=jnp.float32)) for k in (k1, k2)
    )


def to_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)
