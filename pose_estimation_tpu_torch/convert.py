"""Carry VIO state between numpy trees and the port's tensors.

The port has no weights; what crosses over is state. `state_from_numpy`
takes any nested NamedTuple with the field names of `models.vio.VIOState`
(for instance the JAX package's state after mapping `np.asarray` over it)
and builds the port's state on `device`; `state_to_numpy` goes back.
`ics_from_numpy` carries stacked IMU constraints (an initializer's or a
refinement's chain), `sfm_chain_from_numpy` the host state machine's SfM
chain (R, p, constraints) and `window_reseed_from_numpy` the window that
the state machine's initializer re-seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.imu.preintegration import ImuConstraint, PreintState
from pose_estimation_tpu_torch.models.pool import FeaturePool
from pose_estimation_tpu_torch.models.vio import VIOState
from pose_estimation_tpu_torch.models.window import WindowState
from pose_estimation_tpu_torch.utils.tree import tree_map

_NESTED = {"win": WindowState, "pool": FeaturePool, "preint": PreintState,
           "ics": ImuConstraint}


def _to_tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device, dtype) if t.is_floating_point() else t.to(device)


def tree_from_numpy(cls, tree, device, dtype=torch.float32):
    """An instance of the port's NamedTuple `cls` (VIOState, WindowState,
    FeaturePool, PreintState or ImuConstraint) from a numpy tree with the
    same field names; floating leaves become `dtype`."""
    fields = {}
    for name in cls._fields:
        sub = getattr(tree, name)
        fields[name] = (tree_from_numpy(_NESTED[name], sub, device, dtype)
                        if name in _NESTED else _to_tensor(sub, device, dtype))
    return cls(**fields)


def ics_from_numpy(ics, device, dtype=torch.float32) -> ImuConstraint:
    """The port's ImuConstraint (single or stacked along a leading axis)
    from a numpy tree with its field names."""
    return tree_from_numpy(ImuConstraint, ics, torch.device(device), dtype)


def sfm_chain_from_numpy(R, p, ics, device, dtype=torch.float32):
    """The state machine's SfM chain as the initializer takes it: (R [W, 3,
    3], p [W, 3], constraints [W-1]) from per-frame numpy lists or arrays
    and the stacked constraints."""
    def t(a):
        return torch.as_tensor(np.stack(a), dtype=dtype, device=device)

    return t(R), t(p), ics_from_numpy(ics, device, dtype)


def window_reseed_from_numpy(init_out, device, dtype=torch.float32):
    """`init_solvers.full_init`'s outputs (R, v, p, dbg, dba, g_est, ics),
    for instance the JAX package's as numpy, as the port's tensors: what
    the state machine re-seeds its window with."""
    *arrays, ics = init_out
    return (*(torch.as_tensor(np.asarray(a), dtype=dtype, device=device) for a in arrays),
            ics_from_numpy(ics, device, dtype))


def state_from_numpy(tree, device) -> VIOState:
    """The port's VIOState (float32) from a numpy tree with VIOState's
    field names."""
    return tree_from_numpy(VIOState, tree, torch.device(device))


def state_to_numpy(state):
    """The same nested NamedTuples with numpy arrays as leaves."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
