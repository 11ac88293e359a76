"""Carry VIO state between numpy trees and the port's tensors.

The port has no weights; what crosses over is state. `state_from_numpy`
takes any nested NamedTuple with the field names of `models.vio.VIOState`
(for instance the JAX package's state after mapping `np.asarray` over it)
and builds the port's state on `device`; `state_to_numpy` goes back.
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch.imu.preintegration import ImuConstraint, PreintState
from pose_estimation_tpu_torch.models.pool import FeaturePool
from pose_estimation_tpu_torch.models.vio import VIOState
from pose_estimation_tpu_torch.models.window import WindowState

_NESTED = {"win": WindowState, "pool": FeaturePool, "preint": PreintState,
           "ics": ImuConstraint}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def tree_from_numpy(cls, tree, device):
    """An instance of the port's NamedTuple `cls` (VIOState, WindowState,
    FeaturePool, PreintState or ImuConstraint) from a numpy tree with the
    same field names."""
    fields = {}
    for name in cls._fields:
        sub = getattr(tree, name)
        fields[name] = (tree_from_numpy(_NESTED[name], sub, device) if name in _NESTED
                        else _to_tensor(sub, device))
    return cls(**fields)


def state_from_numpy(tree, device) -> VIOState:
    """The port's VIOState from a numpy tree with VIOState's field names."""
    return tree_from_numpy(VIOState, tree, torch.device(device))


def state_to_numpy(state):
    """The same nested NamedTuples with numpy arrays as leaves."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return type(state)(*(state_to_numpy(s) for s in state))
