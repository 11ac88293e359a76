"""Checkpoint and resume of the VIO state.

Counterpart of `pose_estimation_tpu/checkpoint.py`: the persistent state
(`models.vio.VIOState`) is one tree of tensors, so a checkpoint is its
leaves, in the tree's field order, as the arrays `leaf_0`, `leaf_1`, ...
of one `.npz`, with the metadata as JSON bytes under `_meta`. The leaf
order is the JAX package's, so the two packages read each other's files.
Loading checks every leaf's shape against `init_vio_state(static)` and
places the state on the requested device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def save_checkpoint(path: str, state: vio_mod.VIOState, meta: dict | None = None):
    """Write a VIOState and optional JSON-able metadata to an .npz file."""
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(tree_leaves(state))}
    arrays["_meta"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_checkpoint(path: str, static: vio_mod.VIOStatic, device):
    """(VIOState on `device`, meta). Raises ValueError when a leaf's shape
    differs from the configuration's (capacities changed)."""
    data = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
    template = vio_mod.init_vio_state(static, device)
    leaves = []
    for i, tmpl in enumerate(tree_leaves(template)):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected "
                             f"{tuple(tmpl.shape)} (config capacities changed?)")
        leaves.append(torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype))
    meta = json.loads(bytes(data["_meta"]).decode()) if "_meta" in data else {}
    return tree_unflatten(template, iter(leaves)), meta
