"""Batched multi-sequence replay: N recordings stepped in lock-step on one
card.

Counterpart of `pose_estimation_tpu/parallel/batched_slam.py`. Each
sequence bootstraps through SYNCHRONIZING -> SFM -> INITIALIZING in its own
`VisualInertialSLAM` (host-paced, one-time work); then all sequences
advance through the steady-state step together, one batched step
(`parallel.batched.make_batched_step`) per frame index. Sequences keep
independent keyframe decisions, pools and windows, and each draws its
RANSAC uniforms from its own state machine's generator, so lane i of the
batch continues as sequence i's own state machine would, up to the float32
rounding of batched against single products (the extraction is equal bit
for bit; the BA's sums may round apart). The lock-step frames run as
captured graphs (`graphs.BatchedGraphs`, one graph for the batch size).
"""

from __future__ import annotations

import numpy as np
import torch

from pose_estimation_tpu_torch import graphs
from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.parallel import batched
from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM
from pose_estimation_tpu_torch.utils.config import VIOConfig


class BatchedReplay:
    """Drive N sequences in lock-step through the batched step.

    Usage:
        br = BatchedReplay(cfg, n)
        br.bootstrap([feed_0, ..., feed_n-1])   # feed_i(slam) runs sequence
                                                # i's state machine to OK
        br.step(imgs_l, imgs_r, gyrs, accs, masks, timestamps)   # per frame
        br.trajectory(i)
    """

    def __init__(self, cfg: VIOConfig, n: int, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.n = n
        self._graphs: graphs.BatchedGraphs | None = None
        self.slams = [VisualInertialSLAM(cfg, seed=seed + i, device=device)
                      for i in range(n)]
        self.device = self.slams[0].device
        self.consts, self.static = self.slams[0].consts, self.slams[0].static
        self.batched_state = None
        self.trajectories: list[list] = [[] for _ in range(n)]

    def bootstrap(self, feed_fns) -> None:
        """feed_fns[i](slam) drives sequence i's state machine until it
        reaches OK (replaying its own prefix of frames)."""
        for i, fn in enumerate(feed_fns):
            fn(self.slams[i])
            if self.slams[i].state != State.OK:
                raise RuntimeError(f"sequence {i} failed to initialize")
        self.batched_state = batched.stack_states([s.vio for s in self.slams])

    def step(self, imgs_l, imgs_r, gyrs, accs, masks, timestamps=None):
        """One lock-step frame for all sequences; inputs have a leading
        dimension N. Returns the batched metrics (device tensors)."""
        if self.batched_state is None:
            raise RuntimeError("call bootstrap() first")
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a)).to(dev)

        u = torch.stack([torch.stack(vio_mod.draw_ransac_uniforms(s._gen, dev))
                         for s in self.slams])
        inputs = (t(imgs_l), t(imgs_r), t(gyrs), t(accs), t(masks), u)
        if self._graphs is None:
            self._graphs = graphs.BatchedGraphs(self.batched_state, self.consts,
                                                self.static, dev)
        elif self.batched_state is not self._graphs.state:
            self._graphs.load_state(self.batched_state)
        metrics = graphs.snapshot(self._graphs.step(*inputs))
        self.batched_state = self._graphs.state
        if timestamps is not None:
            p = metrics["rec_p"]
            for i, ts in enumerate(timestamps):
                self.trajectories[i].append((int(ts), p[i]))
        return metrics

    def trajectory(self, i: int) -> np.ndarray:
        """[T, 4] (ts, x, y, z) of sequence i's lock-step frames (the
        bootstrap's frames excluded)."""
        if not self.trajectories[i]:
            return np.zeros((0, 4))
        p = torch.stack([q for _, q in self.trajectories[i]]).double().cpu().numpy()
        return np.column_stack([[ts for ts, _ in self.trajectories[i]], p])
