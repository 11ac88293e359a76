"""What decides `correct`: the poses that the timed window produced, held
to the plain reference (`ref/`, the port's eager frame step and batched
step as they stood when the benchmark was written, on plain twins of the
hand kernels) run on the same frames and IMU samples.

The reference starts from one of two places. From the program's state:
at window frames drawn from the seed the harness copies the program's
state (the window, the pool, the running preintegration, the biases) and
the RANSAC generators' states before the frame; once the window has closed
and the program is freed, the reference rebuilds its own configuration
from the YAML, its own constants and a state of its own from those
copies, and runs `chain` frames from there, its own pool update and window
shift feeding the next of them. Or, in a batch, from the start: the
reference seeds every lane at its true state itself, as the harness seeded
the program's, and runs the set-up's steps and the window's first ones.
Each frame's pose is compared with the pose the program reported for it:
the position gap in metres and the rotation gap in radians, over every
lane-frame of every sample. A frame the program gave no finite pose for
fails the run outright.

The control (`control.py`) is the same reference with TF32 on for its
matmuls and convolutions, in the program's place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# The numbers a cell holds to a limit (`limits/<cell>.json`): the largest
# position and rotation gap over every compared lane-frame.
NUMBERS = ("pos_gap_max_m", "rot_gap_max_rad")


def leaves(tree) -> list:
    """The tensors of nested (named) tuples or dicts, depth first in field
    order."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for sub in tree for leaf in leaves(sub)]


def unflatten(template, it):
    import torch

    if isinstance(template, torch.Tensor):
        return next(it)
    parts = [unflatten(t, it) for t in template]
    return type(template)(*parts) if hasattr(template, "_fields") else type(template)(parts)


def copy_leaves(tree) -> list:
    """Copies of a tree's tensors, made in one launch (the leaves' bytes
    concatenated): what the harness takes of the program's state."""
    import torch

    ls = leaves(tree)
    # widest first, so that every leaf's bytes start aligned to its type
    order = sorted(range(len(ls)), key=lambda i: -ls[i].element_size())
    flat = torch.cat([ls[i].contiguous().reshape(-1).view(torch.uint8) for i in order])
    out, at = [None] * len(ls), 0
    for i in order:
        n = ls[i].numel() * ls[i].element_size()
        out[i] = flat[at:at + n].view(ls[i].dtype).reshape(ls[i].shape)
        at += n
    return out


@dataclasses.dataclass
class Sample:
    """Where the reference starts and the frames it runs from there:
    `frames[k]` the world frame index of each lane at the k-th step (one
    lane for a single sequence; a batched state's lanes in order). It
    starts from `state`, the program's state before the first step (its
    leaves), with the RANSAC generators at `gen_states`; or, where `state`
    is None, from each lane seeded at its true state at `frames[0]` with a
    generator seeded `gen_seeds[lane]`."""

    state: list | None
    gen_states: list
    frames: list
    batched: bool = False
    gen_seeds: list | None = None


def rot_gap(q1, q2) -> float:
    """The angle [rad] between two rotations given as (w, x, y, z)."""
    def mat(q):
        w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
        return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    r = mat(q1).T @ mat(q2)
    s = np.linalg.norm([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2
    return float(math.atan2(s, (np.trace(r) - 1) / 2))


class Reference:
    """The frozen frame step (and batched step) at the cell's
    configuration, on `device`."""

    def __init__(self, yaml, dataset: str, overrides: dict, device):
        import dataclasses as dc

        import torch

        from vio_bench.ref.camera import CameraModel
        from vio_bench.ref.models import vio
        from vio_bench.ref.parallel import batched
        from vio_bench.ref.utils.config import load_config

        cfg = load_config(yaml, dataset=dataset)
        if overrides:
            cfg = dc.replace(cfg, **overrides)
        self.device = torch.device(device)
        self.vio = vio
        self.consts, self.static = vio.build_constants(cfg, CameraModel.from_config(cfg),
                                                       self.device)
        self.template = vio.init_vio_state(self.static, self.device)
        self.batched = batched

    def seeded(self, world, first: int):
        """A lane's state at frame `first`: every window frame at the true
        pose and velocity of the frame before it."""
        import torch

        r, p, v = world.truth(first - 1)
        state = self.template
        wlen = state.win.R.shape[0]

        def rep(a, shape):
            return torch.as_tensor(np.broadcast_to(a, shape).copy(), dtype=torch.float32,
                                   device=self.device)
        return state._replace(win=state.win._replace(
            R=rep(r, (wlen, 3, 3)), p=rep(p, (wlen, 3)), v=rep(v, (wlen, 3))))

    def run(self, sample: Sample, world, tf32: bool = False) -> list:
        """[(p [L, 3], q [L, 4], keyframe [L])] of the sample's steps, run
        from its start, L the lanes (1 for a single sequence)."""
        import torch

        dev = self.device
        if sample.state is None:
            state = self.batched.stack_states(
                [self.seeded(world, f) for f in sample.frames[0]])
            gens = [torch.Generator(device=dev).manual_seed(s) for s in sample.gen_seeds]
        else:
            template = self.template
            if sample.batched:
                template = self.batched.stack_states([template] * len(sample.gen_states))
            state = unflatten(template, iter(t.to(dev).clone() for t in sample.state))
            gens = []
            for gs in sample.gen_states:
                g = torch.Generator(device=dev)
                g.set_state(gs)
                gens.append(g)
        step_b = self.batched.make_batched_step(self.consts, self.static)
        before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        out = []

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        try:
            with torch.no_grad():
                for frames in sample.frames:
                    fr = np.asarray(frames)
                    u = [self.vio.draw_ransac_uniforms(g, dev) for g in gens]
                    if sample.batched:
                        u_b = torch.stack([torch.stack(x) for x in u])
                        mask = np.broadcast_to(world.mask, (len(fr), world.m))
                        state, met = step_b(state, t(world.left[fr]), t(world.right[fr]),
                                            t(world.gyr_chunks[fr]), t(world.acc_chunks[fr]),
                                            t(mask), u_b)
                        p, q, kf = met["rec_p"], met["rec_quat"], met["is_keyframe"]
                    else:
                        g, a, m = world.chunk(int(fr[0]))
                        state, met = self.vio.ok_step(
                            state, t(world.left[fr[0]]), t(world.right[fr[0]]), t(g), t(a), t(m),
                            None, self.consts, self.static, ransac_u=u[0])
                        p, q, kf = met["rec_p"][None], met["rec_quat"][None], met["is_keyframe"][None]
                    out.append((p.double().cpu().numpy(), q.double().cpu().numpy(),
                                kf.cpu().numpy().astype(bool)))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
        return out


def gaps(reference: Reference, samples, world, program_pose, tf32: bool = False) -> dict:
    """The largest position and rotation gaps between `program_pose(sample, k)` ((p [L, 3], q [L, 4]) of the
    sample's k-th step, or None) and the reference's poses over every
    lane-frame of every sample; how many lane-frames were compared, how
    many of them the reference made keyframes, and how many the program
    gave no finite pose for (their gaps count as infinite)."""
    pos, ang, keyframes, nonfinite = [], [], 0, 0
    for s in samples:
        for k, (p_ref, q_ref, kf) in enumerate(reference.run(s, world, tf32)):
            got = program_pose(s, k)
            for lane in range(len(p_ref)):
                keyframes += bool(kf[lane])
                if got is None or not (np.all(np.isfinite(got[0][lane]))
                                       and np.all(np.isfinite(got[1][lane]))):
                    nonfinite += 1
                    pos.append(math.inf)
                    ang.append(math.inf)
                    continue
                pos.append(float(np.linalg.norm(got[0][lane] - p_ref[lane])))
                ang.append(rot_gap(got[1][lane], q_ref[lane]))
    if not pos:
        return {**dict.fromkeys(NUMBERS, math.inf), "frames": 0, "keyframes": 0,
                "nonfinite": 0}
    return {"pos_gap_max_m": max(pos), "rot_gap_max_rad": max(ang),
            "frames": len(pos), "keyframes": keyframes, "nonfinite": nonfinite}


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number that the
    cell's limits name within its limit, at least one lane-frame compared,
    and none without a finite pose."""
    def finite(x):
        return x if math.isfinite(x) else None     # JSON has no infinity
    shown = {k: {"value": finite(found[k]), "limit": limits[k]} for k in limits}
    ok = (found["frames"] > 0 and found["nonfinite"] == 0
          and all(found[k] <= limits[k] for k in limits))
    shown["nonfinite_poses"] = {"value": found["nonfinite"], "limit": 0}
    shown["frames_compared"] = {"value": found["frames"], "limit": 1}
    return ok, shown
