#!/usr/bin/env python3
"""Where a lane of the batched frame step parts from the single step.

Run from the repository root on a machine with one NVIDIA GPU (or with
`--device cpu`, at the same shapes, for the CPU's reading):

    python3 tools/lane_diff.py [--batch 8] [--device cuda]

Builds the batch of `chip_smoke.py` phase 9 (lane j starts from the
seeded EuRoC-width window at frame j, its RANSAC draws from generator
100 + j), steps one batched frame, then takes the second frame apart:

1. extraction: each lane's features from the batched extraction (one
   pyramid product per level over all 2B images) against the lane's own
   extraction: the pyramid levels' largest difference, the keypoints
   whose position, score or level differ, the descriptor bits that differ
   on the others;
2. the step after extraction on identical inputs (the batched features,
   each lane's slice for the single step): `vmap(track_step)` against
   `track_step` per lane, op by op under a `TorchFunctionMode` that
   records the tensor outputs of every torch call (under vmap, the lane's
   slice of the physical batch). Per lane: the first call whose output
   differs (and where in the port it is made), the first such call with
   an integer or boolean output (a decision), and the lane's counts,
   LM iterations and position both ways;
3. the first differing call replayed on its recorded inputs: alone,
   under vmap with a batch of 1 (a fake batch dimension), under vmap with
   B copies of the one lane, and on the CPU alone and with B copies.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _smoke():
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _site():
    """file:line of the innermost frame of the port that made the call."""
    f = sys._getframe(2)
    while f is not None and "pose_estimation_tpu_torch" not in f.f_code.co_filename:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.relpath(f.f_code.co_filename, REPO)}:{f.f_lineno}"


def _recorder(capture_at=None):
    """A TorchFunctionMode that appends (name, site, [outputs]) for every
    torch call with tensor outputs; under vmap the outputs are the
    physical tensors with the batch dimension first (None where a tensor
    is not batched). With `capture_at`, also keeps that call's (func,
    args, kwargs), tensors cloned."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_flatten, tree_map

    ft = torch._C._functorch

    def phys(t):
        if ft.is_batchedtensor(t):
            return ft.get_unwrapped(t).movedim(ft.maybe_get_bdim(t), 0).detach().clone(), True
        return t.detach().clone(), False

    class Rec(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls, self.captured = [], None

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if capture_at is not None and len(self.calls) == capture_at:
                clone = lambda a: a.detach().clone() if isinstance(a, torch.Tensor) else a  # noqa: E731
                self.captured = (func, tree_map(clone, args), tree_map(clone, kwargs))
            out = func(*args, **kwargs)
            leaves = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if leaves:
                self.calls.append((getattr(func, "__name__", str(func)), _site(),
                                   [phys(t) for t in leaves]))
            return out

    return Rec()


def _same(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return bool(torch.equal(a, b))


def _diff(a, b) -> float:
    import torch

    if a.shape != b.shape:
        return float("inf")
    if not a.is_floating_point():
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a.double() - b.double()).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if a.numel() else 0.0


def first_differences(a_calls, a_lane, b_calls, b_lane):
    """(first differing call, first differing decision, where the call
    sequences part) between two recordings, each read at its lane (None
    for a single step's): the first two dicts of index, name, site,
    largest difference, or None."""
    first = decision = None

    def at(t, batched, lane):
        return t[lane] if batched and lane is not None else t

    for i, ((name, site, outs), (bname, _, bouts)) in enumerate(zip(a_calls, b_calls)):
        if name != bname or len(outs) != len(bouts):
            return first, decision, dict(index=i, name=name, other=bname, site=site)
        for (a, a_b), (b, b_b) in zip(outs, bouts):
            x, y = at(a, a_b, a_lane), at(b, b_b, b_lane)
            if name == "index_put" and x.dim():
                # the last row of the port's indexed writes takes the
                # dropped rows (`tracker.compact`, `pool._scatter_rows`):
                # several write it, and on a GPU any of them may win
                x, y = x[:-1], y[:-1]
            if not _same(x, y):
                rec = dict(index=i, name=name, site=site, diff=_diff(x, y),
                           dtype=str(x.dtype).replace("torch.", ""), shape=list(x.shape))
                first = first or rec
                if not x.is_floating_point() and decision is None:
                    decision = rec
                break
        if first is not None and decision is not None:
            break
    return first, decision, None


def replay(captured, reference, batch, device):
    """The captured call on `device`: alone against `reference` (the
    single step's recorded output), and under vmap with batch 1 and with
    `batch` copies against the call alone; each the outputs' largest
    difference."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

    func, args, kwargs = captured
    mv = lambda a: a.to(device) if isinstance(a, torch.Tensor) else a  # noqa: E731
    args, kwargs = tree_map(mv, args), tree_map(mv, kwargs)
    leaves, spec = tree_flatten((args, kwargs))
    pos = [i for i, a in enumerate(leaves) if isinstance(a, torch.Tensor)]
    ref = [r.to(device) for r, _ in reference]

    def call(*ts):
        ls = list(leaves)
        for i, t in zip(pos, ts):
            ls[i] = t
        a, k = tree_unflatten(ls, spec)
        out = func(*a, **k)
        return tuple(t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))

    def worst(outs, refs, lanes):
        return max(_diff(o[j] if lanes else o, r) for o, r in zip(outs, refs)
                   for j in (range(lanes) if lanes else [None]))

    alone = call(*[leaves[i] for i in pos])
    res = {"alone": worst(alone, ref, 0)}
    for n in (1, batch):
        ts = [leaves[i].expand((n,) + leaves[i].shape).contiguous() for i in pos]
        res[f"vmap_{n}"] = worst(torch.func.vmap(call)(*ts), alone, n)
    return res


def extraction_diff(lane_in, inputs, fl, fr, consts, static):
    """Per lane: the batched extraction's pyramid and features against the
    lane's own extraction (`inputs[j]` is lane j's frame)."""
    import torch

    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import orb

    b = lane_in[0].shape[0]
    imgs = torch.cat([lane_in[0], lane_in[1]]).float()
    lv_b = orb.pyramid_levels(imgs, consts.orb)
    rows = []
    for j in range(b):
        lv_s = orb.pyramid_levels(torch.stack([imgs[j], imgs[b + j]]), consts.orb)
        lv_err = max(float((x[[j, b + j]] - y).abs().max()) for x, y in zip(lv_b, lv_s))
        sl, sr = vio.extract_rectified(inputs[j][0], inputs[j][1], consts, static)
        moved = bits = kept = 0
        for fb, fs in ((fl, sl), (fr, sr)):
            same_kp = ((fb.xy[j] == fs.xy).all(-1) & (fb.level[j] == fs.level)
                       & (fb.score[j] == fs.score) & (fb.valid[j] == fs.valid))
            moved += int((~same_kp & (fb.valid[j] | fs.valid)).sum())
            keep = same_kp & fs.valid
            kept += int(keep.sum())
            bits += int((fb.desc[j][keep] != fs.desc[keep]).sum())
        rows.append(dict(level_err=lv_err, keypoints_differ=moved, keypoints_same=kept,
                         desc_bits_differ=bits))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=6,
                    help="batched frames; each after the first is held lane by lane")
    ap.add_argument("--size", default="752x480x8x800",
                    help="width x height x levels x features (a small one for the CPU)")
    opts = ap.parse_args()
    smoke = _smoke()

    import torch

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import kernels
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    dev = require_cuda() if opts.device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        kernels.build()
    b = opts.batch
    w, h, levels, features = map(int, opts.size.split("x"))
    cfg = synthetic_config(width=w, height=h, levels=levels, features=features)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    static = dataclasses.replace(static, max_iterations=smoke.HELD_LM_ITERS)
    frames, gyrs, accs, mask, truth = sim_frames(cfg, b + opts.frames, n_landmarks=1200)
    inputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
              for i in range(b + opts.frames)]
    gens = [torch.Generator(device=dev).manual_seed(100 + j) for j in range(b)]
    state = batched.stack_states([seeded_state(static, truth, dev, j) for j in range(b)])
    tstep = functools.partial(vio.track_step, consts=consts, static=static)
    vstep = torch.func.vmap(tstep)
    per_frame, extraction, lanes, captured = [], [], [], None
    for i in range(opts.frames):
        u = torch.stack([torch.stack(vio.draw_ransac_uniforms(g, dev)) for g in gens])
        lane_in = [torch.stack(p) for p in zip(*(inputs[j + i] for j in range(b)))]
        fl, fr = vio.extract_rectified_batch(lane_in[0], lane_in[1], consts, static)
        held = i == 1
        if not held:
            if i > 1:
                new_state, m_b = vstep(state, fl, fr, *lane_in[2:], u)
        else:
            with _recorder() as rec_b:
                new_state, m_b = vstep(state, fl, fr, *lane_in[2:], u)
        if i == 0:
            state, _ = vstep(state, fl, fr, *lane_in[2:], u)
            continue
        rows = []
        for j in range(b):
            args = (batched.lane(state, j), batched.lane(fl, j), batched.lane(fr, j),
                    lane_in[2][j], lane_in[3][j], lane_in[4][j], u[j])
            one = tuple(torch.utils._pytree.tree_map(lambda a: a[None], a) for a in args)
            if held:
                with _recorder() as rec_s:
                    _, m_s = tstep(*args)
                with _recorder() as rec_1:
                    _, m_1 = vstep(*one)
            else:
                _, m_s = tstep(*args)
                _, m_1 = vstep(*one)
            _, m_ok = vio.ok_step(batched.lane(state, j), *inputs[j + i], None, consts, static,
                                  ransac_u=tuple(u[j]))
            row = {}
            for label, m, ix in (("ok_step", m_ok, None), ("track_step", m_s, None),
                                 ("vmap_1", m_1, 0)):
                pick = (lambda k: m[k]) if ix is None else (lambda k: m[k][ix])  # noqa: E731
                row[label] = dict(
                    tracked=int(pick("n_tracked")) - int(m_b["n_tracked"][j]),
                    stereo=int(pick("n_stereo")) - int(m_b["n_stereo"][j]),
                    ba_iters=int(pick("ba_iters")) - int(m_b["ba_iters"][j]),
                    p=float((pick("rec_p") - m_b["rec_p"][j]).abs().max()))
            row["n_tracked"] = int(m_b["n_tracked"][j])
            rows.append(row)
            if not held:
                continue
            first, decision, parted = first_differences(rec_s.calls, None, rec_b.calls, j)
            first1, decision1, parted1 = first_differences(rec_1.calls, 0, rec_b.calls, j)
            lanes.append(dict(lane=j, n_calls=len(rec_s.calls),
                              single=dict(first=first, decision=decision, parted=parted),
                              vmap_1=dict(first=first1, decision=decision1, parted=parted1)))
            if first is not None and captured is None:
                # replay the first differing call of the first lane that has one
                with _recorder(capture_at=first["index"]) as rec_c:
                    tstep(*args)
                ref = rec_s.calls[first["index"]][2]
                captured = dict(lane=j, index=first["index"], name=first["name"],
                                site=first["site"],
                                card=replay(rec_c.captured, ref, b, dev),
                                cpu=replay(rec_c.captured, ref, b, torch.device("cpu")))
            del rec_s, rec_1
        if held:
            del rec_b
            extraction = extraction_diff(lane_in, inputs[1:], fl, fr, consts, static)
        per_frame.append(rows)
        state = new_state

    # each label's worst lane over the frames
    worst = {label: {k: max(abs(r[label][k]) for rows in per_frame for r in rows)
                     for k in ("tracked", "stereo", "ba_iters", "p")}
             for label in ("ok_step", "track_step", "vmap_1")}
    exact = {label: sum(all(r[label][k] == 0 for k in ("tracked", "stereo", "ba_iters"))
                        for rows in per_frame for r in rows)
             for label in ("ok_step", "track_step", "vmap_1")}
    out = dict(device=str(dev), batch=b, lm_iters=smoke.HELD_LM_ITERS,
               lane_frames=sum(len(rows) for rows in per_frame), worst=worst,
               counts_equal=exact, per_frame=per_frame, extraction=extraction,
               held_frame=lanes, replay=captured)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(0))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
