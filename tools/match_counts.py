#!/usr/bin/env python3
"""The matches that each stage of the front end keeps, in both packages,
on the same frames (CPU).

    python3 tools/match_counts.py --frames 8
    python3 tools/match_counts.py --frames 8 --width 320 --height 240

The frames are the parity harness's world (`tests/torch_parity.py`,
`tests/sim.py:sim_world`, seed 0) chained through the JAX package's four
stages from the seeded window, on the map front end (the JAX package's
CPU default; both packages run it). At each frame, from the JAX state
after `stage_imu`, with the RANSAC uniforms of JAX's key for the frame,
the script counts in each package:

- `kp_l`, `kp_r`: the ORB features of each image;
- `stereo`: the left features that pass the stereo gates (ratio, minimum
  distance, epipolar row);
- `ransac`: those the fundamental RANSAC keeps, and `cur` after the
  capacity cut;
- `left`, `left_ransac`, `right`: the temporal matches of the current
  left and right descriptors against the pool, the left ones after their
  RANSAC;
- `tracked`: the circular matches (left and right agree on the slot).

The port runs twice: on its own extraction (`port`) and on the JAX
package's features (`port_on_jax`), which isolates the matching stages
from the extraction. One JSON line a frame, then a summary of the frames
where a count differs.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

KEYS = ("kp_l", "kp_r", "stereo", "ransac", "cur", "left", "left_ransac", "right", "tracked")


def jax_counts(feats_l, feats_r, pool, key, static):
    import jax
    import jax.numpy as jnp

    from pose_estimation_tpu.frontend import tracker
    from pose_estimation_tpu.ops import matching, ransac

    k1, k2 = jax.random.split(key)
    m = matching.stereo_match(feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid,
                              feats_l.xy, feats_r.xy, static.match_ratio,
                              static.min_match_dist, static.max_vertical_dist)
    keep = ransac.fundamental_ransac(feats_l.xy, feats_r.xy[m.index], m.valid, k1).inliers
    cur = tracker.internal_match(feats_l, feats_r, k1, static.cur_capacity, static.match_ratio,
                                 static.min_match_dist, static.max_vertical_dist)
    ml = matching.match(cur.desc_l, pool.desc_l, cur.valid, pool.valid, static.match_ratio,
                        static.min_match_dist)
    left = ransac.fundamental_ransac(cur.px_l, pool.pixel[ml.index], ml.valid, k2).inliers
    mr = matching.match(cur.desc_r, pool.desc_r, cur.valid, pool.valid, static.match_ratio,
                        static.min_match_dist)
    tr = tracker.external_track(cur, pool, k2, static.match_ratio, static.min_match_dist)
    vals = (feats_l.valid, feats_r.valid, m.valid, keep, cur.valid, ml.valid, left, mr.valid,
            tr.matched)
    return {k: int(jnp.sum(v)) for k, v in zip(KEYS, vals)}


def port_counts(feats_l, feats_r, pool, u, static):
    import torch

    from pose_estimation_tpu_torch.frontend import tracker
    from pose_estimation_tpu_torch.ops import matching, ransac

    m = matching.stereo_match(feats_l.desc, feats_r.desc, feats_l.valid, feats_r.valid,
                              feats_l.xy, feats_r.xy, static.match_ratio,
                              static.min_match_dist, static.max_vertical_dist)
    keep = ransac.fundamental_ransac(feats_l.xy, feats_r.xy[m.index], m.valid, u[0]).inliers
    cur = tracker.internal_match(feats_l, feats_r, u[0], static.cur_capacity,
                                 static.match_ratio, static.min_match_dist,
                                 static.max_vertical_dist)
    ml = matching.match(cur.desc_l, pool.desc_l, cur.valid, pool.valid, static.match_ratio,
                        static.min_match_dist)
    left = ransac.fundamental_ransac(cur.px_l, pool.pixel[ml.index], ml.valid, u[1]).inliers
    mr = matching.match(cur.desc_r, pool.desc_r, cur.valid, pool.valid, static.match_ratio,
                        static.min_match_dist)
    tr = tracker.external_track(cur, pool, u[1], static.match_ratio, static.min_match_dist)
    vals = (feats_l.valid, feats_r.valid, m.valid, keep, cur.valid, ml.valid, left, mr.valid,
            tr.matched)
    return {k: int(torch.sum(v)) for k, v in zip(KEYS, vals)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args()

    import jax
    import torch
    from sim import seeded_state
    from torch_parity import jax_map_setup, ransac_uniforms, to_np, torch_map_setup, world

    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch import convert
    from pose_estimation_tpu_torch.models import vio as tvio
    from pose_estimation_tpu_torch.ops import orb as torb

    size = {k: v for k, v in (("width", args.width), ("height", args.height)) if v}
    _, jconsts, jstatic = jax_map_setup(**size)
    _, tconsts, tstatic = torch_map_setup(**size)
    frames, gyrs, accs, mask, state0 = world(args.frames, **size)

    def jit(fn):
        return jax.jit(functools.partial(fn, consts=jconsts, static=jstatic))

    imu, front, ba, pool_stage = (jit(f) for f in (jvio.stage_imu, jvio.stage_frontend,
                                                   jvio.stage_ba, jvio.stage_pool))
    extract = jit(jvio.extract_rectified)
    st = seeded_state(jstatic, state0)
    differ = {"port": [], "port_on_jax": []}
    for i in range(args.frames):
        key = jax.random.PRNGKey(i)
        u = tuple(torch.from_numpy(a) for a in ransac_uniforms(key))
        s1, _ = imu(st, gyrs[i], accs[i], mask)
        img_l, img_r = frames[i]
        jf = extract(img_l, img_r)
        counts = {"jax": jax_counts(*jf, s1.pool, key, jstatic)}
        tpool = convert.state_from_numpy(to_np(s1), "cpu").pool
        tf = tvio.extract_rectified(torch.from_numpy(np.asarray(img_l)),
                                    torch.from_numpy(np.asarray(img_r)), tconsts, tstatic)
        counts["port"] = port_counts(*tf, tpool, u, tstatic)
        jtf = [torb.OrbFeatures(*(torch.from_numpy(np.array(a)) for a in to_np(f)))
               for f in jf]
        jtf = [f._replace(level=f.level.long()) for f in jtf]
        counts["port_on_jax"] = port_counts(*jtf, tpool, u, tstatic)
        for name in differ:
            if counts[name] != counts["jax"]:
                differ[name].append(i)
        print(json.dumps({"frame": i, **counts}), flush=True)
        s2, cur, tr = front(s1, img_l, img_r, key)
        s3, _, _ = ba(s2, tr.n_matches)
        st = pool_stage(s3, cur, tr, tr.n_matches)
    print(json.dumps({"frames": args.frames, "size": size or "parity (160x128)",
                      "frames_where_a_count_differs": differ}))


if __name__ == "__main__":
    main()
