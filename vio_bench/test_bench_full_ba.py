"""Keyframe full BA in the frozen reference, on the CPU at the rehearsal's
size of `euroc-mav`: its solve against the port's on one window and pool;
its frame step against the port's eager frame step over a short sequence
with keyframes; the branch live on a keyframe, and under `vmap` only in
the lane that is one. Both sides run the same operations in the same order
on the same device, so every comparison here is exact: a difference is a
change to what one side computes, not rounding."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import check, spec  # noqa: E402
from vio_bench.world import Rig, World  # noqa: E402

FRAMES = 14          # frames 1..14 of the sequence, from the truth at frame 0
SEED = 2**31 + 3     # the RANSAC draws'


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


def _world(cfg, cell, n_frames):
    w = cell.config["world"]
    rig = Rig(cfg.image_width, cfg.image_height, cfg.k_left, cfg.r_cb, cfg.t_lr)
    return World(rig, cfg.profile.gravity_dir, cfg.sampling_rate, cfg.camera_frequency,
                 cfg.imu_chunk, n_frames, int(w["seed"]), w["landmarks_per_m"], w["imu_noise"],
                 "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames(vio, consts, static, state, world, uniforms):
    """[(state before, p, q, keyframe)] of frames 1..FRAMES from `state`."""
    out = []
    for i in range(1, FRAMES + 1):
        g, a, m = world.chunk(i)
        before = state
        with torch.no_grad():
            state, met = vio.ok_step(state, _t(world.left[i]), _t(world.right[i]), _t(g), _t(a),
                                     _t(m), None, consts, static, ransac_u=uniforms[i - 1])
        out.append((before, met["rec_p"], met["rec_quat"], bool(met["is_keyframe"])))
    return out


@pytest.fixture(scope="module")
def seq():
    """The sequence run by the port (eager, full BA on) and by the
    reference with full BA on and off, from the truth at frame 0, on the
    same RANSAC uniforms."""
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio as port_vio

    before = torch.get_num_threads()
    torch.set_num_threads(4)
    cell = spec.load_cell("euroc-stream", rehearse=True)
    cfg = dataclasses.replace(spec.program_config(cell, True), full_ba_keyframes=True)
    world = _world(cfg, cell, FRAMES + 1)
    ov = spec.reference_overrides(cell, True)
    ref_on = check.Reference(cell.yaml, "euroc", {**ov, "full_ba_keyframes": True}, "cpu")
    ref_off = check.Reference(cell.yaml, "euroc", ov, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    uniforms = [ref_on.vio.draw_ransac_uniforms(gen, "cpu") for _ in range(FRAMES)]
    start = ref_on.seeded(world, 1)
    consts, static = port_vio.build_constants(cfg, CameraModel.from_config(cfg), "cpu")
    port_start = check.unflatten(port_vio.init_vio_state(static, "cpu"),
                                 iter(check.leaves(start)))
    out = {"world": world, "ref_on": ref_on, "ref_off": ref_off, "static": static,
           "port": _frames(port_vio, consts, static, port_start, world, uniforms),
           "on": _frames(ref_on.vio, ref_on.consts, ref_on.static, start, world, uniforms),
           "off": _frames(ref_off.vio, ref_off.consts, ref_off.static, start, world, uniforms)}
    torch.set_num_threads(before)
    return out


def test_the_sequence_has_keyframes(seq):
    kfs = [k for _, _, _, k in seq["on"]]
    assert sum(kfs) >= 2 and not all(kfs), kfs
    assert seq["ref_on"].static.full_ba_keyframes and seq["ref_on"].static.full_ba_iterations == 8
    assert not seq["ref_off"].static.full_ba_keyframes


def test_full_ba_solve_is_the_ports(seq):
    """The window, and the pool's first 64 slots with landmarks, as the
    sequence leaves them before its first keyframe with full BA: the
    reference's solve gives the port's increments and iteration count."""
    from pose_estimation_tpu_torch.backend import ba as port_ba
    from pose_estimation_tpu_torch.backend import full_ba as port_full_ba
    from pose_estimation_tpu_torch.models import window as port_window
    from vio_bench.ref.backend import ba as ref_ba
    from vio_bench.ref.backend import full_ba as ref_full_ba

    k = next(j for j, (_, _, _, kf) in enumerate(seq["on"]) if kf and j > 0)
    state = seq["on"][k][0]
    idx = torch.nonzero(state.pool.valid).flatten()[:64]
    assert len(idx) >= 16
    pool = [state.pool.pos[idx], state.pool.obs_px[idx], state.pool.obs_mask[idx]]
    consts, static = seq["ref_on"].consts, seq["ref_on"].static
    outs = []
    for full_ba, ba, window in ((ref_full_ba, ref_ba, None),
                                (port_full_ba, port_ba, port_window)):
        win = state.win if window is None else window.WindowState(*state.win)
        calib = ba.Calib(*consts.calib)
        with torch.no_grad():
            outs.append(full_ba.full_ba(win, ba.LandmarkObs(*pool), calib, consts.gravity,
                                        static.prior_factor, static.full_ba_iterations))
    (rp, rv, rl, ri), (pp, pv, pl, pi) = outs
    assert int(ri["iterations"]) == int(pi["iterations"]) >= 1
    for a, b in ((rp, pp), (rv, pv), (rl, pl), (ri["final_cost"], pi["final_cost"])):
        assert torch.equal(a, b)
    assert float(rl.abs().max()) > 0


def test_frame_step_with_full_ba_is_the_ports(seq):
    for (_, pr, qr, kr), (_, pp, qp, kp) in zip(seq["on"], seq["port"]):
        assert kr == kp
        assert torch.equal(pr, pp) and torch.equal(qr, qp)


def test_full_ba_moves_the_keyframe_pose(seq):
    """Up to the first keyframe that finds landmarks in the pool (frame 1's,
    which fills the empty pool, finds none) the two references agree bit
    for bit; on it the pose with full BA differs."""
    first = next(j for j, (st, _, _, kf) in enumerate(seq["off"])
                 if kf and bool(st.pool.valid.any()))
    for j in range(first):
        assert torch.equal(seq["on"][j][1], seq["off"][j][1])
    assert seq["on"][first][3]
    gap = float(torch.linalg.norm(seq["on"][first][1] - seq["off"][first][1]))
    assert gap > 0


def test_batched_full_ba_moves_only_the_keyframe_lane(seq):
    """Two lanes through `vio_bench.ref.parallel.batched`, one about to take
    a keyframe and one not, each from its own state of the sequence: with
    full BA on, the keyframe lane's pose changes and the other's is
    bit-equal to the run with it off."""
    frames = seq["on"]
    k1 = next(j for j, (_, _, _, kf) in enumerate(frames) if kf and j > 0)
    k0 = next(j for j, (_, _, _, kf) in enumerate(frames) if not kf and j > 0)
    stacked = seq["ref_on"].batched.stack_states([frames[k1][0], frames[k0][0]])
    gens = []
    for j in (k1, k0):
        # the generator as it stood before frame j + 1's draws in the sequence
        g = torch.Generator().manual_seed(SEED)
        for _ in range(j):
            seq["ref_on"].vio.draw_ransac_uniforms(g, "cpu")
        gens.append(g.get_state())
    sample = check.Sample(check.copy_leaves(stacked), gens, [[k1 + 1, k0 + 1]], batched=True)
    (p_on, q_on, kf_on), = seq["ref_on"].run(sample, seq["world"])
    (p_off, q_off, kf_off), = seq["ref_off"].run(sample, seq["world"])
    assert list(kf_on) == list(kf_off) == [True, False]
    assert np.linalg.norm(p_on[0] - p_off[0]) > 0
    assert np.array_equal(p_on[1], p_off[1]) and np.array_equal(q_on[1], q_off[1])
