#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (`pose_estimation_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from `pose_estimation_tpu_torch/csrc/`, checks
each against its torch twin at the shapes the EuRoC-scale frame step gives
it (752x480 stereo, 8 levels, 800 features), then drives `ok_step` over 16
simulated frames from a window seeded at the true pose and checks the
result: finite state and non-negative BA cost, tracking and BA alive after
a 6-frame warm-up, no divergence, and both kernels launched by the frame
step. Then it runs a small input through the kernel path and through the
CPU twin path (the one the CPU tests hold to the JAX package) and requires
them to agree, and holds the drift of 16 chains at full pyramid depth
(384x240, 8 levels) to the JAX package's drift on the same configuration.
Any failure exits non-zero. The second-to-last line is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 16
WARMUP = 6
K1_TOL_XY = 1e-5       # px: same float32 operations as the twin
K2_TOL_MOM = 1e-5      # of the largest moment: float32 sums in another order
K2_TOL_VAL = 1e-3      # intensity, on >= 99.9 % of samples (a rounded sample
K2_MIN_CLOSE = 0.999   # point can flip at .5 when the rotation rounds apart)
# EuRoC run: a divergence guard, not an accuracy gate. The seeded slice at
# this scale tracks 5-35 features per frame in both packages and drifts by
# decimetres to metres (PERF.md); a run that diverges (an indefinite
# marginalization prior ran LM to kilometres) exceeds this at once.
DIVERGED_PER_M, DIVERGED_M = 2.0, 1.0   # error bound: 2 x distance travelled + 1 m
# Drift at full pyramid depth (384x240, 8 levels, 400 features, 8 frames
# from the seeded window): the JAX package's median final position error
# over 16 RANSAC seeds (measured on a CPU, sampler in interpret mode, keys
# PRNGKey(1000 * seed + frame)), and the bound on the port's median (the
# CPU test tests/test_torch_vio_mid.py holds the port's CPU path to the
# same ratio against the JAX package run live).
MID = dict(width=384, height=240, levels=8, features=400)
MID_FRAMES, MID_SEEDS, MID_LANDMARKS = 8, 16, 400
JAX_MID_MEDIAN_M = 0.1384
MID_RATIO = 1.5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    import torch

    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, kernels, orb, sample
    from pose_estimation_tpu_torch.testing import seeded_state, sim_frames, synthetic_config
    from pose_estimation_tpu_torch.utils.precision import require_cuda

    # ---- phase 1: the card
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build the kernels
    lib_path, build_s, log = kernels.build()
    kernels.library()
    print(f"kernels built in {build_s:.1f} s -> {lib_path.name}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- phase 3: each kernel against its twin at the slice's shapes
    cfg = synthetic_config(width=752, height=480, levels=8, features=800)
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    t0 = time.perf_counter()
    frames, gyrs, accs, mask, truth = sim_frames(cfg, N_FRAMES, n_landmarks=1200)
    print(f"sim: {N_FRAMES} frames of {cfg.image_width}x{cfg.image_height} "
          f"rendered in {time.perf_counter() - t0:.1f} s")
    ocfg, oc = static.orb, consts.orb
    imgs = torch.from_numpy(np.stack(frames[0])).to(dev)
    levels, stack, bounds = orb.plane_stack(imgs, ocfg, oc)
    args = (stack, bounds, ocfg.th_hi, ocfg.th_lo, orb.EDGE, ocfg.k_per_cell)
    got = fast.fast_select(*args)
    ref = fast.select_plain(*args)
    torch.cuda.synchronize()
    valid = ref[0] > -5e8
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        fail("fast_select: scores or codes differ from the twin")
    k1_err = max(float((got[2] - ref[2])[valid].abs().max()),
                 float((got[3] - ref[3])[valid].abs().max()))
    if k1_err > K1_TOL_XY:
        fail(f"fast_select: subpixel error {k1_err} > {K1_TOL_XY}")
    k1_ms = cuda_ms(lambda: fast.fast_select(*args))
    k1_plain_ms = cuda_ms(lambda: fast.select_plain(*args), reps=5, warm=1)
    print(f"K1 fast_select [{tuple(stack.shape)}]: {int(valid.sum())} candidates, "
          f"scores/codes exact, max |dxy| {k1_err:.3g} px; "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms")

    # plane top-k: stable sort and first-index argmin on CUDA as on the CPU
    budgets = orb.level_budgets(ocfg)
    k_top = min(budgets[0], got[0].shape[1])
    order_gpu = torch.sort(got[0], dim=1, descending=True, stable=True).indices[:, :k_top]
    order_cpu = torch.sort(got[0].cpu(), dim=1, descending=True, stable=True).indices[:, :k_top]
    if not torch.equal(order_gpu.cpu(), order_cpu):
        fail("stable descending sort differs between CUDA and CPU")
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.integers(0, 8, (512, 1024)).astype(np.float32))
    if not torch.equal(torch.argmin(d.to(dev), dim=1).cpu(), torch.argmin(d, dim=1)):
        fail("argmin ties resolve differently on CUDA")
    print(f"plane top-k {k_top}: stable sort and first-index argmin agree with the CPU")

    kps = fast.select_keypoints_fused(stack, bounds, ocfg.th_hi, ocfg.th_lo, budgets[0],
                                      orb.EDGE, ocfg.k_per_cell)
    b = imgs.shape[0]
    per_level = []
    for lvl, kb in enumerate(budgets):
        xy = kps.xy[lvl * b:(lvl + 1) * b, :kb].reshape(b * kb, 2).contiguous()
        plane = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(kb)
        per_level.append((levels[lvl].contiguous(), plane, xy, oc.pool_xy))
    k2_err, k2_close, n_kp = 0.0, [], 0
    for lv_args in per_level:
        gv, g10, g01 = sample.sample_patches(*lv_args)
        rv, r10, r01 = sample.sample_patches_plain(*lv_args)
        torch.cuda.synchronize()
        scale = float(torch.maximum(r10.abs().max(), r01.abs().max()))
        mom_err = float(torch.maximum((g10 - r10).abs().max(), (g01 - r01).abs().max()))
        if mom_err > K2_TOL_MOM * scale:
            fail(f"sample_patches: moment error {mom_err} > {K2_TOL_MOM} x {scale}")
        diff = (gv - rv).abs()
        k2_err = max(k2_err, float(diff.max()))
        k2_close.append(float((diff <= K2_TOL_VAL).float().mean()))
        n_kp += lv_args[2].shape[0]
    if min(k2_close) < K2_MIN_CLOSE:
        fail(f"sample_patches: only {min(k2_close):.5f} of samples within {K2_TOL_VAL}")

    def run_levels(fn):
        for lv_args in per_level:
            fn(*lv_args)

    k2_ms = cuda_ms(lambda: run_levels(sample.sample_patches))
    k2_plain_ms = cuda_ms(lambda: run_levels(sample.sample_patches_plain), reps=5, warm=1)
    print(f"K2 sample_patches ({n_kp} keypoints over {len(per_level)} levels): "
          f"moments within {K2_TOL_MOM} rel, min share of samples within {K2_TOL_VAL}: "
          f"{min(k2_close):.5f}, max |dv| {k2_err:.3g}; kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms (8 launches)")

    # ---- phase 4: the frame step over the sim, from the true start pose
    state = seeded_state(static, truth, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = [
        tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))
        for i in range(N_FRAMES)
    ]
    torch.cuda.synchronize()

    fast.fast_select.launches = 0
    sample.sample_patches.launches = 0
    metrics = []
    t_start = t_warm = time.perf_counter()
    for i in range(N_FRAMES):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
        state, m = vio.ok_step(state, *inputs[i], gen, consts, static)
        metrics.append(m)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"fast_select": fast.fast_select.launches,
                "sample_patches": sample.sample_patches.launches}
    ms_frame = (t_end - t_warm) * 1e3 / (N_FRAMES - WARMUP)
    print(f"ok_step: {N_FRAMES} frames in {t_end - t_start:.2f} s; chained "
          f"{ms_frame:.2f} ms/frame over frames {WARMUP}-{N_FRAMES - 1}; launches {launches}")

    dist = 0.0
    for i, m in enumerate(metrics):
        dist += float(np.linalg.norm(truth(i + 1)[1] - truth(i)[1]))
        err = float(np.linalg.norm(m["rec_p"].cpu().numpy() - truth(i + 1)[1]))
        print(f"  frame {i:2d}: stereo {int(m['n_stereo']):4d} tracked {int(m['n_tracked']):4d} "
              f"ba_iters {int(m['ba_iters']):2d} kf {int(m['is_keyframe'])} "
              f"pool {int(m['pool_size']):4d} |p - p_true| {err:.4f} m "
              f"(travelled {dist:.3f} m)")
        if i >= WARMUP and (int(m["n_tracked"]) <= 0 or int(m["ba_iters"]) <= 0):
            fail(f"frame {i}: tracking or BA dead after the warm-up")
        if not float(m["ba_cost"]) >= 0.0:
            fail(f"frame {i}: BA cost {float(m['ba_cost'])} is negative or not finite")
        if err > DIVERGED_PER_M * dist + DIVERGED_M:
            fail(f"frame {i}: diverged, {err:.3f} m from the truth after {dist:.3f} m")
    leaves = [t for t in (*state.win[:5], *state.win.ics, state.pool.pos, *state.preint)
              if t.is_floating_point()]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        fail("non-finite state")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was not launched by ok_step: {launches}")

    # ---- phase 5: the kernel path against the CPU twin path on a small
    # input. The CPU path is the one tests/test_torch_vio.py holds to the
    # JAX package (same tolerances: 5 mm, counts within 2 %, LM capped at 4
    # iterations because the seeded window's BA is ill posed).
    scfg = synthetic_config(width=160, height=128, levels=3, features=200,
                            camera_frequency=40, imu_chunk=8, max_num_iterations=4)
    sframes, sgyrs, saccs, smask, struth = sim_frames(scfg, 5, n_landmarks=250)
    ugen = torch.Generator().manual_seed(1)
    us = [vio.draw_ransac_uniforms(ugen, "cpu") for _ in sframes]
    paths = {}
    for where in (dev, torch.device("cpu")):
        c, s = vio.build_constants(scfg, CameraModel.from_config(scfg), where)
        st = seeded_state(s, struth, where)
        out = []
        for i in range(len(sframes)):
            args = (torch.from_numpy(a).to(where) for a in
                    (sframes[i][0], sframes[i][1], sgyrs[i], saccs[i], smask))
            st, m = vio.ok_step(st, *args, None, c, s,
                                ransac_u=tuple(u.to(where) for u in us[i]))
            out.append((m["rec_p"].cpu().numpy(), int(m["n_stereo"]), int(m["n_tracked"])))
        paths[where.type] = out
    worst = 0.0
    for i, ((pg, sg, tg), (pc, sc, tc)) in enumerate(zip(paths["cuda"], paths["cpu"])):
        worst = max(worst, float(np.linalg.norm(pg - pc)))
        if abs(sg - sc) > 0.02 * sc or abs(tg - tc) > 0.02 * max(tc, 1):
            fail(f"small run frame {i}: counts cuda {sg}/{tg} vs cpu {sc}/{tc}")
    if worst > 5e-3:
        fail(f"small run: kernel path {worst:.2e} m from the CPU twin path (> 5 mm)")
    print(f"small run (160x128, 5 frames): kernel path within {worst:.2e} m of the "
          f"CPU twin path; tracked {[t for _, _, t in paths['cuda']]}")

    # ---- phase 6: drift at full pyramid depth against the JAX package's
    mcfg = synthetic_config(**MID)
    mc, ms = vio.build_constants(mcfg, CameraModel.from_config(mcfg), dev)
    mframes, mgyrs, maccs, mmask, mtruth = sim_frames(mcfg, MID_FRAMES, n_landmarks=MID_LANDMARKS)
    minputs = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (mframes[i][0], mframes[i][1], mgyrs[i], maccs[i], mmask))
               for i in range(MID_FRAMES)]
    mid_err = []
    t0 = time.perf_counter()
    for seed in range(MID_SEEDS):
        st = seeded_state(ms, mtruth, dev)
        mgen = torch.Generator(device=dev).manual_seed(seed)
        for i in range(MID_FRAMES):
            st, m = vio.ok_step(st, *minputs[i], mgen, mc, ms)
        p = m["rec_p"].cpu().numpy()
        if not np.isfinite(p).all():
            fail(f"full-depth chain {seed}: non-finite position")
        mid_err.append(float(np.linalg.norm(p - mtruth(MID_FRAMES)[1])))
    mid_median = float(np.median(mid_err))
    print(f"full depth (384x240, 8 levels, {MID_FRAMES} frames, {MID_SEEDS} seeds, "
          f"{time.perf_counter() - t0:.1f} s): final position error median {mid_median:.4f} m, "
          f"range {min(mid_err):.4f}-{max(mid_err):.4f} m; the JAX package's median "
          f"{JAX_MID_MEDIAN_M} m, bound {MID_RATIO}x")
    if mid_median > MID_RATIO * JAX_MID_MEDIAN_M:
        fail(f"full-depth drift: median {mid_median:.4f} m > {MID_RATIO} x {JAX_MID_MEDIAN_M} m")

    loaded = sorted(
        k for k, v in sys.modules.items() if v is not None
        and (k in ("jax", "pose_estimation_tpu")
             or k.startswith(("jax.", "jaxlib", "pose_estimation_tpu."))))
    if loaded:
        fail(f"the run imported JAX or the JAX package: {loaded[:5]}")

    summary = {"kernels": [
        {"name": "fast_select", "route": "cuda",
         "source": "pose_estimation_tpu_torch/csrc/fast_select.cu",
         "replaces": "pose_estimation_tpu/ops/pallas_fast.py:160",
         "launches": launches["fast_select"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "sample_patches", "route": "cuda",
         "source": "pose_estimation_tpu_torch/csrc/sample_patches.cu",
         "replaces": "pose_estimation_tpu/ops/pallas_sample.py:111",
         "launches": launches["sample_patches"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ], "ok_step_ms_per_frame": ms_frame}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
