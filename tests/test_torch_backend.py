"""PyTorch port vs the JAX package: window and pool state, BA residuals and
Jacobians, the normal equations, LM, motion-only BA and marginalization.

The window is built from the simulator's true trajectory: four IMU
constraints preintegrated from its IMU samples (so every pair is a real
constraint), poses perturbed away from the truth, and landmark
observations projected from the sim's landmark field with pixel noise.
On that problem LM converges below its iteration cap in both packages, so
their iteration counts and final costs are comparable.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_parity import SMALL, jax_setup, to_np, torch_setup  # noqa: E402

from pose_estimation_tpu.backend import ba as jba  # noqa: E402
from pose_estimation_tpu.backend import lm as jlm  # noqa: E402
from pose_estimation_tpu.backend import residuals as jres  # noqa: E402
from pose_estimation_tpu.imu import preintegration as jpre  # noqa: E402
from pose_estimation_tpu.models import pool as jpool  # noqa: E402
from pose_estimation_tpu.models import window as jwin  # noqa: E402
from pose_estimation_tpu_torch import convert  # noqa: E402
from pose_estimation_tpu_torch.backend import ba as tba  # noqa: E402
from pose_estimation_tpu_torch.backend import lm as tlm  # noqa: E402
from pose_estimation_tpu_torch.backend import residuals as tres  # noqa: E402
from pose_estimation_tpu_torch.models import pool as tpool  # noqa: E402
from pose_estimation_tpu_torch.models import window as twin  # noqa: E402

F32 = np.float32
W = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_t(cls, tree):
    return convert.tree_from_numpy(cls, to_np(tree), "cpu")


def _close(got, ref, rel, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, atol=rel * scale, rtol=0, err_msg=what)


@functools.lru_cache(maxsize=1)
def _problem():
    """(jax window, jax obs, torch window, torch obs, constants)."""
    from sim import StereoInertialSim

    jcfg, jconsts, jstatic = jax_setup()
    _, tconsts, tstatic = torch_setup()
    sim = StereoInertialSim(jcfg, n_landmarks=300, seed=2)
    rng = np.random.default_rng(4)
    hz, t0 = 10.0, 0.7
    spf = int(jcfg.sampling_rate / hz)
    win = jwin.init_window(W, jnp.float32)
    Rs, ps, vs = [], [], []
    for j in range(W + 1):
        t = t0 + j / hz
        Rs.append(sim.traj.rot(t))
        ps.append(sim.traj.pos(t))
        vs.append(sim.vel_at(t))
    ics = []
    for k in range(W):
        ta = t0 + k / hz
        g = np.zeros((spf, 3), F32)
        a = np.zeros((spf, 3), F32)
        for s in range(spf):
            g[s], a[s] = sim.imu_at(ta + s * jcfg.dt)
        st = jpre.integrate_chunk_sequential(
            jpre.init_state(jnp.float32), jnp.asarray(g), jnp.asarray(a),
            jnp.ones(spf, bool), jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
            jconsts.imu)
        ics.append(jpre.finalize(st, jnp.zeros(3, jnp.float32),
                                 jnp.asarray(rng.normal(0, 0.01, 3), jnp.float32), jconsts.imu))
    ics = jax.tree.map(lambda *x: jnp.stack(x), *ics)
    dr = rng.normal(0, 0.01, (W + 1, 3)).astype(F32)
    from pose_estimation_tpu.utils import lie

    R = np.asarray(lie.so3_exp(jnp.asarray(dr))) @ np.stack(Rs).astype(F32)
    p = (np.stack(ps) + rng.normal(0, 0.02, (W + 1, 3))).astype(F32)
    v = (np.stack(vs) + rng.normal(0, 0.02, (W + 1, 3))).astype(F32)
    win = win._replace(R=jnp.asarray(R, jnp.float32), p=jnp.asarray(p), v=jnp.asarray(v),
                       dbg=jnp.asarray(rng.normal(0, 1e-3, (W + 1, 3)), jnp.float32),
                       dba=jnp.asarray(rng.normal(0, 1e-2, (W + 1, 3)), jnp.float32),
                       ics=ics, is_keyframe=jnp.asarray(False))

    # landmark observations in frames 1..W (rectified = raw: no distortion)
    c = jconsts.calib
    r_cb, p_cb = np.asarray(c.r_cb, np.float64), np.asarray(c.p_cb, np.float64)
    L = 300
    px = np.zeros((L, W, 2), F32)
    mask = np.zeros((L, W), bool)
    for w in range(W):
        xb = (np.stack(Rs)[w + 1].T @ (sim.lm - ps[w + 1]).T).T
        xc = xb @ r_cb.T + p_cb
        z = xc[:, 2]
        u = float(c.fx) * xc[:, 0] / np.maximum(z, 1e-3) + float(c.cx)
        vv = float(c.fy) * xc[:, 1] / np.maximum(z, 1e-3) + float(c.cy)
        ok = (z > 0.5) & (u > 0) & (u < SMALL["width"]) & (vv > 0) & (vv < SMALL["height"])
        px[:, w, 0] = u + rng.normal(0, 0.7, L)
        px[:, w, 1] = vv + rng.normal(0, 0.7, L)
        mask[:, w] = ok & (rng.random(L) < 0.9)
    px[rng.random((L, W)) < 0.03] += 25.0                 # a few outliers (Huber)
    pos = (sim.lm + rng.normal(0, 0.01, (L, 3))).astype(F32)
    jobs = jba.LandmarkObs(jnp.asarray(pos), jnp.asarray(px), jnp.asarray(mask))
    tobs = tba.LandmarkObs(_t(pos), _t(px), _t(mask))
    return win, jobs, _to_t(twin.WindowState, win), tobs, (jconsts, jstatic, tconsts, tstatic)


def _with_prior(win):
    """The same window with a live marginalization prior, linearized at the
    window's own (perturbed) frames 1..W. Its information is a solve's,
    scaled by 1e-3: at full strength it would pin the frames against the
    data and leave LM crawling along a ~50-iteration valley."""
    jw, jobs, _, _, (jc, js, _, _) = _problem()
    _, _, info = jba.motion_only_ba(jw, jobs, jc.calib, jc.gravity, js.prior_factor, 60,
                                    use_marg_prior=True)
    return win._replace(
        prior_h=1e-3 * jba.marginalize_prior(win, info["marg_h"]).prior_h,
        lin_R=win.R[1:], lin_p=win.p[1:], lin_v=win.v[1:],
        lin_bg=win.ics.bg_i + win.dbg[1:], lin_ba=win.ics.ba_i + win.dba[1:],
        prior_on=jnp.asarray(True),
    )


def test_residuals_and_jacobians_match_jax():
    """Whitened IMU/prior residuals and Jacobian blocks, and the
    reprojection error and its 2x6 Jacobian: float32, 1e-4 of each
    quantity's magnitude (the whiteners reach ~1e4)."""
    jw, jobs, tw, tobs, (jc, js, tc, ts) = _problem()
    rng = np.random.default_rng(0)
    inc = [rng.normal(0, 1e-3, (W, 3)).astype(F32) for _ in range(10)]
    jargs = [jnp.asarray(a) for a in inc]
    targs = [_t(a) for a in inc]
    sl = dict(R_i=slice(0, -1), R_j=slice(1, None))
    jst = [getattr(jw, f)[sl["R_i"]] for f in ("R", "p", "v", "dbg", "dba")] + \
          [getattr(jw, f)[sl["R_j"]] for f in ("R", "p", "v", "dbg", "dba")]
    tst = [getattr(tw, f)[sl["R_i"]] for f in ("R", "p", "v", "dbg", "dba")] + \
          [getattr(tw, f)[sl["R_j"]] for f in ("R", "p", "v", "dbg", "dba")]
    jlt = jres.whitener(jw.ics.inv_cov)
    tlt = tres.whitener(tw.ics.inv_cov)
    _close(tlt, jlt, 1e-5, "whitener")
    ref = jax.vmap(jres.imu_residual, in_axes=(0,) * 20 + (0, None, 0))(
        *jargs, *jst, jw.ics, jc.gravity, jlt)
    got = tres.imu_residual(*targs, *tst, tw.ics, tc.gravity, tlt)
    _close(got, ref, 1e-4, "imu_residual")

    jj = jax.vmap(jres.imu_jacobians, in_axes=(0,) * 8 + (0, None))(
        *jst[:5], *jst[5:8], jw.ics, jc.gravity)
    tj = tres.imu_jacobians(*tst[:5], *tst[5:8], tw.ics, tc.gravity)
    for a, b in zip(tj, jj):
        _close(a, b, 1e-4, "imu_jacobians")
    jp = jax.vmap(jres.prior_jacobians, in_axes=(0, 0, 0, 0, None))(
        jst[0], jst[3], jst[5], jw.ics, js.prior_factor)
    tp = tres.prior_jacobians(tst[0], tst[3], tst[5], tw.ics, ts.prior_factor)
    for a, b in zip(tp, jp):
        _close(a, b, 1e-4, "prior_jacobians")

    c, d = jc.calib, tc.calib
    ref = jres.reprojection_error_and_jacobian(
        jw.R[1:][None], jw.p[1:][None], jobs.pos[:, None], jobs.px,
        c.r_cb, c.p_cb, c.fx, c.fy, c.cx, c.cy, c.inv_std)
    got = tres.reprojection_error_and_jacobian(
        tw.R[1:][None], tw.p[1:][None], tobs.pos[:, None], tobs.px,
        d.r_cb, d.p_cb, d.fx, d.fy, d.cx, d.cy, d.inv_std)
    m = np.asarray(jobs.mask) & (np.asarray(ref[2]) > 0.5)
    for a, b in zip(got, ref):
        _close(a.numpy()[m], np.asarray(b)[m], 1e-4, "reprojection")

    blocks = np.asarray(ref[0]).reshape(ref[0].shape[0], -1) * 0.3
    lm_ok = np.asarray(jobs.mask).any(axis=1)
    _close(tlm.huber_block_weights(_t(blocks), _t(lm_ok)),
           jlm.huber_block_weights(jnp.asarray(blocks), jnp.asarray(lm_ok)), 1e-6, "huber")


@pytest.mark.parametrize("prior", [False, True], ids=["anchor_prior", "marg_prior"])
def test_normal_problem_and_motion_only_ba_match_jax(prior):
    """H, g and the robust cost at zero and at a random increment (1e-4 of
    each one's magnitude: the pair rows are whitened by ~1e4 and summed in
    another order), then the whole LM solve: the same iteration count
    below a 60-iteration cap (Huber-weighted outliers and, with the prior,
    the weakly observed velocity/bias directions make it take 18-36), the
    same final cost to 1e-5, and increments to 1e-2 of their magnitude:
    the late iterations crawl along a flat valley of the robust cost, where
    float32 sums in another order move x but not the cost."""
    jw, jobs, _, tobs, (jc, js, tc, ts) = _problem()
    if prior:
        jw = _with_prior(jw)
    tw = _to_t(twin.WindowState, jw)
    jn, jx0, _ = jba.build_normal_problem(jw, jobs, jc.calib, jc.gravity, js.prior_factor,
                                          use_marg_prior=prior)
    tn, tx0, _ = tba.build_normal_problem(tw, tobs, tc.calib, tc.gravity, ts.prior_factor,
                                          use_marg_prior=prior)
    x = np.random.default_rng(1).normal(0, 1e-3, jx0.shape).astype(F32)
    for xx in (np.zeros_like(x), x):
        ref = jn(jnp.asarray(xx))
        got = tn(_t(xx))
        for name, a, b in zip(("H", "g", "cost"), got, ref):
            _close(a, b, 1e-4, name)

    jd = jba.motion_only_ba(jw, jobs, jc.calib, jc.gravity, js.prior_factor, 60,
                            use_marg_prior=prior)
    td = tba.motion_only_ba(tw, tobs, tc.calib, tc.gravity, ts.prior_factor, 60,
                            use_marg_prior=prior)
    assert 1 < int(td[2]["iterations"]) == int(jd[2]["iterations"]) < 60
    assert int(td[2]["accepted_steps"]) == int(jd[2]["accepted_steps"])
    _close(td[2]["final_cost"], jd[2]["final_cost"], 1e-5, "final_cost")
    _close(td[0], jd[0], 1e-2, "delta_pose")
    _close(td[1], jd[1], 1e-2, "delta_vdbga")
    key = "marg_h" if prior else "h_final"
    _close(td[2][key], jd[2][key], 1e-4, key)


def test_marginalize_prior_matches_jax():
    jw, jobs, tw, tobs, (jc, js, tc, ts) = _problem()
    _, _, info = jba.motion_only_ba(jw, jobs, jc.calib, jc.gravity, js.prior_factor, 15,
                                    use_marg_prior=True)
    h = np.asarray(info["marg_h"])
    ref = jba.marginalize_prior(jw, jnp.asarray(h), 0.9)
    got = tba.marginalize_prior(tw, _t(h), 0.9)
    # Schur complement h_rr - h_rm h_mm^-1 h_mr of an ill-conditioned
    # 15x15 block in float32: the two LU solves differ in their last bits
    # and the subtraction amplifies that to ~2e-3 of the largest entry
    _close(got.prior_h, ref.prior_h, 3e-3, "prior_h")
    for name in ("lin_R", "lin_p", "lin_v", "lin_bg", "lin_ba", "prior_on"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    moved = jw._replace(p=jw.p + 0.01)
    _close(tba.prior_delta(_to_t(twin.WindowState, moved._replace(**{
        k: getattr(ref, k) for k in ("prior_h", "lin_R", "lin_p", "lin_v", "lin_bg",
                                     "lin_ba", "prior_on")}))),
           jba.prior_delta(moved._replace(**{
               k: getattr(ref, k) for k in ("prior_h", "lin_R", "lin_p", "lin_v", "lin_bg",
                                            "lin_ba", "prior_on")})), 1e-5, "prior_delta")


def test_marginalize_prior_clips_an_indefinite_schur_complement():
    """The outgoing frame's velocity and biases unobserved (a zero block in
    h_mm) while rounding-sized couplings to the kept states remain: the
    float32 Schur complement comes out indefinite in the JAX package
    (eigenvalues of -5e3 against +9e3 at most: the next BA cost is unbounded
    below), and the port clips the negative eigenvalues. Its prior is JAX's
    with the negative part removed, to float32 rounding."""
    jw, _, tw, _, _ = _problem()
    n = 15 * W
    a = np.random.default_rng(7).normal(size=(2 * n, n))
    h = a.T @ a
    idx_m, _, new_pos = jba._marg_indices(W)
    free = idx_m[6:]
    noise = np.random.default_rng(8).normal(0, 1e-3, (len(free), n))
    h[free, :] = noise
    h[:, free] = noise.T
    h[np.ix_(free, free)] = 0.0
    h = h.astype(F32)
    ref = np.asarray(jba.marginalize_prior(jw, jnp.asarray(h)).prior_h, np.float64)
    got = tba.marginalize_prior(tw, _t(h)).prior_h.numpy().astype(np.float64)
    lam, vec = np.linalg.eigh(ref[np.ix_(new_pos, new_pos)])
    assert lam.min() < -0.1 * lam.max()
    assert np.linalg.eigvalsh(got).min() >= -1e-5 * lam.max()
    clipped = (vec * np.maximum(lam, 0.0)) @ vec.T
    _close(got[np.ix_(new_pos, new_pos)], clipped, 1e-4, "clipped prior_h")


def test_lm_stops_when_converged_and_freezes():
    """A small nonlinear least-squares problem that converges in a few
    iterations: the fixed-length loop must freeze at the JAX while-loop's
    exit (same x, same iteration count below the cap)."""
    a = np.random.default_rng(3).normal(size=(12, 4)).astype(F32)
    b = np.random.default_rng(4).normal(size=12).astype(F32)

    def make(lib, A, B):
        def normal_fn(x):
            r = A @ x + 0.1 * x[0] * x[1] - B
            jac = A
            return jac.T @ jac, jac.T @ r, 0.5 * (r @ r)
        return normal_fn

    jx, ji = jlm.lm_solve_normal(make(jnp, jnp.asarray(a), jnp.asarray(b)),
                                 jnp.zeros(4, jnp.float32), jlm.LMOptions(max_iterations=20))
    tx, ti = tlm.lm_solve_normal(make(torch, _t(a), _t(b)), torch.zeros(4),
                                 tlm.LMOptions(max_iterations=20))
    assert int(ti["iterations"]) == int(ji["iterations"]) < 20
    _close(tx, jx, 1e-5, "x")


def test_window_updates_match_jax():
    """push_constraint on both branches, apply_deltas, check_keyframe."""
    jw, _, tw, _, (jc, _, tc, _) = _problem()
    ic_j = jax.tree.map(lambda a: a[1], jw.ics)
    ic_t = type(tw.ics)(*(a[1] for a in tw.ics))
    for kf in (True, False):
        ref = jwin.push_constraint(jw._replace(is_keyframe=jnp.asarray(kf)), ic_j, jc.gravity)
        got = twin.push_constraint(tw._replace(is_keyframe=torch.tensor(kf)), ic_t, tc.gravity)
        for name, a, b in zip(got._fields, got, ref):
            if name == "ics":
                for x, y in zip(a, b):
                    _close(x, y, 1e-6, "ics")
            else:
                _close(a, b, 1e-6, name)
    rng = np.random.default_rng(5)
    dp = rng.normal(0, 1e-2, (W, 6)).astype(F32)
    dv = rng.normal(0, 1e-2, (W, 9)).astype(F32)
    ref = jwin.check_keyframe(jwin.apply_deltas(jw, jnp.asarray(dp), jnp.asarray(dv), 0.1, 0.6),
                              0.1, 0.15, 4.0)
    got = twin.check_keyframe(twin.apply_deltas(tw, _t(dp), _t(dv), 0.1, 0.6), 0.1, 0.15, 4.0)
    for name in ("R", "p", "v", "dbg", "dba", "need_reinit", "is_keyframe", "sum_imu_time"):
        _close(getattr(got, name), getattr(ref, name), 1e-6, name)


def test_pool_updates_match_jax_exactly():
    rng = np.random.default_rng(6)
    P, M = 64, 24
    jp = jpool.init_pool(P, W)
    tp = tpool.init_pool(P, W, "cpu")
    for step in range(3):
        px = rng.uniform(0, 100, (M, 2)).astype(F32)
        dl = np.where(rng.random((M, 256)) < 0.5, 1, -1).astype(np.int8)
        dr = np.where(rng.random((M, 256)) < 0.5, 1, -1).astype(np.int8)
        pos = rng.normal(size=(M, 3)).astype(F32)
        want = rng.random(M) < 0.8
        # the last step matches several features to one slot: the last of
        # them must write its observation, as the JAX scatter does on a CPU
        slot = (rng.permutation(P)[:M] if step < 2 else rng.integers(0, 6, M)).astype(np.int32)
        matched = rng.random(M) < 0.5
        jp = jpool.insert_features(jp, *(jnp.asarray(a) for a in (px, dl, dr, pos, want)))
        tp = tpool.insert_features(tp, *(_t(a) for a in (px, dl, dr, pos, want)))
        jp = jpool.record_observations(jp, jnp.asarray(slot), jnp.asarray(matched), jnp.asarray(px))
        tp = tpool.record_observations(tp, _t(slot).long(), _t(matched), _t(px))
        jp = jpool.age_and_evict(jp, jnp.asarray(slot), jnp.asarray(matched), 3)
        tp = tpool.age_and_evict(tp, _t(slot).long(), _t(matched), 3)
        jp = jpool.shift_window(jp)
        tp = tpool.shift_window(tp, torch.tensor(True))
        for name, a, b in zip(tp._fields, tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{step} {name}")
    assert int(tp.valid.sum()) > 0
