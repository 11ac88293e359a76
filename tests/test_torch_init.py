"""PyTorch port vs the JAX package: the initializer and the SfM bootstrap's
PnP.

The chain is recorded from `tests/sim.py`'s world: the true body states of
five frames 0.1 s apart, seen from the first body frame (as the SfM chain
is) and perturbed by 1 mm / 1 mrad, with the IMU constraints preintegrated
by the JAX package from the simulator's noisy, biased samples. The JAX side
runs in float64 (x64); the port runs the same chain in float64, where it
must agree to rounding, and in float32, its precision on the card.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from sim import StereoInertialSim, set_family, sim_config  # noqa: E402

from pose_estimation_tpu.backend import init_solvers as jinit  # noqa: E402
from pose_estimation_tpu.backend import lm as jlm  # noqa: E402
from pose_estimation_tpu.backend import residuals as jres  # noqa: E402
from pose_estimation_tpu.imu import preintegration as jpre  # noqa: E402
from pose_estimation_tpu.ops import pnp as jpnp  # noqa: E402
from pose_estimation_tpu.utils import lie as jlie  # noqa: E402
from pose_estimation_tpu_torch import convert  # noqa: E402
from pose_estimation_tpu_torch.backend import init_solvers as tinit  # noqa: E402
from pose_estimation_tpu_torch.backend import lm as tlm  # noqa: E402
from pose_estimation_tpu_torch.backend import residuals as tres  # noqa: E402
from pose_estimation_tpu_torch.ops import pnp as tpnp  # noqa: E402
from pose_estimation_tpu_torch.utils import lie as tlie  # noqa: E402

F64 = torch.float64
F32 = torch.float32
# (dtype, atol of a unit-scale output); float32 is the card's precision,
# its bounds the measured float32-vs-float64 gaps with 3-10x headroom
TOL = {F64: 1e-9, F32: 2e-4}


def _np(t):
    return t.detach().cpu().double().numpy()


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    """The JAX function compiled once per shape (eager while-loops compile
    per op)."""
    return jax.jit(fn, static_argnames=static)


@jax.jit
def _preintegrate(gyr, acc, params):
    zero = jnp.zeros(3)
    st = jpre.integrate_chunk(jpre.init_state(jnp.float64), gyr, acc,
                              jnp.ones(gyr.shape[0], bool), zero, zero, params)
    return jpre.finalize(st, zero, zero, params)


@functools.lru_cache(maxsize=4)
def _chain(n_frames: int = 5, dataset: str = "euroc", family: str = "A", seed: int = 0):
    """(cfg, R [W, 3, 3], p [W, 3], ics [W-1] as JAX x64 arrays)."""
    g = 9.81
    sdt = np.sqrt(1.0 / 200)
    units = {} if dataset == "euroc" else dict(
        acc_noise=2.0e-3 / g, gyr_walk=1.9e-5 * sdt, acc_walk=3.0e-3 * sdt / g)
    cfg = sim_config(dataset=dataset, **units)
    sim = StereoInertialSim(cfg, n_landmarks=8, seed=seed)
    set_family(sim, family)
    rng = np.random.default_rng(seed)
    params = jpre.ImuParams.from_config(cfg, jnp.float64)
    bias_g, bias_a = np.array([3e-3, -2e-3, 1e-3]), np.array([0.05, -0.03, 0.04])
    spf, t0 = 20, 0.5
    r0, p0 = sim.traj.rot(t0), sim.traj.pos(t0)
    R, p, ics = [], [], []
    for k in range(n_frames):
        t = t0 + 0.1 * k
        dr = jlie.so3_exp(jnp.asarray(rng.normal(0, 1e-3, 3)))
        R.append(r0.T @ sim.traj.rot(t) @ np.asarray(dr))
        p.append(r0.T @ (sim.traj.pos(t) - p0) + rng.normal(0, 1e-3, 3))
        if k + 1 < n_frames:
            gyr, acc = [], []
            for j in range(spf):
                w_b, f_b = sim.imu_at(t + j * cfg.dt)
                gyr.append(w_b + bias_g + rng.normal(0, 2.4e-3, 3))
                acc.append(f_b + bias_a + rng.normal(0, 2.4e-2, 3))
            ics.append(_preintegrate(jnp.asarray(gyr), jnp.asarray(acc), params))
    ics = jax.tree.map(lambda *a: jnp.stack(a), *ics)
    return cfg, jnp.asarray(np.stack(R)), jnp.asarray(np.stack(p)), ics


def _port_chain(dtype, **kw):
    cfg, R, p, ics = _chain(**kw)
    tR, tp, tics = convert.sfm_chain_from_numpy(
        list(np.asarray(R)), list(np.asarray(p)), jax.tree.map(np.asarray, ics), "cpu", dtype)
    return cfg, tR, tp, tics


def _profile(cfg, dtype):
    prof = cfg.profile
    return (torch.tensor(prof.gravity_dir, dtype=dtype), prof.alignment_axes,
            torch.tensor(cfg.gravity, dtype=dtype))


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float64), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_lie_helpers_match_jax(dtype):
    """quat_to_mat, left_jacobian and the SE(3) helpers on random inputs
    (rounding: 1e-12 in float64, 1e-5 in float32)."""
    atol = 1e-12 if dtype == F64 else 1e-5
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    xi = rng.normal(0, 0.7, (6, 6))
    xi[0] *= 1e-3                        # the small-angle branch
    x = rng.normal(size=(6, 3))

    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    _close(tlie.quat_to_mat(t(q)), jlie.quat_to_mat(jnp.asarray(q)), atol)
    _close(tlie.left_jacobian(t(xi[:, 3:])), jlie.left_jacobian(jnp.asarray(xi[:, 3:])), atol)
    jr, jp = jlie.se3_exp(jnp.asarray(xi))
    tr, tp = tlie.se3_exp(t(xi))
    _close(tr, jr, atol)
    _close(tp, jp, atol)
    _close(tlie.se3_log(tr, tp), jlie.se3_log(jr, jp), 10 * atol)
    _close(tlie.se3_apply(tr, tp, t(x)), jlie.se3_apply(jr, jp, jnp.asarray(x)), 10 * atol)
    for a, b in zip(tlie.se3_inverse(tr, tp), jlie.se3_inverse(jr, jp)):
        _close(a, b, 10 * atol)
    for a, b in zip(tlie.se3_compose(tr, tp, tr.flip(0), tp.flip(0)),
                    jlie.se3_compose(jr, jp, jr[::-1], jp[::-1])):
        _close(a, b, 10 * atol)


def test_lm_solve_matches_jax():
    """The residual-form LM on a robust nonlinear problem with a frozen
    Jacobian: same iterate (1e-12), cost and iteration count in float64."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(40, 5))
    b = rng.normal(size=40)
    b[:4] += 8.0                                         # Huber outliers

    def jres_fn(x):
        return jnp.asarray(a) @ x - jnp.asarray(b) + 0.05 * jnp.sin(3 * x).sum()

    def tres_fn(x):
        return torch.as_tensor(a) @ x - torch.as_tensor(b) + 0.05 * torch.sin(3 * x).sum()

    def jw(r):
        return jnp.repeat(jlm.huber_block_weights(r.reshape(20, 2), jnp.ones(20, bool)), 2)

    def tw(r):
        return tlm.huber_block_weights(r.reshape(20, 2), torch.ones(20, dtype=torch.bool)
                                       ).repeat_interleave(2)

    opts = dict(max_iterations=30)
    jx, jinfo = jlm.lm_solve(jres_fn, jnp.asarray(a), jnp.zeros(5), jw, jlm.LMOptions(**opts))
    tx, tinfo = tlm.lm_solve(tres_fn, torch.as_tensor(a), torch.zeros(5, dtype=F64), tw,
                             tlm.LMOptions(**opts))
    _close(tx, jx, 1e-12)
    assert int(tinfo["iterations"]) == int(jinfo["iterations"]) < 30
    assert int(tinfo["accepted_steps"]) == int(jinfo["accepted_steps"])
    assert abs(float(tinfo["final_cost"]) - float(jinfo["final_cost"])) < 1e-10


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_init_residuals_match_jax(dtype):
    """Each initializer residual and Jacobian, batched over the chain's
    pairs, against the JAX functions pair by pair (relative 1e-10 in
    float64, 1e-4 in float32: whitened values reach 1e3)."""
    cfg, R, p, ics = _chain()
    _, tR, tp, tics = _port_chain(dtype)
    rtol = 1e-10 if dtype == F64 else 1e-4
    rng = np.random.default_rng(1)
    x3 = rng.normal(0, 0.01, 3)
    dv = rng.normal(0, 0.5, (5, 3))
    g = np.asarray(cfg.gravity)

    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    got = {
        "gyr_r": tres.gyr_bias_residual(t(x3), tR[:-1], tR[1:], tics),
        "gyr_j": tres.gyr_bias_jacobian(tR[:-1], tR[1:], tics),
        "gv_r": tres.gravity_velocity_residual(t(g), t(dv[:-1]), t(dv[1:]), tR[:-1], tp[:-1],
                                               tp[1:], tics),
        "gv_j": torch.cat(tres.gravity_velocity_jacobians(tR[:-1], tics), -1),
        "acc_r": tres.acc_bias_residual(t(x3), tR[:-1], t(dv[:-1]), t(dv[1:]), tp[:-1],
                                        tp[1:], tics, t(g)),
        "acc_j": tres.acc_bias_jacobian(tics),
    }
    def vm(fn, *axes):
        return jax.jit(jax.vmap(fn, in_axes=axes))

    pair = (R[:-1], R[1:])
    ref = {
        "gyr_r": vm(jres.gyr_bias_residual, None, 0, 0, 0)(x3, *pair, ics),
        "gyr_j": vm(jres.gyr_bias_jacobian, 0, 0, 0)(*pair, ics),
        "gv_r": vm(jres.gravity_velocity_residual, None, 0, 0, 0, 0, 0, 0)(
            g, dv[:-1], dv[1:], R[:-1], p[:-1], p[1:], ics),
        "gv_j": vm(lambda r, c: jnp.concatenate(jres.gravity_velocity_jacobians(r, c), -1),
                   0, 0)(R[:-1], ics),
        "acc_r": vm(jres.acc_bias_residual, None, 0, 0, 0, 0, 0, 0, None)(
            x3, R[:-1], dv[:-1], dv[1:], p[:-1], p[1:], ics, g),
        "acc_j": vm(jres.acc_bias_jacobian, 0)(ics),
    }
    for k, v in got.items():
        r = np.asarray(ref[k])
        _close(v, r, rtol * np.abs(r).max())
    x2 = rng.normal(0, 0.1, 2)
    init_g = np.array([0.2, -0.1, -0.97])
    unit_g = np.asarray(cfg.profile.gravity_dir, float)
    axes = cfg.profile.alignment_axes
    _close(tres.alignment_residual(t(x2), t(init_g), t(unit_g), axes),
           jres.alignment_residual(x2, init_g, unit_g, axes), rtol)
    _close(tres.alignment_jacobian(t(init_g), axes), jres.alignment_jacobian(init_g, axes),
           rtol)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_each_solver_matches_jax(dtype):
    """The six stage solvers on the recorded chain: float64 within 1e-9,
    float32 within 2e-4 (gravity within 2e-4 x |g|) of JAX's x64 solution."""
    cfg, R, p, ics = _chain()
    _, tR, tp, tics = _port_chain(dtype)
    unit_g, axes, grav = _profile(cfg, dtype)
    tol = TOL[dtype]
    g = 9.81

    jx, _ = _jit(jinit.solve_gyr_bias)(R, ics)
    tx, _ = tinit.solve_gyr_bias(tR, tics)
    _close(tx, jx, tol)
    assert np.abs(np.asarray(jx)).max() > 1e-3          # it found the gyro bias

    jg, jv, _ = _jit(jinit.solve_gravity_velocity)(R, p, ics)
    tg, tv, _ = tinit.solve_gravity_velocity(tR, tp, tics)
    _close(tg, jg, tol * g)
    _close(tv, jv, tol * 10)

    # the joint solves on a 12-keyframe chain (on 5 frames the free-gravity
    # one is degenerate, as the JAX package documents)
    long = dict(n_frames=12, family="B", seed=3)
    _, LR, Lp, Lics = _chain(**long)
    _, tLR, tLp, tLics = _port_chain(dtype, **long)
    # the free-gravity joint solve is ill conditioned even there (|g| comes
    # out near 15, the degeneracy the JAX package measured): float32 within
    # 10 % of the float64 solution
    jg3, jba, jv3, _ = _jit(jinit.solve_gravity_velocity_bias)(LR, Lp, Lics)
    tg3, tba, tv3, _ = tinit.solve_gravity_velocity_bias(tLR, tLp, tLics)
    rel = tol if dtype == F64 else 0.1
    for a, b in ((tg3, jg3), (tba, jba), (tv3, jv3)):
        _close(a, b, rel * np.abs(np.asarray(b)).max())

    g0 = np.asarray(cfg.gravity)
    jgt, jbat, jvt, _ = _jit(jinit.solve_gravity_tilt_bias)(LR, Lp, Lics, jnp.asarray(g0))
    tgt, tbat, tvt, _ = tinit.solve_gravity_tilt_bias(tLR, tLp, tLics, grav)
    _close(tgt, jgt, tol * g)
    _close(tbat, jbat, tol * 10)
    _close(tvt, jvt, tol * 10)

    init_g = np.asarray(jg) / np.linalg.norm(np.asarray(jg))
    jdr, _ = _jit(jinit.solve_alignment, "axes")(
        jnp.asarray(init_g), jnp.asarray(unit_g.numpy()), axes)
    tdr, _ = tinit.solve_alignment(torch.as_tensor(init_g, dtype=dtype), unit_g, axes)
    _close(tdr, jdr, tol)

    v = np.asarray(jv)
    jda, _ = _jit(jinit.solve_acc_bias)(R, jnp.asarray(v), p, ics, jnp.asarray(g0))
    tda, _ = tinit.solve_acc_bias(tR, torch.as_tensor(v.copy(), dtype=dtype), tp, tics, grav)
    _close(tda, jda, tol * 10)


@pytest.mark.parametrize("dataset", ["euroc", "kitti"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_full_init_matches_jax(dtype, dataset):
    """All four stages with their repropagations and the world alignment,
    on each profile's gravity axis: states, biases, gravity and the
    repropagated constraints within the solver tolerances."""
    cfg, R, p, ics = _chain(dataset=dataset)
    _, tR, tp, tics = _port_chain(dtype, dataset=dataset)
    unit_g, axes, grav = _profile(cfg, dtype)
    tol = TOL[dtype]
    ref = _jit(jinit.full_init, "axes")(
        R, p, ics, jnp.asarray(cfg.profile.gravity_dir, jnp.float64), axes,
        jnp.asarray(cfg.gravity))
    got = tinit.full_init(tR, tp, tics, unit_g, axes, grav)
    scales = (1, 10, 10, 1, 10, 9.81)                    # R, v, p, dbg, dba, g
    for a, b, s in zip(got[:6], ref[:6], scales):
        _close(a, b, tol * s)
    _close(got[6].dv, ref[6].dv, tol * 10)
    _close(got[6].dR, ref[6].dR, tol)
    # the solved gravity is the world's, up to the chain's perturbation
    assert abs(np.linalg.norm(_np(got[5])) - 9.81) < 0.1 * 9.81


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("form", ["routine", "warm"])
def test_refine_gravity_matches_jax(dtype, form):
    """The online refinement over a 12-keyframe family-B chain, in its
    routine form (sigmas 2, 2 rounds) and the warm recovery's (sigmas 5,
    3 rounds): g, total rotation and total dba within the solver bounds."""
    kw = dict(n_frames=12, family="B", seed=3)
    cfg, R, p, ics = _chain(**kw)
    _, tR, tp, tics = _port_chain(dtype, **kw)
    unit_g, axes, grav = _profile(cfg, dtype)
    opts = (dict(sigma_tilt=2.0, sigma_dba=2.0) if form == "routine"
            else dict(sigma_tilt=5.0, sigma_dba=5.0, rounds=3))
    ref = _jit(jinit.refine_gravity, "axes", *opts)(
        R, p, ics, jnp.asarray(cfg.profile.gravity_dir, jnp.float64), axes,
        jnp.asarray(cfg.gravity), **opts)
    got = tinit.refine_gravity(tR, tp, tics, unit_g, axes, grav, **opts)
    tol = TOL[dtype]
    _close(got[0], ref[0], tol * 9.81)
    _close(got[1], ref[1], tol)
    _close(got[2], ref[2], tol * 10)
    assert np.linalg.norm(np.asarray(ref[2])) > 1e-3     # a real correction


def _pnp_problem(seed):
    rng = np.random.default_rng(seed)
    n = 220
    obj = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(2.5, 11, n)], 1).astype(np.float32)
    rv, tv = np.array([0.01, -0.012, 0.008]), np.array([0.05, -0.02, 0.08])
    xc = obj @ np.asarray(jlie.so3_exp(jnp.asarray(rv))).T + tv
    k = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]], np.float32)
    px = xc[:, :2] / xc[:, 2:] * 260 + [160, 120] + rng.normal(0, 0.5, (n, 2))
    px[:30] += rng.uniform(-60, 60, (30, 2))            # outliers
    mask = np.ones(n, bool)
    mask[-12:] = False
    return obj, px.astype(np.float32), mask, k


@pytest.mark.parametrize("solver", ["dlt", "epnp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_ransac_with_jax_draws(solver, seed):
    """The hypotheses' sample indices drawn from JAX's uniforms equal
    `jax.random.choice`'s; with them the port finds the same inlier set and
    the pose within 1e-4 (rad, m; float32 on both sides)."""
    obj, px, mask, k = _pnp_problem(seed)
    key = jax.random.PRNGKey(10 + seed)
    probs = mask.astype(np.float32) / np.float32(mask.sum())
    jidx = np.asarray(jax.random.choice(key, len(obj), shape=(512, 6), p=jnp.asarray(probs)))
    u = np.asarray(jax.random.uniform(key, (512, 6), dtype=jnp.float32))
    from pose_estimation_tpu_torch.ops.ransac import sample_indices

    np.testing.assert_array_equal(
        sample_indices(torch.from_numpy(mask), torch.from_numpy(u)).numpy(), jidx)
    ref = _jit(jpnp.pnp_ransac, "solver")(jnp.asarray(obj), jnp.asarray(px),
                                          jnp.asarray(mask), jnp.asarray(k), key,
                                          solver=solver)
    t = torch.from_numpy
    got = tpnp.pnp_ransac(t(obj), t(px), t(mask), t(k), t(u), solver=solver)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 150
    _close(got.rvec, ref.rvec, 1e-4)
    _close(got.tvec, ref.tvec, 1e-4)
    again = tpnp.pnp_ransac(t(obj), t(px), t(mask), t(k), None, solver=solver,
                            idx=t(jidx.astype(np.int64)))
    assert torch.equal(again.inliers, got.inliers)
    _close(again.tvec, _np(got.tvec), 0.0)


def test_pnp_p3p_raises():
    """P3P raises only on a draw of the wrong sample size (the 6-point
    solvers' [512, 6]); on its own [128, 3] draw it finds the pose within
    the noise (1e-2 rad and m) and the inliers."""
    obj, px, mask, k = _pnp_problem(0)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="p3p"):
        tpnp.pnp_ransac(t(obj), t(px), t(mask), t(k), torch.rand(512, 6), solver="p3p")
    assert tpnp.uniform_shape("p3p") == (128, 3)
    got = tpnp.pnp_ransac(t(obj), t(px), t(mask), t(k),
                          torch.rand(128, 3, generator=torch.Generator().manual_seed(0)),
                          solver="p3p")
    _close(got.rvec, np.array([0.01, -0.012, 0.008]), 1e-2)
    _close(got.tvec, np.array([0.05, -0.02, 0.08]), 1e-2)
    assert int(got.n_inliers) > 150
