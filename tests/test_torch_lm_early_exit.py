"""The LM solves' early exit (`graphs.iterate`) against their fixed loop
and against the JAX package's `lax.while_loop`.

In a captured CUDA graph each LM loop of the port (`backend/lm.py`
`lm_solve`, `lm_solve_normal`; `backend/full_ba.py`) is one conditional
WHILE node: the device runs an iteration while the solve is live and under
its cap, on a carry held in buffers that each iteration overwrites. The
card is not here, so these tests run the same loop in its host form
(`graphs.host_conditionals`: the carry in the same buffers, the loop's
test read on the host), and hold it:

- bit for bit (NaN where NaN) against the fixed loop of `max_iterations`
  frozen iterations that the eager path and the CPU run, on problems that
  converge early, that run to their cap, whose Cholesky factorization
  fails, and whose cost turns NaN;
- on the iteration count against the JAX package's `while_loop` on the
  same problems in float64 (`pose_estimation_tpu/backend/lm.py`,
  `full_ba.py`, x64 on the CPU): equal counts, the solution within 1e-9 of
  its scale (the two packages order their float64 sums differently).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_backend import GRAVITY  # noqa: E402
from test_torch_full_ba import PRIOR_FACTOR, _np, _port_problem, _window  # noqa: E402

from pose_estimation_tpu.backend import full_ba as jfull_ba  # noqa: E402
from pose_estimation_tpu.backend import lm as jlm  # noqa: E402
from pose_estimation_tpu_torch import graphs  # noqa: E402
from pose_estimation_tpu_torch.backend import full_ba as tfull_ba  # noqa: E402
from pose_estimation_tpu_torch.backend import lm as tlm  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402

X_TOL = 1e-9


def _problem(case, lib):
    """(residual_fn, jac, x0, weight_fn, cap) of one case in `lib` (numpy
    data from a seed): a mildly nonlinear Huber-weighted problem that
    converges early (`early`); the same with a cap it reaches (`cap`);
    negative weights, whose normal matrix no Cholesky factors until the
    damping outgrows it (`cholesky`); a residual that is NaN beyond a
    half-space, so that some trial steps cost NaN (`nan`)."""
    rng = np.random.default_rng(["early", "cap", "cholesky", "nan"].index(case))
    a = rng.normal(size=(30, 6))
    b = rng.normal(size=30) * 3.0
    A, B = (jnp.asarray(a), jnp.asarray(b)) if lib is jnp else (torch.from_numpy(a),
                                                                torch.from_numpy(b))
    nan = float("nan")

    def residual_fn(x):
        r = A @ x - B + 0.3 * lib.sin(x).sum()
        if case == "nan":
            r = r + lib.where(x[0] > 0.05, nan, 0.0)
        return r

    def weight_fn(r):
        w = lib.where(lib.abs(r) <= 1.0, 1.0, 1.0 / lib.abs(r))
        return -w if case == "cholesky" else w

    x0 = lib.zeros(6, dtype=lib.float64)
    return residual_fn, A, x0, weight_fn, {"cap": 3}.get(case, 50)


def _normal_problem(case, lib):
    """(normal_fn, x0, cap) of one case: the residual problem of `_problem`
    in normal form, H and g at x (the `cholesky` case's H negated)."""
    residual_fn, jac, x0, weight_fn, cap = _problem(case, lib)

    def normal_fn(x):
        r = residual_fn(x)
        w = weight_fn(r)
        jtw = jac.T * w[None, :]
        return jtw @ jac, jtw @ r, 0.5 * (w * r * r).sum()

    return normal_fn, x0, cap


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _fixed_and_early(fn):
    """fn() run with the fixed loop, then in the conditional loop's host
    form, and the iteration counts the latter logged."""
    fixed = fn()
    graphs.iteration_log = []
    try:
        with graphs.host_conditionals():
            early = fn()
        logged = graphs.read_iterations(graphs.iteration_log)
    finally:
        graphs.iteration_log = None
    return fixed, early, logged


CASES = ["early", "cap", "cholesky", "nan"]


@pytest.mark.parametrize("case", CASES)
def test_lm_solve_early_exit(case):
    residual_fn, jac, x0, weight_fn, cap = _problem(case, torch)
    opts = tlm.LMOptions(max_iterations=cap)
    fixed, early, logged = _fixed_and_early(
        lambda: tlm.lm_solve(residual_fn, jac, x0, weight_fn, opts, name="case"))
    _same(fixed, early)
    it = int(early[1]["iterations"])
    assert logged == [("case", it, cap)]
    jr, jjac, jx0, jw, _ = _problem(case, jnp)
    jx, ji = jlm.lm_solve(jr, jjac, jx0, jw, jlm.LMOptions(max_iterations=cap))
    assert it == int(ji["iterations"])
    assert int(early[1]["accepted_steps"]) == int(ji["accepted_steps"])
    x = early[0].numpy()
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0,
                               atol=X_TOL * max(1.0, np.abs(np.asarray(jx)).max()))
    if case == "early":
        assert it < cap
    if case == "cap":
        assert it == cap


@pytest.mark.parametrize("case", CASES)
def test_lm_solve_normal_early_exit(case):
    normal_fn, x0, cap = _normal_problem(case, torch)
    opts = tlm.LMOptions(max_iterations=cap)
    fixed, early, logged = _fixed_and_early(lambda: tlm.lm_solve_normal(normal_fn, x0, opts))
    _same(fixed, early)
    it = int(early[1]["iterations"])
    assert logged == [("lm_normal", it, cap)]
    jn, jx0, _ = _normal_problem(case, jnp)
    jx, ji = jlm.lm_solve_normal(jn, jx0, jlm.LMOptions(max_iterations=cap))
    assert it == int(ji["iterations"])
    x = early[0].numpy()
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0,
                               atol=X_TOL * max(1.0, np.abs(np.asarray(jx)).max()))
    if case == "cholesky":
        # the first iterations could not factor the negated normal matrix
        assert int(early[1]["accepted_steps"]) < it


@functools.lru_cache(maxsize=None)
def _jax_full_ba(cap):
    return jax.jit(functools.partial(jfull_ba.full_ba, prior_factor=PRIOR_FACTOR,
                                     max_iterations=cap, use_marg_prior=False))


@pytest.mark.parametrize("case, cap", [("early", 30), ("cap", 2), ("nan", 4)])
def test_full_ba_early_exit(case, cap):
    """Full BA on `test_torch_full_ba`'s synthetic window (4 frames, 24
    landmarks, float64): converging before a cap of 30, cut at 2, and with
    one observation's pixel NaN (every cost NaN, every step rejected, to
    the cap)."""
    win, obs, calib = _window(4, False)
    if case == "nan":
        obs = obs._replace(px=obs.px.at[0, 0, 0].set(jnp.nan))
    twin, tobs, tcal = _port_problem(win, obs, calib)

    def solve():
        return tfull_ba.full_ba(twin, tobs, tcal, torch.from_numpy(np.array(GRAVITY)),
                                PRIOR_FACTOR, cap)

    fixed, early, logged = _fixed_and_early(solve)
    _same(fixed, early)
    it = int(early[3]["iterations"])
    assert logged == [("full_ba", it, cap)]
    jd = _np(_jax_full_ba(cap)(win, obs, calib, GRAVITY))
    assert it == int(jd[3]["iterations"])
    if case == "early":
        assert it < cap
        for g, r in zip(early[:3], jd[:3]):
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=X_TOL * max(1.0, np.abs(r).max()))
    else:
        assert it == cap


def test_vmap_keeps_the_fixed_loop():
    """Under `torch.func.vmap` (the batched step) the conditional form
    stands aside: the select of JAX's vmapped while_loop, each lane its own
    count."""
    problems = [_normal_problem(c, torch) for c in ("early", "cap")]
    x0 = torch.stack([problems[0][1], problems[1][1] + 0.1])

    def solve(x):
        return tlm.lm_solve_normal(problems[0][0], x, tlm.LMOptions(max_iterations=20))

    with graphs.host_conditionals():
        got = torch.func.vmap(solve)(x0)
    for j in range(2):
        ref = solve(x0[j])
        assert int(got[1]["iterations"][j]) == int(ref[1]["iterations"])
        np.testing.assert_allclose(got[0][j].numpy(), ref[0].numpy(), rtol=0, atol=1e-12)
