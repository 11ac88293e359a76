"""The port's log-depth IMU preintegration (`integrate_chunk`) against the
JAX package's, and against the port's own sample loop
(`integrate_chunk_sequential`).

Inputs come from numpy seeds and run through both packages on the CPU.
The port's scan follows JAX's association order (`utils.tree.
associative_scan`, the same pairwise reduction), so the two agree to a few
ulps of each field's magnitude: TOL below, relative to the field's largest
|entry|. The loop reassociates every product and sum, so it is held more
loosely to the scan (LOOP_TOL).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from pose_estimation_tpu.imu import preintegration as jpre  # noqa: E402
from pose_estimation_tpu_torch.imu import preintegration as tpre  # noqa: E402
from pose_estimation_tpu_torch.utils import lie  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import associative_scan  # noqa: E402

DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}
# of each field's largest |entry|: float32 results of the same operations
# in the same order (XLA and ATen may sum a 3x3 product's terms apart),
# and float64 the same
TOL = {"float32": 1e-6, "float64": 1e-12}
# the loop against the scan: every product reassociated, dt summed sample
# by sample
LOOP_TOL = {"float32": 1e-5, "float64": 1e-12}
DT = 0.005


def _params(name):
    """EuRoC-like noise (as tests/test_preintegration.py) in both packages."""
    np_dt, t_dt = DTYPES[name]
    gyr_n, acc_n = 1.6968e-04 / np.sqrt(DT), 2.0e-3 / np.sqrt(DT)
    cov_noise = np.array([gyr_n**2] * 3 + [acc_n**2] * 3, np_dt)
    cov_bias = np.array([1.9393e-05**2] * 3 + [3.0e-3**2] * 3, np_dt)
    return (jpre.ImuParams(jnp.asarray(cov_noise), jnp.asarray(cov_bias),
                           jnp.asarray(np_dt(DT))),
            tpre.ImuParams(torch.from_numpy(cov_noise), torch.from_numpy(cov_bias),
                           torch.tensor(DT, dtype=t_dt)))


def _start_state(rng, name):
    """A non-zero running state: a rotation, velocities, Jacobians, an SPD
    covariance and 0.1 s already integrated (numpy)."""
    np_dt = DTYPES[name][0]
    r = lie.so3_exp(torch.from_numpy(rng.normal(size=3) * 0.4)).numpy()
    l9 = rng.normal(size=(9, 9)) * 1e-3
    return [a.astype(np_dt) for a in (
        r, rng.normal(size=3), rng.normal(size=3) * 0.1,
        *(rng.normal(size=(3, 3)) * 0.01 for _ in range(5)),
        l9 @ l9.T + np.eye(9) * 1e-8, np.array(0.1))]


def _chunk(rng, name, m, valid):
    """(gyr, acc, mask, bg, ba) of m samples; `valid` the mask."""
    np_dt = DTYPES[name][0]
    gyr = rng.normal(size=(m, 3)) * 0.5
    acc = rng.normal(size=(m, 3)) * 2.0 + [0.0, 0.0, 9.81]
    return (gyr.astype(np_dt), acc.astype(np_dt), np.asarray(valid, bool),
            (rng.normal(size=3) * 0.01).astype(np_dt), (rng.normal(size=3) * 0.1).astype(np_dt))


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(np.asarray(a)) for a in arrays]


def _close(got, ref, tol, what=""):
    """Each field within tol x its largest |entry| (of ref)."""
    for name, g, r in zip(got._fields, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g, r, atol=tol * scale, rtol=0,
                                   err_msg=f"{what} {name}")


# the JAX side jitted: eagerly it dispatches ~700 operations a chunk
_jax_integrate = jax.jit(jpre.integrate_chunk)


def _run(fn, state, chunks, params):
    for c in chunks:
        state = fn(state, *c, params)
    return state


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_matches_jax_integrate_chunk_chained(name):
    """Three 32-sample chunks (the last with trailing padding) from a
    non-zero state, then `finalize`, `repropagate` and `predict` on the
    result: the port's scan against JAX's, within TOL; the port's loop
    within LOOP_TOL of the scan."""
    rng = np.random.default_rng(11)
    jp, tp = _params(name)
    s0 = _start_state(rng, name)
    chunks = [_chunk(rng, name, 32, np.arange(32) < n) for n in (32, 32, 21)]
    ref = _run(_jax_integrate, jpre.PreintState(*_j(s0)), [_j(c) for c in chunks], jp)
    got = _run(tpre.integrate_chunk, tpre.PreintState(*_t(s0)), [_t(c) for c in chunks], tp)
    loop = _run(tpre.integrate_chunk_sequential, tpre.PreintState(*_t(s0)),
                [_t(c) for c in chunks], tp)
    _close(got, ref, TOL[name], "scan vs JAX")
    _close(loop, got, LOOP_TOL[name], "loop vs scan")

    bg, ba = chunks[-1][3:]
    jic = jpre.finalize(ref, *_j((bg, ba)), jp)
    tic = tpre.finalize(got, *_t((bg, ba)), tp)
    _close(tic, jic, 100 * TOL[name], "finalize")   # an SPD inverse of the 15x15
    dbg, dba = (rng.normal(size=3) * s for s in (1e-3, 1e-2))
    dbg, dba = dbg.astype(DTYPES[name][0]), dba.astype(DTYPES[name][0])
    _close(tpre.repropagate(tic, *_t((dbg, dba))), jpre.repropagate(jic, *_j((dbg, dba))),
           10 * TOL[name], "repropagate")
    r_i = s0[0]
    v_i, p_i, grav = (rng.normal(size=3).astype(DTYPES[name][0]) for _ in range(3))
    for kw in ({}, {"dbg_i": dbg, "dba_i": dba}):
        got_p = tpre.predict(*_t((r_i, v_i, p_i)), tic, torch.from_numpy(grav),
                             **dict(zip(kw, _t(kw.values()))))
        ref_p = jpre.predict(*_j((r_i, v_i, p_i)), jic, jnp.asarray(grav),
                             **dict(zip(kw, _j(kw.values()))))
        for g, r in zip(got_p, ref_p):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, atol=10 * TOL[name] * np.abs(r).max(),
                                       rtol=0)


@pytest.mark.parametrize("name", ["float32", "float64"])
@pytest.mark.parametrize("m", [7, 13])
def test_odd_lengths_with_interior_padding(m, name):
    """Odd chunk lengths carry an element past each odd level of the
    reduction (and the scan's recursion); masked samples inside the chunk
    and at its end. Against JAX within TOL."""
    rng = np.random.default_rng(m)
    jp, tp = _params(name)
    s0 = _start_state(rng, name)
    valid = np.ones(m, bool)
    valid[[1, m // 2, m - 1]] = False
    chunks = [_chunk(rng, name, m, valid), _chunk(rng, name, m, np.ones(m, bool))]
    ref = _run(_jax_integrate, jpre.PreintState(*_j(s0)), [_j(c) for c in chunks], jp)
    got = _run(tpre.integrate_chunk, tpre.PreintState(*_t(s0)), [_t(c) for c in chunks], tp)
    _close(got, ref, TOL[name], f"m={m}")


@pytest.mark.parametrize("pad", ["trailing", "interior"])
def test_masking_equals_truncation(pad):
    """Masked samples are skipped: a 32-sample chunk with 11 masked (at the
    end, or spread through it) equals the chunk of its 21 valid samples,
    and the loop agrees (float64)."""
    rng = np.random.default_rng(5)
    _, tp = _params("float64")
    s0 = tpre.PreintState(*_t(_start_state(rng, "float64")))
    valid = (np.arange(32) < 21) if pad == "trailing" else (rng.permutation(32) < 21)
    gyr, acc, mask, bg, ba = _t(_chunk(rng, "float64", 32, valid))
    padded = tpre.integrate_chunk(s0, gyr, acc, mask, bg, ba, tp)
    kept = tpre.integrate_chunk(s0, gyr[mask], acc[mask], mask[mask], bg, ba, tp)
    _close(padded, kept, TOL["float64"], pad)
    _close(tpre.integrate_chunk_sequential(s0, gyr, acc, mask, bg, ba, tp), padded,
           LOOP_TOL["float64"], pad + " loop")


@pytest.mark.parametrize("split", [1, 13, 16, 31])
def test_chunked_equals_single(split):
    """Two chunks integrated one after the other equal the single chunk of
    their samples (float64): the state carries everything across."""
    rng = np.random.default_rng(split)
    _, tp = _params("float64")
    s0 = tpre.PreintState(*_t(_start_state(rng, "float64")))
    gyr, acc, mask, bg, ba = _t(_chunk(rng, "float64", 32, np.ones(32, bool)))
    one = tpre.integrate_chunk(s0, gyr, acc, mask, bg, ba, tp)
    two = tpre.integrate_chunk(s0, gyr[:split], acc[:split], mask[:split], bg, ba, tp)
    two = tpre.integrate_chunk(two, gyr[split:], acc[split:], mask[split:], bg, ba, tp)
    _close(two, one, TOL["float64"], f"split {split}")


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_vmap_lanes_equal_single_calls(name):
    """B lanes under `torch.func.vmap` (the batched step's form) equal B
    single calls, each lane its own state, samples, mask and biases, within
    TOL: a batched 3x3 product may take another kernel than a single one,
    and so sum its terms apart."""
    rng = np.random.default_rng(3)
    _, tp = _params(name)
    lanes = [(_start_state(rng, name),
              _chunk(rng, name, 32, rng.permutation(32) < 10 + 7 * b)) for b in range(3)]
    states = tpre.PreintState(*(torch.stack(x) for x in zip(*(_t(s) for s, _ in lanes))))
    inputs = [torch.stack(x) for x in zip(*(_t(c) for _, c in lanes))]
    batched = torch.func.vmap(
        lambda s, g, a, m, bg, ba: tpre.integrate_chunk(s, g, a, m, bg, ba, tp))(states, *inputs)
    for b, (s, c) in enumerate(lanes):
        one = tpre.integrate_chunk(tpre.PreintState(*_t(s)), *_t(c), tp)
        _close(tpre.PreintState(*(x[b] for x in batched)), one, TOL[name], f"lane {b}")


@pytest.mark.parametrize("form", ["integrate_chunk", "integrate_chunk_sequential"])
def test_all_masked_chunk_is_an_exact_noop(form):
    """From a non-zero state, a chunk with every sample masked returns the
    state bit for bit (identity elements, not merely close ones)."""
    rng = np.random.default_rng(8)
    _, tp = _params("float32")
    s0 = tpre.PreintState(*_t(_start_state(rng, "float32")))
    chunk = _t(_chunk(rng, "float32", 13, np.zeros(13, bool)))
    s1 = getattr(tpre, form)(s0, *chunk, tp)
    for field, a, b in zip(s0._fields, s0, s1):
        assert torch.equal(a, b), field


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 32])
def test_associative_scan_matches_jax(n):
    """The scan helper against `jax.lax.associative_scan`: prefix products
    of float32 rotations (each product's three terms may sum apart: a few
    ulps), and exactly on integers: addition, and the composition of the
    affine maps x -> a x + c, which does not commute, as a tree of two
    tensors."""
    rng = np.random.default_rng(n)
    rots = lie.so3_exp(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))).numpy()
    got = associative_scan(torch.matmul, torch.from_numpy(rots)).numpy()
    ref = np.asarray(jax.lax.associative_scan(jnp.matmul, jnp.asarray(rots)))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    prefix = np.eye(3)
    for k in range(n):   # the order: element k is r_0 r_1 ... r_k
        prefix = prefix @ rots[k].astype(np.float64)
        np.testing.assert_allclose(got[k], prefix, atol=1e-5, rtol=0)

    ints = rng.integers(-50, 50, size=(n, 2))
    np.testing.assert_array_equal(
        associative_scan(torch.add, torch.from_numpy(ints)).numpy(),
        np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(ints))))
    a, c = rng.integers(-3, 4, size=n), rng.integers(-9, 10, size=n)

    def compose(f, g):   # g after f
        return g[0] * f[0], g[0] * f[1] + g[1]

    got_a, got_c = associative_scan(compose, (torch.from_numpy(a), torch.from_numpy(c)))
    ref_a, ref_c = jax.lax.associative_scan(compose, (jnp.asarray(a), jnp.asarray(c)))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))


@pytest.mark.parametrize("scale", [1e-3, 0.05, 0.8, 2.5])
def test_exp_and_jacobian_share_terms_bit_for_bit(scale):
    """`lie.so3_exp_and_right_jacobian`, which the scan calls once for the
    chunk, equals `so3_exp` and `right_jacobian` called apart, bit for bit,
    on both sides of the small-angle branch."""
    w = torch.from_numpy((np.random.default_rng(4).normal(size=(64, 3)) * scale)
                         .astype(np.float32))
    exp, jr = lie.so3_exp_and_right_jacobian(w)
    assert torch.equal(exp, lie.so3_exp(w))
    assert torch.equal(jr, lie.right_jacobian(w))


class _CountOps(TorchDispatchMode):
    """Counts the aten operations dispatched, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _ops(fn, m):
    _, tp = _params("float32")
    gyr, acc, mask, bg, ba = _t(_chunk(np.random.default_rng(0), "float32", m, np.ones(m, bool)))
    with _CountOps() as count:
        fn(tpre.init_state("cpu"), gyr, acc, mask, bg, ba, tp)
    return count.n


# aten operations a doubling of the chunk may add: one level of the scan's
# recursion and one of the reduction (16 on this form)
OPS_PER_DOUBLING = 32


def test_op_count_grows_by_a_bounded_amount_per_doubling():
    """The scan's work in operations is log-depth: from M = 8 to 32 and
    from 32 to 128 (two doublings each) it adds at most 2 x
    OPS_PER_DOUBLING operations, where the per-sample loop adds that
    several times over in a single doubling (so a loop cannot come back
    unseen)."""
    n8, n32, n128 = (_ops(tpre.integrate_chunk, m) for m in (8, 32, 128))
    assert n32 - n8 <= 2 * OPS_PER_DOUBLING, (n8, n32)
    assert n128 - n32 <= 2 * OPS_PER_DOUBLING, (n32, n128)
    loop8, loop16 = (_ops(tpre.integrate_chunk_sequential, m) for m in (8, 16))
    assert loop16 - loop8 > 4 * OPS_PER_DOUBLING, (loop8, loop16)
