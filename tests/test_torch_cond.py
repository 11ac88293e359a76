"""`graphs.cond`, the port's `lax.cond` for a branch whose other side
returns the carry or constants.

In a captured CUDA graph the branch is one conditional IF node
(`csrc/graph_cond.cu`) over buffers that hold the untaken side's values;
the card is not here, so these tests run its host form
(`graphs.host_conditionals`: the same buffers, the predicate read on the
host) against the select that the eager path, the CPU and `torch.func.vmap`
run, bit for bit, with an LM solve inside the branch (a WHILE node nested
in the IF node on the card) and its logged iterations: a solve of a branch
not taken logs 0, as the JAX package's `skip_ba` reports. The frame step's
sites are held to each other and to the JAX package in
`test_torch_stages.py` (`test_conditional_forms_match`) and
`test_torch_full_ba_step.py` (`test_full_ba_conditional_forms_match`).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch import graphs  # noqa: E402
from pose_estimation_tpu_torch.backend import lm  # noqa: E402

CAP = 20


def _problem(seed):
    """A small normal-equations LM problem from a seed (numpy data)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(30, 6)))
    b = torch.from_numpy(rng.normal(size=30) * 3.0)

    def normal_fn(x):
        r = a @ x - b + 0.3 * torch.sin(x).sum()
        return a.T @ a, a.T @ r, 0.5 * (r * r).sum()

    return normal_fn


def _site(pred, x0, normal_fn, kept):
    """A cond whose branch solves (x, its iterations) from x0 and leaves
    `kept` alone; the untaken side is (x0, 0 iterations, kept)."""
    def branch():
        x, info = lm.lm_solve_normal(normal_fn, x0, lm.LMOptions(max_iterations=CAP),
                                     name="solve")
        return x, info["iterations"], kept

    zero = torch.zeros((), dtype=torch.int32)
    return graphs.cond(pred, branch, (x0, zero, kept), solves=(("solve", CAP),))


def _run(form, fn):
    """fn() in `form` ("select" or "host") with the iteration log on: its
    result and the (solve, iterations, cap) it logged."""
    graphs.iteration_log = []
    try:
        with graphs.host_conditionals() if form == "host" else contextlib.nullcontext():
            out = fn()
        return out, graphs.read_iterations(graphs.iteration_log)
    finally:
        graphs.iteration_log = None


@pytest.mark.parametrize("taken", [True, False])
def test_host_form_equals_select(taken):
    """The host form of the IF node and the select: the same values bit
    for bit, the leaf the branch leaves alone kept as the same tensor, and
    the solve logged with its iterations where taken and with 0 where
    not."""
    normal_fn = _problem(0)
    x0 = torch.full((6,), 0.1, dtype=torch.float64)
    kept = torch.arange(3.0)
    pred = torch.tensor(taken)
    sel, sel_log = _run("select", lambda: _site(pred, x0, normal_fn, kept))
    host, host_log = _run("host", lambda: _site(pred, x0, normal_fn, kept))
    for a, b in zip(sel, host, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sel[2] is kept and host[2] is kept
    x, info = lm.lm_solve_normal(normal_fn, x0, lm.LMOptions(max_iterations=CAP))
    n = int(info["iterations"])
    assert 0 < n < CAP
    if taken:
        torch.testing.assert_close(host[0], x, rtol=0, atol=0)
        assert int(host[1]) == n
    else:
        assert torch.equal(host[0], x0) and int(host[1]) == 0
    assert sel_log == host_log == [("solve", n if taken else 0, CAP)]


def test_branch_must_match_its_other_side():
    """A branch whose leaves differ from the untaken side's in shape, or
    which logs solves other than those declared, raises in every form that
    checks them."""
    pred = torch.tensor(True)
    with graphs.host_conditionals(), pytest.raises(ValueError, match="leaves differ"):
        graphs.cond(pred, lambda: torch.zeros(3), torch.zeros(2))
    normal_fn = _problem(1)
    x0 = torch.zeros(6, dtype=torch.float64)
    for form in ("select", "host"):
        with pytest.raises(RuntimeError, match="logged the solves"):
            _run(form, lambda: graphs.cond(
                pred, lambda: lm.lm_solve_normal(normal_fn, x0, name="other")[0], x0,
                solves=(("solve", CAP),)))


def test_vmap_keeps_the_select():
    """Under `torch.func.vmap` (the batched step) `cond` is the select of
    JAX's vmapped `lax.cond`, also inside `host_conditionals`, where a
    host read of a batched predicate would fail: each lane gets its own
    side, and its solve the fixed loop."""
    normal_fn = _problem(2)
    x0 = torch.stack([torch.zeros(6, dtype=torch.float64),
                      torch.full((6,), 0.2, dtype=torch.float64)])
    preds = torch.tensor([True, False])
    kept = torch.ones(2, 3)

    with graphs.host_conditionals():
        got = torch.func.vmap(lambda p, x, k: _site(p, x, normal_fn, k))(preds, x0, kept)
    for j in range(2):
        ref, _ = _run("select", lambda: _site(preds[j], x0[j], normal_fn, kept[j]))
        for a, b in zip(got, ref, strict=True):
            torch.testing.assert_close(a[j], b, rtol=0, atol=1e-12)
    assert int(got[1][1]) == 0 and torch.equal(got[0][1], x0[1])
