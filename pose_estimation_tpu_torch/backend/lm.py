"""Levenberg-Marquardt with a constant Jacobian (Ceres' gain-ratio trust
region).

Counterpart of `pose_estimation_tpu/backend/lm.py`: `lm_solve` takes the
residual function and the frozen Jacobian (the initializer's small
problems), `lm_solve_normal` the normal equations directly (the motion-only
BA). The JAX `lax.while_loop` becomes a loop of `max_iterations`
iterations whose body freezes the state once it is done, which gives the
same iterate and iteration count with no host sync per iteration
(`graphs.iterate`): eagerly every iteration runs; in a captured CUDA graph
the loop is one conditional WHILE node, so the device stops at
convergence as JAX's loop does, with the same result bit for bit. A
Cholesky failure zeroes the step, which is then rejected
(`jnp.linalg.cholesky` returns NaN there; `torch.linalg.cholesky_ex`
reports it in `info`). No step reads a result on the host. Each solve
hands its iteration count to `graphs.log_iterations` under its `name`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pose_estimation_tpu_torch.utils.linalg import cho_solve


class LMOptions(NamedTuple):
    max_iterations: int = 20
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-16
    max_lambda: float = 1e32
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-8


def _weighted_cost(r, w):
    return 0.5 * torch.sum(w * r * r)


class _Carry(NamedTuple):
    """The state of `lm_solve`'s loop (`lm_solve_normal` carries h and g in
    r and w)."""
    x: torch.Tensor
    r: torch.Tensor
    w: torch.Tensor
    cost: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    accepted: torch.Tensor
    done: torch.Tensor


def _start(x0, a, b, cost, options):
    dtype, dev = x0.dtype, x0.device
    return _Carry(x0, a, b, cost,
                  torch.full((), options.initial_lambda, dtype=dtype, device=dev),
                  torch.full((), 2.0, dtype=dtype, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev),
                  torch.zeros((), dtype=torch.int32, device=dev),
                  torch.zeros((), dtype=torch.bool, device=dev))


def _step(s: _Carry, x_new, a_new, b_new, new_cost, step, g, h, bad_chol, options) -> _Carry:
    """The gain-ratio accept, damping update and convergence test of one
    iteration; the carry frozen where it was done."""
    model_decrease = torch.clamp(-(g @ step) - 0.5 * step @ (h @ step), min=1e-32)
    rho = (s.cost - new_cost) / model_decrease
    finite = torch.isfinite(new_cost)
    accept = (rho > options.min_relative_decrease) & finite & ~bad_chol

    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_acc = torch.clamp(s.lam * shrink, options.min_lambda, options.max_lambda)
    lam_rej = torch.clamp(s.lam * s.nu, options.min_lambda, options.max_lambda)

    f_conv = (s.cost - new_cost).abs() <= options.function_tolerance * (s.cost + 1e-32)
    p_conv = torch.linalg.norm(step) <= options.parameter_tolerance * (
        torch.linalg.norm(s.x) + options.parameter_tolerance
    )
    now_done = (f_conv | p_conv) & finite & ~bad_chol

    live = ~s.done
    take = live & accept
    return _Carry(
        x=torch.where(take, x_new, s.x),
        r=torch.where(take, a_new, s.r),
        w=torch.where(take, b_new, s.w),
        cost=torch.where(take, new_cost, s.cost),
        lam=torch.where(live, torch.where(accept, lam_acc, lam_rej), s.lam),
        nu=torch.where(live, torch.where(accept, 2.0, s.nu * 2.0), s.nu),
        it=s.it + live.to(torch.int32),
        accepted=s.accepted + take.to(torch.int32),
        done=s.done | now_done,
    )


def _damped_step(h, g, lam, eye):
    """The Levenberg-Marquardt step of (H + lam diag(H)) step = -g, zero
    where the Cholesky fails, and whether it failed."""
    d = torch.diagonal(h)
    d = torch.where(d > 0, d, 1.0)
    chol, info = torch.linalg.cholesky_ex(h + lam * torch.diag(d) + 1e-32 * eye)
    step = -cho_solve(chol, g[:, None])[:, 0]
    bad_chol = (info != 0) | ~torch.all(torch.isfinite(step))
    return torch.where(bad_chol, 0.0, step), bad_chol


def _iterate(body, start: _Carry, iterations: int, name: str) -> _Carry:
    """The solve's loop (`graphs.iterate`) from `start`, its iteration
    count logged under `name`."""
    # imported here: graphs imports the models, which import this module
    from pose_estimation_tpu_torch import graphs

    s = graphs.iterate(body, start, iterations, lambda c: ~c.done, name)
    graphs.log_iterations(name, s.it, iterations)
    return s


def lm_solve(residual_fn: Callable, jac: torch.Tensor, x0: torch.Tensor,
             weight_fn: Callable | None = None, options: LMOptions = LMOptions(),
             cost_fn: Callable | None = None, name: str = "lm"):
    """Minimize 0.5 || sqrt(w(r)) r(x) ||^2 with the frozen Jacobian `jac`
    [m, n]. weight_fn maps the residual vector to per-residual IRLS weights
    (unit weights by default); cost_fn(r), where given, is the cost the
    accept and convergence tests use. Returns (x, info)."""
    if weight_fn is None:
        def weight_fn(r):
            return torch.ones_like(r)

    def cost_of(r, w):
        return cost_fn(r) if cost_fn is not None else _weighted_cost(r, w)

    r = residual_fn(x0)
    w = weight_fn(r)
    cost0 = cost_of(r, w)
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)

    def body(s: _Carry) -> _Carry:
        jtw = jac.T * s.w[None, :]
        h = jtw @ jac
        g = jtw @ s.r
        step, bad_chol = _damped_step(h, g, s.lam, eye)
        x_new = s.x + step
        r_new = residual_fn(x_new)
        w_new = weight_fn(r_new)
        return _step(s, x_new, r_new, w_new, cost_of(r_new, w_new), step, g, h, bad_chol,
                     options)

    s = _iterate(body, _start(x0, r, w, cost0, options), options.max_iterations, name)
    info = {"initial_cost": cost0, "final_cost": s.cost, "iterations": s.it,
            "accepted_steps": s.accepted, "lambda": s.lam}
    return s.x, info


def lm_solve_normal(normal_fn: Callable, x0: torch.Tensor,
                    options: LMOptions = LMOptions(), name: str = "lm_normal"):
    """normal_fn(x) -> (H [n, n], g [n], cost) of the IRLS-weighted problem
    at x. Returns (x, info)."""
    h0, g0, cost0 = normal_fn(x0)
    eye = torch.eye(x0.shape[0], dtype=x0.dtype, device=x0.device)

    def body(s: _Carry) -> _Carry:
        h, g = s.r, s.w
        step, bad_chol = _damped_step(h, g, s.lam, eye)
        x_new = s.x + step
        h_new, g_new, new_cost = normal_fn(x_new)
        return _step(s, x_new, h_new, g_new, new_cost, step, g, h, bad_chol, options)

    s = _iterate(body, _start(x0, h0, g0, cost0, options), options.max_iterations, name)
    info = {
        "initial_cost": cost0, "final_cost": s.cost, "iterations": s.it,
        "accepted_steps": s.accepted, "lambda": s.lam, "h_final": s.r,
    }
    return s.x, info


def huber_block_weights(r_blocks, mask, delta: float = 1.0):
    """Per-block Huber IRLS weights (Ceres HuberLoss on the squared norm)."""
    s = torch.sum(r_blocks * r_blocks, dim=-1)
    w = torch.where(s <= delta * delta, 1.0,
                    delta / torch.sqrt(torch.clamp(s, min=1e-32)))
    return torch.where(mask, w, 0.0)
