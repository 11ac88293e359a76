"""Levenberg-Marquardt with a constant Jacobian (Ceres' gain-ratio trust
region).

Counterpart of `pose_estimation_tpu/backend/lm.py`: `lm_solve` takes the
residual function and the frozen Jacobian (the initializer's small
problems), `lm_solve_normal` the normal equations directly (the motion-only
BA). The JAX `lax.while_loop` becomes a loop of exactly `max_iterations`
iterations that freezes the state once it is done, which gives the same
iterate and iteration count with no host sync per iteration. A Cholesky
failure zeroes the step, which is then rejected (`jnp.linalg.cholesky`
returns NaN there; `torch.linalg.cholesky_ex` reports it in `info`). No
step reads a result on the host, so a CUDA graph captures the loop.
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


def lm_solve(residual_fn: Callable, jac: torch.Tensor, x0: torch.Tensor,
             weight_fn: Callable | None = None, options: LMOptions = LMOptions(),
             cost_fn: Callable | None = None):
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
    cost = cost_of(r, w)
    dtype, dev = x0.dtype, x0.device
    eye = torch.eye(x0.shape[0], dtype=dtype, device=dev)
    x = x0
    lam = torch.full((), options.initial_lambda, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    cost0 = cost

    for _ in range(options.max_iterations):
        live = ~done
        jtw = jac.T * w[None, :]
        h = jtw @ jac
        g = jtw @ r
        d = torch.diagonal(h)
        d = torch.where(d > 0, d, 1.0)
        chol, info = torch.linalg.cholesky_ex(h + lam * torch.diag(d) + 1e-32 * eye)
        step = -cho_solve(chol, g[:, None])[:, 0]
        bad_chol = (info != 0) | ~torch.all(torch.isfinite(step))
        step = torch.where(bad_chol, 0.0, step)

        x_new = x + step
        r_new = residual_fn(x_new)
        w_new = weight_fn(r_new)
        new_cost = cost_of(r_new, w_new)

        model_decrease = torch.clamp(-(g @ step) - 0.5 * step @ (h @ step), min=1e-32)
        rho = (cost - new_cost) / model_decrease
        finite = torch.isfinite(new_cost)
        accept = (rho > options.min_relative_decrease) & finite & ~bad_chol

        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_acc = torch.clamp(lam * shrink, options.min_lambda, options.max_lambda)
        lam_rej = torch.clamp(lam * nu, options.min_lambda, options.max_lambda)

        f_conv = (cost - new_cost).abs() <= options.function_tolerance * (cost + 1e-32)
        p_conv = torch.linalg.norm(step) <= options.parameter_tolerance * (
            torch.linalg.norm(x) + options.parameter_tolerance
        )
        now_done = (f_conv | p_conv) & finite & ~bad_chol

        take = live & accept
        x = torch.where(take, x_new, x)
        r = torch.where(take, r_new, r)
        w = torch.where(take, w_new, w)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, torch.where(accept, lam_acc, lam_rej), lam)
        nu = torch.where(live, torch.where(accept, 2.0, nu * 2.0), nu)
        it = it + live.to(torch.int32)
        accepted = accepted + take.to(torch.int32)
        done = done | now_done

    info = {"initial_cost": cost0, "final_cost": cost, "iterations": it,
            "accepted_steps": accepted, "lambda": lam}
    return x, info


def lm_solve_normal(normal_fn: Callable, x0: torch.Tensor,
                    options: LMOptions = LMOptions()):
    """normal_fn(x) -> (H [n, n], g [n], cost) of the IRLS-weighted problem
    at x. Returns (x, info)."""
    h, g, cost = normal_fn(x0)
    dtype, dev = x0.dtype, x0.device
    n = x0.shape[0]
    eye = torch.eye(n, dtype=dtype, device=dev)
    x = x0
    lam = torch.full((), options.initial_lambda, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    cost0 = cost

    for _ in range(options.max_iterations):
        live = ~done
        d = torch.diagonal(h)
        d = torch.where(d > 0, d, 1.0)
        h_damped = h + lam * torch.diag(d) + 1e-32 * eye
        chol, info = torch.linalg.cholesky_ex(h_damped)
        step = -cho_solve(chol, g[:, None])[:, 0]
        bad_chol = (info != 0) | ~torch.all(torch.isfinite(step))
        step = torch.where(bad_chol, 0.0, step)

        x_new = x + step
        h_new, g_new, new_cost = normal_fn(x_new)

        model_decrease = -(g @ step) - 0.5 * step @ (h @ step)
        model_decrease = torch.clamp(model_decrease, min=1e-32)
        rho = (cost - new_cost) / model_decrease
        finite = torch.isfinite(new_cost)
        accept = (rho > options.min_relative_decrease) & finite & ~bad_chol

        shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_acc = torch.clamp(lam * shrink, options.min_lambda, options.max_lambda)
        lam_rej = torch.clamp(lam * nu, options.min_lambda, options.max_lambda)

        cost_change = (cost - new_cost).abs()
        f_conv = cost_change <= options.function_tolerance * (cost + 1e-32)
        p_conv = torch.linalg.norm(step) <= options.parameter_tolerance * (
            torch.linalg.norm(x) + options.parameter_tolerance
        )
        now_done = (f_conv | p_conv) & finite & ~bad_chol

        take = live & accept
        x = torch.where(take, x_new, x)
        h = torch.where(take, h_new, h)
        g = torch.where(take, g_new, g)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(live, torch.where(accept, lam_acc, lam_rej), lam)
        nu = torch.where(live, torch.where(accept, 2.0, nu * 2.0), nu)
        it = it + live.to(torch.int32)
        accepted = accepted + take.to(torch.int32)
        done = done | now_done

    info = {
        "initial_cost": cost0, "final_cost": cost, "iterations": it,
        "accepted_steps": accepted, "lambda": lam, "h_final": h,
    }
    return x, info


def huber_block_weights(r_blocks, mask, delta: float = 1.0):
    """Per-block Huber IRLS weights (Ceres HuberLoss on the squared norm)."""
    s = torch.sum(r_blocks * r_blocks, dim=-1)
    w = torch.where(s <= delta * delta, 1.0,
                    delta / torch.sqrt(torch.clamp(s, min=1e-32)))
    return torch.where(mask, w, 0.0)
