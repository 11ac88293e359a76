"""The eager forms of the program's conditional dispatch, for the frozen
frame step: `iterate` is the fixed loop (an LM iteration past convergence
is a no-op, so the fixed loop equals the early exit bit for bit), `cond`
computes the branch and selects, and `log_iterations` keeps each solve's
count in `iteration_log` when that is a list."""

from __future__ import annotations

iteration_log: list | None = None


def log_iterations(name: str, iterations, cap: int) -> None:
    if iteration_log is not None:
        iteration_log.append((name, iterations, cap))


def iterate(body, carry, iterations: int, live):
    for _ in range(iterations):
        carry = body(carry)
    return carry


def cond(pred, branch, otherwise, solves=()):
    import torch

    from vio_bench.ref.models.vio import select

    log = iteration_log
    mark = len(log) if log is not None else 0
    out = branch()
    if log is not None:
        log[mark:] = [(name, torch.where(pred, it, 0), cap) for name, it, cap in log[mark:]]
    return select(pred, out, otherwise)
