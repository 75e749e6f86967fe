"""Numerical optimization on the bsts path (port of ``OptResult``, ``bfgs``
and ``newton_raphson`` in boom_tpu/numopt.py:25-133), for the TIM
proposal's mode search, and ``linear_assignment`` (:279) for the
mixtures' relabelling.

Both routines MINIMIZE a scalar function of a flat tensor ``x`` with the
reference's iteration and backtracking counts and tolerances. Gradients and
Hessians come from ``torch.autograd`` (through a kernel's own
``autograd.Function`` where the objective runs one on the card). The
reference's fixed-length backtracking scans keep evaluating after the
first acceptable step and then discard those values; here the loop stops
at that step, which gives the same iterates with fewer evaluations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class OptResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    converged: bool
    iterations: int


def _value_and_grad(fn, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        val = fn(x)
        (grad,) = torch.autograd.grad(val, x)
    return val.detach(), grad


def _max_abs(g) -> float:
    return float(g.abs().max())


def bfgs(fn: Callable, x0, max_iters: int = 200, tol: float = 1e-8):
    """BFGS with inverse-Hessian updates and Armijo backtracking (at most
    20 halvings), as the reference's ``bfgs``."""
    x = x0.detach()
    dim = x.shape[0]
    eye = torch.eye(dim, dtype=x.dtype, device=x.device)
    val, g = _value_and_grad(fn, x)
    h_inv = eye
    it = 0
    done = False
    while not done and it < max_iters:
        direction = -(h_inv @ g)
        slope = g @ direction
        alpha, ok = 1.0, False
        with torch.no_grad():
            for _ in range(20):
                if fn(x + alpha * direction) <= val + 1e-4 * alpha * slope:
                    ok = True
                    break
                alpha *= 0.5
        x_new = x + (alpha if ok else 0.0) * direction
        val_new, g_new = _value_and_grad(fn, x_new)
        s = x_new - x
        y_vec = g_new - g
        sy = float(s @ y_vec)
        if sy > 1e-12:
            rho = 1.0 / sy
            v = eye - rho * torch.outer(s, y_vec)
            h_inv = v @ h_inv @ v.T + rho * torch.outer(s, s)
        done = _max_abs(g_new) < tol or not ok
        x, val, g = x_new, val_new, g_new
        it += 1
    return OptResult(x=x, value=val, converged=_max_abs(g) < 1e-5,
                     iterations=it)


def newton_raphson(fn: Callable, x0, max_iters: int = 50, tol: float = 1e-10,
                   ridge: float = 1e-8):
    """Damped Newton with ridge-regularized Hessian solves; halves the
    step (at most 10 times) while the objective does not decrease, as the
    reference's ``newton_raphson``."""
    z = x0.detach()
    dim = z.shape[0]
    eye = torch.eye(dim, dtype=z.dtype, device=z.device)
    val, g = _value_and_grad(fn, z)
    it = 0
    done = False
    while not done and it < max_iters:
        h = torch.autograd.functional.hessian(fn, z) + ridge * eye
        step = torch.linalg.solve(h, g)
        alpha, improved = 1.0, False
        with torch.no_grad():
            for _ in range(10):
                cand = z - alpha * step
                cv = fn(cand)
                if cv < val:
                    z, val, improved = cand, cv, True
                    break
                alpha *= 0.5
        _, g = _value_and_grad(fn, z)
        done = _max_abs(g) < tol or not improved
        it += 1
    return OptResult(x=z, value=val, converged=_max_abs(g) < 1e-5,
                     iterations=it)


def linear_assignment(cost):
    """Minimum-cost perfect assignment on a square cost matrix (port of
    boom_tpu/numopt.py:279): the host-side O(n^3) Hungarian (Jonker-
    Volgenant potentials) in numpy, the reference's own, so that a tie
    resolves as there (mixture relabelling, analysis-time).

    Returns row_to_col: row i is assigned column row_to_col[i]."""
    c = np.asarray(cost, dtype=float)
    assert c.ndim == 2 and c.shape[0] == c.shape[1], c.shape
    n = c.shape[0]
    # potentials u (rows), v (cols); way[j] = predecessor col on the
    # augmenting path; p[j] = row matched to col j (1-indexed internals)
    inf = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, inf)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], inf, 0
            for j in range(1, n + 1):
                if not used[j]:
                    cur = c[i0 - 1, j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.zeros(n, dtype=int)
    for j in range(1, n + 1):
        if p[j] > 0:
            row_to_col[p[j] - 1] = j - 1
    return row_to_col
