"""Anderson-accelerated nonlinear solver
(counterpart of ``xpic_tpu/solvers/anderson.py``, the host-paced solve).

Replaces the reference's SNES NGMRES solve
(src/impls/eccapfim/simulation.cpp:358-392; tolerances atol=rtol=stol
=1e-7, maxit=1000).  PETSc's NGMRES is Anderson mixing over a residual
window; this is Anderson(m) with least-squares mixing.

The outer iteration is a host loop.  The window is a fixed [m+1, n]
buffer on the operand's device with a validity mask (newest entry last),
so every window fill level takes the same vector algebra; the Gram
products run in the operand's dtype at full precision.  The only host
traffic per iteration is one read of three scalars (residual, step and
solution norms).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class NonlinearResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    history: list


def _push_window(Xs, Fs, mask, x, F):
    """Shift the window left and append (x, F) as the newest entry."""
    Xs = torch.cat([Xs[1:], x[None]])
    Fs = torch.cat([Fs[1:], F[None]])
    mask = torch.cat([mask[1:], torch.ones_like(mask[:1])])
    return Xs, Fs, mask


def _mix(Xs, Fs, mask, damping):
    """One Anderson update from the masked window.

    ``Xs``/``Fs`` are [m+1, n] with the newest entry last; ``mask``
    [m+1] marks filled slots.  Solves the regularized normal equations
    of min || F_k + dF gamma || over the masked history and returns
    (x_new, |F_k|, |x_new - X_k|, |x_new|).  Masked rows get a unit
    diagonal and zero right-hand side, so their gamma is exactly 0.
    """
    xk = Xs[-1]
    Fk = Fs[-1]
    rnorm = torch.linalg.norm(Fk)
    hmask = mask[:-1]
    dF = (Fs[:-1] - Fk) * hmask[:, None]  # [m, n]
    dX = (Xs[:-1] - xk) * hmask[:, None]
    G = dF @ dF.T
    scale = torch.clamp(torch.trace(G), min=1e-300)
    G = (G + (1e-12 * scale) * torch.eye(G.shape[0], dtype=G.dtype,
                                          device=G.device)
         + torch.diag(1.0 - hmask))
    gamma = torch.linalg.solve(G, -(dF @ Fk))
    x_new = xk + gamma @ dX - damping * (Fk + gamma @ dF)
    return (x_new, rnorm, torch.linalg.norm(x_new - xk),
            torch.linalg.norm(x_new))


def anderson_solve(residual_fn: Callable, x0, *, m: int = 10,
                   atol: float = 1e-7, rtol: float = 1e-7,
                   stol: float = 1e-7, maxit: int = 1000,
                   damping: float = 1.0) -> NonlinearResult:
    """Solve F(x) = 0 by Anderson mixing of the fixed-point x - F(x).

    ``residual_fn(x) -> F(x)`` (same shape as x).
    """
    shape = x0.shape
    xf = x0.reshape(-1)
    n = xf.shape[0]
    Ff = residual_fn(x0).reshape(-1)
    r0 = float(torch.linalg.norm(Ff))
    target = max(atol, rtol * r0)
    history = [r0]
    if r0 <= atol:
        return NonlinearResult(x0, 0, r0, True, history)

    Xs = x0.new_zeros((m + 1, n))
    Fs = x0.new_zeros((m + 1, n))
    mask = x0.new_zeros(m + 1)

    for it in range(1, maxit + 1):
        Xs, Fs, mask = _push_window(Xs, Fs, mask, xf, Ff)
        x_new, _, step_d, xnorm_d = _mix(Xs, Fs, mask, damping)

        xf = x_new
        Ff = residual_fn(xf.reshape(shape)).reshape(-1)

        # One host read per iteration: [residual, step, solution] norms.
        rnorm, step, xnorm = torch.stack(
            [torch.linalg.norm(Ff), step_d, xnorm_d]).tolist()
        history.append(rnorm)

        if rnorm <= target:
            return NonlinearResult(xf.reshape(shape), it, rnorm, True, history)
        # PETSc CONVERGED_SNORM_RELATIVE analog: a relative step below
        # stol counts as converged (SNESSetTolerances stol, used by the
        # reference at eccapfim/simulation.cpp:371).
        if step <= stol * max(xnorm, 1.0):
            return NonlinearResult(xf.reshape(shape), it, rnorm, True, history)

    return NonlinearResult(xf.reshape(shape), maxit, history[-1], False,
                           history)
