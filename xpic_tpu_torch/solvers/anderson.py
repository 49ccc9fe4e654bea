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

Over a z mesh (``mesh``, the operand being the rank's slab) the Gram
products of the next mix and the three squared norms are summed over
the ranks in one all-reduce an iteration, before that read; every rank
then solves the same small system and takes the same branch.
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


def _gram(Xs, Fs, mask):
    """The differences of the masked window against its newest entry and
    the rank's Gram products: ``(dF, dX, dF dF^T, dF F_k)``."""
    xk = Xs[-1]
    Fk = Fs[-1]
    hmask = mask[:-1]
    dF = (Fs[:-1] - Fk) * hmask[:, None]  # [m, n]
    dX = (Xs[:-1] - xk) * hmask[:, None]
    return dF, dX, dF @ dF.T, dF @ Fk


def _reduced(G, g, vectors, mesh):
    """``(G, g, norms)``: the Gram products and the 2-norms of
    ``vectors``; on a slab summed over the ranks in one all-reduce (the
    norms as roots of summed squares)."""
    if mesh is None:
        return G, g, torch.stack([torch.linalg.norm(v) for v in vectors])
    m = G.shape[0]
    sq = torch.stack([torch.sum(v * v) for v in vectors])
    s = mesh.allreduce_sum(torch.cat([G.reshape(-1), g, sq]))
    return s[:m * m].reshape(m, m), s[m * m:m * m + m], \
        torch.sqrt(s[m * m + m:])


def _mix(Xs, Fs, mask, damping, gram=None):
    """One Anderson update from the masked window.

    ``Xs``/``Fs`` are [m+1, n] with the newest entry last; ``mask``
    [m+1] marks filled slots; ``gram`` is :func:`_gram`'s result with its
    products already reduced over the ranks (default: this window's, on
    one rank).  Solves the regularized normal equations of
    min || F_k + dF gamma || over the masked history and returns x_new.
    Masked rows get a unit diagonal and zero right-hand side, so their
    gamma is exactly 0.
    """
    xk = Xs[-1]
    Fk = Fs[-1]
    hmask = mask[:-1]
    dF, dX, G, g = _gram(Xs, Fs, mask) if gram is None else gram
    scale = torch.clamp(torch.trace(G), min=1e-300)
    G = (G + (1e-12 * scale) * torch.eye(G.shape[0], dtype=G.dtype,
                                          device=G.device)
         + torch.diag(1.0 - hmask))
    gamma = torch.linalg.solve(G, -g)
    return xk + gamma @ dX - damping * (Fk + gamma @ dF)


def anderson_solve(residual_fn: Callable, x0, *, m: int = 10,
                   atol: float = 1e-7, rtol: float = 1e-7,
                   stol: float = 1e-7, maxit: int = 1000,
                   damping: float = 1.0, mesh=None) -> NonlinearResult:
    """Solve F(x) = 0 by Anderson mixing of the fixed-point x - F(x).

    ``residual_fn(x) -> F(x)`` (same shape as x).  With ``mesh`` the
    operand is the rank's slab and every norm and inner product is the
    whole grid's.
    """
    shape = x0.shape
    xf = x0.reshape(-1)
    n = xf.shape[0]
    Ff = residual_fn(x0).reshape(-1)
    r0 = float(_reduced(x0.new_zeros((0, 0)), x0.new_zeros(0), [Ff],
                        mesh)[2][0])
    target = max(atol, rtol * r0)
    history = [r0]
    if r0 <= atol:
        return NonlinearResult(x0, 0, r0, True, history)

    Xs = x0.new_zeros((m + 1, n))
    Fs = x0.new_zeros((m + 1, n))
    mask = x0.new_zeros(m + 1)
    # The first window holds one entry: its Gram products are zeros on
    # every rank.
    Xs, Fs, mask = _push_window(Xs, Fs, mask, xf, Ff)
    gram = _gram(Xs, Fs, mask)

    for it in range(1, maxit + 1):
        xk = Xs[-1]
        x_new = _mix(Xs, Fs, mask, damping, gram)

        xf = x_new
        Ff = residual_fn(xf.reshape(shape)).reshape(-1)
        Xs, Fs, mask = _push_window(Xs, Fs, mask, xf, Ff)
        dF, dX, G, g = _gram(Xs, Fs, mask)
        G, g, norms = _reduced(G, g, [Ff, x_new - xk, x_new], mesh)
        gram = (dF, dX, G, g)

        # One host read per iteration: [residual, step, solution] norms.
        rnorm, step, xnorm = norms.tolist()
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
