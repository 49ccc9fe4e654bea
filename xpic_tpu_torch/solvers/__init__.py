"""Krylov solvers, the Anderson nonlinear solver and the Chebyshev
preconditioner."""

from .anderson import NonlinearResult, anderson_solve
from .krylov import KrylovResult, cg, gmres

__all__ = ["KrylovResult", "NonlinearResult", "anderson_solve", "cg",
           "gmres"]
