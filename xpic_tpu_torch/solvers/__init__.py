"""Krylov solvers and the Chebyshev preconditioner."""

from .krylov import KrylovResult, cg, gmres

__all__ = ["KrylovResult", "cg", "gmres"]
