"""Chebyshev polynomial preconditioner for the ECSIM field operator
(counterpart of ``xpic_tpu/solvers/spectral.py``, the Chebyshev branch).

matM = (2 + c) I + beta curl- curl+ (beta = dt^2/2, c the mean matL
diagonal) is SPD with a spectrum inside the Gershgorin bounds
[2 + c, 2 + c + 4 beta (1/dx^2 + 1/dy^2 + 1/dz^2)].  A degree-12
Chebyshev semi-iteration approximates matM^{-1} with 12 curl-curl
applications; on the card the whole apply is one launch of the
``cheb_step`` kernel (``ops/stencil_kernel.py``).
"""

from __future__ import annotations

from ..config import Geometry
from ..ops.stencil_kernel import _beta_lam, cheb_matM_inv

CHEB_DEGREE = 12


def matM_bounds(geom: Geometry, dt: float, shift=0.0):
    """The Gershgorin interval (a, b) of matM + shift I."""
    a = 2.0 + shift
    return a, a + _beta_lam(geom, dt)[1]


def make_matM_preconditioner(geom: Geometry, dt: float,
                             degree: int = CHEB_DEGREE):
    """Return P_inv(rhs, shift) ~ (matM + shift I)^{-1} rhs."""

    def P_inv(rhs, shift=0.0):
        return cheb_matM_inv(rhs, shift, geom=geom, degree=degree, dt=dt)

    return P_inv
