"""Yee-lattice differential operators as shifted-tensor stencils
(counterpart of ``xpic_tpu/ops/stencil.py``).

Field tensors are ``[3, nz, ny, nx]`` with components (x, y, z) leading
and x fastest-varying.  Positive (forward) shifts form ``rotE`` on the
edge-centered electric field; negative (backward) shifts form ``rotB``
on the face-centered magnetic field.
"""

from __future__ import annotations

import torch

from ..config import PERIODIC


def shift(f: torch.Tensor, axis: str, by: int, bound: str = PERIODIC
          ) -> torch.Tensor:
    """Return ``f`` shifted so that result[i] = f[i + by] along ``axis``.

    ``f``'s trailing axes are (z, y, x).  Periodic boundaries wrap; other
    boundary kinds read zeros outside the domain.
    """
    ax = f.ndim - 1 - "xyz".index(axis)
    if by == 0:
        return f
    if bound == PERIODIC:
        return torch.roll(f, -by, dims=ax)
    n = f.shape[ax]
    out = torch.zeros_like(f)
    if abs(by) >= n:
        return out
    if by > 0:
        out.narrow(ax, 0, n - by).copy_(f.narrow(ax, by, n - by))
    else:
        out.narrow(ax, -by, n + by).copy_(f.narrow(ax, 0, n + by))
    return out


def _d_plus(f, axis, step, bounds):
    b = bounds["xyz".index(axis)]
    return (shift(f, axis, +1, b) - f) / step


def _d_minus(f, axis, step, bounds):
    b = bounds["xyz".index(axis)]
    return (f - shift(f, axis, -1, b)) / step


def curl_positive(F, steps, bounds=(PERIODIC,) * 3):
    """Forward-difference curl (rotE): edge-centered -> face-centered."""
    dx, dy, dz = steps
    Fx, Fy, Fz = F[0], F[1], F[2]
    cx = _d_plus(Fz, "y", dy, bounds) - _d_plus(Fy, "z", dz, bounds)
    cy = _d_plus(Fx, "z", dz, bounds) - _d_plus(Fz, "x", dx, bounds)
    cz = _d_plus(Fy, "x", dx, bounds) - _d_plus(Fx, "y", dy, bounds)
    return torch.stack([cx, cy, cz])


def curl_negative(F, steps, bounds=(PERIODIC,) * 3):
    """Backward-difference curl (rotB): face-centered -> edge-centered."""
    dx, dy, dz = steps
    Fx, Fy, Fz = F[0], F[1], F[2]
    cx = _d_minus(Fz, "y", dy, bounds) - _d_minus(Fy, "z", dz, bounds)
    cy = _d_minus(Fx, "z", dz, bounds) - _d_minus(Fz, "x", dx, bounds)
    cz = _d_minus(Fy, "x", dx, bounds) - _d_minus(Fx, "y", dy, bounds)
    return torch.stack([cx, cy, cz])


def divergence_negative(F, steps, bounds=(PERIODIC,) * 3):
    """Backward-difference divergence: edge-centered field -> node scalar."""
    dx, dy, dz = steps
    return (
        _d_minus(F[0], "x", dx, bounds)
        + _d_minus(F[1], "y", dy, bounds)
        + _d_minus(F[2], "z", dz, bounds)
    )


def divergence_positive(F, steps, bounds=(PERIODIC,) * 3):
    dx, dy, dz = steps
    return (
        _d_plus(F[0], "x", dx, bounds)
        + _d_plus(F[1], "y", dy, bounds)
        + _d_plus(F[2], "z", dz, bounds)
    )


def gradient_positive(f, steps, bounds=(PERIODIC,) * 3):
    """Forward-difference gradient: node scalar -> edge-centered field."""
    dx, dy, dz = steps
    return torch.stack([
        _d_plus(f, "x", dx, bounds),
        _d_plus(f, "y", dy, bounds),
        _d_plus(f, "z", dz, bounds),
    ])


def gradient_negative(f, steps, bounds=(PERIODIC,) * 3):
    dx, dy, dz = steps
    return torch.stack([
        _d_minus(f, "x", dx, bounds),
        _d_minus(f, "y", dy, bounds),
        _d_minus(f, "z", dz, bounds),
    ])
