"""The Chebyshev preconditioner apply: the ``cheb_step`` CUDA kernel and
its plain PyTorch twin (counterpart of ``xpic_tpu/ops/pallas_stencil.py``).

x ~ (matM + shift I)^{-1} rhs with matM = 2I + beta curl- curl+,
beta = dt^2/2, by a degree-``degree`` Chebyshev semi-iteration over the
Gershgorin bounds [2 + shift, 2 + shift + beta * lam_cc].  ``shift`` is a
0-d tensor on the field's device (the mean mass-matrix diagonal); the
scalar recurrence never leaves the device, so an apply costs no host
synchronisation.

The TPU kernel runs the whole recurrence in one dispatch with the field
resident in on-chip memory.  The CUDA kernel also runs an apply in one
launch: a cooperative grid as large as the card holds at once sweeps the
field once an iteration, with a grid-wide barrier between iterations and
the field in L2 (``csrc/cheb_step.cu``), in float32 (``cheb_step``) or
float64 (``cheb_step_f64``).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import PERIODIC, Geometry
from . import stencil


def _curls(geom: Geometry):
    """curl+ and curl- as the kernels compute them: differences times the
    inverse cell step (``ops/stencil`` divides by the step instead)."""
    ix, iy, iz = 1.0 / geom.dx, 1.0 / geom.dy, 1.0 / geom.dz

    def sh(c, axis, by):
        return stencil.shift(c, "xyz"[axis], by, geom.bounds[axis])

    def curlp(F):
        Fx, Fy, Fz = F
        return (
            (sh(Fz, 1, +1) - Fz) * iy - (sh(Fy, 2, +1) - Fy) * iz,
            (sh(Fx, 2, +1) - Fx) * iz - (sh(Fz, 0, +1) - Fz) * ix,
            (sh(Fy, 0, +1) - Fy) * ix - (sh(Fx, 1, +1) - Fx) * iy,
        )

    def curlm(F):
        Fx, Fy, Fz = F
        return (
            (Fz - sh(Fz, 1, -1)) * iy - (Fy - sh(Fy, 2, -1)) * iz,
            (Fx - sh(Fx, 2, -1)) * iz - (Fz - sh(Fz, 0, -1)) * ix,
            (Fy - sh(Fy, 0, -1)) * ix - (Fx - sh(Fx, 1, -1)) * iy,
        )

    return curlp, curlm


def _beta_lam(geom: Geometry, dt: float):
    beta = 0.5 * dt * dt
    lam_cc = 4.0 * (1.0 / geom.dx**2 + 1.0 / geom.dy**2 + 1.0 / geom.dz**2)
    return beta, beta * lam_cc


def _as_shift(shift, rhs):
    return torch.as_tensor(shift, dtype=rhs.dtype, device=rhs.device)


def cheb_matM_inv_plain(rhs, shift, *, geom: Geometry, degree: int,
                        dt: float):
    """The exact recurrence of the TPU kernel ``_cheb_kernel`` in plain
    PyTorch, in the dtype of ``rhs`` [3, nz, ny, nx]."""
    curlp, curlm = _curls(geom)
    beta, beta_lam = _beta_lam(geom, dt)
    a = 2.0 + _as_shift(shift, rhs)
    b = a + beta_lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    x = [torch.zeros_like(rhs[c]) for c in range(3)]
    r = [rhs[c] for c in range(3)]
    inv_theta = 1.0 / theta
    d = [rhs[c] * inv_theta for c in range(3)]
    rho = 1.0 / sigma1
    for _ in range(degree):
        x = [x[c] + d[c] for c in range(3)]
        cc = curlm(curlp(d))
        r = [r[c] - (a * d[c] + beta * cc[c]) for c in range(3)]
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        cd = rho_new * rho
        cr = 2.0 * rho_new / delta
        d = [cd * d[c] + cr * r[c] for c in range(3)]
        rho = rho_new
    return torch.stack(x)


def cheb_matM_inv(rhs, shift, *, geom: Geometry, degree: int, dt: float):
    """The preconditioner apply: one launch of the ``cheb_step`` kernel
    for a CUDA float32 field (``cheb_step_f64`` for float64), the plain
    twin for a CPU field; raises otherwise."""
    if rhs.device.type == "cpu":
        return cheb_matM_inv_plain(rhs, shift, geom=geom, degree=degree,
                                   dt=dt)
    if rhs.device.type != "cuda":
        raise RuntimeError(f"cheb_matM_inv: unsupported device {rhs.device}")
    name = kernels.entry("cheb_step", rhs)
    kernels.check_operand("cheb_step rhs", rhs,
                          (3, geom.nz, geom.ny, geom.nx), rhs.dtype)
    if degree < 1:
        raise ValueError("cheb_step: degree must be >= 1")
    s = _as_shift(shift, rhs)
    if s.numel() != 1:
        raise ValueError("cheb_step: shift must be one value")
    beta, beta_lam = _beta_lam(geom, dt)
    per = [int(b == PERIODIC) for b in geom.bounds]
    x = torch.empty_like(rhs)
    r, d0, d1 = torch.empty((3,) + tuple(rhs.shape), dtype=rhs.dtype,
                            device=rhs.device)
    kernels.call(
        name, rhs.data_ptr(), s.data_ptr(), x.data_ptr(),
        r.data_ptr(), d0.data_ptr(), d1.data_ptr(),
        geom.nx, geom.ny, geom.nz, per[0], per[1], per[2],
        1.0 / geom.dx, 1.0 / geom.dy, 1.0 / geom.dz, beta, beta_lam, degree,
        device=rhs.device)
    return x
