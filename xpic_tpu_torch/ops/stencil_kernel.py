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

On a z slab of a multi-rank run (``geom.mesh``) an apply is one sweep a
launch (``cheb_sweep``, ``cheb_sweep_f64``: the slab form), with the
boundary planes of d exchanged with the neighbour ranks between sweeps:
12 launches and 11 exchanges at degree 12.  Its twin
(:func:`cheb_matM_inv_slab_plain`) runs the same recurrence on padded
slabs.  Both give the whole grid's values.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..config import PERIODIC, Geometry
from . import stencil
from ..parallel.mesh import mesh_of


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


def _padded_geom(geom: Geometry) -> Geometry:
    """The slab with one ghost plane a side, as a grid of its own."""
    return dataclasses.replace(geom, nz=geom.nz + 2, z0=0, nz_global=0,
                               mesh=None)


def _fill_ghosts(d, mesh) -> None:
    """Exchange the boundary planes of the padded slab ``d``
    [3, nz + 2, ny, nx] into its ghost planes (zeros where there is no
    neighbour)."""
    n = d.shape[1] - 2
    from_dn, from_up = mesh.exchange(d[:, n], d[:, 1], "cheb_ghosts")
    d[:, 0] = 0.0 if from_dn is None else from_dn
    d[:, n + 1] = 0.0 if from_up is None else from_up


def cheb_matM_inv_slab_plain(rhs, shift, *, geom: Geometry, degree: int,
                             dt: float):
    """:func:`cheb_matM_inv_plain` on a z slab: each sweep's curl-curl on
    d padded with one ghost plane a side (11 exchanges at degree 12: the
    last sweep reads no neighbour).  The curl+ of a ghost plane beyond a
    non-periodic global bound is zero, as the whole grid's zero fill."""
    mesh = mesh_of(geom)
    pg = _padded_geom(geom)
    curlp, curlm = _curls(pg)
    beta, beta_lam = _beta_lam(geom, dt)
    a = 2.0 + _as_shift(shift, rhs)
    b = a + beta_lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    n = geom.nz
    x = [torch.zeros_like(rhs[c]) for c in range(3)]
    r = [rhs[c] for c in range(3)]
    inv_theta = 1.0 / theta
    d = [rhs[c] * inv_theta for c in range(3)]
    rho = 1.0 / sigma1
    for k in range(degree):
        x = [x[c] + d[c] for c in range(3)]
        if k == degree - 1:
            break
        dp = torch.zeros((3, n + 2) + tuple(rhs.shape[2:]), dtype=rhs.dtype,
                         device=rhs.device)
        dp[:, 1:n + 1] = torch.stack(d)
        _fill_ghosts(dp, mesh)
        cp = curlp(tuple(dp))
        if mesh.dn is None:
            cp = tuple(torch.cat([torch.zeros_like(c[:1]), c[1:]])
                       for c in cp)
        cc = [c[1:n + 1] for c in curlm(cp)]
        r = [r[c] - (a * d[c] + beta * cc[c]) for c in range(3)]
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        cd = rho_new * rho
        cr = 2.0 * rho_new / delta
        d = [cd * d[c] + cr * r[c] for c in range(3)]
        rho = rho_new
    return torch.stack(x)


def cheb_matM_inv_slab(rhs, shift, *, geom: Geometry, degree: int,
                       dt: float):
    """The slab form of the apply: ``degree`` launches of the
    ``cheb_sweep`` kernel (``cheb_sweep_f64`` for float64) with the ghost
    planes exchanged between them, for a CUDA field; the slab twin for a
    CPU field; raises otherwise."""
    if rhs.device.type == "cpu":
        return cheb_matM_inv_slab_plain(rhs, shift, geom=geom,
                                        degree=degree, dt=dt)
    if rhs.device.type != "cuda":
        raise RuntimeError(f"cheb_sweep: unsupported device {rhs.device}")
    name = kernels.entry("cheb_sweep", rhs)
    kernels.check_operand("cheb_sweep rhs", rhs,
                          (3, geom.nz, geom.ny, geom.nx), rhs.dtype)
    if degree < 1:
        raise ValueError("cheb_sweep: degree must be >= 1")
    s = _as_shift(shift, rhs)
    if s.numel() != 1:
        raise ValueError("cheb_sweep: shift must be one value")
    mesh = mesh_of(geom)
    beta, beta_lam = _beta_lam(geom, dt)
    per = [int(b == PERIODIC) for b in geom.bounds]
    n = geom.nz
    pad = (3, n + 2, geom.ny, geom.nx)
    rhs_p = torch.zeros(pad, dtype=rhs.dtype, device=rhs.device)
    rhs_p[:, 1:n + 1] = rhs
    _fill_ghosts(rhs_p, mesh)
    d = [torch.zeros(pad, dtype=rhs.dtype, device=rhs.device)
         for _ in range(2)]
    x = torch.empty_like(rhs)
    r = torch.empty_like(rhs)
    for k in range(degree):
        d_in, d_out = d[k & 1], d[1 - (k & 1)]
        if 0 < k < degree - 1:
            _fill_ghosts(d_in, mesh)
        kernels.call(
            name, rhs_p.data_ptr(), s.data_ptr(), x.data_ptr(),
            r.data_ptr(), d_in.data_ptr(), d_out.data_ptr(),
            geom.nx, geom.ny, n, per[0], per[1], int(mesh.dn is not None),
            int(mesh.up is not None), 1.0 / geom.dx, 1.0 / geom.dy,
            1.0 / geom.dz, beta, beta_lam, k, degree, device=rhs.device)
    return x


def cheb_matM_inv(rhs, shift, *, geom: Geometry, degree: int, dt: float):
    """The preconditioner apply: one launch of the ``cheb_step`` kernel
    for a CUDA float32 field (``cheb_step_f64`` for float64), the plain
    twin for a CPU field; raises otherwise.  On a z slab: the slab form
    (:func:`cheb_matM_inv_slab`)."""
    if mesh_of(geom) is not None:
        return cheb_matM_inv_slab(rhs, shift, geom=geom, degree=degree,
                                  dt=dt)
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
