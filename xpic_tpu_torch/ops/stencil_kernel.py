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

On a z slab of t planes in a multi-rank run (``geom.mesh``) an apply runs
on the slab padded with g ghost planes a side (where a neighbour rank
exists), z zero-filled at the padded edges: sweep k reads d one plane up
and down, so g exchanged planes carry g sweeps, and the planes the zero
fill spoils never reach the own planes.  An apply is e segments
(:func:`slab_schedule`: e = ceil((degree - 1) / min(degree - 1, t)),
g = ceil((degree - 1) / e)), each one exchange (rhs's planes before the
first, d's and r's before the others) and one cooperative launch
(``cheb_sweep``, ``cheb_sweep_f64``: the slab form); at degree 12 and
t >= 11, one exchange and one launch.  Its twin
(:func:`cheb_matM_inv_slab_plain`) runs the same schedule.  Both give the
whole grid's bits on the own planes.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..config import GHOSTED, PERIODIC, Geometry
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


def slab_schedule(degree: int, t: int):
    """The slab apply's ghost depth g and its segments ``(k0, count)``:
    sweeps k0 .. k0 + count - 1 after one exchange each.  The
    degree - 1 sweeps that read a neighbour plane go in
    e = ceil((degree - 1) / min(degree - 1, t)) runs of at most g, the
    last (x += d) with the last run; degree 1 reads none (g = 0)."""
    need = degree - 1
    if need < 1:
        return 0, [(0, degree)]
    e = -(-need // min(need, t))
    g = -(-need // e)
    segs = [(k0, min(g, need - k0)) for k0 in range(0, need, g)]
    segs[-1] = (segs[-1][0], segs[-1][1] + 1)
    return g, segs


def _depths(mesh, g: int):
    """Ghost planes below and above: g where a neighbour rank exists."""
    lo = g if mesh.dn is not None else 0
    hi = g if mesh.up is not None else 0
    return lo, hi


def _padded_geom(geom: Geometry, planes: int) -> Geometry:
    """The padded slab as a grid of its own, z zero-filled at its edges."""
    bounds = (geom.bounds[0], geom.bounds[1], GHOSTED)
    return dataclasses.replace(geom, nz=planes, z0=0, nz_global=0,
                               mesh=None, bounds=bounds)


def _exchange_ghosts(mesh, fields, lo: int, hi: int, g: int) -> None:
    """One exchange of the padded slabs ``fields`` [3, lo + t + hi, ny,
    nx]: each one's g own boundary planes to the neighbour ranks, theirs
    into its ghost planes."""
    n = fields[0].shape[1] - lo - hi
    to_up = torch.stack([f[:, lo + n - g:lo + n] for f in fields])
    to_dn = torch.stack([f[:, lo:lo + g] for f in fields])
    from_dn, from_up = mesh.exchange(to_up, to_dn, "cheb_ghosts")
    for i, f in enumerate(fields):
        if lo:
            f[:, :lo] = from_dn[i]
        if hi:
            f[:, lo + n:] = from_up[i]


def _pad(rhs, lo: int, hi: int):
    """``rhs`` [3, t, ny, nx] as the own planes of a padded slab; its
    ghost planes are the exchange's to fill."""
    n = rhs.shape[1]
    out = rhs.new_empty((3, lo + n + hi) + tuple(rhs.shape[2:]))
    out[:, lo:lo + n] = rhs
    return out


def cheb_matM_inv_slab_plain(rhs, shift, *, geom: Geometry, degree: int,
                             dt: float):
    """:func:`cheb_matM_inv_plain` on a z slab, on the kernel's schedule
    (:func:`slab_schedule`): the recurrence on the slab padded with g
    ghost planes a side and z zero-filled at the padded edges, rhs's
    ghost planes exchanged before the first segment, d's and r's before
    each later one; the own planes cropped at the end."""
    mesh = mesh_of(geom)
    n = geom.nz
    g, segs = slab_schedule(degree, n)
    lo, hi = _depths(mesh, g)
    curlp, curlm = _curls(_padded_geom(geom, lo + n + hi))
    beta, beta_lam = _beta_lam(geom, dt)
    a = 2.0 + _as_shift(shift, rhs)
    b = a + beta_lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma1 = theta / delta

    rhs_p = _pad(rhs, lo, hi)
    if g:
        _exchange_ghosts(mesh, [rhs_p], lo, hi, g)
    x = torch.zeros_like(rhs_p)
    r = rhs_p
    inv_theta = 1.0 / theta
    d = rhs_p * inv_theta
    rho = 1.0 / sigma1
    for i, (k0, count) in enumerate(segs):
        if i:
            _exchange_ghosts(mesh, [d, r], lo, hi, g)
        for k in range(k0, k0 + count):
            x = x + d
            if k == degree - 1:
                break
            cc = torch.stack(curlm(curlp(d)))
            r = r - (a * d + beta * cc)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            cd = rho_new * rho
            cr = 2.0 * rho_new / delta
            d = cd * d + cr * r
            rho = rho_new
    return x[:, lo:lo + n].contiguous()


def cheb_matM_inv_slab(rhs, shift, *, geom: Geometry, degree: int,
                       dt: float):
    """The slab form of the apply: per segment of :func:`slab_schedule`,
    one exchange and one launch of the ``cheb_sweep`` kernel
    (``cheb_sweep_f64`` for float64) on the ghost-padded slab, for a
    CUDA field; the slab twin for a CPU field; raises otherwise."""
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
    n = geom.nz
    g, segs = slab_schedule(degree, n)
    lo, hi = _depths(mesh, g)
    beta, beta_lam = _beta_lam(geom, dt)
    per = [int(b == PERIODIC) for b in geom.bounds]
    rhs_p = _pad(rhs, lo, hi)
    if g:
        _exchange_ghosts(mesh, [rhs_p], lo, hi, g)
    x, r, d0, d1 = torch.empty((4,) + tuple(rhs_p.shape), dtype=rhs.dtype,
                               device=rhs.device)
    for i, (k0, count) in enumerate(segs):
        if i:
            _exchange_ghosts(mesh, [(d1 if k0 & 1 else d0), r], lo, hi, g)
        kernels.call(
            name, rhs_p.data_ptr(), s.data_ptr(), x.data_ptr(),
            r.data_ptr(), d0.data_ptr(), d1.data_ptr(), geom.nx, geom.ny,
            lo + n + hi, per[0], per[1], 1.0 / geom.dx, 1.0 / geom.dy,
            1.0 / geom.dz, beta, beta_lam, k0, count, degree,
            device=rhs.device)
    return x[:, lo:lo + n].contiguous()


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
