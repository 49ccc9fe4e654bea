"""Particle pushers (counterpart of ``xpic_tpu/pushers.py``): the Boris
magnetic rotation variants M/B/C1/C2 and the electromagnetic ``vEB``
update (reference: src/algorithms/boris_push.cpp:19-91), the implicit
Crank-Nicolson push and the drift-kinetic guiding-center push.  ``p`` is
velocity in units of c (non-relativistic)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _normalized(v, eps=1e-300):
    return v / torch.clamp(_norm(v), min=eps)


def update_r(dt, r, p):
    """r += p * dt (reference: BorisPush::update_r, boris_push.cpp:20-23)."""
    return r + p * dt


def _rotate(v, B, sin_t, cos_t):
    """v -> v_par + cos*v_perp + sin*(b x v_perp) around unit b = B/|B|
    (boris_push.cpp:85-91)."""
    b = _normalized(B)
    v_par = torch.sum(v * b, dim=-1, keepdim=True) * b
    v_t = v - v_par
    return v_par + cos_t * v_t + sin_t * torch.linalg.cross(b, v_t)


def _theta(dt, qm, B):
    """theta = -qm * |B| * dt (boris_push.cpp:60-63)."""
    return -qm * _norm(B) * dt


def update_vM(dt, qm, p, B):
    """Exact-rotation variant (theta = -qm |B| dt), with (sin, cos)
    renormalized so that the rotation stays orthogonal to rounding, as
    in the JAX package."""
    t = _theta(dt, qm, B)
    s, c = torch.sin(t), torch.cos(t)
    renorm = 1.0 / torch.sqrt(s * s + c * c)
    return _rotate(p, B, s * renorm, c * renorm)


def update_vB(dt, qm, p, B):
    """Classic Boris half-angle tangent variant (boris_push.cpp:65-70)."""
    t = _theta(dt, qm, B)
    d = 1.0 + 0.25 * t * t
    return _rotate(p, B, t / d, (1.0 - 0.25 * t * t) / d)


def update_vC1(dt, qm, p, B):
    """Chin C1 variant (boris_push.cpp:72-76)."""
    t = _theta(dt, qm, B)
    return _rotate(p, B, t * torch.sqrt(1.0 - 0.25 * t * t),
                   1.0 - 0.5 * t * t)


def update_vC2(dt, qm, p, B):
    """Chin C2 variant (boris_push.cpp:78-82)."""
    t = _theta(dt, qm, B)
    return _rotate(p, B, t, torch.sqrt(1.0 - t * t))


def update_vEB(dt, qm, p, E, B):
    """Electromagnetic Boris update:
    w = v + a/2;  v += a + (b x w + 0.5 b x (b x w)) / (1 + b^2/4)
    with a = dt*qm*E, b = -dt*qm*B."""
    alpha = dt * qm
    a = alpha * E
    b = -alpha * B
    w = p + 0.5 * a
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    bxw = torch.linalg.cross(b, w)
    return p + a + (bxw + 0.5 * torch.linalg.cross(b, bxw)) / (1.0 + 0.25 * b2)


BORIS_VARIANTS = {
    "M": update_vM,
    "B": update_vB,
    "C1": update_vC1,
    "C2": update_vC2,
}


@dataclasses.dataclass
class CNResult:
    r: torch.Tensor
    p: torch.Tensor
    iterations: torch.Tensor  # [N] int
    residual: torch.Tensor  # [N] final residual norm
    converged: torch.Tensor  # [N] bool


def crank_nicolson_push(dt: float, qm: float, r0, p0,
                        fields_fn: Callable, atol: float = 1e-7,
                        rtol: float = 1e-7, maxit: int = 30) -> CNResult:
    """Batched implicit Crank-Nicolson particle move.

    ``fields_fn(rn, r0) -> (E_p, B_p)`` evaluates fields along the path
    (the reference's SetFields callback, crank_nicolson_push.h:23-26).
    The Picard loop (crank_nicolson_push.cpp:51-67) solves

        v_h = (w + w x b + b (w . b)) / (1 + b^2),  w = p0 + a,
        a = (dt/2) qm E_p,  b = (dt/2) qm B_p,
        rn = r0 + dt v_h,  pn = 2 v_h - p0,

    until |(pn - p0) - dt qm (E_p + v_h x B_p)| < atol + rtol*r0, every
    particle under a convergence mask; the loop's exit test is one host
    read per iteration.  Divergence is reported in ``converged``, not
    raised (the reference aborts, crank_nicolson_push.cpp:69-70).
    """
    vh0 = p0  # pn initialized to p0 => vh = p0
    rn = r0 + dt * vh0
    E, B = fields_fn(rn, r0)

    def residue(pn, vh, E, B):
        return torch.linalg.norm(
            (pn - p0) - dt * qm * (E + torch.linalg.cross(vh, B)), dim=-1)

    res = residue(p0, vh0, E, B)
    target = atol + rtol * res
    alpha = 0.5 * dt * qm
    it = torch.zeros(r0.shape[0], dtype=torch.int32, device=r0.device)
    pn = p0
    active = res >= target
    while bool(torch.any(active)) and int(it.max()) < maxit:
        a = alpha * E
        b = alpha * B
        w = p0 + a
        b2 = torch.sum(b * b, dim=-1, keepdim=True)
        vh = (w + torch.linalg.cross(w, b)
              + b * torch.sum(w * b, dim=-1, keepdim=True)) / (1.0 + b2)
        # Only still-active lanes move.
        m = active[:, None]
        rn = torch.where(m, r0 + dt * vh, rn)
        pn = torch.where(m, 2.0 * vh - p0, pn)
        res = torch.where(active, residue(pn, vh, E, B), res)
        still = active & ~(res < target)
        E_new, B_new = fields_fn(rn, r0)
        E = torch.where(still[:, None], E_new, E)
        B = torch.where(still[:, None], B_new, B)
        it = it + active.to(torch.int32)
        active = still
    return CNResult(r=rn, p=pn, iterations=it, residual=res,
                    converged=~active)


@dataclasses.dataclass
class DKResult:
    r: torch.Tensor
    p_parallel: torch.Tensor
    p_perp: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def drift_kinetic_push(dt: float, qm: float, mp: float, r0, p_par0,
                       p_perp0, mu0, fields_fn: Callable,
                       eps: float = 1e-12, delta: float = 1e-12,
                       maxit: int = 30) -> DKResult:
    """Batched implicit guiding-center push
    (reference: src/algorithms/drift_kinetic_push.cpp:48-160).

    ``fields_fn(r0, rn) -> (Eh, Bp, gradBp)`` returns the electric field
    averaged over the segment and B with its gradient at the new point.
    Drift velocity (drift_kinetic_push.cpp:111-119):

        Vd = (Eh x h)/Bh + (1/qm) (Vh^2/Bh + mu/mp) h x (gradBh/Bh)

    with h the averaged unit-B direction; the update conserves the
    magnetic moment mu through |p_perp| ~ sqrt(|B|).
    """
    n = r0.shape[0]
    Eh, Bp, gradBp = fields_fn(r0, r0)
    B0v, gradB0 = Bp, gradBp
    b0 = _normalized(Bp)
    zero = torch.zeros((), dtype=r0.dtype, device=r0.device)

    def get_vd(Vh, h, Bh_len, gradBh, Eh):
        small = Bh_len[:, 0] < 1e-12
        Bh_safe = torch.clamp(Bh_len, min=1e-300)
        vd = torch.linalg.cross(Eh, h) / Bh_safe + (1.0 / qm) * (
            (Vh * Vh)[:, None] / Bh_safe + (mu0 / mp)[:, None]
        ) * torch.linalg.cross(h, gradBh / Bh_safe)
        return torch.where(small[:, None], zero, vd)

    def vpar_terms(Vh, Vd, Eh, Bp_len, B0_len):
        safe = torch.abs(Vh) >= 1e-12
        Vs = torch.where(safe, Vh, torch.ones_like(Vh))
        term = torch.where(safe, torch.sum(Eh * Vd, dim=-1) / Vs, zero)
        dB = Bp_len[:, 0] - B0_len[:, 0]
        mu_term = torch.where(safe, (mu0 / mp) * dB / Vs, zero)
        return term, mu_term

    it = 0
    rn, ppar, pperp = r0, p_par0, p_perp0
    h, Bh, gradBh = b0, Bp, gradBp
    active = torch.ones(n, dtype=torch.bool, device=r0.device)
    conv = torch.zeros_like(active)
    while bool(torch.any(active)) and it < maxit:
        Vh = 0.5 * (ppar + p_par0)
        Vd = get_vd(Vh, h, _norm(Bh), gradBh, Eh)

        # Residuals (drift_kinetic_push.cpp:139-160)
        R1 = torch.linalg.norm(rn - r0 - dt * (Vh[:, None] * h + Vd), dim=-1)
        term, mu_term = vpar_terms(Vh, Vd, Eh, _norm(Bp), _norm(B0v))
        R2 = torch.abs((ppar - p_par0)
                       - dt * qm * (torch.sum(Eh * h, dim=-1) + term)
                       + mu_term)
        done = (R1 < eps) & (R2 < delta) & (it > 0)
        conv = conv | (active & done)
        still = active & ~done

        m = still[:, None]
        rn = torch.where(m, r0 + dt * (Vh[:, None] * h + Vd), rn)

        Eh_n, Bp_n, gradBp_n = fields_fn(r0, rn)
        Eh = torch.where(m, Eh_n, Eh)
        Bp = torch.where(m, Bp_n, Bp)
        gradBp = torch.where(m, gradBp_n, gradBp)
        Bh = 0.5 * (Bp + B0v)
        gradBh = 0.5 * (gradBp + gradB0)
        h = 0.5 * (_normalized(Bp) + b0)

        pperp_new = p_perp0 * torch.sqrt(_norm(Bp)[:, 0] / _norm(B0v)[:, 0])
        term, mu_term = vpar_terms(Vh, Vd, Eh, _norm(Bp), _norm(B0v))
        ppar_new = (p_par0 + dt * qm * (torch.sum(Eh * h, dim=-1) + term)
                    - mu_term)
        pperp = torch.where(still, pperp_new, pperp)
        ppar = torch.where(still, ppar_new, ppar)
        it += 1
        active = still
    return DKResult(
        r=rn, p_parallel=ppar, p_perp=pperp,
        iterations=torch.full((n,), it, dtype=torch.int32, device=r0.device),
        converged=conv | ~active)
