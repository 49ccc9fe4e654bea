"""Restarted GMRES and CG over field tensors
(counterpart of ``xpic_tpu/solvers/krylov.py``).

The JAX package runs these as fixed-trip-count ``lax.while_loop``s; here
they are Python loops.  The big vectors stay on the operand's device;
the small Hessenberg column (at most restart + 1 numbers) comes to the
host once per iteration, where the Givens rotations, the convergence test
and the back substitution run in numpy in the operand's dtype.  That is
the one device synchronisation per Krylov iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class KrylovResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool


def _dot(a, b, mesh=None):
    d = torch.sum(a * b)
    return d if mesh is None else mesh.allreduce_sum(d)


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def cg(matvec: Callable, b, x0=None, *, rtol: float = 1e-7,
       atol: float = 1e-7, maxit: int = 100, M_inv: Callable | None = None,
       mesh=None) -> KrylovResult:
    """(Preconditioned) conjugate gradient for SPD operators; converges
    on the true residual 2-norm."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M_inv is None:
        M_inv = lambda v: v  # noqa: E731
    nd = _np_dtype(b)
    r = b - matvec(x)
    z = M_inv(r)
    p = z
    rz = _dot(r, z, mesh)
    target = max(nd(rtol) * nd(torch.sqrt(_dot(b, b, mesh)).item()), nd(atol))
    rnorm = nd(torch.sqrt(_dot(r, r, mesh)).item())
    it = 0
    while rnorm > target and it < maxit:
        Ap = matvec(p)
        alpha = rz / _dot(p, Ap, mesh)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _dot(r, z, mesh)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        rnorm = nd(torch.sqrt(_dot(r, r, mesh)).item())
    return KrylovResult(x, it, float(rnorm), bool(rnorm <= target))


def _gmres_cycle(matvec, b, x0, m, target, nd, mesh=None):
    """One GMRES(m) cycle with CGS2 orthogonalisation and Givens QR;
    returns (x, rnorm, j)."""
    tiny = nd(np.finfo(nd).tiny * 1e4)

    def proj(Vj, w):
        h = Vj @ w
        return h if mesh is None else mesh.allreduce_sum(h)

    r0 = b - matvec(x0)
    beta_t = torch.sqrt(_dot(r0, r0, mesh))
    beta = nd(beta_t.item())

    V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype,
                    device=b.device)
    V[0] = r0 / torch.clamp(beta_t, min=float(tiny))
    R = np.zeros((m, m), nd)
    g = np.zeros(m + 1, nd)
    g[0] = beta
    cs = np.zeros(m, nd)
    sn = np.zeros(m, nd)
    n = b.numel()

    j, rnorm = 0, beta
    while j < m and rnorm > target:
        w = matvec(V[j]).reshape(n)
        Vj = V[: j + 1].reshape(j + 1, n)
        # Re-orthogonalised classical Gram-Schmidt against V[0..j].
        h1 = proj(Vj, w)
        w = w - h1 @ Vj
        h2 = proj(Vj, w)
        w = w - h2 @ Vj
        hnorm_t = torch.sqrt(_dot(w, w, mesh))
        V[j + 1] = (w / torch.clamp(hnorm_t, min=float(tiny))).reshape(
            b.shape)
        col = torch.cat([h1 + h2, hnorm_t[None]]).cpu().numpy().astype(nd)
        h = np.zeros(m + 1, nd)
        h[: j + 2] = col

        for i in range(j):
            hi = cs[i] * h[i] + sn[i] * h[i + 1]
            hip = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i], h[i + 1] = hi, hip

        denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
        safe = max(denom, tiny)
        c = h[j] / safe if denom > tiny else nd(1.0)
        s = h[j + 1] / safe if denom > tiny else nd(0.0)
        cs[j], sn[j] = c, s
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = 0.0

        R[:, j] = h[:m]
        gj = g[j]
        g[j] = c * gj
        g[j + 1] = -s * gj
        rnorm = abs(g[j + 1])
        j += 1

    y = np.zeros(m, nd)
    for i in range(m - 1, -1, -1):
        if i < j:
            diag = R[i, i] if abs(R[i, i]) > tiny else nd(1.0)
            y[i] = (g[i] - R[i] @ y) / diag
    if j:
        yt = torch.as_tensor(y[:j], dtype=b.dtype, device=b.device)
        x = x0 + (yt @ V[:j].reshape(j, n)).reshape(b.shape)
    else:
        x = x0
    return x, rnorm, j


def gmres(matvec: Callable, b, x0=None, *, rtol: float = 1e-7,
          atol: float = 1e-7, maxit: int = 100, restart: int = 30,
          M_inv: Callable | None = None, mesh=None) -> KrylovResult:
    """Restarted GMRES.  ``maxit`` counts total inner iterations.  With
    ``M_inv`` the solve is left-preconditioned and converges on the
    preconditioned residual norm (PETSc's defaults)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if M_inv is not None:
        inner = lambda v: M_inv(matvec(v))  # noqa: E731
        b_eff = M_inv(b)
    else:
        inner = matvec
        b_eff = b
    nd = _np_dtype(b)
    bnorm = nd(torch.sqrt(_dot(b_eff, b_eff, mesh)).item())
    target = max(nd(rtol) * bnorm, nd(atol))

    r0 = b_eff - inner(x)
    rnorm = nd(torch.sqrt(_dot(r0, r0, mesh)).item())
    it = 0
    while rnorm > target and it < maxit:
        x, rnorm, j = _gmres_cycle(inner, b_eff, x, restart, target, nd,
                                   mesh)
        it += j
    return KrylovResult(x, it, float(rnorm), bool(rnorm <= target))
