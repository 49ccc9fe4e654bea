"""The ECSIM timestep over the persistent binned particle layout
(counterpart of ``xpic_tpu/parallel/step.py``, single device).

One step: drift, rebin (neighbor exchange), fill (B gather, implicit
current deposit, packed mass operands), advance (GMRES on
matA = 2I + dt^2/2 curl- curl+ + matL with matL matrix-free and the
Chebyshev preconditioner), push (slot gather of E and the Boris vEB
update), and the curl field update.

The port takes the JAX package's default routes only: the matrix-free
mass operator for every dtype (``tests/test_mass_free.py`` holds it equal
to the assembled one), the neighbor rebin for float32 and the global
sort otherwise, and Chebyshev of degree 12.
"""

from __future__ import annotations

import torch

from ..config import Geometry
from ..ops.binning import BinnedState, bin_state, drift_state, rebin, \
    unbin_state
from ..ops.gather_scatter import B_STAGGER, cell_t, gather_vector
from ..ops.mass_free import (
    deposit_vector_slots,
    gather_vector_slots,
    implicit_current,
    mass_apply,
    mass_operands,
    mass_trace,
)
from ..ops.stencil import curl_negative, curl_positive
from ..particles import ParticleArrays
from ..pushers import update_vEB
from ..solvers import gmres
from ..solvers.spectral import make_matM_preconditioner


def fill_phase(B, st: BinnedState, t, geom: Geometry, *, q, m, mpw):
    """currI deposit, the matrix-free mass contribution and B at the
    particles.  Returns ``(currI, (MassOp, trace), B_p)``."""
    dt = geom.dt
    B_p = gather_vector(B, t, st.valid, geom, order=1, width=3, anchor=-1,
                        stagger=B_STAGGER)
    I_p = implicit_current(B_p, st.p, st.valid, q=q, m=m, mpw=mpw, dt=dt)
    currI = deposit_vector_slots(I_p, t, geom)
    op = mass_operands(t, B_p, st.valid, q=q, m=m, mpw=mpw, dt=dt)
    return currI, (op, mass_trace(op)), B_p


def accumulate_mass(acc, mass):
    """Fold one species' ``(MassOp, trace)`` into
    ``((op, ...), trace_sum)``."""
    op, tr = mass
    if acc is None:
        return ((op,), tr)
    ops, tr_acc = acc
    return (ops + (op,), tr_acc + tr)


def advance_phase(E, B, B0, currI, mass, geom: Geometry, *, tol, maxit,
                  prev=None):
    """rhs = 2E - dt currI + dt curl-(B - B0); solve matA Ep = rhs.
    ``mass`` is ``((MassOp, ...), trace)``.  ``prev = (Ep_prev,
    rhs_prev)`` warm-starts the solve with the delta predictor
    x0 = Ep_prev + (rhs - rhs_prev)/2; without it x0 = rhs/2."""
    dt = geom.dt
    steps, bounds = geom.cell_steps, geom.bounds
    half_dt2 = 0.5 * dt * dt
    ops, trace = mass

    def matA(x):
        y = 2.0 * x + half_dt2 * curl_negative(
            curl_positive(x, steps, bounds), steps, bounds)
        return y + (mass_apply(x, ops, geom) if ops else torch.zeros_like(x))

    rhs = 2.0 * E - dt * currI + dt * curl_negative(B - B0, steps, bounds)
    P = make_matM_preconditioner(geom, dt)
    shift = trace / (3.0 * geom.n_cells)
    if prev is None:
        x0 = 0.5 * rhs
    else:
        Ep_p, rhs_p = prev
        x0 = Ep_p + 0.5 * (rhs - rhs_p)
    sol = gmres(matA, rhs, x0=x0, rtol=tol, atol=tol, maxit=maxit,
                M_inv=lambda v: P(v, shift))
    return sol, rhs


def push_phase(Ep, st: BinnedState, t, B_p, geom: Geometry, *, qm):
    """Boris vEB with s1-interpolated E at the already-moved positions."""
    E_p = gather_vector_slots(Ep, t, geom)
    mask = st.valid[..., None]
    E_p = torch.where(mask, E_p, torch.zeros_like(E_p))
    p1 = update_vEB(geom.dt, qm, st.p, E_p, B_p)
    p1 = torch.where(mask, p1, torch.zeros_like(p1))
    return BinnedState(r=st.r, p=p1, valid=st.valid)


def ecsim_step_binned(E, B, B0, st: BinnedState, geom: Geometry, q: float,
                      m: float, mpw: float, maxit: int = 100, prev=None,
                      return_adv: bool = False):
    """One ECSIM timestep for one species over the binned layout.
    Returns ``(E_new, B_new, st, currI, iterations)`` (plus ``(Ep, rhs)``
    with ``return_adv``, to warm-start the next step)."""
    # f32 cannot reach the f64 solve tolerance; it solves to its floor.
    tol = 1e-5 if E.dtype == torch.float32 else 1e-7

    st = rebin(drift_state(st, geom), geom)
    t = cell_t(geom, st.r)
    currI, mass, B_p = fill_phase(B, st, t, geom, q=q, m=m, mpw=mpw)
    sol, rhs = advance_phase(E, B, B0, currI, accumulate_mass(None, mass),
                             geom, tol=tol, maxit=maxit, prev=prev)
    Ep = sol.x
    st = push_phase(Ep, st, t, B_p, geom, qm=q / m)

    E_new = 2.0 * Ep - E
    B_new = B - geom.dt * curl_positive(Ep, geom.cell_steps, geom.bounds)
    if return_adv:
        return E_new, B_new, st, currI, sol.iterations, (Ep, rhs)
    return E_new, B_new, st, currI, sol.iterations


def ecsim_multi_step(E, B, B0, sp: ParticleArrays, geom: Geometry,
                     slots: int, q: float, m: float, mpw: float,
                     maxit: int = 100, n_steps: int = 10):
    """``n_steps`` ECSIM timesteps.  The species enters flat, runs binned
    and exits flat.  Returns ``(E, B, species, iterations)`` with the
    per-step KSP iteration counts as an int64 tensor on the host."""
    st = bin_state(sp, geom, slots)
    iters = []
    for _ in range(n_steps):
        E, B, st, _, it = ecsim_step_binned(E, B, B0, st, geom, q=q, m=m,
                                            mpw=mpw, maxit=maxit)
        iters.append(it)
    return E, B, unbin_state(st, geom), torch.tensor(iters,
                                                     dtype=torch.int64)
