"""The ECSIM timestep over the persistent binned particle layout
(counterpart of ``xpic_tpu/parallel/step.py``, single device).

One step: drift, rebin (neighbor exchange), fill (B gather, implicit
current deposit, the species' mass contribution), advance (GMRES on
matA = 2I + dt^2/2 curl- curl+ + matL with the Chebyshev
preconditioner), push (slot gather of E and the Boris vEB update), and
the curl field update.

The mass contribution takes one of two routes, as in the JAX package:

* ``"free"``: matL is never assembled; the fill packs per-slot operands
  and every solver iteration re-walks them (``ops/mass_free.py``, the
  ``mass_apply`` kernel on the card);
* ``"blocks"``: the fill assembles L [G, 3, 12, 3, 12] once a step
  (``ops/ecsim_kernel.ecsim_fill``, the ``ecsim_fill`` kernel on the
  card) and every iteration applies it (``ecsim_blocks.apply_blocks``).

:func:`mass_route` is JAX's rule: ``free`` only for float32 under
``XPIC_MASS=free`` (the default), ``blocks`` otherwise, float64
included.  The route is passed down explicitly to the two functions that
make a mass contribution (``fill_phase``, ``empty_mass``); from there on
its representation carries it, and only ``accumulate_mass``,
``matL_apply`` and ``matL_trace`` look at it.  The rebin takes the
neighbor exchange for float32 and the global sort otherwise; the
preconditioner is Chebyshev of degree 12.
"""

from __future__ import annotations

import os

import torch

from ..config import Geometry
from ..ops.binning import BinnedState, bin_state, drift_state, rebin, \
    unbin_state
from ..ops.ecsim_blocks import apply_blocks, blocks_trace, deposit_slot_sums
from ..ops.ecsim_kernel import ecsim_fill
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

MASS_ROUTES = ("free", "blocks")


def mass_route(dtype: torch.dtype, mass: str | None = None) -> str:
    """The mass route of a run in ``dtype``: ``mass`` (default: the
    ``XPIC_MASS`` environment variable, read now, else ``"free"``)
    applies to float32; every other dtype assembles."""
    mode = os.environ.get("XPIC_MASS", "free") if mass is None else mass
    if mode not in MASS_ROUTES:
        raise ValueError(f"mass route {mode!r}: expected one of "
                         f"{MASS_ROUTES} (XPIC_MASS)")
    return "free" if mode == "free" and dtype == torch.float32 else "blocks"


def fill_phase(B, st: BinnedState, t, geom: Geometry, *, q, m, mpw, mass):
    """currI deposit, the species' mass contribution and B at the
    particles.  Returns ``(currI, mass_s, B_p)`` with ``mass_s`` the
    dense blocks [G, 3, 12, 3, 12] on the ``blocks`` route, a
    ``(MassOp, trace)`` pair on the ``free`` route."""
    dt = geom.dt
    B_p = gather_vector(B, t, st.valid, geom, order=1, width=3, anchor=-1,
                        stagger=B_STAGGER)
    if mass == "blocks":
        L, Islot = ecsim_fill(t, st.p, B_p, st.valid, q=q, m=m, mpw=mpw,
                              dt=dt)
        return deposit_slot_sums(Islot, geom), L, B_p
    I_p = implicit_current(B_p, st.p, st.valid, q=q, m=m, mpw=mpw, dt=dt)
    currI = deposit_vector_slots(I_p, t, geom)
    op = mass_operands(t, B_p, st.valid, q=q, m=m, mpw=mpw, dt=dt)
    return currI, (op, mass_trace(op)), B_p


def accumulate_mass(acc, mass):
    """Fold one species' mass contribution into the running total: dense
    blocks add; ``(MassOp, trace)`` pairs collect into
    ``((op, ...), trace_sum)``."""
    if isinstance(mass, tuple):
        op, tr = mass
        if acc is None:
            return ((op,), tr)
        ops, tr_acc = acc
        return (ops + (op,), tr_acc + tr)
    return mass if acc is None else acc + mass


def empty_mass(geom: Geometry, dtype, device, mass: str):
    """The zero mass contribution of a run with no particles."""
    if mass == "free":
        return ((), torch.zeros((), dtype=dtype, device=device))
    return torch.zeros((geom.n_cells, 3, 12, 3, 12), dtype=dtype,
                       device=device)


def matL_apply(mass, x, geom: Geometry):
    """matL x for the summed mass contribution in either representation."""
    if isinstance(mass, tuple):
        ops, _ = mass
        return mass_apply(x, ops, geom) if ops else torch.zeros_like(x)
    return apply_blocks(mass, x, geom)


def matL_trace(mass):
    """The trace of matL (the preconditioner's shift) in either
    representation."""
    return mass[1] if isinstance(mass, tuple) else blocks_trace(mass)


def advance_phase(E, B, B0, currI, mass, geom: Geometry, *, tol, maxit,
                  prev=None):
    """rhs = 2E - dt currI + dt curl-(B - B0); solve matA Ep = rhs.
    ``mass`` is the summed contribution: dense blocks or
    ``((MassOp, ...), trace)``.  ``prev = (Ep_prev, rhs_prev)``
    warm-starts the solve with the delta predictor
    x0 = Ep_prev + (rhs - rhs_prev)/2; without it x0 = rhs/2."""
    dt = geom.dt
    steps, bounds = geom.cell_steps, geom.bounds
    half_dt2 = 0.5 * dt * dt
    trace = matL_trace(mass)

    def matA(x):
        y = 2.0 * x + half_dt2 * curl_negative(
            curl_positive(x, steps, bounds), steps, bounds)
        return y + matL_apply(mass, x, geom)

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
    """Boris vEB with s1-interpolated E at the already-moved positions
    (the same slot gather on both mass routes)."""
    E_p = gather_vector_slots(Ep, t, geom)
    mask = st.valid[..., None]
    E_p = torch.where(mask, E_p, torch.zeros_like(E_p))
    p1 = update_vEB(geom.dt, qm, st.p, E_p, B_p)
    p1 = torch.where(mask, p1, torch.zeros_like(p1))
    return BinnedState(r=st.r, p=p1, valid=st.valid)


def ecsim_step_binned(E, B, B0, st: BinnedState, geom: Geometry, q: float,
                      m: float, mpw: float, maxit: int = 100, prev=None,
                      return_adv: bool = False, mass: str | None = None):
    """One ECSIM timestep for one species over the binned layout, on the
    mass route ``mass_route(E.dtype, mass)``.  Returns ``(E_new, B_new,
    st, currI, iterations)`` (plus ``(Ep, rhs)`` with ``return_adv``, to
    warm-start the next step)."""
    # f32 cannot reach the f64 solve tolerance; it solves to its floor.
    tol = 1e-5 if E.dtype == torch.float32 else 1e-7
    mass = mass_route(E.dtype, mass)

    st = rebin(drift_state(st, geom), geom)
    t = cell_t(geom, st.r)
    currI, mass_s, B_p = fill_phase(B, st, t, geom, q=q, m=m, mpw=mpw,
                                    mass=mass)
    sol, rhs = advance_phase(E, B, B0, currI, accumulate_mass(None, mass_s),
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
                     maxit: int = 100, n_steps: int = 10,
                     mass: str | None = None):
    """``n_steps`` ECSIM timesteps on the mass route
    ``mass_route(E.dtype, mass)``.  The species enters flat, runs binned
    and exits flat.  Returns ``(E, B, species, iterations)`` with the
    per-step KSP iteration counts as an int64 tensor on the host."""
    mass = mass_route(E.dtype, mass)
    st = bin_state(sp, geom, slots)
    iters = []
    for _ in range(n_steps):
        E, B, st, _, it = ecsim_step_binned(E, B, B0, st, geom, q=q, m=m,
                                            mpw=mpw, maxit=maxit, mass=mass)
        iters.append(it)
    return E, B, unbin_state(st, geom), torch.tensor(iters,
                                                     dtype=torch.int64)
