"""ECSIM: energy-conserving semi-implicit scheme (Lapenta), host-phased
(counterpart of ``xpic_tpu/schemes/ecsim.py``).

Reference: src/impls/ecsim/{simulation,particles}.cpp, after
https://doi.org/10.1016/j.jcp.2017.01.002.  One timestep
(ecsim/simulation.cpp:145-253):

1. ``first_push``     : r += v dt (no fields), then the checked migration.
2. ``fill``           : per species, gather B (s1) -> implicit current
                        I_p into currI and the species' mass
                        contribution (matL blocks, or the matrix-free
                        operands).
3. ``advance_fields`` : solve (matL + matM) E^{n+1/2} = 2 E^n
                        - dt currI + dt curl-(B^n - B0).
4. ``second_push``    : gather E^{n+1/2} (s1) at the new positions, Boris
                        vEB velocity update.
5. ``final_update``   : E^{n+1} = 2 E^{n+1/2} - E^n;
                        B^{n+1} = B^n - dt curl+(E^{n+1/2}).

The phases are those of the fused step (``parallel/step.py``); this
class runs them one by one for the command and diagnostic cadence, on
the mass route fixed when the simulation was built (``self.mass``):
float64 assembles matL as the JAX package does, float32 is matrix-free
unless ``XPIC_MASS=blocks``.  Host synchronisations, as in the JAX
scheme: one per Krylov iteration, the iteration count and convergence
flag per solve, the rebin guard and the capacity check per species and
step.

Solver budget: rtol=atol=1e-7 (1e-5 in float32), maxit=100
(ecsim/simulation.h:15-18); non-convergence raises.
"""

from __future__ import annotations

import os
import time

import torch

from ..ops.binning import drift_state, rebin_checked
from ..ops.gather_scatter import cell_t
from ..ops.stencil import curl_positive
from ..parallel.step import (
    accumulate_mass,
    advance_phase,
    empty_mass,
    fill_phase,
    mass_route,
    push_phase,
)
from .base import Simulation
from ..parallel.mesh import mesh_of

ATOL = 1e-7
RTOL = 1e-7
MAXIT = 100
# Solver-tolerance override of the float64 path (the JAX package's
# XPIC_KSP_TOL experiment); None = the reference budget above.
_TOL_OVERRIDE = (
    float(os.environ["XPIC_KSP_TOL"]) if "XPIC_KSP_TOL" in os.environ
    else None
)


class EcsimSimulation(Simulation):
    scheme_name = "ecsim"

    def __init__(self, cfg, device: torch.device, dtype: torch.dtype,
                 mass: str | None = None):
        super().__init__(cfg, device, dtype)
        self.mass = mass_route(dtype, mass)

    def initialize_implementation(self) -> None:
        self.Ep = torch.zeros_like(self.E)
        self.phase_timings: dict[str, float] = {}
        # Per-step KSP iteration counts.
        self.ksp_history: list[int] = []

    # -- step phases ----------------------------------------------------
    def clear_sources(self) -> None:
        self.currI = torch.zeros_like(self.J)
        self._mass = None

    def first_push(self) -> None:
        for sp in self.species:
            sp.state, sp._load = rebin_checked(
                drift_state(sp.state, self.geom), self.geom)
        self.fill_ecsim_current()

    def fill_ecsim_current(self) -> None:
        for sp in self.species:
            if sp.n == 0:
                sp._cache = None
                continue
            pr = sp.params
            st = sp.state
            t = cell_t(self.geom, st.r)
            currI_s, mass, B_p = fill_phase(self.B, st, t, self.geom,
                                            q=pr.q, m=pr.m, mpw=pr.n_Np,
                                            mass=self.mass)
            sp.currI = currI_s
            sp._cache = (t, B_p)
            self.currI = self.currI + currI_s
            self._mass = accumulate_mass(self._mass, mass)
        if self._mass is None:
            self._mass = empty_mass(self.geom, self.dtype, self.device,
                                    self.mass)

    def _predict(self):
        """The predict solve into ``self.Ep``; returns its result."""
        f32 = self.E.dtype == torch.float32
        tol = 1e-5 if f32 else ATOL
        if _TOL_OVERRIDE is not None and not f32:
            tol = _TOL_OVERRIDE
        # Cross-step warm start: opt-in (XPIC_WARM_START=1), float32 only,
        # as in the JAX scheme.
        prev = (getattr(self, "_adv_prev", None)
                if f32 and os.environ.get("XPIC_WARM_START") == "1"
                else None)
        sol, rhs = advance_phase(self.E, self.B, self.B0, self.currI,
                                 self._mass, self.geom, tol=tol,
                                 maxit=MAXIT, prev=prev)
        self.Ep = sol.x
        self._adv_prev = (self.Ep, rhs)
        return sol

    def advance_fields(self) -> None:
        sol = self._predict()
        self._ksp_iters = sol.iterations
        self.ksp_history.append(self._ksp_iters)
        if not sol.converged:
            raise RuntimeError(
                f"ECSIM field solve did not converge: "
                f"|r|={sol.residual_norm:.3e} after {sol.iterations} "
                f"iterations")

    def second_push(self) -> None:
        for sp in self.species:
            if sp.n == 0 or sp._cache is None:
                continue
            t, B_p = sp._cache
            sp.state = push_phase(self.Ep, sp.state, t, B_p, self.geom,
                                  qm=sp.params.qm)
            sp._cache = None

    def final_update(self) -> None:
        E = self.E
        self.E = 2.0 * self.Ep - E
        g = self.geom
        self.B = self.B - g.dt * curl_positive(self.Ep, g.cell_steps,
                                               g.bounds, mesh_of(g))

    def timestep_implementation(self, t: int) -> None:
        phases = [
            ("clear_sources", self.clear_sources),
            ("first_push", self.first_push),
            ("advance_fields", self.advance_fields),
            ("second_push", self.second_push),
            ("final_update", self.final_update),
        ]
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            self.phase_timings[name] = time.perf_counter() - t0
        # The ECSIM current is the scheme's J (ecsim/simulation.cpp:139).
        self.J = self.currI
        for sp in self.species:
            sp.J = getattr(sp, "currI", torch.zeros_like(self.J))
        # Capacity policing at the end of the step.
        for sp in self.species:
            load = getattr(sp, "_load", None)
            if load is not None:
                sp._load = None
                self.check_load(sp, load)
        self.refresh_counts()
