"""Explicit leapfrog scheme: FDTD + Boris push + Esirkepov current
(counterpart of ``xpic_tpu/schemes/basic.py``).

Reference: src/impls/basic/simulation.cpp:30-100 and
src/impls/basic/particles.cpp:17-56.  One timestep:

1. ``push_particles``: B^n = B^{n-1/2} - (dt/2) curl+ E^n (external B0 is
   excluded from the rotation); for each species, half drift -> order-2
   Yee gather of (E, B) -> Boris vEB velocity update -> half drift ->
   Esirkepov current deposit over the full old->new move.
2. ``push_fields``: B^{n+1/2} = B^n - (dt/2) curl+ E^n;
   E^{n+1} = E^n + dt curl- B^{n+1/2} - dt J.

Species live in the persistent cell-binned ``BinnedState``; the push
ends with the capacity-checked migration, which on the card runs the
neighbour exchange's kernels (``rebin_extract``, ``rebin_place``).
Host synchronisations a step: the rebin guard of each migration and
each species' load read by ``check_load``.  Over a z mesh the width-6
gathers pad the fields with 2 ghost planes below and 3 above, the
Esirkepov deposit folds its ghost planes, and the curls exchange one
plane a side (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch

from ..config import Geometry
from ..ops.binning import BinnedState, migrate_checked
from ..ops.gather_scatter import (
    B_STAGGER,
    E_STAGGER,
    cell_t,
    esirkepov_current,
    gather_vector,
)
from ..ops.stencil import curl_negative, curl_positive
from ..parallel.mesh import mesh_of
from ..pushers import update_vEB
from .base import Simulation


def _push_species(E, B, st: BinnedState, geom: Geometry, qm: float,
                  alpha: float):
    """Boris push + Esirkepov deposit for one species; returns
    ``(state, J_s, load)``."""
    dt = geom.dt
    d = torch.tensor(geom.cell_steps, dtype=st.r.dtype, device=st.r.device)

    rg0 = st.r  # [G, K, 3] in grid units, binned by the cell of rg0
    p0 = st.p

    # Half drift, gather fields at the mid position, rotate, half drift.
    rg_half = rg0 + (p0 / d) * (0.5 * dt)
    t_half = cell_t(geom, rg_half)
    # Anchor -2 / width 6 tolerates up to one cell of drift off the
    # binning cell.
    E_p = gather_vector(E, t_half, st.valid, geom, order=2, width=6,
                        anchor=-2, stagger=E_STAGGER)
    B_p = gather_vector(B, t_half, st.valid, geom, order=2, width=6,
                        anchor=-2, stagger=B_STAGGER)
    p1 = update_vEB(dt, qm, p0, E_p, B_p)
    p1 = torch.where(st.valid[..., None], p1, torch.zeros_like(p1))
    rg1 = rg_half + (p1 / d) * (0.5 * dt)

    J_s = esirkepov_current(cell_t(geom, rg0), cell_t(geom, rg1), st.valid,
                            alpha, geom)
    st2, load = migrate_checked(BinnedState(r=rg1, p=p1, valid=st.valid),
                                geom)
    return st2, J_s, load


def _half_rotation(E, B, B0, geom: Geometry):
    """B -> B - (dt/2) curl+ (E), excluding the external field B0
    (reference: basic/simulation.cpp:45-52)."""
    return B - 0.5 * geom.dt * curl_positive(E, geom.cell_steps, geom.bounds,
                                             mesh_of(geom))


def _push_fields(E, B, B0, J, geom: Geometry):
    """Faraday then Ampere update (reference: basic/simulation.cpp:74-100).
    The JAX function also returns |E^{n+1} - E^n|, which nothing reads;
    the port does not compute it."""
    steps, bounds, mesh = geom.cell_steps, geom.bounds, mesh_of(geom)
    dt = geom.dt
    Bi = B - B0
    Bi = Bi - 0.5 * dt * curl_positive(E, steps, bounds, mesh)
    E_new = E + dt * curl_negative(Bi, steps, bounds, mesh) - dt * J
    return E_new, Bi + B0


class BasicSimulation(Simulation):
    scheme_name = "basic"
    windows = Simulation.windows + ((-2, 6),)  # the gathers and deposit

    def initialize_implementation(self) -> None:
        pass

    def timestep_implementation(self, t: int) -> None:
        geom = self.geom

        # B^{n-1/2} -> B^{n} for the particle push.
        self.B = _half_rotation(self.E, self.B, self.B0, geom)

        J = torch.zeros_like(self.J)
        loads = []
        for sp in self.species:
            if sp.n == 0:
                sp.J = torch.zeros_like(self.J)
                continue
            alpha = sp.params.q * sp.params.n_Np / (6.0 * geom.dt)
            sp.state, J_s, load = _push_species(
                self.E, self.B, sp.state, geom, sp.params.qm, alpha)
            sp.J = J_s
            J = J + J_s
            loads.append((sp, load))
        self.J = J

        self.E, self.B = _push_fields(self.E, self.B, self.B0, self.J, geom)

        for sp, load in loads:
            self.check_load(sp, load)
        self.refresh_counts()
