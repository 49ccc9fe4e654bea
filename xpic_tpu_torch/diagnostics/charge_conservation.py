"""Charge-conservation table: temporal/charge_conservation.txt
(counterpart of ``xpic_tpu/diagnostics/charge_conservation.py``).

Reference: src/diagnostics/charge_conservation.cpp — per species,
compares the discrete continuity equation d(rho)/dt + div J = 0 where
rho is the node-deposited charge density (order-2 spline products,
charge_conservation.cpp:63-101) and div is the backward-difference Yee
divergence; reports 1- and 2-norms per species and for the total.
"""

from __future__ import annotations

import os

import torch

from ..config import Geometry
from ..ops.gather_scatter import cell_t, deposit_scalar
from ..ops.stencil import divergence_negative
from .tables import TableDiagnostic
from ..parallel.mesh import mesh_of


def charge_density(st, geom: Geometry, qn_Np: float):
    """Node-centered charge density of one binned species state."""
    t = cell_t(geom, st.r)
    values = torch.full(st.valid.shape, qn_Np, dtype=st.r.dtype,
                        device=st.r.device)
    return deposit_scalar(values, t, st.valid, geom, order=2, width=4,
                          anchor=-1)


def _norms(diff, mesh):
    """(1-norm, 2-norm) of ``diff`` as host floats, over all ranks on a
    slab."""
    if mesh is None:
        return float(torch.sum(torch.abs(diff))), \
            float(torch.linalg.norm(diff))
    s = mesh.allreduce_sum(torch.stack([torch.sum(torch.abs(diff)),
                                        torch.sum(diff * diff)]))
    return float(s[0]), float(torch.sqrt(s[1]))


def _continuity_norms(rho_new, rho_old, J, geom: Geometry):
    diff = (rho_new - rho_old) / geom.dt
    diff = diff + divergence_negative(J, geom.cell_steps, geom.bounds,
                                      mesh_of(geom))
    return (*_norms(diff, mesh_of(geom)), diff)


class ChargeConservation:
    def __init__(self, simulation):
        self.simulation = simulation
        self.table = TableDiagnostic(
            os.path.join(simulation.cfg.out_dir, "temporal", "charge_conservation.txt")
        )
        self.rho = [None] * len(simulation.species)

    def _collect(self, i):
        sim = self.simulation
        sp = sim.species[i]
        return charge_density(sim.binned(sp), sim.geom,
                              sp.params.q * sp.params.n_Np)

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        geom = sim.geom
        # Seed at the run's first diagnose: step 0, or the step that a
        # restart from a backup starts at (the JAX package seeds at step
        # 0 only, and its restart fails in ChargeConservation).
        if t == sim.start:
            for i in range(len(sim.species)):
                self.rho[i] = self._collect(i)

        tb = self.table
        tb.add(6, "Time", t, "{:d}")

        total_ddt = torch.zeros(geom.shape, dtype=sim.J.dtype,
                                device=sim.J.device)
        for i, sp in enumerate(sim.species):
            rho_old = self.rho[i]
            rho_new = self._collect(i)
            self.rho[i] = rho_new
            J_s = getattr(sp, "J", None)
            if J_s is None:
                J_s = torch.zeros_like(sim.J)
            n1, n2, _ = _continuity_norms(rho_new, rho_old, J_s, geom)
            total_ddt = total_ddt + (rho_new - rho_old) / geom.dt
            name = sp.params.sort_name
            tb.add(13, "N1dQ_" + name, n1)
            tb.add(13, "N2dQ_" + name, n2)

        total = total_ddt + divergence_negative(sim.J, geom.cell_steps,
                                                geom.bounds, mesh_of(geom))
        n1, n2 = _norms(total, mesh_of(geom))
        tb.add(13, "N1dQ_tot", n1)
        tb.add(13, "N2dQ_tot", n2)
        tb.commit(t, geom.diagnose_period)

    def finalize(self) -> None:
        self.table.finalize()
