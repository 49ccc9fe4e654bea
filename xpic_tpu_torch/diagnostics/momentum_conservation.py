"""Momentum-conservation table: temporal/momentum_conservation.txt
(counterpart of ``xpic_tpu/diagnostics/momentum_conservation.py``).

Reference: src/diagnostics/momentum_conservation.cpp — per species the
total momentum P = (m/Np) sum(p) (the node spline products sum to one)
and the electric impulse QE = (q/Np) sum of the Yee-gathered E at the
particles; the table reports (P1-P0)/dt - QE norms and an oscillation
frequency estimate.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import Geometry
from ..ops.gather_scatter import E_STAGGER, cell_t, gather_vector
from .tables import TableDiagnostic

PETSC_SMALL = 1e-10


def _momentum_and_impulse(E, st, geom: Geometry):
    """(P, QE) as one [2, 3] host array (one device-to-host copy)."""
    t = cell_t(geom, st.r)
    E_p = gather_vector(E, t, st.valid, geom, order=2, width=4, anchor=-1,
                        stagger=E_STAGGER)
    P = torch.sum(torch.where(st.valid[..., None], st.p,
                              torch.zeros_like(st.p)), dim=(0, 1))
    QE = torch.sum(E_p, dim=(0, 1))
    return torch.stack([P, QE]).cpu().numpy()


class MomentumConservation:
    def __init__(self, simulation):
        self.simulation = simulation
        self.table = TableDiagnostic(
            os.path.join(simulation.cfg.out_dir, "temporal",
                         "momentum_conservation.txt")
        )
        n = len(simulation.species)
        self.P0 = [np.zeros(3) for _ in range(n)]
        self.P1 = [np.zeros(3) for _ in range(n)]
        self.QE = [np.zeros(3) for _ in range(n)]

    def _calculate(self):
        sim = self.simulation
        for i, sp in enumerate(sim.species):
            P, QE = _momentum_and_impulse(sim.E, sim.binned(sp), sim.geom)
            Np = sp.params.Np
            self.P1[i] = P * (sp.params.m / Np)
            self.QE[i] = QE * (sp.params.q / Np)

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        dt = sim.geom.dt
        self._calculate()
        # Seed at the run's first diagnose: step 0, or the step that a
        # restart from a backup starts at (the JAX package seeds at step
        # 0 only, and its restart fails in ChargeConservation).
        if t == sim.start:
            for i in range(len(sim.species)):
                self.P0[i] = self.P1[i].copy()

        tb = self.table
        tb.add(6, "Time", t, "{:d}")
        total_err = np.zeros(3)
        for i, sp in enumerate(sim.species):
            name = sp.params.sort_name
            p0, p1, qe = self.P0[i], self.P1[i], self.QE[i]
            for c, ax in enumerate("xyz"):
                tb.add(13, f"P{ax}_" + name, p1[c])
            for c, ax in enumerate("xyz"):
                tb.add(13, f"QE{ax}_" + name, qe[c])
            err = (p1 - p0) / dt - qe
            total_err += err
            denom = np.linalg.norm(p1 + p0)
            freq = (np.linalg.norm(p1 - p0) / denom) / (0.5 * dt) \
                if denom > PETSC_SMALL else 0.0
            tb.add(13, "N2dP_" + name, float(np.linalg.norm(err)))
            tb.add(13, "fP_" + name, float(freq))
            self.P0[i] = p1.copy()
        tb.add(13, "N2dP", float(np.linalg.norm(total_err)))
        tb.commit(t, sim.geom.diagnose_period)

    def finalize(self) -> None:
        self.table.finalize()
