"""ConvergenceHistory table for the eccapfim nonlinear solve
(a copy of ``xpic_tpu/diagnostics/convergence_history.py``).

Reference: src/impls/eccapfim/convergence_history.cpp — per step, the
average Crank-Nicolson iteration count per species, the nonlinear
iteration/evaluation counts and the residual-norm history.
"""

from __future__ import annotations

import os

from .tables import TableDiagnostic


class ConvergenceHistory:
    def __init__(self, simulation):
        self.simulation = simulation
        self.table = TableDiagnostic(
            os.path.join(simulation.cfg.out_dir, "temporal",
                         "convergence_history.txt")
        )

    def diagnose(self, t: int) -> None:
        sim = self.simulation
        tb = self.table
        tb.add(6, "Time", t, "{:d}")
        for sp in sim.species:
            name = sp.params.sort_name
            tb.add(8, "AvgCN_" + name, getattr(sp, "cn_iterations", 0.0),
                   "{:.3f}")
        hist = getattr(sim, "conv_history", [])
        tb.add(6, "ItNum", max(len(hist) - 1, 0), "{:d}")
        if not hist:
            tb.add(12, "ConvHist", "", "{}")
        else:
            for h in hist:
                tb.add(12, "ConvHist", h, "{:8.6e}")
        tb.commit(t, sim.geom.diagnose_period)

    def finalize(self) -> None:
        self.table.finalize()
