"""Energy tables: temporal/energy.txt and temporal/energy_conservation.txt
(counterpart of ``xpic_tpu/diagnostics/energy.py``).

Reference: src/diagnostics/energy.cpp.  Field energy is 0.5*||F||^2
summed over the grid (no cell-volume factor, matching VecNorm);
kinetic energy is 0.5*m*(n/Np)*sum p^2.  The conservation table lists
per-step deltas plus the step presets' source and sink terms
(FieldsDamping, InjectParticles, RemoveParticles) and the closing
dE+dB+dK column.  The ecsimcorr subclass appends the per-species
work-bookkeeping columns.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .tables import TableDiagnostic


def _field_stats(F):
    en = 0.5 * torch.sum(F * F)
    sums = torch.sum(F, dim=(1, 2, 3))  # per-component sums (VecStrideSumAll)
    return en, sums


def _kinetic_stats(p, alive):
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    comp = torch.sum(torch.where(alive[:, None], p, zero), dim=0)
    w = torch.sum(torch.where(alive, torch.sum(p * p, dim=1), zero))
    n = torch.sum(alive)
    return comp, w, n


def _all_stats(E, B, species_p, species_alive):
    """All Energy-diagnostic reductions in one device-to-host copy: a flat
    stats vector [2 + 2*3 + 5*n_species]."""
    en_E, sums_E = _field_stats(E)
    en_B, sums_B = _field_stats(B)
    parts = [torch.stack([en_E, en_B]), sums_E, sums_B]
    for p, alive in zip(species_p, species_alive):
        comp, w, n = _kinetic_stats(p, alive)
        parts.append(torch.cat([comp, torch.stack([w, n.to(p.dtype)])]))
    return torch.cat(parts).cpu().numpy()


class Energy:
    def __init__(self, simulation):
        self.simulation = simulation
        out = simulation.cfg.out_dir
        self.energy = TableDiagnostic(os.path.join(out, "temporal", "energy.txt"))
        self.energy_cons = TableDiagnostic(
            os.path.join(out, "temporal", "energy_conservation.txt")
        )
        ns = len(simulation.species)
        self.E = self.E0 = 0.0
        self.B = self.B0v = 0.0
        self.std_E = self.std_B = 0.0
        self.K = [0.0] * ns
        self.K0 = [0.0] * ns
        self.std_K = [0.0] * ns

    def calculate(self):
        """Every reduction the tables need, in one device round trip.
        The species enter in their flat view (``Species.arrays``), which
        unbins each binned species: one more copy per diagnose step."""
        sim = self.simulation
        g3 = sim.geom.n_cells
        stats = _all_stats(
            sim.E, sim.B,
            tuple(sp.arrays.p for sp in sim.species),
            tuple(sp.arrays.alive for sp in sim.species),
        )
        self.E = float(stats[0])
        self.B = float(stats[1])
        sums_E = stats[2:5]
        sums_B = stats[5:8]
        self.std_E = float(
            np.sqrt(max(self.E - 0.5 * float(np.sum(sums_E**2)) / g3, 0.0) / g3)
        )
        self.std_B = float(
            np.sqrt(max(self.B - 0.5 * float(np.sum(sums_B**2)) / g3, 0.0) / g3)
        )
        off = 8
        for i, sp in enumerate(self.simulation.species):
            comp = stats[off : off + 3]
            w = float(stats[off + 3])
            n = int(round(float(stats[off + 4])))
            off += 5
            frac = 0.5 * sp.params.m * sp.params.n_Np
            if n == 0:
                self.K[i] = 0.0
                self.std_K[i] = 0.0
                continue
            self.K[i] = frac * w
            s = w - float(np.sum(comp**2)) / n
            self.std_K[i] = frac * np.sqrt(abs(s) / n)

    def diagnose(self, t: int) -> None:
        # Seed at the run's first diagnose: step 0, or the step that a
        # restart from a backup starts at (the JAX package seeds at step
        # 0 only, and its restart fails in ChargeConservation).
        if t == self.simulation.start:
            self.calculate()
        self.E0, self.B0v, self.K0 = self.E, self.B, list(self.K)
        self.calculate()
        self.fill_energy(t)
        self.fill_energy_cons(t)
        period = self.simulation.geom.diagnose_period
        self.energy.commit(t, period)
        self.energy_cons.commit(t, period)

    def fill_energy(self, t: int) -> None:
        tb = self.energy
        tb.add(6, "Time", t, "{:d}")
        tb.add(13, "wE", self.E)
        tb.add(13, "wB", self.B)
        for i, sp in enumerate(self.simulation.species):
            tb.add(13, "wK_" + sp.params.sort_name, self.K[i])
        tb.add(13, "sE", self.std_E)
        tb.add(13, "sB", self.std_B)
        for i, sp in enumerate(self.simulation.species):
            tb.add(13, "sK_" + sp.params.sort_name, self.std_K[i])

    def fill_energy_cons(self, t: int) -> None:
        tb = self.energy_cons
        tb.add(6, "Time", t, "{:d}")
        dE = self.E - self.E0
        dB = self.B - self.B0v
        dF = dE + dB
        tb.add(13, "dE", dE)
        tb.add(13, "dB", dB)
        dK = 0.0
        for i, sp in enumerate(self.simulation.species):
            tb.add(13, "dK_" + sp.params.sort_name, self.K[i] - self.K0[i])
            dK += self.K[i] - self.K0[i]

        # Source/sink terms from step presets (reference: energy.cpp:160-180).
        from ..commands.fields_damping import FieldsDamping
        from ..commands.inject_particles import InjectParticles
        from ..commands.remove_particles import RemoveParticles

        for command in self.simulation.step_presets:
            if isinstance(command, FieldsDamping):
                tb.add(13, "Damped(E+B)", command.get_damped_energy())
                dF += command.get_damped_energy()
            if isinstance(command, InjectParticles):
                tb.add(13, "Inj_" + command.get_ionized_name(),
                       command.get_ionized_energy())
                tb.add(13, "Inj_" + command.get_ejected_name(),
                       command.get_ejected_energy())
                dK -= (command.get_ionized_energy()
                       + command.get_ejected_energy())
            if isinstance(command, RemoveParticles):
                tb.add(13, "Rm_" + command.get_particles_name(),
                       command.get_removed_energy())
                dK += command.get_removed_energy()
        self._dK = dK
        tb.add(13, "dE+dB+dK", dF + dK)

    def finalize(self) -> None:
        self.energy.finalize()
        self.energy_cons.finalize()


class EcsimcorrEnergy(Energy):
    """Adds the ecsimcorr work-bookkeeping columns
    (src/impls/ecsimcorr/simulation.cpp:170-199): per species the
    renormalization's energy change CWD, the predicted and corrected
    work defects PWD and LdK, and the total work defect WD."""

    def fill_energy_cons(self, t: int) -> None:
        super().fill_energy_cons(t)
        tb = self.energy_cons
        sim = self.simulation
        dt = sim.geom.dt
        off = 3
        corr_w_total = 0.0
        for sp in sim.species:
            name = sp.params.sort_name
            stats = sp.corr_stats
            cwd = stats["lambda_dK"]
            pwd = stats["pred_dK"] - dt * stats["pred_w"]
            ldk = stats["corr_dK"] - dt * stats["corr_w"]
            corr_w_total += stats["corr_w"]
            off += 1
            tb.add(13, "CWD_" + name, cwd, pos=off)
            off += 1
            tb.add(13, "PWD_" + name, pwd, pos=off)
            off += 1
            tb.add(13, "LdK_" + name, ldk, pos=off)
            off += 1
        tb.add(13, "WD", self._dK - dt * corr_w_total)
