"""Host-side simulation orchestration
(counterpart of ``xpic_tpu/schemes/base.py``).

Mirrors ``interfaces::Simulation`` (src/interfaces/simulation.cpp:16-112):
initialize -> build commands/diagnostics -> run presets -> main loop of
[step-presets, timestep_implementation, diagnostics].  The per-step
physics lives in each scheme; everything here is glue that runs on the
host between steps.  Fields and species live on one ``torch.device`` in
one dtype, both fixed when the simulation is built.

``"Mesh": N`` runs a scheme over N ranks of a process group, one z slab
each (``parallel/mesh.py``): ``self.geom`` is the rank's slab,
``self.cfg.geometry`` the whole grid's.  The host reads that decide
anything (particle counts, the capacity check, the slot count K, the
solvers' norms) are reduced over the ranks first, so every rank takes
the same branch and grows K together.  A slab thinner than the widest
window the scheme reads across a slab face is refused when the
simulation is built.  A (z, y) or (z, y, x) mesh, SimulationBackup, and
the commands and diagnostics not listed in ``MESH_SECTIONS`` are
ROADMAP A11b and refused.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np
import torch

from ..config import PERIODIC, Config, Geometry, SortParameters
from ..ops.binning import (
    BinnedState,
    bin_state,
    choose_slots,
    max_per_cell,
    unbin_state,
)
from ..particles import ParticleArrays, make_empty
from ..ops.gather_scatter import z_halo
from ..parallel.mesh import mesh_of

log = logging.getLogger("xpic")

# What a run over a z mesh takes from the config's sections (Energy,
# ChargeConservation, MomentumConservation and eccapfim's
# ConvergenceHistory are added by the schemes themselves).
MESH_SECTIONS = {
    "command": ("SetParticles", "SetMagneticField", "InjectParticles",
                "RemoveParticles", "FieldsDamping"),
    "diagnostic": ("FieldView", "DistributionMoment",
                   "VelocityDistribution", "LogView"),
}


def _reduce_max(geom: Geometry, v: int, device) -> int:
    """The largest ``v`` over the ranks, reduced on ``device`` (the
    species' data's: NCCL reduces no host tensor)."""
    mesh = mesh_of(geom)
    return v if mesh is None else int(mesh.allreduce_max(
        torch.tensor([v], device=device))[0])


class Species:
    """Host wrapper pairing static sort parameters with the device tensors.

    Storage is dual: the *binned* ``BinnedState`` ([G, K] padded per-cell
    layout, what every scheme step consumes) and the *flat*
    ``ParticleArrays`` view (what the command layer and the Energy
    diagnostic consume).  Whichever side was written last is
    authoritative; the other is derived lazily.
    """

    def __init__(self, params: SortParameters, arrays: ParticleArrays,
                 geom: Geometry):
        self.params = params
        self.geom = geom
        self._flat: ParticleArrays | None = arrays
        self._binned: BinnedState | None = None
        self.slots = 0  # current binned per-cell capacity (K)
        # Host-tracked particle count: commands update it exactly; open
        # boundaries may kill particles, in which case the owning scheme
        # refreshes it (used only to skip work for empty species).
        self.n = 0
        # Particles that changed cell in the last checked migration.
        self.migrated = 0

    # -- flat view ------------------------------------------------------
    @property
    def arrays(self) -> ParticleArrays:
        """Flat [G*K] view when derived from the binned state: cell-major
        with dead padding interleaved (masked by ``alive``)."""
        if self._flat is None:
            self._flat = unbin_state(self._binned, self.geom)
        return self._flat

    @arrays.setter
    def arrays(self, value: ParticleArrays) -> None:
        self._flat = value
        self._binned = None

    # -- binned view ------------------------------------------------------
    @property
    def state(self) -> BinnedState:
        if self._binned is None:
            k = _reduce_max(self.geom, max_per_cell(self._flat, self.geom),
                            self._flat.alive.device)
            # Headroom above the observed max load, so that the growth in
            # check_load can act before any drop can happen.
            slots = choose_slots(max(k, 1) + max(4, k // 8))
            if slots > self.slots or slots * 2 < self.slots:
                self.slots = slots
            self._binned = bin_state(self._flat, self.geom, self.slots)
        return self._binned

    @state.setter
    def state(self, st: BinnedState) -> None:
        self._binned = st
        self.slots = st.valid.shape[1]
        self._flat = None

    def grow_slots(self, k_needed: int) -> None:
        """Grow the per-cell capacity to hold ``k_needed`` (between
        steps; the kernels take K as a launch argument)."""
        new_slots = choose_slots(k_needed)
        if new_slots <= self.slots:
            return
        flat = self.arrays  # materialize from the current binned state
        self.slots = new_slots
        self._binned = bin_state(flat, self.geom, new_slots)
        self._flat = None

    def count(self) -> int:
        """Exact live count (one device-to-host read; over all ranks on a
        slab)."""
        if self._binned is not None:
            n = torch.sum(self._binned.valid)
        else:
            n = torch.sum(self._flat.alive)
        mesh = mesh_of(self.geom)
        if mesh is not None:
            n = mesh.allreduce_sum(n)
        self.n = int(n)
        return self.n

    def log_distribution(self) -> None:
        """Log a 128-bin per-axis velocity histogram (bin =
        floor(p * 64) + 64, i.e. p in [-1, 1) c-units)."""
        hist_w = 128
        hist_h = hist_w // 2
        flat = self.arrays
        p = flat.p.cpu().numpy()[flat.alive.cpu().numpy()]
        if p.size == 0:
            return
        bins = np.clip((p * hist_h).astype(np.int64) + hist_h, 0, hist_w - 1)
        hist = np.stack(
            [np.bincount(bins[:, ax], minlength=hist_w) for ax in range(3)]
        )
        log.debug("    %s velocity distribution histogram:",
                  self.params.sort_name)
        log.debug("    %3s  %6s: %9s %9s %9s",
                  "bin", "v[c]", "hist[X]", "hist[Y]", "hist[Z]")
        for i in range(hist_w):
            if not hist[:, i].any():
                continue
            log.debug("    %3d  % 5.3f: %9d %9d %9d",
                      i, i / hist_h - 1.0, hist[0, i], hist[1, i],
                      hist[2, i])


class Simulation:
    scheme_name = "base"
    # The windows (anchor, width) the scheme reads across a slab face:
    # ChargeConservation's order-2 charge deposit, which every scheme
    # runs, and the scheme's own widest.
    windows = ((-1, 4),)

    def __init__(self, cfg: Config, device: torch.device,
                 dtype: torch.dtype):
        from ..parallel.mesh import SlabMesh, make_mesh, refuse

        self.cfg = cfg
        g = cfg.geometry
        if cfg.n_devices > 1:
            if len(cfg.mesh_shape) > 1:
                refuse(f'"Mesh" {dict(zip("zyx", cfg.mesh_shape))}')
            halo = max(max(z_halo(a, w)) for a, w in self.windows)
            planes = g.nz // cfg.n_devices
            if planes < halo:
                raise ValueError(
                    f'"Mesh": {cfg.n_devices} gives slabs of {planes} z '
                    f"planes, thinner than the {halo} ghost planes the "
                    f"{self.scheme_name} scheme reads across a slab face")
            for kind, names in MESH_SECTIONS.items():
                for info in (*cfg.presets, *cfg.step_presets,
                             *cfg.diagnostics):
                    name = info.get(kind)
                    if name is not None and name not in names:
                        refuse(f"the {kind} {name} with a mesh")
            if cfg.backup:
                refuse("SimulationBackup with a mesh")
            self.mesh = make_mesh(cfg.mesh_shape, g.nz, g.bounds[2])
            self.geom: Geometry = g.slab(self.mesh)
        else:
            # One rank: a mesh of one, which no op calls.
            self.mesh = SlabMesh(0, 1, g.nz, True, None)
            self.geom = g
        self.device = device
        self.dtype = dtype
        self.start = 0
        self.species: list[Species] = []
        self.diagnostics: list[Any] = []
        self.step_presets: list[Any] = []
        self.timings: dict[str, float] = {}
        self.step_seconds: list[float] = []  # each step's host wall time

        g = self.geom
        shape = (3, g.nz, g.ny, g.nx)
        self.E = self._zeros(shape)
        self.B = self._zeros(shape)
        self.B0 = self._zeros(shape)
        self.J = self._zeros(shape)

    def _zeros(self, shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- lifecycle ----------------------------------------------------
    def initialize(self) -> None:
        os.makedirs(os.path.join(self.cfg.out_dir, "temporal"), exist_ok=True)
        for params in self.cfg.sorts:
            self.species.append(Species(
                params, make_empty(256, self.dtype, self.device), self.geom))
            self._log_cfl(params)
        self.initialize_implementation()

        from ..commands import build_commands
        from ..diagnostics import build_diagnostics, default_diagnostics

        presets = build_commands(self, self.cfg.presets)
        self.step_presets = build_commands(self, self.cfg.step_presets)

        self.diagnostics = default_diagnostics(self)
        self.diagnostics += build_diagnostics(self, self.cfg.diagnostics)

        log.info("Executing presets")
        for preset in presets:
            preset.execute(self.start)
        self.rebin_all()
        for sp in self.species:
            sp.count()  # seed the host-tracked counts
            if log.isEnabledFor(logging.DEBUG):
                sp.log_distribution()

        for diag in self.diagnostics:
            diag.diagnose(self.start)

    def calculate(self) -> None:
        log.info("Running the main simulation cycle")
        diag_prev = 0.0  # diagnostics cost of the previous step
        for t in range(self.start + 1, self.geom.nt + 1):
            t0 = time.perf_counter()
            for command in self.step_presets:
                command.execute(t)
            self.timestep_implementation(t)
            t1 = time.perf_counter()
            self.timings = {"step": t1 - t0, "diagnostics": diag_prev}
            self.step_seconds.append(t1 - t0)
            for diag in self.diagnostics:
                diag.diagnose(t)
            t2 = time.perf_counter()
            diag_prev = t2 - t1
            log.info(
                "Timestep = %.4f [1/w_pe] = %d [dt] (%.3fs step, %.3fs diag)",
                t * self.geom.dt, t, t1 - t0, t2 - t1,
            )

    def finalize(self) -> None:
        for command in self.step_presets:
            if hasattr(command, "finalize"):
                command.finalize()
        for diag in self.diagnostics:
            if hasattr(diag, "finalize"):
                diag.finalize()

    # -- helpers ------------------------------------------------------
    def _log_cfl(self, params: SortParameters) -> None:
        """Thermal-CFL guard at species init: log how many cells a
        thermal particle crosses per dt (the reference's species-init
        check, src/interfaces/simulation.tpp:68-77)."""
        from ..config import thermal_velocity

        T = max(params.Tx, params.Ty, params.Tz)
        if T <= 0.0 or params.m <= 0.0:
            return
        v_th = thermal_velocity(T, params.m)
        g = self.geom
        cells = v_th * g.dt / min(g.dx, g.dy, g.dz)
        log.info(
            "  %s: thermal velocity %.3e [c], crosses %.3f cells per dt",
            params.sort_name, v_th, cells,
        )
        if cells > 1.0:
            log.warning(
                "  %s: v_th dt/dx = %.2f > 1 — deposits assume sub-cell "
                "moves per step; reduce dt or expect flagged errors",
                params.sort_name, cells,
            )

    def rebin_all(self) -> None:
        """Ensure every species' binned state is fresh (forces the lazy
        flat -> binned conversion)."""
        for sp in self.species:
            sp.state  # noqa: B018 — property access triggers the rebin

    def check_load(self, sp: Species, load, reduced: bool = False
                   ) -> None:
        """Police the per-cell capacity after a checked rebin (one
        device-to-host read).

        ``load = [max_per_cell, dropped, moved]``.  Any dropped particle
        is a hard error; a cell within ``margin = max(4, K // 8)`` of
        capacity grows K to hold ``max_load + 2 * margin`` for the next
        step.  The JAX package's margin is 4 for every K, the same below
        K = 40; above, a cell's count can rise by more than 4 in one step
        (its sd is ~sqrt(2 f n) for a fraction f of particles changing
        cell: ~4 at n = 90, f = 0.1), and the fixed margin drops
        particles at 32^3 x 50 ppc.  On a slab the ranks' loads are
        reduced here, unless the caller already did (``reduced``)."""
        mesh = mesh_of(self.geom)
        if mesh is not None and not reduced:
            load = torch.cat([mesh.allreduce_max(load[:1]),
                              mesh.allreduce_sum(load[1:])])
        vals = [int(v) for v in load.tolist()]
        max_load, dropped = vals[0], vals[1]
        sp.migrated = vals[2] if len(vals) > 2 else 0
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "  %s: %d particles changed cell (max load %d / K=%d)",
                sp.params.sort_name, sp.migrated, max_load, sp.slots,
            )
        if dropped:
            raise RuntimeError(
                f"species {sp.params.sort_name!r}: {dropped} particles "
                f"dropped — per-cell capacity K={sp.slots} exceeded "
                f"(max load {max_load}); increase capacity headroom"
            )
        margin = max(4, sp.slots // 8)
        if max_load > sp.slots - margin:
            sp.grow_slots(max_load + 2 * margin)

    def binned(self, sp: Species) -> BinnedState:
        return sp.state

    def refresh_counts(self) -> None:
        """Re-sync host particle counts after a phase that may kill
        particles (open boundaries)."""
        if any(b != PERIODIC for b in self.geom.bounds):
            for sp in self.species:
                sp.count()

    def get_named_particles(self, name: str) -> Species:
        for sp in self.species:
            if sp.params.sort_name == name:
                return sp
        raise KeyError(f"no particles with name {name!r}")

    def get_named_field(self, name: str):
        return {"E": self.E, "B": self.B, "B0": self.B0, "J": self.J}[name]

    # -- abstract -----------------------------------------------------
    def initialize_implementation(self) -> None:
        raise NotImplementedError

    def timestep_implementation(self, t: int) -> None:
        raise NotImplementedError
