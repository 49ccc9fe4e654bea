"""RemoveParticles step preset
(counterpart of ``xpic_tpu/commands/remove_particles.py``).

Reference: src/commands/remove_particles.cpp.  The reference clears
whole cells whose corner lies outside the keep geometry; here the
per-particle position test gives the same behavior in the continuum
limit.  The test runs on the host with numpy, as the JAX package's does,
so both packages decide alike on the same positions.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..particles import ParticleArrays
from .particles_load import load_box, load_cylinder

log = logging.getLogger("xpic")


class RemoveParticles:
    def __init__(self, species, tester, name=""):
        self.species = species
        self.tester = tester
        self.removed_energy = 0.0
        self.geometry_name = name

    @classmethod
    def from_json(cls, simulation, info):
        sp = simulation.get_named_particles(info["particles"])
        units = simulation.cfg.unit_table()
        gname = info["geometry"]["name"]
        if gname == "BoxGeometry":
            geom = load_box(info["geometry"], units)
        elif gname == "CylinderGeometry":
            geom = load_cylinder(info["geometry"], units)
        else:
            raise ValueError(f"unknown remove geometry {gname!r}")
        log.info("  RemoveParticles is added for %r", sp.params.sort_name)
        return cls(sp, geom.contains, gname)

    def get_particles_name(self) -> str:
        return self.species.params.sort_name

    def get_removed_energy(self) -> float:
        return self.removed_energy

    def execute(self, t: int) -> None:
        arr = self.species.arrays
        r = arr.r.cpu().numpy()
        alive = arr.alive.cpu().numpy()
        keep = self.tester(r)
        remove = alive & ~keep
        if not remove.any():
            self.removed_energy = 0.0
            return
        params = self.species.params
        w = 0.5 * params.m * params.n_Np
        p = arr.p.cpu().numpy()
        self.removed_energy = float(w * np.sum(p[remove] ** 2))
        alive = alive & keep
        self.species.arrays = ParticleArrays(
            r=arr.r, p=arr.p,
            alive=torch.as_tensor(alive, device=arr.alive.device))
        self.species.n = int(alive.sum())
        log.info(
            "  Removed %d particles from %r (energy %.4e)",
            int(remove.sum()), params.sort_name, self.removed_energy,
        )
