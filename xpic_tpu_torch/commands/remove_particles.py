"""RemoveParticles step preset
(counterpart of ``xpic_tpu/commands/remove_particles.py``).

Reference: src/commands/remove_particles.cpp.  The reference clears
whole cells whose corner lies outside the keep geometry; here the
per-particle position test gives the same behavior in the continuum
limit.  The test runs on the host with numpy, as the JAX package's does,
so both packages decide alike on the same positions.  On a z slab each
rank removes its own particles, and the removed energy and the live
count are summed over the ranks in one all-reduce.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..parallel.mesh import mesh_of
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
        params = self.species.params
        energy = 0.0
        if remove.any():
            p = arr.p.cpu().numpy()
            energy = float(0.5 * params.m * params.n_Np
                           * np.sum(p[remove] ** 2))
        removed = int(remove.sum())
        alive = alive & keep
        n = int(alive.sum())
        mesh = mesh_of(self.species.geom)
        if mesh is not None:
            # On the species' device: NCCL reduces no host tensor.
            energy, removed, n = mesh.allreduce_sum(torch.tensor(
                [energy, removed, n], dtype=torch.float64,
                device=arr.alive.device)).tolist()
            removed, n = int(removed), int(n)
        self.removed_energy = energy
        if not removed:
            return
        self.species.arrays = ParticleArrays(
            r=arr.r, p=arr.p,
            alive=torch.as_tensor(alive, device=arr.alive.device))
        self.species.n = n
        log.info(
            "  Removed %d particles from %r (energy %.4e)",
            removed, params.sort_name, self.removed_energy,
        )
